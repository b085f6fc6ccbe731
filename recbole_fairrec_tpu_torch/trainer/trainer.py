"""Base Trainer — the evaluation half.

Counterpart of ``recbole_fairrec_tpu/trainer/trainer.py``: construction,
batch padding, eval macro-batching, the dense and streaming full-sort eval
paths, ``evaluate`` and the checkpoint payload. Training (``fit``, the train
step, the optimizers) comes with the training slice of the port.

Full-sort evaluation has two paths, as in the JAX package:

* dense (default): ``full_sort_predict`` scores ``[B, |I|]`` with
  ``torch.matmul``, then ``ops.eval_fused.full_sort_eval_step`` masks PAD and
  history and takes the top-k on the device;
* streaming (``streaming_eval: True``, monotone models only): the model's
  retrieval embeddings go through ``ops.fused_topk.fused_topk_scores`` for
  k' = k + max_history + 1 candidates — the hand-written CUDA kernel on a
  card, its plain version on the CPU — and PAD/history are filtered on the
  host. ``_last_eval_path`` names the path that ran.
"""

from __future__ import annotations

import itertools
import os
import pickle
from logging import getLogger

import numpy as np
import torch

from ..data.dataloader import FullSortEvalDataLoader
from ..data.interaction import Interaction, cat_interactions
from ..evaluator import Collector, Evaluator
from ..utils import EvaluatorType, _bucket, ensure_dir, get_local_time, set_color

NEG_INF = -np.inf


class AbstractTrainer:
    def __init__(self, config, model):
        self.config = config
        self.model = model

    def fit(self, train_data):
        raise NotImplementedError("Method [next] should be implemented.")

    def evaluate(self, eval_data):
        raise NotImplementedError("Method [next] should be implemented.")


class Trainer(AbstractTrainer):
    _ckpt_counter = itertools.count()

    def __init__(self, config, model):
        super().__init__(config, model)
        self.logger = getLogger()
        self.device = config["device"]
        self.model = model.to(self.device)
        self.valid_metric_bigger = config["valid_metric_bigger"]
        self.checkpoint_dir = config["checkpoint_dir"]
        ensure_dir(self.checkpoint_dir)
        saved_model_file = (
            f'{self.config["model"]}-{get_local_time()}'
            f"-{os.getpid()}-{next(self._ckpt_counter)}.pth"
        )
        self.saved_model_file = os.path.join(self.checkpoint_dir, saved_model_file)

        self.start_epoch = 0
        self.cur_step = 0
        self.best_valid_score = -np.inf if self.valid_metric_bigger else np.inf
        self.best_valid_result = None

        self.eval_type = config["eval_type"]
        self.eval_collector = Collector(config)
        self.evaluator = Evaluator(config)
        self.tot_item_num = None

    def fit(self, train_data, valid_data=None, verbose=True, saved=True,
            show_progress=False, callback_fn=None):
        raise NotImplementedError(
            "training comes with the next slice of the port; this Trainer evaluates "
            "(load weights with quick_start.load_data_and_model or "
            "utils.jax_params.load_jax_params)"
        )

    # ------------------------------------------------------------- batching

    def _to_batch(self, interaction: Interaction, pad_to=None):
        """Interaction → dict of device tensors, edge-padded to ``pad_to``
        rows with a ``__weight__`` validity mask (the JAX package's static
        shapes; the padded rows are dropped again after scoring)."""
        n = len(interaction)
        target = pad_to or n
        batch = {}
        for key, value in interaction.interaction.items():
            if target > n:
                tail = value[-1:].expand((target - n,) + tuple(value.shape[1:]))
                value = torch.cat([value, tail], dim=0)
            batch[key] = value.to(self.device)
        if target > n:
            w = torch.zeros(target, dtype=torch.float32)
            w[:n] = 1.0
            batch["__weight__"] = w.to(self.device)
        return batch

    def _tensor(self, array):
        return torch.as_tensor(np.asarray(array), device=self.device)

    # ---------------------------------------------------------- checkpoints

    def _checkpoint_payload(self, epoch):
        cfg = dict(self.config.final_config_dict)
        cfg.pop("device", None)  # re-derived on load
        return {
            "config": cfg,
            "epoch": epoch,
            "cur_step": self.cur_step,
            "best_valid_score": self.best_valid_score,
            "params": {k: v.detach().cpu().numpy() for k, v in self.model.state_dict().items()},
            "model_state": {},
            "other_parameter": self.model.other_parameter(),
        }

    def _save_checkpoint(self, epoch, verbose=True, **kwargs):
        saved_model_file = kwargs.pop("saved_model_file", self.saved_model_file)
        with open(saved_model_file, "wb") as f:
            pickle.dump(self._checkpoint_payload(epoch), f)
        if verbose:
            self.logger.info(set_color("Saving current", "blue") + f": {saved_model_file}")

    def _load_params_from_checkpoint(self, checkpoint):
        from ..utils.jax_params import load_jax_params

        load_jax_params(self.model, checkpoint["params"])
        self.model.load_other_parameter(checkpoint.get("other_parameter"))

    # ------------------------------------------------------------ evaluate

    def _get_full_sort_fn(self, sst_list=None):
        model = self.model

        def score(batch):
            return model.full_sort_predict(batch, sst_list=sst_list)

        return score

    def _get_predict_fn(self, sst_list=None):
        model = self.model

        def score(batch):
            return model.predict(batch, sst_list=sst_list)

        return score

    def _get_retrieval_fn(self, sst_list=None):
        model = self.model

        def fn(batch):
            return model.retrieval_embeddings(batch, sst_list=sst_list)

        return fn

    def _predict_scores(self, interaction, sst_list=None):
        n = len(interaction)
        batch = self._to_batch(interaction, pad_to=_bucket(n, 8192))
        out = self._get_predict_fn(sst_list)(batch)
        return out.reshape(-1)[:n].cpu().numpy()

    def _fused_eval_ok(self):
        """The device paths cover the top-k / positive-score resources; the
        rank-curve and VALUE resources need the host path (not ported)."""
        r = self.eval_collector.register
        return not (
            r.need("rec.meanrank") or r.need("rec.score") or r.need("data.label")
        ) and self.config["eval_type"] == EvaluatorType.RANKING

    @staticmethod
    def _pad_pairs(u, i, quantum=1024, cap=None):
        """Pad ragged index pairs to a bucketed length; pads target (0, 0)
        with weight 0."""
        n = len(u)
        if cap is None or cap < n:
            cap = max(_bucket(n, quantum), quantum)
        pu = np.zeros(cap, dtype=np.int64)
        pi = np.zeros(cap, dtype=np.int64)
        w = np.zeros(cap, dtype=np.float32)
        pu[:n] = u
        pi[:n] = i
        w[:n] = 1.0
        return pu, pi, w, n

    def _collect_full_sort_fused(self, batched_data, sst_list=None):
        from ..ops.eval_fused import full_sort_eval_step

        interaction, history_index, positive_u, positive_i = batched_data
        n = len(interaction)
        pad_to = max(getattr(self, "_full_sort_pad", None) or n, _bucket(n, 512))
        batch = self._to_batch(interaction, pad_to=pad_to)
        scores = self._get_full_sort_fn(sst_list)(batch).reshape(pad_to, self.tot_item_num)

        pu, pi, pw, n_pos = self._pad_pairs(positive_u, positive_i)
        if history_index is not None:
            hu, hi, _, _ = self._pad_pairs(history_index[0], history_index[1])
        else:
            hu = np.zeros(1, dtype=np.int64)
            hi = np.zeros(1, dtype=np.int64)
        topk_idx, rec_topk, pos_score = full_sort_eval_step(
            scores, self._tensor(pu), self._tensor(pi), self._tensor(pw),
            self._tensor(hu), self._tensor(hi), max(self.config["topk"]),
        )
        self._emit_fused_payload(
            interaction, positive_u, positive_i, topk_idx, rec_topk, pos_score, n, n_pos,
        )

    def _emit_fused_payload(
        self, interaction, positive_u, positive_i, topk_idx, rec_topk, pos_score,
        n_rows, n_pos, extra=None,
    ):
        r = self.eval_collector.register
        payload = dict(extra or {})
        if r.need("rec.items"):
            payload["rec.items"] = topk_idx[:n_rows].cpu().numpy()
        if r.need("rec.topk"):
            payload["rec.topk"] = rec_topk[:n_rows].cpu().numpy()
        if r.need("rec.positive_score"):
            payload["rec.positive_score"] = pos_score[:n_pos].cpu().numpy()
        self.eval_collector.eval_batch_collect_topk(
            payload, interaction, positive_u, positive_i
        )

    def _macro_batches(self, eval_data):
        """Merge consecutive full-sort loader batches into one dispatch of up
        to ``eval_macro_scores`` score cells ([users × |I|]); per-user
        row-block layout is kept exactly (indices offset by the running
        user count)."""
        target_scores = self.config["eval_macro_scores"] or 32_000_000
        max_users = max(1, target_scores // max(self.tot_item_num or 1, 1))
        buf = []
        acc_users = 0
        for batched_data in eval_data:
            buf.append(batched_data)
            acc_users += len(batched_data[0])
            if acc_users >= max_users:
                yield self._merge_batches(buf)
                buf, acc_users = [], 0
        if buf:
            yield self._merge_batches(buf)

    @staticmethod
    def _merge_batches(buf):
        if len(buf) == 1:
            return buf[0]
        merged_inter = cat_interactions([b[0] for b in buf])
        pos_u_parts, pos_i_parts, hist_u_parts, hist_i_parts = [], [], [], []
        offset = 0
        for inter, (hist_u, hist_i), pos_u, pos_i in buf:
            hist_u_parts.append(hist_u + offset)
            hist_i_parts.append(hist_i)
            pos_u_parts.append(pos_u + offset)
            pos_i_parts.append(pos_i)
            offset += len(inter)
        return (
            merged_inter,
            (np.concatenate(hist_u_parts), np.concatenate(hist_i_parts)),
            np.concatenate(pos_u_parts),
            np.concatenate(pos_i_parts),
        )

    # ------------------------------------------------------- streaming eval

    @staticmethod
    def _pair_membership(row_u, cand_i, key_u, key_i, n_items):
        """bool [B, k']: is (row, candidate) in the (key_u, key_i) pair set."""
        if len(key_u) == 0:
            return np.zeros(cand_i.shape, dtype=bool)
        keys = np.sort(key_u.astype(np.int64) * n_items + key_i.astype(np.int64))
        cand_keys = row_u[:, None].astype(np.int64) * n_items + cand_i.astype(np.int64)
        pos = np.clip(np.searchsorted(keys, cand_keys), 0, len(keys) - 1)
        return keys[pos] == cand_keys

    def _collect_full_sort_streaming(self, batched_data, sst_list=None):
        """Retrieval-form eval: never materializes [B, |I|]. Retrieves
        k' = k + max_history + 1 candidates with the fused top-k, then
        filters PAD + history and builds collector payloads on the host.
        Exact for models whose full-sort score is a strictly monotone
        transform of the retrieval dot product."""
        from ..ops.fused_topk import fused_topk_scores

        interaction, history_index, positive_u, positive_i = batched_data
        B = len(interaction)
        pad_to = max(getattr(self, "_full_sort_pad", None) or B, _bucket(B, 512))
        batch = self._to_batch(interaction, pad_to=pad_to)
        user_repr, item_table = self._get_retrieval_fn(sst_list)(batch)

        max_k = max(self.config["topk"])
        k_prime = getattr(self, "_stream_kprime", None) or (max_k + 1)
        _, cand_i = fused_topk_scores(
            user_repr.contiguous(), item_table.contiguous(), k_prime
        )
        self._last_eval_path = (
            "streaming-kernel" if user_repr.device.type == "cuda" else "streaming"
        )
        cand_i = cand_i[:B].cpu().numpy()

        forbidden = (cand_i == 0) | (cand_i >= self.tot_item_num)
        if history_index is not None:
            hist_u, hist_i = history_index
            forbidden |= self._pair_membership(
                np.arange(B), cand_i, np.asarray(hist_u), np.asarray(hist_i),
                self.tot_item_num,
            )
        order = np.argsort(forbidden, axis=1, kind="stable")  # keep score order
        topk_idx = np.take_along_axis(cand_i, order, axis=1)[:, :max_k]

        r = self.eval_collector.register
        payload = {}
        if r.need("rec.items"):
            payload["rec.items"] = topk_idx
        if r.need("rec.topk"):
            pos_hit = self._pair_membership(
                np.arange(B), topk_idx, np.asarray(positive_u), np.asarray(positive_i),
                self.tot_item_num,
            ).astype(np.int64)
            pos_len = np.bincount(np.asarray(positive_u), minlength=B).reshape(-1, 1)
            payload["rec.topk"] = np.concatenate([pos_hit, pos_len], axis=1)
        if r.need("rec.positive_score"):
            users = np.asarray(interaction[self.config["USER_ID_FIELD"]])[
                np.asarray(positive_u)
            ]
            pair_inter = Interaction(
                {
                    self.config["USER_ID_FIELD"]: users,
                    self.config["ITEM_ID_FIELD"]: np.asarray(positive_i),
                }
            )
            payload["rec.positive_score"] = self._predict_scores(pair_inter, sst_list)
        self.eval_collector.eval_batch_collect_topk(
            payload, interaction, positive_u, positive_i
        )

    def _compute_stream_kprime(self, eval_data):
        """Candidate count for streaming retrieval: k + the longest history
        any user carries + 1 (PAD)."""
        max_k = max(self.config["topk"])
        return max_k + getattr(eval_data, "max_history_len", 0) + 1

    def _retrieval_eval_capable(self):
        """The model must expose ``retrieval_embeddings`` AND declare
        rank-preservation (``retrieval_monotone``)."""
        return (
            getattr(self.model, "retrieval_monotone", False)
            and hasattr(self.model, "retrieval_embeddings")
            and self._fused_eval_ok()
        )

    def _streaming_eval_ok(self):
        return self.config["streaming_eval"] and self._retrieval_eval_capable()

    def _collect_batch(self, batched_data, sst_list=None):
        """Score one full-sort eval batch and feed the collector."""
        if self._streaming_eval_ok():
            return self._collect_full_sort_streaming(batched_data, sst_list)
        if not self._fused_eval_ok():
            raise NotImplementedError(
                "metrics that need the full score matrix on the host (rank curves, "
                "value metrics) are not ported yet"
            )
        self._last_eval_path = "fused"
        return self._collect_full_sort_fused(batched_data, sst_list)

    @torch.no_grad()
    def evaluate(self, eval_data, load_best_model=False, model_file=None, show_progress=False):
        if not eval_data:
            return

        if load_best_model:
            checkpoint_file = model_file or self.saved_model_file
            with open(checkpoint_file, "rb") as f:
                checkpoint = pickle.load(f)
            self._load_params_from_checkpoint(checkpoint)
            self.logger.info(f"Loading model structure and parameters from {checkpoint_file}")

        if not isinstance(eval_data, FullSortEvalDataLoader):
            raise NotImplementedError("sampled evaluation is not ported yet")
        self._full_sort_pad = eval_data.step
        self._stream_kprime = self._compute_stream_kprime(eval_data)
        if self.config["eval_type"] == EvaluatorType.RANKING:
            self.tot_item_num = eval_data.dataset.item_num

        self.model.eval()
        self.eval_collector.model_collect(self.model)
        for batched_data in self._macro_batches(eval_data):
            self._collect_batch(batched_data)
        struct = self.eval_collector.get_data_struct()
        return self.evaluator.evaluate(struct)
