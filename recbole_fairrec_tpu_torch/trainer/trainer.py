"""Base Trainer: train step, early stopping, checkpoints, evaluation loop.

Counterpart of ``recbole_fairrec_tpu/trainer/trainer.py``: the optimizer
zoo, the train step and the epoch loop (``fit``), checkpoints and resume,
and evaluation (eval macro-batching, the device and host paths,
``evaluate``).

Training. One step is ``zero_grad`` of the whole model → device negatives
when the loader runs in ``device_neg_sampling`` mode → the model's loss →
``backward`` → a zero gradient for each of the optimizer's parameters that
the loss did not reach → gradient clipping over the optimizer's parameters →
the optimizer's step. Every learner follows the JAX package's
update rule (its optax chain), not PyTorch's default where the two differ;
see ``_build_optimizer`` and ``trainer/optim.py``. Train batches are not
padded and carry no ``__weight__``: static shapes are XLA's need, and the
weighted mean over all-ones weights is the plain mean. The epoch loss is the
sum of the step losses, accumulated on the device and read once per epoch.
``train_macro_steps`` and ``train_macro_rows`` (the JAX package's fusing of
steps into one dispatch, which changes no result there) are accepted and
ignored.

Evaluation takes the JAX package's paths (``_collect_batch``):

* full-sort, dense (default): ``full_sort_predict`` scores ``[B, |I|]`` with
  ``torch.matmul``, then ``ops.eval_fused.full_sort_eval_step`` masks PAD and
  history and takes the top-k on the device;
* full-sort, streaming (``streaming_eval: True``, monotone models only): the
  model's retrieval embeddings go through ``ops.fused_topk.fused_topk_scores``
  for k' = k + max_history + 1 candidates — the hand-written CUDA kernel on a
  card, its plain version on the CPU — and PAD/history are filtered on the
  host;
* sampled (``uni100`` / ``pop100``): ``_collect_sampled_fused`` rebuilds the
  row lanes on the device from per-user counts, runs ``predict`` and
  ``ops.eval_fused.sampled_topk_from_scores``;
* host: the rank-curve metric (GAUC, ``rec.meanrank``) and the value metrics
  (AUC, LogLoss, MAE, RMSE: ``rec.score``, ``data.label``; labeled
  evaluation) need every score on the host. The model still scores on the
  trainer's device (``_full_sort_scores``, ``_neg_sample_batch_eval``); the
  collector ranks in numpy.

``_last_eval_path`` names the path that ran.
"""

from __future__ import annotations

import itertools
import os
import pickle
from logging import getLogger
from time import time

import numpy as np
import torch

from ..data.dataloader import FullSortEvalDataLoader
from ..data.interaction import Interaction, cat_interactions
from ..evaluator import Collector, Evaluator
from ..utils import (
    EvaluatorType,
    _bucket,
    calculate_valid_score,
    dict2str,
    early_stopping,
    ensure_dir,
    get_local_time,
    set_color,
)
from ..utils.jax_params import (
    load_jax_opt_state,
    load_jax_params,
    to_jax_params,
    to_jax_state,
)
from ..utils.loggers import WandbLogger, get_tensorboard
from .optim import Adagrad, RMSprop, clip_by_global_norm

NEG_INF = -np.inf


def _flatten_result(result):
    flat = {}
    for k, v in (result or {}).items():
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    return flat


def _tree_map_tensors(fn, tree, leaf_type):
    """Apply ``fn`` to every ``leaf_type`` leaf of a dict/list/tuple tree."""
    if isinstance(tree, leaf_type):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map_tensors(fn, v, leaf_type) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_tensors(fn, v, leaf_type) for v in tree)
    return tree


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
        if config["mesh_shape"]:
            raise NotImplementedError(
                "mesh_shape (sharded execution) comes with the parallel layer of the "
                "port (ROADMAP Queue A, parallel layer)"
            )
        self.tensorboard = get_tensorboard(self.logger)
        self.wandblogger = WandbLogger(config)
        self.device = config["device"]
        self.model = model.to(self.device)
        self.learner = config["learner"]
        self.learning_rate = config["learning_rate"]
        self.epochs = config["epochs"]
        self.eval_step = min(config["eval_step"], self.epochs)
        self.stopping_step = config["stopping_step"]
        self.clip_grad_norm = config["clip_grad_norm"]
        self.valid_metric = config["valid_metric"].lower()
        self.valid_metric_bigger = config["valid_metric_bigger"]
        self.weight_decay = config["weight_decay"] or 0.0
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
        self.train_loss_dict = {}

        # device-side randomness (negatives drawn in the step): a generator
        # on the trainer's device; init_seed's generator lives on the CPU
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config["seed"] or 0))
        self._device_used_keys = None
        self.optimizer = self._build_optimizer()

        self.eval_type = config["eval_type"]
        self.eval_collector = Collector(config)
        self.evaluator = Evaluator(config)
        self.tot_item_num = None
        self.test_batch_size = config["eval_batch_size"]
        self.item_tensor = None

    # ------------------------------------------------------------ optimizer

    def _named_top_level_params(self):
        """(top-level name, parameter) pairs: ``user_embedding.weight`` goes
        by ``user_embedding``, the key of the JAX package's param tree."""
        return [(name.split(".")[0], p) for name, p in self.model.named_parameters()]

    def _build_optimizer(self, params=None, learner=None, learning_rate=None,
                         weight_decay=None):
        """The optimizer of ``learner`` over ``params`` (default: every
        parameter the model does not freeze), in the JAX package's update
        rule: ``adam`` and ``sgd`` add ``weight_decay * p`` to the gradient
        (not AdamW); ``adagrad`` and ``rmsprop`` keep eps inside the root
        (``trainer/optim.py``); ``sparse_adam`` is dense Adam without decay;
        an unknown learner is Adam."""
        learner = (learner or self.learner).lower()
        lr = self.learning_rate if learning_rate is None else learning_rate
        wd = self.weight_decay if weight_decay is None else weight_decay

        if self.config["reg_weight"] and wd and wd * self.config["reg_weight"] > 0:
            self.logger.warning(
                "The parameters [weight_decay] and [reg_weight] are specified "
                "simultaneously, which may lead to double regularization."
            )
        if params is None:
            frozen = set(self.model.frozen_param_keys())
            params = []
            for key, p in self._named_top_level_params():
                if key in frozen:
                    p.requires_grad_(False)
                else:
                    params.append(p)

        def adam(decay):
            return torch.optim.Adam(
                params, lr=lr, eps=1e-8, weight_decay=decay,
                fused=self.device.type == "cuda",
            )

        if learner == "adam":
            return adam(wd)
        if learner == "sgd":
            return torch.optim.SGD(params, lr=lr, weight_decay=wd)
        if learner == "adagrad":
            return Adagrad(params, lr=lr, weight_decay=wd, eps=1e-10)
        if learner == "rmsprop":
            return RMSprop(params, lr=lr, weight_decay=wd, eps=1e-8, decay=0.99)
        if learner == "sparse_adam":
            if wd > 0:
                self.logger.warning("Sparse Adam cannot argument received argument [weight_decay]")
            return adam(0.0)
        self.logger.warning("Received unrecognized optimizer, set default Adam optimizer")
        return adam(0.0)

    def _masked_tx(self, group_keys, **kwargs):
        """Optimizer updating only the parameters under the given top-level
        names (the adversarial trainers' per-optimizer parameter lists)."""
        group_keys = set(group_keys)
        frozen = set(self.model.frozen_param_keys())
        params = [
            p for key, p in self._named_top_level_params()
            if key in group_keys and key not in frozen
        ]
        return self._build_optimizer(params=params, **kwargs)

    def _tx_by_tag(self, tag):
        return self.optimizer

    # ------------------------------------------------------------- training

    def _maybe_enable_device_sampling(self, train_data):
        """Build the used-pair table on the device for in-step negative
        sampling when the loader runs in device_neg_sampling mode."""
        if not getattr(train_data, "device_neg_sampling", False):
            return
        if self._device_used_keys is not None:
            return
        from ..ops.neg_sampling import build_used_table

        ds = train_data.dataset
        self._device_used_keys = build_used_table(
            np.asarray(ds.inter_feat[ds.uid_field]),
            np.asarray(ds.inter_feat[ds.iid_field]),
            ds.user_num,
            ds.item_num,
            device=self.device,
        )
        self.logger.info("on-device negative sampling enabled")

    def _train_batch(self, interaction, fields=None):
        """Interaction → dict of device tensors, only the columns in
        ``fields`` (None: all). No padding."""
        return {
            key: value.to(self.device, non_blocking=True)
            for key, value in interaction.interaction.items()
            if fields is None or key in fields
        }

    def _inject_negatives(self, batch, loss_name):
        """Draw one uniform negative per row on the device when device
        sampling is on and the batch carries none."""
        model = self.model
        if (
            self._device_used_keys is None
            or loss_name != "calculate_loss"
            or not hasattr(model, "NEG_ITEM_ID")
            or model.NEG_ITEM_ID in batch
        ):
            return batch
        from ..ops.neg_sampling import sample_negatives

        batch[model.NEG_ITEM_ID] = sample_negatives(
            self.generator, batch[model.USER_ID], self._device_used_keys,
            model.n_items, num_neg=1,
        )
        return batch

    def _train_step(self, batch, loss_name, sst_list, optimizer):
        """One optimizer step on ``batch``; returns the loss (a detached
        scalar on the device, not read here).

        The gradients of the whole model are zeroed first: a loss may reach
        parameters outside ``optimizer`` (the filter step's loss reaches the
        discriminators), which another optimizer steps later. A parameter of
        ``optimizer`` that the loss does not reach (a filter of another
        subset) gets a zero gradient, so its update rule still runs — moments
        decay, weight decay applies, the step count advances — as the JAX
        package's masked optax chain does."""
        self.model.zero_grad(set_to_none=True)
        batch = self._inject_negatives(batch, loss_name)
        loss = getattr(self.model, loss_name)(batch, sst_list=sst_list)
        loss.backward()
        params = [p for group in optimizer.param_groups for p in group["params"]]
        missing = [p for p in params if p.grad is None]
        if missing:  # views of one zero buffer: one allocation, not one per parameter
            flat = torch.zeros(sum(p.numel() for p in missing), dtype=missing[0].dtype,
                               device=missing[0].device)
            for p, g in zip(missing, flat.split([p.numel() for p in missing])):
                p.grad = g.view_as(p)
        if self.clip_grad_norm:
            clip_by_global_norm(params, self.clip_grad_norm.get("max_norm", 1.0))
        optimizer.step()
        return loss.detach()

    def _run_epoch(self, train_data, loss_name="calculate_loss", sst_list=None, tx_tag="main"):
        """One pass over the loader with the given (loss, sst subset,
        optimizer) selection. Returns the sum of the step losses (one host
        read), or None for an empty loader."""
        self._maybe_enable_device_sampling(train_data)
        optimizer = self._tx_by_tag(tx_tag)
        fields = self.model.loss_batch_fields(loss_name, sst_list)
        self.model.train()
        total_loss = None
        for interaction in train_data:
            loss = self._train_step(
                self._train_batch(interaction, fields), loss_name, sst_list, optimizer
            )
            total_loss = loss if total_loss is None else total_loss + loss
        if total_loss is None:
            return None
        total = float(total_loss)  # single sync per epoch
        self._check_nan(total)
        return total

    def _train_epoch(self, train_data, epoch_idx, loss_func=None, show_progress=False):
        return self._run_epoch(train_data, loss_name=loss_func or "calculate_loss")

    def _check_nan(self, loss):
        if np.isnan(loss):
            raise ValueError("Training loss is nan")

    def _generate_train_loss_output(self, epoch_idx, s_time, e_time, losses):
        des = self.config["loss_decimal_place"] or 4
        output = (
            set_color(f"epoch {epoch_idx} training", "green")
            + " ["
            + set_color("time", "blue")
            + f": {e_time - s_time:.2f}s, "
        )
        if isinstance(losses, tuple):
            output += ", ".join(
                set_color(f"train_loss{i + 1}", "blue") + f": {loss:.{des}f}"
                for i, loss in enumerate(losses)
            )
        else:
            output += set_color("train loss", "blue") + f": {losses:.{des}f}"
        return output + "]"

    def _add_train_loss_to_tensorboard(self, epoch_idx, losses, tag="Loss/Train"):
        if isinstance(losses, tuple):
            for idx, loss in enumerate(losses):
                self.tensorboard.add_scalar(tag + str(idx), loss, epoch_idx)
        else:
            self.tensorboard.add_scalar(tag, losses, epoch_idx)

    def _add_hparam_to_tensorboard(self, best_valid_result):
        hparam_dict = {
            "learner": self.config["learner"],
            "learning_rate": self.config["learning_rate"],
            "train_batch_size": self.config["train_batch_size"],
        }
        for k in list(hparam_dict):
            if hparam_dict[k] is not None and not isinstance(hparam_dict[k], (bool, str, float, int)):
                hparam_dict[k] = str(hparam_dict[k])
        self.tensorboard.add_hparams(hparam_dict, {"hparam/best_valid_result": best_valid_result})

    def _valid_epoch(self, valid_data, show_progress=False):
        valid_result = self.evaluate(valid_data, load_best_model=False, show_progress=show_progress)
        valid_score = calculate_valid_score(valid_result, self.valid_metric)
        return valid_score, valid_result

    def _save_sst_embed(self, data):
        """Export user embeddings + sensitive attributes for offline
        attackers. The base trainer names no file for them (nor does the JAX
        package's); the model families' trainers override this."""
        raise NotImplementedError(
            "save_sst_embed: the base Trainer exports no embeddings; PFCNTrainer "
            "does (filter_mode: none), the FairGo trainers are not ported yet"
        )

    def _profiled_epoch(self, profile_dir, train_data, epoch_idx, show_progress):
        """Train one epoch under ``torch.profiler`` and write its Chrome
        trace into ``profile_dir``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        ensure_dir(profile_dir)
        with profile(activities=activities) as prof:
            train_loss = self._train_epoch(train_data, epoch_idx, show_progress=show_progress)
        trace = os.path.join(profile_dir, f"train_epoch_{epoch_idx}.json")
        prof.export_chrome_trace(trace)
        self.logger.info(f"profiler trace written to {trace}")
        return train_loss

    def fit(self, train_data, valid_data=None, verbose=True, saved=True,
            show_progress=False, callback_fn=None):
        """Train for ``epochs`` epochs, validating every ``eval_step`` and
        stopping early after ``stopping_step`` validations without a better
        score; the best model is checkpointed when ``saved``. Returns
        (best_valid_score, best_valid_result)."""
        if self.config["device_epoch_shuffle"]:
            raise NotImplementedError(
                "device_epoch_shuffle (epochs resident on the device) is not ported; "
                "see ROADMAP Queue A, resident epochs"
            )
        if self.config["save_sst_embed"] and type(self)._save_sst_embed is Trainer._save_sst_embed:
            self._save_sst_embed(train_data)  # raises before training, not after it
        if saved and self.start_epoch >= self.epochs:
            self._save_checkpoint(-1, verbose=verbose)

        self.eval_collector.data_collect(train_data)
        if self.config["train_neg_sample_args"].get("dynamic", "none") != "none":
            train_data.get_model(self)
        self._maybe_enable_device_sampling(train_data)
        valid_step = 0

        profile_dir = self.config["profile_dir"]
        for epoch_idx in range(self.start_epoch, self.epochs):
            training_start_time = time()
            if profile_dir and epoch_idx == self.start_epoch:
                train_loss = self._profiled_epoch(
                    profile_dir, train_data, epoch_idx, show_progress
                )
            else:
                train_loss = self._train_epoch(train_data, epoch_idx, show_progress=show_progress)
            self.train_loss_dict[epoch_idx] = (
                sum(train_loss) if isinstance(train_loss, tuple) else train_loss
            )
            training_end_time = time()
            if verbose:
                self.logger.info(
                    self._generate_train_loss_output(
                        epoch_idx, training_start_time, training_end_time, train_loss
                    )
                )
            self._add_train_loss_to_tensorboard(epoch_idx, train_loss)
            self.wandblogger.log_metrics(
                {"epoch": epoch_idx, "train_loss": train_loss, "train_step": epoch_idx},
                head="train",
            )

            if self.eval_step <= 0 or not valid_data:
                if saved:
                    self._save_checkpoint(epoch_idx, verbose=verbose)
                continue
            if (epoch_idx + 1) % self.eval_step == 0:
                valid_start_time = time()
                valid_score, valid_result = self._valid_epoch(valid_data, show_progress=show_progress)
                self.best_valid_score, self.cur_step, stop_flag, update_flag = early_stopping(
                    valid_score,
                    self.best_valid_score,
                    self.cur_step,
                    max_step=self.stopping_step,
                    bigger=self.valid_metric_bigger,
                )
                valid_end_time = time()
                if verbose:
                    self.logger.info(
                        (set_color(f"epoch {epoch_idx} evaluating", "green") + " ["
                         + set_color("time", "blue") + f": {valid_end_time - valid_start_time:.2f}s, "
                         + set_color("valid_score", "blue") + f": {valid_score:f}]")
                    )
                    self.logger.info(set_color("valid result", "blue") + ": \n" + dict2str(valid_result))
                self.tensorboard.add_scalar("Valid_score", valid_score, epoch_idx)
                self.wandblogger.log_metrics(
                    {**_flatten_result(valid_result), "valid_step": valid_step}, head="valid"
                )

                if update_flag:
                    if saved:
                        self._save_checkpoint(epoch_idx, verbose=verbose)
                    self.best_valid_result = valid_result

                if callback_fn:
                    callback_fn(epoch_idx, valid_score)

                if stop_flag:
                    if verbose:
                        self.logger.info(
                            "Finished training, best eval result in epoch %d"
                            % (epoch_idx - self.cur_step * self.eval_step)
                        )
                    break
                valid_step += 1

        if self.config["save_sst_embed"]:
            self._save_sst_embed(train_data)
        self._add_hparam_to_tensorboard(self.best_valid_score)
        return self.best_valid_score, self.best_valid_result

    def score_batch(self, interaction):
        """Used by the dataloader's dynamic hard-negative mining."""
        with torch.no_grad():
            return self._predict_scores(interaction)

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
            "params": to_jax_params(self.model),
            "model_state": to_jax_state(self.model),
            "other_parameter": self.model.other_parameter(),
            "optimizer": self._optimizer_payload(self.optimizer),
        }

    @staticmethod
    def _optimizer_payload(optimizer):
        """An optimizer's ``state_dict`` with numpy leaves (the checkpoint
        holds no torch object, so the JAX package can read it)."""
        return _tree_map_tensors(
            lambda t: t.detach().cpu().numpy(), optimizer.state_dict(), torch.Tensor
        )

    def _load_optimizer_payload(self, optimizer, payload):
        """Restore ``optimizer`` from a checkpoint's ``optimizer`` entry: the
        port's own payload, or the JAX package's optax state (Adam only)."""
        if isinstance(payload, dict) and "param_groups" in payload:
            optimizer.load_state_dict(_tree_map_tensors(torch.as_tensor, payload, np.ndarray))
        else:
            load_jax_opt_state(optimizer, self.model, payload)

    def _save_checkpoint(self, epoch, verbose=True, **kwargs):
        saved_model_file = kwargs.pop("saved_model_file", self.saved_model_file)
        with open(saved_model_file, "wb") as f:
            pickle.dump(self._checkpoint_payload(epoch), f)
        if verbose:
            self.logger.info(set_color("Saving current", "blue") + f": {saved_model_file}")

    def _load_params_from_checkpoint(self, checkpoint):
        load_jax_params(self.model, checkpoint["params"], checkpoint.get("model_state"))
        self.model.load_other_parameter(checkpoint.get("other_parameter"))

    def resume_checkpoint(self, resume_file):
        """Continue a run from a checkpoint written by this package or by the
        JAX package (whose optimizer state is mapped for Adam, and raises for
        another learner): epoch, step, best score, parameters and BatchNorm
        statistics, optimizers."""
        from ..quick_start import load_checkpoint

        resume_file = str(resume_file)
        self.saved_model_file = resume_file
        checkpoint = load_checkpoint(resume_file)
        self.start_epoch = checkpoint["epoch"] + 1
        self.cur_step = checkpoint["cur_step"]
        self.best_valid_score = checkpoint["best_valid_score"]
        if checkpoint["config"]["model"].lower() != self.config["model"].lower():
            self.logger.warning(
                "Architecture configuration given in config file is different from "
                "that of checkpoint. This may yield an exception while state_dict is "
                "being loaded."
            )
        self._load_params_from_checkpoint(checkpoint)
        self._load_optimizers(checkpoint)
        self.logger.info(f"Checkpoint loaded. Resume training from epoch {self.start_epoch}")

    def _load_optimizers(self, checkpoint):
        self._load_optimizer_payload(self.optimizer, checkpoint["optimizer"])

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

    # ------------------------------------------------------------ host paths

    def _full_sort_scores(self, interaction, sst_list=None):
        """The full-catalogue scores of a user batch, on the host (float64)."""
        n = len(interaction)
        pad_to = getattr(self, "_full_sort_pad", None) or n
        batch = self._to_batch(interaction, pad_to=max(pad_to, n))
        scores = self._get_full_sort_fn(sst_list)(batch)
        scores = scores.reshape(-1, self.tot_item_num)[:n].cpu().numpy()
        return scores.astype(np.float64)

    def _full_sort_batch_eval(self, batched_data, sst_list=None):
        interaction, history_index, positive_u, positive_i = batched_data
        try:
            scores = self._full_sort_scores(interaction, sst_list)
        except NotImplementedError:
            scores = self._predict_all_items_fallback(interaction)
        scores[:, 0] = NEG_INF
        if history_index is not None:
            hist_u, hist_i = history_index
            scores[hist_u, hist_i] = NEG_INF
        return interaction, scores, positive_u, positive_i

    def _predict_all_items_fallback(self, interaction):
        """Every item scored through ``predict`` for a model without
        ``full_sort_predict``."""
        inter_len = len(interaction)
        new_inter = interaction.repeat_interleave(self.tot_item_num)
        new_inter.update(self.item_tensor.repeat(inter_len))
        batch_size = len(new_inter)
        if batch_size <= self.test_batch_size:
            scores = self._predict_scores(new_inter)
        else:
            scores = self._spilt_predict(new_inter, batch_size)
        return np.asarray(scores, dtype=np.float64).reshape(-1, self.tot_item_num)

    def _neg_sample_batch_eval(self, batched_data, sst_list=None):
        """Sampled or labeled batch through ``predict`` on the trainer's
        device and the rest on the host: the row scores as they are for the
        value metrics, else scattered into a [users, |I|] −inf matrix."""
        interaction, row_idx, positive_u, positive_i = batched_data
        batch_size = len(interaction)
        if batch_size <= self.test_batch_size:
            origin_scores = self._predict_scores(interaction, sst_list)
        else:
            origin_scores = self._spilt_predict(interaction, batch_size, sst_list)

        if self.config["eval_type"] == EvaluatorType.VALUE:
            return interaction, origin_scores, positive_u, positive_i
        col_idx = interaction[self.config["ITEM_ID_FIELD"]].numpy()
        batch_user_num = int(positive_u[-1]) + 1
        scores = np.full((batch_user_num, self.tot_item_num), NEG_INF)
        scores[np.asarray(row_idx), col_idx] = origin_scores.reshape(-1)
        return interaction, scores, positive_u, positive_i

    def _spilt_predict(self, interaction, batch_size, sst_list=None):
        """``predict`` in blocks of ``eval_batch_size`` rows."""
        results = []
        for lo in range(0, batch_size, self.test_batch_size):
            block = interaction[lo : min(lo + self.test_batch_size, batch_size)]
            results.append(self._predict_scores(block, sst_list))
        return np.concatenate(results, axis=0)

    # ----------------------------------------------------------- device paths

    def _fused_eval_ok(self):
        """The device paths cover the top-k / positive-score resources; the
        rank-curve (``rec.meanrank``) and value (``rec.score``,
        ``data.label``) resources take the host paths."""
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

    def _collect_sampled_fused(self, batched_data, sst_list=None):
        """Sampled evaluation on the device: the row, user and positive lanes
        are rebuilt there from the per-user positive counts (each user's
        block is its positives followed by (times − 1) × count negatives),
        the rows go through ``predict``, ``sampled_topk_from_scores`` ranks
        them, and the first negative block's scores are gathered for the
        value-gap metrics. Only the item lane and per-user arrays go to the
        card, and only the O(users · k) payload comes back."""
        from ..ops.eval_fused import sampled_topk_from_scores

        interaction, _, positive_u, positive_i = batched_data
        uid_field = self.config["USER_ID_FIELD"]
        items_cpu = interaction[self.config["ITEM_ID_FIELD"]]
        counts_np = np.bincount(positive_u)
        n_users, n_pos, n_rows = len(counts_np), len(positive_u), len(items_cpu)
        times = n_rows // max(int(counts_np.sum()), 1)
        block_starts = np.concatenate([[0], np.cumsum(counts_np * times)])[:-1]

        dev = self.device
        items = items_cpu.to(dev)
        counts = torch.as_tensor(counts_np, device=dev)
        uid_list = interaction[uid_field][torch.from_numpy(block_starts)].to(dev)
        user_slot = torch.arange(n_users, device=dev)
        row_idx = torch.repeat_interleave(user_slot, counts * times, output_size=n_rows)
        pos_u = torch.repeat_interleave(user_slot, counts, output_size=n_pos)
        starts = torch.as_tensor(block_starts, device=dev)
        cum_pos = torch.cumsum(counts, 0) - counts
        pos_rows = starts[pos_u] + torch.arange(n_pos, device=dev) - cum_pos[pos_u]
        pos_i = items[pos_rows]

        batch = {uid_field: uid_list[row_idx], self.config["ITEM_ID_FIELD"]: items}
        scores = self._get_predict_fn(sst_list)(batch).reshape(-1)
        topk_idx, rec_topk, pos_score = sampled_topk_from_scores(
            scores, row_idx, items, torch.ones_like(scores), pos_u, pos_i,
            torch.ones(n_pos, device=dev), n_users, self.tot_item_num,
            max(self.config["topk"]),
        )
        r = self.eval_collector.register
        extra = {}
        if r.need("rec.negative_score"):
            extra["rec.negative_score"] = scores[pos_rows + counts[pos_u]].cpu().numpy()
        if r.need("data.negative_i"):
            neg_idx = self._neg_block_positions(n_rows, positive_u)
            extra["data.negative_i"] = items_cpu.numpy()[neg_idx]
        self._last_eval_path = "sampled-fused"
        self._emit_fused_payload(
            interaction, positive_u, positive_i, topk_idx, rec_topk, pos_score,
            n_users, n_pos, extra,
        )

    @staticmethod
    def _neg_block_positions(n_rows, positive_u):
        """Row positions of each user's first negative block."""
        k = np.bincount(positive_u)
        k = k[k > 0]
        times = n_rows // max(k.sum(), 1)
        block_starts = np.concatenate([[0], np.cumsum(k * times)])[:-1]
        return np.concatenate(
            [np.arange(s + kj, s + 2 * kj) for s, kj in zip(block_starts, k)]
        )

    def _macro_rows_target(self):
        """Sampled-evaluation rows per device dispatch (``eval_macro_rows``
        is the older name of the key)."""
        val = self.config["eval_macro_rows_sampled"]
        if val is None:
            val = self.config["eval_macro_rows"]
        return val or 4_194_304

    def _macro_batches(self, eval_data, kind):
        """Merge consecutive loader batches into one dispatch of up to
        ``eval_macro_scores`` score cells ([users × |I|]) and, when sampled,
        up to ``_macro_rows_target`` rows; per-user row-block layout is kept
        exactly (indices offset by the running user count). A sampled loader
        that :meth:`set_macro_rows` already sized passes through as it is;
        labeled batches pass through unmerged."""
        target_scores = self.config["eval_macro_scores"] or 32_000_000
        max_users = max(1, target_scores // max(self.tot_item_num or 1, 1))
        target_rows = None if kind == "full" else self._macro_rows_target()
        if getattr(eval_data, "_macro_sized", False):
            yield from eval_data
            return
        buf = []
        acc_users = acc_rows = 0
        for batched_data in eval_data:
            if kind != "full" and batched_data[1] is None:
                yield batched_data
                continue
            buf.append(batched_data)
            if kind == "full":
                acc_users += len(batched_data[0])
            else:
                acc_rows += len(batched_data[0])
                acc_users += int(batched_data[2][-1]) + 1
            if acc_users >= max_users or (target_rows and acc_rows >= target_rows):
                yield self._merge_batches(buf, kind)
                buf, acc_users, acc_rows = [], 0, 0
        if buf:
            yield self._merge_batches(buf, kind)

    @staticmethod
    def _merge_batches(buf, kind):
        if len(buf) == 1:
            return buf[0]
        merged_inter = cat_interactions([b[0] for b in buf])
        pos_u_parts, pos_i_parts, second_parts = [], [], []
        offset = 0
        for inter, second, pos_u, pos_i in buf:
            if kind == "full":
                hist_u, hist_i = second
                second_parts.append((hist_u + offset, hist_i))
                n_users = len(inter)
            else:
                second_parts.append(second + offset)
                n_users = int(pos_u[-1]) + 1
            pos_u_parts.append(pos_u + offset)
            pos_i_parts.append(pos_i)
            offset += n_users
        pos_u = np.concatenate(pos_u_parts)
        pos_i = np.concatenate(pos_i_parts)
        if kind == "full":
            hist = (np.concatenate([p[0] for p in second_parts]),
                    np.concatenate([p[1] for p in second_parts]))
            return merged_inter, hist, pos_u, pos_i
        return merged_inter, np.concatenate(second_parts), pos_u, pos_i

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

    def _collect_batch(self, kind, batched_data, sst_list=None):
        """Score one eval batch and feed the collector: on the device where
        the metrics allow it, else through the host paths."""
        if kind == "full":
            if self._streaming_eval_ok():
                return self._collect_full_sort_streaming(batched_data, sst_list)
            if self._fused_eval_ok():
                self._last_eval_path = "fused"
                return self._collect_full_sort_fused(batched_data, sst_list)
            self._last_eval_path = "host"
            interaction, scores, positive_u, positive_i = self._full_sort_batch_eval(
                batched_data, sst_list
            )
        else:
            if self._fused_eval_ok() and batched_data[1] is not None:
                return self._collect_sampled_fused(batched_data, sst_list)
            self._last_eval_path = "sampled-host"
            interaction, scores, positive_u, positive_i = self._neg_sample_batch_eval(
                batched_data, sst_list
            )
        self.eval_collector.eval_batch_collect(scores, interaction, positive_u, positive_i)

    def _load_best(self, model_file=None):
        from ..quick_start import load_checkpoint

        checkpoint_file = model_file or self.saved_model_file
        self._load_params_from_checkpoint(load_checkpoint(checkpoint_file))
        self.logger.info(f"Loading model structure and parameters from {checkpoint_file}")

    def _prepare_eval(self, eval_data, reset_macro_rows=True):
        """Size the evaluation for ``eval_data``; returns its kind, "full" or
        "sampled". A sampled loader is macro-sized when the device path can
        take its batches; otherwise (``reset_macro_rows``) sized back to the
        config's batches, which the host paths merge themselves."""
        if isinstance(eval_data, FullSortEvalDataLoader):
            kind = "full"
            self._full_sort_pad = eval_data.step
            self._stream_kprime = self._compute_stream_kprime(eval_data)
            if self.item_tensor is None:
                self.item_tensor = eval_data.dataset.get_item_feature()
        else:
            kind = "sampled"
            if self._fused_eval_ok():
                eval_data.set_macro_rows(self._macro_rows_target())
            elif reset_macro_rows:
                eval_data.reset_macro_rows()
        if self.config["eval_type"] == EvaluatorType.RANKING:
            self.tot_item_num = eval_data.dataset.item_num
        return kind

    @torch.no_grad()
    def evaluate(self, eval_data, load_best_model=False, model_file=None, show_progress=False):
        if not eval_data:
            return
        if load_best_model:
            self._load_best(model_file)
        kind = self._prepare_eval(eval_data)
        self.model.eval()
        self.eval_collector.model_collect(self.model)
        for batched_data in self._macro_batches(eval_data, kind):
            self._collect_batch(kind, batched_data)
        struct = self.eval_collector.get_data_struct()
        result = self.evaluator.evaluate(struct)
        self.wandblogger.log_eval_metrics(result, head="eval")
        return result
