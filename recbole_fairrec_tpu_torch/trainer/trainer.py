"""Base Trainer: train step, early stopping, checkpoints, evaluation loop.

Counterpart of ``recbole_fairrec_tpu/trainer/trainer.py``: the optimizer
zoo, the train step and the epoch loop (``fit``), checkpoints and resume,
and evaluation (eval macro-batching, the device and host paths,
``evaluate``).

Training. One step is ``zero_grad`` of the whole model → device negatives
when the loader runs in ``device_neg_sampling`` mode → the model's loss,
the parameters outside the optimizer not requiring grad while it runs →
the gradients of the optimizer's parameters alone → a zero gradient for
each of them that the loss did not reach → gradient clipping over the
optimizer's parameters → the optimizer's step. Every learner follows the JAX package's
update rule (its optax chain), not PyTorch's default where the two differ;
see ``_build_optimizer`` and ``trainer/optim.py``. Batches from the loader
are not padded and carry no ``__weight__``: static shapes are XLA's need, and
the weighted mean over all-ones weights is the plain mean. The epoch loss is
the sum of the step losses, accumulated on the device and read once per
epoch. ``train_macro_steps`` and ``train_macro_rows`` (the JAX package's
fusing of steps into one dispatch, which changes no result there) are
accepted and ignored.

Resident epochs (``device_epoch_shuffle: True``, JAX's eligibility rule in
``_resident_epoch_ok``: the loader in ``device_neg_sampling`` mode, a model
with negatives and declared loss fields — BPR-MF and both PFCN passes). The
loss's columns of every train row, user and item features joined, live on
the device as one table padded with zero rows to whole batches, with a
``__weight__`` of 1 for real rows and 0 for pad rows (built once per
dataset, field set and size). An epoch draws one permutation of the padded
rows and the negatives of the whole pass on the trainer's device generator,
then runs its steps from device slices of the table: no host→device batch
copy, no host read until the epoch's loss. Pad rows fall inside the random
batches and carry weight 0 through the weighted means and BatchNorm
statistics. The loader is not iterated, so its in-place shuffle does not
run, and the row order is drawn on the device, not from numpy's stream.

Evaluation takes the JAX package's paths (``_collect_batch``):

* full-sort, dense (default): ``full_sort_predict`` scores ``[B, |I|]`` with
  ``torch.matmul``, then ``ops.eval_fused.full_sort_eval_step`` masks PAD and
  history and takes the top-k on the device;
* full-sort, streaming (``streaming_eval: True``, monotone models only): the
  model's retrieval embeddings go through ``ops.fused_topk.fused_topk_scores``
  for k' = k + max_history + 1 candidates — the hand-written CUDA kernel on a
  card, its plain version on the CPU; under ``use_pallas: False`` the plain
  tiled ``ops.topk.streaming_topk_scores`` on the CPU, refused on the card
  — and PAD/history are filtered on the host;
* sampled (``uni100`` / ``pop100``): ``_collect_sampled_fused`` rebuilds the
  row lanes on the device from per-user counts, runs ``predict`` and
  ``ops.eval_fused.sampled_topk_from_scores``;
* host: the rank-curve metric (GAUC, ``rec.meanrank``) and the value metrics
  (AUC, LogLoss, MAE, RMSE: ``rec.score``, ``data.label``; labeled
  evaluation) need every score on the host. The model still scores on the
  trainer's device (``_full_sort_scores``, ``_neg_sample_batch_eval``); the
  collector ranks in numpy.

Deferred emits: the two device paths (dense full-sort and sampled) launch
their work and return a closure that copies the O(users · k) payload to the
host and feeds the collector; ``evaluate`` keeps the closures in batch order
and drains them after the loop (``_drain_collect``), so the card scores
batch k while the host loads batch k+1. The host→device copies of those
paths go through pinned memory without waiting for the card. The streaming
and host paths feed the collector inside the call.

``_last_eval_path`` names the path that ran.

Sharded execution (``mesh_shape: [data, model]``, the JAX package's rules on
``torch.distributed``; see ``parallel/``). ``__init__`` builds the mesh over
the process group's ranks, keeps this rank's rows of ``user_embedding`` /
``item_embedding`` where their rows divide the model axis (before any
optimizer is built, so each rank's optimizers step their own shards) and
replicates the rest. Every rank runs the same host pipeline with the same
seed, so each builds the same global batch; a step draws the device
negatives of the whole batch, keeps this rank's rows on the data axis where
they divide it (else the whole batch), runs the loss with the split active
(its batch reductions are global), averages the gradients over the data
group (never over ``model``) and clips by the norm of the whole parameter
set. Evaluation is replicated over ``data``; under a model axis with
``distributed_eval`` (``_distributed_eval_ok``) the streaming path takes the
item-sharded top-k (``_last_eval_path = "distributed"``). Checkpoints hold
whole tables and are written by rank 0 under a name all ranks share.
"""

from __future__ import annotations

import itertools
import os
import pickle
import weakref
from logging import getLogger
from time import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataloader import FullSortEvalDataLoader
from ..data.interaction import Interaction, cat_interactions
from ..evaluator import Collector, Evaluator
from ..parallel import (
    batch_sharding,
    batch_split,
    distributed_topk_scores,
    make_mesh,
    pad_table_rows,
    shard_params,
    shard_table,
)
from ..parallel.collectives import all_gather_rows
from ..utils import (
    EvaluatorType,
    _bucket,
    calculate_valid_score,
    dict2str,
    early_stopping,
    ensure_dir,
    get_local_time,
    set_color,
    tracing,
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
        self.mesh = None
        if config["mesh_shape"]:
            self._setup_mesh(config["mesh_shape"])

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
        self._resident_key = self._resident_cache = None
        self.optimizer = self._build_optimizer()

        self.eval_type = config["eval_type"]
        self.eval_collector = Collector(config)
        self.evaluator = Evaluator(config)
        self.tot_item_num = None
        self.test_batch_size = config["eval_batch_size"]
        self.item_tensor = None

    # ----------------------------------------------------------------- mesh

    def _setup_mesh(self, mesh_shape):
        """Build the mesh, shard the tables and share rank 0's checkpoint
        name (see the module doc)."""
        self.mesh = make_mesh(tuple(mesh_shape), device_type=self.device.type)
        shard_params(self.mesh, self.model)
        names = [self.saved_model_file]
        dist.broadcast_object_list(names, src=0)
        self.saved_model_file = names[0]
        # the JAX package's two lookups (embedding_exchange: allgather or not)
        # compute one function; here both are the exchange
        self.logger.info(f"sharded execution over mesh {self.mesh.shape}, lookups by the "
                         f"exchange (embedding_exchange: {self.config['embedding_exchange']})")

    def _write_pickle(self, path, payload):
        """``pickle.dump`` of ``payload`` into ``path``: by rank 0 under a
        mesh, the other ranks waiting until the file is there."""
        if self.mesh is None or dist.get_rank() == 0:
            with open(path, "wb") as f:
                pickle.dump(payload, f)
        if self.mesh is not None:
            dist.barrier()

    def _average_over_data(self, params):
        """Average the gradients of ``params`` over the data group, in one
        all-reduce of their concatenation."""
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.group("data"))
        flat /= self.mesh.shape["data"]
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def _param_shards(self):
        """id of a row-sharded table's weight → its RowShard."""
        return {id(self.model.get_parameter(f"{name}.weight")): shard
                for name, shard in getattr(self.model, "row_shards", {}).items()}

    @torch.no_grad()
    def _sharded_grad_norms(self, params):
        """Each gradient's norm, a row-sharded table's over all its shards
        (the squares summed over the model axis)."""
        sharded = self._param_shards()
        norms = [torch.linalg.vector_norm(p.grad) for p in params]
        if self.mesh.shape["model"] > 1 and any(id(p) in sharded for p in params):
            sq = torch.stack([n * n for p, n in zip(params, norms) if id(p) in sharded])
            dist.all_reduce(sq, group=self.mesh.group("model"))
            it = iter(torch.sqrt(sq))
            norms = [next(it) if id(p) in sharded else n for p, n in zip(params, norms)]
        return norms

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

    def _step_params(self, optimizer):
        """(``optimizer``'s parameters, the model's other parameters),
        worked out once per optimizer."""
        cache = self.__dict__.setdefault("_step_param_cache", weakref.WeakKeyDictionary())
        entry = cache.get(optimizer)
        if entry is None:
            params = [p for group in optimizer.param_groups for p in group["params"]]
            ids = {id(p) for p in params}
            entry = cache[optimizer] = (
                params, [p for p in self.model.parameters() if id(p) not in ids])
        return entry

    @tracing.traced("trainer.step")
    def _train_step(self, batch, loss_name, sst_list, optimizer):
        """One optimizer step on ``batch``; returns the loss (a detached
        scalar on the device, not read here).

        Only the gradients of ``optimizer``'s parameters are computed
        (``torch.autograd.grad``), and the other parameters' are cleared: a
        loss may reach parameters outside ``optimizer`` (the PFCN filter
        step's loss reaches the discriminators; FairGo's discriminator loss
        reaches the filters through the propagation hops), which another
        optimizer steps later, and backprop does no work for them. A
        parameter of ``optimizer`` that the loss does not reach (a filter of
        another subset) gets a zero gradient, so its update rule still runs —
        moments decay, weight decay applies, the step count advances — as the
        JAX package's masked optax chain does.

        While the loss runs, the model's parameters outside ``optimizer``
        do not require grad (each gets its own flag back after, so frozen
        ones stay frozen): the gradients are the same, and the model can see
        which of its parameters the step differentiates (FairGo keeps its
        filtered table and hops across discriminator steps)."""
        self.model.zero_grad(set_to_none=True)
        batch = self._inject_negatives(batch, loss_name)
        split = None
        if self.mesh is not None:
            batch, split = batch_sharding(self.mesh, batch)
        params, outside = self._step_params(optimizer)
        flags = [p.requires_grad for p in outside]
        for p in outside:
            p.requires_grad_(False)
        try:
            with batch_split(split):
                loss = getattr(self.model, loss_name)(batch, sst_list=sst_list)
                grads = (torch.autograd.grad(loss, params, allow_unused=True)
                         if loss.requires_grad else [None] * len(params))
        finally:
            for p, flag in zip(outside, flags):
                p.requires_grad_(flag)
        for p, g in zip(params, grads):
            p.grad = g
        if split is not None:
            self._average_over_data([p for p in params if p.grad is not None])
        missing = [p for p in params if p.grad is None]
        if missing:  # views of one zero buffer: one allocation, not one per parameter
            flat = torch.zeros(sum(p.numel() for p in missing), dtype=missing[0].dtype,
                               device=missing[0].device)
            for p, g in zip(missing, flat.split([p.numel() for p in missing])):
                p.grad = g.view_as(p)
        if self.clip_grad_norm:
            norms = None if self.mesh is None else self._sharded_grad_norms(params)
            clip_by_global_norm(params, self.clip_grad_norm.get("max_norm", 1.0), norms)
        optimizer.step()
        return loss.detach()

    def _run_epoch(self, train_data, loss_name="calculate_loss", sst_list=None, tx_tag="main"):
        """One pass over the loader with the given (loss, sst subset,
        optimizer) selection, resident on the device when
        ``_resident_epoch_ok``. Returns the sum of the step losses (one host
        read), or None for an empty loader. Traced as ``trainer.pass``, the
        root of the pass's steps and fetches."""
        with tracing.span("trainer.pass") as sp:
            sp.set("tx_tag", tx_tag)
            sp.set("sst_list", sst_list)
            self._maybe_enable_device_sampling(train_data)
            resident = self._resident_epoch_ok(train_data, loss_name, sst_list)
            sp.set("resident", resident)
            if resident:
                total = self._run_epoch_resident(train_data, loss_name, sst_list, tx_tag)
            else:
                optimizer = self._tx_by_tag(tx_tag)
                fields = self.model.loss_batch_fields(loss_name, sst_list)
                self.model.train()
                total_loss = None
                for interaction in train_data:
                    loss = self._train_step(
                        self._train_batch(interaction, fields), loss_name, sst_list, optimizer
                    )
                    total_loss = loss if total_loss is None else total_loss + loss
                total = self._epoch_total(total_loss)
            sp.set("loss", total)
            return total

    def _epoch_total(self, total_loss):
        if total_loss is None:
            return None
        total = float(tracing.to_host(total_loss))  # single sync per epoch
        self._check_nan(total)
        return total

    # ------------------------------------------------------ resident epochs

    def _resident_epoch_ok(self, train_data, loss_name, sst_list):
        """The JAX package's rule: ``device_epoch_shuffle`` on, the loader in
        ``device_neg_sampling`` mode (it ships raw interaction rows; the
        pointwise loaders expand labels or group items on the host, which
        the table does not reproduce), a model with negatives and with the
        loss's fields declared. BPR-MF and both PFCN passes qualify; FairGo,
        FOCF and NFCF keep the loader's loop."""
        return (
            bool(self.config["device_epoch_shuffle"])
            and getattr(train_data, "device_neg_sampling", False)
            and hasattr(self.model, "NEG_ITEM_ID")
            and self.model.loss_batch_fields(loss_name, sst_list) is not None
        )

    def _resident_tables(self, train_data, fields):
        """The train table on the device: ``fields`` of ``dataset[0:n]``
        (user and item features joined) padded with zero rows to ``n_pad =
        n_steps · batch`` rows, and ``__weight__`` (1 real, 0 pad). Built
        from the dataset's row order at the first call and kept for that
        dataset, field set and size. Returns (tables, n_steps, batch)."""
        ds = train_data.dataset
        n = len(ds.inter_feat)
        batch = train_data.batch_size
        n_steps = -(-n // batch)
        n_pad = n_steps * batch
        key = (ds, tuple(sorted(fields)), n_pad)
        if self._resident_key != key:
            joined = ds[0:n]
            tables = {}
            for f in sorted(fields):
                col = joined[f]
                pad = torch.zeros((n_pad - n,) + tuple(col.shape[1:]), dtype=col.dtype)
                tables[f] = torch.cat([col, pad]).to(self.device)
            weight = torch.zeros(n_pad, dtype=torch.float32)
            weight[:n] = 1.0
            tables["__weight__"] = weight.to(self.device)
            self._resident_key = key
            self._resident_cache = (tables, n_steps, batch)
        return self._resident_cache

    def _resident_epoch(self, tables, n_steps, batch, loss_name, sst_list, optimizer,
                        perm=None, negatives=None):
        """One pass over the resident table: a permutation of its rows cut
        into ``[n_steps, batch]``, the negatives of the whole pass in one
        ``sample_negatives`` call (the rec loss only; the discriminator
        pass draws none), then the steps from device slices. ``perm``
        (``[n_steps · batch]``) and ``negatives`` (one per permuted row)
        replace the draws when given: a test seam, as the parity tests
        inject the JAX package's order and negatives. Returns the summed
        loss on the device."""
        from ..ops.neg_sampling import sample_negatives

        model, dev = self.model, self.device
        if perm is None:
            perm = torch.randperm(n_steps * batch, generator=self.generator, device=dev)
        perm = torch.as_tensor(perm).to(dev).long().reshape(n_steps, batch)
        stacked = {key: value[perm] for key, value in tables.items()}
        if loss_name == "calculate_loss":
            if negatives is None:
                negatives = sample_negatives(
                    self.generator, stacked[model.USER_ID].reshape(-1),
                    self._device_used_keys, model.n_items,
                )
            stacked[model.NEG_ITEM_ID] = torch.as_tensor(negatives).to(dev).reshape(
                n_steps, batch
            ).long()
        total = None
        for s in range(n_steps):
            loss = self._train_step(
                {key: value[s] for key, value in stacked.items()}, loss_name, sst_list,
                optimizer,
            )
            total = loss if total is None else total + loss
        return total

    def _run_epoch_resident(self, train_data, loss_name="calculate_loss", sst_list=None,
                            tx_tag="main", perm=None, negatives=None):
        """A resident pass (see the module doc); ``perm`` and ``negatives``
        as in :meth:`_resident_epoch`."""
        fields = set(self.model.loss_batch_fields(loss_name, sst_list))
        fields -= {self.model.NEG_ITEM_ID, "__weight__"}  # drawn; added by the table
        tables, n_steps, batch = self._resident_tables(train_data, fields)
        self.model.train()
        total = self._resident_epoch(tables, n_steps, batch, loss_name, sst_list,
                                     self._tx_by_tag(tx_tag), perm, negatives)
        return self._epoch_total(total)

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
        with tracing.span("trainer.valid") as sp:
            sp.set("subsets", 1)
            valid_result = self.evaluate(valid_data, load_best_model=False,
                                         show_progress=show_progress)
            valid_score = calculate_valid_score(valid_result, self.valid_metric)
        return valid_score, valid_result

    def _save_sst_embed(self, data):
        """Export user embeddings + sensitive attributes for offline
        attackers. The base trainer names no file for them (nor does the JAX
        package's); the model families' trainers override this."""
        raise NotImplementedError(
            "save_sst_embed: the base Trainer exports no embeddings; PFCNTrainer "
            "(filter_mode: none included) and the FairGo trainers do"
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
            batch[key] = self._h2d(value)
        if target > n:
            w = torch.zeros(target, dtype=torch.float32)
            w[:n] = 1.0
            batch["__weight__"] = self._h2d(w)
        return batch

    def _h2d(self, tensor):
        """A host tensor on the trainer's device. To the card it goes through
        pinned memory without waiting: the copy is ordered on the stream
        behind the kernels already queued, and the host goes on."""
        if self.device.type != "cuda":
            return tensor.to(self.device)
        return tensor.pin_memory().to(self.device, non_blocking=True)

    def _tensor(self, array):
        return self._h2d(torch.from_numpy(np.ascontiguousarray(array)))

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

    def _sharded_slots(self, optimizer):
        """Optimizer state index → RowShard, for the row-sharded tables."""
        shards = self._param_shards()
        params = [p for group in optimizer.param_groups for p in group["params"]]
        return {i: shards[id(p)] for i, p in enumerate(params) if id(p) in shards}

    def _optimizer_payload(self, optimizer):
        """An optimizer's ``state_dict`` with numpy leaves (the checkpoint
        holds no torch object, so the JAX package can read it); under a mesh
        the state of a row-sharded table is gathered whole."""
        state = optimizer.state_dict()  # its per-parameter dicts are the live state
        state["state"] = {i: dict(slots) for i, slots in state["state"].items()}
        for i, shard in self._sharded_slots(optimizer).items():
            slots = state["state"].get(i, {})
            for key, value in slots.items():
                if torch.is_tensor(value) and value.dim() > 0:
                    slots[key] = all_gather_rows(value, self.mesh.group(shard.axis))
        return _tree_map_tensors(lambda t: tracing.to_host(t.detach()).numpy(), state,
                                 torch.Tensor)

    def _load_optimizer_payload(self, optimizer, payload):
        """Restore ``optimizer`` from a checkpoint's ``optimizer`` entry: the
        port's own payload, or the JAX package's optax state of the same learner
        (``utils/jax_params.py::load_jax_opt_state``). Under a mesh a
        row-sharded table keeps its rows of the whole state."""
        if isinstance(payload, dict) and "param_groups" in payload:
            payload = _tree_map_tensors(torch.as_tensor, payload, np.ndarray)
            for i, shard in self._sharded_slots(optimizer).items():
                slots = payload["state"].get(i, {})
                for key, value in slots.items():
                    if value.dim() > 0 and value.shape[0] == shard.rows:
                        slots[key] = value[shard.lo:shard.hi]
            optimizer.load_state_dict(payload)
        else:
            load_jax_opt_state(optimizer, self.model, payload)

    def _save_checkpoint(self, epoch, verbose=True, **kwargs):
        saved_model_file = kwargs.pop("saved_model_file", self.saved_model_file)
        self._write_pickle(saved_model_file, self._checkpoint_payload(epoch))
        if verbose:
            self.logger.info(set_color("Saving current", "blue") + f": {saved_model_file}")

    def _load_params_from_checkpoint(self, checkpoint):
        load_jax_params(self.model, checkpoint["params"], checkpoint.get("model_state"))
        self.model.load_other_parameter(checkpoint.get("other_parameter"))

    def resume_checkpoint(self, resume_file):
        """Continue a run from a checkpoint written by this package or by the
        JAX package (whose Adam, Adagrad or RMSprop state is mapped onto the
        same learner's, and raises for another learner): epoch, step, best
        score, parameters and BatchNorm statistics, optimizers."""
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
        return tracing.to_host(out.reshape(-1)[:n]).numpy()

    # ------------------------------------------------------------ host paths

    def _full_sort_scores(self, interaction, sst_list=None):
        """The full-catalogue scores of a user batch, on the host (float64)."""
        n = len(interaction)
        pad_to = getattr(self, "_full_sort_pad", None) or n
        batch = self._to_batch(interaction, pad_to=max(pad_to, n))
        scores = self._get_full_sort_fn(sst_list)(batch)
        scores = tracing.to_host(scores.reshape(-1, self.tot_item_num)[:n]).numpy()
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

        def emit():
            self._emit_fused_payload(
                interaction, positive_u, positive_i, topk_idx, rec_topk, pos_score, n, n_pos,
            )

        return emit

    def _emit_fused_payload(
        self, interaction, positive_u, positive_i, topk_idx, rec_topk, pos_score,
        n_rows, n_pos, extra=None,
    ):
        r = self.eval_collector.register
        payload = dict(extra or {})
        if r.need("rec.items"):
            payload["rec.items"] = tracing.to_host(topk_idx[:n_rows]).numpy()
        if r.need("rec.topk"):
            payload["rec.topk"] = tracing.to_host(rec_topk[:n_rows]).numpy()
        if r.need("rec.positive_score"):
            payload["rec.positive_score"] = tracing.to_host(pos_score[:n_pos]).numpy()
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
        card, and only the O(users · k) payload comes back, when the
        returned closure is called."""
        from ..ops.eval_fused import sampled_topk_from_scores

        interaction, _, positive_u, positive_i = batched_data
        uid_field = self.config["USER_ID_FIELD"]
        items_cpu = interaction[self.config["ITEM_ID_FIELD"]]
        counts_np = np.bincount(positive_u)
        n_users, n_pos, n_rows = len(counts_np), len(positive_u), len(items_cpu)
        times = n_rows // max(int(counts_np.sum()), 1)
        block_starts = np.concatenate([[0], np.cumsum(counts_np * times)])[:-1]

        dev = self.device
        items = self._h2d(items_cpu)
        counts = self._tensor(counts_np)
        uid_list = self._h2d(interaction[uid_field][torch.from_numpy(block_starts)])
        user_slot = torch.arange(n_users, device=dev)
        row_idx = torch.repeat_interleave(user_slot, counts * times, output_size=n_rows)
        pos_u = torch.repeat_interleave(user_slot, counts, output_size=n_pos)
        starts = self._tensor(block_starts)
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
        neg_score = scores[pos_rows + counts[pos_u]] if r.need("rec.negative_score") else None
        self._last_eval_path = "sampled-fused"

        def emit():
            extra = {}
            if neg_score is not None:
                extra["rec.negative_score"] = tracing.to_host(neg_score).numpy()
            if r.need("data.negative_i"):
                neg_idx = self._neg_block_positions(n_rows, positive_u)
                extra["data.negative_i"] = items_cpu.numpy()[neg_idx]
            self._emit_fused_payload(
                interaction, positive_u, positive_i, topk_idx, rec_topk, pos_score,
                n_users, n_pos, extra,
            )

        return emit

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
        k' = k + max_history + 1 candidates with the fused top-k (on the
        CPU under ``use_pallas: False``, the plain tiled
        ``streaming_topk_scores``; the card has no plain path and refuses
        the key), then filters PAD + history and builds collector payloads
        on the host. Exact for models whose full-sort score is a strictly
        monotone transform of the retrieval dot product."""
        from ..ops.fused_topk import fused_topk_scores
        from ..ops.topk import streaming_topk_scores

        if self.config["use_pallas"] is False and self.device.type == "cuda":
            raise NotImplementedError(
                "use_pallas: False on the card: streaming evaluation there runs the "
                "fused_topk CUDA kernel and has no plain path; leave use_pallas at True, "
                "or take the dense path (streaming_eval: False)"
            )
        interaction, history_index, positive_u, positive_i = batched_data
        B = len(interaction)
        pad_to = max(getattr(self, "_full_sort_pad", None) or B, _bucket(B, 512))
        batch = self._to_batch(interaction, pad_to=pad_to)
        user_repr, item_table = self._get_retrieval_fn(sst_list)(batch)

        max_k = max(self.config["topk"])
        k_prime = getattr(self, "_stream_kprime", None) or (max_k + 1)
        if self._distributed_eval_ok():
            # this rank's rows of the padded table; candidates merged over the model axis
            table, n_valid = pad_table_rows(item_table, self.mesh.shape["model"])
            _, cand_i = distributed_topk_scores(
                self.mesh, user_repr.contiguous(), shard_table(self.mesh, table).contiguous(),
                k_prime, valid_rows=n_valid,
            )
            self._last_eval_path = "distributed"
        elif self.config["use_pallas"] is False:
            _, cand_i = streaming_topk_scores(user_repr, item_table, k_prime)
            self._last_eval_path = "streaming"
        else:
            _, cand_i = fused_topk_scores(
                user_repr.contiguous(), item_table.contiguous(), k_prime
            )
            self._last_eval_path = (
                "streaming-kernel" if user_repr.device.type == "cuda" else "streaming"
            )
        cand_i = tracing.to_host(cand_i[:B]).numpy()

        # indices at or past the catalogue are the distributed merge's sentinels
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

    def _distributed_eval_ok(self):
        """The JAX package's rule: under a model axis, the item-sharded top-k
        when ``distributed_eval`` is True, or by default (None) only where
        ``streaming_eval`` is opted into (retrieval-form ranking breaks
        head-score ties differently from the dense path)."""
        cfg = self.config["distributed_eval"]
        opted_in = cfg is True or (cfg is None and self.config["streaming_eval"])
        return (
            self.mesh is not None
            and self.mesh.shape.get("model", 1) > 1
            and opted_in
            and self._retrieval_eval_capable()
        )

    @staticmethod
    def _drain_collect(pending):
        """Call the deferred emits of ``_collect_batch`` in batch order (a
        path that fed the collector itself left None): the payloads' copies
        to the host, which wait for the device's scoring, and the collector."""
        with tracing.span("trainer.drain") as sp:
            sp.set("batches", len(pending))
            for emit in pending:
                if emit is not None:
                    emit()
            pending.clear()

    def _collect_batch(self, kind, batched_data, sst_list=None):
        """Score one eval batch: on the device where the metrics allow it,
        else through the host paths. The device paths return the closure
        that feeds the collector (see ``_drain_collect``); the others feed
        it here and return None. Traced as ``trainer.collect_batch``."""
        with tracing.span("trainer.collect_batch") as sp:
            sp.set("rows", len(batched_data[0]))
            emit = self._collect_batch_on_path(kind, batched_data, sst_list)
            sp.set("path", self._last_eval_path)
            return emit

    def _collect_batch_on_path(self, kind, batched_data, sst_list):
        if kind == "full":
            if self._distributed_eval_ok() or self._streaming_eval_ok():
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
        pending = [self._collect_batch(kind, batched_data)
                   for batched_data in self._macro_batches(eval_data, kind)]
        self._drain_collect(pending)
        struct = self.eval_collector.get_data_struct()
        result = self.evaluator.evaluate(struct)
        self.wandblogger.log_eval_metrics(result, head="eval")
        return result
