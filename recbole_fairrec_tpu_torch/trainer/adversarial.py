"""Adversarial trainers: the PFCN family (filters against discriminators)
and FairGo (pretrain, then adversarial finetune).

Counterpart of ``recbole_fairrec_tpu/trainer/adversarial.py``. PFCN:

* training: each epoch draws a random non-empty subset of the sensitive
  attributes (numpy's global generator, as the JAX package draws it, so
  equal seeds give equal subsets and batch orders); every
  ``train_epoch_interval``-th epoch runs a filter pass (backbone + filters,
  loss = BPR − dis_weight · discriminator loss) with the filter optimizer,
  then every epoch a discriminator pass with the discriminator optimizer.
  The two are Adam instances over disjoint parameter groups
  (``model.param_groups()``); ``_train_epoch`` returns
  ``(filter_loss, dis_loss)``, 0.0 for a skipped pass;
* validation collects every non-empty attribute subset into ONE result
  dict; the final ``evaluate`` loads the best checkpoint by default and
  returns one dict per subset, keyed ``'{filter_mode}-{sst_list}'``
  (``"sm-['gender', 'age']"``), or ``{"none": ...}`` without filters;
* checkpoints carry ``optimizer_filter`` / ``optimizer_dis`` (``None``
  without filters); ``save_sst_embed`` exports the user representations per
  subset of up to three attributes.

FairGo (``FairGoTrainer``):

* the stage comes from the config: ``pretrain_model_file_path`` loads that
  checkpoint and finetunes, ``load_pretrain_weight`` finetunes from the
  dataset's preloaded tables, otherwise ``fit`` first pretrains the backbone
  for ``pretrain_epochs`` (the ``pretrain`` optimizer), saves
  ``<model>-<dataset>-pretrain.pth``, reloads it and resets the counters,
  then finetunes: every ``train_epoch_interval``-th epoch a filter pass
  (loss = MSE − fair_weight · discriminator loss, the ``filter`` optimizer),
  every epoch a discriminator pass (the ``dis`` optimizer); ``_train_epoch``
  returns ``(dis_loss, filter_loss)``, the reverse of PFCN's order;
* three Adam instances over disjoint groups (``model.param_groups()``); a
  step computes only its group's gradients (``Trainer._train_step``), so a
  discriminator step does not backprop through the propagation hops into
  the filters;
* ``evaluate`` reports ``pretrain-*`` (from the pretrain checkpoint) and
  ``finetune-*`` metrics (from the best finetune checkpoint);
* checkpoints carry ``optimizer_filter``, ``optimizer_dis`` and
  ``train_stage``; ``save_sst_embed`` writes the pretrained users beside
  the pretrain checkpoint and the finetuned ones at the end.
"""

from __future__ import annotations

import itertools
import os
from time import time

import numpy as np
import torch

from ..evaluator import Collector, Evaluator
from ..utils import calculate_valid_score, dict2str, early_stopping, set_color, tracing
from .trainer import Trainer


def _draw_sst_mask(sst_attrs):
    """Random non-empty subset of the sensitive attributes, drawn from
    numpy's global generator exactly as the JAX package draws it."""
    mask = np.zeros(len(sst_attrs))
    while mask.sum() == 0:
        mask = np.random.choice([0, 1], len(sst_attrs))
    return tuple(s for s, m in zip(sst_attrs, mask) if m != 0)


class PFCNTrainer(Trainer):
    def __init__(self, config, model):
        super().__init__(config, model)
        self.filter_mode = config["filter_mode"].lower()
        self.train_epoch_interval = config["train_epoch_interval"]
        if self.filter_mode != "none":
            self.sst_attrs = list(config["sst_attr_list"])
            self.sst_num = len(self.sst_attrs)
            groups = self.model.param_groups()
            self.tx_filter = self._masked_tx(groups["filter"])
            self.tx_dis = self._masked_tx(groups["dis"])

    def _tx_by_tag(self, tag):
        if tag == "filter":
            return self.tx_filter
        if tag == "dis":
            return self.tx_dis
        return self.optimizer

    # --------------------------------------------------------------- training

    def _train_epoch(self, train_data, epoch_idx, loss_func=None, show_progress=False):
        if self.filter_mode == "none":
            return self._run_epoch(train_data, "calculate_loss", None, "main")
        filter_loss = 0.0
        sst_list = _draw_sst_mask(self.sst_attrs)
        if epoch_idx % self.train_epoch_interval == 0:
            self.logger.info("Train Filter and Base model")
            filter_loss = self._run_epoch(train_data, "calculate_loss", sst_list, "filter")
        self.logger.info("Train Discriminator")
        dis_loss = self._run_epoch(train_data, "calculate_dis_loss", sst_list, "dis")
        return filter_loss, dis_loss

    # ------------------------------------------------------------- evaluation

    def _sst_subsets(self):
        return [subset for i in range(1, self.sst_num + 1)
                for subset in itertools.combinations(self.sst_attrs, i)]

    def _collect(self, eval_data, kind, subsets):
        """Feed every macro batch of ``eval_data`` to the collector once per
        subset in ``subsets`` (batches outside, subsets inside): one pass over
        the loader, so a sampled loader draws its negatives once for all of
        them. The device paths' emits are drained after the pass, in that
        order."""
        pending = []
        for batched_data in self._macro_batches(eval_data, kind):
            for sst_list in subsets:
                pending.append(self._collect_batch(kind, batched_data, sst_list))
        self._drain_collect(pending)
        self.eval_collector.model_collect(self.model)
        return self.evaluator.evaluate(self.eval_collector.get_data_struct())

    @torch.no_grad()
    def _evaluate_groups(self, eval_data, groups, load_best_model, model_file):
        """One result dict per group of subsets, one pass over the loader per
        group (each group of a sampled loader sees fresh negatives), after
        loading the best checkpoint when asked.

        As in the JAX package, a loader that an earlier device evaluation
        macro-sized is not sized back when the host path runs: the per-user
        negative draws (in user order) and the per-user metrics do not depend
        on where batches end, so neither do the results."""
        if load_best_model:
            self._load_best(model_file)
        kind = self._prepare_eval(eval_data, reset_macro_rows=False)
        self.model.eval()
        return [self._collect(eval_data, kind, subsets) for subsets in groups]

    def pfcn_evaluate(self, eval_data, load_best_model=True, model_file=None,
                      show_progress=False):
        """Validation-style eval: every attribute subset collected into ONE
        result dict."""
        if not eval_data:
            return
        subsets = self._sst_subsets() if self.filter_mode != "none" else [None]
        return self._evaluate_groups(eval_data, [subsets], load_best_model, model_file)[0]

    def _valid_epoch(self, valid_data, show_progress=False):
        with tracing.span("trainer.valid") as sp:
            if sp:
                sp.set("subsets", len(self._sst_subsets()) if self.filter_mode != "none" else 1)
            valid_result = self.pfcn_evaluate(
                valid_data, load_best_model=False, show_progress=show_progress
            )
            valid_score = calculate_valid_score(valid_result, self.valid_metric)
        return valid_score, valid_result

    def evaluate(self, eval_data, load_best_model=True, model_file=None, show_progress=False):
        """Final eval: one result dict PER subset, keyed
        ``'{filter_mode}-{sst_list}'``; without filters the one key is
        ``"none"``."""
        if not eval_data:
            return
        mode = self.config["filter_mode"]
        if self.filter_mode == "none":
            keys, groups = [str(mode)], [[None]]
        else:
            subsets = self._sst_subsets()
            keys, groups = [f"{mode}-{list(s)}" for s in subsets], [[s] for s in subsets]
        return dict(zip(keys, self._evaluate_groups(eval_data, groups, load_best_model,
                                                    model_file)))

    # ------------------------------------------------------------ checkpoints

    def _checkpoint_payload(self, epoch):
        payload = super()._checkpoint_payload(epoch)
        filtered = self.filter_mode != "none"
        payload["optimizer_filter"] = self._optimizer_payload(self.tx_filter) if filtered else None
        payload["optimizer_dis"] = self._optimizer_payload(self.tx_dis) if filtered else None
        return payload

    def _load_optimizers(self, checkpoint):
        """The main optimizer, and the filter and discriminator optimizers
        when the model has filters; from the port's payloads or the JAX
        package's masked optax states (``utils/jax_params.py::load_jax_opt_state``)."""
        super()._load_optimizers(checkpoint)
        if self.filter_mode != "none":
            self._load_optimizer_payload(self.tx_filter, checkpoint["optimizer_filter"])
            self._load_optimizer_payload(self.tx_dis, checkpoint["optimizer_dis"])

    def _save_sst_embed(self, data):
        """Write the best checkpoint's user representations and the users'
        sensitive attributes beside the checkpoints: one file per subset of
        up to three attributes, ``<model>_embed-<mode>-[a_b].pth``, or
        ``<model>_embed-none.pth`` without filters. After
        ``fit(saved=False)`` there is no checkpoint and the current
        parameters are exported, with a warning."""
        if os.path.isfile(self.saved_model_file):
            self._load_best()
        else:
            self.logger.warning(
                "save_sst_embed: no checkpoint on disk (fit ran with "
                "saved=False); exporting CURRENT params, not best-valid."
            )
        user_features = data.dataset.get_user_feature()[1:]
        model, mode = self.config["model"], self.config["filter_mode"]
        if self.filter_mode == "none":
            exports = {f"{model}_embed-{mode}.pth": None}
        else:
            attrs = self.config["sst_attr_list"]
            exports = {
                f'{model}_embed-{mode}-[{"_".join(subset)}].pth': tuple(subset)
                for i in range(1, min(self.sst_num, 3) + 1)
                for subset in itertools.combinations(attrs, i)
            }
        for fname, sst_list in exports.items():
            stored = self.model.get_sst_embed(user_features, sst_list)
            self._write_pickle(os.path.join(self.checkpoint_dir, fname), stored)


class FairGoTrainer(Trainer):
    """Two-stage pretrain → adversarial-finetune trainer; see the module
    doc."""

    def __init__(self, config, model):
        super().__init__(config, model)
        self.train_epoch_interval = config["train_epoch_interval"]
        self.sst_attrs = list(config["sst_attr_list"])
        self.load_pretrain_weight = config["load_pretrain_weight"]
        groups = self.model.param_groups()
        self.tx_pretrain = self._masked_tx(groups["pretrain"])
        self.tx_filter = self._masked_tx(groups["filter"])
        self.tx_dis = self._masked_tx(groups["dis"])
        self.saved_pretrain_model_file = config["pretrain_model_file_path"]
        if self.saved_pretrain_model_file is not None:
            from ..quick_start import load_checkpoint

            self._load_params_from_checkpoint(load_checkpoint(self.saved_pretrain_model_file))
            self.logger.info("Loading pretrain model structure and parameters from "
                             f"{self.saved_pretrain_model_file}")
            self.model.train_stage = "finetune"
        elif self.load_pretrain_weight:
            self.model.train_stage = "finetune"
        else:
            self.model.train_stage = "pretrain"
            self.pretrain_epochs = config["pretrain_epochs"]
        fname = "{}-{}_embed-[{}].pth".format(
            config["model"], config["aggr_method"], "_".join(self.sst_attrs))
        self.saved_sst_embed_file = os.path.join(self.checkpoint_dir, fname)

    def _tx_by_tag(self, tag):
        return {"pretrain": self.tx_pretrain, "filter": self.tx_filter,
                "dis": self.tx_dis}.get(tag, self.optimizer)

    # ------------------------------------------------------------------ fit

    def reset_params(self):
        """Reset the counters between the stages and switch to finetune."""
        config = self.config
        self.epochs = config["epochs"]
        self.eval_step = min(config["eval_step"], self.epochs)
        self.start_epoch = 0
        self.cur_step = 0
        self.best_valid_score = -np.inf if self.valid_metric_bigger else np.inf
        self.best_valid_result = None
        self.train_loss_dict = {}
        self.eval_collector = Collector(config)
        self.evaluator = Evaluator(config)
        self.item_tensor = None
        self.tot_item_num = None
        self.model.train_stage = "finetune"

    def fit(self, train_data, valid_data=None, verbose=True, saved=True, show_progress=False,
            callback_fn=None):
        if self.model.train_stage == "pretrain":
            self.pretrain(train_data, valid_data, verbose, saved, show_progress)
            self.reset_params()
        elif self.model.train_stage != "finetune":
            raise ValueError("Please make sure that the 'train_stage' is 'pretrain' or 'finetune'!")
        return super().fit(train_data, valid_data, verbose, saved, show_progress, callback_fn)

    def save_pretrained_model(self, saved_model_file):
        payload = self._checkpoint_payload(-1)
        payload["optimizer"] = self._optimizer_payload(self.tx_pretrain)
        self._write_pickle(saved_model_file, payload)
        self._pretrain_saved = True

    def pretrain(self, train_data, valid_data, verbose=True, saved=True, show_progress=False):
        """Train the backbone for ``pretrain_epochs`` with early stopping on
        the validation, saving the best to ``<model>-<dataset>-pretrain.pth``;
        then reload it (with ``saved=False`` nothing is written and the
        current parameters go on, with a warning) and, under
        ``save_sst_embed``, export the pretrained users."""
        from ..quick_start import load_checkpoint

        prefix = os.path.join(self.checkpoint_dir,
                              f'{self.config["model"]}-{self.config["dataset"]}')
        self.saved_pretrain_model_file = f"{prefix}-pretrain.pth"
        self.saved_pretrain_sst_file = f"{prefix}-pretrain_embed[none].pth"
        self._pretrain_saved = False
        self.eval_step = min(self.config["eval_step"], self.pretrain_epochs)
        self.logger.info(set_color("Model Pretrain", "yellow"))
        self.eval_collector.data_collect(train_data)

        for epoch_idx in range(self.start_epoch, self.pretrain_epochs):
            training_start_time = time()
            train_loss = self._run_epoch(train_data, "calculate_loss", None, "pretrain")
            self.train_loss_dict[epoch_idx] = train_loss
            if verbose:
                self.logger.info(self._generate_train_loss_output(
                    epoch_idx, training_start_time, time(), train_loss))
            if self.eval_step <= 0 or not valid_data:
                if saved:
                    self.save_pretrained_model(self.saved_pretrain_model_file)
                continue
            if (epoch_idx + 1) % self.eval_step == 0:
                valid_score, valid_result = self._valid_epoch(valid_data,
                                                              show_progress=show_progress)
                self.best_valid_score, self.cur_step, stop_flag, update_flag = early_stopping(
                    valid_score, self.best_valid_score, self.cur_step,
                    max_step=self.stopping_step, bigger=self.valid_metric_bigger,
                )
                if verbose:
                    self.logger.info(set_color(f"pretrain epoch {epoch_idx} evaluating", "green")
                                     + f" [valid_score: {valid_score:f}]")
                    self.logger.info(set_color("valid result", "blue") + ": \n"
                                     + dict2str(valid_result))
                if update_flag:
                    if saved:
                        self.save_pretrained_model(self.saved_pretrain_model_file)
                    self.best_valid_result = valid_result
                if stop_flag:
                    if verbose:
                        self.logger.info("Finished pretraining, best eval result in epoch %d"
                                         % (epoch_idx - self.cur_step * self.eval_step))
                    break

        if self._pretrain_saved:
            self._load_params_from_checkpoint(load_checkpoint(self.saved_pretrain_model_file))
        else:
            # the reference reloads a checkpoint it never saved here
            self.logger.warning("pretrain ran with saved=False; finetuning from CURRENT "
                                "params, not best-valid.")
        if self.config["save_sst_embed"]:
            self._save_sst_embed_direct(train_data, self.saved_pretrain_sst_file)
        return self.best_valid_score, self.best_valid_result

    def _train_epoch(self, train_data, epoch_idx, loss_func=None, show_progress=False):
        filter_loss = 0.0
        sst_list = _draw_sst_mask(self.sst_attrs)
        if epoch_idx % self.train_epoch_interval == 0:
            self.logger.info("Train Filter")
            filter_loss = self._run_epoch(train_data, "calculate_loss", sst_list, "filter")
        self.logger.info("Train Discriminator")
        dis_loss = self._run_epoch(train_data, "calculate_dis_loss", sst_list, "dis")
        return dis_loss, filter_loss

    # ------------------------------------------------------------ evaluation

    def evaluate(self, eval_data, load_best_model=True, model_file=None, show_progress=False):
        """With ``load_best_model``: ``pretrain-*`` metrics from the pretrain
        checkpoint (unless the run finetunes preloaded tables), then
        ``finetune-*`` metrics from ``model_file`` or the best finetune
        checkpoint. Without: one evaluation of the current parameters."""
        if not eval_data:
            return
        if not load_best_model:
            return super().evaluate(eval_data, show_progress=show_progress)
        from ..quick_start import load_checkpoint

        result = {}
        if not self.load_pretrain_weight:
            if self.saved_pretrain_model_file is None:
                raise ValueError("no pretrain checkpoint to evaluate: run fit, or set "
                                 "pretrain_model_file_path")
            self._load_params_from_checkpoint(load_checkpoint(self.saved_pretrain_model_file))
            self.model.train_stage = "pretrain"
            self.logger.info("Loading pretrain model structure and parameters from "
                             f"{self.saved_pretrain_model_file}")
            for key, value in super().evaluate(eval_data).items():
                result[f"pretrain-{key}"] = value
        checkpoint_file = model_file or self.saved_model_file
        self._load_params_from_checkpoint(load_checkpoint(checkpoint_file))
        self.model.train_stage = "finetune"
        self.logger.info(f"Loading model structure and parameters from {checkpoint_file}")
        for key, value in super().evaluate(eval_data).items():
            result[f"finetune-{key}"] = value
        return result

    # ----------------------------------------------------------- checkpoints

    def _checkpoint_payload(self, epoch):
        payload = super()._checkpoint_payload(epoch)
        payload["optimizer_filter"] = self._optimizer_payload(self.tx_filter)
        payload["optimizer_dis"] = self._optimizer_payload(self.tx_dis)
        payload["train_stage"] = self.model.train_stage
        return payload

    def _load_optimizers(self, checkpoint):
        """On resume: the filter and discriminator optimizers (from the
        port's payloads or the JAX package's masked optax states) and the
        checkpoint's stage, as the JAX package's FairGo trainer resumes."""
        self._load_optimizer_payload(self.tx_filter, checkpoint["optimizer_filter"])
        self._load_optimizer_payload(self.tx_dis, checkpoint["optimizer_dis"])
        if checkpoint.get("train_stage"):
            self.model.train_stage = checkpoint["train_stage"]

    def _save_sst_embed_direct(self, data, saved_sst_embed_file=None):
        """Export the users' representations with the CURRENT parameters."""
        user_features = data.dataset.get_user_feature()[1:]
        stored = self.model.get_sst_embed(user_features, tuple(self.sst_attrs))
        self._write_pickle(saved_sst_embed_file or self.saved_sst_embed_file, stored)

    def _save_sst_embed(self, data):
        self._save_sst_embed_direct(data)


class FairGo_PMFTrainer(FairGoTrainer):
    pass


class FairGo_GCNTrainer(FairGoTrainer):
    pass


class PFCN_PMFTrainer(PFCNTrainer):
    pass


class PFCN_MLPTrainer(PFCNTrainer):
    pass


class PFCN_DMFTrainer(PFCNTrainer):
    pass


class PFCN_BiasedMFTrainer(PFCNTrainer):
    pass
