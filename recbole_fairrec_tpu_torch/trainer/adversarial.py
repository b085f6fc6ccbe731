"""Trainers of the adversarial PFCN family.

Counterpart of the ``PFCNTrainer`` half of
``recbole_fairrec_tpu/trainer/adversarial.py``:

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

The FairGo trainers are not ported yet.
"""

from __future__ import annotations

import itertools
import os
import pickle

import numpy as np
import torch

from ..utils import calculate_valid_score
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
        them."""
        for batched_data in self._macro_batches(eval_data, kind):
            for sst_list in subsets:
                self._collect_batch(kind, batched_data, sst_list)
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
        package's masked optax states (Adam only)."""
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
            with open(os.path.join(self.checkpoint_dir, fname), "wb") as f:
                pickle.dump(stored, f)


class PFCN_PMFTrainer(PFCNTrainer):
    pass


class PFCN_MLPTrainer(PFCNTrainer):
    pass


class PFCN_DMFTrainer(PFCNTrainer):
    pass


class PFCN_BiasedMFTrainer(PFCNTrainer):
    pass
