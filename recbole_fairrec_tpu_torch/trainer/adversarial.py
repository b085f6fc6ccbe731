"""Trainers of the adversarial model families: PFCN, ``filter_mode: none``.

Counterpart of ``recbole_fairrec_tpu/trainer/adversarial.py``. With
``filter_mode: none`` a PFCN model trains like its plain backbone with the
main optimizer; what ``PFCNTrainer`` changes against the base ``Trainer`` is
the surface: ``evaluate`` loads the best checkpoint by default and returns
one result dict per evaluated subset, keyed ``"none"`` here; checkpoints
carry ``optimizer_filter`` / ``optimizer_dis`` entries (``None`` here); and
``save_sst_embed`` exports the user embeddings. The filter/discriminator
alternation (``cm``/``sm``) and the FairGo trainers come with the
adversarial slice of the port.
"""

from __future__ import annotations

import os
import pickle

import torch

from ..utils import calculate_valid_score
from .trainer import Trainer


class PFCNTrainer(Trainer):
    def __init__(self, config, model):
        super().__init__(config, model)
        self.filter_mode = config["filter_mode"].lower()
        self.train_epoch_interval = config["train_epoch_interval"]
        if self.filter_mode != "none":
            raise NotImplementedError(
                f"filter_mode [{self.filter_mode}] (the filter/discriminator alternation) "
                "comes with the adversarial PFCN slice of the port; use filter_mode: none"
            )

    # --------------------------------------------------------------- training

    def _train_epoch(self, train_data, epoch_idx, loss_func=None, show_progress=False):
        return self._run_epoch(train_data, "calculate_loss", None, "main")

    # ------------------------------------------------------------- evaluation

    @torch.no_grad()
    def pfcn_evaluate(self, eval_data, load_best_model=True, model_file=None,
                      show_progress=False):
        """Validation-style eval: everything collected into ONE result dict."""
        if not eval_data:
            return
        if load_best_model:
            self._load_best(model_file)
        self._prepare_eval(eval_data)
        self.model.eval()
        for batched_data in self._macro_batches(eval_data):
            self._collect_batch(batched_data)
        self.eval_collector.model_collect(self.model)
        struct = self.eval_collector.get_data_struct()
        return self.evaluator.evaluate(struct)

    def _valid_epoch(self, valid_data, show_progress=False):
        valid_result = self.pfcn_evaluate(
            valid_data, load_best_model=False, show_progress=show_progress
        )
        valid_score = calculate_valid_score(valid_result, self.valid_metric)
        return valid_score, valid_result

    def evaluate(self, eval_data, load_best_model=True, model_file=None, show_progress=False):
        """Final eval: one result dict PER subset; with ``filter_mode: none``
        the one key is ``"none"``."""
        if not eval_data:
            return
        result = self.pfcn_evaluate(
            eval_data, load_best_model=load_best_model, model_file=model_file,
            show_progress=show_progress,
        )
        return {str(self.config["filter_mode"]): result}

    # ------------------------------------------------------------ checkpoints

    def _checkpoint_payload(self, epoch):
        payload = super()._checkpoint_payload(epoch)
        payload["optimizer_filter"] = None
        payload["optimizer_dis"] = None
        return payload

    def _save_sst_embed(self, data):
        """Write ``<model>_embed-none.pth`` beside the checkpoints: the best
        checkpoint's user embeddings and the users' sensitive attributes.
        After ``fit(saved=False)`` there is no checkpoint and the current
        parameters are exported, with a warning."""
        if os.path.isfile(self.saved_model_file):
            self._load_best()
        else:
            self.logger.warning(
                "save_sst_embed: no checkpoint on disk (fit ran with "
                "saved=False); exporting CURRENT params, not best-valid."
            )
        user_features = data.dataset.get_user_feature()[1:]
        stored = self.model.get_sst_embed(user_features)
        fname = f'{self.config["model"]}_embed-{self.config["filter_mode"]}.pth'
        with open(os.path.join(self.checkpoint_dir, fname), "wb") as f:
            pickle.dump(stored, f)


class PFCN_PMFTrainer(PFCNTrainer):
    pass
