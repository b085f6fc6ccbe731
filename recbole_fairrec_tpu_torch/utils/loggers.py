"""Experiment tracking sinks: TensorBoard-compatible scalars + optional W&B.

Counterpart of ``recbole_fairrec_tpu/utils/loggers.py``, with the same rule:
a real writer is used only when it is asked for and present.

* ``ScalarWriter`` appends JSON lines to ``log_tensorboard/<run>/scalars.jsonl``
  by default; with ``RECBOLE_ENABLE_TENSORBOARD`` set it uses ``tensorboardX``
  or ``torch.utils.tensorboard`` when one of them imports;
* ``WandbLogger`` is a no-op unless ``log_wandb`` is set, and raises when it
  is set and ``wandb`` does not import.
"""

from __future__ import annotations

import importlib
import json
import os
import time

from .common import ensure_dir, get_local_time


class ScalarWriter:
    """Minimal SummaryWriter-compatible scalar sink."""

    def __init__(self, log_dir):
        ensure_dir(log_dir)
        self.log_dir = log_dir
        self._impl = None
        if os.environ.get("RECBOLE_ENABLE_TENSORBOARD"):
            for mod in ("tensorboardX", "torch.utils.tensorboard"):
                try:
                    tb = importlib.import_module(mod)
                    self._impl = tb.SummaryWriter(log_dir=log_dir)
                    break
                except ImportError:
                    continue
        if self._impl is None:
            self._fp = open(os.path.join(log_dir, "scalars.jsonl"), "a", encoding="utf-8")

    def add_scalar(self, tag, value, step):
        if self._impl is not None:
            self._impl.add_scalar(tag, value, step)
        else:
            self._fp.write(
                json.dumps({"tag": tag, "value": float(value), "step": int(step), "t": time.time()})
                + "\n"
            )
            self._fp.flush()

    def add_hparams(self, hparam_dict, metric_dict):
        if self._impl is not None:
            self._impl.add_hparams(hparam_dict, metric_dict)
        else:
            self._fp.write(json.dumps({"hparams": hparam_dict, "metrics": metric_dict}) + "\n")
            self._fp.flush()

    def close(self):
        if self._impl is not None:
            self._impl.close()
        else:
            self._fp.close()


def get_tensorboard(logger, base_path="log_tensorboard"):
    """Writer named after the current log file."""
    dir_name = None
    for handler in getattr(logger, "handlers", []):
        if hasattr(handler, "baseFilename"):
            dir_name = os.path.splitext(os.path.basename(handler.baseFilename))[0]
            break
    if dir_name is None:
        dir_name = f"model-{get_local_time()}"
    return ScalarWriter(os.path.join(base_path, dir_name))


class WandbLogger:
    """Optional Weights & Biases sink."""

    def __init__(self, config):
        self.config = config
        self.log_wandb = bool(config["log_wandb"])
        self._wandb = None
        self.setup()

    def setup(self):
        if not self.log_wandb:
            return
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "To use the Weights and Biases Logger please install wandb."
                "Run `pip install wandb` to install it."
            ) from e
        self._wandb = wandb
        if self._wandb.run is None:
            self._wandb.init(project=self.config["wandb_project"])
        self._set_steps()

    def _set_steps(self):
        self._wandb.define_metric("train_step")
        self._wandb.define_metric("valid_step")
        self._wandb.define_metric("train/*", step_metric="train_step")
        self._wandb.define_metric("valid/*", step_metric="valid_step")

    def log_metrics(self, metrics, head="train", commit=True):
        if not self._wandb:
            return
        if head:
            metrics = self._add_head_to_metrics(metrics, head)
        self._wandb.log(metrics, commit=commit)

    def log_eval_metrics(self, metrics, head="eval"):
        if not self._wandb:
            return
        metrics = self._add_head_to_metrics(metrics, head)
        for k, v in metrics.items():
            self._wandb.run.summary[k] = v

    @staticmethod
    def _add_head_to_metrics(metrics, head):
        return {
            (k if "_step" in k else f"{head}/{k}"): v for k, v in metrics.items()
        }
