"""General-purpose helpers: seeding, time/paths, colored text.

Counterpart of ``recbole_fairrec_tpu/utils/common.py``. Where the JAX package
mints a ``jax.random.PRNGKey``, ``init_seed`` here returns a seeded
``torch.Generator`` that callers pass on explicitly (model init draws from
it). ``_bucket`` lives here because both the trainer and the tests use it;
in the JAX package it sits in ``trainer/trainer.py``.
"""

from __future__ import annotations

import datetime
import os
import random

import numpy as np
import torch


def init_seed(seed: int, reproducibility: bool = True) -> torch.Generator:
    """Seed the host RNGs (python ``random``, numpy) and return a CPU
    ``torch.Generator`` seeded with ``seed``.

    The ETL and the host samplers draw from numpy, in the same order as the
    JAX package, so the same seed gives the same splits and negatives.
    ``reproducibility`` additionally asks PyTorch for deterministic kernels.
    """
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if reproducibility:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
    return torch.Generator().manual_seed(int(seed))


def get_local_time() -> str:
    """Current time formatted for checkpoint file names."""
    return datetime.datetime.now().strftime("%b-%d-%Y_%H-%M-%S")


def ensure_dir(dir_path: str) -> None:
    os.makedirs(dir_path, exist_ok=True)


def dict2str(result_dict) -> str:
    """Pretty one-line rendering of a metric dict."""
    parts = []
    for metric, value in result_dict.items():
        if isinstance(value, dict):
            parts.append(f"{metric}: {{{dict2str(value)}}}")
        else:
            parts.append(f"{metric} : {value}")
    return "    ".join(parts)


_ANSI = {
    "black": "30", "red": "31", "green": "32", "yellow": "33",
    "blue": "34", "pink": "35", "cyan": "36", "white": "37",
}


def set_color(log: str, color: str, highlight: bool = True) -> str:
    code = _ANSI.get(color, "37")
    prefix = "1;" if highlight else ""
    return f"\033[{prefix}{code}m{log}\033[0m"


def _bucket(n, quantum=256):
    """Round a batch size up to a multiple of ``quantum`` (the JAX package
    pads eval batches to these buckets; the port keeps the same shapes)."""
    return int(-(-n // quantum) * quantum)
