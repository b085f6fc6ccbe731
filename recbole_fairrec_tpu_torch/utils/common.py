"""General-purpose helpers: seeding, early stopping, time/paths, colored text,
the environment summary.

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
import torch.distributed as dist


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


def pickle_to(path, obj):
    """``pickle.dump`` into a temporary file beside ``path``, then renamed to
    it: a reader (another process of a multi-process run sharing the
    directory) sees no file or the whole one."""
    import pickle
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def early_stopping(value, best, cur_step, max_step, bigger=True):
    """Early-stopping counter update.

    Args:
        value: current epoch's validation score.
        best: best score so far.
        cur_step: epochs since the last improvement.
        max_step: patience; stop once cur_step exceeds it.
        bigger: whether larger scores are better.

    Returns:
        (best, cur_step, stop_flag, update_flag)
    """
    stop_flag = False
    update_flag = False
    improved = value > best if bigger else value < best
    if improved:
        cur_step = 0
        best = value
        update_flag = True
    else:
        cur_step += 1
        if cur_step > max_step:
            stop_flag = True
    return best, cur_step, stop_flag, update_flag


def calculate_valid_score(valid_result, valid_metric=None):
    """Pull the validation score out of an eval-result dict.

    The configured metric name is lowercased and falls back to ``recall@10``.
    Nested result dicts (PFCN per-subset results) are searched recursively,
    taking the first hit.
    """
    key = (valid_metric or "recall@10").lower()
    return _search_metric(valid_result, key)


def _search_metric(result, key):
    for k, v in result.items():
        if isinstance(v, dict):
            found = _search_metric(v, key)
            if found is not None:
                return found
        elif str(k).lower() == key:
            return v
    return None


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


def get_flops_estimate(n_params: int) -> int:
    """Rough FLOPs-per-example estimate used by the profiler output."""
    return 2 * n_params


def get_environment_info():
    """Device inventory summary for logging, with the JAX package's keys:
    torch's backend (``cuda`` where a card is visible, else ``cpu``), the
    number of devices and their names, and the ``torch.distributed`` world
    size (1 without a process group)."""
    if torch.cuda.is_available():
        backend = "cuda"
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        backend, devices = "cpu", ["cpu"]
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return {"backend": backend, "n_devices": len(devices), "devices": devices,
            "process_count": world}


def _bucket(n, quantum=256):
    """Round a batch size up to a multiple of ``quantum`` (the JAX package
    pads eval batches to these buckets; the port keeps the same shapes)."""
    return int(-(-n // quantum) * quantum)
