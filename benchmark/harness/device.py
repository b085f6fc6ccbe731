"""The device a run measures, the cache directories it uses, and the check
that nothing of JAX was loaded."""

from __future__ import annotations

import os
import subprocess
import sys

# top-level module names a run may not hold once its window has closed: the
# JAX stack and the JAX package the port was made from (compared whole, so
# the port, ``recbole_fairrec_tpu_torch``, is not one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "recbole_fairrec_tpu")


class NoDevice(RuntimeError):
    """The run has no card, or fewer cards than its cell asks for."""


def cache_dirs(root):
    """Fixed directories inside the checkout for every build and kernel
    cache a library may keep (the program itself builds into
    ``recbole_fairrec_tpu_torch/_build/``); set before torch is imported."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        path = os.path.join(base, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def require_cuda(chips):
    """The first card, or ``NoDevice`` when there is none or fewer than
    ``chips``: a timed run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: a timed run needs a card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} card(s), the cell asks for {chips}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    return torch.device("cuda", 0)


def describe(device, count):
    """The result line's ``device``: platform, name, cards used and the peak
    allocation on the fullest card."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": int(peak)}


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them, or None."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout else None


def forbidden_modules(modules=None):
    """Names in ``sys.modules`` whose top-level name is one of
    ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
