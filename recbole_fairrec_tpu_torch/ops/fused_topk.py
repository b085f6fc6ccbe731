"""Fused full-catalog score + top-k': the hand-written CUDA kernel
(``csrc/fused_topk.cu``) and its plain PyTorch version.

Counterpart of ``recbole_fairrec_tpu/ops/pallas/fused_topk.py``. For
``user_emb [B, d]`` and ``item_table [I, d]`` (float32) it returns the k'
best items of every row of ``user_emb @ item_table.T`` as
``(scores [B, k'] float32, idx [B, k'] int32)``, ordered by (score
descending, item index ascending), with item 0 ([PAD]) never selected and
a slot without an item holding (−inf, 0).

A CUDA tensor goes to the kernel (or the call raises); a CPU tensor goes to
the plain version, ``fused_topk_scores_reference``. There is no fallback
between the two. The kernel is compiled with ``nvcc`` for ``sm_90a`` into
``_build/`` at first use and loaded with ctypes; ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from .topk import streaming_topk_scores

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fused_topk.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
MAX_K = 4096
_TILE = 64  # kTile in the CUDA source: items per tile
_CAND_MIN = 256  # kCandMin in the CUDA source: candidate list entries per user, at least

launches = 0
_LIB = None


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused top-k kernel cannot be built")


def build(verbose=False):
    """Compile the kernel library (once per source hash) and return its path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"fused_topk-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", SOURCE, "-o", tmp,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.fused_topk_max_smem.restype = ctypes.c_int
        lib.fused_topk_max_smem.argtypes = []
        lib.fused_topk_launch.restype = ctypes.c_int
        lib.fused_topk_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ]
        _LIB = lib
    return _LIB


def _pow2_at_least(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def smem_bytes(d, K, upb, vec):
    """Dynamic shared memory of one block (layout in the CUDA source)."""
    tstride = d + 4 if vec else d + 1
    cand = max(_CAND_MIN, K)
    return 4 * (2 * _TILE * tstride + upb * d + 2 * upb * K + 2 * upb * cand)


def launch_plan(d, top_k, smem_limit, vec):
    """(K, users per block, shared bytes): K is k' rounded up to a power of
    two; the block holds as many users (8, 4, 2, 1) as fit ``smem_limit``."""
    K = _pow2_at_least(top_k)
    for upb in (8, 4, 2, 1):
        need = smem_bytes(d, K, upb, vec)
        if need <= smem_limit:
            return K, upb, need
    raise ValueError(
        f"fused_topk: k'={top_k}, d={d} needs {smem_bytes(d, K, 1, vec)} bytes of shared "
        f"memory per block, more than the card's {smem_limit}"
    )


def fused_topk_scores_reference(user_emb, item_table, top_k):
    """Plain version: f32 ``user_emb @ item_table.T`` in item tiles, column 0
    masked, stable descending sort, first k'; −inf slots carry index 0."""
    scores, idx = streaming_topk_scores(user_emb, item_table, top_k, mask_pad=True)
    idx = torch.where(torch.isneginf(scores), torch.zeros_like(idx), idx)
    return scores, idx


def fused_topk_scores(user_emb, item_table, top_k):
    """Top-k' of ``user_emb @ item_table.T`` per row; see the module doc."""
    global launches
    if user_emb.dim() != 2 or item_table.dim() != 2 or user_emb.shape[1] != item_table.shape[1]:
        raise ValueError(
            f"fused_topk: shapes {tuple(user_emb.shape)} and {tuple(item_table.shape)} "
            "are not [B, d] and [I, d]"
        )
    if not 1 <= top_k <= MAX_K:
        raise ValueError(f"fused_topk: k'={top_k} is outside [1, {MAX_K}]")
    if user_emb.device.type == "cpu" and item_table.device.type == "cpu":
        return fused_topk_scores_reference(user_emb, item_table, top_k)
    if user_emb.device.type != "cuda" or item_table.device != user_emb.device:
        raise ValueError(
            f"fused_topk: tensors on {user_emb.device} and {item_table.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    if user_emb.dtype != torch.float32 or item_table.dtype != torch.float32:
        raise TypeError("fused_topk: the kernel takes float32 tensors")
    if not (user_emb.is_contiguous() and item_table.is_contiguous()):
        raise ValueError("fused_topk: the kernel takes contiguous tensors")
    B, d = user_emb.shape
    I = item_table.shape[0]
    lib = _lib()
    vec = d % 4 == 0 and item_table.data_ptr() % 16 == 0
    K, upb, smem = launch_plan(d, top_k, lib.fused_topk_max_smem(), vec)
    out_s = torch.empty((B, top_k), dtype=torch.float32, device=user_emb.device)
    out_i = torch.empty((B, top_k), dtype=torch.int32, device=user_emb.device)
    if B == 0:
        return out_s, out_i
    with torch.cuda.device(user_emb.device):  # the C side launches on the current device
        stream = torch.cuda.current_stream(user_emb.device).cuda_stream
        err = lib.fused_topk_launch(
            user_emb.data_ptr(), item_table.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            B, I, d, top_k, K, upb, int(vec), smem, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_topk: kernel launch failed with CUDA error {err}")
    launches += 1
    return out_s, out_i
