"""Fused full-catalog score + top-k': the hand-written CUDA kernel
(``csrc/fused_topk.cu``) and its plain PyTorch version.

Counterpart of ``recbole_fairrec_tpu/ops/pallas/fused_topk.py``. For
``user_emb [B, d]`` and ``item_table [I, d]`` (each float32 or bfloat16) it
returns the k' best items of every row of ``user_emb @ item_table.T``,
summed in float32, as ``(scores [B, k'] float32, idx [B, k'] int32)``,
ordered by (score descending, item index ascending), with item 0 ([PAD])
never selected and a slot without an item holding (−inf, 0). A bfloat16
table is read as it is stored (the wrapper makes no float32 copy of it);
the kernel widens each value as it enters the products, which are then
exact in float32, as under the JAX call's ``preferred_element_type``.
Other dtypes (float16 among them) raise ``TypeError``.

Shard mode (the local stage of ``parallel.eval.distributed_topk_scores``):
``col_offset`` is added to the index of every selected item (the table is
rows ``[col_offset, col_offset + I)`` of a larger one) and ``mask_pad=False``
leaves column 0 selectable. The defaults are the call above, unchanged.

A CUDA tensor goes to the kernel (or the call raises); a CPU tensor goes to
the plain version, ``fused_topk_scores_reference``. There is no fallback
between the two. The kernel is compiled with ``nvcc`` for ``sm_90a`` into
``_build/`` at first use and loaded with ctypes. One call on the card makes
two CUDA launches (score + per-chunk select, then the per-user merge) over
a scratch tensor of per-chunk lists that the wrapper allocates;
``launches`` counts the calls that took the kernel path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import torch

from .topk import streaming_topk_scores

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fused_topk.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
MAX_K = 4096
# The CUDA source's constants: users per score block, items and depth per T
# tile, T tiles in flight, padding of a key row, threads per merge block.
BM, BN, BK, STAGES, KEY_PAD, MERGE_THREADS = 64, 256, 16, 3, 8, 256
MAX_CHUNK = 512  # kMaxChunk: a chunk's keys fit 16 registers per lane
MAX_SPLITS = 65535  # kMaxSplits: the score grid's y extent (chunks)
# t_stride: elements of a T ring row by element size (f32 80 B, bf16 48 B)
T_STRIDE = {4: BK + 4, 2: BK + 8}
# the dtypes the kernel reads, for users and table alike, in any pairing
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
SLACK = 32  # kSlack: keys a chunk's list may hold beyond k' (for k' > 1)
MIN_BLOCKS_PER_SM = 2
MERGE_WARP_MAX_K = 512  # the merge sorts up to this many winners with one warp
# kMergeStaticSmem: the merge kernel's static shared memory, at most; CUDA
# counts it against the opt-in limit beside the dynamic bytes
MERGE_STATIC_SMEM = 256

launches = 0
_LIB = None
_LAUNCH_ARGS = {}


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
        lib.fused_topk_smem_bytes.restype = ctypes.c_longlong
        lib.fused_topk_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.fused_topk_launch.restype = ctypes.c_int
        lib.fused_topk_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        _LIB = lib
    return _LIB


class Plan(NamedTuple):
    """Grid of the score + select kernel: ``bm`` users per block, the item
    axis cut into ``splits`` chunks of ``chunk`` items, ``smem`` bytes of
    dynamic shared memory per block."""

    bm: int
    chunk: int
    splits: int
    smem: int


def _ceil_div(a, b):
    return -(-a // b)


def _pow2_at_least(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def smem_bytes(d, chunk, esize=4):
    """Dynamic shared memory of one score + select block (``score_smem_bytes``
    in the CUDA source): f32 U rows, the T ring in the table's element type
    (``esize`` bytes), the [BM, chunk] key block."""
    dpad = _ceil_div(d, BK) * BK
    return (4 * BM * (dpad + 4) + esize * STAGES * BN * T_STRIDE[esize]
            + 4 * BM * (chunk + KEY_PAD))


class MergePlan(NamedTuple):
    """The merge kernel: ``n`` list entries per user, the winners sorted in
    ``kp`` slots (min(k', I) rounded up to a power of two, at least one per
    thread of the team), ``team`` threads per user (a warp, or the whole
    block where that power of two is above MERGE_WARP_MAX_K), the lists'
    keys copied into shared memory when ``keys_in_smem``, ``smem`` bytes."""

    n: int
    kp: int
    team: int
    keys_in_smem: bool
    smem: int


def list_len(top_k, chunk):
    """Entries of one chunk's list (``list_len`` in the CUDA source)."""
    return min(top_k + SLACK if top_k > 1 else top_k, chunk)


def merge_plan(n_items, top_k, plan, smem_limit):
    """The merge's dynamic bytes stay within ``smem_limit`` less its static
    bytes; the lists' keys go to shared memory only where they fit too."""
    dynamic_limit = smem_limit - MERGE_STATIC_SMEM
    lmax = list_len(top_k, plan.chunk)
    last = n_items - (plan.splits - 1) * plan.chunk
    n = (plan.splits - 1) * lmax + min(lmax, last)
    kp = _pow2_at_least(min(top_k, n_items))
    team = 32 if kp <= MERGE_WARP_MAX_K else MERGE_THREADS
    kp = max(kp, team)
    words = 8 * (kp + kp // 16)  # padded: word i at i + i // 16
    teams = MERGE_THREADS // team
    with_keys = teams * (words + 4 * _ceil_div(n, 2) * 2)
    if with_keys <= dynamic_limit:
        return MergePlan(n, kp, team, True, with_keys)
    smem = teams * words
    if smem > dynamic_limit:
        raise ValueError(f"fused_topk: k'={top_k} needs {smem} bytes of shared memory per "
                         f"merge block, more than the card's {smem_limit} less "
                         f"{MERGE_STATIC_SMEM} static")
    return MergePlan(n, kp, team, False, smem)


def scratch_entries(n_users, top_k, plan):
    """Entries of the per-chunk lists (8 bytes each: the item and its key)."""
    return n_users * plan.splits * list_len(top_k, plan.chunk)


def launch_plan(n_users, n_items, d, smem_limit, n_sm, esize=4):
    """The chunk is as large as ``smem_limit`` allows (a multiple of BN), cut
    further until the grid holds MIN_BLOCKS_PER_SM blocks per SM. ``esize``
    is the table's element size (4 float32, 2 bfloat16). A catalog that
    needs more than MAX_SPLITS chunks raises."""
    chunk_max = min(MAX_CHUNK,
                    (smem_limit - smem_bytes(d, 0, esize)) // (4 * BM) // BN * BN)
    if chunk_max < BN:
        raise ValueError(
            f"fused_topk: d={d} needs {smem_bytes(d, BN, esize)} bytes of shared memory "
            f"per block, more than the card's {smem_limit}"
        )
    if _ceil_div(n_items, chunk_max) > MAX_SPLITS:
        raise ValueError(
            f"fused_topk: I={n_items} items need {_ceil_div(n_items, chunk_max)} chunks of "
            f"{chunk_max}, more than the grid's {MAX_SPLITS}"
        )
    user_blocks = _ceil_div(n_users, BM)
    target = MIN_BLOCKS_PER_SM * n_sm
    splits = max(_ceil_div(n_items, chunk_max), _ceil_div(target, user_blocks))
    chunk = min(chunk_max, _ceil_div(_ceil_div(n_items, splits), BN) * BN)
    while user_blocks * _ceil_div(n_items, chunk) < target and chunk > BN:
        chunk -= BN
    return Plan(BM, chunk, _ceil_div(n_items, chunk), smem_bytes(d, chunk, esize))


def fused_topk_scores_reference(user_emb, item_table, top_k, col_offset=0, mask_pad=True):
    """Plain version: f32 ``user_emb @ item_table.T`` in item tiles, column 0
    masked (``mask_pad``), stable descending sort, first k', indices offset
    by ``col_offset``; −inf slots carry index 0."""
    scores, idx = streaming_topk_scores(user_emb, item_table, top_k, mask_pad=mask_pad,
                                        col_offset=col_offset)
    idx = torch.where(torch.isneginf(scores), torch.zeros_like(idx), idx)
    return scores, idx


def _launch_args(device, B, I, d, top_k, esize):
    """For these shapes and the table's element size on this device, made
    once: the scratch's 8-byte words, the launch's shape arguments before
    ``vec`` and its two shared memory sizes after it (the wrapper's host
    time is part of every call)."""
    key = (device.index, B, I, d, top_k, esize)
    args = _LAUNCH_ARGS.get(key)
    if args is None:
        smem_limit = _lib().fused_topk_max_smem()
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        plan = launch_plan(B, I, d, smem_limit, n_sm, esize)
        merge = merge_plan(I, top_k, plan, smem_limit)
        # the lists, then one 4-byte lower bound per (user, chunk)
        words = scratch_entries(B, top_k, plan) + _ceil_div(B * plan.splits, 2)
        shape = (B, I, d, top_k, plan.chunk, plan.splits, merge.n, merge.kp, merge.team,
                 int(merge.keys_in_smem))
        args = _LAUNCH_ARGS[key] = (words, shape, (plan.smem, merge.smem))
    return args


def _launch(user_emb, item_table, out_s, out_i, top_k, col_offset, mask_pad):
    (B, d), device = user_emb.shape, user_emb.device
    esize = item_table.element_size()
    words, shape, smem = _launch_args(device, B, item_table.shape[0], d, top_k, esize)
    scratch = torch.empty(words, dtype=torch.int64, device=device)
    u, t = user_emb.data_ptr(), item_table.data_ptr()
    u_bf16 = user_emb.dtype == torch.bfloat16
    # 16-byte copies of T (and of f32 users; bf16 users are read by plain loads)
    vec = int(d % (16 // esize) == 0 and t % 16 == 0 and (u_bf16 or u % 16 == 0))
    # the raw handle of the current stream, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    return _lib().fused_topk_launch(
        u, t, scratch.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), *shape, vec, *smem,
        int(col_offset), int(mask_pad), int(u_bf16), int(esize == 2), stream,
    )


def fused_topk_scores(user_emb, item_table, top_k, col_offset=0, mask_pad=True):
    """Top-k' of ``user_emb @ item_table.T`` per row; see the module doc."""
    global launches
    if user_emb.dim() != 2 or item_table.dim() != 2 or user_emb.shape[1] != item_table.shape[1]:
        raise ValueError(
            f"fused_topk: shapes {tuple(user_emb.shape)} and {tuple(item_table.shape)} "
            "are not [B, d] and [I, d]"
        )
    if not 1 <= top_k <= MAX_K:
        raise ValueError(f"fused_topk: k'={top_k} is outside [1, {MAX_K}]")
    for dtype in (user_emb.dtype, item_table.dtype):
        if dtype not in KERNEL_DTYPES:
            raise TypeError(f"fused_topk: the kernel takes float32 or bfloat16 tensors, "
                            f"not {dtype}")
    device, t_device = user_emb.device, item_table.device
    if device.type == "cpu" and t_device.type == "cpu":
        return fused_topk_scores_reference(user_emb, item_table, top_k, col_offset, mask_pad)
    if device.type != "cuda" or t_device != device:
        raise ValueError(
            f"fused_topk: tensors on {device} and {t_device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    if not (user_emb.is_contiguous() and item_table.is_contiguous()):
        raise ValueError("fused_topk: the kernel takes contiguous tensors")
    B, d = user_emb.shape
    I = item_table.shape[0]
    if I == 0:
        raise ValueError("fused_topk: the item table is empty")
    if not 0 <= col_offset <= 2**31 - 1 - I:
        raise ValueError(f"fused_topk: col_offset {col_offset} puts indices past int32")
    out_s = torch.empty((B, top_k), dtype=torch.float32, device=device)
    out_i = torch.empty((B, top_k), dtype=torch.int32, device=device)
    if B == 0:
        return out_s, out_i
    if device.index != torch.cuda.current_device():  # the C side launches on the current one
        with torch.cuda.device(device):
            err = _launch(user_emb, item_table, out_s, out_i, top_k, col_offset, mask_pad)
    else:
        err = _launch(user_emb, item_table, out_s, out_i, top_k, col_offset, mask_pad)
    if err != 0:
        raise RuntimeError(f"fused_topk: kernel launch failed with CUDA error {err}")
    launches += 1
    return out_s, out_i
