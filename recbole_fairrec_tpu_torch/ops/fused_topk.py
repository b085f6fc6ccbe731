"""Fused full-catalog score + top-k': the hand-written CUDA kernel
(``csrc/fused_topk.cu``) and its plain PyTorch version.

Counterpart of ``recbole_fairrec_tpu/ops/pallas/fused_topk.py``. For
``user_emb [B, d]`` and ``item_table [I, d]`` (each float32, bfloat16 or
float16, in any pairing) it returns the k' best items of every row of
``user_emb @ item_table.T``, summed in float32, as ``(scores [B, k']
float32, idx [B, k'] int32)``, ordered by (score descending, item index
ascending), with item 0 ([PAD]) never selected and a slot without an item
holding (−inf, 0). A half-precision table is read as it is stored (the
wrapper makes no float32 copy of it). The products of half values are exact
in float32, as under the JAX call's ``preferred_element_type``: users and
table of one half type go through the tensor cores (``wgmma`` with TMA for
k' <= 32 over many chunks where the table's rows are whole 16-byte units,
``mma.sync`` a chunk a block otherwise; ``score_path``), every other
pairing through float32 FMA on the widened values. float64 and integer
tensors raise ``TypeError`` naming the dtype (the JAX package,
without x64, never holds a float64 array).

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
import os
from typing import NamedTuple

import torch

from ..utils import tracing
from .nvcc_build import CSRC_DIR, build_library
from .topk import streaming_topk_scores

SOURCE = os.path.join(CSRC_DIR, "fused_topk.cu")
MAX_K = 4096
# The CUDA source's constants: users per score block, items and depth per T
# tile, T tiles in flight, padding of a key row, threads per merge block.
BM, BN, BK, STAGES, KEY_PAD, MERGE_THREADS = 64, 256, 16, 3, 8, 256
MAX_CHUNK = 512  # kMaxChunk: a chunk's keys fit 16 registers per lane
MAX_SPLITS = 65535  # kMaxSplits: the score grid's y extent (chunks)
# t_stride: elements of a CUDA-core T ring row by element size (f32 80 B,
# half 48 B)
T_STRIDE = {4: BK + 4, 2: BK + 8}
# the tensor-core path: depth per T tile (kBKM) and elements of a ring row
# (kTSM, 80 B)
BK_MMA = 32
T_STRIDE_MMA = BK_MMA + 8
# the dtypes the kernel reads, for users and table alike, in any pairing,
# with their codes in the C interface
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SLACK = 32  # kSlack: keys a chunk's list may hold beyond k' (for k' > 1)
MIN_BLOCKS_PER_SM = 2
MERGE_WARP_MAX_K = 512  # the merge sorts up to this many winners with one warp
CAND_CAP = 2048  # kCandCap: candidates a user may bring to the split merge's sort
# the split merge: at least this many blocks per SM; with one list per
# chunk it also takes lists that fit shared memory where there are at least
# SPLIT_MIN_LISTS of them and the team grid would leave SMs idle
SPLIT_BLOCKS_PER_SM = 4
SPLIT_MIN_LISTS = MERGE_THREADS
# range mode (same-type half calls, k' <= RANGE_MAX_K): a score block walks
# several chunks, keeping each user's top k' in registers; the grid is one
# wave of blocks (the longer a range, the fewer keys beat its running k'-th
# best, and the less its first chunk costs per chunk)
RANGE_MAX_K = 32  # kRangeMaxK
# kMergeStaticSmem: the merge kernel's static shared memory, at most; CUDA
# counts it against the opt-in limit beside the dynamic bytes
MERGE_STATIC_SMEM = 256
# the Hopper range kernel (score_select_wgmma_kernel: TMA and wgmma), the one
# kernel of range mode, for the calls whose table TMA can read: users per block
# (kWgUsers: two warpgroups of 64), items per T tile (kWgTile), tiles in
# flight (kWgStages), the depth its layout holds (kWgMaxD: two 64-element
# panels), a user's words of top-k' set and candidates (kCandWords)
WG_USERS, WG_TILE, WG_STAGES, WGMMA_MAX_D, CAND_WORDS = 128, 128, 5, 128, 64

launches = 0
_LIB = None
_LAUNCH_ARGS = {}


def build(verbose=False):
    """Compile the kernel library (once per source hash) and return its path."""
    return build_library(SOURCE, "fused_topk", verbose)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.fused_topk_max_smem.restype = ctypes.c_int
        lib.fused_topk_max_smem.argtypes = []
        lib.fused_topk_smem_bytes.restype = ctypes.c_longlong
        lib.fused_topk_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.fused_topk_launch.restype = ctypes.c_int
        lib.fused_topk_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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


def smem_bytes(d, chunk, esize=4, mma=False):
    """Dynamic shared memory of one score + select block (``score_smem_bytes``
    in the CUDA source). CUDA cores: f32 U rows, the T ring in the table's
    element type (``esize`` bytes), the [BM, chunk] key block. Tensor cores
    (``mma``, U and T of one half type): half U rows of ``d`` rounded up to
    32 plus 8, the ring of 32-deep half tiles, the key block."""
    keys = 4 * BM * (chunk + KEY_PAD)
    if mma:
        dpad = _ceil_div(d, BK_MMA) * BK_MMA
        return 2 * BM * (dpad + 8) + 2 * STAGES * BN * T_STRIDE_MMA + keys
    dpad = _ceil_div(d, BK) * BK
    return 4 * BM * (dpad + 4) + esize * STAGES * BN * T_STRIDE[esize] + keys


def wgmma_smem_bytes(d):
    """Dynamic shared memory of one block of the Hopper range kernel
    (``wgmma_smem_bytes`` in the CUDA source): 1,024 bytes of alignment, the
    ring's panels of 128-byte rows (ceil(d / 64) of them for each of
    kWgStages tiles of 128 items), each user's buffer of 64 words (its
    top-k' set and candidates), the ring's barriers."""
    panels = _ceil_div(d, 64)
    return 1024 + panels * 128 * WG_STAGES * WG_TILE + 8 * WG_USERS * CAND_WORDS + 16 * WG_STAGES


class MergePlan(NamedTuple):
    """The merge kernel: ``n`` list entries per user, the winners sorted in
    ``kp`` slots (min(k', I) rounded up to a power of two, at least one per
    thread of the team), ``team`` threads per user (a warp, or the whole
    block where that power of two is above MERGE_WARP_MAX_K), the lists'
    keys copied into shared memory when ``keys_in_smem``, ``smem`` bytes.
    ``parts`` > 0 selects the split merge (``merge_plan`` says where): that
    many blocks of MERGE_THREADS per user, each over a slice of its lists;
    0 the per-user team."""

    n: int
    kp: int
    team: int
    keys_in_smem: bool
    smem: int
    parts: int


def list_len(top_k, chunk):
    """Entries of one chunk's list (``list_len`` in the CUDA source)."""
    return min(top_k + SLACK if top_k > 1 else top_k, chunk)


def range_mode_applies(n_users, top_k, plan, n_sm):
    """Whether a same-type half call's items split into ranges of 2 chunks
    or more: k' <= RANGE_MAX_K, and a grid of one wave of ``n_sm`` blocks of
    BM users (one range per user block where the user blocks alone fill it)
    leaves each range at least 2 chunks."""
    ranges = max(1, n_sm // _ceil_div(n_users, BM))
    return top_k <= RANGE_MAX_K and _ceil_div(plan.splits, ranges) >= 2


def score_path(n_users, d, top_k, plan, smem_limit, n_sm, mma, aligned):
    """The score + select kernel a call takes: ``"fma"`` (the CUDA cores:
    any pairing with float32, or mixed half types), ``"wgmma"`` (the Hopper
    range kernel: the calls where range mode applies whose table TMA reads,
    rows of whole 16-byte units (d % 8 == 0), both tensors 16-byte aligned
    (``aligned``), d <= WGMMA_MAX_D) or ``"mma"`` (the tensor-core kernel, a
    list per chunk: every other same-type half call)."""
    if not mma:
        return "fma"
    if (aligned and d % 8 == 0 and d <= WGMMA_MAX_D and wgmma_smem_bytes(d) <= smem_limit
            and range_mode_applies(n_users, top_k, plan, n_sm)):
        return "wgmma"
    return "mma"


def wgmma_chunks_per_block(n_users, plan, n_sm):
    """Chunks a block of the Hopper range kernel walks: enough that its
    grid (ceil(B / WG_USERS) user blocks by ranges) is one wave of ``n_sm``
    blocks, at least 2 (a range)."""
    ranges = max(1, n_sm // _ceil_div(n_users, WG_USERS))
    return max(2, _ceil_div(plan.splits, ranges))


def merge_plan(n_users, n_items, top_k, plan, smem_limit, n_sm, cpb=1):
    """The merge's dynamic bytes stay within ``smem_limit`` less its static
    bytes. A user has one list per chunk (``cpb`` 1) or per range of ``cpb``
    chunks (k' entries each). Where the lists' keys fit beside the sort's
    words, one team per user copies them into shared memory. The split merge
    reads each list at most once, in SPLIT_BLOCKS_PER_SM blocks per SM of
    ``n_sm`` at least (a part of the lists each), where min(k', I) fits
    CAND_CAP and a list's bound is a threshold (not 0: the list is shorter
    than its chunk, or a range's), and either the keys do not fit or the
    team grid would leave SMs idle (over SPLIT_MIN_LISTS lists or more where
    there is a list per chunk). Else one team per user reads them in
    place."""
    dynamic_limit = smem_limit - MERGE_STATIC_SMEM
    if cpb > 1:
        lists, lmax = _ceil_div(plan.splits, cpb), top_k
        n = lists * lmax
    else:
        lists, lmax = plan.splits, list_len(top_k, plan.chunk)
        last = n_items - (plan.splits - 1) * plan.chunk
        n = (plan.splits - 1) * lmax + min(lmax, last)
    kp = _pow2_at_least(min(top_k, n_items))
    team = 32 if kp <= MERGE_WARP_MAX_K else MERGE_THREADS
    kp = max(kp, team)
    words = 8 * (kp + kp // 16)  # padded: word i at i + i // 16
    teams = MERGE_THREADS // team
    with_keys = teams * (words + 4 * _ceil_div(n, 2) * 2)
    fits = with_keys <= dynamic_limit
    kp_split = max(kp, MERGE_THREADS)
    idle = _ceil_div(n_users, teams) < n_sm and (cpb > 1 or lists >= SPLIT_MIN_LISTS)
    if kp_split <= CAND_CAP and (cpb > 1 or lmax < plan.chunk) and (not fits or idle):
        parts = max(1, min(_ceil_div(SPLIT_BLOCKS_PER_SM * n_sm, n_users), lists))
        smem = 8 * max(kp_split + kp_split // 16, CAND_CAP)
        return MergePlan(n, kp_split, MERGE_THREADS, False, smem, parts)
    if fits:
        return MergePlan(n, kp, team, True, with_keys, 0)
    smem = teams * words
    if smem > dynamic_limit:
        raise ValueError(f"fused_topk: k'={top_k} needs {smem} bytes of shared memory per "
                         f"merge block, more than the card's {smem_limit} less "
                         f"{MERGE_STATIC_SMEM} static")
    return MergePlan(n, kp, team, False, smem, 0)


def scratch_entries(n_users, top_k, plan):
    """Entries of the per-chunk lists (8 bytes each: the item and its key)."""
    return n_users * plan.splits * list_len(top_k, plan.chunk)


def scratch_words(n_users, top_k, plan, merge, cpb=1):
    """The scratch tensor's 8-byte words: the lists (per chunk, or k' per
    range of ``cpb`` chunks), one 4-byte lower bound per list, and for the
    split merge one 4-byte largest key per list, CAND_CAP candidate entries
    and a pair of 4-byte counters per user."""
    lists = _ceil_div(plan.splits, cpb)
    if cpb > 1:
        words = n_users * lists * top_k
    else:
        words = scratch_entries(n_users, top_k, plan)
    per_list = _ceil_div(n_users * lists, 2)
    words += per_list
    if merge.parts:
        words += per_list + n_users * (CAND_CAP + 1)
    return words


def launch_plan(n_users, n_items, d, smem_limit, n_sm, esize=4, mma=False):
    """The chunk is as large as ``smem_limit`` allows (a multiple of BN), cut
    further until the grid holds MIN_BLOCKS_PER_SM blocks per SM. ``esize``
    is the table's element size (4 float32, 2 bfloat16 or float16), ``mma``
    the tensor-core path. A catalog that needs more than MAX_SPLITS chunks
    raises."""
    chunk_max = min(MAX_CHUNK,
                    (smem_limit - smem_bytes(d, 0, esize, mma)) // (4 * BM) // BN * BN)
    if chunk_max < BN:
        raise ValueError(
            f"fused_topk: d={d} needs {smem_bytes(d, BN, esize, mma)} bytes of shared memory "
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
    return Plan(BM, chunk, _ceil_div(n_items, chunk), smem_bytes(d, chunk, esize, mma))


def uses_tensor_cores(u_dtype, t_dtype):
    """Users and table of one half type: the products run on the tensor
    cores; every other pairing on the CUDA cores."""
    return u_dtype == t_dtype and u_dtype in (torch.bfloat16, torch.float16)


def fused_topk_scores_reference(user_emb, item_table, top_k, col_offset=0, mask_pad=True):
    """Plain version: f32 ``user_emb @ item_table.T`` in item tiles, column 0
    masked (``mask_pad``), stable descending sort, first k', indices offset
    by ``col_offset``; −inf slots carry index 0."""
    scores, idx = streaming_topk_scores(user_emb, item_table, top_k, mask_pad=mask_pad,
                                        col_offset=col_offset)
    idx = torch.where(torch.isneginf(scores), torch.zeros_like(idx), idx)
    return scores, idx


def launch_args(device, B, I, d, top_k, u_dtype, t_dtype, aligned=True):
    """For these shapes and types on this device (and users and table
    16-byte ``aligned`` or not), made once: the scratch's 8-byte words, the
    launch's shape arguments before ``vec``, its two shared memory sizes
    after it, and the score kernel's path (``score_path``; the wrapper's
    host time is part of every call)."""
    key = (device.index, B, I, d, top_k, u_dtype, t_dtype, aligned)
    args = _LAUNCH_ARGS.get(key)
    if args is None:
        smem_limit = _lib().fused_topk_max_smem()
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        esize = torch.empty((), dtype=t_dtype).element_size()
        mma = uses_tensor_cores(u_dtype, t_dtype)
        plan = launch_plan(B, I, d, smem_limit, n_sm, esize, mma)
        path = score_path(B, d, top_k, plan, smem_limit, n_sm, mma, aligned)
        if path == "wgmma":
            cpb, smem = wgmma_chunks_per_block(B, plan, n_sm), wgmma_smem_bytes(d)
        else:
            cpb, smem = 1, plan.smem
        merge = merge_plan(B, I, top_k, plan, smem_limit, n_sm, cpb)
        shape = (B, I, d, top_k, plan.chunk, plan.splits, cpb, merge.n, merge.kp, merge.team,
                 int(merge.keys_in_smem), merge.parts)
        args = _LAUNCH_ARGS[key] = (scratch_words(B, top_k, plan, merge, cpb), shape,
                                    (smem, merge.smem), path)
    return args


def _launch(user_emb, item_table, out_s, out_i, top_k, col_offset, mask_pad):
    """The C call and its scratch: the span ``fused_topk.launch`` with the
    attr ``path``; the counter ``fused_topk.wgmma`` counts the calls of the
    Hopper range kernel."""
    with tracing.span("fused_topk.launch") as sp:
        (B, d), device = user_emb.shape, user_emb.device
        u_dtype, t_dtype = user_emb.dtype, item_table.dtype
        u, t = user_emb.data_ptr(), item_table.data_ptr()
        words, shape, smem, path = launch_args(device, B, item_table.shape[0], d, top_k,
                                               u_dtype, t_dtype, u % 16 == 0 and t % 16 == 0)
        if sp:
            sp.set("path", path)
        if path == "wgmma":
            tracing.count("fused_topk.wgmma")
        scratch = torch.empty(words, dtype=torch.int64, device=device)
        # 16-byte copies of T, and of U where it is read by cp.async: f32
        # users, and users of the tensor-core path (half users of the
        # CUDA-core path are read by plain loads)
        u_plain = u_dtype != torch.float32 and not uses_tensor_cores(u_dtype, t_dtype)
        vec = int(d % (16 // item_table.element_size()) == 0 and t % 16 == 0
                  and (u_plain or u % 16 == 0))
        # the raw handle of the current stream, without building a torch.cuda.Stream
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        return _lib().fused_topk_launch(
            u, t, scratch.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), *shape, vec, *smem,
            int(col_offset), int(mask_pad), DTYPE_CODES[u_dtype], DTYPE_CODES[t_dtype],
            int(path == "wgmma"), stream,
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
            raise TypeError(f"fused_topk: the kernel takes float32, bfloat16 or float16 "
                            f"tensors, not {dtype}")
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
