"""Catalog scale on the CPU against the JAX package: bfloat16 and float16
item tables (and users, in any pairing with float32) through the fused
top-k and the retrieval entry points, the kernel's launch plan at bench.py's
2M-item catalog, and the scale train step at a cut size.

The kernel itself runs only on the card (``test_torch_kernels_gpu.py``,
``chip_smoke.py``'s ``scale`` phase); here the wrapper takes its plain
version, as it does for every CPU tensor. Inputs come from numpy seeds and
go to both packages; bfloat16 and float16 values are made by rounding
float32 draws, so both packages hold the same numbers.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from recbole_fairrec_tpu.config import Config as JaxConfig
from recbole_fairrec_tpu.ops.pallas.fused_topk import fused_topk_scores as pallas_fused_topk
from recbole_fairrec_tpu.ops.topk import approx_topk_scores as jax_approx_topk
from recbole_fairrec_tpu.trainer import Trainer as JaxTrainer
from recbole_fairrec_tpu.utils import get_model as jax_get_model

from recbole_fairrec_tpu_torch.ops import fused_topk
from recbole_fairrec_tpu_torch.ops.topk import approx_topk_scores, certified_topk_scores
from recbole_fairrec_tpu_torch.utils.jax_params import load_jax_params, to_jax_params

H100_SMEM = 232448  # 227 KB of opt-in shared memory per block
H100_SMS = 132
K = 10


def _bf16_inputs(seed, B, I, d, dtype=torch.bfloat16):
    """float32 draws rounded to ``dtype`` (bfloat16 or float16): the port's
    tensors and the same values as float32 numpy arrays (exact in
    ``dtype``) for JAX."""
    rng = np.random.RandomState(seed)
    U = torch.from_numpy(rng.randn(B, d).astype(np.float32)).to(dtype)
    T = torch.from_numpy(rng.randn(I, d).astype(np.float32)).to(dtype)
    return U, T, U.float().numpy(), T.float().numpy()


def _assert_topk_close(s, i, ref_s, ref_i, U, T):
    """Scores within the float32 summation-order bound, ids equal but where
    two of the reference's adjacent scores lie within that bound.

    Every product of two bfloat16 values is exact in float32 (so is every
    product of two float16 values, or of a float16 and a bfloat16), so the two
    packages differ only by the order of the d additions: each sum is
    within d * 2^-24 * sum_j |u_j t_j| of the exact value, two orders within
    twice that (``tol``). A near tie is a pair of adjacent reference scores
    within ``tol`` of each other, which the two orders may rank either way
    (chip_smoke's near-tie rule)."""
    s, i, ref_s, ref_i = (np.asarray(x) for x in (s, i, ref_s, ref_i))
    d = U.shape[1]
    abs_dot = np.take_along_axis(np.abs(U) @ np.abs(T).T, ref_i.astype(np.int64), axis=1)
    tol = 2 * d * 2.0 ** -24 * abs_dot
    assert s.dtype == np.float32 and i.dtype == np.int32
    assert (np.abs(s - ref_s) <= tol).all()
    near = np.zeros(ref_s.shape, dtype=bool)
    close = np.abs(np.diff(ref_s, axis=1)) <= tol[:, 1:]
    near[:, 1:] |= close
    near[:, :-1] |= close
    assert ((i == ref_i) | near).all()
    assert not (i == 0).any()


@pytest.fixture(scope="module")
def bf16_case():
    U, T, U32, T32 = _bf16_inputs(9, 64, 4097, 128)
    ref_s, ref_i = pallas_fused_topk(jnp.asarray(U32, jnp.bfloat16), jnp.asarray(T32, jnp.bfloat16),
                                     K, user_tile=64, item_tile=1024, interpret=True)
    return U, T, U32, T32, np.asarray(ref_s), np.asarray(ref_i)


def test_bf16_table_fused_topk_matches_pallas(bf16_case):
    """U [64, 128] and T [4097, 128] in bfloat16, k' 10: the port's
    ``fused_topk_scores`` (plain on the CPU) against the Pallas kernel in
    interpret mode, which accumulates in float32
    (``preferred_element_type``). Tolerance: ``_assert_topk_close``."""
    U, T, U32, T32, ref_s, ref_i = bf16_case
    s, i = fused_topk.fused_topk_scores(U, T, K)
    _assert_topk_close(s.numpy(), i.numpy(), ref_s, ref_i, U32, T32)
    mixed_s, mixed_i = fused_topk.fused_topk_scores(U.float(), T, K)  # f32 users, bf16 table
    _assert_topk_close(mixed_s.numpy(), mixed_i.numpy(), ref_s, ref_i, U32, T32)


def test_bf16_table_retrieval_matches_jax(bf16_case):
    """``approx_topk_scores`` (with and without ``verify``) and
    ``certified_topk_scores`` on the bfloat16 table against the JAX
    package's ``approx_topk_scores`` (exact on the CPU) and the Pallas
    kernel; the port's contract is unchanged: float32 scores, int32 ids,
    every row certified."""
    U, T, U32, T32, ref_s, ref_i = bf16_case
    j_s, j_i, j_cert = jax_approx_topk(jnp.asarray(U32, jnp.bfloat16),
                                       jnp.asarray(T32, jnp.bfloat16), K, verify=True)
    assert np.asarray(j_cert).all()
    _assert_topk_close(np.asarray(j_s), np.asarray(j_i), ref_s, ref_i, U32, T32)
    s, i, cert = approx_topk_scores(U, T, K, verify=True)
    assert cert.dtype == torch.bool and bool(cert.all()) and cert.shape == (64,)
    _assert_topk_close(s.numpy(), i.numpy(), np.asarray(j_s), np.asarray(j_i), U32, T32)
    s2, i2 = approx_topk_scores(U, T, K)
    assert torch.equal(s2, s) and torch.equal(i2, i)
    c_s, c_i = certified_topk_scores(U, T, K)
    assert torch.equal(c_s, s) and torch.equal(c_i, i)


@pytest.fixture(scope="module")
def f16_case():
    U, T, U32, T32 = _bf16_inputs(10, 64, 4097, 128, torch.float16)
    ref_s, ref_i = pallas_fused_topk(jnp.asarray(U32, jnp.float16), jnp.asarray(T32, jnp.float16),
                                     K, user_tile=64, item_tile=1024, interpret=True)
    return U, T, U32, T32, np.asarray(ref_s), np.asarray(ref_i)


def test_f16_table_fused_topk_matches_pallas(f16_case):
    """U [64, 128] and T [4097, 128] in float16, k' 10: the port's
    ``fused_topk_scores`` against the Pallas kernel in interpret mode on the
    same float16 arrays (products exact, sums in float32), for float16
    users and table, float32 users over the float16 table and float16 users
    over a float32 table of the same values. Then the two mixed half
    pairings, bfloat16 users (the float16 users rounded again) over the
    float16 table and float16 users over a bfloat16 table, each against the
    Pallas kernel on its values in float32 at precision "highest". Tolerance:
    ``_assert_topk_close``."""
    U, T, U32, T32, ref_s, ref_i = f16_case
    for u, t in ((U, T), (U.float(), T), (U, T.float())):
        s, i = fused_topk.fused_topk_scores(u, t, K)
        _assert_topk_close(s.numpy(), i.numpy(), ref_s, ref_i, U32, T32)
    # the mixed half pairings: bfloat16 users (the float16 ones rounded again)
    # over the float16 table, float16 users over a bfloat16 table
    Tb = T.to(torch.bfloat16)
    for u, t in ((U.to(torch.bfloat16), T), (U, Tb)):
        u32, t32 = u.float().numpy(), t.float().numpy()
        m_s, m_i = pallas_fused_topk(jnp.asarray(u32), jnp.asarray(t32), K, user_tile=64,
                                     item_tile=1024, interpret=True, precision="highest")
        s, i = fused_topk.fused_topk_scores(u, t, K)
        _assert_topk_close(s.numpy(), i.numpy(), np.asarray(m_s), np.asarray(m_i), u32, t32)


def test_f16_table_retrieval_matches_jax(f16_case):
    """``approx_topk_scores`` (with and without ``verify``) and
    ``certified_topk_scores`` on the float16 table, with float16 and with
    float32 users, against the JAX package's ``approx_topk_scores`` (exact
    on the CPU) on the same float16 arrays and the Pallas kernel: float32
    scores, int32 ids, every row certified."""
    U, T, U32, T32, ref_s, ref_i = f16_case
    j_s, j_i, j_cert = jax_approx_topk(jnp.asarray(U32, jnp.float16),
                                       jnp.asarray(T32, jnp.float16), K, verify=True)
    assert np.asarray(j_cert).all() and np.asarray(j_s).dtype == np.float32
    _assert_topk_close(np.asarray(j_s), np.asarray(j_i), ref_s, ref_i, U32, T32)
    for u in (U, U.float()):
        s, i, cert = approx_topk_scores(u, T, K, verify=True)
        assert cert.dtype == torch.bool and bool(cert.all()) and cert.shape == (64,)
        _assert_topk_close(s.numpy(), i.numpy(), np.asarray(j_s), np.asarray(j_i), U32, T32)
        s2, i2 = approx_topk_scores(u, T, K)
        assert torch.equal(s2, s) and torch.equal(i2, i)
        c_s, c_i = certified_topk_scores(u, T, K)
        assert torch.equal(c_s, s) and torch.equal(c_i, i)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_kernel_dtypes_are_named_in_the_refusal(dtype):
    """float32, bfloat16 and float16 reach the kernel or its plain version,
    on either side (float16 is accepted and ranks as its widened values do);
    any other dtype raises a TypeError that names it."""
    U = (torch.arange(32, dtype=torch.float32).reshape(4, 8) % 5 - 2).to(dtype)
    T = torch.arange(80, dtype=torch.float32).reshape(10, 8) % 3 - 1
    for args in ((U, T), (T[:4], U.new_zeros(10, 8) + U[0, 0])):
        if dtype == torch.float16:
            s, i = fused_topk.fused_topk_scores(*args, 3)
            ref_s, ref_i = fused_topk.fused_topk_scores_reference(
                args[0].float(), args[1].float(), 3)
            assert torch.equal(s, ref_s) and torch.equal(i, ref_i)
            continue
        with pytest.raises(TypeError, match=str(dtype).replace("torch.", "")):
            fused_topk.fused_topk_scores(*args, 3)


def test_near_tie_rule_reaches_the_last_slot():
    """chip_smoke's near-tie rule (how the card's tests hold the tensor-core
    path, whose float32 sums of exact products run in another order than
    the plain version's): a kernel may rank the plain version's (k'+1)-th
    item k'-th where the two scores lie within the summation-order bound
    (``plain_topk_with_next`` gives that neighbour); without it a swap at
    the last slot fails, and a swap with an item outside the bound fails
    either way."""
    U = torch.ones(1, 4)
    T = torch.tensor([[0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0], [0.5, 0.5, 0.5, 0.5],
                      [0.5, 0.5, 0.5, 0.5 + 2.0 ** -21], [0.1, 0.0, 0.0, 0.0]])
    s_p, i_p, s_next = chip_smoke.plain_topk_with_next(fused_topk, U, T, 2)
    assert i_p.tolist() == [[1, 3]] and float(s_next[0]) == 2.0
    swapped_s, swapped_i = torch.tensor([[4.0, 2.0]]), torch.tensor([[1, 2]], dtype=torch.int32)
    err, near = chip_smoke._compare_topk("last slot", U, T, 2, swapped_s, swapped_i, s_p, i_p,
                                         s_next=s_next)
    assert near == 1 and err == 2.0 ** -21
    with pytest.raises(SystemExit):
        chip_smoke._compare_topk("last slot", U, T, 2, swapped_s, swapped_i, s_p, i_p)
    far_s, far_i = torch.tensor([[4.0, 0.1]]), torch.tensor([[1, 4]], dtype=torch.int32)
    with pytest.raises(SystemExit):
        chip_smoke._compare_topk("last slot", U, T, 2, far_s, far_i, s_p, i_p, s_next=s_next)


# ------------------------------------------------------------ launch plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("B", [128, 1024])
def test_launch_plan_at_catalog_scale(B, dtype):
    """bench_scale's catalog with a PAD row (2,097,153 items, d 128, k' 10),
    users of the table's type: chunks of 512 (the most a block's keys take),
    4,097 of them (a last chunk of one item) within the grid's 65,535; a
    block within the opt-in shared memory; item ids fit int32.

    float32 (the CUDA cores): a list of k' + 32 = 42 entries per chunk,
    172,033 a user (176 MB at B 128, 1.41 GB at B 1024), too many for shared
    memory, so the split merge reads them (each at most once) in 5 blocks a
    user at B 128 (640 blocks, at least 4 per SM) and one at B 1024.

    bfloat16 and float16 (the tensor cores): range mode (the tensor-core
    kernel would walk 63 chunks a block at B 128 and 513 at B 1024), taken
    by the Hopper range kernel: a block of 128 users over 32 chunks at B 128
    and 257 at B 1024 (one wave: 1 x 129 and 8 x 16 blocks), one list of k'
    per range (129 and 16 a user), taken by the split merge because a warp
    per user would leave SMs idle: 5 blocks a user at B 128 (640 blocks),
    one at B 1024."""
    I, d = 2 * 1024 * 1024 + 1, 128
    esize = torch.empty((), dtype=dtype).element_size()
    mma = fused_topk.uses_tensor_cores(dtype, dtype)
    assert mma == (dtype != torch.float32)
    plan = fused_topk.launch_plan(B, I, d, H100_SMEM, H100_SMS, esize, mma)
    assert plan.chunk == 512 and plan.splits == 4097 <= fused_topk.MAX_SPLITS
    assert plan.smem == fused_topk.smem_bytes(d, 512, esize, mma) <= H100_SMEM
    cpb = fused_topk.chunks_per_block(B, K, plan, H100_SMS, mma)
    merge = fused_topk.merge_plan(B, I, K, plan, H100_SMEM, H100_SMS, cpb)
    assert merge.smem + fused_topk.MERGE_STATIC_SMEM <= H100_SMEM
    assert I < 2**31 and merge.n < 2**31  # ids and list positions in int32
    assert 8 * fused_topk.scratch_entries(B, K, plan) == B * 4097 * 42 * 8
    assert {128: 176_203_776, 1024: 1_409_630_208}[B] == 8 * fused_topk.scratch_entries(
        B, K, plan)
    parts = {128: 5, 1024: 1}[B]
    assert B * parts >= 4 * H100_SMS
    if not mma:
        assert cpb == 1
        assert merge == (4096 * 42 + 1, 256, fused_topk.MERGE_THREADS, False,
                         8 * fused_topk.CAND_CAP, parts)
        assert fused_topk.scratch_words(B, K, plan, merge) == \
            B * 4097 * 42 + 2 * (B * 4097 // 2) + B * (fused_topk.CAND_CAP + 1)
        return
    assert cpb == {128: 63, 1024: 513}[B]  # range mode
    assert fused_topk.score_path(B, d, K, plan, H100_SMEM, H100_SMS, mma, True) == "wgmma"
    assert fused_topk.wgmma_smem_bytes(d) == 230480 <= H100_SMEM
    cpb_want, lists = {128: (32, 129), 1024: (257, 16)}[B]
    cpb = fused_topk.wgmma_chunks_per_block(B, plan, H100_SMS)
    assert cpb == cpb_want and -(-4097 // cpb) == lists
    merge = fused_topk.merge_plan(B, I, K, plan, H100_SMEM, H100_SMS, cpb)
    user_blocks = -(-B // fused_topk.WG_USERS)
    assert H100_SMS - 4 <= user_blocks * lists <= H100_SMS  # one wave
    assert merge == (lists * K, 256, fused_topk.MERGE_THREADS, False,
                     8 * fused_topk.CAND_CAP, parts)
    assert fused_topk.scratch_words(B, K, plan, merge, cpb) == \
        B * lists * K + 2 * (B * lists // 2) + B * (fused_topk.CAND_CAP + 1)


def test_launch_plan_at_the_pallas_bench_shape():
    """bench_pallas_topk's float32 shape (B 1024, I 65,536, d 64, k' 10):
    128 chunks of 512; the lists (5,376 entries a user) fit shared memory."""
    plan = fused_topk.launch_plan(1024, 65536, 64, H100_SMEM, H100_SMS)
    assert plan == (64, 512, 128, 211968)
    merge = fused_topk.merge_plan(1024, 65536, K, plan, H100_SMEM, H100_SMS)
    assert merge == (128 * 42, 32, 32, True, 8 * (8 * (32 + 2) + 4 * 128 * 42), 0)


def test_launch_plan_refuses_past_the_grid_and_shared_memory():
    with pytest.raises(ValueError, match="grid"):
        fused_topk.launch_plan(128, 512 * fused_topk.MAX_SPLITS + 1, 128, H100_SMEM, H100_SMS, 2)
    fused_topk.launch_plan(128, 512 * fused_topk.MAX_SPLITS, 128, H100_SMEM, H100_SMS, 2)
    with pytest.raises(ValueError, match="shared memory"):
        fused_topk.launch_plan(128, 4096, 1024, H100_SMEM, H100_SMS, 2)


def test_plan_bytes_match_the_cuda_layout():
    """The CUDA source pins its block layout with static_asserts on
    ``score_smem_bytes``; the Python plan must give the same bytes (and the
    launch refuses any other)."""
    with open(fused_topk.SOURCE, encoding="utf-8") as f:
        src = f.read()
    pins = re.findall(r"static_assert\(score_smem_bytes<(float|__nv_bfloat16|__half), "
                      r"(true|false)>\((\d+), (\d+)\) == (\d+)", src)
    assert {p[:2] for p in pins} == {("float", "false"), ("__nv_bfloat16", "false"),
                                     ("__half", "false"), ("__nv_bfloat16", "true"),
                                     ("__half", "true")}
    for ctype, mma, d, chunk, nbytes in pins:
        esize = 4 if ctype == "float" else 2
        assert fused_topk.smem_bytes(int(d), int(chunk), esize, mma == "true") == int(nbytes)
    constants = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(constants["kCandCap"]) == fused_topk.CAND_CAP
    assert int(constants["kBKM"]) == fused_topk.BK_MMA
    assert int(constants["kMergeStaticSmem"]) == fused_topk.MERGE_STATIC_SMEM
    assert int(constants["kMaxChunk"]) == fused_topk.MAX_CHUNK


def _path(B, I, d, k, dtype=torch.bfloat16, t_dtype=None, aligned=True):
    t_dtype = dtype if t_dtype is None else t_dtype
    esize = torch.empty((), dtype=t_dtype).element_size()
    mma = fused_topk.uses_tensor_cores(dtype, t_dtype)
    plan = fused_topk.launch_plan(B, I, d, H100_SMEM, H100_SMS, esize, mma)
    return fused_topk.score_path(B, d, k, plan, H100_SMEM, H100_SMS, mma, aligned)


@pytest.mark.parametrize("case,want", [
    ((128, 2097153, 128, 10, torch.bfloat16), "wgmma"),  # the catalog, both batch sizes
    ((1024, 2097153, 128, 10, torch.bfloat16), "wgmma"),
    ((128, 2097153, 128, 10, torch.float16), "wgmma"),
    ((1024, 2097153, 128, 10, torch.float16), "wgmma"),
    ((1024, 2097153, 128, 1, torch.bfloat16), "wgmma"),   # k' 1 and 32: still range mode
    ((1024, 2097153, 128, 32, torch.float16), "wgmma"),
    ((128, 1048576, 8, 10, torch.bfloat16), "wgmma"),     # one 16-byte unit a row
    ((128, 2097153, 128, 10, torch.float32), "fma"),      # f32: exact FMA on the CUDA cores
    ((128, 2097153, 128, 10, torch.bfloat16, torch.float16), "fma"),  # mixed halves
    ((1024, 2097153, 128, 33, torch.bfloat16), "mma"),    # k' > 32: a list per chunk
    ((128, 2097153, 128, 173, torch.float16), "mma"),
    ((1024, 524288, 30, 10, torch.float16), "mma"),       # d 30: rows not whole 16-byte units
    ((1024, 524288, 136, 10, torch.bfloat16), "mma"),     # past the layout's two panels
    ((64, 4097, 128, 10, torch.bfloat16), "mma"),         # two chunks: no range mode
])
def test_score_path_choice(case, want):
    """The score kernel a call takes, from its dtypes, k', d and chunks: the
    Hopper range kernel for range mode's calls that TMA reads (the catalog's
    bf16 and f16 calls at k' <= 32), the tensor-core kernel for the other
    same-type half calls, the CUDA cores for every call with float32 or mixed
    half types."""
    assert _path(*case) == want


def test_score_path_needs_aligned_tensors():
    """TMA reads 16-byte aligned rows: an unaligned user or table pointer
    keeps range mode on the tensor-core kernel."""
    assert _path(1024, 2097153, 128, 10, aligned=False) == "mma"


def test_wgmma_plan_bytes_match_the_cuda_layout():
    """The Hopper range kernel's block layout: the CUDA source pins
    ``wgmma_smem_bytes`` with static_asserts and the launch refuses other
    bytes; the Python mirror gives the same, from the same constants."""
    with open(fused_topk.SOURCE, encoding="utf-8") as f:
        src = f.read()
    pins = re.findall(r"static_assert\(wgmma_smem_bytes\((\d+)\) == (\d+)", src)
    assert {int(d) for d, _ in pins} == {8, 64, 128}
    for d, nbytes in pins:
        assert fused_topk.wgmma_smem_bytes(int(d)) == int(nbytes)
    constants = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(constants["kWgUsers"]) == fused_topk.WG_USERS
    assert int(constants["kWgTile"]) == fused_topk.WG_TILE
    assert int(constants["kWgStages"]) == fused_topk.WG_STAGES
    assert int(constants["kWgMaxD"]) == fused_topk.WGMMA_MAX_D
    assert int(constants["kCandWords"]) == fused_topk.CAND_WORDS
    assert fused_topk.wgmma_smem_bytes(fused_topk.WGMMA_MAX_D) <= H100_SMEM


# ------------------------------------------------------- the scale step


def test_scale_step_matches_jax(tmp_path):
    """bench_scale's train step cut to 4,096 users, 8,192 items, d 128,
    batch 1,024: the JAX package's ``Trainer._get_update_fn("calculate_loss",
    None, "main")`` and the port's ``Trainer._train_step`` (the one
    ``chip_smoke.py`` times at full size) from the same weights, on the
    first batch of bench.py's RandomState(3) draws, dense Adam.

    Tolerances: loss within 1e-5 relative (float32 means summed in another
    order; measured 0). Parameters within 5e-5 absolute: Adam's first step
    moves an element by lr * g / (|g| + eps), so where the gradient lies
    within its float32 noise delta of 0 the two packages' steps differ by up
    to lr * delta / eps. Gradients here are of order 1e-3 (a mean over 1,024
    rows plus weight decay), whose noise is a few ulps of 2^-33 (1.2e-10):
    delta <= 5e-10 gives lr * delta / eps <= 5e-5. Every other element moves
    by the same lr * sign(g) in both (measured gap 8.6e-6 on the item
    table, 2.4e-7 on the user table)."""
    n_users, n_items, d, batch = 4096, 8192, 128, 1024
    cfg = chip_smoke.scale_config_dict(str(tmp_path), d, {"state": "ERROR"})
    jax_config = JaxConfig(model="PFCN_PMF", dataset="scale", config_dict=cfg)
    jax_model = jax_get_model("PFCN_PMF")(jax_config, chip_smoke.ScaleDataset(n_users, n_items))
    jt = JaxTrainer(jax_config, jax_model)
    update = jt._get_update_fn("calculate_loss", None, "main")
    params = jax.tree_util.tree_map(np.asarray, jt.params)

    pt = chip_smoke.scale_trainer(str(tmp_path), n_users, n_items, d,
                                  {"use_gpu": False, "state": "ERROR"})
    load_jax_params(pt.model, params)
    assert type(pt.optimizer) is torch.optim.Adam and pt.optimizer.defaults["weight_decay"] \
        == jax_config["weight_decay"]

    first = chip_smoke.scale_batches(n_users, n_items, batch)[0]
    loss, new_params, _, _ = update(jt.params, jt.model_state, jt.opt_state,
                                    jax.random.PRNGKey(0),
                                    {k: jnp.asarray(v) for k, v in first.items()})
    pt.model.train()
    port_loss = pt._train_step({k: torch.from_numpy(v).long() for k, v in first.items()},
                               "calculate_loss", None, pt.optimizer)
    np.testing.assert_allclose(float(port_loss), float(loss), rtol=1e-5)
    got = to_jax_params(pt.model)
    for name, value in jax.tree_util.tree_map(np.asarray, new_params).items():
        np.testing.assert_allclose(got[name], value, rtol=0, atol=5e-5, err_msg=name)
        assert np.abs(got[name] - params[name]).max() > 1e-4  # the step moved the table


def test_scale_batches_follow_bench_draw_order():
    """chip_smoke's batches are bench_scale's: per batch, users then
    positives then negatives from one RandomState(3), int32, ids >= 1."""
    rng = np.random.RandomState(3)
    batches = chip_smoke.scale_batches(50, 90, 16, n=2)
    for b in batches:
        for key, hi in (("user_id", 50), ("item_id", 90), ("neg_item_id", 90)):
            np.testing.assert_array_equal(b[key], rng.randint(1, hi, 16, dtype=np.int32))
            assert b[key].dtype == np.int32


def test_scale_trainer_takes_the_duck_typed_dataset(tmp_path):
    """The port's model and trainer need only ``num`` of the dataset (as the
    JAX package's do in bench_scale): no per-user Python work at
    construction, tables of exactly ``num`` rows, on the CPU when asked."""
    pt = chip_smoke.scale_trainer(str(tmp_path), 300, 700, 16, {"use_gpu": False,
                                                                "state": "ERROR"})
    assert pt.device.type == "cpu"
    assert tuple(pt.model.user_embedding.weight.shape) == (300, 16)
    assert tuple(pt.model.item_embedding.weight.shape) == (700, 16)
    assert os.path.isdir(str(tmp_path / "saved"))
