"""The port's fused score + top-k' against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain version; the Pallas kernel runs in
interpret mode. Inputs are made with numpy and fed to both. Tolerance:
scores within atol 1e-5 (float32 dot products of length <= 16 on values of
order 1, summed in different orders), indices equal slot for slot. The
kernel itself is held against the plain version on the card by
``test_torch_kernels_gpu.py`` and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recbole_fairrec_tpu.ops.pallas.fused_topk import fused_topk_scores as pallas_fused_topk
from recbole_fairrec_tpu.ops.topk import streaming_topk_scores as jax_streaming_topk

from recbole_fairrec_tpu_torch.ops import fused_topk
from recbole_fairrec_tpu_torch.ops.topk import streaming_topk_scores


def _inputs(seed, B, I, d, integer=False):
    rng = np.random.RandomState(seed)
    if integer:
        U = rng.randint(-1, 2, (B, d)).astype(np.float32)
        T = rng.randint(-1, 2, (I, d)).astype(np.float32)
    else:
        U = rng.randn(B, d).astype(np.float32)
        T = rng.randn(I, d).astype(np.float32)
    return U, T


def _pallas(U, T, k, item_tile=128):
    s, i = pallas_fused_topk(jnp.asarray(U), jnp.asarray(T), k, user_tile=8,
                             item_tile=item_tile, interpret=True, precision="highest")
    return np.asarray(s), np.asarray(i)


def _port(U, T, k):
    s, i = fused_topk.fused_topk_scores(torch.from_numpy(U), torch.from_numpy(T), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("B,I,d,k,item_tile", [
    (19, 301, 16, 4, 128),    # tests/test_ops.py's Pallas shapes
    (19, 301, 16, 70, 64),    # k' larger than one item tile
    (24, 513, 8, 37, 64),     # several tiles, ragged tail
])
def test_matches_pallas_interpret(B, I, d, k, item_tile):
    U, T = _inputs(1, B, I, d)
    s_ref, i_ref = _pallas(U, T, k, item_tile)
    s, i = _port(U, T, k)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, atol=1e-5, rtol=0)
    assert not (i == 0).any()


@pytest.mark.parametrize("k", [5, 40, 70])
def test_ties_match_pallas_slot_for_slot(k):
    """Small-integer embeddings give exact float32 ties; both rank them by
    the lowest item index."""
    U, T = _inputs(3, 16, 300, 4, integer=True)
    s_ref, i_ref = _pallas(U, T, k, item_tile=64)
    s, i = _port(U, T, k)
    assert (np.diff(s_ref, axis=1) == 0).sum() > 0  # the case has ties
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(s, s_ref)


@pytest.mark.parametrize("tile", [64, 4096])
def test_matches_jax_streaming(tile):
    U, T = _inputs(5, 33, 700, 12)
    s_ref, i_ref = jax_streaming_topk(jnp.asarray(U), jnp.asarray(T), 50, tile=tile,
                                      mask_pad=True)
    s, i = _port(U, T, 50)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(s, np.asarray(s_ref), atol=1e-5, rtol=0)


def test_port_streaming_matches_jax_without_pad_mask():
    U, T = _inputs(6, 9, 200, 8, integer=True)
    s_ref, i_ref = jax_streaming_topk(jnp.asarray(U), jnp.asarray(T), 30, tile=64)
    s, i = streaming_topk_scores(torch.from_numpy(U), torch.from_numpy(T), 30, tile=64)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_k_beyond_catalogue_pads_with_neg_inf_and_index_zero():
    U, T = _inputs(7, 4, 10, 8)
    s, i = _port(U, T, 12)
    assert np.isfinite(s[:, :9]).all() and np.isneginf(s[:, 9:]).all()
    assert (i[:, 9:] == 0).all() and (i[:, :9] != 0).all()
    dense = U @ T.T
    dense[:, 0] = -np.inf
    np.testing.assert_array_equal(i[:, :9], np.argsort(-dense, axis=1, kind="stable")[:, :9])


@pytest.mark.parametrize("case", ["k0", "k_above_max", "rank", "width", "mixed_device"])
def test_wrapper_rejects_bad_input(case):
    U = torch.zeros(4, 8)
    T = torch.zeros(10, 8)
    k = 3
    if case == "k0":
        k = 0
    elif case == "k_above_max":
        k = fused_topk.MAX_K + 1
    elif case == "rank":
        U = torch.zeros(4, 8, 1)
    elif case == "width":
        T = torch.zeros(10, 7)
    elif case == "mixed_device":
        T = torch.zeros(10, 8, device="meta")
    with pytest.raises((ValueError, TypeError)):
        fused_topk.fused_topk_scores(U, T, k)


def test_cpu_tensor_takes_plain_version_without_counting():
    before = fused_topk.launches
    U, T = _inputs(8, 5, 50, 4)
    s, i = _port(U, T, 7)
    ref_s, ref_i = fused_topk.fused_topk_scores_reference(torch.from_numpy(U),
                                                          torch.from_numpy(T), 7)
    np.testing.assert_array_equal(i, ref_i.numpy())
    assert fused_topk.launches == before


H100_SMEM = 232448  # 227 KB of opt-in shared memory per block
H100_SMS = 132


@pytest.mark.parametrize("k", [1, 173, 2048, 4096])
@pytest.mark.parametrize("d", [30, 64, 128])
def test_launch_plan_fits_shared_memory(d, k):
    B, I = 6144, 16384 if k == 4096 else 3630
    plan = fused_topk.launch_plan(B, I, d, H100_SMEM, H100_SMS)
    assert plan.bm == fused_topk.BM and plan.smem == fused_topk.smem_bytes(d, plan.chunk)
    assert plan.smem <= H100_SMEM
    merge = fused_topk.merge_plan(B, I, k, plan, H100_SMEM, H100_SMS)
    assert merge.smem + fused_topk.MERGE_STATIC_SMEM <= H100_SMEM
    assert merge.parts == 0  # the lists fit shared memory: one team per user
    assert merge.team in (32, fused_topk.MERGE_THREADS)
    assert merge.kp >= max(min(k, I), merge.team) and merge.kp % merge.team == 0
    last = I - (plan.splits - 1) * plan.chunk  # items of the last chunk
    lmax = fused_topk.list_len(k, plan.chunk)
    assert min(k, plan.chunk) <= lmax <= min(k + fused_topk.SLACK, plan.chunk)
    assert merge.n == (plan.splits - 1) * lmax + min(lmax, last)
    assert plan.chunk % fused_topk.BN == 0
    assert plan.chunk * (plan.splits - 1) < I <= plan.chunk * plan.splits  # no empty chunk
    assert -(-B // plan.bm) * plan.splits >= 2 * H100_SMS  # >= 2 blocks per SM
    entries = fused_topk.scratch_entries(B, k, plan)
    assert entries == B * plan.splits * lmax
    if k >= plan.chunk:  # every list is a whole chunk: the lists hold all B x I scores
        assert B * I <= entries < B * (I + plan.chunk)


def test_launch_plan_at_the_serving_shape():
    """B 6144, I 3630, d 64: 96 user blocks x 8 chunks of 512 items; the
    lists (k' + 32 entries, at most a chunk) take 81 MB at k' 173 and
    201 MB at k' 2048, 805 MB at k' 4096 with I 16384."""
    plan = fused_topk.launch_plan(6144, 3630, 64, H100_SMEM, H100_SMS)
    assert plan == (64, 512, 8, 211968)
    assert 8 * fused_topk.scratch_entries(6144, 173, plan) == 80_609_280
    assert 8 * fused_topk.scratch_entries(6144, 2048, plan) == 201_326_592
    big = fused_topk.launch_plan(6144, 16384, 64, H100_SMEM, H100_SMS)
    assert 8 * fused_topk.scratch_entries(6144, 4096, big) == 805_306_368
    merge = fused_topk.merge_plan(6144, 3630, 173, plan, H100_SMEM, H100_SMS)
    # 7 lists of 205 and the last chunk's 46 items; a warp per user, 8 per block
    assert merge == (7 * 205 + 46, 256, 32, True, 8 * (8 * (256 + 16) + 4 * 1482), 0)
    assert fused_topk.list_len(1, 512) == 1  # an arg-max list needs no slack


def test_merge_plan_leaves_room_for_static_shared_memory():
    """B 6144, I 6176, d 64, k' 480: the lists' keys with the sort's words
    come to exactly the opt-in limit, which the merge kernel's static bytes
    would overrun, so the merge reads the keys in place."""
    plan = fused_topk.launch_plan(6144, 6176, 64, H100_SMEM, H100_SMS)
    assert plan == (64, 512, 13, 211968)
    merge = fused_topk.merge_plan(6144, 6176, 480, plan, H100_SMEM, H100_SMS)
    # every list is a whole chunk (480 + 32 slots), so its bound is 0 and the
    # split merge would take every entry: one warp per user reads them in place
    assert merge == (6176, 512, 32, False, 8 * 8 * (512 + 32), 0)
    with_keys = fused_topk.merge_plan(6144, 6176, 480, plan,
                                      H100_SMEM + fused_topk.MERGE_STATIC_SMEM, H100_SMS)
    assert with_keys.keys_in_smem and with_keys.smem == H100_SMEM
    for k in range(440, 520):  # every plan near the limit leaves the static bytes free
        m = fused_topk.merge_plan(6144, 6176, k, plan, H100_SMEM, H100_SMS)
        assert m.smem + fused_topk.MERGE_STATIC_SMEM <= H100_SMEM


def test_launch_plan_rejects_a_width_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        fused_topk.launch_plan(6144, 3630, 2048, H100_SMEM, H100_SMS)
