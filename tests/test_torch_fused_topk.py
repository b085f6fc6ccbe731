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


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("d,k", [(64, 11), (64, 256), (64, 4096), (128, 700), (30, 173)])
def test_launch_plan_fits_shared_memory(d, k, vec):
    limit = 232448  # H100: 227 KB of opt-in shared memory per block
    K, upb, smem = fused_topk.launch_plan(d, k, limit, vec)
    assert K >= k and K & (K - 1) == 0 and smem <= limit
    assert smem == fused_topk.smem_bytes(d, K, upb, vec)
    if k <= 256:
        # three blocks (1 KB reserved each) share an SM's 228 KB
        assert upb == 8 and 3 * (smem + 1024) <= 228 * 1024
