"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where no CUDA device is
present. The file imports neither JAX nor the JAX package, so on a machine
with a card and without JAX it runs with the repository's conftest left out:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from recbole_fairrec_tpu_torch.ops import fused_topk


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check_slot_for_slot(U, T, k):
    before = fused_topk.launches
    s, i = fused_topk.fused_topk_scores(U, T, k)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    s_ref, i_ref = fused_topk.fused_topk_scores_reference(U, T, k)
    assert torch.equal(i, i_ref)
    assert torch.equal(s, s_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B,I,d,k", [
    (6144, 3630, 64, 173),   # the serving shape at ml-1M scale
    (300, 5000, 32, 4096),   # the largest k'
    (77, 1001, 30, 50),      # d not a multiple of 4: scalar copies and reads
    (5, 9, 8, 12),           # k' beyond the catalogue: (-inf, 0) slots
    (6144, 3630, 64, 1),     # k' = 1: products with almost no selection
    (1024, 3630, 64, 2048),  # real ml-1M's k': every chunk's list is the whole chunk
    (1000, 3630, 64, 173),   # B not a multiple of the 64 users of a block
    (2000, 3001, 64, 300),   # I not a multiple of the chunk: a short last chunk
    (64, 50000, 8, 4096),    # lists too long for shared memory: the merge reads them in place
    (6144, 6176, 64, 480),   # the keys would fill the opt-in limit but for the static bytes
])
def test_fused_topk_matches_plain(card, B, I, d, k):
    """Integer inputs make every score exact, so the kernel must agree with
    the plain version slot for slot, ties included."""
    gen = torch.Generator().manual_seed(0)
    U = torch.randint(-2, 3, (B, d), generator=gen).float().to(card)
    T = torch.randint(-2, 3, (I, d), generator=gen).float().to(card)
    _check_slot_for_slot(U, T, k)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [7, 173])
def test_fused_topk_zero_scores_tie_by_index(card, k):
    """Many scores are exactly 0, from zero user rows and from products that
    cancel (+0.0 and -0.0 alike): the order key must treat them as one value
    and rank them by item index."""
    gen = torch.Generator().manual_seed(1)
    B, I, d = 700, 3630, 64
    U = torch.randint(-1, 2, (B, d), generator=gen).float()
    U[::3] = 0.0   # every score of these rows is 0
    U[1::3] = -U[1::3].abs()
    T = torch.randint(-1, 2, (I, d), generator=gen).float()
    T[::2, d // 2:] = -T[::2, : d // 2]  # u . t cancels for users constant over the halves
    U[2::3, d // 2:] = U[2::3, : d // 2]
    U, T = U.to(card), T.to(card)
    scores = U @ T.T
    assert int((scores == 0).sum()) > B * I // 3  # the case is tie-heavy at 0
    _check_slot_for_slot(U, T, k)


@pytest.mark.gpu
def test_fused_topk_rejects_non_float32_on_card(card):
    U = torch.zeros(4, 8, device=card, dtype=torch.float64)
    T = torch.zeros(10, 8, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):
        fused_topk.fused_topk_scores(U, T, 3)
