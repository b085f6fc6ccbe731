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


@pytest.mark.gpu
@pytest.mark.parametrize("B,I,d,k", [
    (6144, 3630, 64, 173),  # the serving shape at ml-1M scale
    (300, 5000, 32, 4096),  # the largest k'
    (77, 1001, 30, 50),     # d not a multiple of 4: scalar copies and reads
    (5, 9, 8, 12),          # k' beyond the catalogue: (-inf, 0) slots
])
def test_fused_topk_matches_plain(card, B, I, d, k):
    """Integer inputs make every score exact, so the kernel must agree with
    the plain version slot for slot, ties included."""
    gen = torch.Generator().manual_seed(0)
    U = torch.randint(-2, 3, (B, d), generator=gen).float().to(card)
    T = torch.randint(-2, 3, (I, d), generator=gen).float().to(card)
    before = fused_topk.launches
    s, i = fused_topk.fused_topk_scores(U, T, k)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    s_ref, i_ref = fused_topk.fused_topk_scores_reference(U, T, k)
    assert torch.equal(i, i_ref)
    assert torch.equal(s, s_ref)


@pytest.mark.gpu
def test_fused_topk_rejects_non_float32_on_card(card):
    U = torch.zeros(4, 8, device=card, dtype=torch.float64)
    T = torch.zeros(10, 8, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):
        fused_topk.fused_topk_scores(U, T, 3)
