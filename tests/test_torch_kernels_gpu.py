"""The port's CUDA kernels against their plain versions, and the training
step's device code (negative sampling, one optimizer step) against the CPU,
on the card.

Every test here is marked ``gpu`` and skips where no CUDA device is
present. The file imports neither JAX nor the JAX package, so on a machine
with a card and without JAX it runs with the repository's conftest left out:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.models.pfcn_pmf import PFCN_PMF
from recbole_fairrec_tpu_torch.ops import fused_topk, neg_sampling
from recbole_fairrec_tpu_torch.trainer import PFCN_PMFTrainer


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
@pytest.mark.parametrize("case", list(chip_smoke.F32_PARITY_CASES))
def test_fused_topk_f32_equals_the_parent_build(card, case):
    """float32 outputs are bit for bit those of the kernel before the
    tensor-core path and the split merge (commit 98b4f0a, whose digests
    ``chip_smoke.py --parent`` recomputes beside this tree's): eight shapes
    (serving, k' 1 / 2048 / 4096, d 30 / 65, I 65,536, shard mode) and one
    whose lists take the split merge (I 1,048,576)."""
    got = chip_smoke.f32_digests(fused_topk.fused_topk_scores, {
        case: chip_smoke.F32_PARITY_CASES[case]})
    assert got[case] == chip_smoke.F32_PARENT_DIGESTS[case]


@pytest.mark.gpu
def test_fused_topk_rejects_non_float32_on_card(card):
    U = torch.zeros(4, 8, device=card, dtype=torch.float64)
    T = torch.zeros(10, 8, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):
        fused_topk.fused_topk_scores(U, T, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("u_dtype,t_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float16, torch.float16),
                                             (torch.float32, torch.float16),
                                             (torch.float16, torch.float32),
                                             (torch.bfloat16, torch.float16),
                                             (torch.float16, torch.bfloat16)],
                         ids=["bf16", "f32-users-bf16-table", "bf16-users-f32-table", "f16",
                              "f32-users-f16-table", "f16-users-f32-table",
                              "bf16-users-f16-table", "f16-users-bf16-table"])
@pytest.mark.parametrize("B,I,d,k", [
    (6144, 3630, 64, 173),   # the serving shape
    (64, 4097, 128, 10),     # d 128, a PAD row past a power of two
    (77, 1001, 30, 50),      # d not a multiple of 8: plain loads of the half table
    (2000, 3001, 65, 300),   # d 65 and a short last chunk
    (300, 5000, 32, 4096),   # the largest k'
    (64, 50000, 8, 4096),    # lists too long for shared memory, whole chunks: in place
    (6144, 3630, 64, 1),     # k' = 1: the arg-max lists
    (1024, 3630, 64, 2048),  # every chunk's list is the whole chunk
    (128, 1048576, 32, 10),  # lists past shared memory: the split merge
    (128, 1048576, 16, 1),   # the split merge over arg-max lists
])
def test_fused_topk_bf16_matches_plain(card, B, I, d, k, u_dtype, t_dtype):
    """Half-precision tables (and users) of small integers, bfloat16 and
    float16 in every pairing with each other and with float32: every
    product and sum is exact in float32, on the tensor cores (users and
    table of one half type) as on the CUDA cores, so the kernel agrees with
    the plain version (which widens the values) slot for slot, ties
    included."""
    gen = torch.Generator().manual_seed(2)
    U = torch.randint(-2, 3, (B, d), generator=gen).to(u_dtype).to(card)
    T = torch.randint(-2, 3, (I, d), generator=gen).to(t_dtype).to(card)
    _check_slot_for_slot(U, T, k)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [7, 173])
def test_fused_topk_bf16_tie_heavy(card, k):
    """A bf16 table of values in {-1, 0, 1} with half its rows zero: most
    scores tie, and equal scores must come out by item index."""
    gen = torch.Generator().manual_seed(3)
    U = torch.randint(-1, 2, (700, 64), generator=gen).to(torch.bfloat16)
    T = torch.randint(-1, 2, (3630, 64), generator=gen).to(torch.bfloat16)
    T[1::2] = 0
    U, T = U.to(card), T.to(card)
    assert int(((U.float() @ T.float().T) == 0).sum()) > 700 * 3630 // 2
    _check_slot_for_slot(U, T, k)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [7, 173])
@pytest.mark.parametrize("I", [3630, 1048576])
def test_fused_topk_f16_tie_heavy(card, I, k):
    """A float16 table of values in {-1, 0, 1} with half its rows zero,
    users in {-1, 0, 1}: most scores tie, and equal scores must come out by
    item index, through the tensor cores and either merge (I 1,048,576: the
    split merge)."""
    gen = torch.Generator().manual_seed(5)
    U = torch.randint(-1, 2, (700 if I < 10**5 else 128, 64), generator=gen).to(torch.float16)
    T = torch.randint(-1, 2, (I, 64), generator=gen).to(torch.float16)
    T[1::2] = 0
    U, T = U.to(card), T.to(card)
    _check_slot_for_slot(U, T, k)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fused_topk_constant_scores_at_catalog_scale(card, dtype, k):
    """Every score equal over 1,048,576 items: each chunk's list holds its
    first k' items and every bound is that one key, so the split merge
    gets more candidates than it sorts (2,048 chunks x k') except at k' 1,
    and ranks them by the search over the lists in place: the items 1..k'
    in order (PAD masked), as the plain version gives."""
    U = torch.ones((64, 16), dtype=dtype, device=card)
    T = torch.ones((1048576, 16), dtype=dtype, device=card)
    _check_slot_for_slot(U, T, k)
    s, i = fused_topk.fused_topk_scores(U, T, k)
    assert torch.equal(i[0].cpu(), torch.arange(1, k + 1, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("B,I,d,dtype", [(1024, 65536, 64, torch.float32),
                                         (128, 262144, 128, torch.bfloat16),
                                         (128, 262144, 128, torch.float16),
                                         (1024, 3630, 64, torch.float16),
                                         (1024, 524288, 64, torch.float16),
                                         (128, 1048576, 64, torch.bfloat16)],
                         ids=["pallas-bench-f32", "bf16-table", "f16-table", "f16-serving",
                              "f16-range", "bf16-range-split"])
def test_fused_topk_gaussian_within_the_near_tie_rule(card, B, I, d, dtype):
    """Gaussian inputs at bench_pallas_topk's float32 shape (B 1024, I
    65,536, d 64, k' 10), over bfloat16 and float16 tables of 262,144 x 128
    (the tensor cores and the split merge), at the serving shape in float16,
    and in range mode (a score block over several chunks: B 1024 over
    524,288 items, B 128 over 1,048,576 with the split merge): the kernel against the plain version under chip_smoke's
    near-tie rule (the tensor cores sum the d exact products in another
    order and rounding than the plain version's float32 matmul), and a call
    allocates its outputs and scratch but no float32 copy of the table
    (``chip_smoke._no_table_copy``)."""
    gen = torch.Generator(device=card).manual_seed(4)
    U = torch.randn((B, d), generator=gen, device=card, dtype=dtype)
    T = torch.randn((I, d), generator=gen, device=card, dtype=dtype)
    before = fused_topk.launches
    s, i = fused_topk.fused_topk_scores(U, T, 10)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    s_p, i_p, s_next = chip_smoke.plain_topk_with_next(fused_topk, U, T, 10)
    chip_smoke._compare_topk("gpu test", U, T, 10, s, i, s_p, i_p, s_next=s_next)
    rise, scratch = chip_smoke._no_table_copy(fused_topk, U, T, 10, "gpu test")
    assert rise - scratch < 4 * T.numel()


_WG_TABLES = {}


def _wg_table(card, dtype, I, d=128):
    """A table of small integers made on the card, kept across the Hopper
    range kernel's tests (a 2M-row table takes a while on the host)."""
    key = (dtype, I, d)
    if key not in _WG_TABLES:
        _WG_TABLES.clear()
        gen = torch.Generator(device=card).manual_seed(I + d)
        _WG_TABLES[key] = torch.randint(-2, 3, (I, d), generator=gen, device=card).to(dtype)
    return _WG_TABLES[key]


def _wg_check(U, T, k, **kw):
    """The call takes the Hopper range kernel and equals the plain version
    slot for slot."""
    path = fused_topk.launch_args(U.device, U.shape[0], T.shape[0], U.shape[1], k, U.dtype,
                                  T.dtype, U.data_ptr() % 16 == 0 and T.data_ptr() % 16 == 0)[3]
    assert path == "wgmma"
    before = fused_topk.launches
    s, i = fused_topk.fused_topk_scores(U, T, k, **kw)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    s_ref, i_ref = fused_topk.fused_topk_scores_reference(U, T, k, **kw)
    assert torch.equal(i, i_ref)
    assert torch.equal(s, s_ref)
    return s, i


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("I", [65537, 2097153])
@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("B", [1, 64, 127, 128, 129, 1000, 1024])
def test_fused_topk_wgmma_matches_plain(card, B, I, k, dtype):
    """The Hopper range kernel (TMA + wgmma, selection in registers) on
    small-integer tables at d 128: every score is exact, so it equals the
    plain version slot for slot, ties by item index included, for B across
    a warp, a warpgroup and a block of users (1 to 1,024), one range of two
    256-item chunks a block (I 65,537 at B 1) up to 257 chunks of 512 (the
    catalog at B 1,024, with a last chunk of one item), and k' 1 to 32."""
    T = _wg_table(card, dtype, I)
    gen = torch.Generator(device=card).manual_seed(B * 100 + k)
    U = torch.randint(-2, 3, (B, 128), generator=gen, device=card).to(dtype)
    _wg_check(U, T, k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("k", [10, 32])
def test_fused_topk_wgmma_ties_across_boundaries(card, dtype, k):
    """The item-ascending tie rule across tiles, warpgroups and ranges: a
    constant table (every score equal: each range keeps its first k' items,
    the merge the catalog's first k', PAD masked) and a tie-heavy one
    (values in {-1, 0, 1}, every other row zero), at the catalog's 2,097,153
    rows for 129 users (two blocks, both warpgroups of the first)."""
    U = torch.ones((129, 128), dtype=dtype, device=card)
    T = torch.ones((2097153, 128), dtype=dtype, device=card)
    s, i = _wg_check(U, T, k)
    assert torch.equal(i.cpu(), torch.arange(1, k + 1, dtype=torch.int32).expand(129, k))
    del T
    gen = torch.Generator(device=card).manual_seed(6)
    U = torch.randint(-1, 2, (129, 128), generator=gen, device=card).to(dtype)
    T = torch.randint(-1, 2, (2097153, 128), generator=gen, device=card).to(dtype)
    T[1::2] = 0
    _wg_check(U, T, k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("B,I,d,k,col0", [
    (129, 1048576, 64, 10, 5000),       # a shard of 1M rows, one 64-element panel
    (1024, 2097152, 128, 32, 2097152),  # the second half of a 4M-row catalog
])
def test_fused_topk_wgmma_shard_mode(card, dtype, B, I, d, k, col0):
    """The shard mode through the Hopper range kernel: indices offset by
    ``col_offset``, row 0 selectable. Users of values in {0, 1, 2} against a
    row 0 of 2s: row 0 scores highest (or ties first) for every user."""
    gen = torch.Generator(device=card).manual_seed(7)
    U = torch.randint(0, 3, (B, d), generator=gen, device=card).to(dtype)
    T = torch.randint(-2, 3, (I, d), generator=gen, device=card).to(dtype)
    T[0] = 2
    s, i = _wg_check(U, T, k, col_offset=col0, mask_pad=False)
    assert bool((i[:, 0] == col0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,offset", [
    (torch.float16, 30, 0),     # rows of 60 bytes: not whole 16-byte units
    (torch.bfloat16, 136, 0),   # past the Hopper layout's two panels
    (torch.bfloat16, 128, 1),   # users one element off 16 bytes
], ids=["f16-d30", "bf16-d136", "bf16-unaligned"])
def test_fused_topk_range_mode_left_to_mma(card, dtype, d, offset):
    """The calls where range mode applies but TMA cannot read the tensors
    take the tensor-core kernel (``mma.sync``, one chunk a block, a list per
    chunk) and equal the plain version slot for slot on small-integer
    inputs."""
    B, I, k = 1024, 524288, 10
    gen = torch.Generator(device=card).manual_seed(d + offset)
    U = torch.randint(-2, 3, (B * d + offset,), generator=gen, device=card).to(dtype)
    U = U[offset:].view(B, d)
    T = torch.randint(-2, 3, (I, d), generator=gen, device=card).to(dtype)
    _, shape, _, path = fused_topk.launch_args(
        card, B, I, d, k, dtype, dtype, U.data_ptr() % 16 == 0 and T.data_ptr() % 16 == 0)
    assert path == "mma" and shape[6] == 1  # the tensor-core kernel: a chunk a block
    _check_slot_for_slot(U, T, k)


@pytest.mark.gpu
def test_fused_topk_wgmma_kernels_by_name(card):
    """One catalog call (bf16, B 1,024, k' 10) launches two device kernels,
    the score kernel (its name holds ``score_select``) and the merge: the
    fragments that ``fused_topk_roofline`` and ``chip_smoke.kernel_times_us``
    read. Under tracing, the call's ``fused_topk.launch`` span carries the
    path and the counter ``fused_topk.wgmma`` counts it."""
    from recbole_fairrec_tpu_torch.utils import tracing

    gen = torch.Generator(device=card).manual_seed(8)
    T = torch.randn((2097152, 128), generator=gen, device=card, dtype=torch.bfloat16)
    U = torch.randn((1024, 128), generator=gen, device=card, dtype=torch.bfloat16)
    times = chip_smoke._device_profile(lambda: fused_topk.fused_topk_scores(U, T, 10), calls=2)
    assert len(times) == 2
    assert all("score_select" in name or "merge" in name for name in times), times
    assert any("score_select_wgmma" in name for name in times), times
    tracing.reset()
    tracing.enable()
    try:
        fused_topk.fused_topk_scores(U, T, 10)
        fused_topk.fused_topk_scores(U.float(), T, 10)
    finally:
        tracing.disable()
    paths = [r.attrs["path"] for r in tracing.records() if r.name == "fused_topk.launch"]
    assert paths == ["wgmma", "fma"]
    assert tracing.counters()["fused_topk.wgmma"] == 1
    tracing.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_fused_topk_refuses_other_dtypes_by_name_on_card(card, dtype):
    """float64 users raise a TypeError naming the dtype; float16 users (over
    a bfloat16 table) go through the kernel, counted, slot for slot with the
    plain version."""
    U = torch.zeros(4, 8, device=card, dtype=dtype)
    T = torch.zeros(10, 8, device=card, dtype=torch.bfloat16)
    if dtype == torch.float16:
        U[:, ::2] = 1
        T[::3] = 1
        _check_slot_for_slot(U, T, 3)
        return
    with pytest.raises(TypeError, match=str(dtype).replace("torch.", "")):
        fused_topk.fused_topk_scores(U, T, 3)


# ------------------------------------------------- negative sampling, on card

N_USERS, N_ITEMS = 500, 3630


def _used_pairs(seed=3, n=60_000):
    r = np.random.RandomState(seed)
    keys = np.unique(r.randint(1, N_USERS, n).astype(np.int64) * N_ITEMS
                     + r.randint(1, N_ITEMS, n))
    return keys // N_ITEMS, keys % N_ITEMS, keys


def _used_table(kind, u, i, device):
    if kind == "bitmap":
        return neg_sampling.build_used_bitmap(u, i, N_USERS, N_ITEMS, device=device)
    return neg_sampling.build_used_keys(u, i, N_ITEMS, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bitmap", "keys"])
@pytest.mark.parametrize("num_neg", [1, 3])
def test_sample_negatives_on_card(card, kind, num_neg):
    u, i, keys = _used_pairs()
    used = _used_table(kind, u, i, card)
    users = torch.from_numpy(np.random.RandomState(5).randint(1, N_USERS, 2048)).to(card)
    gen = torch.Generator(device=card).manual_seed(7)
    out = neg_sampling.sample_negatives(gen, users, used, N_ITEMS, num_neg=num_neg)
    assert out.device.type == "cuda" and out.shape == (2048 * num_neg,)
    assert int(out.min()) >= 1 and int(out.max()) < N_ITEMS
    drawn = users.repeat(num_neg).cpu().numpy() * N_ITEMS + out.cpu().numpy()
    assert not np.isin(drawn, keys).any()
    again = neg_sampling.sample_negatives(
        torch.Generator(device=card).manual_seed(7), users, used, N_ITEMS, num_neg=num_neg)
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_sample_negatives_refuses_a_cpu_generator_on_card(card):
    u, i, _ = _used_pairs()
    used = _used_table("bitmap", u, i, card)
    users = torch.ones(16, dtype=torch.int64, device=card)
    with pytest.raises(RuntimeError):
        neg_sampling.sample_negatives(torch.Generator().manual_seed(0), users, used, N_ITEMS)


# ------------------------------------------------------ one train step, on card


class _Sizes:
    """The two numbers a PFCN_PMF reads from its dataset."""

    def num(self, field):
        return {"user_id": N_USERS, "item_id": N_ITEMS}[field]


def _trainer(tmp_path, use_gpu, learner, state):
    config = Config(model="PFCN_PMF", dataset="none", config_dict={
        "use_gpu": use_gpu, "filter_mode": "none", "sst_attr_list": [], "embedding_size": 64,
        "learner": learner, "weight_decay": 0.01, "clip_grad_norm": {"max_norm": 0.5},
        "learning_rate": 0.01, "metrics": ["NDCG"], "topk": [10], "valid_metric": "NDCG@10",
        "checkpoint_dir": str(tmp_path / "saved"), "state": "ERROR",
    })
    model = PFCN_PMF(config, _Sizes())
    model.load_state_dict(state)
    return PFCN_PMFTrainer(config, model)


@pytest.mark.gpu
@pytest.mark.parametrize("learner", ["adam", "sgd", "adagrad", "rmsprop", "sparse_adam"])
def test_train_steps_on_card_match_cpu(card, tmp_path, learner, monkeypatch):
    """Two steps from the same weights, batches and negatives: parameters
    within 1e-5 (abs) and losses within 1e-6 (rel) of the CPU's."""
    monkeypatch.chdir(tmp_path)  # the scalar log lands beside the test's files
    gen = torch.Generator().manual_seed(0)
    state = {"user_embedding.weight": torch.randn(N_USERS, 64, generator=gen) * 0.3,
             "item_embedding.weight": torch.randn(N_ITEMS, 64, generator=gen) * 0.3}
    on_card = _trainer(tmp_path, True, learner, state)
    on_cpu = _trainer(tmp_path, False, learner, state)
    assert on_card.device.type == "cuda" and on_cpu.device.type == "cpu"
    for _ in range(2):
        batch = {
            "user_id": torch.randint(1, N_USERS, (2048,), generator=gen),
            "item_id": torch.randint(1, N_ITEMS, (2048,), generator=gen),
            "neg_item_id": torch.randint(1, N_ITEMS, (2048,), generator=gen),
        }
        losses = []
        for trainer in (on_card, on_cpu):
            trainer.model.train()
            moved = {k: v.to(trainer.device) for k, v in batch.items()}
            losses.append(float(trainer._train_step(moved, "calculate_loss", None,
                                                    trainer.optimizer)))
        assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for p, q in zip(on_card.model.parameters(), on_cpu.model.parameters()):
        assert float((p.detach().cpu() - q.detach()).abs().max()) <= 1e-5


# ------------------------------------------- the adversarial PFCN path, on card


class _AttrSizes(_Sizes):
    """Sizes plus a user table with a binary ``gender`` and a seven-valued
    ``age`` (row 0 is PAD)."""

    def get_user_feature(self):
        users = np.arange(N_USERS)
        return {"gender": users % 2, "age": users % 7}


def _adv_config(tmp_path, use_gpu, model, mode, attrs):
    return Config(model=model, dataset="none", config_dict={
        "use_gpu": use_gpu, "filter_mode": mode, "sst_attr_list": attrs, "embedding_size": 64,
        "dis_hidden_size_list": [128, 256, 128, 128, 64, 32], "dis_dropout": 0.0,
        "mlp_dropout": 0.0, "learner": "adam", "learning_rate": 0.001, "weight_decay": 1e-4,
        "metrics": ["NDCG"], "topk": [10], "valid_metric": "NDCG@10",
        "checkpoint_dir": str(tmp_path / "saved"), "state": "ERROR",
    })


def _pre_bn_bias(name):
    parts = name.split(".")
    return parts[0] in ("filters", "discriminators") and parts[-3:-2] == ["linear"] \
        and parts[-1] == "b"


@pytest.mark.gpu
@pytest.mark.parametrize("loss_name,tag", [("calculate_loss", "filter"),
                                           ("calculate_dis_loss", "dis")])
def test_adversarial_steps_on_card_match_cpu(card, tmp_path, loss_name, tag, monkeypatch):
    """PFCN_PMF, sm over gender and age, full widths: one filter step and
    one dis step from the same weights and batch. Losses within 1e-6 (rel);
    parameters and BatchNorm running statistics within 1e-5 (abs). A bias
    that feeds a BatchNorm has a zero gradient, whose float32 noise Adam
    turns into a step of up to (1 - b1) / sqrt(1 - b2) = 3.16 lr of either
    sign: within twice that + 1e-5."""
    monkeypatch.chdir(tmp_path)
    from recbole_fairrec_tpu_torch.models.pfcn_pmf import PFCN_PMF
    from recbole_fairrec_tpu_torch.trainer import PFCN_PMFTrainer as Cls

    attrs = ["gender", "age"]
    state = PFCN_PMF(_adv_config(tmp_path, False, "PFCN_PMF", "sm", attrs), _AttrSizes(),
                     generator=torch.Generator().manual_seed(0)).state_dict()
    trainers = []
    for use_gpu in (True, False):
        config = _adv_config(tmp_path, use_gpu, "PFCN_PMF", "sm", attrs)
        model = PFCN_PMF(config, _AttrSizes())
        model.load_state_dict(state)
        trainers.append(Cls(config, model))
    gen = torch.Generator().manual_seed(1)
    users = torch.randint(1, N_USERS, (2048,), generator=gen)
    batch = {"user_id": users, "item_id": torch.randint(1, N_ITEMS, (2048,), generator=gen),
             "neg_item_id": torch.randint(1, N_ITEMS, (2048,), generator=gen),
             "gender": users % 2, "age": users % 7}
    losses = []
    for trainer in trainers:
        trainer.model.train()
        moved = {k: v.to(trainer.device) for k, v in batch.items()}
        losses.append(float(trainer._train_step(moved, loss_name, tuple(attrs),
                                                trainer._tx_by_tag(tag))))
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    cpu_state = trainers[1].model.state_dict()
    for name, value in trainers[0].model.state_dict().items():
        limit = 2 * 3.1623 * 0.001 + 1e-5 if _pre_bn_bias(name) else 1e-5
        assert float((value.cpu() - cpu_state[name]).abs().max()) <= limit, name


def _near_tie_equal(U, T, k, topk=fused_topk.fused_topk_scores):
    """The kernel (called through ``topk``) against its plain version on
    float inputs: scores within rtol 1e-5 plus twice the float32 bound of a
    length-d dot product in any order; indices equal except where the plain
    version's neighbours lie within that bound of each other."""
    before = fused_topk.launches
    s, i = topk(U, T, k)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    s_ref, i_ref = fused_topk.fused_topk_scores_reference(U, T, k)
    tol = 2 * U.shape[1] * 2.0 ** -24 * torch.gather(U.abs() @ T.abs().T, 1, i_ref.long())
    assert bool(((s - s_ref).abs() <= 1e-5 * s_ref.abs() + tol).all())
    gap = (s_ref[:, 1:] - s_ref[:, :-1]).abs() <= torch.maximum(1e-6 * s_ref[:, 1:].abs(),
                                                                tol[:, 1:])
    near = torch.zeros_like(gap[:, :1]).expand(-1, k).clone()
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert not bool(((i != i_ref) & ~near).any())


@pytest.mark.gpu
@pytest.mark.parametrize("model_name,mode,attrs,width", [
    ("PFCN_PMF", "sm", ["gender", "age"], 64),   # filtered user representations
    ("PFCN_BiasedMF", "cm", ["gender"], 65),     # user ++ [1] . item ++ [b_i]: d 65
    ("PFCN_DMF", "sm", ["gender"], 64),          # unit vectors
])
def test_fused_topk_on_filtered_retrieval_inputs(card, tmp_path, model_name, mode, attrs, width,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    from recbole_fairrec_tpu_torch.utils import get_model

    config = _adv_config(tmp_path, True, model_name, mode, attrs)
    model = get_model(model_name)(config, _AttrSizes()).to(card).eval()
    users = torch.arange(1, N_USERS, device=card)
    with torch.no_grad():
        U, T = model.retrieval_embeddings({"user_id": users}, tuple(attrs))
    U, T = U.contiguous(), T.contiguous()
    assert U.shape == (N_USERS - 1, width) and T.shape == (N_ITEMS, width)
    if model_name == "PFCN_DMF":
        torch.testing.assert_close(U.norm(dim=1), torch.ones(N_USERS - 1, device=card))
    _near_tie_equal(U, T, 173)


# ---------------------------------- the published evaluation protocol, on card


def _write_fair_dataset(root, n_users=120, n_items=300, seed=4):
    """Every user rates 10-30 random items with ratings 1-5; ``gender`` =
    u mod 2, ``age`` = u mod 3."""
    ddir = root / "fair"
    ddir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(ddir / "fair.inter", "w") as f:
        f.write("user_id:token\titem_id:token\trating:float\n")
        for u in range(1, n_users + 1):
            for i in rng.choice(np.arange(1, n_items + 1), rng.randint(10, 31), replace=False):
                f.write(f"{u}\t{i}\t{rng.randint(1, 6)}\n")
    with open(ddir / "fair.user", "w") as f:
        f.write("user_id:token\tgender:float\tage:float\n")
        for u in range(1, n_users + 1):
            f.write(f"{u}\t{u % 2}\t{u % 3}\n")
    return str(root)


def _published(tmp_path, use_gpu, model, extra=None):
    return Config(model=model, dataset="fair", config_dict={
        "use_gpu": use_gpu, "data_path": _write_fair_dataset(tmp_path / "data"),
        "load_col": {"inter": ["user_id", "item_id", "rating"],
                     "user": ["user_id", "gender", "age"]},
        "LABEL_FIELD": "label", "threshold": {"rating": 3.0},
        "checkpoint_dir": str(tmp_path / "saved"), "state": "ERROR", "dropout": 0.0,
        **(extra or {}),
    })


@pytest.mark.gpu
@pytest.mark.parametrize("mode,attrs", [("none", []), ("sm", ["gender", "age"])])
def test_sampled_device_path_equals_host_path_on_card(card, tmp_path, mode, attrs,
                                                      monkeypatch):
    """PFCN_PMF with its published uni100 protocol (12 metrics, top 5): on
    one list of uni100 batches, the device path (scatter + sort on the card)
    and the host path (``predict`` on the card, ranking in numpy) give one
    dict per subset."""
    monkeypatch.chdir(tmp_path)
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed

    config = _published(tmp_path, True, "PFCN_PMF", {
        "filter_mode": mode, "sst_attr_list": attrs or ["gender"], "dis_dropout": 0.0})
    generator = init_seed(config["seed"], True)
    train, valid, _ = data_preparation(config, create_dataset(config))
    model = get_model("PFCN_PMF")(config, train.dataset, generator=generator)
    with torch.no_grad():  # scores where float32 sigmoid keeps them apart
        for emb in (model.user_embedding, model.item_embedding):
            emb.weight.mul_(0.3)
    trainer = get_trainer(config["MODEL_TYPE"], "PFCN_PMF")(config, model)
    assert trainer.device.type == "cuda"
    trainer.eval_collector.data_collect(train)
    kind = trainer._prepare_eval(valid)
    np.random.seed(9)
    batches = list(trainer._macro_batches(valid, kind))
    trainer.model.eval()
    for sst in [tuple(attrs)] if attrs else [None]:
        results = []
        with torch.no_grad():
            for path in ("device", "host"):
                for batch in batches:
                    if path == "device":
                        trainer._drain_collect([trainer._collect_batch(kind, batch, sst)])
                        assert trainer._last_eval_path == "sampled-fused"
                    else:
                        _, scores, pu, pi = trainer._neg_sample_batch_eval(batch, sst)
                        trainer.eval_collector.eval_batch_collect(scores, batch[0], pu, pi)
                results.append(trainer.evaluator.evaluate(trainer.eval_collector.get_data_struct()))
        assert results[0] == results[1]
        assert len(results[0]) >= 12


@pytest.mark.gpu
@pytest.mark.parametrize("model_name,extra", [
    ("FOCF", {"fair_objective": "value"}),
    ("FOCF", {"fair_objective": "nonparity"}),
    ("NFCF", {}),
])
def test_fair_model_losses_on_card_match_cpu(card, tmp_path, model_name, extra, monkeypatch):
    """FOCF's rating loss + fairness term and NFCF's BCE + ε-DF penalty on
    one train batch, the same weights on the card and on the CPU: losses
    within 1e-6 (rel), gradients within 1e-6 (abs), the float32 error of
    summing in another order."""
    monkeypatch.chdir(tmp_path)
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, init_seed

    losses, grads = [], []
    for use_gpu in (True, False):
        config = _published(tmp_path, use_gpu, model_name, extra)
        init_seed(config["seed"], True)
        train = data_preparation(config, create_dataset(config))[0]
        model = get_model(model_name)(config, train.dataset,
                                      generator=torch.Generator().manual_seed(0))
        model = model.to(config["device"]).train()
        np.random.seed(3)
        batch = next(iter(train))
        fields = model.loss_batch_fields("calculate_loss")
        moved = {k: v.to(config["device"]) for k, v in batch.interaction.items() if k in fields}
        loss = model.calculate_loss(moved)
        if model_name == "NFCF":  # the finetune stage's penalty, on the same rows
            out = model.forward(moved["user_id"], moved["item_id"], train=True)
            loss = loss + model._differential_fairness(moved, out, torch.ones_like(out))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for name, g in grads[1].items():
        assert float((grads[0][name] - g).abs().max()) <= 1e-6, name


# ------------------------------------------------------------ FairGo, on card

FAIRGO_STEPS = [("pretrain", "calculate_loss", "pretrain"),
                ("finetune", "calculate_loss", "filter"),
                ("finetune", "calculate_dis_loss", "dis")]


@pytest.mark.gpu
@pytest.mark.parametrize("model_name", ["FairGo_PMF", "FairGo_GCN"])
def test_fairgo_steps_on_card_match_cpu(card, tmp_path, model_name, monkeypatch):
    """FairGo at its published widths (d 64, filters [128, 64],
    discriminators [16, 8, 4], LBA, GCN hidden 32; ``gcn_dropout`` 0) on the
    small fair dataset: a pretrain step, then a filter and a discriminator
    step over gender and age, each from the same parameters and batch on the
    card and on the CPU. Only the stepped group has gradients. Losses within
    1e-5 (rel); gradients within 1e-4 of the tensor's largest + 1e-7 (abs);
    parameters within 1e-5 (abs), except the elements whose CPU gradient is
    within that gradient tolerance of 0: Adam's first step moves those by up
    to (1 - b1) / sqrt(1 - b2) = 3.16 lr of either sign, within twice that +
    1e-5."""
    monkeypatch.chdir(tmp_path)
    on_card = _check_fairgo_steps(tmp_path, model_name, {})
    assert on_card.model.prop_dense.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("model_name", ["FairGo_PMF", "FairGo_GCN"])
def test_fairgo_csr_steps_on_card_match_cpu(card, tmp_path, model_name, monkeypatch):
    """The same steps with ``dense_propagation: False``: on the card every
    hop (FairGo_GCN's pretrain convolutions and both models' finetune hops)
    goes through the CSR kernel, forward and backward, against the CPU's
    plain CSR product, within the same tolerances."""
    from recbole_fairrec_tpu_torch.ops import spmm_csr

    monkeypatch.chdir(tmp_path)
    before = spmm_csr.launches
    on_card = _check_fairgo_steps(tmp_path, model_name, {"dense_propagation": False})
    assert "prop_dense" not in dict(on_card.model.named_buffers())
    # pretrain: GCN_PMF's 2 convolutions forward and backward; filter: 2 hops forward and
    # backward; discriminator: 2 hops forward (the hops' input takes no gradient there)
    pretrain = 4 if model_name == "FairGo_GCN" else 0
    assert spmm_csr.launches - before == pretrain + 4 + 2


def _check_fairgo_steps(tmp_path, model_name, extra):
    """A pretrain, a filter and a discriminator step on the card and on the
    CPU from the same parameters and batch (see
    ``test_fairgo_steps_on_card_match_cpu``); returns the card's trainer."""
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed

    trainers, loaders = [], []
    for use_gpu in (True, False):
        config = _published(tmp_path, use_gpu, model_name, {
            "sst_attr_list": ["gender", "age"], "gcn_dropout": 0.0, "train_batch_size": 512,
            **extra})
        init_seed(config["seed"], True)
        train = data_preparation(config, create_dataset(config))[0]
        model = get_model(model_name)(config, train.dataset,
                                      generator=torch.Generator().manual_seed(0))
        trainers.append(get_trainer(config["MODEL_TYPE"], model_name)(config, model))
        loaders.append(train)
    on_card, on_cpu = trainers
    assert on_card.device.type == "cuda"
    np.random.seed(3)
    interaction = next(iter(loaders[1]))
    lr = on_cpu.config["learning_rate"]
    groups = on_cpu.model.param_groups()
    for stage, loss_name, tag in FAIRGO_STEPS:
        sst = None if stage == "pretrain" else ("gender", "age")
        on_cpu.model.load_state_dict({k: v.cpu() for k, v in on_card.model.state_dict().items()})
        losses, grads = [], []
        for trainer in trainers:
            trainer.model.train_stage = stage
            trainer.model.train()
            fields = trainer.model.loss_batch_fields(loss_name, sst)
            moved = {k: v.to(trainer.device) for k, v in interaction.interaction.items()
                     if k in fields}
            losses.append(float(trainer._train_step(moved, loss_name, sst,
                                                    trainer._tx_by_tag(tag))))
            grads.append({n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()
                          if p.grad is not None})
        assert losses[0] == pytest.approx(losses[1], rel=1e-5), tag
        assert sorted(grads[0]) == sorted(grads[1])
        assert grads[0] and all(n.split(".")[0] in groups[tag] for n in grads[0]), tag
        cpu_state = on_cpu.model.state_dict()
        for name, value in on_card.model.state_dict().items():
            gap = (value.cpu() - cpu_state[name]).abs()
            if name not in grads[1]:
                assert float(gap.max()) <= 1e-5, (tag, name)
                continue
            g = grads[1][name]
            tol = 1e-4 * float(g.abs().max()) + 1e-7
            assert float((grads[0][name] - g).abs().max()) <= tol, (tag, name)
            unsure = g.abs() <= tol
            assert float(gap.where(~unsure, 0.0).max()) <= 1e-5, (tag, name)
            assert float(gap.where(unsure, 0.0).max()) <= 2 * 3.1623 * lr + 1e-5, (tag, name)
    return on_card


@pytest.mark.gpu
def test_bf16_propagation_on_card(card):
    """One bfloat16 hop on the card (``torch.mm(..., out_dtype=float32)``)
    against the CPU's (bfloat16 values widened to float32): a float32
    result, not rounded to bfloat16, within the float32 bound of each
    element's sum in another order (2 n 2^-24 sum |a x|; the products are
    exact), and the gradient in ``x`` within 2^-7 of its norm (both round it
    to bfloat16; the card also rounds the incoming gradient)."""
    from recbole_fairrec_tpu_torch.ops import spmm

    gen = torch.Generator().manual_seed(0)
    n, d = 3000, 64
    A = torch.rand(n, n, generator=gen)
    A16 = (A / A.sum(dim=1, keepdim=True)).to(torch.bfloat16)
    x = torch.randn(n, d, generator=gen)
    g = torch.randn(n, d, generator=gen)
    outs, grads = [], []
    for device in (card, torch.device("cpu")):
        xt = x.to(device).requires_grad_(True)
        out = spmm.propagate(xt, None, None, None, n, dense=A16.to(device))
        (out * g.to(device)).sum().backward()
        outs.append(out.detach().cpu())
        grads.append(xt.grad.cpu())
    assert outs[0].dtype == torch.float32
    assert not torch.equal(outs[0], outs[0].to(torch.bfloat16).float())
    bound = 2 * n * 2.0 ** -24 * (A16.float().abs() @ x.to(torch.bfloat16).float().abs())
    assert bool(((outs[0] - outs[1]).abs() <= bound).all())
    assert float((grads[0] - grads[1]).norm()) <= 2.0 ** -7 * float(grads[1].norm())


@pytest.mark.gpu
def test_float32_propagation_ignores_a_global_tf32_setting(card):
    """With the process's float32 matmul precision at "high" (TF32), the
    float32 hop and its gradient on the card stay within 8 times the CPU's
    float32 error against float64 (TF32's 10-bit mantissa is ~2^13 times
    that), while a plain ``torch.mm`` at "high" does not: the hop pins its
    own precision, forward and backward."""
    from recbole_fairrec_tpu_torch.ops import spmm

    gen = torch.Generator().manual_seed(0)
    n, d = 3000, 64
    A = torch.rand(n, n, generator=gen)
    A = A / A.sum(dim=1, keepdim=True)
    x = torch.randn(n, d, generator=gen)
    g = torch.randn(n, d, generator=gen)
    ref, ref_grad = A.double() @ x.double(), A.double().t() @ g.double()

    def hop(device):
        xt = x.to(device, copy=True).requires_grad_(True)
        out = spmm.propagate(xt, None, None, None, n, dense=A.to(device))
        (out * g.to(device)).sum().backward()
        return ((out.detach().cpu().double() - ref).abs().max(),
                (xt.grad.cpu().double() - ref_grad).abs().max())

    cpu_err, cpu_grad_err = hop(torch.device("cpu"))
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        card_err, card_grad_err = hop(card)
        plain_err = (torch.mm(A.to(card), x.to(card)).cpu().double() - ref).abs().max()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    assert float(card_err) <= 8 * float(cpu_err)
    assert float(card_grad_err) <= 8 * float(cpu_grad_err)
    assert float(plain_err) > 8 * float(cpu_err)


@pytest.mark.gpu
def test_use_pallas_false_is_refused_on_card(card, tmp_path, monkeypatch):
    """Streaming evaluation on the card runs the fused top-k kernel and has
    no plain path: ``use_pallas: False`` is refused by name there (the CPU
    takes ``ops/topk.py``; tests/test_torch_serving.py)."""
    monkeypatch.chdir(tmp_path)
    gen = torch.Generator().manual_seed(0)
    state = {"user_embedding.weight": torch.randn(N_USERS, 64, generator=gen),
             "item_embedding.weight": torch.randn(N_ITEMS, 64, generator=gen)}
    trainer = _trainer(tmp_path, True, "adam", state)
    trainer.config["use_pallas"] = False
    with pytest.raises(NotImplementedError, match="use_pallas: False on the card"):
        trainer._collect_full_sort_streaming(None)


# ------------------------- resident epochs, deferred emits, certified top-k


def _pfcn_on_card(tmp_path, mode, extra=None):
    """A PFCN_PMF trainer on the card with its published YAML, its loaders,
    and a copy of its model's initial state."""
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed

    config = _published(tmp_path, True, "PFCN_PMF", {
        "filter_mode": mode, "sst_attr_list": ["gender", "age"] if mode != "none" else ["gender"],
        "dis_dropout": 0.0, **(extra or {})})
    generator = init_seed(config["seed"], True)
    loaders = data_preparation(config, create_dataset(config))
    model = get_model("PFCN_PMF")(config, loaders[0].dataset, generator=generator)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = get_trainer(config["MODEL_TYPE"], "PFCN_PMF")(config, model)
    assert trainer.device.type == "cuda"
    return trainer, loaders, state


@pytest.mark.gpu
@pytest.mark.parametrize("mode,loss_name,tag", [
    ("none", "calculate_loss", "main"),
    ("sm", "calculate_loss", "filter"),
    ("sm", "calculate_dis_loss", "dis"),
])
def test_resident_epoch_equals_per_step_path_on_card(card, tmp_path, mode, loss_name, tag,
                                                     monkeypatch):
    """One resident pass on the card (its pad rows weighted 0) and the
    per-step path on the real rows of the same batches, from the same state
    with the same injected permutation and negatives: pass losses within
    1e-6 (rel), parameters and BatchNorm statistics within 2e-5 (abs; the
    CPU's gap in this case is 7.1e-6, in the filter pass, whose gradient
    carries dis_weight 10 through BatchNorms of small variance). Adam for
    BPR-MF; SGD for the filter and discriminator passes, as a pre-BatchNorm
    bias has an analytic gradient of 0 whose float32 noise Adam would scale
    to lr."""
    monkeypatch.chdir(tmp_path)
    extra = {"device_neg_sampling": True, "device_epoch_shuffle": True,
             "train_batch_size": 256, "learner": "adam" if mode == "none" else "sgd"}
    resident, loaders, state = _pfcn_on_card(tmp_path, mode, extra)
    per_step = type(resident)(resident.config, type(resident.model)(
        resident.config, loaders[0].dataset))
    per_step.model.load_state_dict(state)
    per_step.model.to(card)
    loader = loaders[0]
    assert loader.device_neg_sampling
    sst = None if mode == "none" else ("gender", "age")
    rng = np.random.RandomState(2)
    n_pad = -(-len(loader.dataset) // loader.batch_size) * loader.batch_size
    perm = rng.permutation(n_pad)
    negs = rng.randint(1, loader.dataset.item_num, n_pad)
    ours = resident._run_epoch_resident(loader, loss_name, sst, tag, perm=perm, negatives=negs)
    fields = set(per_step.model.loss_batch_fields(loss_name, sst)) - {"neg_item_id",
                                                                     "__weight__"}
    ref = per_step._run_epoch(chip_smoke._real_row_batches(loader, fields, perm, negs),
                              loss_name, sst, tag)
    assert ours == pytest.approx(ref, rel=1e-6)
    theirs = per_step.model.state_dict()
    for name, value in resident.model.state_dict().items():
        assert float((value - theirs[name]).abs().max()) <= 2e-5, name


@pytest.mark.gpu
@pytest.mark.parametrize("mode,eval_mode", [("none", "full"), ("sm", "uni100")])
def test_deferred_emits_equal_immediate_on_card(card, tmp_path, mode, eval_mode, monkeypatch):
    """``evaluate`` with the device paths' emits deferred to after the loop
    (the default) and with each emit run inside its own call: identical
    dicts, over several macro batches (dense full-sort and uni100). With
    deferral no collect call synchronises with the card (CUDA's sync debug
    mode raises on one)."""
    monkeypatch.chdir(tmp_path)
    trainer, loaders, _ = _pfcn_on_card(tmp_path, mode, {
        "eval_args": {"split": {"RS": [8, 1, 1]}, "group_by": "user", "order": "RO",
                      "mode": eval_mode},
        "eval_batch_size": 40 * 301, "eval_macro_scores": 40 * 301,
        "eval_macro_rows_sampled": 4000})
    trainer.eval_collector.data_collect(loaders[0])
    collect = trainer._collect_batch
    counts = {"deferred": 0}

    def immediate(*args, **kwargs):
        emit = collect(*args, **kwargs)
        assert emit is not None
        emit()

    def deferred(*args, **kwargs):
        counts["deferred"] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return collect(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    results = []
    for wrap in (immediate, deferred):
        trainer._collect_batch = wrap
        np.random.seed(3)
        results.append(trainer.evaluate(loaders[1], load_best_model=False))
    assert trainer._last_eval_path == ("fused" if eval_mode == "full" else "sampled-fused")
    assert counts["deferred"] > 1
    assert results[0] == results[1]


@pytest.mark.gpu
def test_certified_topk_goes_through_the_kernel(card):
    from recbole_fairrec_tpu_torch.ops.topk import approx_topk_scores, certified_topk_scores

    gen = torch.Generator().manual_seed(5)
    U = torch.randn(1000, 64, generator=gen).to(card)
    T = torch.randn(3630, 64, generator=gen).to(card)
    _near_tie_equal(U, T, 50, certified_topk_scores)
    before = fused_topk.launches
    _, idx, certified = approx_topk_scores(U, T, 50, verify=True)
    assert fused_topk.launches == before + 1
    assert certified.device.type == "cuda" and bool(certified.all())
    assert idx.dtype == torch.int32 and not bool((idx == 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("B,I,d,k,col0", [
    (6144, 908, 64, 173, 908),  # one of the parallel phase's four serving shards
    (77, 301, 30, 50, 3000),    # scalar copies, an offset past the shard's own rows
    (5, 9, 8, 12, 100),         # k' beyond the shard: (-inf, 0) slots
])
def test_fused_topk_shard_mode_matches_plain(card, B, I, d, k, col0):
    """The shard mode (indices offset by ``col_offset``, the PAD mask off)
    equals its plain version slot for slot on integer inputs."""
    gen = torch.Generator().manual_seed(1)
    U = torch.randint(-2, 3, (B, d), generator=gen).float().to(card)
    T = torch.randint(-2, 3, (I, d), generator=gen).float().to(card)
    T[0] = 2.0  # row 0 scores high: selectable, as the shard mode allows
    before = fused_topk.launches
    s, i = fused_topk.fused_topk_scores(U, T, k, col_offset=col0, mask_pad=False)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    s_ref, i_ref = fused_topk.fused_topk_scores_reference(U, T, k, col_offset=col0,
                                                          mask_pad=False)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)
    assert bool((i == col0).any())


@pytest.mark.gpu
def test_parallel_layer_on_a_world_of_one(card, tmp_path):
    """``init_multihost`` gives a world of one NCCL rank on cuda:0; over its
    mesh the item-sharded top-k (four shards through the kernel's shard
    mode, merged, and the collective form), ``sharded_propagate`` and the
    exchange lookup equal their single-device forms."""
    import torch.distributed as dist

    from recbole_fairrec_tpu_torch.ops.spmm import propagate
    from recbole_fairrec_tpu_torch.ops.topk import streaming_topk_scores
    from recbole_fairrec_tpu_torch.parallel import (
        bucket_allgather_lookup,
        distributed_topk_scores,
        local_candidates,
        make_mesh,
        merge_candidates,
        pad_table_rows,
        shard_propagation_matrix,
        shard_table,
        sharded_propagate,
    )
    from recbole_fairrec_tpu_torch.quick_start import init_multihost

    assert init_multihost({"multihost": True, "num_processes": 1, "process_id": 0,
                           "coordinator_address": f"file://{tmp_path / 'store'}"})
    try:
        assert dist.get_backend() == "nccl" and torch.cuda.current_device() == 0
        mesh = make_mesh((1, 1))
        gen = torch.Generator().manual_seed(2)
        U = torch.randint(-2, 3, (300, 16), generator=gen).float().to(card)
        T = torch.randint(-2, 3, (1001, 16), generator=gen).float().to(card)
        k = 40
        s_p, i_p = streaming_topk_scores(U, T, k, mask_pad=False)
        table, n_valid = pad_table_rows(T, 4)
        rows = table.shape[0] // 4
        before = fused_topk.launches
        parts = [local_candidates(U, table[j * rows:(j + 1) * rows], k, j * rows, n_valid)
                 for j in range(4)]
        s, i = merge_candidates([p[0] for p in parts], [p[1] for p in parts], k, table.shape[0])
        assert fused_topk.launches == before + 4
        assert torch.equal(i, i_p) and torch.equal(s, s_p)
        s, i = distributed_topk_scores(mesh, U, shard_table(mesh, table), k, valid_rows=n_valid)
        assert torch.equal(i, i_p) and torch.equal(s, s_p)

        a = torch.rand((257, 257), generator=gen).to(card)
        x = torch.randn((257, 16), generator=gen).to(card)
        hop = sharded_propagate(mesh, shard_propagation_matrix(mesh, a), x)
        assert torch.equal(hop, propagate(x, None, None, None, 257, dense=a))
        ids = torch.randint(0, 1001, (333,), generator=gen).to(card)
        assert torch.equal(bucket_allgather_lookup(mesh, T, ids), T[ids])
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the CSR product


def _power_law_graph(device, n_rows=6000, n_cols=5000, long_row=100_000, seed=0):
    """Rows of Zipf-distributed length (up to 60 entries), a fifth of them
    empty, and one row of ``long_row`` entries (repeated columns) that spans
    hundreds of pieces; values and columns from the seed."""
    gen = torch.Generator().manual_seed(seed)
    degree = torch.from_numpy(np.random.RandomState(seed).zipf(1.6, n_rows).clip(max=60))
    degree[torch.randperm(n_rows, generator=gen)[: n_rows // 5]] = 0
    degree[n_rows // 3] = long_row
    rows = torch.repeat_interleave(torch.arange(n_rows), degree)
    cols = torch.randint(0, n_cols, (rows.numel(),), generator=gen)
    vals = torch.rand(rows.numel(), generator=gen)
    return rows.to(device), cols.to(device), vals.to(device), n_rows, n_cols


def _check_within_sum_bound(out, csr, x):
    """``out`` against the float64 product, within the float32 bound of each
    row's sum in another order (2 × entries × 2^-24 × sum |a x|)."""
    from recbole_fairrec_tpu_torch.ops import spmm_csr

    exact = spmm_csr.spmm_csr_reference(csr, x.double())
    magnitude = spmm_csr.spmm_csr_reference(csr._replace(vals=csr.vals.abs()), x.abs().double())
    entries = torch.diff(csr.rowptr).double()[:, None]
    bound = 2 * entries * 2.0 ** -24 * magnitude
    assert out.dtype == torch.float32
    assert bool(((out.double() - exact).abs() <= bound).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 48, 64, 128, 192, 30])
def test_spmm_csr_matches_plain_on_a_power_law_graph(card, d):
    """Forward over A and, through the autograd Function, backward over Aᵀ:
    each within the bound of its sums in another order, empty rows 0, the
    long row split across pieces and joined by the carry pass; d 30 takes
    the scalar lanes."""
    from recbole_fairrec_tpu_torch.ops import spmm_csr

    rows, cols, vals, n_rows, n_cols = _power_law_graph(card)
    pair = spmm_csr.csr_pair(rows, cols, vals, n_rows, n_cols)
    long_pieces = int(pair.fwd.rowptr[n_rows // 3 + 1] - pair.fwd.rowptr[n_rows // 3])
    assert long_pieces // spmm_csr.ITEMS >= 100
    gen = torch.Generator(device=card).manual_seed(d)
    x = torch.randn((n_cols, d), generator=gen, device=card).requires_grad_(True)
    g = torch.randn((n_rows, d), generator=gen, device=card)
    before = spmm_csr.launches
    out = spmm_csr.CsrHop.apply(x, pair)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert spmm_csr.launches == before + 2
    _check_within_sum_bound(out.detach(), pair.fwd, x.detach())
    _check_within_sum_bound(x.grad, pair.bwd, g)
    empty = torch.diff(pair.fwd.rowptr) == 0
    assert bool(empty.any()) and bool((out.detach()[empty] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("items", [1, 7, 4096])
def test_spmm_csr_pieces_of_any_size(card, items):
    """A piece of one item (a carry in almost every piece), of 7, and of
    more items than most rows hold."""
    from recbole_fairrec_tpu_torch.ops import spmm_csr

    rows, cols, vals, n_rows, n_cols = _power_law_graph(card, n_rows=800, n_cols=700,
                                                        long_row=3000, seed=1)
    pair = spmm_csr.csr_pair(rows, cols, vals, n_rows, n_cols, items=items)
    x = torch.randn((n_cols, 64), generator=torch.Generator(device=card).manual_seed(2),
                    device=card)
    out = spmm_csr.spmm_csr(pair.fwd, x)
    torch.cuda.synchronize()
    _check_within_sum_bound(out, pair.fwd, x)


@pytest.mark.gpu
def test_spmm_csr_gives_the_same_bits_twice(card):
    """No float atomics: two hops of the same input are bitwise equal, and
    so are two gradients."""
    from recbole_fairrec_tpu_torch.ops import spmm_csr

    rows, cols, vals, n_rows, n_cols = _power_law_graph(card)
    pair = spmm_csr.csr_pair(rows, cols, vals, n_rows, n_cols)
    x = torch.randn((n_cols, 64), generator=torch.Generator(device=card).manual_seed(3),
                    device=card)
    assert torch.equal(spmm_csr.spmm_csr(pair.fwd, x), spmm_csr.spmm_csr(pair.fwd, x))
    g = torch.randn((n_rows, 64), generator=torch.Generator(device=card).manual_seed(4),
                    device=card)
    assert torch.equal(spmm_csr.spmm_csr(pair.bwd, g), spmm_csr.spmm_csr(pair.bwd, g))


@pytest.mark.gpu
def test_spmm_csr_misaligned_rows_take_the_scalar_lanes(card):
    """A contiguous x that starts 4 bytes past a 16-byte boundary: the
    kernel reads it a float at a time, and agrees with the aligned copy."""
    from recbole_fairrec_tpu_torch.ops import spmm_csr

    rows, cols, vals, n_rows, n_cols = _power_law_graph(card, n_rows=900, n_cols=800,
                                                        long_row=5000, seed=5)
    pair = spmm_csr.csr_pair(rows, cols, vals, n_rows, n_cols)
    x = torch.randn((n_cols, 64), generator=torch.Generator(device=card).manual_seed(6),
                    device=card)
    shifted = torch.empty(n_cols * 64 + 1, device=card)[1:].view(n_cols, 64)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert torch.equal(spmm_csr.spmm_csr(pair.fwd, shifted), spmm_csr.spmm_csr(pair.fwd, x))


@pytest.mark.gpu
def test_spmm_csr_refuses_what_it_does_not_take(card):
    from recbole_fairrec_tpu_torch.ops import spmm_csr

    rows, cols, vals, n_rows, n_cols = _power_law_graph(card, n_rows=100, n_cols=90,
                                                        long_row=10)
    pair = spmm_csr.csr_pair(rows, cols, vals, n_rows, n_cols)
    x = torch.randn((n_cols, 16), device=card)
    before = spmm_csr.launches
    for bad in (x.double(), x.to(torch.bfloat16)):
        with pytest.raises(TypeError, match="float32"):
            spmm_csr.spmm_csr(pair.fwd, bad)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_csr.spmm_csr(pair.fwd, torch.randn((16, n_cols), device=card).t())
    with pytest.raises(ValueError, match="same CUDA device"):
        spmm_csr.spmm_csr(pair.fwd, x.cpu())
    assert spmm_csr.launches == before


@pytest.mark.gpu
def test_propagate_on_the_card_takes_the_kernel(card):
    """``propagate`` with the CSR form: one launch a hop, the plain
    product's result within the bound; without ``csr`` it builds the pair
    on the card for the call and gives the same bits."""
    from recbole_fairrec_tpu_torch.ops import spmm, spmm_csr

    rows, cols, vals, n_rows, _ = _power_law_graph(card, n_rows=3000, n_cols=3000,
                                                   long_row=20_000, seed=7)
    pair = spmm_csr.csr_pair(rows, cols, vals, n_rows)
    x = torch.randn((n_rows, 64), generator=torch.Generator(device=card).manual_seed(8),
                    device=card)
    before = spmm_csr.launches
    h = x
    for hop in range(2):
        h = spmm.propagate(h, rows, cols, vals, n_rows, csr=pair)
        assert spmm_csr.launches == before + hop + 1
    torch.cuda.synchronize()
    _check_within_sum_bound(spmm.propagate(x, rows, cols, vals, n_rows, csr=pair), pair.fwd, x)
    assert torch.equal(spmm.propagate(x, rows, cols, vals, n_rows),
                       spmm.propagate(x, rows, cols, vals, n_rows, csr=pair))
