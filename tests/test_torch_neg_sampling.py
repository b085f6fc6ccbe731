"""``ops/neg_sampling.py`` of the port, on the CPU.

The membership tables must equal the JAX package's bit for bit (compared as
numpy). The draws are torch's and are not compared with threefry's; what is
checked is what the samplers promise: no used pair, never PAD 0, ids below
``item_num``, the strided layout, uniformity over the unused items, and
reproducibility from the generator's seed.
"""

import numpy as np
import pytest
import torch

from recbole_fairrec_tpu.ops import neg_sampling as jax_ns

from recbole_fairrec_tpu_torch.ops import neg_sampling as ns
from recbole_fairrec_tpu_torch.sampler.sampler import AliasTable

N_USERS, N_ITEMS = 50, 70  # with PAD rows: ids 1..49 and 1..69


def _pairs(seed=3, n=900):
    r = np.random.RandomState(seed)
    keys = np.unique(r.randint(1, N_USERS, n) * N_ITEMS + r.randint(1, N_ITEMS, n))
    return keys // N_ITEMS, keys % N_ITEMS


def _table(kind, u, i):
    if kind == "bitmap":
        return ns.build_used_bitmap(u, i, N_USERS, N_ITEMS)
    return ns.build_used_keys(u, i, N_ITEMS)


def _used_set(u, i):
    return set(zip(u.tolist(), i.tolist()))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_bitmap_equals_jax_bit_for_bit():
    u, i = _pairs()
    # item 31 of a word exercises the sign bit of the port's int32 words
    u = np.append(u, [1, 2]); i = np.append(i, [31, 63])
    ours = ns.build_used_bitmap(u, i, N_USERS, N_ITEMS)
    ref = np.asarray(jax_ns.build_used_bitmap(u, i, N_USERS, N_ITEMS))
    assert ours.dtype == torch.int32 and ref.dtype == np.uint32
    np.testing.assert_array_equal(ours.numpy().view(np.uint32), ref)
    member = ns._is_used(ours, N_ITEMS, torch.tensor([1, 2, 1]), torch.tensor([31, 63, 30]))
    assert member.tolist() == [True, True, (1, 30) in _used_set(u, i)]


def test_keys_equal_jax():
    u, i = _pairs()
    ours = ns.build_used_keys(u, i, N_ITEMS)
    ref = np.asarray(jax_ns.build_used_keys(u, i, N_ITEMS))
    assert ours.dtype == torch.int64  # torch.searchsorted's key type here
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_build_used_table_picks_by_budget(monkeypatch):
    u, i = _pairs()
    assert ns.build_used_table(u, i, N_USERS, N_ITEMS).dim() == 2
    assert ns._BITMAP_BUDGET_BYTES == jax_ns._BITMAP_BUDGET_BYTES == 64 * 1024 * 1024
    monkeypatch.setattr(ns, "_BITMAP_BUDGET_BYTES", 16)
    assert ns.build_used_table(u, i, N_USERS, N_ITEMS).dim() == 1


@pytest.mark.parametrize("kind", ["bitmap", "keys"])
@pytest.mark.parametrize("num_neg", [1, 3])
def test_sample_negatives_excludes_used_and_is_strided(kind, num_neg):
    u, i = _pairs()
    used = _table(kind, u, i)
    users = torch.from_numpy(np.random.RandomState(5).randint(1, N_USERS, 400))
    out = ns.sample_negatives(_gen(), users, used, N_ITEMS, num_neg=num_neg)
    assert out.shape == (400 * num_neg,) and out.dtype == torch.int64
    assert int(out.min()) >= 1 and int(out.max()) < N_ITEMS
    tiled = users.repeat(num_neg)  # out[i + k * B] belongs to user i
    taken = _used_set(u, i)
    assert not any((a, b) in taken for a, b in zip(tiled.tolist(), out.tolist()))
    # the k negatives of a user are separate draws, not one draw repeated
    if num_neg > 1:
        assert not torch.equal(out[:400], out[400:800])


@pytest.mark.parametrize("kind", ["bitmap", "keys"])
def test_sample_negatives_reproducible_from_seed(kind):
    u, i = _pairs()
    used = _table(kind, u, i)
    users = torch.arange(1, N_USERS).repeat(4)
    a = ns.sample_negatives(_gen(7), users, used, N_ITEMS)
    b = ns.sample_negatives(_gen(7), users, used, N_ITEMS)
    c = ns.sample_negatives(_gen(8), users, used, N_ITEMS)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("kind", ["bitmap", "keys"])
def test_sample_negatives_uniform_over_unused(kind):
    """One user with 20 used items, 60,000 draws over the 49 unused ones:
    Pearson's chi-square with 48 degrees of freedom stays below 100 (its
    99.999th percentile is 98.2)."""
    used_items = np.arange(1, 21)
    used = _table(kind, np.full(20, 4), used_items)
    n = 60_000
    out = ns.sample_negatives(_gen(1), torch.full((n,), 4), used, N_ITEMS).numpy()
    assert not np.isin(out, used_items).any()
    counts = np.bincount(out, minlength=N_ITEMS)[21:]
    expected = n / len(counts)
    assert ((counts - expected) ** 2 / expected).sum() < 100.0


@pytest.mark.parametrize("kind", ["bitmap", "keys"])
def test_user_with_every_item_used_still_gets_valid_ids(kind):
    items = np.arange(1, N_ITEMS)
    used = _table(kind, np.full(len(items), 9), items)
    out = ns.sample_negatives(_gen(), torch.full((64,), 9), used, N_ITEMS, num_neg=2)
    assert out.shape == (128,)
    assert int(out.min()) >= 1 and int(out.max()) < N_ITEMS  # kept, though colliding


def test_first_good_round_equals_the_sequential_rounds():
    """All rounds at once pick what the JAX package's scan arrives at: round
    after round, a sample still colliding takes the new draw; one that
    collides in every round keeps the last draw."""
    r = np.random.RandomState(6)
    draws = torch.from_numpy(r.randint(1, 50, (16, 500)))
    bad = torch.from_numpy(r.rand(16, 500) < 0.6)
    bad[:, :7] = True  # collides in every round
    items = torch.zeros(500, dtype=torch.int64)
    still_bad = torch.ones(500, dtype=torch.bool)
    for k in range(16):
        items = torch.where(still_bad, draws[k], items)
        still_bad = still_bad & bad[k]
    assert torch.equal(ns._first_good_round(draws, bad), items)
    assert torch.equal(items[:7], draws[15, :7])


def test_empty_key_table():
    used = ns.build_used_keys(np.array([], np.int64), np.array([], np.int64), N_ITEMS)
    out = ns.sample_negatives(_gen(), torch.arange(1, 30), used, N_ITEMS)
    assert int(out.min()) >= 1 and int(out.max()) < N_ITEMS


def test_repeatable_excludes_only_the_positive():
    pos = torch.from_numpy(np.random.RandomState(2).randint(1, 4, 3000))  # 3 items: collisions
    out = ns.sample_negatives_repeatable(_gen(), pos, 4, num_neg=2)
    assert out.shape == (6000,)
    assert not bool((out == pos.repeat(2)).any())
    assert set(out.tolist()) == {1, 2, 3}


@pytest.mark.parametrize("kind", ["bitmap", "keys"])
def test_popularity_honours_exclusions_and_follows_popularity(kind):
    u, i = _pairs()
    used = _table(kind, u, i)
    r = np.random.RandomState(4)
    candidates = np.concatenate([np.full(300, 5), np.full(100, 6), r.randint(1, N_ITEMS, 600)])
    table = AliasTable(candidates)
    users = torch.from_numpy(r.randint(1, N_USERS, 20_000))
    out = ns.sample_negatives_popularity(
        _gen(), users, used, torch.from_numpy(table.prob), torch.from_numpy(table.alias),
        torch.from_numpy(table.values), N_ITEMS,
    )
    taken = _used_set(u, i)
    assert not any((a, b) in taken for a, b in zip(users.tolist(), out.tolist()))
    assert int(out.min()) >= 1 and int(out.max()) < N_ITEMS
    counts = np.bincount(out.numpy(), minlength=N_ITEMS)
    rest = np.delete(counts, [5, 6])
    assert counts[5] > counts[6] > rest.max()
