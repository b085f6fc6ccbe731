"""Traffic and data are deterministic in ``--seed``, and every seed gets the
same sizes."""

import importlib.util
import json
import os
from collections import Counter

import numpy as np
import pytest

from harness import manifest, ml1m
from harness.seeds import derive

BIG = 2**31 + 12345


def _driver(name):
    path = os.path.join(manifest.BENCH_DIR, "drivers", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"t_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_derive_takes_large_seeds():
    assert derive(BIG, "a") == derive(BIG, "a")
    assert derive(BIG, "a") != derive(BIG + 1, "a") != derive(BIG, "b")
    assert 0 <= derive(2**40, "x") < 2**31
    with pytest.raises(ValueError):
        derive(-1, "x")


def test_subset_plan_is_deterministic_with_fixed_sizes():
    fit = _driver("pfcn_fit")
    attrs = ["gender", "age", "occupation"]
    sizes = [3, 1, 2, 1, 2, 1, 2]
    a = fit.subset_plan(attrs, sizes, BIG, epochs=21)
    assert a == fit.subset_plan(attrs, sizes, BIG, epochs=21)
    b = fit.subset_plan(attrs, sizes, BIG + 1, epochs=21)
    assert [len(s) for s, _ in a] == [len(s) for s, _ in b] == sizes * 3
    assert [s for s, _ in a] != [s for s, _ in b]
    for subset, numpy_seed in a:  # the trainer's own draw under that seed
        np.random.seed(numpy_seed)
        mask = np.zeros(3)
        while mask.sum() == 0:
            mask = np.random.choice([0, 1], 3)
        assert tuple(x for x, m in zip(attrs, mask) if m) == subset


RETRIEVAL_MIX = json.load(open(os.path.join(manifest.BENCH_DIR, "traffic",
                                           "topk_closed.json")))["batch_mix"]


@pytest.mark.parametrize("mix", [RETRIEVAL_MIX, {"128": 4, "256": 3, "512": 2, "1024": 1}],
                         ids=["traffic_file", "four_sizes"])
def test_retrieval_mix_per_cycle(mix):
    drv = _driver("topk_requests")
    n = sum(mix.values())
    cycle, sizes = drv._schedule(mix, BIG)
    first = [next(sizes) for _ in range(25 * n)]
    for c in range(25):
        assert Counter(first[n * c:n * c + n]) == {int(b): k for b, k in mix.items()}
    assert len(set(first)) == len(mix)
    _, again = drv._schedule(mix, BIG)
    assert [next(again) for _ in range(25 * n)] == first
    _, other = drv._schedule(mix, BIG + 1)
    assert [next(other) for _ in range(25 * n)] != first
    traffic = {"sample_from": 2048, "sample_requests": 64}
    assert drv._sample(traffic, BIG) == drv._sample(traffic, BIG)
    assert len(drv._sample(traffic, BIG)) == 64


def test_ratings_are_deterministic_at_a_fixed_size():
    data = {"n_users": 50, "n_items": 70, "n_inter": 900}
    u, i, r = ml1m.ratings(data, derive(BIG, "data"))
    u2, i2, r2 = ml1m.ratings(data, derive(BIG, "data"))
    assert np.array_equal(u, u2) and np.array_equal(i, i2) and np.array_equal(r, r2)
    u3, i3, _ = ml1m.ratings(data, derive(BIG + 1, "data"))
    assert len(u3) == len(u) == 900 and not np.array_equal(i3, i)
    assert len(set(zip(u.tolist(), i.tolist()))) == 900
    assert u.min() >= 1 and u.max() <= 50 and i.max() <= 70 and set(r) <= set(range(1, 6))


def test_initial_weights_are_deterministic():
    import torch

    from reference.mf_train import Spec, initial_state

    spec = Spec(9, 11, 4, "sm", {"gender": 2, "age": 7}, [8], 0.3, 10.0)
    a = initial_state(spec, derive(BIG, "weights"), "cpu")
    b = initial_state(spec, derive(BIG, "weights"), "cpu")
    c = initial_state(spec, derive(BIG + 1, "weights"), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["user_embedding.weight"], c["user_embedding.weight"])
