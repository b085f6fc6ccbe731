"""The plain references against brute force at a tiny size."""

import numpy as np
import pytest
import torch

from reference import mf_train, topk, uni100


def test_topk_against_a_full_sort():
    g = torch.Generator().manual_seed(0)
    users = torch.randn(7, 8, generator=g).bfloat16()
    items = torch.randn(1000, 8, generator=g).bfloat16()
    s, i = topk.topk(users, items, 5, block=128)
    full = users.double() @ items.double().T
    full[:, 0] = -np.inf
    want = torch.sort(full, dim=1, descending=True).indices[:, :5]
    assert torch.equal(i, want)
    assert torch.allclose(s.double(), torch.gather(full, 1, want), rtol=0, atol=1e-5)
    assert torch.allclose(topk.exact_scores(users, items, i), torch.gather(full, 1, want))


def test_adam_matches_torch_adam():
    g = torch.Generator().manual_seed(1)
    p = torch.randn(5, 3, generator=g)
    grads = [torch.randn(5, 3, generator=g) for _ in range(3)]
    state = {"p": p.clone()}
    ours = mf_train.Adam(state, ["p"], lr=1e-2, weight_decay=1e-3)
    theirs_p = torch.nn.Parameter(p.clone())
    theirs = torch.optim.Adam([theirs_p], lr=1e-2, eps=1e-8, weight_decay=1e-3)
    for grad in grads:
        ours.step({"p": grad})
        theirs_p.grad = grad.clone()
        theirs.step()
    assert torch.allclose(state["p"], theirs_p.detach(), rtol=0, atol=1e-7)


def test_bpr_step_gradient_against_finite_differences():
    spec = mf_train.Spec(5, 6, 3, lr=1e-3)
    state = {k: v.double() for k, v in mf_train.initial_state(spec, 3, "cpu").items()}
    model = mf_train.Model(spec, state, {}, 0)
    batch = {"user_id": torch.tensor([1, 2, 3]), "item_id": torch.tensor([1, 4, 5]),
             "neg_item_id": torch.tensor([2, 2, 3])}
    w = state["user_embedding.weight"].requires_grad_(True)
    loss = model.loss(batch, "bpr", ())
    (grad,) = torch.autograd.grad(loss, w)
    eps = 1e-6
    w2 = w.detach().clone()
    w2[2, 1] += eps
    state["user_embedding.weight"] = w2
    up = model.loss(batch, "bpr", ())
    assert float(grad[2, 1].detach()) == pytest.approx((float(up) - float(loss.detach())) / eps, rel=1e-4)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-20, -3.0 - 2**-12, 1.0 + 2**-11])
    r = mf_train.round_tf32(x)
    assert r.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0, 1.0]


def _loop_metrics(hits, pos_len, k):
    ndcg = recall = hit = mrr = 0.0
    for row, n in zip(hits, pos_len):
        dcg = sum(1 / np.log2(r + 2) for r in range(k) if row[r])
        idcg = sum(1 / np.log2(r + 2) for r in range(min(n, k)))
        ndcg += dcg / idcg
        recall += sum(row[:k]) / n
        hit += float(any(row[:k]))
        first = next((r for r in range(k) if row[r]), None)
        mrr += 0.0 if first is None else 1 / (first + 1)
    n = len(hits)
    return {"ndcg@5": ndcg / n, "recall@5": recall / n, "hit@5": hit / n, "mrr@5": mrr / n}


def test_ranking_metrics_against_loops():
    rs = np.random.RandomState(4)
    n, k = 40, 5
    hits = rs.rand(n, k) < 0.3
    pos_len = rs.randint(1, 8, n)
    res = {"hits": hits.astype(np.int64), "pos_len": pos_len,
           "rec_items": rs.randint(1, 30, (n, k)), "pos_score": rs.rand(60),
           "pos_i": rs.randint(1, 30, 60), "neg_score": rs.rand(60), "neg_i": rs.randint(1, 30, 60),
           "sst": {"gender": rs.randint(0, 2, 60)}}
    got = uni100.metrics(res, k, 30, {i: int(c) for i, c in enumerate(rs.randint(1, 50, 30))},
                         ["gender"])
    for name, value in _loop_metrics(hits, pos_len, k).items():
        assert got[name] == pytest.approx(value, rel=1e-12)


def test_gini_and_nonparity_by_hand():
    res = {"hits": np.zeros((2, 2), dtype=np.int64), "pos_len": np.array([1, 1]),
           "rec_items": np.array([[1, 2], [1, 3]]), "pos_score": np.array([0.2, 0.4, 0.9]),
           "pos_i": np.array([1, 2, 3]), "neg_score": np.array([0.1, 0.1, 0.1]),
           "neg_i": np.array([4, 4, 4]), "sst": {"gender": np.array([0, 0, 1])}}
    got = uni100.metrics(res, 2, 5, {1: 9, 2: 1, 3: 1, 4: 1}, ["gender"])
    # counts sorted [1, 1, 2] over 5 items: idx 3, 4, 5, weights 2·idx − 6
    assert got["giniindex@2"] == pytest.approx((0 * 1 + 2 * 1 + 4 * 2) / 4 / 5)
    assert got["NonParity Unfairness of sensitive attribute gender"] == pytest.approx(0.6)
    assert got["popularitypercentage@2"] == pytest.approx(0.5)  # item 1 is the top 10%
