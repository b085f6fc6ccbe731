"""Plain reference of a sampled (uni100) validation of PFCN_PMF with
RecBole-FairRec's twelve metrics. It imports nothing of the measured
program.

The feed is the validation's batches: per user a block of its positive
items followed by the sampled negatives, with the users' attribute values.
Every subset of the sensitive attributes is scored over the whole feed
(the filter of the subset in evaluation mode: BatchNorm on its running
statistics), so the metrics are over (subset, user) rows. Per row the
candidates' scores ``σ(f(u) · i)`` are ranked with ties to the lower item
id; the top 5 give the ranking metrics (NDCG, Recall, Hit, MRR), Gini and
the popular share; the positives' scores give NonParity and Differential
Fairness per attribute; positives against each one's first sampled
negative give the four unfairness gaps of Yao and Huang over the first
attribute. The formulas are those of RecBole's metrics, in float64 (the
Differential Fairness ratios in float32, as RecBole-FairRec computes them).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def subsets(attrs):
    return [s for i in range(1, len(attrs) + 1) for s in itertools.combinations(attrs, i)]


@torch.no_grad()
def collect(model, feed, n_items, attrs, k, item_field="item_id"):
    """The per-row resources of a validation: ``rec_items`` [N, k],
    ``hits`` [N, k], ``pos_len`` [N], and per positive row ``pos_score``,
    ``pos_i``, ``neg_score``, ``neg_i`` and the attribute values (``sst``).
    ``feed`` is a list of (interaction columns as tensors, user of each row
    as a 0-based slot, number of positives per slot)."""
    out = {key: [] for key in ("rec_items", "hits", "pos_len", "pos_score", "pos_i",
                               "neg_score", "neg_i")}
    out["sst"] = {a: [] for a in attrs}
    for cols, slot, counts in feed:
        users = cols["user_id"]
        items = cols[item_field].long()
        n_users = counts.shape[0]
        times = items.shape[0] // int(counts.sum())
        starts = torch.cumsum(counts * times, 0) - counts * times
        pos_rows = torch.cat([torch.arange(s, s + c, device=items.device)
                              for s, c in zip(starts.tolist(), counts.tolist())])
        neg_rows = torch.cat([torch.arange(s + c, s + 2 * c, device=items.device)
                              for s, c in zip(starts.tolist(), counts.tolist())])
        pos_slot = slot[pos_rows]
        for subset in subsets(attrs):
            u = model.user_repr(users, subset, train=False)
            item_e = model.state["item_embedding.weight"][items]
            scores = torch.sigmoid((u * item_e).sum(-1))
            dense = torch.full((n_users, n_items), float("-inf"), device=scores.device)
            dense[slot, items] = scores
            top = torch.sort(dense, dim=1, descending=True, stable=True).indices[:, :k]
            pos = torch.zeros((n_users, n_items), dtype=torch.int64, device=scores.device)
            pos.index_put_((pos_slot, items[pos_rows]),
                           torch.ones_like(pos_slot), accumulate=True)
            out["rec_items"].append(top.cpu().numpy())
            out["hits"].append(torch.gather(pos, 1, top).cpu().numpy())
            out["pos_len"].append(pos.sum(dim=1).cpu().numpy())
            out["pos_score"].append(dense[pos_slot, items[pos_rows]].double().cpu().numpy())
            out["pos_i"].append(items[pos_rows].cpu().numpy())
            out["neg_score"].append(scores[neg_rows].double().cpu().numpy())
            out["neg_i"].append(items[neg_rows].cpu().numpy())
            for a in attrs:
                out["sst"][a].append(cols[a][pos_rows].cpu().numpy())
    res = {key: np.concatenate(v) for key, v in out.items() if key != "sst"}
    res["sst"] = {a: np.concatenate(v) for a, v in out["sst"].items()}
    return res


def metrics(res, k, n_items, count_items, attrs, popularity_ratio=0.1):
    """The twelve metrics (16 numbers over three attributes), named as
    RecBole names them."""
    hits = res["hits"].astype(bool)[:, :k]
    pos_len = res["pos_len"].astype(np.float64)
    ranks = np.arange(1, k + 1, dtype=np.float64)
    disc = 1.0 / np.log2(ranks + 1)
    dcg = (hits * disc).sum(axis=1)
    idcg = np.array([disc[:min(int(n), k)].sum() for n in pos_len])
    first = np.where(hits.any(axis=1), hits.argmax(axis=1) + 1, 0)
    out = {
        f"ndcg@{k}": float(np.mean(dcg / idcg)),
        f"recall@{k}": float(np.mean(hits.sum(axis=1) / pos_len)),
        f"hit@{k}": float(np.mean(hits.any(axis=1))),
        f"mrr@{k}": float(np.mean(np.where(first > 0, 1.0 / np.maximum(first, 1), 0.0))),
    }
    pos_score, pos_i = res["pos_score"], res["pos_i"]
    for a in attrs:
        out[f"Differential Fairness of sensitive attribute {a}"] = _differential_fairness(
            pos_score, pos_i, res["sst"][a])
    rec = res["rec_items"][:, :k]
    _, counts = np.unique(rec, return_counts=True)
    counts = np.sort(counts)
    idx = np.arange(n_items - len(counts) + 1, n_items + 1)
    out[f"giniindex@{k}"] = float(np.sum((2 * idx - n_items - 1) * counts) / rec.size / n_items)
    ranked = sorted(count_items.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)
    popular = [item for item, _ in ranked[:max(int(len(ranked) * popularity_ratio), 1)]]
    out[f"popularitypercentage@{k}"] = float(np.isin(rec, popular).mean())
    first_attr = attrs[0]
    gaps = _yao_huang(pos_score, pos_i, res["neg_score"], res["neg_i"], res["sst"][first_attr])
    for name, value in gaps.items():
        out[f"{name} of sensitive attribute {first_attr}"] = value
    for a in attrs:
        groups = np.unique(res["sst"][a])
        means = [pos_score[res["sst"][a] == g].mean() for g in groups]
        value = abs(means[0] - means[1]) if len(groups) == 2 else np.std(means)
        out[f"NonParity Unfairness of sensitive attribute {a}"] = float(value)
    return out


def _differential_fairness(score, items, groups):
    _, item_idx = np.unique(items, return_inverse=True)
    _, group_idx = np.unique(groups, return_inverse=True)
    n_i, n_g = item_idx.max() + 1, group_idx.max() + 1
    sums = np.zeros((n_i, n_g))
    counts = np.zeros((n_i, n_g))
    np.add.at(sums, (item_idx, group_idx), score)
    np.add.at(counts, (item_idx, group_idx), 1.0)
    p = ((sums + 1.0 / n_i) / (counts + 1.0)).astype(np.float32)
    logp = np.log(p)
    eps = np.zeros(n_i, dtype=np.float32)
    for i in range(n_g):
        for j in range(i + 1, n_g):
            eps = np.maximum(eps, np.abs(logp[:, i] - logp[:, j]))
    return float(eps.mean())


def _yao_huang(pos_score, pos_i, neg_score, neg_i, groups):
    values, group_idx = np.unique(groups, return_inverse=True)
    if len(values) != 2:
        raise ValueError("the unfairness gaps need a binary attribute")
    all_i = np.concatenate([pos_i, neg_i])
    _, item_idx = np.unique(all_i, return_inverse=True)
    n = item_idx.max() + 1
    g2 = np.concatenate([group_idx, group_idx])
    pred = np.zeros((n, 2))
    num = np.zeros((n, 2))
    true = np.zeros((n, 2))
    np.add.at(pred, (item_idx, g2), np.concatenate([pos_score, neg_score]))
    np.add.at(num, (item_idx, g2), 1.0)
    np.add.at(true, (item_idx[:len(pos_i)], group_idx), 1.0)
    num += 1e-5
    pred, true = pred / num, true / num
    diff = pred - true
    return {
        "Value Unfairness": float(np.mean(np.abs(diff[:, 0] - diff[:, 1]))),
        "Absolute Unfairness": float(np.mean(np.abs(np.abs(diff[:, 0]) - np.abs(diff[:, 1])))),
        "Underestimation Unfairness": float(np.mean(np.abs(
            np.maximum(-diff[:, 0], 0) - np.maximum(-diff[:, 1], 0)))),
        "Overestimation Unfairness": float(np.mean(np.abs(
            np.maximum(diff[:, 0], 0) - np.maximum(diff[:, 1], 0)))),
    }
