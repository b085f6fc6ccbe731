"""Retrieval over a whole catalog by one closed-loop client.

A request is a batch of user ids drawn uniformly on the card from the seed;
batch sizes come from the traffic's ``batch_mix`` (counts per cycle),
every cycle holding exactly that mix in an order drawn from the seed. Per
request the window times, on the host clock: the gather of the users' rows
from the stored user table, ``ops/topk.py::certified_topk_scores`` over the
whole item table, and the copy of the ids to the host. The next request is
sent when the ids are there.

Set-up makes both tables on the card from the seed in the configuration's
storage type and warms up every batch size of the mix. Once the window has
closed, a sample of the requests drawn from the seed (with the first
request, and the first of the largest size) is compared with the plain
reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from counts import topk_call_s
from harness.seeds import derive

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


class State:
    pass


def _schedule(mix, seed):
    """Batch sizes of the requests in order: cycles of the mix, each in an
    order drawn from the seed."""
    cycle = [int(b) for b, n in mix.items() for _ in range(int(n))]
    rs = np.random.RandomState(derive(seed, "order"))

    def sizes():
        while True:
            for b in rs.permutation(cycle):
                yield int(b)

    return cycle, sizes()


def _sample(traffic, seed):
    rs = np.random.RandomState(derive(seed, "sample"))
    return set(rs.choice(traffic["sample_from"], traffic["sample_requests"], replace=False)
               .tolist())


def setup(run):
    from recbole_fairrec_tpu_torch.ops import fused_topk  # noqa: F401  (launch counter)
    from recbole_fairrec_tpu_torch.ops.topk import certified_topk_scores

    cfg, traffic, device = run.config, run.traffic, run.device
    dtype = DTYPES[cfg["retrieval_dtype"]]
    d = cfg["settings"]["embedding_size"]
    gen = torch.Generator(device=device).manual_seed(derive(run.seed, "tables"))
    state = State()
    state.users = torch.randn(cfg["n_users"], d, generator=gen, device=device, dtype=dtype)
    state.items = torch.randn(cfg["n_items"], d, generator=gen, device=device, dtype=dtype)
    state.k = cfg["retrieval_topk"]
    state.topk = certified_topk_scores
    state.ids_gen = torch.Generator(device=device).manual_seed(derive(run.seed, "users"))
    cycle, state.sizes = _schedule(traffic["batch_mix"], run.seed)
    state.pending = []
    state.sample = _sample(traffic, run.seed)
    state.largest_seen = False
    state.kept = {}
    state.latencies = []
    state.index = 0
    for b in sorted(set(cycle)):  # every batch size of the mix, twice
        for _ in range(2):
            ids = torch.randint(1, cfg["n_users"], (b,), generator=gen, device=device)
            state.topk(state.users[ids], state.items, state.k)[1].cpu()
    state.largest = max(cycle)
    return state


def _draw_cycle(run, state):
    """The ids of the next cycle of requests, in one draw on the card."""
    n = sum(int(c) for c in run.traffic["batch_mix"].values())
    sizes = [next(state.sizes) for _ in range(n)]
    flat = torch.randint(1, run.config["n_users"], (sum(sizes),), generator=state.ids_gen,
                         device=run.device)
    state.pending = list(reversed(torch.split(flat, sizes)))


def window(run, state, seconds):
    from recbole_fairrec_tpu_torch.ops import fused_topk

    users, items, k, topk = state.users, state.items, state.k, state.topk
    launches0 = fused_topk.launches
    deadline = time.perf_counter() + seconds
    requests = served = 0
    least = 0.0
    d, n_items = users.shape[1], items.shape[0]
    elem = items.element_size()
    while time.perf_counter() < deadline:
        if not state.pending:
            _draw_cycle(run, state)
        ids = state.pending.pop()
        with run.rec.span("retrieval.request"):
            t0 = time.perf_counter()
            scores, idx = topk(users[ids], items, k)
            idx_host = idx.cpu()
            t1 = time.perf_counter()
        b = ids.shape[0]
        state.latencies.append(t1 - t0)
        i = state.index
        if i == 0 or i in state.sample or (b == state.largest and not state.largest_seen):
            state.largest_seen = state.largest_seen or b == state.largest
            state.kept[i] = (ids, scores, idx_host)
        state.index += 1
        requests += 1
        served += b
        least += topk_call_s(b, n_items, d, k, elem)
    run.work["requests"] += requests
    run.work["users"] += served
    run.work["least_s"] += least
    run.work["launches"] += fused_topk.launches - launches0


def end_to_end(run, state):
    run.attempted = int(run.work["requests"])
    lat = np.asarray(state.latencies[:int(run.work["requests"])])
    return {"retrieval_users_per_s": run.work["users"] / run.window_s,
            "retrieval_p95_ms": float(np.percentile(lat, 95)) * 1e3}


def judge(users, items, k, answers, quantize=None):
    """The numbers of a set of answers ``[(user ids, scores, ids)]``:
    ``score_err`` (largest gap between a returned score and the exact score
    of the returned item), ``rank_gap`` (largest amount by which a returned
    item's exact score lies below the reference's k-th best) and
    ``bad_slots`` (PAD or out-of-range ids, repeats in a row, scores not in
    descending order). With ``quantize`` the answers are replaced by the
    reference's in that type: the control."""
    from reference.topk import exact_scores, topk as ref_topk

    score_err = rank_gap = 0.0
    bad = 0
    n_items = items.shape[0]
    for ids, scores, got in answers:
        rows = users[ids]
        if quantize is not None:
            scores, got = ref_topk(rows, items, k, quantize=quantize)
        got = got.to(rows.device).long()
        scores = scores.to(rows.device).float()
        exact = exact_scores(rows, items, got)
        best, _ = ref_topk(rows, items, k)
        score_err = max(score_err, float((scores.double() - exact).abs().max()))
        rank_gap = max(rank_gap, float((best[:, -1].double() - exact.min(dim=1).values).max()))
        sorted_ids = got.sort(dim=1).values
        bad += int(((got <= 0) | (got >= n_items)).sum())
        bad += int((sorted_ids[:, 1:] == sorted_ids[:, :-1]).sum())
        bad += int((scores[:, 1:] > scores[:, :-1]).sum())
    if not answers:
        return {"score_err": float("nan"), "rank_gap": float("nan"), "bad_slots": float("nan")}
    return {"score_err": score_err, "rank_gap": rank_gap, "bad_slots": float(bad)}


def check(run, state):
    answers = [state.kept[i] for i in sorted(state.kept)]
    run.note("compared", {"requests": len(answers),
                          "users": int(sum(a[0].shape[0] for a in answers))})
    state.pending = []
    numbers = judge(state.users, state.items, state.k, answers)
    if run.calibrate:
        run.note("calibration", {"control_float8_e4m3": judge(
            state.users, state.items, state.k, answers, quantize=torch.float8_e4m3fn)})
    return numbers
