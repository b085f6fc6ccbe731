"""The comparisons that decide ``correct``, and how a run prints them.

Each number compared has a limit of its own (``limits/<cell>.json``); a run
is correct when every number is finite and at most its limit. The numbers
are printed beside their limits as the last lines of standard error and
under the result line's last key.
"""

from __future__ import annotations

import math
import statistics
import sys

import torch

# a leaf whose reference gradient is below this share of the median leaf's
# is nought to rounding (a bias under BatchNorm): Adam moves it by
# round-off alone, so its change is not compared
ZERO_GRAD_SHARE = 1e-3


def leaf_gaps(prog, ref, names):
    """Per leaf: the gap between the program's and the reference's norm,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger (NaN, and a leaf the program lacks, read inf)."""
    names = list(names)
    if not names:
        return {}
    median = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        gap = abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], median, 1e-30)
        out[n] = gap if gap == gap else math.inf
    return out


def reached(raw):
    """The leaves of ``raw`` (name → gradient norm) that are compared: all
    but those whose gradient is nought to rounding, above 0 and under
    ``ZERO_GRAD_SHARE`` of the median reached leaf's. A leaf that the loss
    does not reach at all reads exactly 0 and stays: weight decay alone
    moves it, the same on both sides."""
    nonzero = [v for v in raw.values() if v > 0]
    floor = ZERO_GRAD_SHARE * statistics.median(nonzero) if nonzero else 0.0
    return [n for n in raw if raw[n] == 0 or raw[n] >= floor]


def train_numbers(prog, ref):
    """The numbers of a training cell, from the program's and the
    reference's readings of the same first steps (see
    ``reference/mf_train.py::train_steps`` for the keys): the largest gap of
    a step's loss; the worst leaf's gap of the first gradient and of the
    change; and the median leaf's gaps, which stay steady where the worst
    leaf is one whose gradient is a small sum that cancels, which Adam's
    first steps turn into moves of ±lr from round-off. Parameters whose
    reference gradient is nought to rounding (``reached``; in any step,
    where the reference reports each step's) are left out of the gradient
    and the change. BatchNorm's running statistics are compared step by
    step where the reference follows the program (``passage_numbers``)."""
    losses = [abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    raw = ref["raw_grad"]
    kept = reached(raw)
    grad = leaf_gaps(prog["grad"], ref["grad"], kept)
    if ref.get("passages"):  # a leaf nought to rounding in any step is left out
        raws = [p["raw_grad"] for p in ref["passages"]]
        out = set().union(*(set(r) - set(reached(r)) for r in raws))
        kept = sorted(set().union(*raws) - out)
    change = leaf_gaps(prog["change"], ref["change"], kept)
    numbers = {
        "loss_gap": max(losses) if losses else math.inf,
        "grad_worst": max(grad.values(), default=0.0),
        "change_worst": max(change.values(), default=0.0),
        "grad_median": statistics.median(grad.values()) if grad else 0.0,
        "change_median": statistics.median(change.values()) if change else 0.0,
    }
    info = {"grad_worst_leaf": max(grad, key=grad.get, default=None),
            "change_worst_leaf": max(change, key=change.get, default=None),
            "left_out": sorted(set(raw) - set(kept))}
    return numbers, info


def _norm(t):
    return float(torch.linalg.vector_norm(t.float()))


def passage_numbers(snapshots, ref, initial, lr, params, buffers):
    """The numbers of a reference that starts each step from the program's
    state (``reference/mf_train.py::train_steps`` with ``follow``): each
    step's passage from the program's snapshot before it to the one after
    is checked against the reference's own passage from the same start.

    * ``state_mismatch`` (exact): leaves the program carries wrong: a
      start other than the benchmark's initial state; a parameter outside
      the step's optimizer, or a buffer of a layer the step did not run,
      that moved; another optimizer's moments or step count that moved; a
      leaf of the step's optimizer without moments or at another step count
      than the reference's.
    * ``flip_share``: the largest share, over the steps, of the stepped
      parameters' elements that the two passages put more than half a
      learning rate apart (Adam's first move of a gradient that cancels).
    * ``moment_median``: the largest, over the steps, of the median leaf's
      gap of the norms of the step's optimizer's first and second moments.
    * ``buffer_median``: the largest, over the steps, of the median gap of
      the norms of the BatchNorm running statistics' moves, over the
      statistics the reference's passage moved.

    Leaves of the step's optimizer whose gradient in that step is nought to
    rounding (``reached``) are left out of the flips and the moments."""
    mismatch = 0
    start = snapshots[0]
    for n, t in initial.items():
        if n not in start["model"] or not torch.equal(start["model"][n], t.to("cpu")):
            mismatch += 1
    mismatch += sum(len(m) for m in start["opt"].values())
    flip = moment = buffer = 0.0
    worst = {}
    for i, passage in enumerate(ref["passages"]):
        before, prog, mine = snapshots[i], snapshots[i + 1], passage["after"]
        kind, raw = passage["kind"], passage["raw_grad"]
        kept = reached(raw)
        for n in params:
            if n not in raw and not torch.equal(prog["model"][n], before["model"][n]):
                mismatch += 1
        for n in buffers:
            if torch.equal(mine["model"][n], before["model"][n]) and \
                    not torch.equal(prog["model"][n], before["model"][n]):
                mismatch += 1
        for tag in set(before["opt"]) | set(prog["opt"]):
            if tag == kind:
                continue
            was, now = before["opt"].get(tag, {}), prog["opt"].get(tag, {})
            mismatch += len(set(was) ^ set(now))
            for n in set(was) & set(now):
                same = all(torch.equal(a, b) for a, b in zip(was[n][:2], now[n][:2]))
                mismatch += int(not same or was[n][2] != now[n][2])
        got, want = prog["opt"].get(kind, {}), mine["opt"][kind]
        mismatch += sum(n not in got or got[n][2] != want[n][2] for n in raw)
        apart, total, where = 0, 0, {}
        for n in kept:
            diff = (prog["model"][n] - mine["model"][n]).abs()
            count = int((diff > lr / 2).sum())
            apart, total = apart + count, total + diff.numel()
            if count:
                where[n] = count
        if apart / max(total, 1) > flip:
            flip = apart / total
            worst["flip"] = (i, where)
        for j, label in ((0, "exp_avg"), (1, "exp_avg_sq")):
            gaps = leaf_gaps({n: _norm(got[n][j]) for n in kept if n in got},
                             {n: _norm(want[n][j]) for n in kept}, kept)
            if gaps and statistics.median(gaps.values()) >= moment:
                moment = statistics.median(gaps.values())
                worst["moment"] = (i, label, max(gaps, key=gaps.get), max(gaps.values()))
        ref_move = {n: _norm(mine["model"][n] - before["model"][n]) for n in buffers}
        moved = [n for n in buffers if ref_move[n] > 0]
        gaps = leaf_gaps({n: _norm(prog["model"][n] - before["model"][n]) for n in moved},
                         ref_move, moved)
        if gaps and statistics.median(gaps.values()) >= buffer:
            buffer = statistics.median(gaps.values())
            worst["buffer"] = (i, max(gaps, key=gaps.get), max(gaps.values()))
    numbers = {"state_mismatch": mismatch, "flip_share": flip, "moment_median": moment,
               "buffer_median": buffer}
    return numbers, worst


def judge(numbers, limits):
    """(correct, checks): every number finite and within its limit; checks
    maps each name to its number and limit, in ``limits``' order."""
    checks = {}
    correct = True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"numbers without a limit: {sorted(missing)}")
    return correct, checks


def print_checks(checks, stream=None):
    stream = stream or sys.stderr
    for name, c in checks.items():
        verdict = "ok" if c["value"] is not None and c["value"] <= c["limit"] else "FAIL"
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {verdict}", file=stream,
              flush=True)
