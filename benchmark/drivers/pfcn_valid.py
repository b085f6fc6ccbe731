"""The validation ``fit`` runs after every epoch, under the published uni100
protocol: ``PFCNTrainer._valid_epoch`` on the validation loader, back to
back. One validation is one pass over the loader (each user's validation
items against 100 uniform negatives per item, drawn on the host), every
non-empty subset of the sensitive attributes scored and collected, and the
twelve metrics over all of them.

The model is the configuration's with the benchmark's initial weights (no
training precedes it). Set-up builds data, loaders, model and trainer as
``run_recbole`` does, hands the trainer the training split as ``fit``
does, and runs one validation to warm up. The window counts whole
validations: it ends with the first one to finish after ``seconds``. The
comparison takes the window's last validation: its feed (the loader's
batches) and its result, against the plain reference's metrics of that
feed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import pfcn


class State:
    pass


def setup(run):
    system = pfcn.build(run)
    trainer, valid = system.trainer, system.valid
    trainer.eval_collector.data_collect(system.train)
    state = State()
    state.system = system
    state.feed = []
    state.result = None
    state.users = int(len(valid.segments))
    state.valid_s = []
    inner_fetch = valid._next_batch_data

    def fetch():
        with run.rec.span("loader.fetch"):
            batch = inner_fetch()
        state.feed.append(batch)
        return batch

    valid._next_batch_data = fetch
    run.rec.wrap(trainer.evaluator, "evaluate", "evaluator.evaluate")
    _validate(run, state)  # warm-up: every shape of the window
    return state


def _validate(run, state):
    state.feed = []
    t0 = time.perf_counter()
    with run.rec.span("valid.epoch"):
        _, state.result = state.system.trainer._valid_epoch(state.system.valid)
    state.valid_s.append(round(time.perf_counter() - t0, 3))


def window(run, state, seconds):
    deadline = time.perf_counter() + seconds
    done = 0
    while time.perf_counter() < deadline:
        _validate(run, state)
        done += 1
    run.work["validations"] += done
    run.work["users"] += done * state.users


def end_to_end(run, state):
    run.attempted = int(run.work["validations"])
    run.note("validation_seconds", state.valid_s)
    return {"eval_users_per_s": run.work["users"] / run.window_s}


def _feed_columns(feed, attrs, device):
    """The reference's view of the loader's batches: columns on the device,
    each row's user slot and the positives per slot."""
    out = []
    for interaction, row_idx, positive_u, _ in feed:
        cols = {k: interaction[k].to(device) for k in ("user_id", "item_id", *attrs)}
        slot = torch.from_numpy(np.array(row_idx, dtype=np.int64)).to(device)
        counts = torch.as_tensor(np.bincount(np.asarray(positive_u)), device=device)
        out.append((cols, slot, counts))
    return out


def _feed_faults(feed, n_items, negatives):
    """Draws that break the protocol: a negative that is one of its user's
    validation items, an id out of range, or a user block without
    ``negatives`` draws per item."""
    bad = 0
    for cols, slot, counts in feed:
        items = cols["item_id"].long()
        times = items.shape[0] // int(counts.sum())
        if times != negatives + 1 or times * int(counts.sum()) != items.shape[0]:
            bad += 1
            continue
        bad += int(((items <= 0) | (items >= n_items)).sum())
        starts = (torch.cumsum(counts * times, 0) - counts * times).tolist()
        is_pos = torch.zeros_like(items, dtype=torch.bool)
        for s, c in zip(starts, counts.tolist()):
            is_pos[s:s + c] = True
        key = slot * n_items + items
        pos_keys = torch.unique(key[is_pos])
        bad += int(torch.isin(key[~is_pos], pos_keys).sum())
    return bad


def check(run, state):
    from reference.mf_train import Model, initial_state
    from reference.uni100 import collect, metrics

    system = state.system
    spec, model_seed, weight_seed = system.spec, system.model_seed, system.weight_seed
    attrs = list(spec.attributes)
    settings = run.config["settings"]
    k = max(settings["topk"])
    count_items = dict(system.train.dataset.item_counter)
    n_items = spec.n_items
    feed, result = state.feed, dict(state.result)
    state.system = state.feed = None
    del system
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    cols = _feed_columns(feed, attrs, run.device)
    del feed

    def reference(precision):
        model = Model(spec, initial_state(spec, weight_seed, run.device), {}, model_seed,
                      precision)
        res = collect(model, cols, n_items, attrs, k)
        return metrics(res, k, n_items, count_items, attrs, settings["popularity_ratio"]), \
            res["rec_items"].size

    ref, n_slots = reference("float32")
    numbers = compare(result, ref, n_slots)
    # near-ties that the two sides round apart swap a slot or two; the
    # control swaps only a few more, so the slots are reported, not judged
    # (PERF.md); the score-based and ranking metrics carry the comparison
    run.note("exposure_slots", numbers.pop("exposure_slots"))
    negatives = int(settings["eval_args"]["mode"].lstrip("unipop"))  # uni100 -> 100
    numbers["feed_faults"] = float(_feed_faults(cols, n_items, negatives))
    if run.calibrate:
        run.note("calibration", {"control_tf32": compare(reference("tf32")[0], ref, n_slots)})
    run.note("metrics", {"program": result, "reference": ref})
    return numbers


# metrics of exposure: a near-tie that the program and the reference round
# apart swaps one item of a top-k list, which moves these by a slot
EXPOSURE = {"giniindex": 0.5, "popularitypercentage": 1.0}


def compare(result, ref, n_slots):
    """``metric_gap``: the largest gap of a metric from the reference's,
    against the reference's value or 1e-3, whichever is larger (a
    NonParity value is a small difference of two means, whose round-off
    does not shrink with it); ``exposure_slots``: the Gini index and the
    popular share by how many top-k slots their gap amounts to (a slot moves
    the popular share by 1 / ``n_slots`` and the Gini index by at most 2 /
    ``n_slots``); ``metric_keys``: metrics the one names and the other does
    not."""
    gap = slots = 0.0
    for name in set(result) & set(ref):
        diff = abs(float(result[name]) - ref[name])
        family = name.split("@")[0]
        value = diff * n_slots * EXPOSURE[family] if family in EXPOSURE \
            else diff / max(abs(ref[name]), 1e-3)
        if family in EXPOSURE:
            slots = value if not value <= slots else slots
        else:
            gap = value if not value <= gap else gap
    return {"metric_gap": gap, "exposure_slots": slots,
            "metric_keys": float(len(set(result) ^ set(ref)))}
