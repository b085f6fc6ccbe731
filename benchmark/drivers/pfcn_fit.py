"""Training of a PFCN configuration as ``fit`` trains it, without
validation: ``PFCNTrainer._train_epoch`` over the ``TrainDataLoader`` from
epoch 0 on (a filter pass every ``train_epoch_interval``-th epoch, a
discriminator pass every epoch, each a whole walk of the training rows).

Every seed trains on the same sizes: the trainer draws each epoch's subset
of the sensitive attributes from numpy's global generator, so before each
epoch the benchmark seeds that generator with a value under which the draw
gives the subset of the traffic's size for that epoch (the members of that
size chosen by the run's seed). A pass whose subset is off that plan (the
trainer draws otherwise than ``_draw`` replays) is counted in the numbers
compared, with the limit 0. The window ends at the first step after
``seconds``: the loader ends its pass there.

Set-up takes the traffic's ``checked_steps`` ((step kind, subset size):
the subset is the plan's first of that size) through the window's own
entry, ``_run_epoch``, each the first step of a pass, and the comparison
checks each step's passage against the plain reference.
"""

from __future__ import annotations

import gc
import itertools
import time
from collections import defaultdict

import numpy as np
import torch

from counts import pfcn_pmf as counts
from harness import checks, pfcn
from harness.probe import FirstSteps
from harness.seeds import derive

# step kind → (loss, optimizer tag) as PFCNTrainer runs them
KINDS = {"filter": ("calculate_loss", "filter"), "dis": ("calculate_dis_loss", "dis")}
EPOCHS_PLANNED = 200  # a window holds some ten epochs; the plan repeats past this


class State:
    pass


def _draw(attrs, seed):
    """The trainer's draw of an epoch's subset, replayed under ``seed``."""
    rs = np.random.RandomState(seed)
    mask = np.zeros(len(attrs))
    while mask.sum() == 0:
        mask = rs.choice([0, 1], len(attrs))
    return tuple(a for a, m in zip(attrs, mask) if m != 0)


def subset_plan(attrs, sizes, seed, epochs=EPOCHS_PLANNED):
    """(subset, numpy seed) per epoch: the subset's size from ``sizes`` in
    turn, its members drawn from ``seed``, and a numpy seed under which
    the trainer's draw gives it."""
    plan = []
    for epoch in range(epochs):
        size = sizes[epoch % len(sizes)]
        options = list(itertools.combinations(attrs, size))
        rs = np.random.RandomState(derive(seed, "subset", str(epoch)))
        want = options[rs.randint(len(options))]
        base = derive(seed, "epoch", str(epoch))
        s = next(s for s in range(base, base + 100000) if _draw(attrs, s) == want)
        plan.append((want, s))
    return plan


def model_sizes(system):
    spec = system.spec
    return {"n_users": spec.n_users, "n_items": spec.n_items, "embedding_size": spec.d,
            "filter_mode": spec.filter_mode, "attributes": spec.attributes,
            "dis_hidden_size_list": spec.dis_hidden}


def setup(run):
    system = pfcn.build(run)
    trainer, model, train = system.trainer, system.model, system.train
    attrs = list(system.spec.attributes)
    plan = subset_plan(attrs, run.traffic["subset_sizes"], run.seed)
    probe = FirstSteps(model, {tag: trainer._tx_by_tag(tag) for _, tag in KINDS.values()})
    kinds = {loss_name: kind for kind, (loss_name, _) in KINDS.items()}
    kept = []
    inner_step, inner_fetch = trainer._train_step, train._next_batch_data
    fetched = []

    def first_fetch():  # the pass ends after its first batch
        if fetched:
            raise StopIteration
        fetched.append(1)
        return inner_fetch()

    def step(batch, loss_name, sst_list, optimizer):
        kept.append(({k: v.clone() for k, v in batch.items()}, kinds[loss_name],
                     tuple(sst_list)))
        probe.snapshot()
        loss = inner_step(batch, loss_name, sst_list, optimizer)
        probe.after_step(loss, optimizer)
        return loss

    trainer._train_step, train._next_batch_data = step, first_fetch
    try:
        for kind, size in run.traffic["checked_steps"]:
            loss_name, tag = KINDS[kind]
            subset = next(s for s, _ in plan if len(s) == size)
            fetched.clear()
            trainer._run_epoch(train, loss_name, subset, tag)
            train.pr = 0  # the next pass starts from the top
    finally:
        del trainer._train_step, train._next_batch_data
    state = State()
    state.system, state.kept, state.readings = system, kept, probe.finish()
    state.snapshots = probe.snapshots
    state.plan = plan
    state.epoch, state.deadline, state.current = 0, None, None
    state.drawn_off_plan = 0
    state.pass_s = []
    state.sizes = model_sizes(system)
    _instrument(run, state)
    return state


def _instrument(run, state):
    """Wrap the trainer's pass and the loader's fetch: the pass names the
    step kind and subset of the fetches inside it; a fetch after the
    deadline ends the pass."""
    trainer, train = state.system.trainer, state.system.train
    inner_pass, inner_fetch = trainer._run_epoch, train._next_batch_data

    def run_pass(train_data, loss_name="calculate_loss", sst_list=None, tx_tag="main"):
        subset = tuple(sst_list or ())
        if subset != state.plan[state.epoch % len(state.plan)][0]:
            state.drawn_off_plan += 1
        state.current = f"{tx_tag}|{','.join(subset)}"
        t0 = time.perf_counter()
        with run.rec.span(f"adversarial.{tx_tag}_pass"):
            out = inner_pass(train_data, loss_name, sst_list, tx_tag)
        state.pass_s.append(round(time.perf_counter() - t0, 3))
        return out

    def fetch():
        if time.perf_counter() >= state.deadline:
            train.pr = 0
            raise StopIteration
        with run.rec.span("loader.fetch"):
            batch = inner_fetch()
        run.work[f"steps|{state.current}|{len(batch)}"] += 1
        return batch

    trainer._run_epoch = run_pass
    train._next_batch_data = fetch


def window(run, state, seconds):
    trainer, train = state.system.trainer, state.system.train
    state.deadline = time.perf_counter() + seconds
    while time.perf_counter() < state.deadline:
        np.random.seed(state.plan[state.epoch % len(state.plan)][1])
        trainer._train_epoch(train, state.epoch)
        state.epoch += 1


def account(run, state, work):
    """Rows, steps by kind and the least time of the steps in ``work``."""
    steps = [(k.split("|"), n) for k, n in work.items() if k.startswith("steps|")]
    out = defaultdict(float)
    for (_, kind, subset, rows), n in steps:
        subset = tuple(s for s in subset.split(",") if s)
        out["rows"] += n * int(rows)
        out[f"steps.{kind}"] += n
        out["steps"] += n
        out["least_s"] += n * counts.step_s(state.sizes, int(rows), kind, subset)
    work.update(out)


def end_to_end(run, state):
    run.attempted = int(run.work["steps"])
    run.note("epochs_started", state.epoch)
    run.note("pass_seconds", state.pass_s)
    return {"train_examples_per_s": run.work["rows"] / run.window_s}


def check(run, state):
    system = state.system
    spec, labels, model_seed, weight_seed = (system.spec, system.labels, system.model_seed,
                                             system.weight_seed)
    state.system = None
    del system
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, ref = compare(state, spec, labels, model_seed, weight_seed, run.device)
    # the worst leaf swings by nature here (a 64-element BatchNorm leaf whose
    # gradient is a sum that cancels; Adam's first step turns its round-off
    # into ±lr): reported, and the median leaf compared (PERF.md)
    run.note("worst_leaf_gaps", {k: numbers.pop(k) for k in ("grad_worst", "change_worst")})
    run.note("worst_passage", numbers.pop("worst_passage"))
    numbers["subsets_off_plan"] = state.drawn_off_plan
    if run.calibrate:
        readings = {
            label: compare(state, spec, labels, model_seed, weight_seed, run.device, **kw)[0]
            for label, kw in (("control_tf32", {"precision": "tf32"}),
                              ("fault_half_batch",
                               {"rows": len(state.kept[0][0]["user_id"]) // 2}))}
        readings["own_state"] = own_state(state, spec, labels, model_seed, weight_seed,
                                          run.device)
        run.note("calibration", readings)
    run.note("checked_losses", {"program": state.readings["losses"], "reference": ref["losses"]})
    return numbers


def compare(state, spec, labels, model_seed, weight_seed, device, **kwargs):
    """The cell's numbers against the reference (float32, or as ``kwargs``
    plant it), which starts each step from the program's snapshot before it
    and checks the step's passage to the next (``harness/checks.py::
    passage_numbers``), the start included: so every stage the reference
    takes from the program is checked by itself."""
    from reference.mf_train import initial_state, train_steps

    initial = initial_state(spec, weight_seed, device)
    ref = train_steps(spec, {n: t.clone() for n, t in initial.items()}, labels, model_seed,
                      state.kept, follow=state.snapshots, **kwargs)
    numbers, _ = checks.train_numbers(state.readings, ref)
    passed, worst = checks.passage_numbers(
        state.snapshots, ref, initial, spec.lr, [n for n, _, _ in spec.params()],
        [n for n, _, _ in spec.buffers()])
    numbers.update(passed)
    numbers["worst_passage"] = worst
    return numbers, ref


def own_state(state, spec, labels, model_seed, weight_seed, device):
    """For the record, not judged: the numbers of a reference that keeps its
    own state through every step (how far two sound runs part once Adam's
    first move of a cancelling gradient has gone either way)."""
    from reference.mf_train import initial_state, train_steps

    ref = train_steps(spec, initial_state(spec, weight_seed, device), labels, model_seed,
                      state.kept)
    numbers, info = checks.train_numbers(state.readings, ref)
    numbers["losses"] = ref["losses"]
    return numbers
