"""One run of one cell: set-up, the measured window, the profiler slice of a
``--trace 1`` run, the comparison that decides ``correct``, and the result.

A driver (``drivers/<name>.py``) provides:

* ``setup(run) -> state``: builds the system under test from the seed,
  warms up every shape the traffic uses and, for training, takes the first
  steps that the comparison follows;
* ``window(run, state, seconds)``: drives the traffic for ``seconds``,
  adding the work it completed to ``run.work``; called for the window and,
  in a traced run, again for the profiler slice;
* ``account(run, state, work)`` (optional): derived counts (rows, steps,
  least times) from the raw tallies of a window or slice, outside its time;
* ``end_to_end(run, state) -> {metric: value}`` over the window;
* ``check(run, state) -> {number: value}``: frees the program's state and
  compares its outputs with the plain reference.
"""

from __future__ import annotations

import math
import sys
import time
from collections import defaultdict

from . import checks, trace
from .device import describe


class Run:
    """What a driver and the metric readers see of one run."""

    def __init__(self, cell, seed, seconds, trace_on, device, work_dir):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace = trace_on
        self.device = device
        self.work_dir = work_dir
        self.rec = trace.Recorder(trace_on)
        self.work = defaultdict(float)
        self.window_s = None
        self.profile = None
        self.slice_work = None
        self.attempted = 0
        self.failed = 0
        self.notes = {}
        self.calibrate = False

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic

    def note(self, key, value):
        """A line for standard error (not a metric)."""
        self.notes[key] = value


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def execute(cell, seed, seconds, trace_on, device, work_dir, t_start, calibrate=False):
    """Run ``cell`` once; returns the result line's object (without the
    check of loaded modules, which the caller makes). ``calibrate`` adds the
    readings of the control and the planted faults to the notes."""
    driver = cell.driver()
    run = Run(cell, seed, seconds, trace_on, device, work_dir)
    run.calibrate = calibrate
    state = driver.setup(run)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    driver.window(run, state, seconds)
    _sync(device)
    run.window_s = time.perf_counter() - t0
    account = getattr(driver, "account", None)
    if account is not None:
        account(run, state, run.work)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = dict(driver.end_to_end(run, state))
    values["setup_s"] = setup_s
    metrics = {}
    if trace_on:
        window_work, window_spans = run.work, run.rec.spans
        run.work, run.rec.spans = defaultdict(float), defaultdict(list)
        span_names = set(window_spans)
        run.profile = trace.profile_slice(
            lambda: driver.window(run, state, cell.traffic["trace_seconds"]),
            span_names | set(cell.traffic.get("span_names", ())), lambda: _sync(device))
        if account is not None:
            account(run, state, run.work)
        run.slice_work = run.work
        run.work, run.rec.spans = window_work, window_spans
        run.note("slice_work", {k: v for k, v in run.slice_work.items() if "|" not in k})
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    dev = describe(device, cell.chips)
    if trace_on:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
    numbers = driver.check(run, state)
    correct, checked = checks.judge(numbers, cell.limits)
    for key, value in sorted(run.notes.items()):
        print(f"note {key}: {value}", file=sys.stderr, flush=True)
    for name, m in metrics.items():
        print(f"metric {name}: {m['value']!r} {m['unit']}", file=sys.stderr, flush=True)
    if trace_on:
        print(f"window {run.window_s!r} s; setup {setup_s!r} s", file=sys.stderr, flush=True)
    result = {"correct": bool(correct and run.failed == 0), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace_on:
        result["breakdown"] = run.profile["breakdown"]
    if calibrate:
        result["calibration"] = run.notes.get("calibration")
    result["checks"] = checked
    bad = [n for n, m in metrics.items() if not math.isfinite(m["value"])]
    if bad:
        result["correct"] = False
        print(f"metrics not finite: {bad}", file=sys.stderr, flush=True)
    return result
