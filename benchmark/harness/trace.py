"""Spans around the calls into the program's layers, and the profiler slice.

The program has no spans of its own yet, so the benchmark times each layer
from outside: a span is the host clock around a call the benchmark makes or
wraps (a trainer pass, a loader fetch, the evaluator). Spans are recorded
only in a ``--trace 1`` run; they also enter the profiler's timeline as
annotations, which name the host's work in the idle gaps of the device.

The profiler slice runs more of the cell's work under ``torch.profiler``
after the measured window has closed: the device's busy time (the union of
its kernels, copies and fills, without annotations), the kernels' time by
name, and the longest idle gaps by the span the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

TOP = 10


class Recorder:
    """Spans: name → list of seconds."""

    def __init__(self, on):
        self.on = on
        self.spans = defaultdict(list)
        self._annotate = None

    @contextlib.contextmanager
    def span(self, name):
        if not self.on:
            yield
            return
        if self._annotate is None:
            from torch.profiler import record_function

            self._annotate = record_function
        t0 = time.perf_counter()
        with self._annotate(name):
            try:
                yield
            finally:
                self.spans[name].append(time.perf_counter() - t0)

    def wrap(self, obj, attr, name):
        """Time every call of ``obj.attr`` (a bound method, replaced on the
        instance) as the span ``name``; a no-op when spans are off."""
        if not self.on:
            return
        inner = getattr(obj, attr)

        def timed(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, attr, timed)

    def total(self, name):
        return sum(self.spans.get(name, ()))


def _device_events(prof):
    """(start_ns, end_ns, name) of every device event that is work: kernels,
    copies and fills, not annotations."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.is_user_annotation():
            continue
        start = ev.start_ns()
        out.append((start, start + ev.duration_ns(), ev.name()))
    return sorted(out)


def _host_spans(prof, names):
    """(start_ns, end_ns, name) of the host annotations named in ``names``."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU and ev.name() in names:
            start = ev.start_ns()
            out.append((start, start + ev.duration_ns(), ev.name()))
    return sorted(out)


def _union(intervals):
    merged = []
    for s, e, _ in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(by_name, t):
    """The innermost host span that holds the instant ``t``: of the spans
    of each name (one name's spans do not overlap), the one that started
    last before ``t``, if it holds ``t``; the latest start among those."""
    best, best_start = "outside the benchmark's spans", None
    for name, (starts, ends) in by_name.items():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ends[i] >= t and (best_start is None or starts[i] > best_start):
            best, best_start = name, starts[i]
    return best


def profile_slice(run_work, span_names, sync):
    """Run ``run_work()`` under the profiler, ``sync()`` before and after.
    Returns ``{"busy_s", "window_s", "kernels" (name → seconds),
    "breakdown"}``."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_work()
        sync()
        window_s = time.perf_counter() - t0
    events = _device_events(prof)
    merged = _union(events)
    busy_s = sum(e - s for s, e in merged) / 1e9
    kernels = defaultdict(float)
    for s, e, name in events:
        kernels[name] += (e - s) / 1e9
    by_name = {}
    for start, end, name in _host_spans(prof, set(span_names)):
        starts, ends = by_name.setdefault(name, ([], []))
        starts.append(start)
        ends.append(end)
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gaps[_label(by_name, (e0 + s1) // 2)] += (s1 - e0) / 1e9
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": dict(kernels),
        "breakdown": {"device_ops": [[n[:200], s] for n, s in top_ops],
                      "idle_gaps": [[n, s] for n, s in top_gaps]},
    }


def kernel_seconds(profile, *fragments):
    """Device seconds of the kernels whose names hold any of ``fragments``
    (case-insensitive)."""
    frags = [f.lower() for f in fragments]
    return sum(s for name, s in profile["kernels"].items()
               if any(f in name.lower() for f in frags))
