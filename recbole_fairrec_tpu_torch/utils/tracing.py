"""Spans and counters of the port's layers, on the profiler's clock.

A span is a named interval of host work at a layer boundary (a validation,
a train pass or step, a loader fetch, a top-k call); a counter adds up what
a layer did (host syncs, rows drawn). Both are recorded only while tracing
is on: while a ``torch.profiler`` session is active (a ``profile_dir``
epoch trace, a benchmark's profiler slice) or after :func:`enable`. Off, a
span site costs one check of that state and hands back a shared no-op: it
enters no profiler annotation, allocates no record and stores nothing.

A span recorded under a profiler session also enters it as a user
annotation of the same name, as ``record_function`` makes one, but through
its C binding rather than a dispatcher op: the cheaper call keeps the
stamps close to the annotation's own (after :func:`enable` alone none is
entered: no profiler would read it). Every recorded span
stamps its start and end with ``time.time_ns()``, the clock of the
profiler's host events (nanoseconds since the Unix epoch), so spans and
the device's kernels share one timeline; the stamps fall inside the
annotation. A span never synchronises the device, reads no tensor and
draws no random number.

Each record holds its name, start and end, the index of its parent span
(-1 for none), the index of its root span (the one that began the unit of
work: a validation, a train pass, a top-k call) and a small ``attrs`` dict.
Records stay in memory, at most ``MAX_SPANS`` of them until
:func:`reset`; spans beyond that are counted in ``dropped``. The store is
one per process, as the profiler is, and its spans nest in the order they
open and close: the traced paths run on one thread.

Reading: :func:`records` (the raw records), :func:`summary` (per name: the
count, total and self seconds, where self time is the duration less what
the span's children cover), :func:`counters` and :func:`dropped`.

Device-to-host reads of the traced paths go through :func:`to_host`, which
counts ``host_syncs``.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict

import torch

MAX_SPANS = 1 << 20

# True while a profiler session is active (~0.1-0.2 us a call)
_profiler_enabled = torch._C._autograd._profiler_enabled
# a user annotation in the profiler's events: enter(name) -> handle, exit(handle)
_annotate_enter = torch._C._autograd._record_function_with_args_enter
_annotate_exit = torch._C._autograd._record_function_with_args_exit


class Record:
    """One span: ``name``, ``start_ns`` / ``end_ns`` (the profiler's clock;
    ``end_ns`` is None while it is open), ``parent`` and ``root`` (record
    indices; ``parent`` -1 for a root), ``attrs``."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "root", "attrs")

    def __init__(self, name, start_ns, parent, root, attrs):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.root, self.attrs = parent, root, attrs


class _Store:
    def __init__(self):
        self.enabled = False
        self.records = []
        self.counters = defaultdict(int)
        self.dropped = 0
        self.open = []  # (index, record) of the spans open now, innermost last


_STORE = _Store()


def enable():
    """Record spans and counters without a profiler session, until
    :func:`disable` (annotations still enter a profiler that runs)."""
    _STORE.enabled = True


def disable():
    """Undo :func:`enable` (a profiler session still turns tracing on)."""
    _STORE.enabled = False


def reset():
    """Drop every record, counter and the ``dropped`` count."""
    _STORE.records = []
    _STORE.counters = defaultdict(int)
    _STORE.dropped = 0
    _STORE.open = []


class _NullSpan:
    """What a span site gets while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, key, value):
        pass


NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "record", "annotation")

    def __init__(self, name):
        self.name = name
        self.attrs = {}
        self.record = None
        self.annotation = None

    def __enter__(self):
        store = _STORE
        if len(store.records) >= MAX_SPANS:
            store.dropped += 1
            return self
        index = len(store.records)
        if store.open:
            parent, parent_rec = store.open[-1]
            root = parent_rec.root
        else:
            parent, root = -1, index
        if _profiler_enabled():  # no profiler, no one to read an annotation
            self.annotation = _annotate_enter(self.name)
        self.record = Record(self.name, time.time_ns(), parent, root, self.attrs)
        store.records.append(self.record)
        store.open.append((index, self.record))
        return self

    def __exit__(self, *exc):
        record = self.record
        if record is None:
            return False
        record.end_ns = time.time_ns()
        if self.annotation is not None:
            _annotate_exit(self.annotation)
        opened = _STORE.open
        if opened and opened[-1][1] is record:  # not if a reset came in between
            opened.pop()
        return False

    def __bool__(self):
        return True

    def set(self, key, value):
        """Attach ``attrs[key] = value`` (a host value; never a tensor's
        contents, which would wait for the device)."""
        self.attrs[key] = value


def span(name):
    """``with span(name) as sp:`` records the block as the span ``name``
    while tracing is on (``sp.set(key, value)`` attaches an attr; ``sp`` is
    falsy while off, so costly attrs can be skipped)."""
    if not (_STORE.enabled or _profiler_enabled()):
        return NULL
    return _Span(name)


def traced(name):
    """Decorator: every call of the function is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (_STORE.enabled or _profiler_enabled()):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _STORE.enabled or _profiler_enabled():
        _STORE.counters[name] += n


def to_host(tensor):
    """``tensor.cpu()``, counted as one ``host_syncs``: the traced paths read
    their device results through here (on a card each read waits for it)."""
    if _STORE.enabled or _profiler_enabled():
        _STORE.counters["host_syncs"] += 1
    return tensor.cpu()


def records():
    """The records, in the order their spans opened (a copy of the list)."""
    return list(_STORE.records)


def counters():
    """Counter name → total."""
    return dict(_STORE.counters)


def dropped():
    """Spans not recorded because the store held ``MAX_SPANS``."""
    return _STORE.dropped


def summary(by=None):
    """Closed spans per name: ``{"count", "total_s", "self_s"}``. Self time
    is the span's duration less the durations of its children (spans of
    one thread nest, so children do not overlap). With ``by``, a span whose
    attrs hold that key goes under ``(name, attrs[by])`` instead."""
    recs = _STORE.records
    covered = [0] * len(recs)
    for rec in recs:
        if rec.parent >= 0 and rec.end_ns is not None:
            covered[rec.parent] += rec.end_ns - rec.start_ns
    out = {}
    for rec, cover in zip(recs, covered):
        if rec.end_ns is None:
            continue
        key = rec.name
        if by is not None and by in rec.attrs:
            key = (rec.name, rec.attrs[by])
        stat = out.setdefault(key, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        duration = rec.end_ns - rec.start_ns
        stat["count"] += 1
        stat["total_s"] += duration / 1e9
        stat["self_s"] += (duration - cover) / 1e9
    return out
