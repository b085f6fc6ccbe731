"""The program's own spans and counters, as the per-layer metrics read them.

The port's tracer (``recbole_fairrec_tpu_torch/utils/tracing.py``) records
only while a profiler session is active, so in a ``--trace 1`` run its
store holds the profiler slice alone: the untraced window and the set-up
add nothing. A metric divides what the slice recorded by the slice's own
counts (``run.slice_work``). A program without the tracer, or a store that
holds no span, gives None: the metric is then left out of the result line.
"""

from __future__ import annotations


def _tracer():
    try:
        from recbole_fairrec_tpu_torch.utils import tracing
    except ImportError:  # a program from before the tracer
        return None
    return tracing if tracing.records() else None


def span_seconds(name, stat="self_s", by=None):
    """Seconds of the spans ``name`` in the store (``stat``: ``self_s`` or
    ``total_s``); with ``by``, a dict attr value → seconds of the spans
    that carry that attr. None where the tracer or such spans are
    missing."""
    tracing = _tracer()
    if tracing is None:
        return None
    summary = tracing.summary(by=by)
    if by is None:
        return summary[name][stat] if name in summary else None
    out = {key[1]: v[stat] for key, v in summary.items()
           if isinstance(key, tuple) and key[0] == name}
    return out or None


def counter(name):
    """The counter ``name`` of the store (0 where nothing counted it), or
    None without a tracer or spans."""
    tracing = _tracer()
    if tracing is None:
        return None
    return tracing.counters().get(name, 0)


def per(run, unit, value, scale=1.0):
    """``value`` × ``scale`` per ``unit`` of the slice's work (validations,
    requests, steps), or None."""
    n = (run.slice_work or {}).get(unit, 0)
    if value is None or not n:
        return None
    return scale * value / n
