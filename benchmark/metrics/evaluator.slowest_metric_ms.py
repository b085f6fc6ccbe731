"""Host time a validation spends in the costliest of the twelve metrics:
the program's ``evaluator.metric`` spans (one per metric's
``calculate_metric`` in ``Evaluator.evaluate``), self time summed per
metric over the profiler slice, the largest of them, in ms a validation."""

from harness import program


def read(run):
    by_metric = program.span_seconds("evaluator.metric", by="metric")
    if not by_metric:
        return None
    return program.per(run, "validations", max(by_metric.values()), 1e3)
