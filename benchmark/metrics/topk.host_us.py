"""Host time of a request inside the program's top-k entry point: the
``topk.select`` span of ``ops/topk.py::certified_topk_scores`` (argument
checks, the scratch allocation, the kernel's launch; the device's work is
not waited for), its whole duration in us a request."""

from harness import program


def read(run):
    return program.per(run, "requests", program.span_seconds("topk.select", "total_s"), 1e6)
