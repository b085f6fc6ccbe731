"""Host time a validation spends draining its scoring: the program's
``trainer.drain`` span (``Trainer._drain_collect``: the payloads' copies to
the host, which wait for the device, and the collector), self time in ms a
validation."""

from harness import program


def read(run):
    return program.per(run, "validations", program.span_seconds("trainer.drain"), 1e3)
