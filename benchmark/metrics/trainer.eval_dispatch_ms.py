"""Host time a validation spends launching its scoring: the program's
``trainer.collect_batch`` spans (one macro batch × one attribute subset
through ``Trainer._collect_batch``), self time in ms a validation."""

from harness import program


def read(run):
    return program.per(run, "validations", program.span_seconds("trainer.collect_batch"), 1e3)
