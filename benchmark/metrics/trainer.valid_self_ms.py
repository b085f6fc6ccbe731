"""Host time of a validation that none of its layers' spans names: the
program's ``trainer.valid`` span (``_valid_epoch``) less its children (the
fetches, the scoring dispatch, the drain, the evaluator), in ms a
validation."""

from harness import program


def read(run):
    return program.per(run, "validations", program.span_seconds("trainer.valid"), 1e3)
