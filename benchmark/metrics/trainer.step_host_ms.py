"""Host time to issue one train step: the program's ``trainer.step`` span
(``Trainer._train_step``: the loss, ``autograd.grad``, the optimizer; the
device runs behind it), its whole duration in ms a step."""

from harness import program


def read(run):
    return program.per(run, "steps", program.span_seconds("trainer.step", "total_s"), 1e3)
