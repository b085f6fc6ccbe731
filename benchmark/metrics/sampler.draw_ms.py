"""Host time a validation spends in the uni100 sampler's per-user draws
alone (the program's ``sampler.draw`` span inside the loader's fetch,
without the skeleton and the assembly of the batch), self time in ms a
validation."""

from harness import program


def read(run):
    return program.per(run, "validations", program.span_seconds("sampler.draw"), 1e3)
