"""Device-to-host reads a validation makes: the program's ``host_syncs``
counter over the profiler slice (each a wait for the card), a
validation."""

from harness import program


def read(run):
    return program.per(run, "validations", program.counter("host_syncs"))
