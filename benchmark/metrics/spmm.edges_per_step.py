"""Entries of the propagation matrix that the program's forward hops read,
a step: the program's counter ``spmm.edges`` (``ops/spmm.py::propagate``,
every hop forward) over the slice's steps. Two full-graph hops a step read
twice the matrix's entries; a step that takes its last hop at the batch's
users only, or keeps hops across steps, reads fewer. None where the
program counts no such entries (a program without the counter)."""

from harness import program


def read(run):
    edges = program.counter("spmm.edges")
    return program.per(run, "steps", edges) if edges else None
