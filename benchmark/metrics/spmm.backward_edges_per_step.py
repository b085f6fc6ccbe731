"""Entries of the propagation matrix that the program's backward hops read,
a step: the program's counter ``spmm.backward_edges`` (``ops/spmm_csr.py::
CsrHop.backward``, ``ops/spmm.py::_Propagate.backward``: every hop that
autograd runs backward) over the slice's steps. A pretrain step backprops
through both convolutions' hops: twice Â's entries. None where the program
counts no such entries (a program without the counter)."""

from harness import program


def read(run):
    edges = program.counter("spmm.backward_edges")
    return program.per(run, "steps", edges) if edges else None
