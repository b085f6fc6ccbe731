"""Share of the forward hops' entries that went through the CSR kernel:
100 × the program's counter ``spmm.csr_edges`` (``ops/spmm.py::propagate``,
the hops through the matrix's CSR form) over its ``spmm.edges`` (every
forward hop) over the slice, in %. None where the program counts no such
entries (a program without the CSR path, or a slice without a hop)."""

from harness import program


def read(run):
    edges = program.counter("spmm.edges")
    if not edges:
        return None
    tracing = program._tracer()
    csr = tracing.counters().get("spmm.csr_edges") if tracing is not None else None
    return None if csr is None else 100.0 * csr / edges
