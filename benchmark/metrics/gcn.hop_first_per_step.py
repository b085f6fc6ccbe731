"""Convolutions of the GCN that run their hop before their weight, a step:
the program's counter ``gcn.hop_first`` (``models/gcn.py``: a convolution
that widens, d_out over d_in, computes (Â x) W, so its hop runs at the
narrower d_in) over the slice's steps. FairGo_GCN's 64 → 32 → 64 reads 1.
None where the program counts no such convolution (a program without the
counter)."""

from harness import program


def read(run):
    hop_first = program.counter("gcn.hop_first")
    return program.per(run, "steps", hop_first) if hop_first else None
