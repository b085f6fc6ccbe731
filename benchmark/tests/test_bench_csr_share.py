"""``spmm.csr_edge_share``: the program's counter ``spmm.csr_edges`` over its
``spmm.edges``, in %, from a planted store; None where the program counted
no hop, where it has no such counter (a program without the CSR path) and
where it has no tracer."""

import sys

import pytest

from harness import manifest

CELL = "fairgo_pmf-lastfm360k.finetune"
METRIC = "spmm.csr_edge_share"


@pytest.fixture
def tracing():
    from recbole_fairrec_tpu_torch.utils import tracing

    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


def _read():
    return manifest.load_cell(CELL).reader(METRIC).read(None)


def _plant(tracing, counts):
    tracing.enable()
    with tracing.span("finetune.step"):
        for name, n in counts:
            tracing.count(name, n)
    tracing.disable()


@pytest.mark.parametrize("counts,want", [
    ([("spmm.edges", 100), ("spmm.csr_edges", 100)], 100.0),
    ([("spmm.edges", 100), ("spmm.edges", 100), ("spmm.csr_edges", 100)], 50.0),
])
def test_reads_the_planted_counters(tracing, counts, want):
    _plant(tracing, counts)
    assert _read() == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("counts", [
    [("spmm.edges", 100)],  # the parent: every hop through the COO arrays
    [("host_syncs", 1)],  # no hop in the slice
])
def test_silent_without_the_counters(tracing, counts):
    _plant(tracing, counts)
    assert _read() is None


def test_silent_on_a_program_without_the_tracer(tracing, monkeypatch):
    _plant(tracing, [("spmm.edges", 100), ("spmm.csr_edges", 100)])
    import recbole_fairrec_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "recbole_fairrec_tpu_torch.utils.tracing", None)
    assert _read() is None


def test_the_manifest_lists_the_metric_for_its_cell():
    assert METRIC in [m["name"] for m in manifest.load_cell(CELL).per_layer]
