"""``gcn.hop_first_per_step``: the program's counter ``gcn.hop_first`` over
the slice's steps. From a planted store: None where the store is empty,
where the program has no such counter (a program that runs every
convolution's weight first) and where it has no tracer. On the cell run
traced at a tiny size (FairGo_GCN's 64 -> 32 -> 64): 1 a step, through the
CSR and the dense propagation."""

import sys
from types import SimpleNamespace

import pytest

from harness import manifest

CELL = "fairgo_gcn-lastfm360k.pretrain"
METRIC = "gcn.hop_first_per_step"
BIG = 2**31 + 77


@pytest.fixture
def tracing():
    from recbole_fairrec_tpu_torch.utils import tracing

    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


def _read(run):
    return manifest.load_cell(CELL).reader(METRIC).read(run)


def _plant(tracing, counts):
    tracing.enable()
    with tracing.span("trainer.step"):
        for name, n in counts:
            tracing.count(name, n)
    tracing.disable()


@pytest.mark.parametrize("counts,steps,want", [
    ([("gcn.hop_first", 4)], 4, 1.0),
    ([("gcn.hop_first", 3), ("gcn.hop_first", 3)], 3, 2.0),
])
def test_reads_the_planted_counter_per_step(tracing, counts, steps, want):
    _plant(tracing, counts)
    assert _read(SimpleNamespace(slice_work={"steps": steps})) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("counts", [
    None,  # an empty store
    [("spmm.edges", 100), ("spmm.backward_edges", 100)],  # the parent: the weight first
])
def test_silent_without_the_counter(tracing, counts):
    if counts is not None:
        _plant(tracing, counts)
    assert _read(SimpleNamespace(slice_work={"steps": 4})) is None


def test_silent_without_steps(tracing):
    _plant(tracing, [("gcn.hop_first", 4)])
    assert _read(SimpleNamespace(slice_work={})) is None


def test_silent_on_a_program_without_the_tracer(tracing, monkeypatch):
    _plant(tracing, [("gcn.hop_first", 4)])
    import recbole_fairrec_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "recbole_fairrec_tpu_torch.utils.tracing", None)
    assert _read(SimpleNamespace(slice_work={"steps": 4})) is None


def test_the_manifest_lists_the_metric_for_its_cell_alone():
    entry = next(m for m in manifest.load_cell(CELL).per_layer if m["name"] == METRIC)
    assert entry["workloads"] == [CELL] and entry["moves"] == "train_examples_per_s"
    assert entry["source"] == "program_counter"


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
def test_a_tiny_traced_slice_reads_one_a_step(execute, tracing, dense):
    cell = manifest.load_cell(CELL)
    cell.config["graph"].update({"n_users": 301, "n_items": 401, "n_rows": 300 * 48 + 123})
    cell.config["train_batch_size"] = 256
    cell.config["settings"]["dense_propagation"] = dense
    cell.traffic["trace_seconds"] = 0.5
    traced = execute(cell, BIG, seconds=0.5, trace=True)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"][METRIC]["value"] == pytest.approx(1.0, rel=1e-12)
