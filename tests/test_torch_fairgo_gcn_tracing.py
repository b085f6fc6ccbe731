"""The spans and counters of FairGo_GCN's pretrain (``models/gcn.py``,
``ops/spmm.py``, ``ops/spmm_csr.py``): under the tracer a pretrain step
records ``gcn.conv`` around each convolution (attrs ``layer``, ``d_in``,
``d_out``, ``hop_d``, ``rows``, ``dropout``), nested in ``trainer.step``,
with the convolution's ``spmm.propagate`` inside it, both hops at the
hidden width (the second convolution widens, so it hops first and counts
``gcn.hop_first``); ``spmm.edges`` counts the entries of Â at each forward
hop and ``spmm.backward_edges`` at each backward hop. Through the sparse
(CSR) and
the dense propagation, with a profiler in place of ``tracing.enable``
too; off, nothing is recorded."""

import pytest
from torch.profiler import ProfilerActivity, profile

from recbole_fairrec_tpu_torch.utils import tracing
from test_torch_fairgo_gcn_reference import D, HIDDEN, N_ITEMS, N_USERS, World


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(str(tmp_path_factory.mktemp("fairgo_gcn_tracing")))


def _step(world, dense):
    trainer = world.port(dense, 0.2, trainer=True)
    trainer._train_step(world.batch(), "calculate_loss", None, trainer.tx_pretrain)
    return trainer


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
@pytest.mark.parametrize("under", ["tracer", "profiler"])
def test_a_pretrain_step_records_the_convolutions_and_both_edge_counters(world, dense, under):
    if under == "tracer":
        tracing.enable()
        trainer = _step(world, dense)
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            trainer = _step(world, dense)
        assert [e.name for e in prof.events()].count("gcn.conv") == 2
    n = N_USERS + N_ITEMS
    entries = int(trainer.model.gcn_rows.numel())
    assert entries == 2 * len(world.data.users) + n  # both directions and a self loop a node
    recs = tracing.records()
    convs = [r for r in recs if r.name == "gcn.conv"]
    assert [c.attrs for c in convs] == [
        {"layer": 0, "d_in": D, "d_out": HIDDEN, "hop_d": HIDDEN, "rows": n, "dropout": 0.2},
        {"layer": 1, "d_in": HIDDEN, "d_out": D, "hop_d": HIDDEN, "rows": n, "dropout": 0.0}]
    assert all(recs[c.parent].name == "trainer.step" for c in convs)
    hops = [r for r in recs if r.name == "spmm.propagate"]
    assert [recs[h.parent] for h in hops] == convs
    assert [h.attrs for h in hops] == [{"path": "dense" if dense else "csr", "edges": entries,
                                        "d": HIDDEN} for _ in convs]
    assert tracing.counters() == {"gcn.hop_first": 1, "spmm.edges": 2 * entries,
                                  "spmm.backward_edges": 2 * entries,
                                  **({} if dense else {"spmm.csr_edges": 2 * entries})}


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
def test_nothing_is_recorded_while_tracing_is_off(world, dense):
    _step(world, dense)
    assert tracing.records() == [] and tracing.counters() == {}
