"""The spans and the counter of FairGo's finetune (``ops/spmm.py::propagate``,
``models/fairgo_base.py``): under the tracer a step records
``spmm.propagate`` at each forward hop (attrs ``path``, ``edges``, ``d``),
``fairgo.filters`` around the filters over the whole table and
``fairgo.dis_loss`` around the discriminator loss, nested in
``trainer.step``; the counter ``spmm.edges`` adds the matrix's entries at
every forward hop, ``spmm.csr_edges`` those of the hops through the CSR
pair, ``spmm.backward_edges`` those of every backward hop (a filter step's
two), and a discriminator step's lookup of the kept hops counts
``fairgo.hop_cache_misses`` (a fresh model's first). Through the sparse (CSR) and the dense propagation, for both step
kinds; off, nothing is recorded; under a profiler the spans are its
annotations too."""

import pytest
from torch.profiler import ProfilerActivity, profile

from recbole_fairrec_tpu_torch.utils import tracing
from test_torch_fairgo_reference import KINDS, N_ITEMS, N_USERS, World

SUBSET = ("gender", "age")


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(str(tmp_path_factory.mktemp("fairgo_tracing")))


def _step(world, dense, kind):
    trainer = world.port(dense, trainer=True)
    loss_name, tx = KINDS[kind]
    trainer._train_step(world.batch(), loss_name, SUBSET, getattr(trainer, tx))
    return trainer


@pytest.mark.parametrize("dense", [False, True], ids=["coo", "dense"])
@pytest.mark.parametrize("kind", ["filter", "dis"])
def test_a_step_records_the_spans_and_the_edge_counter(world, dense, kind):
    tracing.enable()
    trainer = _step(world, dense, kind)
    entries = int(trainer.model.norm_rows.numel())
    assert entries == 2 * len(world.data.users)
    recs = tracing.records()
    names = [r.name for r in recs]
    assert names.count("trainer.step") == 1
    assert names.count("fairgo.filters") == 1 and names.count("fairgo.dis_loss") == 1
    hops = [r for r in recs if r.name == "spmm.propagate"]
    assert len(hops) == 2
    for hop in hops:
        assert hop.attrs == {"path": "dense" if dense else "csr", "edges": entries, "d": 8}
        assert recs[hop.parent].name == "fairgo.dis_loss"
    (filters,) = [r for r in recs if r.name == "fairgo.filters"]
    assert filters.attrs == {"filters": len(SUBSET), "rows": N_USERS + N_ITEMS}
    for r in recs:
        if r.name in ("fairgo.filters", "fairgo.dis_loss"):
            assert recs[r.parent].name == "trainer.step"
    # a filter step backprops through both hops; a discriminator step's miss computes
    # them without grad
    assert tracing.counters() == {"spmm.edges": 2 * entries,
                                  **({} if dense else {"spmm.csr_edges": 2 * entries}),
                                  **({"fairgo.hop_cache_misses": 1} if kind == "dis" else
                                     {"spmm.backward_edges": 2 * entries})}
    summary = tracing.summary()
    assert summary["spmm.propagate"]["count"] == 2
    assert all(r.end_ns >= r.start_ns for r in recs)


@pytest.mark.parametrize("dense", [False, True], ids=["coo", "dense"])
def test_nothing_is_recorded_while_tracing_is_off(world, dense):
    _step(world, dense, "filter")
    _step(world, dense, "dis")
    assert tracing.records() == [] and tracing.counters() == {}


def test_under_a_profiler_the_spans_are_its_annotations(world):
    trainer = world.port(False, trainer=True)
    batch = world.batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer._train_step(batch, "calculate_dis_loss", SUBSET, trainer.tx_dis)
    names = [e.name for e in prof.events()]
    for span in ("spmm.propagate", "fairgo.filters", "fairgo.dis_loss"):
        assert span in names, span
    assert names.count("spmm.propagate") == 2
    assert tracing.counters()["spmm.edges"] == 2 * int(trainer.model.norm_rows.numel())
