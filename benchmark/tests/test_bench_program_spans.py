"""The eight metrics that read the program's own spans and counters
(``harness/program.py``): each reads the right span or counter of a
planted store, over the slice's own count of its unit; each is None on an
empty store and on a program that has no tracer."""

import sys
from types import SimpleNamespace

import pytest

from harness import manifest

EVAL, RETRIEVAL, TRAIN = ("pfcn_pmf_sm-ml1m.eval_uni100", "bprmf-catalog2m.retrieval",
                          "bprmf-catalog2m.train")
MS = 1_000_000  # ns
# metric → (cell, its reading of the planted store)
READINGS = {
    "evaluator.slowest_metric_ms": (EVAL, 3.0),
    "sampler.draw_ms": (EVAL, 4.0),
    "trainer.eval_dispatch_ms": (EVAL, 2 * 2.0),
    "trainer.drain_ms": (EVAL, 6.0),
    "trainer.valid_self_ms": (EVAL, 5.0),
    "eval.host_syncs": (EVAL, 28.0),
    "topk.host_us": (RETRIEVAL, 250.0),
    "trainer.step_host_ms": (TRAIN, 1.5),
}
SLICE_WORK = {EVAL: {"validations": 2}, RETRIEVAL: {"requests": 3}, TRAIN: {"steps": 4}}


class _Clock:
    """``time.time_ns`` that moves only when the test moves it."""

    def __init__(self):
        self.now = 0

    def time_ns(self):
        return self.now

    def tick(self, ns):
        self.now += ns


@pytest.fixture
def tracing(monkeypatch):
    from recbole_fairrec_tpu_torch.utils import tracing

    clock = _Clock()
    monkeypatch.setattr(tracing, "time", clock)
    tracing.disable()
    tracing.reset()
    tracing.clock = clock
    yield tracing
    tracing.disable()
    tracing.reset()
    del tracing.clock


def _plant(tracing):
    """Two validations, three top-k calls and four train steps."""
    tick, span = tracing.clock.tick, tracing.span
    tracing.enable()
    for _ in range(2):
        with span("trainer.valid"):
            tick(5 * MS)  # no child names this
            with span("dataloader.sampled_fetch"):
                tick(1 * MS)
                with span("sampler.draw"):
                    tick(4 * MS)
            for _ in range(2):
                with span("trainer.collect_batch"):
                    tick(2 * MS)
            with span("trainer.drain"):
                tick(6 * MS)
            with span("evaluator.run"):
                for metric, ms in (("ndcg", 1), ("giniindex", 3)):
                    with span("evaluator.metric") as sp:
                        sp.set("metric", metric)
                        tick(ms * MS)
        tracing.count("host_syncs", 28)
    for _ in range(3):
        with span("topk.select"):
            tick(150_000)
            with span("fused_topk.launch"):
                tick(100_000)
    for _ in range(4):
        with span("trainer.step"):
            tick(1_500_000)
    tracing.disable()


def _read(metric, cell, slice_work):
    reader = manifest.load_cell(cell).reader(metric)
    return reader.read(SimpleNamespace(slice_work=slice_work))


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reads_the_planted_store(tracing, metric):
    cell, want = READINGS[metric]
    _plant(tracing)
    assert _read(metric, cell, SLICE_WORK[cell]) == pytest.approx(want, rel=1e-12)
    assert _read(metric, cell, {}) is None  # no unit of work in the slice


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_silent_on_an_empty_store(tracing, metric):
    cell, _ = READINGS[metric]
    assert _read(metric, cell, SLICE_WORK[cell]) is None


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_silent_on_a_program_without_the_tracer(tracing, metric, monkeypatch):
    cell, _ = READINGS[metric]
    _plant(tracing)
    import recbole_fairrec_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "recbole_fairrec_tpu_torch.utils.tracing", None)
    assert _read(metric, cell, SLICE_WORK[cell]) is None


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_the_manifest_lists_the_metric_for_its_cell(metric):
    cell, _ = READINGS[metric]
    assert metric in [m["name"] for m in manifest.load_cell(cell).per_layer]
