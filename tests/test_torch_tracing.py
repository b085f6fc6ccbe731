"""The port's tracer (``utils/tracing.py``): off it records nothing and
builds no profiler annotation; on, its spans nest, share the profiler's
clock and leave every result bit for bit as it was; its counters count what
a validation did; no program span takes a name the benchmark's own spans
use; the store is capped."""

import gc
import glob
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
from recbole_fairrec_tpu_torch.ops import fused_topk, topk
from recbole_fairrec_tpu_torch.trainer import Trainer
from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTRS = ["gender", "age"]
# span → the span its parent is, in a PFCN validation and a train pass
PARENTS = {
    "trainer.valid": None,
    "dataloader.sampled_fetch": "trainer.valid",
    "sampler.draw": "dataloader.sampled_fetch",
    "trainer.collect_batch": "trainer.valid",
    "trainer.drain": "trainer.valid",
    "evaluator.run": "trainer.valid",
    "evaluator.metric": "evaluator.run",
    "trainer.pass": None,
    "trainer.step": "trainer.pass",
    "dataloader.train_fetch": "trainer.pass",
}
PROGRAM_SPANS = set(PARENTS) | {"topk.select", "fused_topk.launch", "spmm.propagate",
                                 "fairgo.filters", "fairgo.dis_loss", "gcn.conv"}
# the device-to-host reads of one sampled collect, by the resource each carries
PAYLOAD_READS = ("rec.items", "rec.topk", "rec.positive_score", "rec.negative_score")


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tracing"))
    chip_smoke.write_dataset(root, n_users=60, n_items=80, n_inter=1500,
                             name=chip_smoke.ADV_DATASET, attributes=True)
    return root


def _system(root):
    """PFCN_PMF ``sm`` over gender and age with its published protocol
    (uni100, top 5, the 12 metrics), built as ``run_recbole`` builds it."""
    cfg = chip_smoke.published_config(root, root, "PFCN_PMF", {
        "use_gpu": False, "filter_mode": "sm", "sst_attr_list": ATTRS, "epochs": 1,
        "save_dataset": False, "train_batch_size": 512})
    config = Config(model="PFCN_PMF", dataset=chip_smoke.ADV_DATASET, config_dict=cfg)
    init_seed(config["seed"], config["reproducibility"])
    train, valid, _ = data_preparation(config, create_dataset(config))
    generator = init_seed(config["seed"], config["reproducibility"])
    model = get_model("PFCN_PMF")(config, train.dataset, generator=generator)
    trainer = get_trainer(config["MODEL_TYPE"], "PFCN_PMF")(config, model)
    trainer.eval_collector.data_collect(train)
    return trainer, train, valid


def _validate_and_train(trainer, train, valid):
    """One validation, then epoch 0's filter and discriminator passes."""
    _, result = trainer._valid_epoch(valid)
    losses = trainer._train_epoch(train, 0)
    return result, losses


@pytest.fixture(scope="module")
def traced_records(data_root):
    """The records of one traced validation and train pass."""
    tracing.reset()
    tracing.enable()
    try:
        _validate_and_train(*_system(data_root))
        return tracing.records()
    finally:
        tracing.disable()
        tracing.reset()


class _CountingAnnotation:
    """The tracer's annotation pair, counting the annotations entered."""

    built = 0

    @classmethod
    def enter(cls, name):
        cls.built += 1
        return name

    @staticmethod
    def exit(handle):
        pass


def test_off_records_nothing_and_builds_no_annotation(data_root, monkeypatch):
    monkeypatch.setattr(tracing, "_annotate_enter", _CountingAnnotation.enter)
    monkeypatch.setattr(tracing, "_annotate_exit", _CountingAnnotation.exit)
    _CountingAnnotation.built = 0
    assert tracing.span("trainer.valid") is tracing.NULL
    _validate_and_train(*_system(data_root))
    assert _CountingAnnotation.built == 0
    assert tracing.records() == [] and tracing.counters() == {} and tracing.dropped() == 0
    tracing.enable()  # recorded, but no profiler to annotate
    _validate_and_train(*_system(data_root))
    assert _CountingAnnotation.built == 0 and tracing.records()
    tracing.disable()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):  # on under a profiler: annotated
        _validate_and_train(*_system(data_root))
    assert _CountingAnnotation.built == len(tracing.records()) > 0


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_is_recorded_under_its_parent(traced_records, name):
    recs = traced_records
    mine = [r for r in recs if r.name == name]
    assert mine, name
    for r in mine:
        assert r.end_ns is not None and r.end_ns >= r.start_ns
        parent = None if r.parent < 0 else recs[r.parent].name
        assert parent == PARENTS[name]
        root = recs[r.root]
        assert root.parent == -1 and root.name in ("trainer.valid", "trainer.pass")
        assert root.start_ns <= r.start_ns and r.end_ns <= root.end_ns


def test_span_attrs(traced_records):
    by_name = {}
    for r in traced_records:
        by_name.setdefault(r.name, []).append(r)
    assert [r.attrs for r in by_name["trainer.valid"]] == [{"subsets": 3}]
    assert sorted(r.attrs["metric"] for r in by_name["evaluator.metric"]) == sorted(
        m.lower() for m in chip_smoke.published_yaml("PFCN_PMF")["metrics"])
    assert {r.attrs["path"] for r in by_name["trainer.collect_batch"]} == {"sampled-fused"}
    assert all(r.attrs["rows"] > 0 for r in by_name["trainer.collect_batch"])
    passes = by_name["trainer.pass"]
    assert [r.attrs["tx_tag"] for r in passes] == ["filter", "dis"]
    assert passes[0].attrs["sst_list"] == passes[1].attrs["sst_list"]
    assert all(isinstance(r.attrs["loss"], float) and r.attrs["resident"] is False
               for r in passes)
    assert sum(r.attrs["users"] for r in by_name["dataloader.sampled_fetch"]) == 60


@pytest.mark.parametrize("entry", ["certified_topk_scores", "approx_topk_scores",
                                   "streaming_topk_scores"])
def test_topk_entry_points_are_one_root_span(entry):
    gen = torch.Generator().manual_seed(0)
    users, items = torch.randn(5, 8, generator=gen), torch.randn(300, 8, generator=gen)
    tracing.enable()
    getattr(topk, entry)(users, items, 7)
    (rec,) = tracing.records()
    assert rec.name == "topk.select" and rec.parent == -1 and rec.root == 0
    assert rec.attrs == {"rows": 5, "items": 300, "k": 7}


def test_kernel_launch_is_a_span(monkeypatch):
    """``_launch`` (the C call and its scratch) with the library faked: the
    kernel itself runs only on a card."""

    class Lib:
        def fused_topk_launch(self, *args):
            return 0

    monkeypatch.setattr(fused_topk, "_lib", Lib)
    monkeypatch.setattr(fused_topk, "launch_args", lambda *a: (4, (0,) * 12, (0, 0), "wgmma"))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    users, items = torch.zeros(2, 8), torch.zeros(16, 8)
    out_s, out_i = torch.empty(2, 3), torch.empty(2, 3, dtype=torch.int32)
    tracing.enable()
    with tracing.span("topk.select"):
        assert fused_topk._launch(users, items, out_s, out_i, 3, 0, True) == 0
    outer, launch = tracing.records()
    assert launch.name == "fused_topk.launch" and launch.parent == 0 and launch.root == 0
    assert launch.attrs == {"path": "wgmma"}
    assert tracing.counters()["fused_topk.wgmma"] == 1


def _annotation_offsets(trainer, train, valid):
    """One profiled validation and train pass: per span, the offsets (ns)
    of its start and end from its annotation's, which must hold it."""
    tracing.reset()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert tracing.span("x") is not tracing.NULL
            _validate_and_train(trainer, train, valid)
    finally:
        gc.enable()
    assert tracing.span("x") is tracing.NULL
    recs = tracing.records()
    assert {r.name for r in recs} == set(PARENTS)
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in PROGRAM_SPANS and ev.is_user_annotation():
            events.setdefault(ev.name(), []).append((ev.start_ns(),
                                                     ev.start_ns() + ev.duration_ns()))
    assert set(events) == set(PARENTS)
    offsets = []
    for name, spans in events.items():
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        assert len(mine) == len(spans), name
        for (s, e), (es, ee) in zip(mine, sorted(spans)):
            assert es <= s <= e <= ee, (name, s - es, ee - e)  # one clock
            offsets.append((name, s - es, ee - e))
    return offsets


def test_spans_share_the_profiler_clock(data_root):
    """Recorded while a profiler session runs (no ``enable``), each span
    lies inside its annotation in the profiler's events, its start and end
    within 100 us of the annotation's. A loaded CPU can suspend the thread
    between a stamp and the annotation's own for longer: a run where that
    happened is profiled again, three times at most."""
    trainer, train, valid = _system(data_root)
    for _ in range(3):
        late = [o for o in _annotation_offsets(trainer, train, valid)
                if max(o[1], o[2]) > 100_000]
        if not late:
            break
    assert not late


class _Clock:
    """``time.time_ns`` that steps by the planned amounts."""

    def __init__(self, ticks):
        self.now, self.ticks = 0, iter(ticks)

    def time_ns(self):
        self.now += next(self.ticks)
        return self.now


def test_nesting_roots_and_self_time(monkeypatch):
    clock = _Clock([100, 10, 5, 20, 30, 40, 50, 60, 70, 70])
    monkeypatch.setattr(tracing, "time", clock)
    tracing.enable()
    with tracing.span("a"):  # start 100
        with tracing.span("b"):  # 110
            with tracing.span("c") as c:  # 115
                c.set("k", 1)
            # c ends 135
        # b ends 165
        with tracing.span("c"):  # 205
            pass  # ends 255
    # a ends 315
    with tracing.span("d"):  # 385
        pass  # 455
    recs = tracing.records()
    assert [(r.name, r.parent, r.root) for r in recs] == [
        ("a", -1, 0), ("b", 0, 0), ("c", 1, 0), ("c", 0, 0), ("d", -1, 4)]
    assert recs[2].attrs == {"k": 1}
    s = tracing.summary()
    ns = pytest.approx  # seconds of whole nanoseconds
    assert s["a"] == {"count": 1, "total_s": ns(215e-9), "self_s": ns((215 - 55 - 50) * 1e-9)}
    assert s["b"] == {"count": 1, "total_s": ns(55e-9), "self_s": ns((55 - 20) * 1e-9)}
    assert s["c"] == {"count": 2, "total_s": ns(70e-9), "self_s": ns(70e-9)}
    assert s["d"] == {"count": 1, "total_s": ns(70e-9), "self_s": ns(70e-9)}
    for r in recs:  # self time is the duration less the children's cover
        children = sum(x.end_ns - x.start_ns for x in recs if x.parent == recs.index(r))
        assert children <= r.end_ns - r.start_ns
    by = tracing.summary(by="k")
    assert by[("c", 1)]["count"] == 1 and by["c"]["count"] == 1


def test_results_are_bit_identical_with_tracing_on_and_off(data_root):
    runs = []
    for on in (False, True):
        if on:
            tracing.enable()
        trainer, train, valid = _system(data_root)
        result, losses = _validate_and_train(trainer, train, valid)
        second, _ = _validate_and_train(trainer, train, valid)
        params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        runs.append((dict(result), dict(second), losses, params, np.random.get_state()[1].copy()))
        tracing.disable()
    (r0, s0, l0, p0, rng0), (r1, s1, l1, p1, rng1) = runs
    assert tracing.records(), "the second run was traced"
    assert r0 == r1 and s0 == s1 and l0 == l1
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)
    assert np.array_equal(rng0, rng1), "numpy's global stream moved"


def _expected_validation_counts(trainer, valid):
    reads = sum(trainer.eval_collector.register.need(k) for k in PAYLOAD_READS)
    collects = len(valid) * len(trainer._sst_subsets())
    rows = int(valid.segments.rows.sum()) * valid.neg_spec.sample_num
    return {"host_syncs": collects * reads, "sampler.rows_drawn": rows}


@pytest.mark.parametrize("unit", ["validation", "train_pass"])
def test_counters_count_what_the_work_did(data_root, unit):
    trainer, train, valid = _system(data_root)
    trainer._valid_epoch(valid)  # sizes the loader's batches for the device path
    tracing.enable()
    if unit == "validation":
        trainer._valid_epoch(valid)
        want = _expected_validation_counts(trainer, valid)
        assert want["host_syncs"] > 0 and want["sampler.rows_drawn"] > 0
    else:
        trainer._train_epoch(train, 0)  # a filter pass and a discriminator pass
        want = {"host_syncs": 2}  # each pass reads its summed loss once
    assert tracing.counters() == want


def test_to_host_counts_one_sync_and_copies():
    t = torch.arange(4.0)
    assert torch.equal(tracing.to_host(t), t) and tracing.counters() == {}
    tracing.enable()
    tracing.to_host(t)
    tracing.count("sampler.rows_drawn", 7)
    assert tracing.counters() == {"host_syncs": 1, "sampler.rows_drawn": 7}


def _program_span_names():
    pattern = re.compile(r"tracing\.(?:span|traced)\(\s*\"([^\"]+)\"")
    names = set()
    for path in glob.glob(os.path.join(REPO, "recbole_fairrec_tpu_torch", "**", "*.py"),
                          recursive=True):
        names |= set(pattern.findall(open(path, encoding="utf-8").read()))
    return names


def _benchmark_span_names(program=()):
    """The spans the benchmark opens itself: its drivers' spans and wraps, and
    the names its traffic files list to label idle gaps, less the program's
    own spans listed there (``program``)."""
    names = set()
    for path in glob.glob(os.path.join(REPO, "benchmark", "traffic", "*.json")):
        names |= set(json.load(open(path)).get("span_names", ())) - set(program)
    for path in glob.glob(os.path.join(REPO, "benchmark", "drivers", "*.py")):
        src = open(path, encoding="utf-8").read()
        names |= set(re.findall(r"\.span\(\s*\"([^\"]+)\"", src))
        names |= set(re.findall(r"\.wrap\([^)]*,\s*\"([^\"]+)\"\s*\)", src))
    return names


def test_no_program_span_takes_a_benchmark_span_name():
    program = _program_span_names()
    bench = _benchmark_span_names(program)
    assert program == PROGRAM_SPANS
    assert {"valid.epoch", "loader.fetch", "evaluator.evaluate", "retrieval.request",
            "scale.step", "adversarial.filter_pass", "adversarial.dis_pass"} <= bench
    assert not program & bench


def test_decorated_methods_keep_their_names_and_signatures():
    import inspect

    assert Trainer._train_step.__name__ == "_train_step"
    assert list(inspect.signature(Trainer._train_step).parameters) == [
        "self", "batch", "loss_name", "sst_list", "optimizer"]


def test_the_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.enable()
    with tracing.span("a"):
        for _ in range(4):
            with tracing.span("b"):
                pass
    assert [r.name for r in tracing.records()] == ["a", "b", "b"]
    assert tracing.dropped() == 2
    assert tracing.summary()["b"]["count"] == 2
    tracing.reset()
    assert tracing.records() == [] and tracing.dropped() == 0
