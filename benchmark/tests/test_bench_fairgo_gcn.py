"""The FairGo_GCN cell (``fairgo_gcn-lastfm360k.pretrain``) on the CPU: the
counts against hand-worked values and against the work of the step's
rewritten forms, the configuration's sizes, the readers on fake runs, and
the cell run whole at a tiny size through the CSR and the dense
propagation (sound runs correct, the control and the planted faults
not)."""

from types import SimpleNamespace

import pytest

from counts import PEAK_BYTES, adam_bytes
from counts import fairgo_gcn as counts
from harness import manifest

CELL = "fairgo_gcn-lastfm360k.pretrain"
BIG = 2**31 + 99
TINY = {"n_nodes": 10, "entries": 30, "sources": 10, "embedding_size": 4,
        "hidden_channels": 2, "gcn_n_layers": 2}


def _driver():
    return manifest.load_cell(CELL).driver()


def _cell_model():
    cfg = manifest.load_cell(CELL).config
    g = cfg["graph"]
    n = g["n_users"] + g["n_items"]
    # every node has a self loop, so every node is a source of every hop
    return _driver().model_sizes(cfg, g["gcn_entries"], n), cfg


# ----------------------------------------------------------------- counts


def test_step_work_by_hand():
    # widths 4 -> 2 -> 4: four hops at 2; a hop 30 x 8 + 11 x 4 + (10 + 10) x 4 x 2 B
    assert counts.hop_widths(TINY) == [2, 2, 2, 2]
    flops, nbytes = counts.hops_work(TINY)
    assert (flops, nbytes) == (4 * 2 * 30 * 2, 4 * (240 + 44 + 160))
    # GEMMs 2 x 10 x 4 x 2 twice; batch 6: 2 x 6 x 4
    f, b = counts.step_work(TINY, 6)
    assert f == flops + 2 * (2 * 10 * 4 * 2) + 2 * 6 * 4
    params = 10 * 4 + (4 * 2 + 2) + (2 * 4 + 4)
    assert counts.params(TINY) == params
    # X and H read once, Adam, two rows and a rating a batch row
    assert b == nbytes + 10 * 4 * (4 + 2) + adam_bytes(params) + 2 * 6 * 4 * 4 + 4 * 6


def test_the_configuration_keeps_the_published_widths_and_the_whole_graph():
    cfg = manifest.load_cell(CELL).config
    s, g = cfg["settings"], cfg["graph"]
    assert (s["embedding_size"], s["hidden_channels"], s["gcn_n_layers"]) == (64, 32, 2)
    assert (s["gcn_dropout"], s["gcn_act"], cfg["train_batch_size"]) == (0.2, "relu", 2048)
    assert not s["load_pretrain_weight"] and cfg["reduced"] == []
    n = g["n_users"] + g["n_items"]
    assert n == 651_938 and g["gcn_entries"] == 2 * g["train_rows"] + n == 30_021_446
    pmf = manifest.load_cell("fairgo_pmf-lastfm360k.finetune").config
    assert g == dict(pmf["graph"], gcn_entries=g["gcn_entries"])


def _rewrites(model, B):
    """(operations, bytes) of a step as today's program and each exact
    rewrite would at least do it: the hops at the widths they run at, each
    entry's source row read from memory or each source row once, the rest
    as counted."""
    n, E = model["n_nodes"], model["entries"]
    rest_f, rest_b = counts.step_work(model, B)
    hop_f, hop_b = counts.hops_work(model)
    rest_f, rest_b = rest_f - hop_f, rest_b - hop_b

    def hops(widths, per_entry):
        f = sum(2.0 * E * d for d in widths)
        b = sum(E * 8.0 + (n + 1) * 4.0 + ((E if per_entry else n) + n) * 4.0 * d
                for d in widths)
        return rest_f + f, rest_b + b

    return {
        # Â (X W1) at 32 and Â (H W2) at 64, forward and backward
        "today": hops([32, 32, 64, 64], per_entry=False),
        "today_rows_per_entry": hops([32, 32, 64, 64], per_entry=True),
        # (Â H) W2: every hop at 32
        "narrow": hops([32, 32, 32, 32], per_entry=False),
        "narrow_rows_per_entry": hops([32, 32, 32, 32], per_entry=True),
    }


def test_least_time_is_below_every_rewritten_form():
    """The counted step (four hops at 32, each source row read once) is at
    most what today's step and each rewrite must do: the whole step's share
    stays under 100%; bound by bytes."""
    model, cfg = _cell_model()
    B = cfg["train_batch_size"]
    f, b = counts.step_work(model, B)
    least = counts.least_time(f, b)
    forms = _rewrites(model, B)
    assert least == pytest.approx(counts.least_time(*forms["narrow"]))
    for name, (flops, nbytes) in forms.items():
        assert least <= counts.least_time(flops, nbytes) * (1 + 1e-12), name
    assert least == pytest.approx(b / PEAK_BYTES)
    assert 0.8e-3 < least < 0.9e-3
    _, hop_b = counts.hops_work(model)
    assert 0.45e-3 < hop_b / PEAK_BYTES < 0.5e-3  # four hops at 32 of 30.0M entries


# ---------------------------------------------------------------- readers


def _reader(name):
    return manifest.load_cell(CELL).reader(name)


def test_mfu_and_roofline_readers_on_a_fake_run():
    run = SimpleNamespace(work={"least_s": 0.4}, window_s=40.0, slice_work={
        "hop_bytes": 0.5 * PEAK_BYTES}, profile={"kernels": {
            "void spmm_csr_kernel<4, 8>(int const*)": 4.0,
            "void spmm_csr_carry_kernel<4, 8>(float const*)": 1.0, "sm80_xmma_gemm": 9.0}})
    assert _reader("gcn_step_mfu").read(run) == pytest.approx(1.0)
    assert _reader("spmm_csr_roofline").read(run) == pytest.approx(10.0)
    empty = SimpleNamespace(work={}, window_s=40.0, slice_work={"hop_bytes": 1.0},
                            profile={"kernels": {"sm80_xmma_gemm": 9.0}})
    assert _reader("gcn_step_mfu").read(empty) is None
    assert _reader("spmm_csr_roofline").read(empty) is None  # no kernel ran


@pytest.fixture
def tracer():
    from recbole_fairrec_tpu_torch.utils import tracing

    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


def test_backward_edges_reader_on_a_planted_store(tracer):
    reader = _reader("spmm.backward_edges_per_step")
    run = SimpleNamespace(slice_work={"steps": 4})
    assert reader.read(run) is None  # an empty store
    tracer.enable()
    with tracer.span("trainer.step"):
        pass
    tracer.count("spmm.edges", 8 * 1000)
    assert reader.read(run) is None  # a program before the backward counter
    tracer.count("spmm.backward_edges", 8 * 1000)
    tracer.disable()
    assert reader.read(run) == pytest.approx(2000.0)


# -------------------------------------------------------------- whole cell


@pytest.fixture
def tiny():
    def make(dense):
        cell = manifest.load_cell(CELL)
        cell.config["graph"].update({"n_users": 301, "n_items": 401, "n_rows": 300 * 48 + 123})
        cell.config["train_batch_size"] = 256
        cell.config["settings"]["dense_propagation"] = dense
        cell.traffic["trace_seconds"] = 0.5
        return cell
    return make


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
def test_the_cell_runs_whole_at_a_tiny_size(tiny, execute, tracer, dense):
    """(The tracer's store is one per process: emptied before the runs.)"""
    from harness.checks import judge

    cell = tiny(dense)
    result = execute(cell, BIG, seconds=0.5, calibrate=True)
    assert result["correct"], result["checks"]
    assert set(result["calibration"]) == {"control_bfloat16", "fault_one_hop",
                                          "fault_no_dropout", "fault_half_batch"}
    for label, numbers in result["calibration"].items():
        merged = {k: numbers.get(k, 0.0) for k in cell.limits}
        assert not judge(merged, cell.limits)[0], (label, numbers)
    traced = execute(tiny(dense), BIG, seconds=0.5, trace=True)
    assert traced["correct"]
    metrics = {k: v["value"] for k, v in traced["metrics"].items()}
    # no kernel on the CPU: the rooflines are silent; the dense path counts no CSR entries
    assert set(metrics) == {"device_idle_share.fairgo", "gcn_step_mfu", "spmm.edges_per_step",
                            "spmm.backward_edges_per_step", "trainer.step_host_ms"} | (
                                set() if dense else {"spmm.csr_edge_share"})
    assert metrics["trainer.step_host_ms"] > 0
    assert 0 < metrics["gcn_step_mfu"] < 100
    # two convolutions a step, forward and backward, each over all of Â's entries
    entries = 2 * (300 * 40 + 123) + 301 + 401
    assert metrics["spmm.edges_per_step"] == pytest.approx(2 * entries)
    assert metrics["spmm.backward_edges_per_step"] == pytest.approx(2 * entries)
    if not dense:
        assert metrics["spmm.csr_edge_share"] == pytest.approx(100.0)
