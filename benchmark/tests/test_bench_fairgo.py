"""The FairGo cell (``fairgo_pmf-lastfm360k.finetune``) on the CPU: the
counts against hand-worked values, the least time against the work of every
exact rewrite of a cycle, the traffic's cycle and subset plan, the
synthetic graph and the feed, the three readers on a fake run, and the
cell run whole at a tiny size (sound runs correct, the control and the
planted faults not)."""

import itertools
from types import SimpleNamespace

import pytest
import torch

from counts import PEAK_BYTES, mlp_flops
from counts import fairgo as counts
from harness import manifest

CELL = "fairgo_pmf-lastfm360k.finetune"
BIG = 2**31 + 99
TINY = {"n_nodes": 10, "edges": 20, "embedding_size": 4, "filter_hidden": [8, 4],
        "dis_hidden": [2], "n_layers": 2, "attributes": {"gender": 2, "age": 3}}


def _driver():
    return manifest.load_cell(CELL).driver()


def _small_config(users=2000, items=3000, extra=700):
    cfg = manifest.load_cell(CELL).config
    cfg["graph"].update({"n_users": users + 1, "n_items": items + 1,
                         "n_rows": users * cfg["graph"]["degrees"][0] + extra})
    return cfg


# ----------------------------------------------------------------- counts


def test_cycle_work_by_hand():
    # two filters [4, 8, 4, 4] over 10 rows: 2 x 2 x 10 x (32 + 32 + 16) operations;
    # the hop: 20 entries x (8 + 16) B + 10 rows x 16 B; the filters read and write 10 x 16 B
    assert counts.cycle_work(TINY, 2) == (3200.0, 480.0 + 160.0 + 320.0)


def test_step_work_by_hand():
    # MSE 2 x 6 x 4; LBA [8, 4, 4, 4] at 3 users: 2 x 3 x 64; discriminators twice at 3
    # users: gender [4, 2, 1] 2 x 3 x 10, age [4, 2, 3] 2 x 3 x 14
    flops, nbytes = counts.step_work(TINY, 6, 3, 5, ("gender", "age"))
    assert flops == 48 + 384 + 2 * 60 + 2 * 84
    # the last hop at 3 users holding 5 entries, 2 x 6 rows read, 6 ratings
    assert nbytes == 5 * 24 + 3 * 16 + 2 * 6 * 16 + 6 * 4


def _cell_model():
    cfg = manifest.load_cell(CELL).config
    return _driver().model_sizes(cfg, cfg["graph"]["edges"]), cfg


def _rewrites(model, B, users, entries, subset, cycle):
    """(operations, bytes) of one cycle as today's program and each exact
    rewrite would at least do them: full hops a cycle, filters over the
    table a cycle, and the batch side of every step."""
    n, d, E = model["n_nodes"], model["embedding_size"], model["edges"]
    hop = counts.hop_bytes(E, n, d)
    filt = mlp_flops(counts.filter_sizes(model), n) * len(subset)
    steps = len(cycle)
    filters = cycle.count("filter")
    side_f, side_b = counts.step_work(model, B, users, entries, subset)
    full_hops = {
        # every step 2 hops forward, a filter step 2 more backward, the filters each step
        "today": (2 * steps + 2 * filters, steps),
        # the last hop at the batch's users only: 1 full hop a step (+ 1 backward)
        "last_hop_at_batch": (steps + filters, steps),
        # both hops kept across the discriminator steps: the filter step's 2 (+ 2
        # backward), then 2 after its update for the discriminator steps
        "hops_kept": (2 * filters + 2 * filters + 2, 2),
        # both rewrites: the filter step's first hop (+ 1 backward), 1 after its update
        "both": (filters + filters + 1, 2),
    }
    return {name: (passes * filt + steps * side_f,
                   hops * hop + passes * 2.0 * n * 4 * d + steps * side_b)
            for name, (hops, passes) in full_hops.items()}


@pytest.mark.parametrize("subset", [("gender",), ("age",), ("gender", "age")])
def test_least_time_is_below_every_rewrite_of_a_cycle(subset):
    """The counted cycle (one full hop, the filters once, the batch side of
    each step) is at most what today's step and each exact rewrite must do,
    the CSR product with no [E, d] temporary included (it reads what the
    count reads): the whole step's share stays under 100%."""
    model, cfg = _cell_model()
    cycle = manifest.load_cell(CELL).traffic["cycle"]
    B, users, entries = cfg["train_batch_size"], 1000, 41_000
    f, b = counts.cycle_work(model, len(subset))
    sf, sb = counts.step_work(model, B, users, entries, subset)
    least = counts.least_time(f + len(cycle) * sf, b + len(cycle) * sb)
    for name, (flops, nbytes) in _rewrites(model, B, users, entries, subset, cycle).items():
        assert least <= counts.least_time(flops, nbytes), name
    # bound by bytes: one full hop of 29.4M entries dominates
    assert least == pytest.approx((b + len(cycle) * sb) / PEAK_BYTES)
    assert 2.0e-3 < least < 3.0e-3


# ---------------------------------------------------------------- traffic


def test_cycle_and_subset_plan():
    traffic = manifest.load_cell(CELL).traffic
    driver = _driver()
    assert traffic["cycle"] == ["filter"] + ["dis"] * 5
    assert traffic["subset_sizes"] == [2, 1]
    attrs = ["gender", "age"]
    plan = [driver.subset_plan(attrs, traffic["subset_sizes"], BIG, c) for c in range(40)]
    assert [len(s) for s in plan] == [2, 1] * 20
    assert all(s == ("gender", "age") for s in plan[::2])
    singles = [s for s in plan[1::2]]
    assert {("gender",), ("age",)} == set(singles)  # both members over the run
    assert plan == [driver.subset_plan(attrs, traffic["subset_sizes"], BIG, c)
                    for c in range(40)]
    assert plan != [driver.subset_plan(attrs, traffic["subset_sizes"], BIG + 1, c)
                    for c in range(40)]
    # one checked step of each kind for each subset size
    assert sorted(map(tuple, traffic["checked_steps"])) == sorted(
        itertools.product(["dis", "filter"], traffic["subset_sizes"]))


def test_train_rows_follow_the_programs_split():
    driver = _driver()
    assert driver.train_counts(48, [8, 1, 1]) == 40
    assert driver.train_counts(49, [8, 1, 1]) == 41
    g = manifest.load_cell(CELL).config["graph"]
    users = g["n_users"] - 1
    extra = g["n_rows"] - 48 * users
    assert g["train_rows"] == (users - extra) * 40 + extra * 41
    assert g["edges"] == 2 * g["train_rows"]


# ------------------------------------------------------------------ graph


def test_synthetic_graph():
    cfg = _small_config()
    driver = _driver()
    g = driver.Graph(cfg, 12345, torch.device("cpu"))
    n_rows = cfg["graph"]["n_rows"]
    assert g.users.numel() == g.items.numel() == g.ratings.numel() == n_rows
    degree = torch.bincount(g.users, minlength=2001)[1:]
    assert set(degree.tolist()) == {48, 49} and int((degree == 49).sum()) == 700
    keys = g.users * 3001 + g.items
    assert torch.unique(keys).numel() == n_rows  # no pair twice
    assert int(g.items.min()) >= 1 and int(g.items.max()) <= 3000
    assert set(torch.unique(g.ratings).tolist()) == {1.0, 2.0, 3.0, 4.0, 5.0}
    train = torch.bincount(g.users[g.train], minlength=2001)[1:]
    assert torch.equal(train, torch.where(degree == 49, 41, 40))
    # a head of popular artists: the most drawn is far above the mean
    counts_ = torch.bincount(g.items)
    assert int(counts_.max()) > 20 * n_rows / 3000
    for attr, spec in cfg["attributes"].items():
        assert int(g.features[attr][0]) == 0
        assert set(g.features[attr][1:].tolist()) <= set(spec["values"])
    again = driver.Graph(cfg, 12345, torch.device("cpu"))
    for a, b in ((g.users, again.users), (g.items, again.items), (g.ratings, again.ratings),
                 (g.train, again.train), (g.features["age"], again.features["age"])):
        assert torch.equal(a, b)
    other = driver.Graph(cfg, 12346, torch.device("cpu"))
    assert not torch.equal(g.items, other.items)


def test_feed_forms_pointwise_batches():
    cfg = _small_config()
    driver = _driver()
    g = driver.Graph(cfg, 7, torch.device("cpu"))
    feed = driver.Feed(g, 512, 99, torch.device("cpu"))
    users, items, _ = g.train_edges()
    train = set((users * 3001 + items).tolist())
    seen = 0
    for _ in range(3):
        batch, b = feed.draw()
        half = 256
        assert all(v.shape == (512,) for v in batch.values())
        assert torch.equal(batch["user_id"][:half], batch["user_id"][half:])
        assert torch.equal(batch["rating"][:half], batch["rating"][half:])
        pos = (batch["user_id"][:half] * 3001 + batch["item_id"][:half]).tolist()
        neg = (batch["user_id"][half:] * 3001 + batch["item_id"][half:]).tolist()
        assert set(pos) <= train and not set(neg) & train
        assert torch.equal(batch["age"], g.features["age"][batch["user_id"]])
        distinct = torch.unique(batch["user_id"][:half])
        assert feed.distinct[b] == distinct.numel()
        assert feed.user_entries[b] == int(torch.bincount(users, minlength=2001)[distinct].sum())
        seen += 1
    assert seen == feed.at


# ---------------------------------------------------------------- readers


def _reader(name):
    return manifest.load_cell(CELL).reader(name)


def test_idle_and_mfu_readers_on_a_fake_run():
    run = SimpleNamespace(profile={"busy_s": 7.5, "window_s": 10.0}, work={"least_s": 0.4},
                          window_s=40.0)
    assert _reader("device_idle_share.fairgo").read(run) == pytest.approx(25.0)
    assert _reader("fairgo_step_mfu").read(run) == pytest.approx(1.0)
    empty = SimpleNamespace(profile=None, work={}, window_s=40.0)
    assert _reader("device_idle_share.fairgo").read(empty) is None
    assert _reader("fairgo_step_mfu").read(empty) is None


@pytest.fixture
def tracer():
    from recbole_fairrec_tpu_torch.utils import tracing

    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


def test_edges_reader_on_a_planted_store(tracer):
    reader = _reader("spmm.edges_per_step")
    run = SimpleNamespace(slice_work={"steps": 4})
    assert reader.read(run) is None  # an empty store
    tracer.enable()
    with tracer.span("trainer.step"):
        pass
    assert reader.read(run) is None  # spans, but no hop counted (a program before the counter)
    tracer.count("spmm.edges", 8 * 1000)
    tracer.disable()
    assert reader.read(run) == pytest.approx(2000.0)
    assert reader.read(SimpleNamespace(slice_work={})) is None


# -------------------------------------------------------------- whole cell


@pytest.fixture
def tiny(execute):
    def make():
        cell = manifest.load_cell(CELL)
        cell.config["graph"].update({"n_users": 301, "n_items": 401, "n_rows": 300 * 48 + 123})
        cell.config["train_batch_size"] = 256
        cell.traffic["trace_seconds"] = 0.5
        return cell
    return make


def test_the_cell_runs_whole_at_a_tiny_size(tiny, execute):
    from harness.checks import judge

    cell = tiny()
    result = execute(cell, BIG, seconds=1.0, calibrate=True)
    assert result["correct"], result["checks"]
    for label, numbers in result["calibration"].items():
        merged = {k: numbers.get(k, 0.0) for k in cell.limits}
        assert not judge(merged, cell.limits)[0], (label, numbers)
    traced = execute(tiny(), BIG, seconds=1.0, trace=True)
    assert traced["correct"]
    metrics = traced["metrics"]
    assert set(metrics) == {"device_idle_share.fairgo", "fairgo_step_mfu", "spmm.edges_per_step"}
    assert 0 < metrics["fairgo_step_mfu"]["value"] < 100
    # the dense path at this size: two forward hops a step, each of the matrix's entries
    assert metrics["spmm.edges_per_step"]["value"] == pytest.approx(2 * 2 * (300 * 40 + 123))
