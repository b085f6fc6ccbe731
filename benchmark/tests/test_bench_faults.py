"""A run drives the rest of its path with the timed path broken underneath
(the look for a card skipped: the CPU at a tiny size) and ``correct``
comes out false, once for each fault the cell can have. One card: there is
no exchange between chips to leave out."""

import pytest

BIG = 2**31 + 99


def test_sound_runs_are_correct(tiny_cell, execute):
    for workload in ("pfcn_pmf_sm-ml1m.train", "bprmf-catalog2m.train",
                     "bprmf-catalog2m.retrieval", "pfcn_pmf_sm-ml1m.eval_uni100"):
        result = execute(tiny_cell(workload), BIG)
        assert result["correct"], (workload, result["checks"])


def _unchanged_step(self, batch, loss_name, sst_list, optimizer):
    """The step computes its loss and returns it, the state left as it was."""
    return getattr(self.model, loss_name)(batch, sst_list=sst_list).detach()


def _half_batch(inner):
    def step(self, batch, loss_name, sst_list, optimizer):
        half = {k: v[: len(v) // 2] for k, v in batch.items()}
        return inner(self, half, loss_name, sst_list, optimizer)
    return step


@pytest.mark.parametrize("workload", ["pfcn_pmf_sm-ml1m.train", "bprmf-catalog2m.train"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_read_incorrect(tiny_cell, execute, monkeypatch, workload, fault):
    from recbole_fairrec_tpu_torch.trainer import Trainer

    step = _unchanged_step if fault == "unchanged" else _half_batch(Trainer._train_step)
    monkeypatch.setattr(Trainer, "_train_step", step)
    result = execute(tiny_cell(workload), BIG)
    assert not result["correct"], result["checks"]


def _carry_fault(inner, fault):
    """A step that starts from carried state gone wrong: the optimizer's
    moments zeroed, its step count held at 0, or BatchNorm's running
    statistics set back to their start."""
    import torch

    @torch.no_grad()
    def step(self, batch, loss_name, sst_list, optimizer):
        for st in optimizer.state.values():
            if fault == "moments_reset" and "exp_avg" in st:
                st["exp_avg"].zero_()
                st["exp_avg_sq"].zero_()
            if fault == "step_frozen" and "step" in st:
                if torch.is_tensor(st["step"]):
                    st["step"].zero_()
                else:
                    st["step"] = 0
        if fault == "stats_reset":
            for name, buf in self.model.named_buffers():
                buf.fill_(1.0 if name.endswith(".var") else 0.0)
        with torch.enable_grad():
            return inner(self, batch, loss_name, sst_list, optimizer)
    return step


@pytest.mark.parametrize("fault", ["moments_reset", "step_frozen", "stats_reset"])
def test_carried_state_faults_read_incorrect(tiny_cell, execute, monkeypatch, fault):
    """The PFCN cell's reference starts each step from the program's state:
    what the program carries from step to step is checked by itself."""
    from recbole_fairrec_tpu_torch.trainer import Trainer

    monkeypatch.setattr(Trainer, "_train_step", _carry_fault(Trainer._train_step, fault))
    result = execute(tiny_cell("pfcn_pmf_sm-ml1m.train"), BIG)
    assert not result["correct"], result["checks"]


def test_subsets_off_plan_read_incorrect(tiny_cell, execute, monkeypatch):
    """A trainer that no longer draws its subsets as the plan replays."""
    from recbole_fairrec_tpu_torch.trainer import adversarial

    # off the plan from the first epoch on (the plan's first subset holds
    # every attribute), so a window cut inside epoch 0 reads it too
    monkeypatch.setattr(adversarial, "_draw_sst_mask", lambda attrs: tuple(attrs[:1]))
    result = execute(tiny_cell("pfcn_pmf_sm-ml1m.train"), BIG, seconds=3)
    assert result["checks"]["subsets_off_plan"]["value"] > 0
    assert not result["correct"], result["checks"]


def test_altered_answer_reads_incorrect(tiny_cell, execute, monkeypatch):
    from recbole_fairrec_tpu_torch.ops import topk

    inner = topk.certified_topk_scores

    def altered(users, items, k, **kw):
        scores, ids = inner(users, items, k, **kw)
        ids = ids.clone()
        ids[0, 0] = ids[0, -1]  # a repeat, and a score that is not the item's
        return scores, ids

    monkeypatch.setattr(topk, "certified_topk_scores", altered)
    result = execute(tiny_cell("bprmf-catalog2m.retrieval"), BIG)
    assert not result["correct"], result["checks"]


def test_altered_metric_reads_incorrect(tiny_cell, execute, monkeypatch):
    from recbole_fairrec_tpu_torch.evaluator import Evaluator

    inner = Evaluator.evaluate

    def altered(self, data):
        out = inner(self, data)
        out["ndcg@5"] = out["ndcg@5"] * 1.01
        return out

    monkeypatch.setattr(Evaluator, "evaluate", altered)
    result = execute(tiny_cell("pfcn_pmf_sm-ml1m.eval_uni100"), BIG)
    assert not result["correct"], result["checks"]


def test_altered_draws_read_incorrect(tiny_cell, execute, monkeypatch):
    """Negatives drawn from the user's own validation items."""
    from recbole_fairrec_tpu_torch.data.dataloader import NegSampleEvalDataLoader

    inner = NegSampleEvalDataLoader._next_batch_data

    def altered(self):
        out = inner(self)
        items = out[0]["item_id"]
        first_user_positives = int((out[2] == 0).sum())
        items[first_user_positives] = items[0]
        return out

    monkeypatch.setattr(NegSampleEvalDataLoader, "_next_batch_data", altered)
    result = execute(tiny_cell("pfcn_pmf_sm-ml1m.eval_uni100"), BIG)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["pfcn_pmf_sm-ml1m.train", "bprmf-catalog2m.train",
                                      "bprmf-catalog2m.retrieval",
                                      "pfcn_pmf_sm-ml1m.eval_uni100"])
def test_control_reads_incorrect(tiny_cell, execute, workload):
    """The reference in the next precision below the configuration's, in
    the program's place, fails at least one of the cell's limits."""
    from harness.checks import judge

    cell = tiny_cell(workload)
    result = execute(cell, BIG, calibrate=True)
    assert result["correct"]
    controls = {k: v for k, v in result["calibration"].items() if k.startswith("control")}
    assert controls
    for numbers in controls.values():
        merged = {name: numbers.get(name, 0.0) for name in cell.limits}
        assert not judge(merged, cell.limits)[0], numbers


def test_traced_run_reads_its_layers(tiny_cell, execute):
    """A ``--trace 1`` run reports per-layer metrics (those that find
    something to read on the CPU), the slice's busy and window seconds and
    a breakdown, and is judged as an untraced run is."""
    # a window long enough to hold a discriminator step on a loaded CPU
    result = execute(tiny_cell("pfcn_pmf_sm-ml1m.train"), BIG, seconds=8, trace=True)
    assert result["correct"]
    assert {"adversarial.filter_step_ms", "adversarial.dis_step_ms", "train_step_mfu"} <= \
        set(result["metrics"])
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"


def test_idle_gaps_go_to_the_innermost_span():
    from harness.trace import _label

    # a pass holding many fetches: a gap inside the 100th fetch, one between fetches
    fetch_starts = [1000 + 10 * i for i in range(200)]
    by_name = {"pass": ([0], [5000]),
               "fetch": (fetch_starts, [s + 4 for s in fetch_starts])}
    assert _label(by_name, 1000 + 10 * 150 + 2) == "fetch"
    assert _label(by_name, 1000 + 10 * 150 + 7) == "pass"
    assert _label(by_name, 6000) == "outside the benchmark's spans"
