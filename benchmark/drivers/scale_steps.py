"""The catalog-scale train step: the program's base ``Trainer._train_step``
(PFCN_PMF with ``filter_mode: none``, which is BPR-MF; dense Adam over both
tables) on (user, positive, negative) batches drawn on the card from the
seed, a fresh batch each step, uniform ids as the JAX package's
``bench_scale`` draws them.

Set-up builds the model on the card, loads the benchmark's tables, and takes
the traffic's first ``checked_steps`` through the same step and feed; the
comparison follows them with the plain reference. The window enqueues steps
until ``seconds`` have passed and waits for the card.
"""

from __future__ import annotations

import gc
import time

import torch

from counts import adam_bytes, gather_bytes, least_s
from harness import checks
from harness.pfcn import program_config
from harness.probe import FirstSteps
from harness.seeds import derive


class State:
    pass


class Sizes:
    """The duck-typed dataset the model reads its sizes from."""

    def __init__(self, n_users, n_items):
        self._n = {"user_id": n_users, "item_id": n_items}

    def num(self, field):
        return self._n[field]


def _spec(cfg):
    from reference.mf_train import Spec

    s = cfg["settings"]
    return Spec(cfg["n_users"], cfg["n_items"], s["embedding_size"], "none",
                lr=s["learning_rate"], weight_decay=s["weight_decay"])


def _feed(cfg, seed, device):
    gen = torch.Generator(device=device).manual_seed(derive(seed, "feed"))
    n_users, n_items, batch = cfg["n_users"], cfg["n_items"], cfg["train_batch_size"]

    def draw():
        return {"user_id": torch.randint(1, n_users, (batch,), generator=gen, device=device),
                "item_id": torch.randint(1, n_items, (batch,), generator=gen, device=device),
                "neg_item_id": torch.randint(1, n_items, (batch,), generator=gen, device=device)}

    return draw


def setup(run):
    from recbole_fairrec_tpu_torch.trainer import Trainer
    from recbole_fairrec_tpu_torch.utils import get_model
    from reference.mf_train import initial_state

    cfg, device = run.config, run.device
    config = program_config(run, cfg["name"], {"train_batch_size": cfg["train_batch_size"]})
    with device:  # the model's own init draws on the card; the benchmark's tables replace it
        model = get_model(cfg["model"])(config, Sizes(cfg["n_users"], cfg["n_items"]),
                                        generator=torch.Generator(device=device).manual_seed(0))
    trainer = Trainer(config, model)
    spec = _spec(cfg)
    weight_seed = derive(run.seed, "weights")
    with torch.no_grad():
        model.load_state_dict(initial_state(spec, weight_seed, device), strict=True)
    draw = _feed(cfg, run.seed, device)
    probe = FirstSteps(model)
    model.train()
    kept = []
    for kind in run.traffic["checked_steps"]:
        batch = draw()
        kept.append(({k: v.clone() for k, v in batch.items()}, kind, ()))
        probe.after_step(trainer._train_step(batch, "calculate_loss", None, trainer.optimizer),
                         trainer.optimizer)
    state = State()
    state.trainer, state.model, state.draw = trainer, model, draw
    state.kept, state.readings = kept, probe.finish()
    state.spec, state.weight_seed = spec, weight_seed
    return state


def window(run, state, seconds):
    trainer, draw = state.trainer, state.draw
    deadline = time.perf_counter() + seconds
    steps = 0
    while time.perf_counter() < deadline:
        with run.rec.span("scale.step"):
            trainer._train_step(draw(), "calculate_loss", None, trainer.optimizer)
        steps += 1
    run.work["steps"] += steps


def account(run, state, work):
    cfg = run.config
    batch, d = cfg["train_batch_size"], cfg["settings"]["embedding_size"]
    n_params = (cfg["n_users"] + cfg["n_items"]) * d
    step = least_s(2.0 * 2 * batch * d * 2, gather_bytes(3 * batch, d) + adam_bytes(n_params))
    work["rows"] = work["steps"] * batch
    work["least_s"] = work["steps"] * step
    work["adam_bytes"] = work["steps"] * adam_bytes(n_params)


def end_to_end(run, state):
    run.attempted = int(run.work["steps"])
    return {"train_examples_per_s": run.work["rows"] / run.window_s}


def check(run, state):
    from reference.mf_train import initial_state, train_steps

    spec, weight_seed = state.spec, state.weight_seed
    state.trainer = state.model = state.draw = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = train_steps(spec, initial_state(spec, weight_seed, run.device), {}, 0, state.kept)
    numbers, info = checks.train_numbers(state.readings, ref)
    if run.calibrate:
        out = {}
        for label, kwargs in (("control_bfloat16", {"precision": "bfloat16"}),
                              ("fault_half_batch",
                               {"rows": len(state.kept[0][0]["user_id"]) // 2})):
            other = train_steps(spec, initial_state(spec, weight_seed, run.device), {}, 0,
                                state.kept, **kwargs)
            out[label] = checks.train_numbers(other, ref)[0]
            del other
        run.note("calibration", out)
    run.note("checked_losses", {"program": state.readings["losses"], "reference": ref["losses"]})
    run.note("worst_leaves", {k: info[k] for k in ("grad_worst_leaf", "change_worst_leaf")})
    return numbers
