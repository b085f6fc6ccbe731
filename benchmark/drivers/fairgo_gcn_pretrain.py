"""FairGo_GCN's pretrain, step by step, on the synthetic Last.fm-360K graph
that ``drivers/fairgo_steps.py`` draws on the card from the seed.

The program's own path: ``FairGo_GCN`` built by ``utils.get_model`` with the
program's ``Config``, ``FairGoTrainer`` on it (``load_pretrain_weight``
false and no pretrain checkpoint, so the trainer puts the model in the
pretrain stage itself), and ``Trainer._train_step(batch, "calculate_loss",
None, trainer.tx_pretrain)``, as ``FairGoTrainer.pretrain``'s
``_run_epoch(..., "pretrain")`` calls it. The model chooses its propagation
itself (the CSR pair of Â at this size) and draws its dropout masks from its
own dropout generator. It reads its sizes, ratings and rating matrix from
``fairgo_steps.Lastfm``; batches come from ``fairgo_steps.Feed`` (half
training rows from a seeded permutation, half one uniform negative for each
carrying its row's rating).

Set-up draws the graph, builds the model and trainer, loads the benchmark's
weights (the tables and the GCN; the filters, discriminators and LBA head,
which the pretrain never reads, keep the program's init) and takes the
traffic's ``checked_steps`` steps; the comparison checks each one's passage
from the program's snapshot before it against the plain reference
(``reference/fairgo_gcn.py``), which draws the dropout masks from the state
the program's dropout generator had before the step.
"""

from __future__ import annotations

import gc
import time

import torch

from counts import adam_bytes
from counts import fairgo_gcn as counts
from drivers.fairgo_steps import Feed, Graph, Lastfm, gradient_vector_gaps
from harness import checks
from harness.pfcn import program_config
from harness.probe import FirstSteps
from harness.seeds import derive

LOSS = "calculate_loss"
# the parameters that the pretrain leaves as the program initialised them
UNREAD = ("filters.", "discriminators.", "aggr.")


class State:
    pass


def model_spec(cfg):
    from reference.fairgo_gcn import Spec

    s, g = cfg["settings"], cfg["graph"]
    return Spec(g["n_users"], g["n_items"], s["embedding_size"], s["hidden_channels"],
                s["gcn_n_layers"], s["gcn_dropout"], s["learning_rate"], s["weight_decay"])


def model_sizes(cfg, entries, sources):
    s, g = cfg["settings"], cfg["graph"]
    return {"n_nodes": g["n_users"] + g["n_items"], "entries": entries, "sources": sources,
            "embedding_size": s["embedding_size"], "hidden_channels": s["hidden_channels"],
            "gcn_n_layers": s["gcn_n_layers"]}


def setup(run):
    from recbole_fairrec_tpu_torch.trainer.adversarial import FairGoTrainer
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer
    from reference.fairgo_gcn import initial_state

    cfg, device, traffic = run.config, run.device, run.traffic
    graph = Graph(cfg, derive(run.seed, "data"), device)
    config = program_config(run, cfg["name"], {"train_batch_size": cfg["train_batch_size"]})
    dataset = Lastfm(graph, {}, config["RATING_FIELD"])
    with device:  # the model's own init draws on the card; the benchmark's weights replace it
        model = get_model(cfg["model"])(config, dataset,
                                        generator=torch.Generator(device=device).manual_seed(0))
    del dataset
    trainer = get_trainer(config["MODEL_TYPE"], cfg["model"])(config, model)
    if not isinstance(trainer, FairGoTrainer) or model.train_stage != "pretrain":
        raise RuntimeError(f"{type(trainer).__name__} left the model in stage "
                           f"{model.train_stage!r}, not pretrain")
    spec = model_spec(cfg)
    weight_seed = derive(run.seed, "weights")
    with torch.no_grad():
        missing, unexpected = model.load_state_dict(initial_state(spec, weight_seed, device),
                                                    strict=False)
    if unexpected or not all(k.startswith(UNREAD) for k in missing):
        raise RuntimeError(f"the benchmark's weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    state = State()
    state.trainer, state.model = trainer, model
    state.feed = Feed(graph, cfg["train_batch_size"], run.seed, device)
    state.edges = graph.train_edges()
    del graph
    n = spec.n_users + spec.n_items
    entries = int(model.gcn_rows.numel())
    sources = int(torch.bincount(model.gcn_cols, minlength=n).count_nonzero())
    state.model_sizes = model_sizes(cfg, entries, sources)
    state.spec, state.weight_seed = spec, weight_seed
    state.tx = trainer.tx_pretrain
    probe = FirstSteps(model, {"pretrain": state.tx})
    model.train()
    dropout = model.dropout_generator(model.user_embedding.weight.device)
    kept = []
    for _ in range(traffic["checked_steps"]):
        batch, _ = state.feed.draw()
        kept.append(({k: batch[k].clone() for k in ("user_id", "item_id", "rating")},
                     dropout.get_state()))
        probe.snapshot()
        loss = trainer._train_step(batch, LOSS, None, state.tx)
        probe.after_step(loss, state.tx)
    state.kept, state.readings = kept, probe.finish()
    state.snapshots = probe.snapshots
    path = "dense" if model.dense_propagation else "csr"
    run.note("propagation", {"path": path, "entries": entries, "sources": sources})
    return state


def window(run, state, seconds):
    trainer, feed, tx = state.trainer, state.feed, state.tx
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        batch, _ = feed.draw()
        with run.rec.span("pretrain.step"):
            trainer._train_step(batch, LOSS, None, tx)
        run.work["steps"] += 1


def account(run, state, work):
    """Rows, the least time of the steps (``counts/fairgo_gcn.py``) and the
    least bytes of their hops and of their dense Adam, from the steps
    tallied in ``work``."""
    steps = work.get("steps", 0.0)
    B = run.config["train_batch_size"]
    flops, nbytes = counts.step_work(state.model_sizes, B)
    _, hop_bytes = counts.hops_work(state.model_sizes)
    work.update({"rows": steps * B, "least_s": counts.least_time(steps * flops, steps * nbytes),
                 "hop_bytes": steps * hop_bytes,
                 "adam_bytes": steps * adam_bytes(counts.params(state.model_sizes))})


def end_to_end(run, state):
    run.attempted = int(run.work["steps"])
    return {"train_examples_per_s": run.work["rows"] / run.window_s}


def check(run, state):
    state.trainer = state.model = state.feed = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(state)
    # the worst leaf's gap of the gradient as a vector: reported; its norms' gaps (the
    # worst and the median leaf's) and the GCN's last convolution as a vector judged
    run.note("grad_vector_worst", numbers.pop("grad_vector_worst"))
    run.note("worst_passage", numbers.pop("worst_passage"))
    run.note("checked_losses", {"program": state.readings["losses"],
                                "reference": numbers.pop("losses")})
    if run.calibrate:
        readings = {}
        half = len(state.kept[0][0]["user_id"]) // 2
        for label, kw in (("control_bfloat16", {"precision": "bfloat16"}),
                          ("fault_one_hop", {"one_hop": True}),
                          ("fault_no_dropout", {"dropout": 0.0}),
                          ("fault_half_batch", {"rows": half})):
            readings[label] = compare(state, **kw)
            for k in ("worst_passage", "losses", "grad_vector_worst"):
                readings[label].pop(k)
        run.note("calibration", readings)
    return numbers


def compare(state, **kwargs):
    """The cell's numbers against the reference (float64, or as ``kwargs``
    plant it), which starts each step from the program's snapshot before it
    and checks the step's passage to the next (``harness/checks.py::
    passage_numbers``): every parameter of the model is followed, so one
    that the pretrain does not step and that moved counts in
    ``state_mismatch``."""
    from reference.fairgo_gcn import initial_state, train_steps

    spec = state.spec
    ref = train_steps(spec, state.edges, state.kept, state.snapshots, **kwargs)
    numbers, _ = checks.train_numbers(state.readings, ref)
    initial = {n: t.float() for n, t in initial_state(spec, state.weight_seed,
                                                      state.edges[0].device).items()}
    passed, worst = checks.passage_numbers(state.snapshots, ref, initial, spec.lr,
                                           list(state.snapshots[0]["model"]), [])
    passed.pop("buffer_median")  # the model holds no BatchNorm: no buffer moves
    numbers.update(passed)
    vectors = gradient_vector_gaps(state.snapshots, ref)
    # the last convolution's gradient sums the hops' outputs over every row of the graph:
    # taken as a vector it is where a hop's arithmetic shows (a bfloat16 hop turns it by
    # ~1e-3), where the norms may not see it. The first convolution's also passes the
    # ReLU, whose input float32 puts on the other side of 0 than float64 for a few of its
    # 20.9M elements: that moves its gradient by up to ~5e-5 between sound runs, so it is
    # reported in grad_vector_worst, not judged
    last = f"gcn.convs.{spec.n_layers - 1}."
    numbers["gcn_grad_gap"] = max(gap for _, gaps in vectors for n, gap in gaps.items()
                                  if n.startswith(last))
    numbers["grad_vector_worst"] = max((gap, i, n) for i, (_, gaps) in enumerate(vectors)
                                       for n, gap in gaps.items())
    numbers["worst_passage"] = worst
    numbers["losses"] = ref["losses"]
    return numbers
