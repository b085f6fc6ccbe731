"""FairGo_PMF's adversarial finetune, step by step, on a synthetic graph at
Last.fm-360K's published scale made on the card from the seed.

The program's own path: ``FairGo_PMF`` built by ``utils.get_model`` with the
program's ``Config``, ``FairGo_PMFTrainer`` on it (``load_pretrain_weight``
puts the model in the finetune stage), and ``Trainer._train_step(batch,
"calculate_loss", subset, trainer.tx_filter)`` for a filter step,
``"calculate_dis_loss"`` with ``trainer.tx_dis`` for a discriminator step,
as ``_run_epoch`` calls them. The model chooses its propagation itself (the
COO path at this size). It reads its sizes, ratings, rating matrix and user
attributes from ``Lastfm``, a dataset object made from the seed (the
program's ETL of 17.6M rows would add minutes to every set-up).

Traffic: cycles of the traffic's ``cycle`` (a filter step, then
discriminator steps), each on one attribute subset whose size follows
``subset_sizes`` in turn (a smaller subset's members from the seed). A
batch is half training rows from a seeded permutation and half one uniform
negative for each of them, carrying its row's rating, as FairGo's train
loader forms its pointwise batches.

Set-up draws the graph, builds the model and trainer, loads the
benchmark's weights and takes the traffic's ``checked_steps`` ((step kind,
subset size)); the comparison checks each one's passage from the
program's snapshot before it against the plain reference
(``reference/fairgo.py``).
"""

from __future__ import annotations

import gc
import itertools
import math
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

from counts import fairgo as counts
from harness import checks
from harness.pfcn import program_config
from harness.probe import FirstSteps
from harness.seeds import derive

# step kind → (loss, the trainer's optimizer attribute)
KINDS = {"filter": ("calculate_loss", "tx_filter"), "dis": ("calculate_dis_loss", "tx_dis")}
DRAWS = 96  # candidates a user, drawn with repeats, for 48-49 distinct artists
NEG_ROUNDS = 4  # rejection rounds of a negative against the user's training pairs


class State:
    pass


# ------------------------------------------------------------------ data


def train_counts(degree, split):
    """Training rows of a user with ``degree`` rows under RS ``split`` by
    user, as the program splits them: each later part takes
    ``int(ratio · degree)`` rows (at least 1 where that is under 1), the
    first the rest."""
    ratios = [r / sum(split) for r in split]
    sizes = [int(r * degree) for r in ratios]
    sizes[0] = degree - sum(sizes[1:])
    for back in range(1, len(ratios)):
        if sizes[0] <= 1:
            break
        if 0 < ratios[-back] * degree < 1:
            sizes[-back], sizes[0] = sizes[-back] + 1, sizes[0] - 1
    return sizes[0]


class Graph:
    """The synthetic Last.fm-360K rows on ``device``: ``users``, ``items``
    and ``ratings`` of every row (by user, each user's artists in draw
    order), ``train`` (the RS split's first part of each user) and the user
    attributes ``features`` (name → ``[n_users]`` values, PAD row 0)."""

    def __init__(self, cfg, seed, device):
        g = cfg["graph"]
        n_users, n_items = g["n_users"], g["n_items"]
        U, I = n_users - 1, n_items - 1
        low = g["degrees"][0]
        extra = g["n_rows"] - low * U
        if not 0 <= extra <= U or g["degrees"][1] != low + 1:
            raise ValueError(f"{g['n_rows']} rows do not spread as {g['degrees']} over {U} users")
        gen = torch.Generator(device=device).manual_seed(derive(seed, "graph"))
        degree = torch.full((U,), low, dtype=torch.int64, device=device)
        degree[torch.randperm(U, generator=gen, device=device)[:extra]] += 1
        weights = torch.arange(1, I + 1, dtype=torch.float64, device=device) \
            ** -g["popularity_exponent"]
        cdf = torch.cumsum(weights, 0) / weights.sum()
        by_rank = torch.randperm(I, generator=gen, device=device) + 1  # artist id of each rank
        draws = torch.rand((U, DRAWS), generator=gen, device=device, dtype=torch.float64)
        ranks = torch.searchsorted(cdf, draws).clamp_(max=I - 1)
        del draws
        # each rank's first draw in the user's order: sampling without repeats
        ordered, where = torch.sort(ranks, dim=1, stable=True)
        new = torch.ones_like(ordered, dtype=torch.bool)
        new[:, 1:] = ordered[:, 1:] != ordered[:, :-1]
        first = torch.empty_like(new).scatter_(1, where, new)
        keep = first & (torch.cumsum(first, dim=1) <= degree[:, None])
        if not bool((keep.sum(dim=1) == degree).all()):
            raise RuntimeError(f"a user drew fewer distinct artists in {DRAWS} draws than "
                               "its degree")
        self.items = by_rank[ranks[keep]]
        del ranks, ordered, where, new, first, keep
        self.users = torch.repeat_interleave(torch.arange(1, U + 1, device=device), degree)
        self.ratings = torch.randint(g["ratings"][0], g["ratings"][1] + 1, (g["n_rows"],),
                                     generator=gen, device=device).to(torch.float32)
        starts = torch.cumsum(degree, 0) - degree
        position = torch.arange(g["n_rows"], device=device) - starts.repeat_interleave(degree)
        n_train = torch.tensor([train_counts(d, g["split"]) for d in g["degrees"]],
                               device=device)[degree - low]
        self.train = position < n_train.repeat_interleave(degree)
        self.degree = degree
        self.features = {}
        for attr, spec in cfg["attributes"].items():
            p = torch.tensor(spec["counts"], dtype=torch.float64, device=device)
            drawn = torch.multinomial(p / p.sum(), U, replacement=True, generator=gen)
            values = torch.tensor(spec["values"], device=device)
            self.features[attr] = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                                             values[drawn]])
        self.n_users, self.n_items = n_users, n_items

    def train_edges(self):
        """(users, items, ratings) of the training rows."""
        t = self.train
        return self.users[t], self.items[t], self.ratings[t]


class Lastfm:
    """The dataset object the model's constructor reads: sizes, the
    training ratings and their matrix, the user attributes and the
    preloaded tables."""

    def __init__(self, graph, tables, rating_field="rating"):
        users, items, ratings = (t.cpu().numpy() for t in graph.train_edges())
        self._n = {"user_id": graph.n_users, "item_id": graph.n_items}
        self._coo = (users, items, ratings)
        self.inter_feat = {rating_field: ratings}
        self._features = {k: v.cpu().numpy() for k, v in graph.features.items()}
        self._tables = tables

    def num(self, field):
        return self._n[field]

    def inter_matrix(self, form="coo", value_field=None):
        import scipy.sparse as sp

        if form != "coo":
            raise ValueError(f"only the coo form is made here, not {form}")
        users, items, ratings = self._coo
        return sp.coo_matrix((ratings, (users, items)),
                             shape=(self._n["user_id"], self._n["item_id"]))

    def get_user_feature(self):
        return self._features

    def get_preload_weight(self, field):
        return self._tables[field]


# ------------------------------------------------------------------ model


def model_spec(cfg):
    from reference.fairgo import Spec

    s, g = cfg["settings"], cfg["graph"]
    attrs = {a: len(cfg["attributes"][a]["values"]) for a in s["sst_attr_list"]}
    return Spec(g["n_users"], g["n_items"], s["embedding_size"], attrs,
                s["filter_hidden_size_list"], s["dis_hidden_size_list"], s["n_layers"],
                s["fair_weight"], s["learning_rate"], s["weight_decay"])


def labels(cfg, device):
    """Attribute value → class (sorted values → 0..k-1), for the reference."""
    out = {}
    for attr, spec in cfg["attributes"].items():
        values = torch.tensor(sorted(spec["values"]), device=device)
        lut = torch.zeros(int(values.max()) + 1, dtype=torch.int64, device=device)
        lut[values] = torch.arange(len(values), device=device)
        out[attr] = lut
    return out


def model_sizes(cfg, edges):
    s, g = cfg["settings"], cfg["graph"]
    return {"n_nodes": g["n_users"] + g["n_items"], "edges": edges,
            "embedding_size": s["embedding_size"], "filter_hidden": s["filter_hidden_size_list"],
            "dis_hidden": s["dis_hidden_size_list"], "n_layers": s["n_layers"],
            "attributes": {a: len(cfg["attributes"][a]["values"]) for a in s["sst_attr_list"]}}


# ----------------------------------------------------------------- traffic


def subset_plan(attrs, sizes, seed, cycle):
    """The attribute subset of ``cycle``: its size from ``sizes`` in turn,
    its members drawn from the seed."""
    size = sizes[cycle % len(sizes)]
    options = list(itertools.combinations(attrs, size))
    rs = np.random.RandomState(derive(seed, "subset", str(cycle)))
    return options[rs.randint(len(options))]


class Feed:
    """Batches of ``batch`` rows: ``batch // 2`` training rows in the order
    of a seeded permutation (a new one once a pass is used up), then one
    uniform negative for each, carrying its row's rating. For every batch
    of a permutation also its distinct users and the matrix entries they
    hold, read once when the permutation is drawn."""

    def __init__(self, graph, batch, seed, device):
        self.users, self.items, self.ratings = graph.train_edges()
        self.features = graph.features
        self.n_items = graph.n_items
        self.half = batch // 2
        self.used = torch.sort(self.users * self.n_items + self.items).values
        self.entries = torch.bincount(self.users, minlength=graph.n_users)  # a user's row of D⁻¹A
        self.gen = torch.Generator(device=device).manual_seed(derive(seed, "feed"))
        self.device = device
        self._new_pass()

    def _new_pass(self):
        n = self.users.numel()
        self.order = torch.randperm(n, generator=self.gen, device=self.device)
        nb = n // self.half
        users = self.users[self.order[: nb * self.half]].view(nb, self.half)
        ordered = torch.sort(users, dim=1).values
        new = torch.ones_like(ordered, dtype=torch.bool)
        new[:, 1:] = ordered[:, 1:] != ordered[:, :-1]
        self.distinct = new.sum(dim=1).cpu().numpy()
        self.user_entries = (self.entries[ordered] * new).sum(dim=1).cpu().numpy()
        self.at, self.n_batches = 0, nb

    def _negatives(self, users):
        shape = (NEG_ROUNDS, users.numel())
        draws = torch.randint(1, self.n_items, shape, generator=self.gen, device=self.device)
        keys = users[None] * self.n_items + draws
        pos = torch.searchsorted(self.used, keys).clamp_(max=self.used.numel() - 1)
        good = self.used[pos] != keys
        pick = torch.where(good.any(dim=0), good.to(torch.uint8).argmax(dim=0), NEG_ROUNDS - 1)
        return draws.gather(0, pick[None]).squeeze(0)

    def draw(self):
        """(batch, its index in the pass)."""
        if self.at == self.n_batches:
            self._new_pass()
        b = self.at
        idx = self.order[b * self.half:(b + 1) * self.half]
        self.at += 1
        u, i, r = self.users[idx], self.items[idx], self.ratings[idx]
        users = torch.cat([u, u])
        batch = {"user_id": users, "item_id": torch.cat([i, self._negatives(u)]),
                 "rating": torch.cat([r, r])}
        for attr, values in self.features.items():
            batch[attr] = values[users]
        return batch, b


# ----------------------------------------------------------------- driver


def setup(run):
    from recbole_fairrec_tpu_torch.trainer.adversarial import FairGoTrainer
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer
    from reference.fairgo import initial_state

    cfg, device, traffic = run.config, run.device, run.traffic
    graph = Graph(cfg, derive(run.seed, "data"), device)
    spec = model_spec(cfg)
    weight_seed = derive(run.seed, "weights")
    initial = initial_state(spec, weight_seed, device)
    tables = {"uid": initial["user_embedding.weight"].cpu().numpy(),
              "iid": initial["item_embedding.weight"].cpu().numpy()}
    config = program_config(run, cfg["name"], {"train_batch_size": cfg["train_batch_size"]})
    dataset = Lastfm(graph, tables, config["RATING_FIELD"])
    del tables
    with device:  # the model's own init draws on the card; the benchmark's weights replace it
        model = get_model(cfg["model"])(config, dataset,
                                        generator=torch.Generator(device=device).manual_seed(0))
    del dataset
    trainer = get_trainer(config["MODEL_TYPE"], cfg["model"])(config, model)
    if not isinstance(trainer, FairGoTrainer) or model.train_stage != "finetune":
        raise RuntimeError(f"{type(trainer).__name__} left the model in stage "
                           f"{model.train_stage!r}, not finetune")
    with torch.no_grad():
        model.load_state_dict(initial, strict=True)
    del initial
    attrs = list(spec.attributes)
    feed = Feed(graph, cfg["train_batch_size"], run.seed, device)
    state = State()
    state.trainer, state.model, state.feed = trainer, model, feed
    state.edges = graph.train_edges()
    state.n_entries = int(model.norm_rows.numel())
    state.path = "dense" if model.dense_propagation else "coo"
    del graph
    state.attrs, state.sizes = attrs, traffic["subset_sizes"]
    state.cycle, state.pos, state.subset = 0, 0, None
    state.spec, state.weight_seed = spec, weight_seed
    state.model_sizes = model_sizes(cfg, state.n_entries)
    tx = {kind: getattr(trainer, attr) for kind, (_, attr) in KINDS.items()}
    state.tx = tx
    probe = FirstSteps(model, tx)
    model.train()
    kept = []
    for kind, size in traffic["checked_steps"]:
        subset = next(subset_plan(attrs, state.sizes, run.seed, c) for c in itertools.count()
                      if state.sizes[c % len(state.sizes)] == size)
        batch, _ = feed.draw()
        kept.append(({k: v.clone() for k, v in batch.items()}, kind, subset))
        probe.snapshot()
        loss = trainer._train_step(batch, KINDS[kind][0], subset, tx[kind])
        probe.after_step(loss, tx[kind])
    state.kept, state.readings = kept, probe.finish()
    state.snapshots = probe.snapshots
    run.note("propagation", {"path": state.path, "entries": state.n_entries})
    return state


def window(run, state, seconds):
    trainer, feed, tx, cycle_kinds = state.trainer, state.feed, state.tx, run.traffic["cycle"]
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        kind = cycle_kinds[state.pos]
        if state.pos == 0 or state.subset is None:
            state.subset = subset_plan(state.attrs, state.sizes, run.seed, state.cycle)
        subset = state.subset
        batch, b = feed.draw()
        with run.rec.span("finetune.step"):
            trainer._train_step(batch, KINDS[kind][0], subset, tx[kind])
        names = ",".join(subset)
        run.work[f"steps|{kind}|{names}"] += 1
        if kind == "filter":
            run.work[f"cycles|{names}"] += 1
        run.work["batch_users"] += float(feed.distinct[b])
        run.work["batch_entries"] += float(feed.user_entries[b])
        state.pos += 1
        if state.pos == len(cycle_kinds):
            state.pos, state.cycle = 0, state.cycle + 1


def account(run, state, work):
    """Rows, steps by kind and the least time (``counts/fairgo.py``) of the
    work tallied in ``work``: a cycle's share at each filter step, the
    batch side at every step, at the distinct users the batches held."""
    model, B = state.model_sizes, run.config["train_batch_size"]
    tallies = [(k.split("|"), n) for k, n in work.items() if "|" in k]
    n_steps = sum(n for (what, *_), n in tallies if what == "steps")
    users = work.get("batch_users", 0.0) / max(n_steps, 1)
    entries = work.get("batch_entries", 0.0) / max(n_steps, 1)
    flops = nbytes = 0.0
    out = defaultdict(float)
    for (what, *rest), n in tallies:
        if what == "cycles":
            f, b = counts.cycle_work(model, len(rest[0].split(",")))
        elif what == "steps":
            out[f"steps.{rest[0]}"] += n
            f, b = counts.step_work(model, B, users, entries, rest[1].split(","))
        else:
            continue
        flops, nbytes = flops + n * f, nbytes + n * b
    out.update({"steps": n_steps, "rows": n_steps * B,
                "least_s": counts.least_time(flops, nbytes)})
    work.update(out)


def end_to_end(run, state):
    run.attempted = int(run.work["steps"])
    run.note("steps", {k: v for k, v in run.work.items() if k.startswith("steps.")})
    return {"train_examples_per_s": run.work["rows"] / run.window_s}


def check(run, state):
    spec = state.spec
    state.trainer = state.model = state.feed = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    lut = labels(run.config, run.device)
    numbers = compare(state, spec, lut)
    # the worst leaf's gap of the gradient's norm swings between sound runs as the
    # vector's does (gradient_vector_gaps): reported, the median leaf judged
    run.note("grad_worst", numbers.pop("grad_worst"))
    run.note("grad_vector_worst", numbers.pop("grad_vector_worst"))
    run.note("worst_passage", numbers.pop("worst_passage"))
    run.note("checked_losses", {"program": state.readings["losses"],
                                "reference": numbers.pop("losses")})
    if run.calibrate:
        readings = {}
        for label, kw in (("control_bfloat16", {"precision": "bfloat16"}),
                          ("fault_one_hop", {"one_hop": True}),
                          ("fault_half_batch",
                           {"rows": len(state.kept[0][0]["user_id"]) // 2})):
            readings[label] = compare(state, spec, lut, **kw)
            for k in ("worst_passage", "losses", "grad_vector_worst"):
                readings[label].pop(k)
        run.note("calibration", readings)
    return numbers


def compare(state, spec, lut, **kwargs):
    """The cell's numbers against the reference (float64, or as ``kwargs``
    plant it), which starts each step from the program's snapshot before it
    and checks the step's passage to the next (``harness/checks.py::
    passage_numbers``)."""
    from reference.fairgo import initial_state, train_steps

    ref = train_steps(spec, state.edges, lut, state.kept, state.snapshots, **kwargs)
    numbers, _ = checks.train_numbers(state.readings, ref)
    initial = {n: t.float() for n, t in initial_state(spec, state.weight_seed,
                                                      state.edges[0].device).items()}
    passed, worst = checks.passage_numbers(state.snapshots, ref, initial, spec.lr,
                                           [n for n, _, _ in spec.params()], [])
    passed.pop("buffer_median")  # FairGo's MLPs hold no BatchNorm: no buffer moves
    numbers.update(passed)
    vectors = gradient_vector_gaps(state.snapshots, ref)
    # the LBA head reads the hops directly: its gradient in the discriminator steps is
    # where the propagation's arithmetic shows (a hop in bfloat16 turns it by ~1e-4 to
    # 1e-3 while keeping its norm). Any leaf's gradient also swings by up to ~1e-4
    # between sound runs, where float32 puts a leaky ReLU's input on the other side of
    # 0 than float64 for a row: reported, not judged
    numbers["lba_grad_gap"] = max(gap for kind, gaps in vectors if kind == "dis"
                                  for n, gap in gaps.items() if n.startswith("aggr."))
    numbers["grad_vector_worst"] = max((gap, i, n) for i, (_, gaps) in enumerate(vectors)
                                       for n, gap in gaps.items())
    numbers["worst_passage"] = worst
    numbers["losses"] = ref["losses"]
    return numbers


def gradient_vector_gaps(snapshots, ref):
    """Per step, its kind and, per leaf, the gap of the gradient as a
    vector, where ``train_numbers`` compares norms: each step moves its
    optimizer's first moment by (1 − β1)·g from the same moments before
    (the reference starts from the program's), so the program's move
    against the reference's is the gradients' gap. Against the norm of the
    reference's move of that leaf or of the median leaf, whichever is
    larger; leaves whose gradient is nought to rounding left out."""
    from reference.fairgo import BETA1

    out = []
    for i, passage in enumerate(ref["passages"]):
        kind = passage["kind"]
        before, prog = snapshots[i]["opt"].get(kind, {}), snapshots[i + 1]["opt"].get(kind, {})
        mine = passage["after"]["opt"][kind]
        moves = {}
        for n in checks.reached(passage["raw_grad"]):
            if n not in prog:
                moves[n] = (math.inf, 1.0)
                continue
            m0 = before[n][0].double() if n in before else 0.0
            ref_move = mine[n][0].double() - BETA1 * m0
            moves[n] = (float(torch.linalg.vector_norm(prog[n][0].double() - BETA1 * m0
                                                       - ref_move)),
                        float(torch.linalg.vector_norm(ref_move)))
        sizes = [size for _, size in moves.values() if size > 0]
        median = statistics.median(sizes) if sizes else 0.0
        out.append((kind, {n: gap / max(size, median, 1e-30)
                           for n, (gap, size) in moves.items()}))
    return out
