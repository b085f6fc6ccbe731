"""Plain PyTorch reference of FairGo's adversarial finetune (Wu, Chen, Shao,
Hong and Wang, "Learning Fair Representations for Recommendation: A
Graph-based Perspective", WWW 2021), as RecBole-FairRec's FairGo_PMF
computes it. It imports nothing of the measured program.

The model over a state dict of named tensors:

* the embedding tables ``user_embedding.weight`` and
  ``item_embedding.weight`` stacked into one ``[n, d]`` table of all nodes
  (users first, PAD rows included);
* one filter MLP per sensitive attribute (``filters.<attr>``); the filtered
  table is the sum of the filters of the step's attribute subset over the
  WHOLE table, divided by the number of ALL attributes;
* an MLP layer is ``x @ w + b`` then leaky ReLU (slope 0.01), the
  activation after every layer, the last one included; no BatchNorm, no
  dropout;
* the rating matrix's bipartite graph normalised by rows, ``D⁻¹A``: A holds
  each training rating at (user, item) and (item, user), D is A's row sum
  plus 1e-7; ``n_layers`` hops of it over the filtered table, each
  ``torch.sparse.mm`` of a coalesced sparse COO matrix;
* the LBA head (``aggr.l1/l2/l3``) over the hops laid side by side:
  Linear → leaky ReLU → Linear → leaky ReLU → Linear;
* per attribute of the subset a discriminator MLP (``discriminators.<attr>``)
  over the batch's users twice: their filtered rows (the node term) and
  their rows of the LBA head's output (the local term). A binary attribute
  is read through a sigmoid and binary cross-entropy; any other through
  softmax cross-entropy, except that the local term's logits go through a
  sigmoid first, as the reference repository does (kept on purpose);
  attribute values map to classes in sorted order (``labels``);
* the filter step's loss is MSE(score, rating) − ``fair_weight`` × the
  discriminator loss, its optimizer the filters; the discriminator step's
  loss is the discriminator loss, its optimizer the discriminators and the
  LBA head. Parameters of the optimizer that the loss does not reach get a
  zero gradient; weight decay still applies. Adam with L2 weight decay
  added to the gradient.

The departures from a line-by-line copy of the reference repository, none
of which changes a number: the hops are taken over the whole table once
and read at the batch's users (the reference does the same); the whole
batch is one tensor with no padding rows; float64 throughout by default.

``precision``: ``"float64"`` (the default) or ``"bfloat16"``: float64,
except that each hop's matrix and input, and the gradient coming back into
each hop, are rounded to bfloat16, as the program's ``propagation_dtype:
bfloat16`` computes them (bfloat16 operands, a wide sum). Planted faults:
``one_hop`` (the last hop replaced by the first), ``quirk=False`` (no
sigmoid before the multiclass local cross-entropy) and ``rows`` (only a
batch's first rows).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class Spec:
    """Sizes and settings: ``n_users`` and ``n_items`` rows (PAD included),
    ``d``, ``attributes`` (name → number of classes, in the
    configuration's order), ``filter_hidden``, ``dis_hidden``,
    ``n_layers``, ``fair_weight``, ``lr``, ``weight_decay``."""

    def __init__(self, n_users, n_items, d, attributes, filter_hidden, dis_hidden, n_layers=2,
                 fair_weight=0.1, lr=1e-3, weight_decay=0.0):
        self.n_users, self.n_items, self.d = n_users, n_items, d
        self.attributes = dict(attributes)
        self.filter_hidden, self.dis_hidden = list(filter_hidden), list(dis_hidden)
        self.n_layers, self.fair_weight = n_layers, fair_weight
        self.lr, self.weight_decay = lr, weight_decay

    def filter_sizes(self):
        return [self.d] + self.filter_hidden + [self.d]

    def dis_sizes(self, attr):
        k = self.attributes[attr]
        return [self.d] + self.dis_hidden + [1 if k == 2 else k]

    def params(self):
        """(name, shape, fan_in) of every parameter, named as the program's
        state dict names them; fan_in None for a table."""
        out = [("user_embedding.weight", (self.n_users, self.d), None),
               ("item_embedding.weight", (self.n_items, self.d), None)]
        for prefix, sizes in ([(f"filters.{a}", self.filter_sizes()) for a in self.attributes]
                              + [(f"discriminators.{a}", self.dis_sizes(a))
                                 for a in self.attributes]):
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
                out += [(f"{prefix}.linear.{i}.w", (a, b), a), (f"{prefix}.linear.{i}.b", (b,), a)]
        d, L = self.d, self.n_layers
        for name, a in (("l1", L * d), ("l2", d), ("l3", d)):
            out += [(f"aggr.{name}.w", (a, d), a), (f"aggr.{name}.b", (d,), a)]
        return out

    def group(self, kind):
        """Parameter names of a step kind's optimizer."""
        names = [n for n, _, _ in self.params()]
        if kind == "filter":
            return [n for n in names if n.startswith("filters.")]
        return [n for n in names if n.startswith(("discriminators.", "aggr."))]


def initial_state(spec, seed, device):
    """The benchmark's initial parameters (float32): tables N(0, 1) with the
    PAD row 0 zero, MLP weights and biases U(±1/√fan_in) (``nn.Linear``'s
    default, the published init), drawn in the order of ``spec.params()``
    from one generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    state = {}
    for name, shape, fan_in in spec.params():
        if fan_in is None:
            t = torch.randn(shape, generator=gen, device=device)
            t[0] = 0.0
        else:
            t = (torch.rand(shape, generator=gen, device=device) * 2 - 1) / math.sqrt(fan_in)
        state[name] = t
    return state


class Graph:
    """``D⁻¹A`` of the training ratings (``users``, ``items``, ``ratings``:
    one entry a pair) as a coalesced sparse ``[n, n]`` float64 COO tensor;
    with ``bfloat16`` its values rounded to bfloat16."""

    def __init__(self, spec, users, items, ratings, bfloat16=False):
        n = spec.n_users + spec.n_items
        u, i = users.long(), items.long() + spec.n_users
        rows, cols = torch.cat([u, i]), torch.cat([i, u])
        vals = torch.cat([ratings, ratings]).to(torch.float64)
        deg = torch.bincount(rows, weights=vals, minlength=n)
        vals = vals / (deg[rows] + 1e-7)
        if bfloat16:
            vals = vals.to(torch.bfloat16).double()
        self.matrix = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n),
                                              check_invariants=False).coalesce()


class _RoundBF16(torch.autograd.Function):
    """``x`` rounded to bfloat16 (kept in its own type); the gradient coming
    back rounded too."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _mlp(state, prefix, n_layers, x):
    for i in range(n_layers):
        x = F.leaky_relu(x @ state[f"{prefix}.linear.{i}.w"] + state[f"{prefix}.linear.{i}.b"],
                         0.01)
    return x


class Model:
    """Forward passes of the finetune over a state dict."""

    def __init__(self, spec, state, graph, labels, precision="float64", one_hop=False,
                 quirk=True):
        self.spec, self.state, self.graph, self.labels = spec, state, graph, labels
        self.bf16 = precision == "bfloat16"
        self.one_hop, self.quirk = one_hop, quirk

    def filtered(self, subset):
        st, spec = self.state, self.spec
        ego = torch.cat([st["user_embedding.weight"], st["item_embedding.weight"]])
        out = sum(_mlp(st, f"filters.{a}", len(spec.filter_sizes()) - 1, ego) for a in subset)
        return out / len(spec.attributes)

    def hops(self, x):
        out = []
        for _ in range(self.spec.n_layers):
            if self.one_hop and out:
                out.append(out[0])
                continue
            x = torch.sparse.mm(self.graph.matrix, _RoundBF16.apply(x) if self.bf16 else x)
            out.append(x)
        return out

    def local(self, hops):
        st = self.state
        x = F.leaky_relu(torch.cat(hops, dim=1) @ st["aggr.l1.w"] + st["aggr.l1.b"], 0.01)
        x = F.leaky_relu(x @ st["aggr.l2.w"] + st["aggr.l2.b"], 0.01)
        return x @ st["aggr.l3.w"] + st["aggr.l3.b"]

    def dis_loss(self, table, batch, subset):
        users = batch["user_id"].long()
        node = table[users]
        local = self.local(self.hops(table))[users]
        total = 0.0
        for attr in subset:
            n_layers = len(self.spec.dis_sizes(attr)) - 1
            labels = self.labels[attr].to(users.device)[batch[attr].long()]
            out_node = _mlp(self.state, f"discriminators.{attr}", n_layers, node)
            out_local = _mlp(self.state, f"discriminators.{attr}", n_layers, local)
            if self.spec.attributes[attr] == 2:
                t = labels.to(node.dtype)[:, None]
                total = total + F.binary_cross_entropy(torch.sigmoid(out_node), t) \
                    + F.binary_cross_entropy(torch.sigmoid(out_local), t)
            else:
                local_logits = torch.sigmoid(out_local) if self.quirk else out_local
                total = total + F.cross_entropy(out_node, labels) \
                    + F.cross_entropy(local_logits, labels)
        return total

    def loss(self, batch, kind, subset):
        table = self.filtered(subset)
        if kind == "dis":
            return self.dis_loss(table, batch, subset)
        n_users = self.spec.n_users
        pred = (table[batch["user_id"].long()] * table[n_users + batch["item_id"].long()]).sum(-1)
        mse = ((pred - batch["rating"].to(pred.dtype)) ** 2).mean()
        return mse - self.spec.fair_weight * self.dis_loss(table, batch, subset)


class Adam:
    """Adam with L2 weight decay added to the gradient, over named leaves of
    a state dict."""

    def __init__(self, state, names, lr, weight_decay):
        self.state, self.names = state, list(names)
        self.lr, self.wd = lr, weight_decay
        self.m = {n: torch.zeros_like(state[n]) for n in self.names}
        self.v = {n: torch.zeros_like(state[n]) for n in self.names}
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        """One update; returns the gradients as the update saw them."""
        self.t += 1
        bc1, bc2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
        seen = {}
        for n in self.names:
            p = self.state[n]
            g = grads[n] + self.wd * p
            seen[n] = g
            self.m[n] = BETA1 * self.m[n] + (1 - BETA1) * g
            self.v[n] = BETA2 * self.v[n] + (1 - BETA2) * g * g
            denom = torch.sqrt(self.v[n]) / bc2 ** 0.5 + EPS
            self.state[n] = p - (self.lr / bc1) * self.m[n] / denom
        return seen


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def train_steps(spec, edges, labels, steps, follow, precision="float64", rows=None,
                one_hop=False, quirk=True):
    """Each of ``steps`` ((batch, kind, subset) in order) from the program's
    state before it: ``follow`` holds the program's snapshots (one before
    each step and one after the last: parameters, and each optimizer's
    moments and step count by name, ``harness/probe.py::FirstSteps``).
    ``edges`` is (users, items, ratings) of the training pairs.

    Returns ``losses`` (one a step), ``grad`` (name → norm of each
    optimizer's first gradient as its update saw it), ``raw_grad`` (name →
    norm of the loss's own gradient at that optimizer's first step),
    ``passages`` (a step: its kind, the raw gradients' norms, and the state
    it reaches from the snapshot before it, in the snapshot's form) and
    ``change`` (name → norm of the sum of the reference's own updates)."""
    graph = Graph(spec, *edges, bfloat16=precision == "bfloat16")
    device = graph.matrix.device
    out = {"losses": [], "grad": {}, "raw_grad": {}, "passages": []}
    moved, seen_kinds = {}, set()
    for i, (batch, kind, subset) in enumerate(steps):
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
        batch = {k: v.to(device) for k, v in batch.items()}
        snap = follow[i]
        state = {n: t.to(device, torch.float64) for n, t in snap["model"].items()}
        names = spec.group(kind)
        opt = Adam(state, names, spec.lr, spec.weight_decay)
        carried = snap["opt"].get(kind, {})
        for n in names:
            if n in carried:
                opt.m[n] = carried[n][0].to(device, torch.float64)
                opt.v[n] = carried[n][1].to(device, torch.float64)
        if carried:
            opt.t = int(max(c[2] for c in carried.values()))
        leaves = {n: state[n].detach().requires_grad_(True) for n in names}
        state.update(leaves)
        model = Model(spec, state, graph, labels, precision, one_hop, quirk)
        loss = model.loss(batch, kind, subset)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(leaves[n]))
                 for n, g in zip(names, grads)}
        start = {n: leaves[n].detach() for n in names}
        state.update(start)
        seen = opt.step(grads)
        out["losses"].append(float(loss.detach()))
        raw = {n: _norm(grads[n]) for n in names}
        if kind not in seen_kinds:
            seen_kinds.add(kind)
            out["grad"].update({n: _norm(seen[n]) for n in names})
            out["raw_grad"].update(raw)
        for n in names:
            step = state[n].double() - start[n].double()
            moved[n] = step if n not in moved else moved[n] + step
        opts = {tag: dict(m) for tag, m in snap["opt"].items()}
        opts[kind] = {n: (opt.m[n].float().cpu(), opt.v[n].float().cpu(), float(opt.t))
                      for n in names}
        out["passages"].append({"kind": kind, "raw_grad": raw, "after": {
            "model": {n: t.detach().float().cpu() for n, t in state.items()}, "opt": opts}})
        del model, loss, grads, seen, leaves, state
    out["change"] = {n: _norm(moved[n]) if n in moved else 0.0 for n, _, _ in spec.params()}
    return out
