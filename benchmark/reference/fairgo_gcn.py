"""Plain PyTorch reference of FairGo_GCN's pretrain (Wu, Chen, Shao, Hong
and Wang, "Learning Fair Representations for Recommendation: A Graph-based
Perspective", WWW 2021), as RecBole-FairRec's FairGo_GCN computes it
(``recbole/model/fair_recommender/fairgo_gcn.py``, the GCN backbone of Kipf
& Welling, ICLR 2017, with torch_geometric's ``GCNConv`` semantics). It
imports nothing of the measured program.

The model over a state dict of named tensors:

* the embedding tables ``user_embedding.weight`` and
  ``item_embedding.weight`` stacked into one ``[n, d]`` table X of all
  nodes (users first, PAD rows included);
* Â = D̃^-½ (A + I) D̃^-½: A holds each training rating at (user, item) and
  (item, user), I a self loop of weight 1 at every node (PAD rows too), D̃
  the row sums of A + I; a coalesced sparse float64 COO tensor;
* ``n_layers`` convolutions x' = Â (x W) + b (``gcn.convs.<i>.w`` ``[in,
  out]``, ``gcn.convs.<i>.b``), widths d → hidden → … → d, each hop a
  ``torch.sparse.mm``; ReLU and dropout between the convolutions, not after
  the last. Dropout keeps an element where a ``torch.rand`` draw of the
  activation's shape (float32) is below 1 − p and scales it by 1 / (1 − p);
  the draws come, in the order of the layers, from a ``torch.Generator`` on
  the graph's device set to the state that the program's dropout generator
  had before the step, so the masks are the program's;
* the loss is the mean over the batch of (⟨Z_u, Z_i⟩ − rating)², Z the last
  convolution's output, u a batch row's user and i its item;
* the step is Adam with L2 weight decay added to the gradient, over the two
  tables and every GCN parameter (the trainer's ``pretrain`` group): every
  row of both tables moves each step, reached by the loss or not.

Departures from the published description, none of which changes a number:
the hops are ``torch.sparse.mm`` over the whole table, as the reference
repository's torch_geometric propagation is; the whole batch is one tensor
with no padding rows (the batch weights are all 1); float64 throughout by
default; torch_geometric's ``gcn_norm`` is written out by hand.

``precision``: ``"float64"`` (the default), ``"float32"`` (the
configuration's precision) or ``"bfloat16"``: float64, except that each
hop's matrix and input, and the gradient coming back into each hop, are
rounded to bfloat16. Planted faults: ``one_hop`` (the last convolution's
hop left out: Z = H W + b), ``dropout`` (a rate in place of the spec's; 0
draws no mask) and ``rows`` (only a batch's first rows). TF32 is switched
off while the reference computes.
"""

from __future__ import annotations

import importlib.util
import math
import os

import torch
import torch.nn.functional as F


def _sibling(name):
    """``reference/<name>.py`` by path (the file is also loaded by path,
    outside the benchmark's folder on ``sys.path``)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_fairgo = _sibling("fairgo")
Adam, BETA1, _RoundBF16 = _fairgo.Adam, _fairgo.BETA1, _fairgo._RoundBF16
KIND = "pretrain"


class Spec:
    """Sizes and settings: ``n_users`` and ``n_items`` rows (PAD included),
    ``d`` (the tables' width and the last convolution's), ``hidden``,
    ``n_layers``, ``dropout``, ``lr``, ``weight_decay``."""

    def __init__(self, n_users, n_items, d, hidden, n_layers=2, dropout=0.2, lr=1e-3,
                 weight_decay=0.0):
        self.n_users, self.n_items, self.d, self.hidden = n_users, n_items, d, hidden
        self.n_layers, self.dropout = n_layers, dropout
        self.lr, self.weight_decay = lr, weight_decay

    def sizes(self):
        return [self.d] + [self.hidden] * (self.n_layers - 1) + [self.d]

    def params(self):
        """(name, shape, (fan_in, fan_out)) of every parameter of the step,
        named as the program's state dict names them; fans None for a
        table."""
        out = [("user_embedding.weight", (self.n_users, self.d), None),
               ("item_embedding.weight", (self.n_items, self.d), None)]
        sizes = self.sizes()
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out += [(f"gcn.convs.{i}.w", (a, b), (a, b)), (f"gcn.convs.{i}.b", (b,), (a, b))]
        return out

    def group(self):
        """Parameter names of the pretrain optimizer: all of ``params``."""
        return [n for n, _, _ in self.params()]


def initial_state(spec, seed, device):
    """The benchmark's initial parameters (float32): tables N(0, 1) with the
    PAD row 0 zero, GCN weights Glorot-uniform U(±√(6 / (fan_in +
    fan_out))) and biases 0 (the published init), drawn in the order of
    ``spec.params()`` from one generator on ``device`` seeded with
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    state = {}
    for name, shape, fans in spec.params():
        if fans is None:
            t = torch.randn(shape, generator=gen, device=device)
            t[0] = 0.0
        elif name.endswith(".b"):
            t = torch.zeros(shape, device=device)
        else:
            bound = math.sqrt(6.0 / sum(fans))
            t = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound
        state[name] = t
    return state


class Graph:
    """Â = D̃^-½ (A + I) D̃^-½ of the training ratings (``users``, ``items``,
    ``ratings``: one entry a pair) as a coalesced sparse ``[n, n]`` COO
    tensor of ``dtype``; with ``bfloat16`` its values rounded to
    bfloat16."""

    def __init__(self, spec, users, items, ratings, dtype=torch.float64, bfloat16=False):
        n = spec.n_users + spec.n_items
        u, i = users.long(), items.long() + spec.n_users
        loops = torch.arange(n, device=u.device)
        rows, cols = torch.cat([u, i, loops]), torch.cat([i, u, loops])
        vals = torch.cat([ratings.double(), ratings.double(),
                          torch.ones(n, dtype=torch.float64, device=u.device)])
        deg = torch.bincount(rows, weights=vals, minlength=n)
        inv_sqrt = deg.clamp_min(1e-12).rsqrt()
        vals = inv_sqrt[rows] * vals * inv_sqrt[cols]
        if bfloat16:
            vals = vals.to(torch.bfloat16).double()
        self.matrix = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals.to(dtype), (n, n),
                                              check_invariants=False).coalesce()


class Model:
    """The pretrain's forward pass over a state dict."""

    def __init__(self, spec, state, graph, generator_state=None, precision="float64",
                 one_hop=False, dropout=None):
        self.spec, self.state, self.graph = spec, state, graph
        self.bf16 = precision == "bfloat16"
        self.one_hop = one_hop
        self.p = spec.dropout if dropout is None else dropout
        self.generator_state = generator_state

    def _hop(self, x):
        return torch.sparse.mm(self.graph.matrix, _RoundBF16.apply(x) if self.bf16 else x)

    def gcn(self, x):
        st, L = self.state, self.spec.n_layers
        gen = None
        if self.p > 0:
            gen = torch.Generator(device=x.device)
            gen.set_state(self.generator_state)
        keep = 1.0 - self.p
        for i in range(L):
            h = x @ st[f"gcn.convs.{i}.w"]
            x = (h if self.one_hop and i == L - 1 else self._hop(h)) + st[f"gcn.convs.{i}.b"]
            if i < L - 1:
                x = F.relu(x)
                if self.p > 0:
                    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
                    x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
        return x

    def loss(self, batch):
        st = self.state
        z = self.gcn(torch.cat([st["user_embedding.weight"], st["item_embedding.weight"]]))
        users = batch["user_id"].long()
        items = self.spec.n_users + batch["item_id"].long()
        pred = (z[users] * z[items]).sum(-1)
        return ((pred - batch["rating"].to(pred.dtype)) ** 2).mean()


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def train_steps(spec, edges, steps, follow, precision="float64", rows=None, one_hop=False,
                dropout=None):
    """Each of ``steps`` ((batch, the program's dropout generator state
    before it) in order) from the program's state before it: ``follow``
    holds the program's snapshots (one before each step and one after the
    last: parameters, and each optimizer's moments and step count by name,
    ``harness/probe.py::FirstSteps``). ``edges`` is (users, items, ratings)
    of the training pairs.

    Returns what ``reference/fairgo.py::train_steps`` returns, every step of
    the kind ``pretrain``: ``losses``, ``grad`` and ``raw_grad`` (norms at
    the first step), ``passages`` and ``change``."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_steps(spec, edges, steps, follow, precision, rows, one_hop, dropout)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _train_steps(spec, edges, steps, follow, precision, rows, one_hop, dropout):
    dtype = torch.float32 if precision == "float32" else torch.float64
    graph = Graph(spec, *edges, dtype=dtype, bfloat16=precision == "bfloat16")
    device = graph.matrix.device
    out = {"losses": [], "grad": {}, "raw_grad": {}, "passages": []}
    moved = {}
    names = spec.group()
    for i, (batch, generator_state) in enumerate(steps):
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
        batch = {k: v.to(device) for k, v in batch.items()}
        snap = follow[i]
        state = {n: t.to(device, dtype) for n, t in snap["model"].items()}
        opt = Adam(state, names, spec.lr, spec.weight_decay)
        carried = snap["opt"].get(KIND, {})
        for n in names:
            if n in carried:
                opt.m[n] = carried[n][0].to(device, dtype)
                opt.v[n] = carried[n][1].to(device, dtype)
        if carried:
            opt.t = int(max(c[2] for c in carried.values()))
        leaves = {n: state[n].detach().requires_grad_(True) for n in names}
        state.update(leaves)
        model = Model(spec, state, graph, generator_state, precision, one_hop, dropout)
        loss = model.loss(batch)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        start = {n: leaves[n].detach() for n in names}
        state.update(start)
        seen = opt.step(grads)
        out["losses"].append(float(loss.detach()))
        raw = {n: _norm(grads[n]) for n in names}
        if i == 0:
            out["grad"] = {n: _norm(seen[n]) for n in names}
            out["raw_grad"] = dict(raw)
        for n in names:
            step = state[n].double() - start[n].double()
            moved[n] = step if n not in moved else moved[n] + step
        opts = {tag: dict(m) for tag, m in snap["opt"].items()}
        opts[KIND] = {n: (opt.m[n].float().cpu(), opt.v[n].float().cpu(), float(opt.t))
                      for n in names}
        out["passages"].append({"kind": KIND, "raw_grad": raw, "after": {
            "model": {n: t.detach().float().cpu() for n, t in state.items()}, "opt": opts}})
        del model, loss, grads, seen, leaves, state, opt
    out["change"] = {n: _norm(moved[n]) for n in names}
    return out
