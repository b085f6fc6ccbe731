"""Plain PyTorch reference of PFCN_PMF training: matrix factorisation with
BPR, and with ``filter_mode: sm`` one filter MLP per subset of the
sensitive attributes against one discriminator MLP per attribute; dense Adam
with L2 weight decay. It imports nothing of the measured program.

The model, as RecBole-FairRec's PFCN_PMF defines it:

* a user row ``u`` and item rows; a score is ``f(u) · i`` where ``f`` is
  the filter of the step's attribute subset (``f<Σ 2^i>`` over the
  attributes' positions), or the identity without filters;
* an MLP layer is dropout → ``x @ w + b`` → BatchNorm → leaky ReLU (slope
  0.01), the activation after every layer, the last one included; in
  training BatchNorm uses the batch's biased statistics and moves its
  running mean and unbiased variance with momentum 0.1; filters run without
  dropout, discriminators with ``dis_dropout``;
* BPR loss ``mean(−log(1e-10 + σ(pos − neg)))``; a binary attribute's
  discriminator is read through a sigmoid and binary cross-entropy, any
  other's through softmax cross-entropy; attribute values map to classes in
  sorted order;
* the filter step's loss is BPR − ``dis_weight`` × Σ discriminator losses,
  with the filter run a second time for the discriminator term; its
  optimizer holds both tables and every filter. The discriminator step's
  loss is Σ discriminator losses on the filtered users; its optimizer holds
  the discriminators. Parameters of an optimizer that the loss does not
  reach get a zero gradient (weight decay still applies).

Dropout masks are drawn with ``torch.rand`` from a generator on the
tensors' device seeded with the run's model seed, one draw per
discriminator layer in attribute order: the same stream the configuration's
seed defines for the program.

``precision`` selects how the arithmetic runs: ``"float32"`` (TF32 off),
``"tf32"`` (every MLP product's operands rounded to TF32's 10-bit mantissa)
or ``"bfloat16"`` (parameters, moments and arithmetic in bfloat16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def round_tf32(x):
    """``x`` (float32) rounded to TF32: 10 explicit mantissa bits, round to
    nearest, ties to even."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32).view_as(x)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with the operands of the forward product and of both
    backward products rounded to TF32, as TF32 matmuls compute."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


def _wide(x):
    """Half-precision values widened to float32 for the loss; others as
    they are."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _matmul(precision):
    if precision == "tf32":
        return _TF32MatMul.apply
    return lambda a, b: a @ b


# ------------------------------------------------------------------ leaves


def filter_sizes(d):
    return [d, 2 * d, d]


def dis_sizes(d, hidden, n_classes):
    return [d] + list(hidden) + [1 if n_classes == 2 else n_classes]


def _mlp_leaves(prefix, sizes):
    out = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out += [(f"{prefix}.linear.{i}.w", (a, b), "w"), (f"{prefix}.linear.{i}.b", (b,), "zero"),
                (f"{prefix}.bn.{i}.gamma", (b,), "one"), (f"{prefix}.bn.{i}.beta", (b,), "zero")]
    return out


def _mlp_buffers(prefix, sizes):
    out = []
    for i, b in enumerate(sizes[1:]):
        out += [(f"{prefix}.bn.{i}.mean", (b,), "zero"), (f"{prefix}.bn.{i}.var", (b,), "one")]
    return out


class Spec:
    """The model's sizes: ``n_users`` and ``n_items`` rows (PAD included),
    ``d``, ``filter_mode`` (``sm`` or ``none``), ``attributes`` (name →
    number of classes, in the configuration's order), ``dis_hidden``,
    ``dis_dropout``, ``dis_weight``, ``lr``, ``weight_decay``."""

    def __init__(self, n_users, n_items, d, filter_mode="none", attributes=None,
                 dis_hidden=(), dis_dropout=0.0, dis_weight=0.0, lr=1e-3, weight_decay=0.0):
        if filter_mode not in ("sm", "none"):
            raise ValueError(f"the reference covers filter_mode sm and none, not {filter_mode}")
        self.n_users, self.n_items, self.d = n_users, n_items, d
        self.filter_mode = filter_mode
        self.attributes = dict(attributes or {})
        self.dis_hidden = list(dis_hidden)
        self.dis_dropout, self.dis_weight = dis_dropout, dis_weight
        self.lr, self.weight_decay = lr, weight_decay

    @property
    def filtered(self):
        return self.filter_mode != "none"

    def filter_names(self):
        if not self.filtered:
            return []
        return [f"filters.f{i}" for i in range(1, 2 ** len(self.attributes))]

    def dis_layers(self, attr):
        return dis_sizes(self.d, self.dis_hidden, self.attributes[attr])

    def params(self):
        """(name, shape, init) of every parameter, named as the program's
        state dict names them."""
        out = [("user_embedding.weight", (self.n_users, self.d), "table"),
               ("item_embedding.weight", (self.n_items, self.d), "table")]
        for name in self.filter_names():
            out += _mlp_leaves(name, filter_sizes(self.d))
        if self.filtered:
            for attr in self.attributes:
                out += _mlp_leaves(f"discriminators.{attr}", self.dis_layers(attr))
        return out

    def buffers(self):
        out = []
        for name in self.filter_names():
            out += _mlp_buffers(name, filter_sizes(self.d))
        if self.filtered:
            for attr in self.attributes:
                out += _mlp_buffers(f"discriminators.{attr}", self.dis_layers(attr))
        return out

    def group(self, kind):
        """Parameter names of a step kind's optimizer."""
        names = [n for n, _, _ in self.params()]
        if kind == "dis":
            return [n for n in names if n.startswith("discriminators.")]
        return [n for n in names if not n.startswith("discriminators.")]

    def filter_of(self, subset):
        order = list(self.attributes)
        return f"filters.f{sum(2 ** order.index(a) for a in subset)}"


def initial_state(spec, seed, device, dtype=torch.float32):
    """The benchmark's initial parameters and buffers: tables N(0, 1), MLP
    weights N(0, 0.01) (the published inits), biases and BatchNorm's beta
    0, gamma 1, running mean 0 and variance 1. The random leaves are one
    draw from a generator on ``device`` seeded with ``seed``, in the order
    of ``spec.params()``."""
    leaves = spec.params() + spec.buffers()
    drawn = [(n, s, k) for n, s, k in leaves if k in ("table", "w")]
    total = sum(_numel(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    state, at = {}, 0
    for name, shape, kind in leaves:
        if kind in ("table", "w"):
            n = _numel(shape)
            t = flat[at:at + n].view(shape)
            at += n
            state[name] = (t * 0.01 if kind == "w" else t).to(dtype)
        else:
            fill = 1.0 if kind == "one" else 0.0
            state[name] = torch.full(shape, fill, device=device, dtype=dtype)
    return state


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


# ----------------------------------------------------------------- forward


class Model:
    """Functional forward passes over a state dict (parameters and BatchNorm
    buffers), moving the buffers in place in training."""

    def __init__(self, spec, state, labels, model_seed, precision="float32"):
        self.spec, self.state, self.labels = spec, state, labels
        self.mm = _matmul(precision)
        self.gen = None
        if spec.filtered:
            device = state["user_embedding.weight"].device
            self.gen = torch.Generator(device=device).manual_seed(int(model_seed))

    def mlp(self, prefix, n_layers, x, train, dropout=0.0):
        keep = 1.0 - dropout
        st = self.state
        for i in range(n_layers):
            if train and dropout > 0.0:
                mask = torch.rand(x.shape, generator=self.gen, device=x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
            x = self.mm(x, st[f"{prefix}.linear.{i}.w"]) + st[f"{prefix}.linear.{i}.b"]
            mean_key, var_key = f"{prefix}.bn.{i}.mean", f"{prefix}.bn.{i}.var"
            if train:
                rows = x.shape[0]
                mean = x.mean(dim=0)
                var = ((x - mean) ** 2).mean(dim=0)
                with torch.no_grad():
                    st[mean_key] = 0.9 * st[mean_key] + 0.1 * mean
                    st[var_key] = 0.9 * st[var_key] + 0.1 * var * rows / max(rows - 1, 1)
            else:
                mean, var = st[mean_key], st[var_key]
            x = (x - mean) / torch.sqrt(var + 1e-5) * st[f"{prefix}.bn.{i}.gamma"] \
                + st[f"{prefix}.bn.{i}.beta"]
            x = F.leaky_relu(x, 0.01)
        return x

    def user_repr(self, users, subset, train):
        u = self.state["user_embedding.weight"][users]
        if not self.spec.filtered or not subset:
            return u
        return self.mlp(self.spec.filter_of(subset), 2, u, train)

    def dis_loss(self, user_repr, batch, subset):
        total = 0.0
        for attr in subset:
            out = self.mlp(f"discriminators.{attr}", len(self.spec.dis_layers(attr)) - 1,
                           user_repr, True, self.spec.dis_dropout)
            out = _wide(out)
            labels = self.labels[attr].to(out.device)[batch[attr].long()]
            if self.spec.attributes[attr] == 2:
                total = total + F.binary_cross_entropy(torch.sigmoid(out), labels.float()[:, None])
            else:
                total = total + F.cross_entropy(out, labels)
        return total

    def loss(self, batch, kind, subset):
        """The step's loss on ``batch`` (user, positive, negative ids and the
        attribute columns)."""
        users = batch["user_id"]
        if kind == "dis":
            return self.dis_loss(self.user_repr(users, subset, True), batch, subset)
        u = self.user_repr(users, subset, True)
        items = self.state["item_embedding.weight"]
        pos = _wide((u * items[batch["item_id"]]).sum(-1))
        neg = _wide((u * items[batch["neg_item_id"]]).sum(-1))
        loss = -torch.log(1e-10 + torch.sigmoid(pos - neg)).mean()
        if self.spec.filtered:
            loss = loss - self.spec.dis_weight * self.dis_loss(self.user_repr(users, subset, True),
                                                               batch, subset)
        return loss


# -------------------------------------------------------------------- train


class Adam:
    """Dense Adam with L2 weight decay added to the gradient, over named
    leaves of a state dict."""

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


def train_steps(spec, state, labels, model_seed, steps, precision="float32", rows=None,
                follow=None):
    """Follow ``steps`` ((batch, kind, subset) in order) from ``state``.

    Returns a dict of plain numbers: ``losses`` (one a step), ``grad``
    (name → norm of each optimizer's first gradient as its update saw it),
    ``raw_grad`` (name → norm of the loss's own gradient at that step, for
    the rule that leaves a leaf out) and ``change`` (name → norm of the
    parameter's change over the steps). ``rows`` keeps only the first
    ``rows`` rows of each batch (a fault planted in the reference).

    ``follow`` (the program's snapshots, ``harness/probe.py::FirstSteps``:
    one before each step and one after the last) starts each step from the
    program's state before it instead of the reference's own: Adam's first
    update turns the round-off of a gradient that cancels into a move of
    ±lr, so two sound runs part after one step. Each step's passage is then
    the reference's own: ``passages`` holds, a step, the state the
    reference reaches from the snapshot before it (parameters, buffers and
    both optimizers' moments and step counts, in the snapshot's form) and
    the raw gradients' norms, for the comparison with the program's next
    snapshot; ``change`` is the sum of the reference's own updates.
    """
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    state = {n: t.to(dtype) for n, t in state.items()}
    initial = {n: t.clone() for n, t in state.items()}
    model = Model(spec, state, labels, model_seed, precision)
    opts = {}
    moved = {}
    out = {"losses": [], "grad": {}, "raw_grad": {}, "passages": []}
    for i, (batch, kind, subset) in enumerate(steps):
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
        names = spec.group(kind)
        first = kind not in opts
        if follow is not None:
            snap = follow[i]
            device = state["user_embedding.weight"].device
            state.update({n: t.to(device, dtype) for n, t in snap["model"].items()})
            opts[kind] = Adam(state, names, spec.lr, spec.weight_decay)
            carried = snap["opt"].get(kind, {})
            if carried:  # a leaf the program carries no moments for starts from zero
                for n in names:
                    if n in carried:
                        opts[kind].m[n] = carried[n][0].to(device, dtype)
                        opts[kind].v[n] = carried[n][1].to(device, dtype)
                opts[kind].t = int(max(carried[n][2] for n in carried))
        elif first:
            opts[kind] = Adam(state, names, spec.lr, spec.weight_decay)
        opts[kind].state = state
        start = {n: state[n] for n in names}
        leaves = {n: state[n].detach().requires_grad_(True) for n in names}
        state.update(leaves)
        loss = model.loss(batch, kind, subset)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(leaves[n]))
                 for n, g in zip(names, grads)}
        for n in names:
            state[n] = leaves[n].detach()
        seen = opts[kind].step(grads)
        out["losses"].append(float(loss.detach()))
        raw = {n: float(torch.linalg.vector_norm(grads[n].float())) for n in names}
        if first:
            for n in names:
                out["grad"][n] = float(torch.linalg.vector_norm(seen[n].float()))
            out["raw_grad"].update(raw)
        if follow is not None:
            for n in names:
                step = state[n].float() - start[n].float()
                moved[n] = step if n not in moved else moved[n] + step
            opt = {tag: dict(m) for tag, m in follow[i]["opt"].items()}
            opt[kind] = {n: (opts[kind].m[n].cpu(), opts[kind].v[n].cpu(),
                             float(opts[kind].t)) for n in names}
            out["passages"].append({"kind": kind, "raw_grad": raw, "after": {
                "model": {n: t.detach().to("cpu", copy=True) for n, t in state.items()},
                "opt": opt}})
        del grads, seen, leaves, start
    if follow is None:
        out["change"] = {n: float(torch.linalg.vector_norm(state[n].float() - initial[n].float()))
                         for n, _, _ in spec.params()}
    else:
        out["change"] = {n: float(torch.linalg.vector_norm(moved[n])) if n in moved else 0.0
                         for n, _, _ in spec.params()}
    return out
