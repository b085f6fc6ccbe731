"""Parameter initialisation and the MLP stack.

Counterpart of ``recbole_fairrec_tpu/models/layers.py``. Every init draws
from an explicit ``torch.Generator``; the same seed gives the same tables on
every device because the draw happens on the CPU.

An :class:`MLP` keeps the JAX package's layout, so its state dict maps onto
the JAX trees name for name: ``linear.<i>.w`` is a ``[in, out]`` weight
(applied as ``x @ w + b``, not transposed as ``nn.Linear`` stores it),
``bn.<i>.gamma`` / ``beta`` are parameters and ``bn.<i>.mean`` / ``var`` are
buffers, the JAX package's ``state`` tree. Each layer runs Dropout → Linear →
(BatchNorm) → activation, the activation after every layer, the last one
included. BatchNorm is a function over those tensors, not
``nn.BatchNorm1d``: in training it uses the batch statistics (weighted by
``sample_weight`` when given) and moves the running statistics with momentum
0.1, the variance unbiased with the divisor ``max(n − 1, 1)``, so a one-row
batch gives ``beta``; at eval it uses the running statistics, or per-segment
statistics in the reference-defect emulation mode
(``reference_bn_eval_emulation``). While a batch is split over the data axis
(``parallel/``), the training statistics and the dropout masks are those of
the whole batch, as under the JAX package's SPMD ``jit``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel.collectives import active_batch_split, batch_rand, batch_rows, batch_sum


def xavier_normal(generator, fan_in, fan_out):
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(fan_in, fan_out, generator=generator) * std


def xavier_uniform(generator, fan_in, fan_out):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(fan_in, fan_out, generator=generator) * 2 - 1) * limit


def normal_001(generator, fan_in, fan_out):
    return torch.randn(fan_in, fan_out, generator=generator) * 0.01


def torch_linear_default(generator, fan_in, fan_out):
    """nn.Linear default: kaiming-uniform(a=√5) ≡ U(±1/√fan_in)."""
    limit = 1.0 / math.sqrt(fan_in)
    return (torch.rand(fan_in, fan_out, generator=generator) * 2 - 1) * limit


def normal_1(generator, fan_in, fan_out):
    """nn.Embedding default: N(0, 1)."""
    return torch.randn(fan_in, fan_out, generator=generator)


_INIT_FNS = {
    "xavier_normal": xavier_normal,
    "xavier_uniform": xavier_uniform,
    "norm": normal_001,
    "normal": normal_1,
    "torch_linear": torch_linear_default,
}


def init_embedding(num, dim, method="xavier_normal", generator=None, padding_idx=None):
    """An ``nn.Embedding`` whose table is drawn by ``method`` from
    ``generator``; the ``padding_idx`` row is zeroed."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    table = _INIT_FNS[method](generator, num, dim)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    emb = nn.Embedding(num, dim)
    with torch.no_grad():
        emb.weight.copy_(table)
    return emb


# ------------------------------------------------------------------ layers


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored ``[in, out]``. ``torch_linear`` also
    draws the nn.Linear-default uniform bias; other methods start it at 0."""

    def __init__(self, fan_in, fan_out, method, generator):
        super().__init__()
        self.w = nn.Parameter(_INIT_FNS[method](generator, fan_in, fan_out))
        if method == "torch_linear":
            limit = 1.0 / math.sqrt(fan_in)
            b = (torch.rand(fan_out, generator=generator) * 2 - 1) * limit
        else:
            b = torch.zeros(fan_out)
        self.b = nn.Parameter(b)

    def forward(self, x):
        return x @ self.w + self.b


class BatchNorm(nn.Module):
    """Affine parameters ``gamma`` / ``beta`` and running ``mean`` / ``var``
    buffers; :func:`batch_norm` applies them."""

    def __init__(self, width):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(width))
        self.beta = nn.Parameter(torch.zeros(width))
        self.register_buffer("mean", torch.zeros(width))
        self.register_buffer("var", torch.ones(width))


def apply_activation(name, x):
    if name is None:
        return x
    name = name.lower()
    if name == "none":
        return x
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "relu":
        return torch.relu(x)
    if name == "leakyrelu":
        return torch.nn.functional.leaky_relu(x, negative_slope=0.01)
    raise NotImplementedError(f"activation function {name} is not implemented")


def _segment_stats(x, segments, num_segments):
    """Biased mean and variance of ``x`` per segment, gathered back per row."""
    n = torch.zeros(num_segments, 1, dtype=x.dtype, device=x.device)
    n.index_add_(0, segments, torch.ones(x.shape[0], 1, dtype=x.dtype, device=x.device))
    n = n.clamp_min(1.0)
    s = torch.zeros(num_segments, x.shape[1], dtype=x.dtype, device=x.device)
    s2 = torch.zeros_like(s)
    s.index_add_(0, segments, x)
    s2.index_add_(0, segments, x * x)
    mean = s / n
    var = s2 / n - mean**2
    return mean[segments], var[segments].clamp_min(0.0)


def _split_stats(x, sample_weight):
    """Mean, biased and unbiased variance of the rows of the whole batch
    (this rank holds some of them), weighted by ``sample_weight`` when
    given; differentiable, as ``SyncBatchNorm``'s."""
    if sample_weight is not None:
        w = sample_weight.to(x.dtype)[:, None]
        n = batch_sum(torch.sum(w)).clamp_min(1.0)
        mean = batch_sum(torch.sum(x * w, dim=0)) / n
        var = batch_sum(torch.sum(w * (x - mean) ** 2, dim=0)) / n
        return mean, var, var * n / (n - 1.0).clamp_min(1.0)
    n = batch_rows(x.shape[0])
    mean = batch_sum(x.sum(dim=0)) / n
    var = batch_sum(((x - mean) ** 2).sum(dim=0)) / n
    return mean, var, var * n / max(n - 1, 1)


def batch_norm(bn, x, train, sample_weight=None, segments=None, num_segments=None,
               momentum=0.1, eps=1e-5):
    """BatchNorm over the rows of ``x`` with ``bn``'s tensors; in training
    the running statistics move (outside autograd)."""
    if segments is not None:
        # the reference's filters never leave train mode, so their BN runs
        # on the statistics of each one-user eval batch; running stats are
        # neither read nor moved
        mean, var = _segment_stats(x, segments, num_segments)
    elif train:
        if active_batch_split() is not None:
            mean, var, unbiased = _split_stats(x, sample_weight)
        elif sample_weight is not None:
            w = sample_weight.to(x.dtype)[:, None]
            n = torch.sum(w).clamp_min(1.0)
            mean = torch.sum(x * w, dim=0) / n
            var = torch.sum(w * (x - mean) ** 2, dim=0) / n
            unbiased = var * n / (n - 1.0).clamp_min(1.0)
        else:
            n = x.shape[0]
            mean = x.mean(dim=0)
            var = x.var(dim=0, unbiased=False)
            unbiased = var * n / max(n - 1, 1)
        with torch.no_grad():
            bn.mean.copy_((1 - momentum) * bn.mean + momentum * mean)
            bn.var.copy_((1 - momentum) * bn.var + momentum * unbiased)
    else:
        mean, var = bn.mean, bn.var
    return (x - mean) * torch.rsqrt(var + eps) * bn.gamma + bn.beta


class MLP(nn.Module):
    """An MLPLayers stack over ``layer_sizes``; see the module doc."""

    def __init__(self, layer_sizes, init_method="xavier_normal", bn=False, generator=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        pairs = list(zip(layer_sizes[:-1], layer_sizes[1:]))
        self.linear = nn.ModuleList(
            Linear(fan_in, fan_out, init_method, generator) for fan_in, fan_out in pairs
        )
        self.bn = nn.ModuleList(BatchNorm(fan_out) for _, fan_out in pairs) if bn else None

    def forward(self, x, activation="relu", dropout=0.0, train=False, generator=None,
                sample_weight=None, segments=None, num_segments=None):
        """Dropout (train only, masks from ``generator``) → Linear → BN →
        activation per layer. ``segments`` switches BN to per-segment
        statistics."""
        keep = 1.0 - dropout
        for i, lin in enumerate(self.linear):
            if train and dropout > 0.0:
                mask = batch_rand(x.shape, generator, x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
            x = lin(x)
            if self.bn is not None:
                x = batch_norm(self.bn[i], x, train, sample_weight, segments, num_segments)
            x = apply_activation(activation, x)
        return x
