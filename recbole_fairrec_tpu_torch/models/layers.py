"""Parameter initialisation.

Counterpart of the init half of ``recbole_fairrec_tpu/models/layers.py``.
Every init draws from an explicit ``torch.Generator``; the same seed gives
the same tables on every device because the draw happens on the CPU. The MLP
stacks (filters, discriminators) come with the adversarial slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn


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
