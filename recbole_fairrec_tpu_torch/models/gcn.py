"""A minimal GCN (Kipf & Welling), FairGo_GCN's backbone.

Counterpart of ``recbole_fairrec_tpu/models/gcn.py``, with torch_geometric's
``GCN`` / ``GCNConv`` semantics:

* per layer x' = Â (x W) + b, with Â = D̃^-½ (A + I) D̃^-½ (rating-weighted,
  ``ops.spmm.build_gcn_norm_coo``); a convolution that widens (W's
  ``d_out`` over its ``d_in``) computes it as (Â x) W + b, so that every hop,
  forward and backward, runs at the narrower width ``min(d_in, d_out)``;
* widths in → hidden → … → out over ``num_layers`` convolutions;
* activation and dropout BETWEEN layers, not after the last;
* Glorot-uniform weights, zero biases;
* traced (``utils/tracing.py``): each convolution is the span ``gcn.conv``
  (attrs ``layer``, ``d_in``, ``d_out``, ``hop_d``, the width its hop ran
  at, ``rows`` and ``dropout``, the rate of the mask drawn after it, 0 where
  none is); the spans' count is the count of convolutions, and the counter
  ``gcn.hop_first`` adds 1 for each that hops before its weight.

The state dict is the JAX package's ``gcn`` tree: ``convs.<i>.w`` ``[in,
out]`` and ``convs.<i>.b``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.spmm import propagate
from ..utils import tracing
from .layers import Linear, apply_activation


class GCN(nn.Module):
    def __init__(self, in_channels, hidden_channels, out_channels, num_layers, generator):
        super().__init__()
        sizes = [in_channels] + [hidden_channels] * max(num_layers - 1, 0) + [out_channels]
        self.convs = nn.ModuleList(
            Linear(fan_in, fan_out, "xavier_uniform", generator)
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, x, rows, cols, vals, act="relu", dropout=0.0, train=False,
                generator=None, dense=None, csr=None):
        """The convolutions over ``x [n, in]`` with Â as COO arrays (or
        ``dense``, or ``csr``: ``ops.spmm.propagate``'s forms); dropout masks
        (train only) draw from ``generator``."""
        n = x.shape[0]
        keep = 1.0 - dropout
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            masked = train and dropout > 0.0 and i < last
            d_in, d_out = conv.w.shape
            with tracing.span("gcn.conv") as sp:
                if sp:
                    sp.set("layer", i)
                    sp.set("d_in", d_in)
                    sp.set("d_out", d_out)
                    sp.set("hop_d", min(d_in, d_out))
                    sp.set("rows", n)
                    sp.set("dropout", dropout if masked else 0.0)
                if d_out > d_in:  # Â (x W) = (Â x) W: the hop at the narrower d_in
                    tracing.count("gcn.hop_first")
                    # the kernel takes a contiguous x, as x @ W gives it in the other order
                    x = propagate(x.contiguous(), rows, cols, vals, n, dense=dense,
                                  csr=csr) @ conv.w + conv.b
                else:
                    x = propagate(x @ conv.w, rows, cols, vals, n, dense=dense, csr=csr) + conv.b
                if i < last:
                    x = apply_activation(act, x)
                if masked:
                    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                    x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
        return x
