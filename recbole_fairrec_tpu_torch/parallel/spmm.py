"""Graph propagation with the operator's rows split over the model axis.

Counterpart of ``recbole_fairrec_tpu/parallel/spmm.py``. Each rank holds a
horizontal stripe ``[n_pad / S, n]`` of the dense operator, multiplies it by
the replicated node matrix (``ops/spmm.py``'s float32 product at "highest"
precision, as ``propagate`` does), and one all-gather over the model group
rebuilds the ``[n, d]`` result for the next hop: O(n·d) traffic per hop,
1/S of the operator per device. As in the JAX package, FairGo does not call
it; it is the building block for a graph whose operator outgrows one card.
"""

from __future__ import annotations

import torch

from ..ops.spmm import matmul_f32
from .collectives import all_gather_rows


def pad_rows_to_shards(dense, n_shards):
    """Zero-pad the ROWS of an ``[n, n]`` operator to a multiple of
    ``n_shards`` (zero rows give zero output rows, dropped after the
    gather)."""
    n = dense.shape[0]
    n_pad = -(-n // n_shards) * n_shards
    if n_pad != n:
        dense = torch.cat([dense, dense.new_zeros((n_pad - n,) + tuple(dense.shape[1:]))])
    return dense


def shard_propagation_matrix(mesh, dense, axis="model"):
    """This rank's stripe of the row-padded operator."""
    n_shards = mesh.shape[axis]
    dense = pad_rows_to_shards(dense, n_shards)
    rows = dense.shape[0] // n_shards
    m = mesh.index(axis)
    return dense[m * rows:(m + 1) * rows].contiguous()


def sharded_propagate(mesh, dense_stripe, x, axis="model"):
    """One hop ``A @ x`` from this rank's stripe of the (row-padded) operator
    and the replicated ``x [n, d]``; returns the replicated ``[n, d]``."""
    local = matmul_f32(dense_stripe, x)
    return all_gather_rows(local, mesh.group(axis))[: x.shape[0]]
