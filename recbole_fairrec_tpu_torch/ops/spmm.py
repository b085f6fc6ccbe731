"""Graph propagation: sparse (CSR) and dense products with FairGo's
normalised rating matrices.

Counterpart of ``recbole_fairrec_tpu/ops/spmm.py``. The COO arrays and the
dense matrix are built on the host in numpy, exactly as the JAX package
builds them, and the model keeps them as tensors. A sparse hop goes through
the matrix's CSR pair (``ops/spmm_csr.py``: A forward, Aᵀ backward), built
from the COO arrays with ``spmm_csr.csr_pair`` on their device: on the card
the hand-written kernel, on the CPU its plain version. The dense form is one
``[n, n] @ [n, d]`` matrix product (cuBLAS on the card).

Dense numerics follow the JAX package's: float32 operands give a float32
product with float32 accumulation (the JAX package asks for
``precision="highest"``, so the hop pins PyTorch's float32 matmul precision
to "highest" around its products, forward and backward, whatever the
process has set: no TF32); a bfloat16 matrix (``propagation_dtype:
bfloat16``) multiplies bfloat16 operands into a float32 result, which is
``preferred_element_type=float32`` there. A plain ``torch.mm`` of two
bfloat16 tensors would round the result to bfloat16, so on the card the
product is ``torch.mm(..., out_dtype=torch.float32)``; on the CPU, where
that overload has no kernel, the operands are widened to float32 first (a
product of two bfloat16 values is exact in float32, so only the order of the
sums differs).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..utils import tracing
from .spmm_csr import CsrHop, csr_pair


def coo_to_dense(rows, cols, vals, n):
    """COO arrays → dense float32 ``[n, n]`` numpy matrix (on the host); a
    repeated (row, col) pair keeps one of its values, as numpy's fancy
    assignment does in the JAX package."""
    A = np.zeros((n, n), dtype=np.float32)
    A[np.asarray(rows), np.asarray(cols)] = np.asarray(vals)
    return A


@contextlib.contextmanager
def _highest_precision():
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def matmul_f32(a, b):
    """``a @ b`` into float32: float32 operands at full precision; for a
    bfloat16 ``a``, bfloat16 operands."""
    with _highest_precision():
        if a.dtype != torch.bfloat16:
            return torch.mm(a, b)
        if a.is_cuda:
            return torch.mm(a, b.to(torch.bfloat16), out_dtype=torch.float32)
        return a.float() @ b.float()


class _Propagate(torch.autograd.Function):
    """``dense @ x``, differentiable in ``x`` (``aten::mm.dtype`` has no
    derivative), with the gradient ``dense.T @ grad`` taken by ``matmul_f32`` as
    well, so that it too runs at the pinned precision. For a bfloat16
    ``dense`` the float32 gradient is rounded to bfloat16 by autograd as
    ``x``'s type asks, as the JAX package's transpose of its mixed-precision
    dot gives it; on the card the incoming float32 ``grad`` is rounded to
    bfloat16 too, to stay on the tensor cores. The backward adds ``edges``
    (the matrix's COO entries) to the counter ``spmm.backward_edges``."""

    @staticmethod
    def forward(ctx, dense, x, edges):
        ctx.save_for_backward(dense)
        ctx.edges = edges
        return matmul_f32(dense, x)

    @staticmethod
    def backward(ctx, grad):
        (dense,) = ctx.saved_tensors
        tracing.count("spmm.backward_edges", ctx.edges)
        return None, matmul_f32(dense.t(), grad), None


def propagate(x, rows, cols, vals, n, dense=None, csr=None):
    """One propagation hop, ``A @ x``: through ``dense`` (float32 or
    bfloat16 ``[n, n]``) when given; else through the matrix's CSR pair
    (``spmm_csr.CsrHop``), ``csr`` when given, else one built from the COO
    arrays for this call alone: two stable sorts of the entries on their
    device, ~13 ms at Last.fm-360K scale on an H100 beside a 1.8 ms hop, so
    a caller that hops more than once builds the pair once and passes it
    (``FairGoBase._csr``). Traced as ``spmm.propagate`` (attrs ``path``:
    ``dense`` or ``csr``; ``edges``, ``d``); the counter ``spmm.edges`` adds
    the matrix's edges at every forward hop, ``spmm.csr_edges`` those of the
    forward hops through the CSR pair. ``spmm.edges`` stays forward-only: the
    hop's backward, where autograd runs it, adds the matrix's entries to
    ``spmm.backward_edges`` (``_Propagate.backward``, ``CsrHop.backward``)."""
    edges = 0 if rows is None else rows.shape[0]
    path = "dense" if dense is not None else "csr"
    tracing.count("spmm.edges", edges)
    if path == "csr":
        tracing.count("spmm.csr_edges", edges)
    with tracing.span("spmm.propagate") as sp:
        if sp:
            sp.set("path", path)
            sp.set("edges", edges)
            sp.set("d", x.shape[1])
        if path == "dense":
            return _Propagate.apply(dense, x.to(dense.dtype), edges)
        return CsrHop.apply(x, csr_pair(rows, cols, vals, n) if csr is None else csr)


def build_bipartite_norm_coo(rating_coo, n_users, n_items):
    """Row-normalised (D⁻¹A) bipartite rating matrix as numpy COO arrays.

    A is the (U+I)×(U+I) block matrix with the ratings in its off-diagonal
    blocks; D is its row sum (+1e-7). A duplicate (row, col) entry keeps its
    LAST value, as the reference's dict construction does.

    Returns (rows int64, cols int64, vals float32).
    """
    n = n_users + n_items
    rows = np.concatenate([rating_coo.row, rating_coo.col + n_users])
    cols = np.concatenate([rating_coo.col + n_users, rating_coo.row])
    vals = np.concatenate([rating_coo.data, rating_coo.data]).astype(np.float32)

    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    _, last_idx = np.unique(key[::-1], return_index=True)
    keep = len(rows) - 1 - last_idx
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, rows, vals)
    inv_deg = 1.0 / (deg + 1e-7)
    vals = (vals * inv_deg[rows]).astype(np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def build_gcn_norm_coo(rating_coo, n_users, n_items):
    """Symmetric GCN normalisation D̃^-½ (A + I) D̃^-½ with rating-weighted
    edges and weight-1 self loops (torch_geometric's ``gcn_norm``), as numpy
    COO arrays (rows int64, cols int64, vals float32)."""
    n = n_users + n_items
    rows = np.concatenate([rating_coo.row, rating_coo.col + n_users, np.arange(n)])
    cols = np.concatenate([rating_coo.col + n_users, rating_coo.row, np.arange(n)])
    vals = np.concatenate([rating_coo.data, rating_coo.data, np.ones(n)]).astype(np.float64)

    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, rows, vals)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    vals = (inv_sqrt[rows] * vals * inv_sqrt[cols]).astype(np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals
