"""CSR sparse × dense product for graph propagation: the hand-written CUDA
kernel (``csrc/spmm_csr.cu``) and its plain PyTorch version.

``csr_pair(rows, cols, vals, n_rows)`` turns a COO matrix A (any entry
order, repeated pairs summed) into the CSR forms of A and of Aᵀ, on the
arrays' device: one stable sort by row, one stable sort by column, a
``bincount`` and a ``cumsum`` for each row pointer, and each form's cut
into pieces of equal work (``merge_path_splits``). Aᵀ keeps
its own copy of the values in its own order; nothing assumes A = Aᵀ.
Indices are int32, so the entries and rows together must stay under 2³¹.

``spmm_csr(csr, x)`` is ``A @ x`` for a float32 ``x [n_cols, d]``,
contiguous: on a CUDA tensor the kernel (or the call raises), on a CPU
tensor ``spmm_csr_reference``. There is no fallback between the two. The
kernel sums each row in entry order, without float atomics, so two calls
give the same bits. It is compiled with ``nvcc`` for ``sm_90a`` into
``_build/`` at first use and loaded with ctypes. One call makes two CUDA
launches (the pieces, then the rows that several pieces share) and
allocates the output and a scratch row per piece; ``launches`` counts the
calls that took the kernel. ``CsrHop`` makes the product differentiable in
``x``: the gradient is the same kernel over Aᵀ; each backward hop adds Aᵀ's
entries to the counter ``spmm.backward_edges`` (``utils/tracing.py``; the
forward hops are ``ops/spmm.py::propagate``'s ``spmm.edges``, which stays
forward-only).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from ..utils import tracing
from .nvcc_build import CSRC_DIR, build_library

SOURCE = os.path.join(CSRC_DIR, "spmm_csr.cu")
# merge-path items (row ends and entries) of one piece: one group of lanes'
# work, the unit that each row split across pieces pays one scratch row for
ITEMS = 256
INDEX_LIMIT = 2**31 - 1  # int32 indices
MAX_LANES = 32  # a group is at most one warp: 32 lanes of VEC columns

launches = 0
_LIB = None


class Csr(NamedTuple):
    """A ``[n_rows, n_cols]`` matrix in CSR form, on one device: ``rowptr``
    int32 ``[n_rows + 1]``, ``cols`` int32 and ``vals`` float32 ``[nnz]``
    (each row's entries in order), and ``splits`` int32 ``[pieces + 1]``, the
    rows that end before each piece of ``items`` merge-path items begins."""

    rowptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    splits: torch.Tensor
    n_cols: int
    items: int


class CsrPair(NamedTuple):
    """The CSR forms of a matrix (``fwd``) and of its transpose (``bwd``)."""

    fwd: Csr
    bwd: Csr


def merge_path_splits(rowptr, items=ITEMS):
    """For each piece of ``items`` items of the merge path of the row ends
    and the entries (diagonals 0, items, 2·items, … and the path's end), the
    rows whose ends lie before it: row r's end is item ``rowptr[r + 1] + r``
    of the path, so it is the count of rows with ``rowptr[r + 1] + r + 1 <=
    diagonal``. A piece starting at diagonal D and row i starts at entry D −
    i. int32 ``[pieces + 1]``."""
    n_rows = rowptr.numel() - 1
    total = n_rows + int(rowptr[-1])
    pieces = -(-total // items)
    diagonals = (torch.arange(pieces + 1, dtype=torch.int64, device=rowptr.device) * items
                 ).clamp_(max=total)
    ends = rowptr[1:].long() + torch.arange(1, n_rows + 1, dtype=torch.int64,
                                            device=rowptr.device)
    return torch.searchsorted(ends, diagonals, right=True).to(torch.int32)


def _csr(rows, cols, vals, n_rows, n_cols, items):
    """Entries sorted by row → ``Csr``."""
    rowptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=rows.device),
                        torch.cumsum(torch.bincount(rows, minlength=n_rows), 0)])
    return Csr(rowptr.to(torch.int32), cols.to(torch.int32), vals.contiguous(),
               merge_path_splits(rowptr, items), n_cols, items)


def csr_pair(rows, cols, vals, n_rows, n_cols=None, items=ITEMS):
    """The CSR forms of the COO matrix ``(rows, cols, vals)`` (``[n_rows,
    n_cols]``, square by default) and of its transpose, on the arrays'
    device."""
    n_cols = n_rows if n_cols is None else n_cols
    nnz = rows.numel()
    if nnz + max(n_rows, n_cols) > INDEX_LIMIT:
        raise ValueError(f"spmm_csr: {nnz} entries and {max(n_rows, n_cols)} rows do not fit "
                         "the kernel's int32 indices (their sum must stay under 2**31)")
    if vals.dtype != torch.float32:
        raise TypeError(f"spmm_csr: the matrix's values are {vals.dtype}, not float32")
    rows, cols = rows.long(), cols.long()
    order = torch.argsort(rows, stable=True)
    rows, cols, vals = rows[order], cols[order], vals[order]
    fwd = _csr(rows, cols, vals, n_rows, n_cols, items)
    order = torch.argsort(cols, stable=True)  # by (col, row): the rows are in order
    bwd = _csr(cols[order], rows[order], vals[order], n_cols, n_rows, items)
    return CsrPair(fwd, bwd)


def spmm_csr_reference(csr, x):
    """The plain version: each entry's source row times its value, summed
    into its row with ``index_add_`` (in the type of ``x``)."""
    n_rows = csr.rowptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n_rows, device=x.device),
                                   torch.diff(csr.rowptr).long())
    out = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows, x[csr.cols.long()] * csr.vals.to(x.dtype)[:, None])


def build(verbose=False):
    """Compile the kernel library (once per source hash) and return its path."""
    return build_library(SOURCE, "spmm_csr", verbose)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.spmm_csr_launch.restype = ctypes.c_int
        lib.spmm_csr_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def lanes_per_entry(d, vec):
    """Lanes of the group that reads one entry's row: ``d / vec`` rounded up
    to a power of two, at most 32 (wider rows take more grid rows)."""
    need = min(-(-d // vec), MAX_LANES)
    return 1 << (need - 1).bit_length()


def spmm_csr(csr, x):
    """``A @ x`` for the CSR matrix ``csr`` and ``x [n_cols, d]``: the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    global launches
    if x.dim() != 2 or x.shape[0] != csr.n_cols:
        raise ValueError(f"spmm_csr: x is {tuple(x.shape)}, not [{csr.n_cols}, d]")
    device = x.device
    if device.type == "cpu" and csr.cols.device.type == "cpu":
        return spmm_csr_reference(csr, x)
    if device.type != "cuda" or csr.cols.device != device:
        raise ValueError(f"spmm_csr: x on {device} and the matrix on {csr.cols.device}; both "
                         "must be on the same CUDA device (or both on the CPU)")
    if x.dtype != torch.float32:
        raise TypeError(f"spmm_csr: the kernel takes float32 rows, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("spmm_csr: the kernel takes a contiguous x")
    n_rows, d = csr.rowptr.numel() - 1, x.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=device)
    if n_rows == 0 or d == 0:
        return out
    pieces = csr.splits.numel() - 1
    vec = 4 if d % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    carry = torch.empty((pieces, d), dtype=torch.float32, device=device)
    carry_row = torch.empty(pieces, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = _lib().spmm_csr_launch(
            csr.rowptr.data_ptr(), csr.cols.data_ptr(), csr.vals.data_ptr(),
            csr.splits.data_ptr(), x.data_ptr(), out.data_ptr(), carry.data_ptr(),
            carry_row.data_ptr(), n_rows, d, pieces, csr.items, n_rows + csr.cols.numel(), vec,
            lanes_per_entry(d, vec), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm_csr: kernel launch failed with CUDA error {err}")
    launches += 1
    return out


class CsrHop(torch.autograd.Function):
    """``A @ x`` for a ``CsrPair`` of A, differentiable in ``x``: the
    forward over ``pair.fwd``, the gradient ``Aᵀ @ grad`` over ``pair.bwd``.
    The values take no gradient; nothing but the pair is kept. A backward
    hop counts Aᵀ's entries in ``spmm.backward_edges``."""

    @staticmethod
    def forward(ctx, x, pair):
        ctx.pair = pair
        return spmm_csr(pair.fwd, x)

    @staticmethod
    def backward(ctx, grad):
        tracing.count("spmm.backward_edges", ctx.pair.bwd.vals.numel())
        return spmm_csr(ctx.pair.bwd, grad.contiguous()), None
