"""The collectives that the JAX package's SPMD ``jit`` places by itself,
written out for the port's models and trainer.

Two kinds, by what the ranks downstream of them compute:

* over ``model`` (the ranks of one data slice): everything after a lookup
  or a table gather is the same on every rank of the group, so the
  gradient arriving there is too, and the backward of a gather keeps this
  rank's rows of it without any communication (:func:`gather_rows` with
  ``reduce_grad=False``);
* over ``data``, while a :class:`~.mesh.BatchSplit` is active: each batch
  reduction of a loss is made global with a differentiable all-reduce
  (:func:`batch_sum`), whose backward all-reduces the gradient. Every rank
  then holds the loss of the whole batch, its backward yields ``size``
  times this rank's share of the gradient, and the trainer's average over
  ``data`` gives the gradient of the whole batch, as ``SyncBatchNorm``
  under DDP does.

Without an active split the batch functions are the identity, so a
meshless run takes none of these paths.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import active_batch_split


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumIdenticalGrad(torch.autograd.Function):
    """All-reduce over a group whose ranks go on to compute the same thing:
    the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_gather_rows(x, group):
    """The ranks' ``x`` concatenated along rows in rank order (not
    differentiable)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, reduce_grad):
        ctx.group, ctx.index, ctx.rows, ctx.reduce_grad = group, index, x.shape[0], reduce_grad
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_grad:
            grad = grad.clone()
            dist.all_reduce(grad, group=ctx.group)
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None, None, None


def model_sum(x, group):
    """Sum of ``x`` over the model group; the gradient passes through (see
    the module doc)."""
    return _SumIdenticalGrad.apply(x, group)


def gather_rows(x, group, index, reduce_grad=False):
    """The ranks' ``x`` (equal row counts) concatenated in rank order;
    differentiable. ``reduce_grad``: the ranks downstream differ, so the
    gradient is summed over the group before this rank keeps its rows."""
    return _GatherRows.apply(x, group, index, reduce_grad)


# ------------------------------------------------------------ batch split


def batch_sum(x, differentiable=True):
    """``x`` summed over the data group while a split is active, else
    ``x``."""
    split = active_batch_split()
    if split is None:
        return x
    if differentiable and x.requires_grad:
        return _AllReduceSum.apply(x, split.group)
    out = x.detach().clone()
    dist.all_reduce(out, group=split.group)
    return out


def batch_rows(n):
    """The global row count of a batch of which this rank holds ``n``."""
    split = active_batch_split()
    return n if split is None else n * split.size


def gather_batch(x):
    """The whole batch's rows of ``x`` while a split is active (else ``x``);
    its gradient is summed over the data group."""
    split = active_batch_split()
    if split is None:
        return x
    return gather_rows(x, split.group, split.index, reduce_grad=True)


def batch_rand(shape, generator, device):
    """``torch.rand(shape)`` for this rank's rows: the draw of the whole
    batch, sliced, so a split batch gets the meshless run's dropout masks."""
    split = active_batch_split()
    if split is None:
        return torch.rand(shape, generator=generator, device=device)
    n = shape[0]
    full = torch.rand((n * split.size,) + tuple(shape[1:]), generator=generator, device=device)
    return full[split.index * n:(split.index + 1) * n]
