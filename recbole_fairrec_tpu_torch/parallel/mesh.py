"""The ``data × model`` mesh over the ranks of ``torch.distributed``, and
which tensors are split over it.

Counterpart of ``recbole_fairrec_tpu/parallel/mesh.py``. The JAX package
runs one SPMD program over a device mesh and lets XLA place the
collectives; here there is one process per device (a rank of the default
process group), and the mesh is a ``DeviceMesh`` whose ``data`` and
``model`` groups carry the collectives that the port writes out:

* the embedding tables ``user_embedding`` / ``item_embedding`` are
  row-sharded over ``model`` where their rows divide it (rank ``(d, m)``
  holds rows ``[m·R, (m+1)·R)``), everything else is replicated;
* every rank builds the same global batch (same seed, same host pipeline)
  and keeps its slice of the rows on ``data`` where they divide it, else
  the whole batch (:func:`batch_sharding`);
* gradients are averaged over ``data`` (the trainer), never over
  ``model``.

A batch that is split over ``data`` is announced to the model code through
:func:`batch_split`: while it is active, every batch-wide reduction of a
loss (weighted means, BatchNorm statistics, the fairness terms' group
sums) is global over the data group (``parallel/collectives.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch
import torch.distributed as dist

EMBEDDING_KEYS = ("user_embedding", "item_embedding")


class Mesh:
    """A ``data × model`` mesh of the default process group's ranks (rank
    ``r`` sits at ``(r // model, r % model)``, numpy's row-major reshape, as
    the JAX mesh lays out its devices)."""

    def __init__(self, device_mesh, shape, axis_names):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.device_type = device_mesh.device_type

    def group(self, axis):
        return self.device_mesh.get_group(axis)

    def index(self, axis):
        """This rank's coordinate on ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def make_mesh(mesh_shape=None, axis_names=("data", "model"), device_type=None):
    """Build a :class:`Mesh` over the default process group; ``mesh_shape=None``
    puts every rank on the data axis. The group must exist
    (``quick_start.init_multihost``, or ``torchrun`` and
    ``init_process_group``); ``device_type`` defaults to ``cuda`` under
    NCCL and ``cpu`` otherwise."""
    if not dist.is_initialized():
        raise RuntimeError(
            "mesh_shape needs torch.distributed: set multihost: True (or start the "
            "program under torchrun and call init_process_group) before building a mesh"
        )
    n = dist.get_world_size()
    if mesh_shape is None:
        mesh_shape = (n, 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    total = 1
    for s in mesh_shape:
        total *= s
    if total != n:
        raise ValueError(f"mesh_shape {mesh_shape} does not cover {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, mesh_shape, mesh_dim_names=tuple(axis_names))
    return Mesh(device_mesh, mesh_shape, axis_names)


class RowShard(NamedTuple):
    """Rows ``[lo, hi)`` of a table of ``rows`` rows, split over ``axis``."""

    axis: str
    lo: int
    hi: int
    rows: int


REPLICATED = None


def replicate(mesh):
    """The placement of a replicated tensor (every rank holds all of it)."""
    return REPLICATED


def param_sharding(mesh, model, embedding_keys=EMBEDDING_KEYS):
    """Placement of each top-level parameter of ``model``: a
    :class:`RowShard` for the tables in ``embedding_keys`` whose rows divide
    the model axis (this rank's rows), :data:`REPLICATED` for the rest."""
    model_size = mesh.shape.get("model", 1)
    m = mesh.index("model") if "model" in mesh.shape else 0
    out = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        if top in embedding_keys and p.dim() >= 2 and p.shape[0] % model_size == 0:
            rows = p.shape[0] // model_size
            out[name] = RowShard("model", m * rows, (m + 1) * rows, p.shape[0])
        else:
            out.setdefault(name, REPLICATED)
    return out


def shard_params(mesh, model, embedding_keys=EMBEDDING_KEYS):
    """Keep only this rank's rows of the row-sharded tables of ``model`` (in
    place, before any optimizer is built over them) and give the model the
    mesh. Returns :func:`param_sharding`'s description; the model keeps the
    sharded ones in ``model.row_shards`` (module name → :class:`RowShard`)."""
    placement = param_sharding(mesh, model, embedding_keys)
    modules = dict(model.named_modules())
    shards = {}
    for name, place in placement.items():
        if place is REPLICATED:
            continue
        module_name, _, leaf = name.rpartition(".")
        module = modules[module_name]
        full = getattr(module, leaf)
        setattr(module, leaf, torch.nn.Parameter(full.detach()[place.lo:place.hi].clone()))
        shards[module_name] = place
    model.mesh = mesh
    model.row_shards = shards
    return placement


class BatchSplit(NamedTuple):
    """A batch split over the data axis: this rank holds rows
    ``[index·n, (index+1)·n)`` of ``size·n``."""

    group: object
    index: int
    size: int


# the split of the step being run, for the loss code under it (a context
# variable: set and reset around one step, local to its thread)
_ACTIVE_SPLIT = contextvars.ContextVar("batch_split", default=None)


@contextlib.contextmanager
def batch_split(split):
    """Run a loss with ``split`` (a :class:`BatchSplit`, or None for a batch
    every rank holds whole) active."""
    token = _ACTIVE_SPLIT.set(split)
    try:
        yield split
    finally:
        _ACTIVE_SPLIT.reset(token)


def active_batch_split():
    return _ACTIVE_SPLIT.get()


def batch_sharding(mesh, batch):
    """This rank's rows of ``batch`` (a dict of tensors with the same row
    count), and the :class:`BatchSplit` they make: the rows are split over
    ``data`` where they divide it (and it is larger than one), else every
    rank keeps the whole batch and the split is None."""
    size = mesh.shape.get("data", 1)
    rows = len(next(iter(batch.values())))
    if size == 1 or rows % size:
        return batch, None
    index = mesh.index("data")
    n = rows // size
    part = {key: value[index * n:(index + 1) * n] for key, value in batch.items()}
    return part, BatchSplit(mesh.group("data"), index, size)
