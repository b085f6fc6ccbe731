"""Row-sharded embedding tables and the lookup over them.

Counterpart of ``recbole_fairrec_tpu/parallel/embedding.py``. The JAX
package has two lookups: the declarative ``table[ids]`` (XLA adds the
collectives) and the explicit pull exchange ``bucket_allgather_lookup``.
PyTorch has no compiler that adds collectives, so the port's lookup over a
row-sharded table is always the exchange: every rank of the model group
holds the same ids, masks those its rows own, gathers them locally and the
partial rows are summed over the group. Its backward gives this rank's rows
the rows of the incoming gradient for the ids it owns (the ranks of the
group compute the same thing after the lookup, so that gradient is the
same on each of them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .collectives import model_sum


def shard_table(mesh, table, axis="model"):
    """This rank's rows of ``table`` (``[rows, ...]``, rows divisible by the
    axis size)."""
    n = mesh.shape[axis]
    if table.shape[0] % n:
        raise ValueError(
            f"table rows [{table.shape[0]}] must divide the '{axis}' axis "
            f"size [{n}] — pad the table"
        )
    rows = table.shape[0] // n
    m = mesh.index(axis)
    return table[m * rows:(m + 1) * rows]


def _exchange(mesh, table_shard, ids, axis):
    rows = table_shard.shape[0]
    lo = mesh.index(axis) * rows
    local = ids - lo
    owned = (local >= 0) & (local < rows)
    safe = torch.where(owned, local, torch.zeros_like(local))
    partial = F.embedding(safe, table_shard)
    partial = torch.where(owned.unsqueeze(-1), partial, torch.zeros((), dtype=partial.dtype,
                                                                    device=partial.device))
    return model_sum(partial, mesh.group(axis))


def sharded_gather(mesh, table_shard, ids, axis="model"):
    """``table[ids]`` over a table whose rows are split over ``axis``: the
    exchange (the port has no declarative form; see the module doc)."""
    return _exchange(mesh, table_shard, ids, axis)


def bucket_allgather_lookup(mesh, table_shard, ids, axis="model", data_axis=None):
    """Pull-style lookup of the global ``ids`` in a table whose rows are
    split over ``axis`` (``table_shard`` is this rank's rows). With
    ``data_axis`` the ids are split over that axis as well: this rank looks
    up and returns only its slice of them, and the sum rides the model
    axis alone."""
    if data_axis is not None:
        size = mesh.shape[data_axis]
        if ids.shape[0] % size:
            raise ValueError(
                f"ids [{ids.shape[0]}] must divide the '{data_axis}' axis size [{size}]"
            )
        n = ids.shape[0] // size
        d = mesh.index(data_axis)
        ids = ids[d * n:(d + 1) * n]
    return _exchange(mesh, table_shard, ids, axis)


def pad_table_rows(table, n_shards):
    """Pad rows up to a multiple of ``n_shards`` with zero rows (never looked
    up); returns (table, real row count)."""
    rows = table.shape[0]
    target = -(-rows // n_shards) * n_shards
    if target == rows:
        return table, rows
    pad = torch.zeros((target - rows,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    return torch.cat([table, pad], dim=0), rows
