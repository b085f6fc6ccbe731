"""Operations and bytes that FairGo's finetune needs, from the
configuration's sizes, for the least time of a window of steps.

The count is of what the mathematics of a cycle (one filter step, then
discriminator steps on the same attribute subset) needs, so that it stays a
lower bound under every exact rewrite of the step: keeping the hops across
the discriminator steps while the filters are unchanged, taking the last
hop only at the batch's users, or a sparse product with no ``[E, d]``
temporary. A cycle needs at least:

* one full-graph hop of the filtered table: each of the ``E`` entries of
  ``D⁻¹A`` read once (a 4-byte column index and a 4-byte value) with the
  source row it gathers (4·d bytes), and the ``n`` output rows written
  (``hop_bytes``);
* the filters of the subset forward over the whole (users + items) table
  once: the table read and the filtered table written;

and each step, on the batch side:

* the last hop at the batch's distinct users only (their entries of
  ``D⁻¹A``, the rows they gather and their output rows);
* the LBA head and, for each attribute of the subset, the discriminator
  twice (node and local) at the batch's distinct users;
* the MSE: the user and item rows of every batch row read, a dot product
  each.

Everything else a step does today is left out: the first hop of every
step, the backward passes, the filter step's own hop before its update,
Adam, activations. Operations are taken at the float32 peak (TF32 is off),
bytes at the HBM peak; the larger of the two over a window's sums is its
least time.
"""

from __future__ import annotations

from . import least_s, mlp_flops

ENTRY_BYTES = 4 + 4  # an entry's column index and its float32 value


def hop_bytes(entries, out_rows, d):
    """A hop of ``entries`` entries of the sparse matrix into ``out_rows``
    rows: each entry's index, value and gathered source row read once, each
    output row written once (float32)."""
    return float(entries) * (ENTRY_BYTES + 4 * d) + float(out_rows) * 4 * d


def filter_sizes(model):
    d = model["embedding_size"]
    return [d] + list(model["filter_hidden"]) + [d]


def dis_sizes(model, attr):
    k = model["attributes"][attr]
    return [model["embedding_size"]] + list(model["dis_hidden"]) + [1 if k == 2 else k]


def lba_sizes(model):
    d = model["embedding_size"]
    return [model["n_layers"] * d, d, d, d]


def cycle_work(model, subset_size):
    """(operations, bytes) a cycle needs once, whatever its steps: one
    full-graph hop and the subset's filters over the whole table.
    ``model`` holds ``n_nodes``, ``edges``, ``embedding_size``,
    ``filter_hidden``, ``dis_hidden``, ``n_layers`` and ``attributes``
    (name → number of classes)."""
    n, d = model["n_nodes"], model["embedding_size"]
    flops = subset_size * mlp_flops(filter_sizes(model), n)
    nbytes = hop_bytes(model["edges"], n, d) + 2.0 * n * 4 * d
    return flops, nbytes


def step_work(model, B, users, user_entries, subset):
    """(operations, bytes) of one step's batch side: ``B`` batch rows,
    ``users`` distinct users holding ``user_entries`` entries of the
    matrix, the attribute ``subset``."""
    d = model["embedding_size"]
    flops = 2.0 * B * d + mlp_flops(lba_sizes(model), users)
    flops += sum(2 * mlp_flops(dis_sizes(model, a), users) for a in subset)
    nbytes = hop_bytes(user_entries, users, d) + 2.0 * B * 4 * d + 4.0 * B
    return flops, nbytes


def least_time(flops, nbytes):
    """The least time of work summed over a window (float32 operands)."""
    return least_s(flops, nbytes)
