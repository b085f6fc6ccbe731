"""Operations and bytes that FairGo_GCN's pretrain step needs, from the
configuration's sizes, for the least time of a window of steps.

A step convolves the whole (users + items) table twice over Â =
D̃^-½ (A + I) D̃^-½ (``E`` entries, self loops included, ``n`` rows), forward
and backward, and updates the tables and the GCN by dense Adam. The count is
of what that mathematics needs, at the cheapest of its exact forms:

* four full-graph hops (each convolution's forward over Â and its backward
  over Âᵀ), each at the narrower width of its convolution: Â (X W) = (Â X) W,
  so a hop of the convolution d_in → d_out can run at min(d_in, d_out); for
  the published widths 64 → 32 → 64 every hop is at 32. A hop reads each
  entry once (a 4-byte column index and a 4-byte value), the row pointer
  once, each source row once (never once per entry: a kernel that reuses
  gathered rows through the L2 cache reads fewer bytes from memory than one
  row per entry) and writes each output row once (``hop_bytes``);
* the forward GEMMs' ``[n, ·]`` operands read once (the table X at d, the
  hidden table at its width), and their operations;
* dense Adam over both tables and every GCN parameter: the parameter and its
  two moments read and written once (``counts.adam_bytes``);
* the batch's MSE: the two rows of every batch row read, a dot product
  each, the rating read.

Left out: the backward GEMMs, ReLU, the dropout mask and its draw, the bias
adds and the dense gradients. Operations are taken at the float32 peak (TF32
is off), bytes at the HBM peak; the larger of the two over a window's sums
is its least time. The count is a lower bound under the rewrites that keep
each convolution over the whole graph; a step that restricted the last
convolution to the batch's rows and the first to their neighbourhood would
read fewer entries (PERF.md, open questions).
"""

from __future__ import annotations

from . import adam_bytes, least_s

ENTRY_BYTES = 4 + 4  # an entry's column index and its float32 value


def hop_bytes(entries, rows, sources, d):
    """A hop of ``entries`` entries into ``rows`` rows gathering ``sources``
    distinct source rows of width ``d``: each entry's index and value, the
    row pointer, each source row read once, each output row written once
    (float32)."""
    return float(entries) * ENTRY_BYTES + (rows + 1) * 4.0 + (sources + rows) * 4.0 * d


def widths(model):
    """The convolutions' widths: d → hidden → … → d."""
    d, hidden, layers = model["embedding_size"], model["hidden_channels"], model["gcn_n_layers"]
    return [d] + [hidden] * (layers - 1) + [d]


def hop_widths(model):
    """The width of each full-graph hop of a step at the cheapest exact
    form: each convolution's forward and backward at its narrower side."""
    w = widths(model)
    return [min(a, b) for a, b in zip(w[:-1], w[1:]) for _ in ("forward", "backward")]


def params(model):
    """The pretrain optimizer's parameters: both tables and the GCN's
    weights and biases."""
    w = widths(model)
    return model["n_nodes"] * model["embedding_size"] + sum(a * b + b for a, b in
                                                           zip(w[:-1], w[1:]))


def hops_work(model):
    """(operations, bytes) of a step's hops: ``model`` holds ``n_nodes``,
    ``entries`` (of Â), ``sources`` (its distinct columns), and the widths
    (``embedding_size``, ``hidden_channels``, ``gcn_n_layers``)."""
    n, E = model["n_nodes"], model["entries"]
    ws = hop_widths(model)
    return (sum(2.0 * E * d for d in ws),
            sum(hop_bytes(E, n, model["sources"], d) for d in ws))


def step_work(model, B):
    """(operations, bytes) one pretrain step needs at batch ``B``."""
    n, d = model["n_nodes"], model["embedding_size"]
    w = widths(model)
    flops, nbytes = hops_work(model)
    flops += sum(2.0 * n * a * b for a, b in zip(w[:-1], w[1:]))
    nbytes += sum(4.0 * n * a for a in w[:-1])
    nbytes += adam_bytes(params(model))
    flops += 2.0 * B * d
    nbytes += 2.0 * B * 4 * d + 4.0 * B
    return flops, nbytes


def least_time(flops, nbytes):
    """The least time of work summed over a window (float32 operands)."""
    return least_s(flops, nbytes)
