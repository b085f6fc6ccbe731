"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM
and the operations and bytes that a unit of work needs.

Every count is of what the inputs need (each input byte read once, each
output byte written once, the operations of the mathematics), so the least
time it gives is a lower bound and no share of it can pass 100%.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12  # bfloat16 / float16 on the tensor cores
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def least_s(flops, nbytes, half=False):
    """The least time of work of ``flops`` operations and ``nbytes`` bytes:
    the larger of the two bounds, at the peak of the operands' type."""
    return max(flops / (PEAK_BF16_FLOPS if half else PEAK_F32_FLOPS), nbytes / PEAK_BYTES)


def topk_call_s(B, I, d, k, elem_bytes=2):
    """One top-k call over a catalog: 2·B·I·d operations on the tensor cores
    against the table and the users read once and the (score, id) pairs
    written once."""
    flops = 2.0 * B * I * d
    nbytes = elem_bytes * (I * d + B * d) + 8.0 * B * k
    return least_s(flops, nbytes, half=elem_bytes == 2)


def mlp_params(sizes, bn=True):
    """Parameters of an MLP over ``sizes``: weights, biases and BatchNorm's
    gamma and beta per layer."""
    return sum(i * o + o + (2 * o if bn else 0) for i, o in zip(sizes[:-1], sizes[1:]))


def mlp_flops(sizes, rows):
    """One forward pass of an MLP over ``rows`` rows: 2·rows·in·out a layer
    (activations, BatchNorm and dropout are not counted)."""
    return 2.0 * rows * sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))


def adam_bytes(n_params, elem_bytes=4):
    """Dense Adam: the parameter and its two moments read and written once."""
    return 6.0 * n_params * elem_bytes


def gather_bytes(rows, d, elem_bytes=4):
    """Rows of a table read once."""
    return float(rows) * d * elem_bytes
