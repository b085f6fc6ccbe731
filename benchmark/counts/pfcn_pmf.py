"""Operations and bytes of a PFCN_PMF train step (BPR-MF with
``filter_mode: none``), from the configuration's sizes.

A step of batch ``B`` reads the user, positive and negative rows once. The
filter step runs the subset's filter twice forward and twice backward
(input and weight gradients: 6 passes), and the subset's discriminators
forward and back to their inputs (2 passes); the discriminator step runs
the filter forward and the discriminators forward and back to their weights
(1 + 2 passes; their input gradients are left out, so the count stays a
lower bound). Adam is dense over every parameter of the step's optimizer:
6 × params × 4 B.
"""

from __future__ import annotations

from . import adam_bytes, gather_bytes, least_s, mlp_flops, mlp_params


def filter_sizes(d):
    return [d, 2 * d, d]


def dis_sizes(d, hidden, n_classes):
    return [d] + list(hidden) + [1 if n_classes == 2 else n_classes]


def table_params(model):
    return (model["n_users"] + model["n_items"]) * model["embedding_size"]


def n_filters(model):
    if model["filter_mode"] == "none":
        return 0
    return 2 ** len(model["attributes"]) - 1


def filter_group_params(model):
    """The filter optimizer's parameters: both tables and every filter."""
    d = model["embedding_size"]
    return table_params(model) + n_filters(model) * mlp_params(filter_sizes(d))


def dis_group_params(model):
    d = model["embedding_size"]
    return sum(mlp_params(dis_sizes(d, model["dis_hidden_size_list"], k))
               for k in model["attributes"].values())


def step_s(model, B, kind, subset=()):
    """Least time of one step. ``model`` holds ``n_users``, ``n_items``,
    ``embedding_size``, ``filter_mode``, ``attributes`` (name → number of
    classes) and ``dis_hidden_size_list``; ``kind`` is ``"bpr"`` (no
    filters), ``"filter"`` or ``"dis"``; ``subset`` the attributes drawn."""
    d = model["embedding_size"]
    rows = gather_bytes(3 * B, d)
    dots = 2.0 * 2 * B * d * 2  # two scores a row, forward and backward
    if kind == "bpr":
        return least_s(dots, rows + adam_bytes(table_params(model)))
    dis = sum(mlp_flops(dis_sizes(d, model["dis_hidden_size_list"], model["attributes"][a]), B)
              for a in subset)
    filt = mlp_flops(filter_sizes(d), B)
    if kind == "filter":
        flops = dots + 6 * filt + 2 * dis
        return least_s(flops, rows + adam_bytes(filter_group_params(model)))
    if kind == "dis":
        flops = filt + 2 * dis
        return least_s(flops, gather_bytes(B, d) + adam_bytes(dis_group_params(model)))
    raise ValueError(f"unknown step kind {kind!r}")
