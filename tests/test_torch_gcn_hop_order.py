"""The order of each GCN convolution's hop and weight (``models/gcn.py``), on
the CPU: a convolution that widens (d_out over d_in) runs Â (x W) as
(Â x) W, so that its hop runs at d_in; every other convolution keeps the
weight first. Output and every leaf's gradient against a float64
evaluation of the weight-first form, through the CSR pair (its plain
version, ``ops/spmm_csr.py::spmm_csr_reference``) and the dense float32
product, dropout masks included; the width each hop ran at (the
``spmm.propagate`` span's ``d``, the ``gcn.conv`` span's ``hop_d``) and the
counter ``gcn.hop_first``; nothing recorded while tracing is off.

Tolerance: abs 1e-6 on the output and on each gradient element (float32
over 20 nodes, values of order 1; the float32 port reads up to ~3e-7 in
either order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recbole_fairrec_tpu_torch.models.gcn import GCN
from recbole_fairrec_tpu_torch.ops import spmm
from recbole_fairrec_tpu_torch.utils import tracing

ATOL = 1e-6
N_USERS, N_ITEMS = 8, 12
N = N_USERS + N_ITEMS
# (in, hidden, out, layers): widening second (FairGo_GCN's form), the JAX
# test's 6 -> 5 -> 6, widening first, narrowing throughout, equal widths
WIDTHS = [(4, 3, 8, 2), (6, 5, 6, 2), (6, 5, 6, 3), (3, 8, 4, 2), (8, 4, 2, 2), (5, 5, 5, 2)]
IDS = ["4-3-8", "6-5-6", "6-5-5-6", "3-8-4", "8-4-2", "5-5-5"]
WIDENINGS = dict(zip(IDS, [1, 1, 1, 1, 0, 0]))  # convolutions with d_out over d_in


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _graph():
    """Â of a random bipartite graph (distinct pairs, ratings 1-5) as COO
    tensors and as a dense float32 matrix."""
    rng = np.random.RandomState(0)
    pairs = rng.choice(N_USERS * N_ITEMS, 40, replace=False)
    coo = sp.coo_matrix((rng.randint(1, 6, 40).astype(np.float32),
                         (pairs // N_ITEMS, pairs % N_ITEMS)), shape=(N_USERS, N_ITEMS))
    arrays = spmm.build_gcn_norm_coo(coo, N_USERS, N_ITEMS)
    dense = torch.from_numpy(spmm.coo_to_dense(*arrays, N))
    return tuple(torch.from_numpy(a) for a in arrays), dense


def _gcn(widths):
    d_in, hidden, d_out, layers = widths
    gcn = GCN(d_in, hidden, d_out, layers, torch.Generator().manual_seed(1))
    with torch.no_grad():  # biases off 0, so that they show in the output
        for conv in gcn.convs:
            conv.b.copy_(torch.randn(conv.b.shape, generator=torch.Generator().manual_seed(2)))
    return gcn


def _weight_first64(convs, x, dense, dropout, generator):
    """The convolutions ``[(w, b), ...]`` in float64 as Â (x W) + b, ReLU
    and dropout between, the masks drawn from ``generator`` as the model
    draws them."""
    A = dense.double()
    keep = 1.0 - dropout
    last = len(convs) - 1
    for i, (w, b) in enumerate(convs):
        x = A @ (x @ w) + b
        if i < last:
            x = torch.relu(x)
            if dropout > 0.0:
                mask = torch.rand(x.shape, generator=generator) < keep
                x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype))
    return x


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["p0", "p0.3"])
@pytest.mark.parametrize("path", ["csr", "dense"])
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_output_and_gradients_match_the_weight_first_form_in_float64(widths, path, dropout):
    (rows, cols, vals), dense = _graph()
    gcn = _gcn(widths)
    x = torch.randn(N, widths[0], generator=torch.Generator().manual_seed(3), requires_grad=True)
    # a cotangent of N(0, 1 / N): the gradients stay of order 1, as the tolerance assumes
    cotangent = torch.randn(N, widths[2], generator=torch.Generator().manual_seed(4)) / N ** 0.5
    out = gcn(x, rows, cols, vals, act="relu", dropout=dropout, train=True,
              generator=torch.Generator().manual_seed(5), dense=dense if path == "dense" else None)
    (out * cotangent).sum().backward()

    leaves = [x] + [t for conv in gcn.convs for t in (conv.w, conv.b)]
    leaves64 = [t.detach().double().requires_grad_(True) for t in leaves]
    ref = _weight_first64(list(zip(leaves64[1::2], leaves64[2::2])), leaves64[0], dense,
                          dropout, torch.Generator().manual_seed(5))
    (ref * cotangent.double()).sum().backward()

    torch.testing.assert_close(out.detach().double(), ref.detach(), rtol=0, atol=ATOL)
    names = ["x"] + [f"convs.{i}.{k}" for i in range(len(gcn.convs)) for k in "wb"]
    for name, t, t64 in zip(names, leaves, leaves64):
        torch.testing.assert_close(t.grad.double(), t64.grad, rtol=0, atol=ATOL, msg=name)


@pytest.mark.parametrize("path", ["csr", "dense"])
@pytest.mark.parametrize("widths,name", zip(WIDTHS, IDS), ids=IDS)
def test_each_hop_runs_at_the_narrower_width_of_its_convolution(widths, name, path):
    (rows, cols, vals), dense = _graph()
    gcn = _gcn(widths)
    x = torch.randn(N, widths[0], generator=torch.Generator().manual_seed(3), requires_grad=True)
    tracing.enable()
    gcn(x, rows, cols, vals, dense=dense if path == "dense" else None).sum().backward()
    recs = tracing.records()
    convs = [r for r in recs if r.name == "gcn.conv"]
    hops = [r for r in recs if r.name == "spmm.propagate"]
    assert [recs[h.parent] for h in hops] == convs
    shapes = [tuple(conv.w.shape) for conv in gcn.convs]
    assert [c.attrs["hop_d"] for c in convs] == [min(s) for s in shapes]
    # a narrowing or equal-width convolution keeps W first: its hop at d_out
    assert [h.attrs["d"] for h in hops] == [min(s) for s in shapes]
    assert tracing.counters().get("gcn.hop_first", 0) == WIDENINGS[name]


@pytest.mark.parametrize("widths,name", zip(WIDTHS, IDS), ids=IDS)
def test_hop_first_counts_the_widening_convolutions_once_a_forward(widths, name):
    (rows, cols, vals), _ = _graph()
    gcn = _gcn(widths)
    x = torch.randn(N, widths[0], generator=torch.Generator().manual_seed(3), requires_grad=True)
    tracing.enable()
    for forwards in (1, 2, 3):
        gcn(x, rows, cols, vals).sum().backward()  # the backward counts nothing of its own
        assert tracing.counters().get("gcn.hop_first", 0) == forwards * WIDENINGS[name]


@pytest.mark.parametrize("path", ["csr", "dense"])
def test_nothing_is_recorded_while_tracing_is_off(path):
    (rows, cols, vals), dense = _graph()
    gcn = _gcn((4, 3, 8, 2))
    x = torch.randn(N, 4, generator=torch.Generator().manual_seed(3), requires_grad=True)
    gcn(x, rows, cols, vals, dense=dense if path == "dense" else None).sum().backward()
    assert tracing.records() == [] and tracing.counters() == {}
