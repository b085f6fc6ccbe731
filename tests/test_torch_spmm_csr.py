"""The CSR form of the propagation matrices and its product
(``ops/spmm_csr.py``), on the CPU: the forms of A and Aᵀ built from the COO
arrays of both normalisations (empty rows, repeated pairs), the pieces of
the merge path the kernel reads, the plain product against the JAX
package's ``spmm_coo`` and ``propagate`` and the dense product, the autograd
Function's gradient against the dense transpose (``gradcheck`` in float64),
and ``propagate``'s ``csr`` path, passed or built, with its span and
counters. The kernel
itself runs on the card only (``tests/test_torch_kernels_gpu.py``); here a
loop that follows its pieces, carries and carry pass shows that the plan it
reads covers every entry once.

Tolerances: the CSR forms are exact (the same values, moved); products
float32 abs 1e-6 (sums in another order), as ``test_torch_fairgo.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recbole_fairrec_tpu.ops import spmm as jax_spmm

from recbole_fairrec_tpu_torch.ops import spmm, spmm_csr
from recbole_fairrec_tpu_torch.utils import tracing

PROP_ATOL = 1e-6
BUILDS = ["build_bipartite_norm_coo", "build_gcn_norm_coo"]
N_USERS, N_ITEMS = 8, 10  # user 7 and item 9 rate nothing: empty rows (and PAD 0)
N = N_USERS + N_ITEMS


def _rating_coo(seed=0, nnz=48, duplicates=True):
    """Ratings of users 1-6 on items 1-8 (rows and columns 0, user 7 and
    item 9 stay empty), with repeated pairs unless ``duplicates`` is off."""
    rng = np.random.RandomState(seed)
    rows, cols = rng.randint(1, N_USERS - 1, nnz), rng.randint(1, N_ITEMS - 1, nnz)
    data = rng.randint(1, 6, nnz).astype(np.float32)
    coo = sp.coo_matrix((data, (rows, cols)), shape=(N_USERS, N_ITEMS))
    if duplicates:
        assert len(set(zip(rows.tolist(), cols.tolist()))) < nnz
    else:
        coo.sum_duplicates()
    return coo


def _arrays(build, duplicates=True):
    return tuple(torch.from_numpy(a) for a in getattr(spmm, build)(
        _rating_coo(duplicates=duplicates), N_USERS, N_ITEMS))


def _summed_dense(rows, cols, vals, n):
    """The COO matrix with repeated pairs summed, as the CSR product reads it."""
    A = np.zeros((n, n), dtype=np.float64)
    np.add.at(A, (rows.numpy(), cols.numpy()), vals.numpy().astype(np.float64))
    return A


def _csr_dense(csr, n_rows):
    rows = np.repeat(np.arange(n_rows), np.diff(csr.rowptr.numpy()))
    A = np.zeros((n_rows, csr.n_cols), dtype=np.float64)
    np.add.at(A, (rows, csr.cols.numpy()), csr.vals.numpy().astype(np.float64))
    return A


@pytest.mark.parametrize("duplicates", [True, False], ids=["repeats", "distinct"])
@pytest.mark.parametrize("build", BUILDS)
def test_csr_forms_of_a_and_its_transpose(build, duplicates):
    rows, cols, vals = _arrays(build, duplicates)
    pair = spmm_csr.csr_pair(rows, cols, vals, N)
    for csr in pair:
        assert csr.rowptr.dtype == csr.cols.dtype == csr.splits.dtype == torch.int32
        assert csr.vals.dtype == torch.float32 and csr.n_cols == N
        assert int(csr.rowptr[0]) == 0 and int(csr.rowptr[-1]) == rows.numel()
    counts = np.bincount(rows.numpy(), minlength=N)
    np.testing.assert_array_equal(pair.fwd.rowptr.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    t_counts = np.bincount(cols.numpy(), minlength=N)
    np.testing.assert_array_equal(pair.bwd.rowptr.numpy(),
                                  np.concatenate([[0], np.cumsum(t_counts)]))
    # PAD, user 7 and item 9 hold no entry (the GCN's rows hold their self loop)
    assert (counts == 0).sum() >= (3 if build == "build_bipartite_norm_coo" else 0)
    A = _summed_dense(rows, cols, vals, N)
    np.testing.assert_array_equal(_csr_dense(pair.fwd, N), A)
    np.testing.assert_array_equal(_csr_dense(pair.bwd, N), A.T)
    if build == "build_bipartite_norm_coo" or not duplicates:  # no pair repeats: the dense form
        dense = spmm.coo_to_dense(rows, cols, vals, N)
        np.testing.assert_array_equal(_csr_dense(pair.bwd, N), dense.T.astype(np.float64))
    # Aᵀ's values are A's, moved: D⁻¹A is not symmetric, so they are not A's in A's order
    np.testing.assert_array_equal(np.sort(pair.bwd.vals.numpy()), np.sort(vals.numpy()))
    if build == "build_bipartite_norm_coo":
        assert not np.array_equal(A, A.T)


def test_csr_keeps_each_rows_entries_in_coo_order():
    """A stable sort by row: ``build_bipartite_norm_coo``'s (row, col) order is
    kept, and Aᵀ's rows hold their entries by source row."""
    rows, cols, vals = _arrays("build_bipartite_norm_coo")
    pair = spmm_csr.csr_pair(rows, cols, vals, N)
    np.testing.assert_array_equal(pair.fwd.cols.numpy(), cols.numpy())
    np.testing.assert_array_equal(pair.fwd.vals.numpy(), vals.numpy())
    t_rows = np.repeat(np.arange(N), np.diff(pair.bwd.rowptr.numpy()))
    key = t_rows * N + pair.bwd.cols.numpy()
    assert (np.diff(key) > 0).all()


def _kernel_loop(csr, x):
    """The kernel's arithmetic as plain loops: each piece of the merge path
    sums the rows that end in it into ``y`` and the row it stops inside
    into its carry; then each run of one row's carries is added to the row,
    in piece order. Returns ``y`` and the count of entries each piece read."""
    rowptr = csr.rowptr.tolist()
    splits = csr.splits.tolist()
    n_rows, nnz = len(rowptr) - 1, rowptr[-1]
    total, pieces = n_rows + nnz, len(splits) - 1
    xs, cols, vals = x.numpy(), csr.cols.tolist(), csr.vals.numpy()
    y = np.full((n_rows, x.shape[1]), np.nan, dtype=np.float32)
    carry = np.zeros((pieces, x.shape[1]), dtype=np.float32)
    carry_row = [-1] * pieces
    read = np.zeros(nnz, dtype=np.int64)

    def row_sum(start, end):
        acc = np.zeros(x.shape[1], dtype=np.float32)
        for k in range(start, end):
            acc = acc + vals[k] * xs[cols[k]]
            read[k] += 1
        return acc

    for p in range(pieces):
        diag0, diag1 = p * csr.items, min((p + 1) * csr.items, total)
        row0, row1 = splits[p], splits[p + 1]
        start, entry1 = diag0 - row0, diag1 - row1
        for r in range(row0, row1):
            y[r] = row_sum(start, rowptr[r + 1])
            start = rowptr[r + 1]
        if row1 < n_rows and start < entry1:
            carry_row[p], carry[p] = row1, row_sum(start, entry1)
    for p in range(pieces):
        r = carry_row[p]
        if r < 0 or (p > 0 and carry_row[p - 1] == r):
            continue
        total_carry = carry[p].copy()
        q = p + 1
        while q < pieces and carry_row[q] == r:
            total_carry += carry[q]
            q += 1
        y[r] += total_carry
    return torch.from_numpy(y), read


def _power_law(n_rows=40, n_cols=30, long_row=200, seed=3):
    """A matrix with empty rows, rows of a few entries and one row of
    ``long_row`` entries (repeated columns) that spans many pieces."""
    rng = np.random.RandomState(seed)
    degree = rng.zipf(1.8, n_rows).clip(max=12)
    degree[[0, 5, 6, 33]] = 0
    degree[17] = long_row
    rows = np.repeat(np.arange(n_rows), degree)
    cols = rng.randint(0, n_cols, rows.size)
    vals = rng.randn(rows.size).astype(np.float32)
    return torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals)


@pytest.mark.parametrize("items", [1, 2, 7, 64, spmm_csr.ITEMS])
def test_the_pieces_cover_every_entry_once(items):
    rows, cols, vals = _power_law()
    pair = spmm_csr.csr_pair(rows, cols, vals, 40, 30, items=items)
    x = torch.randn(30, 5, generator=torch.Generator().manual_seed(4))
    y, read = _kernel_loop(pair.fwd, x)
    assert (read == 1).all()
    assert not torch.isnan(y).any()  # every row written, the empty ones with 0
    np.testing.assert_allclose(y.numpy(), spmm_csr.spmm_csr_reference(pair.fwd, x).numpy(),
                               rtol=0, atol=PROP_ATOL * 10)
    assert pair.fwd.splits.numel() - 1 == -(-(40 + rows.numel()) // items)
    yt, read_t = _kernel_loop(pair.bwd, torch.randn(40, 3))
    assert (read_t == 1).all() and not torch.isnan(yt).any()


def test_merge_path_splits_by_hand():
    """Rows of 3, 0 and 2 entries: the path is e e e | | e e |; cut every 3
    items, the pieces start after 0, 0 and 2 row ends, and the path's end
    after all 3."""
    rowptr = torch.tensor([0, 3, 3, 5])
    assert spmm_csr.merge_path_splits(rowptr, 3).tolist() == [0, 0, 2, 3]
    assert spmm_csr.merge_path_splits(rowptr, 100).tolist() == [0, 3]
    assert spmm_csr.merge_path_splits(torch.tensor([0, 0, 0]), 4).tolist() == [0, 2]


@pytest.mark.parametrize("build", BUILDS)
def test_plain_csr_product_matches_coo_dense_and_jax(build):
    rows, cols, vals = _arrays(build, duplicates=False)
    pair = spmm_csr.csr_pair(rows, cols, vals, N)
    x = np.random.RandomState(1).randn(N, 5).astype(np.float32)
    xt = torch.from_numpy(x)
    ours = spmm_csr.spmm_csr(pair.fwd, xt)
    assert ours.dtype == torch.float32 and ours.shape == (N, 5)
    jarrays = [jnp.asarray(a.numpy()) for a in (rows, cols, vals)]
    coo = jax_spmm.spmm_coo(*jarrays, jnp.asarray(x), N)
    dense = spmm.propagate(xt, rows, cols, vals, N,
                           dense=torch.from_numpy(spmm.coo_to_dense(rows, cols, vals, N)))
    ref = jax_spmm.propagate(jnp.asarray(x), *jarrays, N)
    for other in (np.asarray(coo), dense.numpy(), np.asarray(ref)):
        np.testing.assert_allclose(ours.numpy(), other, rtol=0, atol=PROP_ATOL)


@pytest.mark.parametrize("build", BUILDS)
def test_the_hop_gradient_is_the_transpose(build):
    rows, cols, vals = _arrays(build)
    pair = spmm_csr.csr_pair(rows, cols, vals, N)
    A = torch.from_numpy(_summed_dense(rows, cols, vals, N))
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(N, 4)).requires_grad_(True)
    g = torch.from_numpy(rng.randn(N, 4))
    out = spmm_csr.CsrHop.apply(x, pair)
    (out * g).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), (A @ x.detach()).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), (A.T @ g).numpy(), rtol=0, atol=1e-12)
    assert torch.autograd.gradcheck(lambda v: spmm_csr.CsrHop.apply(v, pair),
                                    (torch.from_numpy(rng.randn(N, 3)).requires_grad_(True),))


@pytest.fixture
def tracer():
    tracing.disable()
    tracing.reset()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.reset()


def test_propagate_through_csr_is_traced_and_counted(tracer):
    rows, cols, vals = _arrays("build_bipartite_norm_coo")
    pair = spmm_csr.csr_pair(rows, cols, vals, N)
    x = torch.randn(N, 6, generator=torch.Generator().manual_seed(6))
    before = spmm_csr.launches
    out = spmm.propagate(x, rows, cols, vals, N, csr=pair)
    built = spmm.propagate(x, rows, cols, vals, N)  # the pair built for this call
    assert torch.equal(built, out)
    coo = jax_spmm.spmm_coo(*(jnp.asarray(a.numpy()) for a in (rows, cols, vals)),
                            jnp.asarray(x.numpy()), N)
    np.testing.assert_allclose(out.numpy(), np.asarray(coo), rtol=0, atol=PROP_ATOL)
    assert spmm_csr.launches == before  # the CPU takes the plain version
    E = rows.numel()
    assert tracer.counters() == {"spmm.edges": 2 * E, "spmm.csr_edges": 2 * E}
    hops = [r for r in tracer.records() if r.name == "spmm.propagate"]
    assert [h.attrs for h in hops] == [{"path": "csr", "edges": E, "d": 6}] * 2


def test_dense_propagation_without_coo_arrays_counts_no_edges(tracer):
    A = torch.randn(N, N, generator=torch.Generator().manual_seed(7))
    x = torch.randn(N, 3, generator=torch.Generator().manual_seed(8))
    out = spmm.propagate(x, None, None, None, N, dense=A)
    np.testing.assert_allclose(out.numpy(), (A @ x).numpy(), rtol=1e-6, atol=1e-6)
    assert tracer.counters() == {"spmm.edges": 0}


@pytest.mark.parametrize("d,vec,lanes", [(16, 4, 4), (48, 4, 16), (64, 4, 16), (128, 4, 32),
                                         (192, 4, 32), (5, 1, 8), (30, 1, 32), (1, 1, 1)])
def test_lanes_per_entry(d, vec, lanes):
    assert spmm_csr.lanes_per_entry(d, vec) == lanes


def test_csr_pair_refuses_what_the_kernel_cannot_index(monkeypatch):
    rows, cols, vals = _arrays("build_gcn_norm_coo")
    with pytest.raises(TypeError, match="float32"):
        spmm_csr.csr_pair(rows, cols, vals.double(), N)
    monkeypatch.setattr(spmm_csr, "INDEX_LIMIT", rows.numel() + N - 1)
    with pytest.raises(ValueError, match="int32"):
        spmm_csr.csr_pair(rows, cols, vals, N)


def test_spmm_csr_checks_its_inputs():
    rows, cols, vals = _arrays("build_gcn_norm_coo")
    pair = spmm_csr.csr_pair(rows, cols, vals, N)
    with pytest.raises(ValueError, match="not"):
        spmm_csr.spmm_csr(pair.fwd, torch.randn(N + 1, 4))
    with pytest.raises(ValueError, match="not"):
        spmm_csr.spmm_csr(pair.fwd, torch.randn(N))


@pytest.mark.parametrize("chunk", [1, 7, 1 << 22])
def test_chip_smokes_float64_sums_take_whole_rows(chunk):
    """``chip_smoke.csr_sums_float64`` (the graph phase's reference) in slices
    of whole rows, however they fall across the long row, equals the float64
    plain product and its magnitude."""
    import chip_smoke

    rows, cols, vals = _power_law()
    pair = spmm_csr.csr_pair(rows, cols, vals, 40, 30)
    x = torch.randn(30, 5, generator=torch.Generator().manual_seed(5))
    exact, magnitude = chip_smoke.csr_sums_float64(pair.fwd, x, chunk=chunk)
    np.testing.assert_allclose(exact.numpy(),
                               spmm_csr.spmm_csr_reference(pair.fwd, x.double()).numpy(),
                               rtol=1e-12, atol=1e-12)
    abs_csr = pair.fwd._replace(vals=pair.fwd.vals.abs())
    np.testing.assert_allclose(magnitude.numpy(),
                               spmm_csr.spmm_csr_reference(abs_csr, x.abs().double()).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_chip_smokes_lastfm_like_graph_is_a_row_normalised_bipartite_graph():
    """``chip_smoke.lastfm_like_graph`` at a small size on the CPU: each user
    has 40 or 41 distinct artists, every edge appears in both directions
    with one rating, and each non-empty row of D⁻¹A sums to 1."""
    import chip_smoke

    users, artists, train_rows = 300, 500, 300 * 40 + 123
    rows, cols, vals, n = chip_smoke.lastfm_like_graph(
        seed=11, device="cpu", users=users, artists=artists, train_rows=train_rows)
    assert n == users + artists + 2 and rows.numel() == 2 * train_rows
    user_side = rows <= users
    assert int(user_side.sum()) == train_rows
    assert bool((cols[user_side] > users + 1).all()) and bool((rows[~user_side] > users + 1).all())
    degree = torch.bincount(rows[user_side], minlength=users + 1)[1:]
    assert set(degree.tolist()) == {40, 41} and int((degree == 41).sum()) == 123
    pairs = set(zip(rows[user_side].tolist(), cols[user_side].tolist()))
    assert len(pairs) == train_rows
    assert pairs == set(zip(cols[~user_side].tolist(), rows[~user_side].tolist()))
    sums = torch.zeros(n, dtype=torch.float64).index_add_(0, rows, vals.double())
    nonempty = torch.bincount(rows, minlength=n) > 0
    np.testing.assert_allclose(sums[nonempty].numpy(), 1.0, rtol=1e-6)
    assert not bool(nonempty[[0, users + 1]].any())  # the PAD rows stay empty
