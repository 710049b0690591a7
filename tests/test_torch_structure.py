"""The structure ops, row access and conversions of the port
(``structure.py``, ``_rows.py``, ``constructors.py``, ``kernel.py`` and
the ``CSR`` methods on them), on the CPU: against the JAX package's
``CSR`` (its jitted structure ops on the CPU) and against dense numpy.
The cases are those of ``tests/test_transpose.py``,
``tests/test_attributes.py`` and ``tests/test_convert.py``.  The order
of entries that share a coordinate is unspecified after a sort in the
JAX package, so duplicates are compared by dense semantics."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from hypothesis import given, settings
import hypothesis.strategies as st

import csr_tpu
from csr_tpu.test_utils import csrs, sparse_matrices
from csr_tpu_torch import CSR, constructors, kernels, structure

from torch_util import kept, port_of, random_matrix
from util import to_dense

FEW = settings(max_examples=15, deadline=None)


def _dups():
    """Rows with unsorted columns and repeated coordinates, an empty row,
    an empty column: the same COO data in both packages."""
    rows = np.array([1, 1, 0, 1, 1, 3, 3, 0, 3], np.int32)
    cols = np.array([2, 2, 0, 2, 1, 4, 0, 3, 4], np.int32)
    vals = np.arange(1, 10, dtype=np.float32)
    return (csr_tpu.CSR.from_coo(rows, cols, vals, (4, 6)),
            CSR.from_coo(rows, cols, vals, (4, 6), device="cpu"))


def _pair(structure_only=False):
    a = random_matrix(60, 45, 0.1, seed=31)
    vals = None if structure_only else a.data
    return (csr_tpu.CSR(60, 45, a.nnz, a.indptr, a.indices, vals),
            CSR(60, 45, a.nnz, a.indptr, a.indices, vals, device="cpu"))


def _arrays(c):
    return [np.asarray(getattr(c, n)) if isinstance(c, csr_tpu.CSR)
            else getattr(c, n).numpy() for n in ("rowptrs", "colinds")]


@pytest.mark.parametrize("case", ["random", "structure_only", "duplicates"])
def test_transpose_matches_reference(case):
    ref, c = _dups() if case == "duplicates" else _pair(case == "structure_only")
    rt, t = ref.transpose(), c.transpose()
    assert (t.nrows, t.ncols, t.nnz) == (rt.nrows, rt.ncols, rt.nnz)
    assert t.device == c.device and t.rowptrs.dtype == c.rowptrs.dtype
    for got, want in zip(_arrays(t), _arrays(rt)):
        np.testing.assert_array_equal(got, want)
    assert (t.values is None) == (case == "structure_only")
    if case == "random":
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(rt.values))
    np.testing.assert_allclose(to_dense(t), to_dense(rt), rtol=1e-6)
    st_ = c.transpose_structure()
    assert st_.values is None and torch.equal(st_.colinds, t.colinds)


def test_transpose_keeps_row_order_within_a_column():
    """Entries of one column keep their row-major order: rows ascend, and
    repeated coordinates keep the order they were stored in."""
    _, c = _dups()
    t = c.transpose()
    assert t.rowptrs.tolist() == [0, 2, 3, 6, 7, 9, 9]
    assert t.colinds.tolist() == [0, 3, 1, 1, 1, 1, 0, 3, 3]
    assert t.values.tolist() == [3.0, 7.0, 5.0, 1.0, 2.0, 4.0, 8.0, 6.0, 9.0]


@FEW
@given(csrs())
def test_transpose(csr):
    c = port_of(csr)
    t = c.transpose()
    assert (t.nrows, t.ncols, t.nnz) == (c.ncols, c.nrows, c.nnz)
    np.testing.assert_allclose(to_dense(t), to_dense(c).T, rtol=1e-6)
    np.testing.assert_allclose(to_dense(t.transpose()), to_dense(c), rtol=1e-6)
    rps, cis = t.rowptrs.numpy(), t.colinds.numpy()
    for i in range(t.nrows):
        assert np.all(np.diff(cis[rps[i] : rps[i + 1]]) >= 0)


@FEW
@given(csrs(values=True))
def test_transpose_without_values(csr):
    c = port_of(csr)
    for t in (c.transpose(include_values=False), c.transpose_structure()):
        assert t.values is None
        np.testing.assert_array_equal(to_dense(t) != 0, to_dense(c).T != 0)


def test_transpose_small_exact():
    rows = np.array([0, 0, 1, 3], dtype=np.int32)
    cols = np.array([1, 2, 0, 1], dtype=np.int32)
    vals = np.arange(4, dtype=np.float32)
    csc = CSR.from_coo(rows, cols, vals, device="cpu").transpose()
    assert (csc.nrows, csc.ncols) == (3, 4)
    assert csc.rowptrs.tolist() == [0, 1, 3, 4]
    for r, c, v in zip(rows, cols, vals):
        assert float(csc.row(int(c))[r]) == v


def test_transpose_empty_column():
    rng = np.random.default_rng(5)
    mat = rng.standard_normal((40, 25))
    mat[mat <= 0] = 0
    mat[:, 0:2] = 0
    smat = sps.csr_matrix(mat)
    t = CSR.from_scipy(smat, device="cpu").transpose()
    st_ = smat.T.tocsr()
    np.testing.assert_array_equal(t.rowptrs.numpy(), st_.indptr)
    np.testing.assert_allclose(to_dense(t), st_.toarray(), rtol=1e-6)


@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_sort_rows_matches_reference(case):
    ref, c = _dups() if case == "duplicates" else _pair()
    dense = to_dense(c)
    rowptrs = c.rowptrs
    ref.sort_rows()
    c.sort_rows()
    assert c.rowptrs is rowptrs and kept(c, "host") is None
    np.testing.assert_array_equal(c.colinds.numpy(), np.asarray(ref.colinds))
    np.testing.assert_allclose(to_dense(c), dense, rtol=1e-6)
    if case == "duplicates":  # repeated coordinates keep their order
        assert c.values.tolist() == [3.0, 8.0, 5.0, 1.0, 2.0, 4.0, 7.0, 6.0, 9.0]


@FEW
@given(csrs())
def test_sort_rows(csr):
    c = port_of(csr)
    dense = to_dense(c)
    c.sort_rows()
    rps, cis = c.rowptrs.numpy(), c.colinds.numpy()
    for i in range(c.nrows):
        assert np.all(np.diff(cis[rps[i] : rps[i + 1]]) >= 0)
    np.testing.assert_allclose(to_dense(c), dense, rtol=1e-6)


@pytest.mark.parametrize("rows", [[3, 3, 0, 59], [], [7], list(range(60))[::-1]])
def test_pick_rows_matches_reference(rows):
    ref, c = _pair()
    p, rp = c.pick_rows(rows), ref.pick_rows(np.asarray(rows, np.int32))
    assert (p.nrows, p.ncols, p.nnz) == (len(rows), 45, rp.nnz)
    for got, want in zip(_arrays(p), _arrays(rp)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(p.values.numpy(), np.asarray(rp.values))
    assert c.pick_rows(rows, include_values=False).values is None


@FEW
@given(st.data())
def test_pick_rows(data):
    c = port_of(data.draw(csrs(nrows=st.integers(1, 50))))
    k = data.draw(st.integers(0, 10))
    rows = data.draw(st.lists(st.integers(0, c.nrows - 1), min_size=k, max_size=k))
    p = c.pick_rows(np.asarray(rows, np.int32))
    assert p.nrows == k
    np.testing.assert_allclose(to_dense(p), to_dense(c)[rows].reshape(k, c.ncols),
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_filter_nnzs_matches_reference(case):
    ref, c = _dups() if case == "duplicates" else _pair()
    filt = np.random.default_rng(42).random(c.nnz) > 0.5
    f, rf = c.filter_nnzs(filt), ref.filter_nnzs(filt)
    for got, want in zip(_arrays(f), _arrays(rf)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(f.values.numpy(), np.asarray(rf.values))
    assert torch.equal(c.filter_nnzs(torch.from_numpy(filt)).colinds, f.colinds)
    with pytest.raises(ValueError):
        c.filter_nnzs(np.ones(c.nnz + 1, bool))


def test_structure_helpers_on_tensors():
    """The row pointers of ascending row indices and the row ids of row
    pointers are each other's inverse; a row id expansion needs the
    caller's entry count only."""
    rows = torch.tensor([0, 1, 3, 3, 3], dtype=torch.int32)
    rps = structure._rowptrs_from_rows(rows, 5, torch.int32)
    assert rps.tolist() == [0, 1, 2, 2, 5, 5] and rps.dtype == torch.int32
    assert structure._row_ids(rps, 5, 5).tolist() == [0, 1, 3, 3, 3]
    assert structure._row_ids(torch.zeros(4, dtype=torch.int64), 3, 0).numel() == 0


# -- row access and attributes (tests/test_attributes.py) -------------------


def _fixture():
    rows = np.array([0, 0, 1, 3], dtype=np.int32)
    cols = np.array([1, 2, 0, 1], dtype=np.int32)
    vals = np.arange(4, dtype=np.float32)
    return CSR.from_coo(rows, cols, vals, (4, 3), device="cpu")


def test_row_access_fixed():
    c = _fixture()
    assert c.rowinds().tolist() == [0, 0, 1, 3]
    assert [c.row_extent(i) for i in range(4)] == [(0, 2), (2, 3), (3, 3), (3, 4)]
    assert [c.row(i).tolist() for i in range(4)] == [
        [0.0, 0.0, 1.0], [2.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 3.0, 0.0]]
    assert [c.row_cs(i).tolist() for i in range(4)] == [[1, 2], [0], [], [1]]
    assert [c.row_vs(i).tolist() for i in range(4)] == [[0.0, 1.0], [2.0], [], [3.0]]
    assert c.row_nnzs().tolist() == [2, 1, 0, 1]
    assert c.row([3, 0]).tolist() == [[0.0, 3.0, 0.0], [0.0, 0.0, 1.0]]
    assert c.row_mask(0).tolist() == [False, True, True]
    assert "4x3" in str(c) and "4 nnz" in str(c)
    c.values = None  # implicit ones
    assert c.row(0).tolist() == [0.0, 1.0, 1.0] and c.row(0).dtype == torch.float32
    assert c.row_vs(3).tolist() == [1.0]
    assert c._e_value(2) == 1.0


@pytest.mark.parametrize("structure_only", [False, True])
def test_row_access_matches_reference(structure_only):
    ref, c = _pair(structure_only)
    rows = np.array([5, 0, 5, 59], np.int32)
    np.testing.assert_array_equal(c.row(rows).numpy(), np.asarray(ref.row(rows)))
    np.testing.assert_array_equal(c.row(7).numpy(), np.asarray(ref.row(7)))
    np.testing.assert_array_equal(c.row_mask(rows).numpy(),
                                  np.asarray(ref.row_mask(rows)))
    np.testing.assert_array_equal(c.row_nnzs().numpy(), np.asarray(ref.row_nnzs()))
    for r in (0, 7, 59):
        assert c.row_extent(r) == ref.row_extent(r)
        np.testing.assert_array_equal(c.row_cs(r).numpy(), np.asarray(ref.row_cs(r)))
        np.testing.assert_array_equal(c.row_vs(r).numpy(), np.asarray(ref.row_vs(r)))
    if not structure_only:
        assert float(c._e_value(3)) == float(ref._e_value(3))


@FEW
@given(st.data())
def test_rows_dense(data):
    c = port_of(data.draw(csrs(nrows=st.integers(1, 30))))
    dense = to_dense(c)
    k = data.draw(st.integers(1, 5))
    rows = data.draw(st.lists(st.integers(0, c.nrows - 1), min_size=k, max_size=k))
    np.testing.assert_allclose(c.row(np.asarray(rows, np.int32)).numpy(),
                               dense[rows], rtol=1e-6)
    np.testing.assert_allclose(c.row(rows[0]).numpy(), dense[rows[0]], rtol=1e-6)
    m = c.row_mask(rows[0]).numpy()
    assert m.dtype == bool and np.all(m == (dense[rows[0]] != 0))
    sp, ep = c.row_extent(rows[0])
    assert len(c.row_cs(rows[0])) == len(c.row_vs(rows[0])) == ep - sp
    assert np.all(c.row_nnzs().numpy() == (dense != 0).sum(1))


@FEW
@given(st.data())
def test_fill_values(data):
    c = port_of(data.draw(csrs()))
    x = data.draw(st.floats(-1e3, 1e3, allow_nan=False, allow_subnormal=False))
    dtype = torch.float32 if c.values is None else c.values.dtype
    old = c.values
    c.fill_values(x)
    assert c.values is not old and c.values.dtype == dtype
    assert c.values.shape == (c.nnz,) and bool((c.values == torch.tensor(x, dtype=dtype)).all())
    with pytest.deprecated_call():
        c.drop_values()
    assert c.values is None and kept(c, "host") is None


# -- conversions (tests/test_convert.py) ------------------------------------


@FEW
@given(sparse_matrices(max_shape=(120, 120)))
def test_from_scipy_roundtrip(mat):
    c = CSR.from_scipy(mat, device="cpu")
    assert (c.nrows, c.ncols, c.nnz) == (*mat.shape, mat.nnz)
    np.testing.assert_allclose(to_dense(c), mat.toarray(), rtol=1e-6)


@FEW
@given(csrs())
def test_coo_roundtrip(csr):
    c = port_of(csr)
    vals = None if c.values is None else c.values.numpy()
    c2 = CSR.from_coo(c.rowinds().numpy(), c.colinds.numpy(), vals,
                      (c.nrows, c.ncols), device="cpu")
    np.testing.assert_allclose(to_dense(c2), to_dense(c), rtol=1e-6)


@FEW
@given(csrs())
def test_normalize(csr):
    c = port_of(csr)
    n = c._normalize(np.float64, np.int64)
    assert n.values.dtype == torch.float64 and n.rowptrs.dtype == torch.int64
    np.testing.assert_allclose(to_dense(n), to_dense(c), rtol=1e-6)
    assert c._normalize(False).values is None
    assert c._normalize(None).values is c.values
    assert c._normalize(torch.float32, torch.int32).rowptrs.dtype == torch.int32


@pytest.mark.parametrize("structure_only", [False, True])
@pytest.mark.parametrize("layout", [torch.sparse_csr, torch.sparse_coo])
def test_torch_sparse_roundtrip(layout, structure_only):
    """The counterpart of the JAX package's BCOO round trip: a torch
    sparse CSR or COO tensor and back, structure-only matrices as ones."""
    m = random_matrix(60, 45, 0.1, seed=4, big_group=False)
    c = CSR.from_scipy(m, device="cpu")
    if structure_only:
        c = c.copy(include_values=False)
    t = c.to_torch_sparse(layout)
    assert t.layout == layout and tuple(t.shape) == (60, 45)
    want = (m.toarray() != 0).astype(np.float32) if structure_only else m.toarray()
    np.testing.assert_allclose(t.to_dense().numpy(), want, rtol=1e-6)
    back = CSR.from_torch_sparse(t)
    assert back.device == c.device
    np.testing.assert_allclose(to_dense(back), want, rtol=1e-6)


def test_to_torch_sparse_keeps_duplicates_honest():
    """Unsorted rows and a repeated coordinate: the COO form is left
    uncoalesced, and both forms sum the repeat when made dense."""
    c = CSR.from_coo([0, 0, 0], [5, 2, 5], [1.0, 2.0, 3.0], (1, 8), device="cpu")
    coo = c.to_torch_sparse(torch.sparse_coo)
    assert not coo.is_coalesced()
    for t in (coo, c.to_torch_sparse()):
        np.testing.assert_allclose(t.to_dense().numpy(), to_dense(c), rtol=1e-6)
    assert CSR.from_torch_sparse(coo).nnz == 2  # torch sums the repeat
    with pytest.raises(ValueError):
        CSR.from_torch_sparse(torch.ones(3, 3).to_sparse(1))  # not 2-D sparse
    with pytest.raises(ValueError):
        CSR.from_torch_sparse(torch.zeros(2, 2, 2).to_sparse())


# -- constructors and the static kernel -------------------------------------


def test_constructors_match_reference():
    from csr_tpu import constructors as ref_cons

    e, re_ = constructors.create_empty(4, 5, device="cpu"), ref_cons.create_empty(4, 5)
    assert (e.nrows, e.ncols, e.nnz) == (re_.nrows, re_.ncols, 0)
    assert e.values.dtype == torch.float32
    s = constructors.create_from_sizes(3, 4, [2, 0, 1], device="cpu")
    rs = ref_cons.create_from_sizes(3, 4, [2, 0, 1])
    np.testing.assert_array_equal(s.rowptrs.numpy(), np.asarray(rs.rowptrs))
    assert s.colinds.tolist() == [-1] * 3 and bool(s.values.isnan().all())
    rp, ci = np.array([0, 1, 1]), np.array([2], np.int32)
    n = constructors.create_novalues(2, 3, 1, rp, ci, device="cpu")
    v = constructors.create(2, 3, 1, rp, ci, np.array([4.0], np.float32),
                            device="cpu")
    assert n.values is None and v.values.tolist() == [4.0]
    assert to_dense(n).tolist() == [[0, 0, 1], [0, 0, 0]]


def test_static_kernel_is_the_default():
    from csr_tpu_torch import kernel

    default = kernels._default_kernel()
    assert kernel.name == default.__name__
    for name in ("to_handle", "from_handle", "release_handle", "order_columns",
                 "mult_ab", "mult_abt", "mult_vec", "mult_vec_t", "mult_dense",
                 "max_nnz"):
        assert getattr(kernel, name) is getattr(default, name), name


@pytest.mark.parametrize("kernel", ["scipy", "torch", "cuda"])
def test_order_columns(kernel):
    """The kernel contract's ``order_columns`` sorts the rows on every
    backend (it raised on ``torch`` and ``cuda`` before ``sort_rows``)."""
    _, c = _dups()
    K = kernels.get_kernel(kernel)
    h = K.to_handle(c)
    K.order_columns(h)
    out = K.from_handle(h)
    rps, cis = out.to_scipy().indptr, out.to_scipy().indices
    for i in range(out.nrows):
        assert np.all(np.diff(cis[rps[i] : rps[i + 1]]) >= 0)
    np.testing.assert_allclose(to_dense(out), to_dense(_dups()[1]), rtol=1e-6)
    K.release_handle(h)
