"""Long rows on the CSR form, as the KDD-Cup'11 Yahoo! Music ratings give
them (hundreds of ratings a user, an item rated by a large share of the
users): a matrix of that shape at a small size, on the CPU under the
``cuda`` backend, whose CSR-form plain versions (``spmm_csr_reference``,
``spmv_csr_reference``) split the work into shares of merge items and
carries as the kernels do.  The products against a float64 dense
product under ``tests/util.py``'s tolerances, the split's counters
(``csr.edges.*``) against a direct count from ``csr_parts``, and the
``csr.construct.from_coo`` span and those counters silent with tracing
off."""

import zlib

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import csr_tpu_torch.kernels as kernels
from csr_tpu_torch import CSR, tracing
from csr_tpu_torch.kernels import cuda as cuda_k
from csr_tpu_torch.ops import spmm, spmv

from torch_util import Scipy
from util import assert_spmv_close, dense_tols

NCOLS = 200_000
#: the row that spans many SpMM shares (1024 merge items each)
LONG = 150


def _yahoo_like():
    """About 300 rows of 200-600 entries and 3,000 of 10 over 200,000
    columns (power-law popularity), one row of about 6,500 entries, and
    column 0 in every row (a row of the transpose of 3,301 entries);
    integer ratings 0-100, each (row, column) pair once."""
    rng = np.random.default_rng(16)
    deg = np.insert(np.concatenate([rng.integers(200, 601, 300), np.full(3000, 9)]),
                    LONG, 7000)
    nrows = deg.size
    cdf = np.cumsum(np.arange(1, NCOLS + 1, dtype=np.float64) ** -0.6)
    rank = np.minimum(np.searchsorted(cdf / cdf[-1], rng.random(int(deg.sum()))), NCOLS - 1)
    rows = np.concatenate([np.repeat(np.arange(nrows), deg), np.arange(nrows)])
    cols = np.concatenate([rng.permutation(NCOLS)[rank], np.zeros(nrows, np.int64)])
    vals = rng.integers(0, 101, rows.size).astype(np.float64)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(nrows, NCOLS)).tocsr()
    a.sum_duplicates()  # a pair drawn twice is one rating
    a.data = np.minimum(a.data, 100).astype(np.float32)
    return a


A = _yahoo_like()


def _port(a):
    return CSR(a.shape[0], a.shape[1], a.nnz, torch.from_numpy(a.indptr.astype(np.int32)),
               torch.from_numpy(a.indices.astype(np.int32)),
               torch.from_numpy(a.data.astype(np.float32)), _cast=False)


@pytest.fixture(scope="module")
def sides():
    r = _port(A)
    return {"R": (r, A), "Rt": (r.transpose(), A.T.tocsr())}


def _shares_of_rows(rowptrs, nnz, tile):
    """Shares each row's entries lie in, from the kernels' parts."""
    _, rows = spmv.csr_parts(rowptrs, nnz, tile)
    return torch.bincount(rows, minlength=rowptrs.shape[0] - 1)


def test_the_rows_are_long():
    shares = _shares_of_rows(torch.from_numpy(A.indptr), A.nnz, spmm.CSR_TILE)
    assert int(shares[LONG]) >= 5
    t = A.T.tocsr()
    shares_t = _shares_of_rows(torch.from_numpy(t.indptr), t.nnz, spmm.CSR_TILE)
    assert int(shares_t[0]) >= 3
    lengths = np.diff(A.indptr)
    assert np.median(lengths[lengths > 100]) > 300


@pytest.mark.parametrize("side", ["R", "Rt"])
@pytest.mark.parametrize("method,n", [("mult_dense", 50), ("mult_dense", 7),
                                      ("mult_vec", None), ("mult_vec_t", None)])
def test_products_on_the_csr_form(sides, side, method, n):
    c, a = sides[side]
    a64 = a.astype(np.float64)
    rng = np.random.default_rng(zlib.crc32(f"{side} {method} {n}".encode()))
    if method == "mult_dense":
        assert cuda_k._spmm_route(c, n) == "csr"
        b = rng.standard_normal((a.shape[1], n)).astype(np.float32)
        with kernels.use_kernel("cuda"):
            got = c.mult_dense(torch.from_numpy(b)).numpy()
        ref = a64 @ b.astype(np.float64)
        np.testing.assert_allclose(got, ref, **dense_tols(ref, np.float32))
        return
    transpose = method == "mult_vec_t"
    assert cuda_k._spmv_route(c, transpose) == "csr"
    x = rng.standard_normal(a.shape[0] if transpose else a.shape[1]).astype(np.float32)
    with kernels.use_kernel("cuda"):
        got = getattr(c, method)(torch.from_numpy(x)).numpy()
    m = a64.T.tocsr() if transpose else a64
    assert_spmv_close(got, m @ x.astype(np.float64), Scipy(m), x)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind", ["spmm", "spmv"])
def test_edge_counters_count_the_split(sides, kind, transpose):
    c = sides["R"][0]
    tile = spmm.CSR_TILE if kind == "spmm" else spmv.CSR_TILE
    edges = cuda_k._spmm_edges if kind == "spmm" else cuda_k._spmv_edges
    rowptrs = cuda_k._cached_csr_t(c)[0] if transpose else c.rowptrs
    shares = _shares_of_rows(rowptrs, c.nnz, tile)
    fresh = _port(A)
    rec = tracing.enable()
    try:
        edges(fresh, transpose)
        built = rec.snapshot(reset=True)["counters"]
        edges(fresh, transpose)  # cached: counted once
        again = rec.snapshot()["counters"]
    finally:
        tracing.disable()
    assert built["csr.edges.shares"] == spmv.n_shares(rowptrs.shape[0] - 1, c.nnz, tile)
    assert built["csr.edges.rows_cut"] == int((shares >= 2).sum()) > 0
    assert built["csr.edges.rows_spanning"] == int((shares >= 3).sum())
    assert not any(k.startswith("csr.edges.") for k in again)


def test_span_and_counters_silent_with_tracing_off(monkeypatch):
    """Off, ``from_coo`` records no span and an edge build computes no
    counter; on, ``from_coo`` is one span, and a product's first call
    counts the split of its edges where its plan's hits count none."""
    calls = []
    unique = torch.unique_consecutive

    def counted(*args, **kwargs):
        calls.append(1)
        return unique(*args, **kwargs)

    coo = A.tocoo()
    args = (torch.from_numpy(coo.row), torch.from_numpy(coo.col), torch.from_numpy(coo.data))
    assert tracing._recorder is None
    c = CSR.from_coo(*args, shape=A.shape, device="cpu")
    monkeypatch.setattr(torch, "unique_consecutive", counted)
    cuda_k._spmm_edges(c)
    monkeypatch.undo()
    assert calls == [] and tracing.snapshot()["spans"] == {}
    b = torch.ones(NCOLS, 50)
    rec = tracing.enable()
    try:
        c = CSR.from_coo(*args, shape=A.shape, device="cpu")
        with kernels.use_kernel("cuda"):
            c.mult_dense(b)
            first = rec.snapshot(reset=True)
            c.mult_dense(b)
            hit = rec.snapshot()
    finally:
        tracing.disable()
    assert first["spans"]["csr.construct.from_coo"]["count"] == 1
    assert first["counters"]["csr.edges.shares"] == spmv.n_shares(A.shape[0], A.nnz,
                                                                  spmm.CSR_TILE)
    assert hit["counters"].get("plan.hit") == 1
    assert not any(k.startswith("csr.edges.") for k in hit["counters"])
    assert not any(k.startswith("csr.construct.") for k in hit["spans"])
