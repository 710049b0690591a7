"""The CSR-form SpMV (``ops/spmv.py:spmv_csr``, kernel
``csrc/spmv_csr.cu``) and its route in ``kernels/cuda.py``, on the CPU:
``spmv_csr_reference`` (the kernel's split of the merge of row ends and
entries, its parts and fix-up) and the routed ``CSR.mult_vec`` /
``mult_vec_t`` of the ``cuda`` backend against ``csr_tpu``'s products
under ``pallas`` (interpret mode, as ``tests/test_torch_spmv.py`` runs it)
and against scipy, under ``tests/util.py:assert_spmv_close`` (rtol 1e-4,
384 f32 eps times the 128-row window's L1 mass, unchanged).

Every parity case is 256 x 65,536 so that the Pallas interpreter traces
each direction once for the module."""

import pathlib
import re

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from hypothesis import given, settings, strategies as st

import csr_tpu
import csr_tpu.kernels as ref_kernels
import csr_tpu_torch.kernels as kernels
from csr_tpu_torch import CSR
from csr_tpu_torch.kernels import cuda as cuda_k
from csr_tpu_torch.ops import _cuda, microblock as mb, spmv

from torch_util import Scipy, kept, power_law
from util import assert_spmv_close

SHAPE = (256, 1 << 16)


def _cases():
    nrows, ncols = SHAPE
    hyper = np.full(nrows, 12)
    long_row = np.full(nrows, 3)
    long_row[7] = 20_000  # about ten shares of 2048 merge items
    sparse_rows = np.where(np.arange(nrows) % 5 == 0, 9, 0)  # 4 in 5 empty
    return {"hypersparse": power_law(nrows, ncols, hyper, 1),
            "long row": power_law(nrows, ncols, long_row, 2),
            "empty rows": power_law(nrows, ncols, sparse_rows, 3)}


CASES = _cases()


def _port(a, ptr_dtype):
    """The port's CSR of scipy ``a`` on the CPU, row pointers of
    ``ptr_dtype`` (tensors, kept as given)."""
    return CSR(a.shape[0], a.shape[1], a.nnz,
               torch.from_numpy(a.indptr.astype(np.int64)).to(ptr_dtype),
               torch.from_numpy(a.indices.astype(np.int32)),
               torch.from_numpy(a.data.astype(np.float32)), _cast=False)


@pytest.fixture(scope="module")
def pallas_results():
    """csr_tpu's mult_vec and mult_vec_t of every case under pallas
    (interpret mode), with their seeded operands."""
    out = {}
    for i, (name, a) in enumerate(CASES.items()):
        rng = np.random.default_rng(40 + i)
        x = rng.uniform(-1, 1, a.shape[1]).astype(np.float32)
        xt = rng.uniform(-1, 1, a.shape[0]).astype(np.float32)
        ref = csr_tpu.CSR(a.shape[0], a.shape[1], a.nnz, a.indptr, a.indices,
                          a.data)
        with ref_kernels.use_kernel("pallas"):
            out[name] = (x, xt, np.asarray(ref.mult_vec(x)),
                         np.asarray(ref.mult_vec_t(xt)))
    return out


@pytest.mark.parametrize("ptr_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_routed_products_match_pallas(case, ptr_dtype, pallas_results,
                                      monkeypatch):
    a = CASES[case]
    x, xt, ry, ryt = pallas_results[case]
    if case == "long row":
        # its long row packs densely (about 19 layout bytes an entry, under
        # the crossover): hold it on the CSR route, whose shares it spans
        monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", 0.0)
    c = _port(a, ptr_dtype)
    assert c.rowptrs.dtype == ptr_dtype
    assert cuda_k._spmv_route(c, False) == cuda_k._spmv_route(c, True) == "csr"
    with kernels.use_kernel("cuda"):
        y = c.mult_vec(x)
        yt = c.mult_vec_t(xt)
    assert y.dtype == yt.dtype == torch.float32
    assert y.shape == (a.shape[0],) and yt.shape == (a.shape[1],)
    at = Scipy(a.T.tocsr())
    for got, want, m, v in ((y, ry, Scipy(a), x), (yt, ryt, at, xt)):
        assert_spmv_close(got.numpy(), want, m, v)
    assert_spmv_close(y.numpy(), a.astype(np.float64) @ x, Scipy(a), x)
    assert_spmv_close(yt.numpy(), a.T.astype(np.float64) @ xt, at, xt)
    # the CSR route builds no micro-block layout either way
    for form in ("layout", "layout_t", "large", "large_t"):
        assert kept(c, form) is None, form


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas(case, pallas_results):
    """The plain version against csr_tpu and scipy; rows with no entry are
    exact zeros (every row a sum of its own products only)."""
    a = CASES[case]
    x, _, ry, _ = pallas_results[case]
    c = _port(a, torch.int32)
    y = spmv.spmv_csr_reference(c.rowptrs, c.colinds, c.values,
                                torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (a.shape[0],)
    assert_spmv_close(y.numpy(), ry, Scipy(a), x)
    assert_spmv_close(y.numpy(), a.astype(np.float64) @ x, Scipy(a), x)
    empty = np.diff(a.indptr) == 0
    assert np.all(y.numpy()[empty] == 0)


@pytest.mark.parametrize("transpose", [False, True])
def test_share_edges_cached(transpose):
    """The cuda backend caches the rows at the CSR-form SpMV's share edges
    (csr_shares' first tensor, of the transpose for mult_vec_t), hands
    them to the kernel's wrapper, and builds them again after an in-place
    edit of rowptrs or colinds."""
    a = CASES["long row"]
    c = _port(a, torch.int32)
    seen = []
    real = spmv.spmv_csr

    def spy(*args, **kw):
        seen.append(kw.get("edges"))
        return real(*args, **kw)

    rp_of = lambda: cuda_k._cached_csr_t(c)[0] if transpose else c.rowptrs
    v = np.ones(a.shape[0] if transpose else a.shape[1], np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spmv, "spmv_csr", spy)
        mp.setattr(cuda_k, "_CSR_CROSSOVER", 0.0)
        with kernels.use_kernel("cuda"):
            for _ in range(2):
                c.mult_vec_t(v) if transpose else c.mult_vec(v)
            first = cuda_k._spmv_edges(c, transpose)
            assert seen == [first, first]  # the same tensor: cached
            assert torch.equal(first, spmv.csr_shares(rp_of(), a.nnz)[0])
            c.colinds.copy_(c.colinds.flip(0))
            again = cuda_k._spmv_edges(c, transpose)
            assert again is not first and torch.equal(again, first)
            # 5,000 entries of the long row moved to the next: the edges follow
            c.rowptrs[8] -= 5000
            moved = cuda_k._spmv_edges(c, transpose)
            assert torch.equal(moved, spmv.csr_shares(rp_of(), a.nnz)[0])
            if not transpose:
                assert not torch.equal(moved, first)


def test_empty_matrix():
    z = sps.csr_matrix((40, 30), dtype=np.float32)
    c = _port(z, torch.int32)
    assert torch.equal(spmv.spmv_csr_reference(c.rowptrs, c.colinds, c.values,
                                               torch.ones(30)), torch.zeros(40))
    assert torch.equal(spmv.spmv_csr(c.rowptrs, c.colinds, None, torch.ones(30)),
                       torch.zeros(40))
    with kernels.use_kernel("cuda"):
        assert torch.equal(c.mult_vec(np.ones(30, np.float32)), torch.zeros(40))
        assert torch.equal(c.mult_vec_t(np.ones(40, np.float32)), torch.zeros(30))


def test_inf_reaches_only_its_rows():
    """An inf in x reaches only the rows whose entries use its column;
    every other row agrees with scipy."""
    a = CASES["empty rows"]
    col = int(a.indices[a.indptr[5]])
    x = np.random.default_rng(50).uniform(-1, 1, a.shape[1]).astype(np.float32)
    x[col] = np.inf
    uses = set(np.flatnonzero(a[:, [col]].toarray()[:, 0] != 0).tolist())
    assert uses and len(uses) < a.shape[0]
    c = _port(a, torch.int64)
    with kernels.use_kernel("cuda"):
        y = c.mult_vec(x).numpy()
    ref = spmv.spmv_csr_reference(c.rowptrs, c.colinds, c.values,
                                  torch.from_numpy(x)).numpy()
    for got in (y, ref):
        assert set(np.flatnonzero(~np.isfinite(got)).tolist()) == uses
    finite = np.array(sorted(set(range(a.shape[0])) - uses))
    x0 = np.where(np.isfinite(x), x, 0).astype(np.float32)
    want = (a.astype(np.float64) @ x0)[finite]
    np.testing.assert_allclose(y[finite], want, rtol=1e-4, atol=1e-5)


def test_split_cuts_rows_at_share_edges():
    """csr_shares cuts the merge of row ends and entries into shares of at
    most ``tile`` items, edges on the merge path, and rows cut at a
    share's edge add up from their parts; the kernel's share is
    CSR_TILE."""
    a = CASES["long row"]
    c = _port(a, torch.int32)
    x = torch.from_numpy(np.random.default_rng(51).uniform(
        -1, 1, a.shape[1]).astype(np.float32))
    want = a.astype(np.float64) @ x.numpy().astype(np.float64)
    for tile in (1, 7, 64, spmv.CSR_TILE):
        rows, ents = spmv.csr_shares(c.rowptrs, a.nnz, tile)
        n = a.shape[0] + a.nnz
        assert len(rows) == -(-n // tile) + 1
        d = (rows + ents).numpy()
        assert d[0] == 0 and d[-1] == n and np.all(np.diff(d) <= tile)
        assert np.all(np.diff(rows.numpy()) >= 0) and np.all(np.diff(ents.numpy()) >= 0)
        # the merge path: every row before rows[s] ends at or before entry
        # ents[s], and row rows[s] does not end before it
        rp = a.indptr
        r, k = rows.numpy(), ents.numpy()
        assert np.all(rp[r[r > 0]] <= k[r > 0])
        inner = r < a.shape[0]
        assert np.all(rp[r[inner] + 1] >= k[inner])
        cut = (k[1:-1] > rp[r[1:-1]]) & (r[1:-1] < a.shape[0])
        if tile < 20_000:
            assert cut.any(), tile  # the long row is cut
        y = spmv.spmv_csr_reference(c.rowptrs, c.colinds, c.values, x, tile)
        assert_spmv_close(y.numpy(), want, Scipy(a), x.numpy())
    src = pathlib.Path(_cuda.CSRC, "spmv_csr.cu").read_text()
    assert int(re.search(r"kTile = (\d+);", src).group(1)) == spmv.CSR_TILE


def test_wrapper_on_cpu_runs_plain_version():
    a = CASES["hypersparse"]
    c = _port(a, torch.int32)
    x = torch.from_numpy(np.random.default_rng(52).uniform(
        -1, 1, a.shape[1]).astype(np.float32))
    before = spmv.csr_launches
    want = spmv.spmv_csr_reference(c.rowptrs, c.colinds, c.values, x)
    assert torch.equal(spmv.spmv_csr(c.rowptrs, c.colinds, c.values, x), want)
    out = torch.full((a.shape[0],), 2.0)
    assert spmv.spmv_csr(c.rowptrs, c.colinds, c.values, x, out=out) is out
    assert torch.allclose(out, want + 2.0)
    assert spmv.csr_launches == before
    assert "spmv_csr" not in _cuda._LIBS, "a CPU call built the CUDA kernel"


def test_wrapper_rejects_bad_operands():
    a = CASES["hypersparse"]
    c = _port(a, torch.int32)
    rp, ci, v = c.rowptrs, c.colinds, c.values
    x = torch.zeros(a.shape[1])
    for bad in ((rp.to(torch.int16), ci, v, x), (rp, ci.long(), v, x),
                (rp, ci, v.double(), x), (rp, ci, v[:-1], x),
                (rp, ci, v, x[None])):
        with pytest.raises(ValueError):
            spmv.spmv_csr(*bad)
    with pytest.raises(ValueError):
        spmv.spmv_csr(rp, ci, v, x, out=torch.zeros(3))
    meta = [t.to("meta") for t in (rp, ci, v, x)]
    with pytest.raises(ValueError):
        spmv.spmv_csr(*meta)


def _microrows(c, transpose):
    return round(cuda_k._layout_bytes_per_entry(c, transpose) * c.nnz
                 / cuda_k._MICROROW_BYTES)


@settings(max_examples=25, deadline=None)
@given(nrows=st.integers(1, 700), ncols=st.integers(1, 3000),
       density=st.floats(0.0005, 0.2), seed=st.integers(0, 2**31 - 1))
def test_route_statistic_matches_the_planner(nrows, ncols, density, seed):
    """The route's micro-row count, made with torch ops on the matrix's
    device, equals the host planner's at (256, 1), both ways."""
    a = sps.random(nrows, ncols, density, format="csr", dtype=np.float32,
                   random_state=np.random.default_rng(seed))
    if a.nnz == 0:
        return
    c = _port(a, torch.int32)
    at = a.T.tocsr()
    assert _microrows(c, False) == mb.estimate_microrows(a.indptr, a.indices, 256)
    assert _microrows(c, True) == mb.estimate_microrows(at.indptr, at.indices, 256)


def test_route_statistic_past_the_packing_range(monkeypatch):
    """Past the window budget the statistic counts spmv_large's chunk and
    panel layouts together."""
    monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", 3)
    a = power_law(1000, 2000, np.full(1000, 9), 4)
    c = _port(a, torch.int32)
    for t, b in ((False, a), (True, a.T.tocsr())):
        chunks = spmv.build_large_layouts(b.shape[0], b.shape[1], b.indptr,
                                          b.indices, b.data, max_windows=3)
        assert sum(len(p) for _, p in chunks) > len(chunks) > 1
        assert _microrows(c, t) == sum(lay.n_microrows for _, p in chunks
                                       for _, lay in p)


def flagship_like():
    """327 uniform entries a row, as the flagship has, at 4096^2."""
    rng = np.random.default_rng(53)
    rp = np.arange(4097, dtype=np.int64) * 327
    cols = rng.integers(0, 4096, 4096 * 327).astype(np.int32)
    return sps.csr_matrix((rng.standard_normal(len(cols)).astype(np.float32),
                           cols, rp), shape=(4096, 4096))


def test_route_picks_by_the_measured_crossover():
    """``_spmv_route`` follows ``_CSR_CROSSOVER`` (layout bytes a stored
    entry, measured on the H100 by chip_smoke phase 21): the CSR form for
    a hypersparse matrix (hundreds of bytes an entry), the micro-block
    kernel for a flagship-like one (about 7)."""
    hyper = _port(CASES["hypersparse"], torch.int32)
    flag = _port(flagship_like(), torch.int32)
    assert cuda_k._layout_bytes_per_entry(hyper, False) > 100
    assert cuda_k._layout_bytes_per_entry(flag, False) < cuda_k._CSR_CROSSOVER
    assert cuda_k._spmv_route(hyper, False) == "csr"
    assert cuda_k._spmv_route(flag, False) == "microblock"
    assert cuda_k._spmv_route(flag, True) == "microblock"


def test_transpose_form_cached():
    """mult_vec_t on the CSR route builds the transpose once (a
    ``layout-build-csr`` event), cached on the matrix; mult_vec reads the
    matrix's own tensors and caches nothing; release_handle(drop_cache)
    drops it."""
    a = CASES["hypersparse"]
    c = _port(a, torch.int32)
    events = []
    kernels._listeners.append(lambda e, f: events.append((e, f)))
    try:
        with kernels.use_kernel("cuda"):
            for _ in range(2):
                c.mult_vec(np.ones(a.shape[1], np.float32))
            assert kept(c, "csr_t") is None
            for _ in range(2):
                c.mult_vec_t(np.ones(a.shape[0], np.float32))
    finally:
        kernels._listeners.pop()
    builds = [f for e, f in events if e.startswith("layout-build")]
    assert len(builds) == 1 and builds[0]["transpose"] is True
    assert builds[0]["nnz"] == a.nnz
    assert builds[0]["bytes"] == 4 * (a.shape[1] + 1) + 8 * a.nnz
    rp, ci, v = cuda_k._cached_csr_t(c)
    at = a.T.tocsr()
    assert np.array_equal(rp.numpy(), at.indptr) and np.array_equal(ci.numpy(), at.indices)
    h = cuda_k.to_handle(c)
    cuda_k.release_handle(h, drop_cache=True)
    assert kept(c, "csr_t") is None and kept(c) == {}


def test_vmap_on_the_csr_route_is_one_spmm_csr(monkeypatch):
    """Under torch.func.vmap a CSR-routed matrix runs one CSR-form SpMM a
    batch (``spmm_csr`` on ``X^T``, the transpose's cached CSR tensors for
    ``mult_vec_t``, each direction's cached SpMM share edges), and no SpMV
    launch; no micro-block layout is built."""
    from csr_tpu_torch.ops import spmm as spmm_op

    calls, edges = [], []
    for mod, name in ((spmm_op, "spmm"), (spmm_op, "spmm_csr"), (spmv, "spmv"),
                      (spmv, "spmv_csr")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or edges.append(k.get("edges"))
                            or _f(*a, **k))
    a = CASES["hypersparse"]
    c = _port(a, torch.int32)
    rng = np.random.default_rng(54)
    X = torch.from_numpy(rng.uniform(-1, 1, (3, a.shape[1])).astype(np.float32))
    Xt = torch.from_numpy(rng.uniform(-1, 1, (3, a.shape[0])).astype(np.float32))
    with kernels.use_kernel("cuda"):
        Y = torch.func.vmap(lambda v: c.mult_vec(v))(X)
        Yt = torch.func.vmap(lambda v: c.mult_vec_t(v))(Xt)
    assert calls == ["spmm_csr", "spmm_csr"]
    assert edges[0] is cuda_k._spmm_edges(c, False)
    assert edges[1] is cuda_k._spmm_edges(c, True)
    assert torch.equal(edges[1], spmv.csr_shares(cuda_k._cached_csr_t(c)[0], a.nnz,
                                                 spmm_op.CSR_TILE)[0])
    for form in ("layout", "layout_t", "large", "large_t"):
        assert kept(c, form) is None, form
    at = a.T.tocsr()
    for k in range(3):
        assert_spmv_close(Y[k].numpy(), a.astype(np.float64) @ X[k].numpy(),
                          Scipy(a), X[k].numpy())
        assert_spmv_close(Yt[k].numpy(), at.astype(np.float64) @ Xt[k].numpy(),
                          Scipy(at), Xt[k].numpy())
