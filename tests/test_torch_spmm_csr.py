"""The CSR-form SpMM (``ops/spmm.py:spmm_csr``, kernel
``csrc/spmm_csr.cu``), its route in ``kernels/cuda.py``, and the two
repaired faults of the ``cuda`` backend (caches that outlived an in-place
edit; the route statistic's memory), on the CPU: ``spmm_csr_reference``
(the kernel's split into shares of merge items, a part a row and share,
and the carries) and the routed ``CSR.mult_dense`` / ``multiply`` against
``csr_tpu``'s products under ``pallas`` (interpret mode, as the JAX
package's tests run it) and scipy, within ``tests/test_mult_dense.py``'s
bound (rtol 5e-4, atol 1e-4 times the largest |result|,
``torch_util.assert_product_close``) and ``util.assert_spmv_close``, both
unchanged."""

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
from csr_tpu_torch.kernels import cuda as cuda_k, torch as torch_k
from csr_tpu_torch.ops import _cuda, microblock as mb, spmm, spmv

from torch_util import Scipy, assert_product_close, kept, power_law
from util import assert_spmv_close

SHAPE = (256, 1 << 16)
#: every lanes-a-row (4, 8, 16, 32) and load width (1, 2, 4 floats) of the
#: kernel's plan, on both sides of each change
WIDTHS = (1, 2, 3, 4, 8, 16, 17, 32, 33, 50, 64, 65, 128, 129, 256)


def _cases():
    nrows, ncols = SHAPE
    long_row = np.full(nrows, 3)
    long_row[7] = 5_000  # about five shares of 1024 merge items
    return {"hypersparse": power_law(nrows, ncols, np.full(nrows, 12), 21),
            "thin rows": power_law(nrows, ncols, np.full(nrows, 2), 22),
            "empty rows": power_law(nrows, ncols,
                                    np.where(np.arange(nrows) % 5 == 0, 9, 0), 23),
            "long row": power_law(nrows, ncols, long_row, 24)}


CASES = _cases()


def _structure(a):
    return sps.csr_matrix((np.ones(a.nnz, np.float32), a.indices, a.indptr),
                          shape=a.shape)


def _port(a, ptr_dtype=torch.int32, structure_only=False):
    """The port's CSR of scipy ``a`` on the CPU, row pointers of
    ``ptr_dtype`` (tensors, kept as given)."""
    return CSR(a.shape[0], a.shape[1], a.nnz,
               torch.from_numpy(a.indptr.astype(np.int64)).to(ptr_dtype),
               torch.from_numpy(a.indices.astype(np.int32)),
               None if structure_only else torch.from_numpy(a.data.astype(np.float32)),
               _cast=False)


def _operand(a, n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (a.shape[1], n)).astype(np.float32)


@pytest.fixture(scope="module")
def pallas_results():
    """csr_tpu's mult_dense of every case (and of the hypersparse one
    structure-only) under pallas (interpret mode), at every width, with
    the seeded operands."""
    out = {}
    for i, (name, a) in enumerate(CASES.items()):
        for so in (False, True) if name == "hypersparse" else (False,):
            ref = csr_tpu.CSR(a.shape[0], a.shape[1], a.nnz, a.indptr, a.indices,
                              None if so else a.data)
            for n in WIDTHS:
                b = _operand(a, n, 60 + i)
                with ref_kernels.use_kernel("pallas"):
                    out[name, so, n] = b, np.asarray(ref.mult_dense(b))
    return out


@pytest.fixture
def routes():
    """The routes the cuda kernel reports, as (event, route) pairs."""
    seen = []
    kernels._listeners.append(
        lambda e, f: seen.append((e, f["route"])) if "route" in f else None)
    yield seen
    kernels._listeners.pop()


@pytest.mark.parametrize("ptr_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas(case, n, ptr_dtype, pallas_results):
    """The plain version, at the kernel's share and at one of 7 items
    (every row cut), against csr_tpu and scipy."""
    a = CASES[case]
    b, want = pallas_results[case, False, n]
    c = _port(a, ptr_dtype)
    empty = np.diff(a.indptr) == 0
    for tile in (spmm.CSR_TILE, 7):
        got = spmm.spmm_csr_reference(c.rowptrs, c.colinds, c.values,
                                      torch.from_numpy(b), tile)
        assert got.dtype == torch.float32 and got.shape == (a.shape[0], n)
        assert_product_close(got.numpy(), want)
        assert_product_close(got.numpy(), a.astype(np.float64) @ b)
        assert np.all(got.numpy()[empty] == 0)


@pytest.mark.parametrize("n", WIDTHS)
def test_plan_lanes_and_load_width(n):
    """csr_plan: the fewest of 4, 8, 16, 32 lanes whose 4 columns a lane
    cover n (32 past 128 columns, in passes); 16 B loads where n and B's
    row stride are multiples of 4 on a 16 B boundary, 8 B where they are
    even on 8 B (n = 50: 200 B rows), else 4 B; an unaligned B at n = 50
    takes 4 B loads."""
    width, lanes = spmm.csr_plan(n, n, 256)
    assert lanes == next((k for k in (4, 8, 16, 32) if 4 * k >= n), 32)
    assert width == (4 if n % 4 == 0 else 2 if n % 2 == 0 else 1)
    assert spmm.csr_plan(n, n + 1, 256)[0] == (2 if (n + 1) % 2 == 0 and n % 2 == 0 else 1)
    assert spmm.csr_plan(n, n, 4) == (1, lanes)
    if n == 50:
        assert spmm.csr_plan(50, 50, 8) == (2, 16)  # 200 B rows, 8 B aligned
        assert spmm.csr_plan(50, 52, 16) == (2, 16)
    # the lanes a row the kernel's entry takes
    src = pathlib.Path(_cuda.CSRC, "spmm_csr.cu").read_text()
    assert all(f"lanes == {k}" in src for k in spmm.CSR_LANES)


def test_share_edges_cached():
    """mult_dense on the CSR-form route hands the kernel's wrapper the rows
    at its share edges (csr_shares at SpMM's share, not SpMV's), cached on
    the matrix and built again after an in-place edit."""
    a = CASES["long row"]
    c = _port(a)
    seen = []
    real = spmm.spmm_csr
    b = torch.from_numpy(_operand(a, 3, 78))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spmm, "spmm_csr", lambda *args, **kw: seen.append(kw["edges"])
                   or real(*args, **kw))
        with kernels.use_kernel("cuda"):
            for _ in range(2):
                c.mult_dense(b)
            first = cuda_k._spmm_edges(c)
            assert seen == [first, first]
            assert torch.equal(first, spmv.csr_shares(c.rowptrs, a.nnz, spmm.CSR_TILE)[0])
            assert not torch.equal(first[:5], cuda_k._spmv_edges(c, False)[:5])
            c.values.mul_(2)
            assert cuda_k._spmm_edges(c) is not first


@pytest.mark.parametrize("case,structure_only",
                         [(c, False) for c in sorted(CASES)] + [("hypersparse", True)])
def test_routed_mult_dense_matches_pallas(case, structure_only, pallas_results,
                                          routes):
    """CSR.mult_dense on the cuda backend takes the CSR-form route at
    every width (mostly padding in the micro-block layout) and builds no
    layout."""
    a = CASES[case]
    c = _port(a, torch.int64, structure_only)
    with kernels.use_kernel("cuda"):
        got = {n: c.mult_dense(pallas_results[case, structure_only, n][0])
               for n in WIDTHS}
    assert routes == [("mult_dense", "csr")] * len(WIDTHS)
    ref = _structure(a) if structure_only else a
    for n, d in got.items():
        b, want = pallas_results[case, structure_only, n]
        assert d.dtype == torch.float32 and d.shape == (a.shape[0], n)
        assert_product_close(d.numpy(), want)
        assert_product_close(d.numpy(), ref.astype(np.float64) @ b)
    for form in ("layout", "large"):
        assert kept(c, form) is None, form


def flagship_like():
    """327 uniform entries a row, as the flagship has, at 4096^2."""
    rng = np.random.default_rng(53)
    rp = np.arange(4097, dtype=np.int64) * 327
    cols = rng.integers(0, 4096, 4096 * 327).astype(np.int32)
    return sps.csr_matrix((rng.standard_normal(len(cols)).astype(np.float32),
                           cols, rp), shape=(4096, 4096))


def test_route_picks_spmm_csr(monkeypatch):
    """``_spmm_route`` follows ``_spmm_crossover`` (layout bytes a stored
    entry): the CSR form for a hypersparse matrix, the micro-block kernel
    for a flagship-like one; past a monkeypatched MAX_RB (the packer's row
    windows) the hypersparse one still takes the CSR form, whose route
    packs nothing."""
    hyper = _port(CASES["hypersparse"])
    flag = _port(flagship_like())
    for n in (1, 50, 256, 8192):
        assert cuda_k._spmm_route(hyper, n) == "csr"
        assert cuda_k._spmm_route(flag, n) == "kernel"
    monkeypatch.setattr(mb, "MAX_RB", 1)
    assert cuda_k._needs_large(*SHAPE)
    fresh = _port(CASES["hypersparse"])
    assert cuda_k._spmm_route(fresh, 50) == "csr"
    b = _operand(CASES["hypersparse"], 50, 70)
    with kernels.use_kernel("cuda"):
        d = fresh.mult_dense(b)
    assert_product_close(d.numpy(), CASES["hypersparse"].astype(np.float64) @ b)
    assert kept(fresh, "large") is None


def test_large_route_is_spmm_a_panel(monkeypatch, routes):
    """Past the window budget a matrix that is not CSR-routed runs the
    micro-block SpMM once a (chunk, panel) layout (``spmm_large``), not
    the torch backend."""
    monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", 3)
    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, float("inf")),))
    a = flagship_like()[:1000]
    c = _port(a)
    calls = []
    real = spmm.spmm
    monkeypatch.setattr(spmm, "spmm", lambda lay, b: calls.append(lay) or real(lay, b))
    b = _operand(a, 3, 71)
    with kernels.use_kernel("cuda"):
        d = c.mult_dense(b)
    assert routes == [("mult_dense", "kernel")]
    panels = sum(len(p) for _, p in cuda_k._cached_large(c, False))
    assert len(calls) == panels > 1
    assert_product_close(d.numpy(), a.astype(np.float64) @ b)


def test_f32_spmm_runs_no_scatter_rows(monkeypatch, routes):
    """f32 SpMM and SpGEMM's dense leg on the cuda backend never reach the
    torch backend's product: ``scatter_rows`` runs only inside the
    CSR-form kernel's plain version (which the wrapper takes for CPU
    tensors alone), on each route."""
    callers = []
    real = spmm.scatter_rows

    def scatter(*args):
        import sys

        callers.append(sys._getframe(1).f_code.co_name)
        return real(*args)

    monkeypatch.setattr(spmm, "scatter_rows", scatter)
    monkeypatch.setattr(torch_k, "mult_dense", None)
    monkeypatch.setattr(torch_k, "_spgemm_dense", None)
    a = CASES["hypersparse"][:, :4096]
    m = sps.random(4096, 30, 0.05, format="csr", dtype=np.float32,
                   random_state=np.random.default_rng(72))
    b = _operand(a, 5, 72)
    inf = float("inf")
    # (SpMM's crossover, the densify crossover, the window budget): the
    # CSR form, the micro-block kernel, its chunks and panels, dense
    settings = [(((1, 0.0),), ((1, 2.0),), None), (((1, inf),), ((1, 2.0),), None),
                (((1, inf),), ((1, 2.0),), 1), (((1, inf),), ((1, 0.0),), None)]
    with kernels.use_kernel("cuda"):
        for spmm_x, dense_x, windows in settings:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", spmm_x)
                mp.setattr(cuda_k, "_DENSIFY_CROSSOVER", dense_x)
                if windows:
                    mp.setattr(cuda_k, "_LARGE_WINDOWS", windows)
                c = _port(a)
                assert_product_close(c.mult_dense(b).numpy(), a.astype(np.float64) @ b)
                p = c.multiply(_port(m))
                assert_product_close(p.to_scipy().toarray(), (a.astype(np.float64) @ m).toarray())
    assert [r for _, r in routes] == ["csr", "csr", "kernel", "kernel", "kernel",
                                      "kernel", "dense", "dense"]
    assert set(callers) == {"spmm_csr_reference"}


def test_spgemm_dense_leg_hypersparse_matches_csr_tpu(routes):
    """``multiply`` of a hypersparse A densifies B and runs its sparse leg
    on the CSR-form route; the product agrees with csr_tpu's under
    pallas."""
    a = CASES["hypersparse"]
    m = sps.random(a.shape[1], 40, 2e-3, format="csr", dtype=np.float32,
                   random_state=np.random.default_rng(73))
    mt = sps.random(40, a.shape[1], 2e-3, format="csr", dtype=np.float32,
                    random_state=np.random.default_rng(74))
    ref = csr_tpu.CSR.from_scipy(a)
    with ref_kernels.use_kernel("pallas"):
        want = ref.multiply(csr_tpu.CSR.from_scipy(m)).to_scipy().toarray()
        want_t = ref.multiply(csr_tpu.CSR.from_scipy(mt),
                              transpose=True).to_scipy().toarray()
    c = _port(a)
    with kernels.use_kernel("cuda"):
        got = c.multiply(_port(m)).to_scipy().toarray()
        got_t = c.multiply(_port(mt), transpose=True).to_scipy().toarray()
    assert routes == [("spgemm", "csr")] * 2
    for g, w, e in ((got, want, a @ m), (got_t, want_t, a @ mt.T)):
        assert_product_close(g, w)
        assert_product_close(g, e.astype(np.float64).toarray())


def test_split_cuts_rows_at_share_edges():
    """The plain version is the same product at any share: rows cut at
    many share edges (tiles of 1, 7 and 64 items) add up from their
    parts; the kernel's share is CSR_TILE, its kWarps * kWarpItems."""
    a = CASES["long row"]
    c = _port(a)
    b = torch.from_numpy(_operand(a, 3, 75))
    want = a.astype(np.float64) @ b.numpy()
    for tile in (1, 7, 64, spmm.CSR_TILE):
        part, rows = spmv.csr_parts(c.rowptrs, a.nnz, tile)
        assert int(part[-1]) + 1 == len(rows)
        assert len(rows) > len(np.unique(rows.numpy())) or tile >= a.nnz
        got = spmm.spmm_csr_reference(c.rowptrs, c.colinds, c.values, b, tile)
        assert_product_close(got.numpy(), want)
    src = pathlib.Path(_cuda.CSRC, "spmm_csr.cu").read_text()
    warps = int(re.search(r"kWarps = (\d+);", src).group(1))
    items = int(re.search(r"kWarpItems = (\d+);", src).group(1))
    assert warps * items == spmm.CSR_TILE


def test_inf_in_b_reaches_only_its_rows():
    """An inf in B reaches only the rows whose entries gather its row, in
    its column; every other entry agrees with scipy."""
    a = CASES["empty rows"]
    col = int(a.indices[a.indptr[5]])
    b = _operand(a, 3, 76)
    b[col, 1] = np.inf
    uses = set(np.flatnonzero(a[:, [col]].toarray()[:, 0] != 0).tolist())
    assert uses and len(uses) < a.shape[0]
    c = _port(a)
    got = spmm.spmm_csr_reference(c.rowptrs, c.colinds, c.values,
                                  torch.from_numpy(b), 7).numpy()
    rows, cols = np.nonzero(~np.isfinite(got))
    assert set(rows.tolist()) == uses and set(cols.tolist()) == {1}
    b0 = np.where(np.isfinite(b), b, 0).astype(np.float32)
    want = a.astype(np.float64) @ b0
    keep = np.isfinite(got)
    np.testing.assert_allclose(got[keep], want[keep], rtol=5e-4, atol=1e-4)


def test_wrapper_on_cpu_runs_plain_version():
    a = CASES["hypersparse"]
    c = _port(a)
    b = torch.from_numpy(_operand(a, 3, 77))
    before = spmm.csr_launches
    want = spmm.spmm_csr_reference(c.rowptrs, c.colinds, c.values, b)
    assert torch.equal(spmm.spmm_csr(c.rowptrs, c.colinds, c.values, b), want)
    assert torch.equal(spmm.spmm_csr(c.rowptrs, c.colinds, c.values, b.double()),
                       want)
    assert spmm.csr_launches == before
    assert "spmm_csr" not in _cuda._LIBS, "a CPU call built the CUDA kernel"


def test_wrapper_rejects_bad_operands():
    a = CASES["hypersparse"]
    c = _port(a)
    rp, ci, v = c.rowptrs, c.colinds, c.values
    b = torch.zeros(a.shape[1], 2)
    for bad in ((rp.to(torch.int16), ci, v, b), (rp, ci.long(), v, b),
                (rp, ci, v.double(), b), (rp, ci, v[:-1], b),
                (rp, ci, v, b[:, 0]), (rp, ci, v, b[None])):
        with pytest.raises(ValueError):
            spmm.spmm_csr(*bad)
    with pytest.raises(ValueError):
        spmm.spmm_csr(*[t.to("meta") for t in (rp, ci, v, b)])


# -- fault A: in-place edits of a matrix's tensors ---------------------------

EDIT = power_law(300, 4096, np.random.default_rng(80).integers(0, 12, 300), 80)


@pytest.fixture(scope="module")
def edited_reference():
    """csr_tpu's three products of EDIT with its values doubled (built
    from the new values), under pallas, and their operands."""
    rng = np.random.default_rng(81)
    x = rng.uniform(-1, 1, EDIT.shape[1]).astype(np.float32)
    xt = rng.uniform(-1, 1, EDIT.shape[0]).astype(np.float32)
    b = rng.uniform(-1, 1, (EDIT.shape[1], 6)).astype(np.float32)
    a2 = EDIT * np.float32(2)
    ref = csr_tpu.CSR.from_scipy(a2)
    with ref_kernels.use_kernel("pallas"):
        return (x, xt, b, a2, np.asarray(ref.mult_vec(x)),
                np.asarray(ref.mult_vec_t(xt)), np.asarray(ref.mult_dense(b)))


INF = float("inf")
#: route: (_CSR_CROSSOVER and _CSR_CROSSOVER_LARGE, _SPMM_CSR_CROSSOVER,
#: _LARGE_WINDOWS or None, _DENSIFY_CROSSOVER)
EDIT_ROUTES = {
    "microblock": (INF, ((1, INF),), None, ((1, 2.0),)),
    "csr": (0.0, ((1, 0.0),), None, ((1, 2.0),)),
    "large": (INF, ((1, INF),), 1, ((1, 2.0),)),
    "dense": (INF, ((1, INF),), None, ((1, 0.0),)),
}


@pytest.mark.parametrize("route", sorted(EDIT_ROUTES))
def test_inplace_edit_is_seen_on_every_route(route, edited_reference,
                                             monkeypatch):
    """After ``values.mul_(2)`` the cuda backend's mult_vec, mult_vec_t
    and mult_dense, whose forms were cached by a first call on each
    route, agree with csr_tpu built from the new values."""
    x, xt, b, a2, want, want_t, want_d = edited_reference
    spmv_x, spmm_x, windows, dense_x = EDIT_ROUTES[route]
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", spmv_x)
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER_LARGE", spmv_x)
    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", spmm_x)
    monkeypatch.setattr(cuda_k, "_DENSIFY_CROSSOVER", dense_x)
    if windows:
        monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", windows)
    c = CSR.from_scipy(EDIT, device="cpu")
    with kernels.use_kernel("cuda"):
        h = cuda_k.to_handle(c)
        before = (cuda_k.mult_vec(h, torch.from_numpy(x)),
                  cuda_k.mult_vec_t(h, torch.from_numpy(xt)),
                  cuda_k.mult_dense(h, torch.from_numpy(b)))
        c.values.mul_(2)
        got = (cuda_k.mult_vec(h, torch.from_numpy(x)),
               cuda_k.mult_vec_t(h, torch.from_numpy(xt)),
               cuda_k.mult_dense(h, torch.from_numpy(b)))
        # a fresh handle and the CSR method agree too
        again = c.mult_vec(x)
    assert not torch.allclose(before[0], got[0])
    at = a2.T.tocsr()
    assert_spmv_close(got[0].numpy(), want, Scipy(a2), x)
    assert_spmv_close(again.numpy(), want, Scipy(a2), x)
    assert_spmv_close(got[1].numpy(), want_t, Scipy(at), xt)
    assert_product_close(got[2].numpy(), want_d)
    assert_product_close(got[2].numpy(), a2.astype(np.float64) @ b)


def test_cpu_matrix_copies_the_callers_arrays():
    """A CPU matrix made of numpy arrays holds copies of them (as the JAX
    package copies to its device): an in-place edit of its tensors leaves
    the caller's arrays as they were, and its kept host copies are
    dropped once the edit moves a tensor's version."""
    m = EDIT.copy()
    data = m.data.copy()
    c = CSR.from_scipy(m, device="cpu")
    d = CSR(m.shape[0], m.shape[1], m.nnz, m.indptr, m.indices.astype(np.int64),
            m.data, device="cpu")
    for csr in (c, d):
        assert kept(csr, "host") is not None
        csr.values.mul_(3)
        assert np.array_equal(m.data, data)
    d.colinds.copy_(d.colinds.flip(0))  # an int32 tensor of int64 host arrays
    assert kept(d, "host") is None
    assert np.array_equal(d.host_arrays()[1], m.indices[::-1])
    assert np.allclose(c.to_scipy().data, 3 * data)


def test_shards_and_statistic_follow_an_edit(monkeypatch):
    """The row-shard list and the route statistic are keyed on the tensors'
    versions as well: after an in-place edit the sharded product and the
    route use the new tensors."""
    monkeypatch.setattr(cuda_k, "max_nnz", 400)
    a = EDIT
    c = CSR.from_scipy(a, device="cpu")
    x = np.random.default_rng(82).uniform(-1, 1, a.shape[1]).astype(np.float32)
    with kernels.use_kernel("cuda"):
        c.mult_vec(x)
        shards = kept(c, ("shards", 400))
        cuda_k._layout_bytes_per_entry(c, False)
        c.values.mul_(-1)
        y = c.mult_vec(x)
    assert kept(c, ("shards", 400)) is not shards and len(shards) > 1
    assert_spmv_close(y.numpy(), -(a.astype(np.float64) @ x), Scipy(a), x)
    stat = ("stat", False, cuda_k._LARGE_WINDOWS)
    cuda_k._layout_bytes_per_entry(c, False)
    assert kept(c, stat) is not None
    c.colinds.copy_(c.colinds // 256)  # every entry in the first window
    assert kept(c, stat) is None
    cuda_k._layout_bytes_per_entry(c, False)
    assert kept(c, stat) == _microrows(c, False)
    assert _microrows(c, False) == mb.estimate_microrows(
        a.indptr, a.indices // 256, 256, a.shape[1])


# -- fault B: the route statistic by chunks ----------------------------------

def _microrows(c, transpose):
    return round(cuda_k._layout_bytes_per_entry(c, transpose) * c.nnz
                 / cuda_k._MICROROW_BYTES)


@settings(max_examples=25, deadline=None)
@given(nrows=st.integers(1, 700), ncols=st.integers(1, 3000),
       density=st.floats(0.0005, 0.2), chunk=st.sampled_from([1, 5, 64, 999]),
       seed=st.integers(0, 2**31 - 1))
def test_statistic_by_chunks_matches_the_planner(nrows, ncols, density, chunk,
                                                 seed):
    """With chunks small enough that a matrix spans many, the route's
    micro-row count still equals the host planner's at (256, 1), both
    ways."""
    a = sps.random(nrows, ncols, density, format="csr", dtype=np.float32,
                   random_state=np.random.default_rng(seed))
    if a.nnz == 0:
        return
    at = a.T.tocsr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_k, "_STAT_CHUNK", chunk)
        c = _port(a)
        assert _microrows(c, False) == mb.estimate_microrows(a.indptr, a.indices, 256)
        assert _microrows(c, True) == mb.estimate_microrows(at.indptr, at.indices, 256)


@pytest.mark.parametrize("chunk", [1, 37, 1 << 23])
def test_statistic_by_chunks_past_the_packing_range(chunk, monkeypatch):
    """Past the window budget (``_LARGE_WINDOWS``, the packer's MAX_RB by
    default, here 3: panels of 384, not a multiple of 256) the chunks'
    edges lie on the transpose's panel-local windows, so the statistic
    still counts spmv_large's chunk and panel layouts, the transpose's
    too."""
    monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", 3)
    monkeypatch.setattr(cuda_k, "_STAT_CHUNK", chunk)
    a = power_law(1000, 2000, np.full(1000, 9), 4)
    c = _port(a)
    for t, b in ((False, a), (True, a.T.tocsr())):
        assert cuda_k._needs_large(*b.shape)
        chunks = spmv.build_large_layouts(b.shape[0], b.shape[1], b.indptr,
                                          b.indices, b.data, max_windows=3)
        assert _microrows(c, t) == sum(lay.n_microrows for _, p in chunks
                                       for _, lay in p)


def test_statistic_chunks_are_bounded(monkeypatch):
    """Every chunk of the statistic holds at most ``_STAT_CHUNK`` entries
    plus one 256-row window's, and its edges are panel starts or lie on
    256-row windows counted from one."""
    monkeypatch.setattr(cuda_k, "_STAT_CHUNK", 100)
    a = power_law(3000, 500, np.random.default_rng(83).integers(0, 20, 3000), 83)
    rp = torch.from_numpy(a.indptr.astype(np.int32))
    for period in (384, 3000):
        edges = cuda_k._stat_edges(rp, period)
        assert edges[0] == 0 and edges[-1] == 3000 and edges == sorted(set(edges))
        assert all(e % period % 256 == 0 or e == 3000 for e in edges)
        window = max(int(a.indptr[min(r + 256, 3000)] - a.indptr[r])
                     for r in range(0, 3000, 128))
        assert max(np.diff(a.indptr[edges])) <= 100 + window
        assert len(edges) > a.nnz // (100 + window)


@pytest.mark.parametrize("large", [False, True])
def test_statistic_splits_a_heavy_window(large, monkeypatch):
    """A 256-row window of more than ``_STAT_CHUNK`` entries (a block of
    dense rows; for the transpose, popular columns) is a chunk of its own,
    counted by slices of at most ``_STAT_CHUNK`` entries, and the
    statistic still equals the planner's count both ways (past a
    monkeypatched window budget, spmv_large's chunk and panel layouts)."""
    monkeypatch.setattr(cuda_k, "_STAT_CHUNK", 700)
    if large:
        monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", 3)
    a = power_law(900, 1500, np.random.default_rng(84).integers(0, 6, 900), 84).tolil()
    a[300:420, :] = 1.0  # 180,000 entries in two windows
    a[:, 7] = 2.0  # a popular column
    a = a.tocsr()
    c = _port(a)
    sizes = []
    bincount = torch.bincount
    monkeypatch.setattr(torch, "bincount",
                        lambda x, **kw: sizes.append(x.numel()) or bincount(x, **kw))
    for t, b in ((False, a), (True, a.T.tocsr())):
        if large:
            chunks = spmv.build_large_layouts(b.shape[0], b.shape[1], b.indptr,
                                              b.indices, b.data, max_windows=3)
            want = sum(lay.n_microrows for _, p in chunks for _, lay in p)
        else:
            want = mb.estimate_microrows(b.indptr, b.indices, 256)
        assert _microrows(c, t) == want
    assert sizes and max(sizes) <= 700
    # rows 300-420 lie in the windows [256, 512), or past the budget in
    # [256, 384) and [384, 640) (panels of 384 rows): chunks of their own
    period = 384 if large else 900
    edges = cuda_k._stat_edges(torch.from_numpy(a.indptr.astype(np.int32)), period)
    assert {256, 384, 640} <= set(edges) if large else {256, 512} <= set(edges)


# --- column panels: a B past a slab of L2, rows in column order ---


def _panel_case(case):
    """Rows in column order (repeats kept): ``long row``, 600 x 9000 with
    one full row (over eight shares of merge items, several in every
    panel), 40 empty rows and a block of 30 rows over the first 300
    columns; ``half empty``, 500 x 4000 with every column in the first
    half (the last panels hold no entry)."""
    rng = np.random.default_rng(130)
    if case == "long row":
        lengths = rng.integers(0, 60, 600)
        lengths[100:140] = 0
        a = power_law(600, 9000, lengths, 131).tolil()
        a[17, :] = rng.standard_normal(9000).astype(np.float32)
        a[400:430, :300] = rng.standard_normal((30, 300)).astype(np.float32)
        a = a.tocsr()
    else:
        a = power_law(500, 2000, rng.integers(0, 40, 500), 132)
        a = sps.csr_matrix((a.data, a.indices, a.indptr), shape=(500, 4000))
    a.sort_indices()
    return a


#: the L2 the CPU tests give the rule (an H100's); off a card it sees none
_L2 = 50 << 20


def _force_panels(monkeypatch, ncols, n, k, l2=_L2):
    """Give the rule ``l2`` bytes of L2 on the CPU and set its slab so
    that a B of ``ncols x n`` f32 takes ``k`` panels, whatever the rows'
    length."""
    monkeypatch.setattr(cuda_k, "_l2_bytes", lambda dev: l2)
    monkeypatch.setattr(cuda_k, "_PANEL_L2_SHARE", (ncols * n * 4 // k + 1.5) / l2)
    monkeypatch.setattr(cuda_k, "_PANEL_MIN_ENTRIES", 0.0)


@pytest.mark.parametrize("k", [2, 3, 7])
@pytest.mark.parametrize("ptr_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["long row", "half empty"])
def test_split_panels_is_a_plain_per_row_split(case, ptr_dtype, k):
    """``split_panels`` against a per-row split on the host: each row's
    run in each panel starts where ``np.searchsorted`` puts the panel's
    first column in the row; the panels' row pointers, bases, entry
    counts and share edges follow, at 8 B a row a panel (and the edges)."""
    a = _panel_case(case)
    rp = torch.from_numpy(a.indptr.astype(np.int64)).to(ptr_dtype)
    ci = torch.from_numpy(a.indices.astype(np.int32))
    bounds = spmm.panel_bounds(a.shape[1], k)
    assert bounds[0] == 0 and bounds[-1] == a.shape[1] and len(bounds) == k + 1
    assert max(np.diff(bounds)) - min(np.diff(bounds)) <= 1
    panels = spmm.split_panels(rp, ci, bounds)
    starts = np.array([a.indptr[r] + np.searchsorted(a.indices[a.indptr[r]:a.indptr[r + 1]],
                                                      bounds)
                       for r in range(a.shape[0])]).T  # (k + 1, nrows)
    lengths = np.diff(starts, axis=0)
    ptrs = np.zeros((k, a.shape[0] + 1), np.int64)
    np.cumsum(lengths, axis=1, out=ptrs[:, 1:])
    assert panels.count == k and panels.bounds == bounds
    assert panels.ptrs.dtype == panels.base.dtype == torch.int32
    assert np.array_equal(panels.ptrs.numpy(), ptrs)
    assert np.array_equal(panels.base.numpy(), starts[:-1] - ptrs[:, :-1])
    assert panels.nnz == tuple(int(x) for x in lengths.sum(1)) and sum(panels.nnz) == a.nnz
    want = torch.cat([spmv.csr_shares(panels.ptrs[i], panels.nnz[i], spmm.CSR_TILE)[0]
                      for i in range(k)])
    assert torch.equal(panels.edges, want)
    assert panels.nbytes - panels.edges.numel() * 8 <= 8 * (a.shape[0] + 1) * k
    if case == "half empty" and k > 2:
        assert panels.nnz[-1] == 0


def test_rows_in_order_by_chunks(monkeypatch):
    """``rows_in_order`` reads a drop of the column index as a fault only
    inside a row, in chunks as small as 3 entries, empty rows and a
    drop at a chunk's edge included."""
    monkeypatch.setattr(spmm, "_ORDER_CHUNK", 3)
    a = _panel_case("long row")
    rp = torch.from_numpy(a.indptr.astype(np.int64))
    ci = torch.from_numpy(a.indices.astype(np.int32))
    assert spmm.rows_in_order(rp, ci)
    assert spmm.rows_in_order(rp.to(torch.int32), ci)
    for r in (17, 401, a.shape[0] - 1):
        bad = ci.clone()
        k0 = int(a.indptr[r])
        bad[k0], bad[k0 + 1] = ci[k0 + 1], ci[k0]
        assert not spmm.rows_in_order(rp, bad), r


def test_panel_rule_at_the_cells_shapes():
    """The panels ``spmm_panels`` gives at the benchmark's shapes (B 50
    wide, an H100's 50 MB of L2), as numbers: both KDD-Cup'11 products run
    in panels (B 125 and 200 MB, 263 and 420 entries a row); Amazon Books
    (2.8 and 9.7 a row) and MovieLens-25M (B 11.8 and 32.5 MB, the
    micro-block route) keep one pass; nothing past 2^31 entries panels."""
    l2 = 50 << 20
    slab = int(l2 * cuda_k._PANEL_L2_SHARE)
    k_r, k_rt = -(-624_961 * 200 // slab), -(-1_000_990 * 200 // slab)
    assert cuda_k.spmm_panel_count(1_000_990, 624_961, 262_810_175, 50, l2) == k_r > 1
    assert cuda_k.spmm_panel_count(624_961, 1_000_990, 262_810_175, 50, l2) == k_rt > k_r
    assert 262_810_175 / 1_000_990 / k_r >= cuda_k._PANEL_MIN_ENTRIES
    assert 262_810_175 / 624_961 / k_rt >= cuda_k._PANEL_MIN_ENTRIES
    assert cuda_k.spmm_panel_count(8_026_324, 2_330_066, 22_507_155, 50, l2) == 1
    assert cuda_k.spmm_panel_count(2_330_066, 8_026_324, 22_507_155, 50, l2) == 1
    assert 22_507_155 / 2_330_066 / -(-8_026_324 * 200 // slab) < cuda_k._PANEL_MIN_ENTRIES
    assert cuda_k.spmm_panel_count(162_541, 59_047, 25_000_095, 50, l2) == 1
    assert cuda_k.spmm_panel_count(1 << 22, 1 << 22, 1 << 31, 50, l2) == 1
    assert cuda_k.spmm_panel_count(10, 3, 10_000, 1 << 24, l2) == 3  # a panel a column
    assert cuda_k.panels_for_slab(624_961, 50, slab) == k_r


def test_no_panels_off_a_card(monkeypatch):
    """Off a card the rule sees no L2 and keeps one pass, at KDD-Cup'11's
    shapes and at a CPU matrix whose B would take panels on a card."""
    assert cuda_k._l2_bytes(torch.device("cpu")) == 0
    assert cuda_k.spmm_panel_count(1_000_990, 624_961, 262_810_175, 50, 0) == 1
    a = _panel_case("long row")
    monkeypatch.setattr(cuda_k, "_PANEL_L2_SHARE", 1e-9)
    monkeypatch.setattr(cuda_k, "_PANEL_MIN_ENTRIES", 0.0)
    c = _port(a)
    assert cuda_k._spmm_panels(c, False, 50) is None
    assert cuda_k._spmm_panels(c, True, 50) is None
    assert [k for k in kept(c) if k[0] == "spmm_panels"] == []


@pytest.mark.parametrize("k", [2, 3, 5, 7])
@pytest.mark.parametrize("case", ["long row", "half empty"])
def test_panelled_mult_dense_matches_one_pass(case, k, monkeypatch, routes):
    """With the slab shrunk to give ``k`` panels, ``mult_dense`` on the
    CSR-form route runs in panels (built once, a ``layout-build-panels``
    event; ``csr.spmm.panels`` counts ``k`` a call, the plan's hit
    included) and matches the one-pass product and scipy; the plain
    version panel by panel is what runs on the CPU."""
    from csr_tpu_torch import tracing

    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, 0.0),))
    a = _panel_case(case)
    n = 5
    _force_panels(monkeypatch, a.shape[1], n, k)
    c = _port(a)
    b = torch.from_numpy(_operand(a, n, 133))
    rec = tracing.enable()
    try:
        with kernels.use_kernel("cuda"):
            d = c.mult_dense(b)
            again = c.mult_dense(b)
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
    panels = cuda_k._spmm_panels(c, False, n)
    assert panels.count == k
    assert counters["csr.spmm.panels"] == 2 * k and counters["plan.hit"] == 1
    assert counters["form_builds.spmm_panels"] == 1
    assert counters["event.layout-build-panels"] == 1
    assert routes == [("mult_dense", "csr")] * 2
    assert torch.equal(d, again)
    assert torch.equal(d, spmm.spmm_csr_panels_reference(c.colinds, c.values, b, panels))
    assert_product_close(d.numpy(), spmm.spmm_csr_reference(c.rowptrs, c.colinds,
                                                            c.values, b).numpy())
    assert_product_close(d.numpy(), a.astype(np.float64) @ b.numpy())


@pytest.mark.parametrize("structure_only", [False, True])
def test_panels_follow_an_edit_and_the_settings(structure_only, monkeypatch):
    """The panels are cached on the matrix by count: B of another width
    takes its own, an in-place edit of the values (or a rebinding) builds
    them again, and a plan made under other panel settings is not taken."""
    from csr_tpu_torch import tracing

    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, 0.0),))
    a = _panel_case("long row")
    if structure_only:
        a = _structure(a)
    _force_panels(monkeypatch, a.shape[1], 4, 3)
    c = _port(a, structure_only=structure_only)
    b4, b8 = (torch.from_numpy(_operand(a, n, 134 + n)) for n in (4, 8))
    rec = tracing.enable()
    try:
        with kernels.use_kernel("cuda"):
            d4, d8 = c.mult_dense(b4), c.mult_dense(b8)
            assert {cuda_k._spmm_panels(c, False, n).count for n in (4, 8)} == {3, 6}
            before = cuda_k._spmm_panels(c, False, 8)
            if not structure_only:
                c.values.mul_(2)
                assert torch.equal(c.mult_dense(b8), 2 * d8)
                assert cuda_k._spmm_panels(c, False, 8) is not before
            monkeypatch.setattr(cuda_k, "_PANEL_MIN_ENTRIES", 1e9)  # one pass again
            one = c.mult_dense(b8)
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
    assert counters["form_builds.spmm_panels"] == 2 + (not structure_only)
    assert counters["plan.miss.stale"] == 1 + (not structure_only)
    scale = 1 if structure_only else 2
    assert_product_close(one.numpy(), scale * d8.numpy())
    assert_product_close(d8.numpy(), a.astype(np.float64) @ b8.numpy())


def test_rows_out_of_order_keep_one_pass(monkeypatch, routes):
    """A matrix with a row out of column order runs in one pass whatever
    the slab: its order is checked once (``form_builds.spmm_panels``, an
    event of 1 panel) and ``csr.spmm.panels`` stays silent."""
    from csr_tpu_torch import tracing

    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, 0.0),))
    a = _panel_case("long row")
    _force_panels(monkeypatch, a.shape[1], 5, 4)
    c = _port(a)
    k0 = int(a.indptr[401])
    c.colinds[k0 : k0 + 2] = c.colinds[k0 : k0 + 2].flip(0).clone()
    c.values[k0 : k0 + 2] = c.values[k0 : k0 + 2].flip(0).clone()
    b = torch.from_numpy(_operand(a, 5, 135))
    events = []
    kernels._listeners.append(lambda e, f: events.append((e, f.get("panels"))))
    rec = tracing.enable()
    try:
        with kernels.use_kernel("cuda"):
            d = c.mult_dense(b)
            c.mult_dense(b)
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
        kernels._listeners.pop()
    assert cuda_k._spmm_panels(c, False, 5) is None
    assert "csr.spmm.panels" not in counters and counters["form_builds.spmm_panels"] == 1
    assert ("layout-build-panels", 1) in events
    assert_product_close(d.numpy(), a.astype(np.float64) @ b.numpy())


def test_vmap_on_the_csr_route_runs_in_panels(monkeypatch):
    """``torch.func.vmap`` of ``mult_vec`` and ``mult_vec_t`` on the CSR
    route follows the rule at the batch's width: one ``spmm_csr`` a batch
    with the matrix's (or its transpose's) panels, and no share edges."""
    a = _panel_case("long row")
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", 0.0)
    monkeypatch.setattr(cuda_k, "_PANEL_MIN_ENTRIES", 0.0)
    monkeypatch.setattr(cuda_k, "_l2_bytes", lambda dev: _L2)
    monkeypatch.setattr(cuda_k, "_PANEL_L2_SHARE", 4 * 4 * 200 / _L2)
    seen = []
    real = spmm.spmm_csr
    monkeypatch.setattr(spmm, "spmm_csr", lambda *x, **kw: seen.append(kw) or real(*x, **kw))
    c = _port(a)
    rng = np.random.default_rng(136)
    X = torch.from_numpy(rng.uniform(-1, 1, (4, a.shape[1])).astype(np.float32))
    Xt = torch.from_numpy(rng.uniform(-1, 1, (4, a.shape[0])).astype(np.float32))
    with kernels.use_kernel("cuda"):
        Y = torch.func.vmap(lambda v: c.mult_vec(v))(X)
        Yt = torch.func.vmap(lambda v: c.mult_vec_t(v))(Xt)
    # B 9000 x 4 and 600 x 4 floats, a slab of 200 x 4
    assert [kw["panels"].count for kw in seen] == [45, 3]
    assert all(kw["edges"] is None for kw in seen)
    assert seen[0]["panels"] is cuda_k._spmm_panels(c, False, 4)
    assert seen[1]["panels"] is cuda_k._spmm_panels(c, True, 4)
    assert sum(seen[1]["panels"].nnz) == a.nnz and seen[1]["panels"].ptrs.shape == (3, 9001)
    assert_product_close(Y.numpy(), (a.astype(np.float64) @ X.numpy().T).T)
    assert_product_close(Yt.numpy(), (a.T.astype(np.float64) @ Xt.numpy().T).T)


def test_wrapper_rejects_panels_of_another_matrix():
    a = _panel_case("long row")
    rp = torch.from_numpy(a.indptr.astype(np.int64))
    ci = torch.from_numpy(a.indices.astype(np.int32))
    v = torch.from_numpy(a.data)
    panels = spmm.split_panels(rp, ci, spmm.panel_bounds(a.shape[1], 3))
    b = torch.ones(a.shape[1], 2)
    assert spmm.spmm_csr(rp, ci, v, b, panels=panels).shape == (a.shape[0], 2)
    other = _panel_case("half empty")
    rp2 = torch.from_numpy(other.indptr.astype(np.int64))
    ci2 = torch.from_numpy(other.indices.astype(np.int32))
    with pytest.raises(ValueError, match="panels"):
        spmm.spmm_csr(rp2, ci2, None, torch.ones(other.shape[1], 2), panels=panels)
    one = spmm.split_panels(rp, ci, spmm.panel_bounds(a.shape[1], 1))
    with pytest.raises(ValueError, match="panels"):
        spmm.spmm_csr(rp, ci, v, b, panels=one)
