"""The SpMM slice as a whole: ``CSR.mult_dense``, ``multiply`` and
``multiply(transpose=True)`` of the port under its ``scipy``, ``torch``
and ``cuda`` kernels (``cuda`` on the CPU runs the SpMM kernel's plain
version), the ``cuda`` kernel on both of its routes (densified matmul and
the SpMM kernel), against the JAX package's ``CSR`` under ``pallas``
(interpret mode) on both of its routes and under ``xla``, and against
scipy.  Tolerances are the JAX suite's: ``tests/test_mult_dense.py``'s
for products (rtol 5e-4, atol 1e-4 times the largest |result|) and
``tests/util.py:tols`` for f64.  The matrices go across as arrays
(``utils/serialization.from_arrays``)."""

import jax
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import csr_tpu
import csr_tpu.kernels as ref_kernels
from csr_tpu.kernels import pallas as ref_pallas
from csr_tpu.ops import spgemm as ref_spgemm
import csr_tpu_torch.kernels as kernels
from csr_tpu_torch import CSR
from csr_tpu_torch.kernels import cuda as cuda_k
from csr_tpu_torch.ops import spgemm, spmm
from csr_tpu_torch.utils.serialization import from_arrays

from torch_util import assert_product_close, kept, random_matrix
from util import tols

# the densify threshold that sends each test matrix to one route
ROUTES = {"dense": 0.0, "kernel": 1.1}
# (port kernel, cuda route)
PORT = [("scipy", None), ("torch", None), ("cuda", "dense"), ("cuda", "kernel")]


def _dense(c):
    return c.to_scipy().toarray()


def _operands(structure_only=False):
    """A (its (rb 0, cb 0) group spans two micro-rows), a dense B, and the
    right-hand matrices of ``A @ M`` and ``A @ Mt^T``."""
    a = random_matrix(260, 390, 0.04, seed=5)
    if structure_only:
        a = sps.csr_matrix((np.ones(a.nnz, np.float32), a.indices, a.indptr),
                           shape=a.shape)
    b = np.random.default_rng(15).uniform(-1, 1, (390, 50)).astype(np.float32)
    m = random_matrix(390, 200, 0.05, seed=16, big_group=False)
    mt = random_matrix(200, 390, 0.05, seed=17, big_group=False)
    return a, b, m, mt


def _ref(a, structure_only=False):
    return csr_tpu.CSR(a.shape[0], a.shape[1], a.nnz, a.indptr, a.indices,
                       None if structure_only else a.data)


def _port(ref):
    """The port's copy of a ``csr_tpu.CSR``, carried as arrays."""
    return from_arrays(ref.nrows, ref.ncols, np.asarray(ref.rowptrs),
                       np.asarray(ref.colinds),
                       None if ref.values is None else np.asarray(ref.values))


def _products(csr, b, m, mt):
    return (np.asarray(csr.mult_dense(b)), _dense(csr.multiply(m)),
            _dense(csr.multiply(mt, transpose=True)))


@pytest.fixture(scope="module")
def reference_results():
    """csr_tpu's three products under pallas (dense and kernel routes) and
    xla, on the values and structure-only forms of A."""
    out = {}
    for so in (False, True):
        a, b, m, mt = _operands(so)
        ref, rm, rmt = _ref(a, so), _ref(m), _ref(mt)
        for name, k, density in (("pallas-dense", "pallas", ROUTES["dense"]),
                                 ("pallas-kernel", "pallas", ROUTES["kernel"]),
                                 ("xla", "xla", None)):
            with pytest.MonkeyPatch.context() as mp, ref_kernels.use_kernel(k):
                if density is not None:
                    mp.setattr(ref_pallas, "_DENSIFY_MIN_DENSITY", density)
                out[so, name] = _products(ref, b, rm, rmt)
    return out


@pytest.fixture
def routes():
    """The routes the cuda kernel reports, as (event, route) pairs."""
    seen = []
    kernels._listeners.append(
        lambda e, f: seen.append((e, f["route"])) if "route" in f else None)
    yield seen
    kernels._listeners.pop()


@pytest.mark.parametrize("structure_only", [False, True])
@pytest.mark.parametrize("kernel,route", PORT)
def test_slice_matches_reference(kernel, route, structure_only,
                                 reference_results, routes, monkeypatch):
    a, b, m, mt = _operands(structure_only)
    c = _port(_ref(a, structure_only))
    assert (c.values is None) == structure_only
    if route is not None:
        monkeypatch.setattr(cuda_k, "_DENSIFY_CROSSOVER", ((1, ROUTES[route]),))
    if route == "kernel":
        # its layout is mostly padding (over SpMM's CSR-form crossover):
        # hold it on the micro-block kernel's route, which this checks
        monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, float("inf")),))
    with kernels.use_kernel(kernel):
        d = c.mult_dense(b)
        p = c.multiply(_port(_ref(m)))
        pt = c.multiply(_port(_ref(mt)), transpose=True)
    assert isinstance(d, torch.Tensor) and d.shape == (260, 50)
    assert (p.nrows, p.ncols) == (pt.nrows, pt.ncols) == (260, 200)
    if kernel != "scipy":
        assert d.dtype == p.values.dtype == torch.float32
    if route is not None:
        assert routes == [("mult_dense", route), ("spgemm", route),
                          ("spgemm", route)]
    a64 = a.astype(np.float64)
    got = (d.numpy(), _dense(p), _dense(pt))
    for g, e in zip(got, (a64 @ b, (a64 @ m).toarray(), (a64 @ mt.T).toarray())):
        assert_product_close(g, e)
    for name in ("pallas-dense", "pallas-kernel", "xla"):
        for g, e in zip(got, reference_results[structure_only, name]):
            assert_product_close(g, e)
    # the products store no zeros
    assert (p.to_scipy().data != 0).all() and (pt.to_scipy().data != 0).all()


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_row_shards(kernel, monkeypatch):
    """A shrunken max_nnz sends mult_dense and multiply through the
    row-shard path, the kernel route included."""
    a, b, m, mt = _operands()
    c = CSR.from_scipy(a)
    k = kernels.get_kernel(kernel)
    monkeypatch.setattr(k, "max_nnz", max(int(np.diff(a.indptr).max()), a.nnz // 4))
    monkeypatch.setattr(cuda_k, "_DENSIFY_CROSSOVER", ((1, ROUTES["kernel"]),))
    with kernels.use_kernel(kernel):
        assert len(c._shard_rows(k.max_nnz)) >= 4
        d = c.mult_dense(b)
        p = c.multiply(CSR.from_scipy(m))
        pt = c.multiply(CSR.from_scipy(mt), transpose=True)
    a64 = a.astype(np.float64)
    assert_product_close(d.numpy(), a64 @ b)
    assert_product_close(_dense(p), (a64 @ m).toarray())
    assert_product_close(_dense(pt), (a64 @ mt.T).toarray())


def test_f64_routes_to_torch_backend(routes):
    """f64 values or operands skip the kernel, as the JAX package routes
    f64 away from its Pallas kernel; f64 holds full precision."""
    a, b, m, _ = _operands()
    a = a.astype(np.float64)
    a.data += np.random.default_rng(18).uniform(0, 1e-9, a.nnz)
    c = CSR.from_scipy(a)
    b64 = b.astype(np.float64)
    with kernels.use_kernel("cuda"):
        d = c.mult_dense(b64)
        d32 = CSR.from_scipy(_operands()[0]).mult_dense(b64)  # f32 A, f64 B
        p = c.multiply(CSR.from_scipy(m))
    assert d.dtype == d32.dtype == p.values.dtype == torch.float64
    assert routes == [("mult_dense", "torch")] * 2 + [("spgemm", "torch")]
    assert kept(c, "layout") is None
    np.testing.assert_allclose(d.numpy(), a @ b64, **tols(np.float64))
    np.testing.assert_allclose(_dense(p), (a @ m).toarray(), **tols(np.float64))
    with jax.enable_x64():
        with ref_kernels.use_kernel("xla"):
            rd = np.asarray(_ref(a).mult_dense(b64))
    assert rd.dtype == np.float64
    np.testing.assert_allclose(d.numpy(), rd, **tols(np.float64))


@pytest.mark.parametrize("kernel", ["scipy", "torch", "cuda"])
def test_empty_operands(kernel):
    z = CSR.empty(5, 7)
    m = CSR.from_scipy(random_matrix(7, 4, 0.5, seed=19, big_group=False))
    with kernels.use_kernel(kernel):
        d = z.mult_dense(np.ones((7, 3), np.float32))
        p = z.multiply(m)
        q = m.multiply(CSR.empty(4, 6))
    assert d.shape == (5, 3) and not d.any()
    assert (p.nrows, p.ncols, p.nnz) == (5, 4, 0)
    assert (q.nrows, q.ncols, q.nnz) == (7, 6, 0)


@pytest.mark.parametrize("kernel", ["scipy", "torch", "cuda"])
def test_product_filters_zeros(kernel):
    """Cancelling products are not stored."""
    a = CSR.from_coo(np.array([0, 0]), np.array([0, 1]),
                     np.array([1.0, -1.0], np.float32), (1, 2))
    b = CSR.from_coo(np.array([0, 1]), np.array([0, 0]),
                     np.array([1.0, 1.0], np.float32), (2, 1))
    with kernels.use_kernel(kernel):
        assert a.multiply(b).nnz == 0


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_past_dense_budget_raises(kernel, monkeypatch, routes):
    """Past the dense budget the product runs ESC (it raised before ESC
    was ported; the name stays): against the JAX package's ESC, forced
    there by its own budget, and against scipy."""
    a, _, m, mt = _operands()
    c = CSR.from_scipy(a)
    ref = _ref(a)
    monkeypatch.setattr(spgemm, "max_dense_bytes", 4)
    monkeypatch.setattr(ref_spgemm, "max_dense_elems", 1)
    for b, transpose in ((m, False), (mt, True)):
        with kernels.use_kernel(kernel):
            p = c.multiply(CSR.from_scipy(b), transpose=transpose)
        with ref_kernels.use_kernel("pallas"):
            rp = ref.multiply(_ref(b), transpose=transpose)
        want = (a @ (b.T if transpose else b)).toarray()
        assert p.nnz == rp.nnz and np.all(p.values.numpy() != 0)
        assert_product_close(_dense(p), want)
        assert_product_close(_dense(p), _dense(rp))
    assert routes == ([("spgemm", "esc")] * 2 if kernel == "cuda" else [])


def test_dense_budget_counts_bytes():
    """The port budgets bytes: f64 gets half the elements of f32."""
    side = int((spgemm.max_dense_bytes // 4) ** 0.5)
    assert spgemm.dense_fits(side, side, side, side, torch.float32)
    assert not spgemm.dense_fits(side, side, side, side, torch.float64)
    assert spgemm.dense_fits(side, side, side // 2, side // 2, torch.float64)


def test_densify_threshold_follows_width(monkeypatch):
    """The dense route's threshold is the measured crossover at B's width:
    each measured point, between two points a value between theirs,
    constant past the ends; and it keeps to spgemm's dense budget."""
    table = cuda_k._DENSIFY_CROSSOVER
    for n, d in table:
        assert cuda_k._min_density(n) == pytest.approx(d)
    assert cuda_k._min_density(1) == pytest.approx(table[0][1])
    assert cuda_k._min_density(10**6) == pytest.approx(table[-1][1])
    for (n0, d0), (n1, d1) in zip(table, table[1:]):
        mid = cuda_k._min_density(round((n0 * n1) ** 0.5))
        assert min(d0, d1) <= mid <= max(d0, d1)
    c = CSR.from_scipy(sps.random(64, 64, 0.5, format="csr", random_state=0,
                                  dtype=np.float32))
    assert cuda_k._dense_affordable(c, 256)
    assert not cuda_k._dense_affordable(c, 50)  # the kernel wins at any density
    monkeypatch.setattr(spgemm, "max_dense_bytes", 64 * 64 * 4 - 1)
    assert not cuda_k._dense_affordable(c, 256)


def test_wide_matrix_stays_on_kernel(routes, monkeypatch):
    """A matrix whose B and C panels overflow the TPU's VMEM: the JAX
    package sends it to its XLA scatter path, the port keeps it on the
    SpMM kernel (there is no VMEM gate here).  Its layout costs about 17 B
    an entry, past SpMM's CSR-form crossover: held on the micro-block
    kernel's route, which this checks."""
    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, float("inf")),))
    rng = np.random.default_rng(20)
    a = sps.random(64, 15000, 3e-3, format="csr", random_state=rng,
                   dtype=np.float32)
    b = rng.uniform(-1, 1, (15000, 4)).astype(np.float32)
    ref = csr_tpu.CSR.from_scipy(a)
    assert not ref_pallas._spmm_viable(ref, ref.nrows)
    with ref_kernels.use_kernel("pallas"):
        rd = np.asarray(ref.mult_dense(b))
    before = spmm.launches
    with kernels.use_kernel("cuda"):
        d = _port(ref).mult_dense(b)
    assert spmm.launches == before  # the plain version, on the CPU
    assert routes == [("mult_dense", "kernel")]
    assert_product_close(d.numpy(), a.astype(np.float64) @ b)
    assert_product_close(d.numpy(), rd)


def test_out_of_packing_range_goes_to_torch(routes):
    """SpMM of a matrix past the packer's 15-bit rb no longer runs on the
    torch backend: this one, whose layout would be all padding, takes the
    CSR-form kernel's route (its plain version on the CPU)."""
    nrows = 32768 * 128
    rp = np.zeros(nrows + 1, np.int64)
    rp[-2:] = [0, 1]  # one entry, in the last row
    tall = CSR(nrows, 3, 1, rp, np.array([2], np.int32),
               np.array([1.5], np.float32))
    b = np.arange(6, dtype=np.float32).reshape(3, 2)
    with kernels.use_kernel("cuda"):
        d = tall.mult_dense(b)
    assert routes == [("mult_dense", "csr")]
    assert d.shape == (nrows, 2) and torch.equal(d[-1], torch.tensor([6.0, 7.5]))
    assert not d[:-1].any()


def test_operands_are_checked():
    c = CSR.from_scipy(_operands()[0])
    with pytest.raises(ValueError):
        c.mult_dense(np.ones((389, 2), np.float32))
    with pytest.raises(ValueError):
        c.mult_dense(np.ones(390, np.float32))
    with pytest.raises(ValueError):
        c.multiply(c)
    with pytest.raises(ValueError):
        c.multiply(CSR.empty(5, 7), transpose=True)
