"""The SpMV slice as a whole: ``CSR.mult_vec``/``mult_vec_t`` of the port
under its ``scipy``, ``torch`` and ``cuda`` kernels (``cuda`` on the CPU
runs the kernel's plain version) against the JAX package's ``CSR`` under
``pallas`` (interpret mode) and ``xla``, and against scipy, under
``assert_spmv_close``.  Also the container, the kernel registry, the f64
route, the row-shard path and npz files carried across."""

import pickle

import jax
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import csr_tpu
import csr_tpu.kernels as ref_kernels
import csr_tpu.utils.serialization as ref_ser
import csr_tpu_torch
import csr_tpu_torch.kernels as kernels
from csr_tpu_torch import CSR
from csr_tpu_torch.kernels import cuda as cuda_k
from csr_tpu_torch.utils import serialization as ser

from torch_util import Scipy, random_matrix
from util import assert_spmv_close, tols

PORT_KERNELS = ["scipy", "torch", "cuda"]


def _matrix(structure_only=False):
    a = random_matrix(260, 390, 0.04, seed=5)
    if structure_only:
        a = sps.csr_matrix((np.ones(a.nnz, np.float32), a.indices, a.indptr),
                           shape=a.shape)
    return a


def _port(a, structure_only=False, device=None):
    return CSR(a.shape[0], a.shape[1], a.nnz, a.indptr, a.indices,
               None if structure_only else a.data, device=device)


def _ref(a, structure_only=False):
    return csr_tpu.CSR(a.shape[0], a.shape[1], a.nnz, a.indptr, a.indices,
                       None if structure_only else a.data)


@pytest.fixture(scope="module")
def reference_results():
    """csr_tpu's mult_vec/mult_vec_t under pallas and xla, on the values and
    structure-only forms of one matrix (one pallas trace per direction)."""
    out = {}
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, 390).astype(np.float32)
    xt = rng.uniform(-1, 1, 260).astype(np.float32)
    for so in (False, True):
        ref = _ref(_matrix(so), so)
        for k in ("pallas", "xla"):
            with ref_kernels.use_kernel(k):
                out[so, k] = (np.asarray(ref.mult_vec(x)),
                              np.asarray(ref.mult_vec_t(xt)))
    return x, xt, out


@pytest.mark.parametrize("structure_only", [False, True])
@pytest.mark.parametrize("kernel", PORT_KERNELS)
def test_slice_matches_reference(kernel, structure_only, reference_results):
    x, xt, ref = reference_results
    a = _matrix(structure_only)
    c = _port(a, structure_only)
    with kernels.use_kernel(kernel):
        y = c.mult_vec(x)
        yt = c.mult_vec_t(torch.from_numpy(xt))
    assert isinstance(y, torch.Tensor) and y.shape == (260,)
    assert yt.shape == (390,)
    if kernel != "scipy":
        assert y.dtype == yt.dtype == torch.float32
    a64 = a.astype(np.float64)
    at = Scipy(a.T.tocsr())
    assert_spmv_close(y.numpy(), a64 @ x, c, x)
    assert_spmv_close(yt.numpy(), a64.T @ xt, at, xt)
    for k in ("pallas", "xla"):
        ry, ryt = ref[structure_only, k]
        assert_spmv_close(y.numpy(), ry, c, x)
        assert_spmv_close(yt.numpy(), ryt, at, xt)


def test_cuda_kernel_caches_layouts(monkeypatch):
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", float("inf"))  # the micro-block route
    c = _port(_matrix())
    events = []
    kernels._listeners.append(lambda e, f: events.append(e))
    try:
        with kernels.use_kernel("cuda"):
            for _ in range(2):
                c.mult_vec(np.ones(390, np.float32))
                c.mult_vec_t(np.ones(260, np.float32))
    finally:
        kernels._listeners.pop()
    assert events.count("layout-build") == events.count("layout-build-t") == 1
    assert events.count("to_handle") == events.count("release_handle") == 4
    layout = cuda_k._cached_layout(c)
    assert (layout.nrows, layout.ncols) == (260, 390)
    h = cuda_k.to_handle(c)
    assert h.layout is layout
    cuda_k.release_handle(h, drop_cache=True)
    assert c._mb_layout_cache is None


def test_f64_routes_to_torch_backend():
    """f64 values or operands skip the kernel, as the JAX package routes
    f64 away from its Pallas kernel; f64 holds full precision."""
    a = _matrix().astype(np.float64)
    a.data += np.random.default_rng(7).uniform(0, 1e-9, a.nnz)
    c = _port(a)
    assert c.values.dtype == torch.float64
    x = np.random.default_rng(8).uniform(-1, 1, 390)
    with kernels.use_kernel("cuda"):
        y = c.mult_vec(x)
        y32 = _port(_matrix()).mult_vec(x)  # f32 matrix, f64 operand
        yt = c.mult_vec_t(np.ones(260))
    assert y.dtype == y32.dtype == yt.dtype == torch.float64
    assert getattr(c, "_mb_layout_cache", None) is None
    np.testing.assert_allclose(y.numpy(), a @ x, **tols(np.float64))
    np.testing.assert_allclose(yt.numpy(), a.T @ np.ones(260), **tols(np.float64))
    with jax.enable_x64():
        ref = _ref(a)
        with ref_kernels.use_kernel("xla"):
            ry = np.asarray(ref.mult_vec(x))
    assert ry.dtype == np.float64
    np.testing.assert_allclose(y.numpy(), ry, **tols(np.float64))


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_row_shards(kernel, monkeypatch):
    """A shrunken max_nnz sends mult_vec and mult_vec_t through the
    row-shard path."""
    a = _matrix()
    c = _port(a)
    k = kernels.get_kernel(kernel)
    row_max = int(np.diff(a.indptr).max())
    monkeypatch.setattr(k, "max_nnz", max(row_max, a.nnz // 4))
    x = np.random.default_rng(9).uniform(-1, 1, 390).astype(np.float32)
    xt = np.random.default_rng(10).uniform(-1, 1, 260).astype(np.float32)
    with kernels.use_kernel(kernel):
        y = c.mult_vec(x)
        yt = c.mult_vec_t(xt)
        shards = c._shard_rows(k.max_nnz)
        assert len(shards) >= 4 and all(s.nnz <= k.max_nnz for s in shards)
        assert c._shard_rows(k.max_nnz) is shards  # cached
        assert torch.equal(c.mult_vec(x), y)
    assert_spmv_close(y.numpy(), a.astype(np.float64) @ x, c, x)
    assert_spmv_close(yt.numpy(), a.T.astype(np.float64) @ xt,
                      Scipy(a.T.tocsr()), xt)
    whole = CSR._assemble_shards(shards)
    assert (whole.to_scipy() != a).nnz == 0


@pytest.mark.parametrize("first_has_values", [True, False])
def test_assemble_mixed_value_shards(first_has_values):
    """Shards of which only some carry values assemble as the JAX package
    assembles them: the first shard's value policy wins, and shards
    without values contribute implicit ones."""
    a = _matrix()
    cuts = [0, 90, 170, 260]
    has_values = [first_has_values, not first_has_values, True]
    port, ref = [], []
    for (lo, hi), hv in zip(zip(cuts[:-1], cuts[1:]), has_values):
        s = a[lo:hi]
        vs = s.data if hv else None
        port.append(CSR(s.shape[0], s.shape[1], s.nnz, s.indptr, s.indices, vs))
        ref.append(csr_tpu.CSR(s.shape[0], s.shape[1], s.nnz, s.indptr,
                               s.indices, vs))
    got = CSR._assemble_shards(port)
    expect = csr_tpu.CSR._assemble_shards(ref)
    assert (got.nrows, got.ncols, got.nnz) == (expect.nrows, expect.ncols, expect.nnz)
    assert np.array_equal(got.rowptrs.numpy(), np.asarray(expect.rowptrs))
    assert np.array_equal(got.colinds.numpy(), np.asarray(expect.colinds))
    assert (got.values is None) == (expect.values is None) == (not first_has_values)
    if first_has_values:
        assert got.values.dtype == torch.float32
        assert np.array_equal(got.values.numpy(), np.asarray(expect.values))


def test_empty_and_out_of_range():
    z = CSR.empty(5, 7)
    with kernels.use_kernel("cuda"):
        y = z.mult_vec(np.ones(7, np.float32))
        yt = z.mult_vec_t(np.ones(5, np.float32))
    assert torch.equal(y, torch.zeros(5)) and torch.equal(yt, torch.zeros(7))
    # 32768 row windows: past the packer's 15-bit rb, so spmv_large runs
    # its two row chunks (the second of 128 rows)
    nrows = 32768 * 128
    rp = np.zeros(nrows + 1, np.int64)
    rp[1:] = 1
    rp[-1] = 2  # and one entry in the last row
    tall = CSR(nrows, 3, 2, rp, np.array([2, 0], np.int32),
               np.array([1.5, -2.0], np.float32))
    x = np.array([3.0, 5.0, 7.0], np.float32)
    with kernels.use_kernel("cuda"):
        y = tall.mult_vec(x)
    assert len(cuda_k._cached_large(tall, False)) == 2
    np.testing.assert_array_equal(y.numpy(), tall.to_scipy() @ x)


def test_container_matches_reference():
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 40, 300)
    cols = rng.integers(0, 50, 300)
    vals = rng.standard_normal(300).astype(np.float32)
    c = CSR.from_coo(rows, cols, vals, (40, 50))
    r = csr_tpu.CSR.from_coo(rows, cols, vals, (40, 50))
    for name in ("rowptrs", "colinds", "values"):
        assert np.array_equal(getattr(c, name).numpy(), np.asarray(getattr(r, name)))
    assert c.rowptrs.dtype == torch.int32 and c.colinds.dtype == torch.int32
    assert np.array_equal(c.rowinds().numpy(), np.asarray(r.rowinds()))
    s = c.subset_rows(10, 30)
    rs = r.subset_rows(10, 30)
    assert (s.to_scipy() != rs.to_scipy()).nnz == 0 and s._host is not None
    assert (c.copy().to_scipy() != c.to_scipy()).nnz == 0
    assert c.copy(include_values=False).values is None
    assert (CSR.from_scipy(c.to_scipy()).to_scipy() != c.to_scipy()).nnz == 0
    assert CSR.from_coo(rows, cols, None, rpdtype=np.int64).rowptrs.dtype == torch.int64
    e = CSR.empty(3, 4, row_nnzs=[1, 0, 2])
    assert e.nnz == 3 and e.values.dtype == torch.float32
    assert torch.equal(CSR.empty(3, 4, values=False)._required_values(), torch.ones(0))
    # the data has repeated coordinates, whose order the JAX sort leaves
    # unspecified: arrays equal but for the values, values by dense sums
    t, rt = c.transpose(), r.transpose()
    for name in ("rowptrs", "colinds"):
        assert np.array_equal(getattr(t, name).numpy(), np.asarray(getattr(rt, name)))
    np.testing.assert_allclose(t.to_scipy().toarray(), rt.to_scipy().toarray(),
                               rtol=1e-6)


def test_pickle_round_trip():
    c = _port(_matrix())
    c2 = pickle.loads(pickle.dumps(c))
    assert c2.device == c.device
    assert (c2.to_scipy() != c.to_scipy()).nnz == 0


def test_kernel_registry(monkeypatch):
    assert kernels.get_kernel("pallas") is kernels.get_kernel("cuda")
    assert kernels.get_kernel("mkl") is cuda_k
    assert kernels.get_kernel("xla") is kernels.get_kernel("numba")
    assert kernels.get_kernel("xla").__name__ == "csr_tpu_torch.kernels.torch"
    with kernels.use_kernel("scipy"):
        assert kernels.get_kernel().__name__.endswith("scipy")
    for name in ("to_handle", "from_handle", "release_handle", "order_columns",
                 "mult_vec", "mult_vec_t", "mult_dense", "mult_ab", "mult_abt",
                 "max_nnz"):
        for k in PORT_KERNELS:
            assert hasattr(kernels.get_kernel(k), name), (k, name)
    monkeypatch.delenv("CSR_KERNEL", raising=False)
    saved = kernels.__dict__["__cached_default"]
    try:
        kernels.__dict__["__cached_default"] = None
        expect = "cuda" if torch.cuda.is_available() else "torch"
        assert kernels._default_kernel() is kernels.get_kernel(expect)
        kernels.__dict__["__cached_default"] = None
        monkeypatch.setenv("CSR_KERNEL", "scipy")
        assert kernels._default_kernel() is kernels.get_kernel("scipy")
    finally:
        kernels.__dict__["__cached_default"] = saved


@pytest.mark.parametrize("structure_only", [False, True])
def test_npz_from_reference_loads(structure_only, tmp_path):
    """An npz written by csr_tpu loads into the port with the same SpMV,
    and the port's npz loads back into csr_tpu."""
    a = _matrix(structure_only)
    ref = _ref(a, structure_only)
    path = tmp_path / "m.npz"
    ref_ser.save_npz(path, ref)
    c = ser.load_npz(path)
    assert (c.values is None) == structure_only
    x = np.random.default_rng(12).uniform(-1, 1, 390).astype(np.float32)
    with ref_kernels.use_kernel("xla"):
        ry = np.asarray(ref.mult_vec(x))
    with kernels.use_kernel("cuda"):
        assert_spmv_close(c.mult_vec(x).numpy(), ry, c, x)
    back = tmp_path / "back.npz"
    ser.save_npz(back, c)
    r2 = ref_ser.load_npz(back)
    assert (r2.to_scipy() != ref.to_scipy()).nnz == 0
    d = ser.to_state_dict(c)
    assert (ser.from_state_dict(d).to_scipy() != c.to_scipy()).nnz == 0
    f = ser.from_arrays(ref.nrows, ref.ncols, np.asarray(ref.rowptrs),
                        np.asarray(ref.colinds),
                        None if structure_only else np.asarray(ref.values))
    assert (f.to_scipy() != c.to_scipy()).nnz == 0


def test_package_exports():
    assert csr_tpu_torch.CSR is CSR


def test_check_handle_leaks():
    from csr_tpu_torch.utils.debug import check_handle_leaks

    c = _port(_matrix())
    x = np.ones(390, np.float32)
    with check_handle_leaks() as counter, kernels.use_kernel("torch"):
        c.mult_vec(x)
        c.multiply(c, transpose=True)
    assert counter.created == counter.released == 4
    K = kernels.get_kernel("torch")
    with pytest.raises(AssertionError, match="handle leak"):
        with check_handle_leaks():
            K.to_handle(c)
    with check_handle_leaks(strict=False) as counter:
        K.to_handle(c)
    assert counter.outstanding == 1
    with pytest.raises(KeyError), check_handle_leaks():  # the block's error wins
        K.to_handle(c)
        raise KeyError("inner")
    assert not kernels._listeners


def test_profiling_without_a_card():
    """The least time of given work comes from a card's published peaks;
    the timers refuse to time without a card, and so does the transfer
    guard."""
    from csr_tpu_torch.utils import debug, profiling

    assert profiling.least_ms(3350e9, 0, "NVIDIA H100 80GB HBM3") == (1e3, "bytes")
    assert profiling.least_ms(0, 67e12, "NVIDIA H100 80GB HBM3") == (1e3, "operations")
    assert profiling.peak_gbps("NVIDIA H100 PCIe") == 2000.0
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            profiling.timed(lambda: None)
        with pytest.raises(RuntimeError), debug.guard_transfers():
            pass
