"""Row normalisation (``transform.py``, ``CSR.normalize_rows``) and the
in-place methods of the port, on the CPU: against the JAX package's
``normalize_rows`` (jitted on the CPU) and numpy, within
``tests/util.py:tols``; the cases of ``tests/test_transform.py``.  And
the rule those methods keep: they bind new tensors, so the ``cuda``
kernel's layouts, cached on the identity of the tensors, are built again
and a product never runs a stale layout."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from hypothesis import given, settings

import csr_tpu
from csr_tpu.test_utils import csrs
from csr_tpu_torch import CSR, kernels, transform
from csr_tpu_torch.kernels import cuda as cuda_k

from torch_util import kept, port_of
from util import assert_spmv_close, to_dense, tols

FEW = settings(max_examples=15, deadline=None)


def _matrix():
    """40 x 30 with empty rows, a row of one entry, a row of equal values
    and a row of values near 1e-30 (whose squares underflow f32)."""
    rng = np.random.default_rng(60)
    a = sps.random(40, 30, 0.2, format="lil", random_state=rng, dtype=np.float32)
    for r in (5, 6, 7, 8, 9):
        a[r, :] = 0
    a[7, 3] = 2.5
    a[8, :10] = 4.0
    a[9, :4] = np.array([1e-30, -2e-30, 2e-30, 3e-30], np.float32)
    a = a.tocsr()
    a.eliminate_zeros()
    return a


@pytest.mark.parametrize("norm", ["center", "unit"])
def test_normalize_rows_matches_reference(norm):
    a = _matrix()
    c = CSR.from_scipy(a, device="cpu")
    ref = csr_tpu.CSR.from_scipy(a)
    stat, rstat = c.normalize_rows(norm), ref.normalize_rows(norm)
    t = tols(np.float32)
    np.testing.assert_allclose(stat.numpy(), np.asarray(rstat), **t)
    np.testing.assert_allclose(c.values.numpy(), np.asarray(ref.values), **t)
    assert stat[5] == 0 and stat[6] == 0  # empty rows
    if norm == "unit":
        for r in (7, 8, 9):
            sp, ep = c.row_extent(r)
            np.testing.assert_allclose(np.linalg.norm(c.values[sp:ep].numpy()),
                                       1.0, rtol=1e-5)
    else:
        assert float(stat[8]) == 4.0 and not c.row_vs(8).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transforms_return_new_values(dtype):
    a = _matrix()
    c = CSR(a.shape[0], a.shape[1], a.nnz, a.indptr, a.indices,
            torch.from_numpy(a.data).to(dtype), device="cpu")
    old = c.values.clone()
    for fn in (transform.center_rows, transform.unit_rows):
        vs, stats = fn(c)
        assert vs.dtype == stats.dtype == dtype and vs is not c.values
        assert torch.equal(c.values, old)  # never written in place
    dense = a.toarray().astype(np.float64)
    counts = (dense != 0).sum(1)
    means = np.divide(dense.sum(1), counts, out=np.zeros(40), where=counts > 0)
    np.testing.assert_allclose(transform.center_rows(c)[1].numpy(), means,
                               **tols(np.float32 if dtype == torch.float32
                                      else np.float64))


@FEW
@given(csrs(values="normal"))
def test_center_rows(csr):
    c = port_of(csr)
    dense = to_dense(c)
    means = c.normalize_rows("center").numpy()
    t = tols(means.dtype)
    d2 = to_dense(c)
    for i in range(c.nrows):
        nz = dense[i] != 0
        if nz.sum():
            np.testing.assert_allclose(means[i], dense[i][nz].mean(), **t)
            np.testing.assert_allclose(
                d2[i][nz], dense[i][nz] - dense[i][nz].mean(), rtol=t["rtol"],
                atol=t["atol"] * max(1, np.abs(dense[i]).max()))


@FEW
@given(csrs(values="normal"))
def test_unit_rows(csr):
    c = port_of(csr)
    dense = to_dense(c)
    norms = c.normalize_rows("unit").numpy()
    t = tols(norms.dtype)
    for i in range(c.nrows):
        nz = dense[i] != 0
        if nz.sum():
            np.testing.assert_allclose(
                norms[i], np.linalg.norm(dense[i][nz]), rtol=t["rtol"],
                atol=t["atol"] * max(1, np.abs(dense[i]).max()))
            np.testing.assert_allclose(np.linalg.norm(c.row_vs(i).numpy()), 1.0,
                                       rtol=1e-4)


def test_unit_rows_tiny_values():
    """1e-30 is a normal f32 whose square underflows: without the
    power-of-two prescale the norm would be 0.  Pinned on the CPU only:
    neither the TPU nor the GPU is relied on for subnormals."""
    vals = np.array([1e-30, 2e-30, 2e-30], dtype=np.float32)
    m = CSR.from_coo(np.zeros(3, np.int32), np.arange(3, dtype=np.int32), vals,
                     (1, 3), device="cpu")
    norms = m.normalize_rows("unit").numpy()
    np.testing.assert_allclose(np.linalg.norm(m.row_vs(0).numpy()), 1.0, rtol=1e-5)
    np.testing.assert_allclose(norms[0], 3e-30, rtol=1e-4)


def test_normalize_bad():
    m = CSR.empty(2, 2, device="cpu")
    with pytest.raises(ValueError):
        m.normalize_rows("bogus")
    with pytest.raises(ValueError, match="structure-only"):
        CSR.empty(2, 2, values=False, device="cpu").normalize_rows("unit")


def _events():
    seen = []
    kernels._listeners.append(lambda e, f: seen.append(e))
    return seen


@pytest.mark.parametrize("op", ["center", "unit", "sort_rows", "fill_values",
                                "values_setter"])
def test_inplace_ops_rebuild_cuda_layouts(op, monkeypatch):
    """After each in-place method a ``cuda`` product builds fresh layouts
    (both directions) and agrees with scipy on the new values: the layout
    cache and the host copies never outlive the tensors they were made
    from."""
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", float("inf"))  # the micro-block route
    rng = np.random.default_rng(61)
    rows = rng.integers(0, 300, 3000)
    cols = rng.integers(0, 200, 3000)  # unsorted rows, repeats
    vals = rng.uniform(-2, 2, 3000).astype(np.float32)
    c = CSR.from_coo(rows, cols, vals, (300, 200), device="cpu")
    x = rng.uniform(-1, 1, 200).astype(np.float32)
    xt = rng.uniform(-1, 1, 300).astype(np.float32)
    seen = _events()
    try:
        with kernels.use_kernel("cuda"):
            c.mult_vec(x)
            c.mult_vec_t(xt)
            before = (c.rowptrs, c.colinds, c.values)
            if op in ("center", "unit"):
                c.normalize_rows(op)
            elif op == "sort_rows":
                c.sort_rows()
            elif op == "fill_values":
                c.fill_values(0.5)
            else:
                c.values = c.values * 3
            assert kept(c, "host") is None
            assert any(n is not o for n, o in zip((c.rowptrs, c.colinds, c.values),
                                                  before))
            seen.clear()
            y, yt = c.mult_vec(x), c.mult_vec_t(xt)
    finally:
        kernels._listeners.pop()
    assert seen.count("layout-build") == 1 and seen.count("layout-build-t") == 1
    assert cuda_k._cached_layout(c) is kept(c, "layout")
    assert kept(c).values is c.values
    m = c.to_scipy()
    assert_spmv_close(y.numpy(), m.astype(np.float64) @ x, c, x)
    mt = m.T.tocsr()
    assert_spmv_close(yt.numpy(), mt.astype(np.float64) @ xt,
                      CSR.from_scipy(mt, device="cpu"), xt)
