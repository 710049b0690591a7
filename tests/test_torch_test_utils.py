"""The port's Hypothesis strategies (``csr_tpu_torch/test_utils.py``):
what every draw guarantees, and a few properties of the port held
against scipy through them.  Each property runs at most 25 examples with
no deadline, so the suite stays short."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from hypothesis import HealthCheck, given, settings
import hypothesis.strategies as st

import csr_tpu.test_utils as ref_tu
from csr_tpu import CSR as RefCSR
from csr_tpu.kernels import use_kernel as ref_use_kernel
from csr_tpu_torch import CSR
from csr_tpu_torch import test_utils as tu
from csr_tpu_torch.kernels import use_kernel

from util import assert_spmv_close, dense_tols, tols

FEW = settings(max_examples=25, deadline=None,
               suppress_health_check=[HealthCheck.too_slow])


def test_same_names_as_the_jax_module():
    """Every public name of the JAX module has its counterpart."""
    public = {n for n in vars(ref_tu) if not n.startswith("_")
              and callable(getattr(ref_tu, n))
              and getattr(getattr(ref_tu, n), "__module__", "") == ref_tu.__name__}
    assert public <= set(vars(tu)), public - set(vars(tu))
    for name in ("DIM_LIMIT", "DENSITY_LIMIT", "VALUE_LIMIT"):
        assert getattr(tu, name) == getattr(ref_tu, name)


@FEW
@given(tu.csrs())
def test_csrs_invariants(csr):
    """Row pointers ascend from 0 to nnz, columns lie in range, cells are
    unique, values are finite, bounded, free of zeros and subnormals, in
    f4 or f8, and the matrix lies on the CPU."""
    assert isinstance(csr, CSR) and csr.device == torch.device("cpu")
    assert 1 <= csr.nrows <= tu.DIM_LIMIT and 1 <= csr.ncols <= tu.DIM_LIMIT
    assert csr.nnz <= np.ceil(csr.nrows * csr.ncols * tu.DENSITY_LIMIT)
    rps = csr.rowptrs.numpy()
    assert rps[0] == 0 and rps[-1] == csr.nnz and np.all(np.diff(rps) >= 0)
    cis = csr.colinds.numpy()
    assert np.all((cis >= 0) & (cis < csr.ncols))
    rows = np.repeat(np.arange(csr.nrows), np.diff(rps))
    assert len(np.unique(rows.astype(np.int64) * csr.ncols + cis)) == csr.nnz
    if csr.values is not None:
        vs = csr.values.numpy()
        assert vs.dtype in (np.float32, np.float64)
        assert np.all(np.isfinite(vs)) and np.all(np.abs(vs) <= tu.VALUE_LIMIT)
        assert np.all(vs != 0)
        assert np.all(np.abs(vs) >= np.finfo(vs.dtype).tiny)


@FEW
@given(st.data())
def test_fixed_arguments_and_dtypes(data):
    """Fixed shapes, counts and dtypes are honoured; f8 is drawn, as the
    port never narrows."""
    dtype = data.draw(tu.value_dtypes())
    csr = data.draw(tu.csrs(nrows=7, ncols=st.just(5), nnz=[0, 3, 9],
                            values=True, dtype=dtype))
    assert (csr.nrows, csr.ncols) == (7, 5) and csr.nnz <= 9
    assert csr.values.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    s = data.draw(tu.csrs(values=False))
    assert s.values is None


def test_f8_is_drawn():
    seen = set()

    @settings(max_examples=25, deadline=None)
    @given(tu.value_dtypes())
    def record(dt):
        seen.add(dt)

    record()
    assert seen == {np.dtype("f4"), np.dtype("f8")}


@FEW
@given(tu.mm_pairs(max_shape=(30, 30, 30)))
def test_mm_pairs_conform(pair):
    a, b = pair
    assert a.ncols == b.nrows
    assert a.values is not None and b.values is not None
    assert a.values.dtype == b.values.dtype == torch.float64


def test_other_strategies_and_helpers():
    @settings(max_examples=10, deadline=None)
    @given(tu.sparse_matrices(max_shape=(20, 20)), tu.matrices((6, 6)),
           tu.finite_arrays(5, dtype="f4"), tu.fractions())
    def check(sp, dense, arr, frac):
        assert sps.issparse(sp) and sp.shape[0] <= 20 and sp.shape[1] <= 20
        assert dense.ndim == 2 and dense.shape[0] <= 6
        assert arr.shape == (5,) and np.all(np.isfinite(arr))
        assert 0 <= frac <= 1

    check()
    slow = tu.csr_slow(4)
    assert slow.deadline is None
    assert slow.max_examples == max(settings.default.max_examples // 4, 1)
    assert tu.has_memory(0.001) and not tu.has_memory(1e9)


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_mult_vec_property(kernel):
    """``mult_vec`` of any drawn matrix against scipy, under
    ``assert_spmv_close``, on both port backends (the cuda backend's plain
    version on the CPU)."""

    @FEW
    @given(st.data())
    def check(data):
        csr = data.draw(tu.csrs(dtype=np.float32))
        x = data.draw(tu.finite_arrays(csr.ncols, dtype="f4",
                                       allow_subnormal=False))
        with use_kernel(kernel):
            y = csr.mult_vec(torch.from_numpy(x))
        assert y.shape == (csr.nrows,)
        ref = csr.to_scipy().astype(np.float64) @ x.astype(np.float64)
        assert_spmv_close(y.numpy(), ref, csr, x)

    check()


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_multiply_property(kernel):
    """``multiply`` of any drawn f4 pair against scipy's product, within
    ``tests/util.py:dense_tols``."""

    @FEW
    @given(tu.mm_pairs(max_shape=(40, 40, 40), dtype=np.float32))
    def check(pair):
        a, b = pair
        with use_kernel(kernel):
            c = a.multiply(b)
        ref = (a.to_scipy() @ b.to_scipy()).toarray()
        np.testing.assert_allclose(c.to_scipy().toarray(), ref,
                                   **dense_tols(ref, np.float32))

    check()


@FEW
@given(tu.csrs())
def test_transpose_property(csr):
    """``transpose`` equals scipy's, values and structure, rows sorted."""
    t = csr.transpose()
    assert (t.nrows, t.ncols, t.nnz) == (csr.ncols, csr.nrows, csr.nnz)
    np.testing.assert_array_equal(t.to_scipy().toarray(),
                                  csr.to_scipy().T.toarray())
    rps, cis = t.rowptrs.numpy(), t.colinds.numpy()
    for r in range(t.nrows):
        assert np.all(np.diff(cis[rps[r]:rps[r + 1]]) > 0)


@FEW
@given(tu.coo_arrays(dtype=np.float32))
def test_one_draw_builds_both_packages(arrays):
    """The numpy arrays of one draw build the port's and the JAX
    package's matrices, which hold the same arrays and the same
    products."""
    rows, cols, vals, shape = arrays
    port = CSR.from_coo(rows, cols, vals, shape, device="cpu")
    ref = RefCSR.from_coo(rows, cols, vals, shape)
    np.testing.assert_array_equal(port.rowptrs.numpy(), np.asarray(ref.rowptrs))
    np.testing.assert_array_equal(port.colinds.numpy(), np.asarray(ref.colinds))
    x = np.linspace(-1, 1, shape[1]).astype(np.float32)
    with ref_use_kernel("xla"):
        ref_y = np.asarray(ref.mult_vec(x))
    np.testing.assert_allclose(port.mult_vec(torch.from_numpy(x)).numpy(), ref_y,
                               **tols(np.float32))
