"""Shared helpers of the port's tests (``tests/test_torch_*.py``)."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at
    import, so every pytest-xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_matrix(nrows, ncols, density, seed, big_group=True):
    """Seeded f32 scipy CSR matrix.  With ``big_group``, rows 3 and 4 fill
    most of the first 128-column window, so the (rb 0, cb 0) group holds
    228+ entries and spans two micro-rows."""
    rng = np.random.default_rng(seed)
    a = sps.random(nrows, ncols, density, format="lil", random_state=rng,
                   dtype=np.float32)
    if big_group:
        a[3, : min(128, ncols)] = rng.uniform(-2, 2, min(128, ncols))
        a[4, : min(100, ncols)] = rng.uniform(-2, 2, min(100, ncols))
    return a.tocsr()


def assert_product_close(c, ref):
    """The JAX suite's tolerance for products (tests/test_mult_dense.py,
    tests/test_multiply.py): rtol 5e-4, atol 1e-4 times the largest
    |ref| (at least 1)."""
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, np.abs(ref).max(initial=0))
    np.testing.assert_allclose(np.asarray(c, np.float64), ref, rtol=5e-4,
                               atol=1e-4 * scale)


class Scipy:
    """A scipy matrix behind the ``to_scipy`` hook that
    ``util.assert_spmv_close`` reads its bound's matrix from."""

    def __init__(self, m):
        self.m = m

    def to_scipy(self):
        return self.m


def both_csr(a, structure_only=False):
    """The scipy matrix ``a`` as a ``csr_tpu.CSR`` and as a
    ``csr_tpu_torch.CSR`` on the CPU (values dropped with
    ``structure_only``)."""
    from csr_tpu import CSR as RefCSR
    from csr_tpu_torch import CSR

    vals = None if structure_only else a.data
    return (RefCSR(a.shape[0], a.shape[1], a.nnz, a.indptr, a.indices, vals),
            CSR(a.shape[0], a.shape[1], a.nnz, a.indptr, a.indices, vals,
                device="cpu"))


def fields_of(ref):
    """The fields of a ``csr_tpu.parallel`` dataclass as numpy arrays and
    numbers, for ``parallel_from_arrays``."""
    import dataclasses

    return {f.name: np.asarray(getattr(ref, f.name))
            for f in dataclasses.fields(ref)}


def assert_same_partition(port, ref, tensors):
    """Every field of the JAX dataclass equals the port's, the stacked
    arrays byte for byte."""
    for name, want in fields_of(ref).items():
        got = getattr(port, name)
        if name in tensors:
            got = got.numpy()
            assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
            assert got.shape == want.shape, (name, got.shape, want.shape)
            assert got.tobytes() == want.tobytes(), name
        else:
            np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)


def port_of(ref):
    """The port's copy, on the CPU, of a ``csr_tpu.CSR`` (its arrays go
    across as numpy)."""
    from csr_tpu_torch import CSR

    vs = None if ref.values is None else np.asarray(ref.values)
    return CSR(ref.nrows, ref.ncols, ref.nnz, np.asarray(ref.rowptrs),
               np.asarray(ref.colinds), vs, device="cpu")
