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


class Scipy:
    """A scipy matrix behind the ``to_scipy`` hook that
    ``util.assert_spmv_close`` reads its bound's matrix from."""

    def __init__(self, m):
        self.m = m

    def to_scipy(self):
        return self.m
