"""The CUDA kernel on the card: each test needs a CUDA device and skips
without one.  This file imports neither jax nor csr_tpu, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from csr_tpu_torch import CSR
from csr_tpu_torch.kernels import use_kernel
from csr_tpu_torch.ops import microblock as mb, spmv

from torch_util import Scipy, cuda_device, random_matrix  # noqa: F401
from util import assert_spmv_close

pytestmark = pytest.mark.gpu

WINDOW_PAIR = [(w, p) for w in (128, 256) for p in (1, 2, 4)]


@pytest.mark.parametrize("window,pair", WINDOW_PAIR)
def test_kernel_matches_reference_on_card(window, pair, cuda_device):
    a = random_matrix(300, 700, 0.03, seed=40 + window + pair)
    layout = mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                       window=window, pair=pair,
                                       device=cuda_device)
    x = np.random.default_rng(window + pair).uniform(-1, 1, 700).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device)
    before = spmv.launches
    y = spmv.spmv(layout, xd)
    y_ref = spmv.spmv_reference(layout, xd)
    torch.cuda.synchronize()
    assert spmv.launches == before + 1
    assert_spmv_close(y.cpu().numpy(), y_ref.cpu().numpy(), Scipy(a), x)
    assert_spmv_close(y.cpu().numpy(), a.astype(np.float64) @ x, Scipy(a), x)


def test_wrapper_rejects_bad_layout_on_card(cuda_device):
    a = random_matrix(300, 700, 0.03, seed=50)
    layout = mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                       device=cuda_device)
    x = torch.ones(700, device=cuda_device)
    with pytest.raises(ValueError):
        spmv.spmv(layout, x.cpu())
    for field, bad in (("vals", layout.vals.double()),
                       ("meta", layout.meta.to(torch.int32)),
                       ("rbcb", layout.rbcb[::2])):
        broken = mb.MicroBlockLayout(**{**layout.__dict__, field: bad})
        with pytest.raises(ValueError):
            spmv.spmv(broken, x)


def test_slice_on_card(cuda_device):
    a = random_matrix(260, 390, 0.04, seed=5)
    c = CSR(260, 390, a.nnz, a.indptr, a.indices, a.data, device=cuda_device)
    x = np.random.default_rng(13).uniform(-1, 1, 390).astype(np.float32)
    xt = np.random.default_rng(14).uniform(-1, 1, 260).astype(np.float32)
    before = spmv.launches
    with use_kernel("cuda"):
        y = c.mult_vec(torch.from_numpy(x).to(cuda_device))
        yt = c.mult_vec_t(torch.from_numpy(xt).to(cuda_device))
        y64 = c.mult_vec(torch.from_numpy(x).double().to(cuda_device))
    assert spmv.launches == before + 2  # f64 routes to the torch backend
    assert y.device.type == yt.device.type == "cuda" and y64.dtype == torch.float64
    a64 = a.astype(np.float64)
    assert_spmv_close(y.cpu().numpy(), a64 @ x, c, x)
    assert_spmv_close(yt.cpu().numpy(), a64.T @ xt, Scipy(a.T.tocsr()), xt)
    assert_spmv_close(y64.cpu().numpy(), a64 @ x, c, x)
