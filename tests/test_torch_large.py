"""The chunk/panel SpMV (``ops/spmv.py:build_large_layouts``,
``spmv_large``) and its routing in the ``cuda`` backend, on the CPU
(each panel runs the SpMV kernel's plain version): layouts byte-equal to
the JAX package's, products against ``csr_tpu``'s ``spmv_large``
(Pallas in interpret mode) and scipy within
``tests/util.py:assert_spmv_close``, in both directions, with the
layouts cached.  The budget of windows is shrunk as
``tests/test_mult_vec.py:test_spmv_large_chunk_panel`` shrinks
``_VMEM_WINDOWS``; the packer's own range is never patched."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import csr_tpu
import csr_tpu.kernels as ref_kernels
from csr_tpu.kernels import pallas as ref_pallas
from csr_tpu.ops import spmv as ref_spmv
from csr_tpu_torch import CSR, kernels
from csr_tpu_torch.kernels import cuda as cuda_k
from csr_tpu_torch.ops import microblock, spmv

from torch_util import Scipy, kept, port_chooser
from util import assert_spmv_close


def _matrix(structure_only=False, nrows=512, ncols=640, seed=3):
    rng = np.random.default_rng(seed)
    m = sps.random(nrows, ncols, 0.03, format="csr", random_state=rng,
                   dtype=np.float32)
    if structure_only:
        m.data[:] = 1.0
    return m


def _same_bytes(got, want):
    for name in ("vals", "meta", "rbcb"):
        assert getattr(got, name).numpy().tobytes() == np.asarray(
            getattr(want, name)).tobytes(), name
    for name in ("nrows", "ncols", "nnz", "n_microrows", "window", "pair"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("max_windows,shape", [
    (2, (512, 640)),     # 2 chunks x 3 panels
    (2, (300, 200)),     # 2 chunks, the last of 44 rows; 1 panel
    (1, (256, 900)),     # 2 chunks x 8 panels, some of them empty
    (8, (512, 640)),     # 1 chunk, 1 panel: the unsplit layout
])
@pytest.mark.parametrize("structure_only", [False, True])
def test_large_layouts_byte_equal(max_windows, shape, structure_only,
                                  monkeypatch):
    port_chooser(monkeypatch)
    m = _matrix(False, *shape, seed=sum(shape) + max_windows)
    vals = None if structure_only else m.data
    got = spmv.build_large_layouts(*shape, m.indptr, m.indices, vals,
                                   max_windows=max_windows)
    want = ref_spmv.build_large_layouts(*shape, m.indptr, m.indices, vals,
                                        max_windows=max_windows)
    assert [(cn, [off for off, _ in p]) for cn, p in got] == \
        [(cn, [off for off, _ in p]) for cn, p in want]
    for (_, panels), (_, ref_panels) in zip(got, want):
        for (_, lay), (_, ref_lay) in zip(panels, ref_panels):
            _same_bytes(lay, ref_lay)
    if (max_windows, shape) == (2, (512, 640)):
        assert [len(p) for _, p in got] == [3, 3]


@pytest.mark.parametrize("structure_only", [False, True])
def test_spmv_large_matches_reference(structure_only, monkeypatch):
    """512 x 640 at 2 windows: mult_vec on 2 chunks x 3 panels, mult_vec_t
    on 3 x 2, against csr_tpu's chunk/panel path and scipy; a second call
    builds no layout."""
    monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", 2)
    monkeypatch.setattr(ref_pallas, "_VMEM_WINDOWS", 2)
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", float("inf"))  # the micro-block route
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER_LARGE", float("inf"))
    m = _matrix(structure_only)
    vals = None if structure_only else m.data
    c = CSR(512, 640, m.nnz, m.indptr, m.indices, vals, device="cpu")
    ref = csr_tpu.CSR(512, 640, m.nnz, m.indptr, m.indices, vals)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(640).astype(np.float32)
    xt = rng.standard_normal(512).astype(np.float32)
    events = []
    kernels._listeners.append(lambda e, f: events.append((e, f)))
    try:
        with kernels.use_kernel("cuda"):
            y, yt = c.mult_vec(x), c.mult_vec_t(xt)
            builds = [f for e, f in events if e.startswith("layout-build")]
            events.clear()
            y2, yt2 = c.mult_vec(x), c.mult_vec_t(xt)
            assert not [e for e, _ in events if e.startswith("layout-build")]
    finally:
        kernels._listeners.pop()
    assert [(f["chunks"], f["panels"], f["transpose"]) for f in builds] == [
        (2, 6, False), (3, 6, True)]
    assert torch.equal(y, y2) and torch.equal(yt, yt2)
    with ref_kernels.use_kernel("pallas"):
        ry, ryt = np.asarray(ref.mult_vec(x)), np.asarray(ref.mult_vec_t(xt))
    mt = m.T.tocsr()
    for got, want, a, v in ((y, ry, m, x), (yt, ryt, mt, xt)):
        assert got.dtype == torch.float32
        assert_spmv_close(got.numpy(), want, Scipy(a), v)
        assert_spmv_close(got.numpy(), a.astype(np.float64) @ v, Scipy(a), v)


def test_spmv_large_slices_into_one_output():
    """Each panel adds into its chunk's rows of one zeroed output through
    ``spmv(..., out=)``, on a slice of x; empty chunks leave zeros."""
    m = _matrix(nrows=700, ncols=300, seed=5).tolil()
    m[256:512] = 0  # the second chunk holds no entry
    m = m.tocsr()
    chunks = spmv.build_large_layouts(700, 300, m.indptr, m.indices, m.data,
                                      max_windows=2)
    assert [len(p) for _, p in chunks] == [2, 0, 2]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(300)
                         .astype(np.float32))
    y = spmv.spmv_large(chunks, 300, x)
    assert y.shape == (700,) and not y[256:512].any()
    assert_spmv_close(y.numpy(), m.astype(np.float64) @ x.numpy(), Scipy(m), x.numpy())
    with pytest.raises(ValueError):
        spmv.spmv_large(chunks, 300, x[:299])


def test_routing_follows_the_window_budget(monkeypatch):
    """By default only a matrix the packer cannot take runs the large
    path: past 32767 row windows, or past its column range; a transpose
    is routed on its own shape."""
    w = microblock.LANE
    assert cuda_k._LARGE_WINDOWS == microblock.MAX_RB
    assert not cuda_k._needs_large(microblock.MAX_RB * w, 3)
    assert cuda_k._needs_large(microblock.MAX_RB * w + 1, 3)
    assert not cuda_k._needs_large(3, microblock.MAX_CB * 2 * w)
    assert cuda_k._needs_large(3, microblock.MAX_CB * 2 * w + 1)
    monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", 2)
    assert cuda_k._needs_large(2 * w + 1, 3) and not cuda_k._needs_large(2 * w, 10**6)


def test_large_layouts_dropped_with_the_cache(monkeypatch):
    monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", 2)
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", float("inf"))  # the micro-block route
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER_LARGE", float("inf"))
    m = _matrix()
    c = CSR.from_scipy(m, device="cpu")
    with kernels.use_kernel("cuda"):
        c.mult_vec(np.ones(640, np.float32))
    assert kept(c, "large") is not None
    h = cuda_k.to_handle(c)
    cuda_k.release_handle(h, drop_cache=True)
    assert kept(c, "large") is None and kept(c, "large_t") is None
