"""The port's micro-block layouts are byte-equal to the JAX package's
(``csr_tpu.ops.microblock.build_microblocks_host``), on the native packer
and on the numpy path, for every (window, pair)."""

import numpy as np
import pytest
import scipy.sparse as sps

from csr_tpu.ops import microblock as ref_mb
from csr_tpu_torch import CSR, native
from csr_tpu_torch.ops import microblock as mb

from torch_util import random_matrix

WINDOW_PAIR = [(w, p) for w in (128, 256) for p in (1, 2, 4)]


def _cases():
    """(name, nrows, ncols, rowptrs, colinds, values) host CSR cases."""
    big = random_matrix(300, 700, 0.03, seed=1)
    one = sps.csr_matrix(np.array([[2.5]], np.float32))
    rnd = random_matrix(1024, 1000, 0.01, seed=2, big_group=False)
    return [
        ("empty", 5, 7, np.zeros(6, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32)),
        ("1x1", 1, 1, one.indptr, one.indices, one.data),
        ("big-group", 300, 700, big.indptr, big.indices, big.data),
        ("structure-only", 300, 700, big.indptr, big.indices, None),
        ("random-1024", 1024, 1000, rnd.indptr, rnd.indices, rnd.data),
    ]


def _assert_same(port, ref, case=""):
    assert port.n_microrows == ref.n_microrows, case
    assert (port.window, port.pair, port.nnz) == (ref.window, ref.pair, ref.nnz), case
    assert port.meta.dtype.itemsize == 2 and port.nbytes == ref.nbytes, case
    for name in ("vals", "meta", "rbcb"):
        a = getattr(port, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, (case, name)
        assert a.tobytes() == b.tobytes(), (case, name)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("window,pair", WINDOW_PAIR)
def test_layout_bytes_match_reference(window, pair, path, monkeypatch):
    if path == "native":
        assert native.available(), "g++ build of csr_host.cpp failed"
    else:
        monkeypatch.setattr(native, "build_microblocks", lambda *a, **k: None)
    for name, nrows, ncols, rp, cols, vals in _cases():
        port = mb.build_microblocks_host(nrows, ncols, rp, cols, vals,
                                         window=window, pair=pair)
        ref = ref_mb.build_microblocks_host(nrows, ncols, rp, cols, vals,
                                            window=window, pair=pair)
        _assert_same(port, ref, name)


@pytest.mark.parametrize("density", [0.002, 0.02, 0.2])
def test_default_layout_matches_reference(density):
    """The cost model (TPU-measured STEP_COST, unchanged) picks the same
    (window, pair) in both packages, and the default builds agree."""
    a = random_matrix(512, 640, density, seed=3, big_group=False)
    args = (512, 640, a.indptr, a.indices, a.data)
    assert mb.choose_layout(a.indptr, a.indices, 640) == ref_mb.choose_layout(
        a.indptr, a.indices, 640)
    for window, pair in WINDOW_PAIR:
        assert mb.estimate_microrows(a.indptr, a.indices, window, 640, pair) == \
            ref_mb.estimate_microrows(a.indptr, a.indices, window, 640, pair)
    ref = ref_mb.build_microblocks_host(*args)
    _assert_same(mb.build_microblocks_host(*args), ref)
    _assert_same(mb.build_microblocks(CSR.from_scipy(a)), ref)


def test_layout_from_arrays_carries_reference_layout():
    a = random_matrix(300, 700, 0.03, seed=4)
    ref = ref_mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                        window=256, pair=2)
    port = mb.layout_from_arrays(
        np.asarray(ref.vals), np.asarray(ref.meta), np.asarray(ref.rbcb),
        ref.nrows, ref.ncols, ref.nnz, ref.n_microrows, ref.window, ref.pair,
        "cpu",
    )
    _assert_same(port, ref)
    assert (port.rb_count, port.cb_count, port.fill) == (
        ref.rb_count, ref.cb_count, ref.fill)
    lo, epos = port.unpack_meta()
    rlo, repos = ref.unpack_meta()
    assert np.array_equal(lo, rlo) and np.array_equal(epos, repos)


def test_packing_range():
    """Outside the rbcb packing range the build returns None; a matrix
    that fits only 256-wide windows is packed 256 wide."""
    rp = np.array([0, 1, 1], np.int64)
    cols = np.array([0], np.int32)
    too_wide = 65535 * 256 + 1
    assert mb.build_microblocks_host(2, too_wide, rp, cols, None) is None
    tall = np.zeros(32767 * 128 + 2, np.int64)
    tall[1:] = 1
    assert mb.build_microblocks_host(len(tall) - 1, 4, tall, cols, None) is None
    wide256 = 65535 * 256
    assert not mb.in_range(2, wide256, 128) and mb.in_range(2, wide256, 256)
    layout = mb.build_microblocks_host(2, wide256, rp, cols, None)
    assert layout.window == 256 and layout.n_microrows == mb.ACC_GROUP
