"""The port's micro-block layouts are byte-equal to the JAX package's
(``csr_tpu.ops.microblock.build_microblocks_host``), on the native packer
and on the numpy path, for every (window, pair); the port's layout
chooser picks (256, 1) wherever it packs."""

import numpy as np
import pytest
import scipy.sparse as sps
from hypothesis import HealthCheck, given, settings

from csr_tpu.ops import microblock as ref_mb
from csr_tpu_torch import CSR, native
from csr_tpu_torch import test_utils as tu
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
    """The port's default build is the JAX package's build at the (window,
    pair) the port chooses, byte for byte, and both packages count the
    micro-rows of all six variants alike."""
    a = random_matrix(512, 640, density, seed=3, big_group=False)
    args = (512, 640, a.indptr, a.indices, a.data)
    window, pair = mb.choose_layout(a.indptr, a.indices, 640)
    for w, p in WINDOW_PAIR:
        assert mb.estimate_microrows(a.indptr, a.indices, w, 640, p) == \
            ref_mb.estimate_microrows(a.indptr, a.indices, w, 640, p)
    ref = ref_mb.build_microblocks_host(*args, window=window, pair=pair)
    _assert_same(mb.build_microblocks_host(*args), ref)
    _assert_same(mb.build_microblocks(CSR.from_scipy(a)), ref)


@pytest.mark.parametrize("density", [0.002, 0.02, 0.2])
def test_choose_window_is_the_chosen_window(density):
    a = random_matrix(512, 640, density, seed=3, big_group=False)
    window, _ = mb.choose_layout(a.indptr, a.indices, 640)
    assert mb.choose_window(a.indptr, a.indices, 640) == window
    assert mb.choose_window(a.indptr, a.indices) == window
    assert mb.build_microblocks_host(512, 640, a.indptr, a.indices,
                                     a.data).window == window


def _microrows(rp, cols, ncols):
    return {(w, p): mb.estimate_microrows(rp, cols, w, ncols, p)
            for w, p in WINDOW_PAIR}


@pytest.mark.parametrize("density", [0.002, 0.02, 0.2])
def test_chooser_picks_the_fewest_microrows(density):
    """(256, 1) at three densities, and no variant has fewer micro-rows."""
    a = random_matrix(1024, 1000, density, seed=5)
    assert mb.choose_layout(a.indptr, a.indices, 1000) == (256, 1)
    m = _microrows(a.indptr, a.indices, 1000)
    assert m[256, 1] == min(m.values())


def test_chooser_past_the_packing_range():
    """Past the 128-wide windows' range the pick is (256, 1); past the
    256-wide windows' range (128, 1), and the build gives no layout."""
    rp = np.array([0, 1, 1], np.int64)
    cols = np.array([5], np.int32)
    wide256 = 65535 * 256
    assert not mb.in_range(2, wide256, 128)
    assert mb.choose_layout(rp, cols, wide256) == (256, 1)
    too_wide = wide256 + 1
    assert mb.choose_layout(rp, cols, too_wide) == (128, 1)
    assert mb.build_microblocks_host(2, too_wide, rp, cols, None) is None


def test_chooser_on_an_empty_matrix():
    rp, cols = np.zeros(6, np.int64), np.zeros(0, np.int32)
    assert mb.choose_layout(rp, cols, 7) == (128, 1)
    assert mb.choose_window(rp, cols) == 128
    lay = mb.build_microblocks_host(5, 7, rp, cols, None)
    assert (lay.window, lay.pair, lay.n_microrows) == (128, 1, 0)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(tu.csrs())
def test_chooser_never_more_microrows_than_128_1(csr):
    """On any drawn matrix the pick has no more micro-rows than (128, 1)
    (none of the six has fewer), and the default build is the pick."""
    rp, cis, _ = csr.host_arrays()
    pick = mb.choose_layout(rp, cis, csr.ncols)
    built = mb.build_microblocks(csr)
    assert (built.window, built.pair) == pick
    if csr.nnz:
        m = _microrows(rp, cis, csr.ncols)
        assert m[pick] == built.n_microrows == min(m.values()) <= m[128, 1]


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
