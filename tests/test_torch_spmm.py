"""The port's micro-block SpMM against the JAX package's Pallas kernel
(interpret mode, as the JAX tests run it on the CPU) on identical layout
arrays, and both against scipy, under the tolerance of
``tests/test_mult_dense.py`` (rtol 5e-4, atol 1e-4 times the largest
|result|, unchanged)."""

import dataclasses
import pathlib

import numpy as np
import scipy.sparse as sps
import pytest
import torch
import jax.numpy as jnp

from csr_tpu.ops import microblock as ref_mb
from csr_tpu.ops import spmm as ref_spmm
from csr_tpu_torch.ops import _cuda, microblock as mb, spmm

from torch_util import assert_product_close, random_matrix

WINDOW_PAIR = [(w, p) for w in (128, 256) for p in (1, 2, 4)]


def _carried(window, pair, seed, n):
    """A reference layout, the same arrays as a port layout, the matrix
    (its (rb 0, cb 0) group spans two micro-rows) and a dense operand."""
    a = random_matrix(300, 700, 0.03, seed=seed)
    ref = ref_mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                        window=window, pair=pair)
    port = mb.layout_from_arrays(
        np.asarray(ref.vals), np.asarray(ref.meta), np.asarray(ref.rbcb),
        ref.nrows, ref.ncols, ref.nnz, ref.n_microrows, ref.window, ref.pair,
        "cpu",
    )
    b = np.random.default_rng(seed).uniform(-1, 1, (700, n)).astype(np.float32)
    return a, ref, port, b


# the Pallas interpreter takes a few seconds to trace each (window, pair):
# two of the six variants run against it, all six against scipy below
@pytest.mark.parametrize("window,pair", [(128, 2), (256, 1)])
def test_reference_matches_pallas_interpret(window, pair):
    a, ref, port, b = _carried(window, pair, seed=60 + window + pair, n=300)
    c_pallas = np.asarray(ref_spmm.spmm(ref, jnp.asarray(b), interpret=True))
    c_port = spmm.spmm_reference(port, torch.from_numpy(b))
    assert c_port.dtype == torch.float32 and c_port.shape == (300, 300)
    expect = a.astype(np.float64) @ b
    assert_product_close(c_port.numpy(), c_pallas)
    assert_product_close(c_port.numpy(), expect)
    assert_product_close(c_pallas, expect)


@pytest.mark.parametrize("n", [1, 50, 300])
@pytest.mark.parametrize("window,pair", WINDOW_PAIR)
def test_reference_matches_scipy(window, pair, n):
    a, _, port, b = _carried(window, pair, seed=70 + window + pair, n=n)
    c = spmm.spmm_reference(port, torch.from_numpy(b))
    assert c.dtype == torch.float32 and c.shape == (300, n)
    assert_product_close(c.numpy(), a.astype(np.float64) @ b)


def test_reference_casts_operand():
    """B of another dtype is cast to f32 first; the result is f32."""
    a, _, port, b = _carried(128, 1, seed=80, n=7)
    b64 = torch.from_numpy(b.astype(np.float64))
    c = spmm.spmm(port, b64)
    assert c.dtype == torch.float32
    assert torch.equal(c, spmm.spmm_reference(port, torch.from_numpy(b)))
    ci = spmm.spmm(port, torch.ones(700, 3, dtype=torch.int32))
    assert_product_close(ci.numpy(), a.astype(np.float64) @ np.ones((700, 3)))


def test_scatter_rows_chunks_agree(monkeypatch):
    a, _, port, b = _carried(256, 2, seed=81, n=50)
    whole = spmm.spmm_reference(port, torch.from_numpy(b))
    monkeypatch.setattr(spmm, "_CHUNK_ELEMS", 50 * 37)  # 37 entries a chunk
    chunked = spmm.spmm_reference(port, torch.from_numpy(b))
    assert_product_close(chunked.numpy(), whole.numpy())
    assert_product_close(chunked.numpy(), a.astype(np.float64) @ b)


def test_wrapper_on_cpu_runs_plain_version():
    _, _, port, b = _carried(128, 1, seed=82, n=20)
    before = spmm.launches
    bt = torch.from_numpy(b)
    assert torch.equal(spmm.spmm(port, bt), spmm.spmm_reference(port, bt))
    assert spmm.launches == before
    assert "spmm_microblock" not in _cuda._LIBS, "a CPU call built the kernel"


def test_wrapper_rejects_bad_operands():
    _, _, port, b = _carried(128, 1, seed=83, n=4)
    for bad in (b[:-1], b[:, 0], b[None]):
        with pytest.raises(ValueError):
            spmm.spmm(port, torch.from_numpy(np.ascontiguousarray(bad)))
    meta_layout = mb.layout_from_arrays(
        port.vals.numpy(), port.meta.numpy(), port.rbcb.numpy(), port.nrows,
        port.ncols, port.nnz, port.n_microrows, port.window, port.pair, "meta",
    )
    with pytest.raises(ValueError):
        spmm.spmm(meta_layout, torch.zeros(port.ncols, 4, device="meta"))


@pytest.mark.parametrize("window", [128, 256])
def test_padding_reads_no_b(window):
    """Padding slots read no B: an inf in a row of B that only padding
    points to leaves the product finite (a kernel that read B there would
    form 0 * inf)."""
    a = random_matrix(300, 700, 0.03, seed=84).tolil()
    a[:, 0] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    layout = mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                       window=window)
    b = np.random.default_rng(84).uniform(-1, 1, (700, 9)).astype(np.float32)
    b[0] = np.inf
    c = spmm.spmm(layout, torch.from_numpy(b)).numpy()
    assert np.all(np.isfinite(c))
    b[0] = 0.0
    assert_product_close(c, a.astype(np.float64) @ b)


def test_empty_layout_and_zero_width():
    empty = mb.build_microblocks_host(5, 7, np.zeros(6, np.int64),
                                      np.zeros(0, np.int32), None)
    assert torch.equal(spmm.spmm(empty, torch.ones(7, 3)), torch.zeros(5, 3))
    _, _, port, _ = _carried(128, 1, seed=85, n=1)
    assert spmm.spmm(port, torch.ones(700, 0)).shape == (300, 0)


def test_every_source_has_an_entry():
    """Each ``csrc/*.cu`` is a kernel that ``_cuda`` builds and binds."""
    stems = sorted(p.stem for p in pathlib.Path(_cuda.CSRC).glob("*.cu"))
    assert stems == sorted(_cuda.ENTRIES)


# --- the regrouped plain version: the kernel's algorithm on the CPU ---


@pytest.mark.parametrize("n", [1, 50, 300])
@pytest.mark.parametrize("window,pair", WINDOW_PAIR)
def test_regrouped_matches_reference_and_scipy(window, pair, n):
    a, _, port, b = _carried(window, pair, seed=110 + window + pair, n=n)
    c = spmm.spmm_regrouped(port, torch.from_numpy(b))
    assert c.dtype == torch.float32 and c.shape == (300, n)
    assert_product_close(c.numpy(), spmm.spmm_reference(port, torch.from_numpy(b)).numpy())
    assert_product_close(c.numpy(), a.astype(np.float64) @ b)


# all six variants against the Pallas interpreter at the ALS width, two of
# them at the narrowest and at a width of three column tiles as well
@pytest.mark.parametrize(
    "window,pair,n",
    [(w, p, 50) for w, p in WINDOW_PAIR]
    + [(128, 2, 1), (128, 2, 300), (256, 1, 1), (256, 1, 300)])
def test_regrouped_matches_pallas_interpret(window, pair, n):
    a, ref, port, b = _carried(window, pair, seed=120 + window + pair, n=n)
    c_pallas = np.asarray(ref_spmm.spmm(ref, jnp.asarray(b), interpret=True))
    c_port = spmm.spmm_regrouped(port, torch.from_numpy(b))
    assert c_port.dtype == torch.float32 and c_port.shape == (300, n)
    assert_product_close(c_port.numpy(), c_pallas)
    assert_product_close(c_port.numpy(), a.astype(np.float64) @ b)


def _regroup_numpy(layout):
    """Per group: the (offsets, cols, vals) that a count by row and a
    stable sort of the group's real slots by window row give, in numpy."""
    m = layout.n_microrows
    lo, epos = layout.unpack_meta()
    vals, rbcb = layout.vals.numpy(), layout.rbcb.numpy()
    shift = layout.epos_shift
    out = []
    for g0 in range(0, m, mb.ACC_GROUP):
        rows, cols, vs = [], [], []
        for k in range(g0, g0 + mb.ACC_GROUP):
            e = epos[k] & 127
            for s in range(int(e[-1])):  # slots past the count are padding
                rows.append(int(np.searchsorted(e, s, side="right")))
                cols.append(((int(rbcb[k]) & 0xFFFF) << shift) + int(lo[k, s]))
                vs.append(vals[k, s])
        rows = np.asarray(rows, np.int64)
        order = np.argsort(rows, kind="stable")  # micro-row, then slot
        offsets = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=128))])
        out.append((offsets, np.asarray(cols, np.int64)[order],
                    np.asarray(vs, np.float32)[order]))
    return out


@pytest.mark.parametrize("window,pair", WINDOW_PAIR)
def test_regroup_matches_numpy_count(window, pair):
    """Offsets, the order within a row, padding slots left out; the (rb 0,
    cb 0) group's first micro-row is at the 127-entry cap."""
    a, _, port, _ = _carried(window, pair, seed=130 + window + pair, n=1)
    _, epos = port.unpack_meta()
    assert int((epos[: port.n_microrows, -1] & 127).max()) == mb.SLOT_CAP
    offsets, cols, vals = spmm.regroup(port)
    expect = _regroup_numpy(port)
    assert offsets.dtype == torch.int32 and cols.dtype == torch.int32
    assert offsets.shape == (len(expect), 129)
    assert cols.shape == vals.shape == (len(expect), spmm.GROUP_CAP)
    assert int(offsets[:, -1].sum()) == a.nnz
    for g, (off, c, v) in enumerate(expect):
        np.testing.assert_array_equal(offsets[g].numpy(), off)
        count = off[-1]
        np.testing.assert_array_equal(cols[g, :count].numpy(), c)
        np.testing.assert_array_equal(vals[g, :count].numpy(), v)
        assert not cols[g, count:].any() and not vals[g, count:].any()


def test_regroup_all_empty_group():
    """A group of 32 padding micro-rows regroups to no entry and adds
    nothing to the product."""
    a, _, port, b = _carried(128, 1, seed=140, n=9)
    assert port.vals.shape[0] >= port.n_microrows + mb.ACC_GROUP
    longer = mb.MicroBlockLayout(**{**port.__dict__,
                                    "n_microrows": port.n_microrows + mb.ACC_GROUP})
    offsets, cols, vals = spmm.regroup(longer)
    assert offsets.shape[0] == port.n_microrows // mb.ACC_GROUP + 1
    assert not offsets[-1].any() and not cols[-1].any() and not vals[-1].any()
    bt = torch.from_numpy(b)
    assert torch.equal(spmm.spmm_regrouped(longer, bt), spmm.spmm_regrouped(port, bt))
    assert torch.equal(spmm.spmm_reference(longer, bt), spmm.spmm_reference(port, bt))


def test_regrouped_one_row_holds_a_group():
    """Every entry of a 128-row window in one row: 127 empty rows around
    a run longer than a group."""
    rng = np.random.default_rng(141)
    a = sps.lil_matrix((256, 6000), dtype=np.float32)
    a[133, rng.choice(6000, 4500, replace=False)] = rng.uniform(-1, 1, 4500)
    a = a.tocsr()
    layout = mb.build_microblocks_host(256, 6000, a.indptr, a.indices, a.data)
    offsets, _, _ = spmm.regroup(layout)
    assert offsets.shape[0] >= 2 and int(offsets[:, -1].sum()) == 4500
    assert torch.equal(offsets[:, 5], torch.zeros_like(offsets[:, 5]))
    assert torch.equal(offsets[:, 6], offsets[:, -1])  # all in window row 5
    b = rng.uniform(-1, 1, (6000, 7)).astype(np.float32)
    c = spmm.spmm_regrouped(layout, torch.from_numpy(b))
    assert_product_close(c.numpy(), a.astype(np.float64) @ b)


def test_regrouped_chunks_agree(monkeypatch):
    a, _, port, b = _carried(256, 2, seed=142, n=50)
    whole = spmm.spmm_regrouped(port, torch.from_numpy(b))
    monkeypatch.setattr(spmm, "_CHUNK_ELEMS", 1)  # one group a chunk
    chunked = spmm.spmm_regrouped(port, torch.from_numpy(b))
    assert torch.equal(chunked, whole)


def test_wrapper_on_cpu_runs_regrouped_version(monkeypatch):
    _, _, port, b = _carried(128, 1, seed=143, n=5)
    calls = []
    real = spmm.spmm_regrouped
    monkeypatch.setattr(spmm, "spmm_regrouped",
                        lambda *a: calls.append(1) or real(*a))
    bt = torch.from_numpy(b)
    assert torch.equal(spmm.spmm(port, bt), real(port, bt))
    assert calls == [1]


# --- the launch plan ---


def _check_plan(plan, n):
    assert plan.n == n and n <= plan.ldb < n + spmm.VEC and plan.ldb % spmm.VEC == 0
    assert plan.lanes in (8, 16, 32) and plan.tile == plan.lanes * spmm.VEC
    # the tiles cover the padded width exactly once: no tile past it, no
    # empty chunk, every tile in one chunk
    assert (plan.n_tiles - 1) * plan.tile < plan.ldb <= plan.n_tiles * plan.tile
    assert 1 <= plan.chunks <= min(plan.n_tiles, 65535)
    assert (plan.chunks - 1) * plan.tiles_per_chunk < plan.n_tiles
    assert plan.chunks * plan.tiles_per_chunk >= plan.n_tiles
    # a narrow row of B takes no more lanes than the next power of two
    per_row = plan.ldb // spmm.VEC
    assert plan.lanes >= min(per_row, 32)
    assert plan.lanes == 8 or plan.lanes // 2 < per_row


@pytest.mark.parametrize("n", [1, 2, 3, 50, 64, 256, 300, 8192])
def test_launch_plan(n):
    plan = spmm.launch_plan(n, 32768, 32768, 4096)
    _check_plan(plan, n)
    # 16 B a lane always, from a padded copy where n is no multiple of 4
    assert plan.ldb == -(-n // 4) * 4 and plan.copy == (n % 4 != 0)
    assert plan.lanes == {1: 8, 2: 8, 3: 8, 50: 16, 64: 16}.get(n, 32)
    # B's and C's columns of one chunk (enough groups: one chunk in flight)
    slab = 4 * (32768 + 32768) * plan.tile * plan.tiles_per_chunk
    assert slab <= spmm.L2_SLAB_BYTES or plan.tiles_per_chunk == 1


@pytest.mark.parametrize("n,align", [(256, 4), (256, 8), (50, 4), (3, 16)])
def test_launch_plan_misaligned_b(n, align):
    """A B off the 16 B boundary is copied, like one whose rows are no
    multiple of 4 floats; the launch is that of the aligned B."""
    plan = spmm.launch_plan(n, 1000, 3000, 24, align=align)
    _check_plan(plan, n)
    assert plan.copy == (align != 16 or n % 4 != 0)
    aligned = spmm.launch_plan(n, 1000, 3000, 24)
    assert dataclasses.replace(plan, copy=aligned.copy) == aligned


def test_launch_plan_sizes_chunks_to_l2():
    """An 8192-wide B at 8192^2: with groups enough to fill the card one
    chunk is in flight and takes 4 tiles (B's and C's 512 columns, 33.5
    MB); with few groups several chunks run at once and each takes one
    tile.  The second axis of the grid never passes 65535."""
    many = spmm.launch_plan(8192, 8192, 8192, 100_000)
    assert (many.chunks, many.tiles_per_chunk) == (16, 4)
    some = spmm.launch_plan(8192, 8192, 8192, 200)
    assert (some.chunks, some.tiles_per_chunk) == (64, 1)
    few = spmm.launch_plan(8192, 8192, 8192, 4)
    assert (few.chunks, few.tiles_per_chunk) == (64, 1)
    tiny = spmm.launch_plan(8192, 8, 8, 1)  # 660 chunks of 6 tiles fit
    assert (tiny.chunks, tiny.tiles_per_chunk) == (11, 6)
    huge = spmm.launch_plan(128 * 70_000, 1 << 20, 1 << 20, 4)
    _check_plan(huge, 128 * 70_000)
    assert huge.tiles_per_chunk == 2 and huge.chunks == 35_000
    with pytest.raises(ValueError):
        spmm.launch_plan(0, 10, 10, 1)


def test_source_knobs_match_the_plan():
    """What the plan assumes of the kernel's source: 4 columns a lane, a
    block within the card's limit, a group of 127 * 32 entries, one build
    (no conditional compilation), and a C entry that takes the plan's
    lanes and tiles a chunk."""
    import re

    src = (pathlib.Path(_cuda.CSRC) / "spmm_microblock.cu").read_text()
    assert int(re.search(r"constexpr int kVec = (\d+);", src).group(1)) == spmm.VEC
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert 128 <= threads <= 1024 and threads % 128 == 0
    assert spmm.GROUP_CAP == 127 * 32
    assert "constexpr int kMaxEntries = 127 * kAccGroup;" in src
    assert not re.search(r"^\s*#\s*if", src, re.M)
    assert re.search(r"int lanes, int64_t tiles_per_chunk,\s*void\* stream\)", src)
