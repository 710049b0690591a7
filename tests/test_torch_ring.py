"""The port's ring SpMV against the JAX package's, on the CPU: stacked
layouts byte for byte, the plain version of the bucket-selecting kernel
against ``_spmv_call_bucket`` in interpret mode, and both ring schedules
(micro-block and portable) in the mesh's local form against the JAX ones
on 8 virtual devices and against scipy.  Micro-block products are held
to ``assert_spmv_close`` (eps_mult 384, unchanged); the portable ring to
``tests/test_distributed.py``'s rtol 1e-4, atol 1e-3."""

import functools

import numpy as np
import pytest
import scipy.sparse as sps
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings
import hypothesis.strategies as st

from csr_tpu.ops import spmv as ref_spmv
from csr_tpu.parallel import dist as ref_dist
from csr_tpu.parallel import mb_ring as ref_mb_ring
from csr_tpu.parallel import ring as ref_ring
from csr_tpu.parallel.partition import make_mesh as ref_make_mesh
from csr_tpu.test_utils import csrs
from csr_tpu_torch.ops import _cuda, microblock as mb, spmv
from csr_tpu_torch.parallel import dist, mb_ring, ring
from csr_tpu_torch.parallel.partition import make_mesh
from csr_tpu_torch.utils.serialization import parallel_from_arrays

from torch_util import (Scipy, assert_same_partition, both_csr, fields_of,
                        port_chooser, random_matrix)
from util import assert_spmv_close

RING_TENSORS = ("vals", "meta", "rbcb")


def _matrix_900():
    rng = np.random.default_rng(11)
    m = sps.random(900, 1100, 0.04, format="csr", random_state=rng,
                   dtype=np.float32)
    return m, rng.standard_normal(1100).astype(np.float32)


@pytest.mark.parametrize("window", [None, 128, 256])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_ring_layouts_byte_equal(n_shards, window, monkeypatch):
    port_chooser(monkeypatch)
    a = random_matrix(520, 1300, 0.03, seed=n_shards)
    ref_csr, csr = both_csr(a)
    ref = ref_mb_ring.partition_ring_mb(ref_csr, n_shards, window=window)
    port = mb_ring.partition_ring_mb(csr, n_shards, window=window)
    assert_same_partition(port, ref, RING_TENSORS)
    # the port's own group counts are what the carried arrays derive
    carried = parallel_from_arrays(mb_ring.RingMicroBlock, fields_of(ref))
    assert_same_partition(carried, ref, RING_TENSORS)
    assert torch.equal(carried.groups, port.groups)
    assert carried.n_groups == port.n_groups == int(port.groups.max())
    assert 0.0 <= port.padding_share < 1.0


def test_real_microrows_counts_whole_groups():
    a = random_matrix(300, 700, 0.03, seed=3)
    for window in (128, 256):
        lay = mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                        window=window, device="cpu")
        got = mb.real_microrows(lay.meta.numpy(), window)
        assert got == lay.n_microrows and got % mb.ACC_GROUP == 0
    empty = np.zeros((2, 3, 64, 128), np.uint16)
    assert mb.real_microrows(empty, 128).tolist() == [[0] * 3] * 2


def _bucket_case():
    """A 4-shard ring with empty buckets: the lower half of the rows is
    dense in the first 128 columns and empty elsewhere, so the row shards
    there have entries in one column shard only."""
    top = random_matrix(300, 1024, 0.04, seed=21)
    low = sps.hstack([random_matrix(300, 128, 0.5, seed=22, big_group=False),
                      sps.csr_matrix((300, 896), dtype=np.float32)])
    a = sps.vstack([top, low]).tocsr()
    ref_csr, _ = both_csr(a)
    ref = ref_mb_ring.partition_ring_mb(ref_csr, 4, window=128)
    port = parallel_from_arrays(mb_ring.RingMicroBlock, fields_of(ref))
    return ref, port


def test_bucket_reference_matches_pallas_interpret():
    """Every ``held`` of one row shard, an empty bucket included, through
    ``_spmv_call_bucket`` (interpret mode) and ``spmv_bucket_reference``
    on the same stacked arrays."""
    ref, port = _bucket_case()
    d = int(np.argmin(port.groups.numpy().min(1)))
    assert port.groups[d].min() == 0, "no empty bucket in the case"
    rb, cb, m_pad = ref.rb_count, ref.cb_count, ref.vals.shape[2]
    rows, cols = ref.rows_per_shard, ref.cols_per_shard
    x = np.random.default_rng(5).uniform(-1, 1, cols).astype(np.float32)
    xp = np.zeros(cb * 128, np.float32)
    xp[:cols] = x
    stack = port.stack
    one = mb.BucketStack(rows, cols, port.window, stack.vals[d : d + 1],
                         stack.meta[d : d + 1], stack.rbcb[d : d + 1],
                         stack.groups[d : d + 1], stack.n_groups)
    before = spmv.bucket_launches
    for held in range(4):
        y_ref = np.asarray(ref_spmv._spmv_call_bucket(
            ref.vals[d], ref.meta[d], ref.rbcb[d], jnp.asarray(xp).reshape(cb, 128),
            jnp.asarray([held], jnp.int32), m_pad, rb, cb, True,
            wb=ref.window // 128, pair=ref.pair)).reshape(-1)[:rows]
        y0 = np.random.default_rng(held).uniform(-1, 1, rows).astype(np.float32)
        y = spmv.spmv_bucket(one, torch.tensor([held], dtype=torch.int32),
                             torch.from_numpy(x)[None], torch.from_numpy(y0.copy())[None])
        lay = mb.MicroBlockLayout(rows, cols, 0, m_pad, port.vals[d, held],
                                  port.meta[d, held], port.rbcb[d, held],
                                  port.window)
        dense = _dense_of(lay)
        assert_spmv_close(y[0].numpy() - y0, y_ref, Scipy(dense), x)
        assert_spmv_close(y[0].numpy() - y0, dense.astype(np.float64) @ x,
                          Scipy(dense), x)
        if port.groups[d, held] == 0:
            assert np.array_equal(y[0].numpy(), y0) and not y_ref.any()
    assert spmv.bucket_launches == before, "a CPU call counted a launch"
    assert "spmv_bucket" not in _cuda._LIBS, "a CPU call built the kernel"


def _dense_of(lay):
    """The matrix a micro-block layout holds, as scipy CSR, from its
    arrays alone."""
    lo, epos = lay.unpack_meta()
    rbcb = lay.rbcb.numpy()
    vals = lay.vals.numpy()
    slot = np.arange(128)
    # the window row of slot s is the count of rows whose epos <= s
    row_in = (epos[:, None, :] <= slot[None, :, None]).sum(-1)
    real = slot[None, :] < epos[:, -1:]
    rows = ((rbcb >> 16)[:, None] * 128 + row_in)[real]
    cols = ((rbcb & 0xFFFF)[:, None] * lay.window + lo)[real]
    return sps.csr_matrix((vals[real], (rows, cols)),
                          shape=(lay.nrows, lay.ncols))


def test_bucket_wrapper_rejects_bad_operands():
    _, port = _bucket_case()
    stack = port.stack
    L, rows, cols = 4, port.rows_per_shard, port.cols_per_shard
    held = torch.zeros(L, dtype=torch.int32)
    x, y = torch.zeros(L, cols), torch.zeros(L, rows)
    spmv.spmv_bucket(stack, held, x, y)
    for bad in ((held.long(), x, y), (held[:2], x, y), (held, x[:, :-1], y),
                (held, x.double(), y), (held, x, y[:, :-1]),
                (held, x, torch.zeros(rows, L).T)):
        with pytest.raises(ValueError):
            spmv.spmv_bucket(stack, *bad)
    # a held index outside the stack's buckets adds nothing, as in the kernel
    out = spmv.spmv_bucket(stack, torch.tensor([4, -1, 9, 7], dtype=torch.int32),
                           torch.ones(L, cols), torch.zeros(L, rows))
    assert not out.any()


@functools.lru_cache(maxsize=None)
def _bucket_stack():
    stack = _bucket_case()[1].stack
    assert (stack.groups == 0).any() and stack.n_layers == stack.n_buckets == 4
    return stack


@pytest.mark.parametrize("held", [(0, 1, 2, 3), (3, 0, 1, 2), (4, -1, 2, 0),
                                  (9, -3, 4, 7)])
@pytest.mark.parametrize("grid", [1, 3, 1000])
def test_bucket_work_takes_each_real_microrow_once(grid, held):
    """The blocks' micro-rows are those of the real groups of the held
    buckets (none of an empty bucket or of an index outside the stack),
    each once, listed layer by layer and dealt out to the warps in
    contiguous shares of ceil(micro-rows / warps), a block's warps in
    turn."""
    stack = _bucket_stack()
    work = spmv.bucket_work(stack, torch.tensor(held, dtype=torch.int32), grid)
    assert len(work) == grid
    groups = stack.groups.tolist()
    real = [(l, r) for l, h in enumerate(held) if 0 <= h < 4
            for r in range(groups[l][h] * mb.ACC_GROUP)]
    taken = [row for rows in work for row in rows]
    assert sorted(taken) == real and len(set(taken)) == len(taken)
    warps = grid * spmv.WARPS_PER_BLOCK
    block = -(-len(real) // warps) * spmv.WARPS_PER_BLOCK
    for b, rows in enumerate(work):
        assert rows == real[b * block:(b + 1) * block]
    # every block but the last ones busy takes a whole share
    sizes = [len(rows) for rows in work]
    assert sizes == sorted(sizes, reverse=True) and max(sizes) == min(block, len(real))


def test_bucket_grid_fills_the_card_and_caps_at_the_stack():
    stack = _bucket_stack()
    cap = stack.n_layers * stack.n_groups
    assert spmv.bucket_grid(stack, 132) == min(spmv.BLOCKS_PER_SM * 132, cap)
    assert spmv.bucket_grid(stack, 1) == min(spmv.BLOCKS_PER_SM, cap)
    # the cap is never below the groups a held vector can give
    for held in range(4):
        h = torch.full((4,), held, dtype=torch.int32)
        work = spmv.bucket_work(stack, h, cap)
        assert sum(map(len, work)) <= cap * mb.ACC_GROUP


def test_stack_checks_for_the_card():
    """What the bucket kernel cannot take raises before a launch: more
    layers than a warp has lanes, metadata off a 16 B boundary, 2^31
    micro-rows or more."""
    stack = _bucket_stack()
    mb.check_stack_on_card(stack)
    n = mb.MAX_LAYERS + 1
    wide = mb.BucketStack(128, 128, 128, torch.zeros(n, 1, 32, 128),
                          torch.zeros(n, 1, 32, 128, dtype=torch.uint16),
                          torch.zeros(n, 1, 32, dtype=torch.int32),
                          torch.zeros(n, 1, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="layers"):
        mb.check_stack_on_card(wide)
    shifted = torch.zeros(stack.meta.numel() + 4, dtype=torch.uint16)
    meta = shifted[4:].view(stack.meta.shape)
    assert meta.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16 B"):
        mb.check_stack_on_card(mb.BucketStack(
            stack.nrows, stack.ncols, stack.window, stack.vals, meta,
            stack.rbcb, stack.groups, stack.n_groups))
    # the kernel counts micro-rows in 32 bits (tensors with no storage)
    big = (1, 1, 2 ** 31)
    with pytest.raises(ValueError, match="32 bits"):
        mb.check_stack_on_card(mb.BucketStack(
            128, 128, 128, torch.empty(*big, 128, device="meta"),
            torch.empty(*big, 128, dtype=torch.uint16, device="meta"),
            torch.empty(big, dtype=torch.int32, device="meta"),
            torch.empty(1, 1, dtype=torch.int32, device="meta"), 0))


def _ring_both(a, x, n_shards, structure_only=False):
    """The ring product of ``a @ x`` by the JAX package (interpret mode on
    virtual devices), by the port on its own partition and by the port on
    the JAX package's partition, each as the global vector."""
    ref_csr, csr = both_csr(a, structure_only)
    ref_mesh = ref_make_mesh(n_shards)
    ref = ref_mb_ring.partition_ring_mb(ref_csr, n_shards)
    ref_sharded = ref.shard(ref_mesh)
    y_ref = np.asarray(ref_mb_ring.collect_rows(ref_sharded, ref_mb_ring.spmv_ring_mb(
        ref_sharded, ref_mb_ring.scatter_x(ref_sharded, x, ref_mesh), ref_mesh,
        interpret=True)))
    mesh = make_mesh(n_shards, device="cpu")
    outs = []
    for rmb in (mb_ring.partition_ring_mb(csr, n_shards),
                parallel_from_arrays(mb_ring.RingMicroBlock, fields_of(ref))):
        rmb = rmb.shard(mesh)
        y = mb_ring.spmv_ring_mb(rmb, mb_ring.scatter_x(rmb, x, mesh), mesh)
        assert y.shape == (n_shards, rmb.rows_per_shard)
        outs.append(mb_ring.collect_rows(rmb, y).numpy())
    return y_ref, outs


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("case", ["900x1100", "structure-only", "nnz-0"])
def test_ring_mb_matches_reference_and_scipy(case):
    a, x = _matrix_900()
    n_shards = 8
    if case == "nnz-0":
        a, n_shards = sps.csr_matrix((70, 50), dtype=np.float32), 4
        x = x[:50]
    structure_only = case == "structure-only"
    y_ref, outs = _ring_both(a, x, n_shards, structure_only)
    if structure_only:
        a = sps.csr_matrix((np.ones(a.nnz, np.float32), a.indices, a.indptr),
                           shape=a.shape)
    expect = a.astype(np.float64) @ x
    for y in outs:
        assert y.shape == (a.shape[0],) and y.dtype == np.float32
        assert_spmv_close(y, y_ref, Scipy(a), x)
        assert_spmv_close(y, expect, Scipy(a), x)
        np.testing.assert_allclose(y, expect, rtol=1e-4, atol=1e-3)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
@given(st.data())
@settings(max_examples=4, deadline=None)
def test_ring_mb_property(data):
    """Hypothesis draws (structure-only matrices included), 4 shards."""
    ref_csr = data.draw(csrs(nrows=st.integers(8, 60)))
    x = np.asarray(data.draw(st.lists(
        st.floats(-10, 10, allow_nan=False, width=32),
        min_size=ref_csr.ncols, max_size=ref_csr.ncols)), np.float32)
    a = ref_csr.to_scipy().astype(np.float32)
    y_ref, outs = _ring_both(a, x, 4, structure_only=ref_csr.values is None)
    expect = a.astype(np.float64) @ x
    for y in outs:
        assert_spmv_close(y, y_ref, ref_csr, x)
        assert_spmv_close(y, expect, ref_csr, x)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_ring_mb_odd_shard_counts(n_shards):
    """``D`` = 1 (no rotate at all) and a ``D`` that divides nothing."""
    a, x = _matrix_900()
    _, csr = both_csr(a)
    mesh = make_mesh(n_shards, device="cpu")
    rmb = mb_ring.partition_ring_mb(csr, n_shards).shard(mesh)
    y = mb_ring.spmv_ring_mb(rmb, mb_ring.scatter_x(rmb, x, mesh), mesh)
    assert_spmv_close(mb_ring.collect_rows(rmb, y).numpy(),
                      a.astype(np.float64) @ x, Scipy(a), x)


def test_ring_mb_needs_sharded_layouts():
    a, x = _matrix_900()
    _, csr = both_csr(a)
    rmb = mb_ring.partition_ring_mb(csr, 4)
    with pytest.raises(ValueError, match="shard"):
        mb_ring.spmv_ring_mb(rmb, torch.zeros(2, rmb.cols_per_shard),
                             make_mesh(2, device="cpu"))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("case", ["160x120", "structure-only"])
def test_portable_ring_matches_reference_and_scipy(case):
    rng = np.random.default_rng(11)
    a = sps.random(160, 120, 0.1, format="csr", random_state=rng,
                   dtype=np.float32)
    x = rng.standard_normal(120).astype(np.float32)
    structure_only = case == "structure-only"
    ref_csr, csr = both_csr(a, structure_only)
    ref_mesh, mesh = ref_make_mesh(8), make_mesh(8, device="cpu")
    ref = ref_ring.partition_ring(ref_csr, 8)
    port = ring.partition_ring(csr, 8)
    assert_same_partition(port, ref, ring.RingCSR.TENSORS)
    ref = ref.shard(ref_mesh)
    y_ref = np.asarray(ref_dist.collect_rows(ref, ref_ring.spmv_ring(
        ref, ref_ring.scatter_x(ref, x, ref_mesh), ref_mesh)))
    if structure_only:
        a = sps.csr_matrix((np.ones(a.nnz, np.float32), a.indices, a.indptr),
                           shape=a.shape)
    for r in (port, parallel_from_arrays(ring.RingCSR, fields_of(ref))):
        r = r.shard(mesh)
        xs = ring.scatter_x(r, x, mesh)
        assert xs.shape == (8 * r.cols_per_shard,)
        y = dist.collect_rows(r, ring.spmv_ring(r, xs, mesh)).numpy()
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(y, a @ x, rtol=1e-4, atol=1e-3)
