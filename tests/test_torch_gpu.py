"""The CUDA kernel on the card: each test needs a CUDA device and skips
without one.  This file imports neither jax nor csr_tpu, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from csr_tpu_torch import CSR
from csr_tpu_torch.harness import spmv_share
from csr_tpu_torch.kernels import use_kernel
from csr_tpu_torch.ops import microblock as mb, spmm, spmv
from csr_tpu_torch.parallel import dist, mb_dist, mb_ring, ring
from csr_tpu_torch.parallel.partition import make_mesh, partition_rows

from torch_util import (Scipy, assert_product_close, cuda_device,  # noqa: F401
                        kept,
                        random_matrix)
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


@pytest.mark.parametrize("window", [128, 256])
def test_short_rows_after_heavy_ones_on_card(window, cuda_device):
    """A row of one small entry packed after heavy rows in its micro-row
    reads its own product to f32 rounding: its part is the segmented sum
    of its own slots.  Taken as the difference of two f32 prefixes of the
    micro-row, it carried the rounding of the heavy rows' sum (about 6e-3
    of such a row here, 2e-5 at MovieLens-25M's converged Lanczos
    vector)."""
    n = 256
    rng = np.random.default_rng(window)
    heavy = [rng.choice(n, 60, replace=False) for _ in range(0, n, 2)]
    light = rng.integers(0, n, n // 2)
    rows = np.concatenate([np.full(60, r) for r in range(0, n, 2)] + [np.arange(1, n, 2)])
    cols = np.concatenate(heavy + [light])
    vals = np.where(rows % 2 == 0, 1e3, 1.0).astype(np.float32)
    a = sps.csr_matrix((vals, (rows, cols)), shape=(n, n))
    layout = mb.build_microblocks_host(n, n, a.indptr, a.indices, a.data,
                                       window=window, pair=1, device=cuda_device)
    x = rng.uniform(0.5, 1.0, n).astype(np.float32)
    y = spmv.spmv(layout, torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    a64, x64 = a.astype(np.float64), x.astype(np.float64)
    gap = np.abs(y - a64 @ x64) / (abs(a64) @ np.abs(x64))
    assert gap.max() < 1e-6, (gap.argmax(), gap.max())


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


def _spmm_case(window, pair, seed, cuda_device):
    """A layout on the card whose (rb 0, cb 0) group holds 226 entries (its
    first micro-row at the 127-entry cap) and whose column 0 is empty:
    row 0 of B is read by padding slots only."""
    a = random_matrix(300, 700, 0.03, seed=seed).tolil()
    a[:, 0] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    layout = mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                       window=window, pair=pair,
                                       device=cuda_device)
    return a, layout


def _check_spmm_on_card(a, layout, b, bd=None):
    """One launch, held against both plain versions and scipy (rows of B
    that hold inf count as zero: no entry reads them)."""
    if bd is None:
        bd = torch.from_numpy(b).to(layout.device)
    before = spmm.launches
    c = spmm.spmm(layout, bd)
    torch.cuda.synchronize()
    assert spmm.launches == before + 1
    assert c.shape == (layout.nrows, b.shape[1]) and c.dtype == torch.float32
    c = c.cpu().numpy()
    assert np.all(np.isfinite(c))
    assert_product_close(c, spmm.spmm_reference(layout, bd).cpu().numpy())
    assert_product_close(c, spmm.spmm_regrouped(layout, bd).cpu().numpy())
    assert_product_close(c, a.astype(np.float64) @ np.where(np.isfinite(b), b, 0.0))


# 8, 16 and 32 lanes a row of B; padded copies at 1, 3 and 50; one, three
# and nine column tiles
@pytest.mark.parametrize("n", [1, 3, 50, 64, 256, 300, 1100])
@pytest.mark.parametrize("window,pair", WINDOW_PAIR)
def test_spmm_kernel_matches_reference_on_card(window, pair, n, cuda_device):
    """All six variants at every width; row 0 of B is inf and no entry
    reads it, so only a read from a padding slot could make the result
    non-finite."""
    a, layout = _spmm_case(window, pair, 90 + window + pair, cuda_device)
    b = np.random.default_rng(window + pair + n).uniform(-1, 1, (700, n))
    b = b.astype(np.float32)
    b[0] = np.inf
    _check_spmm_on_card(a, layout, b)


@pytest.mark.parametrize("n", [3, 50, 64])
def test_spmm_misaligned_and_split_on_card(n, cuda_device, monkeypatch):
    """B one float off a 16 B boundary (the wrapper copies it), and the
    nine column tiles of a wide B in chunks of 5, 3 and 2 (the slab that
    the plan sizes its chunks to is set so)."""
    a, layout = _spmm_case(256, 1, 97, cuda_device)
    b = np.random.default_rng(n).uniform(-1, 1, (700, n)).astype(np.float32)
    b[0] = np.inf
    buf = torch.empty(700 * n + 1, device=cuda_device)
    bd = buf[1:].view(700, n).copy_(torch.from_numpy(b))
    assert bd.data_ptr() % 16 == 4
    _check_spmm_on_card(a, layout, b, bd=bd)
    wide = np.random.default_rng(n + 1).uniform(-1, 1, (700, 1100)).astype(np.float32)
    n_groups = layout.n_microrows // mb.ACC_GROUP
    per_chunk = {3: 5, 50: 3, 64: 2}[n]
    in_flight = -(-spmm.BLOCKS_IN_FLIGHT // n_groups)
    monkeypatch.setattr(spmm, "L2_SLAB_BYTES",
                        per_chunk * in_flight * 4 * (300 + 700) * 128)
    plan = spmm.launch_plan(1100, 300, 700, n_groups)
    assert (plan.n_tiles, plan.tiles_per_chunk) == (9, per_chunk)
    _check_spmm_on_card(a, layout, wide)


def test_spmm_repeatable_on_card(cuda_device):
    """Run to run.  A matrix whose every 128-row window fits one group of
    32 micro-rows repeats bit for bit: the order of sums within a group is
    fixed.  Where a window spans several groups their atomic adds into C
    come in an order that varies, so the result is held to the tolerance
    only."""
    small = random_matrix(300, 700, 0.03, seed=98)
    layout = mb.build_microblocks_host(300, 700, small.indptr, small.indices,
                                       small.data, device=cuda_device)
    rb = (layout.rbcb[: layout.n_microrows] >> 16).cpu().numpy()
    assert np.bincount(rb).max() <= mb.ACC_GROUP, "a window spans two groups"
    b = torch.rand(700, 50, device=cuda_device)
    first = spmm.spmm(layout, b)
    for _ in range(5):
        assert torch.equal(spmm.spmm(layout, b), first)

    big = random_matrix(300, 6000, 0.2, seed=99)
    layout = mb.build_microblocks_host(300, 6000, big.indptr, big.indices,
                                       big.data, device=cuda_device)
    rb = (layout.rbcb[: layout.n_microrows] >> 16).cpu().numpy()
    assert np.bincount(rb).max() > mb.ACC_GROUP
    b = torch.rand(6000, 50, device=cuda_device)
    first = spmm.spmm(layout, b).cpu().numpy()
    for _ in range(5):
        assert_product_close(spmm.spmm(layout, b).cpu().numpy(), first)


def test_spmm_wrapper_rejects_bad_operands_on_card(cuda_device):
    a = random_matrix(300, 700, 0.03, seed=51)
    layout = mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                       device=cuda_device)
    b = torch.ones(700, 8, device=cuda_device)
    for bad in (b.cpu(), b[:-1], b[:, 0]):
        with pytest.raises(ValueError):
            spmm.spmm(layout, bad)
    for field, bad in (("vals", layout.vals.double()),
                       ("meta", layout.meta.to(torch.int32)),
                       ("rbcb", layout.rbcb[::2])):
        broken = mb.MicroBlockLayout(**{**layout.__dict__, field: bad})
        with pytest.raises(ValueError):
            spmm.spmm(broken, b)
    # a transposed (non-contiguous) B is made contiguous, not misread
    bt = torch.rand(8, 700, device=cuda_device).T
    assert_product_close(spmm.spmm(layout, bt).cpu().numpy(),
                         a.astype(np.float64) @ bt.cpu().numpy())


def test_spmm_slice_on_card(cuda_device, monkeypatch):
    from csr_tpu_torch.kernels import cuda as cuda_k

    monkeypatch.setattr(cuda_k, "_DENSIFY_CROSSOVER", ((1, 1.1),))  # the kernel route
    # the micro-block kernel route: this small layout is mostly padding
    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, float("inf")),))
    a = random_matrix(260, 390, 0.04, seed=5)
    m = random_matrix(390, 200, 0.05, seed=16, big_group=False)
    c = CSR.from_scipy(a, device=cuda_device)
    b = np.random.default_rng(15).uniform(-1, 1, (390, 50)).astype(np.float32)
    before = spmm.launches
    with use_kernel("cuda"):
        d = c.mult_dense(torch.from_numpy(b).to(cuda_device))
        p = c.multiply(CSR.from_scipy(m, device=cuda_device))
        pt = c.multiply(CSR.from_scipy(m.T.tocsr(), device=cuda_device),
                        transpose=True)
    assert spmm.launches == before + 3
    assert d.device.type == p.device.type == pt.device.type == "cuda"
    a64 = a.astype(np.float64)
    assert_product_close(d.cpu().numpy(), a64 @ b)
    assert_product_close(p.to_scipy().toarray(), (a64 @ m).toarray())
    assert_product_close(pt.to_scipy().toarray(), (a64 @ m).toarray())


def test_slice_on_card(cuda_device):
    a = random_matrix(260, 390, 0.04, seed=5)
    c = CSR(260, 390, a.nnz, a.indptr, a.indices, a.data, device=cuda_device)
    x = np.random.default_rng(13).uniform(-1, 1, 390).astype(np.float32)
    xt = np.random.default_rng(14).uniform(-1, 1, 260).astype(np.float32)
    before = spmv.launches + spmv.csr_launches
    with use_kernel("cuda"):
        y = c.mult_vec(torch.from_numpy(x).to(cuda_device))
        yt = c.mult_vec_t(torch.from_numpy(xt).to(cuda_device))
        y64 = c.mult_vec(torch.from_numpy(x).double().to(cuda_device))
    # one launch of the routed kernel each; f64 routes to the torch backend
    assert spmv.launches + spmv.csr_launches == before + 2
    assert y.device.type == yt.device.type == "cuda" and y64.dtype == torch.float64
    a64 = a.astype(np.float64)
    assert_spmv_close(y.cpu().numpy(), a64 @ x, c, x)
    assert_spmv_close(yt.cpu().numpy(), a64.T @ xt, Scipy(a.T.tocsr()), xt)
    assert_spmv_close(y64.cpu().numpy(), a64 @ x, c, x)


def test_default_device_is_the_card(cuda_device):
    """A matrix built from numpy or scipy data with no device named lies
    on the card, and so does a mesh; tensors keep their own device."""
    a = random_matrix(60, 80, 0.1, seed=1, big_group=False)
    assert CSR.from_scipy(a).device.type == "cuda"
    assert CSR(60, 80, a.nnz, a.indptr, a.indices, a.data).device.type == "cuda"
    coo = a.tocoo()
    assert CSR.from_coo(coo.row, coo.col, coo.data, a.shape).device.type == "cuda"
    assert CSR.empty(4, 5).device.type == "cuda"
    assert CSR.from_scipy(a, device="cpu").device.type == "cpu"
    on_cpu = CSR(60, 80, a.nnz, torch.from_numpy(a.indptr.astype(np.int64)),
                 torch.from_numpy(a.indices), torch.from_numpy(a.data))
    assert on_cpu.device.type == "cpu"
    assert make_mesh(2).device.type == "cuda"
    y = CSR.from_scipy(a).mult_vec(np.ones(80, np.float32))
    assert y.device.type == "cuda"


def test_default_mult_vec_takes_the_chosen_layout_on_card(cuda_device):
    """A default ``CSR.mult_vec`` of a mid-size uniform matrix (4096 x
    6000, density 0.01) is one SpMV launch on the layout of
    ``choose_layout``'s (window, pair), and matches scipy."""
    from csr_tpu_torch.kernels import cuda as cuda_k

    a = random_matrix(4096, 6000, 0.01, seed=61, big_group=False)
    c = CSR.from_scipy(a)
    x = np.random.default_rng(62).uniform(-1, 1, 6000).astype(np.float32)
    before = spmv.launches
    y = c.mult_vec(torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    assert spmv.launches == before + 1
    layout = cuda_k._cached_layout(c)
    assert (layout.window, layout.pair) == mb.choose_layout(
        a.indptr, a.indices, 6000) == (256, 1)
    assert_spmv_close(y.cpu().numpy(), a.astype(np.float64) @ x, Scipy(a), x)


@pytest.mark.parametrize("window", [128, 256])
def test_bucket_kernel_matches_reference_on_card(window, cuda_device):
    """Every ring step's ``held`` row (so every bucket of every row shard,
    empty ones included) through the kernel and its plain version, adding
    into a non-zero ``y``; one launch a step."""
    top = random_matrix(300, 1024, 0.04, seed=21)
    import scipy.sparse as sps
    low = sps.hstack([random_matrix(300, 128, 0.5, seed=22, big_group=False),
                      sps.csr_matrix((300, 896), dtype=np.float32)])
    a = sps.vstack([top, low]).tocsr()
    D = 4
    mesh = make_mesh(D)
    rmb = mb_ring.partition_ring_mb(CSR.from_scipy(a), D, window=window).shard(mesh)
    assert rmb.vals.device.type == "cuda" and int(rmb.groups.min()) == 0
    rng = np.random.default_rng(window)
    x = torch.from_numpy(rng.uniform(-1, 1, (D, rmb.cols_per_shard))
                         .astype(np.float32)).to(cuda_device)
    y0 = torch.from_numpy(rng.uniform(-1, 1, (D, rmb.rows_per_shard))
                          .astype(np.float32)).to(cuda_device)
    for k in range(D):
        before = spmv.bucket_launches
        y = spmv.spmv_bucket(rmb.stack, mesh.held[k], x, y0.clone())
        y_ref = spmv.spmv_bucket_reference(rmb.stack, mesh.held[k], x, y0.clone())
        torch.cuda.synchronize()
        assert spmv.bucket_launches == before + 1
        # f32 sums in another order: rtol 1e-4 of |y| up to ~20, as the
        # SpMV bound's relative part
        torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    out = spmv.spmv_bucket(rmb.stack, torch.full((D,), D, dtype=torch.int32,
                                                 device=cuda_device), x, y0.clone())
    assert torch.equal(out, y0), "a held index past the buckets added something"
    with pytest.raises(ValueError):
        spmv.spmv_bucket(rmb.stack, mesh.held[0].cpu(), x, y0.clone())


def _stack_of(mats, window, device):
    """A BucketStack of ``len(mats)`` layers by ``len(mats[0])`` buckets
    from scipy matrices of one shape, each bucket zero-padded to the
    largest as the ring pads them."""
    layouts = [[mb.build_microblocks_host(*a.shape, a.indptr, a.indices, a.data,
                                          window=window, device="cpu")
                for a in row] for row in mats]
    n_layers, n_buckets = len(mats), len(mats[0])
    m_pad = max(lay.vals.shape[0] for row in layouts for lay in row)
    vals = torch.zeros(n_layers, n_buckets, m_pad, 128)
    meta = torch.zeros(n_layers, n_buckets, m_pad, 128, dtype=torch.uint16)
    rbcb = torch.zeros(n_layers, n_buckets, m_pad, dtype=torch.int32)
    groups = torch.zeros(n_layers, n_buckets, dtype=torch.int32)
    for l, row in enumerate(layouts):
        for b, lay in enumerate(row):
            m = lay.vals.shape[0]
            vals[l, b, :m], meta[l, b, :m], rbcb[l, b, :m] = lay.vals, lay.meta, lay.rbcb
            groups[l, b] = lay.n_microrows // mb.ACC_GROUP
    nrows, ncols = mats[0][0].shape
    return mb.BucketStack(nrows, ncols, window, vals.to(device), meta.to(device),
                          rbcb.to(device), groups.to(device), int(groups.max()))


@pytest.mark.parametrize("n_layers,n_buckets,grid", [
    (1, 3, "card"), (1, 3, "one block"), (7, 7, "card"), (7, 7, "four blocks"),
    (7, 7, "one block")])
def test_bucket_kernel_corners_on_card(n_layers, n_buckets, grid, cuda_device,
                                       monkeypatch):
    """The persistent loop against its plain version: a one-layer stack
    and a D = 7 one, on the card's grid (a micro-row a warp at most) and on
    four blocks and one (many micro-rows a warp: each warp's ring of
    stages in shared memory streams across groups, row windows and
    layers); every held bucket in turn, held indices outside the stack for
    some layers only, every held bucket empty (no micro-row at all);
    always adding into a non-zero y."""
    if grid != "card":
        monkeypatch.setattr(spmv, "_sm_count", lambda dev: 1 if "one" in grid else 4)
        monkeypatch.setattr(spmv, "BLOCKS_PER_SM", 1)
    # bucket (l + 1) % B of layer l is empty
    empty = [(l + 1) % n_buckets for l in range(n_layers)]
    mats = [[random_matrix(1024, 768, 0.0 if b == empty[l]
                           else 0.01 * (1 + (l + b) % 4), seed=7 * l + b,
                           big_group=b == 0 != empty[l])
             for b in range(n_buckets)] for l in range(n_layers)]
    stack = _stack_of(mats, 256 if n_layers > 1 else 128, cuda_device)
    rng = np.random.default_rng(n_layers)
    x = rng.uniform(-1, 1, (n_layers, 768)).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device)
    y0 = torch.from_numpy(rng.uniform(-1, 1, (n_layers, 1024))
                          .astype(np.float32)).to(cuda_device)
    layers = range(n_layers)
    helds = [[(l + k) % n_buckets for l in layers] for k in range(n_buckets)]
    helds.append([(-1, n_buckets, 0)[l % 3] for l in layers])
    helds.append(empty)
    blocks = spmv.bucket_grid(stack, spmv._sm_count(cuda_device))
    work = spmv.bucket_work(stack, torch.tensor(helds[0]), blocks)
    per_warp = -(-max(map(len, work)) // spmv.WARPS_PER_BLOCK)
    assert (per_warp > 1) == (grid != "card")
    for held in helds:
        hd = torch.tensor(held, dtype=torch.int32, device=cuda_device)
        before = spmv.bucket_launches
        y = spmv.spmv_bucket(stack, hd, xd, y0.clone())
        y_ref = spmv.spmv_bucket_reference(stack, hd, xd, y0.clone())
        torch.cuda.synchronize()
        assert spmv.bucket_launches == before + 1
        # f32 sums in another order: rtol 1e-4, as the SpMV bound's
        # relative part
        torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
        for l, h in enumerate(held):
            a = mats[l][h] if 0 <= h < n_buckets else None
            if a is None or a.nnz == 0:
                assert torch.equal(y[l], y0[l]), (held, l)
            else:
                assert_spmv_close((y[l] - y0[l]).cpu().numpy(),
                                  a.astype(np.float64) @ x[l], Scipy(a), x[l])


@pytest.mark.parametrize("n_shards", [1, 4, 7])
def test_ring_and_dist_on_card(n_shards, cuda_device):
    """The ring and ``mb_dist`` in the local form on the card, against
    scipy and the portable forms; the launch counts the schedules predict."""
    a = random_matrix(900, 1100, 0.04, seed=11)
    csr = CSR.from_scipy(a)
    x = np.random.default_rng(3).uniform(-1, 1, 1100).astype(np.float32)
    expect = a.astype(np.float64) @ x
    mesh = make_mesh(n_shards)
    D = n_shards

    rmb = mb_ring.partition_ring_mb(csr, D).shard(mesh)
    before = spmv.bucket_launches
    y = mb_ring.spmv_ring_mb(rmb, mb_ring.scatter_x(rmb, x, mesh), mesh)
    assert spmv.bucket_launches == before + D
    assert y.device.type == "cuda" and y.shape == (D, rmb.rows_per_shard)
    assert_spmv_close(mb_ring.collect_rows(rmb, y).cpu().numpy(), expect,
                      Scipy(a), x)
    r = ring.partition_ring(csr, D).shard(mesh)
    yr = ring.spmv_ring(r, ring.scatter_x(r, x, mesh), mesh)
    assert_spmv_close(dist.collect_rows(r, yr).cpu().numpy(), expect, Scipy(a), x)

    dmb = mb_dist.partition_microblocks(csr, D).shard(mesh)
    dmbt = mb_dist.partition_microblocks_t(csr, D).shard(mesh)
    before = spmv.launches
    ys = mb_dist.spmv(dmb, x, mesh)
    yh = mb_dist.spmv_halo(dmb, mb_dist.scatter_x(dmb, x, mesh), mesh)
    xt = mb_dist.spmv_t(dmbt, ys, mesh)
    xs = mb_dist.spmv_t(dmbt, ys, mesh, scatter=True)
    assert spmv.launches == before + 4 * D
    for got in (ys, yh):
        assert_spmv_close(mb_dist.collect_rows(dmb, got).cpu().numpy(), expect,
                          Scipy(a), x)
    at = a.T.tocsr()
    for got in (xt, mb_dist.collect_cols_t(dmbt, xs)):
        assert_spmv_close(got.cpu().numpy(), at.astype(np.float64) @ (a @ x),
                          Scipy(at), a @ x)
    d = partition_rows(csr, D).shard(mesh)
    np.testing.assert_allclose(
        dist.collect_rows(d, dist.spmv(d, x, mesh)).cpu().numpy(), expect,
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("budget", [5000, 2**24])
def test_esc_on_card(budget, wide, cuda_device, monkeypatch):
    """ESC on the card, in several chunks and in one, both ways, against
    scipy; the product stays on the card with its rows sorted.  B 250
    columns wide, every chunk's keys fit int32; 2^27 wide (12 entries a
    row), a chunk of 16 rows or more takes the int64 key."""
    from csr_tpu_torch import tracing
    from csr_tpu_torch.ops import spgemm

    monkeypatch.setattr(spgemm, "esc_chunk_entries", budget)
    a = random_matrix(300, 400, 0.05, seed=70)
    if wide:
        rng = np.random.default_rng(71)
        cols = rng.choice(2**27, 400 * 12, replace=False).astype(np.int32)
        b = sps.csr_matrix((rng.uniform(-1, 1, 400 * 12).astype(np.float32),
                            cols, np.arange(0, 400 * 12 + 1, 12)),
                           shape=(400, 2**27))
        b.sort_indices()
    else:
        b = random_matrix(400, 250, 0.05, seed=71, big_group=False)
    # scipy's product over B's used columns, mapped back
    used = np.unique(b.indices)
    want = (a @ sps.csr_matrix((b.data, np.searchsorted(used, b.indices),
                                b.indptr), shape=(400, len(used)))).tocsr()
    A = CSR.from_scipy(a, device=cuda_device)
    rec = tracing.enable()
    try:
        products = (spgemm.esc_mult_ab(A, CSR.from_scipy(b, device=cuda_device)),
                    spgemm.esc_mult_abt(A, CSR.from_scipy(b.T.tocsr(),
                                                          device=cuda_device)))
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
    if not wide:
        assert "esc.keys64" not in counters and counters["esc.keys32"] >= 2
    elif budget == 2**24:  # one chunk of 300 rows a product
        assert "esc.keys32" not in counters and counters["esc.keys64"] == 2
    else:  # chunks of 5 to 24 rows: all but the first and last past 2^31 cells
        assert counters["esc.keys64"] >= 2
    for c in products:
        assert c.device.type == cuda_device.type
        assert (c.nrows, c.ncols) == (300, b.shape[1])
        got = c.to_scipy()
        assert got.has_sorted_indices
        got = sps.csr_matrix((got.data, np.searchsorted(used, got.indices),
                              got.indptr), shape=want.shape)
        assert np.isin(c.colinds.cpu().numpy(), used).all()
        assert_product_close(got.toarray(), want.toarray())


def test_spmv_large_on_card(cuda_device, monkeypatch):
    """The chunk/panel SpMV on the card with the budget cut to 2 windows:
    512 x 640 is 2 chunks x 3 panels, its transpose 3 chunks x 2."""
    from csr_tpu_torch.kernels import cuda as cuda_k

    monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", 2)
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", float("inf"))  # the micro-block route
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER_LARGE", float("inf"))
    a = random_matrix(512, 640, 0.03, seed=72)
    c = CSR.from_scipy(a, device=cuda_device)
    rng = np.random.default_rng(73)
    x = rng.uniform(-1, 1, 640).astype(np.float32)
    xt = rng.uniform(-1, 1, 512).astype(np.float32)
    before = spmv.launches
    with use_kernel("cuda"):
        y, yt = c.mult_vec(x), c.mult_vec_t(xt)
    assert spmv.launches - before == 6 + 6
    assert_spmv_close(y.cpu().numpy(), a.astype(np.float64) @ x, Scipy(a), x)
    at = a.T.tocsr()
    assert_spmv_close(yt.cpu().numpy(), at.astype(np.float64) @ xt, Scipy(at), xt)


def test_structure_ops_on_card(cuda_device):
    """Transpose, row sort, pick, filter and both normalisations on the
    card give what they give on the CPU."""
    rng = np.random.default_rng(74)
    rows, cols = rng.integers(0, 200, 2000), rng.integers(0, 150, 2000)
    vals = rng.uniform(0.5, 5, 2000).astype(np.float32)
    on = CSR.from_coo(rows, cols, vals, (200, 150), device=cuda_device)
    off = CSR.from_coo(rows, cols, vals, (200, 150), device="cpu")
    stats = []
    for c in (on, off):
        c.sort_rows()
        stats.append((c.normalize_rows("center"), c.normalize_rows("unit")))
    assert torch.equal(on.colinds.cpu(), off.colinds)
    for s_on, s_off in zip(*stats):
        np.testing.assert_allclose(s_on.cpu().numpy(), s_off.numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(on.values.cpu().numpy(), off.values.numpy(),
                               rtol=1e-5, atol=1e-6)
    t_on, t_off = on.transpose(), off.transpose()
    assert torch.equal(t_on.rowptrs.cpu(), t_off.rowptrs)
    assert torch.equal(t_on.colinds.cpu(), t_off.colinds)
    p_on, p_off = on.pick_rows([5, 5, 0, 199]), off.pick_rows([5, 5, 0, 199])
    assert torch.equal(p_on.colinds.cpu(), p_off.colinds)
    f_on = on.filter_nnzs(on.values > 0)
    f_off = off.filter_nnzs(off.values > 0)
    assert f_on.nnz == f_off.nnz and torch.equal(f_on.rowptrs.cpu(), f_off.rowptrs)


def test_guard_transfers_on_card(cuda_device):
    from csr_tpu_torch.utils.debug import guard_transfers

    x = torch.ones(4, device=cuda_device)
    with guard_transfers():
        y = x * 2
        with pytest.raises(RuntimeError):
            float(y.sum())
    assert float(y.sum()) == 8.0


@pytest.mark.parametrize("k,in_dim", [(8, 0), (3, 1)])
def test_vmap_is_one_spmm_launch_on_card(k, in_dim, cuda_device):
    """``torch.func.vmap`` of ``mult_vec`` on the cuda backend: one SpMM
    launch on B = X^T (k = 3 through the padded copy), no SpMV launch,
    each row within the SpMV bound of a ``mult_vec`` of its operand."""
    a = random_matrix(300, 700, 0.03, seed=70 + k)
    c = CSR.from_scipy(a, device=cuda_device)
    X = np.random.default_rng(k).uniform(-1, 1, (k, 700)).astype(np.float32)
    arg = torch.from_numpy(X if in_dim == 0 else X.T.copy()).to(cuda_device)
    from csr_tpu_torch import kernels

    events = []
    with use_kernel("cuda"):
        c.mult_vec(arg[0] if in_dim == 0 else arg[:, 0])  # packs the layout
        before = (spmv.launches, spmm.launches)
        kernels._listeners.append(
            lambda e, f: events.append((e, f)) if e.startswith("mult_vec") else None)
        try:
            Y = torch.func.vmap(lambda v: c.mult_vec(v), in_dims=in_dim)(arg)
        finally:
            kernels._listeners.pop()
        torch.cuda.synchronize()
        assert (spmv.launches, spmm.launches) == (before[0], before[1] + 1)
        assert events == [("mult_vec", {"route": "kernel", "shape": (300, 700),
                                        "n": k})]
        loop = [c.mult_vec(torch.from_numpy(X[i]).to(cuda_device)) for i in range(k)]
    assert Y.shape == (k, 300)
    for i in range(k):
        assert_spmv_close(Y[i].cpu().numpy(), loop[i].cpu().numpy(), Scipy(a), X[i])
        assert_spmv_close(Y[i].cpu().numpy(), a.astype(np.float64) @ X[i],
                          Scipy(a), X[i])


def test_graph_capture_of_mult_vec_on_card(cuda_device):
    """A chain of ``CSR.mult_vec`` on a fixed matrix captured in a CUDA
    graph: the capture launches once a step, a replay adds to no count,
    and the replayed chain equals the eager one within the SpMV bound."""
    from csr_tpu_torch.harness import normalized
    from csr_tpu_torch.utils import profiling

    a = random_matrix(300, 300, 0.03, seed=72)
    c = CSR.from_scipy(a, device=cuda_device)
    x0 = torch.from_numpy(np.random.default_rng(72).uniform(-1, 1, 300)
                          .astype(np.float32)).to(cuda_device)

    def step(v):
        return normalized(c.mult_vec(v))

    from csr_tpu_torch.kernels import cuda as cuda_k

    kernel = {"csr": "spmv_csr"}.get(cuda_k._spmv_route(c, False), "spmv_microblock")
    with use_kernel("cuda"):
        before = profiling.launch_counts()[kernel]
        _, y, captured = profiling.timed_graph(step, x0, iters=5, reps=3)
        # the warm-up step, the capture
        assert profiling.launch_counts()[kernel] == before + 1 + 5
        assert captured == {"spmv_microblock": 0, "spmm_microblock": 0,
                            "spmv_bucket": 0, "spmv_csr": 0, "spmm_csr": 0,
                            kernel: 5}
        v = x0
        for _ in range(4):
            v = step(v)
        last = c.mult_vec(v)
    scale = torch.clamp_min(last.abs().max(), 1e-30)
    x_last = (v / scale).cpu().numpy()
    assert_spmv_close(y.cpu().numpy(), (last / scale).cpu().numpy(), Scipy(a),
                      x_last)


def test_cuda_backend_refuses_grad_on_card(cuda_device):
    """On the card the kernel writes through a raw pointer, so a result
    would have no ``grad_fn``: the cuda backend raises instead, and the
    torch backend differentiates."""
    a = random_matrix(300, 700, 0.03, seed=73)
    c = CSR.from_scipy(a, device=cuda_device)
    x = torch.ones(700, device=cuda_device, requires_grad=True)
    with use_kernel("cuda"):
        with pytest.raises(ValueError, match="torch backend"):
            c.mult_vec(x)
        with pytest.raises(ValueError, match="torch backend"):
            c.mult_dense(x[:, None].expand(700, 4))
    with use_kernel("torch"):
        y = c.mult_vec(x)
    assert y.grad_fn is not None
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(g.cpu().numpy(), np.asarray(a.sum(0)).ravel(),
                               rtol=1e-5, atol=1e-5)


def _csr_views(a, offset, ptr_dtype, device, structure_only=False):
    """The CSR arrays of scipy ``a`` on the card, ``colinds`` ``offset[0]``
    and ``values`` ``offset[1]`` floats past a 16 B boundary (the same
    offsets take the kernel's 16 B path, different ones its scalar path),
    row pointers of ``ptr_dtype``."""
    nnz = a.nnz
    ci = torch.zeros(nnz + 8, dtype=torch.int32, device=device)[offset[0]:][:nnz]
    ci.copy_(torch.from_numpy(a.indices.astype(np.int32)))
    v = torch.zeros(nnz + 8, device=device)[offset[1]:][:nnz]
    v.copy_(torch.from_numpy(a.data.astype(np.float32)))
    rp = torch.from_numpy(a.indptr.astype(np.int64)).to(device, ptr_dtype)
    return rp, ci, None if structure_only else v


def _into_nan(launch, operand):
    """``launch(operand)`` with the f32 tensors it allocates by
    ``torch.empty`` (its result) filled with NaN first, so that a row the
    kernel does not write shows."""
    empty = torch.empty

    def nan_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.dtype == torch.float32 else t

    torch.empty = nan_empty
    try:
        return launch(operand)
    finally:
        torch.empty = empty


def _spmv_csr_into_nan(rp, ci, v, xd):
    """The CSR-form SpMV kernel's zeroed path (``spmv_csr_launch``, with
    ``csr_shares``' edges) into a y filled with NaN."""
    edges = spmv.csr_shares(rp, ci.shape[0])[0]
    return _into_nan(spmv.spmv_csr_launch(rp, ci, v, edges, xd), xd)


def _spmm_csr_into_nan(rp, ci, v, bd):
    """The CSR-form SpMM kernel (``spmm_csr_launch``, ``csr_plan``'s lanes
    and load width) into a C filled with NaN."""
    edges = spmv.csr_shares(rp, ci.shape[0], spmm.CSR_TILE)[0]
    return _into_nan(spmm.spmm_csr_launch(rp, ci, v, edges, bd), bd)


def _long_row_matrix(seed):
    """600 x 9000 with one full row (4.4 shares of merge items), most rows
    empty, and a block of 30 denser rows."""
    rng = np.random.default_rng(seed)
    m = sps.lil_matrix((600, 9000), dtype=np.float32)
    m[17, :] = rng.standard_normal(9000)
    m[18, 5] = 2.0
    m[400:430, :300] = rng.standard_normal((30, 300))
    return m.tocsr()


@pytest.mark.parametrize("offset,ptr_dtype,structure_only", [
    ((0, 0), torch.int32, False), ((1, 1), torch.int64, False),
    ((3, 3), torch.int32, False), ((1, 2), torch.int64, False),
    ((2, 0), torch.int32, True)])
@pytest.mark.parametrize("case", ["random", "long row"])
def test_csr_kernel_matches_reference_on_card(case, offset, ptr_dtype,
                                              structure_only, cuda_device):
    """The CSR-form kernel against spmv_csr_reference and scipy, on its 16 B
    and scalar paths, with int32 and int64 row pointers and structure-only;
    ``out=`` adds into what it holds."""
    a = (random_matrix(3000, 5000, 0.004, seed=80, big_group=False)
         if case == "random" else _long_row_matrix(81))
    if structure_only:
        a = sps.csr_matrix((np.ones(a.nnz, np.float32), a.indices, a.indptr),
                           shape=a.shape)
    rp, ci, v = _csr_views(a, offset, ptr_dtype, cuda_device, structure_only)
    x = np.random.default_rng(82).uniform(-1, 1, a.shape[1]).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device)
    before = spmv.csr_launches
    y = spmv.spmv_csr(rp, ci, v, xd)
    out = torch.full((a.shape[0],), 0.5, device=cuda_device)
    assert spmv.spmv_csr(rp, ci, v, xd, out=out) is out
    y_ref = spmv.spmv_csr_reference(rp, ci, v, xd)
    torch.cuda.synchronize()
    assert spmv.csr_launches == before + 2
    # every row written (no memset of y), and bitwise repeatable
    assert torch.equal(_spmv_csr_into_nan(rp, ci, v, xd), y)
    assert torch.equal(spmv.spmv_csr(rp, ci, v, xd), y)
    assert_spmv_close(y.cpu().numpy(), y_ref.cpu().numpy(), Scipy(a), x)
    assert_spmv_close(y.cpu().numpy(), a.astype(np.float64) @ x, Scipy(a), x)
    assert_spmv_close((out - 0.5).cpu().numpy(), a.astype(np.float64) @ x,
                      Scipy(a), x)


def test_csr_kernel_many_shares_a_block_on_card(cuda_device):
    """A matrix of more shares than the persistent grid has blocks
    (5,000,000 rows of 0 to 4 entries: about 7,300 shares of 2048 merge
    items), so each block takes a run of shares, rows cut at share and
    at block edges, rows of 60,000 entries over several blocks' runs and
    one of 4,096 entries; empty rows give exact zeros; every row written
    (a y of NaN) and two runs bitwise equal."""
    rng = np.random.default_rng(83)
    n = 5_000_000
    lengths = rng.integers(0, 5, n)
    lengths[[10, 2_500_000, n - 1]] = 60_000
    lengths[3_000_000] = 4096
    rp = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=rp[1:])
    cols = rng.integers(0, 1 << 20, int(rp[-1])).astype(np.int32)
    a = sps.csr_matrix((rng.standard_normal(len(cols)).astype(np.float32),
                        cols, rp), shape=(n, 1 << 20))
    rpd, ci, v = _csr_views(a, (0, 0), torch.int32, cuda_device)
    x = rng.uniform(-1, 1, 1 << 20).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device)
    y = spmv.spmv_csr(rpd, ci, v, xd)
    y_ref = spmv.spmv_csr_reference(rpd, ci, v, xd)
    torch.cuda.synchronize()
    assert not y[torch.from_numpy(lengths == 0).to(cuda_device)].any()
    assert torch.equal(_spmv_csr_into_nan(rpd, ci, v, xd), y)
    assert torch.equal(spmv.spmv_csr(rpd, ci, v, xd), y)
    # assert_spmv_close's bound, on the sparse matrix (it densifies)
    spmv_share(y, y_ref.cpu().numpy(), a, x)
    spmv_share(y, a.astype(np.float64) @ x, a, x)


def test_csr_kernel_inf_reaches_only_its_rows_on_card(cuda_device):
    a = _long_row_matrix(84)
    x = np.random.default_rng(85).uniform(-1, 1, 9000).astype(np.float32)
    x[5] = np.inf
    rp, ci, v = _csr_views(a, (1, 1), torch.int32, cuda_device)
    y = spmv.spmv_csr(rp, ci, v, torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    uses = np.flatnonzero(a[:, [5]].toarray()[:, 0] != 0)
    assert np.array_equal(np.flatnonzero(~np.isfinite(y)), uses)


def test_csr_routed_mult_vec_is_one_launch_on_card(cuda_device):
    """A hypersparse matrix's mult_vec and mult_vec_t take the CSR-form
    kernel, one launch each, and build no micro-block layout; the
    transpose's CSR tensors are cached; both match scipy."""
    from csr_tpu_torch.kernels import cuda as cuda_k

    rng = np.random.default_rng(86)
    a = sps.random(4096, 1 << 20, 12 / (1 << 20), format="csr", dtype=np.float32,
                   random_state=rng)
    c = CSR.from_scipy(a, device=cuda_device)
    assert cuda_k._spmv_route(c, False) == cuda_k._spmv_route(c, True) == "csr"
    x = rng.uniform(-1, 1, 1 << 20).astype(np.float32)
    xt = rng.uniform(-1, 1, 4096).astype(np.float32)
    with use_kernel("cuda"):
        before = (spmv.csr_launches, spmv.launches)
        y = c.mult_vec(torch.from_numpy(x).to(cuda_device))
        assert (spmv.csr_launches, spmv.launches) == (before[0] + 1, before[1])
        yt = c.mult_vec_t(torch.from_numpy(xt).to(cuda_device))
        assert (spmv.csr_launches, spmv.launches) == (before[0] + 2, before[1])
        c.mult_vec_t(torch.from_numpy(xt).to(cuda_device))
    torch.cuda.synchronize()
    for form in ("layout", "layout_t", "large", "large_t"):
        assert kept(c, form) is None, form
    assert kept(c, "csr_t")[0].device.type == "cuda"
    # assert_spmv_close's bound, on the sparse matrices (it densifies)
    spmv_share(y, a.astype(np.float64) @ x, a, x)
    at = a.T.tocsr()
    spmv_share(yt, at.astype(np.float64) @ xt, at, xt)


@pytest.mark.parametrize("offset,ptr_dtype,structure_only,b_offset,b_pad", [
    ((0, 0), torch.int32, False, 0, 0), ((1, 1), torch.int64, False, 0, 4),
    ((2, 0), torch.int32, True, 1, 0), ((3, 3), torch.int64, False, 3, 3),
    ((0, 0), torch.int32, False, 2, 0)])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16, 17, 32, 33, 50, 64, 65, 128,
                               129, 256, 257])
@pytest.mark.parametrize("case", ["random", "long row"])
def test_spmm_csr_kernel_matches_reference_on_card(case, n, offset, ptr_dtype,
                                                   structure_only, b_offset,
                                                   b_pad, cuda_device):
    """The CSR-form SpMM kernel against spmm_csr_reference and scipy: int32
    and int64 row pointers, colinds and values off a 16 B boundary,
    structure-only, and a B 16 B, 8 B or 4 B aligned or with padded rows
    (csr_plan's 16 B, 8 B and 4 B loads) at every lanes-a-row (4, 8, 16,
    32); a row of 4.4 shares (the "long row" case) and empty rows; every
    row written (a C of NaN) and two runs bitwise equal."""
    a = (random_matrix(3000, 5000, 0.004, seed=87, big_group=False)
         if case == "random" else _long_row_matrix(88))
    if structure_only:
        a = sps.csr_matrix((np.ones(a.nnz, np.float32), a.indices, a.indptr),
                           shape=a.shape)
    rp, ci, v = _csr_views(a, offset, ptr_dtype, cuda_device, structure_only)
    b = np.random.default_rng(89).uniform(-1, 1, (a.shape[1], n)).astype(np.float32)
    buf = torch.zeros(a.shape[1] * (n + b_pad) + b_offset, device=cuda_device)
    bd = buf[b_offset:].view(a.shape[1], n + b_pad)[:, :n]
    bd.copy_(torch.from_numpy(b))
    before = spmm.csr_launches
    c = spmm.spmm_csr(rp, ci, v, bd)
    c_ref = spmm.spmm_csr_reference(rp, ci, v, bd)
    torch.cuda.synchronize()
    assert spmm.csr_launches == before + 1
    assert torch.equal(_spmm_csr_into_nan(rp, ci, v, bd), c)
    assert torch.equal(spmm.spmm_csr(rp, ci, v, bd), c)
    assert c.shape == (a.shape[0], n) and c.dtype == torch.float32
    assert_product_close(c.cpu().numpy(), c_ref.cpu().numpy())
    assert_product_close(c.cpu().numpy(), a.astype(np.float64) @ b)


def test_spmm_csr_kernel_inf_reaches_only_its_rows_on_card(cuda_device):
    a = _long_row_matrix(90)
    b = np.random.default_rng(91).uniform(-1, 1, (9000, 50)).astype(np.float32)
    b[5, 1] = np.inf
    rp, ci, v = _csr_views(a, (0, 0), torch.int32, cuda_device)
    c = spmm.spmm_csr(rp, ci, v, torch.from_numpy(b).to(cuda_device)).cpu().numpy()
    rows, cols = np.nonzero(~np.isfinite(c))
    uses = np.flatnonzero(a[:, [5]].toarray()[:, 0] != 0)
    assert np.array_equal(np.unique(rows), uses) and set(cols.tolist()) == {1}


def test_csr_routed_mult_dense_is_one_launch_on_card(cuda_device):
    """A hypersparse matrix's mult_dense takes the CSR-form SpMM kernel in
    one launch and builds no micro-block layout; a vmapped mult_vec of it
    is one CSR-form SpMM launch too; both match scipy."""
    from csr_tpu_torch.kernels import cuda as cuda_k
    from csr_tpu_torch.utils.profiling import launch_counts

    rng = np.random.default_rng(92)
    a = sps.random(4096, 1 << 20, 12 / (1 << 20), format="csr", dtype=np.float32,
                   random_state=rng)
    c = CSR.from_scipy(a, device=cuda_device)
    assert cuda_k._spmm_route(c, 50) == "csr"
    b = rng.uniform(-1, 1, ((1 << 20), 50)).astype(np.float32)
    X = rng.uniform(-1, 1, (3, 1 << 20)).astype(np.float32)
    with use_kernel("cuda"):
        launch_counts(reset=True)
        d = c.mult_dense(torch.from_numpy(b).to(cuda_device))
        Y = torch.func.vmap(lambda v: c.mult_vec(v))(torch.from_numpy(X).to(cuda_device))
        counts = launch_counts()
    assert {k: m for k, m in counts.items() if m} == {"spmm_csr": 2}, counts
    for form in ("layout", "large"):
        assert kept(c, form) is None, form
    assert_product_close(d.cpu().numpy(), a.astype(np.float64) @ b)
    for k in range(3):
        spmv_share(Y[k], a.astype(np.float64) @ X[k], a, X[k])


@pytest.mark.parametrize("route", ["microblock", "csr"])
def test_launch_spans_count_the_launches_on_card(route, cuda_device, monkeypatch):
    """With the program's tracing on, each kernel's ``csr.launch`` span
    counts once a launch: ``mult_vec``, ``mult_vec_t`` and ``mult_dense``
    on the micro-block kernels or on the CSR-form ones give the wrappers'
    launch counts, and each call one ``csr.api`` span."""
    from csr_tpu_torch import tracing
    from csr_tpu_torch.kernels import cuda as cuda_k
    from csr_tpu_torch.utils.profiling import launch_counts

    point = 0.0 if route == "csr" else float("inf")
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", point)
    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, point),))
    a = random_matrix(3000, 2000, 0.01, seed=93)
    c = CSR.from_scipy(a, device=cuda_device)
    x = torch.ones(2000, device=cuda_device)
    y = torch.ones(3000, device=cuda_device)
    b = torch.ones(2000, 8, device=cuda_device)
    rec = tracing.enable()
    try:
        with use_kernel("cuda"):
            launch_counts(reset=True)
            for _ in range(3):
                c.mult_vec(x)
                c.mult_vec_t(y)
                c.mult_dense(b)
            torch.cuda.synchronize()
            counts = launch_counts()
        snap = rec.snapshot()
    finally:
        tracing.disable()
    spans = {k[len("csr.launch."):]: s["count"] for k, s in snap["spans"].items()
             if k.startswith("csr.launch.")}
    assert spans == {k: n for k, n in counts.items() if n} and sum(spans.values()) == 9
    assert sum(s["count"] for k, s in snap["spans"].items() if k.startswith("csr.api.")) == 9


#: route -> (method, B's width or None, B one float off 16 B, the matrix)
PLAN_ROUTES = {
    "microblock-spmm-n50": ("mult_dense", 50, False, "ratings"),
    "microblock-spmm-n52": ("mult_dense", 52, False, "ratings"),
    "microblock-spmm-n52-misaligned": ("mult_dense", 52, True, "ratings"),
    "microblock-spmv": ("mult_vec", None, False, "ratings"),
    "csr-spmm": ("mult_dense", 50, False, "hypersparse"),
    "csr-spmv": ("mult_vec", None, False, "hypersparse"),
    "csr-spmv-t": ("mult_vec_t", None, False, "hypersparse"),
}


def _plan_matrix(kind, cuda_device):
    """``ratings``: 65,536 users x 8,192 items, 24 a user, in 24 of the 32
    256-item windows by turns, so every 128-row window packs into one
    group of 32 micro-rows (the micro-block kernels repeat bit for bit)
    at 8 layout bytes an entry (the micro-block routes); ``hypersparse``:
    2^20 x 2^18 at 3 a row, an Amazon-shaped matrix on the CSR-form
    kernels."""
    rng = np.random.default_rng(94)
    if kind == "ratings":
        nrows, ncols, per = 65536, 8192, 24
        windows = (np.arange(nrows)[:, None] * 7 + np.arange(per)) % 32
        cols = windows * 256 + rng.integers(0, 256, (nrows, per))
    else:
        nrows, ncols, per = 1 << 20, 1 << 18, 3
        cols = rng.integers(0, ncols, (nrows, per))
    rp = np.arange(nrows + 1, dtype=np.int64) * per
    cols = np.sort(cols, axis=1).astype(np.int32).reshape(-1)
    vals = rng.uniform(0.5, 5, nrows * per).astype(np.float32)
    return CSR(nrows, ncols, nrows * per, rp, cols, vals, device=cuda_device)


@pytest.mark.parametrize("route", list(PLAN_ROUTES))
def test_plan_hit_is_the_general_path_on_card(route, cuda_device):
    """A product plan's hit (``csr_tpu_torch/_plan.py``) is bitwise the
    general path's result, in a fresh tensor each call, on each route
    that keeps a plan."""
    from csr_tpu_torch import tracing
    from csr_tpu_torch.kernels import cuda as cuda_k

    method, n, misaligned, kind = PLAN_ROUTES[route]
    c = _plan_matrix(kind, cuda_device)
    transpose = method == "mult_vec_t"
    taken = cuda_k._spmm_route(c, n) if n else cuda_k._spmv_route(c, transpose)
    assert taken == ("csr" if kind == "hypersparse" else "kernel" if n else "microblock")
    shape = (c.ncols, n) if n else (c.nrows if transpose else c.ncols,)
    v = torch.rand(shape, device=cuda_device)
    if misaligned:
        v = torch.empty(v.numel() + 1, device=cuda_device)[1:].view(shape).copy_(v)
        assert v.data_ptr() % 16 == 4
    rec = tracing.enable()
    try:
        with use_kernel("cuda"):
            general = getattr(c, method)(v)
            hits = [getattr(c, method)(v) for _ in range(3)]
        torch.cuda.synchronize()
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
    assert counters["plan.build"] == 1 and counters["plan.hit"] == 3
    if kind == "ratings":
        layout = cuda_k._cached_layout(c)
        rb = (layout.rbcb[: layout.n_microrows] >> 16).cpu().numpy()
        assert np.bincount(rb).max() <= mb.ACC_GROUP, "a window spans two groups"
    ptrs = {general.data_ptr()} | {h.data_ptr() for h in hits}
    assert len(ptrs) == 4
    for h in hits:
        assert torch.equal(h, general)


@pytest.mark.parametrize("perturb", ["values.mul_", "rebind values", "fill_values"])
@pytest.mark.parametrize("kind", ["ratings", "hypersparse"])
def test_a_stale_plan_frees_its_forms_on_card(kind, perturb, cuda_device):
    """Once the values are edited in place or rebound, one ``mult_vec_t``
    (which rebuilds its own forms) frees ``mult_vec``'s plan with the
    form it read and the values it was made from: the card's allocated
    memory returns to its level before ``mult_vec`` first ran."""
    c = _plan_matrix(kind, cuda_device)
    x = torch.rand(c.ncols, device=cuda_device)
    xt = torch.rand(c.nrows, device=cuda_device)
    with use_kernel("cuda"):
        c.mult_vec_t(xt)
        level = torch.cuda.memory_allocated(cuda_device)
        c.mult_vec(x)
        assert kept(c, ("plan", "mult_vec")) is not None
        assert torch.cuda.memory_allocated(cuda_device) > level
        if perturb == "values.mul_":
            c.values.mul_(2)
        elif perturb == "rebind values":
            c.values = c.values * 1.5
        else:
            c.fill_values(0.5)
        c.mult_vec_t(xt)
    torch.cuda.synchronize()
    assert kept(c, ("plan", "mult_vec")) is None
    assert torch.cuda.memory_allocated(cuda_device) == level


def _panel_matrix(case):
    """Rows in column order: ``long row``, 600 x 9000 with a full row (a
    run of over a share in every panel), 40 empty rows and 30 rows over
    the first 300 columns; ``half empty``, 500 x 4000 whose columns all
    lie in the first half (the last panels hold no entry)."""
    rng = np.random.default_rng(140)
    if case == "long row":
        a = sps.random(600, 9000, 0.004, format="lil", random_state=rng, dtype=np.float32)
        a[100:140, :] = 0
        a[17, :] = rng.standard_normal(9000).astype(np.float32)
        a[400:430, :300] = rng.standard_normal((30, 300)).astype(np.float32)
    else:
        a = sps.random(500, 4000, 0.0, format="lil", dtype=np.float32)
        a[:, :2000] = sps.random(500, 2000, 0.01, format="lil", random_state=rng,
                                 dtype=np.float32)
    a = a.tocsr()
    a.sort_indices()
    return a


def _force_panels(monkeypatch, ncols, n, k, device):
    """Set the rule's slab so that a B of ``ncols x n`` f32 takes ``k``
    panels on this card, whatever the rows' length."""
    from csr_tpu_torch.kernels import cuda as cuda_k

    l2 = cuda_k._l2_bytes(device)
    monkeypatch.setattr(cuda_k, "_PANEL_L2_SHARE", (ncols * n * 4 // k + 1.5) / l2)
    monkeypatch.setattr(cuda_k, "_PANEL_MIN_ENTRIES", 0.0)


def _error_scale(a, b):
    """|A| |B| in f64: the scale of an element's rounding error."""
    return abs(a).astype(np.float64) @ np.abs(b.astype(np.float64))


@pytest.mark.parametrize("k", [2, 3, 5, 7])
@pytest.mark.parametrize("n,ptr_dtype,structure_only,b_pad", [
    (50, torch.int32, False, 0), (3, torch.int64, True, 0),
    (256, torch.int32, False, 4), (50, torch.int64, False, 6)])
@pytest.mark.parametrize("case", ["long row", "half empty"])
def test_spmm_csr_panels_match_reference_on_card(case, n, ptr_dtype, structure_only,
                                                 b_pad, k, cuda_device, monkeypatch):
    """``mult_dense`` in ``k`` column panels (the slab shrunk) against
    ``spmm_csr_reference`` and the panels' plain version to 1e-6 of |A||B|,
    and scipy: empty rows and empty panels, a row across many shares,
    int32 and int64 row pointers, structure-only, n = 3, 50 and 256, a B
    whose rows lie ``n + b_pad`` floats apart; two runs bitwise equal,
    ``k`` panels counted a call."""
    from csr_tpu_torch import tracing
    from csr_tpu_torch.kernels import cuda as cuda_k

    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, 0.0),))
    a = _panel_matrix(case)
    if structure_only:
        a = sps.csr_matrix((np.ones(a.nnz, np.float32), a.indices, a.indptr),
                           shape=a.shape)
    _force_panels(monkeypatch, a.shape[1], n, k, cuda_device)
    rp, ci, v = _csr_views(a, (0, 0), ptr_dtype, cuda_device, structure_only)
    c = CSR(a.shape[0], a.shape[1], a.nnz, rp, ci, v, _cast=False)
    b = np.random.default_rng(141).uniform(-1, 1, (a.shape[1], n)).astype(np.float32)
    bd = torch.zeros(a.shape[1], n + b_pad, device=cuda_device)[:, :n]
    bd.copy_(torch.from_numpy(b))
    rec = tracing.enable()
    try:
        with use_kernel("cuda"):
            d = c.mult_dense(bd)
            again = c.mult_dense(bd)
        torch.cuda.synchronize()
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
    panels = cuda_k._spmm_panels(c, False, n)
    assert panels.count == k and counters["csr.spmm.panels"] == 2 * k
    assert torch.equal(d, again)
    scale = _error_scale(a, b)
    for ref in (spmm.spmm_csr_reference(rp, ci, v, bd),
                spmm.spmm_csr_panels_reference(ci, v, bd, panels)):
        gap = np.abs(d.cpu().numpy().astype(np.float64) - ref.cpu().numpy())
        assert np.all(gap <= 1e-6 * scale), float((gap / np.maximum(scale, 1e-30)).max())
    assert_product_close(d.cpu().numpy(), a.astype(np.float64) @ b)


def test_spmm_csr_panels_rows_out_of_order_on_card(cuda_device, monkeypatch):
    """A matrix with a row out of column order keeps the one pass on the
    card whatever the slab: no panel counted, one launch, scipy's result."""
    from csr_tpu_torch import tracing
    from csr_tpu_torch.kernels import cuda as cuda_k

    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, 0.0),))
    a = _panel_matrix("long row")
    k0 = int(a.indptr[17])
    a.indices[k0 : k0 + 2] = a.indices[k0 : k0 + 2][::-1].copy()
    a.data[k0 : k0 + 2] = a.data[k0 : k0 + 2][::-1].copy()
    _force_panels(monkeypatch, a.shape[1], 50, 4, cuda_device)
    c = CSR.from_scipy(a, device=cuda_device)
    b = np.random.default_rng(142).uniform(-1, 1, (a.shape[1], 50)).astype(np.float32)
    before = spmm.csr_launches
    rec = tracing.enable()
    try:
        with use_kernel("cuda"):
            d = c.mult_dense(torch.from_numpy(b).to(cuda_device))
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
    assert cuda_k._spmm_panels(c, False, 50) is None
    assert "csr.spmm.panels" not in counters and spmm.csr_launches == before + 1
    assert_product_close(d.cpu().numpy(), a.astype(np.float64) @ b)


def test_spmm_csr_panels_plan_hit_on_card(cuda_device, monkeypatch):
    """A product plan's hit runs the panelled launch: bitwise the general
    path's result, in a fresh tensor each call, ``k`` panels counted a
    hit, and the one-pass product within 1e-6 of |A||B|."""
    from csr_tpu_torch import tracing
    from csr_tpu_torch.kernels import cuda as cuda_k

    monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, 0.0),))
    a = _panel_matrix("long row")
    _force_panels(monkeypatch, a.shape[1], 50, 6, cuda_device)
    c = CSR.from_scipy(a, device=cuda_device)
    b = np.random.default_rng(143).uniform(-1, 1, (a.shape[1], 50)).astype(np.float32)
    bd = torch.from_numpy(b).to(cuda_device)
    rec = tracing.enable()
    try:
        with use_kernel("cuda"):
            general = c.mult_dense(bd)
            hits = [c.mult_dense(bd) for _ in range(3)]
        torch.cuda.synchronize()
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
    assert counters["plan.build"] == 1 and counters["plan.hit"] == 3
    assert counters["csr.spmm.panels"] == 4 * 6
    assert len({general.data_ptr()} | {h.data_ptr() for h in hits}) == 4
    for h in hits:
        assert torch.equal(h, general)
    one = spmm.spmm_csr(c.rowptrs, c.colinds, c.values, bd)
    gap = np.abs(general.cpu().numpy().astype(np.float64) - one.cpu().numpy())
    assert np.all(gap <= 1e-6 * _error_scale(a, b))


def test_spmm_hundreds_of_groups_a_window_b_past_l2_on_card(cuda_device):
    """One 128-row window over 480,189 columns, as a row window of the
    Netflix Prize ratings' transpose is (about 6,300 entries a row): 200
    groups of 32 micro-rows or more, each adding its sums atomically into
    the same 128 rows of C, times a B of 96 MB (480,189 x 50 f32), past
    the card's L2.  Through ``mult_dense`` (the micro-block route, then a
    plan's hit; ``csr.spmm.b_past_l2`` counts both) and on the layout
    alone, each against the float64 product within 1e-5 of |A||B| (the
    benchmark's limit at its ALS cells)."""
    from csr_tpu_torch import tracing
    from csr_tpu_torch.kernels import cuda as cuda_k

    rng = np.random.default_rng(21)
    ncols, per_row, n = 480_189, 6_600, 50
    rows = np.repeat(np.arange(128), per_row)
    cols = rng.integers(0, ncols, rows.size)
    vals = rng.uniform(-1, 1, rows.size).astype(np.float32)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(128, ncols)).tocsr()
    a.sum_duplicates()
    c = CSR.from_scipy(a, device=cuda_device)
    b = rng.standard_normal((ncols, n)).astype(np.float32)
    bd = torch.from_numpy(b).to(cuda_device)
    assert b.nbytes >= 96_000_000
    assert spmm.b_past_l2(ncols, n, cuda_k._l2_bytes(cuda_device))
    assert cuda_k._spmm_route(c, n) == "kernel"
    rec = tracing.enable()
    try:
        with use_kernel("cuda"):
            general = c.mult_dense(bd)
            hit = c.mult_dense(bd)
        torch.cuda.synchronize()
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
    assert counters["plan.hit"] == 1 and counters["csr.spmm.b_past_l2"] == 2
    layout = cuda_k._cached_layout(c)
    groups = cuda_k.group_counts(layout)
    assert groups["windows"] == 1 and groups["groups_max"] >= 200, groups
    alone = spmm.spmm(layout, bd)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = _error_scale(a, b)
    for got in (general, hit, alone):
        got = got.cpu().numpy().astype(np.float64)
        assert_product_close(got, ref)
        assert np.all(np.abs(got - ref) <= 1e-5 * scale)
