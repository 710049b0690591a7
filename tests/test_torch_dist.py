"""The port's distributed ops in the mesh's local form against the JAX
package's on 8 virtual CPU devices (Pallas kernels in interpret mode), and
against scipy: stacked layouts byte for byte, then ``mb_dist.spmv``,
``spmv_halo`` and ``spmv_t`` (replicated and scattered), the portable
``dist`` ops, and the entry points.  Tolerances are those of
``tests/test_distributed.py``, unchanged."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
import jax
import jax.numpy as jnp

from csr_tpu.parallel import dist as ref_dist
from csr_tpu.parallel import mb_dist as ref_mb_dist
from csr_tpu.parallel.partition import make_mesh as ref_make_mesh
from csr_tpu.parallel.partition import partition_rows as ref_partition_rows
from csr_tpu_torch import entry
from csr_tpu_torch.ops import spmv as spmv_op
from csr_tpu_torch.parallel import dist, mb_dist
from csr_tpu_torch.parallel.partition import make_mesh, partition_rows
from csr_tpu_torch.utils.serialization import parallel_from_arrays

from torch_util import (Scipy, assert_same_partition, both_csr, fields_of,
                        port_chooser)
from util import assert_spmv_close

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8,
                                   reason="needs 8 virtual devices")
MB_TENSORS = ("vals", "meta", "rbcb")
D = 8


def _matrix(shape, density, seed):
    rng = np.random.default_rng(seed)
    m = sps.random(*shape, density, format="csr", random_state=rng,
                   dtype=np.float32)
    return m, rng


@pytest.mark.parametrize("structure_only", [False, True])
@pytest.mark.parametrize("window", [None, 128, 256])
def test_dist_layouts_byte_equal(window, structure_only, monkeypatch):
    port_chooser(monkeypatch)
    m, _ = _matrix((700, 900), 0.05, 5)
    ref_csr, csr = both_csr(m, structure_only)
    for ref_fn, fn, cls in (
        (ref_mb_dist.partition_microblocks, mb_dist.partition_microblocks,
         mb_dist.DistMicroBlock),
        (ref_mb_dist.partition_microblocks_t, mb_dist.partition_microblocks_t,
         mb_dist.DistMicroBlockT),
    ):
        ref = ref_fn(ref_csr, D, window=window)
        port = fn(csr, D, window=window)
        assert type(port) is cls
        assert_same_partition(port, ref, MB_TENSORS)
        carried = parallel_from_arrays(cls, fields_of(ref))
        assert_same_partition(carried, ref, MB_TENSORS)
        np.testing.assert_array_equal(carried.microrows, port.microrows)
        if cls is mb_dist.DistMicroBlock:
            assert port.cols_per_shard == ref.cols_per_shard


@needs_devices
@pytest.mark.parametrize("window", [None, 256])
def test_mb_dist_spmv_and_halo(window):
    m, rng = _matrix((700, 900), 0.05, 5)
    ref_csr, csr = both_csr(m)
    x = rng.standard_normal(900).astype(np.float32)
    ref_mesh, mesh = ref_make_mesh(D), make_mesh(D, device="cpu")
    rdmb = ref_mb_dist.partition_microblocks(ref_csr, D, window=window).shard(ref_mesh)
    y_ref = np.asarray(ref_mb_dist.collect_rows(
        rdmb, ref_mb_dist.spmv(rdmb, x, ref_mesh, interpret=True)))
    yh_ref = np.asarray(ref_mb_dist.collect_rows(rdmb, ref_mb_dist.spmv_halo(
        rdmb, ref_mb_dist.scatter_x(rdmb, x, ref_mesh), ref_mesh, interpret=True)))
    expect = m.astype(np.float64) @ x

    before = spmv_op.launches
    for dmb in (mb_dist.partition_microblocks(csr, D, window=window),
                parallel_from_arrays(mb_dist.DistMicroBlock, fields_of(rdmb))):
        dmb = dmb.shard(mesh)
        y = mb_dist.spmv(dmb, x, mesh)
        assert y.shape == (D, dmb.rows_per_shard) and y.dtype == torch.float32
        xs = mb_dist.scatter_x(dmb, x, mesh)
        assert xs.shape == (D, dmb.cols_per_shard)
        yh = mb_dist.spmv_halo(dmb, xs, mesh)
        for got, ref in ((y, y_ref), (yh, yh_ref)):
            got = mb_dist.collect_rows(dmb, got).numpy()
            assert_spmv_close(got, ref, Scipy(m), x)
            assert_spmv_close(got, expect, Scipy(m), x)
            np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-4)
    assert spmv_op.launches == before, "a CPU call counted a launch"


@needs_devices
@pytest.mark.parametrize("structure_only", [False, True])
def test_mb_dist_spmv_t_both_forms(structure_only):
    m, rng = _matrix((700, 500), 0.05, 13)
    ref_csr, csr = both_csr(m, structure_only)
    if structure_only:
        m = sps.csr_matrix((np.ones(m.nnz, np.float32), m.indices, m.indptr),
                           shape=m.shape)
    x = rng.standard_normal(500).astype(np.float32)
    ref_mesh, mesh = ref_make_mesh(D), make_mesh(D, device="cpu")
    rdmb = ref_mb_dist.partition_microblocks(ref_csr, D).shard(ref_mesh)
    rdmbt = ref_mb_dist.partition_microblocks_t(ref_csr, D).shard(ref_mesh)
    y_ref = ref_mb_dist.spmv(rdmb, x, ref_mesh, interpret=True)
    xt_ref = np.asarray(ref_mb_dist.spmv_t(rdmbt, y_ref, ref_mesh, interpret=True))
    xs_ref = np.asarray(ref_mb_dist.spmv_t(rdmbt, y_ref, ref_mesh, interpret=True,
                                           scatter=True))
    expect = m.T @ (m @ x)

    dmb = mb_dist.partition_microblocks(csr, D).shard(mesh)
    dmbt = mb_dist.partition_microblocks_t(csr, D).shard(mesh)
    assert dmbt.rows_per_shard == dmb.rows_per_shard
    y = mb_dist.spmv(dmb, x, mesh)
    xt = mb_dist.spmv_t(dmbt, y, mesh)
    assert xt.shape == (500,)
    xs = mb_dist.spmv_t(dmbt, y, mesh, scatter=True)
    assert xs.shape == xs_ref.shape
    xsg = mb_dist.collect_cols_t(dmbt, xs)
    for got in (xt.numpy(), xsg.numpy()):
        np.testing.assert_allclose(got, xt_ref, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(xs.numpy(), xs_ref, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError):
        mb_dist.collect_cols_t(dmbt, xs[:1])


def test_mb_dist_more_shards_than_rows_and_empty():
    """``D`` past the row count leaves empty shards; ``nnz == 0`` leaves
    every layout empty."""
    mesh = make_mesh(D, device="cpu")
    for m in (_matrix((5, 300), 0.3, 3)[0],
              sps.csr_matrix((40, 30), dtype=np.float32)):
        _, csr = both_csr(m)
        x = np.random.default_rng(1).uniform(-1, 1, m.shape[1]).astype(np.float32)
        dmb = mb_dist.partition_microblocks(csr, D).shard(mesh)
        y = mb_dist.collect_rows(dmb, mb_dist.spmv(dmb, x, mesh)).numpy()
        assert_spmv_close(y, m.astype(np.float64) @ x, Scipy(m), x)
        dmbt = mb_dist.partition_microblocks_t(csr, D).shard(mesh)
        xt = mb_dist.spmv_t(dmbt, mb_dist.spmv(dmb, x, mesh), mesh).numpy()
        np.testing.assert_allclose(xt, m.T @ (m @ x), rtol=1e-4, atol=1e-3)


@needs_devices
def test_portable_dist_ops():
    m, rng = _matrix((96, 64), 0.08, 7)
    ref_csr, csr = both_csr(m)
    ref_mesh, mesh = ref_make_mesh(D), make_mesh(D, device="cpu")
    rd = ref_partition_rows(ref_csr, D).shard(ref_mesh)
    d = partition_rows(csr, D).shard(mesh)
    x = rng.standard_normal(64).astype(np.float32)
    B = rng.standard_normal((64, 12)).astype(np.float32)

    y_ref = ref_dist.spmv(rd, jnp.asarray(x), ref_mesh)
    y = dist.spmv(d, x, mesh)
    assert y.shape == (D, d.rows_per_shard)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dist.collect_rows(d, y).numpy(), m @ x,
                               rtol=1e-4, atol=1e-4)

    yh_ref = ref_dist.spmv_halo(rd, jnp.asarray(x), ref_mesh)  # 64 = 8 * 8
    yh = dist.spmv_halo(d, torch.from_numpy(x), mesh)
    np.testing.assert_allclose(yh.numpy(), np.asarray(yh_ref), rtol=1e-4, atol=1e-4)

    yt_ref = np.asarray(ref_dist.spmv_t(rd, y_ref, ref_mesh))
    yt = dist.spmv_t(d, y, mesh).numpy()
    np.testing.assert_allclose(yt, yt_ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(yt, m.T @ (m @ x), rtol=1e-4, atol=1e-3)

    C_ref = np.asarray(ref_dist.spmm(rd, jnp.asarray(B), ref_mesh))
    C = dist.spmm(d, B, mesh)
    assert C.shape == C_ref.shape
    np.testing.assert_allclose(C.numpy(), C_ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(dist.collect_rows(d, C).numpy(), m @ B,
                               rtol=1e-4, atol=1e-3)


def test_portable_dist_structure_only_and_empty_rows():
    m, rng = _matrix((30, 40), 0.1, 9)
    _, csr = both_csr(m, structure_only=True)
    ones = sps.csr_matrix((np.ones(m.nnz, np.float32), m.indices, m.indptr),
                          shape=m.shape)
    mesh = make_mesh(4, device="cpu")
    d = partition_rows(csr, 4).shard(mesh)
    x = rng.standard_normal(40).astype(np.float32)
    y = dist.spmv(d, x, mesh)
    np.testing.assert_allclose(dist.collect_rows(d, y).numpy(), ones @ x,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dist.spmv_t(d, y, mesh).numpy(),
                               ones.T @ (ones @ x), rtol=1e-4, atol=1e-3)


def test_entry_points_on_cpu(capsys):
    fn, args = entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (1024,) and out.device.type == "cpu"
    assert torch.all(torch.isfinite(out)) and out.abs().sum() > 0
    entry.dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip(8): ok on cpu" in capsys.readouterr().out
