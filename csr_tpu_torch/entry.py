"""
Entry points (counterpart of ``__graft_entry__.py``).

``entry()``             -- the flagship single-device forward step, the
                          micro-block SpMV, as ``(fn, example_args)``.
``dryrun_multichip(n)`` -- one full distributed step over an ``n``-shard
                          mesh in the local form: row-partitioned SpMV with
                          a column-sharded operand, transpose SpMV with
                          psum, SpMM, then the micro-block halo SpMV, each
                          checked against the host product.

Both run on :func:`csr_tpu_torch.kernels.default_device` (the card when
there is one) unless the caller names a device.

    python -m csr_tpu_torch.entry
"""

from __future__ import annotations

import numpy as np
import torch

from csr_tpu_torch.kernels import default_device


def entry(device=None):
    """Return ``(fn, example_args)`` for the flagship forward step:
    ``fn(vals, meta, rbcb, x)`` is the micro-block SpMV of a seeded
    1024 x 1024 matrix on ``device``."""
    import scipy.sparse as sps

    from csr_tpu_torch import CSR
    from csr_tpu_torch.ops import microblock, spmv as spmv_op

    device = default_device() if device is None else torch.device(device)
    rng = np.random.default_rng(0)
    m = sps.random(1024, 1024, 0.02, format="csr", random_state=rng)
    csr = CSR.from_scipy(m, device=device)
    layout = microblock.build_microblocks(csr)

    def step(vals, meta, rbcb, x):
        return spmv_op.spmv(
            microblock.MicroBlockLayout(
                layout.nrows, layout.ncols, layout.nnz, layout.n_microrows,
                vals, meta, rbcb, layout.window, layout.pair), x)

    x = rng.standard_normal(layout.ncols).astype(np.float32)
    example_args = (layout.vals, layout.meta, layout.rbcb,
                    torch.from_numpy(x).to(device))
    return step, example_args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run one distributed step on an ``n_devices``-shard mesh (local
    form, on ``device``) and check it against the host products."""
    import scipy.sparse as sps

    from csr_tpu_torch import CSR
    from csr_tpu_torch.parallel import dist, mb_dist
    from csr_tpu_torch.parallel.partition import make_mesh, partition_rows

    mesh = make_mesh(n_devices, device=device)

    rng = np.random.default_rng(0)
    nrows, ncols = 16 * n_devices, 8 * n_devices
    m = sps.random(nrows, ncols, 0.2, format="csr", random_state=rng)
    csr = CSR.from_scipy(m, device=mesh.device)
    d = partition_rows(csr, n_devices).shard(mesh)

    pad_cols = -(-ncols // n_devices) * n_devices
    xp = np.zeros(pad_cols, np.float32)
    xp[:ncols] = rng.standard_normal(ncols)
    B = rng.standard_normal((ncols, 8)).astype(np.float32)

    # forward: row-sharded SpMV with column-sharded operand (halo gather)
    y = dist.spmv_halo(d, torch.from_numpy(xp), mesh)
    # backward/transpose: psum-reduced A^T y
    g = dist.spmv_t(d, y, mesh)
    # dense-tall product
    C = dist.spmm(d, B, mesh)
    assert C.shape == (n_devices, d.rows_per_shard, 8)

    # sanity: parity with host computation
    ref = m @ xp[:ncols]
    yg = dist.collect_rows(d, y).cpu().numpy()
    np.testing.assert_allclose(yg, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(g.cpu().numpy(), m.T @ ref, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(dist.collect_rows(d, C).cpu().numpy(), m @ B,
                               rtol=1e-3, atol=1e-3)

    # the tuned path: per-shard micro-block kernels, halo (all_gather)
    # operand form
    dmb = mb_dist.partition_microblocks(csr, n_devices).shard(mesh)
    xs = mb_dist.scatter_x(dmb, xp[:ncols], mesh)
    yh = mb_dist.spmv_halo(dmb, xs, mesh)
    yhg = mb_dist.collect_rows(dmb, yh).cpu().numpy()
    np.testing.assert_allclose(yhg, ref, rtol=1e-3, atol=1e-3)
    print(f"dryrun_multichip({n_devices}): ok on {mesh.device}")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), "on", out.device)
    dryrun_multichip(4)
