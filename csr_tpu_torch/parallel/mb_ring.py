"""
Ring SpMV on the micro-block kernel (counterpart of
:mod:`csr_tpu.parallel.mb_ring`).

Each shard holds one column shard of the dense operand and computes the
sub-matrix whose columns it currently holds, while the column shards
rotate around the ring:

* each row shard's entries are bucketed by source column shard, and each
  bucket is micro-block-packed with columns rebased to the shard (the
  column-shard width is a multiple of the window, so every micro-row
  falls in exactly one bucket).  The stacked layouts are byte-equal to
  the JAX package's;
* at ring step ``k`` shard ``d`` multiplies bucket ``held = (d + k) % D``
  on :func:`csr_tpu_torch.ops.spmv.spmv_bucket`: the bucket index is read
  on the device from the mesh's table, with no host read and no copy of
  the bucket, and the product is added into the shard's result, which is
  the ring's accumulator;
* the rotate for the next step is issued before the local product and
  waited on after it, so communication overlaps the kernel.

In the local form of the mesh one launch a step serves all ``D`` row
shards (``D`` launches a product); in the process form every rank
launches for its own shard.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from csr_tpu_torch.ops import microblock as mb
from csr_tpu_torch.ops import spmv as spmv_op
from . import partition
from .partition import Mesh, balanced_col_splits, balanced_row_splits


@dataclass
class RingMicroBlock:
    """Row-sharded, column-bucketed micro-block form.

    ``vals``/``meta`` are (D, D, M, 128) and ``rbcb`` (D, D, M):
    ``[row shard, column bucket, micro-row, slot]``, the leading axis laid
    over the mesh.  Columns inside bucket k are rebased by
    ``col_offset[k]``.  ``groups`` is the port's own: each bucket's count
    of 32-micro-row groups before its zero padding, which the kernel
    reads to skip the padding; it is derived from ``meta`` when left
    out."""

    TENSORS = ("vals", "meta", "rbcb", "groups")

    nrows: int
    ncols: int
    nnz: int
    n_shards: int
    rows_per_shard: int  # padded local row count (uniform)
    cols_per_shard: int  # operand slice per shard (window-aligned)
    window: int
    pair: int
    vals: torch.Tensor  # (D, D, M, 128) f32
    meta: torch.Tensor  # (D, D, M, 128) u16
    rbcb: torch.Tensor  # (D, D, M) i32
    row_offset: np.ndarray  # (D,) host
    nrows_local: np.ndarray  # (D,) host
    col_offset: np.ndarray = None  # (D+1,) host: nnz-balanced column splits
    groups: torch.Tensor = None  # (D, D) i32
    n_groups: int = None  # the largest entry of groups, over all shards

    def __post_init__(self):
        if self.groups is None:
            g = mb.real_microrows(self.meta.cpu().numpy(),
                                  self.window) // mb.ACC_GROUP
            self.groups = torch.from_numpy(g.astype(np.int32)).to(
                self.meta.device)
        if self.n_groups is None:
            self.n_groups = int(self.groups.max()) if self.groups.numel() else 0

    @property
    def nbytes(self) -> int:
        """Bytes of the stacked layouts this process holds."""
        return sum(t.numel() * t.element_size()
                   for t in (self.vals, self.meta, self.rbcb))

    @property
    def padding_share(self) -> float:
        """Share of the stack's 32-micro-row groups that are zero padding
        (buckets are padded to the largest one)."""
        total = self.rbcb.numel() // mb.ACC_GROUP
        return 1.0 - float(self.groups.sum()) / max(total, 1)

    @property
    def stack(self) -> mb.BucketStack:
        """The stacked layouts as :func:`~csr_tpu_torch.ops.spmv.spmv_bucket`
        takes them (views, no copy)."""
        return mb.BucketStack(
            self.rows_per_shard, self.cols_per_shard, self.window, self.vals,
            self.meta, self.rbcb, self.groups, self.n_groups,
        )

    def shard(self, mesh: Mesh) -> "RingMicroBlock":
        """Lay the row-shard axis out over ``mesh``."""
        return partition.sharded(self, mesh, self.TENSORS)


def partition_ring_mb(
    csr, n_shards: int, *, window: int | None = None
) -> RingMicroBlock:
    """Bucket a CSR by (row shard, column shard) and micro-block-pack
    every bucket (columns rebased to the shard).  Host tensors;
    ``.shard(mesh)`` places them."""
    rp, cis, vls = csr.host_arrays()
    rp, cis = np.asarray(rp), np.asarray(cis)
    vls = (np.ones(csr.nnz, np.float32) if vls is None
           else np.asarray(vls, dtype=np.float32))
    if window is None:
        window = mb.choose_window(rp, cis, csr.ncols)

    splits = balanced_row_splits(rp, n_shards)
    rows_per = max(int(np.max(np.diff(splits))), 1)
    rows_per = -(-rows_per // mb.LANE) * mb.LANE
    # nnz-balanced, window-aligned column shards: every micro-row lands in
    # one bucket, and buckets stay near nnz/D even on column-skewed
    # matrices (uniform splits inflate the padded max bucket up to Dx)
    csplits = balanced_col_splits(cis, csr.ncols, n_shards, align=window)
    cols_per = max(int(np.max(np.diff(csplits))), 1)
    cols_per = -(-cols_per // window) * window

    layouts = []
    for d in range(n_shards):
        r0, r1 = int(splits[d]), int(splits[d + 1])
        s0, s1 = int(rp[r0]), int(rp[r1])
        lcis = cis[s0:s1]
        lvls = vls[s0:s1]
        lrids = (
            np.repeat(np.arange(r0, r1), np.diff(rp[r0 : r1 + 1])) - r0
        ).astype(np.int64)
        shard_of_col = np.searchsorted(csplits[1:], lcis, side="right")
        row_buckets = []
        for k in range(n_shards):
            sel = shard_of_col == k
            bc = (lcis[sel] - csplits[k]).astype(np.int32)
            br = lrids[sel]
            # rebuild a local CSR for the bucket
            brp = np.zeros(rows_per + 1, np.int64)
            np.cumsum(np.bincount(br, minlength=rows_per), out=brp[1:])
            order = np.argsort(br, kind="stable")
            row_buckets.append(
                mb.build_microblocks_host(
                    rows_per, cols_per, brp, bc[order], lvls[sel][order],
                    window=window, pair=1, device="cpu",
                )
            )
        layouts.append(row_buckets)

    m_pad = max(l.vals.shape[0] for row in layouts for l in row)
    D = n_shards
    vals = np.zeros((D, D, m_pad, mb.LANE), np.float32)
    meta = np.zeros((D, D, m_pad, mb.LANE), np.uint16)
    rbcb = np.zeros((D, D, m_pad), np.int32)
    groups = np.zeros((D, D), np.int32)
    for d in range(D):
        for k in range(D):
            l = layouts[d][k]
            m = l.vals.shape[0]
            vals[d, k, :m] = l.vals.numpy()
            meta[d, k, :m] = l.meta.numpy()
            rbcb[d, k, :m] = l.rbcb.numpy()
            groups[d, k] = l.n_microrows // mb.ACC_GROUP

    return RingMicroBlock(
        csr.nrows, csr.ncols, csr.nnz, n_shards, rows_per, cols_per, window, 1,
        torch.from_numpy(vals), torch.from_numpy(meta), torch.from_numpy(rbcb),
        splits[:-1].astype(np.int64), np.diff(splits).astype(np.int64),
        csplits, torch.from_numpy(groups), int(groups.max(initial=0)),
    )


def scatter_x(rmb: RingMicroBlock, x, mesh: Mesh) -> torch.Tensor:
    """Column-shard the dense operand along the nnz-balanced splits:
    (D, cols_per_shard), each shard's slice zero-padded to the uniform
    width; this process's rows of it, on the mesh's device."""
    return mesh.local(
        partition.split_operand(x, rmb.col_offset, rmb.cols_per_shard))


def spmv_ring_mb(rmb: RingMicroBlock, x_sharded: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """``y = A @ x`` with x column-sharded, shards rotating on the ring,
    local compute on the bucket-selecting micro-block kernel.  Returns y
    as (n_local, rows_per_shard), row-sharded: (D, rows_per_shard) in the
    local form, the rank's (1, rows_per_shard) in the process form."""
    partition.check_sharded(rmb, mesh, "vals")
    D, stack, held = rmb.n_shards, rmb.stack, mesh.held
    x_cur = x_sharded
    y = torch.zeros(mesh.n_local, rmb.rows_per_shard, dtype=torch.float32,
                    device=mesh.device)
    for k in range(D):
        # issue the rotate FIRST so it overlaps the local kernel; the last
        # step's operand goes nowhere
        pending = mesh.rotate(x_cur) if k + 1 < D else None
        spmv_op.spmv_bucket(stack, held[k], x_cur, y)
        if pending is not None:
            x_cur = pending()
    return y


def collect_rows(rmb: RingMicroBlock, y_sharded: torch.Tensor) -> torch.Tensor:
    """Assemble the global dense result from the row-sharded outputs of
    all shards."""
    return partition.collect_rows(rmb.nrows_local, y_sharded)
