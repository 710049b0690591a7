"""
Ring SpMV in plain PyTorch (counterpart of :mod:`csr_tpu.parallel.ring`):
column-sharded operand with communication/compute overlap.

``spmv_halo`` all-gathers the whole dense operand before computing.  The
ring schedule instead has each shard hold one column shard of ``x``; at
step ``k`` it multiplies the sub-matrix whose columns live in the shard it
currently holds, while the shards rotate around the ring for the next
step.  This is the portable form and the oracle of
:mod:`csr_tpu_torch.parallel.mb_ring`, which runs the same schedule on
the micro-block kernel.

Preprocessing buckets each row shard's entries by source column shard:
``bucket[d][k]`` holds the entries of row shard ``d`` whose columns fall
in column shard ``k``, with columns rebased to the shard.  Buckets are
padded to a common length.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import partition
from .partition import Mesh, balanced_col_splits, balanced_row_splits


@dataclass
class RingCSR:
    """Row-sharded CSR with entries bucketed by source column shard."""

    TENSORS = ("colinds", "values", "row_ids")

    nrows: int
    ncols: int
    nnz: int
    n_shards: int
    rows_per_shard: int
    cols_per_shard: int
    bucket_len: int
    # (D, D, L): [row shard, column shard, entry]
    colinds: torch.Tensor  # int32 column index rebased to the column shard
    values: torch.Tensor   # float32, 0 in padding slots
    row_ids: torch.Tensor  # int32 row index rebased to the row shard
    row_offset: np.ndarray  # (D,) host
    nrows_local: np.ndarray  # (D,) host
    col_offset: np.ndarray = None  # (D+1,) host: nnz-balanced column splits

    def shard(self, mesh: Mesh) -> "RingCSR":
        """Lay the row-shard axis out over ``mesh``."""
        return partition.sharded(self, mesh, self.TENSORS)


def partition_ring(csr, n_shards: int) -> RingCSR:
    """Bucket a CSR by (row shard, column shard) for the ring schedule.

    Column shards are nnz-balanced (:func:`balanced_col_splits`): buckets
    pad to the max bucket, so a uniform column split would inflate memory
    by up to Dx on column-skewed matrices."""
    rp, cols, vals = csr.host_arrays()
    rp, cols = np.asarray(rp), np.asarray(cols)
    vals = (np.ones(csr.nnz, np.float32) if vals is None
            else np.asarray(vals, dtype=np.float32))
    rids = np.repeat(np.arange(csr.nrows, dtype=np.int32), np.diff(rp))

    splits = balanced_row_splits(rp, n_shards)
    csplits = balanced_col_splits(cols, csr.ncols, n_shards)
    cols_per = max(int(np.max(np.diff(csplits))), 1)
    rows_per = max(int(np.max(np.diff(splits))), 1)

    shard_of_row = np.searchsorted(splits[1:], rids, side="right")
    shard_of_col = np.searchsorted(csplits[1:], cols, side="right")

    counts = np.zeros((n_shards, n_shards), np.int64)
    for d in range(n_shards):
        sel = shard_of_row == d
        counts[d] = np.bincount(shard_of_col[sel], minlength=n_shards)
    L = max(int(counts.max()), 1)

    ci = np.zeros((n_shards, n_shards, L), np.int32)
    vl = np.zeros((n_shards, n_shards, L), np.float32)
    ri = np.zeros((n_shards, n_shards, L), np.int32)
    for d in range(n_shards):
        sel_d = shard_of_row == d
        for k in range(n_shards):
            sel = sel_d & (shard_of_col == k)
            n = int(sel.sum())
            ci[d, k, :n] = cols[sel] - csplits[k]
            vl[d, k, :n] = vals[sel]
            ri[d, k, :n] = rids[sel] - splits[d]
            # padding rows point at the shard's padded extra row; value 0
            ri[d, k, n:] = rows_per

    return RingCSR(
        csr.nrows, csr.ncols, csr.nnz, n_shards, rows_per, cols_per, L,
        torch.from_numpy(ci), torch.from_numpy(vl), torch.from_numpy(ri),
        splits[:-1].astype(np.int32), np.diff(splits).astype(np.int32),
        col_offset=csplits,
    )


def scatter_x(rcsr: RingCSR, x, mesh: Mesh) -> torch.Tensor:
    """Column-shard the dense operand along the nnz-balanced splits: flat
    (n_local * cols_per_shard,), shard k holding its column slice
    zero-padded to the uniform ``cols_per_shard``, on the mesh's device."""
    xs = partition.split_operand(x, rcsr.col_offset, rcsr.cols_per_shard)
    return mesh.local(xs).reshape(-1)


def spmv_ring(rcsr: RingCSR, x_sharded: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``y = A @ x`` with x column-sharded; shards rotate around the ring.

    ``x_sharded`` is the dense operand as :func:`scatter_x` lays it out.
    Returns y as (n_local, rows_per_shard), row-sharded."""
    partition.check_sharded(rcsr, mesh, "values")
    D, rows_per = rcsr.n_shards, rcsr.rows_per_shard
    local = torch.arange(mesh.n_local, device=mesh.device)
    x_cur = x_sharded.reshape(mesh.n_local, rcsr.cols_per_shard)
    acc = torch.zeros(mesh.n_local, rows_per + 1, dtype=rcsr.values.dtype,
                      device=mesh.device)
    for k in range(D):
        # overlap: the next shard starts moving while we compute on x_cur
        pending = mesh.rotate(x_cur) if k + 1 < D else None
        held = mesh.held[k].long()  # which column shard each shard holds
        cb = rcsr.colinds[local, held].long()
        vb = rcsr.values[local, held]
        rb = rcsr.row_ids[local, held].long()
        acc.scatter_add_(1, rb, vb * torch.gather(x_cur, 1, cb))
        if pending is not None:
            x_cur = pending()
    return acc[:, :rows_per]
