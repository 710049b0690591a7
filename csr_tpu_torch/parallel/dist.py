"""
Distributed sparse operations over a mesh, in plain PyTorch (counterpart
of :mod:`csr_tpu.parallel.dist`).

Matrices are row-sharded over the mesh
(:mod:`csr_tpu_torch.parallel.partition`), the dense operand is either
replicated or column-sharded, and the collectives are the mesh's
(``all_gather`` / ``psum``).  These are the portable forms: what
:mod:`csr_tpu_torch.kernels.torch` is to the single-device ops, and the
oracle that the micro-block forms (:mod:`~csr_tpu_torch.parallel.mb_dist`)
are checked against.

Operations:

* ``spmv(dcsr, x)``       -- ``y = A @ x``; x replicated, y row-sharded.
* ``spmv_halo(dcsr, xs)`` -- x column-sharded; each shard all-gathers it
                             before local compute.
* ``spmv_t(dcsr, y)``     -- ``x = A^T @ y``; y row-sharded, result
                             psum-reduced.
* ``spmm(dcsr, B)``       -- ``C = A @ B`` with dense B; C row-sharded.

Local compute is a gather of the operand, a scaling by the values and a
``scatter_add_`` into the rows, over all local shards at once.
"""

from __future__ import annotations

import torch

from . import partition
from .partition import DistCSR, Mesh


def _local_row_ids(rowptrs: torch.Tensor, nnz_per: int) -> torch.Tensor:
    """Row ids (n_local, nnz_per) int64 of the padded shards' entries: the
    count of row ends at or before each position.  Padded entries map to
    row ``rows_per_shard``, one past the shard's rows, whose output is
    sliced off."""
    pos = torch.arange(nnz_per, device=rowptrs.device).expand(
        rowptrs.shape[0], nnz_per)
    return torch.searchsorted(rowptrs[:, 1:].contiguous(), pos.contiguous(),
                              right=True)


def _operands(dcsr: DistCSR, mesh: Mesh):
    partition.check_sharded(dcsr, mesh, "rowptrs")
    rids = _local_row_ids(dcsr.rowptrs, dcsr.colinds.shape[1])
    return rids, dcsr.colinds.long(), dcsr.values


def _local_spmv(dcsr: DistCSR, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Dense-operand local SpMV on every local shard (padded shapes)."""
    rids, cis, vls = _operands(dcsr, mesh)
    y = torch.zeros(mesh.n_local, dcsr.rows_per_shard + 1, dtype=vls.dtype,
                    device=mesh.device)
    y.scatter_add_(1, rids, vls * x.to(vls.dtype)[cis])
    return y[:, : dcsr.rows_per_shard]


def spmv(dcsr: DistCSR, x, mesh: Mesh) -> torch.Tensor:
    """``y = A @ x`` with A row-sharded and x replicated.

    Returns y as (n_local, rows_per_shard) row-sharded; use
    :func:`collect_rows` for the dense global vector."""
    return _local_spmv(dcsr, mesh, torch.as_tensor(x).to(mesh.device))


def spmv_halo(dcsr: DistCSR, x_sharded, mesh: Mesh) -> torch.Tensor:
    """``y = A @ x`` with x *column-sharded* over the same mesh:
    ``x_sharded`` is the dense operand padded to a multiple of D, flat
    (D * n,) in the local form, the rank's (n,) slice in the process form.
    Each shard all-gathers the operand before local compute."""
    xs = torch.as_tensor(x_sharded).to(mesh.device).reshape(mesh.n_local, -1)
    return _local_spmv(dcsr, mesh, mesh.all_gather(xs))


def spmv_t(dcsr: DistCSR, y_sharded: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x = A^T @ y``: every shard computes its contribution to the full
    column space, then ``psum`` reduces across shards.

    ``y_sharded`` is (n_local, rows_per_shard) row-sharded (e.g. the
    output of :func:`spmv`).  Result is the replicated dense vector of
    length ncols."""
    rids, cis, vls = _operands(dcsr, mesh)
    # padded entries (row id rows_per_shard) read the appended zero
    yp = torch.nn.functional.pad(y_sharded.to(vls.dtype), (0, 1))
    contrib = torch.zeros(mesh.n_local, dcsr.ncols, dtype=vls.dtype,
                          device=mesh.device)
    contrib.scatter_add_(1, cis, vls * torch.gather(yp, 1, rids))
    return mesh.psum(contrib)


def spmm(dcsr: DistCSR, b_dense, mesh: Mesh) -> torch.Tensor:
    """``C = A @ B`` with dense B replicated; C row-sharded
    (n_local, rows_per_shard, B.ncols)."""
    rids, cis, vls = _operands(dcsr, mesh)
    b = torch.as_tensor(b_dense).to(device=mesh.device, dtype=vls.dtype)
    n = b.shape[1]
    out = torch.zeros(mesh.n_local, dcsr.rows_per_shard + 1, n,
                      dtype=vls.dtype, device=mesh.device)
    out.scatter_add_(1, rids[:, :, None].expand(-1, -1, n),
                     vls[:, :, None] * b[cis])
    return out[:, : dcsr.rows_per_shard]


def collect_rows(dcsr, y_sharded: torch.Tensor) -> torch.Tensor:
    """Assemble the global dense result vector (or matrix) from the
    row-sharded outputs of all shards, dropping row padding.  Serves any
    of the partitioned forms (it reads ``nrows_local``)."""
    return partition.collect_rows(dcsr.nrows_local, y_sharded)
