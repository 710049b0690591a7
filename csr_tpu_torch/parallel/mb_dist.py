"""
Distributed micro-block SpMV (counterpart of
:mod:`csr_tpu.parallel.mb_dist`): rows are partitioned into nnz-balanced
shards, each shard is packed into the micro-block layout
(:mod:`csr_tpu_torch.ops.microblock`), the stacked layouts are laid out
over the mesh, and every shard's product runs the micro-block SpMV kernel
(:func:`csr_tpu_torch.ops.spmv.spmv`) on a view of the stack, with no
copy.

Two dense-operand strategies:

* :func:`spmv`      -- x replicated; no collectives in the hot loop.
* :func:`spmv_halo` -- x column-sharded over the same mesh; each shard
  ``all_gather``\\ s the operand before its local product.

:func:`spmv_t` multiplies by the transpose from per-shard transposed
layouts and reduces the partial results with ``psum`` or
``psum_scatter``.

Shapes are uniform across shards (micro-row counts padded to the max, row
windows padded to the max shard height), and the stacked arrays are
byte-equal to the JAX package's; padded slots carry zero values and never
affect results.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from csr_tpu_torch import native
from csr_tpu_torch.ops import microblock as mb
from csr_tpu_torch.ops import spmv as spmv_op
from . import partition
from .partition import Mesh, balanced_row_splits


@dataclass
class DistMicroBlock:
    """Row-sharded micro-block form: per-shard layouts stacked on a
    leading shard axis.  ``microrows`` is the port's own: each shard's
    micro-row count before its zero padding, derived from ``meta`` when
    left out."""

    TENSORS = ("vals", "meta", "rbcb")

    nrows: int
    ncols: int
    nnz: int
    n_shards: int
    rows_per_shard: int  # padded local row count (uniform)
    window: int
    pair: int
    vals: torch.Tensor  # (D, M, 128) f32
    meta: torch.Tensor  # (D, M, 128) u16
    rbcb: torch.Tensor  # (D, M) i32
    row_offset: np.ndarray  # (D,) host
    nrows_local: np.ndarray  # (D,) host
    microrows: np.ndarray = None  # (D,) host, over all shards

    def __post_init__(self):
        if self.microrows is None:
            self.microrows = mb.real_microrows(self.meta.cpu().numpy(),
                                               self.window)

    @property
    def cols_per_shard(self) -> int:
        """Per-shard operand slice length for the halo form (lane-aligned)."""
        per = -(-self.ncols // self.n_shards)
        return -(-per // mb.LANE) * mb.LANE

    @property
    def nbytes(self) -> int:
        """Bytes of the stacked layouts this process holds."""
        return sum(t.numel() * t.element_size()
                   for t in (self.vals, self.meta, self.rbcb))

    def shard(self, mesh: Mesh) -> "DistMicroBlock":
        """Lay the shard axis out over ``mesh``."""
        return partition.sharded(self, mesh, self.TENSORS)

    def _view(self, mesh: Mesh, l: int, nrows: int, ncols: int):
        """Local shard ``l``'s layout, as views of the stack."""
        return mb.MicroBlockLayout(
            nrows, ncols, 0, int(self.microrows[mesh.first + l]),
            self.vals[l], self.meta[l], self.rbcb[l], self.window, self.pair,
        )


def _stack(layouts, n_shards):
    m_pad = max(l.vals.shape[0] for l in layouts)
    vals = np.zeros((n_shards, m_pad, mb.LANE), np.float32)
    meta = np.zeros((n_shards, m_pad, mb.LANE), np.uint16)
    rbcb = np.zeros((n_shards, m_pad), np.int32)
    for d, l in enumerate(layouts):
        m = l.vals.shape[0]
        vals[d, :m] = l.vals.numpy()
        meta[d, :m] = l.meta.numpy()
        rbcb[d, :m] = l.rbcb.numpy()
    microrows = np.asarray([l.n_microrows for l in layouts], np.int64)
    return (torch.from_numpy(vals), torch.from_numpy(meta),
            torch.from_numpy(rbcb)), microrows


def partition_microblocks(
    csr, n_shards: int, *, window: int | None = None
) -> DistMicroBlock:
    """Partition rows (nnz-balanced) and micro-block-pack each shard.

    The window width is chosen once for the whole matrix so every shard
    runs the same kernel variant.  Host tensors; ``.shard(mesh)`` places
    them."""
    rp, cis, vls = csr.host_arrays()
    rp, cis = np.asarray(rp), np.asarray(cis)
    splits = balanced_row_splits(rp, n_shards)
    rows_per = max(int(np.max(np.diff(splits))), 1)
    # round the padded shard height to whole row windows
    rows_per = -(-rows_per // mb.LANE) * mb.LANE
    if window is None:
        window = mb.choose_window(rp, cis, csr.ncols)

    layouts = []
    for d in range(n_shards):
        r0, r1 = int(splits[d]), int(splits[d + 1])
        s0, s1 = int(rp[r0]), int(rp[r1])
        lrp = (rp[r0 : r1 + 1] - rp[r0]).astype(np.int64)
        # pad local rowptrs to the uniform shard height (empty rows)
        lrp = np.concatenate([lrp, np.full(rows_per - (r1 - r0), lrp[-1])])
        layouts.append(
            mb.build_microblocks_host(
                rows_per, csr.ncols, lrp, cis[s0:s1],
                None if vls is None else np.asarray(vls)[s0:s1],
                window=window, pair=1, device="cpu",
            )
        )

    stacked, microrows = _stack(layouts, n_shards)
    return DistMicroBlock(
        csr.nrows, csr.ncols, csr.nnz, n_shards, rows_per, window, 1,
        *stacked,
        splits[:-1].astype(np.int64), np.diff(splits).astype(np.int64),
        microrows,
    )


def _local_products(dmb, mesh: Mesh, operand, nrows: int, ncols: int, width):
    """Every local shard's kernel product, stacked: (n_local, width) f32
    whose first ``nrows`` columns hold ``A_l @ operand(l)``."""
    partition.check_sharded(dmb, mesh, "vals")
    out = torch.zeros(mesh.n_local, width, dtype=torch.float32,
                      device=mesh.device)
    for l in range(mesh.n_local):
        spmv_op.spmv(dmb._view(mesh, l, nrows, ncols), operand(l),
                     out=out[l, :nrows])
    return out


def spmv(dmb: DistMicroBlock, x, mesh: Mesh) -> torch.Tensor:
    """``y = A @ x`` with x replicated; every shard runs the micro-block
    kernel on its rows.  Returns (n_local, rows_per_shard) row-sharded;
    use :func:`collect_rows` for the global vector."""
    x = torch.as_tensor(x).to(device=mesh.device, dtype=torch.float32)
    return _local_products(dmb, mesh, lambda l: x, dmb.rows_per_shard,
                           dmb.ncols, dmb.rows_per_shard)


def spmv_halo(dmb: DistMicroBlock, x_sharded: torch.Tensor,
              mesh: Mesh) -> torch.Tensor:
    """``y = A @ x`` with the dense operand column-sharded over the same
    mesh: ``x_sharded`` is (n_local, cols_per_shard), shard d holding x's
    slice ``[d*cols_per : (d+1)*cols_per]`` (zero-padded past ncols).

    Each shard ``all_gather``\\ s the operand and runs the local kernel on
    its first ``ncols`` elements: a shard holds only its rows plus one
    gathered operand copy."""
    xg = mesh.all_gather(x_sharded)[: dmb.ncols]
    return _local_products(dmb, mesh, lambda l: xg, dmb.rows_per_shard,
                           dmb.ncols, dmb.rows_per_shard)


@dataclass
class DistMicroBlockT(DistMicroBlock):
    """Transposed row shards for distributed ``A^T @ y``.

    Shard ``d`` holds the micro-block layout of ``(A_d)^T`` where ``A_d``
    is row shard ``d`` of A.  Each shard's local product covers the FULL
    column space (its shard's contribution), so results combine with one
    ``psum`` (replicated output) or ``psum_scatter`` (column-sharded
    output), never a dense scatter-add over the column space.
    ``rows_per_shard`` is the padded local OPERAND length."""


def partition_microblocks_t(
    csr, n_shards: int, *, window: int | None = None
) -> DistMicroBlockT:
    """Row-partition A (nnz-balanced), transpose each shard on the host
    (native counting sort when available), and micro-block-pack the
    transposes.  One window width serves all shards so every shard runs
    the same kernel variant."""
    rp, cis, vls = csr.host_arrays()
    rp, cis = np.asarray(rp), np.asarray(cis)
    vls = (np.ones(csr.nnz, np.float32) if vls is None
           else np.asarray(vls, dtype=np.float32))
    splits = balanced_row_splits(rp, n_shards)
    rows_per = max(int(np.max(np.diff(splits))), 1)
    rows_per = -(-rows_per // mb.LANE) * mb.LANE

    shard_t = []
    for d in range(n_shards):
        r0, r1 = int(splits[d]), int(splits[d + 1])
        s0, s1 = int(rp[r0]), int(rp[r1])
        lrp = (rp[r0 : r1 + 1] - rp[r0]).astype(np.int64)
        shard_t.append(native.transpose_host(
            r1 - r0, csr.ncols, lrp, cis[s0:s1], vls[s0:s1]))

    # one window for every shard: 256 only where every shard's is
    if window is None:
        window = min(mb.choose_window(t[0], t[1], rows_per) for t in shard_t)

    layouts = [
        mb.build_microblocks_host(
            csr.ncols, rows_per, t_rps, t_cis, t_vls, window=window,
            pair=1, device="cpu",
        )
        for t_rps, t_cis, t_vls in shard_t
    ]

    stacked, microrows = _stack(layouts, n_shards)
    return DistMicroBlockT(
        csr.nrows, csr.ncols, csr.nnz, n_shards, rows_per, window, 1,
        *stacked,
        splits[:-1].astype(np.int64), np.diff(splits).astype(np.int64),
        microrows,
    )


def spmv_t(dmbt: DistMicroBlockT, y_sharded: torch.Tensor, mesh: Mesh,
           *, scatter: bool = False) -> torch.Tensor:
    """``x = A^T @ y`` on the micro-block kernel per shard.

    ``y_sharded`` is (n_local, rows_per_shard) row-sharded (e.g. the
    output of :func:`spmv`).  Each shard multiplies its transposed layout
    by its local y slice, a full-column-space partial, and the partials
    reduce with ``psum`` (returns the replicated dense vector of length
    ncols) or, with ``scatter=True``, ``psum_scatter`` (returns
    (n_local, ncols_pad / D) column-sharded, which keeps a shard's output
    at 1/D; :func:`collect_cols_t` assembles it)."""
    D = dmbt.n_shards
    out_pad = max(-(-dmbt.ncols // mb.LANE), 1) * mb.LANE
    # psum_scatter needs the scattered axis divisible by D
    out_scat = -(-out_pad // (D * mb.LANE)) * (D * mb.LANE)
    y_sharded = y_sharded.to(torch.float32)
    parts = _local_products(dmbt, mesh, lambda l: y_sharded[l], dmbt.ncols,
                            dmbt.rows_per_shard,
                            out_scat if scatter else dmbt.ncols)
    if scatter:
        return mesh.psum_scatter(parts.view(-1, D, out_scat // D))
    return mesh.psum(parts)


def collect_cols_t(dmbt: DistMicroBlockT, x_scattered: torch.Tensor):
    """Assemble the dense ``A^T y`` result from the ``scatter=True`` form
    of :func:`spmv_t` (the column-sharded outputs of all shards)."""
    if x_scattered.shape[0] != dmbt.n_shards:
        raise ValueError(f"collect_cols_t needs all {dmbt.n_shards} shards, "
                         f"got {x_scattered.shape[0]}")
    return x_scattered.reshape(-1)[: dmbt.ncols]


def scatter_x(dmb: DistMicroBlock, x, mesh: Mesh) -> torch.Tensor:
    """Column-shard a dense operand for :func:`spmv_halo`:
    (D, cols_per_shard) with x laid out contiguously and zero-padded;
    this process's rows of it, on the mesh's device."""
    d, cp = dmb.n_shards, dmb.cols_per_shard
    # uniform slices of the operand zero-padded to d * cp
    offsets = np.minimum(np.arange(d + 1) * cp, dmb.ncols)
    return mesh.local(partition.split_operand(x, offsets, cp))


def collect_rows(dmb: DistMicroBlock, y_sharded: torch.Tensor) -> torch.Tensor:
    """Assemble the global dense result from the row-sharded outputs of
    all shards."""
    return partition.collect_rows(dmb.nrows_local, y_sharded)
