"""
Row partitioning of CSR matrices over a mesh of shards (counterpart of
:mod:`csr_tpu.parallel.partition`).

Rows are split into ``n_shards`` nnz-balanced partitions, padded to a
common shape and stacked on a leading shard axis, exactly as the JAX
package stacks them.  Padded entries have value 0 and column 0, so they
never affect results.

A :class:`Mesh` says where the shards live.  It has two forms:

* the **local form** (no process group): one process holds all
  ``n_shards`` shards on one device, stacked on the leading axis.  This is
  the counterpart of one host with ``D`` (virtual) devices.  The
  collectives are tensor ops on the stack, and results have the JAX
  package's global shapes, ``(D, rows_per_shard)``;
* the **process form** (a ``torch.distributed`` process group of
  ``n_shards`` ranks): rank ``r`` keeps slice ``r`` of the leading axis
  on its own device, the collectives are ``torch.distributed``'s, and
  results are the rank's ``(1, rows_per_shard)`` shard (the counterpart
  of a global array's addressable shard).

Each distributed op is one step function for both forms; only the
:class:`Mesh` method it calls differs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import cached_property

import numpy as np
import torch

from csr_tpu_torch.kernels import default_device


def balanced_row_splits(rowptrs_host: np.ndarray, n_shards: int) -> np.ndarray:
    """nnz-balanced row split points: ``n_shards + 1`` boundaries."""
    nnz = int(rowptrs_host[-1])
    nrows = len(rowptrs_host) - 1
    targets = (np.arange(1, n_shards) * nnz) // n_shards
    cuts = np.searchsorted(rowptrs_host, targets, side="left")
    splits = np.concatenate([[0], cuts, [nrows]])
    return np.maximum.accumulate(splits)


def balanced_col_splits(
    cols_host: np.ndarray, ncols: int, n_shards: int, align: int = 1
) -> np.ndarray:
    """nnz-balanced COLUMN split points: ``n_shards + 1`` boundaries,
    each a multiple of ``align`` (except the final ``ncols``).

    The column analog of :func:`balanced_row_splits`, used by the ring
    schedules: buckets pad to the largest one, so a uniform ``ncols / D``
    split sizes every bucket to the densest column stripe; nnz-balanced
    splits bound the largest bucket near ``nnz / D``."""
    counts = np.bincount(
        np.asarray(cols_host, dtype=np.int64), minlength=max(ncols, 1)
    )
    cum = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(cum[-1])
    targets = (np.arange(1, n_shards) * nnz) // n_shards
    cuts = np.searchsorted(cum, targets, side="left")
    if align > 1:
        cuts = ((cuts + align // 2) // align) * align
        cuts = np.minimum(cuts, (ncols // align) * align)
    splits = np.concatenate([[0], cuts, [max(ncols, 1)]])
    return np.maximum.accumulate(splits).astype(np.int64)


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of ``n_shards`` row shards on ``device``, in the local
    form (``group`` None) or the process form (see the module
    docstring).  Its methods are the collectives of the distributed ops;
    each takes and returns the shards this process holds, stacked on the
    leading axis (``n_local`` of them)."""

    n_shards: int
    device: torch.device
    group: object = None  # torch.distributed.ProcessGroup

    @property
    def first(self) -> int:
        """Index of the first shard this process holds."""
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def n_local(self) -> int:
        """Shards this process holds: all in the local form, one in the
        process form."""
        return self.n_shards if self.group is None else 1

    def local(self, stacked) -> torch.Tensor:
        """This process's slice of an array stacked over all shards, as a
        contiguous tensor on the mesh's device."""
        t = torch.as_tensor(stacked)
        if t.shape[0] != self.n_shards:
            raise ValueError(f"leading axis {t.shape[0]} is not the mesh's "
                             f"{self.n_shards} shards")
        first = self.first
        return t[first : first + self.n_local].to(self.device).contiguous()

    @cached_property
    def held(self) -> torch.Tensor:
        """The ring schedule's table, (D, n_local) int32 on the device,
        built once: at ring step ``k`` local shard ``l`` holds column
        shard ``held[k, l] = (first + l + k) % D``."""
        d = self.n_shards
        k = torch.arange(d, dtype=torch.int32, device=self.device)[:, None]
        l = torch.arange(self.first, self.first + self.n_local,
                         dtype=torch.int32, device=self.device)[None, :]
        return ((k + l) % max(d, 1)).contiguous()

    # -- collectives ------------------------------------------------------

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (n_local, n), each shard's slice of a vector, gathered in
        shard order: (D * n,), the same on every shard."""
        if self.group is None:
            return x.reshape(-1)
        import torch.distributed as dist

        out = x.new_empty(self.n_shards * x.shape[1])
        dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(),
                                    group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over all shards of ``x`` (n_local, ...): shape ``x.shape[1:]``,
        the same on every shard."""
        if self.group is None:
            return x.sum(0)
        import torch.distributed as dist

        out = x[0].clone()
        dist.all_reduce(out, group=self.group)
        return out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (n_local, D, n) summed over all shards, shard ``d`` keeping
        row ``d`` of the sum: (n_local, n)."""
        if self.group is None:
            return x.sum(0)
        import torch.distributed as dist

        out = x.new_empty(1, x.shape[2])
        dist.reduce_scatter_tensor(out[0], x[0].reshape(-1).contiguous(),
                                   group=self.group)
        return out

    def rotate(self, x: torch.Tensor):
        """Start the ring's rotate of ``x`` (n_local, n): every shard
        sends its slice to shard ``(d - 1) % D`` and receives shard
        ``(d + 1) % D``'s.  Returns a callable that waits for the exchange
        and returns the received slices, so the caller can issue the
        rotate, compute on ``x``, and only then wait."""
        if self.group is None:
            received = torch.roll(x, -1, 0)
            return lambda: received
        import torch.distributed as dist

        d, r = self.n_shards, self.first
        received = torch.empty_like(x)
        peer = [dist.get_global_rank(self.group, (r + s) % d) for s in (-1, 1)]
        requests = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, peer[0], self.group),
            dist.P2POp(dist.irecv, received, peer[1], self.group),
        ])

        def wait():
            for request in requests:
                request.wait()
            return received

        return wait


def make_mesh(n_shards: int, *, device=None, group=None) -> Mesh:
    """A 1-D mesh of ``n_shards`` row shards on ``device`` (default
    :func:`~csr_tpu_torch.kernels.default_device`): the local form, or
    with a ``torch.distributed`` process group of ``n_shards`` ranks the
    process form, each rank naming its own device."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_shards}")
    if group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(group)
        if world != n_shards:
            raise ValueError(f"the process group has {world} ranks, the mesh"
                             f" {n_shards} shards")
    device = default_device() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        # tensors report an indexed device: name the current card
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(int(n_shards), device, group)


def split_operand(x, offsets, width: int) -> np.ndarray:
    """A dense operand cut at ``offsets`` (D + 1 boundaries) into D slices,
    each zero-padded to ``width``: (D, width) float32 on the host."""
    xv = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    xv = np.asarray(xv, np.float32)
    xs = np.zeros((len(offsets) - 1, width), np.float32)
    for k, (c0, c1) in enumerate(zip(offsets[:-1], offsets[1:])):
        xs[k, : int(c1 - c0)] = xv[int(c0) : int(c1)]
    return xs


def sharded(obj, mesh: Mesh, names):
    """A copy of the dataclass ``obj`` whose stacked tensors ``names`` are
    this process's slices on the mesh's device."""
    return replace(obj, **{n: mesh.local(getattr(obj, n)) for n in names})


def check_sharded(obj, mesh: Mesh, name: str) -> torch.Tensor:
    """``obj.<name>`` if it is laid out on ``mesh`` (as ``.shard(mesh)``
    leaves it), else a ValueError."""
    t = getattr(obj, name)
    if t.shape[0] != mesh.n_local or t.device != mesh.device:
        raise ValueError(
            f"{type(obj).__name__}.{name} holds {t.shape[0]} shards on "
            f"{t.device}; the mesh wants {mesh.n_local} on {mesh.device}: "
            "call .shard(mesh) first")
    return t


def collect_rows(nrows_local, y_sharded):
    """The global dense result from row-sharded outputs of all shards,
    (D, rows_per_shard, ...), dropping each shard's row padding."""
    if y_sharded.shape[0] != len(nrows_local):
        raise ValueError(
            f"collect_rows needs all {len(nrows_local)} shards, got "
            f"{y_sharded.shape[0]}: in the process form each rank holds one")
    return torch.cat([y_sharded[d, : int(n)]
                      for d, n in enumerate(nrows_local)])


@dataclass
class DistCSR:
    """A CSR matrix row-partitioned into ``n_shards`` padded shards.

    Tensors are stacked on a leading shard axis; ``row_offset[d]`` is the
    global row index of shard d's first row."""

    TENSORS = ("rowptrs", "colinds", "values")

    nrows: int
    ncols: int
    nnz: int
    n_shards: int
    rows_per_shard: int  # padded local row count
    nnz_per_shard: int  # padded local nnz
    rowptrs: torch.Tensor  # (D, rows_per_shard + 1) int32
    colinds: torch.Tensor  # (D, nnz_per_shard) int32
    values: torch.Tensor  # (D, nnz_per_shard) float32 (implicit 1s materialized)
    row_offset: np.ndarray  # (D,) int32, host
    nrows_local: np.ndarray  # (D,) int32, host: real rows per shard

    def shard(self, mesh: Mesh) -> "DistCSR":
        """Lay the shard axis out over ``mesh``."""
        return sharded(self, mesh, self.TENSORS)


def partition_rows(csr, n_shards: int) -> DistCSR:
    """Partition a CSR into nnz-balanced, padded row shards (host
    tensors; ``.shard(mesh)`` places them)."""
    rp, cis_host, vals = csr.host_arrays()
    rp = np.asarray(rp)
    splits = balanced_row_splits(rp, n_shards)
    vals_host = (np.ones(csr.nnz, np.float32) if vals is None
                 else np.asarray(vals, dtype=np.float32))

    rows_per = int(np.max(np.diff(splits))) if n_shards else 0
    rows_per = max(rows_per, 1)
    shard_nnz = rp[splits[1:]] - rp[splits[:-1]]
    nnz_per = int(shard_nnz.max()) if len(shard_nnz) else 0
    nnz_per = max(nnz_per, 1)

    rps = np.zeros((n_shards, rows_per + 1), np.int32)
    cis = np.zeros((n_shards, nnz_per), np.int32)
    vls = np.zeros((n_shards, nnz_per), np.float32)

    for d in range(n_shards):
        r0, r1 = splits[d], splits[d + 1]
        s0, s1 = rp[r0], rp[r1]
        local = rp[r0 : r1 + 1] - rp[r0]
        rps[d, : r1 - r0 + 1] = local
        rps[d, r1 - r0 + 1 :] = local[-1]  # padded rows are empty
        cis[d, : s1 - s0] = cis_host[s0:s1]
        vls[d, : s1 - s0] = vals_host[s0:s1]

    return DistCSR(
        csr.nrows, csr.ncols, csr.nnz, n_shards, rows_per, nnz_per,
        torch.from_numpy(rps), torch.from_numpy(cis), torch.from_numpy(vls),
        splits[:-1].astype(np.int32), np.diff(splits).astype(np.int32),
    )
