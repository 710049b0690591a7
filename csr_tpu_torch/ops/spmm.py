"""
Micro-block SpMM (counterpart of :func:`csr_tpu.ops.spmm.spmm`).

``C = A @ B`` with A in :class:`~csr_tpu_torch.ops.microblock.MicroBlockLayout`
and B dense ``(A.ncols, n)``, row-major.

* :func:`spmm` is the kernel wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/spmm_microblock.cu`` (the port of the Pallas
  kernel ``csr_tpu/ops/spmm.py:_spmm_kernel``) by :func:`launch_plan`, or
  raises.  On CPU tensors it runs :func:`spmm_regrouped`.
* :func:`spmm_regrouped` is the plain PyTorch version of the kernel's
  algorithm on the same layout arrays: every group of 32 micro-rows is
  regrouped into a CSR over its 128 window rows (:func:`regroup`), each
  row's run is summed, and the groups' row sums are added into C.
* :func:`spmm_reference` is the plain PyTorch version that goes slot by
  slot, with no regrouping: a second, independent statement of the result.
* :func:`launch_plan` is the kernel's launch geometry as plain Python,
  handed to the kernel's host code with every launch.
* :data:`launches` counts kernel launches.
* :func:`spmm_large` runs :func:`spmm` once a panel over
  ``ops/spmv.py:build_large_layouts``'s chunks, for matrices past the
  packer's range.
* :func:`spmm_csr` is the wrapper of the CSR-form kernel
  ``csrc/spmm_csr.cu``, a second body for the same Pallas kernel that
  reads the matrix's own CSR tensors (no packing), for matrices whose
  micro-block layout is mostly padding or that do not pack.
  :func:`spmm_csr_reference` is its plain PyTorch version, split as the
  kernel splits (``ops/spmv.py:csr_parts``), and :data:`csr_launches` its
  launch count.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from csr_tpu_torch.tracing import spanned

from .microblock import (ACC_GROUP, LANE, SLOT_CAP, MicroBlockLayout,
                         check_on_card)
from .spmv import check_csr_operands, csr_parts, n_shares

#: number of launches of the CUDA kernel (plain-version calls not counted)
launches = 0
#: number of calls that launched the CSR-form CUDA kernel (its two
#: launches, the shares and the carries, count once)
csr_launches = 0
#: merge items (row ends and stored entries) in a block's share of the
#: CSR-form kernel: its ``kWarps * kWarpItems`` (``csrc/spmm_csr.cu``)
CSR_TILE = 1024
#: lanes that may walk a row of the CSR-form kernel, fewest first
CSR_LANES = (4, 8, 16, 32)

#: elements of B's rows gathered at once by :func:`scatter_rows` (256 MB
#: of f32), so the plain version's temporaries stay near 1 GB at any size
_CHUNK_ELEMS = 1 << 26

#: entries a group of ``ACC_GROUP`` micro-rows can hold
GROUP_CAP = ACC_GROUP * SLOT_CAP
#: columns a lane: one 16 B load of a row of B
VEC = 4
#: bytes of B's and C's columns that the blocks in flight together may
#: touch and still find in the H100's 50 MB L2
L2_SLAB_BYTES = 36 << 20
#: blocks in flight on the card: 132 SMs, five blocks each
BLOCKS_IN_FLIGHT = 660
#: the widest second axis of a CUDA grid
_MAX_CHUNKS = 65535


@dataclass(frozen=True)
class LaunchPlan:
    """How the kernel is launched on a B of ``n`` columns.  The kernel's
    host code takes ``lanes`` and ``tiles_per_chunk`` and derives the
    tiles and the chunks from them as the properties here do."""

    n: int
    ldb: int  # floats a row of the B the kernel reads: n padded to 4
    copy: bool  # whether the wrapper hands the kernel a copy of B
    lanes: int  # lanes on one row of B; 32 // lanes entries a warp-step
    tiles_per_chunk: int  # column tiles a block walks

    @property
    def tile(self) -> int:
        """Columns a tile."""
        return self.lanes * VEC

    @property
    def n_tiles(self) -> int:
        return -(-self.ldb // self.tile)

    @property
    def chunks(self) -> int:
        """Blocks a group (the grid's second axis)."""
        return -(-self.n_tiles // self.tiles_per_chunk)


def launch_plan(n: int, nrows: int, ncols: int, n_groups: int, *,
                align: int = 16) -> LaunchPlan:
    """The launch of the kernel for ``A (nrows, ncols) @ B (ncols, n)``
    with ``n_groups`` groups of micro-rows, B's pointer aligned to
    ``align`` bytes.

    The kernel reads 16 B a lane from a B whose row stride is a multiple
    of 4 floats: B itself where it is so and 16 B aligned, else a padded
    copy.  A row of B takes 8, 16 or 32 lanes.  Blocks run chunk by chunk
    of column tiles; a matrix of few groups has several chunks in flight
    at once (:data:`BLOCKS_IN_FLIGHT` blocks), and the tiles a chunk are
    as many as keep those chunks' columns of B and C within
    :data:`L2_SLAB_BYTES`, at least one."""
    if n < 1 or n_groups < 0:
        raise ValueError(f"launch_plan: n {n}, n_groups {n_groups}")
    ldb = -(-n // VEC) * VEC
    copy = ldb != n or align % 16 != 0
    per_row = ldb // VEC
    lanes = 8 if per_row <= 8 else 16 if per_row <= 16 else 32
    tile = lanes * VEC
    n_tiles = -(-ldb // tile)
    in_flight = -(-BLOCKS_IN_FLIGHT // max(n_groups, 1))
    per_chunk = L2_SLAB_BYTES // (in_flight * 4 * (nrows + ncols) * tile)
    per_chunk = min(max(per_chunk, -(-n_tiles // _MAX_CHUNKS), 1), n_tiles)
    return LaunchPlan(n, ldb, copy, lanes, per_chunk)


def scatter_rows(out, rows, cols, vals, b):
    """``out[rows[i]] += vals[i] * b[cols[i]]`` for every entry ``i``, in
    chunks of entries whose gathered rows of ``b`` hold at most
    :data:`_CHUNK_ELEMS` elements.  ``out``, ``vals`` and ``b`` share one
    dtype.  Returns ``out``."""
    step = max(1, _CHUNK_ELEMS // max(b.shape[1], 1))
    for i in range(0, rows.shape[0], step):
        sl = slice(i, i + step)
        out.index_add_(0, rows[sl], vals[sl, None] * b[cols[sl]])
    return out


def _decode(layout: MicroBlockLayout):
    """``(lo, epos, row, real)`` of the layout's ``m`` micro-rows, each
    (m, 128): the column in the window and the running entry count of
    every slot, the window row that holds it (row ``r`` holds slots
    ``[epos[r-1], epos[r])``; 128 past the last entry) and whether it
    holds an entry (slots at or past the micro-row's count are padding)."""
    m = layout.n_microrows
    shift = layout.epos_shift
    meta = layout.meta[:m].to(torch.int32)
    lo = meta & ((1 << shift) - 1)
    epos = ((meta >> shift) & 127).contiguous()
    slot = torch.arange(LANE, dtype=torch.int32, device=layout.device)
    row = torch.searchsorted(epos, slot.expand(m, LANE).contiguous(), right=True)
    return lo, epos, row, slot < epos[:, -1:]


def spmm_reference(layout: MicroBlockLayout, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` in plain PyTorch, slot by slot: each slot's window row is
    found from ``epos``, slots at or past the micro-row's entry count are
    dropped, and every entry adds ``vals * B[cb * window + lo]`` to its
    row.  Returns f32 ``(nrows, n)`` on the layout's device."""
    m = layout.n_microrows
    dev = layout.device
    b = b.to(device=dev, dtype=torch.float32)
    c = torch.zeros(layout.nrows, b.shape[1], dtype=torch.float32, device=dev)
    if m == 0 or b.shape[1] == 0:
        return c
    lo, _, row, real = _decode(layout)  # padding slots read no B
    rbcb = layout.rbcb[:m]
    rows = ((rbcb >> 16)[:, None] * LANE + row)[real]
    cols = (((rbcb & 0xFFFF)[:, None] << layout.epos_shift) + lo)[real]
    return scatter_rows(c, rows, cols, layout.vals[:m][real], b)


def regroup(layout: MicroBlockLayout):
    """Every group of ``ACC_GROUP`` micro-rows as a CSR over its 128
    window rows, as the kernel builds it in shared memory.

    Returns ``(offsets, cols, vals)`` for the ``G`` groups: ``offsets``
    (G, 129) int32, ``cols`` (G, GROUP_CAP) int32 and ``vals``
    (G, GROUP_CAP) f32.  Window row ``r`` of group ``g`` holds the entries
    ``[offsets[g, r], offsets[g, r + 1])`` of ``cols[g]`` (the row of B,
    ``cb * window + lo``) and ``vals[g]``, micro-row after micro-row and in
    slot order within each.  A row's count is the sum over the group's
    micro-rows of ``epos[r] - epos[r - 1]``; padding slots are left out,
    and positions past ``offsets[g, 128]`` hold zeros."""
    m = layout.n_microrows
    dev = layout.device
    n_groups = m // ACC_GROUP
    lo, epos, row, real = _decode(layout)
    prev = torch.nn.functional.pad(epos[:, :-1], (1, 0))  # epos[r - 1]
    count = (epos - prev).view(n_groups, ACC_GROUP, LANE)
    # entries of row r in the group's earlier micro-rows
    before = (count.cumsum(1) - count).view(m, LANE)
    offsets = torch.nn.functional.pad(count.sum(1).cumsum(1), (1, 0))
    group = torch.arange(m, device=dev) // ACC_GROUP
    r = row.clamp_max(LANE - 1)
    slot = torch.arange(LANE, device=dev)
    pos = (offsets[group[:, None], r] + before.gather(1, r) + slot
           - prev.gather(1, r))
    flat = (group[:, None] * GROUP_CAP + pos)[real]
    cols = torch.zeros(n_groups, GROUP_CAP, dtype=torch.int32, device=dev)
    vals = torch.zeros(n_groups, GROUP_CAP, dtype=torch.float32, device=dev)
    base = (layout.rbcb[:m] & 0xFFFF)[:, None] << layout.epos_shift
    cols.view(-1)[flat] = (base + lo)[real]
    vals.view(-1)[flat] = layout.vals[:m][real]
    return offsets.to(torch.int32), cols, vals


def spmm_regrouped(layout: MicroBlockLayout, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` in plain PyTorch by the kernel's algorithm: regroup every
    group (:func:`regroup`), sum each window row's run of
    ``vals * B[cols]``, and add each group's non-empty rows into C (where
    the kernel takes atomics).  Groups go in chunks whose gathered rows of
    B hold at most :data:`_CHUNK_ELEMS` elements.  Returns f32
    ``(nrows, n)`` on the layout's device."""
    m = layout.n_microrows
    dev = layout.device
    b = b.to(device=dev, dtype=torch.float32)
    n = b.shape[1]
    c = torch.zeros(layout.nrows, n, dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return c
    offsets, cols, vals = regroup(layout)
    rb = layout.rbcb[:m:ACC_GROUP] >> 16
    window_rows = torch.arange(LANE, device=dev)
    pos = torch.arange(GROUP_CAP, dtype=torch.int32, device=dev)
    step = max(1, _CHUNK_ELEMS // (GROUP_CAP * n))
    for g0 in range(0, offsets.shape[0], step):
        off = offsets[g0:g0 + step]
        g = off.shape[0]
        # the window row of each position of a group's entries
        row = torch.searchsorted(off[:, 1:].contiguous(),
                                 pos.expand(g, GROUP_CAP).contiguous(), right=True)
        real = pos < off[:, -1:]
        local = (torch.arange(g, device=dev)[:, None] * LANE + row)[real]
        sums = torch.zeros(g * LANE, n, dtype=torch.float32, device=dev)
        sums.index_add_(0, local, vals[g0:g0 + step][real][:, None]
                        * b[cols[g0:g0 + step][real]])
        # a row with no entry in the group adds nothing
        filled = (off[:, 1:] > off[:, :-1]).reshape(-1)
        target = (rb[g0:g0 + step, None] * LANE + window_rows).reshape(-1)
        c.index_add_(0, target[filled], sums[filled])
    return c


@spanned("csr.op.spmm")
def spmm(layout: MicroBlockLayout, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` for a micro-block matrix and a dense ``b`` of shape
    ``(ncols, n)``; returns f32 ``(nrows, n)`` on the layout's device.
    ``b`` must lie on that device; another dtype is cast to f32."""
    global launches
    dev = layout.device
    if b.ndim != 2 or b.shape[0] != layout.ncols or b.device != dev:
        raise ValueError(
            f"B: expected shape ({layout.ncols}, n) on {dev}, got "
            f"{tuple(b.shape)} on {b.device}"
        )
    if dev.type == "cpu":
        return spmm_regrouped(layout, b)
    if dev.type != "cuda":
        raise ValueError(f"spmm runs on CPU or CUDA tensors, not {dev}")
    check_on_card(layout)
    b = b.to(torch.float32).contiguous()
    n = b.shape[1]
    c = torch.zeros(layout.nrows, n, dtype=torch.float32, device=dev)
    n_groups = layout.n_microrows // ACC_GROUP
    if n_groups == 0 or n == 0:
        return c
    plan = launch_plan(n, layout.nrows, layout.ncols, n_groups,
                       align=16 if b.data_ptr() % 16 == 0 else 4)
    if plan.copy:  # rows padded to a multiple of 4 floats, 16 B aligned
        padded = b.new_zeros(layout.ncols, plan.ldb)
        padded[:, :n] = b
        b = padded
    from . import _cuda

    with torch.cuda.device(dev):
        _cuda.spmm_microblock(
            layout.vals, layout.meta, layout.rbcb, b, c, n_groups,
            layout.epos_shift, layout.nrows, plan.lanes, plan.tiles_per_chunk,
        )
    launches += 1
    return c


@spanned("csr.op.spmm_large")
def spmm_large(chunks, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` over ``ops/spmv.py:build_large_layouts``'s chunks:
    :func:`spmm` once a panel, on the panel's rows of ``b``, added into
    its chunk's rows of one zeroed f32 C.  ``b`` must lie on the layouts'
    device."""
    c = torch.zeros(sum(cn for cn, _ in chunks), b.shape[1],
                    dtype=torch.float32, device=b.device)
    r0 = 0
    for cn, panels in chunks:
        for cb_off, layout in panels:
            c0 = cb_off * LANE
            c[r0 : r0 + cn] += spmm(layout, b[c0 : c0 + layout.ncols])
        r0 += cn
    return c


def spmm_csr_reference(rowptrs: torch.Tensor, colinds: torch.Tensor,
                       values: torch.Tensor | None, b: torch.Tensor,
                       tile: int = CSR_TILE) -> torch.Tensor:
    """``A @ B`` in plain PyTorch, split as the CSR-form kernel splits
    it: each share of ``tile`` merge items sums its rows' products
    ``values * B[colinds]`` (every value 1 when ``values`` is None), a row
    cut by a share's edge in one part a share (``ops/spmv.py:csr_parts``);
    then the parts are added into their rows, which is what the kernel's
    carries do.  Every row is a sum of its own products only: empty rows
    are exact zeros.  Entries go in chunks (:func:`scatter_rows`).
    Returns f32 ``(nrows, n)`` on the tensors' device."""
    dev = colinds.device
    nrows, nnz = rowptrs.shape[0] - 1, colinds.shape[0]
    b = b.to(device=dev, dtype=torch.float32)
    c = torch.zeros(nrows, b.shape[1], dtype=torch.float32, device=dev)
    if nnz == 0 or b.shape[1] == 0:
        return c
    vals = (torch.ones(nnz, dtype=torch.float32, device=dev) if values is None
            else values.to(torch.float32))
    part, rows = csr_parts(rowptrs, nnz, tile)
    sums = torch.zeros(rows.shape[0], b.shape[1], dtype=torch.float32,
                       device=dev)
    scatter_rows(sums, part, colinds.long(), vals, b)
    return c.index_add_(0, rows, sums)


def csr_plan(n: int, ldb: int, align: int) -> tuple:
    """How the CSR-form kernel walks C ``n`` columns wide from a B whose
    rows lie ``ldb`` floats apart on an ``align``-byte boundary (C is
    contiguous, from the allocator): ``(width, lanes)``, the floats a lane
    loads at a time (4 where ``n`` and ``ldb`` are multiples of 4 and B
    lies on 16 B, 2 where they are even and it lies on 8 B, else 1) and
    the lanes that walk a row, the fewest of :data:`CSR_LANES` whose 4
    columns a lane cover ``n`` (32 past 128 columns, in passes)."""
    width = next(w for w in (4, 2, 1)
                 if n % w == 0 and ldb % w == 0 and align % (4 * w) == 0)
    lanes = next((k for k in CSR_LANES if 4 * k >= n), CSR_LANES[-1])
    return width, lanes


@spanned("csr.op.spmm_csr")
def spmm_csr(rowptrs: torch.Tensor, colinds: torch.Tensor,
             values: torch.Tensor | None, b: torch.Tensor,
             edges: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ B`` for a matrix in CSR form, read from its own tensors:
    ``rowptrs`` int32 or int64 (``rowptrs[0] == 0``, the last the entry
    count), ``colinds`` int32, ``values`` f32 or None (every value 1),
    contiguous on one device with ``b`` (``(ncols, n)``; another dtype is
    cast to f32); returns f32 ``(nrows, n)``.  ``edges`` are the rows at
    the share edges (``ops/spmv.py:csr_shares(rowptrs, nnz, CSR_TILE)[0]``,
    which ``kernels/cuda.py`` caches on the matrix); without them the
    kernel's first launch finds them.

    On CUDA tensors ``csrc/spmm_csr.cu`` runs: one launch over the shares
    (:func:`csr_plan`'s lanes a row and load width; B read as it is, with
    no padded copy) and one that adds the carries of rows cut by a share's
    edge, counted once in :data:`csr_launches`; a build or launch failure
    raises.  On CPU tensors :func:`spmm_csr_reference` runs."""
    global csr_launches
    check_csr_operands(rowptrs, colinds, values, b, x_dim=2, edges=edges,
                       tile=CSR_TILE)
    dev = colinds.device
    if dev.type == "cpu":
        return spmm_csr_reference(rowptrs, colinds, values, b)
    if dev.type != "cuda":
        raise ValueError(f"spmm_csr runs on CPU or CUDA tensors, not {dev}")
    b = b.to(torch.float32)
    nrows, nnz, n = rowptrs.shape[0] - 1, colinds.shape[0], b.shape[1]
    if b.stride(1) != 1 or b.stride(0) < n:
        b = b.contiguous()
    if n >= 1 << 31:
        raise ValueError(f"B: {n} columns, more than the kernel indexes")
    if any(t.data_ptr() % 4 for t in (rowptrs, colinds, values, b)
           if t is not None):
        raise ValueError("rowptrs, colinds, values and B must be 4 B aligned")
    if nnz == 0 or n == 0:
        return torch.zeros(nrows, n, dtype=torch.float32, device=dev)
    c = torch.empty(nrows, n, dtype=torch.float32, device=dev)  # every row written
    align = b.data_ptr() & -b.data_ptr()
    width, lanes = csr_plan(n, b.stride(0), align)
    shares = n_shares(nrows, nnz, CSR_TILE)
    carry = torch.empty(shares, n, dtype=torch.float32, device=dev)
    carry_row = torch.empty(shares, dtype=torch.int32, device=dev)
    search = edges is None
    if search:
        edges = torch.empty(shares + 1, dtype=torch.int64, device=dev)
    from . import _cuda

    with torch.cuda.device(dev):
        _cuda.spmm_csr(rowptrs, edges, search, colinds, values, b, c, carry,
                       carry_row, width, lanes)
    csr_launches += 1
    return c
