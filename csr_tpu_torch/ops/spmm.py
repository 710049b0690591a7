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
  launch count.  Where ``kernels/cuda.py`` finds B larger than a slab of
  L2 and rows long, it runs in column panels (:class:`Panels`, built by
  :func:`split_panels` on a matrix whose rows hold their columns in order,
  :func:`rows_in_order`); :func:`spmm_csr_panels_reference` is that
  product's plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from csr_tpu_torch.tracing import count, spanned

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
#: rows a chunk of :func:`split_panels`' search takes, and entries a chunk
#: of :func:`rows_in_order`'s check: their temporaries stay near 100 MB
#: whatever the matrix
_SPLIT_ROWS = 1 << 20
_ORDER_CHUNK = 1 << 22

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


def b_past_l2(ncols: int, n: int, l2_bytes: int) -> bool:
    """Whether B's rows, ``ncols`` of ``n`` f32, pass an L2 of ``l2_bytes``
    (never where that is 0: off a card, or not given)."""
    return 0 < l2_bytes < ncols * n * 4


@spanned("csr.op.spmm")
def spmm(layout: MicroBlockLayout, b: torch.Tensor, l2_bytes: int = 0) -> torch.Tensor:
    """``A @ B`` for a micro-block matrix and a dense ``b`` of shape
    ``(ncols, n)``; returns f32 ``(nrows, n)`` on the layout's device.
    ``b`` must lie on that device; another dtype is cast to f32.  Where
    B's rows pass ``l2_bytes`` (the card's L2, :func:`b_past_l2`), each
    call counts ``csr.spmm.b_past_l2`` while tracing records."""
    dev = layout.device
    if b.ndim != 2 or b.shape[0] != layout.ncols or b.device != dev:
        raise ValueError(
            f"B: expected shape ({layout.ncols}, n) on {dev}, got "
            f"{tuple(b.shape)} on {b.device}"
        )
    if dev.type == "cpu":
        if b_past_l2(layout.ncols, b.shape[1], l2_bytes):
            count("csr.spmm.b_past_l2")
        return spmm_regrouped(layout, b)
    if dev.type != "cuda":
        raise ValueError(f"spmm runs on CPU or CUDA tensors, not {dev}")
    check_on_card(layout)
    b = _as_read(b)
    if layout.n_microrows == 0 or b.shape[1] == 0:
        return torch.zeros(layout.nrows, b.shape[1], dtype=torch.float32, device=dev)
    return spmm_launch(layout, b, l2_bytes)(b)


_pad = torch.nn.functional.pad


def _as_read(b: torch.Tensor) -> torch.Tensor:
    """B as the micro-block kernel's wrapper reads it: contiguous f32."""
    return b.to(torch.float32).contiguous()


def spmm_launch(layout: MicroBlockLayout, like: torch.Tensor, l2_bytes: int = 0):
    """:func:`spmm`'s launch on the card for a B like ``like`` (its dtype,
    shape, strides and alignment; checked by :func:`spmm`), the layout's
    side (its groups in ``layout.order``, or in the packer's order in a
    view with none) and the :func:`launch_plan` bound once: a function
    of B that makes it contiguous f32, zeroes C, hands the kernel B's
    padded copy where the plan says so (rows padded to a multiple of 4
    floats, 16 B aligned), takes the current stream and launches
    (counting ``csr.spmm.b_past_l2`` where B's rows pass ``l2_bytes``).
    A product plan (``csr_tpu_torch/_plan.py``) keeps it for such a B."""
    from . import _cuda

    read = _as_read(like)
    convert = read is not like
    plan = launch_plan(read.shape[1], layout.nrows, layout.ncols,
                       layout.n_microrows // ACC_GROUP,
                       align=16 if read.data_ptr() % 16 == 0 else 4)
    dev, index, nrows, n = layout.device, layout.device.index, layout.nrows, plan.n
    kernel = _cuda.entry("spmm_microblock")
    ptrs = (layout.vals.data_ptr(), layout.meta.data_ptr(), layout.rbcb.data_ptr(),
            None if layout.order is None else layout.order.data_ptr())
    mid = (layout.n_microrows // ACC_GROUP, layout.epos_shift, nrows, n)
    tail = (n, plan.lanes, plan.tiles_per_chunk)  # C's row stride, the plan
    pad = (0, plan.ldb - n) if plan.copy else None
    past_l2 = b_past_l2(layout.ncols, n, l2_bytes)

    def launch(b):
        global launches
        if convert:
            b = _as_read(b)
        c = torch.zeros(nrows, n, dtype=torch.float32, device=dev)
        if pad is not None:
            b = _pad(b, pad)
        _cuda.call_on(index, kernel, *ptrs, b.data_ptr(), c.data_ptr(), *mid,
                      b.stride(0), *tail, _cuda.stream(index))
        launches += 1
        if past_l2:
            count("csr.spmm.b_past_l2")
        return c

    return launch


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


@dataclass(frozen=True)
class Panels:
    """A CSR matrix's columns cut into contiguous panels, for
    :func:`spmm_csr` to run panel by panel.  Panel ``k`` holds the entries
    of columns ``bounds[k] .. bounds[k + 1] - 1``: in a matrix whose rows
    hold their columns in order, a run of each row.  ``ptrs[k]`` are the
    panel's own row pointers (its runs' lengths summed) and row ``r``'s
    run starts at entry ``base[k, r] + ptrs[k, r]`` of the matrix; both
    int32, 8 B a row a panel.  ``nnz[k]`` is the panel's entry count and
    ``edges`` holds each panel's share edges (``ops/spmv.py:csr_shares``
    at :data:`CSR_TILE`), one panel after another."""

    bounds: tuple
    ptrs: torch.Tensor  # int32 (K, nrows + 1)
    base: torch.Tensor  # int32 (K, nrows)
    nnz: tuple
    edges: torch.Tensor  # int64, sum of (shares_k + 1)

    @property
    def count(self) -> int:
        return len(self.nnz)

    @property
    def shares(self) -> tuple:
        """Each panel's shares of :data:`CSR_TILE` merge items."""
        nrows = self.ptrs.shape[1] - 1
        return tuple(n_shares(nrows, k, CSR_TILE) for k in self.nnz)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ptrs, self.base, self.edges))


def panel_bounds(ncols: int, k: int) -> tuple:
    """The ``k + 1`` column edges that cut ``ncols`` columns into ``k``
    panels whose widths differ by one at most."""
    return tuple(i * ncols // k for i in range(k + 1))


def rows_in_order(rowptrs: torch.Tensor, colinds: torch.Tensor) -> bool:
    """Whether every row holds its columns in increasing order (repeats
    allowed): a column index below the one before it only where a row
    starts.  On the tensors' device by chunks of :data:`_ORDER_CHUNK`
    entries; one read to the host."""
    nnz = colinds.shape[0]
    dev = colinds.device
    rp = rowptrs.to(torch.int64)
    nrows = rp.shape[0] - 1
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for k0 in range(1, nnz, _ORDER_CHUNK):
        k1 = min(k0 + _ORDER_CHUNK, nnz)
        at = torch.arange(k0, k1, device=dev)
        starts = rp[torch.searchsorted(rp, at).clamp_max(nrows)] == at
        bad |= ((colinds[k0:k1] < colinds[k0 - 1 : k1 - 1]) & ~starts).any()
    count("host_reads")
    return not bool(bad)


def split_panels(rowptrs: torch.Tensor, colinds: torch.Tensor,
                 bounds: tuple) -> Panels:
    """The :class:`Panels` of a matrix whose rows hold their columns in
    order (:func:`rows_in_order`), cut at column edges ``bounds``: where
    each row's run of each panel starts, by a binary search of the row's
    columns at each inner edge, on the tensors' device by chunks of
    :data:`_SPLIT_ROWS` rows (no temporary the size of the entries).
    Two reads to the host: the longest row and the panels' entry counts."""
    from .spmv import csr_shares

    nnz = colinds.shape[0]
    if nnz >= 1 << 31:
        raise ValueError(f"{nnz} entries: a panel's int32 metadata holds < 2^31")
    dev = colinds.device
    rp = rowptrs.to(torch.int64)
    nrows = rp.shape[0] - 1
    k = len(bounds) - 1
    starts = torch.empty(k + 1, nrows, dtype=torch.int64, device=dev)
    starts[0], starts[k] = rp[:-1], rp[1:]
    inner = torch.tensor(bounds[1:-1], dtype=colinds.dtype, device=dev)[:, None]
    steps = int(torch.diff(rp).max()).bit_length() if nrows and k > 1 else 0
    count("host_reads")
    for r0 in range(0, nrows if k > 1 else 0, _SPLIT_ROWS):
        r1 = min(r0 + _SPLIT_ROWS, nrows)
        lo = rp[r0:r1].expand(k - 1, -1).clone()
        hi = rp[r0 + 1 : r1 + 1].expand(k - 1, -1).clone()
        for _ in range(steps):  # the first entry of each row at or past the edge
            mid = (lo + hi) >> 1
            open_ = lo < hi
            below = colinds[mid.clamp_max(max(nnz - 1, 0))] < inner
            lo = torch.where(open_ & below, mid + 1, lo)
            hi = torch.where(open_ & ~below, mid, hi)
        starts[1:k, r0:r1] = lo
    ptrs = torch.zeros(k, nrows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.diff(starts, dim=0), dim=1, out=ptrs[:, 1:])
    base = (starts[:-1] - ptrs[:, :-1]).to(torch.int32)
    per_panel = tuple(ptrs[:, -1].tolist())
    count("host_reads")
    ptrs = ptrs.to(torch.int32)
    edges = torch.cat([csr_shares(ptrs[i], per_panel[i], CSR_TILE)[0]
                       for i in range(k)])
    return Panels(tuple(bounds), ptrs, base, per_panel, edges)


def _panel_entries(panels: Panels, k: int) -> torch.Tensor:
    """The matrix's entries that panel ``k`` holds, in its order: int64."""
    lengths = torch.diff(panels.ptrs[k].to(torch.int64))
    first = torch.repeat_interleave(panels.base[k].to(torch.int64), lengths,
                                    output_size=panels.nnz[k])
    return first + torch.arange(panels.nnz[k], device=first.device)


def spmm_csr_panels_reference(colinds: torch.Tensor,
                              values: torch.Tensor | None, b: torch.Tensor,
                              panels: Panels, tile: int = CSR_TILE) -> torch.Tensor:
    """``A @ B`` in plain PyTorch panel by panel, as the CSR-form kernel
    runs it in :class:`Panels`: each panel's runs as a CSR of their own,
    multiplied by :func:`spmm_csr_reference` (split as the kernel splits
    each panel), and added into C in panel order.  Returns f32
    ``(nrows, n)`` on the tensors' device."""
    c = None
    for k in range(panels.count):
        at = _panel_entries(panels, k)
        part = spmm_csr_reference(panels.ptrs[k], colinds[at],
                                  None if values is None else values[at], b, tile)
        c = part if c is None else c.add_(part)
    return c


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
             edges: torch.Tensor | None = None,
             panels: Panels | None = None) -> torch.Tensor:
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
    raises.  On CPU tensors :func:`spmm_csr_reference` runs.

    With ``panels`` (:func:`split_panels` of this matrix, two panels or
    more) the product runs panel by panel (``edges`` unused): the kernel's
    two launches a panel, the first storing C and the rest adding into it
    (counted once, and ``csr.spmm.panels`` counts the panels); on CPU
    tensors :func:`spmm_csr_panels_reference`."""
    check_csr_operands(rowptrs, colinds, values, b, x_dim=2, edges=edges,
                       tile=CSR_TILE)
    _check_panels(panels, rowptrs, colinds)
    dev = colinds.device
    if dev.type == "cpu":
        if panels is not None:
            count("csr.spmm.panels", panels.count)
            return spmm_csr_panels_reference(colinds, values, b, panels)
        return spmm_csr_reference(rowptrs, colinds, values, b)
    if dev.type != "cuda":
        raise ValueError(f"spmm_csr runs on CPU or CUDA tensors, not {dev}")
    nrows, nnz, n = rowptrs.shape[0] - 1, colinds.shape[0], b.shape[1]
    b = _as_read_csr(b, n)
    if n >= 1 << 31:
        raise ValueError(f"B: {n} columns, more than the kernel indexes")
    if any(t.data_ptr() % 4 for t in (rowptrs, colinds, values, b)
           if t is not None):
        raise ValueError("rowptrs, colinds, values and B must be 4 B aligned")
    if nnz == 0 or n == 0:
        return torch.zeros(nrows, n, dtype=torch.float32, device=dev)
    return spmm_csr_launch(rowptrs, colinds, values, edges, b, panels)(b)


def _check_panels(panels, rowptrs, colinds) -> None:
    """Raise ValueError unless ``panels`` is None or two panels or more of
    a matrix of these row pointers and column indices."""
    if panels is None:
        return
    shape = (panels.count, rowptrs.shape[0])
    if (panels.count < 2 or tuple(panels.ptrs.shape) != shape
            or tuple(panels.base.shape) != (shape[0], shape[1] - 1)
            or panels.ptrs.dtype != torch.int32 or panels.base.dtype != torch.int32
            or sum(panels.nnz) != colinds.shape[0]
            or panels.edges.shape[0] != sum(panels.shares) + panels.count
            or any(t.device != colinds.device
                   for t in (panels.ptrs, panels.base, panels.edges))):
        raise ValueError(f"panels: expected 2 or more of a matrix of "
                         f"{shape[1] - 1} rows and {colinds.shape[0]} entries on "
                         f"{colinds.device}")


def _as_read_csr(b: torch.Tensor, n: int) -> torch.Tensor:
    """B as the CSR-form kernel reads it: f32, rows of unit stride at
    least ``n`` floats apart."""
    b = b.to(torch.float32)
    return b.contiguous() if b.stride(1) != 1 or b.stride(0) < n else b


def spmm_csr_launch(rowptrs: torch.Tensor, colinds: torch.Tensor,
                    values: torch.Tensor | None, edges: torch.Tensor | None,
                    like: torch.Tensor, panels: Panels | None = None):
    """:func:`spmm_csr`'s launch on the card for a B like ``like`` (its
    dtype, shape, strides and alignment; checked by :func:`spmm_csr`),
    the matrix's side (with ``panels``, its :class:`Panels`) and the
    :func:`csr_plan` bound once: a function of B that takes it as the
    kernel reads it, allocates C and the scratch, takes the current
    stream and launches.  A product plan (``csr_tpu_torch/_plan.py``)
    keeps it for such a B."""
    from . import _cuda

    dev = colinds.device
    index = dev.index
    nrows, nnz, n = rowptrs.shape[0] - 1, colinds.shape[0], like.shape[1]
    read = _as_read_csr(like, n)
    convert = read is not like
    width, lanes = csr_plan(n, read.stride(0), read.data_ptr() & -read.data_ptr())
    kernel = _cuda.entry("spmm_csr")
    if panels is None:
        shares = n_shares(nrows, nnz, CSR_TILE)
        search = edges is None
        head = (rowptrs.data_ptr(), int(rowptrs.dtype == torch.int64))
        edges_ptr = None if search else edges.data_ptr()
        per_panel, split = None, (0, None, None)
    else:  # the panels' row pointers, edges and bases; their entry counts
        shares, search = max(panels.shares), False
        head, edges_ptr = (panels.ptrs.data_ptr(), 0), panels.edges.data_ptr()
        per_panel = np.asarray(panels.nnz, dtype=np.int64)  # the host reads it
        split = (panels.count, panels.base.data_ptr(), per_panel.ctypes.data)
    mat = (int(search), colinds.data_ptr(),
           None if values is None else values.data_ptr())

    # one scratch allocation: the shares' carries (n f32 a share), their
    # rows (int32) and, with search, room for the edges (int64), which the
    # kernel's first launch fills
    rows_at = 4 * shares * n
    edges_at = -(-(rows_at + 4 * shares) // 8) * 8
    room = edges_at // 8 + search * (shares + 1)

    def launch(b):
        global csr_launches
        if convert:
            b = _as_read_csr(b, n)
        c = torch.empty(nrows, n, dtype=torch.float32, device=dev)  # every row written
        scratch = torch.empty(room, dtype=torch.int64, device=dev)
        s = scratch.data_ptr()
        _cuda.call_on(index, kernel, *head, s + edges_at if search else edges_ptr,
                      *mat, b.data_ptr(), b.stride(0), c.data_ptr(), n, nrows, nnz,
                      s, s + rows_at, width, lanes, *split, _cuda.stream(index))
        csr_launches += 1
        if per_panel is not None:  # (the launch holds the array it hands over)
            count("csr.spmm.panels", per_panel.shape[0])
        return c

    return launch
