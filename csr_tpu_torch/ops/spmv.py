"""
Micro-block SpMV (counterpart of :func:`csr_tpu.ops.spmv.spmv`).

``y = A @ x`` with A in :class:`~csr_tpu_torch.ops.microblock.MicroBlockLayout`.

* :func:`spmv` is the kernel wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/spmv_microblock.cu`` (the port of the Pallas
  kernel ``csr_tpu/ops/spmv.py:_spmv_kernel``), or raises.  On CPU tensors
  it runs :func:`spmv_reference`.
* :func:`spmv_reference` is the plain PyTorch version of the same
  micro-block algorithm, on the same layout arrays.
* :data:`launches` counts kernel launches.
* :func:`spmv_bucket` is the wrapper of the bucket-selecting kernel
  ``csrc/spmv_bucket.cu`` (the port of
  ``csr_tpu/ops/spmv.py:_spmv_call_bucket``): over a
  :class:`~csr_tpu_torch.ops.microblock.BucketStack` it adds
  ``A[l, held[l]] @ x[l]`` into ``y[l]`` for every layer ``l``, the bucket
  index read on the device.  :func:`spmv_bucket_reference` is its plain
  PyTorch version and :data:`bucket_launches` its launch count.
  :func:`bucket_grid` is the kernel's grid and :func:`bucket_work` the
  (layer, micro-row) pairs each of its blocks takes, in the kernel's order.
* :func:`build_large_layouts` cuts a matrix into row chunks and column
  panels that each pack into a layout, and :func:`spmv_large` runs
  :func:`spmv` once a panel: the counterpart of the JAX package's
  ``spmv_large``, for matrices past a budget of windows.
* :func:`spmv_csr` is the wrapper of the CSR-form kernel
  ``csrc/spmv_csr.cu``, a second body for the same Pallas kernel that
  reads the matrix's own CSR tensors (no packing), for matrices whose
  micro-block layout is mostly padding.  :func:`spmv_csr_reference` is
  its plain PyTorch version, split as the kernel splits
  (:func:`csr_shares`, whose rows at the share edges the kernel reads),
  and :data:`csr_launches` its launch count.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

import numpy as np

from csr_tpu_torch.tracing import spanned

from .microblock import (ACC_GROUP, LANE, BucketStack, MicroBlockLayout,
                         build_microblocks_host, check_on_card,
                         check_stack_on_card)

#: number of launches of the CUDA kernel (plain-version calls not counted)
launches = 0
#: number of launches of the bucket-selecting CUDA kernel
bucket_launches = 0
#: number of launches of the CSR-form CUDA kernel
csr_launches = 0
#: merge items (row ends and stored entries) in a share of the CSR-form
#: kernel: its ``kTile`` (``csrc/spmv_csr.cu``)
CSR_TILE = 2048
#: blocks an SM the CUDA runtime may hold of a kernel (Hopper's limit): the
#: CSR-form SpMV's persistent grid is at most this many an SM, and its
#: scratch, an entry a block, is sized by it
MAX_BLOCKS_PER_SM = 32
#: blocks an SM of the bucket kernel's grid, and warps a block: the
#: occupancy its one build was chosen for (PERF.md, PR 5), which
#: chip_smoke's first phase asserts
BLOCKS_PER_SM = 1
WARPS_PER_BLOCK = 32


def spmv_reference(layout: MicroBlockLayout, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in plain PyTorch: gather ``x[cb * window + lo]`` for every
    slot holding an entry, scale by the values, take the exclusive prefix
    over the 128 slots, gather it at ``epos``, difference per window row,
    and ``index_add_`` the rows into their ``rb`` windows.  Returns f32 on
    the layout's device."""
    m = layout.n_microrows
    dev = layout.device
    x = x.to(device=dev, dtype=torch.float32)
    y = torch.zeros(layout.rb_count * LANE, dtype=torch.float32, device=dev)
    if m == 0:
        return y[: layout.nrows]
    shift = layout.epos_shift
    meta = layout.meta[:m].to(torch.int32)
    lo = meta & ((1 << shift) - 1)
    epos = (meta >> shift) & 127
    rbcb = layout.rbcb[:m]
    slot = torch.arange(LANE, device=dev)

    # slots at or past the micro-row's entry count (epos of slot 127) are
    # padding: they read no x, so 0 * inf never forms
    real = slot < epos[:, -1:]
    col = torch.where(real, ((rbcb & 0xFFFF)[:, None] << shift) + lo, 0)
    p = torch.where(real, layout.vals[:m] * x[col], 0.0)
    prefix = torch.nn.functional.pad(torch.cumsum(p, 1), (1, 0))  # P[0] = 0
    cum = torch.gather(prefix, 1, epos.to(torch.int64))
    rows = torch.diff(cum, dim=1, prepend=torch.zeros_like(cum[:, :1]))
    out_idx = ((rbcb >> 16)[:, None] * LANE + slot).reshape(-1)
    y.index_add_(0, out_idx, rows.reshape(-1))
    return y[: layout.nrows]


@spanned("csr.op.spmv")
def spmv(layout: MicroBlockLayout, x: torch.Tensor,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` for a micro-block matrix; returns f32 of length
    ``nrows`` on the layout's device.  ``x`` must lie on that device.
    With ``out`` (f32, contiguous, ``nrows`` long, on that device) the
    product is added into it and it is returned: a caller that stacks
    the products of several layouts hands in rows of one zeroed tensor."""
    dev = layout.device
    if x.shape != (layout.ncols,) or x.device != dev:
        raise ValueError(
            f"x: expected shape ({layout.ncols},) on {dev}, got "
            f"{tuple(x.shape)} on {x.device}"
        )
    if out is not None and (
        out.shape != (layout.nrows,) or out.device != dev
        or out.dtype != torch.float32 or not out.is_contiguous()
    ):
        raise ValueError(
            f"out: expected contiguous float32 ({layout.nrows},) on {dev}, "
            f"got {out.dtype} {tuple(out.shape)} on {out.device}"
        )
    if dev.type == "cpu":
        y = spmv_reference(layout, x)
        return y if out is None else out.add_(y)
    if dev.type != "cuda":
        raise ValueError(f"spmv runs on CPU or CUDA tensors, not {dev}")

    check_on_card(layout)
    if layout.n_microrows == 0:
        return (torch.zeros(layout.nrows, dtype=torch.float32, device=dev)
                if out is None else out)
    x = _as_read(x)
    return spmv_launch(layout, x)(x, out)


def _as_read(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the SpMV kernels read it: contiguous f32."""
    return x.to(torch.float32).contiguous()


def spmv_launch(layout: MicroBlockLayout, like: torch.Tensor):
    """:func:`spmv`'s launch on the card for an ``x`` like ``like`` (its
    dtype and strides; checked by :func:`spmv`), the layout's side bound
    once: a function of ``x`` and ``out`` that takes ``x`` as the kernel
    reads it, zeroes ``y`` (or takes ``out``), takes the current stream
    and launches.  A product plan (``csr_tpu_torch/_plan.py``) keeps it
    for such an ``x``."""
    from . import _cuda

    dev, index, nrows = layout.device, layout.device.index, layout.nrows
    kernel = _cuda.entry("spmv_microblock")
    ptrs = (layout.vals.data_ptr(), layout.meta.data_ptr(), layout.rbcb.data_ptr())
    n_groups, shift = layout.n_microrows // ACC_GROUP, layout.epos_shift
    convert = _as_read(like) is not like

    def launch(x, out=None):
        global launches
        if convert:
            x = _as_read(x)
        y = torch.zeros(nrows, dtype=torch.float32, device=dev) if out is None else out
        _cuda.call_on(index, kernel, *ptrs, x.data_ptr(), y.data_ptr(), n_groups,
                      shift, nrows, _cuda.stream(index))
        launches += 1
        return y

    return launch


def _check_bucket_operands(stack: BucketStack, held, x, y) -> None:
    dev, n_layers = stack.device, stack.n_layers
    for name, t, dtype, shape in (
        ("held", held, torch.int32, (n_layers,)),
        ("x", x, torch.float32, (n_layers, stack.ncols)),
        ("y", y, torch.float32, (n_layers, stack.nrows)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along its last axis")


def spmv_bucket_reference(stack: BucketStack, held: torch.Tensor,
                          x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y[l] += A[l, held[l]] @ x[l]`` in plain PyTorch: ``held`` is read
    on the host, and :func:`spmv_reference` runs on a view of each held
    bucket, over the bucket's ``groups`` count of micro-row groups (what
    the kernel's grid covers of it).  A held index outside the stack's
    buckets adds nothing, as in the kernel.  Returns ``y``."""
    _check_bucket_operands(stack, held, x, y)
    groups = stack.groups.tolist()
    for l, h in enumerate(held.tolist()):
        if not 0 <= h < stack.n_buckets:
            continue
        view = MicroBlockLayout(
            stack.nrows, stack.ncols, 0, groups[l][h] * ACC_GROUP,
            stack.vals[l, h], stack.meta[l, h], stack.rbcb[l, h],
            stack.window,
        )
        y[l] += spmv_reference(view, x[l])
    return y


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def bucket_grid(stack: BucketStack, sm_count: int) -> int:
    """The bucket kernel's grid on a card of ``sm_count`` SMs:
    :data:`BLOCKS_PER_SM` blocks an SM, but no more blocks than the held
    buckets can have groups (the stack's layers times its largest group
    count), which the host knows without reading ``held``."""
    return min(BLOCKS_PER_SM * sm_count, stack.n_layers * stack.n_groups)


def bucket_work(stack: BucketStack, held: torch.Tensor, grid: int) -> list:
    """The work of each of the bucket kernel's ``grid`` blocks, in the
    kernel's order, as lists of (layer, micro-row of the held bucket): the
    held buckets' real micro-rows (``groups[l, held[l]]`` groups of 32 of
    layer ``l``, none for a held index outside the stack's buckets) listed
    layer by layer, in equal contiguous shares of ``ceil(micro-rows /
    warps)`` to the grid's warps, :data:`WARPS_PER_BLOCK` a block in turn.
    Plain Python for the tests; the kernel walks the same list on the
    device."""
    counts = stack.groups.tolist()
    rows = [(l, r) for l, h in enumerate(held.tolist()) if 0 <= h < stack.n_buckets
            for r in range(counts[l][h] * ACC_GROUP)]
    block = -(-len(rows) // (grid * WARPS_PER_BLOCK)) * WARPS_PER_BLOCK
    return [rows[b * block:(b + 1) * block] for b in range(grid)]


def spmv_bucket(stack: BucketStack, held: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """``y[l] += A[l, held[l]] @ x[l]`` for every layer ``l`` of a stack of
    micro-block layouts; returns ``y``.

    ``held`` is (L,) int32, ``x`` (L, ncols) f32 and ``y`` (L, nrows) f32,
    all on the stack's device.  On CUDA tensors one launch of
    ``csrc/spmv_bucket.cu`` on :func:`bucket_grid` blocks serves all
    layers: each warp reads ``held`` and the held buckets' group counts
    from device memory and takes its share of their micro-rows
    (:func:`bucket_work`), so the host never reads ``held`` and no bucket
    is copied.  On CPU tensors :func:`spmv_bucket_reference` runs.  A
    build or launch failure raises."""
    global bucket_launches
    dev = stack.device
    if dev.type == "cpu":
        return spmv_bucket_reference(stack, held, x, y)
    if dev.type != "cuda":
        raise ValueError(f"spmv_bucket runs on CPU or CUDA tensors, not {dev}")
    _check_bucket_operands(stack, held, x, y)
    check_stack_on_card(stack)
    if x.data_ptr() % 4 or y.data_ptr() % 4:
        raise ValueError("x and y must be 4 B aligned")
    if stack.n_groups == 0 or stack.n_layers == 0:
        return y
    from . import _cuda

    with torch.cuda.device(dev):
        _cuda.spmv_bucket(stack.vals, stack.meta, stack.rbcb, held,
                          stack.groups, x, y, bucket_grid(stack, _sm_count(dev)),
                          stack.epos_shift, stack.nrows)
    bucket_launches += 1
    return y


def build_large_layouts(nrows: int, ncols: int, rp, cols, vals, *,
                        max_windows: int, device="cpu"):
    """Chunk/panel layouts of host CSR arrays, on ``device``: rows in
    chunks of ``max_windows * 128`` and each chunk's columns in panels of
    ``max_windows * 128``, every (chunk, panel) block packed on its own
    (panels are unions of whole windows, so its groups are those of the
    unsplit layout).  The layouts are the JAX package's
    ``build_large_layouts``'s, byte for byte.

    Returns a list of row chunks ``(chunk_nrows, [(col_window_off,
    layout), ...])``, empty panels dropped."""
    rp = np.asarray(rp)
    cols = np.asarray(cols)
    span = max_windows * LANE
    chunks = []
    for r0 in range(0, max(nrows, 1), span):
        r1 = min(nrows, r0 + span)
        s0, s1 = int(rp[r0]), int(rp[r1])
        crp = (rp[r0 : r1 + 1] - rp[r0]).astype(np.int64)
        ccols = cols[s0:s1]
        cvals = None if vals is None else vals[s0:s1]
        cn = r1 - r0
        panels = []
        n_panels = -(-max(ncols, 1) // span)
        if n_panels <= 1:
            if s1 > s0:
                panels.append((0, build_microblocks_host(
                    cn, ncols, crp, ccols, cvals, device=device)))
        else:
            rows = np.repeat(np.arange(cn, dtype=np.int64), np.diff(crp))
            pid = ccols.astype(np.int64) // span
            for p in range(n_panels):
                mask = pid == p
                if not mask.any():
                    continue
                pc = (ccols[mask] - p * span).astype(np.int32)
                prp = np.zeros(cn + 1, np.int64)
                np.cumsum(np.bincount(rows[mask], minlength=cn), out=prp[1:])
                pv = None if cvals is None else cvals[mask]
                pncols = min(ncols - p * span, span)
                panels.append((p * max_windows, build_microblocks_host(
                    cn, pncols, prp, pc, pv, device=device)))
        chunks.append((cn, panels))
    return chunks


@spanned("csr.op.spmv_large")
def spmv_large(chunks, ncols: int, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over :func:`build_large_layouts`'s chunks: :func:`spmv`
    once a panel, on the panel's contiguous slice of ``x``, adding into
    its chunk's contiguous slice of one zeroed f32 ``y`` (``out=``), so
    nothing is concatenated.  ``x`` must lie on the layouts' device."""
    if x.shape != (ncols,):
        raise ValueError(f"x: expected shape ({ncols},), got {tuple(x.shape)}")
    x = x.to(torch.float32).contiguous()
    y = torch.zeros(sum(cn for cn, _ in chunks), dtype=torch.float32,
                    device=x.device)
    r0 = 0
    for cn, panels in chunks:
        for cb_off, layout in panels:
            c0 = cb_off * LANE
            spmv(layout, x[c0 : c0 + layout.ncols], out=y[r0 : r0 + cn])
        r0 += cn
    return y


def csr_shares(rowptrs: torch.Tensor, nnz: int, tile: int = CSR_TILE):
    """The CSR-form kernels' split: the merge of the row ends with the
    entry indices (merge path, Merrill & Garland) cut into shares of
    ``tile`` items.  Returns int64 ``(rows, entries)`` at the
    ``ceil((nrows + nnz) / tile) + 1`` share edges: share ``s`` holds the
    row ends of rows ``rows[s] .. rows[s + 1] - 1`` and the entries
    ``entries[s] .. entries[s + 1] - 1``.  At diagonal ``d`` the rows
    consumed are those with ``rowptrs[i + 1] + i + 1 <= d`` (one
    ``searchsorted``; ``csrc/merge_path.cuh:merge_search`` is the same
    search on the card).  ``rows`` is what the kernels read as their
    ``edges``."""
    nrows = rowptrs.shape[0] - 1
    dev = rowptrs.device
    total = nrows + nnz
    d = torch.arange(0, total + tile, tile, device=dev).clamp_max(total)
    ends = rowptrs[1:].to(torch.int64) + torch.arange(1, nrows + 1, device=dev)
    rows = torch.searchsorted(ends, d, right=True)
    return rows, d - rows


def n_shares(nrows: int, nnz: int, tile: int) -> int:
    """Shares of ``tile`` merge items of an ``nrows``-row matrix of
    ``nnz`` entries (:func:`csr_shares` has one more edge)."""
    return -(-(nrows + nnz) // tile)


def csr_parts(rowptrs: torch.Tensor, nnz: int, tile: int):
    """The parts of the CSR-form kernels' split (:func:`csr_shares` in
    shares of ``tile`` items): a part is a run of entries of one row in
    one share.  Returns ``(part, rows)``: the part of each entry and the
    row of each part, int64 on the tensors' device (``nnz`` > 0)."""
    dev = rowptrs.device
    nrows = rowptrs.shape[0] - 1
    _, k = csr_shares(rowptrs, nnz, tile)
    share = torch.searchsorted(k[1:], torch.arange(nnz, device=dev), right=True)
    row = torch.repeat_interleave(torch.arange(nrows, device=dev),
                                  torch.diff(rowptrs.long()), output_size=nnz)
    new = torch.ones(nnz, dtype=torch.bool, device=dev)
    new[1:] = (row[1:] != row[:-1]) | (share[1:] != share[:-1])
    return torch.cumsum(new, 0) - 1, row[new]


def spmv_csr_reference(rowptrs: torch.Tensor, colinds: torch.Tensor,
                       values: torch.Tensor | None, x: torch.Tensor,
                       tile: int = CSR_TILE) -> torch.Tensor:
    """``A @ x`` in plain PyTorch, split as the CSR-form kernel splits
    it: the products ``values * x[colinds]`` (every value 1 when
    ``values`` is None); each share of :func:`csr_shares`'s sums its
    rows' products (a row inside one share whole, a row cut by a share's
    edge in one part a share, :func:`csr_parts`); then the parts of each
    row are added together, as the kernel carries a cut row's sum into
    the block's next share and, between blocks, adds the blocks' carries
    in a second launch.  Every row is a sum of its own products only:
    empty rows are exact zeros.  Returns f32 on the tensors' device."""
    dev = colinds.device
    nrows, nnz = rowptrs.shape[0] - 1, colinds.shape[0]
    y = torch.zeros(nrows, dtype=torch.float32, device=dev)
    if nnz == 0:
        return y
    x = x.to(device=dev, dtype=torch.float32)
    p = x[colinds.long()]
    if values is not None:
        p = values.to(torch.float32) * p
    part, rows = csr_parts(rowptrs, nnz, tile)
    sums = torch.zeros(rows.shape[0], dtype=torch.float32, device=dev)
    sums.index_add_(0, part, p)
    return y.index_add_(0, rows, sums)


def check_csr_operands(rowptrs, colinds, values, x, out=None,
                       x_dim: int = 1, edges=None, tile: int = CSR_TILE) -> None:
    """Raise ValueError unless the CSR tensors and the operand ``x`` (of
    ``x_dim`` dimensions; ``out`` the optional SpMV accumulator; ``edges``
    the optional rows at the share edges of ``tile`` items) are as the
    CSR-form kernels take them."""
    dev = colinds.device
    nrows = rowptrs.shape[0] - 1 if rowptrs.dim() == 1 else -1
    if rowptrs.dtype not in (torch.int32, torch.int64) or nrows < 0:
        raise ValueError(f"rowptrs: expected 1-D int32 or int64, got "
                         f"{rowptrs.dtype} {tuple(rowptrs.shape)}")
    if colinds.dtype != torch.int32 or colinds.dim() != 1:
        raise ValueError(f"colinds: expected 1-D int32, got {colinds.dtype} "
                         f"{tuple(colinds.shape)}")
    if values is not None and (values.dtype != torch.float32
                               or tuple(values.shape) != tuple(colinds.shape)):
        raise ValueError(f"values: expected float32 {tuple(colinds.shape)}, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if x.dim() != x_dim:
        raise ValueError(f"x: expected {x_dim}-D, got {tuple(x.shape)}")
    if out is not None and (out.shape != (nrows,) or out.dtype != torch.float32):
        raise ValueError(f"out: expected float32 ({nrows},), got {out.dtype} "
                         f"{tuple(out.shape)}")
    if edges is not None:
        want = (n_shares(nrows, colinds.shape[0], tile) + 1,)
        if edges.dtype != torch.int64 or tuple(edges.shape) != want:
            raise ValueError(f"edges: expected int64 {want}, got {edges.dtype} "
                             f"{tuple(edges.shape)}")
    for name, t in (("rowptrs", rowptrs), ("values", values), ("x", x),
                    ("out", out), ("edges", edges)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, colinds on {dev}")
    for name, t in (("rowptrs", rowptrs), ("colinds", colinds),
                    ("values", values), ("out", out), ("edges", edges)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@spanned("csr.op.spmv_csr")
def spmv_csr(rowptrs: torch.Tensor, colinds: torch.Tensor,
             values: torch.Tensor | None, x: torch.Tensor,
             out: torch.Tensor | None = None,
             edges: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` for a matrix in CSR form, read from its own tensors:
    ``rowptrs`` int32 or int64 (``rowptrs[0] == 0``, the last the entry
    count), ``colinds`` int32, ``values`` f32 or None (every value 1),
    all contiguous on one device with ``x``; returns f32 of length
    ``nrows``.  With ``out`` (f32, contiguous, ``nrows`` long) the product
    is added into it and it is returned.  ``edges`` are the rows at the
    share edges (``csr_shares(rowptrs, nnz)[0]``, which ``kernels/cuda.py``
    caches on the matrix); without them the kernel's first launch finds
    them.

    On CUDA tensors ``csrc/spmv_csr.cu`` runs: its persistent blocks over
    runs of shares, then a launch that adds the carries of rows cut
    between blocks; every row is written, so the result needs no zeroing
    (``torch.empty``) and is bitwise repeatable.  The call counts once in
    :data:`csr_launches`; a build or launch failure raises.  On CPU
    tensors :func:`spmv_csr_reference` runs."""
    check_csr_operands(rowptrs, colinds, values, x, out, edges=edges)
    dev = colinds.device
    if dev.type == "cpu":
        y = spmv_csr_reference(rowptrs, colinds, values, x)
        return y if out is None else out.add_(y)
    if dev.type != "cuda":
        raise ValueError(f"spmv_csr runs on CPU or CUDA tensors, not {dev}")
    x = _as_read(x)
    ptrs = [t.data_ptr() for t in (rowptrs, colinds, values, x, out)
            if t is not None]
    if any(p % 4 for p in ptrs):
        raise ValueError("rowptrs, colinds, values, x and out must be 4 B aligned")
    nrows, nnz = rowptrs.shape[0] - 1, colinds.shape[0]
    if nnz == 0:
        return torch.zeros(nrows, dtype=torch.float32, device=dev) if out is None else out
    return spmv_csr_launch(rowptrs, colinds, values, edges, x)(x, out)


def spmv_csr_launch(rowptrs: torch.Tensor, colinds: torch.Tensor,
                    values: torch.Tensor | None, edges: torch.Tensor | None,
                    like: torch.Tensor):
    """:func:`spmv_csr`'s launch on the card for an ``x`` like ``like``
    (its dtype and strides; checked by :func:`spmv_csr`), the matrix's
    side bound once: a function of ``x`` and ``out`` that takes ``x`` as
    the kernel reads it, allocates ``y`` (or takes ``out``) and the
    scratch, takes the current stream and launches.  A product plan
    (``csr_tpu_torch/_plan.py``) keeps it for such an ``x``."""
    from . import _cuda

    dev = colinds.device
    index = dev.index
    nrows, nnz = rowptrs.shape[0] - 1, colinds.shape[0]
    slots = MAX_BLOCKS_PER_SM * _sm_count(dev)
    search = edges is None
    # the blocks' carries (f32 in int64 slots) and rows; the edges' room
    room = 2 * slots + search * (n_shares(nrows, nnz, CSR_TILE) + 1)
    kernel = _cuda.entry("spmv_csr")
    head = (rowptrs.data_ptr(), int(rowptrs.dtype == torch.int64))
    mat = (int(search), colinds.data_ptr(),
           None if values is None else values.data_ptr())
    edges_ptr = None if search else edges.data_ptr()
    convert = _as_read(like) is not like

    def launch(x, out=None):
        global csr_launches
        if convert:
            x = _as_read(x)
        y = torch.empty(nrows, dtype=torch.float32, device=dev) if out is None else out
        scratch = torch.empty(room, dtype=torch.int64, device=dev)
        s = scratch.data_ptr()  # carry rows, carries, then the edges' room
        _cuda.call_on(index, kernel, *head, s + 16 * slots if search else edges_ptr,
                      *mat, x.data_ptr(), y.data_ptr(), nrows, nnz, int(out is None),
                      s + 8 * slots, s, slots, _cuda.stream(index))
        csr_launches += 1
        return y

    return launch


@dataclass(frozen=True)
class CsrForm:
    """A matrix's CSR tensors as :func:`spmv_csr` reads them, and the rows
    at its share edges for :func:`spmv_csr` and, under ``torch.func.vmap``,
    for ``ops/spmm.py:spmm_csr`` (None: the kernel finds them), with the
    column panels that SpMM runs in for a batch of each width
    (``spmm_panels(n)``: ``ops/spmm.py:Panels`` or None), for
    :func:`product` (a plain class, not a pytree node: ``torch.func``
    passes it through as one argument)."""

    rowptrs: torch.Tensor
    colinds: torch.Tensor
    values: torch.Tensor | None
    edges: torch.Tensor | None = None
    spmm_edges: torch.Tensor | None = None
    spmm_panels: object = None  # n -> Panels | None


class _Product(torch.autograd.Function):
    """:func:`spmv`, :func:`spmv_large` or :func:`spmv_csr` with a vmap
    rule (see :func:`product`).  It has no backward, as the JAX package's
    Pallas SpMV has none: the ``cuda`` backend refuses a product that
    would need one before it gets here."""

    @staticmethod
    def forward(a, ncols, x, op):
        if isinstance(a, MicroBlockLayout):
            return spmv(a, x)
        if isinstance(a, CsrForm):
            return spmv_csr(a.rowptrs, a.colinds, a.values, x, edges=a.edges)
        return spmv_large(a, ncols, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("the SpMV kernels have no backward: "
                           "differentiate on the torch backend")

    @staticmethod
    def vmap(info, in_dims, a, ncols, x, op):
        from csr_tpu_torch.kernels import trace

        from . import spmm as spmm_op

        # B = X^T: column j of B is operand j, whichever axis the batch is on
        b = x.movedim(in_dims[2], 1)
        if isinstance(a, CsrForm):
            trace(op, route="csr", shape=(a.rowptrs.shape[0] - 1, ncols),
                  n=b.shape[1])
            panels = a.spmm_panels(b.shape[1]) if a.spmm_panels else None
            return spmm_op.spmm_csr(a.rowptrs, a.colinds, a.values, b,
                                    edges=None if panels else a.spmm_edges,
                                    panels=panels), 1
        if isinstance(a, MicroBlockLayout):
            trace(op, route="kernel", shape=(a.nrows, a.ncols), n=b.shape[1])
            return spmm_op.spmm(a, b), 1
        trace(op, route="kernel", shape=(sum(cn for cn, _ in a), ncols),
              n=b.shape[1])
        return spmm_op.spmm_large(a, b), 1


def product(a, x: torch.Tensor, ncols: int | None = None,
            op: str = "mult_vec") -> torch.Tensor:
    """``A @ x`` on an SpMV kernel: ``a`` is a layout (:func:`spmv`),
    :func:`build_large_layouts`'s chunks of a matrix of ``ncols`` columns
    (:func:`spmv_large`) or a :class:`CsrForm` (:func:`spmv_csr`).
    Returns f32 on the tensors' device.

    Inside a ``torch.func`` transform the call goes through an op with a
    vmap rule: ``torch.func.vmap`` over ``x`` runs SpMM on the batch
    (``B = X^T``) and no SpMV launch: one micro-block SpMM launch a
    layout (route ``kernel``), or one CSR-form SpMM (``spmm_csr``, route
    ``csr``) with no layout built; it emits one ``op`` trace event
    (``shape`` the product's rows and columns, ``n`` the batch), as
    ``mult_dense`` does.  Outside one it
    runs the op's forward directly: the op's dispatch added 0.035 and
    0.059 ms of host time a call (medians of two runs), and every chained
    flagship product through the op was slower than every one direct, on
    an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
    ``phase_dispatch``, PERF.md), so the main path does not pay it."""
    if torch._C._functorch.maybe_current_level() is None:
        return _Product.forward(a, ncols, x, op)
    return _Product.apply(a, ncols, x, op)
