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
"""

from __future__ import annotations

import functools

import torch

import numpy as np

from .microblock import (ACC_GROUP, LANE, BucketStack, MicroBlockLayout,
                         build_microblocks_host, check_on_card,
                         check_stack_on_card)

#: number of launches of the CUDA kernel (plain-version calls not counted)
launches = 0
#: number of launches of the bucket-selecting CUDA kernel
bucket_launches = 0
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


def spmv(layout: MicroBlockLayout, x: torch.Tensor,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` for a micro-block matrix; returns f32 of length
    ``nrows`` on the layout's device.  ``x`` must lie on that device.
    With ``out`` (f32, contiguous, ``nrows`` long, on that device) the
    product is added into it and it is returned: a caller that stacks
    the products of several layouts hands in rows of one zeroed tensor."""
    global launches
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
    x = x.to(torch.float32).contiguous()
    y = out
    if y is None:
        y = torch.zeros(layout.nrows, dtype=torch.float32, device=dev)
    if layout.n_microrows == 0:
        return y
    from . import _cuda

    with torch.cuda.device(dev):
        _cuda.spmv_microblock(
            layout.vals, layout.meta, layout.rbcb, x, y,
            layout.n_microrows // ACC_GROUP, layout.epos_shift, layout.nrows,
        )
    launches += 1
    return y


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


class _Product(torch.autograd.Function):
    """:func:`spmv` or :func:`spmv_large` with a vmap rule (see
    :func:`product`).  It has no backward, as the JAX package's Pallas
    SpMV has none: the ``cuda`` backend refuses a product that would need
    one before it gets here."""

    @staticmethod
    def forward(a, ncols, x, op):
        if isinstance(a, MicroBlockLayout):
            return spmv(a, x)
        return spmv_large(a, ncols, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("the micro-block SpMV has no backward: "
                           "differentiate on the torch backend")

    @staticmethod
    def vmap(info, in_dims, a, ncols, x, op):
        from csr_tpu_torch.kernels import trace

        from . import spmm as spmm_op

        # B = X^T: column j of B is operand j, whichever axis the batch is on
        b = x.movedim(in_dims[2], 1)
        if isinstance(a, MicroBlockLayout):
            trace(op, route="kernel", shape=(a.nrows, a.ncols), n=b.shape[1])
            return spmm_op.spmm(a, b), 1
        c = torch.zeros(sum(cn for cn, _ in a), b.shape[1],
                        dtype=torch.float32, device=b.device)
        trace(op, route="kernel", shape=tuple(c.shape[:1]) + (ncols,),
              n=b.shape[1])
        r0 = 0
        for cn, panels in a:
            for cb_off, layout in panels:
                c0 = cb_off * LANE
                c[r0 : r0 + cn] += spmm_op.spmm(layout, b[c0 : c0 + layout.ncols])
            r0 += cn
        return c, 1


def product(a, x: torch.Tensor, ncols: int | None = None,
            op: str = "mult_vec") -> torch.Tensor:
    """``A @ x`` on the SpMV kernel: ``a`` is a layout (:func:`spmv`) or
    :func:`build_large_layouts`'s chunks of a matrix of ``ncols`` columns
    (:func:`spmv_large`).  Returns f32 on the layouts' device.

    Inside a ``torch.func`` transform the call goes through an op with a
    vmap rule: ``torch.func.vmap`` over ``x`` runs one SpMM launch a
    layout on the batch (``B = X^T``), and no SpMV launch, and emits one
    ``op`` trace event (route ``kernel``, ``shape`` the product's rows and
    columns, ``n`` the batch), as ``mult_dense`` does.  Outside one it
    runs the op's forward directly: the op's dispatch added 0.035 and
    0.059 ms of host time a call (medians of two runs), and every chained
    flagship product through the op was slower than every one direct, on
    an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
    ``phase_dispatch``, PERF.md), so the main path does not pay it."""
    if torch._C._functorch.maybe_current_level() is None:
        return _Product.forward(a, ncols, x, op)
    return _Product.apply(a, ncols, x, op)
