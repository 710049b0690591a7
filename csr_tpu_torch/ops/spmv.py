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
"""

from __future__ import annotations

import functools

import torch

from .microblock import (ACC_GROUP, LANE, BucketStack, MicroBlockLayout,
                         check_on_card, check_stack_on_card)

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
