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
"""

from __future__ import annotations

import torch

from .microblock import ACC_GROUP, LANE, MicroBlockLayout, check_on_card

#: number of launches of the CUDA kernel (plain-version calls not counted)
launches = 0


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


def spmv(layout: MicroBlockLayout, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for a micro-block matrix; returns f32 of length
    ``nrows`` on the layout's device.  ``x`` must lie on that device."""
    global launches
    dev = layout.device
    if x.shape != (layout.ncols,) or x.device != dev:
        raise ValueError(
            f"x: expected shape ({layout.ncols},) on {dev}, got "
            f"{tuple(x.shape)} on {x.device}"
        )
    if dev.type == "cpu":
        return spmv_reference(layout, x)
    if dev.type != "cuda":
        raise ValueError(f"spmv runs on CPU or CUDA tensors, not {dev}")

    check_on_card(layout)
    x = x.to(torch.float32).contiguous()
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
