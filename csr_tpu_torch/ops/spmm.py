"""
Micro-block SpMM (counterpart of :func:`csr_tpu.ops.spmm.spmm`).

``C = A @ B`` with A in :class:`~csr_tpu_torch.ops.microblock.MicroBlockLayout`
and B dense ``(A.ncols, n)``, row-major.

* :func:`spmm` is the kernel wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/spmm_microblock.cu`` (the port of the Pallas
  kernel ``csr_tpu/ops/spmm.py:_spmm_kernel``), or raises.  On CPU
  tensors it runs :func:`spmm_reference`.
* :func:`spmm_reference` is the plain PyTorch version of the same
  micro-block algorithm, on the same layout arrays.
* :data:`launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from .microblock import ACC_GROUP, LANE, MicroBlockLayout, check_on_card

#: number of launches of the CUDA kernel (plain-version calls not counted)
launches = 0

#: elements of B's rows gathered at once by :func:`scatter_rows` (256 MB
#: of f32), so the plain version's temporaries stay near 1 GB at any size
_CHUNK_ELEMS = 1 << 26


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


def spmm_reference(layout: MicroBlockLayout, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` in plain PyTorch: each slot's window row is found from
    ``epos`` (row ``r`` holds slots ``[epos[r-1], epos[r])``), slots at or
    past the micro-row's entry count are dropped, and every entry adds
    ``vals * B[cb * window + lo]`` to its row.  Returns f32 ``(nrows, n)``
    on the layout's device."""
    m = layout.n_microrows
    dev = layout.device
    b = b.to(device=dev, dtype=torch.float32)
    c = torch.zeros(layout.nrows, b.shape[1], dtype=torch.float32, device=dev)
    if m == 0 or b.shape[1] == 0:
        return c
    shift = layout.epos_shift
    meta = layout.meta[:m].to(torch.int32)
    lo = meta & ((1 << shift) - 1)
    epos = ((meta >> shift) & 127).contiguous()
    slot = torch.arange(LANE, dtype=torch.int32, device=dev)
    row = torch.searchsorted(epos, slot.expand(m, LANE).contiguous(), right=True)
    # padding slots read no B, so 0 * inf never forms
    real = slot < epos[:, -1:]
    rbcb = layout.rbcb[:m]
    rows = ((rbcb >> 16)[:, None] * LANE + row)[real]
    cols = (((rbcb & 0xFFFF)[:, None] << shift) + lo)[real]
    return scatter_rows(c, rows, cols, layout.vals[:m][real], b)


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
        return spmm_reference(layout, b)
    if dev.type != "cuda":
        raise ValueError(f"spmm runs on CPU or CUDA tensors, not {dev}")
    check_on_card(layout)
    b = b.to(torch.float32).contiguous()
    c = torch.zeros(layout.nrows, b.shape[1], dtype=torch.float32, device=dev)
    if layout.n_microrows == 0 or b.shape[1] == 0:
        return c
    from . import _cuda

    with torch.cuda.device(dev):
        _cuda.spmm_microblock(
            layout.vals, layout.meta, layout.rbcb, b, c,
            layout.n_microrows // ACC_GROUP, layout.epos_shift, layout.nrows,
        )
    launches += 1
    return c
