"""
Value transformations (counterpart of :mod:`csr_tpu.transform`).

Row centring and unit normalisation by reductions over the per-entry
row ids.  Each returns ``(new_values, stats)``: new tensors, never the
matrix's own written in place; :meth:`csr_tpu_torch.CSR.normalize_rows`
rebinds them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import structure


def _row_sums(values, rids, nrows: int):
    out = torch.zeros(nrows, dtype=values.dtype, device=values.device)
    return out.index_add_(0, rids, values)


def center_rows(csr):
    """Subtract each row's mean from its stored values.

    Returns:
        (values, means): the centred values and the per-row means (0 for
        empty rows).
    """
    values = csr.values
    rids = structure.row_ids_for(csr).to(torch.int64)
    counts = torch.diff(csr.rowptrs).to(values.dtype)
    sums = _row_sums(values, rids, csr.nrows)
    means = torch.where(counts > 0, sums / counts.clamp_min(1), 0)
    return values - means[rids], means


def unit_rows(csr):
    """Scale each row to unit Euclidean norm.

    A row of tiny values would underflow in its sum of squares, giving
    too small a norm and a "unit" row longer than 1.  So each row is
    first scaled by the power of two that brings its largest magnitude
    into ``[0.5, 1)`` (``frexp``), its norm taken there, and the scale
    divided out of the norm again.

    Returns:
        (values, norms): the normalised values and the per-row norms (0
        for empty rows).
    """
    values = csr.values
    dtype = values.dtype
    info = np.finfo(torch.empty(0, dtype=dtype).numpy().dtype)
    nrows = csr.nrows
    rids = structure.row_ids_for(csr).to(torch.int64)
    absmax = torch.zeros(nrows, dtype=dtype, device=values.device).scatter_reduce(
        0, rids, values.abs(), "amax", include_self=False)
    absmax = torch.where(torch.isfinite(absmax), absmax, 0)  # empty rows: 0
    _, exp = torch.frexp(absmax)
    pnexp = torch.clamp(-exp, info.minexp, info.maxexp - 1)
    prenorm = torch.ldexp(torch.ones(nrows, dtype=dtype, device=values.device),
                          pnexp)
    scaled = values * prenorm[rids]
    inorm = torch.sqrt(_row_sums(scaled * scaled, rids, nrows))
    nonempty = torch.diff(csr.rowptrs) > 0
    norms = torch.where(nonempty, inorm / prenorm, 0)
    new_vals = torch.where(nonempty[rids],
                           scaled / inorm[rids].clamp_min(float(info.tiny)),
                           values)
    return new_vals, norms
