"""
Row access (counterpart of :mod:`csr_tpu._rows`).

Per-row slices and dense rows.  Densifying several rows is one gather of
their entries and one scatter into a ``(k, ncols)`` tensor.
"""

from __future__ import annotations

import torch

from . import structure
from .dtypes import VALUE_DTYPE
from .tracing import count


def extent(csr, row):
    """``(start, end)`` positions of ``row`` in the data arrays."""
    count("host_reads", 2)
    return int(csr.rowptrs[row]), int(csr.rowptrs[row + 1])


def _densify(csr, row, values: bool):
    """Dense form of row ``row`` (an int) or rows ``row`` (a sequence),
    stored values or, with ``values`` False or a structure-only matrix,
    ones.  A stored position is assigned, not summed, as in the JAX
    package."""
    rows = torch.as_tensor(row, device=csr.device)
    single = rows.ndim == 0
    rows = rows.reshape(-1)
    dtype = csr.values.dtype if values and csr.values is not None else VALUE_DTYPE
    rps, cis, vs, nnz = structure.pick_rows_arrays(csr, rows, values)
    out = torch.zeros(len(rows), csr.ncols, dtype=dtype, device=csr.device)
    rid = structure._row_ids(rps, len(rows), nnz).to(torch.int64)
    # out of place, so that torch.func.vmap batches it over the values
    out = out.index_put(
        (rid, cis.to(torch.int64)),
        torch.ones(nnz, dtype=dtype, device=csr.device) if vs is None else vs)
    return out[0] if single else out


def row_array(csr, row):
    """Dense row(s): stored values, or ones for a structure-only matrix
    (float32)."""
    return _densify(csr, row, values=True)


def row_mask(csr, row):
    """Dense boolean mask(s) of the stored columns of row(s) ``row``."""
    return _densify(csr, row, values=False) != 0


def cs(csr, row):
    """Column indices of a row's stored entries."""
    sp, ep = extent(csr, row)
    return csr.colinds[sp:ep]


def vs(csr, row):
    """Stored values of a row; float32 ones for a structure-only matrix."""
    sp, ep = extent(csr, row)
    if csr.values is not None:
        return csr.values[sp:ep]
    return torch.ones(ep - sp, dtype=VALUE_DTYPE, device=csr.device)


def all_indices(csr):
    """Row index of every stored entry (the COO row vector)."""
    return structure.row_ids_for(csr)
