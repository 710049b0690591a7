"""
Structure helpers (counterpart of :mod:`csr_tpu.structure`).

Only what the SpMV slice needs: host COO->CSR, the per-entry row ids,
and row subsetting.  The rest of the JAX module (transpose, sort, pick,
filter, assemble) is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import numpy as np
import torch


def from_coo(nrows: int, rows, cols, values=None):
    """Host COO triple -> ``(rowptrs i64, colinds i32, values)`` numpy
    arrays.  Entries keep their input order within each row (a stable
    sort by row), through the native counting sort when it is available
    and a numpy stable argsort otherwise."""
    from . import native

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    host = native.from_coo(nrows, rows, cols, values)
    if host is not None:
        return host
    order = np.argsort(rows, kind="stable")
    rps = np.zeros(nrows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=nrows), out=rps[1:])
    vs = None if values is None else np.asarray(values)[order]
    return rps, cols[order].astype(np.int32), vs


def row_ids_for(csr) -> torch.Tensor:
    """Row index (int32) of each stored entry of ``csr``, on its device."""
    counts = torch.diff(csr.rowptrs).to(torch.int64)
    rows = torch.arange(csr.nrows, dtype=torch.int32, device=csr.rowptrs.device)
    return torch.repeat_interleave(rows, counts, output_size=csr.nnz)


def subset_rows_arrays(rowptrs, colinds, values, begin: int, end: int):
    """Rows ``[begin, end)`` of CSR arrays, as views where the arrays allow
    (numpy arrays and torch tensors alike).  Returns
    ``(rowptrs, colinds, values, nnz)``."""
    sp = int(rowptrs[begin])
    ep = int(rowptrs[end])
    rps = rowptrs[begin : end + 1] - sp
    vs = None if values is None else values[sp:ep]
    return rps, colinds[sp:ep], vs, ep - sp
