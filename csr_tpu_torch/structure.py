"""
Structure helpers (counterpart of :mod:`csr_tpu.structure`).

What the SpMV and SpMM slices need: host COO->CSR, the per-entry row
ids, row subsetting, entry filtering and shard assembly.  The rest of
the JAX module (transpose, sort, pick) is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import numpy as np
import torch

from .dtypes import COLIND_DTYPE, ptr_dtype


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


def filter_nnzs_arrays(csr, filt):
    """Keep only the entries of ``csr`` where the boolean tensor ``filt``
    is True.  The new row pointers are the running count of kept entries
    read at the old row pointers.  Returns ``(rowptrs, colinds, values,
    nnz)``."""
    kept = torch.zeros(csr.nnz + 1, dtype=torch.int64, device=filt.device)
    torch.cumsum(filt, 0, out=kept[1:])
    nnz = int(kept[-1])
    rps = kept[csr.rowptrs.to(torch.int64)].to(ptr_dtype(nnz))
    vs = None if csr.values is None else csr.values[filt]
    return rps, csr.colinds[filt], vs, nnz


def assemble_shards_arrays(shards):
    """Concatenate row shards back into one matrix.  The first shard
    decides whether the result has values; shards without values then
    contribute implicit ones.  Returns ``(nrows, ncols, nnz, rowptrs,
    colinds, values)``."""
    nrows = sum(s.nrows for s in shards)
    ncols = max(s.ncols for s in shards)
    nnz = sum(s.nnz for s in shards)
    dev = shards[0].device
    parts = [torch.zeros(1, dtype=torch.int64, device=dev)]
    off = 0
    for s in shards:
        parts.append(s.rowptrs[1:].to(torch.int64) + off)
        off += s.nnz
    rps = torch.cat(parts).to(ptr_dtype(nnz))
    cis = torch.cat([s.colinds.to(COLIND_DTYPE) for s in shards])
    vs = None
    if shards[0].values is not None:
        vs = torch.cat([s._required_values() for s in shards])
    return nrows, ncols, nnz, rps, cis, vs
