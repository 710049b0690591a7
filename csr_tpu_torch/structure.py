"""
Structure helpers (counterpart of :mod:`csr_tpu.structure`).

Host COO->CSR, and on the matrix's device: the per-entry row ids, row
pointers from row indices, transpose, row sorting, row subsetting and
picking, entry filtering and shard assembly.  Every function returns
new tensors; the in-place methods of :class:`csr_tpu_torch.CSR` rebind
its fields to them.

Sorts are ``torch.sort``: a stable sort of the int32 column index over
row-major entries for the transpose, and of a packed int64
``row << 32 | col`` key for row sorting.  Entries with one coordinate
keep their order in both.
"""

from __future__ import annotations

import numpy as np
import torch

from .dtypes import COLIND_DTYPE, ptr_dtype
from .tracing import count


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


def _rowptrs_from_rows(rows: torch.Tensor, nrows: int,
                       out_dtype=torch.int64) -> torch.Tensor:
    """Row pointers of entries whose row indices ``rows`` ascend: where
    each row begins, by a binary search on the rows' device.  (The JAX
    package takes a bincount of unsorted rows; ``torch.bincount`` reads
    its input's maximum back to the host, a search reads nothing.)"""
    bounds = torch.arange(nrows + 1, dtype=rows.dtype, device=rows.device)
    return torch.searchsorted(rows, bounds).to(out_dtype)


def _row_ids(rowptrs: torch.Tensor, nrows: int, nnz: int) -> torch.Tensor:
    """Row index (int32) of each of the ``nnz`` entries that ``rowptrs``
    delimits, on its device.  ``nnz`` is the caller's, so the expansion
    needs no read of ``rowptrs[-1]``."""
    counts = torch.diff(rowptrs).to(torch.int64)
    rows = torch.arange(nrows, dtype=torch.int32, device=rowptrs.device)
    return torch.repeat_interleave(rows, counts, output_size=nnz)


def row_ids_for(csr) -> torch.Tensor:
    """Row index (int32) of each stored entry of ``csr``, on its device."""
    return _row_ids(csr.rowptrs, csr.nrows, csr.nnz)


def transpose_arrays(rowptrs, colinds, values, nrows: int, ncols: int):
    """The transpose (an ``ncols x nrows`` matrix) of CSR tensors, on
    their device: a stable sort of the column indices, so that within a
    column the entries keep their row-major order (rows ascend, and
    duplicates keep theirs).  Returns ``(rowptrs, colinds, values)``,
    the row pointers in ``rowptrs``' dtype."""
    nnz = colinds.shape[0]
    rids = _row_ids(rowptrs, nrows, nnz)
    cols, perm = torch.sort(colinds, stable=True)
    t_rps = _rowptrs_from_rows(cols, ncols, rowptrs.dtype)
    t_vs = None if values is None else values[perm]
    return t_rps, rids[perm].to(COLIND_DTYPE), t_vs


def sort_rows_arrays(rowptrs, colinds, values, nrows: int):
    """Each row's entries in increasing column order (entries with one
    coordinate keep their order), by one stable sort of the packed key
    ``row << 32 | col``.  Returns ``(colinds, values)``."""
    rids = _row_ids(rowptrs, nrows, colinds.shape[0]).to(torch.int64)
    key = (rids << 32) | colinds.to(torch.int64)
    _, perm = torch.sort(key, stable=True)
    return colinds[perm], None if values is None else values[perm]


def subset_rows_arrays(rowptrs, colinds, values, begin: int, end: int):
    """Rows ``[begin, end)`` of CSR arrays, as views where the arrays allow
    (numpy arrays and torch tensors alike).  Returns
    ``(rowptrs, colinds, values, nnz)``."""
    if isinstance(rowptrs, torch.Tensor):
        count("host_reads", 2)
    sp = int(rowptrs[begin])
    ep = int(rowptrs[end])
    rps = rowptrs[begin : end + 1] - sp
    vs = None if values is None else values[sp:ep]
    return rps, colinds[sp:ep], vs, ep - sp


def pick_rows_arrays(csr, rows, include_values: bool = True):
    """Rows ``rows`` (a tensor of indices, repeats allowed) of ``csr`` as
    new CSR tensors: one gather of every picked entry.  The output's
    entry count is read once on the host.  Returns ``(rowptrs, colinds,
    values, nnz)``."""
    rps = csr.rowptrs.to(torch.int64)
    rows = rows.to(device=rps.device, dtype=torch.int64)
    starts = rps[rows]
    out_rps = torch.zeros(len(rows) + 1, dtype=torch.int64, device=rps.device)
    torch.cumsum(rps[rows + 1] - starts, 0, out=out_rps[1:])
    count("host_reads")
    nnz = int(out_rps[-1])
    out_rid = _row_ids(out_rps, len(rows), nnz).to(torch.int64)
    pos = torch.arange(nnz, dtype=torch.int64, device=rps.device)
    src = starts[out_rid] + pos - out_rps[out_rid]
    vs = None
    if include_values and csr.values is not None:
        vs = csr.values[src]
    return out_rps.to(ptr_dtype(nnz)), csr.colinds[src], vs, nnz


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
    # the count, and each boolean gather's (the mask's true entries)
    count("host_reads", 2 if vs is None else 3)
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
