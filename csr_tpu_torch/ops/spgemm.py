"""
Sparse x sparse products past the dense budget: expand-sort-compress
(ESC), and the budget itself (counterpart of :mod:`csr_tpu.ops.spgemm`).

The dense route (``kernels/torch.py``, ``kernels/cuda.py``) densifies B
(or B^T) and the product C.  :func:`dense_fits` says whether both dense
forms fit :data:`max_dense_bytes`; past it a product runs here, with no
dense array at all:

1. **expand**: every product term ``A[i, k] * B[k, j]`` becomes one
   int64 key ``i << 32 | j`` and one value.  The number of terms of
   each row of A is known on the host before (the chunk plan), so
   ``torch.repeat_interleave(..., output_size=n)`` reads nothing back;
2. **sort**: ``torch.sort`` of the keys, the values gathered by its
   permutation, so that the terms of one coordinate are adjacent;
3. **compress**: ``torch.unique_consecutive`` of the sorted keys (each
   term's output entry), ``index_add_`` of the values, and a binary
   search of the keys' rows for the row pointers.

A is cut into row chunks of at most :data:`esc_chunk_entries` terms
(:func:`_chunk_splits`, the JAX package's plan), and each chunk reads its
output's entry count back once.  The sums are atomic adds on the card,
so an entry's last bits, and so whether a sum that cancels comes out
exactly zero, may differ from run to run there.  The JAX package pads
every size to a power of two to bound XLA's recompiles; torch compiles
nothing, so nothing is padded here.  Zeros that summation produces are
kept: the caller (``CSR.multiply``) drops them.
"""

from __future__ import annotations

import numpy as np
import torch

from csr_tpu_torch import structure
from csr_tpu_torch.dtypes import COLIND_DTYPE, ptr_dtype
from csr_tpu_torch.kernels import trace
from csr_tpu_torch.tracing import count, span

#: largest dense intermediate, in BYTES, that the dense route may
#: allocate (512 MiB).  The JAX package budgets ELEMENTS
#: (``max_dense_elems = 2**27``), so f64 products there get twice the
#: bytes; here an f64 product gets half the elements of an f32 one.
#: The ``cuda`` backend's densify route keeps to the same budget.
max_dense_bytes = 2**29

#: product terms expanded at once; a chunk holds its keys, their sorted
#: copy, the permutation, values and indices, about 65 B a term at its
#: peak as measured (13.1 GiB at the 217,250,243 terms of the block
#: below in one chunk).  The
#: fastest of 2^24, 2^26 and 2^28 for the item-item block of chip_smoke
#: phase 17 on an NVIDIA H100 80GB HBM3 at 700 W: 59.1-61.1 ms a product
#: in one chunk, 13.1 GiB allocated on the card at the peak, against
#: 60.0-61.8 ms (4 chunks, 6.0 GiB) and 66.2-68.2 ms (14 chunks, 3.8 GiB)
#: (PERF.md).
esc_chunk_entries = 2**28


def dense_fits(a_nrows: int, b_nrows: int, b_ncols: int, n_out: int,
               dtype: torch.dtype = torch.float32) -> bool:
    """Can the dense route afford dense B (``b_nrows x b_ncols``) and the
    dense product (``a_nrows x n_out``) in ``dtype``?"""
    size = dtype.itemsize
    return (b_nrows * b_ncols * size <= max_dense_bytes
            and a_nrows * n_out * size <= max_dense_bytes)


def _term_cum(a_rps_host, b_row_nnz_host, a_cols_host) -> np.ndarray:
    """``cum[i]``: the product terms of A's rows before row ``i`` (length
    ``nrows + 1``), on the host."""
    per_entry = np.asarray(b_row_nnz_host, np.int64)[a_cols_host]
    cum_e = np.zeros(len(per_entry) + 1, np.int64)
    np.cumsum(per_entry, out=cum_e[1:])
    return cum_e[np.asarray(a_rps_host)]


def _splits(cum: np.ndarray) -> list[int]:
    """Greedy row splits of at most :data:`esc_chunk_entries` terms a
    chunk; a row past the budget alone still advances."""
    nrows = len(cum) - 1
    splits = [0]
    while splits[-1] < nrows:
        lo = splits[-1]
        hi = int(np.searchsorted(cum, cum[lo] + esc_chunk_entries, side="right")) - 1
        splits.append(min(max(hi, lo + 1), nrows))
    return splits


def _chunk_splits(a_rps_host: np.ndarray, b_row_nnz_host: np.ndarray,
                  a_cols_host: np.ndarray) -> list[int]:
    """Row split points keeping each chunk's product terms under
    :data:`esc_chunk_entries` (the same list as the JAX package's for the
    same budget)."""
    return _splits(_term_cum(a_rps_host, b_row_nnz_host, a_cols_host))


def _expand(a_rids, a_cols, a_vals, b_rps, b_cols, b_vals, n: int, out_dtype):
    """The ``n`` product terms of A's entries (row ids ``a_rids``, columns
    ``a_cols``) with B's rows, sorted: returns ``(keys, values)``, keys
    ``row << 32 | col`` ascending."""
    dev = a_cols.device
    b_rps = b_rps.to(torch.int64)
    a_cols = a_cols.to(torch.int64)
    starts = b_rps[a_cols]
    counts = b_rps[a_cols + 1] - starts
    e = torch.repeat_interleave(torch.arange(len(a_cols), device=dev), counts,
                                output_size=n)
    # term t of entry e reads B's entry starts[e] + (t - first term of e)
    shift = starts - (torch.cumsum(counts, 0) - counts)
    src = torch.arange(n, device=dev) + shift[e]
    key = (a_rids.to(torch.int64)[e] << 32) | b_cols[src].to(torch.int64)
    vals = a_vals.to(out_dtype)[e] * b_vals.to(out_dtype)[src]
    del e, src
    key, perm = torch.sort(key)
    return key, vals[perm]


def _compress(key, vals, nrows: int):
    """Sum the values of equal (adjacent) keys: ``(rowptrs, colinds,
    values, nnz)`` of the output, reading its entry count back once."""
    ukey, seg = torch.unique_consecutive(key, return_inverse=True)
    count("host_reads")  # the unique keys' count
    nnz = ukey.shape[0]
    out_vals = torch.zeros(nnz, dtype=vals.dtype, device=vals.device)
    out_vals.index_add_(0, seg, vals)
    rps = structure._rowptrs_from_rows(ukey >> 32, nrows, ptr_dtype(nnz))
    return rps, (ukey & 0xFFFFFFFF).to(COLIND_DTYPE), out_vals, nnz


def _esc_rows(a_vals, a_rps, a_cols, b_rps, b_cols, b_vals,
              nrows: int, ncols_out: int, out_dtype, n_terms: int):
    """ESC product of a row chunk of A (``nrows`` rows, ``n_terms``
    product terms, as the chunk plan counted them) with all of B."""
    from csr_tpu_torch import CSR

    dev = a_cols.device
    if n_terms == 0:
        return CSR(nrows, ncols_out, 0,
                   torch.zeros(nrows + 1, dtype=torch.int32, device=dev),
                   torch.zeros(0, dtype=COLIND_DTYPE, device=dev),
                   torch.zeros(0, dtype=out_dtype, device=dev), _cast=False)
    with span("csr.esc.expand"):
        a_rids = structure._row_ids(a_rps, nrows, a_cols.shape[0])
        key, vals = _expand(a_rids, a_cols, a_vals, b_rps, b_cols, b_vals,
                            n_terms, out_dtype)
    with span("csr.esc.compress"):
        rps, cols, vals, nnz = _compress(key, vals, nrows)
    return CSR(nrows, ncols_out, nnz, rps, cols, vals, _cast=False)


def _host_index(csr, i: int) -> np.ndarray:
    """``rowptrs`` (``i`` 0) or ``colinds`` (1) of ``csr`` on the host:
    the kept copy, or the one tensor read back."""
    if csr._kept_host() is not None:
        return np.asarray(csr._host[i])
    count("host_reads")
    return (csr.rowptrs, csr.colinds)[i].cpu().numpy()


def esc_mult_ab(a, b, out_dtype=None):
    """``C = A @ B`` for CSR ``a`` and ``b`` on their device, densifying
    nothing.  Each row of C has its entries in increasing column order,
    repeated coordinates summed; zeros that the sums produce are kept.
    Emits an ``esc`` trace event with the terms, chunks and entries."""
    from csr_tpu_torch import CSR

    if a.ncols != b.nrows:
        raise ValueError(f"cannot multiply {a.nrows}x{a.ncols} by "
                         f"{b.nrows}x{b.ncols}")
    a_vals = a._required_values()
    b_vals = b._required_values()
    if out_dtype is None:
        out_dtype = torch.promote_types(
            torch.promote_types(a_vals.dtype, b_vals.dtype), torch.float32)

    # the plan, on the host: no chunk expands past the budget
    with span("csr.esc.plan"):
        a_rps_h = _host_index(a, 0).astype(np.int64)
        cum = _term_cum(a_rps_h, np.diff(_host_index(b, 0)), _host_index(a, 1))
        splits = _splits(cum)
    parts = []
    for lo, hi in zip(splits[:-1], splits[1:]):
        s0, s1 = int(a_rps_h[lo]), int(a_rps_h[hi])
        parts.append(_esc_rows(
            a_vals[s0:s1], a.rowptrs[lo : hi + 1] - s0, a.colinds[s0:s1],
            b.rowptrs, b.colinds, b_vals, hi - lo, b.ncols, out_dtype,
            int(cum[hi] - cum[lo])))
    if not parts:  # no rows
        c = _esc_rows(a_vals, a.rowptrs, a.colinds, b.rowptrs, b.colinds,
                      b_vals, a.nrows, b.ncols, out_dtype, 0)
    else:
        c = parts[0] if len(parts) == 1 else CSR._assemble_shards(parts)
    trace("esc", terms=int(cum[-1]), chunks=len(parts), nnz=c.nnz)
    return c


def esc_mult_abt(a, b, out_dtype=None):
    """``C = A @ B^T``: B transposed on its device
    (:func:`~csr_tpu_torch.structure.transpose_arrays`), then
    :func:`esc_mult_ab`."""
    from csr_tpu_torch import CSR

    if a.ncols != b.ncols:
        raise ValueError(f"cannot multiply {a.nrows}x{a.ncols} by "
                         f"{b.nrows}x{b.ncols}^T")
    with span("csr.structure.transpose"):
        t_rps, t_cis, t_vs = structure.transpose_arrays(
            b.rowptrs, b.colinds, b.values, b.nrows, b.ncols)
    bt = CSR(b.ncols, b.nrows, b.nnz, t_rps, t_cis, t_vs, _cast=False)
    return esc_mult_ab(a, bt, out_dtype)
