"""
Plain PyTorch kernel backend (counterpart of :mod:`csr_tpu.kernels.xla`).

The portable backend: it runs on any device, with no kernel of this
repository.  SpMV is ``index_add_`` of ``values * v[colinds]`` over the
per-entry row ids that the handle carries; SpMM is ``index_add_`` of
``values[:, None] * B[colinds]`` over the same ids; SpGEMM densifies B
and runs that SpMM, within the dense budget of
:mod:`csr_tpu_torch.ops.spgemm`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from csr_tpu_torch import structure
from csr_tpu_torch.kernels import trace
from csr_tpu_torch.ops import spgemm as _esc
from csr_tpu_torch.ops import spmm as _spmm_op

max_nnz = np.iinfo("i8").max


class TorchHandle:
    """The CSR plus its per-entry row ids."""

    __slots__ = ("csr", "row_ids")

    def __init__(self, csr, row_ids):
        self.csr = csr
        self.row_ids = row_ids


def to_handle(csr):
    """Preprocess a CSR for compute: expand the row ids."""
    trace("to_handle", kernel="torch", shape=(csr.nrows, csr.ncols), nnz=csr.nnz)
    return TorchHandle(csr, structure.row_ids_for(csr))


def from_handle(h):
    """Handle -> CSR; the tensors are shared."""
    from csr_tpu_torch import CSR

    c = h.csr
    return CSR(c.nrows, c.ncols, c.nnz, c.rowptrs, c.colinds, c.values, _cast=False)


def release_handle(h):
    """Release a handle.  Tensors are reference-counted; nothing to free."""
    trace("release_handle", kernel="torch", nnz=h.csr.nnz)


def order_columns(h):
    h.csr.sort_rows()


def _result_dtype(*dts):
    """Floating result dtype of an op on ``dts``: at least float32."""
    dt = functools.reduce(torch.promote_types, dts)
    if not dt.is_floating_point:
        dt = torch.float32
    return torch.promote_types(dt, torch.float32)


def _values_dtype(csr):
    return csr.values.dtype if csr.values is not None else torch.float32


def mult_vec(h, v):
    """SpMV ``A @ v``."""
    c = h.csr
    out_dtype = _result_dtype(_values_dtype(c), v.dtype)
    prod = c._required_values().to(out_dtype) * v.to(out_dtype)[c.colinds]
    out = torch.zeros(c.nrows, dtype=out_dtype, device=v.device)
    return out.index_add_(0, h.row_ids, prod)


def mult_vec_t(h, v):
    """Transpose SpMV ``A^T @ v``."""
    c = h.csr
    out_dtype = _result_dtype(_values_dtype(c), v.dtype)
    prod = c._required_values().to(out_dtype) * v.to(out_dtype)[h.row_ids]
    out = torch.zeros(c.ncols, dtype=out_dtype, device=v.device)
    return out.index_add_(0, c.colinds, prod)


def _densify(vals, cols, rids, nrows: int, ncols: int, dtype):
    """Dense ``(nrows, ncols)`` matrix of the entries; duplicates add."""
    out = torch.zeros(nrows * ncols, dtype=dtype, device=vals.device)
    flat = rids.to(torch.int64) * ncols + cols
    return out.index_add_(0, flat, vals.to(dtype)).view(nrows, ncols)


def densify(h, dtype, transpose: bool = False):
    """A handle's matrix (or its transpose, built directly) as a dense
    ``dtype`` tensor."""
    c = h.csr
    vals = c._required_values()
    if transpose:
        return _densify(vals, h.row_ids, c.colinds, c.ncols, c.nrows, dtype)
    return _densify(vals, c.colinds, h.row_ids, c.nrows, c.ncols, dtype)


def _spgemm_dense(a_vals, a_cols, a_rids, b_dense, nrows: int, ncols: int,
                  out_dtype):
    """Dense-accumulator product: ``C[r] += a_i * B[c_i, :]``."""
    out = torch.zeros(nrows, ncols, dtype=out_dtype, device=b_dense.device)
    return _spmm_op.scatter_rows(out, a_rids, a_cols, a_vals.to(out_dtype),
                                 b_dense.to(out_dtype))


def dense_to_csr(dense):
    """The nonzero entries of a dense matrix as a CSR, in row-major
    (column-sorted) order, on the matrix's device."""
    from csr_tpu_torch import CSR

    nrows, ncols = dense.shape
    mask = dense != 0
    rids, cols = torch.nonzero(mask, as_tuple=True)
    rps = torch.zeros(nrows + 1, dtype=torch.int64, device=dense.device)
    torch.cumsum(mask.sum(1), 0, out=rps[1:])
    return CSR(nrows, ncols, cols.shape[0], rps, cols, dense[mask])


def mult_dense(h, B):
    """SpMM ``A @ B`` with dense ``B``."""
    c = h.csr
    vals = c._required_values()
    out_dtype = _result_dtype(vals.dtype, B.dtype)
    return _spgemm_dense(vals, c.colinds, h.row_ids, B, c.nrows, B.shape[1],
                         out_dtype)


def _spgemm(a_h, b_h, transpose: bool):
    """SpGEMM by densification: densify B (or B^T), accumulate A's rows
    of it, compact the product to CSR.  Past the dense budget the
    product needs ESC (:mod:`csr_tpu_torch.ops.spgemm`)."""
    a, b = a_h.csr, b_h.csr
    out_dtype = _result_dtype(_values_dtype(a), _values_dtype(b))
    n_out = b.nrows if transpose else b.ncols
    if not _esc.dense_fits(a.nrows, b.nrows, b.ncols, n_out, out_dtype):
        mul = _esc.esc_mult_abt if transpose else _esc.esc_mult_ab
        return to_handle(mul(a, b, out_dtype))
    b_dense = densify(b_h, out_dtype, transpose)
    return to_handle(dense_to_csr(mult_dense(a_h, b_dense)))


def mult_ab(a_h, b_h):
    """SpGEMM ``A @ B``."""
    return _spgemm(a_h, b_h, transpose=False)


def mult_abt(a_h, b_h):
    """SpGEMM ``A @ B^T``."""
    return _spgemm(a_h, b_h, transpose=True)
