"""
Plain PyTorch kernel backend (counterpart of :mod:`csr_tpu.kernels.xla`).

The portable backend: it runs on any device, with no kernel of this
repository.  SpMV is ``index_add_`` of ``values * v[colinds]`` over the
per-entry row ids that the handle carries.  SpMM and SpGEMM are ROADMAP
Queue 1 items 5 and 6.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from csr_tpu_torch import structure
from csr_tpu_torch.kernels import trace

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


def mult_dense(h, B):
    raise NotImplementedError("SpMM is ROADMAP Queue 1 item 5")


def mult_ab(a_h, b_h):
    raise NotImplementedError("SpGEMM is ROADMAP Queue 1 item 6")


def mult_abt(a_h, b_h):
    raise NotImplementedError("SpGEMM is ROADMAP Queue 1 item 6")
