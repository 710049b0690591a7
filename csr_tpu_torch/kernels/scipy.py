"""
SciPy host kernel (counterpart of :mod:`csr_tpu.kernels.scipy`).

The correctness oracle for tests and benchmarks: it computes on the host
with :mod:`scipy.sparse` and returns tensors on the operand's device.  It
is never selected by default.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import csr_matrix

from csr_tpu_torch.kernels import trace

max_nnz = np.iinfo("i8").max


def to_handle(csr):
    """CSR -> scipy.sparse.csr_matrix on the host."""
    trace("to_handle", kernel="scipy", shape=(csr.nrows, csr.ncols),
          nnz=csr.nnz)
    rps, cis, vs = csr.host_arrays()
    # copies: scipy mutates in place (sort_indices), and the host arrays
    # may alias the matrix's own storage
    vs = np.ones(csr.nnz) if vs is None else np.array(vs)
    return csr_matrix((vs, np.array(cis), np.array(rps)), (csr.nrows, csr.ncols))


def from_handle(h):
    """scipy matrix -> CSR on the CPU."""
    from csr_tpu_torch import CSR

    m = h.tocsr()
    nr, nc = m.shape
    return CSR(nr, nc, m.nnz, m.indptr, m.indices, m.data)


def order_columns(h):
    h.sort_indices()


def release_handle(h):
    trace("release_handle", kernel="scipy", nnz=h.nnz)


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _like(out, v):
    device = v.device if isinstance(v, torch.Tensor) else None
    return torch.as_tensor(np.ascontiguousarray(out), device=device)


def mult_vec(A, v):
    return _like(A @ _host(v), v)


def mult_vec_t(A, v):
    return _like(A.T @ _host(v), v)


def mult_dense(A, B):
    return _like(A @ _host(B), B)


def mult_ab(A, B):
    return A @ B


def mult_abt(A, B):
    return A @ B.T
