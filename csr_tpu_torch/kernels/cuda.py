"""
CUDA kernel backend, the tuned backend (counterpart of
:mod:`csr_tpu.kernels.pallas`).

``to_handle`` returns a handle whose micro-block layouts (of the matrix
and of its transpose) are packed on the host at first use and cached on
the matrix.  SpMV in both directions runs the hand-written kernel behind
:func:`csr_tpu_torch.ops.spmv.spmv`; on a CPU matrix that wrapper runs
the kernel's plain PyTorch version.

Routing, as in the JAX package:

* ``nnz == 0`` returns zeros;
* f64 values or operands go to the ``torch`` backend, as the JAX package
  routes f64 away from its kernel.  A kernel templated on f64 is ROADMAP
  Queue 1 item 7;
* a matrix outside the packing range (more than 32767 row windows or
  65535 column windows) raises :class:`NotImplementedError`: its
  chunk/panel form ``spmv_large`` is ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import numpy as np
import torch

from csr_tpu_torch import native
from csr_tpu_torch.kernels import torch as _torch_k
from csr_tpu_torch.kernels import trace
from csr_tpu_torch.ops import microblock
from csr_tpu_torch.ops import spmv as _spmv_op

# Per-operation capacity, from the card's memory: an H100 holds 80 GB.  A
# layout costs 6 B per padded slot, 12 B per stored entry at fill 0.5.  A
# matrix with both layouts cached also holds its CSR tensors (8 B per
# entry): about 32 B per entry all told, so 2.5G entries fill the card.
# Cap one operation at 2^30 entries (~34 GB), which leaves room for a
# second matrix, the operands and PyTorch's allocator.
max_nnz = 1 << 30


def _build(csr, transpose: bool):
    rp, cis, vals = csr.host_arrays()
    nrows, ncols = csr.nrows, csr.ncols
    if transpose:
        vals32 = None if vals is None else np.asarray(vals, np.float32)
        rp, cis, vals = native.transpose_host(nrows, ncols, rp, cis, vals32)
        nrows, ncols = ncols, nrows
    layout = microblock.build_microblocks_host(
        nrows, ncols, rp, cis, vals, device=csr.device
    )
    if layout is None:
        raise NotImplementedError(
            f"a {nrows}x{ncols} matrix exceeds the micro-block packing range"
            f" ({microblock.MAX_RB} row windows, {microblock.MAX_CB} column"
            " windows); its chunk/panel form spmv_large is ROADMAP Queue 1"
            " item 4"
        )
    trace(
        "layout-build-t" if transpose else "layout-build",
        nnz=layout.nnz, microrows=layout.n_microrows,
        fill=round(layout.fill, 3), bytes=layout.nbytes,
    )
    return layout


def _cached(csr, attr: str, transpose: bool) -> microblock.MicroBlockLayout:
    """Layout of ``csr`` (or of its transpose), cached on the matrix and
    keyed on the identity of its three tensors, so an op that replaces
    them invalidates the cache."""
    cached = getattr(csr, attr, None)
    if (
        cached is not None
        and cached[0] is csr.rowptrs
        and cached[1] is csr.colinds
        and cached[2] is csr.values
    ):
        return cached[3]
    layout = _build(csr, transpose)
    setattr(csr, attr, (csr.rowptrs, csr.colinds, csr.values, layout))
    return layout


def _cached_layout(csr) -> microblock.MicroBlockLayout:
    return _cached(csr, "_mb_layout_cache", transpose=False)


def _cached_layout_t(csr) -> microblock.MicroBlockLayout:
    return _cached(csr, "_mb_layout_t_cache", transpose=True)


class CudaHandle:
    """The CSR plus its lazily built layouts."""

    __slots__ = ("csr", "_layout", "_layout_t", "_torch_handle")

    def __init__(self, csr):
        self.csr = csr
        self._layout = None
        self._layout_t = None
        self._torch_handle = None

    @property
    def layout(self) -> microblock.MicroBlockLayout:
        if self._layout is None:
            self._layout = _cached_layout(self.csr)
        return self._layout

    @property
    def layout_t(self) -> microblock.MicroBlockLayout:
        if self._layout_t is None:
            self._layout_t = _cached_layout_t(self.csr)
        return self._layout_t

    @property
    def torch_handle(self):
        if self._torch_handle is None:
            self._torch_handle = _torch_k.to_handle(self.csr)
        return self._torch_handle


def to_handle(csr):
    trace("to_handle", kernel="cuda", shape=(csr.nrows, csr.ncols), nnz=csr.nnz)
    return CudaHandle(csr)


def from_handle(h):
    from csr_tpu_torch import CSR

    c = h.csr
    return CSR(c.nrows, c.ncols, c.nnz, c.rowptrs, c.colinds, c.values, _cast=False)


def release_handle(h, drop_cache: bool = False):
    """Drop the handle's references.  The layouts stay cached on the
    matrix unless ``drop_cache``, so repeated calls pack nothing."""
    trace("release_handle", kernel="cuda", nnz=h.csr.nnz)
    h._layout = None
    h._layout_t = None
    h._torch_handle = None
    if drop_cache:
        h.csr._mb_layout_cache = None
        h.csr._mb_layout_t_cache = None


def order_columns(h):
    h.csr.sort_rows()
    h._layout = None
    h._layout_t = None


def _mult(h, v, transpose: bool):
    c = h.csr
    out_dtype = _torch_k._result_dtype(_torch_k._values_dtype(c), v.dtype)
    if c.nnz == 0:
        n_out = c.ncols if transpose else c.nrows
        return torch.zeros(n_out, dtype=out_dtype, device=v.device)
    if out_dtype == torch.float64:
        fn = _torch_k.mult_vec_t if transpose else _torch_k.mult_vec
        return fn(h.torch_handle, v)
    layout = h.layout_t if transpose else h.layout
    return _spmv_op.spmv(layout, v).to(out_dtype)


def mult_vec(h, v):
    """SpMV ``A @ v`` on the micro-block kernel."""
    return _mult(h, v, transpose=False)


def mult_vec_t(h, v):
    """Transpose SpMV ``A^T @ v`` on the micro-block kernel, over a cached
    layout of the transpose (built by a host transpose)."""
    return _mult(h, v, transpose=True)


def mult_dense(h, B):
    raise NotImplementedError("SpMM is ROADMAP Queue 1 item 5")


def mult_ab(a_h, b_h):
    raise NotImplementedError("SpGEMM is ROADMAP Queue 1 item 6")


def mult_abt(a_h, b_h):
    raise NotImplementedError("SpGEMM is ROADMAP Queue 1 item 6")
