"""
CUDA kernel backend, the tuned backend (counterpart of
:mod:`csr_tpu.kernels.pallas`).

``to_handle`` returns a handle whose micro-block layouts (of the matrix
and of its transpose) are packed on the host at first use and cached on
the matrix.  SpMV in both directions runs the hand-written kernel behind
:func:`csr_tpu_torch.ops.spmv.spmv`; SpMM (``mult_dense``) and the
sparse leg of SpGEMM (``mult_ab``, ``mult_abt``) run the one behind
:func:`csr_tpu_torch.ops.spmm.spmm`.  On a CPU matrix each wrapper runs
its kernel's plain PyTorch version.

Routing, as in the JAX package, decided from shapes and dtypes before
any launch:

* ``nnz == 0`` returns zeros;
* f64 values or operands go to the ``torch`` backend, as the JAX package
  routes f64 away from its kernel.  A kernel templated on f64 is ROADMAP
  Queue 1 item 7;
* SpMV of a matrix (or, for ``mult_vec_t``, a transpose) of more than
  :data:`_LARGE_WINDOWS` row windows, or outside the packing range,
  runs ``ops/spmv.py:spmv_large``: chunks of :data:`_LARGE_WINDOWS` row
  windows and panels of as many column windows, the SpMV kernel once a
  panel.  The layouts are cached on the matrix as the others are.  SpMM
  of a matrix outside the packing range goes to the ``torch`` backend,
  as the JAX package runs no SpMM on panels;
* SpMM of a matrix whose dense f32 form fits the dense budget of
  :mod:`csr_tpu_torch.ops.spgemm` and whose density is at least
  :func:`_min_density` of B's width is a densified f32 ``torch.matmul``
  with TF32 off (the JAX package's ``Precision.HIGHEST`` product, which
  it leaves to XLA); the threshold was measured on the H100 (PERF.md);
  the rest runs the SpMM kernel;
* SpGEMM densifies B (or B^T) within the budget of
  :mod:`csr_tpu_torch.ops.spgemm` and multiplies A by it as SpMM does;
  past that budget it runs that module's expand-sort-compress (ESC).

SpMV in either direction goes through
:func:`csr_tpu_torch.ops.spmv.product`, so ``torch.func.vmap`` over the
operand runs one SpMM launch a layout on the batch.  No product has a
backward: ``mult_vec``, ``mult_vec_t`` and ``mult_dense`` raise
ValueError when grad mode is on and the operand or the values require
grad, on the CPU and on the card alike (the ``torch`` backend
differentiates).

Each SpMM or SpGEMM emits a ``mult_dense`` or ``spgemm`` trace event
whose ``route`` is ``zeros``, ``torch``, ``dense``, ``kernel`` or (SpGEMM
only) ``esc``.
"""

from __future__ import annotations

import numpy as np
import torch

from csr_tpu_torch import native
from csr_tpu_torch.kernels import torch as _torch_k
from csr_tpu_torch.kernels import trace
from csr_tpu_torch.ops import microblock
from csr_tpu_torch.ops import spgemm as _spgemm_op
from csr_tpu_torch.ops import spmm as _spmm_op
from csr_tpu_torch.ops import spmv as _spmv_op

# Per-operation capacity, from the card's memory: an H100 holds 80 GB.  A
# layout costs 6 B per padded slot, 12 B per stored entry at fill 0.5.  A
# matrix with both layouts cached also holds its CSR tensors (8 B per
# entry): about 32 B per entry all told, so 2.5G entries fill the card.
# Cap one operation at 2^30 entries (~34 GB), which leaves room for a
# second matrix, the operands and PyTorch's allocator.
max_nnz = 1 << 30


#: the large path's budget, in 128-wide windows: SpMV of a matrix of more
#: row windows (or one outside the packing range) runs ``spmv_large`` on
#: chunks of this many row windows and panels of this many column
#: windows.  At the packer's row range, routing is that of every matrix
#: the packer takes, and no chunk leaves it.
_LARGE_WINDOWS = microblock.MAX_RB


def _needs_large(nrows: int, ncols: int) -> bool:
    """Whether SpMV of an ``nrows x ncols`` matrix runs ``spmv_large``."""
    return (-(-nrows // microblock.LANE) > _LARGE_WINDOWS
            or not _packable(nrows, ncols))


def _host_form(csr, transpose: bool):
    """``(nrows, ncols, rowptrs, colinds, values)`` of ``csr`` or of its
    transpose, on the host (the transpose by the native host transpose)."""
    rp, cis, vals = csr.host_arrays()
    nrows, ncols = csr.nrows, csr.ncols
    if transpose:
        vals32 = None if vals is None else np.asarray(vals, np.float32)
        rp, cis, vals = native.transpose_host(nrows, ncols, rp, cis, vals32)
        nrows, ncols = ncols, nrows
    return nrows, ncols, rp, cis, vals


def _build(csr, transpose: bool):
    nrows, ncols, rp, cis, vals = _host_form(csr, transpose)
    layout = microblock.build_microblocks_host(
        nrows, ncols, rp, cis, vals, device=csr.device
    )
    if layout is None:
        raise ValueError(
            f"a {nrows}x{ncols} matrix is outside the micro-block packing"
            f" range ({microblock.MAX_RB} row windows, {microblock.MAX_CB}"
            " column windows): route it to spmv_large"
        )
    trace(
        "layout-build-t" if transpose else "layout-build",
        nnz=layout.nnz, microrows=layout.n_microrows,
        fill=round(layout.fill, 3), bytes=layout.nbytes,
    )
    return layout


def _build_large(csr, transpose: bool):
    nrows, ncols, rp, cis, vals = _host_form(csr, transpose)
    chunks = _spmv_op.build_large_layouts(
        nrows, ncols, rp, cis, vals, max_windows=_LARGE_WINDOWS,
        device=csr.device,
    )
    trace(
        "layout-build-large", nnz=csr.nnz, chunks=len(chunks),
        panels=sum(len(p) for _, p in chunks), transpose=transpose,
        bytes=sum(lay.nbytes for _, p in chunks for _, lay in p),
    )
    return chunks


def _cached(csr, attr: str, build, transpose: bool):
    """``build(csr, transpose)``, cached on the matrix and keyed on the
    identity of its three tensors, so an op that replaces them
    invalidates the cache."""
    cached = getattr(csr, attr, None)
    if (
        cached is not None
        and cached[0] is csr.rowptrs
        and cached[1] is csr.colinds
        and cached[2] is csr.values
    ):
        return cached[3]
    built = build(csr, transpose)
    setattr(csr, attr, (csr.rowptrs, csr.colinds, csr.values, built))
    return built


def _cached_layout(csr) -> microblock.MicroBlockLayout:
    return _cached(csr, "_mb_layout_cache", _build, transpose=False)


def _cached_layout_t(csr) -> microblock.MicroBlockLayout:
    return _cached(csr, "_mb_layout_t_cache", _build, transpose=True)


def _cached_large(csr, transpose: bool):
    """Chunk/panel layouts of ``csr`` (or of its transpose), cached."""
    attr = "_mb_large_t_cache" if transpose else "_mb_large_cache"
    return _cached(csr, attr, _build_large, transpose)


class CudaHandle:
    """The CSR plus its lazily built layouts and dense form."""

    __slots__ = ("csr", "_layout", "_layout_t", "_torch_handle", "_dense")

    def __init__(self, csr):
        self.csr = csr
        self._layout = None
        self._layout_t = None
        self._torch_handle = None
        self._dense = None

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

    @property
    def dense(self) -> torch.Tensor:
        """The matrix densified in f32, cached on the handle."""
        if self._dense is None:
            self._dense = _torch_k.densify(self.torch_handle, torch.float32)
        return self._dense


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
    h._dense = None
    if drop_cache:
        for attr in ("_mb_layout_cache", "_mb_layout_t_cache",
                     "_mb_large_cache", "_mb_large_t_cache"):
            setattr(h.csr, attr, None)


def order_columns(h):
    h.csr.sort_rows()
    h._layout = None
    h._layout_t = None


def _refuse_grad(h, operand, op: str) -> None:
    """Raise ValueError when grad mode is on and the operand or the
    matrix's values require grad.  The kernels have no backward (nor has
    the JAX package's ``pallas`` backend, which refuses ``jax.grad``), and
    a kernel writes its result through a raw pointer, so the result would
    come back with no ``grad_fn``: the gradient would be dropped without
    a word on the card, where the CPU's plain version would carry it."""
    if not torch.is_grad_enabled():
        return
    vals = h.csr.values
    if operand.requires_grad or (vals is not None and vals.requires_grad):
        raise ValueError(
            f"{op} on the cuda backend has no backward: differentiate on the"
            " torch backend (kernels.use_kernel('torch')), or run under"
            " torch.no_grad()")


def _mult(h, v, transpose: bool):
    op = "mult_vec_t" if transpose else "mult_vec"
    _refuse_grad(h, v, op)
    c = h.csr
    out_dtype = _torch_k._result_dtype(_torch_k._values_dtype(c), v.dtype)
    if c.nnz == 0:
        n_out = c.ncols if transpose else c.nrows
        return torch.zeros(n_out, dtype=out_dtype, device=v.device)
    if out_dtype == torch.float64:
        fn = _torch_k.mult_vec_t if transpose else _torch_k.mult_vec
        return fn(h.torch_handle, v)
    nrows, ncols = (c.ncols, c.nrows) if transpose else (c.nrows, c.ncols)
    if _needs_large(nrows, ncols):
        a = _cached_large(c, transpose)
    else:
        a = h.layout_t if transpose else h.layout
    return _spmv_op.product(a, v, ncols, op).to(out_dtype)


def mult_vec(h, v):
    """SpMV ``A @ v`` on the micro-block kernel (chunks and panels past
    :data:`_LARGE_WINDOWS`)."""
    return _mult(h, v, transpose=False)


def mult_vec_t(h, v):
    """Transpose SpMV ``A^T @ v`` on the micro-block kernel, over a cached
    layout of the transpose (built by a host transpose)."""
    return _mult(h, v, transpose=True)


#: densify-and-matmul route: (width n of B, density) points at which a
#: whole mult_dense call on the dense route (densify + full-f32 matmul)
#: starts to beat one on the SpMM kernel.  Both routes cost about
#: rows x columns x n of A times a rate (the matmul's, or the kernel's at
#: that density), plus densifying, which does not grow with n; so the
#: crossover is a density that moves with n alone.  Measured on an H100
#: 80GB HBM3 at 700 W (chip_smoke.py phase 11, 8192^2 at densities 1e-3 to
#: 3e-1, B 50, 128, 256 and 8192 wide, log-interpolated; PERF.md).  The
#: points at n = 256 and 8192 lie inside that range.  At n = 128 the
#: kernel route still wins at 0.3, by 8%, and its point is the trend of
#: 0.1 and 0.3 carried on to where it crosses, 0.35; at n = 50 it wins at
#: 0.3 by 2.2 x and that trend crosses at no density a matrix has, so its
#: point is 1.  Past 0.3 both are extrapolated: a wrong route there costs
#: time, never the result.
_DENSIFY_CROSSOVER = ((50, 1.0), (128, 0.35), (256, 0.1706), (8192, 0.08193))


def _min_density(n: int) -> float:
    """The crossover density at width ``n``: linear in log n between the
    points of :data:`_DENSIFY_CROSSOVER`, constant past its ends."""
    widths, densities = zip(*_DENSIFY_CROSSOVER)
    return float(np.interp(np.log(max(n, 1)), np.log(widths), densities))


def _dense_affordable(csr, n: int) -> bool:
    """Whether ``A @ B`` with B ``n`` wide takes the dense route."""
    elems = csr.nrows * csr.ncols
    if elems == 0 or elems * 4 > _spgemm_op.max_dense_bytes:
        return False
    return csr.nnz / elems >= _min_density(n)


def _packable(nrows: int, ncols: int) -> bool:
    """Whether the micro-block layout can address an ``nrows x ncols``
    matrix (at the wider window, which :func:`microblock.choose_layout`
    falls back to)."""
    return microblock.in_range(nrows, ncols, 2 * microblock.LANE)


def _matmul_f32(a, b):
    """``a @ b`` in full f32, TF32 off (the JAX package's
    ``Precision.HIGHEST``)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _sparse_times_dense(h, b, op: str):
    """``A @ b`` for f32 dense ``b`` (A's columns by n), on the route its
    shape picks: densified matmul, the SpMM kernel, or (outside the
    packing range) the torch backend.  Emits a trace event naming it."""
    c = h.csr
    if _dense_affordable(c, b.shape[1]):
        trace(op, route="dense", shape=(c.nrows, c.ncols), n=b.shape[1])
        return _matmul_f32(h.dense, b)
    if not _packable(c.nrows, c.ncols):
        trace(op, route="torch", shape=(c.nrows, c.ncols), n=b.shape[1])
        return _torch_k.mult_dense(h.torch_handle, b)
    trace(op, route="kernel", shape=(c.nrows, c.ncols), n=b.shape[1])
    return _spmm_op.spmm(h.layout, b)


def mult_dense(h, B):
    """SpMM ``A @ B`` with dense ``B`` (see the module docstring for the
    routes)."""
    _refuse_grad(h, B, "mult_dense")
    c = h.csr
    out_dtype = _torch_k._result_dtype(_torch_k._values_dtype(c), B.dtype)
    if c.nnz == 0:
        trace("mult_dense", route="zeros", shape=(c.nrows, c.ncols), n=B.shape[1])
        return torch.zeros(c.nrows, B.shape[1], dtype=out_dtype, device=B.device)
    if out_dtype == torch.float64:
        trace("mult_dense", route="torch", shape=(c.nrows, c.ncols), n=B.shape[1])
        return _torch_k.mult_dense(h.torch_handle, B)
    return _sparse_times_dense(h, B.to(torch.float32), "mult_dense").to(out_dtype)


def _spgemm(a_h, b_h, transpose: bool):
    """SpGEMM on the dense route: densify B (or B^T) in f32, multiply A by
    it on :func:`_sparse_times_dense`'s route, compact the product to CSR.
    f64 goes to the torch backend; a product past the dense budget runs
    ESC (:mod:`csr_tpu_torch.ops.spgemm`)."""
    a, b = a_h.csr, b_h.csr
    out_dtype = _torch_k._result_dtype(_torch_k._values_dtype(a),
                                       _torch_k._values_dtype(b))
    if out_dtype == torch.float64:
        trace("spgemm", route="torch", shape=(a.nrows, a.ncols), n=b.nrows)
        fn = _torch_k.mult_abt if transpose else _torch_k.mult_ab
        return to_handle(_torch_k.from_handle(fn(a_h.torch_handle, b_h.torch_handle)))
    n_out = b.nrows if transpose else b.ncols
    if not _spgemm_op.dense_fits(a.nrows, b.nrows, b.ncols, n_out, out_dtype):
        trace("spgemm", route="esc", shape=(a.nrows, a.ncols), n=n_out)
        mul = _spgemm_op.esc_mult_abt if transpose else _spgemm_op.esc_mult_ab
        return to_handle(mul(a, b, out_dtype))
    if a.nnz == 0 or b.nnz == 0:
        from csr_tpu_torch import CSR

        trace("spgemm", route="zeros", shape=(a.nrows, a.ncols), n=n_out)
        return to_handle(CSR.empty(a.nrows, n_out, device=a.device))
    b_dense = _torch_k.densify(b_h.torch_handle, torch.float32, transpose)
    c_dense = _sparse_times_dense(a_h, b_dense, "spgemm")
    return to_handle(_torch_k.dense_to_csr(c_dense))


def mult_ab(a_h, b_h):
    """SpGEMM ``A @ B`` (see :func:`_spgemm`)."""
    return _spgemm(a_h, b_h, transpose=False)


def mult_abt(a_h, b_h):
    """SpGEMM ``A @ B^T`` (see :func:`_spgemm`)."""
    return _spgemm(a_h, b_h, transpose=True)
