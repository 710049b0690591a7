"""
ctypes bindings for the native host CSR utilities (counterpart of
:mod:`csr_tpu.native`).

The library is the JAX package's ``csr_host.cpp``, built by
:mod:`csr_tpu_torch.native.build`.  It speeds up host-side construction
and micro-block packing on numpy buffers.  Every caller has a numpy
fallback, so a missing toolchain costs speed only; ``CSR_TPU_NO_NATIVE``
disables the library.
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

_log = logging.getLogger(__name__)

_LIB = None
_TRIED = False

_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u16p = ctypes.POINTER(ctypes.c_uint16)


def _p(a, t):
    return a.ctypes.data_as(t)


def _fp(a):
    t = ctypes.c_double if a.dtype == np.float64 else ctypes.c_float
    return a.ctypes.data_as(ctypes.POINTER(t))


def _bind(lib):
    f64p = ctypes.POINTER(ctypes.c_double)
    for suffix, vp in (("f64", f64p), ("f32", _f32p)):
        fn = getattr(lib, f"csrt_from_coo_{suffix}")
        fn.restype = None
        fn.argtypes = [_i64, _i32p, _i32p, vp, _i64, _i64p, _i32p, vp]
        fn = getattr(lib, f"csrt_transpose_{suffix}")
        fn.restype = None
        fn.argtypes = [_i64, _i64, _i64p, _i32p, vp, _i64p, _i32p, vp]
    lib.csrt_from_coo_structure.restype = None
    lib.csrt_from_coo_structure.argtypes = [_i64, _i32p, _i32p, _i64, _i64p, _i32p]
    lib.csrt_transpose_structure.restype = None
    lib.csrt_transpose_structure.argtypes = [_i64, _i64, _i64p, _i32p, _i64p, _i32p]
    lib.csrt_mb_plan.restype = _i64
    lib.csrt_mb_plan.argtypes = [_i64, _i64, _i64, _i64p, _i32p, _i64, _i64, _i64]
    lib.csrt_mb_plan3.restype = _i64
    lib.csrt_mb_plan3.argtypes = [_i64, _i64, _i64, _i64p, _i32p, _i64, _i64, _i64p]
    lib.csrt_mb_fill.restype = _i64
    lib.csrt_mb_fill.argtypes = [_i64, _i64, _i64, _i64p, _i32p, _f32p, _i64,
                                 _i64, _i64, _i64, _f32p, _u16p, _i32p]


def get_lib():
    """The loaded native library, or None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CSR_TPU_NO_NATIVE"):
        return None
    try:
        from .build import ensure_built

        lib = ctypes.CDLL(ensure_built())
        _bind(lib)
        _LIB = lib
    except Exception as e:  # missing g++ or source: the numpy paths remain
        _log.debug("native csr host library unavailable: %s", e)
    return _LIB


def available() -> bool:
    return get_lib() is not None


def from_coo(nrows: int, rows, cols, values=None):
    """Native COO->CSR; returns (rowptrs i64, colinds i32, values) numpy
    arrays, or None if the library is unavailable or the value dtype is
    neither f32 nor f64."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    nnz = len(rows)
    rowptrs = np.empty(nrows + 1, np.int64)
    out_cols = np.empty(nnz, np.int32)
    if values is None:
        lib.csrt_from_coo_structure(
            nnz, _p(rows, _i32p), _p(cols, _i32p), nrows,
            _p(rowptrs, _i64p), _p(out_cols, _i32p),
        )
        return rowptrs, out_cols, None
    values = np.ascontiguousarray(values)
    if values.dtype == np.float64:
        fn = lib.csrt_from_coo_f64
    elif values.dtype == np.float32:
        fn = lib.csrt_from_coo_f32
    else:
        return None
    out_vals = np.empty(nnz, values.dtype)
    fn(
        nnz, _p(rows, _i32p), _p(cols, _i32p), _fp(values), nrows,
        _p(rowptrs, _i64p), _p(out_cols, _i32p), _fp(out_vals),
    )
    return rowptrs, out_cols, out_vals


def transpose(nrows, ncols, rowptrs, colinds, values=None):
    """Native CSR transpose on host arrays, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rowptrs = np.ascontiguousarray(rowptrs, np.int64)
    colinds = np.ascontiguousarray(colinds, np.int32)
    nnz = len(colinds)
    t_rps = np.empty(ncols + 1, np.int64)
    t_cis = np.empty(nnz, np.int32)
    if values is None:
        lib.csrt_transpose_structure(
            nrows, ncols, _p(rowptrs, _i64p), _p(colinds, _i32p),
            _p(t_rps, _i64p), _p(t_cis, _i32p),
        )
        return t_rps, t_cis, None
    values = np.ascontiguousarray(values)
    if values.dtype == np.float64:
        fn = lib.csrt_transpose_f64
    elif values.dtype == np.float32:
        fn = lib.csrt_transpose_f32
    else:
        return None
    t_vls = np.empty(nnz, values.dtype)
    fn(
        nrows, ncols, _p(rowptrs, _i64p), _p(colinds, _i32p),
        _fp(values), _p(t_rps, _i64p), _p(t_cis, _i32p), _fp(t_vls),
    )
    return t_rps, t_cis, t_vls


def transpose_host(nrows, ncols, rowptrs, colinds, values=None):
    """CSR transpose on host arrays: the native counting sort when the
    library is available, a numpy stable argsort otherwise.  Returns the
    ``(t_rowptrs, t_colinds, t_values)`` triple."""
    t = transpose(nrows, ncols, rowptrs, colinds, values)
    if t is not None:
        return t
    rp = np.asarray(rowptrs)
    cis = np.asarray(colinds)
    order = np.argsort(cis, kind="stable")
    rids = np.repeat(np.arange(nrows, dtype=np.int32), np.diff(rp))
    t_rps = np.zeros(ncols + 1, np.int64)
    np.cumsum(np.bincount(cis, minlength=ncols), out=t_rps[1:])
    t_vls = None if values is None else np.asarray(values)[order]
    return t_rps, rids[order].astype(np.int32), t_vls


def plan_microrows(nrows, ncols, rowptrs, cols, window: int,
                   pad_mult: int, pair: int = 1):
    """Native micro-row count of one (window, pair) layout, or None when
    the library is unavailable or the matrix is outside the packing
    range."""
    if pair not in (1, 2, 4):  # the packer's group mask needs a power of two
        raise ValueError(f"pair {pair}: expected 1, 2 or 4")
    lib = get_lib()
    if lib is None:
        return None
    rowptrs = np.ascontiguousarray(rowptrs, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    m = lib.csrt_mb_plan(
        len(cols), nrows, ncols, _p(rowptrs, _i64p), _p(cols, _i32p),
        int(window).bit_length() - 1, pad_mult, pair,
    )
    return None if m < 0 else int(m)


def plan_microrows3(nrows, ncols, rowptrs, cols, window: int, pad_mult: int):
    """Native micro-row counts for pair = (1, 2, 4) at one window width,
    or None when unavailable or out of range."""
    lib = get_lib()
    if lib is None:
        return None
    rowptrs = np.ascontiguousarray(rowptrs, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    out3 = np.empty(3, np.int64)
    rc = lib.csrt_mb_plan3(
        len(cols), nrows, ncols, _p(rowptrs, _i64p), _p(cols, _i32p),
        int(window).bit_length() - 1, pad_mult, _p(out3, _i64p),
    )
    return None if rc < 0 else tuple(int(v) for v in out3)


def build_microblocks(nrows, ncols, rowptrs, cols, values, m_round: int,
                      window: int, pad_mult: int, pair: int = 1):
    """Native micro-block layout build (``csrt_mb_plan``/``csrt_mb_fill``).

    Returns ``(vals, meta, rbcb, m)`` numpy arrays of ``m_pad`` micro-rows
    (``m`` rounded up to ``m_round``), or None when the library is
    unavailable or the matrix is outside the packing range."""
    lib = get_lib()
    if lib is None:
        return None
    rowptrs = np.ascontiguousarray(rowptrs, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    nnz = len(cols)
    cshift = int(window).bit_length() - 1
    m = lib.csrt_mb_plan(nnz, nrows, ncols, _p(rowptrs, _i64p),
                         _p(cols, _i32p), cshift, pad_mult, pair)
    if m < 0:
        return None
    m_pad = -(-max(int(m), 1) // m_round) * m_round
    vals = np.zeros((m_pad, 128), np.float32)
    meta = np.zeros((m_pad, 128), np.uint16)
    rbcb = np.zeros(m_pad, np.int32)
    vp = None
    if values is not None:
        values = np.ascontiguousarray(values, np.float32)
        vp = _p(values, _f32p)
    m2 = lib.csrt_mb_fill(
        nnz, nrows, ncols, _p(rowptrs, _i64p), _p(cols, _i32p), vp, cshift,
        pad_mult, pair, m_pad, _p(vals, _f32p), _p(meta, _u16p),
        _p(rbcb, _i32p),
    )
    assert m2 == m, (m2, m)
    return vals, meta, rbcb, int(m)
