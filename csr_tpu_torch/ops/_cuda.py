"""
Build and bind the CUDA kernels of ``csrc/``.

Each source ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a``
into its own shared library with a plain C entry ``csrt_<name>``, at
first use, into this package's git-ignored ``_build/`` directory; the
file name carries a hash of the source, of the ``csrc/*.cuh`` headers it
includes and of the flags.  The library is loaded
with :mod:`ctypes`; pointers and the stream are passed as ``c_void_p``
from ``tensor.data_ptr()`` and ``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import: the CPU tests import this module on machines
with no ``nvcc``.  A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import time

import torch

from csr_tpu_torch.native.build import build_cached
from csr_tpu_torch.tracing import span

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: kernel name (the source's stem) -> argument types of ``csrt_<name>``
ENTRIES = {
    # vals, meta, rbcb, x, y, n_groups, shift, nrows, stream
    "spmv_microblock": [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _vp],
    # vals, meta, rbcb, b, c, n_groups, shift, nrows, n, ldb, ldc, lanes,
    # tiles_per_chunk, stream
    "spmm_microblock": [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _i64, _i64,
                        _i64, _i32, _i64, _vp],
    # vals, meta, rbcb, held, groups, n_layers, n_buckets, bucket_microrows,
    # x, x_stride, y, y_stride, grid, shift, nrows, stream
    "spmv_bucket": [_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i64, _vp, _i64, _vp,
                    _i64, _i64, _i32, _i32, _vp],
    # rowptrs, ptr64, edges, search, colinds, values (or NULL), x, y, nrows,
    # nnz, zeroed, carry, carry_row, slots, stream
    "spmv_csr": [_vp, _i32, _vp, _i32, _vp, _vp, _vp, _vp, _i64, _i64, _i32,
                 _vp, _vp, _i64, _vp],
    # rowptrs, ptr64, edges, search, colinds, values (or NULL), b, ldb, c, n,
    # nrows, nnz, carry, carry_row, width, lanes, stream
    "spmm_csr": [_vp, _i32, _vp, _i32, _vp, _vp, _vp, _i64, _vp, _i64, _i64,
                 _i64, _vp, _vp, _i32, _i32, _vp],
}

#: loaded libraries by kernel name
_LIBS: dict = {}
#: kernel name -> (its entry ``csrt_<name>``, the name of its launch's span)
_LAUNCH: dict = {}
#: seconds each kernel's first :func:`library` call took (build and load)
build_seconds: dict = {}
#: nvcc's output of each build (ptxas registers, shared memory, spills)
build_log: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built"
            " where the CUDA toolkit is installed"
        )
    return nvcc


def library(name: str):
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LIBS:
        t0 = time.perf_counter()
        path, log = build_cached(os.path.join(CSRC, f"{name}.cu"), name,
                                 [_nvcc(), *_FLAGS], timeout=600)
        lib = ctypes.CDLL(path)
        fn = getattr(lib, f"csrt_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ENTRIES[name]
        build_log[name] = log
        build_seconds[name] = time.perf_counter() - t0
        _LAUNCH[name] = (fn, "csr.launch." + name)
        _LIBS[name] = lib
    return _LIBS[name]


def _launch(name: str, *args) -> None:
    if name not in _LAUNCH:
        library(name)
    fn, span_name = _LAUNCH[name]
    with span(span_name):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def spmv_microblock(vals, meta, rbcb, x, y, n_groups: int, shift: int,
                    nrows: int) -> None:
    """Launch the micro-block SpMV kernel, ``y += A @ x``, on the current
    stream.  The caller has checked the tensors."""
    _launch("spmv_microblock", vals.data_ptr(), meta.data_ptr(),
            rbcb.data_ptr(), x.data_ptr(), y.data_ptr(), n_groups, shift,
            nrows, torch.cuda.current_stream(y.device).cuda_stream)


def spmm_microblock(vals, meta, rbcb, b, c, n_groups: int, shift: int,
                    nrows: int, lanes: int, tiles_per_chunk: int) -> None:
    """Launch the micro-block SpMM kernel, ``C += A @ B`` over the columns
    of C, with B and C row-major (B's rows a multiple of 4 floats apart,
    padded past C's width where it must be), on the current stream, by the
    caller's launch plan (``lanes`` lanes on a row of B, ``tiles_per_chunk``
    column tiles a block).  The caller has checked the tensors."""
    _launch("spmm_microblock", vals.data_ptr(), meta.data_ptr(),
            rbcb.data_ptr(), b.data_ptr(), c.data_ptr(), n_groups, shift,
            nrows, c.shape[1], b.stride(0), c.stride(0), lanes, tiles_per_chunk,
            torch.cuda.current_stream(c.device).cuda_stream)


def spmv_bucket(vals, meta, rbcb, held, groups, x, y, grid: int,
                shift: int, nrows: int) -> None:
    """Launch the bucket-selecting SpMV kernel on the current stream:
    ``y[l] += A[l, held[l]] @ x[l]`` for every layer ``l`` of the stack
    ``vals`` (L, B, M, 128), on ``grid`` blocks whose warps share out the
    held buckets' micro-rows.  The caller has checked the tensors."""
    n_layers, n_buckets, m = rbcb.shape
    _launch("spmv_bucket", vals.data_ptr(), meta.data_ptr(), rbcb.data_ptr(),
            held.data_ptr(), groups.data_ptr(), n_layers, n_buckets, m,
            x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0), grid,
            shift, nrows, torch.cuda.current_stream(y.device).cuda_stream)


def spmv_csr(rowptrs, edges, search: bool, colinds, values, x, y,
             zeroed: bool, carry, carry_row) -> None:
    """Launch the CSR-form SpMV kernel, ``y = A @ x`` (``zeroed``) or
    ``y += A @ x`` read from the matrix's own tensors (``values`` None:
    every value 1), and its carry pass, on the current stream.  ``edges``
    holds the rows at the share edges, or with ``search`` room for them,
    which a first launch fills; ``carry`` (f32) and ``carry_row`` (int64)
    are its scratch, an entry a block.  The caller has checked the
    tensors."""
    _launch("spmv_csr", rowptrs.data_ptr(), int(rowptrs.dtype == torch.int64),
            edges.data_ptr(), int(search), colinds.data_ptr(),
            None if values is None else values.data_ptr(), x.data_ptr(),
            y.data_ptr(), rowptrs.shape[0] - 1, colinds.shape[0], int(zeroed),
            carry.data_ptr(), carry_row.data_ptr(), carry_row.shape[0],
            torch.cuda.current_stream(y.device).cuda_stream)


def spmm_csr(rowptrs, edges, search: bool, colinds, values, b, c, carry,
             carry_row, width: int, lanes: int) -> None:
    """Launch the CSR-form SpMM kernel, ``C = A @ B`` read from the
    matrix's own tensors (``values`` None: every value 1), and its carry
    pass, on the current stream.  ``edges`` holds the rows at the share
    edges, or with ``search`` room for them, which a first launch fills;
    ``carry`` and ``carry_row`` are its scratch, a row a share; a lane
    loads ``width`` floats of B at a time and ``lanes`` lanes walk a row.
    The caller has checked the tensors."""
    _launch("spmm_csr", rowptrs.data_ptr(), int(rowptrs.dtype == torch.int64),
            edges.data_ptr(), int(search), colinds.data_ptr(),
            None if values is None else values.data_ptr(), b.data_ptr(),
            b.stride(0), c.data_ptr(), c.shape[1], rowptrs.shape[0] - 1,
            colinds.shape[0], carry.data_ptr(), carry_row.data_ptr(), width,
            lanes, torch.cuda.current_stream(c.device).cuda_stream)


def spmv_bucket_occupancy() -> tuple:
    """The bucket kernel's blocks an SM of the current device, by the CUDA
    runtime's reckoning of its registers, threads and shared memory; the
    threads and the shared memory (bytes) a block takes."""
    fn = library("spmv_bucket").csrt_spmv_bucket_occupancy
    blocks, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = fn(ctypes.byref(blocks), ctypes.byref(threads), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"spmv_bucket occupancy query failed: CUDA error {rc}")
    return blocks.value, threads.value, smem.value
