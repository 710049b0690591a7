"""
Build and bind the CUDA kernels of ``csrc/``.

Each source ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a``
into its own shared library with a plain C entry ``csrt_<name>``, at
first use, into this package's git-ignored ``_build/`` directory; the
file name carries a hash of the source, of the ``csrc/*.cuh`` headers it
includes and of the flags.  The library is loaded
with :mod:`ctypes`; pointers and the stream are passed as ``c_void_p``
from ``tensor.data_ptr()`` and :func:`stream`.  The kernel wrappers of
``ops/`` bind a kernel's :func:`entry` and the matrix's side of its
arguments once and launch by :func:`call_on`; :func:`spmv_bucket`
launches from tensors.

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
    # vals, meta, rbcb, order (or NULL), b, c, n_groups, shift, nrows, n, ldb,
    # ldc, lanes, tiles_per_chunk, stream
    "spmm_microblock": [_vp, _vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _i64,
                        _i64, _i64, _i32, _i64, _vp],
    # vals, meta, rbcb, held, groups, n_layers, n_buckets, bucket_microrows,
    # x, x_stride, y, y_stride, grid, shift, nrows, stream
    "spmv_bucket": [_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i64, _vp, _i64, _vp,
                    _i64, _i64, _i32, _i32, _vp],
    # rowptrs, ptr64, edges, search, colinds, values (or NULL), x, y, nrows,
    # nnz, zeroed, carry, carry_row, slots, stream
    "spmv_csr": [_vp, _i32, _vp, _i32, _vp, _vp, _vp, _vp, _i64, _i64, _i32,
                 _vp, _vp, _i64, _vp],
    # rowptrs, ptr64, edges, search, colinds, values (or NULL), b, ldb, c, n,
    # nrows, nnz, carry, carry_row, width, lanes, panels, panel_base (or
    # NULL), panel_nnz (a host array, or NULL), stream
    "spmm_csr": [_vp, _i32, _vp, _i32, _vp, _vp, _vp, _i64, _vp, _i64, _i64,
                 _i64, _vp, _vp, _i32, _i32, _i32, _vp, _vp, _vp],
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


def entry(name: str) -> tuple:
    """``(csrt_<name>, the name of its launch's span)``, the library built
    and loaded first if needed."""
    if name not in _LAUNCH:
        library(name)
    return _LAUNCH[name]


def call(kernel: tuple, *args) -> None:
    """Call a kernel's :func:`entry` with ``args`` in its launch's span;
    raise on a CUDA error."""
    fn, span_name = kernel
    with span(span_name):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{span_name.removeprefix('csr.launch.')} launch"
                           f" failed: CUDA error {rc}")


def call_on(index: int, kernel: tuple, *args) -> None:
    """:func:`call` with device ``index`` current: the device guard is
    entered only where another device is current (the caller has made
    tensors on it, so CUDA is initialised)."""
    if torch._C._cuda_getDevice() == index:
        call(kernel, *args)
    else:
        with torch.cuda.device(index):
            call(kernel, *args)


#: the current stream of a device as a ``cudaStream_t``, where this build
#: of torch has the raw form (None in a build without CUDA)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(index: int) -> int:
    """The current stream of device ``index``, as the ``cudaStream_t`` the
    entries take."""
    if _raw_stream is None:
        return torch.cuda.current_stream(index).cuda_stream
    return _raw_stream(index)


def _launch(name: str, *args) -> None:
    call(entry(name), *args)


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
