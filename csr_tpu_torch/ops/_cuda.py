"""
Build and bind the CUDA kernels of ``csrc/``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry, at first use, into this package's
git-ignored ``_build/`` directory; the file name carries a hash of the
source and flags.  The library is loaded with :mod:`ctypes`; pointers and
the stream are passed as ``c_void_p`` from ``tensor.data_ptr()`` and
``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import: the CPU tests import this module on machines
with no ``nvcc``.  A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import time

import torch

from csr_tpu_torch.native.build import build_cached

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "spmv_microblock.cu")
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None
#: seconds the first :func:`library` call took (build and load)
build_seconds = None
#: nvcc's output of the build (ptxas registers, shared memory, spills)
build_log = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built"
            " where the CUDA toolkit is installed"
        )
    return nvcc


def library():
    """The loaded kernel library, built first if needed."""
    global _LIB, build_seconds, build_log
    if _LIB is None:
        t0 = time.perf_counter()
        path, build_log = build_cached(SRC, "spmv_microblock",
                                       [_nvcc(), *_FLAGS], timeout=600)
        lib = ctypes.CDLL(path)
        vp = ctypes.c_void_p
        lib.csrt_spmv_microblock.restype = ctypes.c_int
        lib.csrt_spmv_microblock.argtypes = [
            vp, vp, vp, vp, vp, ctypes.c_int64, ctypes.c_int, ctypes.c_int, vp,
        ]
        build_seconds = time.perf_counter() - t0
        _LIB = lib
    return _LIB


def spmv_microblock(vals, meta, rbcb, x, y, n_groups: int, shift: int,
                    nrows: int) -> None:
    """Launch the micro-block SpMV kernel, ``y += A @ x``, on the current
    stream.  The caller has checked the tensors."""
    rc = library().csrt_spmv_microblock(
        vals.data_ptr(), meta.data_ptr(), rbcb.data_ptr(), x.data_ptr(),
        y.data_ptr(), n_groups, shift, nrows,
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"spmv_microblock launch failed: CUDA error {rc}")
