"""
Constructors of CSR matrices (counterpart of :mod:`csr_tpu.constructors`).

Plain functions that build a :class:`~csr_tpu_torch.CSR` on ``device``
(default :func:`~csr_tpu_torch.kernels.default_device`; tensor inputs
keep their own device).
"""

from __future__ import annotations

import numpy as np
import torch

from .csr import CSR
from .dtypes import COLIND_DTYPE, VALUE_DTYPE
from .kernels import default_device


def create_empty(nrows, ncols, *, device=None):
    """An empty ``nrows x ncols`` matrix with a float32 value array."""
    device = default_device() if device is None else device
    return CSR(nrows, ncols, 0, torch.zeros(int(nrows) + 1, dtype=torch.int32),
               torch.zeros(0, dtype=COLIND_DTYPE),
               torch.zeros(0, dtype=VALUE_DTYPE), device=device)


def create_novalues(nrows, ncols, nnz, rowptrs, colinds, *, device=None):
    """A structure-only matrix."""
    return CSR(nrows, ncols, nnz, rowptrs, colinds, None, device=device)


def create(nrows, ncols, nnz, rowptrs, colinds, values, *, device=None):
    """A matrix from its three arrays."""
    return CSR(nrows, ncols, nnz, rowptrs, colinds, values, device=device)


def create_from_sizes(nrows, ncols, sizes, *, device=None):
    """A matrix with ``sizes[i]`` stored entries in row ``i``: column
    indices -1 and values NaN until the caller fills them."""
    sizes = np.asarray(sizes)
    nnz = int(np.sum(sizes))
    if nnz < 0:
        raise ValueError("row sizes sum to a negative count")
    device = default_device() if device is None else device
    rowptrs = np.zeros(int(nrows) + 1, dtype=np.int64)
    np.cumsum(sizes, dtype=np.int64, out=rowptrs[1:])
    return CSR(nrows, ncols, nnz, torch.from_numpy(rowptrs),
               torch.full((nnz,), -1, dtype=COLIND_DTYPE),
               torch.full((nnz,), float("nan"), dtype=VALUE_DTYPE),
               device=device)
