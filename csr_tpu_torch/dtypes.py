"""
Data-type policy (counterpart of :mod:`csr_tpu.dtypes`).

Column indices are ``int32``.  Row pointers are ``int32`` unless the
matrix has more than ``INT32_MAX`` stored entries, then ``int64``.
Implicit values of structure-only matrices are ``float32``.

PyTorch never narrows a 64-bit tensor behind the caller's back, so the
JAX package's x64 scopes have no counterpart here: f64 values stay f64.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = int(np.iinfo(np.int32).max)

COLIND_DTYPE = torch.int32

#: dtype of the implicit values of a structure-only matrix
VALUE_DTYPE = torch.float32


def ptr_dtype(nnz: int) -> torch.dtype:
    """Row-pointer dtype for a matrix with ``nnz`` stored entries."""
    return torch.int32 if nnz <= INT32_MAX else torch.int64
