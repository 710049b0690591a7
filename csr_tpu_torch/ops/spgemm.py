"""
The memory budget of the dense-routing SpGEMM (counterpart of the
budget half of :mod:`csr_tpu.ops.spgemm`).

The dense route (``kernels/torch.py``, ``kernels/cuda.py``) densifies B
(or B^T) and the product C.  :func:`dense_fits` says whether both dense
forms fit :data:`max_dense_bytes`.  A product past the budget goes to
expand-sort-compress (ESC) in the JAX package; ESC is ROADMAP Queue 1
item 6 here, and :func:`esc_mult_ab` / :func:`esc_mult_abt` raise.
"""

from __future__ import annotations

import torch

#: largest dense intermediate, in BYTES, that the dense route may
#: allocate (512 MiB).  The JAX package budgets ELEMENTS
#: (``max_dense_elems = 2**27``), so f64 products there get twice the
#: bytes; here an f64 product gets half the elements of an f32 one.
#: The ``cuda`` backend's densify route keeps to the same budget.
max_dense_bytes = 2**29


def dense_fits(a_nrows: int, b_nrows: int, b_ncols: int, n_out: int,
               dtype: torch.dtype = torch.float32) -> bool:
    """Can the dense route afford dense B (``b_nrows x b_ncols``) and the
    dense product (``a_nrows x n_out``) in ``dtype``?"""
    size = dtype.itemsize
    return (b_nrows * b_ncols * size <= max_dense_bytes
            and a_nrows * n_out * size <= max_dense_bytes)


def _esc(what: str):
    raise NotImplementedError(
        f"{what} past the dense budget ({max_dense_bytes} bytes) needs the"
        " expand-sort-compress (ESC) SpGEMM, which is not ported to"
        " csr_tpu_torch yet (ROADMAP Queue 1 item 6, ESC)"
    )


def esc_mult_ab(a, b, out_dtype=None):
    _esc("A @ B")


def esc_mult_abt(a, b, out_dtype=None):
    _esc("A @ B^T")
