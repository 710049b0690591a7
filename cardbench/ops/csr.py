"""Operations on the program's CSR matrices, each one call of
``csr_tpu_torch``'s public API (the package is imported when an
operation first runs, never at import)."""

from __future__ import annotations

import torch

from cardbench import roofline
from cardbench.ops import Op
from cardbench.program import block_begin


def from_coo(ctx, triples):
    """The rating matrix from the generated triples, as lenskit builds it
    (``CSR.from_coo``, which converts on the host)."""
    from csr_tpu_torch import CSR

    return CSR.from_coo(triples["rows"], triples["cols"], triples["vals"],
                        shape=triples["shape"], device=ctx.device)


def transpose(ctx, a):
    return a.transpose()


def normalize_rows(ctx, a, how):
    """``a.normalize_rows(how)``, in place; the matrix is the result."""
    a.normalize_rows(how)
    return a


def subset_rows(ctx, a, block):
    begin = block_begin(ctx, a.nrows, block)
    return a.subset_rows(begin, min(begin + block, a.nrows))


def multiply(ctx, a, b, transpose=False):
    return a.multiply(b, transpose=transpose)


def filter_positive(ctx, a):
    """The entries of ``a`` above zero, as an item-item fit keeps its
    positive similarities."""
    return a.filter_nnzs(a.values > 0)


def mult_dense(ctx, a, b):
    return a.mult_dense(b)


def mult_vec(ctx, a, x):
    return a.mult_vec(x)


def mult_vec_t(ctx, a, x):
    return a.mult_vec_t(x)


def _used(index: torch.Tensor, size: int) -> int:
    """How many of ``size`` indices occur in ``index``."""
    return int((torch.bincount(index.long(), minlength=size) > 0).sum())


def _work(a, width: int, transpose: bool) -> tuple:
    ptr = a.rowptrs.element_size()
    if transpose:  # A^T v reads the entries of v whose rows hold entries
        used = int((torch.diff(a.rowptrs) > 0).sum())
        return roofline.product_work(a.nnz, a.nrows, ptr, used, width, a.ncols)
    return roofline.product_work(a.nnz, a.nrows, ptr, _used(a.colinds, a.ncols),
                                 width, a.nrows)


OPS = {
    "from_coo": Op(from_coo),
    "transpose": Op(transpose),
    "normalize_rows": Op(normalize_rows),
    "subset_rows": Op(subset_rows,
                      cycle=lambda args: -(-args["a"].nrows // args["block"])),
    "multiply": Op(multiply, product="spgemm"),
    "filter_positive": Op(filter_positive),
    "mult_dense": Op(mult_dense, product="spmm",
                     work=lambda args: _work(args["a"], args["b"].shape[1], False)),
    "mult_vec": Op(mult_vec, product="spmv",
                   work=lambda args: _work(args["a"], 1, False)),
    "mult_vec_t": Op(mult_vec_t, product="spmv",
                     work=lambda args: _work(args["a"], 1, True)),
}
