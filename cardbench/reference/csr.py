"""The CSR operations of a traffic, in plain PyTorch: a matrix built by
sorting its own keys, products by gathering and adding in blocks of
entries, in float64 (float32 with TF32 operands for the control)."""

from __future__ import annotations

import torch

from cardbench.program import block_begin
from cardbench.reference import RMat, Ref, dtype, operand

#: product terms a block of a reference product holds at once
TERMS = 1 << 25


def from_coo(ctx, triples) -> RMat:
    """The matrix of the triples, repeated (row, column) pairs summed."""
    nrows, ncols = triples["shape"]
    key = triples["rows"].long() * ncols + triples["cols"].long()
    key, perm = torch.sort(key)
    vals = triples["vals"][perm].to(dtype(ctx))
    ukey, inv = torch.unique_consecutive(key, return_inverse=True)
    values = torch.zeros(ukey.numel(), dtype=vals.dtype, device=vals.device)
    values.index_add_(0, inv, vals)
    err = torch.zeros_like(values).index_add_(0, inv, vals.abs())
    rows = torch.div(ukey, ncols, rounding_mode="floor")
    rowptrs = torch.searchsorted(rows, torch.arange(nrows + 1, device=rows.device))
    return RMat(nrows, ncols, rowptrs, ukey % ncols, values, err)


def transpose_rmat(ctx, a: RMat) -> RMat:
    key, perm = torch.sort(a.colinds * a.nrows + a.row_ids())
    cols = torch.div(key, a.nrows, rounding_mode="floor")
    rowptrs = torch.searchsorted(cols, torch.arange(a.ncols + 1, device=cols.device))
    return RMat(a.ncols, a.nrows, rowptrs, key % a.nrows, a.values[perm], a.err[perm])


def _row_sum(a: RMat, v: torch.Tensor, rid: torch.Tensor) -> torch.Tensor:
    return torch.zeros(a.nrows, dtype=v.dtype, device=v.device).index_add_(0, rid, v)


def normalize_rows(ctx, a: RMat, how: str) -> RMat:
    """Rows centred on their mean, or scaled to unit length (an empty or
    all-zero row stays zero).  A centred value's error scale takes in the
    mean's magnitude: the subtraction rounds at the size of its operands,
    not of its result."""
    rid = a.row_ids()
    if how == "center":
        count = torch.diff(a.rowptrs).to(a.values.dtype).clamp_min(1)
        mean = _row_sum(a, a.values, rid) / count
        err = a.err + (_row_sum(a, a.err, rid) / count)[rid]
        values = a.values - mean[rid]
    elif how == "unit":
        norm = torch.sqrt(_row_sum(a, a.values * a.values, rid))[rid]
        live = norm > 0
        values = torch.where(live, a.values / norm.clamp_min(1e-300), 0)
        err = torch.where(live, a.err / norm.clamp_min(1e-300), 0)
    else:
        raise ValueError(f"unknown normalization {how}")
    return RMat(a.nrows, a.ncols, a.rowptrs, a.colinds, values, err)


def subset_rows(ctx, a: RMat, block: int) -> RMat:
    b = block_begin(ctx, a.nrows, block)
    e = min(b + block, a.nrows)
    s0, s1 = int(a.rowptrs[b]), int(a.rowptrs[e])
    return RMat(e - b, a.ncols, a.rowptrs[b : e + 1] - s0, a.colinds[s0:s1],
                a.values[s0:s1], a.err[s0:s1])


def _blocks(cost: torch.Tensor, budget: int) -> list:
    """Edges of runs of entries whose ``cost`` sums to about ``budget``
    (an entry past it alone)."""
    cum = torch.cumsum(cost.long(), 0)
    if cum.numel() == 0:
        return [0]
    marks = torch.arange(budget, max(int(cum[-1]), budget), budget, device=cum.device)
    edges = torch.searchsorted(cum, marks, right=True).tolist()
    return sorted({0, cost.numel(), *edges})


def multiply(ctx, a: RMat, b: RMat, transpose: bool = False) -> Ref:
    """``A @ B`` (``A @ B^T``), dense: every product term gathered and
    added into its output entry."""
    if transpose:
        key = ("transpose", id(b))
        if key not in ctx.cache:
            ctx.cache[key] = transpose_rmat(ctx, b)
        b = ctx.cache[key]
    dt = dtype(ctx)
    dev = a.values.device
    out = torch.zeros(a.nrows * b.ncols, dtype=dt, device=dev)
    scale = torch.zeros_like(out)
    deg = torch.diff(b.rowptrs)
    terms = deg[a.colinds]
    rid = a.row_ids()
    av, bv = operand(ctx, a.values), operand(ctx, b.values)
    edges = _blocks(terms, TERMS)
    for e0, e1 in zip(edges, edges[1:]):
        counts = terms[e0:e1]
        n = int(counts.sum())
        e = torch.repeat_interleave(torch.arange(e1 - e0, device=dev), counts,
                                    output_size=n)
        first = torch.cumsum(counts, 0) - counts
        src = b.rowptrs[a.colinds[e0:e1]][e] + torch.arange(n, device=dev) - first[e]
        flat = rid[e0:e1][e] * b.ncols + b.colinds[src]
        out.index_add_(0, flat, (av[e0:e1][e] * bv[src]).to(dt))
        scale.index_add_(0, flat, (a.err[e0:e1][e] * b.err[src]).to(dt))
    shape = (a.nrows, b.ncols)
    return Ref(out.view(shape), scale.view(shape))


def filter_positive(ctx, a: Ref) -> Ref:
    return Ref(a.value.clamp_min(0), a.scale, positive=True)


def _times_dense(ctx, a: RMat, b: Ref, transpose: bool) -> Ref:
    """``A @ B`` (``A^T @ B``) for dense ``B`` of one or more columns."""
    dt = dtype(ctx)
    bval, bsc = b.value.reshape(b.value.shape[0], -1), b.scale.reshape(b.value.shape[0], -1)
    width = bval.shape[1]
    n_out = a.ncols if transpose else a.nrows
    out = torch.zeros(n_out, width, dtype=dt, device=bval.device)
    scale = torch.zeros_like(out)
    rid = a.row_ids()
    src_idx, dst_idx = (rid, a.colinds) if transpose else (a.colinds, rid)
    av, bo = operand(ctx, a.values), operand(ctx, bval)
    step = max(1, (1 << 27) // width)
    for e0 in range(0, a.nnz, step):
        sl = slice(e0, e0 + step)
        src, dst = src_idx[sl], dst_idx[sl]
        out.index_add_(0, dst, (av[sl, None] * bo[src]).to(dt))
        scale.index_add_(0, dst, (a.err[sl, None] * bsc[src]).to(dt))
    if b.value.ndim == 1:
        return Ref(out[:, 0], scale[:, 0])
    return Ref(out, scale)


def mult_dense(ctx, a: RMat, b: Ref) -> Ref:
    return _times_dense(ctx, a, b, False)


def mult_vec(ctx, a: RMat, x: Ref) -> Ref:
    return _times_dense(ctx, a, x, False)


def mult_vec_t(ctx, a: RMat, x: Ref) -> Ref:
    return _times_dense(ctx, a, x, True)


OPS = {
    "from_coo": from_coo,
    "transpose": transpose_rmat,
    "normalize_rows": normalize_rows,
    "subset_rows": subset_rows,
    "multiply": multiply,
    "filter_positive": filter_positive,
    "mult_dense": mult_dense,
    "mult_vec": mult_vec,
    "mult_vec_t": mult_vec_t,
}
