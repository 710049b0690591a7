"""
The comparison that decides ``correct``: each output of a checked step
against the plain reference's, as the largest gap of an element over
that element's error scale (:mod:`cardbench.reference`), so a gap reads
in units of the precision that made it: float32 rounding reads about
1e-7, a TF32 operand about 5e-4.

A sparse output is compared in its dense form, where an entry it lacks
is zero; beside its gap it is held to a count of bad entries (limit 0):
entries stored twice and, where the reference says the output keeps only
entries above zero, entries at or below zero.
"""

from __future__ import annotations

import math

import torch

from cardbench.reference import Ref

#: the absolute part of an element's error scale: float32 flushes what
#: lies below its least normal number (2^-126), which is 2^-102 in units
#: of its unit roundoff (2^-24); a value the power iteration has decayed
#: to 1e-47 in float64 reads 0 in float32
FLOOR = 2.0 ** -102


def _dense_gap(got: torch.Tensor, ref: Ref) -> float:
    if tuple(got.shape) != tuple(ref.value.shape):
        return math.inf
    if got.numel() == 0:
        return 0.0
    diff = (got.to(torch.float64) - ref.value.to(torch.float64)).abs()
    ratio = diff / (ref.scale.to(torch.float64) + FLOOR)
    return float(torch.nan_to_num(ratio, nan=math.inf).max())


def _densify(got) -> tuple:
    """The dense float64 form of a CSR-like result, and its count of bad
    entries other than sign (coordinates stored twice)."""
    rowptrs = got.rowptrs.long()
    nnz = int(got.colinds.shape[0])
    rows = torch.repeat_interleave(torch.arange(got.nrows, device=rowptrs.device),
                                   torch.diff(rowptrs), output_size=nnz)
    cols = got.colinds.long()
    dense = torch.zeros(got.nrows, got.ncols, dtype=torch.float64, device=rowptrs.device)
    dense.index_put_((rows, cols), got.values.to(torch.float64), accumulate=True)
    twice = nnz - int(torch.unique(rows * got.ncols + cols).numel())
    return dense, twice


def compare(got, ref: Ref) -> dict:
    """``{"": gap}`` for a dense or scalar output; ``{"": gap, ".bad":
    count}`` for a sparse one.  ``got`` is the program's output (a
    tensor, a number or a CSR), or a control's (a :class:`Ref`)."""
    if isinstance(got, Ref):
        got = got.value
    if isinstance(got, (int, float)):
        got = torch.tensor(float(got), dtype=torch.float64, device=ref.value.device)
    if isinstance(got, torch.Tensor):
        out = {"": _dense_gap(got, ref)}
        if ref.positive:
            out[".bad"] = int((got < 0).sum())
        return out
    if (got.nrows, got.ncols) != tuple(ref.value.shape):
        return {"": math.inf, ".bad": math.inf}
    dense, twice = _densify(got)
    bad = twice
    if ref.positive:
        bad += int((~(got.values > 0)).sum())
    return {"": _dense_gap(dense, ref), ".bad": bad}


def as_ref(x) -> Ref:
    """A program's value taken as an input of the reference (state it
    carries from step to step): its magnitude is its error scale."""
    if isinstance(x, torch.Tensor):
        v = x.to(torch.float64)
        return Ref(v, v.abs())
    v = torch.tensor(float(x), dtype=torch.float64)
    return Ref(v, v.abs())
