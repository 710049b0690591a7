"""
The plain reference: every operation a traffic file names, in plain
PyTorch, from the same generated triples and inputs, with nothing taken
from the program (this package imports none of it).

Each result carries, beside its values, a bound of the size of the
rounding errors an honest computation of it makes, relative to the unit
roundoff (:attr:`Ref.scale`, :attr:`RMat.err`): for a product the sum of
the magnitudes of its terms, for a centred value the magnitudes it was
taken from.  The comparison divides the program's gap by it, so a gap
reads in units of the precision that made it.

The reference computes in float64.  With ``ctx.precision ==
"tfloat32"`` it is the control: float32, with every operand of a product
rounded to TF32 first, as a matrix unit with TF32 allowed computes.

Every module of this package defines ``OPS``, operation name to a
function ``fn(ctx, **args)``; :func:`registry` gathers them.
"""

from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass

import torch


@dataclass
class Ref:
    """A dense result (or a 0-d one) and its error scale.  ``positive``
    marks a sparse result whose program form must hold only entries
    above zero."""

    value: torch.Tensor
    scale: torch.Tensor
    positive: bool = False


@dataclass
class RMat:
    """A CSR matrix of the reference: int64 row pointers and columns,
    values and their error scales in the reference's dtype."""

    nrows: int
    ncols: int
    rowptrs: torch.Tensor
    colinds: torch.Tensor
    values: torch.Tensor
    err: torch.Tensor

    @property
    def nnz(self) -> int:
        return int(self.colinds.shape[0])

    def row_ids(self) -> torch.Tensor:
        return torch.repeat_interleave(
            torch.arange(self.nrows, device=self.rowptrs.device),
            torch.diff(self.rowptrs), output_size=self.nnz)


def dtype(ctx) -> torch.dtype:
    return torch.float64 if ctx.precision == "float64" else torch.float32


def operand(ctx, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a product's operand: as it is in float64, rounded to TF32
    (10 bits of mantissa, to nearest even) for the control."""
    if ctx.precision == "float64":
        return t.to(torch.float64)
    if ctx.precision != "tfloat32":
        raise ValueError(f"unknown precision {ctx.precision}")
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def registry() -> dict:
    ops = {}
    for info in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        for name, fn in getattr(mod, "OPS", {}).items():
            if name in ops:
                raise ValueError(f"reference operation {name} defined twice")
            ops[name] = fn
    return ops
