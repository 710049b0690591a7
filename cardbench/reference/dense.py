"""Dense inputs and the caller's plain steps, in the reference."""

from __future__ import annotations

import torch

from cardbench import generate
from cardbench.reference import Ref, dtype


def randn(ctx, rows, cols=None) -> Ref:
    """The same input the program was handed, made again from the seed."""
    shape = (rows,) if cols is None else (rows, cols)
    v = generate.dense(ctx.seed, ctx.out, shape, ctx.device).to(dtype(ctx))
    return Ref(v, v.abs())


def norm_item(ctx, x: Ref) -> Ref:
    """The norm; its error is at most the norm of the operand's."""
    return Ref(torch.linalg.vector_norm(x.value), torch.linalg.vector_norm(x.scale))


def divide(ctx, x: Ref, by: Ref) -> Ref:
    v = x.value / by.value
    return Ref(v, (x.scale + v.abs() * by.scale) / by.value.abs())


OPS = {"randn": randn, "norm_item": norm_item, "divide": divide}
