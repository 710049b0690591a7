"""Dense inputs made from the seed, and the caller's own plain steps on
dense results (a norm read back to the host, a division)."""

from __future__ import annotations

import torch

from cardbench import generate
from cardbench.ops import Op


def randn(ctx, rows, cols=None):
    """A standard normal f32 input: a vector, or ``rows x cols``."""
    shape = (rows,) if cols is None else (rows, cols)
    return generate.dense(ctx.seed, ctx.out, shape, ctx.device)


def norm_item(ctx, x):
    """The Euclidean norm of ``x``, read back to the host, as a caller's
    reverse communication reads it."""
    return torch.linalg.vector_norm(x).item()


def divide(ctx, x, by):
    return x / by


OPS = {
    "randn": Op(randn),
    "norm_item": Op(norm_item),
    "divide": Op(divide),
}
