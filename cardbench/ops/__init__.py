"""
The operations a traffic mix is written in, each a call into the
program's public API (or the caller's own plain step, such as reading a
norm back to the host).

Every module of this package defines ``OPS``, a dict from an operation's
name, as a traffic file writes it, to an :class:`Op`.  :func:`registry`
gathers them all, so an operation is added with a module of its own and
no edit here.
"""

from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Op:
    """One operation.

    ``run(ctx, **args)`` computes it.  ``product`` names a public product
    call (``"spmm"``, ``"spmv"``, ``"spgemm"``): its host time is a span of
    the API layer, and its first call on each matrix is set-up's packing.
    ``work(args)`` gives the ``(bytes, flops)`` it must move and do, for
    the kernels' roofline.  ``cycle(args)`` gives the steps of one pass
    over what the operation walks (blocks of rows), which warm-up covers
    once."""

    run: Callable
    product: str | None = None
    work: Callable | None = None
    cycle: Callable | None = None


def registry() -> dict:
    """Every operation of every module of this package, by name."""
    ops = {}
    for info in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        for name, op in getattr(mod, "OPS", {}).items():
            if name in ops:
                raise ValueError(f"operation {name} defined twice")
            ops[name] = op
    return ops
