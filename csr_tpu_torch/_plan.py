"""
Product plans: a steady-state ``mult_vec``, ``mult_vec_t`` or
``mult_dense`` goes from the API to its kernel launch in one look-up.

A :class:`Plan` is what a call's general path found for one method of
one matrix and one kind of operand, kept in the matrix's set of forms
(:mod:`csr_tpu_torch._forms`, key ``("plan", method)``): the kernel
module, the operand's key (:func:`operand_key`), the launch itself with
the matrix's side of its arguments bound (``run``), and the trace events
the general path emits.  The set's stamp is the plan's freshness, and
the set keeps alive the forms its launch reads.  The ``cuda`` backend
makes one where its route is a single launch on a cached form (the
micro-block SpMV or SpMM on one layout, the CSR-form SpMV either way or
SpMM) and puts it on the handle; the API keeps it once the call returns.
On the CPU the launch is the kernel wrapper on the cached form, which
runs its plain version.

:func:`run` takes the plan where every condition of the general path
that it skips still holds: the active kernel module is the plan's, the
matrix is not split into row shards, the set's stamp stands (so an
in-place edit or a rebinding invalidates the plan with the forms), the
kernel's route settings (its crossovers and budgets, which a caller may
set) are those it was made under, the operand's key matches, no
``torch.func`` transform is active and the grad rule passes.  Otherwise
the general path runs as it would without plans, and raises where it
raises.  A plan holds no operand or result and no device memory of its
own; a new one replaces the old by one item write, so two threads at
worst build the same plan twice.

While tracing records, each look-up counts ``plan.hit`` or
``plan.miss.<reason>`` (``key``: no plan for the method, another
kernel, a matrix now past ``max_nnz`` or another operand; ``stale``: the
stamp or the route settings moved; ``grad``; ``transform``), and each
plan kept ``plan.build``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _forms, tracing
from .tracing import _listeners, count, trace


class Plan(NamedTuple):
    """A product's launch for one method, matrix state and operand key."""

    kernel: object  # the kernel module (set when the API keeps the plan)
    settings: tuple  # the kernel's route_settings() when it was made
    key: tuple  # operand_key of the operands it serves
    run: Callable  # operand -> result
    events: tuple  # ((event, fields), ...) in the general path's order


#: the active ``torch.func`` transform's level, None outside one
_transform_level = torch._C._functorch.maybe_current_level


def operand_key(v: torch.Tensor) -> tuple:
    """What fixes a product's launch besides the matrix: the operand's
    dtype, device (its index, -1 on the CPU), shape, strides and
    alignment within 16 bytes."""
    return (v.dtype, v.get_device(), v.shape, v.stride(), v.data_ptr() % 16)


def make(operand: torch.Tensor, settings: tuple, run: Callable,
         events: tuple) -> Plan:
    """The plan of a call whose operand was ``operand``, under the
    kernel's route ``settings``."""
    return Plan(None, settings, operand_key(operand), run, events)


def run(csr, kernel, key: tuple, v):
    """The product ``key`` (``("plan", method)``) of ``csr`` by its plan,
    on ``kernel``; None where the plan does not apply (see the module
    docstring)."""
    f = csr._forms
    plan = None if f is None else f.get(key)
    if _transform_level() is not None:
        reason = "transform"
    elif (plan is None or plan.kernel is not kernel or csr.nnz > kernel.max_nnz
          or not isinstance(v, torch.Tensor) or operand_key(v) != plan.key):
        reason = "key"
    elif not f.fresh(csr) or kernel.route_settings() != plan.settings:
        reason = "stale"
    elif torch.is_grad_enabled() and (
            v.requires_grad or (f.values is not None and f.values.requires_grad)):
        reason = "grad"
    else:
        count("plan.hit")
        if not (_listeners or tracing._TRACE):
            return plan.run(v)
        *before, after = plan.events
        for event, fields in before:
            trace(event, **fields)
        out = plan.run(v)
        trace(after[0], **after[1])
        return out
    count("plan.miss." + reason)
    if f is not None:
        _forms.forms(csr)  # a stale set goes now, its plans and forms with it
    return None


def keep(csr, kernel, key: tuple, handle) -> None:
    """Keep in ``csr``'s set, as ``key``, the plan its general path put
    on ``handle``, if any, for ``kernel``."""
    plan = getattr(handle, "plan", None)
    if plan is not None:
        _forms.forms(csr)[key] = plan._replace(kernel=kernel)
        count("plan.build")
