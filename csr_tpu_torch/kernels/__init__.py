"""
Pluggable kernel backends (counterpart of :mod:`csr_tpu.kernels`).

A kernel provides the compute behind :class:`csr_tpu_torch.CSR` through
the contract ``to_handle, from_handle, release_handle, order_columns,
mult_vec, mult_vec_t, mult_dense, mult_ab, mult_abt, max_nnz``.  A
kernel whose handle can carry a product plan (``handle.plan``, the
``cuda`` kernel's) also gives ``route_settings()``, the settings a plan
is taken under (:mod:`csr_tpu_torch._plan`).

Available kernels:

``torch``
    Plain PyTorch on any device (the role ``xla`` plays in the JAX
    package).
``cuda``
    Hand-written CUDA kernels for Hopper (the role of ``pallas``).  On a
    CPU tensor each kernel wrapper runs its plain PyTorch version.
``scipy``
    SciPy host oracle, for tests and benchmarks only.

Selection: the ``CSR_KERNEL`` environment variable, else ``cuda`` when
:func:`default_device` is a card, else ``torch``.  The JAX package's and the
original library's names are aliases: ``xla``/``numba`` for ``torch``,
``pallas``/``mkl`` for ``cuda``.

Instrumentation is one system, :mod:`csr_tpu_torch.tracing`, whose
``trace`` and ``_listeners`` this module re-exports as they are.  The
kernels emit events through :func:`trace` (a handle made and released,
each product's route, each layout build, ESC's terms and chunks), which
go to every listener and, under ``CSR_TPU_TRACE``, to a log.  Spans mark
each layer of a product call (``csr.api``, ``csr.backend``, ``csr.op``,
``csr.launch``), each form the ``cuda`` backend builds (``csr.build``)
and ESC's host work, and counters count the host's reads of device
tensors and the forms built; both record only after
``tracing.enable()``, when they also count the events, and cost one
flag read a site until then.
"""

from __future__ import annotations

import os
import threading
import warnings
from contextlib import contextmanager
from importlib import import_module

# imported under another name: the submodule ``kernels.torch`` becomes the
# package attribute ``torch`` once it is loaded
import torch as _torch

from csr_tpu_torch.tracing import _listeners, trace  # noqa: F401

kernels = {}
__all__ = ["default_device", "releasing", "set_kernel", "use_kernel",
           "get_kernel", "trace"]


def default_device() -> _torch.device:
    """Where the package works when the caller names no device and hands
    over no tensor: the card when ``torch.cuda.is_available()``, the CPU
    only where there is none.  The constructors of
    :class:`csr_tpu_torch.CSR`, :func:`csr_tpu_torch.parallel.partition.make_mesh`
    and the default kernel all follow it."""
    return _torch.device("cuda" if _torch.cuda.is_available() else "cpu")

class ActiveKernel(threading.local):
    """Thread-local active kernel."""

    def __init__(self):
        self.__dict__.update({"active_name": None, "_active": None})

    @property
    def active(self):
        kern = self._active
        if kern is None:
            return _default_kernel()
        return kern

    def set_active(self, kern, name=None):
        self._active = kern
        self.active_name = name


__cached_default = None
__active = ActiveKernel()


@contextmanager
def releasing(h, k):
    """Context manager that releases a kernel handle on exit."""
    try:
        yield h
    finally:
        k.release_handle(h)


def set_kernel(name):
    """Set the thread's kernel by name, or ``None`` to restore automatic
    selection."""
    if name is None:
        __active.set_active(None, None)
    else:
        __active.set_active(get_kernel(name), name)


@contextmanager
def use_kernel(name):
    """Context manager to run code with a specified (thread-local) kernel."""
    old = __active.active_name
    try:
        set_kernel(name)
        yield
    finally:
        set_kernel(old)


_ALIASES = {
    "numba": "torch",
    "xla": "torch",
    "mkl": "cuda",
    "pallas": "cuda",
}


def get_kernel(name=None):
    """A kernel module by name, or the active one."""
    if name is None:
        return __active.active

    name = _ALIASES.get(name, name)
    kern = kernels.get(name, None)
    if not kern:
        kern = import_module(f"{__name__}.{name}")
        kernels[name] = kern
    return kern


def _initialize(name=None):
    global __cached_default
    if __cached_default:
        warnings.warn("default kernel already initialized")

    if not name:
        name = os.environ.get("CSR_KERNEL")
    if not name:
        name = "cuda" if default_device().type == "cuda" else "torch"
    __cached_default = get_kernel(name)


def _default_kernel():
    if not __cached_default:
        _initialize()
    return __cached_default
