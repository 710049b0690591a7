"""
Pluggable kernel backends (counterpart of :mod:`csr_tpu.kernels`).

A kernel provides the compute behind :class:`csr_tpu_torch.CSR` through
the contract ``to_handle, from_handle, release_handle, order_columns,
mult_vec, mult_vec_t, mult_dense, mult_ab, mult_abt, max_nnz``.

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
``torch.cuda.is_available()``, else ``torch``.  The JAX package's and the
original library's names are aliases: ``xla``/``numba`` for ``torch``,
``pallas``/``mkl`` for ``cuda``.
"""

from __future__ import annotations

import logging
import os
import threading
import warnings
from contextlib import contextmanager
from importlib import import_module

# imported under another name: the submodule ``kernels.torch`` becomes the
# package attribute ``torch`` once it is loaded
import torch as _torch

kernels = {}
__all__ = ["releasing", "set_kernel", "use_kernel", "get_kernel", "trace"]

# Handle-lifecycle tracing, enabled by the CSR_TPU_TRACE environment
# variable; kernels call ``trace()`` on handle creation and release and on
# layout builds.
_TRACE = bool(os.environ.get("CSR_TPU_TRACE"))
_trace_log = logging.getLogger("csr_tpu_torch.trace")
if _TRACE and not _trace_log.handlers:  # pragma: no cover - env-dependent
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("csr-tpu-torch-trace: %(message)s"))
    _trace_log.addHandler(_h)
    _trace_log.setLevel(logging.INFO)

#: registered trace listeners (callables ``f(event, fields)``), always
#: dispatched, whether or not CSR_TPU_TRACE is set
_listeners: list = []


def trace(event: str, **fields):
    """Log a handle-lifecycle event when ``CSR_TPU_TRACE`` is set, and
    dispatch it to the registered listeners."""
    for listener in _listeners:
        listener(event, fields)
    if _TRACE:
        _trace_log.info(
            "%s %s", event, " ".join(f"{k}={v}" for k, v in fields.items())
        )


class ActiveKernel(threading.local):
    """Thread-local active kernel."""

    def __init__(self):
        self.__dict__.update({"active_name": None})

    @property
    def active(self):
        kern = getattr(self, "_active", None)
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
        name = "cuda" if _torch.cuda.is_available() else "torch"
    __cached_default = get_kernel(name)


def _default_kernel():
    if not __cached_default:
        _initialize()
    return __cached_default
