"""
csr_tpu_torch — compressed sparse row matrices on PyTorch and CUDA.

The PyTorch port of :mod:`csr_tpu`.  Module names follow the JAX
package so that each counterpart is easy to find; inside, the code is
plain PyTorch: tensors on an explicit ``device``, and hand-written CUDA
kernels for Hopper (``csrc/``) where the JAX package has Pallas kernels.

This package imports neither ``jax`` nor ``csr_tpu``.  The JAX package
is the reference it is tested against (``tests/test_torch_*.py``).
"""

from .csr import CSR  # noqa: F401

__version__ = "0.1.0"

__all__ = ["CSR"]
