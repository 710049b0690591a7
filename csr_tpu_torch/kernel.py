"""
Static default kernel interface (counterpart of :mod:`csr_tpu.kernel`).

Binds the default kernel's entry points when the module is first
imported, for code that wants a fixed binding rather than the active
kernel of :mod:`csr_tpu_torch.kernels`.  Importing it selects the default
kernel (``CSR_KERNEL``, else ``cuda`` on a card, else ``torch``); it
builds nothing.
"""

from csr_tpu_torch.kernels import _default_kernel

_kernel = _default_kernel()

name = _kernel.__name__
to_handle = _kernel.to_handle
from_handle = _kernel.from_handle
release_handle = _kernel.release_handle
order_columns = _kernel.order_columns
mult_ab = _kernel.mult_ab
mult_abt = _kernel.mult_abt
mult_vec = _kernel.mult_vec
mult_vec_t = _kernel.mult_vec_t
mult_dense = _kernel.mult_dense
max_nnz = _kernel.max_nnz
