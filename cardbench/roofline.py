"""
The yardstick of the kernels' rooflines: published peaks by card name,
the least time a piece of work could take, and the bytes and operations
that a sparse product must move and do whatever implements it.

The peaks and :func:`least_ms` are a frozen copy of
``csr_tpu_torch/utils/profiling.py``'s ``_PEAKS``, ``peak_gbps`` and
``least_ms``; the byte count is the SpMM bound of ``chip_smoke.py``
("8 B an entry, the row pointers, B's gathered rows and C once"), with
the rows of B that the columns use counted once.  Nothing here imports
the program: a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

#: published peaks by device-name substring, first match wins: HBM
#: bandwidth (GB/s) and the f32 rate outside the tensor cores (TFLOP/s)
#: (NVIDIA data sheets; SXM parts unless the name says otherwise)
PEAKS = (
    ("H200", 4800.0, 67.0),
    ("H100 NVL", 3900.0, 60.0),
    ("H100 PCIe", 2000.0, 51.0),
    ("H100", 3350.0, 67.0),
)


def peaks(name: str):
    """``(GB/s, TFLOP/s)`` of the card called ``name``; raises for a card
    not in :data:`PEAKS`."""
    for key, gbps, tflops in PEAKS:
        if key in name:
            return gbps, tflops
    raise ValueError(f"no published peaks for {name}")


def least_ms(bytes_moved: float, flops: float, name: str) -> float:
    """The least time (ms) the card ``name`` could take for work that must
    move ``bytes_moved`` bytes through device memory and do ``flops`` f32
    operations: the larger of bytes over the published bandwidth and
    operations over the published f32 rate."""
    gbps, tflops = peaks(name)
    return max(bytes_moved / (gbps * 1e9), flops / (tflops * 1e12)) * 1e3


def product_work(nnz: int, nrows: int, ptr_bytes: int, used: int, width: int,
                 out_rows: int) -> tuple:
    """``(bytes, flops)`` of a sparse-times-dense product (SpMV where
    ``width`` is 1): each stored entry's column index and value (8 B),
    the ``nrows + 1`` row pointers of ``ptr_bytes`` each, the ``used``
    rows of the dense operand that some stored entry reads (each row once,
    ``width`` f32), and the ``out_rows`` rows of the result written once;
    two operations an entry and column."""
    nbytes = 8 * nnz + ptr_bytes * (nrows + 1) + 4 * width * (used + out_rows)
    return nbytes, 2 * nnz * width
