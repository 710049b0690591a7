"""
Timing on the card (counterpart of :func:`csr_tpu.utils.profiling.timed_chained`).

:func:`timed_chained` times chained iterations with CUDA events.
:func:`peak_gbps` gives a card's published memory bandwidth from its
device name, :func:`peak_f32_tflops` its f32 rate outside the tensor
cores, and :func:`least_ms` the least time the card could take for given
bytes and operations.  A measurement needs a CUDA device: there is no
CPU timing here, so no CPU number can pass for a device one.
"""

from __future__ import annotations

import torch

#: published peaks by device-name substring, first match wins: HBM
#: bandwidth (GB/s) and the f32 rate outside the tensor cores (TFLOP/s)
#: (NVIDIA data sheets; SXM parts unless the name says otherwise)
_PEAKS = (
    ("H200", 4800.0, 67.0),
    ("H100 NVL", 3900.0, 60.0),
    ("H100 PCIe", 2000.0, 51.0),
    ("H100", 3350.0, 67.0),
)


def _peaks(name: str | None):
    if name is None:
        name = torch.cuda.get_device_name()
    for key, gbps, tflops in _PEAKS:
        if key in name:
            return gbps, tflops
    return None, None


def peak_gbps(name: str | None = None) -> float | None:
    """Published memory bandwidth of a card, from its name (default: the
    current CUDA device's), or None for a card not in the table."""
    return _peaks(name)[0]


def peak_f32_tflops(name: str | None = None) -> float | None:
    """Published f32 rate of a card outside its tensor cores, from its
    name (default: the current CUDA device's), or None for a card not in
    the table."""
    return _peaks(name)[1]


def least_ms(bytes_moved: float, flops: float, name: str | None = None):
    """The least time (ms) the card could take for work that must move
    ``bytes_moved`` bytes through device memory and do ``flops`` f32
    operations, whatever implements it: the larger of bytes over the
    published bandwidth and operations over the published f32 rate, and
    which of the two binds (``"bytes"`` or ``"operations"``).  Raises for
    a card not in the table."""
    gbps, tflops = _peaks(name)
    if gbps is None:
        raise ValueError(
            f"no published peaks for {name or torch.cuda.get_device_name()}")
    t_bytes = bytes_moved / (gbps * 1e9) * 1e3
    t_ops = flops / (tflops * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_chained(step, x0: torch.Tensor, iters: int = 300, reps: int = 3) -> float:
    """Seconds per iteration of ``x -> step(x)``, chained ``iters`` times
    from ``x0`` between two CUDA events; the best of ``reps`` runs after
    one warm-up step.  Each iteration takes the previous one's output, so
    none can be skipped or overlapped with the next."""
    if x0.device.type != "cuda":
        raise ValueError(f"timed_chained times CUDA work; x0 is on {x0.device}")
    step(x0)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        x = x0
        start.record()
        for _ in range(iters):
            x = step(x)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / iters)
    return best
