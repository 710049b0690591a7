"""
Timing on the card (counterpart of :func:`csr_tpu.utils.profiling.timed_chained`).

:func:`timed_chained` times chained iterations with CUDA events.
:func:`peak_gbps` gives a card's published memory bandwidth from its
device name.  A measurement needs a CUDA device: there is no CPU timing
here, so no CPU number can pass for a device one.
"""

from __future__ import annotations

import torch

#: published HBM bandwidth (GB/s) by device-name substring, first match
#: wins (NVIDIA data sheets; SXM parts unless the name says otherwise)
_PEAK_GBPS = (
    ("H200", 4800.0),
    ("H100 NVL", 3900.0),
    ("H100 PCIe", 2000.0),
    ("H100", 3350.0),
)


def peak_gbps(name: str | None = None) -> float | None:
    """Published memory bandwidth of a card, from its name (default: the
    current CUDA device's), or None for a card not in the table."""
    if name is None:
        name = torch.cuda.get_device_name()
    for key, gbps in _PEAK_GBPS:
        if key in name:
            return gbps
    return None


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
