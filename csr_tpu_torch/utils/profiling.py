"""
Timing on the card (counterpart of :mod:`csr_tpu.utils.profiling`).

:func:`timed_chained` times chained iterations with CUDA events,
:func:`timed_graph` the same chain captured once in a CUDA graph and
replayed, and :func:`timed` single calls.  :func:`launch_counts` reads
the five kernel wrappers' launch counts.  :func:`peak_gbps` gives a card's published
memory bandwidth from its device name, and :func:`least_ms` the least
time the card could take for given bytes and operations.  A measurement
needs a CUDA device: there is no CPU timing here, so no CPU number can
pass for a device one.  The program's own spans and counters, and a
``torch.profiler`` range of each span, are :mod:`csr_tpu_torch.tracing`'s.
"""

from __future__ import annotations

import statistics
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


def launch_counts(reset: bool = False) -> dict:
    """The launch counts of the five kernel wrappers (``ops/spmv.py``'s
    ``spmv``, ``spmv_bucket`` and ``spmv_csr``, ``ops/spmm.py``'s
    ``spmm`` and ``spmm_csr``), set to 0 first with ``reset``."""
    from csr_tpu_torch.ops import spmm as spmm_op, spmv as spmv_op

    if reset:
        spmv_op.launches = spmm_op.launches = spmv_op.bucket_launches = 0
        spmv_op.csr_launches = spmm_op.csr_launches = 0
    return {"spmv_microblock": spmv_op.launches,
            "spmm_microblock": spmm_op.launches,
            "spmv_bucket": spmv_op.bucket_launches,
            "spmv_csr": spmv_op.csr_launches,
            "spmm_csr": spmm_op.csr_launches}


def timed_graph(step, x0: torch.Tensor, iters: int = 300, reps: int = 3):
    """Seconds per iteration of ``x -> step(x)`` chained ``iters`` times
    from ``x0``, captured once in a ``torch.cuda.CUDAGraph`` and replayed:
    one dispatch for all iterations, the counterpart of the JAX package's
    jitted ``fori_loop``.  Each replay is timed between two CUDA events;
    the best of ``reps``.  Returns ``(seconds, y, captured)``: ``y`` the
    chain's output, which every replay rewrites, and ``captured`` the
    kernel launches the graph holds (:func:`launch_counts`' keys), which
    each of the ``reps`` replays runs again.

    One step runs on a side stream before the capture, so that layouts,
    kernel builds and cached device queries exist by then.  The capture
    runs the Python of every step once: launch counters and trace events
    count the captured launches, and a replay adds to neither, so the
    launches that replays ran are ``reps`` times ``captured``, which the
    counters never see.  A step that reads the device from the host
    breaks the capture, which raises."""
    if x0.device.type != "cuda":
        raise ValueError(f"timed_graph times CUDA work; x0 is on {x0.device}")
    x_in = x0.clone()
    side = torch.cuda.Stream(x0.device)
    side.wait_stream(torch.cuda.current_stream(x0.device))
    with torch.cuda.stream(side):
        step(x_in)
    torch.cuda.current_stream(x0.device).wait_stream(side)
    torch.cuda.synchronize(x0.device)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        y = x_in
        for _ in range(iters):
            y = step(y)
    captured = {k: n - before[k] for k, n in launch_counts().items()}
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / iters)
    return best, y, captured


def _needs_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise ValueError(f"{what} times CUDA work; there is no CUDA device")


def timed(fn, *args, iters: int = 10) -> float:
    """Median seconds of one call of ``fn(*args)`` between two CUDA events,
    over ``iters`` calls after one warm-up call."""
    _needs_card("timed")
    fn(*args)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)
