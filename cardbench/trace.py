"""
The traced run's reading of the profiler: device time by the
benchmark's spans, the device's busy share, and the breakdown.

The window is recorded with ``torch.profiler`` (the host and the card),
each step inside a ``cb.step`` range and each operation inside a
``cb.op:<out>=<operation>`` range.  Every kernel, copy and fill that
ran on the card is tied to the operation whose range it was launched
in: by its launch call on the host (the profiler's correlation id), or,
where the launch was not recorded, by the host operation it is linked
to.  The raw kineto events are read directly, so a window of some
hundred thousand events costs seconds, not minutes.
"""

from __future__ import annotations

import bisect

from torch.autograd import DeviceType

STEP = "cb.step"
OP = "cb.op:"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


def _fields(e) -> tuple:
    """``(kind, name, start ns, end ns)`` of a kineto event, its kind told
    from the device and the name (the events of PyTorch 2.11 do not say
    it): on the card a copy, a fill, a range of the benchmark's or a
    kernel; on the host a range of the benchmark's, a CUDA runtime or
    driver call, or an operator."""
    name = e.name()
    start = e.start_ns()
    end = start + e.duration_ns()
    if e.device_type() != DeviceType.CPU:
        if name.startswith("cb."):
            kind = "gpu_user_annotation"
        elif name.startswith("Memcpy"):
            kind = "gpu_memcpy"
        elif name.startswith("Memset"):
            kind = "gpu_memset"
        else:
            kind = "kernel"
    elif name.startswith("cb."):
        kind = "user_annotation"
    elif name.startswith("cuda") or (name[:2] == "cu" and name[2:3].isupper()):
        kind = "cuda_runtime"
    else:
        kind = "cpu_op"
    return kind, name, start, end


def op_label(out: str, name: str) -> str:
    return f"{OP}{out}={name}"


def _merge(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def read(events, labels: dict) -> dict | None:
    """The profiled window's numbers from kineto ``events``; ``labels``
    maps an operation range's name to ``(product kind or None, least ms
    of one call or None)``.  None when no step was recorded.

    Beside the window (``steps``, ``window_ns``, ``busy_ns``) and the
    products' roofline sums (``products``), it gives every device
    operation in the window by name, ``device[name] = [kind, count,
    ns]``, and every range of the benchmark's on the host,
    ``host[name] = [count, ns]``, for the metric readers to filter."""
    steps, ops, device = [], [], []
    launch_at, op_at = {}, {}
    kinds = set()
    for e in events:
        kind, name, start, end = _fields(e)
        kinds.add(kind)
        if kind in DEVICE_KINDS:
            device.append((start, end, name, kind, e.correlation_id(),
                           e.linked_correlation_id()))
        elif kind in LAUNCH_KINDS:
            launch_at[e.correlation_id()] = start
        elif kind != "gpu_user_annotation":
            op_at[e.correlation_id()] = start
            if kind == "user_annotation":
                if name == STEP:
                    steps.append((start, end))
                elif name.startswith(OP):
                    ops.append((start, end, name))
    if not steps:
        return None
    steps.sort()
    ops.sort()
    w0, w1 = steps[0][0], max(e for _, e in steps)
    starts = [s for s, _, _ in ops]

    def op_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return ops[i][2] if i >= 0 and t < ops[i][1] else None

    by_op, by_name, busy, unplaced = {}, {}, [], 0
    for s, e, name, kind, corr, linked in device:
        if e <= w0 or s >= w1:
            continue
        busy.append((max(s, w0), min(e, w1)))
        dur = e - s
        entry = by_name.setdefault(name, [kind, 0, 0])
        entry[1] += 1
        entry[2] += dur
        t = launch_at.get(corr, op_at.get(linked))
        label = None if t is None else op_of(t)
        if label is None:
            unplaced += 1
        else:
            by_op[label] = by_op.get(label, 0) + dur
    merged = _merge(busy)
    busy_ns = sum(e - s for s, e in merged)

    # the device's idle gaps, by what the host was doing when each began
    step_starts = [s for s, _ in steps]
    gaps = {}
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        label = op_of(g0)
        if label is not None:
            label = label[len(OP):] + " (host)"
        else:
            i = bisect.bisect_right(step_starts, g0) - 1
            inside = i >= 0 and g0 < steps[i][1]
            label = "step, outside the calls (sync, loop)" if inside else "between steps"
        gaps[label] = gaps.get(label, 0) + (g1 - g0)

    host = {}
    for s, e, name in ops + [(s, e, STEP) for s, e in steps]:
        if s < w0 or e > w1:
            continue
        entry = host.setdefault(name, [0, 0])
        entry[0] += 1
        entry[1] += e - s
    products = {}
    n_calls = {name: n for name, (n, _) in host.items()}
    for name, (kind, least) in labels.items():
        if kind is None or least is None or name not in n_calls:
            continue
        k = products.setdefault(kind, {"least_ms": 0.0, "device_ns": 0, "calls": 0})
        k["least_ms"] += least * n_calls[name]
        k["device_ns"] += by_op.get(name, 0)
        k["calls"] += n_calls[name]

    def top(d):
        return [[k[:160], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"steps": len(steps), "window_ns": w1 - w0, "busy_ns": busy_ns,
            "device": by_name, "host": host, "products": products,
            "device_events": len(device), "unplaced": unplaced,
            "activity_kinds": sorted(kinds),
            "breakdown": {"device_ops": top({k: v[2] for k, v in by_name.items()}),
                          "idle_gaps": top(gaps)}}
