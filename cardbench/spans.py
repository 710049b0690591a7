"""
The program's own spans and counters (``csr_tpu_torch.tracing``) in a
traced run, and the per-layer metrics that read them.

    python3 -m cardbench.spans --workload <name> --seed <n> --seconds <s>

runs a cell's traced run as :func:`cardbench.cell.run_cell` makes it
(set-up, warm-up, the window's two phases, the check of the last step
run) with the program's tracing on through set-up and warm-up, and off
in the window's two phases; after them come two phases with it on.
First :data:`SPAN_SECONDS` of steps unprofiled, of three kinds in turn:
tracing on (the readers take these steps' spans and counters), off, and
on with each span timing its own cost in place, so that a product
call's host time in the three can be set side by side.  Then at most
:data:`PROFILE_SECONDS` under ``torch.profiler``, where each span is a
host range on the device trace's clock (the card's idle time by the
program's innermost range).  The readers take the spans' sums by name.
It prints a ``cardbench spans:`` line (the spans in ms by name and the
counters of each part) and, last, one JSON line: the run's per-layer
metrics, those of :data:`READERS` beside them, ``breakdown`` with
``idle_in_program``, the card, and the checks.

A product call is a ``csr.api.mult_dense``, ``mult_vec`` or
``mult_vec_t`` span; the readers divide by their count.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import sys
import time

import torch

from cardbench import cell, generate, metrics, program
from cardbench import trace as tr

#: the unprofiled phase, the program's tracing on in a third of the steps (s)
SPAN_SECONDS = 5.0
#: the longest profiled phase with the program's tracing on (s)
PROFILE_SECONDS = 3.0
#: the spans of the product calls the per-call readers divide by
PRODUCTS = ("csr.api.mult_dense", "csr.api.mult_vec", "csr.api.mult_vec_t")
#: set-up's layouts and host transposes (``csr.build.<form>``)
PACKING = ("layout", "layout_t", "large", "large_t", "csr_t")
PREFIX = "csr."


def _calls(spans: dict) -> int:
    return sum(spans.get(n, {}).get("count", 0) for n in PRODUCTS)


def _per_call(part: dict, prefix: str, key: str):
    spans = part.get("spans") or {}
    calls = _calls(spans)
    got = [s[key] for n, s in spans.items() if n.startswith(prefix)]
    if not calls or not got:
        return None
    return sum(got) / calls / 1e6


def _setup_s(part: dict, names) -> float | None:
    spans = part.get("spans") or {}
    got = [spans[n]["total_ns"] for n in names if n in spans]
    return sum(got) / 1e9 if got else None


def _program_idle_share(prog: dict):
    p = prog.get("profile")
    if not p or not p["window_ns"]:
        return None
    return 100.0 * p["program_idle_ns"] / p["window_ns"]


def _host_reads_per_step(prog: dict):
    run = prog.get("spans_phase") or {}
    if not run.get("steps"):
        return None
    return run["counters"].get("host_reads", 0) / run["steps"]


#: metric name -> reader of the program's tracing record of a run: what
#: :func:`program_phases` gives, and set-up's :func:`part` under ``"setup"``
READERS = {
    "api_self_ms": lambda p: _per_call(p.get("spans_phase") or {}, "csr.api.", "self_ns"),
    "route_host_ms": lambda p: _per_call(p.get("spans_phase") or {}, "csr.backend.",
                                         "self_ns"),
    "wrapper_host_ms": lambda p: _per_call(p.get("spans_phase") or {}, "csr.op.",
                                           "self_ns"),
    "launch_host_ms": lambda p: _per_call(p.get("spans_phase") or {}, "csr.launch.",
                                          "total_ns"),
    "host_reads_per_step": _host_reads_per_step,
    "program_idle_share": _program_idle_share,
    "pack_s": lambda p: _setup_s(p.get("setup") or {},
                                 [f"csr.build.{f}" for f in PACKING]),
    "route_stat_s": lambda p: _setup_s(p.get("setup") or {}, ["csr.build.stat"]),
}


def part(snap: dict) -> dict:
    """A tracing snapshot as a part of the record: spans and counters
    (the records one by one left out)."""
    return {"spans": snap["spans"], "counters": snap["counters"]}


def _innermost(ranges: list) -> list:
    """``[(t0, t1, csr, op)]``: the host's time cut where a range opens or
    closes, each piece named by the innermost program range (``csr.``)
    and the innermost ``cb.op:`` range open over it (None where none
    is).  ``ranges`` are ``(start, end, name)`` of properly nested ranges
    of one thread."""
    pieces, stack = [], []

    def names():
        csr = next((n for _, _, n in reversed(stack) if n.startswith(PREFIX)), None)
        op = next((n for _, _, n in reversed(stack) if n.startswith(tr.OP)), None)
        return csr, op

    def close_until(t):
        nonlocal at
        while stack and stack[-1][1] <= t:
            end = stack[-1][1]
            if end > at:
                pieces.append((at, end, *names()))
                at = end
            stack.pop()

    at = 0
    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(s)
        if stack and s > at:
            pieces.append((at, s, *names()))
        at = s
        stack.append((s, e, name))
    close_until(float("inf"))
    return [p for p in pieces if p[1] > p[0] and (p[2] or p[3])]


def idle_in_program(events) -> dict | None:
    """The profiled phase's window and busy time, and the card's idle time
    while the host was inside a program range, in all (``program_idle_ns``)
    and by the innermost one with the ``cb.op:`` call around it
    (``idle_in_program``, the ten largest, in seconds).  The window and
    the busy time are read as :func:`cardbench.trace.read` reads them,
    the program's ranges on the card left out."""
    steps, host, busy = [], [], []
    for e in events:
        kind, name, start, end = tr._fields(e)
        if kind == "user_annotation" and name == tr.STEP:
            steps.append((start, end))
        elif kind in ("user_annotation", "cpu_op") and (
                name.startswith(tr.OP) or name.startswith(PREFIX)):
            host.append((start, end, name))
        elif kind in tr.DEVICE_KINDS and not name.startswith(PREFIX):
            busy.append((start, end))
    if not steps:
        return None
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    merged = tr._merge([(max(s, w0), min(e, w1)) for s, e in busy if e > w0 and s < w1])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    by_key, total = {}, 0
    gap_starts = [a for a, _ in gaps]
    for t0, t1, csr, op in _innermost(host):
        if csr is None:
            continue
        i = max(bisect.bisect_right(gap_starts, t0) - 1, 0)
        while i < len(gaps) and gaps[i][0] < t1:
            ov = min(t1, gaps[i][1]) - max(t0, gaps[i][0])
            if ov > 0:
                key = csr if op is None else f"{csr} in {op[len(tr.OP):]}"
                by_key[key] = by_key.get(key, 0) + ov
                total += ov
            i += 1
    top = sorted(by_key.items(), key=lambda kv: -kv[1])[:10]
    return {"window_ns": w1 - w0, "busy_ns": sum(e - s for s, e in merged),
            "program_idle_ns": total,
            "idle_in_program": [[k[:160], v / 1e9] for k, v in top]}


def _profiled_program(runner: cell.Runner, seconds: float):
    """Steps under ``torch.profiler``, each in a ``cb.step`` range and each
    call in its ``cb.op:`` range, as the traced window's profiled phase
    runs them; the events read by :func:`idle_in_program`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ctx, env = runner.ctx, runner.env
    labels = [tr.op_label(c.out, c.name) for c in runner.step]

    def around_synced(calls):
        with record_function(tr.STEP):
            for call, label in zip(calls, labels):
                with record_function(label):
                    program.run_call(call, ctx, env)
            cell._sync(ctx.device)

    activities = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        runner.loop(seconds, around_synced)
    return idle_in_program(prof.profiler.kineto_results.events())


def _add(total: dict, snap: dict):
    for name, sp in snap["spans"].items():
        got = total["spans"].setdefault(name, {"count": 0, "total_ns": 0, "self_ns": 0})
        for k in got:
            got[k] += sp[k]
    for name, n in snap["counters"].items():
        total["counters"][name] = total["counters"].get(name, 0) + n


#: the kinds of step of the unprofiled phase, in turn
KINDS = ("on", "off", "timed")
#: the span layers of a product call, outermost first
LAYERS = ("csr.api.", "csr.backend.", "csr.op.", "csr.launch.")


def _timed_span(cost: dict):
    """A span class that also sums, by name, the host time each span spends
    outside its own interval: from its making to its start, and from its
    end to its return.  That time counts in the span around it (or, for
    the outermost, in the caller's)."""
    from csr_tpu_torch import tracing

    class Timed(tracing._Span):
        __slots__ = ("made",)

        def __init__(self, rec, name):
            self.made = time.perf_counter_ns()
            super().__init__(rec, name)

        def __exit__(self, *exc):
            end = time.perf_counter_ns()
            super().__exit__(*exc)
            c = cost.setdefault(self.name, [0, 0])
            c[0] += 1
            c[1] += self.start - self.made + time.perf_counter_ns() - end
            return False

    return Timed


def _alternating(runner: cell.Runner, seconds: float) -> dict:
    """``seconds`` of steps unprofiled, of three kinds in turn (:data:`KINDS`):
    the program's tracing on, off, and on with each span timing its own
    cost in place (:func:`_timed_span`).  Returns the spans and counters
    of the ``on`` steps (``steps`` of them); the mean host time of a
    product call timed from outside (as ``api_host_ms`` is) in each kind
    (``api_host_<kind>_ms``); the garbage collector's ms a step in each
    kind (``gc_ms``); and, from the timed steps, the cost of each layer's
    spans a product call (``span_cost_ms``, by :data:`LAYERS`) with the
    API span's mean total there (``timed_api_span_ms``)."""
    from csr_tpu_torch import tracing

    ctx, env = runner.ctx, runner.env
    kinds = [runner.product(c) for c in runner.step]
    host = {k: [] for k in KINDS}
    gc_ns = {k: 0 for k in KINDS}
    steps = {k: 0 for k in KINDS}
    total = {"spans": {}, "counters": {}, "steps": 0}
    timed = {"spans": {}, "counters": {}}
    cost = {}
    now = {"kind": "off", "gc": 0}
    plain, timing = tracing._Span, _timed_span(cost)

    def collecting(phase, info):
        if phase == "start":
            now["gc"] = time.perf_counter_ns()
        else:
            gc_ns[now["kind"]] += time.perf_counter_ns() - now["gc"]

    def around(calls):
        kind = now["kind"] = KINDS[runner.k % len(KINDS)]
        if kind != "off":
            tracing.enable()
            if kind == "timed":
                tracing._Span = timing
        try:
            for call, product in zip(calls, kinds):
                if product in ("spmm", "spmv"):
                    t0 = time.perf_counter()
                    program.run_call(call, ctx, env)
                    host[kind].append(time.perf_counter() - t0)
                else:
                    program.run_call(call, ctx, env)
        finally:
            tracing._Span = plain
            if kind != "off":
                _add(total if kind == "on" else timed, tracing.disable().snapshot())
            steps[kind] += 1

    gc.callbacks.append(collecting)
    try:
        runner.loop(seconds, around)
    finally:
        gc.callbacks.remove(collecting)
    total["steps"] = steps["on"]
    for kind in KINDS:
        total[f"api_host_{kind}_ms"] = (sum(host[kind]) / len(host[kind]) * 1e3
                                        if host[kind] else None)
    total["gc_ms"] = {k: gc_ns[k] / steps[k] / 1e6 if steps[k] else None for k in KINDS}
    calls = _calls(timed["spans"])
    total["span_cost_ms"] = {
        layer: sum(ns for n, (_, ns) in cost.items() if n.startswith(layer)) / calls / 1e6
        for layer in LAYERS} if calls else {}
    total["timed_api_span_ms"] = _per_call(timed, "csr.api.", "total_ns")
    return total


def program_phases(runner: cell.Runner, seconds: float = SPAN_SECONDS,
                   profile_s: float = PROFILE_SECONDS) -> dict:
    """The two phases with the program's tracing on: ``seconds`` of steps
    unprofiled, of three kinds in turn (``spans_phase``:
    :func:`_alternating`), then ``profile_s`` profiled with it on
    throughout (``profile``: :func:`idle_in_program`)."""
    from csr_tpu_torch import tracing

    spans_phase = _alternating(runner, seconds)
    tracing.enable()
    try:
        profile = _profiled_program(runner, profile_s)
    finally:
        tracing.disable()
    return {"spans_phase": spans_phase, "profile": profile}


def ms_table(p: dict) -> dict:
    """Spans in ms by name (count, total, self) and the counters."""
    return {"spans": {k: [s["count"], s["total_ns"] / 1e6, s["self_ns"] / 1e6]
                      for k, s in sorted(p.get("spans", {}).items())},
            "counters": dict(sorted(p.get("counters", {}).items()))}


def run_traced(bench: dict, workload: str, seed: int, seconds: float, *,
               device="cuda", t_start: float | None = None, config=None,
               traffic=None, card: str = "", span_s: float = SPAN_SECONDS,
               profile_s: float = PROFILE_SECONDS, info=None) -> dict:
    """One traced run of cell ``workload`` (the run of
    :func:`cardbench.cell.run_cell`), the program's tracing on in set-up
    and in the two phases that follow the window; returns the result
    line's fields (``checks`` last); ``info(dict)`` receives the spans."""
    from csr_tpu_torch import tracing
    from csr_tpu_torch.kernels import _listeners

    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell.find_cell(bench, workload)
    config = config or generate.load_config(spec["config"])
    traffic = traffic or program.load_traffic(spec["traffic"])
    device = torch.device(device)
    g = generate.generator(seed, "start", "cpu")
    ctx = program.Context(device=device, seed=seed,
                          start=int(torch.randint(0, 1 << 30, (1,), generator=g)))
    trip = generate.ratings(config, seed, device)
    cell._sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    runner = cell.Runner(traffic, ctx, {"triples": trip})
    rec = cell.Record()
    routes = cell.Routes()
    _listeners.append(routes)
    names = list(traffic["check"])
    prog = {}
    try:
        tracing.enable()
        runner.run_setup(rec.first_calls)
        warm = max(int(traffic.get("warmup_steps", 1)), runner.cycle())
        for i in range(warm):
            runner.one_step(rec.first_calls if i == 0 else None)
            if i == 0:
                first = {n: cell._to(runner.env[n], "cpu") for n in names}
        prog["setup"] = part(tracing.disable().snapshot())
        gc.freeze()
        rec.setup_s = time.perf_counter() - t_start
        window_profile = min(cell.PROFILE_SECONDS, seconds / 2)
        runner.loop(seconds - window_profile, cell._host_spans(runner, rec.api_host))
        rec.step_times, rec.window_s, rec.profile = cell._profiled(runner, window_profile,
                                                                   card)
        prog.update(program_phases(runner, span_s, profile_s))
        if device.type == "cuda":
            rec.peak_bytes = torch.cuda.max_memory_allocated(device)
    finally:
        tracing.disable()
        _listeners.remove(routes)
    last_step = runner.k - 1
    last = {n: runner.env[n] for n in names}
    before = dict(runner.before_last or {})
    del runner
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.verify(traffic, ctx, trip, names, first, last, last_step, before)
    failed = sum(1 for tag in ("first", "last")
                 if any(not (v <= lim) for k, (v, lim) in checks.items()
                        if k.startswith(tag + ".")))
    values = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        v = metrics.reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    for name, read in READERS.items():
        v = read(prog)
        if v is not None:
            values[name] = {"value": v}
    p = prog.get("profile") or {}
    run = prog["spans_phase"]
    cost = run["span_cost_ms"]
    extra = {"api_span_ms": _per_call(run, "csr.api.", "total_ns"),
             **{k: run[k] for k in ("api_host_on_ms", "api_host_off_ms", "api_host_timed_ms",
                                    "gc_ms", "span_cost_ms", "timed_api_span_ms")},
             # each host layer's reading less its inner spans' cost in place:
             # what it would read with tracing off
             "layers_off_ms": {
                 name: values[name]["value"] - cost.get(inner, 0.0)
                 for name, inner in (("api_self_ms", "csr.backend."),
                                     ("route_host_ms", "csr.op."),
                                     ("wrapper_host_ms", "csr.launch."),
                                     ("launch_host_ms", None)) if name in values},
             "program_phase_idle_share": (100.0 * (1 - p["busy_ns"] / p["window_ns"])
                                          if p.get("window_ns") else None)}
    if info is not None:
        info({"setup": ms_table(prog["setup"]), "spans_phase": ms_table(run),
              "steps": run["steps"], "routes": routes.counts})
    breakdown = dict((rec.profile or {}).get("breakdown") or {})
    breakdown["idle_in_program"] = p.get("idle_in_program", [])
    return {"correct": failed == 0 and bool(checks), "attempted": len(rec.step_times),
            "failed": failed, "metrics": values, "beside": extra,
            "breakdown": breakdown,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("cardbench.spans: no CUDA device", file=sys.stderr)
        return 2
    from cardbench.run import card_line

    t0 = time.perf_counter()
    result = run_traced(cell.load_benchmark(), args.workload, args.seed, args.seconds,
                        t_start=t0, card=torch.cuda.get_device_name(0),
                        info=lambda r: print("cardbench spans: " + json.dumps(r), flush=True))
    checks = result.pop("checks")
    result["card"] = card_line()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
