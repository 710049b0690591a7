"""
One run of one cell: the configuration's data made on the device from
the seed, the traffic's set-up through the program's public API (its
first step included, so packing, the route statistic and CSR-form edges
land in set-up), warm-up, a closed loop of steps for the window, then
the check of what the window produced against the plain reference.

A step ends in ``torch.cuda.synchronize()``, as a caller's next host
decision waits for its result.  The untraced run times the window alone.
The traced run spends the first part of its window timing each public
product call on the host, and the rest (at most
:data:`PROFILE_SECONDS`) under ``torch.profiler``.
"""

from __future__ import annotations

import gc
import json
import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import torch

from cardbench import check, generate, metrics, ops, program, reference, roofline
from cardbench import trace as tr

HERE = os.path.dirname(os.path.abspath(__file__))
#: the longest part of a traced window the profiler records
PROFILE_SECONDS = 3.0


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise ValueError(f"no workload {workload} in BENCHMARK.json")


@dataclass
class Record:
    """What a run measured, for the metric readers."""

    setup_s: float = 0.0
    window_s: float = 0.0
    step_times: list = field(default_factory=list)
    peak_bytes: int = 0
    api_host: dict = field(default_factory=dict)
    first_calls: dict = field(default_factory=dict)
    profile: dict | None = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_arg(call) -> str:
    for _, kind, payload in call.args:
        if kind == 0:
            return payload
    return ""


def _to(x, device):
    """A step's output moved to ``device`` (a CSR as its three tensors)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if hasattr(x, "colinds"):
        return SimpleNamespace(nrows=x.nrows, ncols=x.ncols,
                               rowptrs=x.rowptrs.to(device),
                               colinds=x.colinds.to(device),
                               values=x.values.to(device))
    return x


class Runner:
    """The program side of a run: its results (``env``), the compiled
    set-up and step, and the loop that times steps."""

    def __init__(self, traffic: dict, ctx: program.Context, env: dict):
        self.ops = ops.registry()
        self.ctx, self.env = ctx, env
        known = set(env)
        self.setup = program.compile_ops(traffic["setup"], self.ops, known)
        self.step = program.compile_ops(traffic["step"], self.ops, known)
        self.carry = program.carried(traffic["step"])
        self.k = 0
        self.before_last = None

    def product(self, call):
        return self.ops[call.name].product if call.name in self.ops else None

    def run_setup(self, first_calls: dict):
        for call in self.setup:
            self._timed_first(call, first_calls)

    def _timed_first(self, call, first_calls: dict):
        label = self.product(call) and f"{call.name}:{_first_arg(call)}"
        if label and label not in first_calls:
            t0 = time.perf_counter()
            program.run_call(call, self.ctx, self.env)
            first_calls[label] = time.perf_counter() - t0
        else:
            program.run_call(call, self.ctx, self.env)

    def cycle(self) -> int:
        """Steps of one pass of the step's walks (1 if it walks nothing)."""
        n = 1
        for call in self.step:
            op = self.ops.get(call.name)
            if op is not None and op.cycle is not None:
                n = max(n, op.cycle(call.resolve(self.env)))
        return n

    def one_step(self, first_calls: dict | None = None):
        self.ctx.step = self.k
        for call in self.step:
            if first_calls is None:
                program.run_call(call, self.ctx, self.env)
            else:
                self._timed_first(call, first_calls)
        _sync(self.ctx.device)
        self.k += 1

    def loop(self, seconds: float, around=None):
        """Steps until ``seconds`` have passed; each step's wall time and
        the window's length.  ``around(call)`` runs a call in a span of
        the caller's."""
        ctx, env, calls, dev = self.ctx, self.env, self.step, self.ctx.device
        times, before = [], None
        t_begin = t = time.perf_counter()
        while True:
            if self.carry:
                before = {n: env[n] for n in self.carry}
            ctx.step = self.k
            if around is None:
                for call in calls:
                    program.run_call(call, ctx, env)
            else:
                around(calls)
            _sync(dev)
            t_end = time.perf_counter()
            times.append(t_end - t)
            t = t_end
            self.k += 1
            if t - t_begin >= seconds:
                break
        self.before_last = before
        return times, t - t_begin


def _host_spans(runner: Runner, api_host: dict):
    ctx, env = runner.ctx, runner.env
    kinds = [runner.product(c) for c in runner.step]

    def around(calls):
        for call, kind in zip(calls, kinds):
            if kind in ("spmm", "spmv"):
                t0 = time.perf_counter()
                program.run_call(call, ctx, env)
                api_host.setdefault(kind, []).append(time.perf_counter() - t0)
            else:
                program.run_call(call, ctx, env)
    return around


def _profiled(runner: Runner, seconds: float, card: str):
    """The profiled part of a traced window: its step times and the
    profile's numbers (:func:`cardbench.trace.read`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ctx, env = runner.ctx, runner.env
    labels = [tr.op_label(c.out, c.name) for c in runner.step]

    def around_synced(calls):  # the step's range closes after its sync
        with record_function(tr.STEP):
            for call, label in zip(calls, labels):
                with record_function(label):
                    program.run_call(call, ctx, env)
            _sync(ctx.device)

    activities = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        times, window = runner.loop(seconds, around_synced)
    events = prof.profiler.kineto_results.events()
    works = {}
    for call, label in zip(runner.step, labels):
        op = runner.ops.get(call.name)
        if op is None or label in works:
            continue
        least = None
        if op.work is not None and ctx.device.type == "cuda":
            least = roofline.least_ms(*op.work(call.resolve(env)), card)
        works[label] = (op.product, least)
    return times, window, tr.read(events, works)


class Routes:
    """A listener on the program's trace events: the route of each
    product and ESC's terms and chunks, for the traced run's report."""

    def __init__(self):
        self.counts, self.esc = {}, []

    def __call__(self, event, fields):
        if event == "esc":
            self.esc.append((fields.get("terms"), fields.get("chunks")))
        elif "route" in fields:
            key = f"{event}:{fields['route']}"
            self.counts[key] = self.counts.get(key, 0) + 1
        elif event.startswith("layout-build"):
            self.counts[event] = self.counts.get(event, 0) + 1


def run_cell(bench: dict, workload: str, seed: int, seconds: float, traced: bool,
             *, device="cuda", t_start: float | None = None, config=None,
             traffic=None, card: str = "", info=None) -> dict:
    """One run of cell ``workload``; returns the result line's fields
    (``checks`` last).  ``info(dict)`` receives the run's report."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(bench, workload)
    config = config or generate.load_config(cell["config"])
    traffic = traffic or program.load_traffic(cell["traffic"])
    device = torch.device(device)
    g = generate.generator(seed, "start", "cpu")
    ctx = program.Context(device=device, seed=seed,
                          start=int(torch.randint(0, 1 << 30, (1,), generator=g)))
    trip = generate.ratings(config, seed, device)
    _sync(device)
    if device.type == "cuda":
        # the generator's temporaries are freed: the peak counts the
        # triples handed to the program, and the program's own memory
        torch.cuda.reset_peak_memory_stats(device)
    parts = {"data_s": time.perf_counter() - t_start}
    runner = Runner(traffic, ctx, {"triples": trip})
    rec = Record()
    routes = None
    if traced:
        from csr_tpu_torch.kernels import _listeners

        routes = Routes()
        _listeners.append(routes)
    try:
        runner.run_setup(rec.first_calls)
        _sync(device)
        parts["setup_ops_s"] = time.perf_counter() - t_start - parts["data_s"]
        # warm-up covers one pass of what the step walks (every block a
        # window meets), and at least the traffic's own count of steps
        warm = max(int(traffic.get("warmup_steps", 1)), runner.cycle())
        names = list(traffic["check"])
        for i in range(warm):
            runner.one_step(rec.first_calls if i == 0 else None)
            if i == 0:
                first = {n: _to(runner.env[n], "cpu") for n in names}
        # the set-up's objects (the libraries', the harness's, the
        # program's matrices) leave the collector's scans: a full
        # collection over them took about 90 ms, a stall that landed in
        # a window or not, run by run; what the steps allocate is still
        # collected
        gc.freeze()
        rec.setup_s = time.perf_counter() - t_start
        parts["warmup_s"] = rec.setup_s - parts["data_s"] - parts["setup_ops_s"]
        parts["warmup_steps"] = warm
        if not traced:
            rec.step_times, rec.window_s = runner.loop(seconds)
        else:
            prof_s = min(PROFILE_SECONDS, seconds / 2)
            runner.loop(seconds - prof_s, _host_spans(runner, rec.api_host))
            rec.step_times, rec.window_s, rec.profile = _profiled(runner, prof_s, card)
        if device.type == "cuda":
            rec.peak_bytes = torch.cuda.max_memory_allocated(device)
    finally:
        if routes is not None:
            _listeners.remove(routes)
    last_step = runner.k - 1
    last = {n: runner.env[n] for n in names}
    before = dict(runner.before_last or {})
    report = {"routes": routes and routes.counts, "esc": routes and routes.esc[-3:],
              "first_calls": rec.first_calls, "setup": parts,
              "steps": len(rec.step_times),
              "data": generate.describe(trip)}
    del runner
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = verify(traffic, ctx, trip, names, first, last, last_step, before)
    failed = sum(1 for tag in ("first", "last")
                 if any(not (v <= lim) for k, (v, lim) in checks.items()
                        if k.startswith(tag + ".")))
    wanted = "per_layer" if traced else "end_to_end"
    values = {}
    for m in bench[wanted]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        v = metrics.reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": rec.peak_bytes}
    result = {"correct": failed == 0 and bool(checks), "attempted": len(rec.step_times),
              "failed": failed, "metrics": values, "device": dev}
    if traced and rec.profile:
        dev["busy_s"] = rec.profile["busy_ns"] / 1e9
        dev["window_s"] = rec.profile["window_ns"] / 1e9
        result["breakdown"] = rec.profile["breakdown"]
        report["profile"] = {k: rec.profile[k] for k in
                             ("steps", "device_events", "unplaced",
                              "products", "activity_kinds")}
        report["profile"]["kernels"] = sum(
            n for kind, n, _ in rec.profile["device"].values() if kind == "kernel")
        report["profile"]["window_steps"] = len(rec.step_times)
    if info is not None:
        info(report)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def reference_env(traffic: dict, ctx: program.Context, trip: dict) -> tuple:
    """The reference's results after set-up, and its compiled step."""
    reg = reference.registry()
    env = {"triples": trip}
    known = set(env)
    for call in program.compile_ops(traffic["setup"], reg, known):
        program.run_call(call, ctx, env)
    return env, program.compile_ops(traffic["step"], reg, known)


def reference_step(ctx, env: dict, calls: list, step: int, carried: dict) -> dict:
    """The reference's results of step ``step``, the state the step carries
    in taken from ``carried``."""
    env = dict(env)
    env.update({n: check.as_ref(v) for n, v in carried.items()})
    ctx.step = step
    for call in calls:
        program.run_call(call, ctx, env)
    return env


def verify(traffic, ctx, trip, names, first, last, last_step, before) -> dict:
    """``{"<first|last>.<output>[.bad]": (number, limit)}``: the checked
    steps' outputs against the reference's.  The last step starts from
    the program's own carried state (the state before it); the first
    from the seed's inputs alone."""
    limits = traffic["check"]
    rctx = program.Context(device=ctx.device, seed=ctx.seed, start=ctx.start)
    env, calls = reference_env(traffic, rctx, trip)
    out = {}
    runs = [("first", {n: _to(v, ctx.device) for n, v in first.items()}, 0, {}),
            ("last", last, last_step, before)]
    for tag, got, step, carried in runs:
        ref = reference_step(rctx, env, calls, step, carried)
        for n in names:
            for suffix, v in check.compare(got[n], ref[n]).items():
                out[f"{tag}.{n}{suffix}"] = (v, limits[n] if not suffix else 0)
        del ref
    return out
