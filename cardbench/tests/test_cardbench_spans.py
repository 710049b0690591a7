"""The readers of the program's spans and counters (``cardbench.spans``)
on synthetic records, the card's idle time by the program's innermost
range on synthetic profiler events, and a whole traced run with the
program's tracing phases on the CPU at small sizes.

    python -m pytest cardbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest

from cardbench import spans
from cardbench.tests.test_cardbench_harness import BENCH, CELLS, SEED, _Event, inputs
from cardbench.trace import STEP, op_label, read


def _s(count, total, self_ns=None):
    return {"count": count, "total_ns": total, "self_ns": total if self_ns is None else self_ns}


PROG = {
    "setup": {"spans": {"csr.build.layout": _s(1, 2e9), "csr.build.layout_t": _s(1, 1e9),
                        "csr.build.csr_t": _s(1, 5e8), "csr.build.stat": _s(2, 3e8),
                        "csr.build.spmm_edges": _s(1, 1e8)},
              "counters": {"host_reads": 40}},
    "spans_phase": {"spans": {"csr.api.mult_dense": _s(4, 800_000, 200_000),
                              "csr.backend.mult_dense": _s(4, 600_000, 120_000),
                              "csr.op.spmm": _s(4, 480_000, 400_000),
                              "csr.launch.spmm_microblock": _s(4, 80_000)},
                    "counters": {"host_reads": 6, "form_builds.layout": 0}, "steps": 2},
    "profile": {"window_ns": 1_000_000, "busy_ns": 700_000, "program_idle_ns": 50_000,
                "idle_in_program": [["csr.op.spmm in C1=mult_dense", 5e-5]]},
}


def test_readers_on_synthetic_spans():
    got = {name: read(PROG) for name, read in spans.READERS.items()}
    assert got == pytest.approx({
        "api_self_ms": 0.05, "route_host_ms": 0.03, "wrapper_host_ms": 0.1,
        "launch_host_ms": 0.02, "host_reads_per_step": 3.0, "program_idle_share": 5.0,
        "pack_s": 3.5, "route_stat_s": 0.3})
    # the four layers add up to the API span's total a call
    assert sum(got[k] for k in ("api_self_ms", "route_host_ms", "wrapper_host_ms",
                                "launch_host_ms")) == pytest.approx(0.2)
    assert all(read({}) is None for read in spans.READERS.values())
    bare = {"spans_phase": {"spans": {"csr.api.multiply": _s(2, 10)}, "counters": {},
                            "steps": 2}, "setup": {"spans": {}}}
    assert spans.READERS["api_self_ms"](bare) is None  # no product call
    assert spans.READERS["host_reads_per_step"](bare) == 0.0
    assert spans.READERS["pack_s"](bare) is None


def _events():
    """Two 100 us steps.  In each, the host is in C=mult_dense's call from
    10 to 90 us, in csr.api.mult_dense over 20-80, in csr.op.spmm over
    40-60 (a program range on the card beside it, to be left out); a
    kernel runs over 50-70 us."""
    mul = op_label("C", "mult_dense")
    ev = []
    for k in range(2):
        t = 1000 + k * 100_000
        ev += [_Event(STEP, t, 100_000), _Event(mul, t + 10_000, 80_000),
               _Event("csr.api.mult_dense", t + 20_000, 60_000),
               _Event("csr.op.spmm", t + 40_000, 20_000),
               _Event("aten::empty", t + 41_000, 1_000),
               _Event("csr.op.spmm", t + 40_000, 30_000, True),
               _Event("cudaLaunchKernel", t + 45_000, 1_000, corr=k + 1),
               _Event("spmm_kernel", t + 50_000, 20_000, True, k + 1)]
    return ev, mul


def test_idle_in_program_by_innermost_range():
    ev, mul = _events()
    p = spans.idle_in_program(ev)
    assert p["window_ns"] == 200_000 and p["busy_ns"] == 40_000
    # a step's idle time inside the program: 20-40 and 70-80 in the API
    # span, 40-50 in spmm's
    assert p["program_idle_ns"] == 2 * 40_000
    assert p["idle_in_program"] == [["csr.api.mult_dense in C=mult_dense", 60e-6],
                                    ["csr.op.spmm in C=mult_dense", 20e-6]]
    assert 100 * p["program_idle_ns"] / p["window_ns"] <= 100 * (1 - p["busy_ns"] / 200_000)


def test_trace_read_unchanged_by_host_program_ranges():
    """The host's program ranges leave every number of the profile reader
    as it was for the same events."""
    ev, mul = _events()
    host_only = [e for e in ev if not (e.name().startswith("csr.")
                                       and e.device_type().name != "CPU")]
    plain = [e for e in host_only if not e.name().startswith("csr.")]
    assert read(host_only, {mul: ("spmm", 0.01)}) == read(plain, {mul: ("spmm", 0.01)})


def test_innermost_pieces():
    pieces = spans._innermost([(0, 100, "cb.op:C=m"), (10, 50, "csr.api.a"),
                               (20, 30, "csr.op.b"), (60, 70, "csr.api.c")])
    assert pieces == [(0, 10, None, "cb.op:C=m"), (10, 20, "csr.api.a", "cb.op:C=m"),
                      (20, 30, "csr.op.b", "cb.op:C=m"), (30, 50, "csr.api.a", "cb.op:C=m"),
                      (50, 60, None, "cb.op:C=m"), (60, 70, "csr.api.c", "cb.op:C=m"),
                      (70, 100, None, "cb.op:C=m")]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_with_program_phases(name):
    """The whole run on the CPU under the ``cuda`` backend (its routing
    and the plain versions): correct, the run's own per-layer metrics,
    and the program's readings where the cell has something to read."""
    from csr_tpu_torch import kernels, tracing

    tracing_span = tracing._Span
    with kernels.use_kernel("cuda"):
        r = spans.run_traced(BENCH, name, SEED, 0.4, device="cpu", span_s=0.2,
                             profile_s=0.2, **inputs(name))
    assert r["correct"], r["checks"]
    assert tracing._recorder is None and not kernels._listeners
    m = r["metrics"]
    assert {"api_host_ms", "first_call_s"} & set(m)
    assert "idle_in_program" in r["breakdown"] and "idle_gaps" in r["breakdown"]
    assert "host_reads_per_step" in m and "program_idle_share" in m
    assert "launch_host_ms" not in m  # no launch on the CPU
    if name == "ml25m.itemsim":
        assert m["host_reads_per_step"]["value"] > 0 and "api_self_ms" not in m
    else:
        assert m["host_reads_per_step"]["value"] == 0
        assert m["api_self_ms"]["value"] > 0 and m["route_host_ms"]["value"] > 0
        assert "route_stat_s" in m
        beside = r["beside"]
        assert beside["api_host_on_ms"] > 0 and beside["api_host_off_ms"] > 0
        assert beside["api_host_timed_ms"] > 0 and beside["api_span_ms"] > 0
        cost = beside["span_cost_ms"]
        assert set(cost) == set(spans.LAYERS) and cost["csr.backend."] > 0
        assert cost["csr.launch."] == 0  # no launch on the CPU
        assert set(beside["layers_off_ms"]) == {"api_self_ms", "route_host_ms",
                                                "wrapper_host_ms"}
        assert beside["layers_off_ms"]["api_self_ms"] < m["api_self_ms"]["value"]
        assert set(beside["gc_ms"]) == set(spans.KINDS)
    assert tracing._Span is tracing_span
