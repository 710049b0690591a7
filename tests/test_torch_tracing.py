"""Spans and counters of ``csr_tpu_torch.tracing`` on the CPU (the
``cuda`` backend's routing and the kernels' plain versions): nothing
recorded while off, one ``csr.api`` -> ``csr.backend`` -> ``csr.op``
chain a product call while on (``csr.api`` -> ``csr.op`` on a plan's
hit), self times that add up, the forms built and the host's reads
counted, and the spans as ``torch.profiler`` ranges while a profiler
records."""

import threading

import numpy as np
import pytest
import torch

import csr_tpu_torch.kernels as kernels
from csr_tpu_torch import CSR, tracing
from csr_tpu_torch.ops import spgemm

from torch_util import random_matrix


@pytest.fixture(autouse=True)
def recording_off():
    tracing.disable()
    yield
    tracing.disable()


def _matrix():
    a = random_matrix(260, 390, 0.04, seed=5)
    return CSR(a.shape[0], a.shape[1], a.nnz, torch.from_numpy(a.indptr),
               torch.from_numpy(a.indices), torch.from_numpy(a.data), device="cpu")


def _call(c, method, step=1):
    """A product of ``c`` by ones; ``step`` > 1 hands it a strided view,
    another operand key than the contiguous one (``_plan.operand_key``)."""
    if method == "mult_vec":
        return c.mult_vec(torch.ones(c.ncols * step)[::step])
    if method == "mult_vec_t":
        return c.mult_vec_t(torch.ones(c.nrows * step)[::step])
    return c.mult_dense(torch.ones(c.ncols, 8 * step)[:, ::step])


def test_off_records_nothing_and_events_still_flow():
    seen = []
    kernels._listeners.append(lambda e, f: seen.append(e))
    try:
        assert tracing.span("csr.api.a") is tracing.span("csr.op.b") is tracing._OFF
        tracing.count("host_reads")
        with kernels.use_kernel("cuda"):
            _call(_matrix(), "mult_vec")
    finally:
        kernels._listeners.pop()
    assert {"to_handle", "release_handle"} <= set(seen)
    assert tracing.snapshot() == {"spans": {}, "counters": {}, "records": [], "dropped": 0}
    assert kernels.trace is tracing.trace and kernels._listeners is tracing._listeners


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("method", ["mult_vec", "mult_vec_t", "mult_dense"])
def test_a_product_call_is_one_chain(method, planned):
    """The general path is one csr.api -> csr.backend -> csr.op chain; a
    plan's hit skips the backend: csr.api -> csr.op (on the CPU a plan
    launches through the wrapper, which runs the plain version)."""
    c = _matrix()
    rec = tracing.enable()
    with kernels.use_kernel("cuda"):
        _call(c, method)  # the forms and the plan are built here
        rec.reset()
        _call(c, method, step=1 if planned else 2)
    snap = tracing.snapshot()
    by_name = {r.name: r for r in snap["records"]}
    assert len(snap["records"]) == 3 - planned == len(by_name), list(by_name)
    api = by_name[f"csr.api.{method}"]
    backend = by_name.get(f"csr.backend.{method}", api)
    (op,) = [r for r in snap["records"] if r.name.startswith("csr.op.")]
    assert (backend is api) == planned
    assert (api.parent, op.parent) == (0, backend.id)
    assert backend.parent in (0, api.id)
    assert api.call == backend.call == op.call == api.id
    assert api.start_ns <= backend.start_ns <= op.start_ns
    assert op.end_ns <= backend.end_ns <= api.end_ns
    assert snap["counters"]["plan.hit" if planned else "plan.miss.key"] == 1
    for r in snap["records"]:
        s = snap["spans"][r.name]
        children = sum(k.end_ns - k.start_ns for k in snap["records"] if k.parent == r.id)
        assert s["count"] == 1 and s["total_ns"] == r.end_ns - r.start_ns
        assert s["self_ns"] + children == s["total_ns"]
    assert not any(k.startswith("form_builds") for k in snap["counters"])
    assert snap["counters"].get("host_reads", 0) == 0


def _builds(counters):
    return {k: v for k, v in counters.items() if k.startswith("form_builds.")}


@pytest.mark.parametrize("method", ["mult_vec", "mult_vec_t", "mult_dense"])
def test_form_builds_count_each_form_once(method):
    c = _matrix()
    rec = tracing.enable()
    with kernels.use_kernel("cuda"):
        _call(c, method)
        first = _builds(rec.snapshot(reset=True)["counters"])
        _call(c, method)
        again = _builds(rec.snapshot(reset=True)["counters"])
        c.values.mul_(2)
        _call(c, method)
        edited = _builds(rec.snapshot()["counters"])
    assert first and set(first.values()) == {1} and "form_builds.stat" in first
    assert again == {}
    assert edited == first
    spans = rec.snapshot()["spans"]
    assert {k[len("form_builds."):] for k in edited} == {
        k[len("csr.build."):] for k in spans if k.startswith("csr.build.")}


def test_host_reads_and_spans_of_esc(monkeypatch):
    """ESC past the dense budget: three host reads for the plan (A's row
    pointers and columns, B^T's row pointers), one for the unique keys,
    three for ``CSR.multiply``'s filter of zeros (its count and two
    boolean gathers)."""
    monkeypatch.setattr(spgemm, "max_dense_bytes", 1)
    c = _matrix()
    rec = tracing.enable()
    with kernels.use_kernel("cuda"):
        p = c.multiply(c, transpose=True)
    snap = rec.snapshot()
    ref = c.to_scipy() @ c.to_scipy().T
    np.testing.assert_allclose(p.to_scipy().toarray(), ref.toarray(), rtol=1e-5, atol=1e-6)
    counters = snap["counters"]
    assert counters["host_reads"] == 7
    assert counters["route.spgemm.esc"] == 1 and counters["esc.chunks"] == 1
    assert counters["esc.terms"] > 0 and "event.to_handle" not in counters
    spans = snap["spans"]
    for name in ("csr.api.multiply", "csr.backend.mult_abt", "csr.esc.plan",
                 "csr.esc.expand", "csr.esc.compress", "csr.structure.transpose"):
        assert spans[name]["count"] == 1, name
    inner = sum(spans[n]["total_ns"] for n in ("csr.esc.plan", "csr.esc.expand",
                                                "csr.esc.compress",
                                                "csr.structure.transpose"))
    assert spans["csr.backend.mult_abt"]["self_ns"] == spans["csr.backend.mult_abt"][
        "total_ns"] - inner


def _host_ranges(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_spans_are_profiler_ranges_only_while_recording(monkeypatch):
    from torch.profiler import ProfilerActivity, profile, record_function

    c = _matrix()
    x = torch.ones(c.ncols)
    with kernels.use_kernel("cuda"):
        c.mult_vec(x)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("caller"):
                c.mult_vec(x)
        assert not [n for n, _, _ in _host_ranges(prof) if n.startswith("csr.")]

        tracing.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("caller"):
                c.mult_vec(x)
        ranges = {n: (s, e) for n, s, e in _host_ranges(prof)
                  if n == "caller" or n.startswith("csr.")}
        entered = []
        real = tracing._range
        monkeypatch.setattr(tracing, "_range", lambda name: entered.append(name) or real(name))
        c.mult_vec(x)  # no profiler: no range
    assert entered == []
    (op,) = [n for n in ranges if n.startswith("csr.op.")]
    # the second call on the matrix: its plan's hit, with no backend span
    assert "csr.backend.mult_vec" not in ranges
    chain = ["caller", "csr.api.mult_vec", op]
    for outer, inner in zip(chain, chain[1:]):
        assert ranges[outer][0] <= ranges[inner][0] <= ranges[inner][1] <= ranges[outer][1]


def test_recorder_bounds_its_records_and_keeps_the_sums(monkeypatch):
    monkeypatch.setattr(tracing, "SPAN_LIMIT", 2)
    rec = tracing.enable()
    for _ in range(5):
        with tracing.span("a"), tracing.span("b"):
            tracing.count("n", 2)
    snap = rec.snapshot()
    assert len(snap["records"]) == 2 and snap["dropped"] == 8
    assert snap["spans"]["a"]["count"] == snap["spans"]["b"]["count"] == 5
    assert snap["counters"] == {"n": 10}
    assert tracing.disable() is rec and tracing.span("a") is tracing._OFF
    assert rec not in kernels._listeners


def test_threads_keep_their_own_chains():
    """More threads than cores, each nesting spans and counting, with a
    short switch interval: no count is lost and no span takes another
    thread's span as its parent."""
    import sys

    rec = tracing.enable()
    n_threads, rounds = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        tracing.count("c")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = rec.snapshot()
    assert snap["counters"]["c"] == n_threads * rounds
    assert snap["spans"]["inner"]["count"] == n_threads * rounds
    outer = {r.id: r for r in snap["records"] if r.name == "outer"}
    for r in snap["records"]:
        if r.name == "inner":
            p = outer[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns and r.call == p.id
