"""The Netflix Prize shape at a small size: few columns, long item rows,
so the transpose's row windows hold many groups of 32 micro-rows, each
adding its sums into the same rows of C (as Rt's 139 windows of about
207 groups each do at the full size).  The matrix comes from the
benchmark's generator with ``cardbench/configs/netflix.json``'s laws and
smaller counts, on the CPU under the ``cuda`` backend, whose micro-block
plain versions (``spmm_regrouped``, ``spmm_reference``) run the layout
as the kernel does.

Every product against float64 from the benchmark's plain reference
(``cardbench/reference/csr.py``, which imports nothing of the port),
under ``tests/util.py``'s tolerances; the ``layout-build`` events'
``windows``, ``groups`` and ``groups_max`` against the layout's
``rbcb``; the ``csr.spmm.b_past_l2`` counter at an L2 the test gives;
``from_coo``'s inner spans; and a refit loop whose dropped matrices die
by reference counting alone.
"""

import gc
import weakref
import zlib

import numpy as np
import pytest
import torch

import csr_tpu_torch.kernels as kernels
from cardbench import generate, program
from cardbench.reference import Ref
from cardbench.reference import csr as ref_csr
from csr_tpu_torch import CSR, tracing
from csr_tpu_torch.kernels import cuda as cuda_k
from csr_tpu_torch.ops import microblock as mb, spmm

from torch_util import kept
from util import dense_tols

#: the configuration's laws at a small size: 5% dense, 20 a user, 150 a
#: title (the source: 1.18%, 209, 5,654); at most half the titles a
#: user, as the cap keeps the generator's redraws short at full size
SMALL = {"users": 3000, "items": 400, "ratings": 60000}
CAP = 200
SEED = 3_000_000_021
#: an L2 between Q's rows at n = 50 (400 x 50 x 4 B) and P's (3,000 x 50
#: x 4 B), so the transpose's product passes it and R's does not
L2 = 200_000


@pytest.fixture(autouse=True)
def recording_off():
    tracing.disable()
    yield
    tracing.disable()


def _triples(seed=SEED):
    cfg = generate.load_config("netflix")
    cfg.update(SMALL, user_degree=dict(cfg["user_degree"], cap=CAP))
    return generate.ratings(cfg, seed, "cpu")


def _port(trip):
    return CSR.from_coo(trip["rows"], trip["cols"], trip["vals"], shape=trip["shape"],
                        device="cpu")


@pytest.fixture(scope="module")
def sides():
    trip = _triples()
    r = _port(trip)
    ctx = program.Context(device=torch.device("cpu"), seed=SEED)
    rm = ref_csr.from_coo(ctx, trip)
    return {"R": (r, rm), "Rt": (r.transpose(), ref_csr.transpose_rmat(ctx, rm))}


def _operand(c, n, tag):
    g = torch.Generator().manual_seed(zlib.crc32(f"{tag} {n}".encode()))
    return torch.randn(c.ncols, n, generator=g)


def _reference(rm, b):
    """``A @ B`` in float64 by the benchmark's plain reference."""
    ctx = program.Context(device=torch.device("cpu"), seed=SEED)
    b64 = b.to(torch.float64)
    return ref_csr.mult_dense(ctx, rm, Ref(b64, b64.abs())).value.numpy()


def _per_window(layout):
    """Micro-rows of each row window, from ``rbcb``."""
    rb = (layout.rbcb[: layout.n_microrows] >> 16).numpy()
    return np.bincount(rb, minlength=layout.rb_count)


def test_the_transpose_has_many_groups_a_window(sides):
    r, rt = sides["R"][0], sides["Rt"][0]
    assert (r.nrows, r.ncols, r.nnz) == (SMALL["users"], SMALL["items"], SMALL["ratings"])
    for c in (r, rt):
        assert cuda_k._spmm_route(c, 50) == cuda_k._spmm_route(c, 7) == "kernel"
    per = _per_window(cuda_k._cached_layout(rt))
    assert int((per > mb.ACC_GROUP).sum()) >= 3, per
    assert cuda_k.group_counts(cuda_k._cached_layout(rt))["groups_max"] >= 4


@pytest.mark.parametrize("n", [50, 7])
@pytest.mark.parametrize("side", ["R", "Rt"])
def test_mult_dense_against_the_float64_reference(sides, side, n):
    """The normal path (route, layout, plan) and the kernel's plain
    versions on the packed layout, each against float64."""
    c, rm = sides[side]
    b = _operand(c, n, side)
    ref = _reference(rm, b)
    tol = dense_tols(ref, np.float32)
    with kernels.use_kernel("cuda"):
        got = c.mult_dense(b)
        again = c.mult_dense(b)  # the plan's hit
    assert kept(c, ("plan", "mult_dense")) is not None
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.numpy(), ref, **tol)
    layout = cuda_k._cached_layout(c)
    for plain in (spmm.spmm_regrouped, spmm.spmm_reference):
        np.testing.assert_allclose(plain(layout, b).numpy(), ref, **tol)


def _listened(fn):
    """``fn()``'s ``layout-build*`` events, ``(event, fields)``."""
    seen = []
    kernels._listeners.append(lambda e, f: seen.append((e, f)) if e.startswith(
        "layout-build") else None)
    try:
        fn()
    finally:
        kernels._listeners.pop()
    return seen


def _groups_from_rbcb(layout):
    rb = (layout.rbcb[: layout.n_microrows : mb.ACC_GROUP] >> 16).numpy()
    return {"windows": len(np.unique(rb)), "groups": rb.size,
            "groups_max": int(np.bincount(rb).max())}


def test_layout_events_give_the_groups_of_rbcb():
    trip = _triples()
    c = _port(trip).transpose()
    with kernels.use_kernel("cuda"):
        events = _listened(lambda: (c.mult_dense(_operand(c, 50, "e")),
                                    c.mult_vec_t(torch.ones(c.nrows))))
    (_, f), (_, ft) = events
    assert [e for e, _ in events] == ["layout-build", "layout-build-t"]
    want = _groups_from_rbcb(cuda_k._cached_layout(c))
    assert {k: f[k] for k in want} == want and want["groups_max"] >= 4
    assert f["microrows"] == want["groups"] * mb.ACC_GROUP
    want_t = _groups_from_rbcb(cuda_k._cached_layout_t(c))
    assert {k: ft[k] for k in want_t} == want_t
    # the recorder keeps them as counters: windows and groups summed,
    # groups_max the most of any layout
    c2 = _port(trip)
    rec = tracing.enable()
    with kernels.use_kernel("cuda"):
        c.values.mul_(2)  # the layouts are built again
        c.mult_dense(_operand(c, 50, "e"))
        c2.mult_dense(_operand(c2, 50, "e"))
    counters = rec.snapshot()["counters"]
    mine = _groups_from_rbcb(cuda_k._cached_layout(c2))
    assert counters["event.layout-build"] == 2
    assert counters["event.layout-build.groups"] == want["groups"] + mine["groups"]
    assert counters["event.layout-build.windows"] == want["windows"] + mine["windows"]
    assert counters["event.layout-build.groups_max"] == max(want["groups_max"],
                                                            mine["groups_max"])


def test_group_counts_are_worked_out_only_for_a_listener(monkeypatch):
    def refuse(layout):
        raise AssertionError("group counts worked out with no one listening")

    saved = list(kernels._listeners)
    kernels._listeners.clear()
    monkeypatch.setattr(tracing, "_TRACE", False)
    monkeypatch.setattr(cuda_k, "group_counts", refuse)
    try:
        c = _port(_triples())
        with kernels.use_kernel("cuda"):
            c.mult_dense(_operand(c, 50, "off"))
        assert kept(c, "layout") is not None and not tracing.listening()
    finally:
        kernels._listeners.extend(saved)


@pytest.mark.parametrize("n", [50, 7])
def test_b_past_l2_counts_each_call_past_the_given_l2(sides, n, monkeypatch):
    """At the test's L2, the transpose's product by P (3,000 rows) passes
    it at n = 50 and not at n = 7 (84,000 B); R's by Q (400 rows) never.
    Each call counts, a plan's hit too; off a card (no L2) nothing does,
    nor anything with tracing off."""
    r, rt = sides["R"][0], sides["Rt"][0]
    p, q = _operand(rt, n, "P"), _operand(r, n, "Q")
    past = spmm.b_past_l2(rt.ncols, n, L2)
    assert past == (n == 50) and not spmm.b_past_l2(r.ncols, n, L2)
    with kernels.use_kernel("cuda"):
        rec = tracing.enable()
        for c, b in ((rt, p), (r, q)):  # no L2 off a card: nothing counts
            c.mult_dense(b)
        assert "csr.spmm.b_past_l2" not in rec.snapshot(reset=True)["counters"]
        monkeypatch.setattr(cuda_k, "_l2_bytes", lambda dev: L2)
        for c in (rt, r):  # forms and plans made again, under the given L2
            c.values.mul_(1.0)
        for c, b in ((rt, p), (rt, p), (r, q), (r, q)):
            c.mult_dense(b)
        tracing.disable()
        for c, b in ((rt, p), (r, q)):  # plan hits, tracing off
            c.mult_dense(b)
    counters = rec.snapshot()["counters"]
    assert counters.get("plan.hit") == 2
    assert counters.get("csr.spmm.b_past_l2", 0) == (2 if past else 0)
    assert tracing.snapshot()["counters"] == {}


def test_from_coo_spans_sit_inside_its_own():
    trip = _triples()
    _port(trip)
    assert tracing.snapshot()["spans"] == {}
    rec = tracing.enable()
    _port(trip)
    snap = rec.snapshot()
    outer = next(r for r in snap["records"] if r.name == "csr.construct.from_coo")
    inner = [r for r in snap["records"] if r.parent == outer.id]
    assert [r.name for r in inner] == ["csr.construct.read", "csr.construct.convert",
                                       "csr.construct.upload"]
    assert all(outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns for r in inner)
    assert snap["counters"]["host_reads"] == 3  # rows, columns, values


def test_refit_frees_each_dropped_matrix_without_a_collection():
    """A fresh ``from_coo`` and its first ``mult_dense`` three times over,
    the matrix rebound each time, as a refit for each crossfold split
    does: each result matches the first and the float64 reference, and
    the matrix dropped (with its layout, route statistic and plan) is
    gone by reference counting alone, the collector frozen and off as
    the benchmark's window has it."""
    trip = _triples()
    q = _operand(_port(trip), 50, "refit")
    ctx = program.Context(device=torch.device("cpu"), seed=SEED)
    ref = _reference(ref_csr.from_coo(ctx, trip), q)
    results, dropped = [], []
    gc.collect()
    gc.freeze()
    enabled = gc.isenabled()
    gc.disable()
    try:
        r = None
        with kernels.use_kernel("cuda"):
            for _ in range(3):
                if r is not None:
                    dropped.append([weakref.ref(r), weakref.ref(r.values),
                                    weakref.ref(kept(r, "layout").vals)])
                r = _port(trip)
                results.append(r.mult_dense(q))
                assert kept(r, ("plan", "mult_dense")) is not None
                assert all(ref() is None for refs in dropped for ref in refs)
    finally:
        if enabled:
            gc.enable()
        gc.unfreeze()
    assert len(dropped) == 2
    for c in results:
        assert torch.equal(c, results[0])
    np.testing.assert_allclose(results[0].numpy(), ref, **dense_tols(ref, np.float32))
