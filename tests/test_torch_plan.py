"""Product plans (``csr_tpu_torch/_plan.py``) on the CPU, through the
``cuda`` backend's plain versions: a hit returns what the general path
returns; an in-place edit, a rebinding, another operand key, an f64
operand or another kernel takes the general path (and builds a new plan
where its route has one); vmap, row shards and the grad rule keep the
general path; a hit emits the general path's events and holds neither
operand nor result."""

import gc
import weakref

import numpy as np
import pytest
import torch

import csr_tpu_torch.kernels as kernels
from csr_tpu_torch import CSR, tracing
from csr_tpu_torch.kernels import cuda as cuda_k
from csr_tpu_torch.ops import spgemm

from torch_util import kept, random_matrix

#: route -> (method, B's width or None for a vector, the route's settings:
#: SpMV's CSR-form crossover, SpMM's)
ROUTES = {
    "microblock-spmm-n50": ("mult_dense", 50, None, float("inf")),
    "microblock-spmm-n52": ("mult_dense", 52, None, float("inf")),
    "csr-spmm": ("mult_dense", 50, None, 0.0),
    "csr-spmv": ("mult_vec", None, 0.0, None),
    "csr-spmv-t": ("mult_vec_t", None, 0.0, None),
    "microblock-spmv": ("mult_vec", None, float("inf"), None),
    "microblock-spmv-t": ("mult_vec_t", None, float("inf"), None),
}


@pytest.fixture(autouse=True)
def recording_off():
    tracing.disable()
    yield
    tracing.disable()


def _route(monkeypatch, route):
    method, n, spmv_x, spmm_x = ROUTES[route]
    monkeypatch.setattr(cuda_k, "_DENSIFY_CROSSOVER", ((1, 2.0),))  # never dense
    if spmv_x is not None:
        monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", spmv_x)
    if spmm_x is not None:
        monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", ((1, spmm_x),))
    return method, n


def _matrix(seed=5):
    a = random_matrix(260, 390, 0.04, seed=seed)
    return CSR(a.shape[0], a.shape[1], a.nnz, torch.from_numpy(a.indptr),
               torch.from_numpy(a.indices), torch.from_numpy(a.data), device="cpu")


def _operand(c, method, n, seed=0, layout="plain"):
    """The operand of ``method`` (B ``n`` wide), contiguous (``plain``),
    one float off a 16 B boundary (``misaligned``) or a strided view."""
    shape = (c.ncols, n) if n else ((c.nrows,) if method == "mult_vec_t" else (c.ncols,))
    v = torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, shape)
                         .astype(np.float32))
    if layout == "misaligned":
        out = torch.empty(v.numel() + 1)[1:].view(shape).copy_(v)
        assert out.data_ptr() % 16 == 4
        return out
    if layout == "strided":
        wide = torch.zeros(*shape[:-1], 2 * shape[-1])
        out = wide[..., ::2]
        out.copy_(v)
        return out
    return v


def _counted(c, method, v):
    """``method`` of ``c`` on ``v`` and the plan counters it moved."""
    rec = tracing.enable()
    rec.reset()
    out = getattr(c, method)(v)
    counters = {k: n for k, n in rec.snapshot()["counters"].items()
                if k.startswith("plan.")}
    tracing.disable()
    return out, counters


def _edit_values(c, v, method, n):
    c.values.mul_(2)
    return v, "stale"


def _sort_rows(c, v, method, n):
    c.sort_rows()
    return v, "stale"


def _normalize(c, v, method, n):
    c.normalize_rows("center")
    return v, "stale"


def _rebind_values(c, v, method, n):
    c.values = c.values * 1.5
    return v, "stale"


def _new_n(c, v, method, n):
    return _operand(c, method, n + 1, seed=3), "key"


def _misaligned(c, v, method, n):
    return _operand(c, method, n, seed=4, layout="misaligned"), "key"


def _strided(c, v, method, n):
    return _operand(c, method, n, seed=5, layout="strided"), "key"


def _settings(c, v, method, n):
    """A route setting moved after the plan was made: the micro-block
    routes stay, the CSR-form ones go to the micro-block kernel.  (The
    test's monkeypatch of the same setting puts it back.)"""
    if n:
        cuda_k._SPMM_CSR_CROSSOVER = ((1, 1e9),)
    else:
        cuda_k._CSR_CROSSOVER = 1e9
    return v, "stale"


#: perturbation -> what it does, returning the next operand and the reason
#: the next call misses its plan; that call builds a new one
PERTURB = {"values.mul_": _edit_values, "sort_rows": _sort_rows,
           "normalize_rows": _normalize, "rebind values": _rebind_values,
           "new n": _new_n, "misaligned": _misaligned, "strided": _strided,
           "route setting": _settings}


@pytest.mark.parametrize("route,perturb", [
    (route, perturb) for route in ROUTES
    for perturb in [*PERTURB, "f64", "torch kernel"]
    if perturb != "new n" or ROUTES[route][1]])  # a vector has no width
def test_a_hit_is_the_general_path(route, perturb, monkeypatch):
    method, n = _route(monkeypatch, route)
    c = _matrix()
    v = _operand(c, method, n)
    taken = cuda_k._spmm_route(c, n) if n else cuda_k._spmv_route(c, method == "mult_vec_t")
    assert taken == ("csr" if route.startswith("csr") else "kernel" if n else "microblock")
    with kernels.use_kernel("cuda"):
        first, counted = _counted(c, method, v)
        assert counted == {"plan.miss.key": 1, "plan.build": 1}
        hit, counted = _counted(c, method, v)
        assert counted == {"plan.hit": 1}
        assert torch.equal(hit, first) and hit.data_ptr() != first.data_ptr()
        if perturb in PERTURB:
            w, reason = PERTURB[perturb](c, v, method, n)
            general, counted = _counted(c, method, w)
            assert counted == {f"plan.miss.{reason}": 1, "plan.build": 1}
            again, counted = _counted(c, method, w)
            assert counted == {"plan.hit": 1}
            assert torch.equal(again, general)
            want = _matrix_now(c, method, w)
        else:  # no plan for these; the kernel's plan stays
            if perturb == "f64":
                w = v.double()
                general, counted = _counted(c, method, w)
                assert general.dtype == torch.float64
            else:
                w = v
                with kernels.use_kernel("torch"):
                    general, counted = _counted(c, method, w)
            assert counted == {"plan.miss.key": 1}
            want = _matrix_now(c, method, w)
            again, counted = _counted(c, method, v)
            assert counted == {"plan.hit": 1} and torch.equal(again, first)
    np.testing.assert_allclose(general.double().numpy(), want, rtol=1e-5, atol=1e-5)


def _planned(c) -> set:
    """The methods whose product plans ``c`` keeps."""
    return {k[1] for k in kept(c) if k[0] == "plan"}


def _matrix_now(c, method, v):
    """``method`` of ``c`` as it is now, in f64 by scipy."""
    a = c.to_scipy().astype(np.float64)
    v = v.double().numpy()
    return a.T @ v if method == "mult_vec_t" else a @ v


def _plan_counters(rec, reset=False):
    return {k: v for k, v in rec.snapshot(reset)["counters"].items()
            if k.startswith("plan.")}


@pytest.mark.parametrize("method", ["mult_vec", "mult_vec_t"])
def test_no_plan_under_vmap(method):
    """A vmapped SpMV (the backend's SpMM on the batch) neither builds nor
    takes a plan, before and after a plain call has built one."""
    c = _matrix()
    v = _operand(c, method, None)
    batch = torch.stack([v, 2 * v])
    with kernels.use_kernel("cuda"):
        rec = tracing.enable()
        for _ in range(2):
            ys = torch.func.vmap(lambda x: getattr(c, method)(x))(batch)
        assert _planned(c) == set()
        y = getattr(c, method)(v)  # builds one
        again = torch.func.vmap(lambda x: getattr(c, method)(x))(batch)
        assert _plan_counters(rec) == {"plan.miss.transform": 3, "plan.miss.key": 1,
                                       "plan.build": 1}
    assert torch.equal(again, ys)
    np.testing.assert_allclose(ys[1].numpy(), 2 * y.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["mult_vec", "mult_vec_t", "mult_dense"])
def test_no_plan_for_row_shards(method, monkeypatch):
    """Past ``max_nnz`` the row shards run the general path, a plan made
    before the limit shrank included, and no plan is kept on the matrix
    or its shards."""
    c = _matrix()
    v = _operand(c, method, 6 if method == "mult_dense" else None)
    with kernels.use_kernel("cuda"):
        getattr(c, method)(v)  # a plan, under the limit
        rec = tracing.enable()
        monkeypatch.setattr(cuda_k, "max_nnz", c.nnz // 3)
        got = [getattr(c, method)(v)]
        sharded = _matrix()
        got += [getattr(sharded, method)(v) for _ in range(2)]
        assert _plan_counters(rec) == {"plan.miss.key": 3}
        assert _planned(sharded) == set()
        assert all(_planned(s) == set() for s in sharded._shard_rows(cuda_k.max_nnz))
    for y in got:
        np.testing.assert_allclose(y.numpy(), _matrix_now(c, method, v),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["mult_vec", "mult_vec_t", "mult_dense"])
def test_grad_refusal_is_unchanged(method):
    c = _matrix()
    n = 4 if method == "mult_dense" else None
    v = _operand(c, method, n)
    with kernels.use_kernel("cuda"):
        getattr(c, method)(v)  # a plan for v's key
        for operand in (v.clone().requires_grad_(), v):
            if operand is v:
                c.values.requires_grad_()
            for _ in range(2):
                with pytest.raises(ValueError, match="no backward"):
                    getattr(c, method)(operand)
        with torch.no_grad():
            assert torch.equal(getattr(c, method)(v), getattr(c, method)(v))


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_hit_emits_the_events_and_holds_no_operand(route, monkeypatch):
    method, n = _route(monkeypatch, route)
    c = _matrix()
    with kernels.use_kernel("cuda"):  # the forms, by a call of another operand key
        getattr(c, method)(_operand(c, method, n, layout="strided"))
    seen = []

    def listen(event, fields):
        seen.append((event, fields))

    rec = tracing.enable()
    kernels._listeners.append(listen)
    try:
        v = _operand(c, method, n)
        with kernels.use_kernel("cuda"):
            out = getattr(c, method)(v)
            first = list(seen)
            seen.clear()
            again = getattr(c, method)(v)
    finally:
        kernels._listeners.remove(listen)
    assert seen == first
    assert [e for e, _ in first] == ["to_handle", *(["mult_dense"] if n else []),
                                     "release_handle"]
    counters = rec.snapshot()["counters"]
    assert counters["plan.build"] == 1 and counters["plan.hit"] == 1
    assert torch.equal(out, again)
    refs = [weakref.ref(t) for t in (v, out, again)]
    del v, out, again
    gc.collect()
    assert [r() for r in refs] == [None] * 3


#: route -> the form its plan's launch reads (of the transpose's CSR
#: tensors, a tuple, the test follows the columns)
FORM = {"microblock-spmm-n50": "layout", "microblock-spmm-n52": "layout",
        "csr-spmm": "spmm_edges", "csr-spmv": "spmv_edges", "csr-spmv-t": "csr_t",
        "microblock-spmv": "layout", "microblock-spmv-t": "layout_t"}
#: method -> another one, whose call follows the perturbation
OTHER = {"mult_vec": "mult_vec_t", "mult_vec_t": "mult_vec", "mult_dense": "mult_vec"}
#: perturbations that leave a plan stale -> whether they rebind the values
STALE = {"values.mul_": False, "rebind values": True, "fill_values": True}


def _make_stale(c, perturb):
    if perturb == "values.mul_":
        c.values.mul_(2)
    elif perturb == "rebind values":
        c.values = c.values * 1.5
    else:
        c.fill_values(0.5)


@pytest.mark.parametrize("route,perturb", [(r, p) for r in ROUTES for p in STALE])
def test_a_stale_plan_frees_its_forms(route, perturb, monkeypatch):
    """Once the values are edited in place or rebound, one call of another
    method frees the plan with the form it read and the values it was made
    from: a plan never outlives them."""
    method, n = _route(monkeypatch, route)
    c = _matrix()
    with kernels.use_kernel("cuda"):
        getattr(c, method)(_operand(c, method, n))
        assert _planned(c) == {method}
        form = kept(c, FORM[route])
        refs = [weakref.ref(form[1] if isinstance(form, tuple) else form)]  # csr_t's columns
        del form
        if STALE[perturb]:
            refs.append(weakref.ref(c.values))
        _make_stale(c, perturb)
        other = OTHER[method]
        y = getattr(c, other)(_operand(c, other, None, seed=1))
    gc.collect()
    assert [r() for r in refs] == [None] * len(refs)
    assert _planned(c) == {other}
    np.testing.assert_allclose(y.double().numpy(),
                               _matrix_now(c, other, _operand(c, other, None, seed=1)),
                               rtol=1e-5, atol=1e-5)


def test_drop_cache_drops_the_plans():
    c = _matrix()
    v = torch.ones(c.ncols)
    k = kernels.get_kernel("cuda")
    with kernels.use_kernel("cuda"):
        c.mult_vec(v)
        assert _planned(c) == {"mult_vec"}
        k.release_handle(k.to_handle(c), drop_cache=True)
    assert kept(c) == {}


def test_spgemm_keeps_no_plan(monkeypatch):
    monkeypatch.setattr(spgemm, "max_dense_bytes", 1 << 30)
    c = _matrix()
    with kernels.use_kernel("cuda"):
        c.multiply(c, transpose=True)
    assert _planned(c) == set()


@pytest.fixture
def fake_entries(monkeypatch):
    """The launches' host side on the CPU: each kernel entry records its
    arguments instead of launching; the stream is a number."""
    from csr_tpu_torch.ops import _cuda, spmv

    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn, "csr.launch." + name

    monkeypatch.setattr(_cuda, "entry", entry)
    monkeypatch.setattr(_cuda, "_LAUNCH", {}, raising=False)
    monkeypatch.setattr(_cuda, "library", lambda name: _cuda._LAUNCH.setdefault(
        name, entry(name)))
    monkeypatch.setattr(_cuda, "call_on", lambda index, kernel, *args: _cuda.call(kernel, *args))
    monkeypatch.setattr(_cuda, "stream", lambda index: 77)
    monkeypatch.setattr(spmv, "_sm_count", lambda dev: 2)
    return calls


@pytest.mark.parametrize("launch", ["spmv", "spmv_csr", "spmm-n50", "spmm-n52", "spmm_csr",
                                    "spmm-view"])
def test_launches_pass_their_entries_arguments(launch, fake_entries):
    """Each wrapper's bound launch hands its kernel entry as many
    arguments as ``ops/_cuda.py:ENTRIES`` declares, of their types, with
    the matrix's side where ``ENTRIES`` puts it: its pointers (the CSR
    form's row pointers, edges, columns and values), sizes, the
    micro-block SpMM's group order (none in a view made without one)
    and, for the CSR-form SpMM, ``csr_plan``'s load width and lanes and
    no panels."""
    import ctypes
    import dataclasses

    from csr_tpu_torch.ops import _cuda, microblock as mb, spmm, spmv

    c = _matrix()
    n = {"spmm-n50": 50, "spmm-n52": 52, "spmm-view": 50}.get(
        launch, 3 if launch == "spmm_csr" else None)
    v = _operand(c, "mult_dense" if n else "mult_vec", n)
    rp, ci, vs = c.rowptrs, c.colinds.to(torch.int32), c.values.float()
    if launch in ("spmv", "spmm-n50", "spmm-n52", "spmm-view"):
        layout = mb.build_microblocks_host(c.nrows, c.ncols, *c.host_arrays(), device="cpu")
        if launch == "spmm-view":
            layout = dataclasses.replace(layout, order=None)
        run = (spmv.spmv_launch(layout, v) if launch == "spmv"
               else spmm.spmm_launch(layout, v))
        name = "spmv_microblock" if launch == "spmv" else "spmm_microblock"
        want = {0: layout.vals.data_ptr(), 1: layout.meta.data_ptr(), 2: layout.rbcb.data_ptr()}
        if launch != "spmv":  # the groups' order, or none: the packer's
            want[3] = None if layout.order is None else layout.order.data_ptr()
    else:  # rowptrs, ptr64, edges, search, colinds, values: both kernels
        tile = spmv.CSR_TILE if launch == "spmv_csr" else spmm.CSR_TILE
        edges = spmv.csr_shares(rp, c.nnz, tile)[0]
        want = {0: rp.data_ptr(), 1: int(rp.dtype == torch.int64), 2: edges.data_ptr(),
                3: 0, 4: ci.data_ptr(), 5: vs.data_ptr()}
        if launch == "spmv_csr":
            run, name = spmv.spmv_csr_launch(rp, ci, vs, edges, v), "spmv_csr"
            # nrows, nnz, zeroed; the blocks' slots (two SMs)
            want.update({8: c.nrows, 9: c.nnz, 10: 1, 13: spmv.MAX_BLOCKS_PER_SM * 2})
        else:
            run, name = spmm.spmm_csr_launch(rp, ci, vs, edges, v), "spmm_csr"
            width, lanes = spmm.csr_plan(n, v.stride(0), v.data_ptr() & -v.data_ptr())
            # ldb, n, nrows, nnz; width, lanes; one pass (no panels)
            want.update({7: v.stride(0), 9: n, 10: c.nrows, 11: c.nnz, 14: width,
                         15: lanes, 16: 0, 17: None, 18: None})
    out = run(v)
    (got_name, args), = fake_entries
    assert got_name == name and len(args) == len(_cuda.ENTRIES[name])
    for arg, kind in zip(args, _cuda.ENTRIES[name]):
        assert arg is None or isinstance(arg, int), (arg, kind)
        if kind is not ctypes.c_void_p:
            assert arg is not None
    assert {i: args[i] for i in want} == want
    assert args[-1] == 77 and out.dtype == torch.float32
    if launch.startswith("spmm-"):  # B's rows padded to a multiple of 4 floats
        assert args[10] == 52
    if launch.endswith("_csr"):  # with no edges: room for them past the scratch
        bind = spmv.spmv_csr_launch if launch == "spmv_csr" else spmm.spmm_csr_launch
        bind(rp, ci, vs, None, v)(v)
        (_, args), = fake_entries[1:]
        carry, carry_row = (args[11], args[12]) if launch == "spmv_csr" else args[12:14]
        assert args[3] == 1 and args[2] % 8 == 0 and args[2] > max(carry, carry_row)


def test_threads_share_a_matrix_and_its_plans():
    """More threads than cores, with a short switch interval, each calling
    all three products of one matrix with operands of two keys in turn
    (each call may replace a plan another thread is about to take): every
    result is the general path's."""
    import sys
    import threading

    c = _matrix()
    ops = [(method, _operand(c, method, n, layout=layout))
           for method, n in (("mult_vec", None), ("mult_vec_t", None), ("mult_dense", 5))
           for layout in ("plain", "strided")]
    with kernels.use_kernel("cuda"):
        want = [getattr(c, m)(v) for m, v in ops]
    bad, rounds = [], 30
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            with kernels.use_kernel("cuda"):
                for r in range(rounds):
                    i = (k + r) % len(ops)
                    m, v = ops[i]
                    if not torch.equal(getattr(c, m)(v), want[i]):
                        bad.append((k, r))
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert bad == []
    assert _planned(c) == {"mult_vec", "mult_vec_t", "mult_dense"}
