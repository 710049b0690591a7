"""
The package's instrumentation: events, spans and counters, one system.

**Events.**  :func:`trace` reports what the kernels do: a handle's life
(``to_handle``, ``release_handle``), the route of each product (an
event named for the product, ``mult_vec``, ``mult_vec_t``,
``mult_dense`` or ``spgemm``, whose ``route`` field names it), each
layout or transpose built (``layout-build*``) and ESC's terms, chunks
and key width (``esc``).  Every event goes to the callables in :data:`_listeners`
(``f(event, fields)``), always, and to the ``csr_tpu_torch.trace`` log
when the ``CSR_TPU_TRACE`` environment variable is set.

**Spans and counters.**  ``with span(name):`` (or a function decorated
``@spanned(name)``) marks a layer of a call, and :func:`count` adds to a
counter where the work happens.  Until :func:`enable`, a site reads one
flag (``span`` then returns a shared object that does nothing) and a
counter site returns: nothing is allocated, timed, recorded or handed
to the profiler.  Once
enabled, each span records its name, start and end
(``time.perf_counter_ns``), the span it sits in and the id of the
outermost one (one public call); while ``torch.profiler`` records, it
also enters a profiler range of its own name, so the span lies on the
device trace's clock.  The enabled recorder listens to the events too,
and counts them.  :func:`snapshot` gives the spans by name (count, total
and self nanoseconds, self being the total less the time of the spans
inside it), the counters, and the first :data:`SPAN_LIMIT` spans
themselves, the rest counted as dropped.

Spans, from a public call down:

* ``csr.api.<method>``: ``CSR.mult_vec``, ``mult_vec_t``, ``mult_dense``
  and ``multiply`` (the kernel registry, the operand's placement and
  checks, the handles);
* ``csr.backend.<op>``: the ``cuda`` backend's ``mult_vec``,
  ``mult_vec_t``, ``mult_dense``, ``mult_ab`` and ``mult_abt`` (the
  grad refusal, the route and the cache look-ups), entered by a product
  call only where it takes the general path, not its plan
  (:mod:`csr_tpu_torch._plan`);
* ``csr.op.<wrapper>``: the kernel wrappers ``spmv``, ``spmv_large``,
  ``spmv_csr``, ``spmm``, ``spmm_large`` and ``spmm_csr`` (operand
  checks, allocation, B's padded copy); on the card a plan's hit
  launches from ``csr.api`` with no wrapper span;
* ``csr.launch.<kernel>``: a kernel's launch through ``ctypes``;
* ``csr.build.<form>``: a form the ``cuda`` backend builds and caches on
  the matrix: the micro-block layouts (``layout``, ``layout_t``, and
  ``large``, ``large_t`` in chunks and panels), the transpose's CSR
  tensors (``csr_t``), the CSR-form kernels' share edges
  (``spmv_edges``, ``spmv_edges_t``, ``spmm_edges``, ``spmm_edges_t``),
  the CSR-form SpMM's column panels (``spmm_panels``: the rows' order
  checked and the panels' metadata built) and the route statistic
  (``stat``);
* ``csr.esc.plan``, ``csr.esc.expand``, ``csr.esc.compress`` and
  ``csr.structure.transpose``: ESC's host plan and its two halves, and
  the transpose of B that ``A @ B^T`` makes;
* ``csr.construct.from_coo``: ``CSR.from_coo``, its read of the triples
  to the host, the native conversion and the upload.

Counters: ``host_reads``, each read of a tensor to the host that waits
for the card (``.cpu()``, ``int(t)``, ``.tolist()``, a boolean mask's
gather, ``torch.unique``); ``form_builds.<form>``, each form built;
``plan.hit``, ``plan.miss.<reason>`` and ``plan.build``, each product
call's plan look-up and each plan kept (:mod:`csr_tpu_torch._plan`);
``csr.edges.shares``, ``csr.edges.rows_cut`` and
``csr.edges.rows_spanning``, the split of each set of CSR-form share
edges built (its shares, the rows a share edge cuts, the rows over
three shares or more: ``kernels/cuda.py:_build_edges``), set-up figures
that a cached split never counts again; ``csr.spmm.panels``, the column
panels each CSR-form SpMM ran in, counted only where it ran in two or
more (``ops/spmm.py:spmm_csr``); and from the events,
``route.<event>.<route>``, ``event.layout-build*`` (the panels' build is
``event.layout-build-panels``), ``esc.terms`` and ``esc.chunks``; and
``esc.keys32`` and ``esc.keys64``, each ESC chunk by the width of its
sort key (``ops/spgemm.py:_esc_rows``; the ``esc`` event's ``key_bits``
is the widest of a call).
"""

from __future__ import annotations

import functools
import itertools
import logging
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["count", "disable", "enable", "recording", "snapshot", "span", "spanned",
           "trace"]

_TRACE = bool(os.environ.get("CSR_TPU_TRACE"))
_trace_log = logging.getLogger("csr_tpu_torch.trace")
if _TRACE and not _trace_log.handlers:  # pragma: no cover - env-dependent
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("csr-tpu-torch-trace: %(message)s"))
    _trace_log.addHandler(_h)
    _trace_log.setLevel(logging.INFO)

#: registered event listeners (callables ``f(event, fields)``), always
#: dispatched, whether or not CSR_TPU_TRACE is set
_listeners: list = []


def trace(event: str, **fields):
    """Dispatch an event to the registered listeners, and log it when
    ``CSR_TPU_TRACE`` is set."""
    for listener in _listeners:
        listener(event, fields)
    if _TRACE:
        _trace_log.info(
            "%s %s", event, " ".join(f"{k}={v}" for k, v in fields.items())
        )


#: spans a recorder keeps one by one (a small tuple each); later ones
#: only add to the sums
SPAN_LIMIT = 1 << 16

#: a profiler range that costs little when entered: the fast form where
#: this build of torch has it
_range = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.profiler.record_function)


class SpanRecord(NamedTuple):
    """One finished span: ``parent`` is the id of the span it sat in (0
    for none), ``call`` the id of the outermost span around it."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    call: int


class _Off:
    """The span of a site while recording is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "call", "child_ns", "range", "start")

    def __init__(self, rec: "Recorder", name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        try:
            stack = rec._local.stack
        except AttributeError:
            stack = rec._local.stack = []
        parent = stack[-1] if stack else None
        self.id = next(rec._ids)
        self.parent = parent
        self.call = self.id if parent is None else parent.call
        self.child_ns = 0
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _range(self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self.rec
        rec._local.stack.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        total = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += total
        with rec._lock:
            agg = rec.spans.get(self.name)
            if agg is None:
                agg = rec.spans[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += total
            agg[2] += total - self.child_ns
            if len(rec.records) < SPAN_LIMIT:
                rec.records.append((self.name, self.start, end, self.id,
                                    0 if parent is None else parent.id, self.call))
            else:
                rec.dropped += 1
        return False


class Recorder:
    """What :func:`enable` records: spans by name, counters, and the
    first :data:`SPAN_LIMIT` spans one by one.  It is also an event
    listener."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)  # next() is atomic under the GIL
        self.reset()

    def reset(self):
        with self._lock:
            self.spans = {}  # name -> [count, total ns, self ns]
            self.counters = {}
            self.records = []  # SpanRecord fields, as plain tuples
            self.dropped = 0

    def add(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def __call__(self, event: str, fields: dict):
        # the routes, layout builds and ESC's work; a handle's events,
        # two a call, are left to the listeners that want them
        route = fields.get("route")
        if route is not None:
            self.add(f"route.{event}.{route}")
        elif event == "esc":
            self.add("esc.terms", int(fields.get("terms", 0)))
            self.add("esc.chunks", int(fields.get("chunks", 0)))
        elif event.startswith("layout-build"):
            self.add("event." + event)

    def snapshot(self, reset: bool = False) -> dict:
        with self._lock:
            out = {"spans": {k: {"count": c, "total_ns": t, "self_ns": s}
                             for k, (c, t, s) in self.spans.items()},
                   "counters": dict(self.counters),
                   "records": [SpanRecord._make(r) for r in self.records],
                   "dropped": self.dropped}
        if reset:
            self.reset()
        return out


#: the recorder while recording is on, else None
_recorder: Recorder | None = None


def span(name: str):
    """A context manager around a layer of a call (see the module's
    docstring for the names); it does nothing while recording is off."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(rec, name)


def spanned(name: str):
    """A decorator: each call of the function is a span named ``name``
    (while recording is off, one flag read before the call)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _recorder
            if rec is None:
                return fn(*args, **kwargs)
            with _Span(rec, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def recording() -> bool:
    """Whether recording is on: a site whose counters cost work of their
    own to compute does it only then."""
    return _recorder is not None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording is on."""
    rec = _recorder
    if rec is not None:
        rec.add(name, n)


def enable() -> Recorder:
    """Turn recording on (a fresh recorder, listening to the events),
    unless it is on already; returns the recorder."""
    global _recorder
    if _recorder is None:
        rec = Recorder()
        _listeners.append(rec)
        _recorder = rec
    return _recorder


def disable() -> Recorder | None:
    """Turn recording off; returns the recorder that was on, if any,
    with what it recorded."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is not None:
        _listeners.remove(rec)
    return rec


def snapshot(reset: bool = False) -> dict:
    """What the recorder holds (:meth:`Recorder.snapshot`): ``spans`` by
    name (``count``, ``total_ns``, ``self_ns``), ``counters``,
    ``records`` (:class:`SpanRecord`) and ``dropped``; with ``reset`` it
    starts afresh.  Empty while recording is off."""
    rec = _recorder
    if rec is None:
        return {"spans": {}, "counters": {}, "records": [], "dropped": 0}
    return rec.snapshot(reset)
