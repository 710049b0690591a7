"""
What a matrix keeps that is valid only while its three tensors stand:
one set of forms (``CSR._forms``), by key, and the stamp it was made at.

The stamp is the identity of ``rowptrs``, ``colinds`` and ``values`` and
their version counters (:meth:`CSR._versions`): an op that rebinds a
tensor and an in-place edit (``values.mul_(2)``) alike move it.  Where
the stamp has moved, :func:`forms` puts an empty set in place of the
old one, by one attribute write, so no form outlives the tensors it was
made from.  Two threads at worst build a form twice.

The keys are the names of the forms' spans and counters:

* ``layout``, ``layout_t``, ``large``, ``large_t`` (the micro-block
  layouts, one or in chunks and panels), ``csr_t`` (the transpose's CSR
  tensors), ``spmv_edges``, ``spmv_edges_t``, ``spmm_edges``,
  ``spmm_edges_t`` (the CSR-form kernels' share edges): built by the
  ``cuda`` backend through :func:`cached`;
* ``("stat", transpose, windows)``, the route statistic, and
  ``("spmm_panels", transpose, k)``, the CSR-form SpMM's column panels
  (with ``("in_order", transpose)``, the rows' order they need), built
  under ``csr.build.stat`` and ``csr.build.spmm_panels``;
* ``("shards", tgt_nnz)``, the row shards of ``CSR._shard_rows``;
* ``host``, the kept host copies of the three tensors;
* ``("plan", method)``, a product plan (:mod:`csr_tpu_torch._plan`).
"""

from __future__ import annotations

from .tracing import count, span

#: a key absent from a set (a form may be None)
_ABSENT = object()


class Forms(dict):
    """A matrix's kept forms, by key, and the stamp they were made at."""

    __slots__ = ("rowptrs", "colinds", "values", "versions")

    def __init__(self, csr, versions: tuple | None = None):
        super().__init__()
        self.rowptrs, self.colinds, self.values = csr.rowptrs, csr.colinds, csr._values
        self.versions = csr._versions() if versions is None else versions

    def fresh(self, csr, versions: tuple | None = None) -> bool:
        """Whether ``csr``'s tensors are those the set was made from, at
        the same versions (``versions``: ``csr._versions()`` where the
        caller has read it)."""
        return (self.rowptrs is csr.rowptrs and self.colinds is csr.colinds
                and self.values is csr._values
                and self.versions == (csr._versions() if versions is None else versions))


def forms(csr, versions: tuple | None = None) -> Forms:
    """The current set of ``csr``'s forms, an empty one put in place
    where the stamp has moved.  ``versions`` is ``csr._versions()`` where
    the caller has read it for several look-ups."""
    if versions is None:
        versions = csr._versions()
    f = csr._forms
    if f is None or not f.fresh(csr, versions):
        f = csr._forms = Forms(csr, versions)
    return f


def cached(csr, key, build, versions: tuple | None = None):
    """Form ``key`` of ``csr``, made by ``build()`` where the current set
    lacks it: in the span ``csr.build.<name>``, counted in
    ``form_builds.<name>``, the name being the key or its first member."""
    f = forms(csr, versions)
    form = f.get(key, _ABSENT)
    if form is _ABSENT:
        name = key if isinstance(key, str) else key[0]
        with span("csr.build." + name):
            form = build()
        count("form_builds." + name)
        f[key] = form
    return form


def drop(csr) -> None:
    """Forget every form of ``csr``."""
    csr._forms = None
