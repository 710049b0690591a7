"""
CUDA kernel backend, the tuned backend (counterpart of
:mod:`csr_tpu.kernels.pallas`).

``to_handle`` returns a handle whose micro-block layouts (of the matrix
and of its transpose) are packed on the host at first use and cached on
the matrix.  SpMV in both directions runs the hand-written kernel behind
:func:`csr_tpu_torch.ops.spmv.spmv`, or, where the layout would be mostly
padding, the one behind :func:`csr_tpu_torch.ops.spmv.spmv_csr` on the
matrix's own CSR tensors; SpMM (``mult_dense``) and the sparse leg of
SpGEMM (``mult_ab``, ``mult_abt``) run the one behind
:func:`csr_tpu_torch.ops.spmm.spmm`, or, likewise, the one behind
:func:`csr_tpu_torch.ops.spmm.spmm_csr`.  On a CPU matrix each wrapper
runs its kernel's plain PyTorch version.

Every cached form (layouts, the transpose's CSR tensors, share edges,
column panels, the route statistic) lies in the matrix's one set of
forms (:mod:`csr_tpu_torch._forms`), and the handle's torch handle and
dense form in a set of the handle's own, each stamped with the identity
of the matrix's three tensors and their version counters, so an op that
rebinds them and an in-place edit (``values.mul_(2)``) alike make it
stale.

Routing, as in the JAX package, decided from shapes and dtypes before
any launch (and from the structure's micro-row count):

* ``nnz == 0`` returns zeros;
* f64 values or operands go to the ``torch`` backend, as the JAX package
  routes f64 away from its kernel.  A kernel templated on f64 is ROADMAP
  Queue 1 item 7;
* f32 SpMV of a matrix (or, for ``mult_vec_t``, a transpose) whose
  (256, 1) micro-block layout would cost more than
  :data:`_CSR_CROSSOVER` device bytes a stored entry
  (:data:`_CSR_CROSSOVER_LARGE` past the packer's range) runs the CSR-form
  kernel ``ops/spmv.py:spmv_csr`` (:func:`_spmv_route` says ``"csr"``):
  one call whatever the size (the kernel and its carry pass), on the
  matrix's own tensors, and the rows at its share edges cached, with no
  layout built; for ``mult_vec_t`` on the transpose's CSR tensors, made
  once by the native host transpose and cached on the matrix (a
  ``layout-build-csr`` trace event).  The statistic is the layout's
  micro-row count, taken with torch ops on the matrix's device by chunks
  of about :data:`_STAT_CHUNK` entries (:func:`_microrows`; per panel
  past the packing range) and cached.  The crossover was measured on the
  H100 (chip_smoke phase 21, PERF.md).  Under a ``torch.func`` transform
  the same route's vmap rule runs: one ``spmm_csr`` launch a batch;
* other SpMV of a matrix (or a transpose) of more than
  :data:`_LARGE_WINDOWS` row windows, or outside the packing range,
  runs ``ops/spmv.py:spmv_large``: chunks of :data:`_LARGE_WINDOWS` row
  windows and panels of as many column windows, the SpMV kernel once a
  panel (``"large"``).  The layouts are cached on the matrix as the
  others are.  The rest runs the micro-block kernel on one layout
  (``"microblock"``);
* SpMM of a matrix whose dense f32 form fits the dense budget of
  :mod:`csr_tpu_torch.ops.spgemm` and whose density is at least
  :func:`_min_density` of B's width is a densified f32 ``torch.matmul``
  with TF32 off (the JAX package's ``Precision.HIGHEST`` product, which
  it leaves to XLA); the threshold was measured on the H100 (PERF.md).
  Other f32 SpMM of a matrix whose layout would cost more than
  :func:`_spmm_crossover` bytes a stored entry at B's width runs the
  CSR-form kernel ``ops/spmm.py:spmm_csr`` on the matrix's own tensors
  (:func:`_spmm_route` says ``"csr"``), one call whatever the size, in
  column panels where :func:`spmm_panel_count` finds B larger than a slab of
  the card's L2 and the rows long (:func:`_spmm_panels`); the
  rest runs the micro-block SpMM kernel, once a chunk and panel
  (``ops/spmm.py:spmm_large``) past :func:`_needs_large`'s limit.  No
  f32 SpMM runs the ``torch`` backend;
* SpGEMM densifies B (or B^T) within the budget of
  :mod:`csr_tpu_torch.ops.spgemm` and multiplies A by it as SpMM does;
  past that budget it runs that module's expand-sort-compress (ESC).

SpMV in either direction goes through
:func:`csr_tpu_torch.ops.spmv.product`, so ``torch.func.vmap`` over the
operand runs SpMM on the batch: one SpMM launch a layout, or one
CSR-form SpMM.  No product has a backward: ``mult_vec``, ``mult_vec_t``
and ``mult_dense`` raise ValueError when grad mode is on and the operand
or the values require grad, on the CPU and on the card alike (the
``torch`` backend differentiates).

Each SpMM or SpGEMM emits a ``mult_dense`` or ``spgemm`` trace event
whose ``route`` is ``zeros``, ``torch`` (f64), ``dense``, ``csr``,
``kernel`` (the micro-block kernel, one layout or its chunks and panels)
or (SpGEMM only) ``esc``.

A ``mult_vec``, ``mult_vec_t`` or ``mult_dense`` of an f32 operand
outside a ``torch.func`` transform whose route is one launch on a cached
form (the micro-block SpMV or SpMM on one layout, the CSR-form SpMV
either way, the CSR-form SpMM on the matrix's own tensors) leaves its
product plan on the handle (``CudaHandle.plan``: the wrapper's launch
with the form's side bound, :mod:`csr_tpu_torch._plan`), which the API
keeps on the matrix: the next call with such an operand goes from the
API to the launch.  The other routes keep none.
"""

from __future__ import annotations

import numpy as np
import torch

from csr_tpu_torch import _forms, _plan, native
from csr_tpu_torch.dtypes import ptr_dtype
from csr_tpu_torch.kernels import torch as _torch_k
from csr_tpu_torch.kernels import trace
from csr_tpu_torch.ops import microblock
from csr_tpu_torch.ops import spgemm as _spgemm_op
from csr_tpu_torch.ops import spmm as _spmm_op
from csr_tpu_torch.ops import spmv as _spmv_op
from csr_tpu_torch.tracing import count, listening, recording, spanned

# Per-operation capacity, from the card's memory: an H100 holds 80 GB.  A
# layout costs 6 B per padded slot, 12 B per stored entry at fill 0.5.  A
# matrix with both layouts cached also holds its CSR tensors (8 B per
# entry): about 32 B per entry all told, so 2.5G entries fill the card.
# Cap one operation at 2^30 entries (~34 GB), which leaves room for a
# second matrix, the operands and PyTorch's allocator.
max_nnz = 1 << 30


#: the large path's budget, in 128-wide windows: SpMV of a matrix of more
#: row windows (or one outside the packing range) runs ``spmv_large`` on
#: chunks of this many row windows and panels of this many column
#: windows.  At the packer's row range, routing is that of every matrix
#: the packer takes, and no chunk leaves it.
_LARGE_WINDOWS = microblock.MAX_RB


def _needs_large(nrows: int, ncols: int) -> bool:
    """Whether the micro-block kernels take an ``nrows x ncols`` matrix in
    chunks and panels (``spmv_large``, ``spmm_large``): past the window
    budget, or outside what the layout can address at the wider window
    (which :func:`microblock.choose_layout` picks wherever it can)."""
    return (-(-nrows // microblock.LANE) > _LARGE_WINDOWS
            or not microblock.in_range(nrows, ncols, 2 * microblock.LANE))


#: the CSR-form route: SpMV of a matrix (or, for ``mult_vec_t``, of its
#: transpose) whose micro-block layout at (256, 1) would cost more device
#: bytes a stored entry than this (:func:`_layout_bytes_per_entry`) runs
#: ``ops/spmv.py:spmv_csr`` on the matrix's own CSR tensors; the rest runs
#: the micro-block kernel.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
#: (chip_smoke.py phase 21, PERF.md) with the row-summing CSR-form kernel: the
#: micro-block kernel was the faster at every matrix that packs up to
#: 24.12 B an entry (131,072 rows, 8-13 a row over 4,096 columns and 64
#: and 96 over 2^16, 14.85-24.12 B: time ratios 0.59-0.81; the flagship
#: and the MovieLens-25M shape, both ways, 0.30-0.41), the CSR form from
#: 75.55 B on (2.4x at 327 a row over 2^20; 3.1-17x from 128.67 up); the
#: ratio, log-interpolated between 24.12 and 75.55, crosses 1 near 30.
_CSR_CROSSOVER = 30.0
#: the same point for a matrix past the packer's range, whose micro-block
#: form is ``spmv_large``'s chunks and panels (a launch each, a zeroed y,
#: seconds of host packing), measured as above at 4,300,000 x 4,096 with
#: 24, 16, 12 and 8 power-law entries a row: micro-block time / CSR-form
#: time 0.52 and 0.83 at 8.62 and 12.06 B an entry, 1.30 and 1.52 at 16.08
#: and 24.13 B (the realistic 8,388,608 x 2^20 case, 778.75 B, runs only
#: on the CSR form); the ratio, log-interpolated, crosses 1 near 14
_CSR_CROSSOVER_LARGE = 14.0
#: device bytes of one micro-row: 128 f32 values, 128 u16 metadata and
#: its i32 ``rbcb``
_MICROROW_BYTES = microblock.LANE * (4 + 2) + 4


#: entries a chunk of the route statistic takes (plus at most one 256-row
#: window of the matrix): :func:`_microrows` holds one chunk's temporaries
#: at a time (int32 rows and columns, int64 keys and the sort's), so its
#: peak does not grow with the matrix.  A window of more entries than this
#: (dense rows, a transpose's popular items) is a chunk of its own, counted
#: by slices of this many entries into one int64 count a key: ``ncols /
#: 256`` counts forward, ``ncols / 128`` for the transpose, whatever its
#: entries.  The first mult_vec of a matrix of 2^27 entries peaked at
#: 610.1 MiB of device memory, against 8,734.8 MiB when the statistic took
#: the whole matrix at once (an NVIDIA H100 80GB HBM3 at 700 W,
#: chip_smoke.py's phase_stat_memory)
_STAT_CHUNK = 1 << 23


def _stat_edges(rowptrs: torch.Tensor, period: int) -> list:
    """Row edges of :func:`_microrows`' chunks of about
    :data:`_STAT_CHUNK` entries: the starts of ``period``-row panels and,
    within each, starts of its own 256-row windows (counted from the
    panel's start), so no key of either direction crosses an edge.  A
    window of more than :data:`_STAT_CHUNK` entries is a chunk alone."""
    nrows = rowptrs.shape[0] - 1
    dev = rowptrs.device
    panels = torch.arange(0, nrows, period, device=dev)
    starts = (panels[:, None] + torch.arange(0, min(period, nrows), 256,
                                             device=dev)).flatten()
    starts = starts[starts < nrows]
    ends = torch.cat([starts[1:], starts.new_tensor([nrows])])
    at = rowptrs[starts].long()
    heavy = rowptrs[ends].long() - at > _STAT_CHUNK
    targets = torch.arange(_STAT_CHUNK, max(int(rowptrs[-1]), _STAT_CHUNK),
                           _STAT_CHUNK, device=dev)
    picks = starts[torch.searchsorted(at, targets, right=True) - 1]
    # the three boolean gathers, the entry count and the four lists
    count("host_reads", 8)
    return sorted({0, nrows, *panels.tolist(), *picks.tolist(),
                   *starts[heavy].tolist(), *ends[heavy].tolist()})


def _key_microrows(colinds, k0: int, k1: int, key, size: int) -> torch.Tensor:
    """Micro-rows of each of ``size`` keys over entries ``k0:k1`` (those
    of a heavy window, or of one stripe of it), ``key`` mapping int64
    columns to keys: counted by slices of :data:`_STAT_CHUNK` entries."""
    counts = torch.zeros(size, dtype=torch.int64, device=colinds.device)
    for k in range(k0, k1, _STAT_CHUNK):
        count("host_reads")  # bincount reads its input's largest key
        counts += torch.bincount(key(colinds[k : min(k + _STAT_CHUNK, k1)].long()),
                                 minlength=size)
    return -torch.div(-counts, microblock.SLOT_CAP, rounding_mode="floor")


def _microrows(csr, transpose: bool) -> int:
    """Micro-rows of the (256, 1) micro-block layout of ``csr`` (or of
    its transpose), or, past :func:`_needs_large`'s limit, of
    ``spmv_large``'s chunk and panel layouts together: on the matrix's
    device with torch ops, without the host planner's sort.  Entries are
    keyed by (stripe, 256-column window), a stripe being a 128-row window
    of one panel; each key holds ``ceil(count / SLOT_CAP)`` micro-rows, and
    each stripe's are padded to ``ACC_GROUP``.  Equals
    ``microblock.estimate_microrows(rp, cols, 256)`` wherever the matrix
    packs.

    The matrix's rows go in chunks (:func:`_stat_edges`) whose edges are
    multiples of 128 rows and lie on the transpose's panel-local 256-wide
    windows, so a key of either direction lies in one chunk: forward a
    chunk holds whole stripes, which are padded and summed in it; for the
    transpose a chunk lies in one panel of its columns, and each stripe's
    micro-rows are added up over the panel's chunks before the padding."""
    nrows, ncols = csr.nrows, csr.ncols
    if csr.nnz == 0:
        return 0
    span = _LARGE_WINDOWS * microblock.LANE
    # the width of a column panel of the matrix, and of the transpose's
    # (a run of the matrix's rows)
    col_period = span if _needs_large(nrows, ncols) else ncols
    row_period = span if _needs_large(ncols, nrows) else nrows
    period = row_period if transpose else col_period
    n_cb = -(-period // (2 * microblock.LANE))  # 256-column windows a panel
    n_panels = -(-(nrows if transpose else ncols) // period)
    rp = csr.rowptrs
    dev = rp.device
    edges = _stat_edges(rp, row_period)
    bounds = rp[torch.tensor(edges, device=dev)].tolist()
    count("host_reads")
    group, total = microblock.ACC_GROUP, 0
    per_stripe = (torch.zeros(-(-ncols // microblock.LANE), dtype=torch.int64,
                              device=dev) if transpose else None)

    def padded(mrs):
        count("host_reads")
        return int((-torch.div(-mrs, group, rounding_mode="floor") * group).sum())

    for i, (r0, r1) in enumerate(zip(edges, edges[1:])):
        k0, k1 = bounds[i], bounds[i + 1]
        if k1 - k0 > _STAT_CHUNK and r1 - r0 <= 256:  # a heavy window alone
            if transpose:  # one window of the row panel: a key a stripe
                per_stripe += _key_microrows(csr.colinds, k0, k1, lambda c: c >> 7,
                                             per_stripe.numel())
            else:  # keys (panel, column window), a stripe at a time, padded a panel
                for s0 in range(r0, r1, microblock.LANE):
                    count("host_reads", 2)
                    mrs = _key_microrows(
                        csr.colinds, int(rp[s0]), int(rp[min(s0 + microblock.LANE, r1)]),
                        lambda c: c // period * n_cb + c % period // 256,
                        n_panels * n_cb)
                    total += padded(mrs.view(n_panels, n_cb).sum(1))
        elif k1 > k0:
            rows = torch.repeat_interleave(
                torch.arange(r1 - r0, dtype=torch.int32, device=dev),
                torch.diff(rp[r0 : r1 + 1]), output_size=k1 - k0)
            cols = csr.colinds[k0:k1].to(torch.int32)
            if transpose:  # stripe = column >> 7, window in the row panel
                key = ((cols >> 7).long() * n_cb
                       + ((r0 % period + rows) >> 8).long())
            else:
                panel = cols // period
                key = (((rows >> 7).long() * n_panels + panel) * n_cb
                       + ((cols - panel * period) >> 8))
            keys, counts = torch.unique(key, return_counts=True)
            count("host_reads")  # the keys' count
            mrs = -torch.div(-counts, microblock.SLOT_CAP, rounding_mode="floor")
            stripe = torch.div(keys, n_cb, rounding_mode="floor")
            if transpose:
                per_stripe.index_add_(0, stripe, mrs)
            else:
                _, inverse = torch.unique_consecutive(stripe, return_inverse=True)
                count("host_reads", 2)  # the stripes' count, and the last read back
                total += padded(torch.zeros(int(inverse[-1]) + 1, dtype=torch.int64,
                                            device=dev).index_add_(0, inverse, mrs))
        if transpose and (r1 == nrows or r1 % period == 0):  # a panel ends
            total += padded(per_stripe)
            per_stripe.zero_()
    return total


def _layout_bytes_per_entry(csr, transpose: bool, versions=None) -> float:
    """Device bytes a stored entry of the (256, 1) micro-block layout of
    ``csr`` (or of its transpose), from :func:`_microrows` (cached on the
    matrix as the layouts are, by direction and ``_LARGE_WINDOWS``: the
    ``csr.build.stat`` span)."""
    microrows = _forms.cached(csr, ("stat", transpose, _LARGE_WINDOWS),
                              lambda: _microrows(csr, transpose), versions)
    return microrows * _MICROROW_BYTES / max(csr.nnz, 1)


def _spmv_route(csr, transpose: bool, versions=None) -> str:
    """The f32 SpMV route of ``csr`` (``mult_vec``) or of its transpose
    (``mult_vec_t``): ``"csr"`` where the micro-block layout would cost
    more than :data:`_CSR_CROSSOVER` bytes a stored entry
    (:data:`_CSR_CROSSOVER_LARGE` past :func:`_needs_large`'s limit), else
    ``"large"`` past that limit, else ``"microblock"``."""
    nrows, ncols = (csr.ncols, csr.nrows) if transpose else (csr.nrows, csr.ncols)
    large = _needs_large(nrows, ncols)
    if (csr.nnz and _layout_bytes_per_entry(csr, transpose, versions)
            > (_CSR_CROSSOVER_LARGE if large else _CSR_CROSSOVER)):
        return "csr"
    return "large" if large else "microblock"


def _csr_form(csr):
    """``(rowptrs, colinds, values)`` of ``csr`` as ``spmv_csr`` reads
    them: its own tensors (a copy only of column indices that are not
    int32 or values that are not f32; values None for a structure-only
    matrix)."""
    vals = csr.values
    return (csr.rowptrs, csr.colinds.to(torch.int32),
            None if vals is None else vals.to(torch.float32))


def _build_csr_t(csr):
    """The transpose's CSR tensors on the matrix's device, by the native
    host transpose (as :func:`_host_form` makes it)."""
    nrows, _, rp, cis, vals = _host_form(csr, True)
    dev = csr.device
    rp = torch.from_numpy(np.ascontiguousarray(rp, np.int64)).to(
        device=dev, dtype=ptr_dtype(len(cis)))
    cis = torch.from_numpy(np.ascontiguousarray(cis, np.int32)).to(dev)
    if vals is not None:
        vals = torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(dev)
    trace("layout-build-csr", nnz=len(cis), transpose=True,
          bytes=sum(t.numel() * t.element_size()
                    for t in (rp, cis, vals) if t is not None))
    return rp, cis, vals


def _cached_csr_t(csr, versions=None):
    """The transpose's CSR tensors, cached on the matrix."""
    return _forms.cached(csr, "csr_t", lambda: _build_csr_t(csr), versions)


def _build_edges(csr, transpose: bool, tile: int) -> torch.Tensor:
    """The rows at the share edges of ``tile`` merge items of ``csr`` (or
    of its transpose).  While tracing records, it also counts the split:
    ``csr.edges.shares``, the shares; ``csr.edges.rows_cut``, the rows
    whose entries a share edge cuts; ``csr.edges.rows_spanning``, the rows
    whose entries lie in three shares or more.  Reading them back waits
    for the card, a read made for the recorder alone (not counted in
    ``host_reads``)."""
    rowptrs = _cached_csr_t(csr)[0] if transpose else csr.rowptrs
    rows, entries = _spmv_op.csr_shares(rowptrs, csr.nnz, tile)
    if recording():
        _count_split(rowptrs, rows, entries)
    return rows


def _count_split(rowptrs, rows, entries) -> None:
    """Count a share split (``csr_shares``' rows and entries at its
    edges) in ``csr.edges.*``."""
    # an edge cuts the row it stops in where entries of that row lie on
    # both sides of it; the edges come in row order
    at = rows.clamp_max(rowptrs.shape[0] - 2)
    inside = (rowptrs[at] < entries) & (entries < rowptrs[at + 1])
    _, cuts = torch.unique_consecutive(at[inside], return_counts=True)
    count("csr.edges.shares", rows.numel() - 1)
    count("csr.edges.rows_cut", cuts.numel())
    count("csr.edges.rows_spanning", int((cuts >= 2).sum()))


def _spmv_edges(csr, transpose: bool, versions=None) -> torch.Tensor:
    """The rows at the CSR-form SpMV's share edges of ``csr`` (or of its
    transpose): ``ops/spmv.py:csr_shares``' first tensor, made by one
    ``searchsorted`` and cached on the matrix, so the kernel searches
    nothing."""
    return _forms.cached(csr, "spmv_edges_t" if transpose else "spmv_edges",
                         lambda: _build_edges(csr, transpose, _spmv_op.CSR_TILE),
                         versions)


def _spmm_edges(csr, transpose: bool = False, versions=None) -> torch.Tensor:
    """The rows at the CSR-form SpMM's share edges of ``csr`` (or of its
    transpose; its shares are smaller than SpMV's), cached as
    :func:`_spmv_edges` are."""
    return _forms.cached(csr, "spmm_edges_t" if transpose else "spmm_edges",
                         lambda: _build_edges(csr, transpose, _spmm_op.CSR_TILE),
                         versions)


def _host_form(csr, transpose: bool):
    """``(nrows, ncols, rowptrs, colinds, values)`` of ``csr`` or of its
    transpose, on the host (the transpose by the native host transpose)."""
    rp, cis, vals = csr.host_arrays()
    nrows, ncols = csr.nrows, csr.ncols
    if transpose:
        vals32 = None if vals is None else np.asarray(vals, np.float32)
        rp, cis, vals = native.transpose_host(nrows, ncols, rp, cis, vals32)
        nrows, ncols = ncols, nrows
    return nrows, ncols, rp, cis, vals


def _build(csr, transpose: bool):
    nrows, ncols, rp, cis, vals = _host_form(csr, transpose)
    layout = microblock.build_microblocks_host(
        nrows, ncols, rp, cis, vals, device=csr.device
    )
    if layout is None:
        raise ValueError(
            f"a {nrows}x{ncols} matrix is outside the micro-block packing"
            f" range ({microblock.MAX_RB} row windows, {microblock.MAX_CB}"
            " column windows): route it to spmv_large"
        )
    trace(
        "layout-build-t" if transpose else "layout-build",
        nnz=layout.nnz, microrows=layout.n_microrows,
        fill=round(layout.fill, 3), bytes=layout.nbytes,
        **(group_counts(layout) if listening() else {}),
    )
    return layout


def group_counts(layout: microblock.MicroBlockLayout) -> dict:
    """``windows``, ``groups`` and ``groups_max`` of a layout: its row
    windows that hold micro-rows, its groups of ``ACC_GROUP`` micro-rows
    (each in one row window, adding its sums into C's rows there) and the
    most groups of one row window, read from ``rbcb`` (one read to the
    host)."""
    rb = (layout.rbcb[: layout.n_microrows : microblock.ACC_GROUP] >> 16).long()
    if rb.numel() == 0:
        return {"windows": 0, "groups": 0, "groups_max": 0}
    per = torch.zeros(layout.rb_count, dtype=torch.int64, device=rb.device)
    per.index_add_(0, rb, torch.ones_like(rb))
    windows, most = torch.stack([(per > 0).sum(), per.max()]).tolist()
    count("host_reads")
    return {"windows": windows, "groups": rb.numel(), "groups_max": most}


def _build_large(csr, transpose: bool):
    nrows, ncols, rp, cis, vals = _host_form(csr, transpose)
    chunks = _spmv_op.build_large_layouts(
        nrows, ncols, rp, cis, vals, max_windows=_LARGE_WINDOWS,
        device=csr.device,
    )
    trace(
        "layout-build-large", nnz=csr.nnz, chunks=len(chunks),
        panels=sum(len(p) for _, p in chunks), transpose=transpose,
        bytes=sum(lay.nbytes for _, p in chunks for _, lay in p),
    )
    return chunks


def _cached_layout(csr, versions=None) -> microblock.MicroBlockLayout:
    return _forms.cached(csr, "layout", lambda: _build(csr, False), versions)


def _cached_layout_t(csr, versions=None) -> microblock.MicroBlockLayout:
    return _forms.cached(csr, "layout_t", lambda: _build(csr, True), versions)


def _cached_large(csr, transpose: bool, versions=None):
    """Chunk/panel layouts of ``csr`` (or of its transpose), cached."""
    return _forms.cached(csr, "large_t" if transpose else "large",
                         lambda: _build_large(csr, transpose), versions)


class CudaHandle:
    """The CSR plus its lazily built forms: the layouts in the matrix's
    set of forms, the torch handle and the dense form in the handle's own
    (``_own``, under the same stamp, dying with the handle); and the
    product plan of the call it serves, where its route has one (``plan``,
    which the API keeps in the matrix's set)."""

    __slots__ = ("csr", "_own", "plan")

    def __init__(self, csr):
        self.csr = csr
        self._own = None
        self.plan = None

    def _kept(self, key: str, build):
        """``build()``, kept on the handle while the matrix's stamp stands."""
        own = self._own
        if own is None or not own.fresh(self.csr):
            own = self._own = _forms.Forms(self.csr)
        if key not in own:
            own[key] = build()
        return own[key]

    @property
    def layout(self) -> microblock.MicroBlockLayout:
        return _cached_layout(self.csr)

    @property
    def layout_t(self) -> microblock.MicroBlockLayout:
        return _cached_layout_t(self.csr)

    @property
    def torch_handle(self):
        return self._kept("torch_handle", lambda: _torch_k.to_handle(self.csr))

    @property
    def dense(self) -> torch.Tensor:
        """The matrix densified in f32."""
        return self._kept("dense", lambda: _torch_k.densify(self.torch_handle,
                                                            torch.float32))


def _to_handle_fields(csr) -> dict:
    return {"kernel": "cuda", "shape": (csr.nrows, csr.ncols), "nnz": csr.nnz}


def _release_fields(csr) -> dict:
    return {"kernel": "cuda", "nnz": csr.nnz}


def to_handle(csr):
    trace("to_handle", **_to_handle_fields(csr))
    return CudaHandle(csr)


def from_handle(h):
    from csr_tpu_torch import CSR

    c = h.csr
    return CSR(c.nrows, c.ncols, c.nnz, c.rowptrs, c.colinds, c.values, _cast=False)


def release_handle(h, drop_cache: bool = False):
    """Drop the handle's references.  The matrix's forms stay unless
    ``drop_cache``, so repeated calls pack nothing."""
    trace("release_handle", **_release_fields(h.csr))
    h._own = None
    if drop_cache:
        _forms.drop(h.csr)


def order_columns(h):
    h.csr.sort_rows()


def _refuse_grad(h, operand, op: str) -> None:
    """Raise ValueError when grad mode is on and the operand or the
    matrix's values require grad.  The kernels have no backward (nor has
    the JAX package's ``pallas`` backend, which refuses ``jax.grad``), and
    a kernel writes its result through a raw pointer, so the result would
    come back with no ``grad_fn``: the gradient would be dropped without
    a word on the card, where the CPU's plain version would carry it."""
    if not torch.is_grad_enabled():
        return
    vals = h.csr.values
    if operand.requires_grad or (vals is not None and vals.requires_grad):
        raise ValueError(
            f"{op} on the cuda backend has no backward: differentiate on the"
            " torch backend (kernels.use_kernel('torch')), or run under"
            " torch.no_grad()")


def _mult(h, v, transpose: bool):
    op = "mult_vec_t" if transpose else "mult_vec"
    _refuse_grad(h, v, op)
    c = h.csr
    out_dtype = _torch_k._result_dtype(_torch_k._values_dtype(c), v.dtype)
    if c.nnz == 0:
        n_out = c.ncols if transpose else c.nrows
        return torch.zeros(n_out, dtype=out_dtype, device=v.device)
    if out_dtype == torch.float64:
        fn = _torch_k.mult_vec_t if transpose else _torch_k.mult_vec
        return fn(h.torch_handle, v)
    ncols = c.nrows if transpose else c.ncols
    ver = c._versions()  # read once for every cache this call looks up
    route = _spmv_route(c, transpose, ver)
    # under torch.func.vmap the product is an SpMM, on SpMM's edges
    batched = torch._C._functorch.maybe_current_level() is not None
    if route == "csr":
        a = _spmv_op.CsrForm(*(_cached_csr_t(c, ver) if transpose else _csr_form(c)),
                             edges=_spmv_edges(c, transpose, ver),
                             spmm_edges=(_spmm_edges(c, transpose, ver)
                                         if batched else None),
                             spmm_panels=((lambda n: _spmm_panels(c, transpose, n, ver))
                                          if batched else None))
    elif route == "large":
        a = _cached_large(c, transpose, ver)
    else:
        a = (_cached_layout_t if transpose else _cached_layout)(c, ver)
    y = _spmv_op.product(a, v, ncols, op).to(out_dtype)
    # a plan where the launch reads cached forms only (not a copy of
    # int64 columns or of values in another dtype)
    if (route != "large" and not batched and v.dtype == out_dtype == torch.float32
            and (route != "csr" or transpose
                 or (a.colinds is c.colinds and a.values is c.values))):
        h.plan = _plan.make(v, route_settings(), _spmv_run(a, v, ncols, op), _events(c))
    return y


def route_settings() -> tuple:
    """What decides a product's route and launch besides the matrix and the
    operand: the crossovers and budgets of this module and of the SpMM
    and SpGEMM ops, which a caller may set.  A product plan is taken only
    under the settings it was made under."""
    return (_CSR_CROSSOVER, _CSR_CROSSOVER_LARGE, _SPMM_CSR_CROSSOVER,
            _DENSIFY_CROSSOVER, _LARGE_WINDOWS, _spgemm_op.max_dense_bytes,
            _spmm_op.L2_SLAB_BYTES, _spmm_op.BLOCKS_IN_FLIGHT,
            _PANEL_L2_SHARE, _PANEL_MIN_ENTRIES)


def _spmv_run(a, v, ncols: int, op: str):
    """A plan's launch of SpMV on ``a``, a layout or a :class:`CsrForm`,
    for operands like ``v``: on the card the wrapper's launch, its checks
    done; on the CPU :func:`csr_tpu_torch.ops.spmv.product` as the
    general path calls it."""
    if v.device.type != "cuda":
        return lambda x: _spmv_op.product(a, x, ncols, op)
    if isinstance(a, _spmv_op.CsrForm):
        return _spmv_op.spmv_csr_launch(a.rowptrs, a.colinds, a.values, a.edges, v)
    return _spmv_op.spmv_launch(a, v)


def _events(c, *route) -> tuple:
    """The events of a product call on ``c`` as the general path emits
    them: ``to_handle``, the route's (``(event, fields)`` pairs) and
    ``release_handle``."""
    return (("to_handle", _to_handle_fields(c)), *route,
            ("release_handle", _release_fields(c)))


@spanned("csr.backend.mult_vec")
def mult_vec(h, v):
    """SpMV ``A @ v`` on the route :func:`_spmv_route` picks: the
    CSR-form kernel, or the micro-block kernel (chunks and panels past
    :data:`_LARGE_WINDOWS`)."""
    return _mult(h, v, transpose=False)


@spanned("csr.backend.mult_vec_t")
def mult_vec_t(h, v):
    """Transpose SpMV ``A^T @ v`` on the route :func:`_spmv_route` picks
    for the transpose, over its cached CSR tensors or layout (built by a
    host transpose)."""
    return _mult(h, v, transpose=True)


#: densify-and-matmul route: (width n of B, density) points at which a
#: whole mult_dense call on the dense route (densify + full-f32 matmul)
#: starts to beat one on the SpMM kernel.  Both routes cost about
#: rows x columns x n of A times a rate (the matmul's, or the kernel's at
#: that density), plus densifying, which does not grow with n; so the
#: crossover is a density that moves with n alone.  Measured on an H100
#: 80GB HBM3 at 700 W (chip_smoke.py phase 11, 8192^2 at densities 1e-3 to
#: 3e-1, B 50, 128, 256 and 8192 wide, log-interpolated; PERF.md).  The
#: points at n = 256 and 8192 lie inside that range.  At n = 128 the
#: kernel route still wins at 0.3, by 8%, and its point is the trend of
#: 0.1 and 0.3 carried on to where it crosses, 0.35; at n = 50 it wins at
#: 0.3 by 2.2 x and that trend crosses at no density a matrix has, so its
#: point is 1.  Past 0.3 both are extrapolated: a wrong route there costs
#: time, never the result.
_DENSIFY_CROSSOVER = ((50, 1.0), (128, 0.35), (256, 0.1706), (8192, 0.08193))


def _at_width(points, n: int) -> float:
    """The value of measured (B width, value) ``points`` at width ``n``:
    linear in log n between them, constant past their ends."""
    widths, values = zip(*points)
    return float(np.interp(np.log(max(n, 1)), np.log(widths), values))


def _min_density(n: int) -> float:
    """The crossover density of :data:`_DENSIFY_CROSSOVER` at width ``n``."""
    return _at_width(_DENSIFY_CROSSOVER, n)


def _dense_affordable(csr, n: int) -> bool:
    """Whether ``A @ B`` with B ``n`` wide takes the dense route."""
    elems = csr.nrows * csr.ncols
    if elems == 0 or elems * 4 > _spgemm_op.max_dense_bytes:
        return False
    return csr.nnz / elems >= _min_density(n)


def _matmul_f32(a, b):
    """``a @ b`` in full f32, TF32 off (the JAX package's
    ``Precision.HIGHEST``)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


#: SpMM's CSR-form route: f32 SpMM with B ``n`` wide of a matrix whose
#: (256, 1) micro-block layout would cost more device bytes a stored entry
#: (:func:`_layout_bytes_per_entry`) than :func:`_spmm_crossover` of ``n``
#: runs ``ops/spmm.py:spmm_csr`` on the matrix's own CSR tensors; the rest
#: runs the micro-block kernel (``spmm_large`` past the packing range).
#: (B width, bytes an entry) points, log-interpolated in the width.
#: Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 22,
#: its crossover sweep of 131,072-row matrices and phase 9's 8192^2
#: operand, PERF.md) with the CSR-form kernel that walks a row with a
#: sub-warp: at n = 50 the CSR form was the faster at every sweep matrix
#: from 8.27 B an entry (time ratios 1.01-1.87, the 8192^2 operand the
#: most), at n = 256 over 4,096 columns (1.15-1.49), tied over 2^16
#: (1.00-1.05); the flagship (7.18 B; 0.98) and the MovieLens-25M shape
#: (10.13 B; 1.00-1.02) were not.  The point at both widths is 11, above
#: those two and phase 9's 8192^2 operand (9.65 B), whose main paths run
#: the micro-block kernel, and below the 12.06 B matrix (1.27 and 1.35).
_SPMM_CSR_CROSSOVER = ((50, 11.0), (256, 11.0))


def _spmm_crossover(n: int) -> float:
    """Layout bytes a stored entry above which SpMM with B ``n`` wide
    takes the CSR form (:data:`_SPMM_CSR_CROSSOVER` at width ``n``)."""
    return _at_width(_SPMM_CSR_CROSSOVER, n)


#: the CSR-form SpMM in column panels (``ops/spmm.py:Panels``): B's rows
#: that the blocks in flight gather from must fit this share of the
#: card's L2 (a panel's columns times B's width times 4 B), so a B larger
#: than the share runs in as many panels as it takes.  Measured on an
#: NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 23, PERF.md), at
#: KDD-Cup'11's R . Q and Rt . P (B 125 and 200 MB, 50 wide): one pass
#: 15.60 / 17.31 ms; slabs of 8, 12, 16, 20, 25, 30 and 40 MiB 14.68 /
#: 14.18, 13.17 / 12.76, 12.42 / 11.93, 11.63 / 11.56, 11.40 / 11.25,
#: 11.46 / 11.24 and 11.77 / 11.52 ms: fewer, wider panels cost less
#: until the slab passes about half of L2, which 25 MiB is
_PANEL_L2_SHARE = 0.5
#: ... where each row keeps at least this many entries a panel on average
#: (``nnz / nrows / K``): every panel walks every row and reads and writes
#: C's rows again, which pays only where rows are long.  Measured as
#: above over 44 (matrix, slab) points of 0.18-88 entries a row a panel
#: (KDD-Cup'11's R thinned to 1/2 .. 1/32, phase 22's 131,072-row sweep):
#: one-pass time / panelled time 0.05-0.94 up to 9.14, 0.973 at 10.94,
#: 0.999 at 13.13, then 1.053 at 16.41 and 1.06-1.54 from there on
_PANEL_MIN_ENTRIES = 16.0
#: L2 bytes by CUDA device index, read once
_l2_by_device: dict = {}


def _l2_bytes(dev: torch.device) -> int:
    """The L2 cache of the card ``dev``; 0 off a card (one pass)."""
    if dev.type != "cuda":
        return 0
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _l2_by_device:
        _l2_by_device[index] = torch.cuda.get_device_properties(index).L2_cache_size
    return _l2_by_device[index]


def panels_for_slab(ncols: int, n: int, slab_bytes: int) -> int:
    """The fewest column panels of ``ncols`` columns that keep a panel's
    rows of a B ``n`` wide (``ncols * n * 4 / K`` bytes) within
    ``slab_bytes``, a column a panel at most."""
    return min(-(-(ncols * n * 4) // max(slab_bytes, 1)), ncols)


def spmm_panel_count(nrows: int, ncols: int, nnz: int, n: int, l2_bytes: int) -> int:
    """The column panels the CSR-form SpMM of an ``nrows x ncols`` matrix
    of ``nnz`` entries runs in, with B ``n`` wide, on a card of
    ``l2_bytes`` of L2: :func:`panels_for_slab` of :data:`_PANEL_L2_SHARE`
    of L2, or 1 (one pass) where that is 1, where there is no L2 (off a
    card), where the rows would keep fewer than :data:`_PANEL_MIN_ENTRIES`
    entries a panel on average, or where the panels' int32 metadata
    cannot index ``nnz`` entries."""
    if l2_bytes <= 0:
        return 1
    k = panels_for_slab(ncols, n, int(l2_bytes * _PANEL_L2_SHARE))
    if k <= 1 or nnz >= 1 << 31 or nnz < _PANEL_MIN_ENTRIES * nrows * k:
        return 1
    return k


def _spmm_panels(csr, transpose: bool, n: int, versions=None):
    """The :class:`ops/spmm.py:Panels` that the CSR-form SpMM of ``csr``
    (or of its transpose) with B ``n`` wide runs in, or None for one pass:
    :func:`spmm_panel_count`'s count on the matrix's card, where its rows hold
    their columns in order (``ops/spmm.py:rows_in_order``, checked once on
    the card).  Built at the first product that needs them and cached on
    the matrix by count, as the share edges are (the
    ``csr.build.spmm_panels`` span, ``form_builds.spmm_panels``, a
    ``layout-build-panels`` event; while tracing records, each panel's
    share split counts in ``csr.edges.*`` as :func:`_build_edges`' do)."""
    nrows, ncols = (csr.ncols, csr.nrows) if transpose else (csr.nrows, csr.ncols)
    k = spmm_panel_count(nrows, ncols, csr.nnz, n, _l2_bytes(csr.device))
    if k == 1:
        return None

    def build():
        rp, ci, _ = _cached_csr_t(csr, versions) if transpose else _csr_form(csr)
        kept = _forms.forms(csr, versions)
        in_order = kept.get(("in_order", transpose))
        if in_order is None:
            in_order = kept[("in_order", transpose)] = _spmm_op.rows_in_order(rp, ci)
        panels = (_spmm_op.split_panels(rp, ci, _spmm_op.panel_bounds(ncols, k))
                  if in_order else None)
        if recording() and panels:  # each panel's share split
            for i, nnz in enumerate(panels.nnz):
                ptrs = panels.ptrs[i]
                _count_split(ptrs, *_spmv_op.csr_shares(ptrs, nnz, _spmm_op.CSR_TILE))
        trace("layout-build-panels", panels=k if panels else 1, nnz=csr.nnz,
              transpose=transpose, n=n, bytes=panels.nbytes if panels else 0)
        return panels

    return _forms.cached(csr, ("spmm_panels", transpose, k), build, versions)


def _spmm_route(csr, n: int, versions=None) -> str:
    """The f32 SpMM route of ``csr`` with B ``n`` wide, past the dense
    route: ``"csr"`` where the micro-block layout would cost more than
    :func:`_spmm_crossover` bytes a stored entry, else ``"large"`` past
    :func:`_needs_large`'s limit, else ``"kernel"``."""
    if (csr.nnz and _layout_bytes_per_entry(csr, False, versions)
            > _spmm_crossover(n)):
        return "csr"
    return "large" if _needs_large(csr.nrows, csr.ncols) else "kernel"


def _sparse_times_dense(h, b, op: str, plan: bool = False):
    """``A @ b`` for f32 dense ``b`` (A's columns by n), on the route its
    shape picks: densified matmul, the CSR-form SpMM kernel, or the
    micro-block one (a launch a chunk and panel past the packing range).
    Emits a trace event naming it (``kernel`` for both micro-block
    forms).  With ``plan``, a single launch on a cached form leaves its
    product plan on the handle."""
    c = h.csr
    n = b.shape[1]
    if _dense_affordable(c, n):
        trace(op, route="dense", shape=(c.nrows, c.ncols), n=n)
        return _matmul_f32(h.dense, b)
    ver = c._versions()  # read once for every cache this call looks up
    route = _spmm_route(c, n, ver)
    fields = {"route": "csr" if route == "csr" else "kernel",
              "shape": (c.nrows, c.ncols), "n": n}
    trace(op, **fields)
    if route == "large":
        return _spmm_op.spmm_large(_cached_large(c, False, ver), b)
    panels = None
    if route == "csr":
        form, panels = _csr_form(c), _spmm_panels(c, False, n, ver)
        edges = None if panels else _spmm_edges(c, False, ver)
        out = _spmm_op.spmm_csr(*form, b, edges=edges, panels=panels)
        # a plan where the launch reads cached forms only
        plan = plan and form[1] is c.colinds and form[2] is c.values
    else:
        form, edges = _cached_layout(c, ver), None
        out = _spmm_op.spmm(form, b, l2_bytes=_l2_bytes(b.device))
    if plan and n and torch._C._functorch.maybe_current_level() is None:
        h.plan = _plan.make(b, route_settings(), _spmm_run(form, edges, b, panels),
                            _events(c, (op, fields)))
    return out


def _spmm_run(form, edges, b, panels=None):
    """A plan's launch of SpMM on ``form``, a layout or the CSR tensors
    (with the rows at their SpMM share edges, or their column panels),
    for a B like ``b``: on the card the wrapper's launch, its checks done;
    on the CPU the wrapper as the general path calls it."""
    csr_form = isinstance(form, tuple)
    l2 = 0 if csr_form else _l2_bytes(b.device)
    if b.device.type != "cuda":
        if csr_form:
            return lambda x: _spmm_op.spmm_csr(*form, x, edges=edges, panels=panels)
        return lambda x: _spmm_op.spmm(form, x, l2_bytes=l2)
    if csr_form:
        return _spmm_op.spmm_csr_launch(*form, edges, b, panels)
    return _spmm_op.spmm_launch(form, b, l2_bytes=l2)


@spanned("csr.backend.mult_dense")
def mult_dense(h, B):
    """SpMM ``A @ B`` with dense ``B`` (see the module docstring for the
    routes)."""
    _refuse_grad(h, B, "mult_dense")
    c = h.csr
    out_dtype = _torch_k._result_dtype(_torch_k._values_dtype(c), B.dtype)
    if c.nnz == 0:
        trace("mult_dense", route="zeros", shape=(c.nrows, c.ncols), n=B.shape[1])
        return torch.zeros(c.nrows, B.shape[1], dtype=out_dtype, device=B.device)
    if out_dtype == torch.float64:
        trace("mult_dense", route="torch", shape=(c.nrows, c.ncols), n=B.shape[1])
        return _torch_k.mult_dense(h.torch_handle, B)
    return _sparse_times_dense(h, B.to(torch.float32), "mult_dense",
                               plan=B.dtype == out_dtype == torch.float32).to(out_dtype)


def _spgemm(a_h, b_h, transpose: bool):
    """SpGEMM on the dense route: densify B (or B^T) in f32, multiply A by
    it on :func:`_sparse_times_dense`'s route, compact the product to CSR.
    f64 goes to the torch backend; a product past the dense budget runs
    ESC (:mod:`csr_tpu_torch.ops.spgemm`)."""
    a, b = a_h.csr, b_h.csr
    out_dtype = _torch_k._result_dtype(_torch_k._values_dtype(a),
                                       _torch_k._values_dtype(b))
    if out_dtype == torch.float64:
        trace("spgemm", route="torch", shape=(a.nrows, a.ncols), n=b.nrows)
        fn = _torch_k.mult_abt if transpose else _torch_k.mult_ab
        return to_handle(_torch_k.from_handle(fn(a_h.torch_handle, b_h.torch_handle)))
    n_out = b.nrows if transpose else b.ncols
    if not _spgemm_op.dense_fits(a.nrows, b.nrows, b.ncols, n_out, out_dtype):
        trace("spgemm", route="esc", shape=(a.nrows, a.ncols), n=n_out)
        mul = _spgemm_op.esc_mult_abt if transpose else _spgemm_op.esc_mult_ab
        return to_handle(mul(a, b, out_dtype))
    if a.nnz == 0 or b.nnz == 0:
        from csr_tpu_torch import CSR

        trace("spgemm", route="zeros", shape=(a.nrows, a.ncols), n=n_out)
        return to_handle(CSR.empty(a.nrows, n_out, device=a.device))
    b_dense = _torch_k.densify(b_h.torch_handle, torch.float32, transpose)
    c_dense = _sparse_times_dense(a_h, b_dense, "spgemm")
    return to_handle(_torch_k.dense_to_csr(c_dense))


@spanned("csr.backend.mult_ab")
def mult_ab(a_h, b_h):
    """SpGEMM ``A @ B`` (see :func:`_spgemm`)."""
    return _spgemm(a_h, b_h, transpose=False)


@spanned("csr.backend.mult_abt")
def mult_abt(a_h, b_h):
    """SpGEMM ``A @ B^T`` (see :func:`_spgemm`)."""
    return _spgemm(a_h, b_h, transpose=True)
