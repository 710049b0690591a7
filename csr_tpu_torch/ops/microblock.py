"""
Micro-block CSR layout (counterpart of :mod:`csr_tpu.ops.microblock`).

The layout is the JAX package's, byte for byte, so that layouts and
results compare directly between the two packages.  Stored entries are
regrouped into *micro-rows* of up to ``SLOT_CAP = 127`` entries, each
confined to one aligned 128-row window ``rb`` and one aligned 128- or
256-column window ``cb``, and sorted by row within the micro-row:

``vals``  (M, 128) float32 -- entry values (0 in padding slots)
``meta``  (M, 128) uint16  -- ``lo | epos << s`` per slot (``s`` = 7 for
                              128-wide windows, 8 for 256-wide): ``lo``
                              is the entry's column within the window,
                              ``epos`` the number of the micro-row's
                              entries in window rows ``<= slot``
``rbcb``  (M,)     int32   -- ``rb << 16 | cb``

Every stripe (the micro-rows of one ``rb``) is padded to a multiple of
``ACC_GROUP`` micro-rows, so each aligned group of ``ACC_GROUP``
micro-rows shares one ``rb``; with ``pair = P`` every (rb, cb) group is
padded to a multiple of P micro-rows; ``M`` is rounded up to
``MR_BLOCK``.  See the JAX module for why the TPU wanted this shape.

The packing runs on the host (the native C++ packer, or numpy), and only
the final arrays go to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LANE = 128
#: entries per micro-row; slot 127 of every micro-row is padding
SLOT_CAP = 127
#: micro-rows are padded to a multiple of this
MR_BLOCK = 2048
#: micro-rows in one aligned group of uniform ``rb``
ACC_GROUP = 32
#: the packing range of ``rbcb``: ``rb`` in 15 bits, ``cb`` in 16
#: (``csr_tpu/native/csr_host.cpp`` mb_sort)
MAX_RB = 32767
MAX_CB = 65535


@dataclass
class MicroBlockLayout:
    """Micro-block form of a CSR matrix, as tensors on one device."""

    nrows: int
    ncols: int
    nnz: int
    n_microrows: int  # before padding to MR_BLOCK
    vals: torch.Tensor  # (M, 128) f32
    meta: torch.Tensor  # (M, 128) u16: lo | epos << (7|8)
    rbcb: torch.Tensor  # (M,) i32
    window: int = LANE
    pair: int = 1

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def rb_count(self) -> int:
        return -(-self.nrows // LANE)

    @property
    def cb_count(self) -> int:
        """128-wide blocks covering ncols, padded to whole windows."""
        wb = self.window // LANE
        return wb * -(-self.ncols // self.window)

    @property
    def fill(self) -> float:
        """Fraction of micro-row slots holding real entries."""
        return self.nnz / (max(self.n_microrows, 1) * LANE)

    @property
    def nbytes(self) -> int:
        """Device bytes held by the layout."""
        return sum(t.numel() * t.element_size()
                   for t in (self.vals, self.meta, self.rbcb))

    @property
    def epos_shift(self) -> int:
        return 7 if self.window == LANE else 8

    def unpack_meta(self):
        """Host (numpy) ``(lo, epos)`` int32 arrays, for tests."""
        m = self.meta.cpu().numpy().astype(np.int32)
        s = self.epos_shift
        return m & ((1 << s) - 1), m >> s


def in_range(nrows: int, ncols: int, window: int) -> bool:
    """Whether ``rbcb`` can address the matrix at this window width."""
    return -(-nrows // LANE) <= MAX_RB and -(-ncols // window) <= MAX_CB


def layout_from_arrays(vals, meta, rbcb, nrows, ncols, nnz, n_microrows,
                       window, pair, device) -> MicroBlockLayout:
    """A layout from numpy arrays, for instance those of a
    :class:`csr_tpu.ops.microblock.MicroBlockLayout`."""
    def t(a, dtype):
        # writable and contiguous: torch will not alias read-only memory
        return torch.from_numpy(np.require(a, dtype, "CW")).to(device)

    return MicroBlockLayout(
        int(nrows), int(ncols), int(nnz), int(n_microrows),
        t(vals, np.float32), t(meta, np.uint16), t(rbcb, np.int32),
        int(window), int(pair),
    )


def _estimate_multi_numpy(rp, cols, window: int, nrows: int):
    """(m_pair1, m_pair2, m_pair4) stripe-padded micro-row counts, numpy."""
    rids = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(rp))
    shift = int(window).bit_length() - 1
    key = (rids >> 7) << 32 | (np.asarray(cols).astype(np.int64) >> shift)
    uk, counts = np.unique(key, return_counts=True)
    grp_mrs = -(-counts // SLOT_CAP)
    urb = uk >> 32
    new_stripe = np.empty(len(uk), bool)
    new_stripe[0] = True
    new_stripe[1:] = urb[1:] != urb[:-1]
    stripe_id = np.cumsum(new_stripe) - 1
    out = []
    for pair in (1, 2, 4):
        gm = -(-grp_mrs // pair) * pair
        stripe_mrs = np.bincount(stripe_id, weights=gm).astype(np.int64)
        out.append(int((-(-stripe_mrs // ACC_GROUP) * ACC_GROUP).sum()))
    return tuple(out)


def estimate_microrows(rp, cols, window: int, ncols: int | None = None,
                       pair: int = 1) -> int:
    """Stripe-padded micro-row count that a build at ``(window, pair)``
    would produce."""
    if pair not in (1, 2, 4):
        raise ValueError(f"pair {pair}: expected 1, 2 or 4")
    if len(cols) == 0:
        return 0
    rp = np.asarray(rp)
    nrows = len(rp) - 1
    if ncols is None:
        ncols = int(np.max(cols)) + 1
    from csr_tpu_torch import native

    m = native.plan_microrows(nrows, ncols, rp, cols, window, ACC_GROUP, pair)
    if m is not None:
        return m
    return _estimate_multi_numpy(rp, cols, window, nrows)[(1, 2, 4).index(pair)]


#: SpMV cost per 1024 micro-rows for each (window, pair).  These are the
#: JAX package's numbers, MEASURED ON A TPU v5e for its Pallas kernel, and
#: say nothing about the CUDA kernel.  They are kept unchanged so that the
#: two packages choose the same layout and compare byte for byte;
#: re-deriving them on the H100 is later work (ROADMAP).
STEP_COST = {
    (128, 1): 2.45, (128, 2): 1.98, (128, 4): 1.58,
    (256, 1): 4.42, (256, 2): 2.86, (256, 4): 2.43,
}


def choose_layout(rp, cols, ncols: int | None = None) -> tuple[int, int]:
    """``(window, pair)`` minimizing micro-row count times
    :data:`STEP_COST`.  A window width whose ``cb`` count is outside the
    packing range is skipped."""
    if len(cols) == 0:
        return LANE, 1
    rp = np.asarray(rp)
    nrows = len(rp) - 1
    if ncols is None:
        ncols = int(np.max(cols)) + 1
    from csr_tpu_torch import native

    best = None
    for window in (128, 256):
        if not in_range(nrows, ncols, window):
            continue
        m3 = native.plan_microrows3(nrows, ncols, rp, cols, window, ACC_GROUP)
        if m3 is None:
            m3 = _estimate_multi_numpy(rp, cols, window, nrows)
        for pair, m in zip((1, 2, 4), m3):
            t = m * STEP_COST[(window, pair)]
            if best is None or t < best[0]:
                best = (t, window, pair)
    return (LANE, 1) if best is None else best[1:]


def build_microblocks(csr, window: int | None = None,
                      pair: int | None = None) -> MicroBlockLayout | None:
    """Micro-block layout of a :class:`csr_tpu_torch.CSR`, on its device
    (see :func:`build_microblocks_host`)."""
    rp, cis, vals = csr.host_arrays()
    return build_microblocks_host(
        csr.nrows, csr.ncols, rp, cis, vals, window=window, pair=pair,
        device=csr.device,
    )


def build_microblocks_host(
    nrows, ncols, rp, cols, vals_in, *,
    window: int | None = None, pair: int | None = None, device="cpu",
) -> MicroBlockLayout | None:
    """Pack host CSR arrays into a micro-block layout on ``device``.

    The native C++ packer runs when it is available, the numpy path
    otherwise; both give the same bytes.  ``window`` (128 or 256) and
    ``pair`` (1, 2 or 4) default to :func:`choose_layout`'s choice.
    Returns None when the matrix is outside the packing range (more than
    ``MAX_RB`` row windows or ``MAX_CB`` column windows)."""
    nnz = int(len(cols))
    if nnz and (window is None or pair is None):
        w_, p_ = choose_layout(rp, cols, ncols)
        window = w_ if window is None else window
        pair = p_ if pair is None else pair
    window = LANE if window is None else window
    pair = 1 if pair is None else pair
    if window not in (128, 256) or pair not in (1, 2, 4):
        raise ValueError(f"(window, pair) = ({window}, {pair}): expected a"
                         " window of 128 or 256 and a pair of 1, 2 or 4")

    def layout(vals, meta, rbcb, m):
        return layout_from_arrays(vals, meta, rbcb, nrows, ncols, nnz, m,
                                  window, pair, device)

    if nnz == 0:
        return layout(np.zeros((MR_BLOCK, LANE), np.float32),
                      np.zeros((MR_BLOCK, LANE), np.uint16),
                      np.zeros(MR_BLOCK, np.int32), 0)
    if not in_range(nrows, ncols, window):
        return None
    from csr_tpu_torch import native

    built = native.build_microblocks(
        nrows, ncols, rp, cols, vals_in, MR_BLOCK, window, ACC_GROUP, pair
    )
    if built is not None:
        return layout(*built)

    cols = np.asarray(cols).astype(np.int32, copy=False)
    if vals_in is None:
        vals_in = np.ones(nnz, np.float32)
    else:
        vals_in = np.asarray(vals_in).astype(np.float32, copy=False)

    shift = window.bit_length() - 1
    rp = np.asarray(rp)
    rids = np.repeat(np.arange(nrows, dtype=np.int32), np.diff(rp))
    rb = rids >> 7
    cb = cols >> shift

    # lexicographic (rb, cb, row): np.lexsort sorts by the LAST key first
    perm = np.lexsort((rids, cb, rb))
    srid = rids[perm]
    scol = cols[perm]
    sval = vals_in[perm]
    srb = rb[perm]
    scb = cb[perm]

    # group = run of equal (rb, cb); packed position of each entry
    newgrp = np.empty(nnz, bool)
    newgrp[0] = True
    np.logical_or(srb[1:] != srb[:-1], scb[1:] != scb[:-1], out=newgrp[1:])
    grp_id = np.cumsum(newgrp) - 1
    idx = np.arange(nnz, dtype=np.int64)
    grp_first = np.maximum.accumulate(np.where(newgrp, idx, 0))
    pos = idx - grp_first

    mr_in_grp = pos // SLOT_CAP
    slot = (pos % SLOT_CAP).astype(np.int64)

    grp_sizes = np.bincount(grp_id)
    grp_mrs = -(-grp_sizes // SLOT_CAP)
    grp_mrs = -(-grp_mrs // pair) * pair  # pair padding
    n_grps = len(grp_sizes)
    grp_rb = srb[np.flatnonzero(newgrp)]
    grp_cb = scb[np.flatnonzero(newgrp)]

    # stripes = runs of groups sharing one rb, each padded to ACC_GROUP
    new_stripe = np.empty(n_grps, bool)
    new_stripe[0] = True
    new_stripe[1:] = grp_rb[1:] != grp_rb[:-1]
    stripe_id = np.cumsum(new_stripe) - 1
    n_stripes = int(stripe_id[-1]) + 1
    stripe_mrs = np.bincount(stripe_id, weights=grp_mrs).astype(np.int64)
    stripe_pad = -(-stripe_mrs // ACC_GROUP) * ACC_GROUP
    stripe_off = np.cumsum(stripe_pad) - stripe_pad

    grp_cum = np.cumsum(grp_mrs) - grp_mrs
    stripe_first_cum = grp_cum[np.flatnonzero(new_stripe)]
    grp_off_in_stripe = grp_cum - stripe_first_cum[stripe_id]
    grp_mr_off = stripe_off[stripe_id] + grp_off_in_stripe
    mr_idx = grp_mr_off[grp_id] + mr_in_grp

    m = int(stripe_pad.sum())
    m_pad = -(-m // MR_BLOCK) * MR_BLOCK

    vals = np.zeros((m_pad, LANE), np.float32)
    vals[mr_idx, slot] = sval
    lo = np.zeros((m_pad, LANE), np.int32)
    lo[mr_idx, slot] = scol & (window - 1)

    # stripe-padding micro-rows carry their stripe's rb (cb 0, value 0);
    # group micro-rows, pair padding included, carry the group's (rb, cb)
    rbcb = np.zeros(m_pad, np.int32)
    stripe_rb = grp_rb[np.flatnonzero(new_stripe)].astype(np.int32)
    for s_ in range(n_stripes):
        rbcb[stripe_off[s_] : stripe_off[s_] + stripe_pad[s_]] = stripe_rb[s_] << 16
    mr_grp = np.repeat(np.arange(n_grps), grp_mrs)
    grp_mr_pos = np.repeat(grp_mr_off, grp_mrs) + (
        np.arange(len(mr_grp)) - np.repeat(grp_cum, grp_mrs)
    )
    rbcb[grp_mr_pos] = (grp_rb[mr_grp].astype(np.int32) << 16) | grp_cb[
        mr_grp
    ].astype(np.int32)
    if m_pad > m:
        rbcb[m:] = rbcb[m - 1] & ~np.int32(0xFFFF)

    lrow = (srid & (LANE - 1)).astype(np.int64)
    cnt = np.bincount(mr_idx * LANE + lrow, minlength=m_pad * LANE)
    epos = np.cumsum(cnt.reshape(m_pad, LANE), axis=1).astype(np.int32)

    meta = (lo | (epos << (7 if window == LANE else 8))).astype(np.uint16)
    return layout(vals, meta, rbcb, m)
