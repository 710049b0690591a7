"""
Smoke test of the csr_tpu_torch main path on one CUDA card.

    python3 chip_smoke.py

It builds the CUDA kernel from ``csr_tpu_torch/csrc`` (into
``csr_tpu_torch/_build/``) and runs five phases; any failure raises and
the script exits nonzero.  It needs a CUDA device and never falls back to
the CPU.

1. Environment: the card's name and power limit, the CUDA version, the
   kernel's build time.
2. The kernel against its plain PyTorch version (``spmv_reference``) on
   the card, on small seeded layouts for window 128/256 x pair 1/2/4.
3. Main path at the flagship: ``CSR.mult_vec`` and ``CSR.mult_vec_t`` of
   the 32768^2 matrix with 327 entries per row (10.7M), against scipy.
4. The same at the MovieLens-25M shape: 162,541 users x 59,047 items,
   25,000,095 ratings, made from a seed.
5. The kernel against its plain version at the main path's four layouts;
   kernel and plain-version times at the flagship over chained
   iterations timed with CUDA events; a ``torch.profiler`` view of 20
   chained iterations; each main-path layout's times alone.

Every comparison uses the bound of ``tests/util.py:assert_spmv_close``
(rtol 1e-4 plus 384 f32 eps times the L1 mass of the row's 128-row
window, plus 1e-6), computed here on sparse matrices; "share" is the
largest error as a fraction of that bound, and must stay <= 1.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps
import torch

EPS_MULT = 384
RTOL = 1e-4
KERNEL = {
    "name": "spmv_microblock",
    "route": "cuda",
    "source": "csr_tpu_torch/csrc/spmv_microblock.cu",
    "replaces": "csr_tpu/ops/spmv.py:79",
}


def spmv_share(y, ref, a, x) -> float:
    """Largest |y - ref| as a share of the assert_spmv_close bound for
    ``ref = a @ x``; raises if it exceeds the bound or y is not finite."""
    y = y.detach().cpu().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert y.shape == ref.shape, (y.shape, ref.shape)
    assert np.all(np.isfinite(y)), "non-finite SpMV output"
    a = sps.csr_matrix(a, dtype=np.float64, copy=True)
    a.sum_duplicates()
    row_l1 = abs(a) @ np.abs(np.asarray(x, np.float64))
    cum = np.concatenate([[0.0], np.cumsum(row_l1)])
    n = len(row_l1)
    idx = np.arange(n)
    win_l1 = cum[np.minimum(idx + 128, n)] - cum[np.maximum(idx - 127, 0)]
    eps = float(np.finfo(np.float32).eps)
    tol = RTOL * np.abs(ref) + EPS_MULT * eps * win_l1 + 1e-6
    share = float(np.max(np.abs(y - ref) / tol)) if n else 0.0
    assert share <= 1.0, f"SpMV outside the bound: share {share:.3g}"
    return share


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    from csr_tpu_torch.ops import _cuda

    card = card_line()
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _cuda.library()
    print(f"[1] kernel built and loaded in {_cuda.build_seconds:.2f} s")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1] ptxas: {line.strip()}")
    return card


def phase_kernel_vs_plain():
    """Kernel against spmv_reference on small seeded layouts, all six
    (window, pair) variants, with one (rb, cb) group of 228 entries that
    spans two micro-rows."""
    from csr_tpu_torch.ops import microblock, spmv as spmv_op

    rng = np.random.default_rng(7)
    nrows, ncols = 1000, 3000
    a = sps.random(nrows, ncols, 0.02, format="lil", random_state=rng,
                   dtype=np.float32)
    a[3, :128] = rng.standard_normal(128)
    a[4, :100] = rng.standard_normal(100)
    a = a.tocsr()
    x = rng.standard_normal(ncols).astype(np.float32)
    xd = torch.from_numpy(x).cuda()
    worst = 0.0
    for window in (128, 256):
        for pair in (1, 2, 4):
            layout = microblock.build_microblocks_host(
                nrows, ncols, a.indptr, a.indices, a.data,
                window=window, pair=pair, device="cuda",
            )
            y = spmv_op.spmv(layout, xd)
            y_ref = spmv_op.spmv_reference(layout, xd)
            torch.cuda.synchronize()
            share = spmv_share(y, y_ref.cpu().numpy(), a, x)
            share_sp = spmv_share(y, a.astype(np.float64) @ x, a, x)
            err = float((y - y_ref).abs().max())
            worst = max(worst, err)
            print(f"[2] window {window} pair {pair}: {layout.n_microrows} "
                  f"micro-rows, kernel vs plain max abs err {err:.3g}, "
                  f"share {share:.3g} (vs scipy {share_sp:.3g})")
    return worst


def flagship():
    """The 32768^2 matrix with 327 entries per row, made as bench.py
    makes it (seed 0)."""
    nrows = ncols = 32768
    npr = 327
    nnz = nrows * npr
    rng = np.random.default_rng(0)
    rowptr = np.arange(nrows + 1, dtype=np.int64) * npr
    cols = rng.integers(0, ncols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal(ncols).astype(np.float32)
    return nrows, ncols, rowptr, cols, vals, x


def movielens_shape(seed: int = 25):
    """A rating matrix of MovieLens-25M's shape: 162,541 users x 59,047
    items, 25,000,095 ratings.  Users rate at least 20 items, with a
    log-normal tail; items are drawn with power-law popularity (exponent
    0.6, so the most popular item takes a fraction of a percent of the
    ratings) over a random permutation of the item ids; ratings are
    0.5 .. 5.0 in half steps.  Repeated (user, item) pairs are kept and
    summed, as in the reference."""
    nrows, ncols, nnz = 162_541, 59_047, 25_000_095
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0.0, 1.2, nrows)
    extra_total = nnz - 20 * nrows
    extra = np.floor(w / w.sum() * extra_total).astype(np.int64)
    rem = extra_total - int(extra.sum())
    extra[rng.choice(nrows, rem, replace=False)] += 1
    rowptr = np.zeros(nrows + 1, np.int64)
    np.cumsum(20 + extra, out=rowptr[1:])
    assert rowptr[-1] == nnz
    pop = np.arange(1, ncols + 1, dtype=np.float64) ** -0.6
    cdf = np.cumsum(pop / pop.sum())
    rank = np.minimum(np.searchsorted(cdf, rng.random(nnz)), ncols - 1)
    cols = rng.permutation(ncols).astype(np.int32)[rank]
    vals = (rng.integers(1, 11, nnz) * 0.5).astype(np.float32)
    x = rng.standard_normal(ncols).astype(np.float32)
    xt = rng.standard_normal(nrows).astype(np.float32)
    return nrows, ncols, rowptr, cols, vals, x, xt


def phase_main_path(tag, nrows, ncols, rowptr, cols, vals, x, xt):
    """CSR.mult_vec and CSR.mult_vec_t on the cuda kernel, against scipy."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel
    from csr_tpu_torch.ops import spmv as spmv_op

    nnz = len(cols)
    csr = CSR(nrows, ncols, nnz, rowptr, cols, vals, device="cuda")
    a = sps.csr_matrix((vals, cols, rowptr), shape=(nrows, ncols))
    before = spmv_op.launches
    with use_kernel("cuda"):
        t0 = time.perf_counter()
        y = csr.mult_vec(torch.from_numpy(x).cuda())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        yt = csr.mult_vec_t(torch.from_numpy(xt).cuda())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    grew = spmv_op.launches - before
    assert grew == 2, f"launches grew by {grew}, not 2"
    assert y.shape == (nrows,) and yt.shape == (ncols,)
    at = a.T.tocsr()
    share = spmv_share(y, a.astype(np.float64) @ x, a, x)
    share_t = spmv_share(yt, at.astype(np.float64) @ xt, at, xt)
    layout, layout_t = cuda_k._cached_layout(csr), cuda_k._cached_layout_t(csr)
    for name, lay, secs, s in (("mult_vec", layout, t1 - t0, share),
                               ("mult_vec_t", layout_t, t2 - t1, share_t)):
        print(f"[{tag}] {name}: {nrows}x{ncols} nnz {nnz}, layout window "
              f"{lay.window} pair {lay.pair}, fill {lay.fill:.4f}, "
              f"{lay.nbytes} B; first call {secs:.2f} s (host packing "
              f"included); share of bound vs scipy {s:.3g}")
    print(f"[{tag}] launches grew by {grew}")
    return (layout, x, a, csr.mult_vec), (layout_t, xt, at, csr.mult_vec_t)


def phase_timing(layout, x, card):
    """Kernel and plain version at the flagship: chained iterations,
    each output max-normalised into the next input (as bench.py)."""
    from csr_tpu_torch.ops import spmv as spmv_op
    from csr_tpu_torch.utils.profiling import peak_gbps, timed_chained

    x0 = torch.from_numpy(x).cuda()

    def chained(fn):
        def step(v):
            y = fn(layout, v)
            return y / y.abs().max().clamp_min(1e-30)
        return step

    kern, plain = chained(spmv_op.spmv), chained(spmv_op.spmv_reference)
    # plain, kernel, kernel, plain on the same card; best of each
    t_plain = timed_chained(plain, x0, iters=100)
    t_kern = timed_chained(kern, x0, iters=300)
    t_kern = min(t_kern, timed_chained(kern, x0, iters=300))
    t_plain = min(t_plain, timed_chained(plain, x0, iters=100))
    peak = peak_gbps(torch.cuda.get_device_name(0))
    for name, t in (("kernel", t_kern), ("plain", t_plain)):
        gbps = layout.nbytes / t / 1e9
        frac = f"{gbps / peak:.4f} of {peak} GB/s" if peak else "peak unknown"
        print(f"[5] {name}: {t * 1e3:.5f} ms/iter, {gbps:.2f} GB/s streamed "
              f"({frac}), {layout.nnz / t / 1e9:.3f} Gnnz/s; card {card}")

    # where a chained iteration's time goes: device time by kernel name
    # over 20 iterations, and the device's busy share of that window
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        v = x0
        for _ in range(20):
            v = kern(v)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    print(f"[5] profile of 20 chained kernel iterations: wall {wall * 1e3:.4f} "
          f"ms, device busy {busy * 1e3:.4f} ms ({busy / wall:.3f})")
    for e in dev[:5]:
        print(f"[5]   {e.self_device_time_total / e.count:9.3f} us x{e.count} "
              f"{e.key[:70]}")
    return t_kern * 1e3, t_plain * 1e3


def phase_alone(main_layouts, card):
    """Each main-path layout alone: the kernel wrapper, its plain version
    and the whole ``CSR.mult_vec``/``mult_vec_t`` call, 50 calls on one
    operand between two CUDA events.  The host clock over the same loop
    gives the time to enqueue a call: where it is as long as the event
    time, the host, not the card, sets the pace."""
    from csr_tpu_torch.kernels import use_kernel
    from csr_tpu_torch.ops import spmv as spmv_op

    def per_call(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host = (time.perf_counter() - t0) / iters * 1e3
        end.synchronize()
        return start.elapsed_time(end) / iters, host

    for layout, x, _, call in main_layouts:
        xd = torch.from_numpy(x).cuda()
        ms, host = per_call(lambda: spmv_op.spmv(layout, xd))
        plain_ms, _ = per_call(lambda: spmv_op.spmv_reference(layout, xd))
        with use_kernel("cuda"):
            call_ms, call_host = per_call(lambda: call(xd))
        print(f"[5] alone at {layout.nrows}x{layout.ncols} (nnz {layout.nnz}, "
              f"{layout.nbytes} B): kernel {ms:.5f} ms "
              f"({layout.nbytes / ms / 1e6:.2f} GB/s, "
              f"{layout.nnz / ms / 1e6:.3f} Gnnz/s; host enqueue {host:.5f} "
              f"ms), plain {plain_ms:.5f} ms, CSR.{call.__name__} "
              f"{call_ms:.5f} ms (host enqueue {call_host:.5f} ms); card {card}")


def main():
    card = phase_environment()
    phase_kernel_vs_plain()

    from csr_tpu_torch.ops import spmv as spmv_op

    fl = flagship()
    ml = movielens_shape()
    spmv_op.launches = 0
    main_layouts = phase_main_path("3", *fl, fl[-1])
    main_layouts += phase_main_path("4", *ml)
    launches = spmv_op.launches
    assert launches == 4, launches

    # the kernel against its plain version at the main path's shapes (these
    # launches come after the count was read)
    max_err = 0.0
    for layout, x, a, _ in main_layouts:
        xd = torch.from_numpy(x).cuda()
        y, y_ref = spmv_op.spmv(layout, xd), spmv_op.spmv_reference(layout, xd)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        max_err = max(max_err, err)
        share = spmv_share(y, y_ref.cpu().numpy(), a, x)
        print(f"[5] kernel vs plain at {layout.nrows}x{layout.ncols}: max abs "
              f"err {err:.3g} (|y| up to {float(y_ref.abs().max()):.4g}), "
              f"share of bound {share:.3g}")

    ms, plain_ms = phase_timing(*main_layouts[0][:2], card)
    phase_alone(main_layouts, card)
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=max_err, ms=ms, plain_ms=plain_ms
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
