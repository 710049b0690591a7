"""
Smoke test of the csr_tpu_torch main path on one CUDA card.

    python3 chip_smoke.py

It builds the CUDA kernels from ``csr_tpu_torch/csrc`` (into
``csr_tpu_torch/_build/``, one ``nvcc`` per source, side by side) and
runs twenty-four phases; any failure raises and the script exits nonzero.  It
needs a CUDA device and never falls back to the CPU: every matrix is
built with no device named and must land on the card.

1. Environment: the card's name and power limit, the CUDA version, each
   kernel's build time and ptxas report (no spills in the SpMM, bucket
   and CSR-form kernels).
2. The SpMV kernel against its plain PyTorch version (``spmv_reference``)
   on the card, on small seeded layouts for window 128/256 x pair 1/2/4.
3. SpMV main path at the flagship: ``CSR.mult_vec`` and ``CSR.mult_vec_t``
   of the 32768^2 matrix with 327 entries per row (10.7M), against scipy.
4. The same at the MovieLens-25M shape: 162,541 users x 59,047 items,
   25,000,095 ratings, made from a seed.
5. The SpMV kernel against its plain version at the main path's four
   layouts; kernel and plain-version times at the flagship over chained
   iterations timed with CUDA events; a ``torch.profiler`` view of 20
   chained iterations; each main-path layout's times alone.
6. The SpMM kernel against both plain versions (``spmm_reference``, slot
   by slot, and ``spmm_regrouped``, the kernel's algorithm) on the card:
   the six (window, pair) variants at n = 1, 3, 50, 64, 256, 300 and 1100
   (every lane mapping, padded copies, one to nine column tiles), a
   micro-row at the 127-entry cap, inf in the rows of B that only padding
   slots point to, a misaligned B, the column tiles split by force, and
   a 128-row window whose entries sit in one row.
7. SpMM main path at the flagship: ``CSR.mult_dense`` with a seeded B of
   32768 x 256, against scipy on a column slice.
8. The same at the MovieLens-25M shape with B of 59,047 x 50 (R Q of an
   ALS half-step at lenskit BiasedMF's 50 features).
9. ``CSR.multiply`` and ``multiply(transpose=True)`` of two seeded 8192^2
   matrices with 20 entries per row: B densifies, A runs the SpMM kernel
   on an 8192-wide operand; against scipy's product.
10. The SpMM kernel against both plain versions at the main path's
    shapes; kernel and plain-version times at the flagship and at the
    MovieLens-25M shape over chained iterations (CUDA events) and the
    kernel's device time by ``torch.profiler``.
11. The densify threshold: at 8192^2 with B 50, 128, 256 and 8192 wide, the
    SpMM kernel against the densified f32 ``torch.matmul`` (TF32 off),
    alone and as whole ``CSR.mult_dense`` calls, at densities 1e-3 ..
    3e-1 (a whole call off the dense route takes the port's sparse route:
    the CSR-form SpMM where the layout would be mostly padding, at the
    lowest densities); the route the port picks must cost at most 1.5
    times the faster one at every point.

12. The bucket-selecting SpMV kernel against its plain version
    (``spmv_bucket_reference``) on the card: small seeded stacks of two
    layers by three buckets, one of them empty, window 128/256 x pair
    1/2/4, every bucket of every layer, adding into a non-zero ``y``;
    held to the SpMV bound against the plain version and against scipy.
13. The ring main path in the mesh's local form with D = 4 (what a
    four-card ring would hold, on one card) at the flagship and at the
    MovieLens-25M shape: ``partition_ring_mb`` -> ``.shard(make_mesh(4))``
    -> ``scatter_x`` -> ``spmv_ring_mb`` -> ``collect_rows``, against scipy
    and against ``CSR.mult_vec`` of the unsplit matrix; the stack's bytes,
    fill, share of padding groups, packing time and launch count.
14. ``mb_dist.spmv``, ``spmv_halo`` and ``spmv_t`` (replicated and
    scattered) at the flagship with D = 4, against scipy; the SpMV kernel
    against its plain version on every shard's view of the stacks; the
    portable ``ring`` and ``dist`` forms beside them, and
    ``entry.dryrun_multichip(4)``.
15. Ring times at both shapes over chained products (CUDA events): the
    ring on the kernel, ``CSR.mult_vec`` of the unsplit matrix, the ring
    on the plain version; the bucket kernel's device time by
    ``torch.profiler``; the ring's steps alone at both shapes, the kernel
    held to the SpMV bound against its plain version and scipy at every
    step, with the device time of the kernel, the plain version and the
    library call on each step's entries, all by ``torch.profiler``.
16. The yardsticks: ``torch.sparse_csr_tensor(...) @ x`` and ``@ B`` on
    the same products at both shapes (timed only; the port never calls
    them), over chained products and as device time beside the kernels'
    and the plain versions' device time, the rate of SpMM's gather of
    nnz n 4 B of B's rows, and each kernel's bound, the least time the
    card could take: the CSR form (8 B an entry plus row pointers), the
    operand and the result moved once at the published bandwidth, or
    2 nnz n operations at the published f32 rate, whichever is larger.
17. lenskit's item-item path at the MovieLens-25M shape (repeated pairs
    summed: 24,463,578 ratings): ``Rt = R.transpose()`` against scipy's
    ``R.T`` (equal arrays), ``normalize_rows("center")`` then ``"unit"``
    against numpy, and the similarities of the first 1,024 items,
    ``blk.multiply(Rt, transpose=True)`` and ``blk.multiply(R)``: past
    the dense budget, so both take the ``esc`` route; against scipy's
    products (structure and values), then ``filter_nnzs(S.values > 0)``
    and ``sort_rows()``.  Expanded terms, chunks, entries, the time of a
    product (CUDA events), scipy's on the host, ``torch.sparse.mm`` of the
    same CSR tensors (timed only) and ESC's chunk budget at 2^24, 2^26
    and 2^28 terms.
18. ``spmv_large`` (with ``_CSR_CROSSOVER`` and ``_CSR_CROSSOVER_LARGE``
    set past every matrix for the phase, so that the CSR-form route, which
    phase 21 takes at this matrix, stays off): ``mult_vec`` of a 4,300,000 x 4,096 matrix with 8
    power-law entries a row (past the packer's 32767 row windows: 2
    chunks, 2 launches) against scipy, each panel's launch against
    ``spmv_reference``, ``mult_vec_t`` on the in-range transpose; then
    the flagship with the budget cut to 64 windows (4 x 4 panels, 16
    launches) against the unsplit ``mult_vec`` and scipy; and the
    layout's fill and bytes an entry on 131,072-row samples, hypersparse
    (12 entries a row over 1M and 4M columns) and not.
19. The harness and the transforms: ``python -m csr_tpu_torch.harness.
    bench``'s path (the flagship chain of 300 products captured in a CUDA
    graph and eager; 0 < vs_baseline <= 1.05; the captured chain's output
    equal to the eager one's within the SpMV bound), ``benchmarks
    --fast`` on scipy, torch and cuda (every product checked against
    scipy), ``bench_weak`` at D = 1, 2, 4, halo and ring (the first step
    of each against scipy); ``torch.func.vmap`` of ``mult_vec`` on the
    cuda backend at the flagship with k = 8 and at the MovieLens-25M shape
    with k = 50: one SpMM launch and no SpMV launch, against a loop of k
    ``mult_vec`` calls, both timed by ``device_ms``; grad on the torch
    backend on the card against ``mult_vec_t(w)`` and ``w[rows] *
    x[cols]``; the host's cost of the SpMV op's dispatch, the flagship's
    eager chain through the op against the wrapper called directly.  Each
    path's launches are counted from 0 and printed, with the launches of
    its CUDA-graph replays (which no counter sees) beside them.
20. The layout chooser on the card: the six (window, pair) layouts of the
    flagship, the MovieLens-25M shape, their transposes and a hypersparse
    matrix (65,536 rows, 12 entries a row over 1,048,576 columns):
    micro-rows, fill, bytes, the SpMV kernel against scipy and its
    device time (``device_ms``, the median of three rounds in turns),
    and per 1024 micro-rows; at the flagship and the MovieLens shape the
    SpMM kernel (B x 256, x 50) and a D = 4 ring step on each window's
    pair-1 layout.  ``choose_layout``'s pick must take at most 1.10 times
    the fastest variant's SpMV time at every matrix (each time the median
    of three rounds).
21. The CSR-form SpMV kernel (``csrc/spmv_csr.cu``) and its route: the
    kernel against ``spmv_csr_reference`` and scipy on small seeded
    matrices (empty rows and an empty matrix, a row of 4.4 shares, int32
    and int64 row pointers, colinds and values off a 16 B boundary,
    structure-only, ``out=``, an inf in x that some rows use, and 3M rows
    cut at share and block edges with rows of 60,000 and 4,096 entries),
    each also into a y of NaN (every row written) and run twice (bitwise
    equal); then at
    phase 20's hypersparse matrix, phase 18's 4.3M x 4,096, the flagship
    and the MovieLens-25M shape (each both ways), 4.3M x 4,096 at 12, 16
    and 24 a row (16.08, 12.06 and 8.62 B a stored entry past the
    packer's range, ``mult_vec``), a sweep of 131,072-row
    power-law matrices (12 a row over 4,096 to 2^22 columns, 64 and 327
    over 2^20; 8-13 over 4,096 and 64 and 96 over 2^16 about the crossover)
    and the realistic hypersparse case (8,388,608 x 2^20,
    ``min(zipf(2.4), 4096)`` entries a row, about 18.5M, both ways, never
    packed): the first ``mult_vec`` / ``mult_vec_t`` of a fresh CSR
    (route and call, host seconds) against scipy, its launches counted
    from 0 and held to its route (one CSR-form launch each way at the
    realistic case, no micro-block layout built on that route); the
    kernel against ``spmv_csr_reference``; device time (``device_ms``) of
    the CSR-form kernel (with the share edges cached on the matrix, as the
    route hands them; its launches by name: the kernel and its carry pass,
    no memset), the micro-block kernel (or ``spmv_large``) where
    it runs, ``torch.sparse_csr_tensor(...) @ x`` and the plain version,
    beside the CSR bound; at the hypersparse matrix a call without edges
    (the kernel's search) against ``csr_shares`` first; bytes a stored
    entry of both forms; the route's pick within 1.10 times the faster
    kernel; the time ratios by layout bytes beside the crossover.
22. The CSR-form SpMM kernel (``csrc/spmm_csr.cu``) and its route: the
    kernel against ``spmm_csr_reference`` and scipy on small seeded
    matrices (empty rows and an empty matrix, a row of 4.9 shares of
    1,024 merge items, a block of dense rows; n = 1, 2, 3, 4, 8, 16, 17,
    32, 33, 50, 64, 65, 128, 129 and 256, every lanes-a-row and load
    width of ``ops/spmm.py:csr_plan``; int32 and int64 row pointers,
    colinds and values off a 16 B boundary, structure-only, B 16 B, 8 B
    and 4 B aligned or with padded rows; each also into a C of NaN and
    run twice, bitwise equal; an inf in B that some rows use); then, at
    n = 50 and 256, at the realistic case
    (n = 50 only), 4.3M x 4,096, phase 20's hypersparse matrix and its
    transpose, phase 21's sweep, the flagship and the MovieLens-25M shape:
    the first ``mult_dense`` of a fresh CSR (route, host seconds), its
    launches counted from 0 and held to its route (one ``spmm_csr``
    launch and no layout at the realistic case and 4.3M x 4,096, n = 50),
    against scipy on a 64-row sample; the kernel against the plain
    version on the card; device time of the CSR-form kernel, the
    micro-block SpMM (one layout, or ``spmm_large``'s chunks and panels),
    ``torch.sparse_csr_tensor(...) @ B`` and the plain version, beside the
    bound (8 B an entry, the row pointers, B's gathered rows and C once);
    the route's pick within 1.10 times the faster kernel; the CSR-form and
    micro-block SpMM timed in turns at 15 131,072-row matrices whose
    layouts cost 8.3-24.1 B a stored entry (8-64 entries a row over
    4,096 columns, 64-128 over 2^16), n = 50 and 256, and at phase 9's
    8192^2 SpGEMM operand, n = 50 to 8,192, with their time ratios by
    layout bytes beside SpMM's crossover; ``vmap`` of ``mult_vec`` at the hypersparse
    matrix, k = 50 (one ``spmm_csr`` launch, no layout); the route
    statistic's peak device memory over the first ``mult_vec`` at 2^27
    entries; and ``mult_vec``, ``mult_vec_t`` and ``mult_dense`` on every
    route after ``values.mul_(2)`` against scipy's products of the new
    values.
23. The CSR-form SpMM in column panels at KDD-Cup'11's R . Q and Rt . P
    and at thinned and swept matrices (:func:`phase_spmm_panels`).
24. The micro-block SpMM at the Netflix Prize's R . Q and Rt . P (B 3.6
    MB in L2; B 96 MB past it, about 207 groups a row window): kernel
    alone, groups, gap to the plain version (:func:`phase_netflix`).

SpMV comparisons use the bound of ``tests/util.py:assert_spmv_close``
(rtol 1e-4 plus 384 f32 eps times the L1 mass of the row's 128-row
window, plus 1e-6), computed on sparse matrices by
``csr_tpu_torch.harness.spmv_share``; SpMM ones that of
``tests/test_mult_dense.py`` (rtol 5e-4, atol 1e-4 times the largest
|result|), and the products ``tests/util.py:tols`` (rtol 5e-4, atol
5e-3).  "share" is the largest error as a fraction of the bound, and
must stay <= 1.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sps
import torch

from csr_tpu_torch.harness import spmv_share
from csr_tpu_torch.utils.profiling import launch_counts

KERNEL = {
    "name": "spmv_microblock",
    "route": "cuda",
    "source": "csr_tpu_torch/csrc/spmv_microblock.cu",
    "replaces": "csr_tpu/ops/spmv.py:79",
}
BUCKET_KERNEL = {
    "name": "spmv_bucket",
    "route": "cuda",
    "source": "csr_tpu_torch/csrc/spmv_bucket.cu",
    "replaces": "csr_tpu/ops/spmv.py:237",
}
SPMM_KERNEL = {
    "name": "spmm_microblock",
    "route": "cuda",
    "source": "csr_tpu_torch/csrc/spmm_microblock.cu",
    "replaces": "csr_tpu/ops/spmm.py:66",
}
# tests/test_mult_dense.py: rtol 5e-4, atol 1e-4 x max(1, max |ref|)
SPMM_RTOL, SPMM_ATOL = 5e-4, 1e-4
# tests/util.py:tols for f32 products
PROD_RTOL, PROD_ATOL = 5e-4, 5e-3


def spmm_share(c, ref, rtol=SPMM_RTOL, atol=SPMM_ATOL) -> float:
    """Largest |c - ref| as a share of tests/test_mult_dense.py's bound
    (rtol * |ref| + atol * max(1, max |ref|)); raises if it exceeds the
    bound or c is not finite."""
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    c = np.asarray(c, np.float64)
    ref = np.asarray(ref, np.float64)
    assert c.shape == ref.shape, (c.shape, ref.shape)
    assert np.all(np.isfinite(c)), "non-finite SpMM output"
    tol = rtol * np.abs(ref) + atol * max(1.0, np.abs(ref).max(initial=0))
    share = float(np.max(np.abs(c - ref) / tol)) if c.size else 0.0
    assert share <= 1.0, f"SpMM outside the bound: share {share:.3g}"
    return share


def product_share(got, ref, scaled=False) -> float:
    """Largest entry of |got - ref| as a share of tests/util.py:tols' f32
    bound (PROD_RTOL * |ref| + PROD_ATOL), over both sparse patterns;
    with ``scaled`` the atol is PROD_ATOL times max(1, max |ref|), as
    tests/util.py:dense_tols and tests/torch_util.py:assert_product_close
    scale it.  Raises if it exceeds the bound."""
    got = sps.csr_matrix(got, dtype=np.float64)
    ref = sps.csr_matrix(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.isfinite(got.data)), "non-finite product"
    diff = abs(got - ref).tocoo()
    if diff.nnz == 0:
        return 0.0
    atol = PROD_ATOL * (max(1.0, np.abs(ref.data).max(initial=0)) if scaled else 1.0)
    # |ref| at each coordinate of the difference: a search of the sorted
    # keys (scipy's ref[rows, cols] takes minutes at 10^7 coordinates)
    ref.sum_duplicates()
    ncols = ref.shape[1]
    key_ref = np.repeat(np.arange(ref.shape[0], dtype=np.int64),
                        np.diff(ref.indptr)) * ncols + ref.indices
    key = diff.row.astype(np.int64) * ncols + diff.col
    at = np.minimum(np.searchsorted(key_ref, key), max(ref.nnz - 1, 0))
    ref_at = (np.where(key_ref[at] == key, ref.data[at], 0.0) if ref.nnz
              else np.zeros(diff.nnz))
    tol = PROD_RTOL * np.abs(ref_at) + atol
    share = float(np.max(diff.data / tol))
    assert share <= 1.0, f"product outside the bound: share {share:.3g}"
    return share


def per_call(fn, iters=50):
    """Milliseconds per call of ``fn`` between two CUDA events (after one
    warm-up call), and the host's milliseconds to enqueue a call."""
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


def device_ms(fn, calls=10, tries=8, by_kernel=False, floor_ms=0.0):
    """Milliseconds of device time per call of ``fn``: the time of every
    kernel and copy ``torch.profiler`` saw on the card over ``calls`` calls,
    so the host's pace is left out.  The same clock for a hand-written
    kernel, its plain version and a library call.  With ``by_kernel``,
    also each kernel's and copy's milliseconds a call, by name.

    The profiler can lose records (late in a long process, mostly those of
    a window's first milliseconds), so the window opens with 20 ms of calls
    that are not counted: only records that start after a mark set behind
    them are.  Each of those calls is waited for: otherwise the host would
    queue as many as it can launch in 20 ms, seconds of device work for a
    product of 10 ms.  Every call launches the same kernels, so a window
    counts only if it kept a whole number of records a call of every
    kernel that the uncounted calls ran (none lost whole), and if their
    time is no more than the counted calls took on the host's clock, and
    (with ``floor_ms``, the least time the card could take for the bytes
    ``fn`` must move) if a call reads no less than that floor: windows
    have read variants of phase 20 at half their time, below the bytes
    they move, with every record kept.  A window that fails a test is
    taken again, ``tries`` times in all; then this raises.  Nothing is
    extrapolated from a window with records missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "device_ms.counted"
    fn()
    torch.cuda.synchronize()
    why = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.02:
                fn()
                torch.cuda.synchronize()
            with record_function(mark):
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        start = min(e.time_range.start for e in events if e.name == mark)
        # device events only: a CPU op's entry repeats its kernels' time,
        # and so does the mark's own range on the device's timeline
        times, ran = {}, set()
        for e in events:
            if e.device_type == DeviceType.CUDA and e.name != mark:
                if e.time_range.start >= start:
                    times.setdefault(e.name, []).append(e.time_range.elapsed_us())
                else:
                    ran.add(e.name)
        total_us = sum(map(sum, times.values()))
        partial = ([f"{len(us)} of {name[:40]}" for name, us in times.items()
                    if len(us) % calls]
                   + [f"0 of {name[:40]}" for name in ran - set(times)])
        if not times:
            why.append("no device record")
        elif partial:
            why.append(f"records kept over {calls} calls: {', '.join(partial)}")
        elif total_us > 1.02 * wall_us:
            why.append(f"{total_us:.0f} us on the device in {wall_us:.0f} us")
        elif total_us / calls / 1e3 < floor_ms:
            why.append(f"{total_us / calls / 1e3:.5f} ms a call, under the "
                       f"floor of {floor_ms:.5f} ms")
        elif by_kernel:
            return total_us / calls / 1e3, {name: sum(us) / calls / 1e3
                                            for name, us in times.items()}
        else:
            return total_us / calls / 1e3
        print(f"[device_ms] window taken again ({why[-1]})")
    raise RuntimeError(f"device_ms: no whole window in {tries}: {why}")


def fit(y, n, dim=0):
    """``y`` cut or zero-padded to length ``n`` along ``dim``: a result
    made into the next operand of a chained loop on a matrix that is not
    square."""
    if y.shape[dim] >= n:
        return y.narrow(dim, 0, n).contiguous()
    pad = (0, 0) * (y.ndim - 1 - dim) + (0, n - y.shape[dim])
    return torch.nn.functional.pad(y, pad)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    from csr_tpu_torch.ops import _cuda, spmm as spmm_op, spmv as spmv_op

    card = card_line()
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_cuda.ENTRIES)) as pool:  # one nvcc each
        list(pool.map(_cuda.library, _cuda.ENTRIES))
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name in _cuda.ENTRIES:
        print(f"[1] {name}: {_cuda.build_seconds[name]:.2f} s")
        for line in _cuda.build_log[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   ptxas: {line.strip()}")
    # the SpMM launch plan counts on five blocks of 256 threads an SM: of
    # 65,536 registers and 233,472 B of shared memory (1 KB more a block)
    log = _cuda.build_log["spmm_microblock"]
    used = re.findall(r"Used (\d+) registers.*?(\d+) bytes smem", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    assert len(used) == len(spills) == 3, log
    assert all(int(st) == int(ld) == 0 for st, ld in spills), spills
    blocks = min(min(65536 // (int(r) * 256), 233472 // (int(sm) + 1024))
                 for r, sm in used)
    assert blocks * 132 >= spmm_op.BLOCKS_IN_FLIGHT, (used, blocks)
    print(f"[1] spmm_microblock: no spills, {blocks} blocks an SM by registers "
          "and shared memory")
    # the bucket kernel's grid counts on BLOCKS_PER_SM blocks an SM of
    # WARPS_PER_BLOCK warps, each warp with its ring of stages in shared
    # memory: the runtime must agree
    log = _cuda.build_log["spmv_bucket"]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    assert len(spills) == 1 and spills[0] == ("0", "0"), log
    blocks, threads, smem = _cuda.spmv_bucket_occupancy()
    assert blocks == spmv_op.BLOCKS_PER_SM, (blocks, spmv_op.BLOCKS_PER_SM)
    assert threads == 32 * spmv_op.WARPS_PER_BLOCK, threads
    print(f"[1] spmv_bucket: no spills, {blocks} block an SM of {threads} "
          f"threads and {smem} B of shared memory, by the CUDA runtime")
    # the CSR-form kernels and the micro-block SpMV: no spills (spmv_csr's
    # build is held to 32 registers, eight blocks an SM; spmv_microblock's
    # to 32, sixteen blocks an SM)
    for name in ("spmv_csr", "spmm_csr", "spmv_microblock"):
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                            _cuda.build_log[name])
        assert spills and all(st == ld == "0" for st, ld in spills), _cuda.build_log[name]
        print(f"[1] {name}: no spills in its {len(spills)} functions")
    return card


def small_matrix(seed):
    """A 1000 x 3000 f32 matrix of density 0.02 with one (rb, cb) group of
    228 entries that spans two micro-rows, and the generator that drew it
    (for the operands)."""
    rng = np.random.default_rng(seed)
    a = sps.random(1000, 3000, 0.02, format="lil", random_state=rng,
                   dtype=np.float32)
    a[3, :128] = rng.standard_normal(128)
    a[4, :100] = rng.standard_normal(100)
    return a.tocsr(), rng


def phase_kernel_vs_plain():
    """Kernel against spmv_reference on small seeded layouts, all six
    (window, pair) variants, with one (rb, cb) group of 228 entries that
    spans two micro-rows."""
    from csr_tpu_torch.ops import microblock, spmv as spmv_op

    a, rng = small_matrix(7)
    nrows, ncols = a.shape
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
    csr = CSR(nrows, ncols, nnz, rowptr, cols, vals)
    assert csr.device.type == "cuda", csr.device
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
              f"{lay.nbytes} B; first call {secs:.3f} s (host packing "
              f"included); share of bound vs scipy {s:.3g}")
    print(f"[{tag}] launches grew by {grew}")
    return (layout, x, a, csr.mult_vec), (layout_t, xt, at, csr.mult_vec_t)


def chained_times(tag, layout, kernel, plain, x0, iters, plain_iters,
                  plain_reps, profile_iters):
    """Seconds per chained iteration of ``kernel`` and of its ``plain``
    version on ``layout``, each output max-normalised into the next input
    (as bench.py): plain, kernel, kernel, plain on the same card, the best
    of each.  Then the device time by kernel name over ``profile_iters``
    chained kernel iterations (torch.profiler), and the device's busy
    share of that window."""
    from torch.profiler import ProfilerActivity, profile

    from csr_tpu_torch.utils.profiling import timed_chained

    def chained(fn):
        def step(v):
            y = fn(layout, v)
            return y / y.abs().max().clamp_min(1e-30)
        return step

    kern, slow = chained(kernel), chained(plain)
    t_plain = timed_chained(slow, x0, iters=plain_iters, reps=plain_reps)
    t_kern = timed_chained(kern, x0, iters=iters)
    t_kern = min(t_kern, timed_chained(kern, x0, iters=iters))
    t_plain = min(t_plain, timed_chained(slow, x0, iters=plain_iters,
                                         reps=plain_reps))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        v = x0
        for _ in range(profile_iters):
            v = kern(v)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    print(f"[{tag}] profile of {profile_iters} chained kernel iterations: wall "
          f"{wall * 1e3:.4f} ms, device busy {busy * 1e3:.4f} ms "
          f"({busy / wall:.3f})")
    for e in dev[:5]:
        print(f"[{tag}]   {e.self_device_time_total / e.count:9.3f} us "
              f"x{e.count} {e.key[:70]}")
    return t_kern, t_plain


def phase_timing(layout, x, card):
    """SpMV kernel and plain version at the flagship (chained_times)."""
    from csr_tpu_torch.ops import spmv as spmv_op
    from csr_tpu_torch.utils.profiling import peak_gbps

    t_kern, t_plain = chained_times(
        "5", layout, spmv_op.spmv, spmv_op.spmv_reference,
        torch.from_numpy(x).cuda(), iters=300, plain_iters=100, plain_reps=3,
        profile_iters=20)
    peak = peak_gbps(torch.cuda.get_device_name(0))
    for name, t in (("kernel", t_kern), ("plain", t_plain)):
        gbps = layout.nbytes / t / 1e9
        frac = f"{gbps / peak:.4f} of {peak} GB/s" if peak else "peak unknown"
        print(f"[5] {name}: {t * 1e3:.5f} ms/iter, {gbps:.2f} GB/s streamed "
              f"({frac}), {layout.nnz / t / 1e9:.3f} Gnnz/s; card {card}")
    return t_kern * 1e3, t_plain * 1e3


def phase_alone(main_layouts, card):
    """Each main-path layout alone: the kernel wrapper, its plain version
    and the whole ``CSR.mult_vec``/``mult_vec_t`` call, 50 calls on one
    operand between two CUDA events.  The host clock over the same loop
    gives the time to enqueue a call: where it is as long as the event
    time, the host, not the card, sets the pace."""
    from csr_tpu_torch.kernels import use_kernel
    from csr_tpu_torch.ops import spmv as spmv_op

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


SPMM_WIDTHS = (1, 3, 50, 64, 256, 300, 1100)


def check_spmm(layout, a, b, bd=None):
    """The SpMM kernel on ``layout`` (of the scipy matrix ``a``) times the
    host array ``b`` against both plain versions and scipy, each within
    spmm_share's bound; rows of ``b`` that hold inf must be rows no entry
    reads (only a read from a padding slot could then make the result
    non-finite), and count as zero for scipy.  Returns the largest
    |kernel - plain| and the share of the bound it takes.  ``bd`` is ``b``
    on the card, where the caller has placed it itself."""
    from csr_tpu_torch.ops import spmm as spmm_op

    if bd is None:
        bd = torch.from_numpy(b).cuda()
    c = spmm_op.spmm(layout, bd)
    torch.cuda.synchronize()
    assert c.shape == (layout.nrows, b.shape[1]) and c.dtype == torch.float32
    err = share = 0.0
    for plain in (spmm_op.spmm_reference, spmm_op.spmm_regrouped):
        c_ref = plain(layout, bd)
        err = max(err, float((c - c_ref).abs().max()))
        share = max(share, spmm_share(c, c_ref.cpu().numpy()))
    spmm_share(c, a.astype(np.float64) @ np.where(np.isfinite(b), b, 0.0))
    return err, share


def phase_spmm_kernel_vs_plain():
    """SpMM kernel against both plain versions (spmm_reference, slot by
    slot, and spmm_regrouped, the kernel's algorithm) and scipy on small
    seeded layouts: the six (window, pair) variants at the widths of
    SPMM_WIDTHS (8, 16 and 32 lanes a row of B; padded copies at 1, 3 and
    50; one, three and nine column tiles), with one (rb, cb) group of 228
    entries that spans two micro-rows, the first at the 127-entry cap.
    Column 0 of every 128-wide window is empty and B holds inf there, where
    only padding slots point.  Then a B that is not 16 B aligned, a forced
    split of the column tiles, and a group whose 128 rows are empty but
    one."""
    from csr_tpu_torch.ops import microblock, spmm as spmm_op

    a, rng = small_matrix(8)
    a = a.tolil()
    a[:, ::128] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    nrows, ncols = a.shape
    worst = 0.0
    for window in (128, 256):
        for pair in (1, 2, 4):
            layout = microblock.build_microblocks_host(
                nrows, ncols, a.indptr, a.indices, a.data,
                window=window, pair=pair, device="cuda",
            )
            shares = []
            for n in SPMM_WIDTHS:
                b = rng.standard_normal((ncols, n)).astype(np.float32)
                b[::128] = np.inf
                err, share = check_spmm(layout, a, b)
                worst = max(worst, err)
                shares.append(share)
            print(f"[6] window {window} pair {pair}: {layout.n_microrows} "
                  f"micro-rows; n = {', '.join(map(str, SPMM_WIDTHS))}: share "
                  "of bound vs plain " + ", ".join(f"{s:.3g}" for s in shares))
    n_groups = layout.n_microrows // microblock.ACC_GROUP
    shares = []
    for n in (3, 50, 64):  # B one float past a 16 B boundary
        b = rng.standard_normal((ncols, n)).astype(np.float32)
        b[::128] = np.inf
        buf = torch.empty(ncols * n + 1, device="cuda")
        bd = buf[1:].view(ncols, n).copy_(torch.from_numpy(b))
        assert bd.data_ptr() % 16 == 4 and bd.is_contiguous()
        err, share = check_spmm(layout, a, b, bd=bd)
        worst = max(worst, err)
        shares.append(share)
    print("[6] misaligned B, n = 3, 50, 64: share "
          + ", ".join(f"{s:.3g}" for s in shares))
    # nine column tiles over 2, 3 and 5 blocks a group: the slab that the
    # plan sizes its chunks to is set so that a chunk takes 5, 3 and 2 tiles
    b = rng.standard_normal((ncols, 1100)).astype(np.float32)
    in_flight = -(-spmm_op.BLOCKS_IN_FLIGHT // n_groups)
    slab = spmm_op.L2_SLAB_BYTES
    try:
        for per_chunk in (5, 3, 2):
            spmm_op.L2_SLAB_BYTES = per_chunk * in_flight * 4 * (nrows + ncols) * 128
            plan = spmm_op.launch_plan(1100, nrows, ncols, n_groups)
            assert (plan.n_tiles, plan.tiles_per_chunk) == (9, per_chunk), plan
            err, share = check_spmm(layout, a, b)
            worst = max(worst, err)
            print(f"[6] n 1100 in {plan.chunks} chunks of "
                  f"{plan.tiles_per_chunk} tiles: share {share:.3g}")
    finally:
        spmm_op.L2_SLAB_BYTES = slab
    # one row of a 128-row window holds every entry (a full group and more)
    lone = sps.lil_matrix((256, 6000), dtype=np.float32)
    cols = rng.choice(6000, 4500, replace=False)
    lone[133, cols] = rng.standard_normal(4500)
    lone = lone.tocsr()
    layout = microblock.build_microblocks_host(
        256, 6000, lone.indptr, lone.indices, lone.data, device="cuda")
    b = rng.standard_normal((6000, 50)).astype(np.float32)
    err, share = check_spmm(layout, lone, b)
    worst = max(worst, err)
    print(f"[6] one row of 4500 entries in {layout.n_microrows} micro-rows: "
          f"share {share:.3g}")
    print(f"[6] kernel vs plain max abs err {worst:.3g}")
    return worst


def phase_mult_dense(tag, csr, a, b):
    """``CSR.mult_dense`` on the cuda kernel (the matrix's layout is cached
    from the SpMV phase), against scipy on a 16-column slice of B."""
    from csr_tpu_torch.kernels import use_kernel

    bd = torch.from_numpy(b).cuda()
    with use_kernel("cuda"):
        t0 = time.perf_counter()
        c = csr.mult_dense(bd)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    assert c.shape == (csr.nrows, b.shape[1]) and c.dtype == torch.float32
    assert c.device.type == "cuda"
    ref = a.astype(np.float64) @ b[:, :16].astype(np.float64)
    share = spmm_share(c[:, :16], ref)
    print(f"[{tag}] mult_dense: {csr.nrows}x{csr.ncols} nnz {csr.nnz} times "
          f"B {b.shape[0]}x{b.shape[1]}: first call {secs * 1e3:.3f} ms "
          f"(layout cached); share of bound vs scipy (16 columns) {share:.3g}")
    return bd


def sparse_square(n, per_row, seed):
    """Host CSR arrays of an n x n f32 matrix with ``per_row`` uniformly
    drawn columns in each row (repeats kept), from a seed."""
    rng = np.random.default_rng(seed)
    rowptr = np.arange(n + 1, dtype=np.int64) * per_row
    cols = rng.integers(0, n, n * per_row).astype(np.int32)
    vals = rng.standard_normal(n * per_row).astype(np.float32)
    return rowptr, cols, vals


def phase_multiply():
    """``CSR.multiply`` and ``multiply(transpose=True)`` of two seeded
    8192^2 matrices with 20 entries per row (density 2.4e-3): B densifies
    within the dense budget, A is too sparse to, so the sparse leg runs the
    SpMM kernel on an 8192-wide operand.  Against scipy, zeros filtered."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel

    n, per_row = 8192, 20
    mats = []
    for seed in (81, 82):
        rp, ci, v = sparse_square(n, per_row, seed)
        mats.append((CSR(n, n, len(ci), rp, ci, v),
                     sps.csr_matrix((v, ci, rp), shape=(n, n))))
    (A, a), (B, b) = mats
    assert A.device.type == B.device.type == "cuda"
    assert not cuda_k._dense_affordable(A, n), "A densifies: lower its density"
    for transpose in (False, True):
        with use_kernel("cuda"):
            t0 = time.perf_counter()
            p = A.multiply(B, transpose=transpose)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        ref = a @ (b.T if transpose else b)
        ref.sum_duplicates()
        ref.eliminate_zeros()
        assert p.device.type == "cuda" and (p.nrows, p.ncols) == ref.shape
        got = p.to_scipy()
        assert np.all(got.data != 0), "stored zeros"
        share = product_share(got, ref)
        print(f"[9] multiply(transpose={transpose}): {n}x{n} with {A.nnz} and "
              f"{B.nnz} entries -> {p.nnz} (scipy {ref.nnz}); first call "
              f"{secs:.3f} s (packing and densify included); share of bound "
              f"vs scipy {share:.3g}")
    return A, b


def phase_spmm_timing(tag, layout, b0, card):
    """SpMM kernel and plain version at one main-path shape
    (chained_times; C, cut or zero-padded to B's rows, feeds the next
    iteration as B)."""
    from csr_tpu_torch.ops import spmm as spmm_op

    def on(fn):
        return lambda lay, v: fit(fn(lay, v), lay.ncols)

    t_kern, t_plain = chained_times(
        "10", layout, on(spmm_op.spmm), on(spmm_op.spmm_reference), b0,
        iters=20, plain_iters=3, plain_reps=2, profile_iters=5)
    cells = layout.nnz * b0.shape[1]
    for name, t in (("kernel", t_kern), ("plain", t_plain)):
        print(f"[10] {tag}, {name}: {t * 1e3:.5f} ms/iter, {cells / t / 1e9:.3f} "
              f"G entry-columns/s ({cells * 4 / t / 1e9:.1f} GB/s of B rows "
              f"read); card {card}")
    return t_kern * 1e3, t_plain * 1e3


def crossover(rows):
    """The density at which whole dense-route calls start to beat
    kernel-route ones, log-interpolated between the measured densities
    ``rows = [(density, kernel_ms, dense_ms), ...]``; None if they never
    do, the first density if they always do."""
    sign = [np.log(dense / kern) for _, kern, dense in rows]
    if sign[0] <= 0:
        return rows[0][0]
    for (d0, _, _), (d1, _, _), r0, r1 in zip(rows, rows[1:], sign, sign[1:]):
        if r0 > 0 >= r1:
            f = r0 / (r0 - r1)
            return float(np.exp(np.log(d0) + f * (np.log(d1) - np.log(d0))))
    return None


def phase_densify_threshold(card):
    """Where the densified f32 matmul (TF32 off) starts to beat the SpMM
    kernel: 8192^2 matrices at densities 1e-3 .. 3e-1 times B of width 50
    (an ALS half-step), 128, 256 and 8192 (the sparse leg of an 8192^2
    ``multiply``).  Timed alone (layout and dense form prebuilt) and as
    whole ``CSR.mult_dense`` calls on each route (the dense route
    densifies anew in every call, as a released handle drops its dense
    form; off the dense route the call takes the port's sparse route,
    the CSR-form SpMM at the lowest densities).  At every point the route
    that ``_dense_affordable`` picks must cost at most 1.5 times the
    faster one."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel
    from csr_tpu_torch.ops import spmm as spmm_op

    n, widths = 8192, (50, 128, 256, 8192)
    rng = np.random.default_rng(11)
    bs = {w: rng.standard_normal((n, w)).astype(np.float32) for w in widths}
    bds = {w: torch.from_numpy(b).cuda() for w, b in bs.items()}
    saved = cuda_k._DENSIFY_CROSSOVER
    rows = {w: [] for w in widths}
    slow = []  # points where the picked route costs over 1.5 x the faster
    try:
        for d in (1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1):
            a = sps.random(n, n, d, format="csr", random_state=rng,
                           dtype=np.float32)
            csr = CSR.from_scipy(a)
            assert csr.device.type == "cuda", csr.device
            layout = cuda_k._cached_layout(csr)
            h = cuda_k.to_handle(csr)
            dense = h.dense
            for w in widths:
                b, bd = bs[w], bds[w]
                iters = 5 if w > 1024 else 20
                ref = a.astype(np.float64) @ b[:, :16].astype(np.float64)
                spmm_share(spmm_op.spmm(layout, bd)[:, :16], ref)
                spmm_share(cuda_k._matmul_f32(dense, bd)[:, :16], ref)
                k_ms, _ = per_call(lambda: spmm_op.spmm(layout, bd), iters)
                m_ms, _ = per_call(lambda: cuda_k._matmul_f32(dense, bd), iters)
                picks_dense = cuda_k._dense_affordable(csr, w)
                with use_kernel("cuda"):
                    cuda_k._DENSIFY_CROSSOVER = ((1, 2.0),)  # the kernel route
                    kc_ms, _ = per_call(lambda: csr.mult_dense(bd), iters)
                    cuda_k._DENSIFY_CROSSOVER = ((1, 0.0),)  # the dense route
                    dc_ms, _ = per_call(lambda: csr.mult_dense(bd), iters)
                cuda_k._DENSIFY_CROSSOVER = saved
                rows[w].append((d, kc_ms, dc_ms))
                picked = dc_ms if picks_dense else kc_ms
                print(f"[11] density {d:g} (nnz {a.nnz}), B x {w}: kernel "
                      f"{k_ms:.5f} ms, matmul {m_ms:.5f} ms; whole mult_dense: "
                      f"kernel route {kc_ms:.5f} ms, dense route {dc_ms:.5f} "
                      f"ms; the port picks {'dense' if picks_dense else 'kernel'}"
                      f" ({picked / min(kc_ms, dc_ms):.3f} of the faster); "
                      f"card {card}")
                if picked > 1.5 * min(kc_ms, dc_ms):
                    slow.append((d, w, kc_ms, dc_ms))
            cuda_k.release_handle(h)
            del csr, layout, h, dense
    finally:
        cuda_k._DENSIFY_CROSSOVER = saved
    for w in widths:
        x = crossover(rows[w])
        where = "never within 3e-1" if x is None else f"{x:.4g}"
        print(f"[11] B x {w}: whole dense-route calls beat kernel-route ones "
              f"from density {where}; the port's threshold is "
              f"{cuda_k._min_density(w):.4g}")
    assert not slow, f"(density, n, kernel ms, dense ms) picked badly: {slow}"


def small_stack(window, pair, seed, n_layers=2, n_buckets=3, nrows=512):
    """A stack of ``n_layers`` layers by ``n_buckets`` buckets of nrows x 768
    layouts at one (window, pair), bucket (l + 1) % n_buckets of layer l
    empty, padded to the largest as the ring pads its buckets; and the
    scipy matrix of each bucket, by layer."""
    from csr_tpu_torch.ops import microblock

    ncols = 768
    mats, layouts = [], []
    for l in range(n_layers):
        for b in range(n_buckets):
            rng = np.random.default_rng(seed + 10 * l + b)
            density = 0.0 if b == (l + 1) % n_buckets else 0.02 * (1 + (l + b) % 3)
            a = sps.random(nrows, ncols, density, format="csr", random_state=rng,
                           dtype=np.float32)
            mats.append(a)
            layouts.append(microblock.build_microblocks_host(
                nrows, ncols, a.indptr, a.indices, a.data, window=window,
                pair=pair, device="cpu"))
    shape = (n_layers, n_buckets, max(lay.vals.shape[0] for lay in layouts))
    vals = torch.zeros(*shape, 128)
    meta = torch.zeros(*shape, 128, dtype=torch.uint16)
    rbcb = torch.zeros(shape, dtype=torch.int32)
    groups = torch.zeros(shape[:2], dtype=torch.int32)
    for i, lay in enumerate(layouts):
        l, b, m = i // n_buckets, i % n_buckets, lay.vals.shape[0]
        vals[l, b, :m], meta[l, b, :m], rbcb[l, b, :m] = lay.vals, lay.meta, lay.rbcb
        groups[l, b] = lay.n_microrows // microblock.ACC_GROUP
    stack = microblock.BucketStack(
        nrows, ncols, window, vals.cuda(), meta.cuda(), rbcb.cuda(),
        groups.cuda(), int(groups.max()))
    return stack, [mats[l * n_buckets:(l + 1) * n_buckets] for l in range(n_layers)]


def per_warp(stack, held, blocks):
    """The most micro-rows a warp of the bucket kernel takes on ``blocks``
    blocks with ``held`` (a host tensor)."""
    from csr_tpu_torch.ops import spmv as spmv_op

    work = spmv_op.bucket_work(stack, held, blocks)
    return -(-max(map(len, work)) // spmv_op.WARPS_PER_BLOCK)


def check_bucket(stack, mats, held, x, y0):
    """One launch of the bucket kernel with ``held`` (a host tuple) on the
    card, adding into ``y0``, against spmv_bucket_reference and scipy:
    what each layer gained is held to spmv_share's bound against both, and
    a layer whose held bucket is empty or out of range must gain nothing.
    Returns the largest |kernel - plain| and the two largest shares."""
    from csr_tpu_torch.ops import spmv as spmv_op

    hd = torch.tensor(held, dtype=torch.int32, device="cuda")
    xd, y0d = torch.from_numpy(x).cuda(), torch.from_numpy(y0).cuda()
    y = spmv_op.spmv_bucket(stack, hd, xd, y0d.clone())
    y_ref = spmv_op.spmv_bucket_reference(stack, hd, xd, y0d.clone())
    torch.cuda.synchronize()
    plain = share = 0.0
    for l, h in enumerate(held):
        if not 0 <= h < stack.n_buckets or mats[l][h].nnz == 0:
            assert torch.equal(y[l], y0d[l]), f"layer {l}, held {h} added"
            continue
        a, added = mats[l][h], y[l] - y0d[l]
        plain = max(plain, spmv_share(added, (y_ref[l] - y0d[l]).cpu().numpy(),
                                      a, x[l]))
        share = max(share, spmv_share(added, a.astype(np.float64) @ x[l], a, x[l]))
    return float((y - y_ref).abs().max()), plain, share


def phase_bucket_vs_plain():
    """The bucket kernel against spmv_bucket_reference on small seeded
    stacks: all six (window, pair) variants of two layers by three
    buckets, every bucket of both layers (empty ones among them); then the
    persistent loop's corners: a one-layer stack and a D = 7 one, on the
    card's grid (a micro-row a warp at most), on four blocks and on one
    (many micro-rows a warp, each stage of shared memory taken many
    times), with every held bucket in turn, held indices outside the stack
    for some layers only, and every held bucket empty (no micro-row).  Always adding
    into a non-zero y; what each launch added is held to spmv_share's
    bound against the plain version's and against scipy's product."""
    from csr_tpu_torch.ops import spmv as spmv_op

    worst = 0.0
    for window in (128, 256):
        for pair in (1, 2, 4):
            stack, mats = small_stack(window, pair, seed=100 + window + pair)
            rng = np.random.default_rng(window + pair)
            x = rng.standard_normal((2, stack.ncols)).astype(np.float32)
            y0 = rng.standard_normal((2, stack.nrows)).astype(np.float32)
            plain = share = 0.0
            for held in ((0, 1), (1, 2), (2, 0)):
                err, p, s = check_bucket(stack, mats, held, x, y0)
                worst, plain, share = max(worst, err), max(plain, p), max(share, s)
            print(f"[12] window {window} pair {pair}: groups "
                  f"{stack.groups.tolist()}; largest share of bound vs plain "
                  f"{plain:.3g}, vs scipy {share:.3g}")
    saved = spmv_op._sm_count, spmv_op.BLOCKS_PER_SM
    try:
        for n_layers, n_buckets, window in ((1, 3, 128), (7, 7, 256)):
            stack, mats = small_stack(window, 2, 300 + n_layers, n_layers,
                                      n_buckets, nrows=1024)
            rng = np.random.default_rng(n_layers)
            x = rng.standard_normal((n_layers, stack.ncols)).astype(np.float32)
            y0 = rng.standard_normal((n_layers, stack.nrows)).astype(np.float32)
            layers = range(n_layers)
            helds = [tuple((l + k) % n_buckets for l in layers)
                     for k in range(n_buckets)]
            helds.append(tuple((-1, n_buckets, 0)[l % 3] for l in layers))
            helds.append(tuple((l + 1) % n_buckets for l in layers))  # all empty
            for grid, sms, per_sm in (("the card's", saved[0], saved[1]),
                                      ("four blocks", lambda dev: 4, 1),
                                      ("one block", lambda dev: 1, 1)):
                spmv_op._sm_count, spmv_op.BLOCKS_PER_SM = sms, per_sm
                blocks = spmv_op.bucket_grid(stack, sms(stack.device))
                most = per_warp(stack, torch.tensor(helds[0]), blocks)
                plain = share = 0.0
                for held in helds:
                    err, p, s = check_bucket(stack, mats, held, x, y0)
                    worst, plain, share = max(worst, err), max(plain, p), max(share, s)
                print(f"[12] {n_layers} x {n_buckets} stack on {grid} grid "
                      f"({blocks} blocks, up to {most} micro-rows a warp), "
                      f"{len(helds)} held vectors: share of bound vs plain "
                      f"{plain:.3g}, vs scipy {share:.3g}")
    finally:
        spmv_op._sm_count, spmv_op.BLOCKS_PER_SM = saved
    print(f"[12] bucket kernel vs plain max abs err {worst:.3g}")


def phase_ring(tag, csr, a, x, n_shards=4):
    """The ring main path in the local form: partition, shard, scatter,
    ring product, collect; against scipy and CSR.mult_vec."""
    from csr_tpu_torch.kernels import use_kernel
    from csr_tpu_torch.ops import microblock, spmv as spmv_op
    from csr_tpu_torch.parallel import mb_ring
    from csr_tpu_torch.parallel.partition import make_mesh

    assert csr.device.type == "cuda", csr.device
    t0 = time.perf_counter()
    host = mb_ring.partition_ring_mb(csr, n_shards)
    t1 = time.perf_counter()
    mesh = make_mesh(n_shards)
    assert mesh.device.type == "cuda" and mesh.group is None
    rmb = host.shard(mesh)
    xs = mb_ring.scatter_x(rmb, x, mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    before = spmv_op.bucket_launches
    y = mb_ring.spmv_ring_mb(rmb, xs, mesh)
    yg = mb_ring.collect_rows(rmb, y)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    grew = spmv_op.bucket_launches - before
    assert grew == n_shards, f"bucket launches grew by {grew}, not {n_shards}"
    assert y.shape == (n_shards, rmb.rows_per_shard) and yg.shape == (csr.nrows,)
    assert rmb.vals.device.type == "cuda"
    ref = a.astype(np.float64) @ x
    share = spmv_share(yg, ref, a, x)
    with use_kernel("cuda"):
        y_mv = csr.mult_vec(torch.from_numpy(x).cuda())
    share_mv = spmv_share(yg, y_mv.cpu().numpy(), a, x)
    real = int(rmb.groups.sum()) * microblock.ACC_GROUP
    print(f"[{tag}] ring D={n_shards}: {csr.nrows}x{csr.ncols} nnz {csr.nnz}, "
          f"window {rmb.window} pair {rmb.pair}, rows/shard {rmb.rows_per_shard}, "
          f"cols/shard {rmb.cols_per_shard} (splits {rmb.col_offset.tolist()}); "
          f"stack {rmb.nbytes} B, {rmb.rbcb.shape[2]} micro-rows a bucket, "
          f"groups {rmb.groups.tolist()}, fill {csr.nnz / max(real, 1) / 128:.4f} "
          f"of real micro-rows, padding groups {rmb.padding_share:.4f} of the "
          f"stack; packing {t1 - t0:.2f} s, to the card {t2 - t1:.2f} s, first "
          f"product {(t3 - t2) * 1e3:.3f} ms; {grew} launches")
    print(f"[{tag}] ring share of bound vs scipy {share:.3g}, vs CSR.mult_vec "
          f"{share_mv:.3g}")
    return rmb, mesh, xs


def phase_dist(csr, a, x, n_shards=4):
    """mb_dist.spmv, spmv_halo and spmv_t (both forms) at the flagship in
    the local form, the portable ring and dist forms beside them, and
    entry.dryrun_multichip."""
    from csr_tpu_torch import entry
    from csr_tpu_torch.ops import spmv as spmv_op
    from csr_tpu_torch.parallel import dist, mb_dist, ring
    from csr_tpu_torch.parallel.partition import make_mesh, partition_rows

    mesh = make_mesh(n_shards)
    t0 = time.perf_counter()
    dmb = mb_dist.partition_microblocks(csr, n_shards).shard(mesh)
    dmbt = mb_dist.partition_microblocks_t(csr, n_shards).shard(mesh)
    torch.cuda.synchronize()
    pack = time.perf_counter() - t0
    before = spmv_op.launches
    ys = mb_dist.spmv(dmb, x, mesh)
    yh = mb_dist.spmv_halo(dmb, mb_dist.scatter_x(dmb, x, mesh), mesh)
    xt = mb_dist.spmv_t(dmbt, ys, mesh)
    xsc = mb_dist.spmv_t(dmbt, ys, mesh, scatter=True)
    torch.cuda.synchronize()
    grew = spmv_op.launches - before
    assert grew == 4 * n_shards, f"launches grew by {grew}, not {4 * n_shards}"
    ref = a.astype(np.float64) @ x
    s_y = spmv_share(mb_dist.collect_rows(dmb, ys), ref, a, x)
    s_h = spmv_share(mb_dist.collect_rows(dmb, yh), ref, a, x)
    at = a.T.tocsr()
    y32 = mb_dist.collect_rows(dmb, ys).cpu().numpy()
    ref_t = at.astype(np.float64) @ y32
    s_t = spmv_share(xt, ref_t, at, y32)
    s_s = spmv_share(mb_dist.collect_cols_t(dmbt, xsc), ref_t, at, y32)
    print(f"[14] mb_dist D={n_shards} at {csr.nrows}x{csr.ncols}: layouts "
          f"{dmb.nbytes} + {dmbt.nbytes} B (window {dmb.window} pair {dmb.pair}; "
          f"transposed {dmbt.window}/{dmbt.pair}), packing {pack:.2f} s; {grew} "
          f"launches; share of bound vs scipy: spmv {s_y:.3g}, spmv_halo "
          f"{s_h:.3g}, spmv_t {s_t:.3g}, spmv_t scattered {s_s:.3g}")

    # the kernel against its plain version on every shard's view of the
    # stacks, as the path launches it (padded layout, out= a row of a
    # stack); these launches come after the count was read
    xd = torch.from_numpy(x).cuda()
    parts = mb_dist._local_products(dmbt, mesh, lambda l: ys[l], dmbt.ncols,
                                    dmbt.rows_per_shard, dmbt.ncols)
    s_p = s_pt = err = 0.0
    for l in range(n_shards):
        r0, nl = int(dmb.row_offset[l]), int(dmb.nrows_local[l])
        a_l = a[r0:r0 + nl]
        y_ref = spmv_op.spmv_reference(
            dmb._view(mesh, l, dmb.rows_per_shard, dmb.ncols), xd)
        t_ref = spmv_op.spmv_reference(
            dmbt._view(mesh, l, dmbt.ncols, dmbt.rows_per_shard), ys[l])
        torch.cuda.synchronize()
        assert not ys[l, nl:].any() and not y_ref[nl:].any(), "padding rows"
        err = max(err, float((ys[l] - y_ref).abs().max()),
                  float((parts[l] - t_ref).abs().max()))
        s_p = max(s_p, spmv_share(ys[l, :nl], y_ref[:nl].cpu().numpy(), a_l, x))
        s_pt = max(s_pt, spmv_share(parts[l], t_ref.cpu().numpy(),
                                    a_l.T.tocsr(), ys[l, :nl].cpu().numpy()))
    print(f"[14] kernel vs plain on the {n_shards} + {n_shards} shard views: "
          f"max abs err {err:.3g}, share of bound {s_p:.3g} (spmv), "
          f"{s_pt:.3g} (spmv_t)")

    # the portable forms on the card (plain PyTorch), the oracle's role
    r = ring.partition_ring(csr, n_shards).shard(mesh)
    yr = ring.spmv_ring(r, ring.scatter_x(r, x, mesh), mesh)
    d = partition_rows(csr, n_shards).shard(mesh)
    yd = dist.spmv(d, x, mesh)
    s_r = spmv_share(dist.collect_rows(r, yr), ref, a, x)
    s_d = spmv_share(dist.collect_rows(d, yd), ref, a, x)
    s_dt = spmv_share(dist.spmv_t(d, yd, mesh), ref_t, at, y32)
    print(f"[14] portable forms: ring.spmv_ring {s_r:.3g}, dist.spmv {s_d:.3g}, "
          f"dist.spmv_t {s_dt:.3g} of the bound")

    before = spmv_op.launches
    fn, args = entry.entry()
    out = fn(*args)
    assert out.device.type == "cuda" and bool(torch.isfinite(out).all())
    entry.dryrun_multichip(n_shards)
    torch.cuda.synchronize()
    assert spmv_op.launches - before == 1 + n_shards, spmv_op.launches - before


def phase_ring_timing(rmb, mesh, xs, csr, card):
    """Chained ring products against CSR.mult_vec of the unsplit matrix
    and the ring on the plain version, and the device time by kernel name
    (chained_times)."""
    from csr_tpu_torch.kernels import use_kernel
    from csr_tpu_torch.ops import spmv as spmv_op
    from csr_tpu_torch.parallel import mb_ring
    from csr_tpu_torch.utils.profiling import timed_chained

    def ring(rmb_, v):
        # the row-sharded result as the next column-sharded operand
        return fit(mb_ring.spmv_ring_mb(rmb_, v, mesh), rmb.cols_per_shard, 1)

    def ring_plain(rmb_, v):
        kernel = spmv_op.spmv_bucket
        spmv_op.spmv_bucket = spmv_op.spmv_bucket_reference
        try:
            return ring(rmb_, v)
        finally:
            spmv_op.spmv_bucket = kernel

    t_ring, t_plain = chained_times("15", rmb, ring, ring_plain, xs, iters=100,
                                    plain_iters=5, plain_reps=2, profile_iters=10)

    def unsplit(v):
        y = csr.mult_vec(v)
        return fit(y / y.abs().max().clamp_min(1e-30), csr.ncols)

    with use_kernel("cuda"):
        t_mv = timed_chained(unsplit, torch.ones(csr.ncols, device="cuda"), iters=100)
    print(f"[15] chained product at {csr.nrows}x{csr.ncols}, D={rmb.n_shards}: "
          f"ring {t_ring * 1e3:.5f} ms, CSR.mult_vec unsplit {t_mv * 1e3:.5f} ms, "
          f"ring on the plain version {t_plain * 1e3:.5f} ms; card {card}")


def step_matrices(rmb, a):
    """The entries each ring step multiplies: for k in [0, D), those of
    ``a`` whose column shard is (row shard + k) % D, as scipy CSR over the
    whole matrix."""
    coo = a.tocoo()
    d = rmb.n_shards
    sr = np.searchsorted(np.cumsum(rmb.nrows_local), coo.row, side="right")
    sc = np.searchsorted(rmb.col_offset[1:], coo.col, side="right")
    step = (sc - sr) % d
    return [sps.csr_matrix((coo.data[step == k],
                            (coo.row[step == k], coo.col[step == k])),
                           shape=a.shape) for k in range(d)]


def torch_csr(a):
    """A scipy CSR matrix as a ``torch.sparse_csr_tensor`` on the card, for
    the library yardsticks only."""
    a = a.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int32)).cuda(),
        torch.from_numpy(a.indices.astype(np.int32)).cuda(),
        torch.from_numpy(a.data.astype(np.float32)).cuda(), size=a.shape,
        check_invariants=False)


def csr_bytes(nnz, nrows, x_elems, y_elems):
    """Bytes a product must move whatever implements it: the CSR form
    (8 B an entry, 4 B a row pointer), the operand and the result once."""
    return 8 * nnz + 4 * (nrows + 1) + 4 * x_elems + 4 * y_elems


def microblock_floor_ms(layouts, nnz):
    """``device_ms``'s floor for a micro-block SpMV over ``layouts``: every
    micro-row's metadata (128 u16) and every stored value (f32) read once
    (csrc/microblock_spmv.cuh reads both whatever the fill), at the card's
    memory rate."""
    from csr_tpu_torch.ops import microblock
    from csr_tpu_torch.utils.profiling import least_ms

    mrs = sum(lay.n_microrows for lay in layouts)
    return least_ms(mrs * microblock.LANE * 2 + 4 * nnz, 0)[0]


def layer_stack(stack, l):
    """Layer ``l`` of a stack alone (views, no copy): what one rank of a
    four-card ring holds and launches on."""
    from csr_tpu_torch.ops import microblock

    return microblock.BucketStack(
        stack.nrows, stack.ncols, stack.window, stack.vals[l:l + 1],
        stack.meta[l:l + 1], stack.rbcb[l:l + 1], stack.groups[l:l + 1],
        stack.n_groups)


def phase_bucket_steps(tag, rmb, mesh, xs, a, card):
    """The bucket kernel's two launches of a ring step, each alone on one
    operand: the local form's (one launch over all D row shards) and the
    one that a rank of a D-card ring makes (one layer of the stack, the
    rank's own row shard).  At every step the four-layer launch, and the D
    one-layer launches together, are held to spmv_share's bound against
    the plain version and scipy.  Then, for each launch, the kernel, its
    plain version (four-layer only) and the library call on the same
    entries, taken in turn (the D steps; the D x D (layer, step) pairs):
    device time (device_ms) beside the bound, and a call's time from the
    host between two CUDA events.  Taking them in turn keeps a launch
    from finding its buckets in L2.  Times and bounds are means over the
    launches."""
    from csr_tpu_torch.ops import spmv as spmv_op
    from csr_tpu_torch.parallel import mb_ring
    from csr_tpu_torch.utils.profiling import least_ms

    d, stack, held = rmb.n_shards, rmb.stack, mesh.held
    sms = spmv_op._sm_count(stack.device)
    layers = [layer_stack(stack, l) for l in range(d)]
    y = torch.zeros(d, rmb.rows_per_shard, device="cuda")
    xs_host = xs.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(rmb.nrows_local)])
    err = share = plain_share = bound_ms = bound1_ms = 0.0
    libs, libs1, most = [], [], {4: 0, 1: 0}
    for k, a_k in enumerate(step_matrices(rmb, a)):
        y_k = spmv_op.spmv_bucket(stack, held[k], xs, y.clone())
        y_1 = y.clone()
        for l in range(d):
            spmv_op.spmv_bucket(layers[l], held[k][l:l + 1], xs[l:l + 1],
                                y_1[l:l + 1])
        y_ref = spmv_op.spmv_bucket_reference(stack, held[k], xs, y.clone())
        torch.cuda.synchronize()
        # the operand is not rotated here: shard s's slice stands in for
        # column shard (s + k) % D, so rebuild the operand the entries see
        x_seen = np.zeros(a.shape[1], np.float32)
        for s in range(d):
            c0, c1 = rmb.col_offset[(s + k) % d], rmb.col_offset[(s + k) % d + 1]
            x_seen[c0:c1] = xs_host[s, : c1 - c0]
        ref = mb_ring.collect_rows(rmb, y_ref).cpu().numpy()
        for got in (y_k, y_1):
            err = max(err, float((got - y_ref).abs().max()))
            got = mb_ring.collect_rows(rmb, got)
            plain_share = max(plain_share, spmv_share(got, ref, a_k, x_seen))
            share = max(share, spmv_share(got, a_k.astype(np.float64) @ x_seen,
                                          a_k, x_seen))
        x_dev = torch.from_numpy(x_seen).cuda()
        libs.append((torch_csr(a_k), x_dev))
        step_ms, by = least_ms(csr_bytes(a_k.nnz, a.shape[0], d * rmb.cols_per_shard,
                                         2 * a.shape[0]), 2 * a_k.nnz)
        bound_ms += step_ms / d
        for l in range(d):
            a_lk = a_k[starts[l]:starts[l + 1]]
            libs1.append((torch_csr(a_lk), x_dev))
            rows = a_lk.shape[0]
            bound1_ms += least_ms(csr_bytes(a_lk.nnz, rows, rmb.cols_per_shard,
                                            2 * rows), 2 * a_lk.nnz)[0] / d / d
            most[1] = max(most[1], per_warp(layers[l], held[k][l:l + 1].cpu(),
                                             spmv_op.bucket_grid(layers[l], sms)))
        most[4] = max(most[4], per_warp(stack, held[k].cpu(),
                                         spmv_op.bucket_grid(stack, sms)))

    def steps(fn):
        def product():
            for k in range(d):
                fn(stack, held[k], xs, y)
        return product

    def one_layer():
        for k in range(d):
            for l in range(d):
                spmv_op.spmv_bucket(layers[l], held[k][l:l + 1], xs[l:l + 1],
                                    y[l:l + 1])

    def library(pairs):
        def calls():
            for lib, xd in pairs:
                lib @ xd
        return calls

    kernel = steps(spmv_op.spmv_bucket)
    ms = device_ms(kernel, 10) / d
    plain_ms = device_ms(steps(spmv_op.spmv_bucket_reference), 2) / d
    lib_ms = device_ms(library(libs), 10) / d
    call_ms, host = (t / d for t in per_call(kernel, 20))
    lib_call_ms, lib_host = (t / d for t in per_call(library(libs), 20))
    ms1 = device_ms(one_layer, 5) / d / d
    lib1_ms = device_ms(library(libs1), 5) / d / d
    call1_ms, host1 = (t / d / d for t in per_call(one_layer, 10))
    lib1_call_ms, _ = (t / d / d for t in per_call(library(libs1), 10))
    # device time above a call's own time, or under the bound, is a fault
    # of the measurement
    for b, t, t_call in ((bound_ms, ms, call_ms), (bound_ms, lib_ms, lib_call_ms),
                         (bound1_ms, ms1, call1_ms), (bound1_ms, lib1_ms, lib1_call_ms)):
        assert b <= t <= 1.05 * t_call, (b, t, t_call)
    grids = [spmv_op.bucket_grid(s, sms) for s in (stack, layers[0])]
    print(f"[{tag}] a ring step at {a.shape[0]}x{a.shape[1]} (mean of the {d} "
          f"steps, {a.nnz / d:.0f} entries over {d} row shards), device time: "
          f"kernel {ms:.5f} ms ({bound_ms / ms:.4f} of it the bound), plain "
          f"{plain_ms:.5f} ms, torch.sparse CSR @ x {lib_ms:.5f} ms, bound "
          f"{bound_ms:.5f} ms by {by}; a call from the host: kernel "
          f"{call_ms:.5f} ms (enqueue {host:.5f} ms), torch.sparse "
          f"{lib_call_ms:.5f} ms (enqueue {lib_host:.5f} ms); kernel vs plain "
          f"max abs err {err:.3g}, share of bound vs plain {plain_share:.3g}, "
          f"vs scipy {share:.3g}; card {card}")
    print(f"[{tag}] one rank's launch (one layer, mean of the {d * d} (layer, "
          f"step) pairs), device time: kernel {ms1:.5f} ms ({bound1_ms / ms1:.4f} "
          f"of it the bound), torch.sparse CSR @ x {lib1_ms:.5f} ms, bound "
          f"{bound1_ms:.5f} ms; a call from the host: kernel {call1_ms:.5f} ms "
          f"(enqueue {host1:.5f} ms), torch.sparse {lib1_call_ms:.5f} ms; card "
          f"{card}")
    print(f"[{tag}] grid: {grids[0]} blocks for {d} layers, {grids[1]} for one "
          f"({spmv_op.BLOCKS_PER_SM} an SM of {sms}); up to {most[4]} and "
          f"{most[1]} micro-rows a warp")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_ms, one_layer_ms=ms1,
                one_layer_bound_ms=bound1_ms, one_layer_library_ms=lib1_ms)


def phase_library(tag, a, layout, x, b, card, iters, mm_iters):
    """The yardsticks at one shape: the SpMV and SpMM kernels and
    ``torch.sparse_csr_tensor(...) @ x`` / ``@ B`` on the same products,
    each over chained calls between CUDA events and as device time
    (device_ms: the host's pace left out; the plain versions too), beside
    each product's bound, and for SpMM the rate of the gather of
    nnz * n * 4 B of B's rows (the kernel's, the library's, and that of
    one ``torch.index_select`` of those rows).  The port never calls the
    library product.
    Returns, for "SpMV" and "SpMM", a dict of the times in ms."""
    from csr_tpu_torch.ops import spmm as spmm_op, spmv as spmv_op
    from csr_tpu_torch.utils.profiling import least_ms, timed_chained

    lib = torch_csr(a)
    nrows, ncols = a.shape
    n = b.shape[1]

    def chained(fn):
        def step(v):
            y = fn(v)
            return fit(y / y.abs().max().clamp_min(1e-30), v.shape[0])
        return step

    xd = torch.from_numpy(x).cuda()
    out = {}
    for name, kern, plain, libfn, v0, its, width in (
        ("SpMV", lambda v: spmv_op.spmv(layout, v),
         lambda v: spmv_op.spmv_reference(layout, v), lambda v: lib @ v, xd,
         iters, 1),
        ("SpMM", lambda v: spmm_op.spmm(layout, v),
         lambda v: spmm_op.spmm_reference(layout, v), lambda v: lib @ v, b,
         mm_iters, n),
    ):
        t_lib = timed_chained(chained(libfn), v0, iters=its)
        t_kern = timed_chained(chained(kern), v0, iters=its)
        t_kern = min(t_kern, timed_chained(chained(kern), v0, iters=its))
        t_lib = min(t_lib, timed_chained(chained(libfn), v0, iters=its))
        got, want = kern(v0), libfn(v0)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        gap = float((got - want).abs().max())
        assert gap <= 1e-3 * max(scale, 1.0), (name, gap, scale)
        del got, want
        lib_ms = device_ms(lambda: libfn(v0), 20)
        ms = device_ms(lambda: kern(v0), 20)
        plain_ms = device_ms(lambda: plain(v0), 2)
        bound_ms, by = least_ms(
            csr_bytes(a.nnz, nrows, ncols * width, nrows * width), 2 * a.nnz * width)
        # a chained product holds the call and more: device time above
        # it, or under the bound, is a fault of the measurement
        assert bound_ms <= ms <= 1.05 * t_kern * 1e3, (name, bound_ms, ms, t_kern)
        assert bound_ms <= lib_ms <= 1.05 * t_lib * 1e3, (name, bound_ms, lib_ms, t_lib)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         chained_ms=t_kern * 1e3, chained_library_ms=t_lib * 1e3,
                         bound_ms=bound_ms, bound_by=by)
        gather = ""
        if width > 1:
            # B's rows by the matrix's column indices, one library gather:
            # it writes the rows out as well, the products do not
            cols = torch.from_numpy(a.indices.astype(np.int64)).cuda()
            sel_ms = device_ms(lambda: torch.index_select(v0, 0, cols), 3)
            del cols
            out[name]["index_select_ms"] = sel_ms
            gather = (
                f"; the gather of nnz n 4 B = {a.nnz * width * 4 / 1e9:.3f} GB: "
                f"kernel {a.nnz * width * 4 / ms / 1e9:.3f} TB/s, library "
                f"{a.nnz * width * 4 / lib_ms / 1e9:.3f} TB/s, torch.index_select "
                f"of B's rows {a.nnz * width * 4 / sel_ms / 1e9:.3f} TB/s "
                f"({sel_ms:.5f} ms; it writes as much)")
        print(f"[{tag}] {name} at {nrows}x{ncols} (nnz {a.nnz}"
              f"{'' if width == 1 else f', B x {width}'}), device time: kernel "
              f"{ms:.5f} ms ({bound_ms / ms:.4f} of it the bound, {ms / lib_ms:.4f} "
              f"of the library's), plain {plain_ms:.5f} ms, torch.sparse CSR "
              f"{lib_ms:.5f} ms, bound {bound_ms:.5f} ms by {by}{gather}; per "
              f"chained product: kernel {t_kern * 1e3:.5f} ms, torch.sparse CSR "
              f"{t_lib * 1e3:.5f} ms; kernel vs library max abs diff {gap:.3g} of "
              f"|y| up to {scale:.4g}; card {card}")
    return out


def on_card(*mats):
    """Assert that every matrix landed on the card."""
    for m in mats:
        assert m.device.type == "cuda", m.device


def host_csr(c):
    """A port CSR as a scipy matrix (its arrays copied from the card)."""
    return sps.csr_matrix(
        (c.values.cpu().numpy(), c.colinds.cpu().numpy(),
         c.rowptrs.cpu().numpy()), shape=(c.nrows, c.ncols))


def row_stats(a, center):
    """Per-row mean (``center``) or Euclidean norm of a scipy CSR's stored
    values, and the values centred or scaled to unit rows, in f64 on the
    host (empty rows: 0; a row of zeros stays zero)."""
    counts = np.diff(a.indptr)
    rows = np.repeat(np.arange(a.shape[0]), counts)
    v = a.data.astype(np.float64)
    if center:
        stat = np.bincount(rows, v, a.shape[0]) / np.maximum(counts, 1)
        return stat, v - stat[rows]
    stat = np.sqrt(np.bincount(rows, v * v, a.shape[0]))
    return stat, v / np.where(stat > 0, stat, 1.0)[rows]


def check_sorted_rows(c):
    """Every row of a port CSR holds strictly increasing columns."""
    rp = c.rowptrs.cpu().numpy()
    ci = c.colinds.cpu().numpy().astype(np.int64)
    inner = np.ones(len(ci), bool)
    inner[rp[1:-1][rp[1:-1] < len(ci)]] = False  # a row's first entry
    assert np.all(np.diff(ci)[inner[1:]] > 0), "rows not sorted or not unique"


def print_profile(tag, fn, top=12):
    """The device time of one call of ``fn`` (``torch.profiler``, after a
    warm-up call), summed by kernel name, the largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = times.get(e.name, (0, 0.0))
            times[e.name] = (n + 1, us + e.time_range.elapsed_us())
    total = sum(us for _, us in times.values()) / 1e3
    print(f"[{tag}] profile of one call: {total:.3f} ms of device time in "
          f"{wall_ms:.3f} ms (profiled)")
    for name, (n, us) in sorted(times.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"[{tag}]   {us / 1e3:9.3f} ms x{n} {name[:90]}")


def phase_item_item(ml, card, block=1024):
    """[17] lenskit's item-item kNN at the MovieLens-25M shape: the rating
    matrix R (repeated (user, item) pairs summed: one rating a pair),
    ``Rt = R.transpose()``, its rows centred and scaled to unit length,
    then the similarities of the first 1,024 items with all of them, a
    block at a time as lenskit computes them: ``blk.multiply(Rt,
    transpose=True)`` (and ``blk.multiply(R)``), past the dense budget and
    so on ESC; then the positive similarities, rows sorted.  Every step
    against scipy or numpy on the host.  Returns the ESC numbers."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import _listeners, use_kernel
    from csr_tpu_torch.ops import spgemm

    nrows, ncols, rowptr, cols, vals = ml[:5]
    # a copy: sum_duplicates compacts the arrays in place, and phase 4's
    # matrix and CSR (its host copy) share them
    a = sps.csr_matrix((vals, cols, rowptr), shape=(nrows, ncols), copy=True)
    a.sum_duplicates()
    R = CSR(nrows, ncols, a.nnz, a.indptr, a.indices, a.data)
    on_card(R)
    t0 = time.perf_counter()
    Rt = R.transpose()
    torch.cuda.synchronize()
    t_tr = time.perf_counter() - t0
    at = a.T.tocsr()
    on_card(Rt)
    assert (Rt.nrows, Rt.ncols, Rt.nnz) == (ncols, nrows, a.nnz)
    for name, got, want in (("rowptrs", Rt.rowptrs, at.indptr),
                            ("colinds", Rt.colinds, at.indices),
                            ("values", Rt.values, at.data)):
        assert np.array_equal(got.cpu().numpy(), want), f"transpose {name}"
    print(f"[17] R {nrows}x{ncols}, {a.nnz} ratings (repeats summed); "
          f"R.transpose() {t_tr:.4f} s: rowptrs, colinds and values equal "
          "scipy's R.T")

    ref_vals = at.data
    for norm in ("center", "unit"):
        stat = Rt.normalize_rows(norm)
        want_stat, ref_vals = row_stats(
            sps.csr_matrix((ref_vals, at.indices, at.indptr), shape=at.shape),
            norm == "center")
        got = Rt.values.cpu().numpy().astype(np.float64)
        for what, g, w in (("values", got, ref_vals),
                           ("stat", stat.cpu().numpy(), want_stat)):
            err = np.abs(g - w)
            bad = err > PROD_RTOL * np.abs(w) + PROD_ATOL
            assert not bad.any(), (norm, what, np.flatnonzero(bad)[:5])
        print(f"[17] Rt.normalize_rows({norm!r}): values and per-row "
              f"{'means' if norm == 'center' else 'norms'} within tols of "
              f"numpy (max abs err {np.abs(got - ref_vals).max():.3g})")

    blk = Rt.subset_rows(0, block)
    rt_h = host_csr(Rt)
    blk_h = rt_h[:block]
    events = []
    _listeners.append(lambda e, f: events.append((e, f)))
    try:
        with use_kernel("cuda"):
            t0 = time.perf_counter()
            S = blk.multiply(Rt, transpose=True)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            S2 = blk.multiply(R)
    finally:
        _listeners.pop()
    routes = [f["route"] for e, f in events if e == "spgemm"]
    esc = [f for e, f in events if e == "esc"]
    assert routes == ["esc", "esc"], routes
    on_card(S, S2)
    t0 = time.perf_counter()
    ref = blk_h @ rt_h.T
    scipy_s = time.perf_counter() - t0
    ref2 = blk_h @ a
    out = {"terms": esc[0]["terms"], "chunks": esc[0]["chunks"],
           "nnz": S.nnz, "scipy_s": scipy_s, "first_s": first}
    for tag, c, r in (("blk.multiply(Rt, transpose=True)", S, ref),
                      ("blk.multiply(R)", S2, ref2)):
        r.sum_duplicates()
        r.eliminate_zeros()
        check_sorted_rows(c)
        got = host_csr(c)
        assert np.all(got.data != 0), "stored zeros"
        share = product_share(got, r, scaled=True)
        pat = abs(abs(got.sign()) - abs(r.sign())).nnz  # in one pattern only
        print(f"[17] {tag}: {c.nrows}x{c.ncols}, {c.nnz} entries (scipy "
              f"{r.nnz}, {pat} coordinates in one pattern only); share of "
              f"the scale-aware tols bound vs scipy {share:.3g}")
    print(f"[17] ESC: {out['terms']} product terms in {out['chunks']} "
          f"chunk(s) of at most {spgemm.esc_chunk_entries}, {S.nnz} entries "
          f"out; first call {first:.3f} s (the transpose of Rt included)")

    def product():
        with use_kernel("cuda"):
            return blk.multiply(Rt, transpose=True)

    ms, host_ms = per_call(product, iters=3)
    out["ms"] = ms
    print_profile("17", product)
    print(f"[17] one product {ms:.3f} ms between CUDA events after a warm-up "
          f"({out['terms'] / ms / 1e6:.4f} G terms/s); scipy on the card's "
          f"host {scipy_s * 1e3:.1f} ms ({out['terms'] / scipy_s / 1e9:.4f} G "
          f"terms/s); card {card}")

    # the yardstick, timed only: torch.sparse.mm of the same two CSR
    # tensors (the block and Rt^T, that is the normalised R)
    lib_a, lib_b = blk.to_torch_sparse(), Rt.transpose().to_torch_sparse()
    try:
        lib_ms, _ = per_call(lambda: torch.sparse.mm(lib_a, lib_b), iters=3)
        lib_nnz = torch.sparse.mm(lib_a, lib_b)._nnz()
        out["library_ms"] = lib_ms
        print(f"[17] torch.sparse.mm of the same CSR tensors: {lib_ms:.3f} ms "
              f"a product ({lib_nnz} entries stored)")
    except RuntimeError as e:  # out of memory among them: recorded, not hidden
        out["library_ms"] = None
        out["library_error"] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        print(f"[17] torch.sparse.mm of the same CSR tensors failed: "
              f"{out['library_error']}")
    del lib_a, lib_b
    torch.cuda.empty_cache()

    # the chunk budget: each value in turns, the result unchanged
    saved = spgemm.esc_chunk_entries
    sweep = {}
    for budget in (2**24, 2**26, 2**28, 2**28, 2**26, 2**24):
        spgemm.esc_chunk_entries = budget
        torch.cuda.reset_peak_memory_stats()
        chunks = []
        _listeners.append(lambda e, f: chunks.append(f["chunks"]) if e == "esc" else None)
        try:
            t, _ = per_call(product, iters=3)
        finally:
            _listeners.pop()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check = ""
        if budget not in sweep:  # the product at each budget, once
            check = (f", share of bound vs scipy "
                     f"{product_share(host_csr(product()), ref, scaled=True):.3g}")
        sweep.setdefault(budget, []).append(t)
        print(f"[17] esc_chunk_entries 2^{budget.bit_length() - 1}: "
              f"{chunks[-1]} chunks, {t:.3f} ms a product, peak "
              f"{peak:.2f} GiB allocated{check}")
    spgemm.esc_chunk_entries = saved
    out["sweep_ms"] = {f"2^{b.bit_length() - 1}": v for b, v in sweep.items()}

    F = S.filter_nnzs(S.values > 0)
    F.sort_rows()
    check_sorted_rows(F)
    assert F.nnz == int((S.values > 0).sum()) and bool((F.values > 0).all())
    ref.data[ref.data <= 0] = 0
    ref.eliminate_zeros()
    share = product_share(host_csr(F), ref, scaled=True)
    print(f"[17] S.filter_nnzs(S.values > 0).sort_rows(): {F.nnz} of "
          f"{S.nnz} entries; share of bound vs scipy's positive entries "
          f"{share:.3g}")
    return out


@functools.lru_cache(maxsize=None)
def power_law_rows(nrows, ncols, per_row, seed):
    """Host CSR arrays of an ``nrows x ncols`` f32 matrix with ``per_row``
    entries a row, columns drawn with power-law popularity (exponent 0.6
    over a random permutation of the ids, as movielens_shape draws items;
    repeats kept), values standard normal, from a seed.  Cached: the
    phases that use one matrix share its arrays, which none changes."""
    rng = np.random.default_rng(seed)
    nnz = nrows * per_row
    rowptr = np.arange(nrows + 1, dtype=np.int64) * per_row
    pop = np.arange(1, ncols + 1, dtype=np.float64) ** -0.6
    cdf = np.cumsum(pop / pop.sum())
    rank = np.minimum(np.searchsorted(cdf, rng.random(nnz)), ncols - 1)
    cols = rng.permutation(ncols).astype(np.int32)[rank]
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rowptr, cols, vals


def layout_fill(nrows=131_072):
    """Fill and layout bytes an entry of the micro-block layout, packed on
    the host, for ``nrows``-row samples with power-law column popularity:
    hypersparse (12 entries a row over 1M and 4M columns) against the
    shape of phase 18 (8 over 4,096) and a denser one (16 over 8,192)."""
    from csr_tpu_torch.ops import microblock

    for per_row, ncols in ((12, 1 << 20), (12, 1 << 22), (8, 4096), (16, 8192)):
        rp, ci, v = power_law_rows(nrows, ncols, per_row, seed=per_row + ncols)
        lay = microblock.build_microblocks_host(nrows, ncols, rp, ci, v,
                                                device="cpu")
        print(f"[18] layout of {nrows} rows, {per_row} entries a row over "
              f"{ncols} columns: window {lay.window} pair {lay.pair}, fill "
              f"{lay.fill:.4f}, {lay.nbytes / len(ci):.1f} B a stored entry")
        del lay


def check_panels(tag, chunks, a, x):
    """Each panel's SpMV kernel launch against ``spmv_reference`` on the
    panel's slice of ``x``, within the SpMV bound of the panel's block of
    ``a``.  Returns the largest absolute difference."""
    from csr_tpu_torch.ops import microblock, spmv as spmv_op

    xd = torch.from_numpy(x).cuda()
    worst, r0 = 0.0, 0
    for cn, panels in chunks:
        for cb_off, layout in panels:
            c0 = cb_off * microblock.LANE
            xs = xd[c0 : c0 + layout.ncols]
            y, y_ref = spmv_op.spmv(layout, xs), spmv_op.spmv_reference(layout, xs)
            torch.cuda.synchronize()
            worst = max(worst, float((y - y_ref).abs().max()))
            spmv_share(y, y_ref.cpu().numpy(),
                       a[r0 : r0 + cn, c0 : c0 + layout.ncols],
                       x[c0 : c0 + layout.ncols])
            del y, y_ref
        r0 += cn
    print(f"[18] {tag}: every panel's launch within the SpMV bound of "
          f"spmv_reference, max abs err {worst:.3g}")
    return worst


def phase_large(fl_csr, fl_a, x_fl, card):
    """[18] ``spmv_large`` (:func:`large_path`), with ``_CSR_CROSSOVER``
    and ``_CSR_CROSSOVER_LARGE`` set past every matrix for the phase: the
    4,300,000-row matrix takes the CSR-form kernel by default (phase 21),
    and this phase holds the micro-block kernel's large path."""
    from csr_tpu_torch.kernels import cuda as cuda_k

    saved = cuda_k._CSR_CROSSOVER, cuda_k._CSR_CROSSOVER_LARGE
    cuda_k._CSR_CROSSOVER = cuda_k._CSR_CROSSOVER_LARGE = float("inf")
    try:
        return large_path(fl_csr, fl_a, x_fl, card)
    finally:
        cuda_k._CSR_CROSSOVER, cuda_k._CSR_CROSSOVER_LARGE = saved


def large_path(fl_csr, fl_a, x_fl, card, nrows=4_300_000, ncols=4096,
               windows=64):
    """[18] ``spmv_large``: a 4,300,000 x 4,096 matrix with 8 entries a row
    (past the packer's 32767 row windows, so 2 row chunks), ``mult_vec``
    against scipy and each panel's launch against ``spmv_reference``, and
    ``mult_vec_t`` on the in-range transpose; then the flagship of phase 3
    with the budget cut to 64 windows: 4 chunks x 4 panels, 16 launches,
    against the unsplit ``mult_vec`` and scipy.  Returns the panel
    launches of both runs and the largest kernel-vs-plain difference."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import _listeners, cuda as cuda_k, use_kernel
    from csr_tpu_torch.ops import spmv as spmv_op

    per_row = 8
    rowptr, cols, vals = power_law_rows(nrows, ncols, per_row, seed=18)
    a = sps.csr_matrix((vals, cols, rowptr), shape=(nrows, ncols))
    csr = CSR(nrows, ncols, len(cols), rowptr, cols, vals)
    on_card(csr)
    rng = np.random.default_rng(180)
    x = rng.standard_normal(ncols).astype(np.float32)
    xt = rng.standard_normal(nrows).astype(np.float32)
    xd, xtd = torch.from_numpy(x).cuda(), torch.from_numpy(xt).cuda()
    builds = []
    _listeners.append(lambda e, f: builds.append(f) if e == "layout-build-large" else None)
    try:
        with use_kernel("cuda"):
            spmv_op.launches = 0
            t0 = time.perf_counter()
            y = csr.mult_vec(xd)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            large = spmv_op.launches
            yt = csr.mult_vec_t(xtd)
            torch.cuda.synchronize()
    finally:
        _listeners.pop()
    assert large == 2, large
    (built,) = builds
    share = spmv_share(y, a.astype(np.float64) @ x, a, x)
    at = a.T.tocsr()
    share_t = spmv_share(yt, at.astype(np.float64) @ xt, at, xt)
    chunks = cuda_k._cached_large(csr, False)
    assert [len(p) for _, p in chunks] == [1, 1], chunks
    err = check_panels("4.3M rows", chunks, a, x)
    with use_kernel("cuda"):
        ms, host_ms = per_call(lambda: csr.mult_vec(xd), iters=20)
    fill = len(cols) / sum(lay.n_microrows * 128 for _, p in chunks for _, lay in p)
    print(f"[18] mult_vec of {nrows}x{ncols} ({len(cols)} entries): "
          f"{built['chunks']} chunks, {built['panels']} panels, {large} "
          f"launches, layouts {built['bytes']} B (fill {fill:.4f}); first call "
          f"{secs:.2f} s (host packing included); {ms:.5f} ms a product "
          f"between CUDA events (host {host_ms:.5f} ms); share of bound vs "
          f"scipy {share:.3g}; mult_vec_t on the in-range transpose: share "
          f"{share_t:.3g}; card {card}")
    del csr, chunks, y, yt, xtd, a, at
    torch.cuda.empty_cache()

    layout_fill()

    # the panel path at the flagship: the budget cut to 64 windows
    xf = torch.from_numpy(x_fl).cuda()
    with use_kernel("cuda"):
        y_unsplit = fl_csr.mult_vec(xf)
        saved = cuda_k._LARGE_WINDOWS
        cuda_k._LARGE_WINDOWS = windows
        spmv_op.launches = 0
        y = fl_csr.mult_vec(xf)
        torch.cuda.synchronize()
        panels = spmv_op.launches
        ms_large, _ = per_call(lambda: fl_csr.mult_vec(xf), iters=50)
        cuda_k._LARGE_WINDOWS = saved
        ms_unsplit, _ = per_call(lambda: fl_csr.mult_vec(xf), iters=50)
    assert panels == 16, panels
    chunks = cuda_k._cached_large(fl_csr, False)
    assert [len(p) for _, p in chunks] == [4] * 4, [len(p) for _, p in chunks]
    share_u = spmv_share(y, y_unsplit.cpu().numpy().astype(np.float64), fl_a, x_fl)
    share = spmv_share(y, fl_a.astype(np.float64) @ x_fl, fl_a, x_fl)
    err = max(err, check_panels("flagship, 4 x 4 panels", chunks, fl_a, x_fl))
    print(f"[18] flagship with _LARGE_WINDOWS {windows}: 4 chunks x 4 panels, "
          f"{panels} launches; share of bound vs the unsplit mult_vec "
          f"{share_u:.3g}, vs scipy {share:.3g}; {ms_large:.5f} ms a product "
          f"against {ms_unsplit:.5f} ms unsplit")
    return {"large_launches": large, "large_launches_flagship_panels": panels,
            "large_max_abs_err": err}


def phase_vmap(tag, csr, a, k, seed, card):
    """``torch.func.vmap`` of ``mult_vec`` on the cuda backend over ``k``
    operands: one SpMM launch and no SpMV launch, held to the SpMV bound
    against a loop of ``k`` ``mult_vec`` calls and against scipy; both
    timed by ``device_ms``.  Returns the counts, the times and the largest
    difference from the loop."""
    from csr_tpu_torch.kernels import use_kernel

    X = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (k, csr.ncols)).astype(np.float32)).cuda()
    with use_kernel("cuda"):
        def batch():
            return torch.func.vmap(lambda v: csr.mult_vec(v))(X)

        def loop():
            return torch.stack([csr.mult_vec(X[i]) for i in range(k)])

        launch_counts(reset=True)
        Y = batch()
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts == {"spmv_microblock": 0, "spmm_microblock": 1,
                          "spmv_bucket": 0, "spmv_csr": 0, "spmm_csr": 0}, counts
        Y_loop = loop()
        ms_batch, ms_loop = device_ms(batch), device_ms(loop)
    assert Y.shape == (k, csr.nrows), Y.shape
    xs = X.cpu().numpy()
    share = spmv_share(Y, Y_loop.cpu().numpy(), a, xs)
    share_s = spmv_share(Y, (a.astype(np.float64) @ xs.T.astype(np.float64)).T,
                              a, xs)
    err = float((Y - Y_loop).abs().max())
    print(f"[19] vmap of mult_vec, {tag} ({csr.nrows}x{csr.ncols}), k = {k}: "
          f"launches {counts}; share of bound vs the loop of {k} mult_vec "
          f"{share:.3g}, vs scipy {share_s:.3g}, max abs err {err:.3g}; device "
          f"time {ms_batch:.5f} ms a batch against {ms_loop:.5f} ms for the "
          f"loop; card {card}")
    return {"k": k, "launches": counts, "ms": ms_batch, "loop_ms": ms_loop,
            "max_abs_err": err}


def phase_grad(csr, a, card):
    """Grad on the torch backend, on the card: the gradients of
    ``w . (A x)`` in the operand and the values match ``mult_vec_t(w)`` on
    the cuda kernel and ``w[rows] * x[cols]``; the cuda backend refuses
    the same call."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import use_kernel

    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.standard_normal(csr.ncols).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.standard_normal(csr.nrows).astype(np.float32)).cuda()
    vals = csr.values.detach().clone().requires_grad_()
    c = CSR(csr.nrows, csr.ncols, csr.nnz, csr.rowptrs, csr.colinds, vals,
            _cast=False)
    xg = x.clone().requires_grad_()
    with use_kernel("torch"):
        y = c.mult_vec(xg)
        gx, gv = torch.autograd.grad((w * y).sum(), (xg, vals))
    with use_kernel("cuda"):
        try:
            c.mult_vec(xg)
        except ValueError as e:
            assert "torch backend" in str(e), e
        else:
            raise AssertionError("the cuda backend took a product needing grad")
        want_x = csr.mult_vec_t(w)
    torch.cuda.synchronize()
    assert y.grad_fn is not None
    wn = w.cpu().numpy()
    at = a.T.tocsr()
    share = spmv_share(gx, want_x.cpu().numpy().astype(np.float64), at, wn)
    share_s = spmv_share(gx, at.astype(np.float64) @ wn, at, wn)
    rows = torch.repeat_interleave(
        torch.arange(csr.nrows, device="cuda"), torch.diff(csr.rowptrs.long()))
    want_v = w[rows] * x[csr.colinds.long()]
    err_v = float((gv - want_v).abs().max())
    assert torch.allclose(gv, want_v, rtol=1e-6, atol=0), err_v
    print(f"[19] grad on the torch backend at {csr.nrows}x{csr.ncols}: d/dx "
          f"share of bound vs mult_vec_t(w) on the kernel {share:.3g}, vs scipy "
          f"{share_s:.3g}; d/dvalues max abs err {err_v:.3g} against "
          f"w[rows] * x[cols]; the cuda backend raised ValueError; card {card}")


def phase_dispatch(csr, card, iters=300, reps=3, rounds=2):
    """The host's cost of the SpMV op's dispatch (``ops/spmv.py:product``
    outside a transform calls the op's forward, inside one the op): the
    flagship's eager chain of ``normalized(A @ v)`` through
    ``_Product.forward`` and through ``_Product.apply``, by
    ``timed_chained`` (best of ``reps`` chains of ``iters``), in the order
    forward, apply, apply, forward, ``rounds`` times; and the host's
    milliseconds to enqueue a call of each (``per_call``).  Returns the
    lists of times."""
    from csr_tpu_torch.harness import normalized
    from csr_tpu_torch.kernels import cuda as cuda_k
    from csr_tpu_torch.ops import spmv as spmv_op
    from csr_tpu_torch.utils import profiling

    layout = cuda_k._cached_layout(csr)
    x0 = torch.from_numpy(np.random.default_rng(192).standard_normal(
        csr.ncols).astype(np.float32)).cuda()
    fns = {"forward": spmv_op._Product.forward, "apply": spmv_op._Product.apply}
    out = {f"{k}_{m}": [] for k in fns for m in ("chained_ms", "host_ms")}
    for name in ("forward", "apply", "apply", "forward") * rounds:
        f = fns[name]

        def step(v):
            return normalized(f(layout, csr.ncols, v, "mult_vec"))

        out[f"{name}_chained_ms"].append(
            profiling.timed_chained(step, x0, iters, reps) * 1e3)
        out[f"{name}_host_ms"].append(
            per_call(lambda: f(layout, csr.ncols, x0, "mult_vec"), iters)[1])
    torch.cuda.synchronize()
    print(f"[19] the SpMV op's dispatch at the flagship, chained "
          f"normalized(A @ v), ms a product (forward, apply, apply, forward "
          f"x{rounds}): forward {out['forward_chained_ms']}, apply "
          f"{out['apply_chained_ms']}; host ms to enqueue a call: forward "
          f"{out['forward_host_ms']}, apply {out['apply_host_ms']}; card {card}")
    return out


def path_launches(counted, graphs) -> dict:
    """A path's kernel launches: ``counted``, what the wrappers counted
    (eager calls and each graph's capture), and the launches that graph
    replays ran, which no wrapper sees: ``graphs`` lists each captured
    graph's launches (a dict of counts) with its number of replays."""
    replayed = {k: sum(g.get(k, 0) * n for g, n in graphs) for k in counted}
    return {"counted": counted, "replayed": replayed,
            "total": {k: counted[k] + replayed[k] for k in counted}}


def phase_harness(fl_csr, fl_a, ml_csr, ml_a, card):
    """[19] The paths of the harness and of the transforms on the card:
    ``harness.bench`` (0 < vs_baseline <= 1.05, the captured chain equal to
    the eager one within the SpMV bound), ``harness.benchmarks --fast`` on
    scipy, torch and cuda (every product checked against scipy),
    ``harness.bench_weak`` at D = 1, 2, 4, halo and ring (the first step of
    each against scipy), ``torch.func.vmap`` of ``mult_vec`` at the
    flagship (k = 8) and the MovieLens-25M shape (k = 50), and grad on the
    torch backend.  Each path runs with the launch counts set to 0 just
    before it and read just after; graph replays, which the counts do not
    see, are added from what each graph captured (:func:`path_launches`).
    Returns the counts and numbers."""
    from csr_tpu_torch.harness import bench, bench_weak, benchmarks

    out = {"launches": {}}
    t0 = time.perf_counter()
    launch_counts(reset=True)
    r = bench.main([])
    out["launches"]["bench"] = path_launches(
        launch_counts(), [(r.launches, r.replays)])
    line = r.result
    assert list(line) == list(bench.KEYS), line
    assert 0 < line["vs_baseline"] <= 1.05, line
    assert set(r.shares) == {"eager_vs_scipy", "graph_vs_eager"}, r.shares
    assert r.launches == {"spmv_microblock": 300, "spmm_microblock": 0,
                          "spmv_bucket": 0, "spmv_csr": 0, "spmm_csr": 0}, r.launches
    assert r.replays == 3, r.replays
    out["bench"] = dict(line, ms=r.seconds * 1e3, eager_ms=r.eager_seconds * 1e3,
                        prep_s=r.prep_seconds, **r.shares)
    print(f"[19] bench: {r.seconds * 1e3:.5f} ms a product captured, "
          f"{r.eager_seconds * 1e3:.5f} ms eager; shares {r.shares}; "
          f"{time.perf_counter() - t0:.1f} s")
    del r
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    launch_counts(reset=True)
    rows = benchmarks.main(["--fast"])
    out["launches"]["benchmarks"] = path_launches(launch_counts(), [])
    groups = {(row["group"], row["kernel"]) for row in rows}
    want = {(g, k) for g in ("MultAB", "MultABt", "MultAx", "MultAB-Density",
                             "MultABt-Density", "MultAB-Size", "MultAB-ESC")
            for k in ("scipy", "torch", "cuda")}
    assert want <= groups, want - groups
    out["benchmarks"] = rows
    print(f"[19] benchmarks --fast: {len(rows)} rows, every product within "
          f"tests/util.py:tols of scipy's; {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    out["bench_weak"] = []
    for argv, name in (([], "bench_weak"), (["--ring"], "bench_weak --ring")):
        t0 = time.perf_counter()
        launch_counts(reset=True)
        runs = bench_weak.main(argv)
        out["launches"][name] = path_launches(
            launch_counts(), [(run["captured"], run["replays"]) for run in runs])
        assert [run["line"]["devices"] for run in runs] == [1, 2, 4], runs
        out["bench_weak"] += [run["line"] for run in runs]
        print(f"[19] {name}: {time.perf_counter() - t0:.1f} s")
        del runs
        torch.cuda.empty_cache()

    out["vmap"] = [phase_vmap("flagship", fl_csr, fl_a, 8, 190, card),
                   phase_vmap("MovieLens shape", ml_csr, ml_a, 50, 191, card)]
    phase_grad(fl_csr, fl_a, card)
    out["dispatch"] = phase_dispatch(fl_csr, card)
    print(json.dumps({"path_launches": out["launches"]}))
    return out


VARIANTS = tuple((w, p) for w in (128, 256) for p in (1, 2, 4))
#: how far the chosen variant's SpMV time may lie above the fastest's
CHOICE_SLACK = 1.10


def layout_matrices(fl, ml):
    """Phase 20's matrices as (name, scipy CSR, x): the flagship, the
    MovieLens-25M shape, the transposes ``mult_vec_t`` multiplies by, and
    a hypersparse matrix of phase 18's kind (65,536 rows, 12 power-law
    entries a row over 1,048,576 columns)."""
    fl_a = sps.csr_matrix((fl[4], fl[3], fl[2]), shape=fl[:2])
    ml_a = sps.csr_matrix((ml[4], ml[3], ml[2]), shape=ml[:2])
    nrows, ncols = 65_536, 1 << 20
    rp, ci, v = power_law_rows(nrows, ncols, 12, seed=12 + ncols)
    hyper = sps.csr_matrix((v, ci, rp), shape=(nrows, ncols))
    rng = np.random.default_rng(20)
    return [
        ("flagship", fl_a, fl[5]),
        ("flagship transpose", fl_a.T.tocsr(),
         rng.standard_normal(fl[0]).astype(np.float32)),
        ("MovieLens shape", ml_a, ml[5]),
        ("MovieLens shape transpose", ml_a.T.tocsr(), ml[6]),
        ("hypersparse", hyper, rng.standard_normal(ncols).astype(np.float32)),
    ]


def phase_layouts(fl, ml, card):
    """[20] The six (window, pair) layouts of each of
    :func:`layout_matrices`: micro-rows, fill and bytes, the SpMV kernel
    held to the SpMV bound against scipy, and its device time
    (``device_ms``, the median of three rounds taken in turns).  At
    the flagship and the MovieLens shape, each window's pair-1 layout
    also times the SpMM kernel (B x 256 and x 50, checked against scipy
    on a column slice) and a ring step (D = 4, local form, the mean of
    the D steps, the ring's product checked against scipy).  Asserts that
    the variant ``choose_layout`` picks takes at most CHOICE_SLACK times
    the fastest variant's SpMV time at every matrix.  Returns the table."""
    from csr_tpu_torch.ops import microblock, spmv as spmv_op

    out = []
    for name, a, x in layout_matrices(fl, ml):
        nrows, ncols = a.shape
        t0 = time.perf_counter()
        chosen = microblock.choose_layout(a.indptr, a.indices, ncols)
        choose_s = time.perf_counter() - t0
        xd = torch.from_numpy(x).cuda()
        ref = a.astype(np.float64) @ x
        layouts = {}
        for w, p in VARIANTS:
            t0 = time.perf_counter()
            lay = microblock.build_microblocks_host(
                nrows, ncols, a.indptr, a.indices, a.data, window=w, pair=p,
                device="cuda")
            build_s = time.perf_counter() - t0
            share = spmv_share(spmv_op.spmv(lay, xd), ref, a, x)
            layouts[w, p] = lay, build_s, share
        # the median of three rounds, in turns: device_ms takes again a
        # window under the variant's floor (one had read half a variant's
        # time and failed the pick's assertion with the best of two), and
        # the median leaves out one window that reads low above it
        runs = {v: [] for v in VARIANTS}
        for order in (VARIANTS, VARIANTS[::-1], VARIANTS):
            for v in order:
                lay = layouts[v][0]
                runs[v].append(device_ms(lambda: spmv_op.spmv(lay, xd), 20,
                                         floor_ms=microblock_floor_ms([lay], a.nnz)))
        ms = {v: float(np.median(t)) for v, t in runs.items()}
        rows = []
        for v in VARIANTS:
            lay, build_s, share = layouts[v]
            row = dict(matrix=name, window=v[0], pair=v[1],
                       microrows=lay.n_microrows, fill=lay.fill,
                       nbytes=lay.nbytes, ms=ms[v],
                       us_per_1024=ms[v] * 1e3 / max(lay.n_microrows, 1) * 1024,
                       build_s=build_s, share=share)
            rows.append(row)
            print(f"[20] {name} ({nrows}x{ncols}, nnz {a.nnz}) window {v[0]} "
                  f"pair {v[1]}{' (chosen)' if v == chosen else ''}: "
                  f"{lay.n_microrows} micro-rows, fill {lay.fill:.4f}, "
                  f"{lay.nbytes} B; SpMV {ms[v]:.5f} ms of device time, "
                  f"{row['us_per_1024']:.4f} us per 1024 micro-rows; share of "
                  f"bound vs scipy {share:.3g}; packed in {build_s:.2f} s")
        del layouts
        torch.cuda.empty_cache()
        best = min(ms, key=ms.get)
        print(f"[20] {name}: choose_layout picks {chosen} in {choose_s:.3f} s, "
              f"{ms[chosen]:.5f} ms; fastest {best}, {ms[best]:.5f} ms "
              f"({ms[chosen] / ms[best]:.4f} of it); card {card}")
        out.append(dict(matrix=name, chosen=list(chosen), fastest=list(best),
                        choose_s=choose_s, variants=rows))
        if name in ("flagship", "MovieLens shape"):
            out[-1]["pair1"] = layout_spmm_ring(name, a, x, card)
    print(json.dumps({"layouts": out}))
    for m in out:
        ms = {(r["window"], r["pair"]): r["ms"] for r in m["variants"]}
        assert ms[tuple(m["chosen"])] <= CHOICE_SLACK * min(ms.values()), (
            m["matrix"], m["chosen"], ms)
    return out


def layout_spmm_ring(name, a, x, card, n_shards=4):
    """The SpMM kernel and a ring step on each window's pair-1 layout of
    ``a`` (phase 20)."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.ops import microblock, spmm as spmm_op, spmv as spmv_op
    from csr_tpu_torch.parallel import mb_ring
    from csr_tpu_torch.parallel.partition import make_mesh

    nrows, ncols = a.shape
    n = 256 if name == "flagship" else 50
    b = np.random.default_rng(n).standard_normal((ncols, n)).astype(np.float32)
    bd = torch.from_numpy(b).cuda()
    csr = CSR(nrows, ncols, a.nnz, a.indptr, a.indices, a.data)
    mesh = make_mesh(n_shards)
    held = mesh.held
    out = {}
    for w in (128, 256):
        lay = microblock.build_microblocks_host(
            nrows, ncols, a.indptr, a.indices, a.data, window=w, pair=1,
            device="cuda")
        spmm_share(spmm_op.spmm(lay, bd)[:, :4], a.astype(np.float64) @ b[:, :4])
        spmm_ms = device_ms(lambda: spmm_op.spmm(lay, bd), 5)
        del lay
        rmb = mb_ring.partition_ring_mb(csr, n_shards, window=w).shard(mesh)
        assert (rmb.window, rmb.pair) == (w, 1), (rmb.window, rmb.pair)
        xs = mb_ring.scatter_x(rmb, x, mesh)
        y = mb_ring.collect_rows(rmb, mb_ring.spmv_ring_mb(rmb, xs, mesh))
        spmv_share(y, a.astype(np.float64) @ x, a, x)
        stack = rmb.stack
        acc = torch.zeros(n_shards, rmb.rows_per_shard, device="cuda")

        def steps():
            for k in range(n_shards):
                spmv_op.spmv_bucket(stack, held[k], xs, acc)

        ring_ms = device_ms(steps, 10) / n_shards
        out[w] = dict(spmm_ms=spmm_ms, ring_step_ms=ring_ms,
                      stack_bytes=rmb.nbytes)
        print(f"[20] {name} window {w} pair 1: SpMM (B x {n}) {spmm_ms:.5f} ms "
              f"of device time, within the SpMM bound of scipy on 4 columns; "
              f"a ring step (D = {n_shards}, mean of the {n_shards}) "
              f"{ring_ms:.5f} ms, stack {rmb.nbytes} B, the ring's product "
              f"within the SpMV bound of scipy; card {card}")
        del rmb, xs, y, stack, acc
        torch.cuda.empty_cache()
    return out


CSR_KERNEL = {
    "name": "spmv_csr",
    "route": "cuda",
    "source": "csr_tpu_torch/csrc/spmv_csr.cu",
    "replaces": "csr_tpu/ops/spmv.py:79",
}
#: phase 21's sweep to place the crossover: (entries a row, columns) of
#: 131,072-row matrices of power_law_rows
CSR_SWEEP = ((12, 4096), (12, 1 << 16), (12, 1 << 20), (12, 1 << 22),
             (64, 1 << 20), (327, 1 << 20))
#: more of phase 21's sweep, for SpMV alone: 131,072-row matrices whose
#: (256, 1) layouts cost 8.3-24.1 B a stored entry, about the crossover
#: (phase 22's crossover sweep's matrices)
CSR_CROSSOVER_SWEEP = tuple((k, 4096) for k in (8, 10, 13)) + tuple(
    (k, 1 << 16) for k in (64, 96))
#: entries a row of phase 21's 4,300,000 x 4,096 matrices past the
#: packer's range besides phase 18's 8 (24.13 B a stored entry): 12, 16
#: and 24 a row cost 16.08, 12.06 and 8.62 B, two on each side of
#: ``_CSR_CROSSOVER_LARGE`` with phase 18's
CSR_LARGE_SWEEP = (12, 16, 24)


@functools.lru_cache(maxsize=None)
def realistic_hypersparse(nrows=8_388_608, ncols=1 << 20, seed=21):
    """Host CSR arrays of the realistic hypersparse rating matrix: users x
    items as in the Amazon product-review sets, each row's length
    ``min(zipf(2.4), 4096)`` (about 18.5M entries, 2.2 a row), item
    columns drawn by power_law_rows' power law (exponent 0.6 over a
    random permutation of the ids; repeats kept), values standard
    normal, all from ``np.random.default_rng(seed)``.  Cached, as
    power_law_rows is."""
    rng = np.random.default_rng(seed)
    rowptr = np.zeros(nrows + 1, np.int64)
    np.cumsum(np.minimum(rng.zipf(2.4, nrows), 4096), out=rowptr[1:])
    nnz = int(rowptr[-1])
    pop = np.arange(1, ncols + 1, dtype=np.float64) ** -0.6
    cdf = np.cumsum(pop / pop.sum())
    rank = np.minimum(np.searchsorted(cdf, rng.random(nnz)), ncols - 1)
    cols = rng.permutation(ncols).astype(np.int32)[rank]
    vals = rng.standard_normal(nnz).astype(np.float32)
    return nrows, ncols, rowptr, cols, vals


def csr_cases(fl, ml):
    """Phase 21's matrices, made one at a time: (name, (nrows, ncols,
    rowptr, cols, vals), the directions to run: False for mult_vec, True
    for mult_vec_t)."""
    both = (False, True)
    yield "hypersparse", (65_536, 1 << 20, *power_law_rows(
        65_536, 1 << 20, 12, seed=12 + (1 << 20))), both
    yield "4.3M x 4,096", (4_300_000, 4096, *power_law_rows(
        4_300_000, 4096, 8, seed=18)), both
    for per_row in CSR_LARGE_SWEEP:
        yield (f"4.3M x 4,096, {per_row} a row", (4_300_000, 4096, *power_law_rows(
            4_300_000, 4096, per_row, seed=18 + per_row)), (False,))
    yield "flagship", fl[:5], both
    yield "MovieLens shape", ml[:5], both
    for per_row, ncols in CSR_SWEEP + CSR_CROSSOVER_SWEEP:
        yield (f"sweep {per_row} a row over {ncols}",
               (131_072, ncols, *power_law_rows(131_072, ncols, per_row,
                                                seed=per_row + ncols)), (False,))
    yield "realistic", realistic_hypersparse(), both


def kept(csr, key):
    """Form ``key`` that ``csr`` keeps while its tensors stand as they are
    (``csr_tpu_torch/_forms.py``), or None."""
    f = csr._forms
    return f.get(key) if f is not None and f.fresh(csr) else None


def csr_views(a, offset_c, offset_v, ptr_dtype, structure_only=False):
    """The CSR arrays of scipy ``a`` on the card, ``colinds`` and
    ``values`` as views ``offset_c`` and ``offset_v`` floats past a 16 B
    boundary (so the kernel takes its scalar or its 16 B path), rowptrs
    of ``ptr_dtype``."""
    nnz = a.nnz
    cbuf = torch.zeros(nnz + 8, dtype=torch.int32, device="cuda")
    vbuf = torch.zeros(nnz + 8, dtype=torch.float32, device="cuda")
    ci = cbuf[offset_c : offset_c + nnz]
    ci.copy_(torch.from_numpy(a.indices.astype(np.int32)))
    v = vbuf[offset_v : offset_v + nnz]
    v.copy_(torch.from_numpy(a.data.astype(np.float32)))
    rp = torch.from_numpy(a.indptr.astype(np.int64)).to("cuda", ptr_dtype)
    return rp, ci, None if structure_only else v


def into_nan(launch, operand):
    """``launch(operand)`` with the f32 tensors it allocates by
    ``torch.empty`` (its result) filled with NaN first, so that a row the
    kernel does not write shows."""
    empty = torch.empty

    def nan_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.dtype == torch.float32 else t

    torch.empty = nan_empty
    try:
        return launch(operand)
    finally:
        torch.empty = empty


def spmv_csr_into_nan(rp, ci, v, xd):
    """The CSR-form SpMV kernel's zeroed path (``spmv_csr_launch``, with
    the edges of ``csr_shares``) into a y filled with NaN."""
    from csr_tpu_torch.ops import spmv as spmv_op

    edges = spmv_op.csr_shares(rp, ci.shape[0])[0]
    return into_nan(spmv_op.spmv_csr_launch(rp, ci, v, edges, xd), xd)


def cut_rows_matrix(rng, nrows=3_000_000, ncols=1 << 20):
    """A matrix whose rows are cut at share and at block edges: 0 to 4
    entries a row, and rows of 60,000 entries (about 30 shares of 2048
    merge items each, so over several of the persistent blocks' runs of
    shares) and one of 4,096 entries (the realistic case's longest)."""
    lengths = rng.integers(0, 5, nrows)
    lengths[[1000, 1_500_000, nrows - 2]] = 60_000
    lengths[2_000_000] = 4096
    rp = np.zeros(nrows + 1, np.int64)
    np.cumsum(lengths, out=rp[1:])
    return sps.csr_matrix((rng.standard_normal(int(rp[-1])).astype(np.float32),
                           rng.integers(0, ncols, int(rp[-1])).astype(np.int32), rp),
                          shape=(nrows, ncols))


def phase_csr_kernel_vs_plain():
    """[21] The CSR-form kernel against spmv_csr_reference (and scipy) on
    small seeded matrices on the card: empty rows and an empty matrix, a
    row longer than many shares together, int32 and int64 rowptrs,
    colinds and values off a 16 B boundary (the same way and not),
    structure-only, ``out=`` accumulation, and an inf in x that one row
    uses; and a matrix whose rows are cut at share and block edges, with a
    4,096-entry row.  Every case also runs into a y filled with NaN (every
    row written) and twice (bitwise equal).  Returns the largest
    difference."""
    from csr_tpu_torch.ops import spmv as spmv_op

    rng = np.random.default_rng(2100)
    worst = 0.0
    lil = sps.lil_matrix((600, 9000), dtype=np.float32)
    lil[17, :] = rng.standard_normal(9000)          # 4.4 shares of one row
    lil[18, 5] = 2.0
    lil[400:430, :300] = rng.standard_normal((30, 300))
    every = ((0, 0, torch.int32, False), (1, 1, torch.int64, False),
             (3, 3, torch.int32, False), (1, 2, torch.int64, False),
             (2, 0, torch.int32, True))
    mats = [("random", sps.random(3000, 5000, 0.004, format="csr",
                                  random_state=rng, dtype=np.float32), every),
            ("long row, empty rows", lil.tocsr(), every),
            ("empty", sps.csr_matrix((50, 40), dtype=np.float32), every),
            ("rows cut at share and block edges", cut_rows_matrix(rng), every[:2])]
    for name, a, views in mats:
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        xd = torch.from_numpy(x).cuda()
        for oc, ov, pd, so in views:
            rp, ci, v = csr_views(a, oc, ov, pd, so)
            b = a if not so else sps.csr_matrix(
                (np.ones(a.nnz, np.float32), a.indices, a.indptr), shape=a.shape)
            y = spmv_op.spmv_csr(rp, ci, v, xd)
            again = spmv_op.spmv_csr(rp, ci, v, xd)
            y_ref = spmv_op.spmv_csr_reference(rp, ci, v, xd)
            out = torch.full((a.shape[0],), 0.5, device="cuda")
            y_out = spmv_op.spmv_csr(rp, ci, v, xd, out=out)
            nan = spmv_csr_into_nan(rp, ci, v, xd) if a.nnz else y
            torch.cuda.synchronize()
            assert y_out is out
            assert torch.equal(y, again) and torch.equal(y, nan), name
            err = float((y - y_ref).abs().max()) if a.shape[0] else 0.0
            worst = max(worst, err)
            spmv_share(y, y_ref.cpu().numpy(), b, x)
            spmv_share(y, b.astype(np.float64) @ x, b, x)
            spmv_share(y_out - 0.5, b.astype(np.float64) @ x, b, x)
            print(f"[21] {name} ({a.shape[0]}x{a.shape[1]}, nnz {a.nnz}), colinds "
                  f"+{oc}, values +{ov}, rowptrs {pd}, structure-only {so}: "
                  f"kernel vs plain max abs err {err:.3g}; out= adds; a y of NaN "
                  f"all written; two runs bitwise equal")
        del xd, y, again, y_ref, out, y_out, nan
    # an inf in x used by one row only
    a = mats[1][1]
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    x[5] = np.inf
    rp, ci, v = csr_views(a, 1, 1, torch.int32)
    y = spmv_op.spmv_csr(rp, ci, v, torch.from_numpy(x).cuda()).cpu().numpy()
    uses = np.flatnonzero(a[:, [5]].toarray()[:, 0] != 0)
    bad = np.flatnonzero(~np.isfinite(y))
    assert set(bad) == set(uses), (bad, uses)
    print(f"[21] inf in x[5]: non-finite rows {bad.tolist()}, the rows that "
          f"use column 5 {uses.tolist()}")
    torch.cuda.empty_cache()
    return worst


def phase_csr(fl, ml, card):
    """[21] The CSR-form kernel and its route on the card, at every
    matrix of csr_cases: the first CSR.mult_vec / mult_vec_t of a fresh
    CSR (the route's decision and the call timed on the host) against
    scipy, with each path's launches counted from 0 and held to its
    route (the realistic case in one launch each way); the kernel against
    spmv_csr_reference on the CSR tensors it reads; the micro-block
    kernel (or spmv_large) where the matrix is not the realistic case,
    against scipy; device time (device_ms, the best of two rounds in
    opposite orders) of the CSR-form kernel, the micro-block kernel and
    one torch.sparse_csr_tensor(...) @ x, and of the plain version; the
    CSR bound; bytes a stored entry of both forms; and the assertion that
    the route's pick takes at most CHOICE_SLACK times the faster kernel's
    time.  Returns the table."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel
    from csr_tpu_torch.ops import spmv as spmv_op
    from csr_tpu_torch.utils.profiling import least_ms

    rows, csr_counts = [], 0
    for i, (name, (nrows, ncols, rp, cols, vals), dirs) in enumerate(csr_cases(fl, ml)):
        nnz = len(cols)
        csr = CSR(nrows, ncols, nnz, rp, cols, vals)
        on_card(csr)
        a = sps.csr_matrix((vals, cols, rp), shape=(nrows, ncols))
        rng = np.random.default_rng(2110 + i)
        for t in dirs:
            b = a.T.tocsr() if t else a
            tag = f"{name}{' transpose' if t else ''}"
            x = rng.standard_normal(b.shape[1]).astype(np.float32)
            xd = torch.from_numpy(x).cuda()
            ref = b.astype(np.float64) @ x
            with use_kernel("cuda"):
                launch_counts(reset=True)
                t0 = time.perf_counter()
                route = cuda_k._spmv_route(csr, t)
                t1 = time.perf_counter()
                # the realistic case is never packed into micro-blocks
                assert name != "realistic" or route == "csr", (tag, route)
                y = csr.mult_vec_t(xd) if t else csr.mult_vec(xd)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                counts = launch_counts()
            large = cuda_k._needs_large(*b.shape)
            if route == "csr":
                want = {"spmv_csr": 1}
                assert kept(csr, "layout_t" if t else "layout") is None
                assert kept(csr, "large_t" if t else "large") is None
            elif large:
                want = {"spmv_microblock": sum(
                    len(p) for _, p in cuda_k._cached_large(csr, t))}
            else:
                want = {"spmv_microblock": 1}
            assert {k: n for k, n in counts.items() if n} == want, (tag, route, counts)
            csr_counts += counts["spmv_csr"]
            share = spmv_share(y, ref, b, x)
            del y

            fm = cuda_k._cached_csr_t(csr) if t else cuda_k._csr_form(csr)
            edges = cuda_k._spmv_edges(csr, t)  # as the route hands them
            csr_bytes_entry = sum(u.numel() * u.element_size()
                                  for u in fm if u is not None) / nnz
            mb_bytes_entry = cuda_k._layout_bytes_per_entry(csr, t)
            yk = spmv_op.spmv_csr(*fm, xd, edges=edges)
            yr = spmv_op.spmv_csr_reference(*fm, xd)
            torch.cuda.synchronize()
            err = float((yk - yr).abs().max())
            share_plain = spmv_share(yk, yr.cpu().numpy(), b, x)
            spmv_share(yk, ref, b, x)
            del yk, yr

            fns = {"csr": lambda: spmv_op.spmv_csr(*fm, xd, edges=edges)}
            lib = torch_csr(b)
            fns["library"] = lambda: lib @ xd
            bound_ms, by = least_ms(csr_bytes(nnz, b.shape[0], b.shape[1], b.shape[0]),
                                    2 * nnz)
            floors = {"csr": bound_ms}
            if name != "realistic":
                if large:
                    mb = cuda_k._cached_large(csr, t)
                    fns["microblock"] = lambda: spmv_op.spmv_large(mb, b.shape[1], xd)
                    floors["microblock"] = microblock_floor_ms(
                        [lay for _, p in mb for _, lay in p], nnz)
                else:
                    mb = cuda_k._cached_layout_t(csr) if t else cuda_k._cached_layout(csr)
                    fns["microblock"] = lambda: spmv_op.spmv(mb, xd)
                    floors["microblock"] = microblock_floor_ms([mb], nnz)
                spmv_share(fns["microblock"](), ref, b, x)
            ms = {k: float("inf") for k in fns}
            for order in (list(fns), list(fns)[::-1]):
                for k in order:
                    ms[k] = min(ms[k], device_ms(fns[k], 10,
                                                 floor_ms=floors.get(k, 0.0)))
            plain_ms = device_ms(lambda: spmv_op.spmv_csr_reference(*fm, xd), 2)
            assert bound_ms <= ms["csr"], (tag, bound_ms, ms)
            # the zeroed path: the kernel and its carry pass, no memset
            _, parts = device_ms(fns["csr"], 10, by_kernel=True)
            assert len(parts) == 2 and all("spmv_csr" in k for k in parts), parts
            direct = {}
            if name == "hypersparse" and not t:
                # a call without edges: merge_path.cuh's search in a launch of
                # its own, against the edges by csr_shares' searchsorted first
                direct = {"search_ms": device_ms(lambda: spmv_op.spmv_csr(*fm, xd), 10),
                          "searchsorted_ms": device_ms(lambda: spmv_op.spmv_csr(
                              *fm, xd, edges=spmv_op.csr_shares(fm[0], nnz)[0]), 10)}
                print(f"[21] {tag}: a call without edges {direct['search_ms']:.5f} ms "
                      f"(the kernel's search), {direct['searchsorted_ms']:.5f} ms with "
                      f"csr_shares first; card {card}")
            kernels_ms = [ms[k] for k in ("csr", "microblock") if k in ms]
            pick = ms["csr" if route == "csr" else "microblock"]
            row = dict(matrix=tag, shape=list(b.shape), nnz=nnz, route=route,
                       large=large, csr_ms=ms["csr"],
                       microblock_ms=ms.get("microblock"), library_ms=ms["library"],
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                       csr_bytes_per_entry=csr_bytes_entry,
                       microblock_bytes_per_entry=mb_bytes_entry,
                       route_s=t1 - t0, first_call_s=t2 - t0, share=share,
                       share_plain=share_plain, max_abs_err=err,
                       launches=counts, device_kernels=sorted(parts), **direct)
            rows.append(row)
            mbs = ("not run" if "microblock" not in ms else
                   f"{ms['microblock']:.5f} ms ({'spmv_large' if large else 'one layout'})")
            print(f"[21] {tag} ({b.shape[0]}x{b.shape[1]}, nnz {nnz}): route {route}; "
                  f"device time: CSR-form kernel {ms['csr']:.5f} ms ({bound_ms / ms['csr']:.4f} "
                  f"of it the bound), micro-block {mbs}, torch.sparse CSR @ x "
                  f"{ms['library']:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} "
                  f"ms by {by}; bytes a stored entry: CSR form {csr_bytes_entry:.2f}, "
                  f"micro-block at (256, 1) {mb_bytes_entry:.2f}; first "
                  f"{'mult_vec_t' if t else 'mult_vec'} of a fresh CSR {t2 - t0:.3f} s "
                  f"(route {t1 - t0:.3f} s); launches {want}; share of bound vs scipy "
                  f"{share:.3g}, kernel vs plain {share_plain:.3g} (max abs err {err:.3g}); "
                  f"card {card}")
            assert pick <= CHOICE_SLACK * min(kernels_ms), (tag, route, ms)
            del fns, lib, fm, edges
            torch.cuda.empty_cache()
        del csr, a, b
        torch.cuda.empty_cache()
    for large, point in ((False, "_CSR_CROSSOVER"), (True, "_CSR_CROSSOVER_LARGE")):
        pts = "; ".join(f"{r['microblock_bytes_per_entry']:.2f} "
                        f"{r['microblock_ms'] / r['csr_ms']:.3f} ({r['matrix']})"
                        for r in sorted(rows, key=lambda r: r["microblock_bytes_per_entry"])
                        if r["microblock_ms"] and r["large"] == large)
        print(f"[21] {'past' if large else 'within'} the packer's range: layout bytes "
              f"a stored entry and micro-block time / CSR-form time (above 1: the "
              f"CSR form is the faster): {pts}; the port's {point} is "
              f"{getattr(cuda_k, point)}")
    print(json.dumps({"csr_route": rows}))
    return rows, csr_counts


def csr_summary(rows, corner_err):
    """The spmv_csr entry of the kernels line: phase 21's numbers at the
    hypersparse matrix (mult_vec), and at the realistic case both ways
    beside them."""
    by = {r["matrix"]: r for r in rows}
    hyper = by["hypersparse"]
    out = dict(max_abs_err=max([corner_err] + [r["max_abs_err"] for r in rows]),
               ms=hyper["csr_ms"], plain_ms=hyper["plain_ms"],
               bound_ms=hyper["bound_ms"], bound_by=hyper["bound_by"],
               library_ms=hyper["library_ms"],
               microblock_ms=hyper["microblock_ms"])
    for tag, name in (("realistic", "realistic"),
                      ("realistic_t", "realistic transpose")):
        for key in ("csr_ms", "plain_ms", "bound_ms", "library_ms"):
            out[f"{key.replace('csr_', '')}_{tag}"] = by[name][key]
    return out


CSR_SPMM_KERNEL = {
    "name": "spmm_csr",
    "route": "cuda",
    "source": "csr_tpu_torch/csrc/spmm_csr.cu",
    "replaces": "csr_tpu/ops/spmm.py:66",
}
#: phase 22's widths of B against the plain version: every lanes-a-row
#: (4, 8, 16, 32) and load width (4, 8, 16 B) of ops/spmm.py:csr_plan, on
#: both sides of each change
SPMM_CSR_WIDTHS = (1, 2, 3, 4, 8, 16, 17, 32, 33, 50, 64, 65, 128, 129, 256)


def b_view(ncols, n, rng, offset=0, pad=0):
    """A seeded f32 B (``ncols`` x ``n``) on the card and on the host: on
    the card a view ``offset`` floats past a 16 B boundary whose rows lie
    ``n + pad`` floats apart."""
    b = rng.standard_normal((ncols, n)).astype(np.float32)
    buf = torch.zeros(ncols * (n + pad) + offset, device="cuda")
    bd = buf[offset:].view(ncols, n + pad)[:, :n]
    bd.copy_(torch.from_numpy(b))
    return b, bd


def spmm_share_card(c, ref, rtol=SPMM_RTOL, atol=SPMM_ATOL) -> float:
    """:func:`spmm_share` on the card, for results too large to copy to
    the host: the largest |c - ref| as a share of tests/test_mult_dense.py's
    bound; raises if it exceeds the bound or c is not finite."""
    assert c.shape == ref.shape, (tuple(c.shape), tuple(ref.shape))
    if c.numel() == 0:
        return 0.0
    assert bool(torch.isfinite(c).all()), "non-finite SpMM output"
    tol = rtol * ref.abs() + atol * max(1.0, float(ref.abs().max()))
    share = float(((c - ref).abs() / tol).max())
    assert share <= 1.0, f"SpMM outside the bound: share {share:.3g}"
    return share


def spmm_csr_into_nan(rp, ci, v, bd):
    """The CSR-form SpMM kernel (``spmm_csr_launch``, with the edges of
    ``csr_shares`` and ``csr_plan``'s lanes and load width) into a C filled
    with NaN."""
    from csr_tpu_torch.ops import spmm as spmm_op, spmv as spmv_op

    edges = spmv_op.csr_shares(rp, ci.shape[0], spmm_op.CSR_TILE)[0]
    return into_nan(spmm_op.spmm_csr_launch(rp, ci, v, edges, bd), bd)


def phase_spmm_csr_kernel_vs_plain():
    """[22] The CSR-form SpMM kernel against spmm_csr_reference (and
    scipy) on small seeded matrices on the card: empty rows and an empty
    matrix, a row of 4.9 shares, a block of 30 dense rows; B of every
    width of SPMM_CSR_WIDTHS; int32 and int64 rowptrs, colinds and values
    off a 16 B boundary, structure-only, and a B 16 B aligned, with padded
    rows, 4 B and 8 B aligned (each load width the plan allows); each run
    also into a C filled with NaN (every row written) and twice (bitwise
    equal); an inf in B that some rows use.  Returns the largest
    difference."""
    from csr_tpu_torch.ops import spmm as spmm_op

    rng = np.random.default_rng(2200)
    lil = sps.lil_matrix((700, 5000), dtype=np.float32)
    lil[17, :] = rng.standard_normal(5000)          # 4.9 shares of one row
    lil[18, 5] = 2.0
    lil[400:430, :300] = rng.standard_normal((30, 300))
    mats = [("random", sps.random(3000, 5000, 0.004, format="csr",
                                  random_state=rng, dtype=np.float32)),
            ("long row, empty rows", lil.tocsr()),
            ("empty", sps.csr_matrix((50, 40), dtype=np.float32))]
    worst = 0.0
    for name, a in mats:
        ones = sps.csr_matrix((np.ones(a.nnz, np.float32), a.indices, a.indptr),
                              shape=a.shape)
        for n in SPMM_CSR_WIDTHS:
            plans, err_n, shares = set(), 0.0, []
            # (colinds +, values +, rowptrs, structure-only, B +, B's row pad)
            for oc, ov, pd, so, bo, bp in ((0, 0, torch.int32, False, 0, 0),
                                           (1, 1, torch.int64, False, 0, 4),
                                           (2, 0, torch.int32, True, 1, 0),
                                           (3, 3, torch.int64, False, 2, 0)):
                rp, ci, v = csr_views(a, oc, ov, pd, so)
                b, bd = b_view(a.shape[1], n, rng, bo, bp)
                c = spmm_op.spmm_csr(rp, ci, v, bd)
                again = spmm_op.spmm_csr(rp, ci, v, bd)
                nan = spmm_csr_into_nan(rp, ci, v, bd) if a.nnz else c
                c_ref = spmm_op.spmm_csr_reference(rp, ci, v, bd)
                torch.cuda.synchronize()
                assert torch.equal(c, again) and torch.equal(c, nan), (name, n, bo)
                err = float((c - c_ref).abs().max()) if c.numel() else 0.0
                worst = max(worst, err)
                share = spmm_share(c, c_ref.cpu().numpy())
                share_sp = spmm_share(c, (ones if so else a).astype(np.float64) @ b)
                width, lanes = spmm_op.csr_plan(n, bd.stride(0),
                                                bd.data_ptr() & -bd.data_ptr())
                plans.add(f"{lanes} lanes a row, {4 * width} B loads")
                err_n = max(err_n, err)
                shares.append(max(share, share_sp))
            print(f"[22] {name} ({a.shape[0]}x{a.shape[1]}, nnz {a.nnz}), n {n}: "
                  f"colinds and values +0..3 floats, int32 and int64 rowptrs, "
                  f"structure-only, B +0, +1, +2 floats and padded rows "
                  f"({'; '.join(sorted(plans))}): kernel vs plain max abs err "
                  f"{err_n:.3g}, largest share of the bound {max(shares):.3g}; a C "
                  f"of NaN all written; two runs bitwise equal")
    # an inf in B, in the row that column 5 gathers: only the rows that use
    # column 5 turn non-finite, and only in the inf's column
    a = mats[1][1]
    uses = set(np.flatnonzero(a[:, [5]].toarray()[:, 0] != 0).tolist())
    for n in (50, 128):
        b, bd = b_view(a.shape[1], n, rng)
        bd[5, 1] = float("inf")
        rp, ci, v = csr_views(a, 0, 0, torch.int32)
        c = spmm_op.spmm_csr(rp, ci, v, bd).cpu().numpy()
        bad_r, bad_c = np.nonzero(~np.isfinite(c))
        assert set(bad_r.tolist()) == uses and set(bad_c.tolist()) == {1}, (
            sorted(set(bad_r.tolist())), sorted(uses), set(bad_c.tolist()))
        print(f"[22] inf in B[5, 1], n {n}: non-finite entries of C in rows "
              f"{sorted(set(bad_r.tolist()))} (the rows that use column 5), "
              f"column 1 only")
    return worst


def spmm_csr_cases(fl, ml):
    """Phase 22's matrices, made one at a time: (name, (nrows, ncols,
    rowptr, cols, vals), the widths of B)."""
    hyper = (65_536, 1 << 20, *power_law_rows(65_536, 1 << 20, 12,
                                              seed=12 + (1 << 20)))
    yield "realistic", realistic_hypersparse(), (50,)
    yield "4.3M x 4,096", (4_300_000, 4096, *power_law_rows(
        4_300_000, 4096, 8, seed=18)), (50, 256)
    yield "hypersparse", hyper, (50, 256)
    t = sps.csr_matrix((hyper[4], hyper[3], hyper[2]), shape=hyper[:2]).T.tocsr()
    yield "hypersparse transpose", (t.shape[0], t.shape[1], t.indptr, t.indices,
                                    t.data), (50, 256)
    for per_row, ncols in CSR_SWEEP:
        yield (f"sweep {per_row} a row over {ncols}",
               (131_072, ncols, *power_law_rows(131_072, ncols, per_row,
                                                seed=per_row + ncols)), (50, 256))
    yield "flagship", fl[:5], (256, 50)
    yield "MovieLens shape", ml[:5], (50, 256)


def sample_check(c, a, bd, rows=64, seed=0):
    """``c = A @ B`` held to scipy in f64 on the host on a seeded sample
    of ``rows`` rows (B's rows that they use copied from the card), within
    tests/test_mult_dense.py's bound; returns the share of the bound."""
    pick = np.sort(np.random.default_rng(seed).choice(a.shape[0], rows,
                                                      replace=False))
    sub = a[pick]
    used = np.unique(sub.indices)
    bs = bd[torch.from_numpy(used.astype(np.int64)).cuda()].cpu().numpy()
    sub = sps.csr_matrix((sub.data, np.searchsorted(used, sub.indices),
                          sub.indptr), shape=(rows, len(used)))
    got = c[torch.from_numpy(pick).cuda()].cpu().numpy()
    return spmm_share(got, sub.astype(np.float64) @ bs.astype(np.float64))


def spmm_crossover(rows, n):
    """The matrices of ``rows`` timed on both SpMM kernels at width ``n``,
    as ``(layout bytes a stored entry, micro-block time / CSR-form time,
    matrix)`` in the order of their bytes: the CSR form is the faster
    where the ratio is above 1, and SpMM's crossover should lie above
    the bytes of every ratio below 1 and below those of every ratio
    above it, where no ratio of the other kind lies between."""
    return sorted((r["microblock_bytes_per_entry"], r["microblock_ms"] / r["csr_ms"],
                   r["matrix"]) for r in rows if r["n"] == n and r.get("microblock_ms"))


def phase_spmm_csr(fl, ml, card):
    """[22] The CSR-form SpMM kernel and its route on the card, at every
    matrix of spmm_csr_cases and each width: the first ``CSR.mult_dense``
    of a CSR at each width, fresh at the first (the route and the call,
    host seconds; its launches
    counted from 0 and held to its route; no layout built on the CSR
    route, which the realistic case and 4.3M x 4,096 at n = 50 must take)
    held to scipy on a row sample; the kernel against spmm_csr_reference
    on the card; device time (device_ms) of the CSR-form kernel, the
    micro-block SpMM (one layout, or
    spmm_large's chunks and panels at 4.3M x 4,096; not the realistic
    case, which is never packed), ``torch.sparse_csr_tensor(...) @ B`` and
    the plain version, beside the bound; the route's pick within
    CHOICE_SLACK of the faster kernel.  Returns the table and the CSR-form
    launches of the API calls."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import _listeners, cuda as cuda_k, use_kernel
    from csr_tpu_torch.ops import spmm as spmm_op
    from csr_tpu_torch.utils.profiling import least_ms

    rows, csr_counts = [], 0
    events = []
    for i, (name, (nrows, ncols, rp, cols, vals), widths) in enumerate(
            spmm_csr_cases(fl, ml)):
        nnz = len(cols)
        a = sps.csr_matrix((vals, cols, rp), shape=(nrows, ncols))
        used = int(np.count_nonzero(np.bincount(cols, minlength=ncols)))
        csr = CSR(nrows, ncols, nnz, rp, cols, vals)  # fresh at the first width
        on_card(csr)
        for n in widths:
            t_row = time.perf_counter()
            g = torch.Generator(device="cuda").manual_seed(2210 + i)
            bd = torch.randn(ncols, n, device="cuda", generator=g)
            tag = f"{name}, n {n}"
            _listeners.append(lambda e, f: events.append(e))
            try:
                with use_kernel("cuda"):
                    events.clear()
                    launch_counts(reset=True)
                    t0 = time.perf_counter()
                    route = cuda_k._spmm_route(csr, n)
                    t1 = time.perf_counter()
                    c = csr.mult_dense(bd)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    counts = launch_counts()
            finally:
                _listeners.pop()
            if name in ("realistic", "4.3M x 4,096") and n == 50:
                assert route == "csr", (tag, route)
            if route == "csr":  # the call built no micro-block layout (the
                # column panels are the CSR form's own, where B passes L2)
                want = {"spmm_csr": 1}
                assert not [e for e in events if e.startswith("layout-build")
                            and e != "layout-build-panels"], events
                for form in ("layout", "large"):
                    assert n != widths[0] or kept(csr, form) is None, (tag, form)
            elif route == "large":
                want = {"spmm_microblock": sum(
                    len(p) for _, p in cuda_k._cached_large(csr, False))}
            else:
                want = {"spmm_microblock": 1}
            assert {k: m for k, m in counts.items() if m} == want, (tag, route, counts)
            csr_counts += counts["spmm_csr"]
            share = sample_check(c, a, bd, seed=i)
            del c

            fm = cuda_k._csr_form(csr)
            edges = cuda_k._spmm_edges(csr)  # as the route hands them
            ck = spmm_op.spmm_csr(*fm, bd, edges=edges)
            cr = spmm_op.spmm_csr_reference(*fm, bd)
            torch.cuda.synchronize()
            err = float((ck - cr).abs().max())
            share_plain = spmm_share_card(ck, cr)
            del ck, cr
            fns = {"csr": lambda: spmm_op.spmm_csr(*fm, bd, edges=edges)}
            lib = torch_csr(a)
            fns["library"] = lambda: lib @ bd
            if name != "realistic":
                if cuda_k._needs_large(nrows, ncols):
                    mb = cuda_k._cached_large(csr, False)
                    fns["microblock"] = lambda: spmm_op.spmm_large(mb, bd)
                else:
                    mb = cuda_k._cached_layout(csr)
                    fns["microblock"] = lambda: spmm_op.spmm(mb, bd)
                sample_check(fns["microblock"](), a, bd, seed=i)
            # B's rows that some entry gathers, each read once
            bound_ms, by = least_ms(csr_bytes(nnz, nrows, used * n, nrows * n),
                                    2 * nnz * n)
            ms = {k: device_ms(fn, 10, floor_ms=bound_ms if k == "csr" else 0.0)
                  for k, fn in fns.items()}
            plain_ms = device_ms(lambda: spmm_op.spmm_csr_reference(*fm, bd), 2)
            assert bound_ms <= ms["csr"], (tag, bound_ms, ms)
            mb_bytes = cuda_k._layout_bytes_per_entry(csr, False)
            kernels_ms = [ms[k] for k in ("csr", "microblock") if k in ms]
            pick = ms["csr" if route == "csr" else "microblock"]
            row = dict(matrix=name, n=n, shape=[nrows, ncols], nnz=nnz, route=route,
                       csr_ms=ms["csr"], microblock_ms=ms.get("microblock"),
                       library_ms=ms["library"], plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=by, used_columns=used,
                       microblock_bytes_per_entry=mb_bytes, route_s=t1 - t0,
                       first_call_s=t2 - t0, share=share, share_plain=share_plain,
                       max_abs_err=err, launches=counts,
                       host_s=time.perf_counter() - t_row)
            rows.append(row)
            mbs = ("not run" if "microblock" not in ms else
                   f"{ms['microblock']:.5f} ms")
            print(f"[22] {tag} ({nrows}x{ncols}, nnz {nnz}): route {route}; device "
                  f"time: CSR-form kernel {ms['csr']:.5f} ms ({bound_ms / ms['csr']:.4f} "
                  f"of it the bound), micro-block {mbs}, torch.sparse CSR @ B "
                  f"{ms['library']:.5f} ms, plain {plain_ms:.5f} ms, bound "
                  f"{bound_ms:.5f} ms by {by} ({used} of B's {ncols} rows gathered); "
                  f"micro-block layout {mb_bytes:.2f} B "
                  f"a stored entry; first mult_dense at this width {t2 - t0:.3f} s "
                  f"(route {t1 - t0:.3f} s); launches {want}; share of bound vs "
                  f"scipy (64 rows) {share:.3g}, kernel vs plain {share_plain:.3g} "
                  f"(max abs err {err:.3g}); {row['host_s']:.1f} s on the host; "
                  f"card {card}")
            assert pick <= CHOICE_SLACK * min(kernels_ms), (tag, route, ms)
            del fns, lib, fm, bd, edges
            torch.cuda.empty_cache()
        del a, csr
    print(json.dumps({"spmm_csr_route": rows}))
    return rows, csr_counts


#: phase 22's crossover sweep: 131,072-row power-law matrices whose (256, 1)
#: layouts cost 8.3-24.1 B a stored entry, (entries a row, columns), at
#: n = 50 and 256; and phase 9's 8192^2 SpGEMM operand (20 a row, 9.65 B)
#: at the widths of B in SPMM_WIDE
SPMM_CROSSOVER_SWEEP = tuple((k, 4096) for k in (8, 9, 10, 11, 13, 14, 16, 20, 24, 64)) + tuple(
    (k, 1 << 16) for k in (64, 80, 96, 112, 128))
SPMM_WIDE = (50, 256, 1024, 8192)


def spmm_crossover_cases():
    """The crossover sweep's matrices, made one at a time: (name, nrows,
    ncols, (rowptr, cols, vals), the widths of B)."""
    for per_row, ncols in SPMM_CROSSOVER_SWEEP:
        yield (f"{per_row} a row over {ncols}", 131_072, ncols,
               power_law_rows(131_072, ncols, per_row, seed=per_row + ncols), (50, 256))
    yield "8192^2, 20 a row (phase 9)", 8192, 8192, sparse_square(8192, 20, 81), SPMM_WIDE


def phase_spmm_crossover(rows, card, turns=1):
    """[22] Where SpMM's CSR form starts to win: at each matrix of
    spmm_crossover_cases and each width, the CSR-form kernel and the
    micro-block one (held to each other) timed by device_ms in turns,
    CSR form first then last, ``turns`` times each (the micro-block
    kernel's time by kernel beside its first); then, over these and
    ``rows`` (phase 22's table), the time ratios by layout bytes at n =
    50 and 256 beside the port's crossover.  Returns the sweep's rows."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k
    from csr_tpu_torch.ops import spmm as spmm_op

    sweep = []
    for name, nrows, ncols, (rp, cols, vals), widths in spmm_crossover_cases():
        csr = CSR(nrows, ncols, len(cols), rp, cols, vals)
        on_card(csr)
        mb = cuda_k._cached_layout(csr)
        fm = cuda_k._csr_form(csr)
        edges = cuda_k._spmm_edges(csr)
        mb_bytes = cuda_k._layout_bytes_per_entry(csr, False)
        for n in widths:
            bd = torch.randn(ncols, n, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(nrows + ncols + n))
            fns = {"csr": lambda: spmm_op.spmm_csr(*fm, bd, edges=edges),
                   "microblock": lambda: spmm_op.spmm(mb, bd)}
            share = spmm_share_card(fns["csr"](), fns["microblock"]())
            runs = {"csr": [], "microblock": []}
            for _ in range(turns):
                for k in ("csr", "microblock", "microblock", "csr"):
                    if k == "microblock" and not runs[k]:
                        ms, parts = device_ms(fns[k], 10, by_kernel=True)
                    else:
                        ms = device_ms(fns[k], 10)
                    runs[k].append(ms)
            med = {k: float(np.median(v)) for k, v in runs.items()}
            sweep.append(dict(matrix=name, n=n,
                              microblock_bytes_per_entry=mb_bytes,
                              csr_ms=med["csr"], microblock_ms=med["microblock"],
                              csr_runs=runs["csr"], microblock_runs=runs["microblock"],
                              microblock_parts=parts))
            print(f"[22] crossover sweep, {name} ({nrows} rows), "
                  f"n {n}, layout {mb_bytes:.2f} B a stored entry: CSR form "
                  f"{' '.join(f'{t:.5f}' for t in runs['csr'])} ms, micro-block "
                  f"{' '.join(f'{t:.5f}' for t in runs['microblock'])} ms (the first "
                  f"by kernel: {', '.join(f'{k[:40]} {t:.5f}' for k, t in parts.items())}); "
                  f"ratio of medians {med['microblock'] / med['csr']:.4f}; kernels "
                  f"agree, share {share:.3g}; card {card}")
            del bd, fns
        del csr, mb, fm, edges
        torch.cuda.empty_cache()
    for n in (50, 256):
        pts = "; ".join(f"{b:.2f} {r:.3f} ({m})" for b, r, m in spmm_crossover(rows + sweep, n))
        print(f"[22] B x {n}: layout bytes a stored entry and micro-block time / "
              f"CSR-form time (above 1: the CSR form is the faster): {pts}; the "
              f"port's crossover is {cuda_k._spmm_crossover(n):.4g}")
    print(json.dumps({"spmm_crossover_sweep": sweep}))
    return sweep


def phase_spmm_csr_vmap(card, k=50):
    """[22] ``torch.func.vmap`` of ``mult_vec`` at phase 20's hypersparse
    matrix (a CSR-routed matrix): one ``spmm_csr`` launch and no layout
    built, held to the SpMV bound against a loop of ``k`` ``mult_vec``
    calls (the CSR-form SpMV) and against scipy; both timed by device_ms.
    Returns the launches."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel

    nrows, ncols = 65_536, 1 << 20
    rp, cols, vals = power_law_rows(nrows, ncols, 12, seed=12 + (1 << 20))
    a = sps.csr_matrix((vals, cols, rp), shape=(nrows, ncols))
    csr = CSR(nrows, ncols, len(cols), rp, cols, vals)
    on_card(csr)
    X = torch.randn(k, ncols, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2230))
    with use_kernel("cuda"):
        assert cuda_k._spmv_route(csr, False) == "csr"
        launch_counts(reset=True)
        Y = torch.func.vmap(lambda v: csr.mult_vec(v))(X)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert {m: c for m, c in counts.items() if c} == {"spmm_csr": 1}, counts
        for form in ("layout", "large"):
            assert kept(csr, form) is None, form
        Y_loop = torch.stack([csr.mult_vec(X[i]) for i in range(k)])
        ms_batch = device_ms(lambda: torch.func.vmap(lambda v: csr.mult_vec(v))(X))
        ms_loop = device_ms(lambda: [csr.mult_vec(X[i]) for i in range(k)])
    xs = X.cpu().numpy()
    share = spmv_share(Y, Y_loop.cpu().numpy(), a, xs)
    share_s = spmv_share(Y, (a.astype(np.float64) @ xs.T.astype(np.float64)).T, a, xs)
    print(f"[22] vmap of mult_vec, hypersparse ({nrows}x{ncols}), k = {k}: launches "
          f"{counts}, no layout built; share of bound vs the loop of {k} mult_vec "
          f"{share:.3g}, vs scipy {share_s:.3g}; device time {ms_batch:.5f} ms a "
          f"batch against {ms_loop:.5f} ms for the loop; card {card}")
    return counts["spmm_csr"]


def phase_stat_memory(card, nnz=1 << 27, per_row=32, ncols=1 << 20, seed=2240):
    """[22] The route statistic's device memory: the peak allocated over
    the first ``mult_vec`` of a fresh CSR of ``nnz`` entries (``per_row``
    uniform columns a row over ``ncols``, made on the card from a seed),
    less what was allocated before it, and the call's host seconds; the
    product held to ``spmv_csr_reference``.  It uses only what the port
    had before the statistic ran by chunks, so that it runs against an
    earlier tree too (chip_smoke.py imported with that tree's package
    first on the path)."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel
    from csr_tpu_torch.ops import _cuda, spmv as spmv_op

    _cuda.library("spmv_csr")  # built before the call is timed
    g = torch.Generator(device="cuda").manual_seed(seed)
    nrows = nnz // per_row
    rp = torch.arange(nrows + 1, device="cuda", dtype=torch.int32) * per_row
    cols = torch.randint(0, ncols, (nnz,), device="cuda", generator=g,
                         dtype=torch.int32)
    vals = torch.randn(nnz, device="cuda", generator=g)
    csr = CSR(nrows, ncols, nnz, rp, cols, vals)
    x = torch.randn(ncols, device="cuda", generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with use_kernel("cuda"):
        t0 = time.perf_counter()
        y = csr.mult_vec(x)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    route = cuda_k._spmv_route(csr, False)
    y_ref = spmv_op.spmv_csr_reference(csr.rowptrs, csr.colinds, csr.values, x)
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    assert err <= 1e-4 * max(1.0, scale), (err, scale)
    out = dict(nnz=nnz, route=route, peak_bytes=peak, peak_bytes_per_entry=peak / nnz,
               first_call_s=secs, layout_bytes_per_entry=cuda_k._layout_bytes_per_entry(
                   csr, False))
    print(f"[22] the route statistic at {nnz} entries ({nrows}x{ncols}): first "
          f"mult_vec {secs:.3f} s, route {route}, peak device memory over it "
          f"{peak / 2**20:.1f} MiB ({peak / nnz:.2f} B a stored entry); kernel vs "
          f"plain max abs err {err:.3g} (|y| up to {scale:.4g}); card {card}")
    print(json.dumps({"stat_memory": out}))
    return out


def phase_inplace(card):
    """[22] Fault A on the card: after ``values.mul_(2)``, ``mult_vec``,
    ``mult_vec_t`` and ``mult_dense`` on every route (SpMV: micro-block,
    CSR form, chunk/panel; SpMM: micro-block, CSR form, chunk/panel,
    dense), called once before the edit so that every form is cached,
    hold to scipy's products of the new values."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel

    rng = np.random.default_rng(2250)
    a = sps.random(3000, 2000, 0.01, format="csr", random_state=rng,
                   dtype=np.float32)
    x = rng.standard_normal(2000).astype(np.float32)
    xt = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal((2000, 24)).astype(np.float32)
    inf = float("inf")
    settings = {  # route: (_CSR_CROSSOVER and _CSR_CROSSOVER_LARGE,
        # _SPMM_CSR_CROSSOVER, _LARGE_WINDOWS, _DENSIFY_CROSSOVER)
        "micro-block": (inf, inf, ((1, inf),), cuda_k._LARGE_WINDOWS, ((1, 2.0),)),
        "CSR form": (0.0, 0.0, ((1, 0.0),), cuda_k._LARGE_WINDOWS, ((1, 2.0),)),
        "chunk/panel": (inf, inf, ((1, inf),), 4, ((1, 2.0),)),
        "dense": (inf, inf, ((1, inf),), cuda_k._LARGE_WINDOWS, ((1, 0.0),)),
    }
    names = ("_CSR_CROSSOVER", "_CSR_CROSSOVER_LARGE", "_SPMM_CSR_CROSSOVER",
             "_LARGE_WINDOWS", "_DENSIFY_CROSSOVER")
    saved = [getattr(cuda_k, k) for k in names]
    try:
        for route, values in settings.items():
            for k, v in zip(names, values):
                setattr(cuda_k, k, v)
            csr = CSR.from_scipy(a)
            on_card(csr)
            xd, xtd, bd = (torch.from_numpy(t).cuda() for t in (x, xt, b))
            with use_kernel("cuda"):
                csr.mult_vec(xd), csr.mult_vec_t(xtd), csr.mult_dense(bd)
                csr.values.mul_(2)
                y, yt, c = csr.mult_vec(xd), csr.mult_vec_t(xtd), csr.mult_dense(bd)
            a2 = a.astype(np.float64) * 2
            shares = (spmv_share(y, a2 @ x, 2 * a, x),
                      spmv_share(yt, a2.T @ xt, (2 * a).T.tocsr(), xt),
                      spmm_share(c, a2 @ b))
            print(f"[22] in-place edit, {route} routes: mult_vec, mult_vec_t and "
                  f"mult_dense after values.mul_(2) within their bounds of scipy's "
                  f"products of the new values (shares {', '.join(f'{s:.3g}' for s in shares)})")
    finally:
        for k, v in zip(names, saved):
            setattr(cuda_k, k, v)


def spmm_csr_summary(rows, corner_err):
    """The spmm_csr entry of the kernels line: phase 22's numbers at the
    realistic case (n = 50), with the hypersparse matrix at n = 50 beside
    them."""
    by = {(r["matrix"], r["n"]): r for r in rows}
    real, hyper = by["realistic", 50], by["hypersparse", 50]
    out = dict(max_abs_err=max([corner_err] + [r["max_abs_err"] for r in rows]),
               ms=real["csr_ms"], plain_ms=real["plain_ms"],
               bound_ms=real["bound_ms"], bound_by=real["bound_by"],
               library_ms=real["library_ms"])
    for key in ("csr_ms", "microblock_ms", "plain_ms", "bound_ms", "library_ms"):
        out[f"{key.replace('csr_', '')}_hypersparse"] = hyper[key]
    return out


#: slabs (MiB of L2 a panel's rows of B may take) that phase 23 times
PANEL_SLABS_MIB = (8, 12, 16, 20, 25, 30, 40)
#: shares of a rating set's entries that phase 23 keeps to thin its rows
PANEL_KEEP = (1 / 2, 1 / 4, 1 / 8, 1 / 16, 1 / 32)


def panels_of(csr, slab_bytes, n):
    """The column panels of ``csr`` with B ``n`` wide and a slab of
    ``slab_bytes`` (the rule's count for that slab, with no threshold),
    built on the card, and the seconds the build took."""
    from csr_tpu_torch.kernels import cuda as cuda_k
    from csr_tpu_torch.ops import spmm as spmm_op

    k = cuda_k.panels_for_slab(csr.ncols, n, slab_bytes)
    if k < 2:
        return None, 0.0
    rp, ci, _ = cuda_k._csr_form(csr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    panels = spmm_op.split_panels(rp, ci, spmm_op.panel_bounds(csr.ncols, k))
    torch.cuda.synchronize()
    return panels, time.perf_counter() - t0


def thinned(csr, keep, seed):
    """``csr`` with each entry kept with chance ``keep`` (on the card)."""
    from csr_tpu_torch import CSR

    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.rand(csr.nnz, device="cuda", generator=g) < keep
    rows = torch.repeat_interleave(torch.arange(csr.nrows, device="cuda"),
                                   torch.diff(csr.rowptrs.long()), output_size=csr.nnz)
    counts = torch.bincount(rows[mask], minlength=csr.nrows)
    rp = torch.zeros(csr.nrows + 1, dtype=torch.int64, device="cuda")
    torch.cumsum(counts, 0, out=rp[1:])
    ci, v = csr.colinds[mask], csr.values[mask]
    return CSR(csr.nrows, csr.ncols, int(ci.shape[0]), rp.to(csr.rowptrs.dtype), ci, v)


#: the panelled CSR-form SpMM's largest gap to the plain version, as a
#: share of |A| |B| (the card tests' limit)
PANEL_ERR_LIMIT = 1e-6


def plain_and_scale(fm, b):
    """``spmm_csr_reference`` of the CSR form ``fm`` by ``b`` on the card,
    and |A| |B| (the same of the absolute values), the scale of each
    element's rounding error."""
    from csr_tpu_torch.ops import spmm as spmm_op

    rp, ci, v = fm
    return (spmm_op.spmm_csr_reference(rp, ci, v, b),
            spmm_op.spmm_csr_reference(rp, ci, None if v is None else v.abs(), b.abs()))


def gap_to(c, plain):
    """The largest ``|c - ref|`` as a share of its element's |A| |B|, for
    ``plain`` = (ref, scale) of :func:`plain_and_scale`."""
    ref, scale = plain
    return float(((c - ref).abs() / scale.clamp_min(1e-30)).max())


def time_panels(tag, csr, b, slabs, card, turns=1):
    """[23] The CSR-form SpMM of ``csr`` by ``b`` in one pass and in the
    panels of each slab (MiB), by device_ms in turns (one pass first and
    last); the one pass and each panelled result held to the plain version
    within PANEL_ERR_LIMIT of |A| |B|, each panelled one run twice for
    equal bits.  Returns rows of (slab, panels, entries a row a panel,
    ms, one-pass ms, ratio, error), the panelled calls made and the plain
    version (ref, scale)."""
    from csr_tpu_torch.kernels import cuda as cuda_k
    from csr_tpu_torch.ops import spmm as spmm_op

    fm = cuda_k._csr_form(csr)
    edges = cuda_k._spmm_edges(csr)
    n = b.shape[1]
    plain = plain_and_scale(fm, b)
    one = lambda: spmm_op.spmm_csr(*fm, b, edges=edges)
    c1 = one()
    one_err = gap_to(c1, plain)
    assert one_err <= PANEL_ERR_LIMIT, (tag, "one pass", one_err)
    scale = float(c1.abs().max())
    base = [device_ms(one, 5)]
    rows = []
    calls = [0]
    for slab in slabs:
        panels, build_s = panels_of(csr, int(slab * (1 << 20)), n)
        if panels is None:
            continue

        def fn(panels=panels):
            calls[0] += 1
            return spmm_op.spmm_csr(*fm, b, panels=panels)

        c = fn()
        same = bool(torch.equal(fn(), c))
        err = gap_to(c, plain)
        gap = float((c - c1).abs().max()) / scale
        ms = [device_ms(fn, 5) for _ in range(turns)]
        t = float(np.median(ms))
        per = csr.nnz / csr.nrows / panels.count
        rows.append(dict(matrix=tag, n=n, slab_mib=slab, panels=panels.count,
                         per_row_panel=per, ms=t, build_s=build_s,
                         metadata_bytes=panels.nbytes, max_err=err))
        print(f"[23] {tag}, n {n}: slab {slab} MiB, {panels.count} panels, "
              f"{per:.2f} entries a row a panel: {' '.join(f'{x:.5f}' for x in ms)} ms "
              f"(one pass {base[-1]:.5f}); built in {build_s:.3f} s, "
              f"{panels.nbytes / csr.nrows / panels.count:.2f} B a row a panel; "
              f"gap to the plain version {err:.3g} of |A||B| (one pass {one_err:.3g}), "
              f"to one pass {gap:.3g} of max |C|; repeatable {same}; card {card}")
        assert same, (tag, slab, "the panelled product is not bitwise repeatable")
        assert err <= PANEL_ERR_LIMIT, (tag, slab, err)
        del c, fn, panels
    base.append(device_ms(one, 5))
    one_ms = float(np.median(base))
    for r in rows:
        r["one_pass_ms"] = one_ms
        r["ratio"] = one_ms / r["ms"]
    print(f"[23] {tag}, n {n}: one pass {' '.join(f'{x:.5f}' for x in base)} ms; "
          f"one-pass time / panelled time by slab: "
          + "; ".join(f"{r['slab_mib']} MiB ({r['panels']}) {r['ratio']:.3f}" for r in rows))
    return rows, calls[0], plain


def api_panels(tag, csr, b, plain, card):
    """[23] ``csr.mult_dense(b)`` through the API at the port's own rule:
    the panels built once, then three plan hits, each bitwise the first
    call's result, the rule's panels counted a call, and the first within
    PANEL_ERR_LIMIT of |A| |B| of the plain version.  Returns the
    panelled calls and the gap."""
    from csr_tpu_torch import tracing
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel

    k = cuda_k.spmm_panel_count(csr.nrows, csr.ncols, csr.nnz, b.shape[1],
                                cuda_k._l2_bytes(b.device))
    rec = tracing.enable()
    try:
        with use_kernel("cuda"):
            c = csr.mult_dense(b)
            hits = [csr.mult_dense(b) for _ in range(3)]
        torch.cuda.synchronize()
        snap = rec.snapshot()
    finally:
        tracing.disable()
    counters = snap["counters"]
    build = snap["spans"].get("csr.build.spmm_panels", {}).get("total_ns", 0) / 1e9
    equal = all(torch.equal(h, c) for h in hits)
    err = gap_to(c, plain)
    print(f"[23] {tag}.mult_dense through the API: the rule's {k} panels; counters "
          f"{ {n: v for n, v in counters.items() if 'panel' in n or n.startswith('plan.')} }; "
          f"csr.build.spmm_panels {build:.3f} s; hits equal {equal}; gap to the plain "
          f"version {err:.3g} of |A||B|; card {card}")
    assert k > 1, (tag, "the rule keeps one pass")
    assert equal, (tag, "a plan's hit is not bitwise the first call")
    assert counters.get("plan.hit") == 3, counters
    assert counters.get("csr.spmm.panels") == 4 * k, counters
    assert counters.get("form_builds.spmm_panels") == 1, counters
    assert err <= PANEL_ERR_LIMIT, (tag, err)
    return 4, err


def phase_spmm_panels(card):
    """[23] The CSR-form SpMM in column panels: at KDD-Cup'11's R . Q and
    Rt . P (the benchmark's generator, seed 1) in one pass and at each
    slab of PANEL_SLABS_MIB; the same R thinned to PANEL_KEEP of its
    entries (rows of 131 down to 8 entries) at each slab, and the 131,072
    x 2^22 and 2^20 sweep matrices of phase 22, to find the entries a row
    a panel below which one pass wins; every result held to the plain
    version; then the port's rule at each, the metadata's build time and
    bytes, and mult_dense at both yahoo products through the API (the
    rule's panels, the plan's hits).  Returns the sweep's rows, the
    panelled calls and their largest gap to the plain version."""
    from cardbench import generate
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k

    t0 = time.perf_counter()
    cfg = generate.load_config("yahoo-kddcup11")
    trip = generate.ratings(cfg, 1, "cuda")
    r = CSR.from_coo(trip["rows"], trip["cols"], trip["vals"], shape=trip["shape"],
                     device="cuda")
    del trip
    rt = r.transpose()
    torch.cuda.synchronize()
    print(f"[23] yahoo R {r.nrows} x {r.ncols}, {r.nnz} entries, and Rt made in "
          f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randn(r.ncols, 50, device="cuda", generator=g)
    p = torch.randn(r.nrows, 50, device="cuda", generator=g)
    calls, errs = 0, []
    sweep = []
    for tag, m, b in (("yahoo R.Q", r, q), ("yahoo Rt.P", rt, p)):
        rows, made, plain = time_panels(tag, m, b, PANEL_SLABS_MIB, card, turns=2)
        api_calls, api_err = api_panels(tag, m, b, plain, card)
        sweep += rows
        calls += made + api_calls
        errs.append(api_err)
        del plain
    del rt, p
    torch.cuda.empty_cache()
    for keep in PANEL_KEEP:
        thin = thinned(r, keep, seed=int(1 / keep))
        rows, made, _ = time_panels(f"yahoo R thinned to {keep:.4g}", thin, q,
                                    (12, 20, 30), card)
        sweep += rows
        calls += made
        del thin
        torch.cuda.empty_cache()
    for per_row, ncols in ((12, 1 << 22), (64, 1 << 20), (327, 1 << 20)):
        rp, cols, vals = power_law_rows(131_072, ncols, per_row, seed=per_row + ncols)
        m = CSR(131_072, ncols, len(cols), rp, cols, vals)
        m.sort_rows()  # the panels take rows in column order
        on_card(m)
        bd = torch.randn(ncols, 50, device="cuda", generator=g)
        rows, made, _ = time_panels(f"{per_row} a row over {ncols}", m, bd,
                                    (12, 20, 30), card)
        sweep += rows
        calls += made
        del m, bd
        torch.cuda.empty_cache()
    l2 = cuda_k._l2_bytes(torch.device("cuda"))
    print(f"[23] L2 {l2} B; the port's slab {cuda_k._PANEL_L2_SHARE} of it "
          f"({l2 * cuda_k._PANEL_L2_SHARE / (1 << 20):.1f} MiB), threshold "
          f"{cuda_k._PANEL_MIN_ENTRIES} entries a row a panel")
    for row in sorted(sweep, key=lambda x: x["per_row_panel"]):
        print(f"[23] {row['per_row_panel']:.2f} a row a panel, slab {row['slab_mib']} "
              f"MiB ({row['panels']}): ratio {row['ratio']:.3f} ({row['matrix']})")
    max_err = max(errs + [row["max_err"] for row in sweep])
    print(f"[23] {calls} panelled calls, largest gap to the plain version {max_err:.3g} "
          f"of |A||B| (limit {PANEL_ERR_LIMIT})")
    print(json.dumps({"spmm_panels_sweep": sweep}))
    return sweep, calls, max_err


#: the micro-block SpMM's largest gap to its plain version at the Netflix
#: shapes, as a share of |A| |B| (the benchmark's limit at its ALS cells)
NETFLIX_ERR_LIMIT = 1e-5


def phase_netflix(card, n=50):
    """[24] The micro-block SpMM at the Netflix Prize's shapes (the
    benchmark's generator, seed 1: 480,189 users x 17,770 movies,
    100,480,507 ratings): R . Q, whose B (3.6 MB) sits in L2, and Rt . P,
    whose B (96 MB) is past it and whose row windows hold about 207
    groups of 32 micro-rows each, all adding into C's same rows.  For
    each: the route, the layout's build time, bytes an entry and groups
    (``kernels/cuda.py:group_counts``), the kernel alone and the whole
    call (C's zeros, B's padded copy) by device_ms, the bound by bytes
    (``cardbench/roofline.py``), the gather rate, and the gap to the
    plain version (``spmm_reference``) as a share of |A| |B|, held to
    NETFLIX_ERR_LIMIT.  Returns the rows.  Runs alone as
    ``python3 -c "import chip_smoke as s; s.phase_netflix(s.phase_environment())"``."""
    import dataclasses

    from cardbench import generate, roofline
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k
    from csr_tpu_torch.ops import spmm as spmm_op

    t0 = time.perf_counter()
    cfg = generate.load_config("netflix")
    trip = generate.ratings(cfg, 1, "cuda")
    rounds = trip["redraw_rounds"]
    r = CSR.from_coo(trip["rows"], trip["cols"], trip["vals"], shape=trip["shape"],
                     device="cuda")
    del trip
    rt = r.transpose()
    torch.cuda.synchronize()
    print(f"[24] netflix R {r.nrows} x {r.ncols}, {r.nnz} entries ({rounds} redraw "
          f"rounds), and Rt made in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(24)
    q = torch.randn(r.ncols, n, device="cuda", generator=g)
    p = torch.randn(r.nrows, n, device="cuda", generator=g)
    l2 = cuda_k._l2_bytes(q.device)
    rows = []
    for tag, m, b in (("netflix R.Q", r, q), ("netflix Rt.P", rt, p)):
        route = cuda_k._spmm_route(m, n)
        t1 = time.perf_counter()
        layout = cuda_k._cached_layout(m)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t1
        groups = cuda_k.group_counts(layout)
        fn = lambda layout=layout, b=b: spmm_op.spmm(layout, b)
        c = fn()
        ref = spmm_op.spmm_reference(layout, b)
        scale = spmm_op.spmm_reference(dataclasses.replace(layout, vals=layout.vals.abs()),
                                       b.abs())
        err = gap_to(c, (ref, scale))
        del ref, scale
        used = int((torch.bincount(m.colinds.long(), minlength=m.ncols) > 0).sum())
        nbytes, flops = roofline.product_work(m.nnz, m.nrows, m.rowptrs.element_size(),
                                              used, n, m.nrows)
        least = roofline.least_ms(nbytes, flops, card)
        whole, by_name = device_ms(fn, 5, by_kernel=True, floor_ms=least)
        kernel = sum(t for name, t in by_name.items() if "spmm" in name.lower())
        row = dict(matrix=tag, n=n, route=route, pack_s=pack_s, **groups,
                   bytes_an_entry=layout.nbytes / m.nnz, b_bytes=b.numel() * 4,
                   b_past_l2=spmm_op.b_past_l2(m.ncols, n, l2), kernel_ms=kernel,
                   call_ms=whole, least_ms=least, max_err=err,
                   gather_tbps=m.nnz * n * 4 / kernel / 1e9)
        rows.append(row)
        print(f"[24] {tag}, n {n}: route {route}; layout built in {pack_s:.2f} s, "
              f"{row['bytes_an_entry']:.2f} B an entry, {groups['windows']} row windows, "
              f"{groups['groups']} groups, at most {groups['groups_max']} a window; B "
              f"{row['b_bytes'] / 1e6:.1f} MB, past L2 ({l2} B) {row['b_past_l2']}; kernel "
              f"{kernel:.5f} ms, whole call {whole:.5f} ms "
              f"({', '.join(f'{k[:30]} {v:.5f}' for k, v in by_name.items())}); bound "
              f"{least:.5f} ms by bytes ({least / kernel:.3f} of it); gather "
              f"{row['gather_tbps']:.3f} TB/s; gap to the plain version {err:.3g} of "
              f"|A||B|; card {card}")
        assert route == "kernel", (tag, route)
        assert err <= NETFLIX_ERR_LIMIT, (tag, err)
        del c, fn, layout
        torch.cuda.empty_cache()
    print(json.dumps({"netflix_spmm": rows}))
    return rows


def stamp(tag, t0=time.perf_counter()):
    """Print the seconds since the script started, after ``tag``."""
    print(f"[time] {tag}: {time.perf_counter() - t0:.1f} s since the start")


def main():
    card = phase_environment()
    phase_kernel_vs_plain()
    phase_spmm_kernel_vs_plain()
    stamp("phases 1, 2, 6")

    from csr_tpu_torch.kernels import _listeners, cuda as cuda_k
    from csr_tpu_torch.ops import spmm as spmm_op, spmv as spmv_op

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

    phase_timing(*main_layouts[0][:2], card)
    phase_alone(main_layouts, card)

    # the SpMM main path, on the matrices of phases 3 and 4 (the bound
    # CSR.mult_vec of each holds it; its layout is cached): mult_dense at
    # both shapes, then multiply both ways
    fl_csr, fl_a = main_layouts[0][3].__self__, main_layouts[0][2]
    ml_csr, ml_a = main_layouts[2][3].__self__, main_layouts[2][2]
    rng = np.random.default_rng(256)
    b_fl = rng.standard_normal((fl_csr.ncols, 256)).astype(np.float32)
    b_ml = rng.standard_normal((ml_csr.ncols, 50)).astype(np.float32)
    routes = []
    _listeners.append(
        lambda e, f: routes.append((e, f["route"])) if "route" in f else None)
    spmm_op.launches = 0
    try:
        bd_fl = phase_mult_dense("7", fl_csr, fl_a, b_fl)
        bd_ml = phase_mult_dense("8", ml_csr, ml_a, b_ml)
        mul_a, mul_b = phase_multiply()
    finally:
        _listeners.pop()
    spmm_launches = spmm_op.launches
    expect = [("mult_dense", "kernel")] * 2 + [("spgemm", "kernel")] * 2
    assert routes == expect, routes
    assert spmm_launches == 4, spmm_launches
    print(f"[9] SpMM launches in the main path: {spmm_launches}; routes {routes}")

    # the SpMM kernel against its plain version at the main path's shapes
    # (these launches come after the count was read)
    spmm_err = 0.0
    for tag, layout, bd in (
        ("flagship", cuda_k._cached_layout(fl_csr), bd_fl),
        ("MovieLens shape", cuda_k._cached_layout(ml_csr), bd_ml),
        ("multiply", cuda_k._cached_layout(mul_a),
         torch.from_numpy(mul_b.toarray()).cuda()),
    ):
        c = spmm_op.spmm(layout, bd)
        err = share = 0.0
        for plain in (spmm_op.spmm_reference, spmm_op.spmm_regrouped):
            c_ref = plain(layout, bd)
            torch.cuda.synchronize()
            err = max(err, float((c - c_ref).abs().max()))
            share = max(share, spmm_share(c, c_ref.cpu().numpy()))
        spmm_err = max(spmm_err, err)
        print(f"[10] kernel vs both plain versions, {tag} ({layout.nrows}x"
              f"{layout.ncols}, n {bd.shape[1]}): max abs err {err:.3g} (|C| up "
              f"to {float(c_ref.abs().max()):.4g}), share of bound {share:.3g}")
        del c, c_ref
    phase_spmm_timing("flagship", cuda_k._cached_layout(fl_csr), bd_fl, card)
    phase_spmm_timing("MovieLens shape", cuda_k._cached_layout(ml_csr), bd_ml, card)
    phase_densify_threshold(card)
    stamp("phases 3-11")

    # the ring main path (local form, D = 4) at both shapes; the bucket
    # kernel's count is read right after it
    phase_bucket_vs_plain()
    spmv_op.bucket_launches = 0
    fl_ring = phase_ring("13", fl_csr, fl_a, fl[5])
    ml_ring = phase_ring("13", ml_csr, ml_a, ml[5])
    bucket_launches = spmv_op.bucket_launches
    assert bucket_launches == 8, bucket_launches
    phase_dist(fl_csr, fl_a, fl[5])
    phase_ring_timing(*fl_ring, fl_csr, card)
    phase_ring_timing(*ml_ring, ml_csr, card)
    bucket = phase_bucket_steps("15", *fl_ring, fl_a, card)
    bucket_ml = phase_bucket_steps("15", *ml_ring, ml_a, card)
    bucket["max_abs_err"] = max(bucket["max_abs_err"], bucket_ml["max_abs_err"])
    for key in ("ms", "bound_ms", "library_ms", "one_layer_ms",
                "one_layer_bound_ms", "one_layer_library_ms"):
        bucket[f"{key}_movielens"] = bucket_ml[key]
    del fl_ring, ml_ring

    lib_fl = phase_library("16", fl_a, cuda_k._cached_layout(fl_csr), fl[5],
                           bd_fl, card, iters=300, mm_iters=20)
    lib_ml = phase_library("16", ml_a, cuda_k._cached_layout(ml_csr), ml[5],
                           bd_ml, card, iters=100, mm_iters=10)
    stamp("phases 12-16")

    # the item-item path through ESC, and spmv_large (its launches are
    # counted from 0 inside the phase, after the count above was read)
    item_item = phase_item_item(ml, card)
    stamp("phase 17")
    large = phase_large(fl_csr, fl_a, fl[5], card)
    stamp("phase 18")
    # the harness, vmap and grad (each path's launches counted from 0
    # inside the phase, after the counts above were read)
    harness_paths = phase_harness(fl_csr, fl_a, ml_csr, ml_a, card)
    stamp("phase 19")
    # the six (window, pair) layouts, and the chooser held to the fastest
    layouts = phase_layouts(fl, ml, card)
    stamp("phase 20")
    # the CSR-form kernel and its route (each matrix's launches counted
    # from 0 inside the phase, after the counts above were read)
    csr_err = phase_csr_kernel_vs_plain()
    csr_rows, csr_launches = phase_csr(fl, ml, card)
    stamp("phase 21")
    # the CSR-form SpMM kernel, its route, vmap on it (launches counted
    # from 0 before each API call, after the counts above were read), and
    # the two repaired faults
    spmm_csr_err = phase_spmm_csr_kernel_vs_plain()
    stamp("phase 22 (a), the kernel against its plain version")
    spmm_csr_rows, spmm_csr_launches = phase_spmm_csr(fl, ml, card)
    stamp("phase 22 (b, c), times and routes")
    phase_spmm_crossover(spmm_csr_rows, card)
    stamp("phase 22 (b), the crossover sweep")
    spmm_csr_launches += phase_spmm_csr_vmap(card)
    phase_stat_memory(card)
    phase_inplace(card)
    stamp("phase 22")
    _, panel_launches, panel_err = phase_spmm_panels(card)
    stamp("phase 23")
    phase_netflix(card)
    stamp("phase 24")

    def yardsticks(name):
        """Device times, the bound and the chained times at the flagship,
        and the kernel's and the library's device time at the MovieLens
        shape beside them."""
        return dict(lib_fl[name], ms_movielens=lib_ml[name]["ms"],
                    library_ms_movielens=lib_ml[name]["library_ms"])

    print(json.dumps({"esc_item_item": item_item}))
    print(json.dumps({"harness": {k: harness_paths[k] for k in
                                  ("bench", "bench_weak", "vmap", "dispatch")}}))
    print(json.dumps({"chosen_layouts": {
        m["matrix"]: dict(chosen=m["chosen"], fastest=m["fastest"])
        for m in layouts}}))
    print(json.dumps({"kernels": [
        dict(KERNEL, launches=launches, max_abs_err=max_err, **large,
             **yardsticks("SpMV")),
        dict(SPMM_KERNEL, launches=spmm_launches, max_abs_err=spmm_err,
             **yardsticks("SpMM")),
        dict(BUCKET_KERNEL, launches=bucket_launches, **bucket),
        dict(CSR_KERNEL, launches=csr_launches, **csr_summary(csr_rows, csr_err)),
        dict(CSR_SPMM_KERNEL, launches=spmm_csr_launches,
             **spmm_csr_summary(spmm_csr_rows, spmm_csr_err),
             panel_launches=panel_launches, panel_max_err_share=panel_err),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
