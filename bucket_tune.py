"""
Design variants of the bucket-selecting SpMV kernel, timed on one card.

    python3 bucket_tune.py [--parent DIR] [--sass] [VARIANT ...]

A variant is ``A<ahead>W<warps>B<blocks an SM>``, optionally followed by
``-<probe>`` (see ``PROBES``) and ``@PATH``: the constants ``kAhead``,
``kWarps`` and ``kBlocksPerSm`` of ``csr_tpu_torch/csrc/spmv_bucket.cu``
(or of the copy at ``PATH``) are set so in a copy of the source, built
with the port's own ``nvcc`` flags into ``csr_tpu_torch/_build/`` (one
``nvcc`` each, side by side); a variant that does not build, or that the
runtime cannot fit on an SM, is reported and dropped.  ``--parent DIR``
adds the kernel of an earlier tree
(``DIR/csr_tpu_torch/csrc/spmv_bucket.cu``, whose C entry took the
largest group count in place of the grid).  Every variant is first held
to ``spmv_bucket_reference`` on every ring step of each shape, probes
excepted.  ``--sass`` writes each build's SASS to ``chiprun_out/`` and
prints the kernel's instruction count.

At the flagship (32768^2, 327 entries a row) and the MovieLens-25M shape,
both as chip_smoke makes them, partitioned for a D = 4 ring in the
mesh's local form, it prints for each variant the device time
(``chip_smoke.device_ms``) of a ring step over all four layers, mean of
the four steps taken in turn, and of the one-layer launch one rank of a
four-card ring makes, mean of the 16 (layer, step) pairs taken in turn;
each beside its bound.  The variants are timed in turns, in the order
given and then backwards, so that drift on the card shows.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sps
import torch

import chip_smoke as cs
from csr_tpu_torch import CSR
from csr_tpu_torch.native.build import BUILD_DIR, build_cached
from csr_tpu_torch.ops import _cuda, microblock as mb, spmv as spmv_op
from csr_tpu_torch.parallel import mb_ring
from csr_tpu_torch.parallel.partition import make_mesh
from csr_tpu_torch.utils.profiling import least_ms

SPEC = re.compile(r"A(\d+)W(\d+)B(\d+)(?:-(\w+))?$")
#: probes: the kernel with a part changed, for timing only (results are
#: wrong).  nogather: no x gathers (the products use the column index);
#: nocompute: the copies alone (no gather, no row sums)
PROBES = {"nogather": [("__ldg(xw + ", "float(")],
          "nocompute": [("if (n > 0) {  //", "if (false) {  //")]}


def build(spec, parent):
    """(library, blocks an SM of the grid) of one variant; 0 blocks for
    the parent's kernel, whose grid is its own."""
    if spec == "parent":
        src = os.path.join(parent, "csr_tpu_torch", "csrc", "spmv_bucket.cu")
        path, log = build_cached(src, "spmv_bucket_parent",
                                 [_cuda._nvcc(), *_cuda._FLAGS], timeout=600)
        return ctypes.CDLL(path), 0, log
    tag = re.sub(r"\W", "_", spec)
    spec, _, other = spec.partition("@")
    ahead, warps, blocks, probe = SPEC.match(spec).groups()
    text = open(other or os.path.join(_cuda.CSRC, "spmv_bucket.cu")).read()
    for old, new in PROBES.get(probe, []):
        assert old in text, (probe, old)
        text = text.replace(old, new)
    for name, value in (("kAhead", ahead), ("kWarps", warps),
                        ("kBlocksPerSm", blocks)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        assert n == 1, name
    os.makedirs(os.path.join(BUILD_DIR, "tune"), exist_ok=True)
    src = os.path.join(BUILD_DIR, "tune", f"spmv_bucket_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    path, log = build_cached(src, f"spmv_bucket_{tag}",
                             [_cuda._nvcc(), *_cuda._FLAGS], timeout=600)
    return ctypes.CDLL(path), int(blocks), log


def sass(spec, lib):
    """Write the SASS of a build to chiprun_out/ and print the number of
    instructions of its kernel."""
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True).stdout
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"sass_{re.sub(r'\W', '_', spec)}.txt"),
              "w") as f:
        f.write(text)
    count = len(re.findall(r"^\s+/\*[0-9a-f]{4}\*/", text, re.M))
    print(f"[tune] {spec} SASS: {count} instructions")


def launcher(lib, blocks_per_sm):
    fn = lib.csrt_spmv_bucket
    fn.restype = ctypes.c_int
    fn.argtypes = _cuda.ENTRIES["spmv_bucket"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launch(stack, held, x, y):
        grid = (stack.n_groups if blocks_per_sm == 0 else
                min(blocks_per_sm * sms, stack.n_layers * stack.n_groups))
        n_layers, n_buckets, m = stack.rbcb.shape
        rc = fn(stack.vals.data_ptr(), stack.meta.data_ptr(),
                stack.rbcb.data_ptr(), held.data_ptr(), stack.groups.data_ptr(),
                n_layers, n_buckets, m, x.data_ptr(), x.stride(0), y.data_ptr(),
                y.stride(0), grid, stack.epos_shift, stack.nrows,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return y
    return launch


def layer(stack, l):
    """Layer ``l`` of a stack alone, as one rank of the process form holds
    it (views, no copy)."""
    return mb.BucketStack(stack.nrows, stack.ncols, stack.window,
                          stack.vals[l:l + 1], stack.meta[l:l + 1],
                          stack.rbcb[l:l + 1], stack.groups[l:l + 1],
                          stack.n_groups)


def shape_case(tag, nrows, ncols, rowptr, cols, vals):
    a = sps.csr_matrix((vals, cols, rowptr), shape=(nrows, ncols))
    rmb = mb_ring.partition_ring_mb(CSR(nrows, ncols, len(cols), rowptr, cols,
                                        vals), 4).shard(make_mesh(4))
    d = rmb.n_shards
    steps = cs.step_matrices(rmb, a)
    bound4 = np.mean([least_ms(cs.csr_bytes(s.nnz, nrows, d * rmb.cols_per_shard,
                                            2 * nrows), 2 * s.nnz)[0]
                      for s in steps])
    starts = np.concatenate([[0], np.cumsum(rmb.nrows_local)])
    bound1 = []
    for l in range(d):
        for s in steps:
            nnz = int(s.indptr[starts[l + 1]] - s.indptr[starts[l]])
            rows = int(rmb.nrows_local[l])
            bound1.append(least_ms(cs.csr_bytes(nnz, rows, rmb.cols_per_shard,
                                                2 * rows), 2 * nnz)[0])
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.standard_normal((d, rmb.cols_per_shard))
                          .astype(np.float32)).cuda()
    print(f"[tune] {tag}: groups {rmb.groups.tolist()}; bound of a step "
          f"{bound4:.5f} ms, of a one-layer launch {np.mean(bound1):.5f} ms")
    return dict(tag=tag, stack=rmb.stack, held=make_mesh(4).held, xs=xs, d=d,
                bound4=bound4, bound1=float(np.mean(bound1)))


def check(launch, case):
    stack, held, xs, d = case["stack"], case["held"], case["xs"], case["d"]
    y0 = torch.randn(d, stack.nrows, device="cuda")
    worst = 0.0
    for k in range(d):
        y = launch(stack, held[k], xs, y0.clone())
        ref = spmv_op.spmv_bucket_reference(stack, held[k], xs, y0.clone())
        for l in range(d):
            y1 = launch(layer(stack, l), held[k][l:l + 1], xs[l:l + 1],
                        y0[l:l + 1].clone())
            worst = max(worst, float((y1[0] - ref[l]).abs().max()))
        worst = max(worst, float((y - ref).abs().max()))
    scale = float(ref.abs().max())
    assert worst <= 1e-4 * scale + 1e-4, (worst, scale)
    return worst


def times(launch, case):
    stack, held, xs, d = case["stack"], case["held"], case["xs"], case["d"]
    y = torch.zeros(d, stack.nrows, device="cuda")
    layers = [layer(stack, l) for l in range(d)]

    def four():
        for k in range(d):
            launch(stack, held[k], xs, y)

    def one():
        for k in range(d):
            for l in range(d):
                launch(layers[l], held[k][l:l + 1], xs[l:l + 1], y[l:l + 1])
    return cs.device_ms(four, 10) / d, cs.device_ms(one, 5) / (d * d)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("variants", nargs="*", default=["A1W32B1"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bucket_tune: no CUDA device")
    print(f"[tune] card: {cs.card_line()}")
    specs = (["parent"] if args.parent else []) + args.variants
    def try_build(spec):
        try:
            return build(spec, args.parent)
        except (RuntimeError, AssertionError) as exc:
            print(f"[tune] {spec} does not build: {str(exc)[-2000:]}")
            return None

    with ThreadPoolExecutor(len(specs)) as pool:
        built = {s: b for s, b in zip(specs, pool.map(try_build, specs)) if b}
    specs = [s for s in specs if s in built]
    for spec, (lib, _, log) in list(built.items()):
        if args.sass:
            sass(spec, lib)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[tune] {spec} ptxas: {line.strip()}")
        if spec != "parent":
            blocks, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            assert lib.csrt_spmv_bucket_occupancy(
                ctypes.byref(blocks), ctypes.byref(threads), ctypes.byref(smem)) == 0
            print(f"[tune] {spec}: {blocks.value} blocks an SM by the runtime, "
                  f"{threads.value} threads and {smem.value} B of shared memory "
                  "a block")
            if blocks.value == 0:
                specs.remove(spec)
    launches = {s: launcher(*built[s][:2]) for s in specs}
    fl = cs.flagship()
    ml = cs.movielens_shape()
    cases = [shape_case("flagship", *fl[:5]), shape_case("MovieLens shape", *ml[:5])]
    for case in cases:
        for spec, launch in launches.items():
            if "-" not in spec:
                print(f"[tune] {case['tag']} {spec}: max |kernel - plain| "
                      f"{check(launch, case):.3g}")
    rows = {}
    for spec in specs + specs[::-1]:
        for case in cases:
            t4, t1 = times(launches[spec], case)
            rows.setdefault((case["tag"], spec), []).append((t4, t1))
            print(f"[tune] {case['tag']} {spec}: step {t4:.5f} ms "
                  f"({case['bound4'] / t4:.4f} of it the bound), one layer "
                  f"{t1:.5f} ms ({case['bound1'] / t1:.4f})")
    for (tag, spec), ts in rows.items():
        t4 = [t for t, _ in ts]
        t1 = [t for _, t in ts]
        print(f"[tune] {tag} {spec}: step {min(t4):.5f}-{max(t4):.5f} ms, one "
              f"layer {min(t1):.5f}-{max(t1):.5f} ms; card {cs.card_line()}")


if __name__ == "__main__":
    sys.exit(main())
