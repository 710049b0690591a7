"""
Weak-scaling benchmark of the distributed micro-block SpMV (counterpart
of the JAX package's root ``bench_weak.py``).

    python -m csr_tpu_torch.harness.bench_weak [--ring] [--max-devices 4]
        [--rows-per-device 16384] [--nnz-per-row 327] [--iters 300]

For each mesh size D = 1, 2, 4 (up to ``--max-devices``): a square matrix
of ``rows-per-device * D`` rows with ``nnz-per-row`` entries a row from
``default_rng(0)``, partitioned over a D-shard mesh, and a chain of
``--iters`` products, each shard's output normalised and fed back as its
next operand slice: the halo form (``mb_dist.spmv_halo``, the operand
column-sharded and all-gathered) or, with ``--ring``, the ring
(``mb_ring.spmv_ring_mb`` on the bucket kernel).  The chain is captured
once in a CUDA graph and replayed, as in :mod:`.bench`, best of
``--reps``; the eager chain's time goes beside it.  Each D prints one
JSON line; before the timing, the first product is held against scipy's
``A @ x`` (within the JAX suite's ``assert_spmv_close`` bound).

**One card runs the local form**: all D shards on the card, D launches a
product (a step of the ring serves all D layers in one launch), so every
line says ``"form": "local"``.  Its work at D is what a D-card mesh would
hold, run on one card: perfect weak scaling then keeps the D = 1 rate,
not D times it, so ``efficiency`` is the rate over the D = 1 rate.  Under
``torchrun`` (one process a card, ``WORLD_SIZE`` set) the mesh takes the
process form over NCCL at D = the world size alone, so no D = 1 rate
is at hand and ``efficiency`` is null; that form is accepted but not
verified here, which has one card.  On the CPU the sizes shrink (1024 rows a shard, 32 a row, 2
steps) and the host's clock times the plain versions: plumbing only.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from csr_tpu_torch.harness import normalized, on_card, spmv_share, sync


def fit(y: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of ``y`` (D, m) cut or zero-padded to ``n`` columns: a
    shard's output made into its next operand slice."""
    if y.shape[1] >= n:
        return y[:, :n]
    return torch.nn.functional.pad(y, (0, n - y.shape[1]))


def matrix(n_devices: int, rows_per_device: int, npr: int):
    """``(csr, x, (rowptr, cols, vals))`` of the JAX script's matrix for
    ``n_devices`` shards, on the card (the CPU where there is none)."""
    from csr_tpu_torch import CSR

    nrows = ncols = rows_per_device * n_devices
    nnz = nrows * npr
    rng = np.random.default_rng(0)
    rowptr = np.arange(nrows + 1, dtype=np.int64) * npr
    cols = rng.integers(0, ncols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal(ncols).astype(np.float32)
    csr = CSR(nrows, ncols, nnz, rowptr, cols, vals,
              device="cuda" if on_card() else "cpu")
    return csr, x, (rowptr, cols, vals)


def run(n_devices: int, rows_per_device: int, npr: int, iters: int,
        reps: int, ring: bool = False, group=None) -> dict:
    """One mesh size: the chain's seconds a product (captured and eager on
    the card, the host's clock on the CPU), the packing seconds, in the
    local form the first product's share of the SpMV bound against
    scipy's (raising past 1), and on the card the kernel launches the
    captured chain holds (``captured``), run again by each of its
    ``replays`` replays."""
    from csr_tpu_torch.parallel import mb_dist, mb_ring
    from csr_tpu_torch.parallel.partition import make_mesh
    from csr_tpu_torch.utils import profiling

    csr, x, arrays = matrix(n_devices, rows_per_device, npr)
    mesh = make_mesh(n_devices, group=group)
    t0 = time.perf_counter()
    if ring:
        part = mb_ring.partition_ring_mb(csr, n_devices).shard(mesh)
        xs = mb_ring.scatter_x(part, x, mesh)

        def product(xv):
            return mb_ring.spmv_ring_mb(part, xv, mesh)

        collect = mb_ring.collect_rows
    else:
        part = mb_dist.partition_microblocks(csr, n_devices).shard(mesh)
        xs = mb_dist.scatter_x(part, x, mesh)

        def product(xv):
            return mb_dist.spmv_halo(part, xv, mesh)

        collect = mb_dist.collect_rows
    sync()
    prep = time.perf_counter() - t0
    width = xs.shape[1]

    def step(xv):
        return normalized(fit(product(xv), width))

    share = None
    if mesh.group is None:  # the first product, collected, against scipy
        import scipy.sparse as sps

        rowptr, cols, vals = arrays
        a = sps.csr_matrix((vals, cols, rowptr), shape=(csr.nrows, csr.ncols))
        share = spmv_share(collect(part, product(xs)),
                           a.astype(np.float64) @ x, a, x)
    eager, captured = None, {}
    if on_card():
        dt, _, captured = profiling.timed_graph(step, xs, iters, reps)
        eager = profiling.timed_chained(step, xs, iters, reps)
    else:
        dt = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            v = xs
            for _ in range(iters):
                v = step(v)
            dt = min(dt, (time.perf_counter() - t0) / iters)
    return {"nnz": csr.nnz, "seconds": dt, "eager_seconds": eager,
            "prep_seconds": prep, "share": share,
            "captured": captured, "replays": reps if captured else 0}


def main(argv=None) -> list:
    """Print one JSON line a mesh size; returns the runs, each with its
    JSON line under ``line``."""
    from csr_tpu_torch.parallel import init_distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-per-device", type=int, default=16384)
    ap.add_argument("--nnz-per-row", type=int, default=327)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-devices", type=int, default=4)
    ap.add_argument("--ring", action="store_true",
                    help="the ring schedule (mb_ring) instead of the halo form")
    args = ap.parse_args(argv)
    if not on_card():  # plumbing only: shrink
        args.rows_per_device = min(args.rows_per_device, 1024)
        args.nnz_per_row = min(args.nnz_per_row, 32)
        args.iters, args.reps = 2, 1

    group = None
    sizes = []
    d = 1
    while d <= args.max_devices:
        sizes.append(d)
        d *= 2
    if on_card() and "LOCAL_RANK" in os.environ:  # torchrun: a card a rank
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if init_distributed():  # under torchrun: the process form
        import torch.distributed as dist

        group = dist.group.WORLD
        sizes = [dist.get_world_size()]
    runs = []
    base = None
    for d in sizes:
        r = run(d, args.rows_per_device, args.nnz_per_row, args.iters,
                args.reps, ring=args.ring, group=group)
        rate = r["nnz"] / r["seconds"] / 1e9
        base = base or rate
        eff = rate / base if group is None else None
        r["line"] = {
            "group": "WeakScaling-Ring" if args.ring else "WeakScaling",
            "devices": d, "form": "local" if group is None else "process",
            "nnz": r["nnz"], "ms_per_iter": r["seconds"] * 1e3,
            "eager_ms_per_iter": (None if r["eager_seconds"] is None
                                  else r["eager_seconds"] * 1e3),
            "gnnz_per_s": rate, "efficiency": eff,
            "prep_s": r["prep_seconds"], "first_step_share": r["share"],
        }
        if group is None or torch.distributed.get_rank() == 0:
            print(json.dumps(r["line"]))
        runs.append(r)
    return runs


if __name__ == "__main__":
    main()
