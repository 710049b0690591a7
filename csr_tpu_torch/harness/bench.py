"""
Flagship benchmark: the micro-block SpMV kernel at 10.7M entries on one
card (counterpart of the JAX package's root ``bench.py``).

    python -m csr_tpu_torch.harness.bench [--iters K] [--reps R]

Prints ONE JSON line last, with the JAX script's keys::

    {"metric": "spmv_gbps", "value": <GB/s of layout bytes>, "unit": "GB/s",
     "vs_baseline": <value over the card's published bandwidth>,
     "effective_csr_gbps": <GB/s of a CSR's bytes>, "gnnz_s": <G entries/s>,
     "fill": <share of micro-row slots holding an entry>}

and, on the line before, the card, the eager chain's time a product and
the host's packing time.

The matrix is the JAX script's: 32768 x 32768 with 327 entries a row
from ``default_rng(0)`` (2048 x 32 on the CPU).  So is the chain: K = 300
products through ``CSR.mult_vec`` on the ``cuda`` backend, each divided
by its largest magnitude and fed back.  The JAX script runs the chain in
one jitted ``fori_loop``, a single dispatch; here the K steps are
captured once in a CUDA graph and replayed
(:func:`~csr_tpu_torch.utils.profiling.timed_graph`), best of 3 replays
between CUDA events.  The same chain run eagerly
(:func:`~csr_tpu_torch.utils.profiling.timed_chained`) pays the host's
cost of every call, so the two times side by side give the host's share
of a product.  ``value`` counts the layout's bytes a product (what the
kernel streams) and ``effective_csr_gbps`` the bytes an ideal CSR kernel
would move (8 B an entry, the row pointers, x and y), as the JAX script
does.  ``vs_baseline`` divides by
:func:`~csr_tpu_torch.utils.profiling.peak_gbps` of the card's name; a
card that table does not know is an error.  Numbers are printed
unrounded.

On the CPU the chain is 2 steps on the kernel's plain version, timed by
the host's clock: plumbing only, and ``vs_baseline`` is null.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np
import torch

from csr_tpu_torch.harness import device_line, normalized, on_card, spmv_share, sync

#: the keys of the JSON line, in the JAX script's order
KEYS = ("metric", "value", "unit", "vs_baseline", "effective_csr_gbps",
        "gnnz_s", "fill")


@dataclass
class BenchRun:
    """One run: the JSON line's fields and what produced them."""

    result: dict
    seconds: float  # a product in the captured chain (the CPU: host clock)
    eager_seconds: float | None  # a product in the eager chain (card only)
    prep_seconds: float  # packing the layout on the host
    #: kernel launches the captured chain holds, each run again by every
    #: one of ``replays`` replays (the launch counters see the capture
    #: alone; the card only)
    launches: dict
    replays: int
    #: shares of the SpMV bound of the chain's last product: the eager
    #: chain's output against scipy's, and the captured chain's against
    #: the eager one's (card only)
    shares: dict
    csr: object


def flagship(card: bool):
    """``(nrows, ncols, rowptr, cols, vals, x)`` of the JAX script's
    matrix, as numpy arrays: 32768^2 at 327 entries a row on the card,
    2048^2 at 32 on the CPU."""
    nrows = ncols = 32768 if card else 2048
    npr = 327 if card else 32
    nnz = nrows * npr
    rng = np.random.default_rng(0)
    rowptr = np.arange(nrows + 1, dtype=np.int64) * npr
    cols = rng.integers(0, ncols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal(ncols).astype(np.float32)
    return nrows, ncols, rowptr, cols, vals, x


def run(iters: int | None = None, reps: int | None = None) -> BenchRun:
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel
    from csr_tpu_torch.utils import profiling

    card = on_card()
    iters = iters or (300 if card else 2)
    reps = reps or (3 if card else 1)
    nrows, ncols, rowptr, cols, vals, x = flagship(card)
    nnz = len(cols)
    csr = CSR(nrows, ncols, nnz, rowptr, cols, vals,
              device="cuda" if card else "cpu")
    x0 = torch.from_numpy(x).to(csr.device)

    def step(v):
        return normalized(csr.mult_vec(v))

    with use_kernel("cuda"):
        t0 = time.perf_counter()
        layout = cuda_k._cached_layout(csr)
        sync()
        prep = time.perf_counter() - t0
        eager = y_graph = None
        if card:
            dt, y_graph, launches = profiling.timed_graph(step, x0, iters, reps)
            eager = profiling.timed_chained(step, x0, iters, reps)
        else:
            dt = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                v = x0
                for _ in range(iters):
                    v = step(v)
                dt = min(dt, (time.perf_counter() - t0) / iters)
            launches, reps = {}, 0
        # the eager chain once more, keeping its last operand, for the check
        v = x0
        for _ in range(iters - 1):
            v = step(v)
        y = csr.mult_vec(v)
        scale = torch.clamp_min(y.abs().max(), 1e-30)
        y_eager, x_last = y / scale, v / scale
    sync()
    # the last product against scipy's, and the captured chain's output
    # against the eager one's, both within the SpMV bound of that product
    import scipy.sparse as sps

    a = sps.csr_matrix((vals, cols, rowptr), shape=(nrows, ncols))
    xl = x_last.cpu().numpy()
    shares = {"eager_vs_scipy": spmv_share(y_eager, a.astype(np.float64) @ xl,
                                           a, xl)}
    if y_graph is not None:
        shares["graph_vs_eager"] = spmv_share(y_graph, y_eager, a, xl)

    peak = None
    if card:
        peak = profiling.peak_gbps()
        if peak is None:
            raise ValueError(f"no published bandwidth for "
                             f"{torch.cuda.get_device_name()}")
    gbps = layout.nbytes / dt / 1e9
    csr_bytes = nnz * 8 + (nrows + 1) * 4 + (nrows + ncols) * 4
    result = {
        "metric": "spmv_gbps",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": None if peak is None else gbps / peak,
        "effective_csr_gbps": csr_bytes / dt / 1e9,
        "gnnz_s": nnz / dt / 1e9,
        "fill": layout.fill,
    }
    return BenchRun(result, dt, eager, prep, launches, reps, shares, csr)


def main(argv=None) -> BenchRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=None,
                    help="products a chain (300 on the card, 2 on the CPU)")
    ap.add_argument("--reps", type=int, default=None,
                    help="chains timed, the best kept (3 on the card)")
    args = ap.parse_args(argv)
    r = run(args.iters, args.reps)
    nnz = r.csr.nnz
    chain = ("captured in a CUDA graph" if r.eager_seconds is not None
             else "host clock, plain version")
    eager = ("" if r.eager_seconds is None else
             f" eager={r.eager_seconds * 1e3:.5f}ms/iter"
             f" graph_share={r.seconds / r.eager_seconds:.3f}")
    print(f"# device={device_line()} nnz={nnz} fill={r.result['fill']} "
          f"prep={r.prep_seconds:.2f}s t={r.seconds * 1e3:.5f}ms/iter "
          f"({chain}){eager} launches a replay={r.launches} replays={r.replays} "
          f"bound shares {r.shares}")
    print(json.dumps(r.result))
    return r


if __name__ == "__main__":
    main()
