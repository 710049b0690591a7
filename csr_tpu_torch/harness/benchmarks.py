"""
Kernel-comparative benchmark suite (counterpart of the JAX package's root
``benchmarks.py``): the reference's six pytest-benchmark groups as one
script, over the port's backends.

    python -m csr_tpu_torch.harness.benchmarks [--kernels scipy,torch,cuda]
        [--fast] [--only SUBSTRING] [--save]

Prints one JSON line a (group, kernel, param) with the median ms of one
API call, handle creation included, as the JAX script does; the groups,
their sizes and ``--fast``'s are the JAX script's.  ``--kernels`` takes
the registry's names and aliases (``xla`` for ``torch``, ``pallas`` for
``cuda``).

Where it differs from the JAX script:

* a call is timed between two reads of the host's clock with the card
  synchronised after it, and every error goes through: the JAX script's
  ``timeit`` swallows every exception of its sync;
* every (group, kernel, param) holds the result of its first call against
  scipy's within the JAX suite's ``tests/util.py:tols`` (f32), and raises
  if it is outside;
* the matrices are f32 and so is ``MultAx``'s operand: the JAX package
  narrows f64 to f32 without x64, and the port never narrows, so f64
  data would time the ``torch`` backend's f64 route instead;
* in ``MultAB-ESC`` a backend is skipped only where its product would not
  fit the card's free memory, and the script prints which;
* ``--save`` writes the run to ``bench_history_torch/``, never to the
  TPU's ``bench_history/``; its ``device`` is the card's name and power
  limit as ``nvidia-smi`` gives them (``cpu`` on the CPU), and
  ``timings_report --compare`` refuses two runs whose ``device`` differs.

On the CPU the times are the host's and only check the plumbing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import scipy.sparse as sps
import torch

from csr_tpu_torch.harness import HISTORY_DIR, device_line, on_card, sync, tols

DEFAULT_KERNELS = "scipy,torch,cuda"
#: peak bytes a product term of ESC holds on the card, and bytes an
#: output entry: 65 B a term is the peak that chip_smoke's phase 17
#: measured on an NVIDIA H100 80GB HBM3 (13.1 GiB allocated for
#: 217,250,243 terms in one chunk, ops/spgemm.py), all of it charged to
#: the terms
ESC_TERM_BYTES = 65
ESC_ENTRY_BYTES = 12


def make_csr(nrows, ncols, density, rng, device):
    """An f32 CSR of scipy's ``random`` on ``rng`` (the JAX script's
    draws, kept in f32) and its scipy form."""
    from csr_tpu_torch import CSR

    m = sps.random(nrows, ncols, density, format="csr", random_state=rng,
                   dtype=np.float32)
    return CSR.from_scipy(m, device=device), m


def timeit(fn, min_repeat=3, max_time=2.0):
    """The median ms of ``fn()``, the card synchronised after every call,
    after one warm-up call whose result is returned beside it: at least
    ``min_repeat`` calls and ``max_time / 4`` seconds, at most 50 calls."""
    first = fn()
    sync()
    times = []
    total = 0.0
    while len(times) < min_repeat or total < max_time / 4:
        t0 = time.perf_counter()
        fn()
        sync()
        dt = time.perf_counter() - t0
        times.append(dt)
        total += dt
        if len(times) >= 50:
            break
    return float(np.median(times) * 1e3), first


def check(got, ref) -> float:
    """Largest excess of ``|got - ref|`` over ``rtol * |ref|``, raising if
    it passes ``tols``' atol (f32): ``got`` a CSR or a tensor, ``ref`` a
    scipy matrix or a numpy array."""
    t = tols(np.float32)
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy().astype(np.float64)
        excess = np.abs(got - ref) - t["rtol"] * np.abs(ref)
        worst = float(excess.max(initial=0.0))
    else:
        got = got.to_scipy().astype(np.float64)
        # a copy: scipy sorts an operand's indices in place, and a dtype
        # change alone would share them with the caller's matrix
        ref = sps.csr_matrix(ref, dtype=np.float64, copy=True)
        worst = float((abs(got - ref) - t["rtol"] * abs(ref)).max())
    if not worst <= t["atol"]:
        raise AssertionError(f"outside tests/util.py:tols: excess {worst:.3g}"
                             f" over atol {t['atol']}")
    return worst


def esc_fits(kernel: str, terms: int, out_entries: int) -> bool:
    """Whether a product of ``terms`` expanded terms and about
    ``out_entries`` entries fits the card's free memory on ``kernel``
    (scipy and the CPU compute on the host: always)."""
    if kernel == "scipy" or not on_card():
        return True
    from csr_tpu_torch.ops import spgemm

    need = (min(terms, spgemm.esc_chunk_entries) * ESC_TERM_BYTES
            + out_entries * ESC_ENTRY_BYTES)
    return need <= torch.cuda.mem_get_info()[0]


def save_history(results, history_dir=HISTORY_DIR) -> str:
    """Write this run to ``history_dir`` (git revision, backend, the
    card's name and power limit, timestamp); returns the path."""
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(os.path.abspath(history_dir)),
        ).stdout.strip() or "unknown"
    except OSError:
        rev = "unknown"
    ts = time.strftime("%Y%m%dT%H%M%S")
    os.makedirs(history_dir, exist_ok=True)
    path = os.path.join(history_dir, f"{ts}-{rev}.json")
    with open(path, "w") as f:
        json.dump({"timestamp": ts, "git_rev": rev,
                   "backend": "cuda" if on_card() else "cpu",
                   "device": device_line(), "torch": torch.__version__,
                   "results": results}, f, indent=1)
    print(f"# saved {len(results)} results to {path}")
    return path


def main(argv=None, history_dir=HISTORY_DIR) -> list:
    """Run the groups; returns the printed rows (with each row's check
    excess under ``excess``)."""
    from csr_tpu_torch.kernels import get_kernel, use_kernel

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=DEFAULT_KERNELS)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--save", action="store_true",
                    help="write this run to bench_history_torch/")
    ap.add_argument("--only", default=None,
                    help="run only groups whose name contains this substring")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    for k in kernels:
        get_kernel(k)  # an unknown name raises here, before any timing
    device = "cuda" if on_card() else "cpu"
    rng = np.random.default_rng(42)
    only = args.only
    results = []

    def want(group):
        return only is None or only in group

    def report(group, kernel, param, fn, ref):
        with use_kernel(kernel):
            ms, first = timeit(fn)
        row = {"group": group, "kernel": kernel, "param": param,
               "ms_per_op": ms, "excess": check(first, ref)}
        results.append(row)
        print(json.dumps(row))
        return ms

    # fixed-workload groups (the reference's tests/test_bench_multiply.py)
    A1, a1 = make_csr(100, 500, 0.1, rng, device)
    B1, b1 = make_csr(500, 200, 0.2, rng, device)
    At, at = make_csr(100, 500, 0.1, rng, device)
    Bt, bt = make_csr(200, 500, 0.2, rng, device)
    Ax, ax = make_csr(100, 100, 0.1, rng, device)
    v_np = rng.standard_normal(100).astype(np.float32)
    v = torch.from_numpy(v_np).to(device)

    for k in kernels:
        if want("MultAB"):
            report("MultAB", k, None, lambda: A1.multiply(B1), a1 @ b1)
        if want("MultABt"):
            report("MultABt", k, None, lambda: At.multiply(Bt, transpose=True),
                   at @ bt.T)
        if want("MultAx"):
            report("MultAx", k, None, lambda: Ax.mult_vec(v), ax @ v_np)

    densities = [] if not want("Density") else [0.1, 0.5, 1.0] if args.fast else [
        round(x, 1) for x in np.arange(0, 1.01, 0.1)]
    for dens in densities:
        Ad, ad = make_csr(100, 100, dens, rng, device)
        Bd, bd = make_csr(100, 100, dens, rng, device)
        for k in kernels:
            report("MultAB-Density", k, dens, lambda: Ad.multiply(Bd), ad @ bd)
            report("MultABt-Density", k, dens,
                   lambda: Ad.multiply(Bd, transpose=True), ad @ bd.T)

    sizes = [] if not want("MultAB-Size") else [10, 100, 500] if args.fast else [
        5, 10, 15, 25, 50, 100, 200, 250, 500, 750, 1000]
    for size in sizes:
        As, as_ = make_csr(size, size, 0.1, rng, device)
        Bs, bs = make_csr(size, size, 0.1, rng, device)
        for k in kernels:
            report("MultAB-Size", k, size, lambda: As.multiply(Bs), as_ @ bs)

    # past the dense budget both port backends run expand-sort-compress;
    # about 50 entries a row, so about size * 2500 product terms
    esc_sizes = [] if not want("ESC") else [20_000] if args.fast else [
        20_000, 50_000, 100_000]
    for size in esc_sizes:
        Ae, ae = make_csr(size, size, 50.0 / size, rng, device)
        Be, be = make_csr(size, size, 50.0 / size, rng, device)
        ref = ae @ be
        terms = Ae.nnz * 50
        for k in kernels:
            if not esc_fits(k, terms, ref.nnz):
                print(f"# MultAB-ESC {size}: {k} skipped, its product would "
                      "not fit the card's free memory")
                continue
            ms = report("MultAB-ESC", k, size, lambda: Ae.multiply(Be), ref)
            row = {"group": "MultAB-ESC-rate", "kernel": k, "param": size,
                   "gterms_s": terms / (ms * 1e-3) / 1e9}
            results.append(row)
            print(json.dumps(row))

    if args.save:
        save_history(results, history_dir)
    return results


if __name__ == "__main__":
    main()
