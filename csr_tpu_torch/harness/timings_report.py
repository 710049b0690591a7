"""
Benchmark analysis (counterpart of the JAX package's root
``timings_report.py``): a summary of :mod:`.benchmarks` output by kernel
and group, and a comparison between two saved runs.

    python -m csr_tpu_torch.harness.benchmarks > bench_results.jsonl
    python -m csr_tpu_torch.harness.timings_report bench_results.jsonl

    python -m csr_tpu_torch.harness.benchmarks --save   # bench_history_torch/
    python -m csr_tpu_torch.harness.timings_report --compare          # last two
    python -m csr_tpu_torch.harness.timings_report --compare OLD NEW

``--compare`` reads ``bench_history_torch/`` by default and flags a
change of more than 15%; it exits 1 when a benchmark regressed.  Two runs
whose ``device`` differs (another card, another power limit, a TPU run of
the JAX script's ``bench_history/``) are not comparable: it says so and
exits 2, comparing nothing.
"""

from __future__ import annotations

import json
import math
import os
import sys
from collections import defaultdict

from csr_tpu_torch.harness import HISTORY_DIR


class NotComparable(ValueError):
    """Two saved runs from different devices."""


def _load_history(path):
    with open(path) as f:
        run = json.load(f)
    table = {}
    for r in run["results"]:
        # rate rows (MultAB-ESC-rate) have no ms_per_op: not compared
        if "ms_per_op" in r:
            table[(r["group"], str(r.get("param")), r["kernel"])] = r["ms_per_op"]
    return run, table


def _timing_runs(history_dir):
    """The saved benchmark runs of ``history_dir``, oldest first."""
    def is_timing_run(path):
        try:
            with open(path) as f:
                return "backend" in json.load(f)
        except (OSError, ValueError):
            return False

    if not os.path.isdir(history_dir):
        return []
    return sorted(p for f in os.listdir(history_dir) if f.endswith(".json")
                  and is_timing_run(p := os.path.join(history_dir, f)))


def compare(old_path=None, new_path=None, threshold=0.15,
            history_dir=HISTORY_DIR) -> int:
    """Compare two saved runs (by default the last two of
    ``history_dir``) and flag changes beyond ``threshold``.  Returns the
    number of regressions; raises :class:`NotComparable` when the runs'
    ``device`` differs."""
    if old_path is None or new_path is None:
        files = _timing_runs(history_dir)
        if len(files) < 2:
            print(f"need two runs in {history_dir} (have {len(files)}); run "
                  "`python -m csr_tpu_torch.harness.benchmarks --save` first")
            return 0
        old_path, new_path = files[-2], files[-1]
    old_run, old = _load_history(old_path)
    new_run, new = _load_history(new_path)
    if old_run.get("device") != new_run.get("device"):
        raise NotComparable(
            f"{os.path.basename(old_path)} ran on {old_run.get('device')!r} and "
            f"{os.path.basename(new_path)} on {new_run.get('device')!r}: "
            "timings from different devices are not comparable")
    for tag, path, run in (("old", old_path, old_run), ("new", new_path, new_run)):
        print(f"{tag}: {os.path.basename(path)} ({run['git_rev']}, "
              f"{run['backend']}, {run['device']})")

    header = (f"{'group':<18} {'param':>8} {'kernel':>8} "
              f"{'old ms':>10} {'new ms':>10} {'delta':>8}")
    print(header)
    print("-" * len(header))
    regressions = 0
    for key in sorted(set(old) & set(new)):
        o, n = old[key], new[key]
        delta = (n - o) / o if o else float("inf")
        flag = ""
        if delta > threshold:
            flag = "  <-- REGRESSION"
            regressions += 1
        elif delta < -threshold:
            flag = "  (improved)"
        group, param, kernel = key
        print(f"{group:<18} {param:>8} {kernel:>8} {o:>10.4f} {n:>10.4f} "
              f"{delta:>+7.1%}{flag}")
    missing = set(old) - set(new)
    if missing:
        print(f"{len(missing)} benchmarks present in old but not new")
    return regressions


def summary(path) -> dict:
    """Print the ms of every (group, param) by kernel from a file of
    :mod:`.benchmarks` output lines, and each kernel's geometric-mean
    speedup over the first; returns the table."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                rows.append(json.loads(line))

    groups = defaultdict(dict)
    kernels = []
    for r in rows:
        if "ms_per_op" not in r:
            continue
        groups[(r["group"], r.get("param"))][r["kernel"]] = r["ms_per_op"]
        if r["kernel"] not in kernels:
            kernels.append(r["kernel"])

    header = f"{'group':<18} {'param':>8} " + " ".join(f"{k:>10}" for k in kernels)
    print(header)
    print("-" * len(header))
    for (group, param), vals in sorted(groups.items(),
                                       key=lambda kv: (kv[0][0], str(kv[0][1]))):
        cells = " ".join(f"{vals.get(k, float('nan')):>10.4f}" for k in kernels)
        print(f"{group:<18} {str(param):>8} {cells}")

    if len(kernels) > 1:
        base = kernels[0]
        print()
        for k in kernels[1:]:
            logs = [math.log(vals[base] / vals[k]) for vals in groups.values()
                    if base in vals and k in vals and vals[k] > 0]
            if logs:
                print(f"geomean speedup {k} vs {base}: "
                      f"{math.exp(sum(logs) / len(logs)):.2f}x")
    return dict(groups)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--compare":
        try:
            return 1 if compare(*argv[1:3]) else 0
        except NotComparable as e:
            print(f"refused: {e}")
            return 2
    summary(argv[0] if argv else "bench_results.jsonl")
    return 0


if __name__ == "__main__":
    sys.exit(main())
