"""
The readings each check limit is set from, on the card at a cell's own
size (the benchmark's own runs never run this):

* the program's: whole runs of the cell (set-up, a short window, the
  check), one a seed, in one process;
* the control's: the reference put in the program's place and computed
  a precision lower than the configuration's float32 (TF32 operands,
  :func:`cardbench.reference.operand`), for the first step, against the
  float64 reference.

    python3 -m cardbench.readings --workload <name> --seeds 1,2,3 \\
        --control 4,5,6 --seconds 2 [--out FILE]

Prints one JSON line a run; with ``--out`` appends them to ``FILE``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from cardbench import cell, check, generate, program


def control_numbers(traffic: dict, config: dict, seed: int, device) -> dict:
    """The numbers the check compares, for the control's first step
    against the reference's: ``{"first.<output>[.bad]": number}``."""
    trip = generate.ratings(config, seed, device)
    g = generate.generator(seed, "start", "cpu")
    start = int(torch.randint(0, 1 << 30, (1,), generator=g))
    out = {}
    rctx = program.Context(device=device, seed=seed, start=start)
    cctx = program.Context(device=device, seed=seed, start=start, precision="tfloat32")
    env_c, calls_c = cell.reference_env(traffic, cctx, trip)
    got = cell.reference_step(cctx, env_c, calls_c, 0, {})
    got = {n: got[n] for n in traffic["check"]}
    del env_c
    env_r, calls_r = cell.reference_env(traffic, rctx, trip)
    ref = cell.reference_step(rctx, env_r, calls_r, 0, {})
    for n in traffic["check"]:
        for suffix, v in check.compare(got[n], ref[n]).items():
            out[f"first.{n}{suffix}"] = v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    bench = cell.load_benchmark()
    spec = cell.find_cell(bench, args.workload)
    config = generate.load_config(spec["config"])
    traffic = program.load_traffic(spec["traffic"])
    card = torch.cuda.get_device_name(0)

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for s in filter(None, args.seeds.split(",")):
        t0 = time.perf_counter()
        r = cell.run_cell(bench, args.workload, int(s), args.seconds, False,
                          device="cuda", t_start=t0, card=card)
        emit({"kind": "program", "workload": args.workload, "seed": int(s),
              "correct": r["correct"], "attempted": r["attempted"],
              "checks": {k: c["value"] for k, c in r["checks"].items()},
              "metrics": {k: m["value"] for k, m in r["metrics"].items()},
              "seconds": time.perf_counter() - t0})
        gc.collect()
        torch.cuda.empty_cache()
    for s in filter(None, args.control.split(",")):
        t0 = time.perf_counter()
        nums = control_numbers(traffic, config, int(s), torch.device("cuda"))
        emit({"kind": "control", "workload": args.workload, "seed": int(s),
              "checks": nums, "seconds": time.perf_counter() - t0})
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
