"""
The benchmark's command: one run of one cell.

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It needs a CUDA card (there is no CPU fallback) and the program,
``csr_tpu_torch``, beside this folder.  The last line of standard output
is the run's result as one JSON object; the last lines of standard
error give each number the check compared, beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: top-level modules that may not be loaded in a run: JAX, and the JAX
#: package the program was ported from (compared by whole name: the
#: program's own name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "csr_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from cardbench.cell import find_cell, load_benchmark

    cell = find_cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("cardbench: no CUDA device; the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"cardbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    return execute(args, "cuda", card_line())


def execute(args, device: str, card: str, **overrides) -> int:
    """The run after the look for a card: the cell on ``device``, the
    check for forbidden modules, the checks on standard error and the
    result as the last line of standard output.  ``overrides`` go to
    :func:`cardbench.cell.run_cell` (a test's small configuration)."""
    import torch

    from cardbench.cell import load_benchmark, run_cell

    name = torch.cuda.get_device_name(0) if device == "cuda" else device
    result = run_cell(load_benchmark(), args.workload, args.seed, args.seconds,
                      bool(args.trace), device=device, t_start=T_START, card=name,
                      info=lambda r: print("cardbench report: " + json.dumps(r, default=str),
                                           flush=True),
                      **overrides)
    bad = forbidden_modules()
    if bad:
        print(f"cardbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    for key, c in checks.items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
