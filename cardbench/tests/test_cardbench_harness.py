"""
The benchmark's own tests, on the CPU at small sizes (the program's
plain versions run there): the generator, every cell's set-up, step and
check against the reference, the traced run's reading, the result line,
the control and the planted faults that the check has to catch.  The
``gpu`` case runs a cell on the card and skips without one.

    python -m pytest cardbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cardbench import cell, generate, ops, program, readings, roofline, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = cell.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
#: small sizes of each configuration: every law kept, the counts cut
TINY = {"ml25m": {"users": 300, "items": 2000, "ratings": 9000},
        "amazon-books": {"users": 3000, "items": 1500, "ratings": 8400}}
PUBLISHED = {"ml25m": (162_541, 59_047, 25_000_095),
             "amazon-books": (8_026_324, 2_330_066, 22_507_155)}
SEED = 3_000_000_017  # past 32 signed bits, as the check's seeds are


def tiny_config(name: str) -> dict:
    cfg = generate.load_config(name)
    cfg.update(TINY[name])
    return cfg


def tiny_traffic(mix: str) -> dict:
    t = program.load_traffic(mix)
    for spec in t["step"]:
        if "block" in spec:
            spec["block"] = 256
    return t


def inputs(name: str) -> dict:
    w = cell.find_cell(BENCH, name)
    return {"config": tiny_config(w["config"]), "traffic": tiny_traffic(w["traffic"])}


def run_tiny(name: str, traced=False, seconds=0.2, seed=SEED) -> dict:
    return cell.run_cell(BENCH, name, seed, seconds, traced, device="cpu", **inputs(name))


def over(checks: dict) -> list:
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("name", sorted(TINY))
def test_generator_counts(name):
    cfg = tiny_config(name)
    trip = generate.ratings(cfg, SEED, "cpu")
    d = generate.describe(trip)
    assert (d["users"], d["items"], d["ratings"]) == (cfg["users"], cfg["items"], cfg["ratings"])
    assert d["user_min"] >= cfg["user_degree"]["min"]
    key = trip["rows"].long() * cfg["items"] + trip["cols"].long()
    assert bool((key[1:] > key[:-1]).all()), "sorted, each (user, item) pair once"
    scale = cfg["ratings_scale"]
    levels = (trip["vals"].double() - scale["low"]) / scale["step"]
    assert bool((levels == levels.round()).all())
    assert float(trip["vals"].min()) >= scale["low"] and float(trip["vals"].max()) <= scale["high"]
    assert trip["vals"].dtype == getattr(torch, cfg["dtype"])


@pytest.mark.parametrize("name", sorted(TINY))
def test_generator_repeats_from_seed(name):
    cfg = tiny_config(name)
    a, b = generate.ratings(cfg, SEED, "cpu"), generate.ratings(cfg, SEED, "cpu")
    c = generate.ratings(cfg, SEED + 1, "cpu")
    for k in ("rows", "cols", "vals"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["cols"], c["cols"])
    # the sizes are the configuration's: each user rates as many items
    # whatever the seed, and the seed draws which
    assert torch.equal(a["rows"], c["rows"])
    assert torch.equal(generate.dense(SEED, "Q", (5, 3), "cpu"),
                       generate.dense(SEED, "Q", (5, 3), "cpu"))
    assert not torch.equal(generate.dense(SEED, "Q", (5, 3), "cpu"),
                           generate.dense(SEED, "P", (5, 3), "cpu"))


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_counts(name):
    """The configuration files hold the published counts, and the degree
    law meets the published total exactly at full size."""
    cfg = generate.load_config(name)
    assert (cfg["users"], cfg["items"], cfg["ratings"]) == PUBLISHED[name]
    assert cfg["reduced"] == []
    deg = generate.degrees(cfg, generate.generator(SEED, "ratings", "cpu"), "cpu")
    law = cfg["user_degree"]
    assert deg.numel() == cfg["users"] and int(deg.sum()) == cfg["ratings"]
    assert int(deg.min()) >= law["min"]
    assert int(deg.max()) <= min(law.get("cap", cfg["items"]), cfg["items"])


def test_zipf_exponent_meets_the_mean():
    s = generate.zipf_exponent(22_507_155 / 8_026_324, 4096)
    k = torch.arange(1, 4097, dtype=torch.float64)
    p = k ** -s
    assert abs(float((k * p).sum() / p.sum()) - 22_507_155 / 8_026_324) < 1e-9


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct(name):
    r = run_tiny(name, seconds=0.6)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert r["metrics"]["step_ms"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_traced_cell(name):
    r = run_tiny(name, traced=True, seconds=0.4)
    assert r["correct"], r["checks"]
    want = {m["name"] for m in BENCH["per_layer"] if name in m.get("workloads", CELLS)}
    # on the CPU nothing runs on a card: no roofline or sort time to read
    assert set(r["metrics"]) <= want
    assert {"api_host_ms", "first_call_s", "kernels_per_step"} & set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "busy_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _corrupt(out, kind):
    """A product's output with a fault planted where it is produced."""
    from csr_tpu_torch import CSR

    if isinstance(out, torch.Tensor):
        out = out.clone()
        if kind == "unchanged":  # the result buffer never written
            out.zero_()
        elif kind == "half":  # half of the rows left out
            out[out.shape[0] // 2:] = 0
        else:  # one answer altered
            flat = out.view(-1)
            flat[int(flat.abs().argmax())] *= 1.01
        return out
    if kind == "unchanged":
        return CSR.empty(out.nrows, out.ncols, device=out.device)
    if kind == "half":
        rows = out.rowinds()
        return out.filter_nnzs(rows < out.nrows // 2)
    vals = out.values.clone()
    vals[int(vals.abs().argmax())] *= 1.01
    out.values = vals
    return out


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_caught(name, kind, monkeypatch):
    """A run whose products are broken underneath comes out not correct:
    a result left unwritten, half of its rows left out, one answer
    altered.  (One card: no exchange between cards to leave out.)"""
    from csr_tpu_torch import CSR

    for method in ("mult_dense", "mult_vec", "mult_vec_t", "multiply"):
        real = getattr(CSR, method)

        def broken(self, *a, _real=real, **k):
            return _corrupt(_real(self, *a, **k), kind)
        monkeypatch.setattr(CSR, method, broken)
    r = run_tiny(name)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    """The reference computed with TF32 operands, in the program's place,
    reads over a limit; the program reads under every limit."""
    spec = inputs(name)
    for seed in (SEED, SEED + 1, SEED + 2):
        nums = readings.control_numbers(spec["traffic"], spec["config"], seed,
                                        torch.device("cpu"))
        limits = spec["traffic"]["check"]
        assert any(v > limits[k.split(".")[1]] for k, v in nums.items()
                   if k.count(".") == 1), nums
        assert not over(run_tiny(name, seed=seed)["checks"])


def test_roofline_counts_the_work_not_the_route(monkeypatch):
    """The bytes and operations of a product: 8 B an entry, the row
    pointers, the operand rows the columns use once and the result once,
    whichever kernel the program routes the product to."""
    from csr_tpu_torch import CSR
    from csr_tpu_torch.kernels import cuda as cuda_k, use_kernel

    rows = torch.tensor([0, 0, 1, 3, 3, 3])
    cols = torch.tensor([1, 4, 1, 0, 2, 4])
    a = CSR.from_coo(rows, cols, torch.ones(6), shape=(5, 7), device="cpu")
    b = torch.ones(7, 50)
    want = (8 * 6 + 4 * 6 + 4 * 50 * (4 + 5), 2 * 6 * 50)
    assert roofline.product_work(6, 5, 4, 4, 50, 5) == want
    work = ops.registry()["mult_dense"].work
    for points in (((1, 0.0),), ((1, float("inf")),)):  # CSR form, micro-block
        monkeypatch.setattr(cuda_k, "_SPMM_CSR_CROSSOVER", points)
        with use_kernel("cuda"):
            a.mult_dense(b)
        assert work({"a": a, "b": b}) == want
    # the transposed SpMV reads the entries of v whose rows hold entries
    assert ops.registry()["mult_vec_t"].work({"a": a, "x": None}) == (
        8 * 6 + 4 * 6 + 4 * (3 + 7), 2 * 6)
    assert roofline.least_ms(3350e9, 0, "NVIDIA H100 80GB HBM3") == pytest.approx(1e3)
    assert roofline.least_ms(0, 67e12, "NVIDIA H100 80GB HBM3") == pytest.approx(1e3)


class _Event:
    """A kineto event as :func:`cardbench.trace.read` reads one."""

    def __init__(self, name, start, dur, device=False, corr=0, linked=0):
        from torch.autograd import DeviceType

        self._name, self._start, self._dur = name, start, dur
        self._dev = DeviceType.CUDA if device else DeviceType.CPU
        self._corr, self._linked = corr, linked

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


def test_trace_tables_feed_the_readers():
    """The profile reader gives every device operation and every host
    range of the window by name; the readers filter those tables
    themselves (the sort kernels, the kernel count, a product's share of
    its roofline)."""
    from cardbench import metrics
    from cardbench.trace import STEP, op_label, read

    mul = op_label("S", "multiply")
    ev = []
    for k in range(2):  # two steps of 100 us, one product call each
        t = 1000 + k * 100_000
        ev += [_Event(STEP, t, 100_000), _Event(mul, t + 10, 60_000),
               _Event("cudaLaunchKernel", t + 20, 5, corr=10 * k + 1),
               _Event("cudaLaunchKernel", t + 30, 5, corr=10 * k + 2),
               _Event("cudaMemcpyAsync", t + 40, 5, corr=10 * k + 3),
               _Event("DeviceRadixSortOnesweepKernel", t + 100, 20_000, True, 10 * k + 1),
               _Event("esc_expand", t + 20_200, 30_000, True, 10 * k + 2),
               _Event("Memcpy DtoH (Device -> Pageable)", t + 50_300, 1_000, True,
                      10 * k + 3)]
    p = read(ev, {mul: ("spgemm", 0.01)})
    assert p["steps"] == 2 and p["window_ns"] == 200_000
    assert p["device"]["DeviceRadixSortOnesweepKernel"] == ["kernel", 2, 40_000]
    assert p["device"]["Memcpy DtoH (Device -> Pageable)"][0] == "gpu_memcpy"
    assert p["host"][mul] == [2, 120_000] and p["host"][STEP] == [2, 200_000]
    assert p["busy_ns"] == 2 * 51_000 and p["unplaced"] == 0
    assert p["products"]["spgemm"] == {"least_ms": 0.02, "device_ns": 102_000, "calls": 2}
    rec = cell.Record(profile=p)
    assert metrics.reader("esc_sort_ms")(rec) == pytest.approx(0.02)
    assert metrics.reader("kernels_per_step")(rec) == 2
    assert metrics.reader("device_idle_share")(rec) == pytest.approx(49.0)
    assert metrics.reader("spmm_roofline")(rec) is None
    assert p["breakdown"]["device_ops"][0] == ["esc_expand", 60e-6]


SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from cardbench import run
from cardbench.tests.test_cardbench_harness import inputs
args = run.parse(["--workload", {name!r}, "--seed", "7", "--seconds", "0.2",
                  "--trace", {trace!r}])
rc = run.execute(args, "cpu", "cpu", **inputs({name!r}))
print("forbidden", run.forbidden_modules(), file=sys.stderr)
sys.exit(rc)
"""


@pytest.mark.parametrize("trace", ["0", "1"])
def test_result_line_and_no_jax(trace):
    """The last line holds the contract's keys, the checks last; the
    checks close standard error; no module of JAX or of the JAX package
    (top-level names compared whole) was loaded."""
    name = CELLS[0]
    p = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT, name=name, trace=trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace == "1" else []
    assert list(line) == keys + ["card", "checks"]
    err = p.stderr.strip().splitlines()
    assert err[-1] == "forbidden []"
    assert all(x.startswith("check ") for x in err[-1 - len(line["checks"]):-1])
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "cardbench"), tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from cardbench import run; import sys; "
            "sys.exit(run.execute(run.parse(['--workload', 'ml25m.als', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']), 'cpu', 'cpu'))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600, env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0
    assert not any(x.startswith("{") for x in p.stdout.splitlines())


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(name):
    """The command on the card at the cell's own size, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "cardbench.run", "--workload", name,
                        "--seed", "3000000019", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
