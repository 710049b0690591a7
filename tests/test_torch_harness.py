"""The port's benchmark harness (``csr_tpu_torch/harness/``) at its CPU
size: every module's ``main`` runs, prints what the JAX package's root
scripts print, and holds its products against scipy.  The times here are
the host's (plumbing only)."""

import ast
import glob
import json
import os

import pytest

from csr_tpu_torch.harness import bench, bench_weak, benchmarks, timings_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json_lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def _bench_py_keys():
    """The keys of the ``result`` dict of the JAX package's ``bench.py``."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no result dict in bench.py")


def test_bench_main(capsys):
    """One JSON line last, with exactly the keys of bench.py:116-124, after
    a line with the packing time; the chain's last product within the
    SpMV bound of scipy's."""
    r = bench.main([])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert list(line) == _bench_py_keys() == [
        "metric", "value", "unit", "vs_baseline", "effective_csr_gbps",
        "gnnz_s", "fill"]
    assert list(line) == list(bench.KEYS)
    assert line["metric"] == "spmv_gbps" and line["unit"] == "GB/s"
    assert line["vs_baseline"] is None  # no card: no device peak
    assert line["value"] > 0 and line["gnnz_s"] > 0 and 0 < line["fill"] <= 1
    assert out[-2].startswith("# device=cpu") and "prep=" in out[-2]
    assert (r.csr.nrows, r.csr.nnz) == (2048, 2048 * 32)
    assert 0 <= r.shares["eager_vs_scipy"] <= 1


def test_benchmarks_fast_multax(capsys):
    """``--fast --only MultAx`` on the three default backends (the
    aliases accepted): a row each, each checked against scipy."""
    rows = benchmarks.main(["--fast", "--only", "MultAx",
                            "--kernels", "scipy,xla,pallas"])
    printed = _json_lines(capsys.readouterr().out)
    assert printed == rows
    assert [(r["group"], r["kernel"]) for r in rows] == [
        ("MultAx", "scipy"), ("MultAx", "xla"), ("MultAx", "pallas")]
    for r in rows:
        assert r["ms_per_op"] > 0 and r["excess"] <= 5e-3
    assert benchmarks.DEFAULT_KERNELS == "scipy,torch,cuda"


def test_benchmarks_products_checked(capsys, tmp_path):
    """A size group's products, checked against scipy's on every backend,
    saved under the given history directory with the device's name."""
    rows = benchmarks.main(["--fast", "--only", "MultAB-Size", "--save"],
                           history_dir=str(tmp_path))
    capsys.readouterr()
    assert {(r["kernel"], r["param"]) for r in rows} == {
        (k, s) for k in ("scipy", "torch", "cuda") for s in (10, 100, 500)}
    (saved,) = glob.glob(str(tmp_path / "*.json"))
    with open(saved) as f:
        run = json.load(f)
    assert run["device"] == "cpu" and run["backend"] == "cpu"
    assert len(run["results"]) == 9


def test_benchmarks_check_raises_on_a_wrong_product():
    import numpy as np
    import scipy.sparse as sps
    import torch

    ref = np.array([1.0, 2.0, 3.0])
    assert benchmarks.check(torch.tensor([1.0, 2.0, 3.0]), ref) <= 0
    with pytest.raises(AssertionError, match="tols"):
        benchmarks.check(torch.tensor([1.0, 2.0, 3.1]), ref)
    from csr_tpu_torch import CSR

    m = sps.random(20, 20, 0.2, format="csr", random_state=np.random.default_rng(0))
    c = CSR.from_scipy(m, device="cpu")
    benchmarks.check(c, m)
    with pytest.raises(AssertionError):
        benchmarks.check(c, m * 1.01 + sps.eye(20))


@pytest.mark.parametrize("ring", [False, True])
def test_bench_weak_main(capsys, ring):
    """D = 1 and 2 in the local form: a JSON line each, the first product
    of each within the SpMV bound of scipy's."""
    argv = ["--max-devices", "2"] + (["--ring"] if ring else [])
    runs = bench_weak.main(argv)
    lines = _json_lines(capsys.readouterr().out)
    assert lines == [r["line"] for r in runs]
    assert [l["devices"] for l in lines] == [1, 2]
    for l in lines:
        assert l["group"] == ("WeakScaling-Ring" if ring else "WeakScaling")
        assert l["form"] == "local" and l["nnz"] == l["devices"] * 1024 * 32
        assert l["ms_per_iter"] > 0 and 0 <= l["first_step_share"] <= 1
    assert lines[0]["efficiency"] == 1.0


def test_timings_report_summary_and_compare(tmp_path, capsys):
    """The summary of a results file, and --compare of two runs on one
    device (a slower copy flags every benchmark)."""
    rows = [{"group": "MultAx", "kernel": k, "param": None, "ms_per_op": ms}
            for k, ms in (("scipy", 2.0), ("cuda", 0.5))]
    results = tmp_path / "results.jsonl"
    results.write_text("# a comment\n" + "\n".join(map(json.dumps, rows)) + "\n")
    assert timings_report.main([str(results)]) == 0
    out = capsys.readouterr().out
    assert "MultAx" in out and "geomean speedup cuda vs scipy: 4.00x" in out

    run = {"timestamp": "t", "git_rev": "r", "backend": "cuda",
           "device": "NVIDIA H100 80GB HBM3, 700.00 W", "results": rows}
    old, new = tmp_path / "a.json", tmp_path / "b.json"
    old.write_text(json.dumps(run))
    slower = dict(run, results=[dict(r, ms_per_op=2 * r["ms_per_op"]) for r in rows])
    new.write_text(json.dumps(slower))
    assert timings_report.compare(str(old), str(new)) == 2
    assert timings_report.main(["--compare", str(old), str(new)]) == 1
    assert timings_report.compare(history_dir=str(tmp_path)) == 2
    assert timings_report.compare(history_dir=str(tmp_path / "none")) == 0


def test_timings_report_refuses_another_device(tmp_path, capsys):
    """A TPU run of the JAX script's bench_history/ (read, never written)
    against a port run: refused, nothing compared."""
    tpu = os.path.join(ROOT, "bench_history", "20260821T143654-8fd0cae.json")
    with open(tpu, "rb") as f:
        before = f.read()
    tpu_run = json.loads(before)
    assert tpu_run["device"].startswith("TPU")
    port = tmp_path / "port.json"
    port.write_text(json.dumps(dict(tpu_run, backend="cuda",
                                    device="NVIDIA H100 80GB HBM3, 700.00 W")))
    with pytest.raises(timings_report.NotComparable, match="not comparable"):
        timings_report.compare(tpu, str(port))
    assert timings_report.main(["--compare", tpu, str(port)]) == 2
    assert "refused" in capsys.readouterr().out
    with open(tpu, "rb") as f:
        assert f.read() == before
    # the default directory is the port's own
    assert timings_report.HISTORY_DIR == os.path.join(ROOT, "bench_history_torch")


def test_benchmarks_check_leaves_the_reference_alone():
    """The check compares against a copy: scipy sorts an operand's indices
    in place, which would scramble a reference with unsorted rows (the
    product of two scipy matrices may have them) for the next backend."""
    import numpy as np
    import scipy.sparse as sps

    from csr_tpu_torch import CSR

    ref = sps.csr_matrix((np.array([1.0, 2.0, 3.0], np.float32),
                          np.array([2, 0, 1]), np.array([0, 3])), shape=(1, 3))
    ref.has_sorted_indices = False
    before = ref.indices.copy(), ref.data.copy()
    c = CSR.from_scipy(ref, device="cpu")
    benchmarks.check(c, ref)
    np.testing.assert_array_equal(ref.indices, before[0])
    np.testing.assert_array_equal(ref.data, before[1])
    benchmarks.check(c, ref)


def test_spmv_share_of_a_batch_is_that_of_its_rows():
    """``spmv_share`` of a (k, nrows) batch is the largest share of its
    rows, each against its own operand's bound; a row past its bound
    raises."""
    import numpy as np
    import scipy.sparse as sps

    from csr_tpu_torch.harness import spmv_share

    rng = np.random.default_rng(11)
    a = sps.random(300, 200, 0.05, format="csr", dtype=np.float32,
                   random_state=rng)
    X = rng.standard_normal((4, 200)).astype(np.float32)
    ref = (a.astype(np.float64) @ X.T.astype(np.float64)).T
    Y = (a @ X.T).T.astype(np.float32)
    rows = [spmv_share(Y[i], ref[i], a, X[i]) for i in range(4)]
    assert spmv_share(Y, ref, a, X) == pytest.approx(max(rows))
    Y[2, 7] += 1.0
    with pytest.raises(AssertionError, match="outside the bound"):
        spmv_share(Y, ref, a, X)
