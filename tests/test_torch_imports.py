"""The port stands alone: no module of ``csr_tpu_torch`` (nor
``chip_smoke.py``) imports jax or the JAX package, and the package
imports on a machine with no jax, no nvcc and no triton."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "csr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "csr_tpu"}


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [n for n in _imported(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


_IMPORT_ALL = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "csr_tpu", "triton"}
for k in list(sys.modules):
    if k.split(".")[0] in BLOCKED:
        del sys.modules[k]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import csr_tpu_torch
for m in pkgutil.walk_packages(csr_tpu_torch.__path__, "csr_tpu_torch."):
    importlib.import_module(m.name)
from csr_tpu_torch.ops import _cuda
assert _cuda._LIB is None, "a kernel was built at import"
print("imported", len(sys.modules))
"""


def test_imports_without_jax_nvcc_triton():
    bindir = os.path.dirname(sys.executable)
    env = dict(os.environ, PATH=f"{bindir}:/usr/bin:/bin", CUDA_HOME="",
               PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout
