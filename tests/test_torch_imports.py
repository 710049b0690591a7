"""The port stands alone: no module of ``csr_tpu_torch`` (nor
``chip_smoke.py``) imports jax or the JAX package or opens a path under
``csr_tpu/``, and the package imports on a machine with no jax, no nvcc,
no triton and no NCCL."""

import ast
import os
import pathlib
import re
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


_JAX_PACKAGE_PATH = re.compile(r"(^|[/\\\\])csr_tpu([/\\\\]|$)")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_the_jax_package(path):
    """No call (``os.path.join``, ``open``, ``Path`` ...) is handed a
    string with ``csr_tpu`` as a path component; docstrings may name the
    JAX package's files."""
    bad = [
        (node.lineno, arg.value)
        for node in ast.walk(ast.parse(path.read_text(), str(path)))
        if isinstance(node, ast.Call)
        for arg in [*node.args, *(k.value for k in node.keywords)]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str)
        and _JAX_PACKAGE_PATH.search(arg.value)
    ]
    assert not bad, f"{path.name} builds a path into csr_tpu/: {bad}"


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
assert not _cuda._LIBS, "a kernel was built at import"
import torch.distributed
from csr_tpu_torch import parallel
from csr_tpu_torch.parallel import dist, mb_dist, mb_ring, partition, ring
assert "csr_tpu_torch.parallel.mb_ring" in sys.modules
assert parallel.init_distributed() is False, "joined a group with none configured"
assert not torch.distributed.is_initialized()
print("nccl", torch.distributed.is_nccl_available())
print("imported", len(sys.modules))
"""


def test_imports_without_jax_nvcc_triton():
    bindir = os.path.dirname(sys.executable)
    env = dict(os.environ, PATH=f"{bindir}:/usr/bin:/bin", CUDA_HOME="",
               PYTHONPATH=str(ROOT))
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(name, None)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout
