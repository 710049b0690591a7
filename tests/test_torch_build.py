"""The port builds from its own sources: the native host library from
its own copy of ``csr_host.cpp`` (the same exported symbols as the JAX
package's), and every library under a name that carries a hash of the
source and of the headers it includes, so an edit of a shared header
rebuilds."""

import ctypes
import os
import pathlib
import re
import shutil

import pytest

from csr_tpu_torch.native import build
from csr_tpu_torch.ops import _cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "csr_tpu_torch"


def _exported(path):
    return sorted(re.findall(r'extern "C"[^(]*?\b(csrt_\w+)\s*\(',
                             pathlib.Path(path).read_text()))


def test_native_source_is_the_ports_own():
    src = pathlib.Path(build.SRC).resolve()
    assert PORT in src.parents and src.exists()
    ref = ROOT / "csr_tpu" / "native" / "csr_host.cpp"
    assert _exported(src) == _exported(ref) and len(_exported(src)) == 15
    assert pathlib.Path(_cuda.CSRC).resolve().parent == PORT


def test_native_library_exports_every_symbol():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    lib = ctypes.CDLL(build.ensure_built())
    assert PORT / "_build" in pathlib.Path(build.ensure_built()).parents
    for name in _exported(build.SRC):
        assert hasattr(lib, name), name


@pytest.mark.parametrize("name", sorted(_cuda.ENTRIES))
def test_kernel_sources_and_their_headers(name):
    src = os.path.join(_cuda.CSRC, f"{name}.cu")
    files = [os.path.basename(f) for f in build.source_files(src)]
    assert files[0] == f"{name}.cu"
    # only the SpMV kernel includes the micro-block body; the bucket
    # kernel carries its own, staged through shared memory
    assert ("microblock_spmv.cuh" in files) == (name == "spmv_microblock"), files
    text = pathlib.Path(src).read_text()
    assert f'extern "C" int csrt_{name}(' in text


def test_key_follows_headers(tmp_path):
    (tmp_path / "inner.h").write_text("#define INNER 1\n")
    (tmp_path / "outer.h").write_text('#include "inner.h"\n#define OUTER 2\n')
    src = tmp_path / "unit.cpp"
    src.write_text('#include <cstdint>\n  #  include "outer.h"\n'
                   '// #include "missing.h" names no file here\n'
                   'extern "C" int f() { return INNER + OUTER; }\n')
    files = [os.path.basename(f) for f in build.source_files(str(src))]
    assert files == ["unit.cpp", "outer.h", "inner.h"]
    cmd = ["g++", "-O1", "-shared", "-fPIC"]
    key = build.source_key(str(src), cmd)
    assert key == build.source_key(str(src), cmd)
    assert key != build.source_key(str(src), cmd + ["-g"])
    (tmp_path / "inner.h").write_text("#define INNER 5\n")
    assert key != build.source_key(str(src), cmd)


def test_header_edit_rebuilds(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    (tmp_path / "value.h").write_text("#define VALUE 7\n")
    src = tmp_path / "unit.cpp"
    src.write_text('#include "value.h"\nextern "C" int value() { return VALUE; }\n')
    cmd = ["g++", "-O1", "-shared", "-fPIC"]
    first, _ = build.build_cached(str(src), "unit", cmd, timeout=120)
    assert build.build_cached(str(src), "unit", cmd, timeout=120)[0] == first
    assert ctypes.CDLL(first).value() == 7
    (tmp_path / "value.h").write_text("#define VALUE 8\n")
    second, _ = build.build_cached(str(src), "unit", cmd, timeout=120)
    assert second != first and ctypes.CDLL(second).value() == 8


def test_bucket_kernel_opts_in_before_every_launch():
    """``cudaFuncSetAttribute`` holds for the current device only, so the
    bucket kernel's opt-in to more than 48 KB of shared memory is made
    before every launch, never cached once a process (a launch on a
    second card would go without it)."""
    text = pathlib.Path(_cuda.CSRC, "spmv_bucket.cu").read_text()
    code = re.sub(r"//[^\n]*", "", text)
    entry = code[code.index('extern "C" int csrt_spmv_bucket('):]
    entry = entry[: entry.index("\n}\n")]
    assert re.search(r"\ballow_shared_memory\(\)", entry), entry
    assert not re.search(r"\bstatic\b[^;]*allow_shared_memory", code)
    launch = entry.index("spmv_bucket_kernel<<<")
    assert entry.rindex("allow_shared_memory()", 0, launch) < launch
