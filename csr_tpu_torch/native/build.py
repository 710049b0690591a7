"""
On-demand builds of the port's shared libraries.

:func:`build_cached` compiles one source into this package's git-ignored
``_build/`` directory, under a file name that carries a hash of the
source and the command, so an edit rebuilds and an unchanged source is
built once.  Several processes (pytest-xdist workers) may race for a
build, so each writes a temporary file and moves it into place with
``os.replace``: no process ever loads a half-written library.

:func:`ensure_built` builds the native host library from the JAX
package's ``csr_tpu/native/csr_host.cpp`` (the same source, read by path:
importing ``csr_tpu.native`` would pull in jax).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "csr_tpu", "native", "csr_host.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def build_cached(src: str, name: str, cmd: list, timeout: int):
    """Compile ``src`` with ``cmd + [src, "-o", out]`` into
    ``_build/<name>_<hash>.so`` unless it is there.  Returns the library
    path and the compiler's output; raises if the compiler fails."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(cmd).encode()).hexdigest()
    lib = os.path.join(BUILD_DIR, f"{name}_{key[:16]}.so")
    log = lib + ".log"
    if os.path.exists(lib):
        if os.path.exists(log):
            with open(log) as f:
                return lib, f.read()
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, out = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([*cmd, src, "-o", out], capture_output=True,
                           text=True, timeout=timeout)
        output = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed on {src}:\n{output}")
        with open(out + ".log", "w") as f:
            f.write(output)
        os.replace(out + ".log", log)
        os.replace(out, lib)
    finally:
        for path in (out, out + ".log"):
            if os.path.exists(path):
                os.unlink(path)
    return lib, output


def ensure_built() -> str:
    """Build (if missing) and return the native host library's path."""
    return build_cached(SRC, "csr_host", ["g++", *_FLAGS], timeout=120)[0]
