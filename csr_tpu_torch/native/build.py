"""
On-demand builds of the port's shared libraries.

:func:`build_cached` compiles one source into this package's git-ignored
``_build/`` directory, under a file name that carries a hash of the
source, of the headers it includes by ``#include "..."`` (followed
through the headers themselves) and of the command, so an edit of any of
them rebuilds and an unchanged source is built once.  Several processes
(pytest-xdist workers) may race for a build, so each writes a temporary
file and moves it into place with ``os.replace``: no process ever loads
a half-written library.

:func:`ensure_built` builds the native host library from this package's
own ``native/csr_host.cpp``, a copy of the JAX package's source kept
equal to it by a test (same exported symbols, byte-equal layouts).
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "csr_host.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_files(src: str) -> list:
    """``src`` and every file it includes by ``#include "..."`` relative to
    the including file's directory, followed through the headers, each
    once, in the order met."""
    files, todo = [], [os.path.abspath(src)]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            names = _INCLUDE.findall(f.read())
        here = os.path.dirname(path)
        for name in names:
            header = os.path.normpath(os.path.join(here, name.decode()))
            if os.path.exists(header):
                todo.append(header)
    return files


def source_key(src: str, cmd: list) -> str:
    """Hash of ``src``, the headers it includes and the command."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for path in source_files(src):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build_cached(src: str, name: str, cmd: list, timeout: int):
    """Compile ``src`` with ``cmd + [src, "-o", out]`` into
    ``_build/<name>_<hash>.so`` unless it is there.  Returns the library
    path and the compiler's output; raises if the compiler fails."""
    key = source_key(src, cmd)
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
