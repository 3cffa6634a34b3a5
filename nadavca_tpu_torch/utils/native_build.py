"""Builds the host C++ sources under ``csrc/`` (``*.cpp``) with g++.

Counterpart of ``nadavca_tpu/utils/native_build.py``: ``-O3 -std=c++17
-shared -fPIC``, one shared library per source, named by a hash of the
source so a stale library never shadows an edited source. Libraries are
built at first use into ``nadavca_tpu_torch/_build/`` (never committed) and
loaded with ``ctypes``. No CUDA toolchain is involved: ``kernel_build``
compiles only the ``.cu`` sources.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")

CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def build_shared(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` into a shared library if this source has
    none yet; return the library's path. A failed build raises
    ``RuntimeError`` with the compiler's output (no g++: ``OSError``)."""
    src = os.path.join(CSRC_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_ROOT, f"lib{name}-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_ROOT, exist_ok=True)
    # build to a temporary file, then rename: concurrent builds race benignly
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_ROOT)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ could not build {src}:\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so
