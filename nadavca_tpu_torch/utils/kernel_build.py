"""Builds the CUDA sources under ``csrc/`` into one shared library.

Twin in role of ``nadavca_tpu/utils/native_build.py``. The sources have a
plain C interface and include nothing of PyTorch, so ``nvcc`` compiles each in
seconds (the walk's, with its 64 instantiations for bands up to 1024 slots, in
about a minute). There are four: the fills (``viterbi_fill.cu``), the walk
(``backtrack.cu``), the local rescore (``rescore.cu``) and the locus scatter
(``scatter.cu``); each is compiled
to an object by its own ``nvcc`` process, all started together, and one link
step makes ``libnadavca_kernels.so``, which is loaded with ``ctypes``. The
output lives in ``nadavca_tpu_torch/_build/<hash>/`` keyed by a hash of the
sources and the flags, is built at first use and never committed. A failed
build raises with the compiler's output; nothing falls back.

Flags: ``-fmad=false`` and no ``--use_fast_math`` — the Viterbi fill must take
the decisions eager PyTorch takes for the same expression, and the local
rescore must give the plain version's scores to the last bit (see
``csrc/common.cuh``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libnadavca_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None   # None until a build ran in this process


def sources() -> List[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC_DIR)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(CSRC_DIR, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of nadavca_tpu_torch cannot be built on this machine")


def build_library() -> str:
    """Compile and link the kernels if this source state has no library yet.

    Returns the library's path. The compiler's register / shared-memory
    report (``-Xptxas -v``) is kept beside it as ``ptxas.log``.
    """
    global last_build_seconds
    out_dir = os.path.join(BUILD_ROOT, _digest())
    so = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(so):
        return so
    nvcc = find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    tmp = tempfile.mkdtemp(dir=out_dir)
    try:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc] + NVCC_FLAGS + ["-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, objs, failed = [], [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            log.append(f"== {os.path.basename(src)} (rc {p.returncode})\n{out}")
            objs.append(obj)
            if p.returncode != 0:
                failed.append(os.path.basename(src))
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
        tmp_so = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_so] + objs,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
            f.write("\n".join(log))
        # rename into place: concurrent builders race benignly
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    last_build_seconds = time.time() - t0
    return so


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nadavca_viterbi_fill.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, f, f, p]
    lib.nadavca_viterbi_fill.restype = i
    lib.nadavca_viterbi_fill_skip.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, f, f, f, p]
    lib.nadavca_viterbi_fill_skip.restype = i
    lib.nadavca_viterbi_fill_pair.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, f, f, f, f, f, p]
    lib.nadavca_viterbi_fill_pair.restype = i
    lib.nadavca_viterbi_fill_layout.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                                i, i, i, i, i, f, f, i, p]
    lib.nadavca_viterbi_fill_layout.restype = i
    lib.nadavca_viterbi_fill_skip_layout.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                                     i, i, i, i, i, f, f, f, i, p]
    lib.nadavca_viterbi_fill_skip_layout.restype = i
    lib.nadavca_viterbi_fill_pair_layout.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                                     i, i, i, i, i, f, f, f, f, f, i, p]
    lib.nadavca_viterbi_fill_pair_layout.restype = i
    lib.nadavca_fill_slots_per_lane.argtypes = [i, i]
    lib.nadavca_fill_slots_per_lane.restype = i
    lib.nadavca_backtrack.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.nadavca_backtrack.restype = i
    lib.nadavca_backtrack_skip.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.nadavca_backtrack_skip.restype = i
    lib.nadavca_rescore_local_tab.argtypes = [p, p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, i, i, i, f, f, p]
    lib.nadavca_rescore_local_tab.restype = i
    lib.nadavca_rescore_local.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                          i, i, i, i, i, i, i, i, f, f, p]
    lib.nadavca_rescore_local.restype = i
    lib.nadavca_index_add_windows.argtypes = [p, p, p, p, i, i, i, p, p, p,
                                              i, i, ctypes.c_longlong, f, f, p]
    lib.nadavca_index_add_windows.restype = i
    lib.nadavca_error_string.argtypes = [i]
    lib.nadavca_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            _declare(lib)
            _lib = lib
        return _lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.nadavca_error_string(code).decode("ascii", "replace")
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")
