"""ctypes binding to the single-core C++ banded Viterbi and local rescore.

Counterpart of ``nadavca_tpu/ops/cpu_ref.py``: the same two functions, the
same signatures and ctypes argument lists, over ``csrc/banded_dp.cpp`` (a
byte-for-byte copy of the JAX package's source). It is the measured CPU
baseline: one host core, one read at a time, the role of the reference
tool's ``nadavca.dtw`` extension. The library is built by g++ at first use
into ``nadavca_tpu_torch/_build/`` (``utils/native_build``); a failed build
raises, and nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ..utils.native_build import build_shared

        lib = ctypes.CDLL(build_shared("banded_dp"))
        lib.banded_viterbi.restype = ctypes.c_int
        lib.banded_viterbi.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.base_loglik_local.restype = ctypes.c_int
        lib.base_loglik_local.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_float, ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
    return _LIB


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def banded_viterbi_cpu(
    x: np.ndarray, mu: np.ndarray, sigma: np.ndarray, lo: np.ndarray,
    band_width: int, log_p_stay: float, log_p_move: float,
    log_p_skip: float = -1e30, use_skip: bool = False,
) -> Tuple[float, np.ndarray]:
    """Single-read banded Viterbi on the native CPU core: x (T,), levels
    mu / sigma (N,), per-sample band starts lo (T,). Returns (score, path
    (T,) int64)."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    mu = np.ascontiguousarray(mu, np.float32)
    sigma = np.ascontiguousarray(sigma, np.float32)
    lo = np.ascontiguousarray(lo, np.int32)
    T, N = len(x), len(mu)
    if len(lo) != T or len(sigma) != N:
        raise ValueError(f"lo {len(lo)} / sigma {len(sigma)} against T {T} / N {N}")
    score = ctypes.c_float()
    path = np.empty(T, np.int32)
    rc = lib.banded_viterbi(
        _fptr(x), T, _fptr(mu), _fptr(sigma), N, _iptr(lo), band_width,
        log_p_stay, log_p_move, log_p_skip, int(use_skip),
        ctypes.byref(score), _iptr(path),
    )
    if rc != 0:
        raise RuntimeError(f"banded_viterbi failed rc={rc}")
    return float(score.value), path.astype(np.int64)


def base_loglik_local_cpu(
    x: np.ndarray, codes: np.ndarray, path: np.ndarray,
    level_mean: np.ndarray, level_std: np.ndarray, k: int,
    log_p_stay: float, log_p_move: float, max_window: int = 192,
) -> np.ndarray:
    """Single-read local re-DP rescoring on the native CPU core: (L, 4)
    float32, the reference base at 0."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    codes = np.ascontiguousarray(codes, np.int32)
    path = np.ascontiguousarray(path, np.int32)
    lm = np.ascontiguousarray(level_mean, np.float32)
    ls = np.ascontiguousarray(level_std, np.float32)
    if len(path) != len(x) or len(lm) != 4 ** k or len(ls) != 4 ** k:
        raise ValueError(f"path {len(path)} against T {len(x)}; tables "
                         f"{len(lm)} / {len(ls)} against 4**{k}")
    L = len(codes)
    out = np.zeros((L, 4), np.float32)
    rc = lib.base_loglik_local(
        _fptr(x), len(x), _iptr(codes), L, _iptr(path), _fptr(lm), _fptr(ls),
        k, log_p_stay, log_p_move, max_window, _fptr(out),
    )
    if rc != 0:
        raise RuntimeError(f"base_loglik_local failed rc={rc}")
    return out
