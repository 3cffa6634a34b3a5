"""ctypes binding to the native host-prep engine (csrc/prep.cpp).

Per-read preprocessing (normalize → seed-and-vote anchor → move-table
composition → expected levels → calibration fit) in C++, with the GIL
released for the call, so prep scales over threads. Same algorithms and
numeric conventions as ``pipeline.preprocess_read``.

Copy of ``nadavca_tpu/prep_native.py``; ``csrc/prep.cpp`` is the JAX
package's source byte for byte, so both packages give the same records bit
for bit (``tests/test_torch_prep_native.py``). Built with g++ at first use
by ``utils/native_build.py``; ``pipeline.make_preprocessor`` falls back to
the Python path under ``"auto"`` when no toolchain is present.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import pipeline
from .anchor import Anchor, SeedIndex
from .config import AlignConfig
from .genome import Genome, encode_bases
from .io.fast5 import normalize_signal
from .kmer_model import KmerModel
from .utils.native_build import build_shared

_LIB: Optional[ctypes.CDLL] = None

_NORM_METHODS = {"mad": 0, "meanstd": 1}


def get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_shared("prep"))
        lib.prep_index_build.restype = ctypes.c_void_p
        lib.prep_index_build.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.prep_index_free.restype = None
        lib.prep_index_free.argtypes = [ctypes.c_void_p]
        lib.prep_read.restype = ctypes.c_int
        lib.prep_read.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
    return _LIB


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


class NativePrep:
    """Native seed index + per-read preprocessing for one genome.

    ``prep_read`` is the drop-in equivalent of
    ``fast5.normalize_signal`` + ``pipeline.preprocess_read``; it returns a
    :class:`~nadavca_tpu_torch.pipeline.ReadRecord` (with cached expected levels)
    or None when the read cannot be anchored.
    """

    def __init__(self, genome: Genome, seed_k: int = 13):
        self.genome = genome
        self.seed_k = seed_k
        self.contig_names = [c.name for c in genome]
        starts = [0]
        chunks = []
        for c in genome:
            chunks.append(np.ascontiguousarray(c.codes, np.int8))
            starts.append(starts[-1] + len(c))
        codes = (np.concatenate(chunks) if chunks else np.empty(0, np.int8))
        starts = np.asarray(starts, np.int64)
        lib = get_lib()
        self._lib = lib
        self._handle = lib.prep_index_build(
            _ptr(codes, ctypes.c_int8), _ptr(starts, ctypes.c_int64),
            len(self.contig_names), seed_k,
        )
        if not self._handle:
            raise RuntimeError("prep_index_build failed")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.prep_index_free(self._handle)
            self._handle = None

    def prep_read(
        self,
        signal_pa: np.ndarray,
        basecall: str,
        move_index: np.ndarray,
        cfg: AlignConfig,
        model: Optional[KmerModel] = None,
        read_id: str = "?",
        seed_stride: int = 3,
        diag_bin: int = 32,
        min_votes: int = 5,
        margin: int = 10,
    ):
        sig = np.ascontiguousarray(signal_pa, np.float32)
        bc = np.ascontiguousarray(encode_bases(basecall), np.int8)
        mv = np.ascontiguousarray(move_index, np.int64)
        T, nb = len(sig), len(bc)
        if nb == 0 or T == 0 or len(mv) != nb:
            return None
        cap = nb + 2 * margin + 8 * diag_bin + 256
        out_signal = np.empty(T, np.float32)
        out_path = np.empty(T, np.float64)
        out_meta = np.empty(5, np.int32)
        out_window = np.empty(cap, np.int8)
        out_wlen = np.empty(1, np.int64)
        out_mu = np.empty(cap, np.float32)
        out_sigma = np.empty(cap, np.float32)
        out_nref = np.empty(1, np.int64)
        if model is not None:
            lm = np.ascontiguousarray(model.level_mean, np.float32)
            ls = np.ascontiguousarray(model.level_std, np.float32)
            lm_p, ls_p, mk = (_ptr(lm, ctypes.c_float),
                              _ptr(ls, ctypes.c_float), model.k)
        else:
            lm_p = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
            ls_p = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
            mk = 0
        rc = self._lib.prep_read(
            self._handle, _ptr(sig, ctypes.c_float), T,
            _NORM_METHODS[cfg.normalization],
            _ptr(bc, ctypes.c_int8), nb, _ptr(mv, ctypes.c_int64),
            lm_p, ls_p, mk, seed_stride, diag_bin, min_votes, margin, cap,
            _ptr(out_signal, ctypes.c_float), _ptr(out_path, ctypes.c_double),
            _ptr(out_meta, ctypes.c_int32), _ptr(out_window, ctypes.c_int8),
            _ptr(out_wlen, ctypes.c_int64),
            _ptr(out_mu, ctypes.c_float), _ptr(out_sigma, ctypes.c_float),
            _ptr(out_nref, ctypes.c_int64),
        )
        if rc == 1:
            return None
        if rc == 2:
            # pathological window (repeat-heavy vote spread): fall back
            index = getattr(self, "_py_index", None)
            if index is None:
                index = self._py_index = SeedIndex(self.genome, self.seed_k)
            sn = normalize_signal(sig, cfg.normalization)
            return pipeline.preprocess_read(
                sn, basecall, mv, index, self.genome, read_id, model=model)
        if rc != 0:
            raise RuntimeError(f"prep_read failed rc={rc}")
        ci, strand, start, end, votes = (int(v) for v in out_meta)
        wlen = int(out_wlen[0])
        n_ref = int(out_nref[0])
        anchor = Anchor(
            contig=self.contig_names[ci], strand=strand,
            ref_start=start, ref_end=end,
            base_to_window=out_path[0] + np.arange(nb, dtype=np.float64),
            score=votes,
        )
        return pipeline.ReadRecord(
            read_id=read_id,
            signal=out_signal,
            anchor=anchor,
            anchor_path=out_path,
            window_codes=out_window[:wlen].copy(),
            mu=out_mu[:n_ref].copy() if model is not None else None,
            sigma=out_sigma[:n_ref].copy() if model is not None else None,
        )
