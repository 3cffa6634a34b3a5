"""Chunked band construction — the shared banding contract of all DP paths.

Design decision kept from the JAX package (SURVEY.md §7.3 item 2): instead
of a band that slides by 0/1 reference positions every signal sample (the
reference C++ loop's shape), the band is *piecewise constant over signal
chunks* of C samples and jumps by Δ ≥ 0 at chunk boundaries. Within a chunk
the band does not move, so the fill kernel's inner loop has no gathers and no
per-step dynamic slices; the expected-level band slices (mu/sigma) are
gathered per (read, chunk) by the fill kernels' producer warps (plain
version: ops/cuda_dp.band_gather_plain) and read as dense rows.

The scan backend consumes the *expanded* per-sample
``lo[t] = lo_chunk[t // C]`` form, so all three implementations share one
band and are cell-for-cell comparable.

Band width B must absorb within-chunk drift: at ~10 samples/position a C=128
chunk drifts ~13 positions, far inside B=128.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.upload import host_copy


@dataclasses.dataclass
class ChunkedBands:
    """Banding of a padded batch. R reads, n_chunks chunks of C samples."""

    lo: np.ndarray        # (R, n_chunks) int32 band start per chunk, nondecreasing
    delta: np.ndarray     # (R, n_chunks) int32 lo[c] - lo[c-1] (delta[:,0] == 0)
    chunk_size: int
    band_width: int

    @property
    def n_chunks(self) -> int:
        return self.lo.shape[1]

    def expand(self, T: int) -> np.ndarray:
        """Per-sample lo (R, T) for the spec / lax.scan paths."""
        reps = np.repeat(self.lo, self.chunk_size, axis=1)
        return reps[:, :T].astype(np.int32)


def build_chunked_bands(
    anchors: np.ndarray,
    t_len: np.ndarray,
    n_ref: np.ndarray,
    band_width: int,
    chunk_size: int,
) -> ChunkedBands:
    """Build piecewise-constant bands from per-sample anchor estimates.

    Args:
      anchors: (R, T) float — approximate reference k-mer position per signal
        sample (padding may hold anything; it is frozen to the last valid
        chunk's value so padded chunks are identity steps).
      t_len: (R,) true signal lengths.
      n_ref: (R,) true reference window lengths (k-mer positions).
      band_width: B (multiple of 128).
      chunk_size: C samples per chunk.

    Returns ChunkedBands with lo clipped to [0, max(n_ref - B, 0)],
    nondecreasing, frozen after each read's last chunk, and per-chunk jumps
    capped at ``band_width`` (a larger jump would disconnect the band; the
    cap keeps the DP well-defined and such reads simply score badly).
    ``lo`` and ``delta`` are page-locked where CUDA is present (``utils.upload``).
    """
    R, T = anchors.shape
    B, C = band_width, chunk_size
    n_chunks = -(-T // C)
    # anchor at each chunk start (sample index c*C, clamped to valid range)
    starts = np.minimum(
        np.arange(n_chunks) * C, np.maximum(t_len - 1, 0)[:, None]
    )  # (R, n_chunks)
    a = np.take_along_axis(anchors, starts, axis=1)
    lo = np.round(a).astype(np.int64) - B // 2
    lo = np.clip(lo, 0, np.maximum(n_ref - B, 0)[:, None])
    lo = np.maximum.accumulate(lo, axis=1)
    # freeze after read end
    last_chunk = np.maximum((t_len - 1) // C, 0)
    li = np.minimum(np.arange(n_chunks)[None, :], last_chunk[:, None])
    lo = np.take_along_axis(lo, li, axis=1)
    # cap per-chunk jumps at B (monotone re-accumulate after capping)
    delta = np.diff(lo, axis=1, prepend=lo[:, :1])
    delta = np.clip(delta, 0, B)
    lo = lo[:, :1] + np.cumsum(delta, axis=1) - delta[:, :1]
    delta = np.diff(lo, axis=1, prepend=lo[:, :1])
    return ChunkedBands(
        lo=host_copy(lo, np.int32),
        delta=host_copy(delta, np.int32),
        chunk_size=C,
        band_width=B,
    )


def gather_band_levels(
    mu: np.ndarray, sigma: np.ndarray, bands: ChunkedBands
) -> tuple[np.ndarray, np.ndarray]:
    """Pregather per-(read, chunk) band slices of the expected levels.

    mu/sigma: (R, N) padded level arrays. Returns (R, n_chunks, B) float32
    pairs; out-of-range slots get mu=0, sigma=1 (the kernel masks them via
    n_ref, see ops/cuda_dp.py). This is the numpy oracle of the band-gather
    kernel, which returns the same values chunk-major.
    """
    R, N = mu.shape
    B = bands.band_width
    idx = bands.lo[:, :, None].astype(np.int64) + np.arange(B)[None, None, :]
    ok = idx < N
    idx = np.minimum(idx, N - 1)
    ridx = np.arange(R)[:, None, None]
    mu_b = np.where(ok, mu[ridx, idx], 0.0).astype(np.float32)
    sg_b = np.where(ok, sigma[ridx, idx], 1.0).astype(np.float32)
    return mu_b, sg_b
