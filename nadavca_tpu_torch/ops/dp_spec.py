"""Executable numpy (float64) spec of the banded signal-alignment DP.

Counterpart of ``nadavca_tpu/ops/dp_spec.py``, copied function for function
(same names, same arithmetic), so that the port's tests reach an oracle
without importing the JAX package and a comparison of the two copies is
exact; ``make_band_batch``, the batched band of the JAX package's
``ops/banded_dp.py``, lives here beside ``make_band`` because it is numpy
too. It implements, slowly and exactly:

  * band construction from an anchor path,
  * banded Viterbi over (signal sample t × reference k-mer position i) with
    Gaussian emissions from the pore model and stay/move(/skip) transitions,
  * backtrack to a per-position segmentation of the signal,
  * per-position sufficient statistics of the aligned samples,
  * closed-form base-substitution log-likelihoods for SNP calling, and the
    restricted local re-DP of the default ``snp_rescore="local"``.

Everything here is float64 numpy and deliberately unoptimized: an oracle
gains nothing from tensors. The port's ``scan`` twin (``ops/banded_dp.py``)
and its kernels' plain versions (``ops/cuda_dp.py``) are tested against it,
and so is the single-core C++ core (``ops/cpu_ref.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import AlignConfig

NEG_INF = -1e30
_HALF_LOG_2PI = 0.5 * np.log(2.0 * np.pi)

# decision codes stored during the DP fill (values matter: they are the
# number of reference positions advanced when entering this cell)
DEC_START = 3  # no predecessor (t == 0 or fresh band entry)
DEC_STAY = 0
DEC_MOVE = 1
DEC_SKIP = 2


def gaussian_logpdf(x, mu, sigma):
    """log N(x; mu, sigma), elementwise."""
    z = (x - mu) / sigma
    return -0.5 * z * z - np.log(sigma) - _HALF_LOG_2PI


def make_band(anchor: np.ndarray, n_ref: int, band_width: int) -> np.ndarray:
    """Band start positions lo[t] from an anchor path.

    ``anchor[t]`` is the approximate reference k-mer position of signal sample
    t (float). The band at sample t covers positions [lo[t], lo[t]+B). lo is
    clipped to [0, n_ref - B] and made nondecreasing so the DP can always move
    forward. If n_ref <= B the band is the whole reference (lo == 0).
    """
    B = band_width
    if n_ref <= B:
        return np.zeros(len(anchor), dtype=np.int64)
    lo = np.round(anchor).astype(np.int64) - B // 2
    lo = np.clip(lo, 0, n_ref - B)
    lo = np.maximum.accumulate(lo)
    return lo


def make_band_batch(
    anchors: np.ndarray, t_len: np.ndarray, n_ref: np.ndarray, band_width: int
) -> np.ndarray:
    """Vectorized numpy band construction for a padded batch: the
    per-sample band of the ``scan`` twin.

    anchors (R, T) float: approximate k-mer position per sample (padding
    repeated). Matches :func:`make_band` per row; padding rows repeat the last
    valid lo so padded scan steps are identity.
    """
    R, T = anchors.shape
    B = band_width
    lo = np.round(anchors).astype(np.int64) - B // 2
    hi_clip = np.maximum(n_ref - B, 0)[:, None]
    lo = np.clip(lo, 0, hi_clip)
    lo = np.maximum.accumulate(lo, axis=1)
    # freeze lo beyond each read's end at its final valid value
    idx = np.minimum(np.arange(T)[None, :], np.maximum(t_len - 1, 0)[:, None])
    lo = np.take_along_axis(lo, idx, axis=1)
    return lo.astype(np.int32)


def banded_viterbi(
    x: np.ndarray,
    mu: np.ndarray,
    sigma: np.ndarray,
    lo: np.ndarray,
    cfg: AlignConfig = AlignConfig(),
) -> Tuple[float, np.ndarray]:
    """Banded Viterbi alignment of signal to expected levels.

    Args:
      x: (T,) normalized signal samples.
      mu, sigma: (N,) expected level mean/std per reference k-mer position.
      lo: (T,) nondecreasing band start positions (see :func:`make_band`).
      cfg: transition parameters.

    Returns:
      (score, path) where score is the best final log-likelihood (max over the
      final band) and path is (T,) int64 of reference k-mer positions, one per
      sample, nondecreasing. Alignment is semi-global: it may start anywhere in
      the first band and end anywhere in the last band.
    """
    T, N = len(x), len(mu)
    B = min(cfg.band_width, N)
    assert len(lo) == T
    V = np.full((T, B), NEG_INF)
    dec = np.full((T, B), DEC_START, dtype=np.int8)

    def emit(t):
        i = lo[t] + np.arange(B)
        valid = i < N
        e = np.where(
            valid,
            gaussian_logpdf(x[t], mu[np.minimum(i, N - 1)], sigma[np.minimum(i, N - 1)]),
            NEG_INF,
        )
        return e

    V[0] = emit(0)
    for t in range(1, T):
        d = int(lo[t] - lo[t - 1])
        prev = V[t - 1]

        def shifted(offset):
            # source band slot j_prev = j + d - adv  (adv = positions advanced)
            jp = np.arange(B) + d - offset
            ok = (jp >= 0) & (jp < B)
            out = np.where(ok, prev[np.clip(jp, 0, B - 1)], NEG_INF)
            return out

        cand_stay = shifted(0) + cfg.log_p_stay
        cand_move = shifted(1) + cfg.log_p_move
        cands = [cand_stay, cand_move]
        if cfg.use_skip:
            cands.append(shifted(2) + cfg.log_p_skip)
        stacked = np.stack(cands)  # (n_trans, B)
        best = np.argmax(stacked, axis=0)
        best_val = np.take_along_axis(stacked, best[None], axis=0)[0]
        # a "move" into band slot 0 from below the band, or any cell with no
        # valid predecessor, stays NEG_INF (no fresh restarts after t=0)
        V[t] = np.where(best_val > NEG_INF / 2, emit(t) + best_val, NEG_INF)
        dec[t] = np.where(best_val > NEG_INF / 2, best.astype(np.int8), DEC_START)

    # backtrack
    j = int(np.argmax(V[T - 1]))
    score = float(V[T - 1, j])
    path = np.zeros(T, dtype=np.int64)
    path[T - 1] = lo[T - 1] + j
    for t in range(T - 1, 0, -1):
        adv = int(dec[t, j])
        if adv == DEC_START:
            adv = 0  # degenerate; should not happen on the optimal path
        d = int(lo[t] - lo[t - 1])
        j = j + d - adv
        path[t - 1] = lo[t - 1] + j
    return score, path


def path_segments(path: np.ndarray, n_ref: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-reference-position signal sample ranges from a Viterbi path.

    Returns (seg_start, seg_end), each (N,) int64: position i was aligned to
    samples [seg_start[i], seg_end[i]); positions never visited have
    seg_start == seg_end == -1. This is the reference's ``align`` output shape
    (per-position signal ranges — SURVEY.md "Output writers" row).
    """
    seg_start = np.full(n_ref, -1, dtype=np.int64)
    seg_end = np.full(n_ref, -1, dtype=np.int64)
    for t, i in enumerate(path):
        if seg_start[i] < 0:
            seg_start[i] = t
        seg_end[i] = t + 1
    return seg_start, seg_end


def segment_stats(path: np.ndarray, x: np.ndarray, n_ref: int) -> np.ndarray:
    """Sufficient statistics (n, Σx, Σx²) of samples aligned to each position.

    Returns (N, 3) float64. These three numbers per position are all that base
    re-scoring needs: Σ_t log N(x_t; μ, σ) over a segment is a closed form in
    (n, S1, S2) — see :func:`gaussian_segment_loglik`.
    """
    stats = np.zeros((n_ref, 3))
    np.add.at(stats[:, 0], path, 1.0)
    np.add.at(stats[:, 1], path, x)
    np.add.at(stats[:, 2], path, x * x)
    return stats


def gaussian_segment_loglik(stats: np.ndarray, mu, sigma):
    """Σ log N(x_t; mu, sigma) over a segment with stats (n, S1, S2).

    Broadcasts: stats (..., 3) against mu/sigma of matching shape.
    """
    n, s1, s2 = stats[..., 0], stats[..., 1], stats[..., 2]
    return -n * (np.log(sigma) + _HALF_LOG_2PI) - (s2 - 2.0 * mu * s1 + n * mu * mu) / (
        2.0 * sigma * sigma
    )


def base_substitution_loglik(
    window_codes: np.ndarray,
    stats: np.ndarray,
    level_mean: np.ndarray,
    level_std: np.ndarray,
    k: int,
) -> np.ndarray:
    """Per-position per-base log-likelihoods under fixed-path re-scoring.

    For each base position i of the window and each candidate base b, the k
    k-mers overlapping i change; with the Viterbi segmentation held fixed, the
    log-likelihood delta is the closed-form Gaussian segment re-score of the
    affected positions (SURVEY.md §3.2 second hot loop; §7.3 item 5 says to
    reuse the fixed band segmentation — this is that design).

    Args:
      window_codes: (L,) int8 encoded window bases.
      stats: (N, 3) per-kmer-position stats, N = L - k + 1.
      level_mean, level_std: (4^k,) model tables.
      k: k-mer length.

    Returns:
      (L, 4) float64 log-likelihood of each base, normalized so the reference
      base has log-likelihood 0 at every position.
    """
    L = len(window_codes)
    N = L - k + 1
    assert stats.shape[0] == N
    out = np.zeros((L, 4))

    # current kmer ids and their segment log-liks
    from ..genome import kmer_ids

    ids = kmer_ids(window_codes, k)
    valid = ids >= 0
    safe = np.where(valid, ids, 0)
    cur_ll = gaussian_segment_loglik(stats, level_mean[safe], level_std[safe])
    cur_ll = np.where(valid, cur_ll, 0.0)

    pow4 = 4 ** np.arange(k - 1, -1, -1)  # digit weight of offset o in the kmer id

    for i in range(L):
        ref_base = int(window_codes[i])
        p_loidx = max(0, i - k + 1)
        p_hiidx = min(N - 1, i)
        if p_hiidx < p_loidx or ref_base > 3:
            continue
        ps = np.arange(p_loidx, p_hiidx + 1)
        offs = i - ps  # offset of base i within the kmer starting at p
        for b in range(4):
            if b == ref_base:
                continue
            delta = 0.0
            for p, o in zip(ps, offs):
                if ids[p] < 0:
                    continue
                new_id = ids[p] + (b - ref_base) * pow4[o]
                delta += (
                    gaussian_segment_loglik(
                        stats[p], level_mean[new_id], level_std[new_id]
                    )
                    - cur_ll[p]
                )
            out[i, b] = delta
    return out


# ----------------------------------------------------------------- reference
def full_read_spec(
    x: np.ndarray,
    window_codes: np.ndarray,
    model,
    anchor: np.ndarray,
    cfg: AlignConfig = AlignConfig(),
):
    """End-to-end per-read spec: levels → band → Viterbi → segments → base LLs.

    Returns a dict with score, path, seg_start/seg_end (per kmer position),
    and (L, 4) base log-likelihoods.
    """
    mu, sigma = model.expected_signal(window_codes)
    mu = mu.astype(np.float64)
    sigma = sigma.astype(np.float64)
    lo = make_band(anchor, len(mu), cfg.band_width)
    score, path = banded_viterbi(x, mu, sigma, lo, cfg)
    seg_start, seg_end = path_segments(path, len(mu))
    stats = segment_stats(path, x, len(mu))
    base_ll = base_substitution_loglik(
        window_codes, stats, model.level_mean.astype(np.float64),
        model.level_std.astype(np.float64), model.k,
    )
    return {
        "score": score,
        "path": path,
        "seg_start": seg_start,
        "seg_end": seg_end,
        "stats": stats,
        "base_loglik": base_ll,
    }


def base_substitution_loglik_local(
    window_codes: np.ndarray,
    path: np.ndarray,
    x: np.ndarray,
    level_mean: np.ndarray,
    level_std: np.ndarray,
    k: int,
    cfg: AlignConfig = AlignConfig(),
    max_window: int = 1 << 30,
) -> np.ndarray:
    """Per-position per-base log-likelihoods via restricted local re-DP.

    For each base position i and candidate base b, re-run the banded DP over
    ONLY the k k-mer positions overlapping i, using the signal samples the
    global Viterbi path assigned to those positions, with entry fixed at the
    first position and exit fixed at the last (the global path's boundary
    crossings). This is the reference's second hot loop (SURVEY.md §3.2/§3.4
    "SNP re-score: recompute restricted DP over that window"): unlike
    fixed-path re-scoring (:func:`base_substitution_loglik`), the local path
    re-optimizes per substitution, which removes the reference-bias of a path
    that was chosen to fit the reference allele.

    Skip-path semantics: the window clamps to the global path's span
    [path[0], path[-1]]; within the span, S/E are the first/last samples the
    global path assigned to positions in [p_lo, p_hi] (a bisection on the
    monotone path, so positions the path skipped contribute no samples but
    still participate in the restricted DP's level sequence). For a no-skip
    path every in-span position is visited, so this is exactly "the samples
    of the overlapped segments".

    Returns (L, 4) float64, reference base normalized to 0.
    """
    from ..genome import kmer_ids

    L = len(window_codes)
    N = L - k + 1
    first_pos, last_pos = int(path[0]), int(path[-1])
    ids = kmer_ids(window_codes, k)
    pow4 = 4 ** np.arange(k - 1, -1, -1)
    out = np.zeros((L, 4))

    for i in range(L):
        ref_base = int(window_codes[i])
        if ref_base > 3:
            continue
        p_lo = max(max(0, i - k + 1), first_pos)
        p_hi = min(min(N - 1, i), last_pos)
        if p_hi < p_lo:
            continue
        # samples the global path assigned to positions in [p_lo, p_hi]
        S = int(np.searchsorted(path, p_lo, side="left"))
        E = int(np.searchsorted(path, p_hi, side="right"))
        if E <= S:
            continue
        if E - S > max_window:
            E = S + max_window
        xs = x[S:E]
        kk = p_hi - p_lo + 1
        ps = np.arange(p_lo, p_hi + 1)
        if (ids[ps] < 0).any():
            continue
        offs = i - ps  # offset of base i inside the kmer at p (may be <0/>k-1 at edges)
        scores = np.full(4, np.nan)
        for b in range(4):
            dmu = np.empty(kk)
            dsg = np.empty(kk)
            for j, (p, o) in enumerate(zip(ps, offs)):
                if 0 <= o < k:
                    nid = ids[p] + (b - ref_base) * pow4[o]
                else:  # kmer does not contain base i (edge padding) — unchanged
                    nid = ids[p]
                dmu[j] = level_mean[nid]
                dsg[j] = level_std[nid]
            # restricted Viterbi over positions 0..kk-1, samples xs
            V = np.full(kk, NEG_INF)
            V[0] = gaussian_logpdf(xs[0], dmu[0], dsg[0])
            for t in range(1, len(xs)):
                stay = V + cfg.log_p_stay
                move = np.concatenate([[NEG_INF], V[:-1] + cfg.log_p_move])
                V = gaussian_logpdf(xs[t], dmu, dsg) + np.maximum(stay, move)
            scores[b] = V[kk - 1]
        out[i] = scores - scores[ref_base]
    return out
