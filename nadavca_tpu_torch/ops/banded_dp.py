"""Batched banded Viterbi in plain PyTorch — twin of the JAX ``scan`` backend.

Counterpart of ``nadavca_tpu/ops/banded_dp.py``: a Python loop over the
signal axis t on (R, B) tensors, renormalised every step, vectorised over
reads and band slots. It is the portable reference of the port (any device)
and is written operation for operation like the JAX function so that both
take the same decisions: without skip the polynomial emission with the stay
transition folded in and the compare on the transition difference; with
``cfg.use_skip`` the Gaussian log-density emission and the first maximum over
the stacked stay / move / skip candidates. ``pin_start`` / ``pin_end``
constrain the path to begin at position 0 / end at position ``n_ref - 1``
(the joint refiner pins both).

Shapes (R reads, T padded signal length, B band width, N padded window length
in k-mer positions):
  x        (R, T)  float32   normalized signal, zero-padded
  t_len    (R,)    int32     true signal lengths
  mu,sigma (R, N)  float32   expected levels, padded
  n_ref    (R,)    int32     true window lengths (k-mer positions)
  lo       (R, T)  int32     band start per sample; nondecreasing; padded by
                             repeating the final value
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import AlignConfig

NEG_INF = -1e30
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

DEC_STAY = 0
DEC_MOVE = 1
DEC_SKIP = 2
DEC_START = 3


class ViterbiResult(NamedTuple):
    score: torch.Tensor                 # (R,) float32 best final log-likelihood
    path: Optional[torch.Tensor]        # (R, T) int32 reference k-mer position per sample
    final_j: torch.Tensor               # (R,) int32 argmax band slot at the end
    counts: Optional[torch.Tensor] = None   # (R, n_lanes) int32 segment counts, on request


def _band_gather(arr, idx, fill):
    """arr (R, N) gathered at idx (R, B); out-of-range -> fill."""
    n = arr.shape[1]
    ok = (idx >= 0) & (idx < n)
    safe = idx.clamp(0, n - 1)
    got = torch.gather(arr, 1, safe)
    return torch.where(ok, got, torch.full_like(got, fill))


def banded_viterbi_batch(
    x: torch.Tensor,
    t_len: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    n_ref: torch.Tensor,
    lo: torch.Tensor,
    cfg: AlignConfig = AlignConfig(),
    pin_start: bool = False,
    pin_end: bool = False,
) -> ViterbiResult:
    """Fill + backtrack of the banded Viterbi over a padded batch."""
    R, T = x.shape
    B = cfg.band_width
    dev = x.device
    lo = lo.to(torch.int64)
    t_len = t_len.to(torch.int64)
    n_ref = n_ref.to(torch.int64)
    j_idx = torch.arange(B, dtype=torch.int64, device=dev)[None, :]

    def emit_at(t):
        i = lo[:, t][:, None] + j_idx                     # (R, B) absolute positions
        m = _band_gather(mu, i, 0.0)
        s = _band_gather(sigma, i, 1.0)
        valid = i < n_ref[:, None]
        xc = x[:, t][:, None]
        if cfg.use_skip:
            z = (xc - m) / s
            e = -0.5 * z * z - torch.log(s) - _HALF_LOG_2PI
            return torch.where(valid, e, neg)
        # the fill kernel's polynomial emission, stay transition folded in;
        # returns e + log_p_stay, the t = 0 free start subtracts it back
        inv2v = 0.5 / (s * s)
        em_const = torch.where(valid, -torch.log(s) - _HALF_LOG_2PI,
                               torch.full_like(s, NEG_INF))
        c2p = -inv2v
        c1p = (m + m) * inv2v
        c0p = em_const - m * m * inv2v + cfg.log_p_stay
        return (c2p * xc + c1p) * xc + c0p

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)

    # t = 0: free start anywhere in the band (or pinned to position 0)
    V = emit_at(0) if cfg.use_skip else emit_at(0) - cfg.log_p_stay
    if pin_start:
        V = torch.where(lo[:, 0][:, None] + j_idx == 0, V, neg)
    m0 = V.max(dim=1).values
    m0 = torch.where(m0 > NEG_INF / 2, m0, zero)
    V = V - m0[:, None]
    acc = m0

    dcs = cfg.log_p_move - cfg.log_p_stay
    trans = (cfg.log_p_stay, cfg.log_p_move, cfg.log_p_skip)
    decs = torch.zeros((max(T - 1, 0), R, B), dtype=torch.int8, device=dev)
    # steps at or beyond the longest read are identity for every row
    t_stop = min(T, int(t_len.max())) if R else 0

    for t in range(1, t_stop):
        d = (lo[:, t] - lo[:, t - 1])[:, None]            # (R, 1)
        if cfg.use_skip:
            cands = torch.stack(
                [_band_gather(V, j_idx + d - adv, NEG_INF) + trans[adv]
                 for adv in range(3)], dim=0)                 # (3, R, B)
            # ties go to the smaller advance: stay beats move beats skip
            best_val = cands.max(dim=0).values
            best = ((cands[0] < best_val).to(torch.int8)
                    + ((cands[0] < best_val) & (cands[1] < best_val)).to(torch.int8))
        else:
            v0 = _band_gather(V, j_idx + d, NEG_INF)
            mv = _band_gather(V, j_idx + d - 1, NEG_INF) + dcs
            best = mv > v0
            best_val = torch.maximum(v0, mv)
        has_pred = best_val > NEG_INF / 2
        V_new = torch.where(has_pred, emit_at(t) + best_val, neg)
        dec = torch.where(has_pred, best.to(torch.int8),
                          torch.full_like(best, DEC_START, dtype=torch.int8))

        m = torch.maximum(V_new.max(dim=1).values, neg)
        m = torch.where(m > NEG_INF / 2, m, zero)
        V_new = V_new - m[:, None]
        acc_new = acc + m

        active = (t < t_len)[:, None]
        V = torch.where(active, V_new, V)
        acc = torch.where(active[:, 0], acc_new, acc)
        decs[t - 1] = torch.where(active, dec, torch.zeros_like(dec))

    i_fin = lo[:, T - 1][:, None] + j_idx
    V_valid = torch.where(i_fin < n_ref[:, None], V, neg)
    if pin_end:
        V_valid = torch.where(i_fin == (n_ref - 1)[:, None], V_valid, neg)
    j_end = torch.argmax(V_valid, dim=1)
    score = acc + torch.gather(V_valid, 1, j_end[:, None])[:, 0]

    # ------------------------------------------------------------- backtrack
    path = torch.empty((R, T), dtype=torch.int64, device=dev)
    j = j_end
    path[:, T - 1] = lo[:, T - 1] + j
    for t in range(T - 1, 0, -1):
        if t >= t_stop:
            # identity step: bit 0, and the band is frozen beyond a read's end
            adv = torch.zeros_like(j)
        else:
            adv = torch.gather(decs[t - 1], 1, j.clamp(0, B - 1)[:, None])[:, 0]
            adv = adv.to(torch.int64)
            adv = torch.where(adv == DEC_START, torch.zeros_like(adv), adv)
        j = j + (lo[:, t] - lo[:, t - 1]) - adv
        path[:, t - 1] = lo[:, t - 1] + j
    return ViterbiResult(score=score, path=path.to(torch.int32),
                         final_j=j_end.to(torch.int32))


def segment_stats_batch(
    path: torch.Tensor, x: torch.Tensor, t_len: torch.Tensor, n_ref_max: int
) -> torch.Tensor:
    """Per-position sufficient statistics (n, Σx, Σx²) — (R, N, 3) float32.

    Samples beyond each read's true length contribute nothing, and neither do
    samples whose position is >= ``n_ref_max``.

    ``path`` must be nondecreasing over each read's live samples, which every
    Viterbi backend guarantees. That makes each position's samples one
    contiguous run, so the sums are differences of float64 prefix sums taken
    at bounds found by bisection. The result does not depend on the order in
    which a scatter's atomic adds land, as an ``index_add_`` on the card
    would, and it is at least as accurate as the float32 segment sums of the
    JAX function.
    """
    R, T = x.shape
    dev = x.device
    N = int(n_ref_max)
    live = torch.arange(T, device=dev)[None, :] < t_len.to(torch.int64)[:, None]
    path_safe = torch.where(live, path.to(torch.int64),
                            torch.full((), N, dtype=torch.int64, device=dev))
    pos = torch.arange(N + 1, dtype=torch.int64, device=dev)[None, :].expand(R, N + 1)
    cnt = torch.searchsorted(path_safe.contiguous(), pos.contiguous(), right=False)
    xd = x.to(torch.float64)
    zero = torch.zeros((R, 1), dtype=torch.float64, device=dev)
    cs1 = torch.cat([zero, torch.cumsum(xd, dim=1)], dim=1)          # (R, T + 1)
    cs2 = torch.cat([zero, torch.cumsum(xd * xd, dim=1)], dim=1)
    s, e = cnt[:, :-1], cnt[:, 1:]
    n = (e - s).to(torch.float32)
    s1 = (torch.gather(cs1, 1, e) - torch.gather(cs1, 1, s)).to(torch.float32)
    s2 = (torch.gather(cs2, 1, e) - torch.gather(cs2, 1, s)).to(torch.float32)
    return torch.stack([n, s1, s2], dim=-1)


def gaussian_segment_loglik(stats, mu, sigma):
    n, s1, s2 = stats[..., 0], stats[..., 1], stats[..., 2]
    return -n * (torch.log(sigma) + _HALF_LOG_2PI) - (
        s2 - 2.0 * mu * s1 + n * mu * mu
    ) / (2.0 * sigma * sigma)


def base_loglik_batch(
    window_codes: torch.Tensor,   # (R, L) int encoded bases (4 = pad/N)
    ids: torch.Tensor,            # (R, N) int kmer ids (-1 invalid), N = L-k+1
    stats: torch.Tensor,          # (R, N, 3) float32
    level_mean: torch.Tensor,     # (4^k,) float32
    level_std: torch.Tensor,      # (4^k,) float32
    k: int,
) -> torch.Tensor:
    """(R, L, 4) per-position per-base log-likelihoods, ref base = 0.

    Fixed-path rescoring: for base position i and candidate base b, the k
    k-mers overlapping i are re-scored in closed form from the segment
    statistics. This is the documented approximation (``snp_rescore="fixed"``).
    """
    R, L = window_codes.shape
    N = ids.shape[1]
    dev = stats.device
    ids = ids.to(torch.int64)
    ref_base = window_codes.to(torch.int64)
    valid_id = ids >= 0
    safe_ids = torch.where(valid_id, ids, torch.zeros_like(ids))
    cur_ll = gaussian_segment_loglik(stats, level_mean[safe_ids], level_std[safe_ids])
    cur_ll = torch.where(valid_id, cur_ll, torch.zeros_like(cur_ll))

    out = torch.zeros((R, L, 4), dtype=torch.float32, device=dev)
    n_levels = level_mean.shape[0]

    # offset o: base i sits at offset o of the kmer starting at p = i - o
    for o in range(k):
        pow4 = 4 ** (k - 1 - o)
        p = torch.arange(L, device=dev)[None, :] - o          # (1, L)
        p_ok = (p >= 0) & (p < N)
        p_safe_b = p.clamp(0, N - 1).expand(R, L)
        ids_p = torch.gather(safe_ids, 1, p_safe_b)            # (R, L)
        ok = p_ok & torch.gather(valid_id, 1, p_safe_b) & (ref_base < 4)
        stats_p = torch.gather(stats, 1, p_safe_b[..., None].expand(R, L, 3))
        cur_p = torch.gather(cur_ll, 1, p_safe_b)              # (R, L)
        for b in range(4):
            new_id = (ids_p + (b - ref_base) * pow4).clamp(0, n_levels - 1)
            ll = gaussian_segment_loglik(stats_p, level_mean[new_id], level_std[new_id])
            delta = torch.where(ok & (ref_base != b), ll - cur_p,
                                torch.zeros_like(ll))
            out[:, :, b] += delta
    return out


def base_loglik_local_batch(
    x: torch.Tensor,             # (R, T) f32
    path: torch.Tensor,          # (R, T) i32 — global Viterbi path
    t_len: torch.Tensor,         # (R,) i32
    window_codes: torch.Tensor,  # (R, L) i32 (4 = pad/N)
    ids: torch.Tensor,           # (R, N) i32 kmer ids (-1 invalid)
    level_mean: torch.Tensor,    # (4^k,) f32
    level_std: torch.Tensor,     # (4^k,) f32
    k: int,
    cfg: AlignConfig = AlignConfig(),
    t_w: int = 192,
) -> torch.Tensor:
    """(R, L, 4) base log-likelihoods via restricted local re-DP (batched).

    Twin of the JAX ``base_loglik_local_batch``: for every (read, base
    position, candidate base) a tiny Viterbi over the <= k affected k-mer
    positions re-optimizes the local path, over the samples the global path
    assigned to those positions (truncated at t_w samples; the truncation
    drops the same evidence for every base so deltas stay comparable). Plain
    eager tensor code: a Python loop of t_w steps over an (R, L, k, 4) state.
    """
    R, T = x.shape
    L = window_codes.shape[1]
    N = ids.shape[1]
    dev = x.device
    i64 = torch.int64
    path = path.to(i64)
    t_len = t_len.to(i64)
    ids = ids.to(i64)
    ref_base = window_codes.to(i64)

    tmask = torch.arange(T, device=dev)[None, :] < t_len[:, None]
    # padding samples -> overflow segment
    path_safe = torch.where(tmask, path, torch.full((), N, dtype=i64, device=dev))

    # segment bounds from the monotone path by bisection: cnt[i] = #{t :
    # path[t] < i}, so S = cnt[p_lo], E = cnt[p_hi + 1]
    pos_all = torch.arange(N + 1, dtype=i64, device=dev)[None, :].expand(R, N + 1)
    cnt = torch.searchsorted(path_safe.contiguous(), pos_all.contiguous(),
                             right=False)                        # (R, N + 1)

    first_pos = path[:, 0]
    last_t = (t_len - 1).clamp(min=0)
    last_pos = torch.gather(path, 1, last_t[:, None])[:, 0]

    i_idx = torch.arange(L, dtype=i64, device=dev)[None, :]      # (1, L)
    p_lo = (i_idx - k + 1).clamp(0, N - 1)
    p_hi = i_idx.clamp(0, N - 1)
    p_lo = torch.maximum(p_lo, first_pos[:, None])               # (R, L)
    p_hi = torch.minimum(p_hi, last_pos[:, None])
    kk = p_hi - p_lo + 1                                         # positions in window
    valid_i = (kk > 0) & (ref_base < 4)

    S = torch.gather(cnt, 1, p_lo.clamp(0, N))                   # (R, L)
    E = torch.gather(cnt, 1, (p_hi + 1).clamp(0, N))
    W = (E - S).clamp(0, t_w)

    # gather sample windows: xs[r, i, s] = x[r, S[r, i] + s]
    samp = S[:, :, None] + torch.arange(t_w, dtype=i64, device=dev)[None, None, :]
    xs = torch.gather(x, 1, samp.clamp(0, T - 1).reshape(R, L * t_w)).reshape(R, L, t_w)

    # substituted levels: for j in 0..k-1 at position p = p_lo + j
    j_idx = torch.arange(k, dtype=i64, device=dev)[None, None, :]  # (1, 1, k)
    p = p_lo[:, :, None] + j_idx                                 # (R, L, k)
    j_ok = j_idx < kk[:, :, None]
    ids_p = torch.gather(ids, 1, p.clamp(0, N - 1).reshape(R, L * k)).reshape(R, L, k)
    ids_ok = ids_p >= 0
    off = i_idx[:, :, None] - p                                  # (R, L, k)
    inside = (off >= 0) & (off < k)
    pow4 = torch.tensor([4 ** (k - 1 - o) for o in range(k)], dtype=i64, device=dev)
    w4 = torch.where(inside, pow4[off.clamp(0, k - 1)], torch.zeros_like(off))
    b_idx = torch.arange(4, dtype=i64, device=dev)[None, None, None, :]
    nid = ids_p[..., None] + (b_idx - ref_base[:, :, None, None]) * w4[..., None]
    nid = nid.clamp(0, level_mean.shape[0] - 1)                  # (R, L, k, 4)
    mu_s = level_mean[nid]
    sg_s = level_std[nid]
    em_const = -torch.log(sg_s) - _HALF_LOG_2PI                  # (R, L, k, 4)
    inv2v = 0.5 / (sg_s * sg_s)
    pos_dead = ~(j_ok & ids_ok)                                  # (R, L, k)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    em_const = torch.where(pos_dead[..., None], neg, em_const)

    # restricted Viterbi: state (R, L, k, 4), loop over local samples
    neg_row = torch.full((R, L, 1, 4), NEG_INF, dtype=torch.float32, device=dev)
    first_slot = (j_idx == 0)[..., None]                         # (1, 1, k, 1)
    v = torch.full((R, L, k, 4), NEG_INF, dtype=torch.float32, device=dev)
    # steps at or beyond the longest window are identity for every position
    for s in range(min(t_w, int(W.max())) if W.numel() else 0):
        d = xs[:, :, s][:, :, None, None] - mu_s
        emit = em_const - d * d * inv2v
        if s == 0:
            v_new = torch.where(first_slot, emit, neg)
        else:
            stay = v + cfg.log_p_stay
            move = torch.cat([neg_row, v[:, :, :-1, :]], dim=2) + cfg.log_p_move
            v_new = emit + torch.maximum(stay, move)
        act = (s < W)[:, :, None, None]
        v = torch.where(act, v_new, v)

    score = torch.gather(
        v, 2, (kk - 1).clamp(0, k - 1)[:, :, None, None].expand(R, L, 1, 4))[:, :, 0, :]
    ref_score = torch.gather(score, 2, ref_base.clamp(0, 3)[:, :, None])
    out = score - ref_score
    all_ok = (valid_i & (W > 0)
              & torch.where(j_ok, ids_ok, torch.ones_like(ids_ok)).all(dim=2))
    return torch.where(all_ok[:, :, None], out, torch.zeros_like(out))
