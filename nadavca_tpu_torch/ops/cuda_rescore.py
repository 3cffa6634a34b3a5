"""The kernels of the local re-DP rescore: wrappers and plain versions.

Counterpart of ``nadavca_tpu/ops/pallas_rescore.py``. Each TPU kernel has a
hand-written CUDA kernel under ``csrc/`` and, beside its wrapper here, a plain
PyTorch version with the same contract:

  ``rescore_local_tab``  csrc/rescore.cu        plain: ``rescore_local_tab_plain``
  ``rescore_local``      csrc/rescore.cu        plain: ``rescore_local_plain``

``rescore_local_tab`` is the TPU's tables rescore (K5) with the shear gather
(K4) and the tensor code around them folded in: from the walk's counts to the
masked (R, L, 4) result in one launch. Its plain version is the composition
it replaces (``local_windows`` → ``span_ok`` → ``shear_gather_plain`` →
``rescore_fill_tab_plain``, the plain version of the TPU's K5 on its own
contract, → masks). ``rescore_local`` is the same for the path without genome
tables: the TPU's K6 with K4 and the no-tables tensor code folded in; its
plain version is ``local_windows`` → ``shear_gather_plain`` →
``batch_constants`` → ``rescore_fill_plain`` (the plain version of K6 on its
own contract) → masks. K4 thus runs inside both kernels (counted in
``shear_gather_folded``); ``shear_gather_plain`` is its plain version.

As in ``ops/cuda_dp``: a wrapper checks its arguments, runs the plain version
on CPU tensors, launches the kernel on CUDA tensors or raises, never falls
back, and counts its launches in ``<wrapper>.launches``.

The TPU's path counts (K3, ``path_counts_pallas``) are emitted by the walk
that makes the path (``ops/cuda_dp.backtrack`` with ``t_len`` and
``n_lanes``, ``csrc/backtrack.cu``); their plain version is
``cuda_dp.path_counts_plain``.

``base_loglik_local_cuda`` picks one of the two: with genome tables
``rescore_local_tab``, without ``rescore_local``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import AlignConfig
from ..utils import kernel_build
from .banded_dp import NEG_INF
from .cuda_dp import _check, _Epilogue, _on, _stream, path_counts_plain
from .subst_tables import SubstTables

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
LT = 128      # positions per tile of the slab rule
SPAN = 2048   # samples a tile's window starts may spread over (slab rule)
MAX_K = 9     # k-mer lengths csrc/rescore.cu is instantiated for (1..9)
MAX_TW = 256  # longest window the fused rescore's staged samples hold


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def count_lanes(n_pos: int) -> int:
    """Lanes of the segment counts over ``n_pos`` window positions: index i
    runs 0..n_pos so that a position's start and end come from one row,
    padded to a multiple of 128 (the TPU's lane tile)."""
    return _round_up(n_pos + 1, 128)


# -------------------------------------------------------------- shear gather
def shear_slab_base(S: torch.Tensor, T: int, span: int, lt: int = LT) -> torch.Tensor:
    """Aligned slab base per (read, position tile): (R, L // lt), same dtype
    as S — shared by the gather and by the caller's span mask."""
    R, L = S.shape
    base = S.reshape(R, L // lt, lt).min(dim=2).values.clamp(0, T - span - 256)
    return torch.div(base, 128, rounding_mode="floor") * 128


def span_ok(S: torch.Tensor, T: int, span: int = SPAN, lt: int = LT) -> torch.Tensor:
    """(R, L) bool: True where position i's window start lies inside the slab
    of its tile, ``S - base`` in [0, span). The gather zeroes the others and
    the caller masks them (the span mask)."""
    R, L = S.shape
    d = S.reshape(R, L // lt, lt) - shear_slab_base(S, T, span, lt)[:, :, None]
    return ((d >= 0) & (d < span)).reshape(R, L)


def _check_shear(x, S, t_w: int, span: int, slab: bool):
    if x.dim() != 2 or S.dim() != 2 or S.shape[0] != x.shape[0]:
        raise ValueError(f"x (R, T) and S (R, L) expected, got {tuple(x.shape)} "
                         f"and {tuple(S.shape)}")
    T, L = x.shape[1], S.shape[1]
    if t_w < 1:
        raise ValueError(f"t_w must be positive, got {t_w}")
    if slab:
        if L % LT != 0:
            raise ValueError(f"L={L} must be a multiple of {LT} under the slab rule")
        if T < span + 256:
            raise ValueError(f"T={T} is shorter than span + 256 = {span + 256}")
        if t_w > 256:
            raise ValueError(f"t_w={t_w} exceeds 256: a window could leave the row")


def shear_gather_plain(x, S, t_w: int, span: int = SPAN, slab: bool = True):
    """``xs[s, r, i] = x[r, S[r, i] + s]`` — (t_w, R, L) f32, exact.

    x (R, T) f32; S (R, L) i32 with 0 <= S. With ``slab`` (the contract of
    ``shear_gather_pallas``): per (read, 128-position tile) the aligned base
    is :func:`shear_slab_base`; an element whose ``S - base`` lies outside
    [0, span) comes out 0.0 (the caller masks such positions), everything
    else is exact; needs T >= span + 256, L a multiple of 128 and t_w <= 256.
    Without ``slab`` the index ``S + s`` is clamped to [0, T - 1] and nothing
    is zeroed. The kernels gather the same samples inside the rescore tile
    kernels; this is their plain version."""
    _check_shear(x, S, t_w, span, slab)
    R, T = x.shape
    L = S.shape[1]
    dev = x.device
    S64 = S.to(torch.int64)
    samp = S64[:, :, None] + torch.arange(t_w, dtype=torch.int64, device=dev)
    xs = torch.gather(x, 1, samp.clamp(0, T - 1).reshape(R, L * t_w)).reshape(R, L, t_w)
    if slab:
        xs = torch.where(span_ok(S64, T, span)[:, :, None], xs, torch.zeros_like(xs))
    return xs.permute(2, 0, 1).contiguous()


# the shear gather (K4 of the TPU package) done inside the two rescore tile
# kernels: one count per launch of either
shear_gather_folded = _Epilogue("shear_gather_folded")


# ------------------------------------------------------------------- rescore
def _check_rescore(xs, w, kk, codes, t_w: int):
    if xs.dim() != 3:
        raise ValueError(f"xs: expected (t_w, R, L), got {tuple(xs.shape)}")
    if xs.shape[0] != t_w or t_w < 1:
        raise ValueError(f"xs has {xs.shape[0]} sample rows, t_w is {t_w}")
    dev = xs.device
    _, R, L = xs.shape
    _check("xs", xs, torch.float32, (t_w, R, L), dev)
    for name, t in (("w", w), ("kk", kk), ("codes", codes)):
        _check(name, t, torch.int32, (R, L), dev)
    return R, L, dev


def _rescore_plain(xs, em, mu, iv, w, kk, codes, k: int, cfg: AlignConfig, t_w: int):
    """The local DP on (k, 4, R, L) constants: a Python loop over the samples
    with the kernel's operations in the kernel's order."""
    _, R, L = xs.shape
    dev = xs.device
    em, mu, iv = (a.reshape(k, 4, R, L) for a in (em, mu, iv))
    w = w.clamp(max=t_w)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    neg_row = torch.full((1, 4, R, L), NEG_INF, dtype=torch.float32, device=dev)
    first_slot = (torch.arange(k, device=dev) == 0)[:, None, None, None]

    d0 = xs[0][None, None] - mu
    v = torch.where(first_slot, em - d0 * d0 * iv, neg)     # whatever W is
    # steps at or beyond the longest window are identity for every position
    for s in range(1, int(w.max()) if w.numel() else 0):
        d = xs[s][None, None] - mu
        emit = em - d * d * iv
        stay = v + cfg.log_p_stay
        move = torch.cat([neg_row, v[: k - 1]], dim=0) + cfg.log_p_move
        v_new = emit + torch.maximum(stay, move)
        v = torch.where((s < w)[None, None], v_new, v)

    kk1 = (kk - 1).to(torch.int64)
    in_range = (kk1 >= 0) & (kk1 < k)
    out = torch.gather(v, 0, kk1.clamp(0, k - 1)[None, None].expand(1, 4, R, L))[0]
    out = torch.where(in_range[None], out, torch.zeros_like(out))   # (4, R, L)
    cod = codes.to(torch.int64)
    ref = torch.gather(out, 0, cod.clamp(0, 3)[None])[0]
    ref = torch.where((cod >= 0) & (cod < 4), ref, torch.zeros_like(ref))
    return out - ref[None]


def _check_tab(woff, tab, R: int, L: int, k: int, dev, woff_range=None):
    """Check the table and the offsets into it. ``woff_range``: the smallest
    and largest offset, where the caller has them on the host; else they are
    read back from ``woff`` (one synchronisation with the card)."""
    if tab.dim() != 3 or tab.shape[0] != 3 or tab.shape[1] != 4 * k:
        raise ValueError(f"tab: expected (3, {4 * k}, rows_p), got {tuple(tab.shape)}")
    rows_p = tab.shape[2]
    _check("tab", tab, torch.float32, (3, 4 * k, rows_p), dev)
    _check("woff", woff, torch.int32, (R,), dev)
    if R:
        if woff_range is None:
            woff_range = torch.stack(torch.aminmax(woff)).tolist()
        lo, hi = (int(v) for v in woff_range)
        # the kernel reads L columns from each offset and never clamps: a
        # clamped slice would be the wrong genome positions, silently
        if lo < 0 or hi + L > rows_p:
            raise ValueError(
                f"window offsets [{lo}, {hi}] + {L} columns leave the table "
                f"of {rows_p} columns")
    return rows_p


def rescore_fill_tab_plain(xs, w, kk, codes, woff, tab, cfg: AlignConfig, t_w: int):
    """The local DP with constants read from the genome table, on gathered
    samples — the contract of ``rescore_fill_tab_pallas``: xs (t_w, R, L) f32
    from :func:`shear_gather_plain`; w, kk, codes (R, L) i32 (window length, live
    slots, reference base 0..3); woff (R,) i32 table column of each read's
    first window position; tab (3, k*4, rows_p) f32 the stacked [em, mu, iv]
    of ``SubstTables``. Returns (4, R, L) f32 scores per base minus the
    reference base's. Offsets that would leave the table raise. The card runs
    this inside :func:`rescore_local_tab`."""
    k = cfg.k
    R, L, dev = _check_rescore(xs, w, kk, codes, t_w)
    _check_tab(woff, tab, R, L, k, dev)
    cols = woff.to(torch.int64)[:, None] + torch.arange(L, device=dev)[None, :]
    em, mu, iv = (tab[p][:, cols] for p in range(3))        # (k*4, R, L) each
    return _rescore_plain(xs, em, mu, iv, w, kk, codes, k, cfg, t_w)


def rescore_fill_plain(xs, em, mu, iv, w, kk, codes, cfg: AlignConfig, t_w: int):
    """The local DP with constants passed per batch, on gathered samples —
    the contract of ``rescore_fill_pallas`` (K6 on its own): as
    :func:`rescore_fill_tab_plain`, with em, mu, iv (k*4, R, L) f32 (row
    ``j*4 + b`` is slot j, base b; ``em`` is NEG_INF at dead slots) in place
    of the table. The card runs this inside :func:`rescore_local`."""
    k = cfg.k
    R, L, dev = _check_rescore(xs, w, kk, codes, t_w)
    for name, t in (("em", em), ("mu", mu), ("iv", iv)):
        _check(name, t, torch.float32, (4 * k, R, L), dev)
    return _rescore_plain(xs, em, mu, iv, w, kk, codes, k, cfg, t_w)


# ---------------------------------------------------------- the local rescore
def local_windows(path, t_len, window_codes, N: int, k: int, t_w: int,
                  cnt: Optional[torch.Tensor] = None):
    """Window bounds of every position from the global path.

    ``window_codes`` (R, L) is already padded to a multiple of 128. ``cnt``
    (R, count_lanes(N)) i32 are the path's segment counts, as the walk emits
    them; on CPU tensors they may be left out and are then computed by
    ``path_counts_plain``, on CUDA tensors they must come from the walk.
    Returns (S, W, kk, p_lo, valid_i), each (R, L): first sample and length
    (<= t_w) of the window, number of live slots, first k-mer position of
    the window, and whether position i is inside the path's span with a real
    base.
    """
    R, T = path.shape
    L = window_codes.shape[1]
    dev = path.device
    # the path is monotone over live samples, so segment bounds are counts:
    # start[i] = #{t < t_len : path[t] < i}, end[i] = start[i + 1]. Count
    # index i runs 0..N so both bounds come from one array.
    Np = count_lanes(N)
    if cnt is None:
        if dev.type != "cpu":
            raise ValueError("local_windows: on a CUDA device the segment counts "
                             "come from the walk (cuda_dp.backtrack with t_len "
                             "and n_lanes)")
        cnt = path_counts_plain(path, Np, t_len)
    _check("cnt", cnt, torch.int32, (R, Np), dev)

    first_pos = path[:, 0]
    last_t = (t_len - 1).clamp(min=0).to(torch.int64)
    last_pos = torch.gather(path, 1, last_t[:, None])[:, 0]

    i_idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    p_lo = torch.maximum((i_idx - k + 1).clamp(0, N - 1), first_pos[:, None])
    p_hi = torch.minimum(i_idx.clamp(0, N - 1), last_pos[:, None])
    kk = p_hi - p_lo + 1
    valid_i = (kk > 0) & (window_codes < 4)

    # S[i] = cnt[clip(i-k+1, 0, N-1)] and E[i] = cnt[clip(i, 0, N-1) + 1] are
    # edge-clamped shifts of the count row: no gathers. Clipping against
    # first/last_pos is unnecessary because cnt saturates (0 below first_pos,
    # t_len above last_pos).
    def edge_pad(row, left, right):
        return torch.cat([row[:, :1].expand(R, left), row,
                          row[:, -1:].expand(R, right)], dim=1)[:, :L]

    S = edge_pad(cnt[:, :N], k - 1, max(L - N - (k - 1), 0))
    E = edge_pad(cnt[:, 1:N + 1], 0, max(L - N, 0))
    W = (E - S).clamp(0, t_w)
    return S, W, kk, p_lo, valid_i


def kmer_constants(level_mean, level_std):
    """The three per-k-mer vectors of the constants: emission constant
    ``-log(sigma) - log(2 pi) / 2``, mean, and ``0.5 / sigma^2``, by the
    expressions :func:`batch_constants` applies to the gathered levels (an
    element-wise operation gives the same float before a gather as after)."""
    return -torch.log(level_std) - _HALF_LOG_2PI, level_mean, 0.5 / (level_std * level_std)


def batch_constants(p_lo, kk, window_codes, ids, level_mean, level_std, k: int):
    """Per-batch substituted levels for K6: em, mu, iv (k*4, R, L) f32 and
    the (R, L) mask of positions all of whose live slots hold a real k-mer."""
    R, L = window_codes.shape
    N = ids.shape[1]
    dev = ids.device
    i64 = torch.int64
    i_idx = torch.arange(L, dtype=i64, device=dev)[None, :, None]
    j_id = torch.arange(k, dtype=i64, device=dev)[None, None, :]
    p = p_lo.to(i64)[:, :, None] + j_id                          # (R, L, k)
    j_ok = j_id < kk[:, :, None]
    ids_p = torch.gather(ids.to(i64), 1,
                         p.clamp(0, N - 1).reshape(R, L * k)).reshape(R, L, k)
    ids_ok = ids_p >= 0
    off = i_idx - p
    inside = (off >= 0) & (off < k)
    pow4 = torch.tensor([4 ** (k - 1 - o) for o in range(k)], dtype=i64, device=dev)
    w4 = torch.where(inside, pow4[off.clamp(0, k - 1)], torch.zeros_like(off))
    b_id = torch.arange(4, dtype=i64, device=dev)[None, None, None, :]
    nid = ids_p[..., None] + (b_id - window_codes.to(i64)[:, :, None, None]) * w4[..., None]
    nid = nid.clamp(0, level_mean.shape[0] - 1)                  # (R, L, k, 4)
    mu_s = level_mean[nid]
    sg_s = level_std[nid]
    em = -torch.log(sg_s) - _HALF_LOG_2PI
    iv = 0.5 / (sg_s * sg_s)
    dead = ~(j_ok & ids_ok)
    em = torch.where(dead[..., None],
                     torch.full((), NEG_INF, dtype=torch.float32, device=dev), em)

    def to_kernel_layout(a):   # (R, L, k, 4) -> (k*4, R, L)
        return a.permute(2, 3, 0, 1).reshape(k * 4, R, L).contiguous()

    slots_ok = torch.where(j_ok, ids_ok, torch.ones_like(ids_ok)).all(dim=2)
    return to_kernel_layout(em), to_kernel_layout(mu_s), to_kernel_layout(iv), slots_ok


def _window_xs(x, S, W, t_w: int):
    """The sample windows of the positions and the span mask: (xs (t_w, R, L),
    W with the span-masked positions set to 0). Where T >= 2048 + 256 the
    samples are gathered under the slab rule, and a position whose window
    start lies 2048 samples or more beyond its tile's aligned base gets W = 0;
    below that T there is no mask and sample indices clamp to T - 1."""
    T = x.shape[1]
    S_c = S.clamp(0, T - 1).contiguous()
    slab = T >= SPAN + 256
    if slab:
        W = torch.where(span_ok(S_c, T), W, torch.zeros_like(W))
    return shear_gather_plain(x, S_c, t_w, span=SPAN, slab=slab), W.contiguous()


def _check_local(x, path, t_len, cnt, window_codes, N, t_w):
    """Checks shared by the two rescore tile kernels' wrappers. Returns
    (R, T, L)."""
    if x.dim() != 2 or window_codes.dim() != 2:
        raise ValueError(f"x (R, T) and window_codes (R, L) expected, got "
                         f"{tuple(x.shape)} and {tuple(window_codes.shape)}")
    dev = x.device
    R, T = x.shape
    L = window_codes.shape[1]
    if L % LT != 0:
        raise ValueError(f"L={L} must be a multiple of {LT} (pad the window codes)")
    if not 1 <= t_w <= MAX_TW:
        raise ValueError(f"t_w={t_w} must lie in [1, {MAX_TW}]")
    if N < 1 or T < 1:
        raise ValueError(f"N={N} and T={T} must be positive")
    _check("x", x, torch.float32, (R, T), dev)
    _check("path", path, torch.int32, (R, T), dev)
    _check("t_len", t_len, torch.int32, (R,), dev)
    _check("window_codes", window_codes, torch.int32, (R, L), dev)
    if cnt is not None:
        _check("cnt", cnt, torch.int32, (R, count_lanes(N)), dev)
    return R, T, L


def rescore_local_tab_plain(x, path, t_len, cnt, window_codes, woff, tab, valid,
                            N: int, cfg: AlignConfig, t_w: int):
    """Plain version of :func:`rescore_local_tab`: the composition it
    replaces."""
    k = cfg.k
    L = window_codes.shape[1]
    S, W, kk, _, valid_i = local_windows(path, t_len, window_codes, N, k, t_w, cnt)
    xs, W = _window_xs(x, S, W, t_w)
    scores = rescore_fill_tab_plain(xs, W, kk, window_codes.clamp(0, 3), woff, tab,
                                    cfg, t_w)                      # (4, R, L)
    # read-local edge positions (clipped windows) are masked: kk == k required
    cols = woff.to(torch.int64)[:, None] + torch.arange(L, device=x.device)
    all_ok = valid_i & (kk == k) & valid[cols] & (W > 0)
    out = scores.permute(1, 2, 0)                                  # (R, L, 4)
    return torch.where(all_ok[:, :, None], out, torch.zeros_like(out)).contiguous()


def rescore_local_tab(x: torch.Tensor, path: torch.Tensor, t_len: torch.Tensor,
                      cnt: Optional[torch.Tensor], window_codes: torch.Tensor,
                      woff: torch.Tensor, tab: torch.Tensor, valid: torch.Tensor,
                      N: int, cfg: AlignConfig, t_w: int,
                      woff_range: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The local rescore with genome tables, from the walk's counts to the
    masked base log-likelihoods, in one launch.

    x (R, T) f32; path (R, T) i32 and t_len (R,) i32 (the path's first and
    last live positions are read from them); cnt (R, count_lanes(N)) i32 the
    path's segment counts as the walk emits them (on CPU tensors None makes
    the plain version count them); window_codes (R, L) i32 the window's bases,
    4 past its end, L a multiple of 128; woff (R,) i32 the table column of
    each read's position 0; tab (3, k*4, rows_p) f32 and valid (rows_p,) bool
    of ``SubstTables``; N the window's k-mer count; t_w <= 256. Returns (R, L,
    4) f32: per base, the local DP's score minus the reference base's, and 0
    where the position is masked — not a real base, a window clipped by the
    read's ends (kk < k), invalid in the genome, an empty window, or (from
    T = 2304 on) a window start 2048 samples or more beyond its 128-position
    tile's slab base. The tables branch of ``base_loglik_local_pallas``: the
    TPU's K4 and K5 with the tensor code around them. Offsets that would leave
    the table raise: ``woff_range``, the smallest and largest of ``woff``
    where the caller has them on the host (the pipeline does), spares the
    wrapper reading them back from the card.
    """
    k, t_w, N = cfg.k, int(t_w), int(N)
    R, T, L = _check_local(x, path, t_len, cnt, window_codes, N, t_w)
    dev = x.device
    rows_p = _check_tab(woff, tab, R, L, k, dev, woff_range)
    _check("valid", valid, torch.bool, (rows_p,), dev)
    if dev.type == "cpu":
        return rescore_local_tab_plain(x, path, t_len, cnt, window_codes, woff, tab,
                                       valid, N, cfg, t_w)
    if dev.type != "cuda":
        raise ValueError(f"rescore_local_tab: unsupported device {dev}")
    if cnt is None:
        raise ValueError("rescore_local_tab: on a CUDA device the segment counts "
                         "come from the walk (cuda_dp.backtrack with t_len and "
                         "n_lanes)")
    if k > MAX_K:
        raise ValueError(f"k={k}: the rescore kernel is built for k <= {MAX_K}")
    lib = kernel_build.load_library()
    out = torch.empty((R, L, 4), dtype=torch.float32, device=dev)
    with _on(dev):
        code = lib.nadavca_rescore_local_tab(
            x.data_ptr(), cnt.data_ptr(), path.data_ptr(), t_len.data_ptr(),
            window_codes.data_ptr(), woff.data_ptr(), tab.data_ptr(),
            valid.data_ptr(), out.data_ptr(), R, T, L, N, cnt.shape[1], t_w, k,
            tab.shape[2], float(cfg.log_p_stay), float(cfg.log_p_move), _stream(dev))
    kernel_build.check_launch(lib, code, "rescore_local_tab")
    rescore_local_tab.launches += 1
    shear_gather_folded.launches += 1
    return out


rescore_local_tab.launches = 0


def rescore_local_plain(x, path, t_len, cnt, window_codes, ids, level_mean, level_std,
                        cfg: AlignConfig, t_w: int):
    """Plain version of :func:`rescore_local`: the composition it replaces."""
    k = cfg.k
    N = ids.shape[1]
    S, W, kk, p_lo, valid_i = local_windows(path, t_len, window_codes, N, k, t_w, cnt)
    xs, W = _window_xs(x, S, W, t_w)
    em, mu, iv, slots_ok = batch_constants(p_lo, kk, window_codes, ids, level_mean,
                                           level_std, k)
    scores = rescore_fill_plain(xs, em, mu, iv, W, kk.contiguous(),
                                window_codes.clamp(0, 3), cfg, t_w)     # (4, R, L)
    all_ok = valid_i & (W > 0) & slots_ok
    out = scores.permute(1, 2, 0)                                      # (R, L, 4)
    return torch.where(all_ok[:, :, None], out, torch.zeros_like(out)).contiguous()


def rescore_local(x: torch.Tensor, path: torch.Tensor, t_len: torch.Tensor,
                  cnt: Optional[torch.Tensor], window_codes: torch.Tensor,
                  ids: torch.Tensor, level_mean: torch.Tensor, level_std: torch.Tensor,
                  cfg: AlignConfig, t_w: int) -> torch.Tensor:
    """The local rescore without genome tables, from the walk's counts to the
    masked base log-likelihoods, in one launch.

    x, path, t_len, cnt, window_codes, t_w as :func:`rescore_local_tab`; ids
    (R, N) i32 the window's k-mer ids (-1 for none); level_mean, level_std
    (n_kmers,) f32 the k-mer model. Each position is scored with the
    substituted k-mers' levels; a window clipped by the read's ends (kk < k)
    is scored on its kk live slots, as the ``scan`` twin does. Returns (R, L,
    4) f32, 0 where the position is masked — not a real base, a live slot
    without a real k-mer, an empty window, or (from T = 2304 on) a window
    start 2048 samples or more beyond its 128-position tile's slab base. The
    no-tables branch of ``base_loglik_local_pallas``: the TPU's K4 and K6
    with the tensor code around them. The three per-k-mer vectors of
    :func:`kmer_constants` are made here, once per call; the kernel gathers
    from them.
    """
    k, t_w = cfg.k, int(t_w)
    if ids.dim() != 2 or level_mean.dim() != 1 or level_mean.shape[0] < 1:
        raise ValueError(f"ids (R, N) and level_mean (n_kmers,) expected, got "
                         f"{tuple(ids.shape)} and {tuple(level_mean.shape)}")
    N = ids.shape[1]
    R, T, L = _check_local(x, path, t_len, cnt, window_codes, N, t_w)
    dev = x.device
    _check("ids", ids, torch.int32, (R, N), dev)
    _check("level_mean", level_mean, torch.float32, level_mean.shape, dev)
    _check("level_std", level_std, torch.float32, level_mean.shape, dev)
    if dev.type == "cpu":
        return rescore_local_plain(x, path, t_len, cnt, window_codes, ids, level_mean,
                                   level_std, cfg, t_w)
    if dev.type != "cuda":
        raise ValueError(f"rescore_local: unsupported device {dev}")
    if cnt is None:
        raise ValueError("rescore_local: on a CUDA device the segment counts come "
                         "from the walk (cuda_dp.backtrack with t_len and n_lanes)")
    if k > MAX_K:
        raise ValueError(f"k={k}: the rescore kernel is built for k <= {MAX_K}")
    if level_mean.shape[0] < 4 ** k:
        raise ValueError(f"level_mean holds {level_mean.shape[0]} k-mers, k={k} "
                         f"needs {4 ** k}")
    em_k, mu_k, iv_k = (v.contiguous() for v in kmer_constants(level_mean, level_std))
    lib = kernel_build.load_library()
    out = torch.empty((R, L, 4), dtype=torch.float32, device=dev)
    with _on(dev):
        code = lib.nadavca_rescore_local(
            x.data_ptr(), cnt.data_ptr(), path.data_ptr(), t_len.data_ptr(),
            window_codes.data_ptr(), ids.data_ptr(), em_k.data_ptr(), mu_k.data_ptr(),
            iv_k.data_ptr(), out.data_ptr(), R, T, L, N, cnt.shape[1], t_w, k,
            level_mean.shape[0], float(cfg.log_p_stay), float(cfg.log_p_move),
            _stream(dev))
    kernel_build.check_launch(lib, code, "rescore_local")
    rescore_local.launches += 1
    shear_gather_folded.launches += 1
    return out


rescore_local.launches = 0

KERNELS = (rescore_local_tab, rescore_local, shear_gather_folded)


def reset_launches() -> None:
    for kern in KERNELS:
        kern.launches = 0


def base_loglik_local_cuda(
    x: torch.Tensor,             # (R, T) f32
    path: torch.Tensor,          # (R, T) i32
    t_len: torch.Tensor,         # (R,) i32
    window_codes: torch.Tensor,  # (R, L) i32
    ids: torch.Tensor,           # (R, N) i32
    level_mean: torch.Tensor,
    level_std: torch.Tensor,
    k: int,
    cfg: AlignConfig = AlignConfig(),
    t_w: int = 192,
    tables: Optional[SubstTables] = None,
    window_off: Optional[torch.Tensor] = None,   # (R,) i32 table column per read
    cnt: Optional[torch.Tensor] = None,          # (R, count_lanes(N)) i32 from the walk
    window_off_range: Optional[Tuple[int, int]] = None,   # window_off's min, max
) -> torch.Tensor:
    """(R, L, 4) base log-likelihoods — kernel version of
    ``banded_dp.base_loglik_local_batch``, twin of ``base_loglik_local_pallas``.

    With ``tables`` the whole rescore is one :func:`rescore_local_tab`
    (the TPU's K4 and K5 and the tensor code around them): positions whose
    window is clipped by the read's ends (``kk < k``) or invalid in the genome
    are masked to exactly 0. Without, it is one :func:`rescore_local` (K4 and
    K6 and their tensor code), and edge positions are scored like the
    ``scan`` twin's.

    ``cnt`` are the path's segment counts as the walk emitted them (see
    :func:`local_windows`: required on CUDA tensors). ``window_off_range``:
    the smallest and largest window offset, where the caller has them on the
    host (see :func:`rescore_local_tab`).

    The span mask: where T >= 2048 + 256 the sample windows are gathered
    under the slab rule, and a position whose window start lies 2048 samples
    or more beyond its tile's aligned base is masked to 0. Below that T there
    is no mask and sample indices clamp to T - 1.
    """
    if k != cfg.k:
        raise ValueError(f"k={k} differs from cfg.k={cfg.k}")
    if (tables is None) != (window_off is None):
        raise ValueError("tables and window_off go together")
    L_in = window_codes.shape[1]
    N = ids.shape[1]
    # pad the position axis so that tiles of the slab rule are whole (padded
    # positions carry base code 4 => masked out)
    L = _round_up(L_in, LT)
    if L != L_in:
        window_codes = torch.nn.functional.pad(window_codes, (0, L - L_in), value=4)
    window_codes = window_codes.contiguous()

    if tables is not None:
        out = rescore_local_tab(x, path, t_len, cnt, window_codes,
                                window_off.contiguous(), tables.tab, tables.valid, N,
                                cfg, t_w, woff_range=window_off_range)
        return out if L == L_in else out[:, :L_in, :].contiguous()

    out = rescore_local(x, path, t_len, cnt, window_codes, ids, level_mean, level_std,
                        cfg, t_w)
    return out if L == L_in else out[:, :L_in, :].contiguous()
