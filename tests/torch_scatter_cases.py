"""Batches for the locus scatter (``ops/cuda_scatter.index_add_windows``) and
a NumPy statement of what it adds, shared by the CPU tests and the card's.
Imports neither JAX nor the JAX package."""

import numpy as np
import torch

from nadavca_tpu_torch import call as tcall
from nadavca_tpu_torch.config import AlignConfig

CFG = AlignConfig()
NEG_INF = -1e30
G, R, L = 300, 8, 64
# the cases every test runs; "wide" is the bench cells' widest batch on the
# E. coli genome, for the card only
CASES = ("forward", "reverse", "crossing_ends", "empty_windows", "ties", "margin_edge",
         "clip_and_neg_inf", "nan_rows", "no_votes", "int64_vectors")
WIDE = dict(G=4_641_652, R=256, L=26_000)


def make_case(name: str, seed: int = 0):
    """(base_ll (R, L, 4) f32, window_start, window_len, strand, G, with_votes)
    as numpy arrays, the three per-read vectors int32 (int64 where named)."""
    rng = np.random.default_rng(seed + CASES.index(name) if name in CASES else seed)
    if name == "wide":
        g, r, l = WIDE["G"], WIDE["R"], WIDE["L"]
        base_ll = rng.normal(0, 8, size=(r, l, 4)).astype(np.float32)
        wl = rng.integers(0, l + 1, size=r).astype(np.int32)
        # half the reads pile up on the first 50 kb (many adds to one row),
        # the rest anywhere, a few over either end of the genome
        ws = np.where(np.arange(r) % 2 == 0, rng.integers(0, 50_000, size=r),
                      rng.integers(0, g, size=r)).astype(np.int64)
        ws[:4] = (-300, g - 500, -20_000, g - 10)
        st = np.where(rng.random(r) < 0.5, 1, -1).astype(np.int32)
        return base_ll, ws, wl, st, g, True
    base_ll = rng.normal(0, 6, size=(R, L, 4)).astype(np.float32)
    ws = rng.integers(0, G - L, size=R).astype(np.int32)
    wl = rng.integers(L // 2, L + 1, size=R).astype(np.int32)
    st = np.where(np.arange(R) % 2 == 0, 1, -1).astype(np.int32)
    votes = True
    if name == "forward":
        st[:] = 1
    elif name == "reverse":
        st[:] = -1
    elif name == "crossing_ends":
        ws[:4] = (-20, G - 30, -5, G - 1)           # fwd, rev, fwd, rev
        wl[:4] = L
        ws[4], wl[4] = -L - 3, L                    # wholly before the genome
    elif name == "empty_windows":
        wl[::2] = 0
        wl[1] = 1
    elif name == "ties":
        base_ll[:, ::3] = [0.0, 2.0, 2.0, -1.0]     # best and runner-up tie
        base_ll[:, 1::5] = 5.0                      # all four tie
        base_ll[:, 2::7] = [7.0, 1.0, 7.0, 7.0]
    elif name == "margin_edge":
        m = np.float32(CFG.snp_vote_margin)
        base_ll[:, ::2] = [0.5, 0.5 + m, -1.0, 0.5]        # exactly the margin: votes
        base_ll[:, 1::4] = [0.0, np.nextafter(m, np.float32(0)), 0.0, -2.0]  # just under
        base_ll[:, 3::4] = [-m, -m, -m, 0.0]               # exactly, best at the end
    elif name == "clip_and_neg_inf":
        c = CFG.snp_ll_clip
        base_ll[:, ::2] = [0.0, 40.0, -40.0, c]
        base_ll[:, 1::4] = [NEG_INF, NEG_INF, 0.0, NEG_INF]
        base_ll[:, 3::4] = [NEG_INF] * 4
    elif name == "nan_rows":
        base_ll[:, ::3, 2] = np.nan
        base_ll[:, 1::7] = [np.nan, 9.0, 0.0, 0.0]
    elif name == "no_votes":
        votes = False
    elif name == "int64_vectors":
        ws, st = ws.astype(np.int64), st.astype(np.int64)
        ws[0] = -7
    return base_ll, ws, wl, st, G, votes


def start_accumulators(g: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(g, 4)).astype(np.float32),
            rng.integers(0, 5, size=g).astype(np.int32),
            rng.integers(0, 3, size=(g, 4)).astype(np.int32))


def numpy_scatter(acc, cov, votes, base_ll, ws, wl, st, cfg=CFG):
    """What the scatter adds, in NumPy: acc summed in float64 (a new array),
    cov and votes (new arrays; votes None where not given)."""
    g = acc.shape[0]
    acc, cov = acc.astype(np.float64), cov.copy()
    i = np.arange(base_ll.shape[1])[None, :]
    ws, wl = ws.astype(np.int64)[:, None], wl.astype(np.int64)[:, None]
    rev = (st < 0)[:, None]
    pos = np.where(rev, ws + wl - 1 - i, ws + i)
    valid = (i < wl) & (pos >= 0) & (pos < g)
    v = np.where(rev[:, :, None], base_ll[:, :, ::-1], base_ll)[valid]   # (n, 4) f32
    p = pos[valid]
    np.add.at(acc, p, np.clip(v, -cfg.snp_ll_clip, cfg.snp_ll_clip).astype(np.float64))
    np.add.at(cov, p, 1)
    if votes is None:
        return acc, cov, None
    votes = votes.copy()
    best = np.argmax(v, axis=1)                        # first maximum; a NaN wins
    second = np.sort(v, axis=1)[:, 2]                  # NaN sorts last
    ok = v[np.arange(len(v)), best] - second >= np.float32(cfg.snp_vote_margin)
    np.add.at(votes, (p[ok], best[ok]), 1)
    return acc, cov, votes


def padded_scatter(acc, cov, votes, base_ll, ws, wl, st, cfg=CFG):
    """The scatter as the port wrote it before the kernel: ``scatter_values``
    and three ``index_add_`` into G + 1 rows, the last the overflow row that
    is cut off again (torch tensors in, new tensors out)."""
    g = acc.shape[0]
    flat_pos, ll, n_valid, onehot = tcall.scatter_values(base_ll, ws, wl, st, g, cfg)
    out = []
    for a, d in ((acc, ll), (cov, n_valid), (votes, onehot)):
        if a is None:
            out.append(None)
            continue
        pad = torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))], dim=0)
        pad.index_add_(0, flat_pos, d.to(a.dtype))
        out.append(pad[:g])
    return tuple(out)
