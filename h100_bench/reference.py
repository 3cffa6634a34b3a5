"""The plain reference of the SNP step, in NumPy, one read at a time.

It imports nothing of the program and takes nothing the program made: from
the benchmark's own inputs (signals, true anchors, reference windows, pore
model) it works out again what the program derives on the way — which reads
share a batch and how that batch is padded, the band of every signal chunk,
the expected and the substituted k-mer levels — and then computes, for one
read, the banded Viterbi score and path and the local re-DP's base
log-likelihoods; for the genome, the accumulators that the scatter of all
reads' log-likelihoods gives, and the SNP calls of accumulators.

The semantics are those of the configuration (``configs/*.json``, key
``align``): a band of ``band_width`` slots, constant within each chunk of
``signal_chunk`` samples, placed on the anchor; stay / move transitions;
Gaussian emissions; a free start at the first sample; the best final slot
inside the window. The local rescore scores each window position under the
4 bases over the samples the Viterbi path gives its k k-mers (at most
``snp_local_window``), and keeps only positions whose k k-mers all lie in the
path's span and, for batches of ``2048 + 256`` samples or more, whose window
starts within 2048 samples of the aligned slab base of its 128-position tile.

Arithmetic is float64 (``Precision("float64")``); ``Precision("bfloat16")``
rounds every intermediate to bfloat16, the control the comparison has to
fail.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
TILE = 128       # positions per tile of the slab rule
SPAN = 2048      # samples a tile's window starts may spread over
SLAB_MIN_T = SPAN + 256
_COMP = np.array([3, 2, 1, 0])


class Precision:
    """Rounding after every arithmetic step: none (float64), or to bfloat16
    by round-to-nearest-even of the float32 value."""

    def __init__(self, name: str = "float64"):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, a):
        if self.name == "float64":
            return a
        a = np.asarray(a, np.float64)
        u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return u.astype(np.uint32).view(np.float32).astype(np.float64).reshape(a.shape)


F64 = Precision("float64")


def kmer_ids(codes: np.ndarray, k: int) -> np.ndarray:
    n = len(codes) - k + 1
    ids = np.zeros(max(n, 0), np.int64)
    for off in range(k):
        ids = ids * 4 + codes[off:off + n].astype(np.int64)
    return ids


# ------------------------------------------------------------------ batching
def bucket(t: int, edges) -> int:
    for e in edges:
        if t <= e:
            return int(e)
    return -(-t // edges[-1]) * edges[-1]


@dataclasses.dataclass
class RefBatch:
    members: List[int]    # stream indices of the reads, in batch row order
    T: int                # padded signal length
    L: int                # padded window length
    band: int             # band width


def group(t_len: Sequence[int], wlen: Sequence[int], align: dict,
          batch_reads: int) -> List[RefBatch]:
    """The full batches a stream of reads falls into: each read joins the bin
    of its padded length and band (wide above ``adaptive_band_threshold``
    samples); a bin that reaches ``batch_reads`` reads is a batch. Partial
    bins at the end of the stream are dropped (the benchmark runs full
    batches only)."""
    C = align["signal_chunk"]
    bins: Dict[tuple, List[int]] = {}
    out = []
    for i, t in enumerate(t_len):
        key = (bucket(int(t), align["bucket_edges"]),
               int(t) > align["adaptive_band_threshold"])
        bins.setdefault(key, []).append(i)
        if len(bins[key]) == batch_reads:
            m = bins.pop(key)
            T = -(-bucket(max(int(t_len[j]) for j in m), align["bucket_edges"]) // C) * C
            L = -(-max(int(wlen[j]) for j in m) // 256) * 256
            out.append(RefBatch(m, T, L, align["band_width_long"] if key[1]
                                else align["band_width"]))
    return out


# --------------------------------------------------------------------- band
def chunk_band(anchor: np.ndarray, n_ref: int, B: int, C: int) -> np.ndarray:
    """Band start of every live chunk: the anchor at the chunk's first sample,
    centred, kept inside the window, never moving back, and jumping by at
    most B from one chunk to the next."""
    t_len = len(anchor)
    starts = np.minimum(np.arange(-(-t_len // C)) * C, t_len - 1)
    lo = np.round(anchor[starts]).astype(np.int64) - B // 2
    lo = np.maximum.accumulate(np.clip(lo, 0, max(n_ref - B, 0)))
    d = np.clip(np.diff(lo, prepend=lo[:1]), 0, B)
    return lo[0] + np.cumsum(d) - d[0]


# ------------------------------------------------------------------- Viterbi
def viterbi(x, mu, sg, lo, B: int, C: int, log_stay: float, log_move: float,
            q: Precision = F64):
    """Banded Viterbi of one read. x (t,) signal; mu, sg (n_ref,) expected
    levels of the window's k-mers; lo the band start of each live chunk.
    Returns (score, path (t,) int64 k-mer position per sample)."""
    t_len, n_ref = len(x), len(mu)
    lane = np.arange(B)
    em_all = q(q(-np.log(sg.astype(np.float64))) - HALF_LOG_2PI)
    iv_all = q(0.5 / q(sg.astype(np.float64) * sg))
    dec = np.zeros((t_len, B), bool)
    neg = np.full(1, -np.inf)
    v, acc = None, 0.0
    for c in range(len(lo)):
        pos = lo[c] + lane
        ok = pos < n_ref
        pc = np.minimum(pos, n_ref - 1)
        m, iv = mu[pc].astype(np.float64), iv_all[pc]
        em = np.where(ok, em_all[pc], -np.inf)
        if c > 0:
            d = int(lo[c] - lo[c - 1])
            v = np.concatenate([v[d:], np.full(min(d, B), -np.inf)])
        t0, t1 = c * C, min((c + 1) * C, t_len)
        dx = q(x[t0:t1, None].astype(np.float64) - m[None, :])
        emit = q(em[None, :] - q(q(dx * dx) * iv[None, :]))
        for s in range(t1 - t0):
            if t0 + s == 0:
                v = emit[0]
                continue
            stay = q(v + log_stay)
            move = q(np.concatenate([neg, v[:-1]]) + log_move)
            dec[t0 + s] = move > stay
            v = q(emit[s] + np.maximum(stay, move))
        top = v.max()
        if np.isfinite(top):        # once a chunk, as the kernels renormalise
            v = q(v - top)
            acc = float(q(acc + top))
    valid = lo[-1] + lane < n_ref
    vv = np.where(valid, v, -np.inf)
    j = int(np.argmax(vv))
    score = float(q(acc + vv[j]))
    path = np.empty(t_len, np.int64)
    for t in range(t_len - 1, -1, -1):
        c = t // C
        path[t] = lo[c] + j
        if t == 0:
            break
        j -= int(dec[t, j])
        if t % C == 0:
            j += int(lo[c] - lo[c - 1])
    return score, path


# ------------------------------------------------------------ local rescore
def window_bounds(path, n_codes: int, codes_ok, T: int, L: int, k: int, t_w: int):
    """Where each of the L window positions of a read finds its samples:
    (first sample (L,), number of samples (L,), kept (L,) bool). A position
    is kept where its k k-mers all lie in the path's span, its base is a real
    one (``codes_ok``), it has samples, and (T >= 2304) its first sample lies
    within 2048 samples of the aligned slab base of its 128-position tile."""
    N = L - k + 1
    cnt = np.searchsorted(path, np.arange(N + 1), side="left")
    first, last = int(path[0]), int(path[-1])
    i = np.arange(L)
    S = cnt[np.clip(i - k + 1, 0, N - 1)]
    E = cnt[np.minimum(i, N - 1) + 1]
    W = np.clip(E - S, 0, t_w)
    kk = np.minimum(np.clip(i, 0, N - 1), last) - np.maximum(
        np.clip(i - k + 1, 0, N - 1), first) + 1
    keep = (kk == k) & (i < n_codes)
    keep[:n_codes] &= codes_ok
    Sc = np.clip(S, 0, T - 1)
    if T >= SLAB_MIN_T:
        base = np.clip(Sc.reshape(-1, TILE).min(axis=1), 0, T - SLAB_MIN_T) // 128 * 128
        d = Sc - np.repeat(base, TILE)
        W = np.where((d >= 0) & (d < SPAN), W, 0)
    return Sc, W, keep & (W > 0)


def local_rescore(x, path, codes, T: int, L: int, k: int, t_w: int,
                  level_mean, level_std, log_stay: float, log_move: float,
                  q: Precision = F64) -> np.ndarray:
    """(L, 4) base log-likelihoods of one read: for every kept window
    position, the local DP's score under each base minus the reference
    base's; 0 at every other position. T and L are the read's batch's
    padded lengths (the slab rule depends on them)."""
    t_len = len(x)
    code = np.full(L, 4, np.int64)
    code[:len(codes)] = codes
    Sc, W, keep = window_bounds(path, len(codes), code[:len(codes)] < 4, T, L, k, t_w)
    P = np.nonzero(keep)[0]
    out = np.zeros((L, 4))
    if len(P) == 0:
        return out
    # substituted k-mers: slot j of position i is the k-mer starting at
    # i - k + 1 + j, its digit of weight 4^j replaced by each base
    ids = kmer_ids(code[:len(codes)], k)
    j = np.arange(k)
    kid = ids[P[:, None] - k + 1 + j[None, :]]                      # (P, k)
    nid = kid[:, None, :] + (np.arange(4)[None, :, None]
                             - code[P][:, None, None]) * (4 ** j)[None, None, :]
    mu = level_mean[nid].astype(np.float64)                         # (P, 4, k)
    sg = level_std[nid].astype(np.float64)
    em = q(q(-np.log(sg)) - HALF_LOG_2PI)
    iv = q(0.5 / q(sg * sg))
    Wp = W[P]
    samp = np.minimum(Sc[P][:, None] + np.arange(int(Wp.max()))[None, :], t_len - 1)
    xs = x[samp].astype(np.float64)                                 # (P, max W)
    d0 = q(xs[:, 0, None, None] - mu)
    v = np.full(mu.shape, -np.inf)
    v[:, :, 0] = q(em - q(q(d0 * d0) * iv))[:, :, 0]
    neg = np.full(mu.shape[:2] + (1,), -np.inf)
    for s in range(1, int(Wp.max())):
        dx = q(xs[:, s, None, None] - mu)
        emit = q(em - q(q(dx * dx) * iv))
        stay = q(v + log_stay)
        move = q(np.concatenate([neg, v[:, :, :-1]], axis=2) + log_move)
        v = np.where((s < Wp)[:, None, None], q(emit + np.maximum(stay, move)), v)
    fin = v[:, :, k - 1]
    out[P] = q(fin - fin[np.arange(len(P)), code[P]][:, None])
    return out


def expected_levels(codes, k: int, level_mean, level_std):
    ids = kmer_ids(codes, k)
    return level_mean[ids], level_std[ids]


def answers_of_reads(jobs, workers: int = 0):
    """:func:`read_answers` of many reads, ``jobs`` a list of its argument
    tuples, shared over as many worker processes as there are cores (at most
    one a read): plain subprocesses fed through pipes, so nothing is made in
    shared memory. The results in the order of ``jobs``."""
    import os
    import pickle
    import subprocess
    import sys

    n = min(workers or os.cpu_count() or 1, len(jobs))
    if n <= 1:
        return [read_answers(*j) for j in jobs]
    # the longest reads dealt out first, so that the workers finish together
    order = sorted(range(len(jobs)), key=lambda i: -len(jobs[i][0]))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    procs = []
    try:
        for w in range(n):
            procs.append((subprocess.Popen(
                [sys.executable, "-c", "from h100_bench.reference import _serve; _serve()"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env), order[w::n]))
        for p, idx in procs:
            pickle.dump([jobs[i] for i in idx], p.stdin)
            p.stdin.close()
        out = [None] * len(jobs)
        for p, idx in procs:
            for i, res in zip(idx, pickle.load(p.stdout)):
                out[i] = res
            if p.wait() != 0:
                raise RuntimeError(f"a reference worker exited with {p.returncode}")
        return out
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _serve():
    """One worker of :func:`answers_of_reads`: its jobs from standard input,
    their answers to standard output."""
    import pickle
    import sys

    jobs = pickle.load(sys.stdin.buffer)
    pickle.dump([read_answers(*j) for j in jobs], sys.stdout.buffer)
    sys.stdout.buffer.flush()


def read_answers(x, anchor, codes, batch: RefBatch, align: dict, level_mean,
                 level_std, q: Precision = F64):
    """The Viterbi score and the (L, 4) base log-likelihoods of one read of
    ``batch``."""
    k = align["k"]
    mu, sg = expected_levels(codes, k, level_mean, level_std)
    lo = chunk_band(np.asarray(anchor, np.float64), len(mu), batch.band,
                    align["signal_chunk"])
    score, path = viterbi(x, mu, sg, lo, batch.band, align["signal_chunk"],
                          align["log_p_stay"], align["log_p_move"], q)
    ll = local_rescore(x, path, codes, batch.T, batch.L, k, align["snp_local_window"],
                       level_mean, level_std, align["log_p_stay"],
                       align["log_p_move"], q)
    return score, ll


# ------------------------------------------------------------------ scatter
def window_positions(start: int, wlen: int, strand: int, L: int, G: int):
    """Genome position of each of the L window slots of a read, and whether
    the slot is a real base inside the genome."""
    i = np.arange(L)
    pos = start + i if strand > 0 else start + wlen - 1 - i
    return pos, (i < wlen) & (pos >= 0) & (pos < G)


def coverage(starts, wlens, strands, G: int) -> np.ndarray:
    """(G,) int64: how many read windows cover each position."""
    d = np.zeros(G + 1, np.int64)
    np.add.at(d, np.asarray(starts), 1)
    np.add.at(d, np.minimum(np.asarray(starts) + np.asarray(wlens), G), -1)
    return np.cumsum(d)[:G]


def window_sums(lls, starts, wlens, strands, clip: float, q: Precision = F64):
    """The clipped log-likelihoods of a few reads summed into the genome
    positions they cover, read after read, each sum rounded by ``q``:
    (n_positions, 4), the positions in increasing order."""
    pos_ok = [window_positions(int(s), int(w), int(st), ll.shape[0], 1 << 62)
              for ll, s, w, st in zip(lls, starts, wlens, strands)]
    cols = np.unique(np.concatenate([p[ok] for p, ok in pos_ok]))
    acc = np.zeros((len(cols), 4))
    for ll, (p, ok), st in zip(lls, pos_ok, strands):
        raw = np.asarray(ll, np.float64)[:, _COMP] if st < 0 else np.asarray(ll, np.float64)
        i = np.searchsorted(cols, p[ok])
        acc[i] = q(acc[i] + q(np.clip(raw[ok], -clip, clip)))
    return acc


def scatter(lls, starts, wlens, strands, G: int, clip: float, margin: float):
    """Accumulators of a batch of reads' log-likelihoods, ``lls`` (R, L, 4)
    float32, a tensor on any device: (acc (G, 4) float64, votes (G, 4)
    int64), on that device, of the clipped values and of each read's
    confident best base. Reverse reads' window runs down the genome and
    their base axis is complemented. Plain PyTorch: the genome-sized sums
    run where the log-likelihoods lie."""
    import torch

    dev = lls.device
    R, L, _ = lls.shape
    col = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)[:, None]
    starts, wlens = col(starts), col(wlens)
    rev = col(strands) < 0
    i = torch.arange(L, device=dev)[None, :]
    pos = torch.where(rev, starts + wlens - 1 - i, starts + i)
    ok = (i < wlens) & (pos >= 0) & (pos < G)
    comp = torch.as_tensor(_COMP, device=dev)
    raw = torch.where(rev[:, :, None], lls[:, :, comp], lls)[ok]      # (n, 4)
    pos = pos[ok]
    acc = torch.zeros((G, 4), dtype=torch.float64, device=dev)
    acc.index_add_(0, pos, raw.clamp(-clip, clip).to(torch.float64))
    top2 = torch.topk(raw, 2, dim=1).values
    conf = (top2[:, 0] - top2[:, 1]) >= margin
    best = torch.argmax(raw, dim=1)
    votes = torch.zeros(4 * G, dtype=torch.int64, device=dev)
    votes.index_add_(0, (pos * 4 + best)[conf],
                     torch.ones(int(conf.sum()), dtype=torch.int64, device=dev))
    return acc, votes.reshape(G, 4)


# -------------------------------------------------------------------- calls
def call_snps(acc, cov, votes, ref_codes, align: dict, min_coverage: int,
              device="cpu"):
    """The SNP calls of accumulators: {position: alt base}, and the positions
    where a float32 evaluation of the same rule may decide otherwise
    (posterior within 1e-4 of the threshold, two bases' posteriors within
    1e-6, or a pruning contest within 1e-3 of the stronger call's
    strength). The genome-sized arithmetic is float64 PyTorch on ``device``."""
    import torch

    t = lambda x, dt: torch.as_tensor(np.asarray(x), device=device).to(dt)
    a = t(acc, torch.float64)
    z = torch.exp(a - a.max(dim=1, keepdim=True).values)
    post = z / z.sum(dim=1, keepdim=True)
    top2, best = torch.topk(post, 2, dim=1)
    pbest, second, best = top2[:, 0], top2[:, 1], best[:, 0]
    ref = t(ref_codes, torch.int64)
    v = torch.gather(t(votes, torch.int64), 1, best[:, None])[:, 0]
    base_hit = (best != ref) & (t(cov, torch.int64) >= min_coverage) & (ref < 4) & (
        v >= align["snp_min_alt_votes"])
    hit = base_hit & (pbest >= align["snp_threshold"])
    near = base_hit & (((pbest - align["snp_threshold"]).abs() < 1e-4)
                       | (pbest - second < 1e-6))
    strength = a.max(dim=1).values - torch.gather(a, 1, ref.clamp(0, 3)[:, None])[:, 0]
    idx = torch.nonzero(hit)[:, 0].cpu().numpy()
    strength = strength[torch.as_tensor(idx, device=device)].cpu().numpy()
    best = best.cpu().numpy()
    near = set(torch.nonzero(near)[:, 0].cpu().numpy().tolist())
    calls = {}
    k = align["k"]
    lo = np.searchsorted(idx, idx - k + 1, side="left")
    hi = np.searchsorted(idx, idx + k, side="left")
    for n, g in enumerate(idx):
        riv = np.r_[lo[n]:n, n + 1:hi[n]]       # other hits within k - 1
        if align["snp_cluster_prune"] and (strength[riv] > strength[n]).any():
            continue
        calls[int(g)] = int(best[g])
        tight = riv[np.abs(strength[riv] - strength[n])
                    <= 1e-3 * max(1.0, abs(strength[n]))]
        if len(tight):
            near.update(idx[tight].tolist())
            near.add(int(g))
    return calls, near
