"""Joint adjacent-hypothesis rescoring of SNP candidate clusters.

The per-position caller scores each substitution hypothesis against its own
local signal window under the segmentation of the REFERENCE alignment. A true
SNP perturbs k consecutive k-mers, distorts the local segmentation, and can
make a NEIGHBOR position's alt hypothesis the apparent winner — the
adjacent-shift ambiguity (a float64 oracle makes the identical shifted call,
so this is a limitation of the model, not of a kernel).

Counterpart of ``nadavca_tpu/joint.py``: the same host-side numpy planning and
decision code, with the hypothesis rows scored by the port's ``scan`` twin
(``ops/banded_dp.banded_viterbi_batch``, skip and pinned ends included) on the
device the caller names. The fix is a second, JOINT pass over each candidate
cluster:

  * hypothesis set = {reference} ∪ {base b at position p : p within k-1 of a
    candidate hit, b != ref_p} — every way a single SNP near the cluster
    could explain the evidence;
  * every covering read contributes the SAME signal slice to every
    hypothesis, and each hypothesis is scored by full re-ALIGNMENT (a fresh
    banded Viterbi over the slice with hypothesis-substituted expected
    levels) — the segmentation adapts to the hypothesis instead of being
    pinned to the reference alignment, and scores are comparable across
    positions;
  * per-read hypothesis deltas aggregate by MEDIAN across reads; the call
    moves to the median-argmax hypothesis only when it beats the caller's
    own pick decisively (cfg.snp_joint_repos_margin nats/read, ≥
    cfg.snp_joint_min_reads covering reads) — the pass refines positions,
    it never drops or cheaply overrides the per-position caller.

Candidate clusters are rare (they already passed the caller's filters), so
the pass costs one tiny batched DP — reads × hypotheses rows of a few
hundred samples — via the plain per-step loop (ops/banded_dp.py).

Staged so multi-host works shared-nothing: :func:`cluster_plan` is a pure
function of the (globally merged, replicated) accumulators — every process
derives the identical plan; :func:`partial_deltas` scores only the LOCAL
shard's covering reads; the per-read matrices concatenate across processes
(one padded allgather per contig); :func:`decide` medians them into calls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import call as callmod
from .config import AlignConfig
from .kmer_model import KmerModel
from .ops import banded_dp

# static DP shapes for the joint pass, the JAX package's: T_PAD bounds the
# signal slice (slices are ~dwell × slice positions ≈ 300-500 samples; longer
# tails are trimmed symmetrically), N_PAD the slice's k-mer positions.
T_PAD = 512
N_PAD = 64
# rows per DP slab: whole-genome runs score tens of thousands of hypothesis
# rows, and the decision tensor of the backtrack is T_PAD · rows · band bytes.
# Fixed-size slabs bound peak memory at ~135 MB per slab for any workload.
R_SLAB = 2048

_COMP = np.array([3, 2, 1, 0], dtype=np.int64)
_BASES = "ACGT"


@dataclasses.dataclass(frozen=True)
class ReadMeta:
    """Per-read placement metadata: ~60 bytes/read, enough to find the reads
    covering a candidate cluster without the full records."""

    read_id: str
    contig: str
    wstart: int
    wlen: int
    strand: int


@dataclasses.dataclass(frozen=True)
class Cluster:
    """One candidate cluster: hit span + its hypothesis enumeration."""

    span: Tuple[int, int]                 # inclusive genome-position span
    hyps: Tuple[Tuple[int, int], ...]     # (position, alt base) per hypothesis
    fallback_pos: int                     # strongest hit (no-evidence fallback)
    fallback_base: int
    fallback_prob: float


def group_clusters(hits: np.ndarray, k: int) -> List[Tuple[int, int]]:
    """Group sorted hit positions into spans with gaps < k.

    Hypotheses cover every position within k-1 of the span, which is where a
    single true SNP can sit and still perturb the hit positions' k-mers."""
    if len(hits) == 0:
        return []
    hits = np.sort(np.asarray(hits))
    spans = []
    lo = hi = int(hits[0])
    for h in hits[1:]:
        if int(h) - hi < int(k):
            hi = int(h)
        else:
            spans.append((lo, hi))
            lo = hi = int(h)
    spans.append((lo, hi))
    return spans


def reads_covering(span: Tuple[int, int], metas: Iterable[ReadMeta],
                   k: int) -> List[ReadMeta]:
    """Reads whose window fully covers the hypothesis-affected positions."""
    gl = span[0] - (k - 1)
    gh = span[1] + (k - 1)
    return [m for m in metas if m.wstart <= gl and gh < m.wstart + m.wlen]


def cluster_plan(
    acc: np.ndarray,
    cov: np.ndarray,
    votes: Optional[np.ndarray],
    ref_codes: np.ndarray,
    cfg: AlignConfig,
    min_coverage: int = 1,
) -> List[Cluster]:
    """Deterministic cluster + hypothesis enumeration from the accumulators.

    A pure function of globally-merged state, so every process of a
    multi-host run derives the identical plan independently."""
    hit, best, pbest = callmod.candidate_hits(
        acc, cov, ref_codes, cfg, min_coverage=min_coverage, votes=votes)
    hits = np.nonzero(hit)[0]
    plan = []
    acc = np.asarray(acc)
    for span in group_clusters(hits, cfg.k):
        g0 = max(span[0] - (cfg.k - 1), 0)
        g1 = min(span[1] + (cfg.k - 1), len(ref_codes) - 1)
        hyps = []
        for p in range(g0, g1 + 1):
            rp = int(ref_codes[p])
            if rp > 3:
                continue
            for b in range(4):
                if b != rp:
                    hyps.append((p, b))
        span_hits = [int(g) for g in hits if span[0] <= g <= span[1]]
        fb = max(span_hits,
                 key=lambda g: float(acc[g].max() - acc[g, ref_codes[g]]))
        plan.append(Cluster(span=span, hyps=tuple(hyps), fallback_pos=fb,
                            fallback_base=int(best[fb]),
                            fallback_prob=float(pbest[fb])))
    return plan


def _read_slice(rec, span, hyps, model: KmerModel, cfg: AlignConfig):
    """One read's signal slice + per-hypothesis level sets for a cluster.

    Returns (x_slice, mu_rows (1+n_h, n_pos), sg_rows, clean_lo, clean_hi)
    or None when the read's anchor does not place enough signal on the
    cluster. clean_lo/clean_hi are slice K-MER positions guaranteed
    hypothesis-INDEPENDENT (outside every perturbed k-mer) — the locate
    pass pins the scoring window at them. Coordinates: the read's window is
    genome[wstart : wstart+wlen] (reverse-complemented when strand < 0),
    rec.anchor_path[t] is the window K-MER position of sample t (monotone).
    """
    k = model.k
    a = rec.anchor
    wlen = len(rec.window_codes)
    # genome span of interest (hypothesis positions ± context pad)
    gl = span[0] - (k - 1) - cfg.snp_joint_pad
    gh = span[1] + (k - 1) + cfg.snp_joint_pad

    def to_window(g):
        if a.strand > 0:
            return g - a.ref_start
        return (a.ref_start + wlen - 1) - g

    wa, wb = to_window(gl), to_window(gh)
    w0 = max(min(wa, wb), 0)
    w1 = min(max(wa, wb) + 1, wlen)           # window BASE positions [w0, w1)
    n_pos = w1 - w0 - k + 1                    # k-mer positions in the slice
    if n_pos < 2 or n_pos > N_PAD:
        return None

    # sample range: the anchor maps window k-mer positions to samples; pad by
    # half the band width each side (the anchor may be off by up to the band)
    path = rec.anchor_path[: len(rec.signal)]
    s0 = int(np.searchsorted(path, w0, side="left"))
    s1 = int(np.searchsorted(path, w1 - k, side="right"))
    s0 = max(s0 - cfg.band_width // 2, 0)
    s1 = min(s1 + cfg.band_width // 2, len(rec.signal))
    if s1 - s0 < 4 * k:
        return None
    if s1 - s0 > T_PAD:                        # trim symmetrically
        extra = (s1 - s0) - T_PAD
        s0 += extra // 2
        s1 = s0 + T_PAD
    x = rec.signal[s0:s1]

    codes = np.asarray(rec.window_codes[w0:w1], np.int64)
    # k-mer positions perturbed by ANY hypothesis, in slice coords
    pert = []
    mu_rows, sg_rows = [], []
    for hyp in [None] + list(hyps):
        c = codes
        if hyp is not None:
            p, b = hyp
            wp = to_window(p) - w0
            if not 0 <= wp < len(c):
                return None
            pert += [wp - k + 1, wp]
            c = codes.copy()
            # the window stores the revcomp for reverse-strand reads, so a
            # genome-forward alt lands as its complement
            c[wp] = b if a.strand > 0 else int(_COMP[b])
        m, s = model.expected_signal(c)
        mu_rows.append(m)
        sg_rows.append(s)
    # trim boundaries sit a few positions INTO the clean flanks: the locate
    # pass aligns under the REFERENCE model, whose path is locally distorted
    # around a true SNP's perturbed k-mers — a boundary adjacent to them
    # inherits that distortion (measured: bimodal truth-hypothesis deltas).
    buf = 4
    clean_lo = min(pert) - buf if pert else 0
    clean_hi = max(pert) + buf if pert else n_pos - 1
    if clean_lo < 1 or clean_hi > n_pos - 2:
        return None                            # no clean flank on some side
    return x, np.stack(mu_rows), np.stack(sg_rows), clean_lo, clean_hi


def _score_rows(xs, t_lens, mus, sgs, n_refs, cfg: AlignConfig,
                pin: bool = True, want_path: bool = False,
                use_skip: bool = False, device="cuda"):
    """Batched full-band Viterbi over the padded joint rows.

    Rows run in fixed R_SLAB-row slabs through the ``scan`` twin on
    ``device``. ``pin`` constrains the alignment to span position
    0..n_ref-1 (see the pinned-endpoint rationale in
    :func:`partial_deltas`); the locate pass runs free. ``use_skip`` enables
    the skip transition at cfg.snp_joint_log_p_skip — the indel-tolerant
    slice model (a pore-skipped position costs one bounded penalty instead of
    a forced misalignment).
    """
    jcfg = dataclasses.replace(cfg, band_width=128, band_width_long=128,
                               use_skip=use_skip,
                               log_p_skip=(cfg.snp_joint_log_p_skip
                                           if use_skip else cfg.log_p_skip))
    R = len(xs)
    Rp = -(-max(R, 1) // R_SLAB) * R_SLAB
    x = np.zeros((Rp, T_PAD), np.float32)
    mu = np.zeros((Rp, N_PAD), np.float32)
    sg = np.ones((Rp, N_PAD), np.float32)
    for r in range(R):
        x[r, : len(xs[r])] = xs[r]
        mu[r, : len(mus[r])] = mus[r]
        sg[r, : len(sgs[r])] = sgs[r]
    tl = np.zeros(Rp, np.int32)
    tl[:R] = np.asarray(t_lens, np.int32)
    tl[R:] = 4                                 # harmless nonzero pad rows
    nr = np.ones(Rp, np.int32)
    nr[:R] = np.asarray(n_refs, np.int32)
    dev = torch.device(device)
    lo = torch.zeros((R_SLAB, T_PAD), dtype=torch.int32, device=dev)  # full band
    scores, paths = [], []
    for r0 in range(0, Rp, R_SLAB):
        sl = slice(r0, r0 + R_SLAB)
        res = banded_dp.banded_viterbi_batch(
            *(torch.from_numpy(a[sl]).to(dev) for a in (x, tl, mu, sg, nr)),
            lo, jcfg, pin_start=pin, pin_end=pin)
        scores.append(res.score.cpu().numpy())
        if want_path:
            paths.append(res.path.cpu().numpy())
    score = np.concatenate(scores)[:R]
    if want_path:
        return score, np.concatenate(paths)[:R]
    return score


def partial_deltas(
    plan: Sequence[Cluster],
    metas: Sequence[ReadMeta],
    records_by_id: Dict[str, object],
    model: KmerModel,
    cfg: AlignConfig,
    diag_out: Optional[list] = None,
    device="cuda",
) -> List[np.ndarray]:
    """This shard's per-read hypothesis-delta matrices.

    mats[c] is (n_local_reads, 1 + n_hyps + 1) float32: each row is one
    covering read's alignment-score deltas vs its own reference hypothesis
    (column 0, identically 0), plus a trailing per-read QUALITY column —
    max-over-hypotheses score per scored sample. Contaminated reads
    (pore-skip/indel-distorted slices) fit poorly under EVERY hypothesis,
    so their quality is low regardless of whether they carry the SNP;
    :func:`decide` can drop them by robust z-score
    (cfg.snp_joint_filter_mad) before aggregating. Matrices CONCATENATE
    across processes (row-wise); :func:`decide` aggregates the delta
    columns with a per-hypothesis MEDIAN across reads. Sums were measured
    inadequate both raw (one indel-distorted read drags the argmax hundreds
    of nats) and clipped (clean high-signal clusters saturate every
    plausible hypothesis at the clip and tie-break arbitrarily); the median
    is immune to both failure modes.

    ``diag_out``, if a list, receives one dict per accepted row
    (ci, ri, read_id, qual, n_samp) for offline analysis. The DP rows run on
    ``device``.

    Two DP passes per read:

    1. **Locate** (free endpoints, reference levels): the anchor places the
       signal slice only approximately, and a pinned DP on a misplaced
       slice shifts EVERY hypothesis's alignment coherently — selection
       then keys on the shift, not the SNP (measured: a wrong hypothesis
       5 positions off beat the exact true model by 30 nats/read). The
       locate pass aligns the slice under the reference model and reads
       off the samples of the cluster's CLEAN flanking positions (outside
       every perturbed k-mer, where the reference model is right even when
       a SNP is present).
    2. **Score** (pinned endpoints, per hypothesis): on the flank-trimmed
       window the content-derived endpoints are trustworthy, so pinning is
       sound — and without pinning a whole-window shift is nearly free and
       adjacent hypotheses tie (the original ambiguity re-entering through
       the alignment's gauge freedom).
    """
    mats = [np.zeros((0, 2 + len(c.hyps)), np.float32) for c in plan]
    # ---- pass 1: locate (free ends, ref levels) --------------------------
    loc_x, loc_mu, loc_sg, loc_info = [], [], [], []
    for ci, c in enumerate(plan):
        for m in reads_covering(c.span, metas, cfg.k):
            rec = records_by_id.get(m.read_id)
            if rec is None:
                continue
            rr = _read_slice(rec, c.span, c.hyps, model, cfg)
            if rr is None:
                continue
            x, mu_r, sg_r, clean_lo, clean_hi = rr
            loc_x.append(x)
            loc_mu.append(mu_r[0])
            loc_sg.append(sg_r[0])
            loc_info.append((ci, m.read_id, x, mu_r, sg_r,
                             clean_lo, clean_hi))
    if not loc_x:
        return mats
    _, paths = _score_rows(loc_x, [len(v) for v in loc_x], loc_mu, loc_sg,
                           [len(v) for v in loc_mu], cfg,
                           pin=False, want_path=True,
                           use_skip=cfg.snp_joint_skip, device=device)
    # ---- pass 2: score all hypotheses on the flank-trimmed windows -------
    rows_x, rows_mu, rows_sg, rows_key = [], [], [], []
    counts = [0 for _ in plan]
    row_meta = []
    for (ci, rid, x, mu_r, sg_r, clean_lo, clean_hi), path in zip(
            loc_info, paths):
        p = path[: len(x)]
        s0 = int(np.searchsorted(p, clean_lo, side="left"))
        s1 = int(np.searchsorted(p, clean_hi, side="right"))
        n_pos2 = clean_hi - clean_lo + 1
        if s1 - s0 < 2 * n_pos2:       # locate pass put too little signal on
            continue                   # the cluster — not usable evidence
        x2 = x[s0:s1]
        counts[ci] += 1
        row_meta.append((ci, counts[ci] - 1, rid, len(x2)))
        for h in range(mu_r.shape[0]):
            rows_x.append(x2)
            rows_mu.append(mu_r[h, clean_lo: clean_hi + 1])
            rows_sg.append(sg_r[h, clean_lo: clean_hi + 1])
            rows_key.append((ci, h, counts[ci] - 1))
    if not rows_x:
        return mats
    scores = _score_rows(
        rows_x, [len(v) for v in rows_x], rows_mu, rows_sg,
        [len(v) for v in rows_mu], cfg, pin=True,
        use_skip=cfg.snp_joint_skip, device=device)
    mats = [np.zeros((n, 2 + len(c.hyps)), np.float32)
            for n, c in zip(counts, plan)]
    for (ci, h, ri), s in zip(rows_key, scores):
        mats[ci][ri, h] = float(s)
    out = []
    for m in mats:
        d = m[:, :-1] - m[:, :1]             # deltas vs own-ref score
        # quality: best absolute fit per scored sample — contamination
        # (misattributed samples) depresses EVERY hypothesis's fit, a true
        # SNP only the reference's
        qual = m[:, :-1].max(axis=1, keepdims=True)
        out.append(np.concatenate([d, qual], axis=1))
    for (ci, ri, rid, n_samp) in row_meta:
        out[ci][ri, -1] /= max(n_samp, 1)
        if diag_out is not None:
            diag_out.append(dict(ci=ci, ri=ri, read_id=rid,
                                 qual=float(out[ci][ri, -1]),
                                 n_samp=n_samp))
    return out


def decide(
    plan: Sequence[Cluster],
    mats: Sequence[np.ndarray],
    cov: np.ndarray,
    ref_codes: np.ndarray,
    contig: str,
    cfg: AlignConfig,
    acc: Optional[np.ndarray] = None,
) -> List[callmod.SnpCall]:
    """Summed hypothesis totals → final calls for one contig.

    The joint pass is a REFINER of the per-position caller, not a
    replacement: every cluster emits a call (the caller already filtered by
    posterior/coverage/votes), at the caller's pick by default. The call
    moves to the joint argmax only when the joint evidence is substantial
    (≥ snp_joint_min_reads fully-covering reads) and decisively prefers the
    new position — ≥ snp_joint_repos_margin (~one clipped read-equivalent)
    over the caller's own hypothesis. BASE identity at a repositioned site
    defers to the accumulator ``acc`` when it carries alt evidence there —
    the local-window model is the better-calibrated base discriminator.
    (Measured on the accuracy grid, 2026-08-21: an unconditional
    drop-and-replace rule was strictly worse at 4-8x coverage; this
    conservative rule keeps the caller's behavior except where realignment
    has real evidence of an adjacent shift.)"""
    calls: List[callmod.SnpCall] = []
    cov = np.asarray(cov)
    acc = np.asarray(acc) if acc is not None else None
    for c, mat in zip(plan, mats):
        p_star, b_star = c.fallback_pos, c.fallback_base
        prob = c.fallback_prob
        # trailing column = per-read quality (see partial_deltas); the
        # delta columns are everything before it
        qual = mat[:, -1].astype(np.float64)
        mat = mat[:, :-1]
        if cfg.snp_joint_filter_mad > 0 and mat.shape[0] >= 3:
            med_q = np.median(qual)
            mad = np.median(np.abs(qual - med_q))
            if mad > 0:
                keep = qual >= med_q - cfg.snp_joint_filter_mad * mad
                mat = mat[keep]
        n = mat.shape[0]
        try:
            fb_idx = c.hyps.index((c.fallback_pos, c.fallback_base))
        except ValueError:
            fb_idx = None
        if n >= cfg.snp_joint_min_reads and c.hyps and fb_idx is not None:
            med = np.median(mat.astype(np.float64), axis=0)  # (1 + n_h,)
            # repositioning targets are gated on per-position accumulator
            # support: the realignment median can mildly prefer a shifted
            # same-base hypothesis at a position the per-position model sees
            # NOTHING at (clean-world measurement) — a real shifted SNP
            # always leaves sub-threshold accumulator evidence at the true
            # position, so require acc's argmax there to be non-reference.
            gated = []
            for hi, (p, b) in enumerate(c.hyps):
                if acc is None:
                    gated.append(hi)
                elif int(np.argmax(acc[p])) != int(ref_codes[p]):
                    gated.append(hi)
            if gated:
                alt_idx = max(gated, key=lambda hi: med[1 + hi])
                edge_vs_fb = float(med[1 + alt_idx] - med[1 + fb_idx])
                if (alt_idx != fb_idx
                        and edge_vs_fb >= cfg.snp_joint_repos_margin):
                    p_star = c.hyps[alt_idx][0]
                    b_star = c.hyps[alt_idx][1]
                    if acc is not None:
                        acc_best = int(np.argmax(acc[p_star]))
                        if acc_best != int(ref_codes[p_star]):
                            b_star = acc_best
                    # per-read-representative posterior over the hypotheses
                    t = med - med.max()
                    prob = float(np.exp(t[1 + alt_idx]) / np.exp(t).sum())
        calls.append(callmod.SnpCall(
            contig=contig, position=int(p_star),
            ref_base=_BASES[int(ref_codes[p_star])], alt_base=_BASES[b_star],
            probability=prob, coverage=int(cov[p_star])))
    return calls


def needed_read_ids(plan: Sequence[Cluster], metas: Sequence[ReadMeta],
                    k: int) -> set:
    """Read ids this shard must re-load for the plan (one re-ingest pass)."""
    needed = set()
    for c in plan:
        for m in reads_covering(c.span, metas, k):
            needed.add(m.read_id)
    return needed


def refine_contig_calls(
    acc: np.ndarray,
    cov: np.ndarray,
    votes: Optional[np.ndarray],
    ref_codes: np.ndarray,
    contig: str,
    cfg: AlignConfig,
    model: KmerModel,
    metas: Sequence[ReadMeta],
    records_by_id: Dict[str, object],
    min_coverage: int = 1,
    device="cuda",
) -> List[callmod.SnpCall]:
    """Single-process convenience wrapper: plan → score local → decide."""
    plan = cluster_plan(acc, cov, votes, ref_codes, cfg,
                        min_coverage=min_coverage)
    if not plan:
        return []
    mats = partial_deltas(plan, metas, records_by_id, model, cfg, device=device)
    return decide(plan, mats, cov, ref_codes, contig, cfg, acc=acc)
