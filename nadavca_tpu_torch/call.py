"""SNP calling: cross-read aggregation of base likelihoods → posteriors → VCF.

Counterpart of ``nadavca_tpu/call.py``: per-read per-position base
log-likelihoods are summed across reads covering each locus, converted to
posteriors under a uniform prior, thresholded, and reported.

The aggregation is a scatter-add (``index_add_``) of (R, L, 4) read windows
into a (G, 4) genome accumulator. Reverse-strand reads are handled by flipping
the window coordinates and complementing the base axis before the scatter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from .config import AlignConfig
from .utils.profiling import span


def scatter_values(
    base_ll: torch.Tensor,      # (R, L, 4) float32 per-read window log-likelihoods
    window_start: torch.Tensor, # (R,) int genome coord of window base 0 (fwd strand)
    window_len: torch.Tensor,   # (R,) int true window lengths
    strand: torch.Tensor,       # (R,) int +1 / -1
    G: int,
    cfg: AlignConfig,
):
    """The single source of truth for the locus scatter semantics.

    Per-read contributions are clipped to ±cfg.snp_ll_clip so a single
    misanchored read cannot dominate a locus, and each read casts at most one
    "vote" per position for a base whose margin over the runner-up exceeds
    cfg.snp_vote_margin (consumed by call_snps' min-alt-votes filter).

    Returns (flat_pos (R·L,) int64 with G as the overflow row, ll (R·L, 4)
    clipped+masked values, n_valid (R·L,) int32, votes_onehot (R·L, 4) int32).
    """
    R, L, _ = base_ll.shape
    dev = base_ll.device
    window_start = window_start.to(torch.int64)
    window_len = window_len.to(torch.int64)
    li = torch.arange(L, dtype=torch.int64, device=dev)[None, :]   # (1, L)
    rev = strand[:, None] < 0                                       # (R, 1)
    # genome position of window base i
    pos_fwd = window_start[:, None] + li
    pos_rev = window_start[:, None] + (window_len[:, None] - 1 - li)
    pos = torch.where(rev, pos_rev, pos_fwd)                        # (R, L)
    valid = (li < window_len[:, None]) & (pos >= 0) & (pos < G)
    pos_safe = torch.where(valid, pos, torch.full_like(pos, G))     # overflow row

    # complement base axis for reverse reads: A C G T -> T G C A, the axis
    # reversed (made on the device: a tensor of indices from the host would be
    # a blocking copy in the middle of the step)
    ll_rev = base_ll.flip(2)
    ll_raw = torch.where(rev[:, :, None], ll_rev, base_ll)
    ll = ll_raw.clamp(-cfg.snp_ll_clip, cfg.snp_ll_clip)
    ll = torch.where(valid[:, :, None], ll, torch.zeros_like(ll))

    # per-read confident votes (on UNclipped deltas): best base beats the
    # runner-up by the margin. argmax returns the first maximum; ref col is 0
    best = torch.argmax(ll_raw, dim=2)                              # (R, L)
    best_v = ll_raw.max(dim=2).values
    second = torch.sort(ll_raw, dim=2).values[:, :, 2]
    confident = (best_v - second >= cfg.snp_vote_margin) & valid
    onehot = torch.nn.functional.one_hot(best, 4).to(torch.int32) \
        * confident[..., None].to(torch.int32)
    return (pos_safe.reshape(-1), ll.reshape(-1, 4),
            valid.reshape(-1).to(torch.int32), onehot.reshape(-1, 4))


def accumulate_batch(
    acc: torch.Tensor,          # (G, 4) float32 genome log-likelihood accumulator
    cov: torch.Tensor,          # (G,) int32 read coverage counter
    base_ll: torch.Tensor,      # (R, L, 4) float32 per-read window log-likelihoods
    window_start: torch.Tensor, # (R,) genome coord of window base 0 (fwd strand)
    window_len: torch.Tensor,   # (R,) true window lengths
    strand: torch.Tensor,       # (R,) +1 / -1
    votes: Optional[torch.Tensor] = None,  # (G, 4) int32 per-read alt-vote counter
    cfg: AlignConfig = AlignConfig(),
):
    """Scatter-add one batch of read windows into the genome accumulators.

    Returns new tensors (the arguments are left as they were). Out-of-window
    and out-of-genome positions land in an overflow row that is cut off again.
    On a CUDA device ``index_add_`` adds with atomics, so the float sums in
    ``acc`` can differ in their last bits from run to run; ``cov`` and
    ``votes`` are integer sums and exact. Span ``nadavca.accumulate``.
    """
    G = acc.shape[0]
    with span("nadavca.accumulate"):
        flat_pos, ll, n_valid, onehot = scatter_values(
            base_ll, window_start, window_len, strand, G, cfg)
        acc_pad = torch.cat([acc, acc.new_zeros((1, 4))], dim=0)
        acc_pad.index_add_(0, flat_pos, ll.to(acc.dtype))
        cov_pad = torch.cat([cov, cov.new_zeros((1,))], dim=0)
        cov_pad.index_add_(0, flat_pos, n_valid.to(cov.dtype))
        if votes is None:
            return acc_pad[:G], cov_pad[:G]
        votes_pad = torch.cat([votes, votes.new_zeros((1, 4))], dim=0)
        votes_pad.index_add_(0, flat_pos, onehot.to(votes.dtype))
        return acc_pad[:G], cov_pad[:G], votes_pad[:G]


def accumulate_batch_(
    acc: torch.Tensor,          # (G, 4) float32, added to in place
    cov: torch.Tensor,          # (G,) int32, added to in place
    votes: torch.Tensor,        # (G, 4) int32, added to in place
    base_ll: torch.Tensor,
    window_start: torch.Tensor,
    window_len: torch.Tensor,
    strand: torch.Tensor,
    cfg: AlignConfig = AlignConfig(),
) -> None:
    """:func:`accumulate_batch` into the given accumulators, in place, with no
    G-sized temporary. The overflow row's entries are zeros (``scatter_values``
    masks them), so they are added to row 0, which leaves it as it was."""
    G = acc.shape[0]
    with span("nadavca.accumulate"):
        flat_pos, ll, n_valid, onehot = scatter_values(
            base_ll, window_start, window_len, strand, G, cfg)
        flat_pos = torch.where(flat_pos < G, flat_pos, torch.zeros_like(flat_pos))
        acc.index_add_(0, flat_pos, ll.to(acc.dtype))
        cov.index_add_(0, flat_pos, n_valid.to(cov.dtype))
        votes.index_add_(0, flat_pos, onehot.to(votes.dtype))


def make_accumulators(genome_len: int, with_votes: bool = False, device="cuda"):
    """Fresh (G, 4) log-likelihood and (G,) coverage accumulators."""
    acc = torch.zeros((genome_len, 4), dtype=torch.float32, device=device)
    cov = torch.zeros((genome_len,), dtype=torch.int32, device=device)
    if with_votes:
        return acc, cov, torch.zeros((genome_len, 4), dtype=torch.int32,
                                     device=device)
    return acc, cov


def posteriors(acc: torch.Tensor, prior: float = 0.25) -> torch.Tensor:
    """(G, 4) posterior probabilities from aggregated log-likelihoods."""
    return torch.softmax(acc + math.log(prior), dim=-1)


@dataclasses.dataclass
class SnpCall:
    contig: str
    position: int         # 0-based genome coordinate
    ref_base: str
    alt_base: str
    probability: float
    coverage: int


def candidate_hits(
    acc: np.ndarray,
    cov: np.ndarray,
    ref_codes: np.ndarray,
    cfg: AlignConfig = AlignConfig(),
    min_coverage: int = 1,
    votes: Optional[np.ndarray] = None,
):
    """Pre-prune candidate positions: (hit mask, best base, posterior).

    The filter stack of :func:`call_snps` WITHOUT cluster pruning — a
    joint-rescore pass would use these as cluster seeds, so a true SNP
    suppressed by a stronger shifted neighbor is still in play.
    """
    post = posteriors(torch.as_tensor(np.asarray(acc)), cfg.snp_prior).numpy()
    cov = np.asarray(cov)
    best = post.argmax(axis=1)
    pbest = post.max(axis=1)
    ref = np.asarray(ref_codes)
    hit = (best != ref) & (pbest >= cfg.snp_threshold) & (cov >= min_coverage) & (ref < 4)
    if votes is not None:
        v = np.take_along_axis(np.asarray(votes), best[:, None], axis=1)[:, 0]
        hit &= v >= cfg.snp_min_alt_votes
    return hit, best, pbest


def call_snps(
    acc: np.ndarray,
    cov: np.ndarray,
    ref_codes: np.ndarray,
    contig: str,
    cfg: AlignConfig = AlignConfig(),
    min_coverage: int = 1,
    votes: Optional[np.ndarray] = None,
) -> List[SnpCall]:
    """Threshold posteriors into SNP calls (host side, tiny).

    Filters: posterior >= snp_threshold, coverage >= min_coverage, and (when
    a votes accumulator is provided) >= snp_min_alt_votes reads individually
    voting for the alt; finally cluster pruning keeps only the strongest call
    within any window of k-1 bases (neighbors of a true SNP share perturbed
    k-mers and would otherwise bleed into spurious calls).
    """
    hit, best, pbest = candidate_hits(acc, cov, ref_codes, cfg,
                                      min_coverage=min_coverage, votes=votes)
    cov = np.asarray(cov)
    ref = np.asarray(ref_codes)
    calls = []
    bases = "ACGT"
    acc_np = np.asarray(acc)
    strength = acc_np.max(axis=1) - np.take_along_axis(
        acc_np, ref[:, None].clip(0, 3), axis=1
    )[:, 0]
    idxs = list(np.nonzero(hit)[0])
    if cfg.snp_cluster_prune and idxs:
        keep = []
        for g in idxs:
            better = [h for h in idxs
                      if h != g and abs(h - g) < cfg.k and strength[h] > strength[g]]
            if not better:
                keep.append(g)
        idxs = keep
    for g in idxs:
        calls.append(
            SnpCall(
                contig=contig,
                position=int(g),
                ref_base=bases[ref[g]],
                alt_base=bases[best[g]],
                probability=float(pbest[g]),
                coverage=int(cov[g]),
            )
        )
    return calls


def write_vcf(path: str, calls: List[SnpCall], source: str = "nadavca_tpu_torch") -> None:
    """Minimal VCF 4.2 output of SNP calls."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##source={source}\n")
        f.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Read coverage">\n')
        f.write('##INFO=<ID=PP,Number=1,Type=Float,Description="Posterior probability">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for c in calls:
            qual = min(999.0, -10.0 * np.log10(max(1e-100, 1.0 - c.probability)))
            f.write(
                f"{c.contig}\t{c.position + 1}\t.\t{c.ref_base}\t{c.alt_base}\t"
                f"{qual:.1f}\tPASS\tDP={c.coverage};PP={c.probability:.6f}\n"
            )


def write_alignment(path: str, read_id: str, contig: str, strand: int,
                    ref_start: int, ref_end: int,
                    seg_start: np.ndarray, seg_end: np.ndarray) -> None:
    """Per-read alignment output: reference position → signal sample range.

    Mirrors the reference's `align` output shape (header + per-position
    ranges; SURVEY.md "Output writers" row).
    """
    with open(path, "w") as f:
        strand_c = "+" if strand > 0 else "-"
        f.write(f"# read={read_id} contig={contig} strand={strand_c} "
                f"start={ref_start} end={ref_end}\n")
        for i, (s, e) in enumerate(zip(seg_start, seg_end)):
            if s >= 0:
                f.write(f"{i}\t{s}\t{e}\n")
