"""SNP calling: cross-read aggregation of base likelihoods → posteriors → VCF.

Counterpart of ``nadavca_tpu/call.py``: per-read per-position base
log-likelihoods are summed across reads covering each locus, converted to
posteriors under a uniform prior, thresholded, and reported.

The aggregation is a scatter-add of (R, L, 4) read windows into a (G, 4)
genome accumulator (``ops/cuda_scatter``: one kernel on the card, its plain
version ``scatter_values`` and ``index_add_`` on the CPU). Reverse-strand
reads are handled by flipping the window coordinates and complementing the
base axis before the scatter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from .config import AlignConfig
from .ops.cuda_scatter import index_add_windows, scatter_values  # noqa: F401
from .utils.profiling import span


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

    Returns new tensors (the arguments are left as they were): a copy of each
    accumulator, added to by :func:`accumulate_batch_`. Out-of-window and
    out-of-genome positions add nothing. On a CUDA device the adds are
    atomic, so the float sums in ``acc`` can differ in their last bits from
    run to run; ``cov`` and ``votes`` are integer sums and exact. Span
    ``nadavca.accumulate``.
    """
    with span("nadavca.accumulate"):
        acc, cov, votes = (None if t is None else t.clone(memory_format=torch.contiguous_format)
                           for t in (acc, cov, votes))
        accumulate_batch_(acc, cov, votes, base_ll, window_start, window_len, strand, cfg)
    return (acc, cov) if votes is None else (acc, cov, votes)


def accumulate_batch_(
    acc: torch.Tensor,          # (G, 4) float32, added to in place
    cov: torch.Tensor,          # (G,) int32, added to in place
    votes: Optional[torch.Tensor],  # (G, 4) int32, added to in place, or None
    base_ll: torch.Tensor,
    window_start: torch.Tensor,
    window_len: torch.Tensor,
    strand: torch.Tensor,
    cfg: AlignConfig = AlignConfig(),
) -> None:
    """:func:`accumulate_batch` into the given accumulators, in place, with no
    G-sized temporary: ``ops/cuda_scatter.index_add_windows``, one kernel on
    a CUDA device, its plain version (``scatter_values`` and three
    ``index_add_``) on the CPU."""
    with span("nadavca.accumulate"):
        index_add_windows(acc, cov, votes, base_ll, window_start, window_len, strand, cfg)


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
