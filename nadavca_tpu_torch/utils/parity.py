"""Hold two alignments of one batch to each other where ties may fall
differently: the one home of that comparison, for the tests and for
``chip_smoke.py``.

Two correct banded Viterbi implementations agree on every path entry except
where two placements of a sample score EQUALLY in exact arithmetic; there the
last bit of a float32 sum decides, and the kernels (renormalised once per
chunk) and the ``scan`` twin (once per step), or two packages, may decide
differently. Both paths are then optimal. Two rules sort such a tie from a
fault:

* the near rule (:func:`tie_only_differences`): the two positions have
  identical levels and lie at most 2 apart, a homopolymer run; with a limit
  on the share of live samples. The callers whose worlds hold no long runs of
  identical levels use it (the main path, the long batch, the C++ core).
* the run rule (:func:`run_tie_differences`): every position from
  ``min(pa, pb)`` to ``max(pa, pb)`` has the same level and the same spread,
  compared bit for bit. Along such a run every way of placing the samples
  scores the same, so this covers a homopolymer (``|pa - pb| <= 2``) and an N
  run of the reference (level 0, spread 1, over as many positions as the run
  is long) alike.

A position's local rescore reads the samples of its k-mers' segments. Where
two tied paths bound a segment differently, the rescore of the positions
next to it may differ by tens of nats and neither is wrong:
:func:`loglik_compare_mask` marks the positions whose window touches no
segment bound that the two paths place differently, and :func:`hold_runs`
compares the rescores there only and counts the positions it left out.
:func:`hold_against_scan` holds the kernels' run of one staged batch against
the twin by the near rule, the twin rescoring the kernels' own path.

Everything here takes torch tensors (numpy arrays are converted) on any
device; nothing imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import call as callmod
from .. import pipeline
from ..ops import banded_dp, cuda_rescore
from ..ops.subst_tables import build_subst_tables


# the largest share of live samples on which a path may differ by a broken
# tie under the near rule: the C++ core against the card, and the long batch
# (8 reads of 8,000 bases) against the scan twin (77 of 640,564, 1.2e-4, on
# the card); the long batch's reads are 8, so a few runs of ties weigh more
# than over the main path's 256 reads (the default limit, 1e-4)
CPU_REF_TIE_SHARE, LONG_TIE_SHARE = 2e-3, 3e-4


def _t(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def live_mask(t_len, T: int, n_reads: int = None) -> torch.Tensor:
    """(R, T) True on the samples ``t < t_len`` of the first ``n_reads`` rows."""
    t_len = _t(t_len)
    live = torch.arange(T, device=t_len.device)[None, :] < t_len[:, None]
    if n_reads is not None:
        live[n_reads:] = False
    return live


def tie_only_differences(tag, path_a, path_b, live, mu, sigma,
                         max_share: float = 1e-4) -> int:
    """Number of live samples on which two paths differ, after checking that
    every such difference is a broken tie by the near rule: the two positions
    hold identical levels and lie at most 2 apart (a homopolymer run, where
    "stay" and "move" score equally). Any other difference fails, and so do
    more than ``max_share`` of the live samples."""
    diff = (path_a != path_b) & live
    n = int(diff.sum())
    if n == 0:
        return 0
    r, t = torch.nonzero(diff, as_tuple=True)
    pa, pb = path_a[r, t].long(), path_b[r, t].long()
    same_level = (mu[r, pa] == mu[r, pb]) & (sigma[r, pa] == sigma[r, pb])
    near = (pa - pb).abs() <= 2
    assert bool((same_level & near).all()), (
        f"{tag}: {int((~(same_level & near)).sum())} of {n} differing path "
        "entries are not ties between positions with identical levels")
    assert n <= max_share * int(live.sum()), (tag, n, int(live.sum()))
    return n


def level_runs(mu, sigma) -> torch.Tensor:
    """(R, N) int64: the index of each position's run of identical levels
    (the same ``mu`` and ``sigma`` as its left neighbour, bit for bit)."""
    mu, sigma = _t(mu).float(), _t(sigma).float()
    bits = torch.stack([mu.view(torch.int32), sigma.view(torch.int32)])
    new = torch.ones(mu.shape, dtype=torch.int64, device=mu.device)
    new[:, 1:] = (bits[:, :, 1:] != bits[:, :, :-1]).any(0).long()
    return torch.cumsum(new, dim=1)


def run_tie_differences(tag, path_a, path_b, live, mu, sigma, max_count: int) -> dict:
    """The run rule: every live sample on which the two paths differ must
    place the two positions in one run of identical levels (``level_runs``),
    and at most ``max_count`` samples may differ. A failure names the read and
    the sample. Returns the count of differing samples (``differing``), the
    reads they lie in (``reads``) and the widest gap ``|pa - pb|``
    (``max_gap``)."""
    path_a = _t(path_a)
    path_b, live = _t(path_b).to(path_a.device), _t(live).to(path_a.device)
    diff = (path_a != path_b) & live
    n = int(diff.sum())
    out = {"differing": n, "reads": 0, "max_gap": 0}
    if n == 0:
        return out
    runs = level_runs(mu, sigma).to(path_a.device)
    r, t = torch.nonzero(diff, as_tuple=True)
    pa, pb = path_a[r, t].long(), path_b[r, t].long()
    bad = runs[r, pa] != runs[r, pb]
    if bool(bad.any()):
        i = torch.nonzero(bad)[:5, 0].tolist()
        where = ", ".join(f"read {int(r[j])} sample {int(t[j])} "
                          f"({int(pa[j])} against {int(pb[j])})" for j in i)
        raise AssertionError(
            f"{tag}: {int(bad.sum())} of {n} differing path entries are not ties "
            f"along a run of identical levels: {where}")
    assert n <= max_count, f"{tag}: {n} tie differences, limit {max_count}"
    out.update(reads=int(torch.unique(r).numel()), max_gap=int((pa - pb).abs().max()))
    return out


def segment_counts(path, t_len, n_pos: int) -> torch.Tensor:
    """(R, n_pos + 1) int64: ``C[r, i] = #{t < t_len[r] : path[r, t] < i}``,
    the segment bounds of a monotone path (segment i is ``[C[i], C[i+1])``)."""
    path = _t(path).long()
    t_len = _t(t_len).long().to(path.device)
    R, T = path.shape
    live = torch.arange(T, device=path.device)[None, :] < t_len[:, None]
    safe = torch.where(live, path, torch.full_like(path, n_pos + 1))
    pos = torch.arange(n_pos + 1, device=path.device)[None, :].expand(R, -1)
    return torch.searchsorted(safe.contiguous(), pos.contiguous(), right=False)


def loglik_compare_mask(path_a, path_b, t_len, n_pos: int, L: int, k: int) -> torch.Tensor:
    """(R, L) bool: True at the base positions whose rescore window touches
    no segment bound that the two paths place differently. Position i's window
    is the segments of k-mer positions ``i-k+1 .. i+k-1``, bounded by
    ``C[i-k+1] .. C[i+k]`` (clipped to the window)."""
    ca = segment_counts(path_a, t_len, n_pos)
    cb = segment_counts(path_b, t_len, n_pos)
    differ = (ca != cb).long()
    cs = torch.nn.functional.pad(torch.cumsum(differ, dim=1), (1, 0))   # (R, N + 2)
    i = torch.arange(L, device=cs.device)
    lo = (i - k + 1).clamp(0, n_pos)
    hi = (i + k).clamp(0, n_pos)
    touched = (cs[:, hi + 1] - cs[:, lo]) > 0
    return ~touched


def interior_mask(path, t_len, window_len, L: int, k: int) -> torch.Tensor:
    """(R, L) bool: the interior of each read's path span, positions
    ``first + k`` up to ``min(window_len, last) - k``. The tables path masks
    the read-local edges to exactly 0, so only these compare with the twin."""
    path = _t(path).long()
    t_len = _t(t_len).long().to(path.device)
    first = path[:, 0]
    last = torch.gather(path, 1, (t_len - 1).clamp(min=0)[:, None])[:, 0]
    wlen = _t(window_len).long().to(path.device)
    i = torch.arange(L, device=path.device)[None, :]
    return (i >= (first + k)[:, None]) & (i < (torch.minimum(wlen, last) - k)[:, None])


def span_mask(path, t_len, L: int, n_pos: int, k: int) -> torch.Tensor:
    """(R, L) bool: the positions the span rule keeps. From T = 2304 on the
    kernels mask to 0 a position whose window starts 2048 samples or more
    past its tile's slab base (``cuda_rescore.span_ok``); below, none."""
    path = _t(path).long()
    R, T = path.shape
    if T < cuda_rescore.SPAN + 256:
        return torch.ones((R, L), dtype=torch.bool, device=path.device)
    Lp = -(-L // cuda_rescore.LT) * cuda_rescore.LT
    cnt = segment_counts(path, t_len, n_pos)
    i = torch.arange(Lp, device=path.device)
    S = cnt[:, (i - k + 1).clamp(0, n_pos - 1)].clamp(0, T - 1)
    return cuda_rescore.span_ok(S, T)[:, :L]


def kernel_compare_mask(path, t_len, window_len, L: int, n_pos: int, k: int,
                        tables: bool) -> torch.Tensor:
    """(R, L) bool: the positions that the kernels' local rescore scores as
    the ``scan`` twin does: those the span rule keeps and, with genome
    tables, of those the interior of the path's span."""
    keep = span_mask(path, t_len, L, n_pos, k)
    return keep & interior_mask(path, t_len, window_len, L, k) if tables else keep


@dataclasses.dataclass
class Held:
    """What :func:`hold_runs` found: path entries that differ by a tie, the
    positions left out of the rescore comparison next to those ties, the
    positions compared, and the largest difference there."""

    tie_differences: int
    tie_reads: int
    max_gap: int
    excluded_positions: int
    compared_positions: int
    ll_max_abs_diff: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def hold_runs(tag, path_a, ll_a, path_b, ll_b, t_len, mu, sigma, k: int,
              max_ties: int, n_reads: int = None, compare=None,
              ll_atol: float = 2e-3) -> Held:
    """Two full runs of one batch, each a path (R, T) and a rescore (R, L, 4)
    of that path: the paths by the run rule (at most ``max_ties`` differing
    live samples), the rescores within ``ll_atol`` at every position of
    ``compare`` (all, when None) whose window touches no segment bound that
    the paths place differently; the positions that the ties leave out are
    counted. Rows from ``n_reads`` on are padding and take no part."""
    path_a, path_b = _t(path_a), _t(path_b).to(_t(path_a).device)
    ll_a, ll_b = _t(ll_a), _t(ll_b).to(_t(ll_a).device)
    t_len = _t(t_len).to(path_a.device)
    mu, sigma = _t(mu).to(path_a.device), _t(sigma).to(path_a.device)
    R, T = path_a.shape
    L, N = ll_a.shape[1], mu.shape[1]
    n = R if n_reads is None else n_reads
    live = live_mask(t_len, T, n)
    ties = run_tie_differences(tag, path_a, path_b, live, mu, sigma, max_ties)
    keep = loglik_compare_mask(path_a, path_b, t_len, N, L, k).to(ll_a.device)
    base = torch.ones_like(keep) if compare is None else _t(compare).to(keep.device)
    base = base.clone()
    base[n:] = False
    cmp = base & keep
    err = (ll_a[cmp] - ll_b[cmp]).abs()
    worst = float(err.max()) if err.numel() else 0.0
    assert worst <= ll_atol, (
        f"{tag}: rescore differs by {worst} at a position no tie explains "
        f"(limit {ll_atol})")
    return Held(tie_differences=ties["differing"], tie_reads=ties["reads"],
                max_gap=ties["max_gap"], excluded_positions=int((base & ~keep).sum()),
                compared_positions=int(cmp.sum()), ll_max_abs_diff=worst)


def calls_of(batches, lls, codes, contig, cfg, min_coverage: int, votes: bool = True):
    """The calls of one contig's batches (their rescores ``lls``, any
    device): the accumulators of ``call.accumulate_batch``, then
    ``call.call_snps``, with the per-read votes or without."""
    dev = lls[0].device
    acc, cov, *v = callmod.make_accumulators(len(codes), with_votes=votes, device=dev)
    for batch, ll in zip(batches, lls):
        assert set(batch.contigs[:batch.n_reads]) <= {contig}, batch.contigs
        n = batch.n_reads
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a[:n])).to(dev)
        acc, cov, *v = callmod.accumulate_batch(
            acc, cov, ll[:n], put(batch.window_start), put(batch.window_len),
            put(batch.strand), votes=v[0] if votes else None, cfg=cfg)
    return callmod.call_snps(acc.cpu().numpy(), cov.cpu().numpy(), codes, contig, cfg,
                             min_coverage=min_coverage,
                             votes=v[0].cpu().numpy() if votes else None)


def call_keys(calls) -> list:
    return [(c.contig, c.position, c.ref_base, c.alt_base, c.coverage) for c in calls]


def masked_like_tables(ll, ll_tables) -> torch.Tensor:
    """``ll`` with the positions the tables path masks set to 0: those the
    tables rescore left exactly 0 on all four bases (the outer k-1 positions
    of each read's window, k-mers invalid in the genome, the span rule)."""
    ll, ll_tables = _t(ll), _t(ll_tables).to(_t(ll).device)
    return torch.where((ll_tables == 0).all(dim=2, keepdim=True), torch.zeros_like(ll), ll)


def kernels_against_scan(tag, batches, model, cfg, genome, device, max_ties,
                         codes=None, contig: str = "ref", min_coverage: int = 1,
                         votes: bool = True) -> dict:
    """Batches through the kernels with genome tables, as ``api.call_snps``
    runs them, and through the ``scan`` twin, both on ``device`` (on the CPU
    the kernels' plain versions run): the paths by the run rule (at most
    ``max_ties`` differing live samples over all batches; a callable
    ``max_ties(batch, kernel_path, twin_path)`` gives each batch's limit),
    the rescores within 2e-3 where the kernels score as the twin does
    (:func:`kernel_compare_mask`) and no tie moved a window, and, given the
    ``codes`` of the one contig the batches hold, the calls equal once the
    twin's rescore is masked as the tables path masks it. Returns the counts,
    the calls and the kernels' outputs (``runs``)."""
    tables = build_subst_tables(genome, model, device=device)
    ties = excluded = compared = 0
    worst = 0.0
    kern_ll, scan_ll, runs = [], [], []
    for batch in batches:
        kern = pipeline.align_batch(batch, model, cfg, backend="cuda", device=device,
                                    subst=tables)
        scan = pipeline.align_batch(batch, model, cfg, backend="scan", device=device)
        compare = kernel_compare_mask(kern["path"], batch.t_len, batch.window_len,
                                      batch.codes.shape[1], batch.ids.shape[1], model.k,
                                      tables=True)
        limit = (max_ties(batch, kern["path"], scan["path"]) if callable(max_ties)
                 else max_ties - ties)
        held = hold_runs(tag, kern["path"], kern["base_loglik"], scan["path"],
                         scan["base_loglik"], batch.t_len, batch.mu, batch.sigma, model.k,
                         limit, n_reads=batch.n_reads, compare=compare)
        ties += held.tie_differences
        excluded += held.excluded_positions
        compared += held.compared_positions
        worst = max(worst, held.ll_max_abs_diff)
        kern_ll.append(kern["base_loglik"])
        scan_ll.append(masked_like_tables(scan["base_loglik"], kern["base_loglik"]))
        runs.append(kern)
    calls = None
    if codes is not None:
        calls = calls_of(batches, kern_ll, codes, contig, cfg, min_coverage, votes)
        want = calls_of(batches, scan_ll, codes, contig, cfg, min_coverage, votes)
        assert call_keys(calls) == call_keys(want), (tag, call_keys(calls), call_keys(want))
        np.testing.assert_allclose([c.probability for c in calls],
                                   [c.probability for c in want], atol=1e-5, err_msg=tag)
    return {"tie_differences": ties, "excluded_positions": excluded,
            "compared_positions": compared, "ll_max_abs_diff": worst,
            "calls": calls, "runs": runs}


def hold_against_scan(tag, batch, a, path, base_ll, model, cfg, ll_atol,
                      tie_share: float = 1e-4) -> dict:
    """The ``scan`` twin against the kernels on one staged batch, on the
    device of ``path`` (the card, in ``chip_smoke.py`` and the card tests):
    its Viterbi differs from the kernels' on broken ties only (the near
    rule), and its local rescore of the kernels' path agrees with the kernels' rescore (genome
    tables) on interior positions, within ``ll_atol`` (the table path masks
    read-local edges to exactly 0, by design, and the span rule positions
    whose window starts 2048 samples or more past their tile's slab base).
    At most ``tie_share`` of the live samples may differ, each by a tie.
    Returns the counts, and the compared positions' mask as ``cmp``."""
    dev = path.device
    n, T = batch.n_reads, batch.x.shape[1]
    L, k = batch.codes.shape[1], cfg.k
    scan = pipeline.align_batch(batch, model, dataclasses.replace(cfg, snp_rescore="fixed"),
                                backend="scan", device=dev)
    live = live_mask(a["t_len"], T, n)
    n_tie = tie_only_differences(tag, path, scan["path"], live, a["mu"], a["sigma"],
                                 max_share=tie_share)
    del scan
    twin_ll = banded_dp.base_loglik_local_batch(
        a["x"], path, a["t_len"], a["codes"], a["ids"], a["lm"], a["ls"], k, cfg,
        t_w=cfg.snp_local_window)
    interior = interior_mask(path, a["t_len"], batch.window_len, L, k)
    interior[n:] = False
    # positions the span rule masks are 0 on the kernel side only
    span_ok = span_mask(path, a["t_len"], L, batch.ids.shape[1], k)
    cmp = interior & span_ok
    n_win = int(batch.window_len[:n].sum())
    assert int(cmp.sum()) > 0.8 * n_win, (tag, int(cmp.sum()), n_win)
    # table constants are made with numpy's log on the host, the twin's with
    # torch.log on the card: last-bit differences summed over <= 192 steps
    torch.testing.assert_close(base_ll[cmp], twin_ll[cmp], rtol=1e-5, atol=ll_atol)
    i_idx = torch.arange(L, device=dev)[None, :]
    edge = ~interior & (i_idx < path[:, :1].long() + k - 1)
    assert bool((base_ll[edge] == 0).all()), f"{tag}: read-local edges must be exactly 0"
    return {"tie_differences": n_tie, "live_samples": int(live.sum()),
            "interior_positions": int(cmp.sum()),
            "span_masked_interior_positions": int((interior & ~span_ok).sum()),
            "ll_max_abs_diff": float((base_ll[cmp] - twin_ll[cmp]).abs().max()),
            "cmp": cmp}
