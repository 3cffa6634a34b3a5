"""The comparison of two alignments of one batch
(``nadavca_tpu_torch.utils.parity``), on the CPU: the near rule and the run
rule for ties, the segment bounds and the positions a moved bound leaves out
of the rescore comparison, and the card checks' helpers run on the CPU,
where the kernels' plain versions stand in for the kernels.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu_torch import pipeline
from nadavca_tpu_torch.ops import cuda_dp, cuda_rescore
from nadavca_tpu_torch.ops.subst_tables import build_subst_tables
from nadavca_tpu_torch.utils import parity, worlds

K = 6


def _levels():
    """One row of 40 positions: distinct levels, but positions 10–11 a
    homopolymer pair and 20–27 a run of 8 (level 0, spread 1, an N run)."""
    mu = torch.arange(40, dtype=torch.float32)[None, :] * 0.1
    sigma = torch.full((1, 40), 0.2)
    mu[0, 11] = mu[0, 10]
    mu[0, 20:28], sigma[0, 20:28] = 0.0, 1.0
    return mu, sigma


def _path():
    return torch.repeat_interleave(torch.arange(40, dtype=torch.int32), 3)[None, :]


def test_the_run_rule_takes_ties_along_a_run_of_any_length():
    mu, sigma = _levels()
    a = _path()
    b = a.clone()
    b[0, 31] = 11                       # homopolymer pair, one apart
    b[0, 62:70] = 26                    # inside the N run, up to 6 apart
    live = torch.ones_like(a, dtype=torch.bool)
    got = parity.run_tie_differences("t", a, b, live, mu, sigma, max_count=9)
    assert got == {"differing": 9, "reads": 1, "max_gap": 6}
    # the near rule takes the pair but not the run
    assert parity.tie_only_differences("t", a, b.where(b != 26, a), live, mu, sigma,
                                       max_share=1.0) == 1
    with pytest.raises(AssertionError, match="not ties between"):
        parity.tie_only_differences("t", a, b, live, mu, sigma, max_share=1.0)
    with pytest.raises(AssertionError, match="limit 8"):
        parity.run_tie_differences("t", a, b, live, mu, sigma, max_count=8)


def test_the_run_rule_names_the_read_and_the_sample_of_a_fault():
    mu, sigma = _levels()
    a = _path()
    b = a.clone()
    b[0, 50] = 18                       # 16 against 18: different levels
    live = torch.ones_like(a, dtype=torch.bool)
    with pytest.raises(AssertionError, match="read 0 sample 50 .16 against 18."):
        parity.run_tie_differences("t", a, b, live, mu, sigma, max_count=10)
    # a run ends where its level does: 27 against 28 is no tie
    b = a.clone()
    b[0, 84] = 27
    with pytest.raises(AssertionError, match="sample 84"):
        parity.run_tie_differences("t", a, b, live, mu, sigma, max_count=10)
    # a dead sample is not compared
    live[0, 84] = False
    assert parity.run_tie_differences("t", a, b, live, mu, sigma, 0)["differing"] == 0


def test_levels_are_compared_bit_for_bit():
    mu = torch.tensor([[0.0, -0.0, 1.0]])
    sigma = torch.ones((1, 3))
    assert parity.level_runs(mu, sigma).tolist() == [[1, 2, 3]]


def test_segment_counts_are_the_bounds_of_the_path():
    rng = np.random.default_rng(1)
    path = np.sort(rng.integers(0, 30, (3, 50)), axis=1).astype(np.int32)
    t_len = np.array([50, 20, 1], np.int32)
    got = parity.segment_counts(path, t_len, 30).numpy()
    for r in range(3):
        want = [(path[r, :t_len[r]] < i).sum() for i in range(31)]
        np.testing.assert_array_equal(got[r], want)


def test_a_moved_bound_leaves_out_the_windows_that_touch_it():
    a = _path()
    b = a.clone()
    b[0, 33] = 10                       # C[11] moves from 33 to 34
    t_len = torch.tensor([120])
    keep = parity.loglik_compare_mask(a, b, t_len, 40, 48, K)[0]
    out = torch.nonzero(~keep)[:, 0].tolist()
    # position i's window is bounded by C[i-k+1] .. C[i+k]
    assert out == list(range(11 - K, 11 + K))
    ll_a = torch.zeros((1, 48, 4))
    ll_b = ll_a.clone()
    ll_b[0, 8, 2] = 20.0                # next to the tie: left out and counted
    mu, sigma = _levels()
    held = parity.hold_runs("t", a, ll_a, b, ll_b, t_len, mu, sigma, K, max_ties=1)
    assert (held.tie_differences, held.excluded_positions) == (1, 2 * K)
    assert held.compared_positions == 48 - 2 * K and held.ll_max_abs_diff == 0.0
    ll_b[0, 30, 1] = 3e-3               # where no tie explains it
    with pytest.raises(AssertionError, match="no tie explains"):
        parity.hold_runs("t", a, ll_a, b, ll_b, t_len, mu, sigma, K, max_ties=1)


@pytest.mark.parametrize("name", ["one_read", "narrow_window"])
def test_kernels_against_scan_on_the_cpu(name):
    """The card check of ``chip_smoke.py``'s ``reference_worlds`` phase with
    the plain versions: worlds 2 and 3 without a tie, the calls equal."""
    build, limit = worlds.CARD_WORLDS[name]
    w = build()
    got = parity.kernels_against_scan(name, w["batches"], w["model"], w["cfg"], w["genome"],
                                      "cpu", limit, codes=w["codes"],
                                      min_coverage=w["min_coverage"], votes=w["votes"])
    assert got["tie_differences"] == got["excluded_positions"] == 0
    assert got["compared_positions"] > 40 and len(got["runs"]) == 1


def test_hold_against_scan_on_the_cpu():
    """The near rule's check of one staged batch (the main path's and the
    long batch's), on the CPU: the one-read world."""
    w = worlds.one_read()
    (batch,) = w["batches"]
    model, cfg = w["model"], w["cfg"]
    tables = build_subst_tables(w["genome"], model, device="cpu")
    a = pipeline.stage_batch(batch, model, cfg, "cuda", device="cpu", subst=tables)
    res, _ = cuda_dp.cuda_viterbi_batch(
        a["x"], a["t_len"], a["mu"], a["sigma"], a["n_ref"], a["lo"], a["delta"], cfg,
        count_lanes=cuda_rescore.count_lanes(batch.ids.shape[1]))
    ll = cuda_rescore.base_loglik_local_cuda(
        a["x"], res.path, a["t_len"], a["codes"], a["ids"], a["lm"], a["ls"], cfg.k, cfg,
        t_w=cfg.snp_local_window, tables=tables, window_off=a["woff"], cnt=res.counts,
        window_off_range=a["woff_range"])
    got = parity.hold_against_scan("one read", batch, a, res.path, ll, model, cfg,
                                   ll_atol=2e-3)
    assert got["tie_differences"] == 0 and got["interior_positions"] > 150


def test_span_mask_is_the_kernels_span_rule():
    """``parity.span_mask`` from the path's own segment counts keeps exactly
    the positions the rescore's span rule keeps (``cuda_rescore.span_ok`` of
    the windows ``local_windows`` gives), on a batch of 5632 samples."""
    w = worlds.indel_calls()
    (batch,) = w["batches"]
    out = pipeline.align_batch(batch, w["model"], w["cfg"], backend="cuda", device="cpu",
                               rescore=False)
    t_len = torch.from_numpy(batch.t_len)
    codes = torch.from_numpy(batch.codes)
    N, k, T = batch.ids.shape[1], w["model"].k, batch.x.shape[1]
    S = cuda_rescore.local_windows(out["path"], t_len, codes, N, k, 192)[0]
    want = cuda_rescore.span_ok(S.clamp(0, T - 1), T)
    got = parity.span_mask(out["path"], t_len, codes.shape[1], N, k)
    assert T >= 2304 and not bool(want.all())
    assert torch.equal(got, want)
