"""The port's float64 oracle ``ops/dp_spec`` against the JAX package's, and
the port's ``scan`` twin and its kernels' plain versions against that oracle.

Both oracles are numpy float64 with the same operations, so their outputs
must be equal exactly. The cases are ``tests/test_dp_spec.py``'s; the
oracle is also held against a brute-force unbanded DP written here. The
batched backends are held to it as ``tests/test_banded_dp_jax.py`` holds the
JAX ones: paths equal, scores within 2e-3, the fixed-path statistics and
base log-likelihoods within that file's tolerances.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.config import AlignConfig as JaxConfig
from nadavca_tpu.ops import dp_spec as jspec

from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.genome import kmer_ids
from nadavca_tpu_torch.io.simulator import random_genome, simulate_read, simulate_squiggle
from nadavca_tpu_torch.kmer_model import default_model
from nadavca_tpu_torch.ops import banded_dp, cuda_dp, dp_spec
from nadavca_tpu_torch.sched.bands import build_chunked_bands

# scores: ``scripts/tpu_smoke.py``'s ``compare`` tolerance
SCORE_TOL = dict(rtol=2e-3, atol=2e-3)


def _cfgs(**kw):
    return AlignConfig(**kw), JaxConfig(**kw)


def brute_force_viterbi(x, mu, sigma, cfg):
    """Independent O(T*N) unbanded Viterbi with the same transition model."""
    T, N = len(x), len(mu)
    V = np.full((T, N), dp_spec.NEG_INF)
    back = np.zeros((T, N), dtype=np.int64)
    emit = dp_spec.gaussian_logpdf(x[:, None], mu[None, :], sigma[None, :])
    V[0] = emit[0]
    for t in range(1, T):
        for i in range(N):
            best, adv = V[t - 1, i] + cfg.log_p_stay, 0
            if i >= 1 and V[t - 1, i - 1] + cfg.log_p_move > best:
                best, adv = V[t - 1, i - 1] + cfg.log_p_move, 1
            if cfg.use_skip and i >= 2 and V[t - 1, i - 2] + cfg.log_p_skip > best:
                best, adv = V[t - 1, i - 2] + cfg.log_p_skip, 2
            V[t, i] = emit[t, i] + best
            back[t, i] = adv
    i = int(np.argmax(V[T - 1]))
    score = float(V[T - 1, i])
    path = np.zeros(T, dtype=np.int64)
    path[T - 1] = i
    for t in range(T - 1, 0, -1):
        i -= back[t, i]
        path[t - 1] = i
    return score, path


def _squiggle(seed, length, **kw):
    rng = np.random.default_rng(seed)
    model = default_model()
    window = random_genome(rng, length=length)["ref"].codes
    x, true_path = simulate_squiggle(window, model, rng, **kw)
    mu, sigma = model.expected_signal(window)
    return model, window, x, true_path, mu.astype(np.float64), sigma.astype(np.float64)


@pytest.mark.parametrize("use_skip", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_banded_viterbi_equals_the_jax_oracle_and_brute_force(seed, use_skip):
    """The band covers the whole reference (N < band_width): banded equals
    unbanded, and both oracles give the same score and path, bit for bit."""
    _, _, x, _, mu, sigma = _squiggle(seed, 80, mean_dwell=6.0)
    cfg, jcfg = _cfgs(band_width=128, use_skip=use_skip,
                      log_p_skip=-4.0 if use_skip else -1e30)
    lo = dp_spec.make_band(np.zeros(len(x)), len(mu), cfg.band_width)
    np.testing.assert_array_equal(lo, jspec.make_band(np.zeros(len(x)), len(mu), 128))
    score, path = dp_spec.banded_viterbi(x, mu, sigma, lo, cfg)
    j_score, j_path = jspec.banded_viterbi(x, mu, sigma, lo, jcfg)
    assert score == j_score
    np.testing.assert_array_equal(path, j_path)
    score_f, path_f = brute_force_viterbi(x, mu, sigma, cfg)
    assert np.isclose(score, score_f, rtol=1e-12)
    np.testing.assert_array_equal(path, path_f)


def test_a_narrow_band_from_the_true_path_equals_the_jax_oracle():
    """400 positions under a band of 128 that follows the true path: the same
    band, score, path, segments and statistics in both packages, and the
    path close to the truth at low noise."""
    _, _, x, true_path, mu, sigma = _squiggle(7, 400, mean_dwell=9.0, noise_scale=0.5)
    cfg, jcfg = _cfgs(band_width=128)
    anchor = true_path.astype(np.float64)
    lo = dp_spec.make_band(anchor, len(mu), 128)
    np.testing.assert_array_equal(lo, jspec.make_band(anchor, len(mu), 128))
    score, path = dp_spec.banded_viterbi(x, mu, sigma, lo, cfg)
    j_score, j_path = jspec.banded_viterbi(x, mu, sigma, lo, jcfg)
    assert score == j_score
    np.testing.assert_array_equal(path, j_path)
    assert np.mean(np.abs(path - true_path) <= 2) > 0.95
    for a, b in zip(dp_spec.path_segments(path, len(mu)), jspec.path_segments(path, len(mu))):
        np.testing.assert_array_equal(a, b)
    stats = dp_spec.segment_stats(path, x, len(mu))
    np.testing.assert_array_equal(stats, jspec.segment_stats(path, x, len(mu)))
    np.testing.assert_array_equal(dp_spec.gaussian_segment_loglik(stats, mu, sigma),
                                  jspec.gaussian_segment_loglik(stats, mu, sigma))


def test_segments_and_closed_forms():
    """``tests/test_dp_spec.py``'s hand cases, on the port's oracle."""
    start, end = dp_spec.path_segments(np.array([0, 0, 1, 1, 1, 3, 3, 4]), 6)
    np.testing.assert_array_equal(start, [0, 2, -1, 5, 7, -1])
    np.testing.assert_array_equal(end, [2, 5, -1, 7, 8, -1])
    rng = np.random.default_rng(3)
    x = rng.normal(size=50)
    path = np.sort(rng.integers(0, 10, size=50))
    stats = dp_spec.segment_stats(path, x, 10)
    for i in range(10):
        sel = x[path == i]
        np.testing.assert_allclose(stats[i], [len(sel), sel.sum(), (sel ** 2).sum()])
    xs = np.random.default_rng(4).normal(size=20)
    st = np.array([len(xs), xs.sum(), (xs ** 2).sum()])
    assert np.isclose(dp_spec.gaussian_logpdf(xs, 0.3, 0.7).sum(),
                      dp_spec.gaussian_segment_loglik(st, 0.3, 0.7), rtol=1e-12)
    assert dp_spec.DEC_STAY == 0 and dp_spec.DEC_MOVE == 1
    assert (dp_spec.DEC_SKIP, dp_spec.DEC_START) == (2, 3)


def test_base_loglik_fixed_and_local_equal_the_jax_oracle():
    """A planted substitution: the signal of the original base against a
    mutated window. Both rescoring forms vote for the original base, and
    each equals the JAX oracle's result bit for bit."""
    model, window, x, true_path, _, _ = _squiggle(13, 200, mean_dwell=10.0,
                                                   noise_scale=0.7)
    pos = 100
    true_base = int(window[pos])
    mutated = window.copy()
    mutated[pos] = (true_base + 1) % 4
    anchor = true_path.astype(np.float64)
    res = dp_spec.full_read_spec(x, mutated, model, anchor=anchor)
    jres = jspec.full_read_spec(x, mutated, model, anchor=anchor)
    assert res.keys() == jres.keys()
    for k in res:
        np.testing.assert_array_equal(res[k], jres[k], err_msg=k)
    ll = res["base_loglik"]
    assert int(np.argmax(ll[pos])) == true_base
    assert ll[pos, true_base] - ll[pos, (true_base + 1) % 4] > 2.0
    lm, ls = model.level_mean.astype(np.float64), model.level_std.astype(np.float64)
    cfg, jcfg = _cfgs()
    local = dp_spec.base_substitution_loglik_local(mutated, res["path"], x, lm, ls,
                                                   model.k, cfg, max_window=192)
    np.testing.assert_array_equal(local, jspec.base_substitution_loglik_local(
        mutated, res["path"], x, lm, ls, model.k, jcfg, max_window=192))
    assert int(np.argmax(local[pos])) == true_base


@pytest.fixture(scope="module")
def sim():
    """``tests/test_banded_dp_jax.py``'s world: 4 reads of 150-300 bases,
    padded into one batch, chunked bands of 128 samples from the true path."""
    rng = np.random.default_rng(42)
    model = default_model()
    genome = random_genome(rng, length=2000)
    reads = [simulate_read(genome, "ref", model, rng, read_len=ln, strand=1,
                           mean_dwell=8.0) for ln in (150, 300, 220, 180)]
    R = len(reads)
    T = 128 * -(-max(len(r.signal) for r in reads) // 128)
    L = max(len(r.window_codes) for r in reads)
    N = L - model.k + 1
    x = np.zeros((R, T), np.float32)
    t_len = np.zeros(R, np.int32)
    mu = np.zeros((R, N), np.float32)
    sigma = np.ones((R, N), np.float32)
    n_ref = np.zeros(R, np.int32)
    anchors = np.zeros((R, T), np.float64)
    codes = np.full((R, L), 4, np.int32)
    ids = np.full((R, N), -1, np.int32)
    for r, rd in enumerate(reads):
        t = len(rd.signal)
        x[r, :t] = rd.signal
        t_len[r] = t
        m, s = model.expected_signal(rd.window_codes)
        mu[r, :len(m)], sigma[r, :len(m)], n_ref[r] = m, s, len(m)
        anchors[r, :t] = rd.true_path
        anchors[r, t:] = rd.true_path[-1]
        codes[r, :len(rd.window_codes)] = rd.window_codes
        ids[r, :len(m)] = kmer_ids(rd.window_codes, model.k)
    bands = build_chunked_bands(anchors, t_len, n_ref, 128, 128)
    arrays = dict(x=x, t_len=t_len, mu=mu, sigma=sigma, n_ref=n_ref,
                  lo=bands.lo, delta=bands.delta, lo_t=bands.expand(T),
                  codes=codes, ids=ids)
    return model, reads, arrays, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def _oracle(model, rd, lo_t, cfg):
    """The oracle on one read of the batch, under the batch's band."""
    mu, sigma = model.expected_signal(rd.window_codes)
    t = len(rd.signal)
    score, path = dp_spec.banded_viterbi(rd.signal, mu.astype(np.float64),
                                         sigma.astype(np.float64), lo_t[:t], cfg)
    return score, path, dp_spec.segment_stats(path, rd.signal, len(mu))


def test_make_band_batch_equals_the_oracles_band_per_row(sim):
    model, reads, a, _ = sim
    anchors = np.zeros(a["x"].shape, np.float64)
    for r, rd in enumerate(reads):
        t = len(rd.signal)
        anchors[r, :t] = rd.true_path
        anchors[r, t:] = rd.true_path[-1]
    lo = dp_spec.make_band_batch(anchors, a["t_len"], a["n_ref"], 128)
    assert lo.dtype == np.int32 and lo.shape == a["x"].shape
    for r, rd in enumerate(reads):
        t = len(rd.signal)
        np.testing.assert_array_equal(
            lo[r, :t], dp_spec.make_band(rd.true_path.astype(np.float64),
                                         int(a["n_ref"][r]), 128))
        assert (lo[r, t:] == lo[r, t - 1]).all()


@pytest.mark.parametrize("backend", ["scan", "plain_kernels"])
@pytest.mark.parametrize("use_skip", [False, True], ids=["no_skip", "skip"])
def test_batched_backends_match_the_oracle(sim, backend, use_skip):
    """The ``scan`` twin (per-sample band) and the kernels' plain versions
    (chunked band) against the oracle on every read: paths equal, scores
    within 2e-3; without skip also the fixed-path statistics and base
    log-likelihoods (calls equal)."""
    model, reads, a, t = sim
    cfg = AlignConfig(band_width=128, use_skip=use_skip,
                      log_p_skip=-4.0 if use_skip else -1e30)
    if backend == "scan":
        res = banded_dp.banded_viterbi_batch(t["x"], t["t_len"], t["mu"], t["sigma"],
                                             t["n_ref"], t["lo_t"], cfg)
    else:
        res, _ = cuda_dp.cuda_viterbi_batch(t["x"], t["t_len"], t["mu"], t["sigma"],
                                            t["n_ref"], t["lo"], t["delta"], cfg)
    N = a["mu"].shape[1]
    stats = banded_dp.segment_stats_batch(res.path, t["x"], t["t_len"], N)
    ll = banded_dp.base_loglik_batch(t["codes"], t["ids"], stats,
                                     torch.from_numpy(model.level_mean),
                                     torch.from_numpy(model.level_std), model.k)
    for r, rd in enumerate(reads):
        n_t = len(rd.signal)
        score, path, spec_stats = _oracle(model, rd, a["lo_t"][r], cfg)
        np.testing.assert_array_equal(res.path[r, :n_t].numpy(), path,
                                      err_msg=f"read {r}")
        np.testing.assert_allclose(float(res.score[r]), score, **SCORE_TOL,
                                   err_msg=f"read {r}")
        if use_skip:
            continue
        n = int(a["n_ref"][r])
        np.testing.assert_allclose(stats[r, :n].numpy(), spec_stats, rtol=1e-4, atol=1e-3)
        assert float(stats[r, n:, 0].sum()) == 0
        want = dp_spec.base_substitution_loglik(
            rd.window_codes, spec_stats, model.level_mean.astype(np.float64),
            model.level_std.astype(np.float64), model.k)
        got = ll[r, :len(rd.window_codes)].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-2)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))

