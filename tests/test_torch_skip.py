"""The skip transition, the two-sample fill and pinned ends: port vs JAX package.

The same numpy inputs (seeded) go through the JAX functions — the Pallas
kernels in interpret mode, the ``scan`` backend, the float64 spec — and
through ``nadavca_tpu_torch`` on CPU tensors, where each kernel wrapper runs
its plain version. The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_card.py``.

The fixture is the one of ``tests/test_skip_parity.py`` (seed 123, 8 reads
simulated with pore skips), so the recovered paths hold advance-by-2 steps;
that is asserted, to keep the comparisons from being vacuous. It runs at two
chunk sizes. The interpret-mode compile of the TPU's two-plane walk unrolls
32 steps for each of a chunk's words and takes about four minutes on a CPU at
four words per chunk (``signal_chunk=128``), whatever the batch; at one word
per chunk it takes seconds. So ``pallas_viterbi_batch(interpret=True)`` as a
whole, its walk included, runs at ``signal_chunk=32``; at ``signal_chunk=128``
the Pallas gather and fill run in interpret mode and the JAX path comes from
``backtrack_from_bits``, which ``tests/test_skip_parity.py`` holds equal to
the Pallas walk.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import nadavca_tpu
from nadavca_tpu import api as japi
from nadavca_tpu import call as jcall
from nadavca_tpu import pipeline as jpipe
from nadavca_tpu.config import AlignConfig as JaxConfig
from nadavca_tpu.genome import kmer_ids
from nadavca_tpu.io import fast5 as jfast5
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.ops import banded_dp as jdp
from nadavca_tpu.ops import dp_spec, pallas_dp, pallas_rescore
from nadavca_tpu.sched import build_chunked_bands

import nadavca_tpu_torch
from nadavca_tpu_torch import api as tapi
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.ops import banded_dp as tdp
from nadavca_tpu_torch.ops import cuda_dp, cuda_rescore

# kernel_unroll=1 only shortens the interpret-mode compile of the TPU kernels;
# their arithmetic is the same
SKIP = dict(band_width=128, signal_chunk=128, read_tile=8, use_skip=True,
            log_p_skip=-4.6)
JCFG = JaxConfig(kernel_unroll=1, **SKIP)
TCFG = AlignConfig(**SKIP)
C = 128
SKIP_LENS = (200, 350, 260, 150, 300, 180, 220, 330)


def _simulate(seed, lens, skip_prob, mean_dwell=6.0, chunk=C):
    rng = np.random.default_rng(seed)
    model = default_model()
    genome = random_genome(rng, length=3000)
    reads = [simulate_read(genome, "ref", model, rng, read_len=ln, strand=1,
                           mean_dwell=mean_dwell, skip_prob=skip_prob)
             for ln in lens]
    R = len(reads)
    T = C * ((max(len(r.signal) for r in reads) + C - 1) // C)
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
    true_paths = np.zeros((R, T), np.int32)
    for r, rd in enumerate(reads):
        t = len(rd.signal)
        x[r, :t] = rd.signal
        t_len[r] = t
        m, s = model.expected_signal(rd.window_codes)
        mu[r, : len(m)] = m
        sigma[r, : len(m)] = s
        n_ref[r] = len(m)
        anchors[r, :t] = rd.true_path
        anchors[r, t:] = rd.true_path[-1]
        codes[r, : len(rd.window_codes)] = rd.window_codes
        ids[r, : len(m)] = kmer_ids(rd.window_codes, model.k)
        true_paths[r, :t] = rd.true_path
        true_paths[r, t:] = rd.true_path[-1]
    bands = build_chunked_bands(anchors, t_len, n_ref, 128, chunk)
    b = dict(x=x, t_len=t_len, mu=mu, sigma=sigma, n_ref=n_ref, lo=bands.lo,
             delta=bands.delta, codes=codes, ids=ids, true_path=true_paths)
    return dict(np=b, bands=bands, reads=reads, model=model,
                j={k: jnp.asarray(v) for k, v in b.items()},
                t={k: torch.from_numpy(v.copy()) for k, v in b.items()})


def _dp_args(d):
    return [d[k] for k in ("x", "t_len", "mu", "sigma", "n_ref", "lo", "delta")]


def _n_skips(path, t_len):
    return sum(int(np.sum(np.diff(path[r, : int(t_len[r])]) == 2))
               for r in range(len(t_len)))


def _tie_bits(diff, mu_b, sg_b, chunk=C):
    """Number of differing decision bits, after checking that each sits on a
    cell j where two of the slots j, j-1, j-2 have identical levels (adjacent
    window positions with the same k-mer: a homopolymer run). There two of the
    stay / move / skip candidates tie in exact arithmetic, and XLA's CPU
    compiler, which contracts ``em_const - d*d*inv2v`` into a fused
    multiply-add, breaks the tie by a last bit that eager PyTorch (and the
    CUDA kernel, built with -fmad=false) does not have."""
    ws, rs, js = np.nonzero(diff)
    for w, r, jj in zip(ws, rs, js):
        c = (32 * w) // chunk
        lv = [(mu_b[c, r, jj - d], sg_b[c, r, jj - d]) for d in range(3) if jj >= d]
        assert len(set(lv)) < len(lv), (w, r, jj, lv)
    return sum(bin(int(np.uint32(d))).count("1") for d in diff[ws, rs, js])


@pytest.fixture(scope="module", params=[128, 32], ids=["chunk128", "chunk32"])
def skip_case(request):
    chunk = request.param
    d = _simulate(123, SKIP_LENS, skip_prob=0.08, chunk=chunk)
    jcfg = dataclasses.replace(JCFG, signal_chunk=chunk)
    tcfg = dataclasses.replace(TCFG, signal_chunk=chunk)
    j = d["j"]
    if chunk == 32:
        # the JAX side as a whole: gather -> skip fill -> score -> Pallas walk
        res, decs = pallas_dp.pallas_viterbi_batch(*_dp_args(j), jcfg,
                                                   interpret=True)
        path, score, final_j = res.path, res.score, res.final_j
    else:
        # the same steps with the walk of backtrack_from_bits (module docstring)
        R, n_chunks = d["np"]["lo"].shape
        mu_b, sg_b = pallas_dp.band_gather_pallas(j["mu"], j["sigma"], j["lo"],
                                                  128, interpret=True)
        decs, v_fin, acc = pallas_dp.viterbi_fill_pallas(
            j["x"], j["t_len"], mu_b, sg_b, j["lo"].T.reshape(n_chunks, R, 1),
            j["delta"].T.reshape(n_chunks, R, 1), j["n_ref"], jcfg,
            interpret=True)
        i_fin = j["lo"][:, -1][:, None] + jnp.arange(128, dtype=jnp.int32)[None, :]
        v_valid = jnp.where(i_fin < j["n_ref"][:, None], v_fin, jdp.NEG_INF)
        final_j = jnp.argmax(v_valid, axis=1).astype(jnp.int32)
        score = acc + jnp.take_along_axis(v_valid, final_j[:, None], axis=1)[:, 0]
        path = pallas_dp.backtrack_from_bits(decs, j["lo"], j["delta"], final_j,
                                             chunk_size=chunk)
    assert len(decs) == 2
    d.update(chunk=chunk, jcfg=jcfg, tcfg=tcfg,
             jdecs=[np.array(p) for p in decs], jpath=np.array(path),
             jscore=np.array(score), jfinal=np.array(final_j))
    # the port once, on CPU tensors: the plain versions
    tres, tdecs = cuda_dp.cuda_viterbi_batch(*_dp_args(d["t"]), tcfg)
    d.update(tres=tres, tdecs=tdecs)
    return d


@pytest.fixture(scope="module")
def skip_world():
    """The same reads without any alignment: inputs of the rescore tests."""
    return _simulate(123, SKIP_LENS, skip_prob=0.08)


def test_skip_fill_planes_match_pallas(skip_case):
    d = skip_case
    assert len(d["tdecs"]) == 2
    mu_b, sg_b = (a.numpy() for a in cuda_dp.band_gather_plain(
        d["t"]["mu"], d["t"]["sigma"], d["t"]["lo"], 128))
    n_bits = 0
    for plane in range(2):
        got = d["tdecs"][plane].numpy()
        assert got.shape == d["jdecs"][plane].shape and got.dtype == np.int32
        # word for word, but for broken ties
        n_bits += _tie_bits(got ^ d["jdecs"][plane], mu_b, sg_b, d["chunk"])
    assert n_bits <= 1e-5 * d["jdecs"][0].size * 32, n_bits
    # advance 1 or advance 2, never both
    assert not (d["tdecs"][0] & d["tdecs"][1]).any()
    assert d["tdecs"][1].any()


def test_skip_paths_and_scores_match_pallas(skip_case):
    d = skip_case
    t_len = d["np"]["t_len"]
    np.testing.assert_array_equal(d["tres"].final_j.numpy(), d["jfinal"])
    # the same operations; XLA may fuse a multiply-add, and the logs differ in
    # the last bit: rounding adds up over a chunk of 128 steps
    np.testing.assert_allclose(d["tres"].score.numpy(), d["jscore"],
                               rtol=1e-5, atol=2e-3)
    for r in range(len(t_len)):
        n = int(t_len[r])
        np.testing.assert_array_equal(d["tres"].path[r, :n].numpy(),
                                      d["jpath"][r, :n])
    assert _n_skips(d["tres"].path.numpy(), t_len) > 0


def test_backtrack_two_planes_matches_pallas(skip_case):
    d = skip_case
    # the Pallas side's planes and final slots go in, its path must come out:
    # an integer walk over the same bits, exact, padding samples included
    path = cuda_dp.backtrack(
        tuple(torch.from_numpy(p) for p in d["jdecs"]), d["t"]["lo"],
        d["t"]["delta"], torch.from_numpy(d["jfinal"].astype(np.int32)),
        d["chunk"])
    np.testing.assert_array_equal(path.numpy(), d["jpath"])
    assert _n_skips(path.numpy(), d["np"]["t_len"]) > 0


def test_scan_twin_with_skip_matches_jax_scan_and_spec(skip_case):
    d = skip_case
    b, t = d["np"], d["t"]
    T = b["x"].shape[1]
    lo_full = d["bands"].expand(T)
    jres = jdp.banded_viterbi_batch(b["x"], b["t_len"], b["mu"], b["sigma"],
                                    b["n_ref"], lo_full, d["jcfg"])
    res = tdp.banded_viterbi_batch(t["x"], t["t_len"], t["mu"], t["sigma"],
                                   t["n_ref"], torch.from_numpy(lo_full), d["tcfg"])
    np.testing.assert_allclose(res.score.numpy(), np.asarray(jres.score),
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_array_equal(res.final_j.numpy(), np.asarray(jres.final_j))
    for r, rd in enumerate(d["reads"]):
        n, nr = int(b["t_len"][r]), int(b["n_ref"][r])
        np.testing.assert_array_equal(res.path[r, :n].numpy(),
                                      np.asarray(jres.path)[r, :n])
        # and the float64 spec, as tests/test_skip_parity.py holds the JAX scan
        score, path = dp_spec.banded_viterbi(
            rd.signal, b["mu"][r, :nr].astype(np.float64),
            b["sigma"][r, :nr].astype(np.float64),
            lo_full[r, :n].astype(np.int64), d["jcfg"])
        assert np.mean(res.path[r, :n].numpy() == path) > 0.999, r
        assert np.isclose(float(res.score[r]), score, rtol=1e-4, atol=0.05)
    assert _n_skips(res.path.numpy(), b["t_len"]) > 0
    # the kernel backend's path (chunked renormalisation) is the twin's
    for r in range(len(b["t_len"])):
        n = int(b["t_len"][r])
        np.testing.assert_array_equal(d["tres"].path[r, :n].numpy(),
                                      res.path[r, :n].numpy())


@pytest.mark.parametrize("use_skip", [False, True], ids=["noskip", "skip"])
def test_pinned_ends_match_jax(use_skip):
    """The case of tests/test_joint.py: pin_start / pin_end force the path to
    span positions 0..n_ref-1, and the pinned optimum never beats the free."""
    rng = np.random.default_rng(0)
    model = default_model()
    genome = random_genome(rng, length=80)
    rd = simulate_read(genome, "ref", model, rng, read_len=60, strand=1)
    mu, sg = model.expected_signal(rd.window_codes)
    T, n = len(rd.signal), len(mu)
    extra = dict(use_skip=True, log_p_skip=-3.5) if use_skip else {}
    arrs = (rd.signal[None, :].astype(np.float32), np.asarray([T], np.int32),
            mu[None].astype(np.float32), sg[None].astype(np.float32),
            np.asarray([n], np.int32), np.zeros((1, T), np.int32))
    jargs = [jnp.asarray(a) for a in arrs]
    targs = [torch.from_numpy(a.copy()) for a in arrs]
    jcfg, tcfg = JaxConfig(band_width=128, **extra), AlignConfig(band_width=128, **extra)
    free = tdp.banded_viterbi_batch(*targs, tcfg)
    for pins in (dict(pin_start=True, pin_end=True), dict(pin_start=True),
                 dict(pin_end=True)):
        want = jdp.banded_viterbi_batch(*jargs, jcfg, **pins)
        got = tdp.banded_viterbi_batch(*targs, tcfg, **pins)
        p = got.path.numpy()[0]
        if pins.get("pin_start"):
            assert p[0] == 0
        if pins.get("pin_end"):
            assert p[T - 1] == n - 1
        np.testing.assert_array_equal(p, np.asarray(want.path)[0])
        np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                                   rtol=1e-4, atol=2e-3)
        assert float(got.score[0]) <= float(free.score[0]) + 1e-3


# ------------------------------------------------------- the two-sample fill
@pytest.fixture(scope="module")
def pair_case():
    # an odd t_len (a half pair at the read's end) and a read that ends inside
    # chunk 0 are among the reads
    d = _simulate(77, (200, 350, 9, 150, 300, 180, 220, 330), skip_prob=0.0,
                  mean_dwell=8.0)
    t_len = d["np"]["t_len"]
    if not (t_len % 2 == 1).any():
        r = int(np.argmax(t_len))
        for v in (d["np"], d["j"], d["t"]):
            tl = np.array(v["t_len"])
            tl[r] -= 1
            v["t_len"] = (jnp.asarray(tl) if v is d["j"] else
                          torch.from_numpy(tl) if v is d["t"] else tl)
    t_len = d["np"]["t_len"]
    assert (t_len % 2 == 1).any() and (t_len < C).any()
    jcfg = JaxConfig(band_width=128, signal_chunk=C, read_tile=8,
                     kernel_unroll=1, dp_pair_step=True)
    j = d["j"]
    R, n_chunks = d["np"]["lo"].shape
    mu_b, sg_b = pallas_dp.gather_band_levels_jax(j["mu"], j["sigma"], j["lo"], 128)
    decs, v_fin, acc = pallas_dp.viterbi_fill_pallas(
        j["x"], j["t_len"], mu_b, sg_b, j["lo"].T.reshape(n_chunks, R, 1),
        j["delta"].T.reshape(n_chunks, R, 1), j["n_ref"], jcfg, interpret=True)
    assert len(decs) == 1
    d.update(mu_b=np.array(mu_b), sg_b=np.array(sg_b), jdec=np.array(decs[0]),
             jv=np.array(v_fin), jacc=np.array(acc))
    return d


def test_pair_fill_matches_pallas(pair_case):
    d = pair_case
    t = d["t"]
    tcfg = AlignConfig(band_width=128, dp_pair_step=True)
    # the rows go in: the two-sample fill gathers its band levels itself
    (dec,), v_fin, acc = cuda_dp.viterbi_fill(
        t["x"], t["t_len"], t["mu"], t["sigma"], t["lo"], t["delta"], t["n_ref"], tcfg)
    # word for word, but for broken ties (a pair compares paths through the
    # slots j, j-1 and j-2)
    n_bits = _tie_bits(dec.numpy() ^ d["jdec"], d["mu_b"], d["sg_b"])
    assert n_bits <= 1e-5 * d["jdec"].size * 32, n_bits
    np.testing.assert_allclose(v_fin.numpy(), d["jv"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(acc.numpy(), d["jacc"], rtol=1e-5, atol=1e-3)


def _path_loglik(b, r, p, cfg):
    """Float64 log-likelihood of path p of read r under the no-skip model."""
    x = b["x"][r, : len(p)].astype(np.float64)
    mu, sg = b["mu"][r].astype(np.float64)[p], b["sigma"][r].astype(np.float64)[p]
    e = -0.5 * ((x - mu) / sg) ** 2 - np.log(sg) - 0.5 * np.log(2 * np.pi)
    d = np.diff(p)
    return e.sum() + (d == 0).sum() * cfg.log_p_stay + (d == 1).sum() * cfg.log_p_move


def test_pair_fill_path_against_the_single_step_path(pair_case):
    """The two-sample fill carries the single-step fill's values, so the scores
    agree to float32 rounding. Its per-sample bits do not always give the
    single-step path: the bit of a pair's first sample is stored at the slot
    where the pair ENDS, while the walk looks it up at the slot it reaches
    after the pair's second step, where another pair's bit stands. On this
    fixture 8 of 13,468 live samples differ, none of them a tie, and the path
    walked from the pair's bits scores up to 7 nats below the optimum. The
    port reproduces the TPU body bit for bit (the test above), this included;
    ROADMAP.md, Queue 3, records it."""
    d = pair_case
    t, b = d["t"], d["np"]
    cfg = AlignConfig(band_width=128)
    pair, decs = cuda_dp.cuda_viterbi_batch(
        *_dp_args(t), AlignConfig(band_width=128, dp_pair_step=True))
    single, _ = cuda_dp.cuda_viterbi_batch(*_dp_args(t), cfg)
    assert len(decs) == 1
    np.testing.assert_allclose(pair.score.numpy(), single.score.numpy(),
                               rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(pair.final_j.numpy(), single.final_j.numpy())
    n_diff = n_live = 0
    for r in range(len(b["t_len"])):
        n = int(b["t_len"][r])
        pp, ps = pair.path[r, :n].numpy(), single.path[r, :n].numpy()
        assert np.all(np.diff(pp) >= 0) and np.all(np.diff(pp) <= 1)
        assert pp[-1] == ps[-1]
        n_diff += int((pp != ps).sum())
        n_live += n
        # the single-step path attains the score both fills report; the pair's
        # path never beats it
        best = _path_loglik(b, r, ps, cfg)
        assert abs(best - float(pair.score[r])) <= 2e-3 + 1e-5 * abs(best)
        assert _path_loglik(b, r, pp, cfg) <= best + 1e-6
    assert 0 < n_diff <= 1e-3 * n_live, (n_diff, n_live)
    # the Pallas planes walked by the port give the same path on live samples
    path = cuda_dp.backtrack((torch.from_numpy(d["jdec"]),), t["lo"], t["delta"],
                             pair.final_j, C)
    same = sum(int((path[r, : int(b["t_len"][r])] !=
                    pair.path[r, : int(b["t_len"][r])]).sum())
               for r in range(len(b["t_len"])))
    assert same <= 8, same        # the 7 tie bits of the fill comparison


# ------------------------------- the local rescore on a path with skipped positions
def _edge_ok(path, t_len, L, k):
    first = path[:, 0]
    last = path[np.arange(len(t_len)), np.maximum(t_len - 1, 0)]
    i = np.arange(L)[None, :]
    return (i >= (first + k - 1)[:, None]) & (i <= last[:, None])


def test_local_rescore_on_skip_path_matches_pallas(skip_world):
    d = skip_world
    b, j, t, model = d["np"], d["j"], d["t"], d["model"]
    assert _n_skips(b["true_path"], b["t_len"]) > 0
    k = model.k
    L = b["codes"].shape[1]
    lm, ls = model.level_mean.astype(np.float32), model.level_std.astype(np.float32)
    want = np.asarray(pallas_rescore.base_loglik_local_pallas(
        j["x"], j["true_path"], j["t_len"], j["codes"], j["ids"],
        jnp.asarray(lm), jnp.asarray(ls), k, JCFG, t_w=JCFG.snp_local_window,
        interpret=True))[:, :L]
    got = cuda_rescore.base_loglik_local_cuda(
        t["x"], t["true_path"], t["t_len"], t["codes"], t["ids"],
        torch.from_numpy(lm), torch.from_numpy(ls), k, TCFG,
        t_w=TCFG.snp_local_window).numpy()[:, :L]
    assert b["x"].shape[1] < 2304            # no span mask at this length
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert np.abs(want).max() > 1.0
    # the batch twin against the JAX batch function, every position
    jll = np.asarray(jdp.base_loglik_local_batch(
        j["x"], j["true_path"], j["t_len"], j["codes"], j["ids"],
        jnp.asarray(lm), jnp.asarray(ls), k, JCFG, t_w=JCFG.snp_local_window))
    tll = tdp.base_loglik_local_batch(
        t["x"], t["true_path"], t["t_len"], t["codes"], t["ids"],
        torch.from_numpy(lm), torch.from_numpy(ls), k, TCFG,
        t_w=TCFG.snp_local_window).numpy()
    np.testing.assert_allclose(tll, jll, rtol=1e-5, atol=1e-3)
    # kernel path and twin agree away from the read-local edges
    ok = _edge_ok(b["true_path"], b["t_len"], L, k)
    np.testing.assert_allclose(got[ok], tll[:, :L][ok], rtol=1e-5, atol=1e-3)


def test_segment_stats_with_skipped_positions_match_jax(skip_world):
    """The ``"fixed"`` rescore's statistics on a path with advance-by-2 steps:
    a skipped position has an empty sample range and its neighbours' bounds
    stay exact."""
    d = skip_world
    b, t, j = d["np"], d["t"], d["j"]
    N = b["mu"].shape[1]
    jstats = np.asarray(jdp.segment_stats_batch(j["true_path"], j["x"],
                                                j["t_len"], N))
    tstats = tdp.segment_stats_batch(t["true_path"], t["x"], t["t_len"], N).numpy()
    np.testing.assert_array_equal(tstats[..., 0], jstats[..., 0])
    np.testing.assert_allclose(tstats, jstats, rtol=1e-4, atol=2e-3)
    # skipped positions inside a read's span: no samples
    r = 1
    p = b["true_path"][r, : int(b["t_len"][r])]
    skipped = p[1:][np.diff(p) == 2] - 1
    assert len(skipped) > 0 and (tstats[r, skipped, 0] == 0).all()


# ------------------------------------------------- the slice as a whole
from test_torch_slice import DATA, MIN_COV, REF, THRESHOLDS, _jax_local  # noqa: E402

needs_goldens = pytest.mark.skipif(
    not (jfast5.HAVE_H5PY and os.path.exists(REF)),
    reason="golden dataset or h5py missing")

# name -> (config fields, the port's backend, the JAX backend of the Viterbi,
# the JAX backend of the local rescore). Under skip the JAX ``pallas`` Viterbi
# is not run on the golden batch (its two-plane walk takes minutes to compile
# in interpret mode, see the module docstring): ``scan`` gives the same path
# (tests/test_skip_parity.py). ``dp_pair_step`` exists in the Pallas fill only.
SLICE_CASES = {
    "skip-scan": (dict(use_skip=True, log_p_skip=-4.6), "scan", "scan", "scan"),
    "skip-cuda": (dict(use_skip=True, log_p_skip=-4.6), "cuda", "scan", "pallas"),
    "pair-cuda": (dict(dp_pair_step=True), "cuda", "pallas", "pallas"),
}


@pytest.fixture(scope="module")
def golden_records():
    cfg = nadavca_tpu.AlignConfig()
    genome = nadavca_tpu.Genome.from_fasta(REF)
    model = nadavca_tpu.default_model(cfg.k)
    records = japi._preprocess(japi._iter_raw(DATA), genome, model, cfg,
                               prep="python")
    group = sorted(records, key=lambda r: len(r.signal))
    return dict(genome=genome, model=model, records=records, group=group)


@needs_goldens
@pytest.mark.parametrize("name", sorted(SLICE_CASES))
def test_slice_matches_jax(golden_records, name):
    fields, backend, j_backend, j_rescore = SLICE_CASES[name]
    g = golden_records
    genome, model, group = g["genome"], g["model"], g["group"]
    # the Viterbi does not depend on the rescore: align once with the cheap one
    jcfg = nadavca_tpu.AlignConfig(kernel_unroll=1, snp_rescore="fixed",
                                   **fields, **THRESHOLDS)
    batch = jpipe.assemble_batch(group, model, jcfg)
    out = jpipe.align_batch(batch, model, jcfg, backend=j_backend,
                            interpret=(j_backend == "pallas"))
    js = dict(cfg=jcfg, batch=batch, model=model, genome=genome)
    base_ll = jnp.asarray(_jax_local(js, j_rescore, out))
    n = batch.n_reads
    contig = genome.contigs[0]
    acc, cov, votes = jcall.make_accumulators(len(contig), with_votes=True)
    acc, cov, votes = jcall.accumulate_batch(
        acc, cov, base_ll[:n], jnp.asarray(batch.window_start[:n]),
        jnp.asarray(batch.window_len[:n]), jnp.asarray(batch.strand[:n]),
        votes=votes, cfg=jcfg)
    want_calls = jcall.call_snps(np.asarray(acc), np.asarray(cov), contig.codes,
                                 contig.name, jcfg, min_coverage=MIN_COV,
                                 votes=np.asarray(votes))
    want_path, want_score = np.array(out["path"]), np.array(out["score"])
    base_ll = np.array(base_ll)

    cfg = nadavca_tpu_torch.AlignConfig(**fields, **THRESHOLDS)
    assert cfg.snp_rescore == "local"
    kw = dict(backend=backend, batch_reads=16, prep="python", device="cpu")
    calls = tapi.call_snps(REF, DATA, cfg, min_coverage=MIN_COV, **kw)
    key = lambda c: (c.contig, c.position, c.ref_base, c.alt_base, c.coverage)
    assert len(want_calls) >= 1
    assert [key(c) for c in calls] == [key(c) for c in want_calls]
    np.testing.assert_allclose([c.probability for c in calls],
                               [c.probability for c in want_calls], atol=1e-5)

    alns = tapi.align_signal(REF, DATA, cfg, **kw)
    by_id = {a.read_id: a for a in alns}
    assert len(alns) == batch.n_reads == 16
    n_skips = 0
    for r in range(batch.n_reads):
        a = by_id[group[r].read_id]
        tl = int(batch.t_len[r])
        s, e = jpipe.path_to_segments(want_path[r], tl, int(batch.n_ref[r]))
        # segments come from the path alone: identical
        np.testing.assert_array_equal(a.seg_start, s)
        np.testing.assert_array_equal(a.seg_end, e)
        np.testing.assert_allclose(a.score, want_score[r], rtol=1e-5, atol=2e-3)
        wlen = int(batch.window_len[r])
        np.testing.assert_allclose(a.base_loglik, base_ll[r, :wlen],
                                   rtol=1e-4, atol=2e-3)
        n_skips += int(np.sum(np.diff(want_path[r, :tl]) == 2))
    # the golden reads were simulated without pore skips; at log_p_skip = -4.6
    # the skip model still takes a few advance-by-2 steps on them
    assert (n_skips > 0) == bool(fields.get("use_skip")), n_skips
