"""The port's plain-PyTorch ``scan`` twin vs ``nadavca_tpu.ops.banded_dp``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.config import AlignConfig as JaxConfig
from nadavca_tpu.genome import kmer_ids
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.ops import banded_dp as jdp
from nadavca_tpu.sched import build_chunked_bands

from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.ops import banded_dp as tdp


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(77)
    model = default_model()
    genome = random_genome(rng, length=3000)
    reads = [simulate_read(genome, "ref", model, rng, read_len=ln, strand=1,
                           mean_dwell=8.0)
             for ln in (200, 350, 260, 150, 300, 180, 220, 330)]
    R = len(reads)
    T = 128 * ((max(len(r.signal) for r in reads) + 127) // 128)
    L = 256 * ((max(len(r.window_codes) for r in reads) + 255) // 256)
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
        mu[r, : len(m)] = m
        sigma[r, : len(m)] = s
        n_ref[r] = len(m)
        anchors[r, :t] = rd.true_path
        anchors[r, t:] = rd.true_path[-1]
        codes[r, : len(rd.window_codes)] = rd.window_codes
        ids[r, : len(m)] = kmer_ids(rd.window_codes, model.k)
    bands = build_chunked_bands(anchors, t_len, n_ref, 128, 128)
    lo_full = bands.expand(T)
    b = dict(x=x, t_len=t_len, mu=mu, sigma=sigma, n_ref=n_ref, lo=lo_full,
             codes=codes, ids=ids)
    jres = jdp.banded_viterbi_batch(x, t_len, mu, sigma, n_ref, lo_full,
                                    JaxConfig(band_width=128))
    return dict(np=b, model=model, N=N,
                t={k: torch.from_numpy(v.copy()) for k, v in b.items()},
                jpath=np.array(jres.path), jscore=np.array(jres.score),
                jfinal=np.array(jres.final_j))


def test_scan_twin_matches_jax_scan(batch):
    t = batch["t"]
    res = tdp.banded_viterbi_batch(t["x"], t["t_len"], t["mu"], t["sigma"],
                                   t["n_ref"], t["lo"],
                                   AlignConfig(band_width=128))
    # per-step renormalised values differ by float32 rounding only (XLA fuses
    # multiply-adds, eager PyTorch does not): the score tolerance the JAX
    # tests use across backends
    np.testing.assert_allclose(res.score.numpy(), batch["jscore"],
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(res.final_j.numpy(), batch["jfinal"])
    assert res.path.dtype == torch.int32
    for r in range(t["x"].shape[0]):
        n = int(batch["np"]["t_len"][r])
        np.testing.assert_array_equal(res.path[r, :n].numpy(),
                                      batch["jpath"][r, :n])


def test_segment_stats_and_base_loglik_match_jax(batch):
    b, t, model = batch["np"], batch["t"], batch["model"]
    N = batch["N"]
    jstats = jdp.segment_stats_batch(jnp.asarray(batch["jpath"]),
                                     jnp.asarray(b["x"]),
                                     jnp.asarray(b["t_len"]), N)
    tstats = tdp.segment_stats_batch(torch.from_numpy(batch["jpath"].copy()),
                                     t["x"], t["t_len"], N)
    assert tuple(tstats.shape) == (8, N, 3) and tstats.dtype == torch.float32
    # counts are exact; the sums differ by the order of float32 additions on
    # the JAX side (the port sums in float64 and rounds once)
    np.testing.assert_array_equal(tstats[..., 0].numpy(), np.asarray(jstats[..., 0]))
    np.testing.assert_allclose(tstats.numpy(), np.asarray(jstats),
                               rtol=1e-4, atol=2e-3)
    jll = jdp.base_loglik_batch(jnp.asarray(b["codes"]), jnp.asarray(b["ids"]),
                                jstats, jnp.asarray(model.level_mean),
                                jnp.asarray(model.level_std), model.k)
    tll = tdp.base_loglik_batch(t["codes"], t["ids"], tstats,
                                torch.from_numpy(model.level_mean.copy()),
                                torch.from_numpy(model.level_std.copy()), model.k)
    assert tuple(tll.shape) == tuple(jll.shape)
    # a sum of k closed-form terms of size ~1e2 each: float32 rounding of the
    # statistics and of the terms
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-4, atol=2e-3)
    assert np.abs(np.asarray(jll)).max() > 1.0     # the comparison is not vacuous
