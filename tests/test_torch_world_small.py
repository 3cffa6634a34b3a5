"""Worlds 2 and 3 of the JAX package's own tests through the port
(``tests/test_edge_cases.py``): a batch of one read (seed 9, padded to its
read tile of 8 rows), and a reference window narrower than the band (a
60-base genome, seed 10: 55 k-mer positions under a band of 128 slots).

A one-read batch has no ties to hide behind: paths equal exactly in every
pairing, the rescores within 2e-3, the score finite. The narrow window goes
through the port's float64 oracle ``ops/dp_spec`` (equal to the JAX copy's
exactly, and to the JAX test's own bound), and through the ``scan`` twin and
the kernels' plain versions, whose paths are equal to each other.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.ops import dp_spec as jspec

from nadavca_tpu_torch.ops import banded_dp, cuda_dp, dp_spec
from nadavca_tpu_torch.sched.bands import build_chunked_bands
from nadavca_tpu_torch.utils import worlds

import torch_worlds as W


# ------------------------------------------------------ world 2: one read
@pytest.fixture(scope="module")
def one_read():
    j, p = worlds.one_read(W.JAX), worlds.one_read(W.PORT)
    for w in (j, p):
        (w["batch"],) = w["batches"]
    W.assert_same_reads(j["reads"], p["reads"])
    W.assert_same_batch(j["batch"], p["batch"])
    assert p["batch"].n_reads == 1 and p["batch"].x.shape[0] == 8
    jc = dataclasses.replace(j["cfg"], kernel_unroll=1)
    runs = {
        "jax_scan": W.jax_align(j["batch"], j["model"], j["cfg"], "scan"),
        "jax_pallas": W.jax_align(j["batch"], j["model"], jc, "pallas", genome=j["genome"]),
        "scan": W.port_align(p["batch"], p["model"], p["cfg"], "scan"),
        "kernels": W.port_align(p["batch"], p["model"], p["cfg"], "cuda"),
        "tables": W.port_align(p["batch"], p["model"], p["cfg"], "cuda",
                               genome=p["genome"]),
    }
    assert p["batch"].x.shape[1] < 2304      # no span mask on either side
    return p, runs


@pytest.mark.parametrize("a, b", [("scan", "jax_scan"), ("kernels", "scan"),
                                  ("tables", "jax_pallas")])
def test_one_read_paths_equal_and_rescores_close(one_read, a, b):
    p, runs = one_read
    batch, k = p["batch"], p["model"].k
    ra, rb = runs[a], runs[b]
    t = int(batch.t_len[0])
    np.testing.assert_array_equal(np.asarray(ra["path"])[0, :t], np.asarray(rb["path"])[0, :t])
    held = W.hold(f"{a} against {b}", ra, rb, batch, k, max_ties=0)
    assert held.excluded_positions == 0 and held.compared_positions >= 190
    assert np.isfinite(float(np.asarray(ra["score"])[0]))
    np.testing.assert_allclose(float(np.asarray(ra["score"])[0]),
                               float(np.asarray(rb["score"])[0]), rtol=1e-5, atol=2e-3)


def test_one_read_tables_rescore_against_the_scan_twin(one_read):
    """The tables path masks the read's outer k-1 positions; inside, it
    agrees with the ``scan`` twin's rescore of the same path."""
    p, runs = one_read
    batch, k = p["batch"], p["model"].k
    held = W.hold("tables against scan", runs["tables"], runs["scan"], batch, k,
                  max_ties=0, compare=W.kernel_compare(batch, runs["tables"], k, True))
    assert held.compared_positions >= 170


# ------------------------------------- world 3: a window narrower than the band
@pytest.fixture(scope="module")
def narrow():
    j, p = worlds.narrow_window(W.JAX), worlds.narrow_window(W.PORT)
    W.assert_same_reads(j["reads"], p["reads"])
    (jb,), (pb,) = j["batches"], p["batches"]
    W.assert_same_batch(jb, pb)
    assert pb.n_ref[0] < p["cfg"].band_width and (pb.bands.lo == 0).all()
    return j, p


def test_narrow_window_oracle_equals_the_jax_oracle(narrow):
    """The JAX test's own body through both copies of the oracle: band,
    score and path equal exactly, and the JAX test's bound."""
    j, p = narrow
    (jrd,), (rd,) = j["reads"], p["reads"]
    jcfg, cfg, model = j["cfg"], p["cfg"], p["model"]
    mu, sigma = model.expected_signal(rd.window_codes)
    assert len(mu) < cfg.band_width
    lo = dp_spec.make_band(rd.true_path.astype(np.float64), len(mu), cfg.band_width)
    jlo = jspec.make_band(jrd.true_path.astype(np.float64), len(mu), jcfg.band_width)
    np.testing.assert_array_equal(lo, jlo)
    score, path = dp_spec.banded_viterbi(rd.signal, mu.astype(np.float64),
                                         sigma.astype(np.float64), lo, cfg)
    jscore, jpath = jspec.banded_viterbi(jrd.signal, mu.astype(np.float64),
                                         sigma.astype(np.float64), jlo, jcfg)
    assert score == jscore
    np.testing.assert_array_equal(path, jpath)
    assert np.mean(np.abs(path - rd.true_path) <= 2) > 0.9


def test_narrow_window_scan_twin_and_kernels_agree(narrow):
    """One row under the per-sample band of ``dp_spec.make_band_batch``
    (``scan`` twin) and under the chunked band (the kernels' plain versions):
    the band spans the whole window either way, and the paths are equal."""
    _, p = narrow
    (rd,), cfg, model = p["reads"], p["cfg"], p["model"]
    t = len(rd.signal)
    T = cfg.signal_chunk * -(-t // cfg.signal_chunk)
    m, s = model.expected_signal(rd.window_codes)
    n = len(m)
    x = np.zeros((1, T), np.float32)
    x[0, :t] = rd.signal
    anchors = np.full((1, T), float(rd.true_path[-1]))
    anchors[0, :t] = rd.true_path
    t_len, n_ref = np.array([t], np.int32), np.array([n], np.int32)
    lo_t = dp_spec.make_band_batch(anchors, t_len, n_ref, cfg.band_width)
    assert (lo_t == 0).all()
    bands = build_chunked_bands(anchors, t_len, n_ref, cfg.band_width, cfg.signal_chunk)
    np.testing.assert_array_equal(bands.expand(T), lo_t)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    mu, sigma = put(m[None].astype(np.float32)), put(s[None].astype(np.float32))
    scan = banded_dp.banded_viterbi_batch(put(x), put(t_len), mu, sigma, put(n_ref),
                                          put(lo_t), cfg)
    kern, _ = cuda_dp.cuda_viterbi_batch(put(x), put(t_len), mu, sigma, put(n_ref),
                                         put(bands.lo), put(bands.delta), cfg)
    np.testing.assert_array_equal(scan.path[0, :t].numpy(), kern.path[0, :t].numpy())
    np.testing.assert_allclose(float(scan.score[0]), float(kern.score[0]), rtol=1e-5, atol=2e-3)
    assert np.mean(np.abs(scan.path[0, :t].numpy() - rd.true_path) <= 2) > 0.9


def test_narrow_window_through_the_pipeline(narrow):
    """The read anchored and batched as the pipeline batches it: the port's
    ``scan`` twin gives the JAX ``scan`` path, and the kernels' plain
    versions, with tables and without, the twin's; the rescores agree
    wherever the kernels score as the twin."""
    j, p = narrow
    (jb,), (batch,) = j["batches"], p["batches"]
    k = p["model"].k
    ref = W.jax_align(jb, j["model"], j["cfg"], "scan")
    scan = W.port_align(batch, p["model"], p["cfg"], "scan")
    W.hold("scan against the JAX scan", scan, ref, batch, k, max_ties=0)
    for genome in (None, p["genome"]):
        kern = W.port_align(batch, p["model"], p["cfg"], "cuda", genome=genome)
        held = W.hold("kernels against scan", kern, scan, batch, k, max_ties=0,
                      compare=W.kernel_compare(batch, kern, k, tables=genome is not None))
        assert held.compared_positions >= 40
    t = int(batch.t_len[0])
    assert np.mean(np.abs(np.asarray(scan["path"])[0, :t] - p["reads"][0].true_path) <= 2) > 0.9
