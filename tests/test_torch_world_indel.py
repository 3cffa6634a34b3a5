"""Worlds 4 and 5 of the JAX package's own tests through the port:
basecalls with 5 % indels (``tests/test_anchor_indel.py``).

World 4 is the anchorer alone: the 40-read world (seed 314), the 4 kb reads
whose indel rates drift the fit on both strands, and the clean read whose
fit must stay rigid. The port's ``anchor_basecall`` and
``signal_anchor_path`` equal the JAX package's on every read, and the JAX
tests' own rates hold.

World 5 runs end to end (seed 2025, 12 reads of 600 bases, two planted
SNPs). Its reads cross 8-base homopolymers, where positions of identical
level let two optimal paths place samples differently (the run rule of
``nadavca_tpu_torch.utils.parity``; 87 of 63,488 live entries between the two
packages' ``scan`` backends on the CPU). Next to such a tie a position's
rescore window moves with the segment bound, so its rescore may differ by
tens of nats: those positions are counted and left out, every other one
agrees within 2e-3. The calls are equal, and pass the JAX test's truth
asserts.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu_torch.utils import parity, worlds

import torch_worlds as W

# limits on the differing live path entries, from the CPU readings with
# headroom (PERF.md): the two scan backends 87 of 63,488, the kernels' plain
# versions against the scan twin 72, with tables and without
SCAN_TIES, KERNEL_TIES = 120, 100


# --------------------------------------------------------- world 4: anchoring
def _anchor_world(pkg):
    rng = np.random.default_rng(314)
    model = pkg.default_model()
    genome = pkg.random_genome(rng, length=8000)
    index = pkg.SeedIndex(genome)
    reads = [pkg.simulate_read(genome, "ref", model, rng, read_len=600,
                               strand=1 if i % 2 else -1, mean_dwell=9.0,
                               noise_scale=0.8, **worlds.INDEL)
             for i in range(40)]
    # the drift reads and the clean read, drawn after the world's in the
    # order the JAX tests draw them
    drift = [pkg.simulate_read(genome, "ref", model, rng, read_len=4000, start=2000,
                               strand=strand, mean_dwell=6.0, noise_scale=0.8,
                               basecall_sub_rate=0.02, basecall_ins_rate=0.035,
                               basecall_del_rate=0.015) for strand in (+1, -1)]
    clean = pkg.simulate_read(genome, "ref", model, rng, read_len=400, start=3000,
                              strand=1, basecall_sub_rate=0.0)
    anchors = [(rd, pkg.anchor_basecall(index, rd.basecall))
               for rd in reads + drift + [clean]]
    paths = [None if a is None else pkg.signal_anchor_path(a, rd.move_index, len(rd.signal))
             for rd, a in anchors]
    return dict(reads=reads, drift=drift, clean=clean, anchors=anchors, paths=paths)


@pytest.fixture(scope="module")
def anchor_world():
    j, p = _anchor_world(W.JAX), _anchor_world(W.PORT)
    W.assert_same_reads(j["reads"] + j["drift"] + [j["clean"]],
                        p["reads"] + p["drift"] + [p["clean"]])
    return j, p


def test_anchors_equal_the_jax_anchors_on_every_read(anchor_world):
    j, p = anchor_world
    n = 0
    for (_, ja), (rd, pa), jp, pp in zip(j["anchors"], p["anchors"], j["paths"], p["paths"]):
        assert (ja is None) == (pa is None), rd.read_id
        if pa is None:
            continue
        assert (pa.contig, pa.strand, pa.ref_start, pa.ref_end) == \
               (ja.contig, ja.strand, ja.ref_start, ja.ref_end), rd.read_id
        np.testing.assert_array_equal(pa.base_to_window, ja.base_to_window)
        np.testing.assert_array_equal(pp, jp)
        n += 1
    assert n >= 40


def test_anchor_rates_of_the_jax_tests(anchor_world):
    """``test_anchor_recovery_rate_with_indels`` and
    ``test_anchor_path_stays_inside_band_with_indels`` on the port's anchors."""
    _, p = anchor_world
    B = W.PORT.AlignConfig().band_width
    ok = checked = 0
    for rd, a in p["anchors"][:40]:
        if (a is not None and a.contig == rd.contig and a.strand == rd.strand
                and a.ref_start <= rd.ref_start + 40 and a.ref_end >= rd.ref_end - 40):
            ok += 1
        if a is None or a.strand != rd.strand:
            continue
        path = W.PORT.signal_anchor_path(a, rd.move_index, len(rd.signal))
        shift = rd.ref_start - a.ref_start if rd.strand > 0 else a.ref_end - rd.ref_end
        err = np.abs(path - (rd.true_path + shift))
        assert np.mean(err <= B // 2 - 8) > 0.98, rd.read_id
        checked += 1
    assert ok / 40 >= 0.95 and checked >= 35


def test_long_read_drift_and_the_rigid_clean_read(anchor_world):
    """``test_long_read_systematic_drift`` on both strands and
    ``test_no_indel_anchor_unchanged`` on the port's anchors."""
    _, p = anchor_world
    B = W.PORT.AlignConfig().band_width
    for (rd, a), path in zip(p["anchors"][40:42], p["paths"][40:42]):
        assert a is not None and a.strand == rd.strand
        assert np.ptp(a.base_to_window - np.arange(len(a.base_to_window))) > 40
        shift = rd.ref_start - a.ref_start if rd.strand > 0 else a.ref_end - rd.ref_end
        assert np.mean(np.abs(path - (rd.true_path + shift)) <= B // 2 - 8) > 0.98
    _, a = p["anchors"][42]
    assert a is not None and a.strand == 1
    np.testing.assert_allclose(np.diff(a.base_to_window), 1.0)


# ---------------------------------------------- world 5: indel basecalls end to end
@pytest.fixture(scope="module")
def e2e():
    j, p = worlds.indel_calls(W.JAX), worlds.indel_calls(W.PORT)
    for w in (j, p):
        (w["batch"],) = w["batches"]
    W.assert_same_reads(j["reads"], p["reads"])
    W.assert_same_batch(j["batch"], p["batch"])
    assert p["batch"].n_reads >= 11
    runs = {"jax_scan": W.jax_align(j["batch"], j["model"], j["cfg"], "scan"),
            "scan": W.port_align(p["batch"], p["model"], p["cfg"], "scan"),
            "kernels": W.port_align(p["batch"], p["model"], p["cfg"], "cuda"),
            "tables": W.port_align(p["batch"], p["model"], p["cfg"], "cuda",
                                   genome=p["genome"])}
    return j, p, runs


def test_indel_scan_twin_against_the_jax_scan(e2e):
    _, p, runs = e2e
    held = W.hold("scan against the JAX scan", runs["scan"], runs["jax_scan"],
                  p["batch"], p["model"].k, max_ties=SCAN_TIES)
    assert held.compared_positions > 6500


@pytest.mark.parametrize("name", ["kernels", "tables"])
def test_indel_kernels_against_the_scan_twin(e2e, name):
    _, p, runs = e2e
    batch, k = p["batch"], p["model"].k
    compare = W.kernel_compare(batch, runs[name], k, tables=name == "tables")
    held = W.hold(f"{name} against scan", runs[name], runs["scan"], batch, k,
                  max_ties=KERNEL_TIES, compare=compare)
    assert held.compared_positions > 6000


@pytest.mark.parametrize("name", ["scan", "kernels", "tables"])
def test_indel_calls_equal_the_jax_calls_and_the_truth(e2e, name):
    """The JAX test's truth asserts (each covered SNP called with its base,
    at most 2 false positives) on every run, and the call set equal to the JAX
    ``scan`` backend's (masked as the tables path masks, for ``tables``)."""
    j, p, runs = e2e
    ref = runs["jax_scan"]["base_loglik"]
    got = runs[name]["base_loglik"]
    if name == "tables":
        ref = parity.masked_like_tables(ref, got)
    want = W.jax_calls(j["batch"], ref, j["codes"], "ref", j["cfg"], min_coverage=2,
                       votes=False)
    calls = parity.calls_of([p["batch"]], [got], p["codes"], "ref", p["cfg"], min_coverage=2,
                            votes=False)
    W.assert_same_calls(calls, want)
    batch = p["batch"]
    cov = np.zeros(len(p["codes"]), np.int64)
    for ws, wl in zip(batch.window_start[:batch.n_reads], batch.window_len[:batch.n_reads]):
        cov[ws:ws + wl] += 1
    called = {c.position: c.alt_base for c in calls}
    for pos, orig in p["truth"].items():
        if cov[pos] >= 2:
            assert called.get(pos) == "ACGT"[orig], (pos, called)
    assert len([q for q in called if q not in p["truth"]]) <= 2
