"""The port's joint refiner (``nadavca_tpu_torch.joint``) vs ``nadavca_tpu.joint``.

One simulated world, built in memory the way the JAX package's ``simulate``
command builds it (24 reads x 400 bases over a 2 kb genome, 2 planted SNPs,
seed 3; no fast5 file, no ``h5py``). The port aligns the reads once on the
CPU; the same accumulators and the same read records then go through both
packages' joint passes: the host-side planning and decision code must agree
exactly, and the hypothesis rows, scored by the JAX ``scan`` backend on one
side and by the port's twin on the other (pinned ends, free locate pass, skip
at ``snp_joint_log_p_skip`` when ``snp_joint_skip`` is set), must agree to
float32 rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import nadavca_tpu
from nadavca_tpu import joint as jjoint

import nadavca_tpu_torch
from nadavca_tpu_torch import api as tapi
from nadavca_tpu_torch import joint as tjoint
from nadavca_tpu_torch.genome import Contig, Genome
from nadavca_tpu_torch.io.simulator import random_genome, simulate_read

MIN_COV = 3


@pytest.mark.parametrize("hits,want", [
    ([], []),
    ([10], [(10, 10)]),
    # 10, 12, 14 chain into one cluster (gaps < k); 30 is separate
    ([14, 10, 30, 12], [(10, 14), (30, 30)]),
    # a gap of exactly k splits
    ([10, 16], [(10, 10), (16, 16)]),
])
def test_group_clusters(hits, want):
    hits = np.asarray(hits, np.int64)
    assert tjoint.group_clusters(hits, 6) == want
    assert jjoint.group_clusters(hits, 6) == want


def test_reads_covering_and_needed_ids():
    metas = [tjoint.ReadMeta("a", "ref", 0, 100, 1),
             tjoint.ReadMeta("b", "ref", 50, 100, -1),
             tjoint.ReadMeta("c", "ref", 96, 100, 1)]
    k = 6
    # span 100..101 touches positions 95..106: read a ends at 99
    assert [m.read_id for m in tjoint.reads_covering((100, 101), metas, k)] == ["b"]
    assert [m.read_id for m in tjoint.reads_covering((104, 104), metas, k)] == ["b", "c"]
    plan = [tjoint.Cluster(span=(104, 104), hyps=(), fallback_pos=104,
                           fallback_base=0, fallback_prob=1.0)]
    assert tjoint.needed_read_ids(plan, metas, k) == {"b", "c"}
    jmetas = [jjoint.ReadMeta(*dataclasses.astuple(m)) for m in metas]
    assert jjoint.needed_read_ids(plan, jmetas, k) == {"b", "c"}


def test_snp_joint_device_is_validated():
    for ok in ("cpu", "default"):
        assert nadavca_tpu_torch.AlignConfig(snp_joint_device=ok).snp_joint_device == ok
    with pytest.raises(ValueError, match="snp_joint_device"):
        nadavca_tpu_torch.AlignConfig(snp_joint_device="gpu")
    with pytest.raises(ValueError, match="snp_joint_device"):
        dataclasses.replace(nadavca_tpu_torch.AlignConfig(), snp_joint_device="")


@pytest.fixture(scope="module")
def world():
    """The world of tests/test_joint.py, in memory, aligned once by the port."""
    rng = np.random.default_rng(3)
    model = nadavca_tpu_torch.default_model()
    sample = random_genome(rng, length=2000)
    contig = sample.contigs[0]
    codes = contig.codes.copy()
    truth = {}
    for p in sorted(rng.choice(len(codes) - 20, size=2, replace=False) + 10):
        orig = int(codes[p])
        codes[p] = (orig + int(rng.integers(1, 4))) % 4
        truth[int(p)] = "ACGT"[orig]
    reference = Genome([Contig(contig.name, codes)])
    reads = [simulate_read(sample, contig.name, model, rng, read_len=400,
                           read_id=f"sim{i:05d}") for i in range(24)]
    raws = [tapi.raw_read_from_simulated(r) for r in reads]
    cfg = nadavca_tpu_torch.AlignConfig()
    dev = torch.device("cpu")
    records, accs = tapi._accumulate_reads(reference, raws, cfg, model, "scan",
                                           32, 1, "python", dev)
    acc, cov, votes = (a.numpy() for a in accs[contig.name])
    metas = [tjoint.ReadMeta(r.read_id, r.anchor.contig, int(r.anchor.ref_start),
                             len(r.window_codes), int(r.anchor.strand))
             for r in records]
    return dict(reference=reference, contig=contig.name, codes=codes, truth=truth,
                raws=raws, records={r.read_id: r for r in records}, metas=metas,
                acc=acc, cov=cov, votes=votes, model=model,
                jmodel=nadavca_tpu.default_model(), scored={})


def _cfgs(skip: bool):
    kw = dict(snp_joint_rescore=True, snp_joint_skip=skip)
    return nadavca_tpu_torch.AlignConfig(**kw), nadavca_tpu.AlignConfig(**kw)


def _plans(w, skip):
    tcfg, jcfg = _cfgs(skip)
    args = (w["acc"], w["cov"], w["votes"], w["codes"])
    return (tjoint.cluster_plan(*args, tcfg, min_coverage=MIN_COV),
            jjoint.cluster_plan(*args, jcfg, min_coverage=MIN_COV))


def _scored(w, skip):
    """Both packages' per-read delta matrices, once per configuration."""
    if skip not in w["scored"]:
        tcfg, jcfg = _cfgs(skip)
        tplan, jplan = _plans(w, skip)
        jmetas = [jjoint.ReadMeta(*dataclasses.astuple(m)) for m in w["metas"]]
        tm = tjoint.partial_deltas(tplan, w["metas"], w["records"], w["model"],
                                   tcfg, device="cpu")
        jm = jjoint.partial_deltas(jplan, jmetas, w["records"], w["jmodel"], jcfg)
        w["scored"][skip] = (tplan, jplan, tm, jm)
    return w["scored"][skip]


def test_cluster_plan_matches_jax(world):
    tplan, jplan = _plans(world, False)
    assert len(tplan) >= 2
    assert [dataclasses.astuple(c) for c in tplan] == [
        dataclasses.astuple(c) for c in jplan]
    # every planted SNP lies inside a cluster's hypothesis set
    for p, alt in world["truth"].items():
        assert any((p, "ACGT".index(alt)) in c.hyps for c in tplan), p


@pytest.mark.parametrize("skip", [False, True], ids=["noskip", "skip"])
def test_partial_deltas_match_jax(world, skip):
    tplan, jplan, tm, jm = _scored(world, skip)
    assert len(tm) == len(jm) == len(tplan)
    n_rows = 0
    for c, a, b in zip(tplan, tm, jm):
        assert a.shape == b.shape == (a.shape[0], 2 + len(c.hyps))
        assert a.dtype == np.float32
        # per-read alignment scores of ~500-sample slices, renormalised every
        # step on both sides: float32 rounding (XLA fuses multiply-adds)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-3)
        assert (a[:, 0] == 0).all()
        n_rows += a.shape[0]
    assert n_rows >= 4                  # reads really were scored


@pytest.mark.parametrize("skip", [False, True], ids=["noskip", "skip"])
def test_decide_and_api_match_jax(world, skip):
    w = world
    tcfg, jcfg = _cfgs(skip)
    tplan, jplan, tm, jm = _scored(w, skip)
    args = (w["cov"], w["codes"], w["contig"])
    tcalls = tjoint.decide(tplan, tm, *args, tcfg, acc=w["acc"])
    jcalls = jjoint.decide(jplan, jm, *args, jcfg, acc=w["acc"])
    key = lambda c: (c.contig, c.position, c.ref_base, c.alt_base, c.coverage)
    assert [key(c) for c in tcalls] == [key(c) for c in jcalls]
    np.testing.assert_allclose([c.probability for c in tcalls],
                               [c.probability for c in jcalls], atol=1e-4)
    # each side's matrices through the other side's decision code too
    assert [key(c) for c in tjoint.decide(tplan, jm, *args, tcfg, acc=w["acc"])] == [
        key(c) for c in tcalls]
    # on this clean world the refined calls are the planted SNPs, exactly placed
    assert {c.position: c.alt_base for c in tcalls} == w["truth"]
    # and the public entry point gives the same list
    api_calls = tapi.call_snps_reads(w["reference"], w["raws"], tcfg, backend="scan",
                                     batch_reads=32, min_coverage=MIN_COV,
                                     prep="python", device="cpu")
    assert [key(c) for c in api_calls] == [key(c) for c in tcalls]


def test_joint_off_is_the_per_position_caller(world):
    w = world
    calls = tapi.call_snps_reads(w["reference"], w["raws"], backend="scan",
                                 batch_reads=32, min_coverage=MIN_COV,
                                 prep="python", device="cpu")
    k = nadavca_tpu_torch.AlignConfig().k
    for p in w["truth"]:
        assert any(abs(c.position - p) < k for c in calls), (p, calls)
