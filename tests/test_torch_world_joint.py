"""World 8 of the JAX package's own tests through the port: the joint
refiner's realistic world (``tests/test_joint_realistic.py``: 16× coverage
of a 4000-base genome, 8 dense SNPs, 5 % indels and 3 % pore skips,
seed 9).

The world is built through both packages and held equal batch for batch.
The port's ``scan`` twin then gives the JAX package's calls with the
joint pass off, and the port's joint pass (``snp_joint_rescore``, on the
CPU) keeps exactly those calls, as the JAX test pins for the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import call as jcall

from nadavca_tpu_torch import call as tcall, joint
from nadavca_tpu_torch.utils import worlds

import jax.numpy as jnp
import torch_worlds as W

GENOME_LEN, READ_LEN, COVERAGE, N_SNPS, SEED, MIN_COV = 4000, 600, 16, 8, 9, 3


def _world(pkg):
    rng = np.random.default_rng(SEED)
    model = pkg.default_model()
    k = model.k
    true_genome = pkg.random_genome(rng, length=GENOME_LEN)
    ref_codes = true_genome["ref"].codes.copy()
    candidates = rng.permutation(np.arange(2 * k, GENOME_LEN - 2 * k))
    positions = []
    for p in candidates:
        if all(abs(p - q) >= 2 * k for q in positions):
            positions.append(int(p))
            if len(positions) == N_SNPS:
                break
    truth = {}
    for p in positions:
        orig = int(ref_codes[p])
        ref_codes[p] = (orig + 1 + int(rng.integers(0, 3))) % 4
        truth[p] = orig
    ref_genome = pkg.Genome.from_dict({"ref": pkg.decode_bases(ref_codes)})
    index = pkg.SeedIndex(ref_genome)
    n_reads = int(np.ceil(COVERAGE * GENOME_LEN / READ_LEN))
    reads = [pkg.simulate_read(
        true_genome, "ref", model, rng, read_len=READ_LEN,
        start=int(rng.integers(0, GENOME_LEN - READ_LEN + 1)),
        strand=1 if rng.random() < 0.5 else -1, mean_dwell=9.0, noise_scale=1.0,
        skip_prob=0.03, **worlds.INDEL) for _ in range(n_reads)]
    recs = sorted(worlds.records(pkg, reads, index, ref_genome), key=lambda r: len(r.signal))
    cfg = pkg.AlignConfig()
    batches = [pkg.assemble_batch(recs[i:i + 128], model, cfg)
               for i in range(0, len(recs), 128)]
    return dict(model=model, codes=ref_codes, truth=truth, reads=reads, records=recs,
                batches=batches, cfg=cfg)


@pytest.fixture(scope="module")
def world():
    j, p = _world(W.JAX), _world(W.PORT)
    W.assert_same_reads(j["reads"], p["reads"])
    assert len(j["batches"]) == len(p["batches"])
    for jb, pb in zip(j["batches"], p["batches"]):
        W.assert_same_batch(jb, pb)
    # the JAX package's accumulators under scan, and the port's
    G = len(p["codes"])
    jacc, jcov, jvotes = jcall.make_accumulators(G, with_votes=True)
    acc, cov, votes = tcall.make_accumulators(G, with_votes=True, device="cpu")
    for jb, pb in zip(j["batches"], p["batches"]):
        jout = W.jax_align(jb, j["model"], j["cfg"], "scan")
        jacc, jcov, jvotes = jcall.accumulate_batch(
            jacc, jcov, jnp.asarray(jout["base_loglik"]), jnp.asarray(jb.window_start),
            jnp.asarray(jb.window_len), jnp.asarray(jb.strand), votes=jvotes, cfg=j["cfg"])
        out = W.port_align(pb, p["model"], p["cfg"], "scan")
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        acc, cov, votes = tcall.accumulate_batch(
            acc, cov, out["base_loglik"], put(pb.window_start), put(pb.window_len),
            put(pb.strand), votes=votes, cfg=p["cfg"])
    jstate = (np.asarray(jacc), np.asarray(jcov), np.asarray(jvotes))
    return j, p, jstate, (acc.numpy(), cov.numpy(), votes.numpy())


def _off(state, codes, cfg, callmod):
    acc, cov, votes = state
    return callmod.call_snps(acc, cov, codes, "ref", cfg, min_coverage=MIN_COV, votes=votes)


def test_joint_off_calls_equal_the_jax_calls(world):
    j, p, jstate, state = world
    np.testing.assert_array_equal(state[1], jstate[1])      # coverage
    np.testing.assert_array_equal(state[2], jstate[2])      # votes
    np.testing.assert_allclose(state[0], jstate[0], atol=2e-2, rtol=1e-5)
    off = _off(state, p["codes"], p["cfg"], tcall)
    W.assert_same_calls(off, _off(jstate, j["codes"], j["cfg"], jcall))
    # the JAX test's sanity: the world exercises the caller
    callable_truth = {q for q in p["truth"] if state[1][q] >= MIN_COV}
    assert len(callable_truth) >= N_SNPS - 2
    assert sum(1 for c in off if c.position in p["truth"]) >= len(callable_truth) - 2


def test_joint_on_keeps_the_calls(world):
    _, p, _, state = world
    acc, cov, votes = state
    recs = p["records"]
    metas = [joint.ReadMeta(r.read_id, r.anchor.contig, int(r.anchor.ref_start),
                            len(r.window_codes), int(r.anchor.strand)) for r in recs]
    on = joint.refine_contig_calls(
        acc, cov, votes, p["codes"], "ref",
        dataclasses.replace(p["cfg"], snp_joint_rescore=True), p["model"], metas,
        {r.read_id: r for r in recs}, min_coverage=MIN_COV, device="cpu")
    off = _off(state, p["codes"], p["cfg"], tcall)
    assert {(c.position, c.alt_base) for c in on} == {(c.position, c.alt_base) for c in off}
