"""The port's SNP step under a 9-mer pore model (R10.4.1's k), on the CPU,
held against the benchmark's plain reference ``h100_bench/reference.py``
(NumPy and plain PyTorch in float64, independent of both packages).

Seeded inputs at a small size, made by the benchmark's own generator from the
9-mer configuration and the 5 kHz mix with their sizes cut: a 4 kb genome,
16 reads of 500-1,000 bases at 12.5 samples a base, two batches, one of them
at the wide band. They go through the path the benchmark's cell drives
(``cli._stream_groups``, ``pipeline.assemble_batch``,
``parallel.sharded.shard_batch`` and the step of ``make_sharded_step`` with
genome tables; every kernel wrapper runs its plain version on CPU tensors),
and are compared in order: the per-sample scores, the base log-likelihoods
of every live entry, the coverage, votes and calls, and the genome tables
against a direct recomputation of the substituted levels. The comparison's
numbers and limits are the benchmark's (``h100_bench/limits``); the
log-likelihoods rounded through bfloat16 must fail it.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100_bench import cell as bench_cell  # noqa: E402
from h100_bench import gen, reference  # noqa: E402
from nadavca_tpu_torch import api, cli  # noqa: E402
from nadavca_tpu_torch import call as callmod  # noqa: E402
from nadavca_tpu_torch import pipeline  # noqa: E402
from nadavca_tpu_torch.config import AlignConfig  # noqa: E402
from nadavca_tpu_torch.genome import Contig, Genome  # noqa: E402
from nadavca_tpu_torch.kmer_model import KmerModel  # noqa: E402
from nadavca_tpu_torch.parallel import sharded  # noqa: E402

CELL = "ecoli_k12_r1041_9mer.snp_long_5khz"
SEED = 2 ** 31 + 170917
K = 9


def _load(*parts):
    with open(os.path.join(ROOT, "h100_bench", *parts)) as f:
        return json.load(f)


LIMITS = _load("limits", CELL + ".json")


def _small():
    """The 9-mer configuration and the 5 kHz mix at a CPU test's size."""
    conf = _load("configs", "ecoli_k12_r1041_9mer.json")
    conf["genome"]["length"] = 4000
    conf["align"]["adaptive_band_threshold"] = 9000      # a batch at the wide band
    traffic = _load("traffic", "snp_long_5khz.json")
    traffic.update(batch_reads=8, batches=2, snp_rate=0.005,
                   lengths={"kind": "lognormal", "median": 720, "sigma_ln": 0.25,
                            "min": 500, "max": 1000})
    return conf, traffic


@pytest.fixture(scope="module")
def world():
    """The program's step over the small pool, and the reference's answers."""
    conf, traffic = _small()
    align = conf["align"]
    assert align["k"] == K and traffic["mean_dwell"] == 12.5
    inputs = gen.make_inputs(conf, traffic, SEED, device="cpu")
    cfg = AlignConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in align.items()})
    model = KmerModel(K, inputs.level_mean, inputs.level_std)
    genome = Genome([Contig(inputs.contig, inputs.ref)])
    G = len(inputs.ref)
    mesh = sharded.make_mesh(1, "cpu")
    subst = api._maybe_subst(genome, model, cfg, "auto", mesh.devices[0])
    assert subst is not None and subst.k == K
    tables = sharded.replicate_tables(mesh, subst)

    index = {rid: i for i, rid in enumerate(inputs.read_ids)}
    pool = []
    for group in cli._stream_groups(bench_cell._records(inputs), traffic["batch_reads"],
                                    cfg):
        if len(group) < traffic["batch_reads"]:
            continue
        gcfg = cli._cfg_for_group(cfg, group)
        batch = pipeline.assemble_batch(group, model, gcfg,
                                        pad_reads_to=cli._shard_rows(gcfg, mesh,
                                                                     len(group)))
        pool.append(bench_cell.PoolBatch(gcfg, batch, [index[r.read_id] for r in group],
                                         batch.window_start.astype(np.int64)))
    state = sharded.make_accumulators_sharded(mesh, G)
    scores = []
    with bench_cell._Recorder(callmod) as rec:
        for pb in pool:
            step = sharded.make_sharded_step(mesh, pb.cfg, G, genome_sharded=False,
                                             with_path=False, merge_deferred=False)
            blocks = sharded.shard_batch(mesh, pb.batch, model, pb.cfg, "auto", tables,
                                         window_start=pb.window_start)
            score, *state = step(blocks, *state)
            scores.append(score.numpy())
    lls = [ll.numpy() for ll in rec.got]
    acc, cov, votes = (s[0].numpy() for s in state)
    calls = callmod.call_snps(acc, cov, inputs.ref, inputs.contig, cfg,
                              min_coverage=int(conf["min_coverage"]), votes=votes)

    t_len = [len(s) for s in inputs.signal]
    ref_batches = reference.group(t_len, inputs.bases, align, traffic["batch_reads"])
    answers = {}
    for rb in ref_batches:
        for m in rb.members:
            answers[m] = reference.read_answers(
                inputs.signal[m], inputs.path[m], inputs.window(m), rb, align,
                inputs.level_mean, inputs.level_std)
    return dict(conf=conf, traffic=traffic, align=align, inputs=inputs, cfg=cfg,
                model=model, genome=genome, subst=subst, pool=pool, scores=scores,
                lls=lls, acc=acc, cov=cov, votes=votes, calls=calls,
                ref_batches=ref_batches, answers=answers)


def test_the_pool_is_the_references_batching(world):
    pool, ref_batches = world["pool"], world["ref_batches"]
    assert len(pool) == len(ref_batches) == 2
    for pb, rb in zip(pool, ref_batches):
        assert (pb.members, pb.T, pb.L, pb.band) == (rb.members, rb.T, rb.L, rb.band)
    assert sorted(pb.band for pb in pool) == [128, 256]
    # 12.5 samples a base: every read's signal is about 12.5 times its k-mers
    inputs = world["inputs"]
    ratio = [len(inputs.signal[m]) / (inputs.bases[m] - K + 1)
             for pb in pool for m in pb.members]
    assert 11.5 < float(np.mean(ratio)) < 13.5


def _pairs(world, round_ll=None):
    """(program scores, reference score, samples, program (L, 4), reference
    (L, 4)) of every read of the pool, as the benchmark's check takes them."""
    inputs, out = world["inputs"], []
    for b, pb in enumerate(world["pool"]):
        for r, m in enumerate(pb.members):
            s_ref, ll_ref = world["answers"][m]
            ll = world["lls"][b][r]
            if round_ll is not None:
                ll = torch.from_numpy(ll).to(round_ll).float().numpy()
            out.append(([float(world["scores"][b][r])], s_ref, len(inputs.signal[m]), ll,
                        ll_ref))
    return out


def test_scores_against_the_reference(world):
    gaps = bench_cell.read_gaps(_pairs(world))
    assert gaps["score_gap_per_sample"] <= LIMITS["score_gap_per_sample"], gaps


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_log_likelihoods_against_the_reference(world, precision):
    """Every live (position, base) entry of every read, within 0.05 + 1e-4 of
    the reference's value. The program's own float32 values pass; the same
    values rounded through bfloat16 are off at more entries than the limit
    allows, so the comparison catches a lower precision."""
    pairs = _pairs(world, torch.bfloat16 if precision == "bfloat16" else None)
    live = sum(int((ll_ref != 0).any(axis=1).sum()) for *_, ll_ref in pairs)
    assert live > 8000
    off = bench_cell.read_gaps(pairs)["ll_off_share"]
    if precision == "float32":
        assert off <= LIMITS["ll_off_share"], off
        for *_, ll, ll_ref in pairs:        # the same positions are masked
            assert np.array_equal((ll != 0).any(axis=1), (ll_ref != 0).any(axis=1))
    else:
        assert off > LIMITS["ll_off_share"], off


def test_coverage_votes_and_calls_exactly(world):
    inputs, pool, align = world["inputs"], world["pool"], world["align"]
    G = len(inputs.ref)
    members = [m for pb in pool for m in pb.members]
    cov_ref = reference.coverage(inputs.start[members], inputs.bases[members],
                                 inputs.strand[members], G)
    assert np.array_equal(world["cov"].astype(np.int64), cov_ref)
    assert int((cov_ref >= 3).sum()) > 500
    acc_ref = votes_ref = 0
    for pb, ll in zip(pool, world["lls"]):
        m = pb.members
        a, v = reference.scatter(torch.from_numpy(ll[:len(m)]), inputs.start[m],
                                 inputs.bases[m], inputs.strand[m], G,
                                 align["snp_ll_clip"], align["snp_vote_margin"])
        acc_ref, votes_ref = acc_ref + a.numpy(), votes_ref + v.numpy()
    assert np.array_equal(world["votes"].astype(np.int64), votes_ref)
    gap = (np.abs(world["acc"].astype(np.float64) - acc_ref).max()
           / np.abs(acc_ref).max())
    assert gap <= LIMITS["acc_rel_gap"], gap
    want, near = reference.call_snps(world["acc"], world["cov"], world["votes"],
                                     inputs.ref, align, int(world["conf"]["min_coverage"]))
    got = {c.position: "ACGT".index(c.alt_base) for c in world["calls"]}
    assert got and {g for g in set(want) | set(got) if want.get(g) != got.get(g)} <= near
    # most calls are SNPs planted where three reads or more cover the genome
    planted = set(np.flatnonzero(inputs.sample != inputs.ref).tolist())
    assert len(set(got) & planted) >= max(5, len(got) // 2), (sorted(got), planted)


def test_edge_mask_drops_8_positions_at_each_read_end(world):
    """With genome tables a window clipped by the read's ends (fewer than k
    live slots) is masked: k - 1 = 8 positions at each end of every read
    give 0, and the next position in is scored."""
    inputs, live_in = world["inputs"], 0
    n = 0
    for pb, ll in zip(world["pool"], world["lls"]):
        for r, m in enumerate(pb.members):
            w = int(inputs.bases[m])
            assert not ll[r, :K - 1].any() and not ll[r, w - K + 1:].any(), m
            live_in += int(ll[r, K - 1].any()) + int(ll[r, w - K].any())
            n += 2
    assert live_in >= 0.75 * n, (live_in, n)


def _direct_levels(codes, g, j, b, model):
    """The level of slot j of position g under base b, from the k-mer
    itself: the k bases from g - k + 1 + j, base g replaced by b."""
    s = g - (K - 1) + j
    kmer = codes[s:s + K].astype(np.int64)
    kmer[g - s] = b
    idx = 0
    for c in kmer:
        idx = idx * 4 + int(c)
    return model.level_mean[idx], model.level_std[idx]


def test_subst_tables_at_k9(world):
    model, genome, subst = world["model"], world["genome"], world["subst"]
    tab, valid = subst.tab.numpy(), subst.valid.numpy()
    assert tab.shape[:2] == (3, 4 * K)
    Gp = subst.g_total
    G = len(genome.contigs[0].codes)
    concat = np.full(Gp, 4, np.int8)
    concat[:G] = genome.contigs[0].codes
    rc = gen.reverse_complement(concat)
    rng = np.random.default_rng(9)
    for block, codes, lo, hi in ((0, concat, K - 1, G - K + 1),
                                 (Gp, rc, Gp - G + K - 1, Gp - K + 1)):
        # validity: every k-mer of every slot inside the strand's bases
        g_all = np.arange(Gp)
        want_valid = (g_all >= lo) & (g_all < hi)
        assert np.array_equal(valid[block:block + Gp], want_valid)
        for g in rng.integers(lo, hi, 300):
            for j in range(K):
                for b in range(4):
                    mu, sg = _direct_levels(codes, int(g), j, b, model)
                    col = tab[:, j * 4 + b, block + g]
                    assert col[1] == mu
                    np.testing.assert_allclose(col[0], -np.log(np.float64(sg))
                                               - reference.HALF_LOG_2PI, rtol=1e-6)
                    np.testing.assert_allclose(col[2], 0.5 / (np.float64(sg) ** 2),
                                               rtol=1e-6)
    rows = 2 * Gp + 8192
    assert subst.rows_p >= rows and not valid[rows:].any()


def test_the_benchmarks_model_is_the_programs_at_k9():
    """The generator's 9-mer levels are ``KmerModel.synthetic(9)``, the
    model the command line runs at k = 9 without a model file."""
    mean, std = gen.pore_model(K, 20260817)
    synth = KmerModel.synthetic(k=K)
    assert mean.shape == (4 ** K,)
    np.testing.assert_array_equal(mean, synth.level_mean)
    np.testing.assert_array_equal(std, synth.level_std)


def test_k_above_9_raises_before_any_launch():
    pipeline.check_supported(AlignConfig(k=9), "cuda", "cuda")
    with pytest.raises(ValueError, match="k=10 exceeds 9"):
        pipeline.check_supported(AlignConfig(k=10), "cuda", "cuda")
    # the plain versions on the CPU, and the fixed rescore, take any k
    pipeline.check_supported(AlignConfig(k=10), "cuda", "cpu")
    pipeline.check_supported(AlignConfig(k=10, snp_rescore="fixed"), "cuda", "cuda")
