"""The 9-mer model (R10.4.1's k) on the card: ``cli snp`` with a
configuration of k 9 against the same job through the plain versions on the
CPU, and the K = 9 rescore tile of both entry points against its plain
version at the benchmark's wide shape (T 22,016, band 256).

These tests need an NVIDIA GPU and ``nvcc``; on a machine without one they
skip. Run them on the card with

    python -m pytest tests/test_torch_card_kmer9.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(4)

from nadavca_tpu_torch.config import AlignConfig

pytestmark = pytest.mark.cuda

K = 9
DWELL = 12.5        # samples a base: 5 kHz at 400 bases/s


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    return torch.device("cuda")


def _world(n_reads, bases, G=200_000, region=(50_000, 70_000), seed=17):
    """A genome of ``G`` bases, SNPs planted in the sample inside ``region``,
    and ``n_reads`` reads of ``bases`` bases from there, simulated under the
    synthetic 9-mer model at 12.5 samples a base."""
    import nadavca_tpu_torch as nt
    from nadavca_tpu_torch import api
    from nadavca_tpu_torch.genome import Contig, Genome
    from nadavca_tpu_torch.io.simulator import random_genome, simulate_read

    rng = np.random.default_rng(seed)
    model = nt.default_model(K)
    sample = random_genome(rng, length=G)
    name = sample.contigs[0].name
    codes = sample.contigs[0].codes.copy()
    snps = list(range(region[0] + 500, region[1] - 500, 1500))
    for p in snps:
        codes[p] = (codes[p] + 1) % 4
    reference = Genome([Contig(name, codes)])
    reads = [simulate_read(sample, name, model, rng, read_len=bases,
                           start=int(rng.integers(region[0], region[1] - bases)),
                           mean_dwell=DWELL, read_id=f"r9_{i:03d}")
             for i in range(n_reads)]
    return model, sample, reference, snps, reads, [api.raw_read_from_simulated(r)
                                                   for r in reads]


def test_cli_snp_at_k9_gives_the_plain_versions_calls(card, tmp_path):
    """``cli.main(["snp", ...], reads=...)`` with a configuration of k 9 and
    no model file (the synthetic 9-mer model): on the card and on the CPU,
    where every kernel wrapper runs its plain version, the same VCF rows
    (posteriors within 2e-6: the card adds with atomics), the same coverage
    and votes, and accumulators within the benchmark's 1e-3 of their
    largest value."""
    from nadavca_tpu_torch import cli
    from nadavca_tpu_torch.ops import cuda_dp, cuda_rescore
    from nadavca_tpu_torch.utils.checkpoint import load_checkpoint

    model, _, reference, snps, _, raws = _world(96, 1500)
    ref = str(tmp_path / "reference.fasta")
    reference.to_fasta(ref)
    conf = str(tmp_path / "k9.yaml")
    AlignConfig(k=K).to_yaml(conf)
    rows, accs = {}, {}
    for device in ("cuda", "cpu"):
        out, ckpt = str(tmp_path / f"{device}.vcf"), str(tmp_path / f"{device}.npz")
        fills = cuda_dp.viterbi_fill.launches
        tabs = cuda_rescore.rescore_local_tab.launches
        assert cli.main(["snp", ref, "(in memory)", "-o", out, "--configuration", conf,
                         "--backend", "cuda", "--device", device, "--batch-reads", "32",
                         "--min-coverage", "3", "--checkpoint", ckpt], reads=raws) == 0
        ran = (cuda_dp.viterbi_fill.launches > fills,
               cuda_rescore.rescore_local_tab.launches > tabs)
        assert ran == ((device == "cuda"),) * 2, (device, ran)
        rows[device] = [l.rstrip("\n").split("\t") for l in open(out)
                        if not l.startswith("#")]
        accs[device] = load_checkpoint(ckpt)[0][reference.contigs[0].name]
    key = lambda r: r[:5] + [r[7].split(";")[0]]
    assert [key(r) for r in rows["cuda"]] == [key(r) for r in rows["cpu"]]
    np.testing.assert_allclose([float(r[7].split("PP=")[1]) for r in rows["cuda"]],
                               [float(r[7].split("PP=")[1]) for r in rows["cpu"]],
                               atol=2e-6)
    called = {int(r[1]) - 1 for r in rows["cuda"]}
    assert len(called & set(snps)) >= len(snps) // 2, (sorted(called), snps)
    (acc, cov, votes), (acc_p, cov_p, votes_p) = accs["cuda"], accs["cpu"]
    np.testing.assert_array_equal(cov, cov_p)
    assert int((cov >= 3).sum()) > 10_000
    np.testing.assert_array_equal(votes, votes_p)
    gap = np.abs(acc.astype(np.float64) - acc_p).max() / np.abs(acc_p).max()
    assert gap <= 1e-3, gap


def test_k9_rescore_tiles_at_the_wide_shape(card):
    """32 reads of the 9-mer world whose signal fits 22,016 samples, at the
    band of 256: the fill and the walk on the card give the path and its
    counts, and each K = 9 tile kernel (with genome tables, and without)
    gives its plain version's (R, L, 4) result, on the same card tensors, to
    the bit (both built without fused multiply-adds)."""
    from nadavca_tpu_torch import api, pipeline
    from nadavca_tpu_torch.ops import cuda_dp, cuda_rescore
    from nadavca_tpu_torch.ops.subst_tables import build_subst_tables

    model, _, reference, _, _, raws = _world(48, 1690, seed=23)
    cfg = AlignConfig(k=K, band_width=256)
    records = [r for r in api._preprocess(raws, reference, model, cfg, prep="python")
               if len(r.signal) <= 22016][:32]
    assert len(records) == 32
    batch = pipeline.assemble_batch(records, model, cfg)
    assert batch.x.shape[1] == 22016
    tables = build_subst_tables(reference, model, device=card)
    assert tables.tab.shape[1] == 4 * K
    a = pipeline.stage_batch(batch, model, cfg, "cuda", device=card, subst=tables)
    N = int(a["ids"].shape[1])
    res, _ = cuda_dp.cuda_viterbi_batch(
        a["x"], a["t_len"], a["mu"], a["sigma"], a["n_ref"], a["lo"], a["delta"], cfg,
        count_lanes=cuda_rescore.count_lanes(N))
    codes = a["codes"].contiguous()
    assert codes.shape[1] % cuda_rescore.LT == 0
    t_w = cfg.snp_local_window
    before = [kern.launches for kern in cuda_rescore.KERNELS]

    tab_args = (a["x"], res.path, a["t_len"], res.counts, codes, a["woff"], tables.tab,
                tables.valid, N, cfg, t_w)
    got = cuda_rescore.rescore_local_tab(*tab_args, woff_range=a["woff_range"])
    want = cuda_rescore.rescore_local_tab_plain(*tab_args)
    assert torch.equal(got, want)
    live = (want != 0).any(2)
    assert int(live.sum()) > 0.8 * 32 * 1690
    # the edge mask: k - 1 = 8 positions at each end of every read give 0
    wlen = torch.as_tensor(batch.window_len[:32].astype(np.int64))
    for r in range(32):
        w = int(wlen[r])
        assert not bool(live[r, :K - 1].any()) and not bool(live[r, w - K + 1:w].any())

    args = (a["x"], res.path, a["t_len"], res.counts, codes, a["ids"], a["lm"], a["ls"],
            cfg, t_w)
    got = cuda_rescore.rescore_local(*args)
    want = cuda_rescore.rescore_local_plain(*args)
    assert torch.equal(got, want)
    assert int((want != 0).any(2).sum()) > 0.8 * 32 * 1690
    torch.cuda.synchronize()
    assert [kern.launches for kern in cuda_rescore.KERNELS] == [
        b + n for b, n in zip(before, (1, 1, 2))]


def test_the_level_vectors_come_with_the_tables(card):
    """The 9-mer model's two level vectors (1 MB each) go to the card with
    the genome tables: every batch staged on the tables path gets those same
    device tensors, and its upload counts only the batch's own arrays."""
    from nadavca_tpu_torch import api, pipeline
    from nadavca_tpu_torch.ops.subst_tables import build_subst_tables
    from nadavca_tpu_torch.utils import metrics

    model, _, reference, _, _, raws = _world(16, 800, G=100_000, region=(20_000, 40_000))
    cfg = AlignConfig(k=K)
    records = api._preprocess(raws, reference, model, cfg, prep="python")
    tables = build_subst_tables(reference, model, device=card)
    assert torch.equal(tables.level_mean.cpu(), torch.from_numpy(model.level_mean))
    assert torch.equal(tables.level_std.cpu(), torch.from_numpy(model.level_std))
    c = metrics.PROCESS.counters
    for part in (records[:8], records[8:]):
        batch = pipeline.assemble_batch(part, model, cfg)
        before = c.get("upload_bytes", 0)
        a = pipeline.stage_batch(batch, model, cfg, "cuda", device=card, subst=tables)
        torch.cuda.synchronize()
        assert a["lm"] is tables.level_mean and a["ls"] is tables.level_std
        own = sum(v.nbytes for v in (batch.x, batch.t_len, batch.mu, batch.sigma,
                                     batch.n_ref, batch.bands.lo, batch.bands.delta,
                                     batch.codes, batch.ids))
        assert c.get("upload_bytes", 0) - before == own + 4 * batch.x.shape[0]
