"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; on a machine without one they
skip. Run them on the card with

    python -m pytest tests/test_torch_card.py -q -m cuda --noconftest

``chip_smoke.py`` makes the same comparison at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.ops import cuda_dp

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    return torch.device("cuda")


def _dp_inputs(card, B, seed=3, C=128):
    rng = np.random.default_rng(seed)
    R, T, N = 16, 768, 400
    n_chunks = T // C
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    mu = put(rng.normal(0, 1, (R, N)).astype(np.float32))
    sigma = put(rng.uniform(0.1, 0.4, (R, N)).astype(np.float32))
    delta = rng.integers(0, 20, (R, n_chunks)).astype(np.int32)
    delta[:, 0] = 0
    delta[5, 2] = B + 3                  # the whole row of read 5 goes dead
    lo = np.cumsum(delta, axis=1).astype(np.int32)
    n_ref = put(rng.integers(N // 2, N, R).astype(np.int32))
    t_len = rng.integers(1, T + 1, R).astype(np.int32)
    t_len[:4] = (1, 2, 131, T)           # free start only, half pairs, a full read
    x = put(rng.normal(0, 1, (R, T)).astype(np.float32))
    return x, put(t_len), mu, sigma, put(lo), put(delta), n_ref, C


def _launches():
    return {k.__name__: k.launches for k in cuda_dp.COUNTERS}


def _assert_fill_equal(got, want):
    (decs, v, acc), (p_decs, p_v, p_acc) = got, want
    assert len(decs) == len(p_decs)
    for d, p in zip(decs, p_decs):
        assert torch.equal(d, p)
    live = p_v > -5e29
    # the same operations in the same order; logf may differ in its last bit
    assert float(((v - p_v).abs() * live).max()) <= 1e-3
    torch.testing.assert_close(acc, p_acc, rtol=1e-5, atol=1e-3)


# band widths of one, two, three and eight warps of the fill (1024: the most
# it and the walk take, with more than 48 KB of shared memory); C = 32 makes
# every decision word a chunk of its own
FILL_SHAPES = [(128, 128), (256, 128), (384, 128), (1024, 128), (128, 32), (384, 32)]


@pytest.mark.parametrize("B, C", FILL_SHAPES)
def test_kernels_match_plain_versions(card, B, C):
    x, t_len, mu, sigma, lo_t, dl_t, n_ref, C = _dp_inputs(card, B, C=C)
    cfg = AlignConfig(band_width=B, signal_chunk=C, snp_rescore="fixed")
    before = _launches()
    p_mu, p_sg = cuda_dp.band_gather_plain(mu, sigma, lo_t, B)

    # the fill gathers its band levels itself: against the plain gather + fill
    decs, v, acc = cuda_dp.viterbi_fill(x, t_len, mu, sigma, lo_t, dl_t, n_ref, cfg)
    _assert_fill_equal((decs, v, acc), cuda_dp.viterbi_fill_plain(
        x, t_len, p_mu, p_sg, lo_t, dl_t, n_ref, cfg))

    j_end, _ = cuda_dp.final_slot_and_score(v, acc, lo_t[:, -1], n_ref)
    path = cuda_dp.backtrack(decs, lo_t, dl_t, j_end, C)
    assert torch.equal(path, cuda_dp.backtrack_plain(decs, lo_t, dl_t, j_end, C))
    _assert_walk_counts(decs, lo_t, dl_t, j_end, C, t_len, path)
    want = dict(before)
    for k, n in (("viterbi_fill", 1), ("band_gather_folded", 1), ("backtrack", 2),
                 ("path_counts", 1)):
        want[k] += n
    assert _launches() == want


def _assert_walk_counts(decs, lo_t, dl_t, j_end, C, t_len, path):
    """The walk with counts: the same path, and the plain version's counts,
    t_len of 0 included."""
    t_cnt = t_len.clone()
    t_cnt[4] = 0
    n_lanes = int(lo_t.max()) + decs[0].shape[2] + 8
    path_c, cnt = cuda_dp.backtrack(decs, lo_t, dl_t, j_end, C, t_len=t_cnt,
                                    n_lanes=n_lanes)
    assert torch.equal(path_c, path)
    assert torch.equal(cnt, cuda_dp.path_counts_plain(path, n_lanes, t_cnt))


@pytest.mark.parametrize("B, C", FILL_SHAPES)
def test_skip_and_pair_kernels_match_plain_versions(card, B, C):
    x, t_len, mu, sigma, lo_t, dl_t, n_ref, C = _dp_inputs(card, B, seed=4, C=C)
    mu_b, sg_b = cuda_dp.band_gather_plain(mu, sigma, lo_t, B)
    before = _launches()

    # the skip fill (two planes) and the two-plane walk, through the two
    # names every caller uses
    cfg = AlignConfig(band_width=B, signal_chunk=C, use_skip=True, log_p_skip=-4.6)
    rows = (x, t_len, mu, sigma, lo_t, dl_t, n_ref)
    bands = (x, t_len, mu_b, sg_b, lo_t, dl_t, n_ref)
    decs, v, acc = cuda_dp.viterbi_fill(*rows, cfg)
    assert len(decs) == 2
    _assert_fill_equal((decs, v, acc), cuda_dp.viterbi_fill_plain(*bands, cfg))
    assert not bool((decs[0] & decs[1]).any())      # advance 1 or 2, never both
    j_end, _ = cuda_dp.final_slot_and_score(v, acc, lo_t[:, -1], n_ref)
    path = cuda_dp.backtrack(decs, lo_t, dl_t, j_end, C)
    assert torch.equal(path, cuda_dp.backtrack_plain(decs, lo_t, dl_t, j_end, C))
    _assert_walk_counts(decs, lo_t, dl_t, j_end, C, t_len, path)
    live = torch.arange(path.shape[1], device=card)[None, 1:] < t_len[:, None]
    step = (path[:, 1:] - path[:, :-1]) * live
    assert int(step.max()) == 2 and int(step.min()) >= 0

    # the disabled skip (log_p_skip = -1e30, the default): sums of two such
    # numbers stay finite (a cell dead for several steps may still set a skip
    # bit; no path reaches it)
    cfg_off = AlignConfig(band_width=B, signal_chunk=C, use_skip=True)
    got = cuda_dp.viterbi_fill(*rows, cfg_off)
    _assert_fill_equal(got, cuda_dp.viterbi_fill_plain(*bands, cfg_off))
    assert bool(torch.isfinite(got[1]).all()) and bool(torch.isfinite(got[2]).all())

    # the two-sample fill: one plane, the single-step fill's outputs; it
    # gathers its band levels itself, and equals the plain gather and pair
    # fill to the bit
    cfg_pair = AlignConfig(band_width=B, signal_chunk=C, dp_pair_step=True)
    got = cuda_dp.viterbi_fill(*rows, cfg_pair)
    assert len(got[0]) == 1
    _assert_fill_exact(got, cuda_dp.viterbi_fill_pair_plain(*bands, cfg_pair))
    single = cuda_dp.viterbi_fill(*rows, AlignConfig(band_width=B, signal_chunk=C))
    torch.testing.assert_close(got[2] + got[1].max(1).values,
                               single[2] + single[1].max(1).values,
                               rtol=1e-5, atol=2e-3)
    torch.cuda.synchronize()
    want = dict(before, viterbi_fill_skip=before["viterbi_fill_skip"] + 2,
                backtrack_skip=before["backtrack_skip"] + 2,
                path_counts=before["path_counts"] + 1,
                viterbi_fill_pair=before["viterbi_fill_pair"] + 1,
                viterbi_fill=before["viterbi_fill"] + 1,
                band_gather_folded=before["band_gather_folded"] + 4)
    assert _launches() == want


def _assert_fill_exact(got, want):
    (decs, v, acc), (p_decs, p_v, p_acc) = got, want
    assert len(decs) == len(p_decs)
    for d, p in zip(decs, p_decs):
        assert torch.equal(d, p)
    assert torch.equal(v, p_v) and torch.equal(acc, p_acc)


@pytest.mark.parametrize("B", [96] + list(range(128, 1025, 128)))
def test_pair_fill_at_every_width(card, B):
    """The two-sample fill at every band width the fills take up to 1024 (and
    at 96, a width that is not a multiple of 32 * S: the last warp's lanes
    past the band run idle), on reads with odd lengths, against the plain
    band gather and pair fill, to the bit."""
    import types

    x, t_len, mu, sigma, lo_t, dl_t, n_ref, C = _dp_inputs(card, B, seed=B)
    d = AlignConfig()
    cfg = (AlignConfig(band_width=B, dp_pair_step=True) if B % 128 == 0 else
           types.SimpleNamespace(band_width=B, signal_chunk=C, dp_pair_step=True,
                                 use_skip=False, log_p_stay=d.log_p_stay,
                                 log_p_move=d.log_p_move))
    rows = (x, t_len, mu, sigma, lo_t, dl_t, n_ref)
    before = cuda_dp.viterbi_fill_pair.launches
    got = cuda_dp.viterbi_fill_pair(*rows, cfg)
    mu_b, sg_b = cuda_dp.band_gather_plain(mu, sigma, lo_t, B)
    _assert_fill_exact(got, cuda_dp.viterbi_fill_pair_plain(x, t_len, mu_b, sg_b, lo_t,
                                                            dl_t, n_ref, cfg))
    assert cuda_dp.viterbi_fill_pair.launches == before + 1
    assert bool((got[0][0] != 0).any())


def _kmer_inputs(codes, k, N, seed):
    """The window's k-mer ids (-1 over a non-base) and a random k-mer model,
    for the rescore without tables."""
    from nadavca_tpu_torch import kmer_ids

    rng = np.random.default_rng(seed)
    dev = codes.device
    ids = np.stack([kmer_ids(c.astype(np.int8), k)[:N]
                    for c in codes.cpu().numpy()]).astype(np.int32)
    lm = rng.normal(0, 1, 4 ** k).astype(np.float32)
    ls = rng.uniform(0.1, 0.4, 4 ** k).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (ids, lm, ls))


def _local_tab_inputs(dev, T, k, seed, R=8, L=256, rows_p=4096):
    """Dwell paths (reads 0 and 5 dwell 2000 samples inside tile 0, so from
    T = 2304 on the span mask trips), the walk's counts of them, window codes
    with a few non-bases, and random genome tables with both ends of the
    table among the offsets."""
    from nadavca_tpu_torch.ops import cuda_rescore

    rng = np.random.default_rng(seed)
    N = L - k + 1
    codes = rng.integers(0, 4, (R, L)).astype(np.int32)
    codes[3, 100:104] = 4
    path = np.zeros((R, T), np.int32)
    t_len = np.zeros(R, np.int32)
    for r in range(R):
        dwell = rng.integers(4, 12, N)
        if r in (0, 5):
            dwell[30:50] = 100
        p = np.repeat(np.arange(N), dwell)[:T] + (3 if r == 2 else 0)
        t_len[r] = len(p)
        path[r, :len(p)] = p
        path[r, len(p):] = p[-1]
    k4 = 4 * k
    sg = rng.uniform(0.1, 0.4, (k4, rows_p)).astype(np.float32)
    tab = np.stack([(-np.log(sg) - 0.9189385).astype(np.float32),
                    rng.normal(0, 1, (k4, rows_p)).astype(np.float32),
                    (0.5 / (sg * sg)).astype(np.float32)])
    woff = rng.integers(0, rows_p - L + 1, R).astype(np.int32)
    woff[0], woff[-1] = 0, rows_p - L
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    path_t, t_len_t = put(path), put(t_len)
    cnt = cuda_dp.path_counts_plain(path_t, cuda_rescore.count_lanes(N), t_len_t)
    return (put(rng.normal(size=(R, T)).astype(np.float32)), path_t, t_len_t, cnt,
            put(codes), put(woff), put(tab), put(rng.random(rows_p) > 0.05), N)


@pytest.mark.parametrize("k", [6, 3, 8, 9])
def test_rescore_kernels_match_plain_versions(card, k):
    from nadavca_tpu_torch.ops import cuda_rescore

    R, t_w = 5, 96
    cfg = AlignConfig(k=k)
    before = [kern.launches for kern in cuda_rescore.KERNELS]
    counts_before = cuda_dp.path_counts.launches

    # K3, the walk's counts on random words and a band that moves: integer
    # work, equal
    rng = np.random.default_rng(1)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    Tc, C, B = 3072, 128, 128
    dec = np.packbits(rng.random((Tc // 32, R, B, 32)) < 0.12, axis=-1,
                      bitorder="little").view(np.int32)[..., 0]
    dl = rng.integers(0, 20, (R, Tc // C)).astype(np.int32)
    dl[:, 0] = 0
    lo_c = np.cumsum(dl, axis=1).astype(np.int32)
    j_end = put(rng.integers(0, B, R).astype(np.int32))
    t_len_t = put(np.asarray([Tc, 1, 0, Tc // 2, Tc - 7], np.int32))
    decs = (put(dec),)
    path_t, cnt = cuda_dp.backtrack(decs, put(lo_c), put(dl), j_end, C, t_len=t_len_t,
                                    n_lanes=384)
    p_path = cuda_dp.backtrack_plain(decs, put(lo_c), put(dl), j_end, C)
    assert torch.equal(path_t, p_path)
    assert torch.equal(cnt, cuda_dp.path_counts_plain(p_path, 384, t_len_t))

    # K5 and K6, each with K4 and the glue folded in: the slab rule with a
    # TMA copy (T a multiple of 4), with the threads' copy (rows not 16-byte
    # aligned), and below T = 2304 (the whole row, indices clamped); the same
    # operations in the same order as the plain composition (-fmad=false),
    # so equal to the bit
    for T_loc in (3000, 2561, 2000):
        a = _local_tab_inputs(card, T_loc, k, seed=k + T_loc)
        got = cuda_rescore.rescore_local_tab(*a, cfg, t_w)
        want = cuda_rescore.rescore_local_tab_plain(*a, cfg, t_w)
        assert torch.equal(got, want), T_loc
        assert bool((want != 0).any(2).sum() > 200), T_loc
        x_l, path_l, t_len_l, cnt_l, codes_l = a[:5]
        ids, lm, ls = _kmer_inputs(codes_l, k, a[-1], seed=T_loc)
        args = (x_l, path_l, t_len_l, cnt_l, codes_l, ids, lm, ls, cfg, t_w)
        got = cuda_rescore.rescore_local(*args)
        want = cuda_rescore.rescore_local_plain(*args)
        assert torch.equal(got, want), T_loc
        live = (want != 0).any(2)
        assert bool(live.sum() > 200) and not bool(live[3, 100:104].any()), T_loc
    torch.cuda.synchronize()
    assert [kern.launches for kern in cuda_rescore.KERNELS] == [
        b + n for b, n in zip(before, (3, 3, 6))]
    assert cuda_dp.path_counts.launches == counts_before + 1
    a = list(_local_tab_inputs(card, 3000, k, seed=0))
    a[5] = a[5] + 1                          # the last read's offset leaves the table
    with pytest.raises(ValueError, match="leave the table"):
        cuda_rescore.rescore_local_tab(*a, cfg, t_w)


def test_local_windows_on_the_card_needs_the_walks_counts(card):
    """On a CUDA tensor the segment counts come from the walk: without them
    the rescore raises, and there is no second route that computes them."""
    from nadavca_tpu_torch.ops import cuda_rescore

    R, T, L, k = 2, 512, 128, 6
    path = torch.arange(T, dtype=torch.int32, device=card).repeat(R, 1) // 8
    t_len = torch.full((R,), T, dtype=torch.int32, device=card)
    codes = torch.zeros((R, L), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="come from the walk"):
        cuda_rescore.local_windows(path, t_len, codes, L - k + 1, k, 32)
    cnt = cuda_dp.path_counts_plain(path, cuda_rescore.count_lanes(L - k + 1), t_len)
    S, W, _, _, _ = cuda_rescore.local_windows(path, t_len, codes, L - k + 1, k, 32,
                                               cnt=cnt)
    assert S[0, :8].tolist() == [0, 0, 0, 0, 0, 0, 8, 16] and int(W[0, 0]) == 8


def test_a_cpu_run_launches_no_kernel(card):
    from nadavca_tpu_torch.ops import cuda_rescore

    cpu = torch.device("cpu")
    before = [kern.launches for kern in cuda_dp.COUNTERS + cuda_rescore.KERNELS]
    a = _local_tab_inputs(cpu, 2600, 6, 0)
    cuda_rescore.rescore_local_tab(*a, AlignConfig(), 32)
    cuda_rescore.rescore_local(*a[:5], *_kmer_inputs(a[4], 6, a[-1], 0), AlignConfig(),
                               32)
    assert [kern.launches for kern in cuda_dp.COUNTERS + cuda_rescore.KERNELS] == before


def test_call_snps_at_band_width_384(card):
    """A band wider than 256 slots end to end on the card (the walk took at
    most 256 before): the same calls and alignments as the CPU run of the
    same reads, where every wrapper runs its plain version."""
    import nadavca_tpu_torch as nt
    from nadavca_tpu_torch import api
    from nadavca_tpu_torch.genome import Contig, Genome
    from nadavca_tpu_torch.io.simulator import random_genome, simulate_read

    rng = np.random.default_rng(6)
    model = nt.default_model()
    sample = random_genome(rng, length=4000)
    codes = sample.contigs[0].codes.copy()
    for p in (700, 1500, 2300, 3100):
        codes[p] = (codes[p] + 1) % 4
    reference = Genome([Contig(sample.contigs[0].name, codes)])
    reads = [simulate_read(sample, sample.contigs[0].name, model, rng, read_len=700,
                           read_id=f"r{i:03d}") for i in range(48)]
    raws = [api.raw_read_from_simulated(r) for r in reads]
    cfg = AlignConfig(band_width=384)
    kw = dict(config=cfg, model=model, batch_reads=32, prep="python")
    before = _launches()
    calls = api.call_snps_reads(reference, raws, device="cuda", **kw)
    alns = api.align_reads(reference, raws, device="cuda", **kw)
    torch.cuda.synchronize()
    got = _launches()
    assert got["backtrack"] > before["backtrack"]
    assert got["band_gather_folded"] - before["band_gather_folded"] == got["viterbi_fill"] - before["viterbi_fill"]
    c_calls = api.call_snps_reads(reference, raws, device="cpu", **kw)
    c_alns = api.align_reads(reference, raws, device="cpu", **kw)
    key = lambda c: (c.contig, c.position, c.ref_base, c.alt_base, c.coverage)
    assert [key(c) for c in calls] == [key(c) for c in c_calls] and len(calls) >= 3
    assert len(alns) == len(c_alns) >= 40
    same = sum(np.array_equal(a.seg_start, b.seg_start) for a, b in zip(alns, c_alns))
    # a read may differ only by a tie between identical levels (logf on the
    # card, log on the CPU); none did on this seed
    assert same == len(alns)
    for a, b in zip(alns, c_alns):
        assert abs(a.score - b.score) <= 2e-3 * max(1.0, abs(b.score))
        np.testing.assert_allclose(a.base_loglik, b.base_loglik, rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="exceeds 1024"):
        api.call_snps_reads(reference, raws[:1], config=AlignConfig(band_width=1152),
                            model=model, device="cuda")


def test_align_reads_with_pair_step(card):
    """``dp_pair_step=True`` end to end on the card: the two-sample fill
    gathering its own band levels, then the walk and the local rescore. The
    same alignments as the CPU run of the same reads, where the plain
    versions run the same operations; a read may differ only where a sample
    sits on one of two positions with identical levels (logf on the card, log
    on the CPU, can break such a tie either way). The pair body's own path
    defect is the same on both sides."""
    import nadavca_tpu_torch as nt
    from nadavca_tpu_torch import api
    from nadavca_tpu_torch.io.simulator import random_genome, simulate_read

    rng = np.random.default_rng(8)
    model = nt.default_model()
    genome = random_genome(rng, length=3000)
    reads = [simulate_read(genome, genome.contigs[0].name, model, rng, read_len=500,
                           read_id=f"p{i:03d}") for i in range(40)]
    raws = [api.raw_read_from_simulated(r) for r in reads]
    kw = dict(config=AlignConfig(dp_pair_step=True), model=model, batch_reads=32,
              prep="python")
    before = _launches()
    alns = api.align_reads(genome, raws, device="cuda", **kw)
    torch.cuda.synchronize()
    got = _launches()
    n_b = got["viterbi_fill_pair"] - before["viterbi_fill_pair"]
    assert n_b == 2 and got["viterbi_fill"] == before["viterbi_fill"]
    assert got["band_gather_folded"] - before["band_gather_folded"] == n_b
    c_alns = api.align_reads(genome, raws, device="cpu", **kw)
    assert [a.read_id for a in alns] == [a.read_id for a in c_alns] and len(alns) >= 36
    records = {r.read_id: r for r in api._preprocess(raws, genome, model, kw["config"],
                                                      prep="python")}
    n_tied = 0
    for a, b in zip(alns, c_alns):
        assert abs(a.score - b.score) <= 2e-3 * max(1.0, abs(b.score))
        if np.array_equal(a.seg_start, b.seg_start) and np.array_equal(a.seg_end, b.seg_end):
            np.testing.assert_allclose(a.base_loglik, b.base_loglik, rtol=1e-5, atol=1e-3)
            continue
        n = int(max(a.seg_end.max(), b.seg_end.max()))
        pa, pb = np.full(n, -1), np.full(n, -1)
        for p_, al in ((pa, a), (pb, b)):
            for pos in np.nonzero(al.seg_start >= 0)[0]:
                p_[al.seg_start[pos]:al.seg_end[pos]] = pos
        t = np.nonzero(pa != pb)[0]
        mu, sigma = records[a.read_id].mu, records[a.read_id].sigma
        assert ((pa[t] >= 0) & (pb[t] >= 0)).all()
        assert ((mu[pa[t]] == mu[pb[t]]) & (sigma[pa[t]] == sigma[pb[t]])
                & (np.abs(pa[t] - pb[t]) <= 2)).all(), a.read_id
        n_tied += 1
    assert n_tied <= 2, n_tied


def test_cli_snp_with_native_prep_gives_the_api_calls(card, tmp_path):
    """``cli.main(["snp", ...], reads=...)`` on the card, with the native prep
    on two threads, streams, buckets and accumulates differently from
    ``api.call_snps_reads`` and gives its calls and coverage (the card adds
    with atomics, so posteriors may differ in their last bits)."""
    import nadavca_tpu_torch as nt
    from nadavca_tpu_torch import api, cli
    from nadavca_tpu_torch.genome import Contig, Genome
    from nadavca_tpu_torch.io.simulator import random_genome, simulate_read

    rng = np.random.default_rng(9)
    model = nt.default_model()
    sample = random_genome(rng, length=3000)
    codes = sample.contigs[0].codes.copy()
    for p in (600, 1400, 2200):
        codes[p] = (codes[p] + 1) % 4
    reference = Genome([Contig(sample.contigs[0].name, codes)])
    reads = [simulate_read(sample, sample.contigs[0].name, model, rng, read_len=600,
                           read_id=f"c{i:03d}") for i in range(64)]
    raws = [api.raw_read_from_simulated(r) for r in reads]
    ref = str(tmp_path / "reference.fasta")
    reference.to_fasta(ref)
    out = str(tmp_path / "calls.vcf")
    before = _launches()
    assert cli.main(["snp", ref, "(in memory)", "-o", out, "--backend", "cuda",
                     "--device", "cuda", "--prep", "native", "--workers", "2",
                     "--batch-reads", "32", "--min-coverage", "2"], reads=raws) == 0
    assert _launches()["viterbi_fill"] > before["viterbi_fill"]
    calls = api.call_snps_reads(reference, raws, backend="cuda", batch_reads=32,
                                min_coverage=2, prep="native", device="cuda")
    got = [l.split("\t") for l in open(out) if not l.startswith("#")]
    assert [(c[0], int(c[1]) - 1, c[3], c[4], c[7].split(";")[0]) for c in got] == [
        (c.contig, c.position, c.ref_base, c.alt_base, f"DP={c.coverage}")
        for c in calls]
    assert len(calls) >= 3


def test_sharded_step_on_one_card_twice_equals_one_device(card):
    """``parallel.sharded`` on the mesh ``[cuda:0, cuda:0]``: 40 reads padded
    to 128 rows, so the second shard is all padding (rows of the minimal
    live length); every layout and merge cadence gives the one-device
    accumulators (``cov``, ``votes`` exact, ``acc`` as the JAX tests hold
    it), with the kernels launched once a shard."""
    import nadavca_tpu_torch as nt
    from nadavca_tpu_torch import api, pipeline
    from nadavca_tpu_torch.io.simulator import random_genome, simulate_read
    from nadavca_tpu_torch.ops.subst_tables import build_subst_tables
    from nadavca_tpu_torch.parallel import sharded

    rng = np.random.default_rng(10)
    model = nt.default_model()
    cfg = AlignConfig()
    genome = random_genome(rng, length=4096)
    reads = [simulate_read(genome, genome.contigs[0].name, model, rng, read_len=500,
                           read_id=f"s{i:03d}") for i in range(40)]
    records = api._preprocess([api.raw_read_from_simulated(r) for r in reads], genome,
                              model, cfg, prep="python")
    batch = pipeline.assemble_batch(records, model, cfg, pad_reads_to=128)
    G = len(genome.contigs[0])
    tables = build_subst_tables(genome, model, device=card)

    def run(mesh, gs, md):
        blocks = sharded.shard_batch(mesh, batch, model, cfg, "cuda",
                                     sharded.replicate_tables(mesh, tables))
        accs = sharded.make_accumulators_sharded(mesh, G, gs, md)
        before = _launches()
        _, *accs = sharded.make_sharded_step(mesh, cfg, G, gs, with_path=False,
                                             merge_deferred=md)(blocks, *accs)
        torch.cuda.synchronize()
        n = _launches()["viterbi_fill"] - before["viterbi_fill"]
        assert n == len(mesh.devices), n
        if md:
            accs = sharded.make_merge_fn(mesh, G, gs)(*accs)
        return [sharded.fetch(mesh, a, gs) for a in accs], blocks

    one, _ = run(sharded.make_mesh(1, card), False, False)
    two = sharded.Mesh((torch.device("cuda", 0),) * 2)
    for gs, md in ((False, False), (True, False), (False, True), (True, True)):
        got, blocks = run(two, gs, md)
        assert [b.batch.n_reads for b in blocks] == [len(records), 0]
        np.testing.assert_array_equal(got[1], one[1])
        np.testing.assert_array_equal(got[2], one[2])
        np.testing.assert_allclose(got[0], one[0], rtol=1e-4, atol=1e-2)


def test_long_reads_above_the_last_bucket_edge(card):
    """8 reads of 8,000 bases (above 65,536 samples each, so the batch pads
    to 131,072) at the long band of 256 through ``api.call_snps``; the same
    batch against the ``scan`` twin on the card (``parity.hold_against_scan``,
    as ``chip_smoke.py`` holds it): paths equal but for ties between identical
    levels, the twin's local rescore of the kernels' path within 2e-3 of the
    kernels' on interior positions the span rule keeps."""
    import nadavca_tpu_torch as nt
    from nadavca_tpu_torch import api, pipeline
    from nadavca_tpu_torch.io.simulator import random_genome, simulate_read
    from nadavca_tpu_torch.ops import cuda_rescore
    from nadavca_tpu_torch.ops.subst_tables import build_subst_tables

    from nadavca_tpu_torch.utils import parity

    rng = np.random.default_rng(12)
    model = nt.default_model()
    cfg = AlignConfig(band_width=256)
    genome = random_genome(rng, length=32000)
    reads = [simulate_read(genome, genome.contigs[0].name, model, rng, read_len=8000,
                           read_id=f"long{i}") for i in range(8)]
    raws = [api.raw_read_from_simulated(r) for r in reads]
    before = _launches()
    calls = api.call_snps_reads(genome, raws, config=cfg, model=model, batch_reads=8,
                                prep="python", device="cuda")
    torch.cuda.synchronize()
    assert _launches()["viterbi_fill"] - before["viterbi_fill"] == 1
    assert isinstance(calls, list)
    records = api._preprocess(raws, genome, model, cfg, prep="python")
    assert min(len(r.signal) for r in records) > 65536
    tables = build_subst_tables(genome, model, device=card)
    batch = pipeline.assemble_batch(records, model, cfg)
    assert batch.x.shape[1] == 131072
    out = pipeline.align_batch(batch, model, cfg, backend="cuda", device=card,
                               subst=tables)
    a = pipeline.stage_batch(batch, model, cfg, "cuda", device=card, subst=tables)
    res, _ = cuda_dp.cuda_viterbi_batch(
        a["x"], a["t_len"], a["mu"], a["sigma"], a["n_ref"], a["lo"], a["delta"], cfg,
        count_lanes=cuda_rescore.count_lanes(batch.ids.shape[1]))
    assert torch.equal(res.path, out["path"])
    parity.hold_against_scan("long reads", batch, a, out["path"], out["base_loglik"],
                             model, cfg, ll_atol=2e-3, tie_share=parity.LONG_TIE_SHARE)


def _rescore_launches():
    from nadavca_tpu_torch.ops import cuda_rescore

    return {k.__name__: k.launches for k in cuda_rescore.KERNELS}


def _hold_plain(tag, batches, runs, model, cfg, genome, limit):
    """The kernels' outputs on the card against their plain versions on the
    CPU, batch for batch: paths by the run rule (``logf`` on the card, ``log``
    on the CPU, may break a tie either way), rescores within 1e-3 wherever no
    tie moved a window. Returns the plain versions' rescores."""
    from nadavca_tpu_torch import pipeline
    from nadavca_tpu_torch.ops.subst_tables import build_subst_tables
    from nadavca_tpu_torch.utils import parity

    tables = build_subst_tables(genome, model, device="cpu")
    lls = []
    for batch, kern in zip(batches, runs):
        plain = pipeline.align_batch(batch, model, cfg, backend="cuda", device="cpu",
                                     subst=tables)
        path = kern["path"].cpu()
        lim = limit(batch, path, plain["path"]) if callable(limit) else limit
        parity.hold_runs(tag, path, kern["base_loglik"].cpu(), plain["path"],
                         plain["base_loglik"], batch.t_len, batch.mu, batch.sigma, model.k,
                         lim, n_reads=batch.n_reads, ll_atol=1e-3)
        lls.append(plain["base_loglik"])
    return lls


@pytest.mark.parametrize("name", ["n_run", "one_read", "narrow_window", "indel_calls"])
def test_reference_world_on_the_card(card, name):
    """Worlds 1, 2, 3 and 5 of the JAX package's own tests
    (``nadavca_tpu_torch.utils.worlds``: an N run in the reference, a
    one-read batch padded to its tile, a window narrower than the band, 5 %
    indel basecalls) through the kernels with genome tables on the card, as
    ``api.call_snps`` runs them. Against the ``scan`` twin on the card: paths
    by the run rule, rescores within 2e-3 where no tie moved a window, calls
    equal outside the tables' masks. Against the kernels' plain versions on
    the CPU: paths by the run rule, rescores within 1e-3, the same calls."""
    from nadavca_tpu_torch.utils import parity, worlds

    build, limit = worlds.CARD_WORLDS[name]
    w = build()
    before, before_r = _launches(), _rescore_launches()
    got = parity.kernels_against_scan(name, w["batches"], w["model"], w["cfg"], w["genome"],
                                      "cuda", limit, codes=w["codes"],
                                      min_coverage=w["min_coverage"], votes=w["votes"])
    torch.cuda.synchronize()
    n = len(w["batches"])
    assert _launches()["viterbi_fill"] - before["viterbi_fill"] == n
    assert _launches()["path_counts"] - before["path_counts"] == n
    assert _rescore_launches()["rescore_local_tab"] - before_r["rescore_local_tab"] == n
    lls = _hold_plain(f"{name}: card against the plain versions", w["batches"], got["runs"],
                      w["model"], w["cfg"], w["genome"], limit)
    plain_calls = parity.calls_of(w["batches"], lls, w["codes"], "ref", w["cfg"],
                                  w["min_coverage"], w["votes"])
    assert parity.call_keys(got["calls"]) == parity.call_keys(plain_calls)
    if name == "n_run":
        lo, hi = worlds.N_RUN
        assert not any(lo <= c.position < hi for c in got["calls"])
    if name == "indel_calls":
        called = {c.position: c.alt_base for c in got["calls"]}
        assert all(called.get(p) == "ACGT"[b] for p, b in w["truth"].items()), called


# world 9 on the card: the kernels' path may differ from the scan twin's on
# at most this many live samples, each a tie (45 of 120,731 with the plain
# versions on the CPU)
CONTIG_TIES = 70


def test_three_contig_world_on_the_card(card, tmp_path):
    """World 9 (``worlds.three_contigs``: three contigs, reads of every
    contig on both strands, batches that mix them). ``cli snp`` on the card
    gives the calls of the same command on the CPU, where the plain versions
    run (the card adds with atomics: posteriors within 2e-6); the batches of
    eight mixed reads through the kernels with tables against the ``scan``
    twin on the card and against the plain versions on the CPU, by the run
    rule."""
    import nadavca_tpu_torch as nt
    from nadavca_tpu_torch import api, cli, pipeline
    from nadavca_tpu_torch.utils import parity, worlds

    _, reference, reads = worlds.three_contigs()
    raws = [api.raw_read_from_simulated(r) for r in reads]
    ref = str(tmp_path / "reference.fasta")
    reference.to_fasta(ref)
    rows = {}
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.vcf")
        before = _launches()["viterbi_fill"]
        assert cli.main(["snp", ref, "(in memory)", "-o", out, "--backend", "cuda",
                         "--device", device, "--batch-reads", "8", "--min-coverage", "2"],
                        reads=raws) == 0
        assert (_launches()["viterbi_fill"] > before) == (device == "cuda")
        rows[device] = [l.rstrip("\n").split("\t") for l in open(out) if not l.startswith("#")]
    key = lambda r: r[:5] + [r[7].split(";")[0]]
    assert [key(r) for r in rows["cuda"]] == [key(r) for r in rows["cpu"]]
    np.testing.assert_allclose([float(r[7].split("PP=")[1]) for r in rows["cuda"]],
                               [float(r[7].split("PP=")[1]) for r in rows["cpu"]], atol=2e-6)
    assert {r[0] for r in rows["cuda"]} == set(worlds.CONTIGS)

    model, cfg = nt.default_model(), AlignConfig()
    records = api._preprocess(raws, reference, model, cfg, prep="python")
    batches = [pipeline.assemble_batch(records[i:i + 8], model, cfg)
               for i in range(0, len(records), 8)]
    assert all(len(set(b.contigs[:b.n_reads])) == 3 for b in batches)
    got = parity.kernels_against_scan("three contigs", batches, model, cfg, reference,
                                      "cuda", CONTIG_TIES)
    _hold_plain("three contigs: card against the plain versions", batches, got["runs"],
                model, cfg, reference, CONTIG_TIES)


# ---------------------------------------------------------------- the upload

def _long_world(seed, n_reads=256, bases=4000, G=60000):
    """A batch of ``n_reads`` forward reads of ``bases`` bases each, made
    without the simulator: each k-mer's expected level for 8-12 samples plus
    noise, the true path as the anchor path. Returns what the step needs."""
    import nadavca_tpu_torch as nt
    from nadavca_tpu_torch import pipeline
    from nadavca_tpu_torch.anchor import Anchor
    from nadavca_tpu_torch.genome import Contig, Genome
    from nadavca_tpu_torch.ops.subst_tables import build_subst_tables

    rng = np.random.default_rng(seed)
    model = nt.default_model()
    cfg = AlignConfig(band_width=256)
    genome = Genome([Contig("ref", rng.integers(0, 4, G).astype(np.int8))])
    tables = build_subst_tables(genome, model, device="cuda")

    def batch(batch_seed):
        r = np.random.default_rng(batch_seed)
        records = []
        for i in range(n_reads):
            s = int(r.integers(0, G - bases))
            codes = genome.window("ref", s, s + bases, 1)
            mu, sigma = model.expected_signal(codes)
            path = np.repeat(np.arange(len(mu)), r.integers(8, 13, len(mu)))
            x = (mu[path] + 0.3 * sigma[path] * r.standard_normal(len(path)))
            records.append(pipeline.ReadRecord(
                read_id=f"b{batch_seed}r{i}", signal=x.astype(np.float32),
                anchor=Anchor("ref", 1, s, s + bases, np.arange(bases, dtype=np.float64),
                              bases),
                anchor_path=path.astype(np.float64), window_codes=codes))
        return pipeline.assemble_batch(records, model, cfg)

    return dict(model=model, cfg=cfg, G=G, tables=tables, batch=batch)


def _blocking_blocks(mesh, batch, model, cfg, tables):
    """``shard_batch``'s blocks, every array put with the blocking
    ``torch.from_numpy(a).to(device)`` from pageable memory."""
    from nadavca_tpu_torch import pipeline
    from nadavca_tpu_torch.parallel import sharded

    n = len(mesh.devices)
    r = batch.x.shape[0] // n
    out = []
    for i, dev in enumerate(mesh.devices):
        blk = pipeline.batch_rows(batch, i * r, (i + 1) * r)
        put = lambda a: torch.from_numpy(np.array(a)).to(dev)
        off = tables[dev].window_offsets(blk.contigs, blk.window_start, blk.window_len,
                                         blk.strand, padded_len=blk.codes.shape[1])
        staged = dict(
            x=put(blk.x), t_len=put(blk.t_len), mu=put(blk.mu), sigma=put(blk.sigma),
            n_ref=put(blk.n_ref), lo=put(blk.bands.lo), delta=put(blk.bands.delta),
            codes=put(blk.codes), ids=put(blk.ids),
            lm=put(model.level_mean.astype(np.float32)),
            ls=put(model.level_std.astype(np.float32)), woff=put(off),
            woff_range=(int(off.min()), int(off.max())), subst=tables[dev],
            backend="cuda", k=model.k)
        out.append(sharded.Block(dev, blk, staged,
                                 put(blk.window_start.astype(np.int64)),
                                 put(blk.window_len), put(blk.strand)))
    return out


def _run_step(mesh, w, blocks):
    from nadavca_tpu_torch.parallel import sharded

    accs = sharded.make_accumulators_sharded(mesh, w["G"])
    score, *accs = sharded.make_sharded_step(mesh, w["cfg"], w["G"], with_path=False)(
        blocks, *accs)
    return score.cpu(), [sharded.fetch(mesh, a) for a in accs]


def _assert_same_step(got, want):
    (s, (acc, cov, votes)), (s_ref, (acc_ref, cov_ref, votes_ref)) = got, want
    assert torch.equal(s, s_ref)
    np.testing.assert_array_equal(cov, cov_ref)
    np.testing.assert_array_equal(votes, votes_ref)
    # float atomics add in another order from run to run
    assert np.abs(acc - acc_ref).max() <= 1e-5 * np.abs(acc_ref).max()


@pytest.mark.parametrize("n_positions", [1, 2])
def test_async_upload_gives_the_blocking_upload(card, n_positions):
    """Every array of the batch page-locked; ``shard_batch`` on one and on
    two mesh positions (``[cuda:0, cuda:0]``) stages tensors bit-identical
    to the blocking copies, all of its bytes copied without waiting, and the
    step gives the blocking staging's scores and accumulators."""
    from nadavca_tpu_torch.parallel import sharded
    from nadavca_tpu_torch.utils import metrics, upload

    w = _long_world(16, n_reads=64, bases=1500, G=20000)
    batch = w["batch"](1)
    for a in (batch.x, batch.t_len, batch.mu, batch.sigma, batch.n_ref, batch.codes,
              batch.ids, batch.window_start, batch.window_len, batch.strand,
              batch.bands.lo, batch.bands.delta):
        assert upload.tensor_under(a).is_pinned()
    mesh = sharded.Mesh((card,) * n_positions)
    tables = sharded.replicate_tables(mesh, w["tables"])
    c = metrics.PROCESS.counters
    before = (c.get("upload_bytes", 0), c.get("upload_async_bytes", 0))
    blocks = sharded.shard_batch(mesh, batch, w["model"], w["cfg"], "cuda", tables)
    moved = (c["upload_bytes"] - before[0], c["upload_async_bytes"] - before[1])
    assert moved[0] > batch.x.nbytes and moved[0] == moved[1]
    ref = _blocking_blocks(mesh, batch, w["model"], w["cfg"], tables)
    for b, r in zip(blocks, ref, strict=True):
        for name in ("x", "t_len", "mu", "sigma", "n_ref", "lo", "delta", "codes", "ids",
                     "lm", "ls", "woff"):
            assert b.staged[name].dtype == r.staged[name].dtype, name
            assert torch.equal(b.staged[name], r.staged[name]), name
        assert b.staged["woff_range"] == r.staged["woff_range"]
        for name in ("wstart", "wlen", "strand"):
            assert torch.equal(getattr(b, name), getattr(r, name)), name
    _assert_same_step(_run_step(mesh, w, blocks), _run_step(mesh, w, ref))


def test_a_batch_freed_while_its_copies_wait(card):
    """The copy stream held back by a sleeping kernel: the batch is freed on
    the host before its copies run, and another batch of the same shape is
    assembled and staged meanwhile. The host allocator hands the second
    batch other page-locked memory, so the first step still gives the
    blocking staging's results."""
    import dataclasses
    from nadavca_tpu_torch.parallel import sharded
    from nadavca_tpu_torch.utils import upload

    w = _long_world(17, n_reads=64, bases=1500, G=20000)
    mesh = sharded.make_mesh(1, card)
    tables = sharded.replicate_tables(mesh, w["tables"])
    first = w["batch"](1)
    want_first = _run_step(mesh, w, _blocking_blocks(mesh, first, w["model"], w["cfg"],
                                                     tables))
    torch.cuda.synchronize()
    stream = upload.copy_stream(card)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(3_000_000_000)
    blocks = sharded.shard_batch(mesh, first, w["model"], w["cfg"], "cuda", tables)
    blocks = [dataclasses.replace(b, batch=None) for b in blocks]
    del first
    second = w["batch"](2)
    assert not stream.query(), "the first batch's copies ran before the test could free it"
    blocks2 = sharded.shard_batch(mesh, second, w["model"], w["cfg"], "cuda", tables)
    got_first = _run_step(mesh, w, blocks)
    got_second = _run_step(mesh, w, blocks2)
    _assert_same_step(got_first, want_first)
    _assert_same_step(got_second, _run_step(
        mesh, w, _blocking_blocks(mesh, second, w["model"], w["cfg"], tables)))


def test_the_upload_runs_under_the_previous_step(card):
    """Six batches, each uploaded as soon as the step before it is enqueued
    (as the CLI's staging thread does), at most two scores pending; traced:
    no host-to-device copy from pageable memory, every byte copied without
    waiting, and a host-to-device copy runs while a kernel of the step
    before it does."""
    from torch.profiler import ProfilerActivity, profile
    from nadavca_tpu_torch.parallel import sharded
    from nadavca_tpu_torch.utils import metrics

    w = _long_world(18, bases=6000, G=100000)
    mesh = sharded.make_mesh(1, card)
    tables = sharded.replicate_tables(mesh, w["tables"])
    batches = [w["batch"](i) for i in range(2)]
    assert batches[0].x.shape[0] == 256 and batches[0].x.shape[1] > 60000
    step = sharded.make_sharded_step(mesh, w["cfg"], w["G"], with_path=False)

    def stage(i):
        return sharded.shard_batch(mesh, batches[i % 2], w["model"], w["cfg"], "cuda",
                                   tables)

    def loop(state, n):
        pending, blocks = [], stage(0)
        for i in range(n):
            score, *state = step(blocks, *state)
            if i + 1 < n:
                blocks = stage(i + 1)
            pending.append(score)
            while len(pending) > 2:
                pending.pop(0).cpu()
        for s in pending:
            s.cpu()
        return state

    state = loop(sharded.make_accumulators_sharded(mesh, w["G"]), 2)   # warm-up
    c = metrics.PROCESS.counters
    before = (c["upload_bytes"], c["upload_async_bytes"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop(state, 6)
        torch.cuda.synchronize()
    assert c["upload_bytes"] - before[0] == c["upload_async_bytes"] - before[1] > 0
    dev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()]
    h2d = [d for d in dev if "HtoD" in d[0]]
    kernels = [d for d in dev if "Memcpy" not in d[0] and "Memset" not in d[0]]
    assert h2d and kernels
    assert not [n for n, _, _ in h2d if "Pageable" in n], {n for n, _, _ in h2d}
    assert any(a < kb and ka < b for _, a, b in h2d for _, ka, kb in kernels)
