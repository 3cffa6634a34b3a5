"""The port's alignment kernels' plain versions vs the Pallas kernels.

The same numpy inputs (seeded) go through the Pallas kernels in interpret
mode and through ``nadavca_tpu_torch.ops.cuda_dp`` on CPU tensors, where each
wrapper runs its kernel's plain version. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.config import AlignConfig as JaxConfig
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.ops import pallas_dp, pallas_rescore
from nadavca_tpu.sched import build_chunked_bands

from nadavca_tpu_torch import pipeline as tpipe
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.ops import cuda_dp
from nadavca_tpu_torch.sched.bands import ChunkedBands, gather_band_levels


def _make_batch(seed, lens, band_width, chunk=128):
    rng = np.random.default_rng(seed)
    model = default_model()
    genome = random_genome(rng, length=3000)
    reads = [simulate_read(genome, "ref", model, rng, read_len=ln, strand=1,
                           mean_dwell=8.0) for ln in lens]
    R = len(reads)
    T = 128 * ((max(len(r.signal) for r in reads) + 127) // 128)
    L = max(len(r.window_codes) for r in reads)
    N = L - model.k + 1
    x = np.zeros((R, T), np.float32)
    t_len = np.zeros(R, np.int32)
    mu = np.zeros((R, N), np.float32)
    sigma = np.ones((R, N), np.float32)
    n_ref = np.zeros(R, np.int32)
    anchors = np.zeros((R, T), np.float64)
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
    bands = build_chunked_bands(anchors, t_len, n_ref, band_width, chunk)
    return dict(x=x, t_len=t_len, mu=mu, sigma=sigma, n_ref=n_ref,
                lo=bands.lo, delta=bands.delta)


# the fixture of tests/test_pallas_dp.py (R = 8, seed 77, B = 128), and a
# B = 256 case at a small T
CASES = {
    "b128": (77, (200, 350, 260, 150, 300, 180, 220, 330), 128),
    "b256": (17, (60, 45, 70, 50, 65, 40, 55, 30), 256),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    seed, lens, B = CASES[request.param]
    b = _make_batch(seed, lens, B)
    # kernel_unroll=1 only shortens the interpret-mode compile of the TPU
    # kernel; its arithmetic is the same
    jcfg = JaxConfig(band_width=B, signal_chunk=128, read_tile=8, kernel_unroll=1)
    tcfg = AlignConfig(band_width=B, signal_chunk=128, read_tile=8)
    j = {k: jnp.asarray(v) for k, v in b.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    R = b["x"].shape[0]
    n_chunks = b["lo"].shape[1]
    # the JAX side once: gather -> fill -> backtrack, all in interpret mode
    mu_b, sg_b = pallas_dp.band_gather_pallas(j["mu"], j["sigma"], j["lo"], B,
                                              interpret=True)
    lo_cm = j["lo"].T.reshape(n_chunks, R, 1)
    dl_cm = j["delta"].T.reshape(n_chunks, R, 1)
    decs, v_fin, acc = pallas_dp.viterbi_fill_pallas(
        j["x"], j["t_len"], mu_b, sg_b, lo_cm, dl_cm, j["n_ref"], jcfg,
        interpret=True)
    res, _ = pallas_dp.pallas_viterbi_batch(
        j["x"], j["t_len"], j["mu"], j["sigma"], j["n_ref"], j["lo"],
        j["delta"], jcfg, interpret=True, mu_band=mu_b, sg_band=sg_b)
    return dict(np=b, t=t, j=j, jcfg=jcfg, tcfg=tcfg, B=B,
                mu_b=np.array(mu_b), sg_b=np.array(sg_b),
                dec=np.array(decs[0]), v_fin=np.array(v_fin),
                acc=np.array(acc), score=np.array(res.score),
                path=np.array(res.path), final_j=np.array(res.final_j))


def test_band_gather_matches_pallas(case):
    t = case["t"]
    # the plain version of the gather the fills' producer warps make
    mu_b, sg_b = cuda_dp.band_gather_plain(t["mu"], t["sigma"], t["lo"], case["B"])
    # a gather moves values and computes nothing: exact
    np.testing.assert_array_equal(mu_b.numpy(), case["mu_b"])
    np.testing.assert_array_equal(sg_b.numpy(), case["sg_b"])
    # and the numpy oracle of the port agrees (read-major there)
    b = case["np"]
    o_mu, o_sg = gather_band_levels(
        b["mu"], b["sigma"],
        ChunkedBands(b["lo"], b["delta"], 128, case["B"]))
    np.testing.assert_array_equal(mu_b.numpy(), o_mu.transpose(1, 0, 2))
    np.testing.assert_array_equal(sg_b.numpy(), o_sg.transpose(1, 0, 2))


def test_viterbi_fill_matches_pallas(case):
    t = case["t"]
    # the fill gathers its band levels from the rows (case["mu_b"] is what the
    # Pallas band gather made of them: test_band_gather_matches_pallas)
    (dec,), v_fin, acc = cuda_dp.viterbi_fill(
        t["x"], t["t_len"], t["mu"], t["sigma"], t["lo"], t["delta"], t["n_ref"],
        case["tcfg"])
    # decisions: the same expression in the same order on both sides, so the
    # packed words are equal bit for bit — except at exact ties. Two adjacent
    # positions with the same k-mer (a homopolymer run) have identical
    # levels, so V[j] and V[j-1] + (move - stay) can be EQUAL in strict
    # float32, where the strict compare says "stay". XLA's CPU compiler
    # contracts the emission polynomial into fused multiply-adds, which
    # breaks such a tie by its last bit; eager PyTorch (and the CUDA kernel,
    # built with -fmad=false) rounds after every operation. Measured on the
    # seed-77 fixture: 7 of 2.9 million bits, all in read 5 at window
    # position 160 (ROADMAP.md, Queue 3). So: every differing bit sits on a
    # cell whose levels equal its left neighbour's, and they are rare.
    diff = dec.numpy() ^ case["dec"]
    ws, rs, js = np.nonzero(diff)
    C = 128
    for w, r, jj in zip(ws, rs, js):
        c = (32 * w) // C
        assert jj > 0
        assert case["mu_b"][c, r, jj] == case["mu_b"][c, r, jj - 1], (w, r, jj)
        assert case["sg_b"][c, r, jj] == case["sg_b"][c, r, jj - 1], (w, r, jj)
    n_bits = sum(bin(int(np.uint32(d))).count("1") for d in diff[ws, rs, js])
    assert n_bits <= 1e-5 * diff.size * 32, n_bits
    # values: XLA may contract a multiply-add where eager PyTorch rounds
    # twice, and the two logs differ in the last bit; errors add up over a
    # chunk of 128 steps before the renormalisation
    np.testing.assert_allclose(v_fin.numpy(), case["v_fin"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(acc.numpy(), case["acc"], rtol=1e-5, atol=1e-3)


def test_backtrack_matches_pallas(case):
    t = case["t"]
    # the Pallas side's decision words and final slots go in, and its path
    # (backtrack_pallas inside pallas_viterbi_batch) is what must come out
    path_t = cuda_dp.backtrack(
        (torch.from_numpy(case["dec"]),), t["lo"], t["delta"],
        torch.from_numpy(case["final_j"].astype(np.int32)), 128)
    # an integer walk over the same bits: exact, padding samples included
    np.testing.assert_array_equal(path_t.numpy(), case["path"])


def test_backtrack_counts_match_pallas(case):
    """The walk with counts: the path as before, and the counts of
    ``path_counts_pallas`` on the JAX package's own path."""
    t = case["t"]
    n_lanes = max(256, 128 * ((int(case["path"].max()) + 2 + 127) // 128))
    before = cuda_dp.path_counts.launches
    path_t, cnt = cuda_dp.backtrack(
        (torch.from_numpy(case["dec"]),), t["lo"], t["delta"],
        torch.from_numpy(case["final_j"].astype(np.int32)), 128,
        t_len=t["t_len"], n_lanes=n_lanes)
    np.testing.assert_array_equal(path_t.numpy(), case["path"])
    t_len = case["np"]["t_len"]
    live = np.arange(case["path"].shape[1])[None, :] < t_len[:, None]
    path_safe = np.where(live, case["path"], n_lanes).astype(np.int32)
    want = np.asarray(pallas_rescore.path_counts_pallas(
        jnp.asarray(path_safe), n_lanes, t_len=jnp.asarray(t_len), interpret=True))
    np.testing.assert_array_equal(cnt.numpy(), want)
    assert cuda_dp.path_counts.launches == before, "no kernel on the CPU"


def test_cuda_viterbi_batch_matches_pallas(case):
    t = case["t"]
    res_t, dec = cuda_dp.cuda_viterbi_batch(
        t["x"], t["t_len"], t["mu"], t["sigma"], t["n_ref"], t["lo"],
        t["delta"], case["tcfg"])
    # the tolerance of tests/test_pallas_dp.py for scores across backends
    np.testing.assert_allclose(res_t.score.numpy(), case["score"],
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(res_t.final_j.numpy(), case["final_j"])
    for r in range(t["x"].shape[0]):
        n = int(case["np"]["t_len"][r])
        np.testing.assert_array_equal(res_t.path[r, :n].numpy(),
                                      case["path"][r, :n])
    # without the path the score is the same and no backtrack runs
    res_np, _ = cuda_dp.cuda_viterbi_batch(
        t["x"], t["t_len"], t["mu"], t["sigma"], t["n_ref"], t["lo"],
        t["delta"], case["tcfg"], with_path=False)
    assert res_np.path is None
    np.testing.assert_array_equal(res_np.score.numpy(), res_t.score.numpy())


def test_walk_past_256_slots_matches_jax():
    """B = 384, beyond the 256 slots the card's first walk took: the port's
    walk with counts on the JAX fill's bits against ``backtrack_from_bits``
    and ``path_counts_pallas`` (``signal_chunk=32``: the fill compiles
    quickly in interpret mode at that chunk)."""
    B, C = 384, 32
    b = _make_batch(5, (520, 450, 60, 480, 430, 470, 440, 300), B, chunk=C)
    j = {k: jnp.asarray(v) for k, v in b.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    R, n_chunks = b["lo"].shape
    jcfg = JaxConfig(band_width=B, signal_chunk=C, read_tile=8, kernel_unroll=1)
    mu_b, sg_b = pallas_dp.band_gather_pallas(j["mu"], j["sigma"], j["lo"], B,
                                              interpret=True)
    decs, v_fin, acc = pallas_dp.viterbi_fill_pallas(
        j["x"], j["t_len"], mu_b, sg_b, j["lo"].T.reshape(n_chunks, R, 1),
        j["delta"].T.reshape(n_chunks, R, 1), j["n_ref"], jcfg, interpret=True)
    j_end, _ = cuda_dp.final_slot_and_score(
        torch.from_numpy(np.array(v_fin)), torch.from_numpy(np.array(acc)),
        t["lo"][:, -1], t["n_ref"])
    want = np.asarray(pallas_dp.backtrack_from_bits(
        decs, j["lo"], j["delta"], jnp.asarray(j_end.numpy()), chunk_size=C))
    n_lanes = 128 * ((int(b["n_ref"].max()) + 1 + 127) // 128)
    path, cnt = cuda_dp.backtrack(tuple(torch.from_numpy(np.array(d)) for d in decs),
                                  t["lo"], t["delta"], j_end, C, t_len=t["t_len"],
                                  n_lanes=n_lanes)
    np.testing.assert_array_equal(path.numpy(), want)
    live = np.arange(want.shape[1])[None, :] < b["t_len"][:, None]
    want_cnt = np.asarray(pallas_rescore.path_counts_pallas(
        jnp.asarray(np.where(live, want, n_lanes).astype(np.int32)), n_lanes,
        t_len=jnp.asarray(b["t_len"]), interpret=True))
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    # the band really moved, and every read's path is nondecreasing
    assert (b["delta"][:, 1:] > 0).any()
    for r in range(R):
        assert (np.diff(want[r, : b["t_len"][r]]) >= 0).all()


def test_argmax_takes_the_first_maximum():
    # final_slot_and_score must break ties like jnp.argmax: first maximum
    v = torch.tensor([[0.0, 1.5, 1.5, -1.0], [2.0, 2.0, 2.0, 2.0]])
    acc = torch.zeros(2)
    lo_last = torch.tensor([0, 0], dtype=torch.int32)
    n_ref = torch.tensor([4, 3], dtype=torch.int32)
    j_end, score = cuda_dp.final_slot_and_score(v, acc, lo_last, n_ref)
    assert j_end.tolist() == [1, 0]
    assert score.tolist() == [1.5, 2.0]
    assert j_end.tolist() == np.asarray(
        jnp.argmax(jnp.asarray(v.numpy()), axis=1)).tolist()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    cfg = AlignConfig()
    x = torch.zeros((8, 128))
    i = torch.zeros((8,), dtype=torch.int32)
    band = torch.zeros((8, 200))             # the level rows, (R, N)
    lo = torch.zeros((8, 1), dtype=torch.int32)
    with pytest.raises(TypeError):          # float64 signal
        cuda_dp.viterbi_fill(x.double(), i, band, band, lo, lo, i, cfg)
    with pytest.raises(ValueError):         # T not a multiple of the chunk
        cuda_dp.viterbi_fill(torch.zeros((8, 100)), i, band, band, lo, lo, i, cfg)
    with pytest.raises(ValueError):         # chunk-major bands are not rows
        cuda_dp.viterbi_fill(x, i, torch.zeros((1, 8, 128)), torch.zeros((1, 8, 128)),
                             lo, lo, i, cfg)
    # a band width the kernels do not take raises before anything runs on the
    # card, and not on the CPU, where the plain versions take any
    with pytest.raises(ValueError, match="exceeds 1024"):
        tpipe.check_supported(AlignConfig(band_width=1152), "cuda", "cuda")
    tpipe.check_supported(AlignConfig(band_width=1152), "cuda", "cpu")
    tpipe.check_supported(AlignConfig(band_width=1152), "scan", "cuda")
    with pytest.raises(ValueError):         # non-contiguous levels
        cuda_dp.viterbi_fill(x, i, torch.zeros((200, 8)).T, band, lo, lo, i, cfg)
    with pytest.raises(TypeError):          # int64 band starts
        cuda_dp.viterbi_fill(x, i, band, band, lo.long(), lo, i,
                             AlignConfig(dp_pair_step=True))
    # the skip transition gives two decision planes, and the walk takes both
    decs, _, _ = cuda_dp.viterbi_fill(x, i, band, band, lo, lo, i,
                                      AlignConfig(use_skip=True))
    assert len(decs) == 2 and decs[0].shape == decs[1].shape == (4, 8, 128)
    assert cuda_dp.backtrack(decs, lo, lo, i, 128).shape == (8, 128)
    with pytest.raises(ValueError):         # a bare tensor is not a plane tuple
        cuda_dp.backtrack(decs[0], lo, lo, i, 128)
    # on the CPU the plain versions run and no kernel launch is counted
    before = [k.launches for k in cuda_dp.COUNTERS]
    cuda_dp.viterbi_fill(x, i, band, band, lo, lo, i, AlignConfig(dp_pair_step=True))
    cuda_dp.viterbi_fill(x, i, band, band, lo, lo, i, cfg)
    assert [k.launches for k in cuda_dp.COUNTERS] == before
