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
    return {k.__name__: k.launches for k in cuda_dp.KERNELS}


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
# it takes, with more than 48 KB of shared memory); C = 32 makes every
# decision word a chunk of its own. The walk takes B up to 256.
FILL_SHAPES = [(128, 128), (256, 128), (384, 128), (1024, 128), (128, 32), (384, 32)]


@pytest.mark.parametrize("B, C", FILL_SHAPES)
def test_kernels_match_plain_versions(card, B, C):
    x, t_len, mu, sigma, lo_t, dl_t, n_ref, C = _dp_inputs(card, B, C=C)
    cfg = AlignConfig(band_width=B, signal_chunk=C, snp_rescore="fixed")
    before = _launches()
    mu_b, sg_b = cuda_dp.band_gather(mu, sigma, lo_t, B)
    p_mu, p_sg = cuda_dp.band_gather_plain(mu, sigma, lo_t, B)
    assert torch.equal(mu_b, p_mu) and torch.equal(sg_b, p_sg)

    args = (x, t_len, mu_b, sg_b, lo_t, dl_t, n_ref, cfg)
    decs, v, acc = cuda_dp.viterbi_fill(*args)
    _assert_fill_equal((decs, v, acc), cuda_dp.viterbi_fill_plain(*args))

    walk = B <= 256
    if walk:
        j_end, _ = cuda_dp.final_slot_and_score(v, acc, lo_t[:, -1], n_ref)
        path = cuda_dp.backtrack(decs, lo_t, dl_t, j_end, C)
        assert torch.equal(path, cuda_dp.backtrack_plain(decs, lo_t, dl_t, j_end, C))
        _assert_walk_counts(decs, lo_t, dl_t, j_end, C, t_len, path)
    want = {k: n + (k in ("band_gather", "viterbi_fill"))
            + walk * ((k == "path_counts") + 2 * (k == "backtrack"))
            for k, n in before.items()}
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
    mu_b, sg_b = cuda_dp.band_gather(mu, sigma, lo_t, B)
    before = _launches()

    # the skip fill (two planes) and the two-plane walk, through the two
    # names every caller uses
    cfg = AlignConfig(band_width=B, signal_chunk=C, use_skip=True, log_p_skip=-4.6)
    args = (x, t_len, mu_b, sg_b, lo_t, dl_t, n_ref, cfg)
    decs, v, acc = cuda_dp.viterbi_fill(*args)
    assert len(decs) == 2
    _assert_fill_equal((decs, v, acc), cuda_dp.viterbi_fill_plain(*args))
    assert not bool((decs[0] & decs[1]).any())      # advance 1 or 2, never both
    walk = B <= 256
    if walk:
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
    args_off = args[:-1] + (cfg_off,)
    got = cuda_dp.viterbi_fill(*args_off)
    _assert_fill_equal(got, cuda_dp.viterbi_fill_plain(*args_off))
    assert bool(torch.isfinite(got[1]).all()) and bool(torch.isfinite(got[2]).all())

    # the two-sample fill: one plane, the single-step fill's outputs
    cfg_pair = AlignConfig(band_width=B, signal_chunk=C, dp_pair_step=True)
    args_pair = args[:-1] + (cfg_pair,)
    got = cuda_dp.viterbi_fill(*args_pair)
    assert len(got[0]) == 1
    _assert_fill_equal(got, cuda_dp.viterbi_fill_pair_plain(*args_pair))
    single = cuda_dp.viterbi_fill(*args[:-1], AlignConfig(band_width=B, signal_chunk=C))
    torch.testing.assert_close(got[2] + got[1].max(1).values,
                               single[2] + single[1].max(1).values,
                               rtol=1e-5, atol=2e-3)
    torch.cuda.synchronize()
    want = dict(before, viterbi_fill_skip=before["viterbi_fill_skip"] + 2,
                backtrack_skip=before["backtrack_skip"] + 2 * walk,
                path_counts=before["path_counts"] + walk,
                viterbi_fill_pair=before["viterbi_fill_pair"] + 1,
                viterbi_fill=before["viterbi_fill"] + 1)
    assert _launches() == want


def _rescore_inputs(card, R, L, T, t_w, k, seed):
    """Random windows, constants and a small substitution table on the card."""
    rng = np.random.default_rng(seed)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    x = put(rng.normal(0, 1, (R, T)).astype(np.float32))
    S = np.sort(rng.integers(0, T - 300, (R, L)), axis=1).astype(np.int32)
    W = rng.integers(0, t_w + 1, (R, L)).astype(np.int32)
    W[0, :8] = 0
    kk = rng.integers(0, k + 2, (R, L)).astype(np.int32)     # 0 and k+1: no slot
    codes = rng.integers(0, 4, (R, L)).astype(np.int32)
    k4 = 4 * k
    sg = rng.uniform(0.1, 0.4, (k4, R, L)).astype(np.float32)
    em = (-np.log(sg) - 0.9189385).astype(np.float32)
    em[rng.random((k4, R, L)) < 0.05] = -1e30                # dead slots
    mu = rng.normal(0, 1, (k4, R, L)).astype(np.float32)
    iv = (0.5 / (sg * sg)).astype(np.float32)
    rows_p = 4096
    tsg = rng.uniform(0.1, 0.4, (k4, rows_p)).astype(np.float32)
    tab = np.stack([(-np.log(tsg) - 0.9189385).astype(np.float32),
                    rng.normal(0, 1, (k4, rows_p)).astype(np.float32),
                    (0.5 / (tsg * tsg)).astype(np.float32)])
    woff = rng.integers(0, rows_p - L + 1, R).astype(np.int32)
    woff[0], woff[-1] = 0, rows_p - L                        # both ends of the table
    return dict(x=x, S=put(S), W=put(W), kk=put(kk), codes=put(codes), em=put(em),
                mu=put(mu), iv=put(iv), tab=put(tab), woff=put(woff))


@pytest.mark.parametrize("k", [6, 3, 8])
def test_rescore_kernels_match_plain_versions(card, k):
    from nadavca_tpu_torch.ops import cuda_rescore

    R, L, T, t_w = 5, 200, 3000, 96          # no tile multiple is required
    cfg = AlignConfig(k=k)
    d = _rescore_inputs(card, R, L, T, t_w, k, seed=k)
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

    # K4: a gather, equal; without the slab rule, and with it on a wide S
    xs = cuda_rescore.shear_gather(d["x"], d["S"], t_w, slab=False)
    assert torch.equal(xs, cuda_rescore.shear_gather_plain(d["x"], d["S"], t_w,
                                                           slab=False))
    S_slab = torch.nn.functional.pad(d["S"], (0, 56), mode="replicate").contiguous()
    xs_slab = cuda_rescore.shear_gather(d["x"], S_slab, t_w, span=256)
    p_slab = cuda_rescore.shear_gather_plain(d["x"], S_slab, t_w, span=256)
    assert torch.equal(xs_slab, p_slab)
    assert bool((p_slab == 0).all(dim=0).any()) and bool((p_slab != 0).any())

    # K5 / K6: the same operations in the same order (-fmad=false)
    args = (xs, d["W"], d["kk"], d["codes"])
    got = cuda_rescore.rescore_fill_tab(*args, d["woff"], d["tab"], cfg, t_w)
    want = cuda_rescore.rescore_fill_tab_plain(*args, d["woff"], d["tab"], cfg, t_w)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-4)
    got = cuda_rescore.rescore_fill(xs, d["em"], d["mu"], d["iv"], d["W"], d["kk"],
                                    d["codes"], cfg, t_w)
    want = cuda_rescore.rescore_fill_plain(xs, d["em"], d["mu"], d["iv"], d["W"],
                                           d["kk"], d["codes"], cfg, t_w)
    live = want.abs() < 1e20                 # dead slots: ~-1e30 on both sides
    assert torch.equal(live, got.abs() < 1e20)
    assert float(((got - want).abs() * live).max()) <= 1e-4
    torch.cuda.synchronize()
    assert [kern.launches for kern in cuda_rescore.KERNELS] == [
        b + n for b, n in zip(before, (2, 1, 1))]
    assert cuda_dp.path_counts.launches == counts_before + 1
    with pytest.raises(ValueError, match="leave the table"):
        cuda_rescore.rescore_fill_tab(*args, d["woff"] + 1, d["tab"], cfg, t_w)


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

    d = _rescore_inputs(torch.device("cpu"), 2, 128, 2600, 32, 6, seed=0)
    before = [kern.launches for kern in cuda_dp.KERNELS + cuda_rescore.KERNELS]
    xs = cuda_rescore.shear_gather(d["x"], d["S"], 32)
    cuda_rescore.rescore_fill_tab(xs, d["W"].clamp(max=32), d["kk"], d["codes"],
                                  d["woff"], d["tab"], AlignConfig(), 32)
    assert [kern.launches for kern in cuda_dp.KERNELS + cuda_rescore.KERNELS] == before
