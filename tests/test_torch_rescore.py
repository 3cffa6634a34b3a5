"""The local re-DP rescore of the port vs the JAX package's.

The same numpy inputs (seeded) go through the Pallas kernels of
``nadavca_tpu.ops.pallas_rescore`` in interpret mode and through
``nadavca_tpu_torch.ops.cuda_rescore`` on CPU tensors, where each wrapper runs
its kernel's plain version; and through both packages' ``scan`` twins. The
CUDA kernels themselves are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_card.py``.

Interpret mode has no span mask (the TPU applies it only on the chip, under
``T >= 2304``); the port applies it on every device. The span-mask test below
therefore zeroes the JAX output itself, with the JAX package's own
``shear_slab_base`` and rule.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.anchor import SeedIndex
from nadavca_tpu.config import AlignConfig as JaxConfig
from nadavca_tpu.genome import kmer_ids
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.ops import banded_dp as jbanded
from nadavca_tpu.ops import dp_spec, pallas_rescore
from nadavca_tpu.ops.subst_tables import build_subst_tables as jax_build_tables
from nadavca_tpu import pipeline as jpipe

from nadavca_tpu_torch import convert
from nadavca_tpu_torch import pipeline as tpipe
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.ops import banded_dp as tbanded
from nadavca_tpu_torch.ops import cuda_dp, cuda_rescore
from nadavca_tpu_torch.ops.subst_tables import SubstTables

JCFG = JaxConfig(read_tile=8)
TCFG = AlignConfig(read_tile=8)
# XLA's CPU compiler contracts the emission into FMAs; eager PyTorch does not
TOL = dict(rtol=1e-5, atol=1e-3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_span_ok(path, t_len, N, L, k, span=2048):
    """The span rule of ``base_loglik_local_pallas`` applied by hand: (R, L)
    bool, False where the TPU on the chip masks a position because its
    128-position tile spreads beyond the slab. L must be a multiple of 128."""
    R, T = path.shape
    live = np.arange(T)[None, :] < t_len[:, None]
    psafe = np.where(live, path, N + 1)
    cnt = np.stack([np.searchsorted(psafe[r], np.arange(N + 1)) for r in range(R)])
    S = cnt[:, np.clip(np.arange(L) - k + 1, 0, N - 1)]
    S_c = np.clip(S, 0, T - 1).astype(np.int32)
    base = np.asarray(pallas_rescore.shear_slab_base(jnp.asarray(S_c), T, span))
    return ((S_c.reshape(R, L // 128, 128) - base[:, :, None])
            <= span - 1).reshape(R, L)


# ------------------------------------------------------------ K3 path counts
def _paths(seed, R, T, n_pos, jump_row=None):
    """Monotone paths with padded tails; row 1 has t_len 1, ``jump_row`` jumps
    more than 256 positions inside one 256-sample chunk."""
    rng = np.random.default_rng(seed)
    path = np.zeros((R, T), np.int32)
    t_len = np.zeros(R, np.int32)
    for r in range(R):
        t = int(rng.integers(T // 2, T + 1)) if r != 1 else 1
        if r == 2:
            t = T                                   # no padded tail at all
        first = int(rng.integers(0, 5))
        p = first + np.cumsum(rng.random(t) < 0.12)
        if r == jump_row:
            p[300:] += 300                          # chunk 1 spans > 256 lanes
        path[r, :t] = np.minimum(p, n_pos - 1)
        path[r, t:] = rng.integers(0, n_pos, T - t)     # garbage beyond t_len
        t_len[r] = t
    return path, t_len


@pytest.mark.parametrize("seed,jump_row", [(0, None), (1, 3), (2, 0)])
def test_path_counts_plain_matches_pallas(seed, jump_row):
    """The plain version of the walk's counts epilogue (K3 of the TPU)."""
    R, T, n_lanes = 8, 1024, 512
    path, t_len = _paths(seed, R, T, n_lanes - 2, jump_row)
    live = np.arange(T)[None, :] < t_len[:, None]
    path_safe = np.where(live, path, n_lanes).astype(np.int32)
    want = np.asarray(pallas_rescore.path_counts_pallas(
        jnp.asarray(path_safe), n_lanes, t_len=jnp.asarray(t_len), interpret=True))
    before = cuda_dp.path_counts.launches
    # the counts never read beyond t_len: hand them the garbage tails
    got = cuda_dp.path_counts_plain(_t(path), n_lanes, _t(t_len))
    assert got.dtype == torch.int32 and got.shape == (R, n_lanes)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cuda_dp.path_counts_plain(_t(path_safe), n_lanes, _t(t_len)).numpy(), want)
    assert got[1, 1:].max() <= 1 and int(got[2, -1]) == T
    assert cuda_dp.path_counts.launches == before, "no kernel on the CPU"


# ----------------------------------------------------------- K4 shear gather
def _shear_fixture(break_tiles):
    """The fixture of tests/test_shear_gather.py; with ``break_tiles`` some
    tiles spread beyond the slab."""
    rng = np.random.default_rng(0)
    R, T, L, tw, span = 8, 4608, 256, 64, 256
    x = rng.normal(size=(R, T)).astype(np.float32)
    S = np.zeros((R, L), np.int32)
    for r in range(R):
        S[r] = np.sort(rng.integers(0, 3000, size=L)).astype(np.int32)
    for r in range(R):
        for lt in range(L // 128):
            tile = S[r, lt * 128:(lt + 1) * 128]
            if break_tiles and (r + lt) % 3 == 0:
                continue                             # spread of ~1500 samples
            tile[:] = np.clip(tile, tile.min(), tile.min() + span - 160)
    if break_tiles:
        S[5, 128:] = np.sort(rng.integers(4000, 4600, size=128))  # base is clipped
    return x, S, T, tw, span


@pytest.mark.parametrize("break_tiles", [False, True])
def test_shear_gather_plain_matches_pallas(break_tiles):
    x, S, T, tw, span = _shear_fixture(break_tiles)
    want = np.asarray(pallas_rescore.shear_gather_pallas(
        jnp.asarray(x), jnp.asarray(S), tw, span=span, interpret=True))
    base = np.asarray(pallas_rescore.shear_slab_base(jnp.asarray(S), T, span))
    got_base = cuda_rescore.shear_slab_base(_t(S), T, span)
    np.testing.assert_array_equal(got_base.numpy(), base)
    before = cuda_rescore.shear_gather_folded.launches
    got = cuda_rescore.shear_gather_plain(_t(x), _t(S), tw, span=span).numpy()
    assert cuda_rescore.shear_gather_folded.launches == before
    # a gather computes nothing: equal, the zeros of broken tiles included
    np.testing.assert_array_equal(got, want)
    d = S.reshape(8, 2, 128) - base[:, :, None]
    broken = ((d < 0) | (d >= span)).reshape(8, 256)
    assert broken.any() == break_tiles
    assert (got[:, broken] == 0).all()
    ok_r, ok_i = np.nonzero(~broken)
    for r, i in list(zip(ok_r, ok_i))[::97]:
        np.testing.assert_array_equal(got[:, r, i], x[r, S[r, i]:S[r, i] + tw])


def test_shear_gather_without_slab_clamps():
    rng = np.random.default_rng(4)
    R, T, L, tw = 3, 300, 40, 32
    x = rng.normal(size=(R, T)).astype(np.float32)
    S = np.sort(rng.integers(0, T, size=(R, L)), axis=1).astype(np.int32)
    got = cuda_rescore.shear_gather_plain(_t(x), _t(S), tw, slab=False).numpy()
    idx = np.clip(S[None] + np.arange(tw)[:, None, None], 0, T - 1)
    np.testing.assert_array_equal(got, x[np.arange(R)[None, :, None], idx])
    with pytest.raises(ValueError):          # the slab rule needs long rows
        cuda_rescore.shear_gather_plain(_t(x), _t(S), tw, slab=True)


# --------------------------------------------- a preprocessed batch with tables
@pytest.fixture(scope="module")
def world():
    """The fixture of tests/test_subst_tables.py: 8 reads of 250 bases on both
    strands, one batch, the genome's tables in both packages, and one path
    (the port's scan backend) that both sides rescore."""
    rng = np.random.default_rng(3)
    model = default_model()
    genome = random_genome(rng, length=1500)
    index = SeedIndex(genome)
    reads = [simulate_read(genome, "ref", model, rng, read_len=250,
                           strand=1 if i % 2 else -1) for i in range(8)]
    records = [jpipe.preprocess_read(r.signal.astype(np.float32), r.basecall,
                                     r.move_index, index, genome, r.read_id,
                                     model=model) for r in reads]
    records = [r for r in records if r is not None][:8]
    batch = jpipe.assemble_batch(records, model, JCFG, pad_reads_to=8)
    jt = jax_build_tables(genome, model)
    tt = convert.subst_tables_from_numpy(
        np.asarray(jt.tab4), np.asarray(jt.valid), jt.contig_offsets,
        jt.g_total, jt.k, device="cpu")
    woff = jt.window_offsets(batch.contigs, batch.window_start,
                             batch.window_len, batch.strand,
                             padded_len=batch.codes.shape[1])
    tmodel = convert.kmer_model_from_numpy(model.level_mean, model.level_std, model.k)
    lo_full = np.repeat(batch.bands.lo, JCFG.signal_chunk, axis=1)[:, :batch.x.shape[1]]
    path = tbanded.banded_viterbi_batch(
        _t(batch.x), _t(batch.t_len), _t(batch.mu), _t(batch.sigma),
        _t(batch.n_ref), _t(lo_full), TCFG).path.numpy()
    arrs = dict(x=batch.x, path=path, t_len=batch.t_len, codes=batch.codes,
                ids=batch.ids, lm=model.level_mean.astype(np.float32),
                ls=model.level_std.astype(np.float32))
    return dict(model=model, tmodel=tmodel, batch=batch, jt=jt, tt=tt,
                woff=woff.astype(np.int32), arrs=arrs)


def _common(arrs, to):
    return tuple(to(arrs[n]) for n in ("x", "path", "t_len", "codes", "ids", "lm", "ls"))


@pytest.fixture(scope="module")
def dp_inputs(world):
    """xs, W, kk, codes and the two sources of constants at the world's
    shapes, made by the port's own prelude."""
    t_w, k = 96, world["model"].k
    x, path, t_len, codes, ids, lm, ls = _common(world["arrs"], _t)
    N = ids.shape[1]
    S, W, kk, p_lo, _ = cuda_rescore.local_windows(path, t_len, codes, N, k, t_w)
    xs = cuda_rescore.shear_gather_plain(x, S.clamp(0, x.shape[1] - 1).contiguous(),
                                         t_w, slab=False)
    em, mu, iv, _ = cuda_rescore.batch_constants(p_lo, kk, codes, ids, lm, ls, k)
    return dict(t_w=t_w, xs=xs, W=W.contiguous(), kk=kk.contiguous(),
                codes=codes.clamp(0, 3), em=em, mu=mu, iv=iv)


def _live(d, k):
    """Positions whose result the caller uses: a window and a final slot."""
    kk, W = d["kk"].numpy(), d["W"].numpy()
    return (W > 0) & (kk >= 1) & (kk <= k)


def test_rescore_fill_tab_plain_matches_pallas(world, dp_inputs):
    d, k = dp_inputs, world["model"].k
    j = {n: jnp.asarray(d[n].numpy()) for n in ("xs", "W", "kk", "codes")}
    want = np.asarray(pallas_rescore.rescore_fill_tab_pallas(
        j["xs"], j["W"], j["kk"], j["codes"], jnp.asarray(world["woff"]),
        world["jt"].tab4, JCFG, d["t_w"], interpret=True))
    before = [kern.launches for kern in cuda_rescore.KERNELS]
    got = cuda_rescore.rescore_fill_tab_plain(
        d["xs"], d["W"], d["kk"], d["codes"], _t(world["woff"]),
        world["tt"].tab, TCFG, d["t_w"]).numpy()
    assert [kern.launches for kern in cuda_rescore.KERNELS] == before
    assert got.shape == want.shape == (4,) + tuple(d["W"].shape)
    live = _live(d, k)
    assert live.sum() > 1000
    np.testing.assert_allclose(got[:, live], want[:, live], **TOL)
    # elsewhere both are finite, and the reference base's own row is 0
    assert np.isfinite(got).all()
    ref_row = np.take_along_axis(got, d["codes"].numpy()[None].astype(np.int64), 0)
    assert (ref_row == 0).all()


def test_rescore_fill_plain_matches_pallas(world, dp_inputs):
    d, k = dp_inputs, world["model"].k
    names = ("xs", "em", "mu", "iv", "W", "kk", "codes")
    want = np.asarray(pallas_rescore.rescore_fill_pallas(
        *(jnp.asarray(d[n].numpy()) for n in names), JCFG, d["t_w"],
        interpret=True))
    before = [kern.launches for kern in cuda_rescore.KERNELS]
    got = cuda_rescore.rescore_fill_plain(*(d[n] for n in names), TCFG,
                                          d["t_w"]).numpy()
    assert [kern.launches for kern in cuda_rescore.KERNELS] == before
    live = _live(d, k)
    np.testing.assert_allclose(got[:, live], want[:, live], **TOL)
    assert np.isfinite(got).all()


def test_rescore_wrappers_refuse_bad_arguments(world, dp_inputs):
    d = dp_inputs
    x, path, t_len, codes, ids, lm, ls = _common(world["arrs"], _t)
    tt = world["tt"]
    args = (x, path, t_len, None, codes)
    tail = (tt.tab, tt.valid, ids.shape[1], TCFG, d["t_w"])
    with pytest.raises(ValueError, match="leave the table"):
        cuda_rescore.rescore_local_tab(
            *args, torch.full((8,), tt.rows_p - 100, dtype=torch.int32), *tail)
    with pytest.raises(ValueError, match="leave the table"):
        cuda_rescore.rescore_local_tab(
            *args, torch.full((8,), -1, dtype=torch.int32), *tail)
    with pytest.raises(TypeError):
        cuda_rescore.rescore_local_tab(x, path.long(), t_len, None, codes,
                                       _t(world["woff"]), *tail)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_rescore.rescore_local_tab(x, path, t_len, None, codes[:, :200],
                                       _t(world["woff"]), *tail)
    with pytest.raises(ValueError, match="leave the table"):
        cuda_rescore.rescore_fill_tab_plain(
            d["xs"], d["W"], d["kk"], d["codes"], torch.full((8,), -1, dtype=torch.int32),
            tt.tab, TCFG, d["t_w"])
    with pytest.raises(ValueError):
        cuda_rescore.rescore_fill_plain(d["xs"], d["em"][:20], d["mu"], d["iv"],
                                        d["W"], d["kk"], d["codes"], TCFG, d["t_w"])
    # the no-tables rescore: the k-mer model must be float32 vectors, the
    # position axis whole tiles, the ids (R, N)
    local = (x, path, t_len, None, codes)
    with pytest.raises(TypeError):
        cuda_rescore.rescore_local(*local, ids, lm.double(), ls, TCFG, d["t_w"])
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_rescore.rescore_local(x, path, t_len, None, codes[:, :200], ids, lm, ls,
                                   TCFG, d["t_w"])
    with pytest.raises(ValueError):
        cuda_rescore.rescore_local(*local, ids[:4], lm, ls, TCFG, d["t_w"])


# ----------------------------------------- base_loglik_local_cuda as a whole
def test_local_cuda_with_tables_matches_pallas(world):
    """tests/test_subst_tables.py's case, both sides fed the same tables."""
    k, batch = world["model"].k, world["batch"]
    want = np.asarray(pallas_rescore.base_loglik_local_pallas(
        *_common(world["arrs"], jnp.asarray), k, JCFG, t_w=96, interpret=True,
        tables_tab=world["jt"].tab4, tables_valid=world["jt"].valid,
        window_off=jnp.asarray(world["woff"])))
    # the batch's T is 2816 >= 2304: the port applies the span mask, interpret
    # mode does not (the slab narrows near the end of so short a row)
    a = world["arrs"]
    assert a["x"].shape[1] >= 2304
    span_ok = jax_span_ok(a["path"], a["t_len"], a["ids"].shape[1],
                          a["codes"].shape[1], k)
    want = np.where(span_ok[:, :, None], want, 0.0)
    got = cuda_rescore.base_loglik_local_cuda(
        *_common(world["arrs"], _t), k, TCFG, t_w=96, tables=world["tt"],
        window_off=_t(world["woff"])).numpy()
    assert got.shape == want.shape == batch.codes.shape + (4,)
    np.testing.assert_allclose(got, want, **TOL)
    # masked positions are exactly 0 on both sides, and they are the same
    np.testing.assert_array_equal((got == 0).all(2), (want == 0).all(2))
    path = world["arrs"]["path"]
    for r in range(batch.n_reads):
        first = int(path[r, 0])
        assert (got[r, :first + k - 1] == 0).all()       # the clipped edge
        assert (got[r, int(batch.window_len[r]):] == 0).all()
    assert (np.abs(got).sum(axis=(1, 2))[:batch.n_reads] > 0).all()

    # the walk's counts handed in give the same result, to the bit
    a = world["arrs"]
    cnt = cuda_dp.path_counts_plain(_t(a["path"]), cuda_rescore.count_lanes(
        a["ids"].shape[1]), _t(a["t_len"]))
    with_cnt = cuda_rescore.base_loglik_local_cuda(
        *_common(world["arrs"], _t), k, TCFG, t_w=96, tables=world["tt"],
        window_off=_t(world["woff"]), cnt=cnt).numpy()
    np.testing.assert_array_equal(with_cnt, got)
    with pytest.raises(ValueError):         # counts over the wrong lanes
        cuda_rescore.base_loglik_local_cuda(
            *_common(world["arrs"], _t), k, TCFG, t_w=96, cnt=cnt[:, :-128])

    # and the table path agrees with the per-batch constants on the interior
    no_tab = cuda_rescore.base_loglik_local_cuda(
        *_common(world["arrs"], _t), k, TCFG, t_w=96).numpy()
    for r in range(batch.n_reads):
        first, last = int(path[r, 0]), int(path[r, int(batch.t_len[r]) - 1])
        interior = slice(first + k, min(int(batch.window_len[r]), last) - k)
        np.testing.assert_allclose(got[r, interior], no_tab[r, interior], **TOL)


def _mk(rng, model, lens, L, dwell=8.0):
    """The fixture of tests/test_pallas_rescore.py."""
    genome = random_genome(rng, length=1500)
    reads = [simulate_read(genome, "ref", model, rng, read_len=ln, strand=1,
                           mean_dwell=dwell) for ln in lens]
    R = len(reads)
    T = max(len(r.signal) for r in reads)
    N = L - model.k + 1
    x = np.zeros((R, T), np.float32)
    t_len = np.zeros(R, np.int32)
    codes = np.full((R, L), 4, np.int32)
    ids = np.full((R, N), -1, np.int32)
    paths = np.zeros((R, T), np.int32)
    for r, rd in enumerate(reads):
        t = len(rd.signal)
        x[r, :t] = rd.signal
        t_len[r] = t
        lw = len(rd.window_codes)
        codes[r, :lw] = rd.window_codes
        ids[r, : lw - model.k + 1] = kmer_ids(rd.window_codes, model.k)
        paths[r, :t] = rd.true_path
        paths[r, t:] = rd.true_path[-1]
    return dict(x=x, path=paths, t_len=t_len, codes=codes, ids=ids,
                lm=model.level_mean.astype(np.float32),
                ls=model.level_std.astype(np.float32)), reads


NO_TABLE_CASES = {
    "L256": (42, (150, 190, 180, 175, 160, 185, 170, 165), 256, 192),
    "L200": (42, (150, 190, 180, 175, 160, 185, 170, 165), 200, 192),
    "odd_R": (5, (150, 180, 200), 256, 96),
}


@pytest.mark.parametrize("case", sorted(NO_TABLE_CASES))
def test_local_cuda_without_tables_matches_pallas(case):
    seed, lens, L, t_w = NO_TABLE_CASES[case]
    model = default_model()
    arrs, _ = _mk(np.random.default_rng(seed), model, lens, L)
    want = np.asarray(pallas_rescore.base_loglik_local_pallas(
        *_common(arrs, jnp.asarray), model.k, JaxConfig(), t_w=t_w, interpret=True))
    got = cuda_rescore.base_loglik_local_cuda(
        *_common(arrs, _t), model.k, AlignConfig(), t_w=t_w).numpy()
    assert got.shape == want.shape == (len(lens), L, 4)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal((got == 0).all(2), (want == 0).all(2))
    np.testing.assert_array_equal(got.argmax(2), want.argmax(2))
    # and the port's two backends agree with each other
    twin = tbanded.base_loglik_local_batch(
        *_common(arrs, _t), model.k, AlignConfig(), t_w=t_w).numpy()
    np.testing.assert_allclose(got, twin, **TOL)


def test_local_rescore_at_k9_matches_jax():
    """The 9-mer model (R10.4.1's k) at 12.5 samples a base, windows of ~112
    samples under t_w 192: the no-tables tile's plain version and the
    port's ``scan`` twin against the JAX package's ``scan`` twin, on the
    same inputs."""
    model = default_model(9)
    arrs, _ = _mk(np.random.default_rng(7), model, (150, 180, 165), 256, dwell=12.5)
    assert arrs["x"].shape[1] > 1800
    want = np.asarray(jbanded.base_loglik_local_batch(
        *_common(arrs, jnp.asarray), 9, JaxConfig(k=9), t_w=192))
    got = cuda_rescore.base_loglik_local_cuda(
        *_common(arrs, _t), 9, AlignConfig(k=9), t_w=192).numpy()
    twin = tbanded.base_loglik_local_batch(
        *_common(arrs, _t), 9, AlignConfig(k=9), t_w=192).numpy()
    assert got.shape == want.shape == (3, 256, 4)
    assert int((want != 0).any(2).sum()) > 400
    for port in (got, twin):
        np.testing.assert_allclose(port, want, **TOL)
        np.testing.assert_array_equal((port == 0).all(2), (want == 0).all(2))
        np.testing.assert_array_equal(port.argmax(2), want.argmax(2))


def test_span_mask_applies_from_T_2304_on():
    """A read that dwells long enough for one 128-position tile to spread
    over more than 2048 samples: the port masks what the TPU masks on the
    chip. Interpret mode does not, so the JAX output is zeroed here."""
    rng = np.random.default_rng(9)
    model = default_model()
    k, R, L, T, t_w, span = model.k, 8, 256, 2560, 96, 2048
    N = L - k + 1
    codes = rng.integers(0, 4, (R, L)).astype(np.int32)
    ids = np.stack([kmer_ids(c.astype(np.int8), k) for c in codes]).astype(np.int32)
    path = np.zeros((R, T), np.int32)
    t_len = np.zeros(R, np.int32)
    for r in range(R):
        dwell = rng.integers(4, 12, N)
        if r in (0, 5):
            dwell[30:50] = 100               # 2000 samples inside tile 0
        p = np.repeat(np.arange(N), dwell)[:T]
        t_len[r] = len(p)
        path[r, :len(p)] = p
        path[r, len(p):] = p[-1]
    x = rng.normal(size=(R, T)).astype(np.float32)
    arrs = dict(x=x, path=path, t_len=t_len, codes=codes, ids=ids,
                lm=model.level_mean.astype(np.float32),
                ls=model.level_std.astype(np.float32))
    raw = np.asarray(pallas_rescore.base_loglik_local_pallas(
        *_common(arrs, jnp.asarray), k, JaxConfig(), t_w=t_w, interpret=True))

    spread_ok = jax_span_ok(path, t_len, N, L, k, span)
    want = np.where(spread_ok[:, :, None], raw, 0.0)
    tripped = ~spread_ok & (raw != 0).any(2)
    assert tripped[0].any() and tripped[5].any() and not tripped[1].any()

    got = cuda_rescore.base_loglik_local_cuda(
        *_common(arrs, _t), k, AlignConfig(), t_w=t_w).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[tripped] == 0).all()
    # one sample short of 2304 there is no mask
    short = {n: (a[:, :2303] if n in ("x", "path") else a) for n, a in arrs.items()}
    short["t_len"] = np.minimum(t_len, 2303)
    got_short = cuda_rescore.base_loglik_local_cuda(
        *_common(short, _t), k, AlignConfig(), t_w=t_w).numpy()
    assert (got_short[tripped] != 0).any()


# ------------------------------------------------------------- the scan twin
def test_scan_twin_matches_jax_scan_and_spec():
    """tests/test_local_rescore.py's case through both scan twins and, per
    read, through the numpy spec."""
    model = default_model()
    lens = (150, 220, 180)
    rng = np.random.default_rng(42)
    genome = random_genome(rng, length=1500)
    reads = [simulate_read(genome, "ref", model, rng, read_len=ln, strand=1,
                           mean_dwell=8.0) for ln in lens]
    R = len(reads)
    T = max(len(r.signal) for r in reads)
    L = max(len(r.window_codes) for r in reads)
    N = L - model.k + 1
    x = np.zeros((R, T), np.float32)
    t_len = np.zeros(R, np.int32)
    codes = np.full((R, L), 4, np.int32)
    ids = np.full((R, N), -1, np.int32)
    paths = np.zeros((R, T), np.int32)
    for r, rd in enumerate(reads):
        t = len(rd.signal)
        x[r, :t] = rd.signal
        t_len[r] = t
        lw = len(rd.window_codes)
        codes[r, :lw] = rd.window_codes
        ids[r, :lw - model.k + 1] = kmer_ids(rd.window_codes, model.k)
        paths[r, :t] = rd.true_path
        paths[r, t:] = rd.true_path[-1]
    arrs = dict(x=x, path=paths, t_len=t_len, codes=codes, ids=ids,
                lm=model.level_mean.astype(np.float32),
                ls=model.level_std.astype(np.float32))
    cfg = JaxConfig()
    want = np.asarray(jbanded.base_loglik_local_batch(
        *_common(arrs, jnp.asarray), model.k, cfg, t_w=cfg.snp_local_window))
    got = tbanded.base_loglik_local_batch(
        *_common(arrs, _t), model.k, AlignConfig(),
        t_w=cfg.snp_local_window).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal((got == 0).all(2), (want == 0).all(2))
    for r, rd in enumerate(reads):
        spec = dp_spec.base_substitution_loglik_local(
            rd.window_codes, rd.true_path, rd.signal.astype(np.float64),
            model.level_mean.astype(np.float64), model.level_std.astype(np.float64),
            model.k, cfg, max_window=cfg.snp_local_window)
        lw = len(rd.window_codes)
        # f32 vs f64 on quadratic terms: the tolerance of tests/test_local_rescore.py
        np.testing.assert_allclose(got[r, :lw], spec, rtol=5e-3, atol=5e-2)
        np.testing.assert_array_equal(got[r, :lw].argmax(1), spec.argmax(1))
        assert np.abs(got[r, lw:]).sum() == 0


def test_pipeline_device_step_runs_local_with_and_without_tables(world):
    """``align_batch`` hands the tables through: with them K5's path, without
    K6's; both agree on interior positions."""
    import dataclasses

    jb = world["batch"]
    d = {f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)}
    d["bands"] = dataclasses.asdict(jb.bands)
    tb = convert.batch_from_numpy(d)
    cfg = AlignConfig(read_tile=8, snp_local_window=96)
    with_t = tpipe.align_batch(tb, world["tmodel"], cfg, backend="cuda",
                               device="cpu", subst=world["tt"])
    staged = tpipe.stage_batch(tb, world["tmodel"], cfg, "cuda", device="cpu",
                               subst=world["tt"])
    np.testing.assert_array_equal(staged["woff"].numpy(), world["woff"])
    assert tpipe.stage_batch(tb, world["tmodel"], cfg, "scan", device="cpu",
                             subst=world["tt"])["subst"] is None
    without = tpipe.align_batch(tb, world["tmodel"], cfg, backend="cuda",
                                device="cpu")
    assert torch.equal(with_t["path"], without["path"])
    path = with_t["path"].numpy()
    k = world["model"].k
    a, b = with_t["base_loglik"].numpy(), without["base_loglik"].numpy()
    for r in range(tb.n_reads):
        first, last = int(path[r, 0]), int(path[r, int(tb.t_len[r]) - 1])
        interior = slice(first + k, min(int(tb.window_len[r]), last) - k)
        np.testing.assert_allclose(a[r, interior], b[r, interior], **TOL)
        assert (a[r, :first + k - 1] == 0).all() and (b[r, first + 1:first + k - 1] != 0).any()


# ------------------------------------- the fused kernel's tile mapping (K4+K5)
F32 = np.float32
LT, SPAN, SLAB = 128, 2048, 2048 + 256


def local_tile_model(x, path, t_len, cnt, codes, N, k, t_w, cfg, tables=None,
                     kmers=None, mutate=None):
    """``csrc/rescore.cu`` rescore_tile in numpy, for the test only: one block
    per (read, 128-position tile), a position's window from the counts and
    the path's two ends, the tile's slab base from the block minimum, the
    samples from the staged slab (or the whole row with its last sample
    repeated t_w times, below T = 2304), the masks, the positions ranked by
    falling window length and taken 8 at a time, the DP per base on the slab
    at offset S_c - base, and the reference base's value from the same
    position. ``tables`` = (woff, tab, valid): the tables kernel, constants
    from the genome table and kk == k required. ``kmers`` = (ids, em_k, mu_k,
    ``kmers`` = (ids, level_mean, level_std): the kernel without
    tables, constants gathered from the per-k-mer vectors of
    ``cuda_rescore.kmer_constants``, a clipped window scored on its kk live
    slots, every live slot a real k-mer. Mutations: "edge_masked" masks
    kk < k without tables as the tables kernel does; "logf" makes each
    emission constant by one rounding of a double log, as a kernel that took
    its own log would, instead of gathering it. Returns (R, L, 4) float32."""
    R, T = x.shape
    L = codes.shape[1]
    lps, lpm = F32(cfg.log_p_stay), F32(cfg.log_p_move)
    neg = F32(-1e30)
    out = np.zeros((R, L, 4), F32)
    rule = T >= SLAB
    for r in range(R):
        first = int(path[r, 0])
        last = int(path[r, min(max(int(t_len[r]) - 1, 0), T - 1)])
        for tile in range(L // LT):
            i = tile * LT + np.arange(LT)
            ic = np.clip(i - k + 1, 0, N - 1)
            ie = np.clip(i, 0, N - 1)
            S = cnt[r, ic].astype(np.int64)
            W = np.clip(cnt[r, ie + 1] - S, 0, t_w)
            S_c = np.clip(S, 0, T - 1)
            p_lo = np.maximum(ic, first)
            kk = np.minimum(ie, last) - p_lo + 1
            code = codes[r, i]
            if rule:
                base = (min(max(int(S_c.min()), 0), T - SLAB) // LT) * LT
                slab = x[r, base:base + SLAB]
            else:
                base = 0
                slab = np.concatenate([x[r], np.full(t_w, x[r, T - 1], F32)])
            off = S_c - base
            if rule:
                W = np.where((off >= 0) & (off < SPAN), W, 0)      # the span mask
            ok = (kk > 0) & (code < 4) & (W > 0)
            jj = np.arange(k)
            if tables is not None:
                woff, tab, valid = tables
                col = woff[r] + i
                ok &= (kk == k) & valid[col]
            else:
                ids, lm, ls = kmers
                em_k, mu_k, iv_k = (a.numpy() for a in cuda_rescore.kmer_constants(
                    torch.from_numpy(lm), torch.from_numpy(ls)))
                if mutate == "logf":
                    em_k = (-np.log(ls.astype(np.float64))
                            - 0.5 * np.log(2 * np.pi)).astype(F32)
                p = p_lo[:, None] + jj[None, :]                   # (LT, k)
                ids_p = ids[r, np.clip(p, 0, N - 1)]
                ok &= ((jj[None, :] >= kk[:, None]) | (ids_p >= 0)).all(1)
                if mutate == "edge_masked":
                    ok &= kk == k
            w_ok = np.where(ok, W, 0)
            # rank: falling window length, ties by position; perm[rank] = t
            t = np.arange(LT)
            rank = ((w_ok[None, :] > w_ok[:, None])
                    | ((w_ok[None, :] == w_ok[:, None]) & (t[None, :] < t[:, None]))).sum(1)
            perm = np.empty(LT, np.int64)
            perm[rank] = t
            for g in range(LT // 8):                     # 8 positions x 4 bases
                q = perm[8 * g:8 * g + 8]
                live = w_ok[q] > 0
                if not live.any():
                    out[r, i[q]] = 0
                    continue
                b_id = np.arange(4)[None, None, :]
                if tables is not None:
                    # constants (k, 8, 4): slot j, base b of table row j * 4 + b
                    em, mu, iv = (tab[pl][jj[:, None, None] * 4 + b_id,
                                          col[q][None, :, None]] for pl in range(3))
                    slot = np.full(8, k - 1)                     # kk == k
                else:
                    pq = p[q].T[:, :, None]                      # (k, 8, 1)
                    idq = ids_p[q].T[:, :, None]
                    o_w = i[q][None, :, None] - pq
                    w4 = np.where((o_w >= 0) & (o_w < k), 4 ** (k - 1 - np.clip(o_w, 0, k - 1)), 0)
                    nid = np.clip(idq + (b_id - code[q][None, :, None]) * w4, 0, len(em_k) - 1)
                    dead = (jj[:, None, None] >= kk[q][None, :, None]) | (idq < 0)
                    em = np.where(dead, neg, em_k[nid])
                    mu, iv = mu_k[nid], iv_k[nid]
                    slot = np.clip(kk[q] - 1, 0, k - 1)
                wq, off_q = w_ok[q], np.where(live, off[q], 0)
                d0 = slab[off_q][None, :, None] - mu
                v = np.where(jj[:, None, None] == 0, em - d0 * d0 * iv, neg)
                for s in range(1, int(wq.max())):
                    xs = slab[np.where(s < wq, off_q + s, 0)][None, :, None]
                    d = xs - mu
                    emit = em - d * d * iv
                    move = np.concatenate([np.full((1, 8, 4), neg, F32), v[:-1]]) + lpm
                    new = emit + np.maximum(v + lps, move)
                    v = np.where((s < wq)[None, :, None], new, v)
                o = v[slot, np.arange(8)]                         # (8, 4)
                ref = o[np.arange(8), np.clip(code[q], 0, 3)]
                out[r, i[q]] = np.where(live[:, None], o - ref[:, None], F32(0))
    return out


def _random_tables(rng, k, rows_p, R, L):
    k4 = 4 * k
    sg = rng.uniform(0.1, 0.4, (k4, rows_p)).astype(np.float32)
    tab = np.stack([(-np.log(sg) - 0.9189385).astype(np.float32),
                    rng.normal(0, 1, (k4, rows_p)).astype(np.float32),
                    (0.5 / (sg * sg)).astype(np.float32)])
    valid = rng.random(rows_p) > 0.05
    woff = rng.integers(0, rows_p - L + 1, R).astype(np.int32)
    woff[0], woff[-1] = 0, rows_p - L                    # both ends of the table
    return tab, valid, woff


def _dwell_case(T, seed=9):
    """The span-mask fixture above with random genome tables: reads 0 and 5
    dwell 2000 samples inside tile 0, so from T = 2304 on their tile's
    positions past the slab are masked."""
    rng = np.random.default_rng(seed)
    model = default_model()
    k, R, L, t_w = model.k, 8, 256, 96
    N = L - k + 1
    codes = rng.integers(0, 4, (R, L)).astype(np.int32)
    codes[3, 100:104] = 4                                # not a real base
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
    x = rng.normal(size=(R, T)).astype(np.float32)
    tab, valid, woff = _random_tables(rng, k, 2048, R, L)
    ids = np.stack([kmer_ids(c.astype(np.int8), k) for c in codes]).astype(np.int32)
    return dict(x=x, path=path, t_len=t_len, codes=codes, woff=woff, tab=tab,
                valid=valid, N=N, k=k, t_w=t_w, ids=ids,
                lm=model.level_mean.astype(np.float32),
                ls=model.level_std.astype(np.float32))


def _world_case(world):
    a, tt = world["arrs"], world["tt"]
    return dict(x=a["x"], path=a["path"], t_len=a["t_len"], codes=a["codes"],
                woff=world["woff"], tab=tt.tab.numpy(), valid=tt.valid.numpy(),
                N=a["ids"].shape[1], k=world["model"].k, t_w=96, ids=a["ids"],
                lm=a["lm"], ls=a["ls"])


TILE_CASES = ["slab_rule_span_masked", "short_rows_no_slab", "world_clipped_base"]


def _tile_case(case, world):
    if case == "slab_rule_span_masked":
        return _dwell_case(2560)
    if case == "short_rows_no_slab":
        return _dwell_case(2303)       # no slab rule: sample indices clamp
    return _world_case(world)          # T = 2816: the base clips to T - 2304


@pytest.mark.parametrize("case", TILE_CASES)
def test_local_tab_tile_model_matches_the_plain_composition(case, world):
    """The fused kernel's mapping (numpy model) bit for bit against
    ``rescore_local_tab_plain`` — the composition the kernel replaces —
    and through ``base_loglik_local_cuda``."""
    d = _tile_case(case, world)
    R, T = d["x"].shape
    k, N, t_w = d["k"], d["N"], d["t_w"]
    cfg = AlignConfig(k=k)
    cnt = cuda_dp.path_counts_plain(_t(d["path"]), cuda_rescore.count_lanes(N),
                                    _t(d["t_len"]))
    want = local_tile_model(d["x"], d["path"], d["t_len"], cnt.numpy(), d["codes"], N, k,
                            t_w, cfg, tables=(d["woff"], d["tab"], d["valid"]))
    before = [kern.launches for kern in cuda_rescore.KERNELS]
    args = (_t(d["x"]), _t(d["path"]), _t(d["t_len"]), cnt, _t(d["codes"]),
            _t(d["woff"]), _t(d["tab"]), _t(d["valid"]), N, cfg, t_w)
    got = cuda_rescore.rescore_local_tab(*args).numpy()
    assert [kern.launches for kern in cuda_rescore.KERNELS] == before
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cuda_rescore.rescore_local_tab_plain(*args).numpy(), want)

    # what the case reaches: masked and unmasked positions, read edges, the
    # reference base's own row exactly 0, and the rule's branch
    live = (got != 0).any(2)
    assert live.sum() > 200 and (~live).sum() > 50
    assert (np.take_along_axis(got, np.clip(d["codes"], 0, 3)[..., None], 2) == 0).all()
    first = d["path"][:, 0]
    for r in range(R):
        assert (got[r, :first[r] + k - 1] == 0).all()
    if case != "world_clipped_base":
        S = cnt.numpy()[:, np.clip(np.arange(256) - k + 1, 0, N - 1)]
        spread = S[:, :128].max(1) - S[:, :128].min(1)
        assert spread[0] > SPAN and spread[5] > SPAN
        tripped = ~live[[0, 5], :128].all() if T >= SLAB else live[[0, 5], 60:128].any()
        assert tripped
    else:
        base = cuda_rescore.shear_slab_base(
            _t(np.clip(cnt.numpy()[:, np.clip(np.arange(d["codes"].shape[1]) - k + 1,
                                              0, N - 1)], 0, T - 1)), T, SPAN)
        assert int(base.max()) == T - SLAB           # the clip to T - 2304 bites

    # base_loglik_local_cuda with tables is this function, to the bit
    tabs = SubstTables(tab=_t(d["tab"]), valid=_t(d["valid"]), contig_offsets={},
                       g_total=0, k=k)
    ids = torch.zeros((R, N), dtype=torch.int32)
    lm = torch.ones(4 ** k)
    whole = cuda_rescore.base_loglik_local_cuda(
        _t(d["x"]), _t(d["path"]), _t(d["t_len"]), _t(d["codes"]), ids, lm, lm, k, cfg,
        t_w=t_w, tables=tabs, window_off=_t(d["woff"]), cnt=cnt).numpy()
    np.testing.assert_array_equal(whole, want)


def _kmer_model(d, cfg, mutate=None):
    cnt = cuda_dp.path_counts_plain(_t(d["path"]), cuda_rescore.count_lanes(d["N"]),
                                    _t(d["t_len"]))
    got = local_tile_model(d["x"], d["path"], d["t_len"], cnt.numpy(), d["codes"],
                           d["N"], d["k"], d["t_w"], cfg,
                           kmers=(d["ids"], d["lm"], d["ls"]), mutate=mutate)
    return got, cnt


@pytest.mark.parametrize("case", TILE_CASES)
def test_local_tile_model_without_tables_matches_the_plain_composition(case, world):
    """The no-tables kernel's mapping (numpy model: constants gathered from
    the per-k-mer vectors, clipped windows on their live slots, slots without
    a real k-mer) bit for bit against ``rescore_local_plain`` — the
    composition the kernel replaces — and through ``base_loglik_local_cuda``
    without tables."""
    d = _tile_case(case, world)
    R, T = d["x"].shape
    k, N, t_w = d["k"], d["N"], d["t_w"]
    cfg = AlignConfig(k=k)
    want, cnt = _kmer_model(d, cfg)
    before = [kern.launches for kern in cuda_rescore.KERNELS]
    args = (_t(d["x"]), _t(d["path"]), _t(d["t_len"]), cnt, _t(d["codes"]), _t(d["ids"]),
            _t(d["lm"]), _t(d["ls"]), cfg, t_w)
    got = cuda_rescore.rescore_local(*args).numpy()
    assert [kern.launches for kern in cuda_rescore.KERNELS] == before
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cuda_rescore.rescore_local_plain(*args).numpy(), want)
    whole = cuda_rescore.base_loglik_local_cuda(
        _t(d["x"]), _t(d["path"]), _t(d["t_len"]), _t(d["codes"]), _t(d["ids"]),
        _t(d["lm"]), _t(d["ls"]), k, cfg, t_w=t_w, cnt=cnt).numpy()
    np.testing.assert_array_equal(whole, want)

    # what the case reaches: scored edge positions (kk < k), positions masked
    # for a slot without a real k-mer, the reference base's own row 0
    live = (got != 0).any(2)
    assert live.sum() > 200 and (~live).sum() > 50
    assert (np.take_along_axis(got, np.clip(d["codes"], 0, 3)[..., None], 2) == 0).all()
    first = d["path"][:, 0]
    edge = np.zeros_like(live)
    for r in range(R):
        edge[r, first[r] + 1:first[r] + k - 1] = True
    assert (live & edge).any()
    bad_ids = np.zeros_like(live)
    for r, i in zip(*np.nonzero(d["ids"] < 0)):
        bad_ids[r, i:i + k] = True
    assert not (live & bad_ids & (d["codes"] < 4)).any()
    if case != "world_clipped_base":
        assert bad_ids[3].any() and not live[3, 100:104].any()


@pytest.mark.parametrize("mutate", ["edge_masked", "logf"])
def test_local_tile_model_without_tables_mutations_are_caught(mutate, world):
    """Two wrong kernels, written into the model: an edge position masked as
    the tables kernel masks it, and the emission constant computed per slot
    instead of gathered from the plain version's vector. Each differs from
    the plain composition on every batch of the test above."""
    for case in TILE_CASES:
        d = _tile_case(case, world)
        cfg = AlignConfig(k=d["k"])
        got, cnt = _kmer_model(d, cfg, mutate=mutate)
        want = cuda_rescore.rescore_local_plain(
            _t(d["x"]), _t(d["path"]), _t(d["t_len"]), cnt, _t(d["codes"]), _t(d["ids"]),
            _t(d["lm"]), _t(d["ls"]), cfg, d["t_w"]).numpy()
        assert not np.array_equal(got, want), case
