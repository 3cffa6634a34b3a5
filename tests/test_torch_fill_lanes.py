"""A numpy model of the fill's lane mapping in ``csrc/viterbi_fill.cu``.

The kernel keeps a read's band in registers: W chain warps, lane l of warp w
holding the S contiguous slots from 32*S*w + S*l, and beside each a producer
warp that writes the emissions of the same slots into a table, two buffers of
16 samples. At each sample a lane takes slot j0 - 1 (and j0 - 2 under skip)
from lane l - 1 by a shuffle-up; lane 0 takes NEG_INF, or the left warp's
edge, which that warp wrote into a ring in shared memory while it ran the
same 16 samples before. The slots of a lane are updated from the last down,
so each reads the old row. The producers gather each chunk's band levels
themselves from the read's (R, N) rows of expected levels, 0 and 1 where a
slot's position leaves [0, N) (the band gather folded into the fill). A chunk starts with the realign by delta through
a shared row and ends with the row maximum, a butterfly over the lanes of
each warp and a maximum over the warps. This file writes that mapping in
numpy, the warps of each half-group in the kernel's order and every read at
once, and holds its decision words bit for bit, and V and acc within the
card test's tolerance, against the plain band gather and fill
(``cuda_dp.band_gather_plain``, ``cuda_dp.viterbi_fill_plain``) on seeded
inputs: B = 128, 256, 384 at the
(S, W) of ``cuda_dp.fill_layout``, without and with skip, C = 32 and 128,
deltas of 0, >= S, >= 32*S and >= B, t_len of 0, 1, 31, 33 and T, n_ref
ending inside a lane, and a band that runs past N inside a lane. The kernel itself is held against the plain version on
the card (``tests/test_torch_card.py``, ``chip_smoke.py``).
"""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.ops import cuda_dp

NEG_INF = np.float32(-1e30)
HALF_LOG_2PI = np.float32(0.5 * np.log(2.0 * np.pi))
RING_HALVES = 8          # the kernel's ring of warp edges, in half-groups
HALF = 16                # samples handed over at a time
f32 = np.float32


def shfl_up(a):
    """__shfl_up_sync(a, 1) over the lane axis (last): lane 0 keeps its own."""
    return np.concatenate([a[..., :1], a[..., :-1]], axis=-1)


def warp_max(a):
    """The butterfly of __shfl_xor_sync over the lane axis (last)."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        a = np.maximum(a, a[..., lanes ^ off])
    return a[..., 0]


def lane_fill(x, t_len, mu_rows, sg_rows, lo, delta, n_ref, cfg, S, W):
    """The kernel's mapping for every read at once, from the (R, N) level
    rows. Returns (decs, V, acc) as numpy arrays shaped like the plain
    version's."""
    R, T = x.shape
    N = mu_rows.shape[1]
    B, C = cfg.band_width, cfg.signal_chunk
    assert B == 32 * S * W
    skip = bool(cfg.use_skip)
    planes = 2 if skip else 1
    n_chunks, gpc = T // C, C // 32
    lps = f32(cfg.log_p_stay)
    if skip:
        p1, p2 = f32(cfg.log_p_move), f32(cfg.log_p_skip)
    else:
        p1 = f32(cfg.log_p_move - cfg.log_p_stay)
    lane = np.arange(32)
    j = (32 * S * np.arange(W)[:, None, None] + S * lane[None, :, None]
         + np.arange(S)[None, None, :])                       # (W, 32, S) slots
    v = np.full((R, W, 32, S), NEG_INF, f32)
    acc = np.zeros(R, f32)
    decs = np.zeros((planes, T // 32, R, B), np.uint32)
    # each producer's table: two buffers of HALF samples of emissions
    table = np.zeros((R, W, 2, HALF, 32, S), f32)
    ring = np.zeros((R, W, RING_HALVES, planes, HALF), f32)
    tl = t_len.astype(np.int64)
    rows = np.arange(R)

    for c in range(n_chunks):
        t0 = c * C
        if c > 0:
            # realign through the shared row: V'[j] = V[j + d]
            row = v.reshape(R, B)
            src = j[None] + delta[:, c].astype(np.int64)[:, None, None, None]
            ok = (src >= 0) & (src < B)
            v = np.where(ok, row[rows[:, None, None, None], np.clip(src, 0, B - 1)],
                         NEG_INF).astype(f32)
        # the producers' gather: slot j of the chunk is position lo + j
        pos = lo[:, c].astype(np.int64)[:, None, None, None] + j[None]
        inside = (pos >= 0) & (pos < N)
        at = (rows[:, None, None, None], np.clip(pos, 0, N - 1))
        mu = np.where(inside, mu_rows[at], f32(0))
        sg = np.where(inside, sg_rows[at], f32(1))
        # the log as the plain version takes it; the card's logf is checked there
        log_sg = torch.log(torch.from_numpy(sg)).numpy()
        valid = (lo[:, c].astype(np.int64)[:, None, None, None] + j[None]
                 < n_ref.astype(np.int64)[:, None, None, None])
        em_const = np.where(valid, -log_sg - HALF_LOG_2PI, NEG_INF).astype(f32)
        inv2v = f32(0.5) / (sg * sg)
        if skip:
            ka, kb, kc = mu, em_const, inv2v
        else:
            ka, kb, kc = -inv2v, (mu + mu) * inv2v, (em_const - (mu * mu) * inv2v) + lps
        for g in range(gpc):
            G = c * gpc + g
            xg = x[:, 32 * G:32 * G + 32]                     # (R, 32): lane s holds x[s]
            pk = np.zeros((planes, R, W, 32, S), np.uint32)
            for half in range(2):
                h = 2 * G + half
                slot, buf = h % RING_HALVES, h & 1
                # the producers: the half's emissions into their tables
                for u in range(HALF):
                    xv = xg[:, HALF * half + u][:, None, None, None]
                    if skip:
                        diff = xv - ka
                        table[:, :, buf, u] = kb - (diff * diff) * kc
                    else:
                        table[:, :, buf, u] = (ka * xv + kb) * xv + kc
                for w in range(W):                            # the wavefront
                    q = v[:, w]                               # (R, 32, S), a view
                    for u in range(HALF):
                        s = HALF * half + u
                        live = (t0 + 32 * g + s < tl)[:, None]  # (R, 1)
                        emit = table[:, w, buf, u]
                        if w + 1 < W:                         # lane 31 feeds the ring
                            ring[:, w, slot, 0, u] = q[:, 31, S - 1]
                            if skip:
                                ring[:, w, slot, 1, u] = q[:, 31, S - 2]
                        if t0 + 32 * g + s == 0:              # the free start
                            q[:] = np.where(live[:, :, None], emit if skip else emit - lps, q)
                            continue
                        e1 = ring[:, w - 1, slot, 0, u][:, None] if w else NEG_INF
                        e2 = ring[:, w - 1, slot, 1, u][:, None] if w and skip else NEG_INF
                        left1 = np.where(lane == 0, e1, shfl_up(q[:, :, S - 1])).astype(f32)
                        left2 = (np.where(lane == 0, e2, shfl_up(q[:, :, S - 2])).astype(f32)
                                 if skip else None)
                        bit = np.uint32(1 << s)
                        for k in range(S - 1, -1, -1):
                            vk = q[:, :, k]
                            vm1 = q[:, :, k - 1] if k >= 1 else left1
                            if skip:
                                vm2 = q[:, :, k - 2] if k >= 2 else (left1 if k == 1 else left2)
                                stay = vk + lps
                                move = vm1 + p1
                                best = np.maximum(stay, move)
                                sk = vm2 + p2
                                b2 = (sk > best) & live
                                b1 = (move > stay) & ~b2 & live
                                pk[1, :, w, :, k] |= np.where(b2, bit, np.uint32(0))
                                new = emit[:, :, k] + np.maximum(best, sk)
                            else:
                                mv = vm1 + p1
                                b1 = (mv > vk) & live
                                new = emit[:, :, k] + np.maximum(vk, mv)
                            pk[0, :, w, :, k] |= np.where(b1, bit, np.uint32(0))
                            q[:, :, k] = np.where(live, new, vk)
            decs[:, G] = pk.reshape(planes, R, B)
        # chunk-end maximum: over the lane's slots, the warp, then the warps
        m = warp_max(v.max(axis=3)).max(axis=1)               # (R,)
        m = np.where(m > NEG_INF / 2, m, f32(0)).astype(f32)
        v = (v - m[:, None, None, None]).astype(f32)
        acc = (acc + m).astype(f32)
    return tuple(d.view(np.int32) for d in decs), v.reshape(R, B), acc


def fill_inputs(B, C, S, seed):
    """Seeded reads that reach every corner of the mapping."""
    rng = np.random.default_rng(seed)
    n_chunks = 512 // C if C >= 128 else 10
    T = n_chunks * C
    R = 7
    x = rng.normal(0, 1, (R, T)).astype(np.float32)
    # deltas of 0, >= S (inside a warp), >= 32*S (across warps) and >= B
    choices = np.array([0, 0, 0, 1, S + 1, 2 * S + 3, 32 * S + 5, B + 7])
    delta = rng.choice(choices, (R, n_chunks)).astype(np.int32)
    delta[:, 0] = 0
    delta[0, 1:] = [S + 1, 32 * S + 2, B][: n_chunks - 1] + [0] * max(n_chunks - 4, 0)
    # read 4 (t_len = T) ends furthest along, and its last band runs past the
    # rows' end inside a lane: slots from B/2 + S - 1 on read the pad values
    ends = np.cumsum(delta, axis=1)[:, -1]
    delta[4, -1] += ends.max() - ends[4] + 1
    lo = np.cumsum(delta, axis=1).astype(np.int32)
    N = int(lo[4, -1]) + B // 2 + S - 1
    mu = rng.normal(0, 1, (R, N)).astype(np.float32)
    sigma = rng.uniform(0.1, 0.4, (R, N)).astype(np.float32)
    t_len = np.array([0, 1, 31, 33, T, T - 7, int(rng.integers(34, T))], np.int32)
    # every read's window ends inside a lane's slots at half the run
    n_ref = (lo[:, n_chunks // 2] + B // 2 + S // 2 + 1).astype(np.int32)
    return x, t_len, mu, sigma, lo, delta, n_ref


@pytest.mark.parametrize("C", [32, 128])
@pytest.mark.parametrize("skip", [False, True], ids=["noskip", "skip"])
@pytest.mark.parametrize("B", [128, 256, 384])
def test_lane_model_matches_the_plain_fill(B, skip, C):
    S, W = cuda_dp.fill_layout(B, skip)
    assert 32 * S * W == B and S in (2, 4, 8) and 1 <= W <= 8
    cfg = AlignConfig(band_width=B, signal_chunk=C,
                      **(dict(use_skip=True, log_p_skip=-4.6) if skip else {}))
    arrays = fill_inputs(B, C, S, seed=B + C + skip)
    decs, v, acc = lane_fill(*arrays, cfg, S, W)
    x, t_len, mu, sigma, lo, delta, n_ref = (torch.from_numpy(a) for a in arrays)
    mu_b, sg_b = cuda_dp.band_gather_plain(mu, sigma, lo, B)
    # the band past the rows' end holds pad values in the last chunk of read 4
    assert bool((mu_b[-1, 4, -1] == 0) & (sg_b[-1, 4, -1] == 1))
    assert bool((sg_b[-1, 4, : B // 2 + S - 1] != 1).all())
    p_decs, p_v, p_acc = cuda_dp.viterbi_fill_plain(x, t_len, mu_b, sg_b, lo, delta,
                                                    n_ref, cfg)
    # the wrapper on CPU tensors composes the same two plain versions
    w_decs, w_v, w_acc = cuda_dp.viterbi_fill(x, t_len, mu, sigma, lo, delta, n_ref, cfg)
    assert all(torch.equal(a, b) for a, b in zip(w_decs, p_decs))
    assert torch.equal(w_v, p_v) and torch.equal(w_acc, p_acc)
    assert len(decs) == len(p_decs) == (2 if skip else 1)
    for d, p in zip(decs, p_decs):
        assert np.array_equal(d, p.numpy())
    assert any(int(np.count_nonzero(d)) > 0 for d in decs)
    p_v = p_v.numpy()
    live = p_v > NEG_INF / 2
    assert np.array_equal(live, v > NEG_INF / 2)
    assert float((np.abs(v - p_v) * live).max()) <= 1e-3
    np.testing.assert_allclose(acc, p_acc.numpy(), rtol=1e-5, atol=1e-3)


# ------------------------------------------------------- the two-sample fill
def lane_fill_pair(x, t_len, mu_rows, sg_rows, lo, delta, n_ref, cfg, S, W,
                   mutate=None):
    """The two-sample fill's mapping (``viterbi_fill_pair_kernel``) for every
    read at once: the band in W chain warps of S slots a lane, the last warp
    reaching past B when B is not a multiple of 32 * S; a pair of samples per
    step, its first a free start at t = 0 and a half pair where a read ends
    after the first sample; e1, e2 of the lane's slots and e1 of slot j0 - 1
    from its producer, which gathers S + 1 levels from j0 - 1 a chunk; v[j-1]
    and v[j-2] by shuffle-up, lane 0 of a warp from the ring of two values a
    pair its left warp fed. ``mutate="e1m_own"`` takes e1[j-1] of a lane's
    slot 0 from its own slot (the edge missed). Returns (decs, V, acc)."""
    R, T = x.shape
    N = mu_rows.shape[1]
    B, C = cfg.band_width, cfg.signal_chunk
    Bp = 32 * S * W
    assert Bp - 32 * S < B <= Bp and B % 32 == 0
    n_chunks, gpc = T // C, C // 32
    cs_d, cm_d = cfg.log_p_stay, cfg.log_p_move
    cs, cm = f32(cs_d), f32(cm_d)
    cs2, csm, cm2 = f32(cs_d + cs_d), f32(cs_d + cm_d), f32(cm_d + cm_d)
    lane = np.arange(32)
    j = (32 * S * np.arange(W)[:, None, None] + S * lane[None, :, None]
         + np.arange(S)[None, None, :])                       # (W, 32, S) slots
    j_edge = j[:, :, 0] - 1                                   # (W, 32): slot j0 - 1
    live_lane = (j[:, :, 0] < B)                              # lanes inside the band
    v = np.full((R, W, 32, S), NEG_INF, f32)
    acc = np.zeros(R, f32)
    decs = np.zeros((T // 32, R, Bp), np.uint32)
    ring = np.zeros((R, W, RING_HALVES, 2, HALF), f32)
    tl = t_len.astype(np.int64)[:, None]                      # (R, 1)
    rows = np.arange(R)

    def consts(pos, c):
        """mu, em_const, inv2v of positions ``pos`` (W, 32[, S]) in chunk c,
        as the producers gather and compute them."""
        p = lo[:, c].astype(np.int64).reshape((R,) + (1,) * pos.ndim) + pos[None]
        inside = (p >= 0) & (p < N)
        at = (rows.reshape((R,) + (1,) * pos.ndim), np.clip(p, 0, N - 1))
        mu = np.where(inside, mu_rows[at], f32(0))
        sg = np.where(inside, sg_rows[at], f32(1))
        log_sg = torch.log(torch.from_numpy(sg)).numpy()
        valid = p < n_ref.astype(np.int64).reshape((R,) + (1,) * pos.ndim)
        em = np.where(valid, -log_sg - HALF_LOG_2PI, NEG_INF).astype(f32)
        return mu, em, f32(0.5) / (sg * sg)

    def emit(q, xv):
        mu, em, iv = q
        d = xv - mu
        return em - (d * d) * iv

    for c in range(n_chunks):
        t0 = c * C
        if c > 0:
            row = v.reshape(R, Bp)
            src = j[None] + delta[:, c].astype(np.int64)[:, None, None, None]
            ok = (src >= 0) & (src < B)
            v = np.where(ok, row[rows[:, None, None, None], np.clip(src, 0, Bp - 1)],
                         NEG_INF).astype(f32)
        q_s = consts(j, c)                                    # (R, W, 32, S) each
        q_e = consts(j_edge, c)                               # (R, W, 32) each
        for g in range(gpc):
            G = c * gpc + g
            pk = np.zeros((R, W, 32, S), np.uint32)
            for half in range(2):
                h = 2 * G + half
                slot = h % RING_HALVES
                for w in range(W):                            # the wavefront
                    q = v[:, w]                               # (R, 32, S), a view
                    for u in range(HALF // 2):
                        s = HALF * half + 2 * u               # bit of the first sample
                        t = t0 + 32 * g + s
                        x1 = x[:, t][:, None, None]
                        x2 = x[:, t + 1][:, None, None]
                        e1 = emit(tuple(a[:, w] for a in q_s), x1)
                        e2 = emit(tuple(a[:, w] for a in q_s), x2)
                        e1m0 = emit(tuple(a[:, w] for a in q_e), x1[..., 0])
                        e1m0 = np.where(j_edge[w] < 0, NEG_INF, e1m0).astype(f32)
                        if mutate == "e1m_own":
                            e1m0 = e1[:, :, 0]
                        e1m = np.concatenate([e1m0[..., None], e1[..., :-1]], axis=2)
                        if w + 1 < W:                         # lane 31 feeds the ring
                            ring[:, w, slot, 0, u] = q[:, 31, S - 1]
                            ring[:, w, slot, 1, u] = q[:, 31, S - 2]
                        l1 = ring[:, w - 1, slot, 0, u][:, None] if w else NEG_INF
                        l2 = ring[:, w - 1, slot, 1, u][:, None] if w else NEG_INF
                        left1 = np.where(lane == 0, l1, shfl_up(q[:, :, S - 1]))
                        left2 = np.where(lane == 0, l2, shfl_up(q[:, :, S - 2]))
                        vm1 = np.concatenate([left1[..., None], q[..., :-1]], axis=2)
                        vm2 = np.concatenate([left2[..., None], left1[..., None],
                                              q[..., :-2]], axis=2)[..., :S]
                        act1 = (t < tl)[:, :, None]           # (R, 1, 1)
                        act2 = (t + 1 < tl)[:, :, None]
                        bit_lo = np.uint32(1 << s)
                        bit_hi = np.uint32(2 << s)
                        if t == 0:
                            stay_f = e1 + cs
                            move_f = e1m + cm
                            new = e2 + np.maximum(stay_f, move_f)
                            hi = (move_f > stay_f) & act2
                            pk[:, w] |= np.where(hi, bit_hi, np.uint32(0))
                            q[:] = np.where(act2, new, np.where(act1, e1, q))
                            continue
                        K0 = e1 + cs2
                        b_dec = e1m > e1
                        K1 = np.maximum(e1, e1m) + csm
                        K2 = e1m + cm2
                        c0 = q + K0
                        c1 = vm1 + K1
                        c2 = vm2 + K2
                        a1 = c1 > c0
                        m01 = np.maximum(c0, c1)
                        a2 = c2 > m01
                        new = e2 + np.maximum(m01, c2)
                        stay_h = q + cs
                        move_h = vm1 + cm
                        new_h = e1 + np.maximum(stay_h, move_h)
                        hi = (a2 | (a1 & b_dec)) & act2
                        lo_b = ((a2 | (a1 & ~b_dec)) & act2) | ((move_h > stay_h) & act1 & ~act2)
                        pk[:, w] |= np.where(hi, bit_hi, np.uint32(0))
                        pk[:, w] |= np.where(lo_b, bit_lo, np.uint32(0))
                        q[:] = np.where(act2, new, np.where(act1, new_h, q))
            decs[G] = pk.reshape(R, Bp)
        # chunk-end maximum over the slots inside the band
        vm = np.where(live_lane[None, :, :, None], v, NEG_INF)
        m = warp_max(vm.max(axis=3)).max(axis=1)
        m = np.where(m > NEG_INF / 2, m, f32(0)).astype(f32)
        v = (v - m[:, None, None, None]).astype(f32)
        acc = (acc + m).astype(f32)
    return (decs[:, :, :B].view(np.int32),), v.reshape(R, Bp)[:, :B], acc


PAIR_SHAPES = [(64, 128), (96, 128), (128, 128), (384, 128), (128, 32)]


def _pair_cfg(B, C):
    """The two-sample configuration at band width B. The kernel takes any
    multiple of 32, ``AlignConfig`` multiples of 128: below that a stand-in
    with the same fields drives the plain versions."""
    if B % 128 == 0:
        return AlignConfig(band_width=B, signal_chunk=C, dp_pair_step=True)
    d = AlignConfig()
    return types.SimpleNamespace(band_width=B, signal_chunk=C, dp_pair_step=True,
                                 use_skip=False, log_p_stay=d.log_p_stay,
                                 log_p_move=d.log_p_move)


def _pair_case(B, C):
    S, W = cuda_dp.fill_layout(B, pair_step=True)
    cfg = _pair_cfg(B, C)
    arrays = list(fill_inputs(B, C, S, seed=B + C + 5))
    t_len = arrays[1]
    T = arrays[0].shape[1]
    # odd and even lengths, reads shorter than one chunk, a free start alone
    # and a free start with one step
    t_len[:] = [0, 1, 2, 33, T, T - 7, C + 3]
    return S, W, cfg, arrays


@pytest.mark.parametrize("B, C", PAIR_SHAPES)
def test_pair_lane_model_matches_the_plain_pair_fill(B, C):
    S, W, cfg, arrays = _pair_case(B, C)
    assert S in (2, 4) and 1 <= W <= 8 and 32 * S * W >= B
    (dec,), v, acc = lane_fill_pair(*arrays, cfg, S, W)
    x, t_len, mu, sigma, lo, delta, n_ref = (torch.from_numpy(a) for a in arrays)
    mu_b, sg_b = cuda_dp.band_gather_plain(mu, sigma, lo, B)
    (p_dec,), p_v, p_acc = cuda_dp.viterbi_fill_pair_plain(x, t_len, mu_b, sg_b, lo,
                                                           delta, n_ref, cfg)
    # the wrapper on CPU tensors composes the same two plain versions
    (w_dec,), w_v, w_acc = cuda_dp.viterbi_fill(x, t_len, mu, sigma, lo, delta, n_ref,
                                                cfg)
    assert torch.equal(w_dec, p_dec) and torch.equal(w_v, p_v) and torch.equal(w_acc, p_acc)
    np.testing.assert_array_equal(dec, p_dec.numpy())
    assert int(np.count_nonzero(dec)) > 0
    np.testing.assert_array_equal(v, p_v.numpy())
    np.testing.assert_array_equal(acc, p_acc.numpy())


def test_pair_lane_model_mutation_is_caught():
    """The model with e1[j-1] of a lane's slot 0 taken from its own slot, not
    from the slot to its left: the plain version tells it apart."""
    B, C = 128, 128
    S, W, cfg, arrays = _pair_case(B, C)
    (dec,), v, _ = lane_fill_pair(*arrays, cfg, S, W, mutate="e1m_own")
    x, t_len, mu, sigma, lo, delta, n_ref = (torch.from_numpy(a) for a in arrays)
    mu_b, sg_b = cuda_dp.band_gather_plain(mu, sigma, lo, B)
    (p_dec,), p_v, _ = cuda_dp.viterbi_fill_pair_plain(x, t_len, mu_b, sg_b, lo, delta,
                                                       n_ref, cfg)
    assert not np.array_equal(dec, p_dec.numpy()) or not np.array_equal(v, p_v.numpy())
