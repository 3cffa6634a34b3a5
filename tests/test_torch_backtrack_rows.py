"""A numpy model of the walk in ``csrc/backtrack.cu`` against its contract.

The CUDA kernel splits the walk into three passes over segments of word rows
(row maps, a stitch of the maps, a re-walk of every row from its entry that
also emits the path's segment counts). This file writes the same three
passes in numpy, for the test only, and holds them bit for bit against the
plain versions of the contract, ``cuda_dp.backtrack_plain`` and
``cuda_dp.path_counts_plain``, on seeded random decision words and band
tables: one and two planes, B = 128, 256, 384 and 1024 (the most the kernel
takes), pointers that leave the band,
final slots at both band edges, t_len of 0, 1 and T, and segment boundaries
on and off chunk boundaries. The kernel itself is held against the plain
versions on the card (``tests/test_torch_card.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu_torch.ops import cuda_dp

CODE_OFFSET = 4     # a map code is value + 4: dead at -2, -1 are 0, 1


def row_map(row_words, B):
    """Pass 1: the exit code of every entry slot of one word row. ``row_words``
    (P, B) uint32. The steps are composed from s = 0 up, as one warp does."""
    e = np.arange(B)
    adv = np.zeros((32, B), np.int64)
    for p, plane in enumerate(row_words):
        adv += ((plane[None, :] >> np.arange(32)[:, None].astype(np.uint32)) & 1
                ).astype(np.int64) << p
    h = e + CODE_OFFSET                       # identity
    for s in range(32):
        src = e - adv[s]
        # below slot 0: the raw value after step 0, dead after a later step
        below = src + CODE_OFFSET - (0 if s == 0 else 2)
        h = np.where(src < 0, below, h[np.clip(src, 0, B - 1)])
    return h


def walk_rows(decs, lo, delta, j_end, t_len, C, n_lanes, S):
    """The kernel's three passes for every read, ``S`` word rows per segment.
    Returns (path (R, T), cnt (R, n_lanes)) as int32."""
    P = len(decs)
    Tw, R, B = decs[0].shape
    T = 32 * Tw
    words = np.stack([d.view(np.uint32) for d in decs], axis=2)   # (Tw, R, P, B)
    path = np.zeros((R, T), np.int64)
    cnt = np.zeros((R, n_lanes), np.int64)
    for r in range(R):
        tl = min(max(int(t_len[r]), 0), T)
        row_cnt = cnt[r]
        ends = [0, 0]

        def emit(tp, lower, upper):
            if tp < tl:
                hi = min(upper, n_lanes - 1)
                row_cnt[max(lower + 1, 0):hi + 1] = tp

        def lo_d(w):
            if w < 0:
                return 0, 0
            c = (32 * w) // C
            return int(lo[r, c]), int(delta[r, c]) if (32 * w) % C == 0 else 0

        j = int(j_end[r])
        alive = 0 <= j < B
        w_hi = Tw
        while w_hi > 0:
            w_lo = max(w_hi - S, 0)
            n = w_hi - w_lo
            maps = [row_map(words[w_lo + i, r], B) for i in range(n)]
            # 2. stitch: ent[i + 1] is the state at the top of row w_lo + i,
            # ent[0] at the top of the row below the segment
            ent = [None] * (n + 1)
            for i in range(n - 1, -1, -1):
                ent[i + 1] = (j, alive)
                if alive:
                    v = int(maps[i][j]) - CODE_OFFSET
                    if v < -2:
                        j, alive = v + 2, False
                    else:
                        j = v
                j += lo_d(w_lo + i)[1]
                alive = alive and 0 <= j < B
            ent[0] = (j, alive)
            # 3. re-walk every row from its entry
            for i in range(n):
                w = w_lo + i
                jj, al = ent[i + 1]
                lo_c = lo_d(w)[0]
                for s in range(31, -1, -1):
                    path[r, 32 * w + s] = lo_c + jj
                    if al and s > 0:
                        adv = sum(int((words[w, r, q, jj] >> s) & 1) << q for q in range(P))
                        jj -= adv
                        al = jj >= 0
            # the counts the segment's samples cross, from the sample below
            for t in range(32 * w_lo, 32 * w_hi):
                p = int(path[r, t])
                if t == 0:
                    ends[0] = p
                else:
                    below = (int(path[r, t - 1]) if t > 32 * w_lo
                             else lo_d(w_lo - 1)[0] + ent[0][0])
                    emit(t, below, p)
                if t == tl - 1:
                    ends[1] = p
            w_hi = w_lo
        i = np.arange(n_lanes)
        fill0 = (tl <= 0) | (i <= ends[0])
        row_cnt[fill0] = 0
        row_cnt[~fill0 & (i > ends[1])] = tl
    return path.astype(np.int32), cnt.astype(np.int32)


def _inputs(seed, R, Tw, B, C, n_planes, move_p):
    """Random decision words (planes disjoint, as the skip fill writes them),
    a consistent band schedule (lo[c] = lo[c-1] + delta[c]) with jumps that
    can push a pointer out of the band, final slots at both band edges and
    beyond, and t_len of 0, 1 and T among random lengths."""
    rng = np.random.default_rng(seed)
    T = 32 * Tw
    n_chunks = T // C

    def bits(p):
        return np.packbits(rng.random((Tw, R, B, 32)) < p, axis=-1,
                           bitorder="little").view(np.uint32)[..., 0]

    planes = [bits(move_p)]
    if n_planes == 2:
        planes.append(bits(move_p / 2) & ~planes[0])
    delta = rng.integers(0, 40, (R, n_chunks)).astype(np.int32)
    delta[:, 0] = 0
    # read 5 steps from slot 0 to -1 on the first sample of a chunk, and the
    # chunk's jump brings it back into the band: still alive, it moves again
    c = n_chunks // 2
    w = c * C // 32
    for p in planes:
        p[:, 5] = 0
    planes[0][w, 5, 0] = 1
    planes[0][w - 1, 5, 6] = 1 << 31
    delta[5, c + 1:] = 0
    delta[5, c] = 7
    lo = (np.cumsum(delta, axis=1) + rng.integers(0, 50, (R, 1))).astype(np.int32)
    j_end = rng.integers(0, B, R).astype(np.int32)
    j_end[:4] = (0, B - 1, B - 1, 0)
    j_end[4] = B + 3                          # out of the band from the start
    j_end[5] = 0
    t_len = rng.integers(1, T + 1, R).astype(np.int32)
    t_len[:4] = (0, 1, T, T)
    decs = tuple(p.view(np.int32) for p in planes)
    return decs, lo, delta, j_end, t_len


# (B, planes, C, Tw, S, move probability): segments of 4 rows end on chunk
# boundaries when C = 64 (two rows a chunk) or 128; 3 rows do not
CASES = {
    "b128_one_plane_segments_on_chunks": (128, 1, 64, 24, 4, 0.35),
    "b128_one_plane_segments_off_chunks": (128, 1, 128, 20, 3, 0.6),
    "b128_two_planes": (128, 2, 128, 16, 4, 0.3),
    "b256_one_plane": (256, 1, 32, 12, 5, 0.4),
    "b256_two_planes_one_segment": (256, 2, 64, 8, 8, 0.5),
    # past 256 slots: 16-bit codes in 6 and 16 registers a lane (B / 64)
    "b384_one_plane": (384, 1, 128, 12, 5, 0.4),
    "b384_two_planes": (384, 2, 64, 10, 4, 0.35),
    "b1024_one_plane": (1024, 1, 64, 8, 3, 0.45),
    "b1024_two_planes": (1024, 2, 128, 8, 5, 0.3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_passes_match_the_plain_walk_and_counts(name):
    B, n_planes, C, Tw, S, move_p = CASES[name]
    R = 8
    decs, lo, delta, j_end, t_len = _inputs(sorted(CASES).index(name), R, Tw, B, C,
                                            n_planes, move_p)
    n_lanes = int(lo.max()) + B + 8
    path, cnt = walk_rows(decs, lo, delta, j_end, t_len, C, n_lanes, S)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    want_path = cuda_dp.backtrack_plain(tuple(t(d) for d in decs), t(lo), t(delta),
                                        t(j_end), C)
    want_cnt = cuda_dp.path_counts_plain(want_path, n_lanes, t(t_len))
    np.testing.assert_array_equal(path, want_path.numpy())
    np.testing.assert_array_equal(cnt, want_cnt.numpy())
    # and the wrapper gives the same on the CPU
    got_path, got_cnt = cuda_dp.backtrack(tuple(t(d) for d in decs), t(lo), t(delta),
                                          t(j_end), C, t_len=t(t_len), n_lanes=n_lanes)
    assert torch.equal(got_path, want_path) and torch.equal(got_cnt, want_cnt)

    # the cases reach what they are for: pointers that leave the band inside
    # a row and at a chunk's jump, both band edges, t_len 0 / 1 / T
    lo_rep = np.repeat(lo, C, axis=1)
    j = path - lo_rep
    assert (j < 0).any() and (j_end >= B).any()
    assert set(t_len[:4]) == {0, 1, 32 * Tw} and (cnt[0] == 0).all()
    if n_planes == 2:
        assert (np.diff(path, axis=1) == 2).any()
