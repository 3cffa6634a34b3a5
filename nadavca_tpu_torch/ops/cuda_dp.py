"""The alignment kernels of the port: wrappers and plain versions.

Counterpart of ``nadavca_tpu/ops/pallas_dp.py``. Each TPU kernel, and each
variant of one that is a program of its own, has a hand-written CUDA kernel
under ``csrc/`` and, beside its wrapper here, a plain PyTorch version with the
same contract:

  ``viterbi_fill``       csrc/viterbi_fill.cu       ``band_gather_plain`` +
                                                    ``viterbi_fill_plain``
  ``viterbi_fill_skip``  csrc/viterbi_fill.cu       the same (``use_skip``)
  ``viterbi_fill_pair``  csrc/viterbi_fill.cu       ``band_gather_plain`` +
                                                    ``viterbi_fill_pair_plain``
  ``backtrack``          csrc/backtrack.cu          ``backtrack_plain``
  ``backtrack_skip``     csrc/backtrack.cu          ``backtrack_plain`` (two planes)
  ``path_counts``        csrc/backtrack.cu          ``path_counts_plain`` (the walk's
                                                    counts, emitted by either walk)

The TPU's band gather (``band_gather_pallas``) runs inside the three fills,
in their producer warps (counted in ``band_gather_folded``); its plain
version is ``band_gather_plain``.

A wrapper checks its arguments, then looks at where the tensors lie: on the
CPU it runs the plain version; on a CUDA device it launches the kernel on the
current stream, or raises. Nothing falls back from the kernel to the plain
version. Each wrapper counts its kernel launches in ``<wrapper>.launches``.
``viterbi_fill`` and ``backtrack`` hand over to their variants as the config
(``use_skip``, ``dp_pair_step``) or the number of planes says, so callers use
those two names only.

The band is constant within a chunk of C samples (``sched/bands.py``), the
fill renormalises once per chunk, and decisions are packed 32 steps to an
int32 word in ``(T/32, R, B)`` planes: bit s of word w at (r, j) of plane 0 is
1 iff the best predecessor of cell (t = 32w + s, slot j) of read r is slot
j - 1; with the skip transition a second plane marks predecessor j - 2.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

from ..config import AlignConfig
from ..utils import kernel_build
from ..utils.profiling import span
from .banded_dp import NEG_INF, ViterbiResult

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
# most band slots the fill and walk kernels take (32 word columns of a lane in
# the walk, 8 chain warps of 4 slots a lane in the fill)
MAX_BAND = 1024


# ------------------------------------------------------------------ checking
def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(device) -> int:
    """The raw handle of the current stream on ``device`` (a CUDA device), by
    the call Triton's launcher makes too: a tenth of the host time of
    ``torch.cuda.current_stream(device).cuda_stream``, which builds a Stream."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _on(device):
    """The context a launch on ``device`` runs in: none when it is the current
    device (entering one costs as much host time as a small kernel takes)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


# --------------------------------------------------------------- band gather
def band_gather_plain(mu, sigma, lo, band_width: int):
    """Chunk-major band levels: ``out[c, r, j] = mu[r, lo[r, c] + j]``.

    mu, sigma (R, N) f32; lo (R, n_chunks) i32 with lo >= 0. Positions at or
    beyond N read the pad values (mu 0, sigma 1). Returns two (n_chunks, R, B)
    f32 tensors — the contract of ``band_gather_pallas``. The kernels gather
    the same values in the fills' producer warps; this is their plain
    version."""
    R, N = mu.shape
    B = band_width
    idx = lo.to(torch.int64)[:, :, None] + torch.arange(
        B, dtype=torch.int64, device=mu.device)[None, None, :]      # (R, n_chunks, B)
    ok = idx < N
    safe = idx.clamp(max=N - 1).reshape(R, -1)
    mu_b = torch.gather(mu, 1, safe).reshape(idx.shape)
    sg_b = torch.gather(sigma, 1, safe).reshape(idx.shape)
    mu_b = torch.where(ok, mu_b, torch.zeros_like(mu_b))
    sg_b = torch.where(ok, sg_b, torch.ones_like(sg_b))
    return mu_b.transpose(0, 1).contiguous(), sg_b.transpose(0, 1).contiguous()


class _Epilogue:
    """The launch count of work that runs inside another kernel's launch."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


# the band gather done by the producer warps of the fills (K1b of the TPU
# package, folded into K1, K7a and K7b): one count per fill launch, each of
# which gathers its own band levels
band_gather_folded = _Epilogue("band_gather_folded")


# ---------------------------------------------------------------------- fill
def _check_fill_cfg(cfg: AlignConfig) -> None:
    if cfg.signal_chunk % 32 != 0:
        raise ValueError("signal_chunk must be a multiple of 32")


def _shift(a, n: int, fill_col):
    """a'[:, j] = a[:, j - n], ``fill_col`` (R, 1) shifted in on the left."""
    return torch.cat([fill_col.expand(-1, n), a[:, : a.shape[1] - n]], dim=1)


class _FillState:
    """What the plain fills share: per-chunk realignment of the carried row,
    emission constants, packed decision words, chunk-end renormalisation."""

    def __init__(self, x, t_len, lo, delta, n_ref, cfg, n_planes):
        _check_fill_cfg(cfg)
        self.R, self.T = x.shape
        self.B, self.C = cfg.band_width, cfg.signal_chunk
        dev = self.dev = x.device
        R, B = self.R, self.B
        self.lane = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
        self.t_len = t_len.to(torch.int64)
        self.n_ref = n_ref.to(torch.int64)
        self.lo = lo.to(torch.int64)
        self.delta = delta.to(torch.int64)
        self.neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
        self.neg_col = torch.full((R, 1), NEG_INF, dtype=torch.float32, device=dev)
        self.zero = torch.zeros((), dtype=torch.float32, device=dev)
        self.decs = tuple(torch.zeros((self.T // 32, R, B), dtype=torch.int32,
                                      device=dev) for _ in range(n_planes))
        self.v = torch.full((R, B), NEG_INF, dtype=torch.float32, device=dev)
        self.acc = torch.zeros((R,), dtype=torch.float32, device=dev)
        self.t_max = int(self.t_len.max()) if R else 0

    def realign(self, c):
        """Move the carried row to chunk c's band start."""
        src = self.lane + self.delta[:, c][:, None]
        ok = (src >= 0) & (src < self.B)
        self.v = torch.where(ok, torch.gather(self.v, 1, src.clamp(0, self.B - 1)),
                             self.neg)

    def constants(self, c, mu_band, sigma_band):
        """(mu, em_const, inv2v) of chunk c; dead slots carry NEG_INF."""
        sg = sigma_band[c]
        pos_valid = (self.lo[:, c][:, None] + self.lane) < self.n_ref[:, None]
        em_const = torch.where(pos_valid, -torch.log(sg) - _HALF_LOG_2PI, self.neg)
        return mu_band[c], em_const, 0.5 / (sg * sg)

    def renormalise(self):
        m = self.v.max(dim=1).values
        m = torch.where(m > NEG_INF / 2, m, self.zero)
        self.v = self.v - m[:, None]
        self.acc = self.acc + m


def viterbi_fill_plain(x, t_len, mu_band, sigma_band, lo, delta, n_ref,
                       cfg: AlignConfig):
    """Plain version of :func:`viterbi_fill` and :func:`viterbi_fill_skip`: a
    Python loop over t on (R, B) tensors with the kernels' semantics (per-chunk
    band, per-chunk renormalisation, packed decision words). ``cfg.use_skip``
    selects the three-candidate step with two decision planes. Returns
    (decs, V, acc) with ``decs`` a tuple of one or two planes."""
    skip = bool(cfg.use_skip)
    st = _FillState(x, t_len, lo, delta, n_ref, cfg, 2 if skip else 1)
    R, B, C = st.R, st.B, st.C
    dev = st.dev
    dcs = cfg.log_p_move - cfg.log_p_stay
    neg_col = st.neg_col

    for c in range(st.T // C):
        t0 = c * C
        if c > 0:
            st.realign(c)
        n_steps = min(C, st.t_max - t0)
        if n_steps > 0:     # else every step of the chunk is an identity step
            mu, em_const, inv2v = st.constants(c, mu_band, sigma_band)
            c2p = -inv2v
            c1p = (mu + mu) * inv2v
            c0p = em_const - mu * mu * inv2v + cfg.log_p_stay
            packs = [torch.zeros((R, B), dtype=torch.int32, device=dev)
                     for _ in st.decs]
            for s in range(n_steps):
                t = t0 + s
                v = st.v
                xc = x[:, t][:, None]
                if skip:
                    diff = xc - mu
                    emit = em_const - diff * diff * inv2v
                    stay = v + cfg.log_p_stay
                    move = _shift(v, 1, neg_col) + cfg.log_p_move
                    bit = move > stay
                    best = torch.maximum(stay, move)
                    # strict compares: stay beats move beats skip on ties
                    skp = _shift(v, 2, neg_col) + cfg.log_p_skip
                    bit2 = skp > best
                    bit = bit & ~bit2
                    best = torch.maximum(best, skp)
                    free = emit
                else:
                    emit = (c2p * xc + c1p) * xc + c0p
                    mv = _shift(v, 1, neg_col) + dcs
                    bit = mv > v
                    best = torch.maximum(v, mv)
                    free = emit - cfg.log_p_stay
                active = (t < st.t_len)[:, None]
                if t == 0:
                    v_new = free
                    bits = [torch.zeros_like(bit)] * len(packs)
                else:
                    v_new = emit + best
                    bits = [bit, bit2] if skip else [bit]
                st.v = torch.where(active, v_new, v)
                for p, b in enumerate(bits):
                    packs[p] = packs[p] | ((b & active).to(torch.int32) << (s % 32))
                if s % 32 == 31 or s == n_steps - 1:
                    for p, dec in enumerate(st.decs):
                        dec[t // 32] = packs[p]
                        packs[p] = torch.zeros_like(packs[p])
        st.renormalise()
    return st.decs, st.v, st.acc


def viterbi_fill_pair_plain(x, t_len, mu_band, sigma_band, lo, delta, n_ref,
                            cfg: AlignConfig):
    """Plain version of :func:`viterbi_fill_pair`: two samples per iteration,
    regrouped by total advance 0 / 1 / 2, the per-sample bits recovered from
    the winning decomposition. Same outputs as the single-step fill without
    skip: ((plane,), V, acc)."""
    st = _FillState(x, t_len, lo, delta, n_ref, cfg, 1)
    R, B, C = st.R, st.B, st.C
    dev = st.dev
    cs, cm = cfg.log_p_stay, cfg.log_p_move
    neg_col = st.neg_col
    dec = st.decs[0]

    for c in range(st.T // C):
        t0 = c * C
        if c > 0:
            st.realign(c)
        n_steps = min(C, st.t_max - t0)
        if n_steps > 0:
            mu, em_const, inv2v = st.constants(c, mu_band, sigma_band)
            tmask = (st.t_len - t0)[:, None]
            pack = torch.zeros((R, B), dtype=torch.int32, device=dev)
            for s in range(0, n_steps, 2):
                v = st.v
                d1 = x[:, t0 + s][:, None] - mu
                e1 = em_const - d1 * d1 * inv2v
                d2 = x[:, t0 + s + 1][:, None] - mu
                e2 = em_const - d2 * d2 * inv2v
                e1m = _shift(e1, 1, neg_col)
                vm1 = _shift(v, 1, neg_col)
                # half pair (the read ends between the two samples): one
                # single step from v
                stay_h = v + cs
                move_h = vm1 + cm
                if t0 + s == 0:
                    # free start at the first sample, one single step from it
                    stay_f = e1 + cs
                    move_f = e1m + cm
                    bit_hi = move_f > stay_f
                    bit_lo = torch.zeros_like(bit_hi)
                    v_new = e2 + torch.maximum(stay_f, move_f)
                    v_half = e1
                    bit_lo_half = bit_lo
                else:
                    # pair-transition constants, functions of the emissions alone
                    K0 = e1 + (cs + cs)
                    b_dec = e1m > e1
                    K1 = torch.maximum(e1, e1m) + (cs + cm)
                    K2 = e1m + (cm + cm)
                    c0 = v + K0
                    c1 = vm1 + K1
                    c2 = _shift(v, 2, neg_col) + K2
                    a1best = c1 > c0
                    m01 = torch.maximum(c0, c1)
                    a2best = c2 > m01
                    v_new = e2 + torch.maximum(m01, c2)
                    bit_hi = a2best | (a1best & b_dec)
                    bit_lo = a2best | (a1best & ~b_dec)
                    v_half = e1 + torch.maximum(stay_h, move_h)
                    bit_lo_half = move_h > stay_h
                act1 = s < tmask
                act2 = (s + 1) < tmask
                st.v = torch.where(act2, v_new, torch.where(act1, v_half, v))
                bit_lo = (act2 & bit_lo) | (~act2 & bit_lo_half & act1)
                bit_hi = bit_hi & act2
                pack = pack | (bit_lo.to(torch.int32) << (s % 32))
                pack = pack | (bit_hi.to(torch.int32) << ((s + 1) % 32))
                if s % 32 == 30 or s + 2 >= n_steps:
                    dec[(t0 + s) // 32] = pack
                    pack = torch.zeros_like(pack)
        st.renormalise()
    return st.decs, st.v, st.acc


def fill_layout(band_width: int, use_skip: bool = False,
                pair_step: bool = False) -> Tuple[int, int]:
    """(S, W) of the fill kernel for a band of ``band_width`` slots: the
    single-step fill without or with skip, or with ``pair_step`` the
    two-sample fill. S slots per lane, W chain warps per read (each with a
    producer warp beside it; the two-sample fill's last warp may reach past
    the band). The table is ``slots_per_lane`` in ``csrc/viterbi_fill.cu``,
    which the kernels use; this is its copy."""
    if pair_step:
        S = 2 if band_width <= 384 else 4
    else:
        S = 2 if use_skip and band_width <= 256 else 4
    return S, -(-band_width // (32 * S))


def _fill_prologue(name, x, t_len, mu, sigma, lo, delta, n_ref, cfg):
    """Argument checks shared by the three fill wrappers, the level rows mu,
    sigma (R, N) among them. Returns (R, T, C, B)."""
    _check_fill_cfg(cfg)
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"x: expected (R, T), got {tuple(x.shape)}")
    R, T = x.shape
    B, C = cfg.band_width, cfg.signal_chunk
    if T % C != 0:
        raise ValueError(f"T={T} must be a multiple of signal_chunk={C}")
    n_chunks = T // C
    _check("x", x, torch.float32, (R, T), dev)
    _check("t_len", t_len, torch.int32, (R,), dev)
    _check("n_ref", n_ref, torch.int32, (R,), dev)
    if mu.dim() != 2 or mu.shape[1] < 1:
        raise ValueError(f"mu: expected (R, N) with N >= 1, got {tuple(mu.shape)}")
    _check("mu", mu, torch.float32, (R, mu.shape[1]), dev)
    _check("sigma", sigma, torch.float32, (R, mu.shape[1]), dev)
    _check("lo", lo, torch.int32, (R, n_chunks), dev)
    _check("delta", delta, torch.int32, (R, n_chunks), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and B > MAX_BAND:
        raise ValueError(f"band_width {B} exceeds {MAX_BAND} slots, the most the "
                         f"fill kernels take")
    return R, T, C, B


def _fill_outputs(R, T, B, dev, n_planes):
    # every word is written by the kernel (zeros for chunks beyond a read's end)
    decs = tuple(torch.empty((T // 32, R, B), dtype=torch.int32, device=dev)
                 for _ in range(n_planes))
    v_out = torch.empty((R, B), dtype=torch.float32, device=dev)
    acc = torch.empty((R,), dtype=torch.float32, device=dev)
    return decs, v_out, acc


def viterbi_fill(x: torch.Tensor, t_len: torch.Tensor, mu: torch.Tensor,
                 sigma: torch.Tensor, lo: torch.Tensor,
                 delta: torch.Tensor, n_ref: torch.Tensor, cfg: AlignConfig):
    """Banded Viterbi fill.

    x (R, T) f32; t_len, n_ref (R,) i32; mu, sigma (R, N) f32 the expected
    levels of each read's window; lo, delta (R, n_chunks) i32 with lo >= 0
    and delta >= 0. T must be a multiple of ``cfg.signal_chunk``, which must
    be a multiple of 32. The kernel gathers each chunk's band levels from the
    rows itself (the band gather folded into its producer warps, counted in
    ``band_gather_folded``); on the CPU :func:`band_gather_plain` and
    :func:`viterbi_fill_plain` run. Returns (decs, V (R, B) f32 the final
    renormalised band row, acc (R,) f32 the renormalisation accumulator),
    where ``decs`` is a tuple of (T/32, R, B) i32 planes of packed decision
    words: one plane without skip, two with — the contract of
    ``band_gather_pallas`` followed by ``viterbi_fill_pallas``.

    ``cfg.use_skip`` goes to :func:`viterbi_fill_skip`, ``cfg.dp_pair_step``
    (without skip) to :func:`viterbi_fill_pair`; what is launched and counted
    here is the single-step kernel without skip.
    """
    args = (x, t_len, mu, sigma, lo, delta, n_ref, cfg)
    if cfg.use_skip:
        return viterbi_fill_skip(*args)
    if cfg.dp_pair_step:
        return viterbi_fill_pair(*args)
    return _fill_rows("viterbi_fill", viterbi_fill, 1, *args)


viterbi_fill.launches = 0


def _fill_rows(name, wrapper, n_planes, x, t_len, mu, sigma, lo, delta, n_ref,
               cfg: AlignConfig):
    """The body of the three fill wrappers."""
    R, T, C, B = _fill_prologue(name, x, t_len, mu, sigma, lo, delta, n_ref, cfg)
    dev = x.device
    pair = name == "viterbi_fill_pair"
    if dev.type == "cpu":
        mu_b, sg_b = band_gather_plain(mu, sigma, lo, B)
        plain = viterbi_fill_pair_plain if pair else viterbi_fill_plain
        return plain(x, t_len, mu_b, sg_b, lo, delta, n_ref, cfg)
    lib = kernel_build.load_library()
    decs, v_out, acc = _fill_outputs(R, T, B, dev, n_planes)
    cs, cm = cfg.log_p_stay, cfg.log_p_move
    if pair:
        # the pair sums in double, rounded to float32 once, as the plain
        # version's Python floats are
        consts = (float(cs), float(cm), float(cs + cs), float(cs + cm), float(cm + cm))
    elif n_planes == 2:
        consts = (float(cs), float(cm), float(cfg.log_p_skip))
    else:
        consts = (float(cs), float(cm - cs))
    with _on(dev):
        code = getattr(lib, "nadavca_" + name)(
            x.data_ptr(), t_len.data_ptr(), mu.data_ptr(), sigma.data_ptr(),
            lo.data_ptr(), delta.data_ptr(), n_ref.data_ptr(),
            *(d.data_ptr() for d in decs), v_out.data_ptr(), acc.data_ptr(),
            R, T, C, B, mu.shape[1], *consts, _stream(dev))
    kernel_build.check_launch(lib, code, name)
    wrapper.launches += 1
    band_gather_folded.launches += 1
    return decs, v_out, acc


def viterbi_fill_skip(x, t_len, mu, sigma, lo, delta, n_ref, cfg: AlignConfig):
    """The fill with the skip transition: a third candidate
    ``V[t-1, j-2] + log_p_skip`` and two decision planes (plane 0: advance 1,
    plane 1: advance 2). Arguments as :func:`viterbi_fill`; returns
    ((plane0, plane1), V, acc)."""
    if not cfg.use_skip:
        raise ValueError("viterbi_fill_skip needs cfg.use_skip")
    return _fill_rows("viterbi_fill_skip", viterbi_fill_skip, 2, x, t_len, mu, sigma,
                      lo, delta, n_ref, cfg)


viterbi_fill_skip.launches = 0


def viterbi_fill_pair(x, t_len, mu, sigma, lo, delta, n_ref, cfg: AlignConfig):
    """The fill without skip, two samples per serial step (``dp_pair_step``):
    arguments as :func:`viterbi_fill`, the level rows included; the kernel
    gathers its band levels itself, on the CPU :func:`band_gather_plain` and
    :func:`viterbi_fill_pair_plain` run. Returns ((plane,), V, acc). Scores
    agree with the single-step fill to float32 rounding; near-tie decisions
    can differ, because the regrouped sums round differently, and the bit of
    a pair's first sample stands where the pair ends (the TPU body's, kept).
    On CUDA tensors the band width is any multiple of 32 up to 1024."""
    if cfg.use_skip:
        raise ValueError("viterbi_fill_pair has no skip transition")
    return _fill_rows("viterbi_fill_pair", viterbi_fill_pair, 1, x, t_len, mu, sigma,
                      lo, delta, n_ref, cfg)


viterbi_fill_pair.launches = 0


# ----------------------------------------------------------------- backtrack
def backtrack_plain(decs, lo, delta, j_end, chunk_size: int):
    """Plain version of the path of :func:`backtrack` and
    :func:`backtrack_skip`: a Python loop down t with one (R,)-gather per
    plane and step."""
    Tw, R, B = decs[0].shape
    T = Tw * 32
    C = chunk_size
    dev = decs[0].device
    lo = lo.to(torch.int64)
    delta = delta.to(torch.int64)
    j = j_end.to(torch.int64)
    rows = torch.arange(R, device=dev)
    path = torch.empty((R, T), dtype=torch.int64, device=dev)
    alive = (j >= 0) & (j < B)
    for t in range(T - 1, -1, -1):
        c = t // C
        path[:, t] = lo[:, c] + j
        if t == 0:
            break
        jc = j.clamp(0, B - 1)
        adv = torch.zeros_like(j)
        for p, dec in enumerate(decs):
            adv = adv + (((dec[t // 32][rows, jc] >> (t % 32)) & 1).to(torch.int64) << p)
        adv = torch.where(alive, adv, torch.zeros_like(adv))
        j = j - adv
        if t % C == 0:
            j = j + delta[:, c]
        # a pointer that left the band reads advance 0 from then on
        alive = alive & (j >= 0) & (j < B)
    return path.to(torch.int32)


def path_counts_plain(path, n_lanes: int, t_len):
    """Plain version of the walk's counts: ``C[r, i] = #{t < t_len[r] :
    path[r, t] < i}`` for i in [0, n_lanes), a searchsorted on the path with
    the samples at or past ``t_len`` set to a sentinel that is never counted
    — the contract of ``path_counts_pallas``. Returns (R, n_lanes) i32."""
    R, T = path.shape
    dev = path.device
    live = torch.arange(T, device=dev)[None, :] < t_len.to(torch.int64)[:, None]
    p = torch.where(live, path.to(torch.int64),
                    torch.full((), n_lanes, dtype=torch.int64, device=dev))
    lanes = torch.arange(n_lanes, dtype=torch.int64, device=dev)[None, :]
    return torch.searchsorted(p.contiguous(), lanes.expand(R, n_lanes).contiguous(),
                              right=False).to(torch.int32)


# the walk's counts epilogue (K3 of the TPU package): one launch per walk that
# emitted counts
path_counts = _Epilogue("path_counts")


def _backtrack_prologue(name, decs, n_planes, lo, delta, j_end, chunk_size,
                        t_len, n_lanes):
    if not isinstance(decs, (tuple, list)) or len(decs) != n_planes:
        raise ValueError(f"{name}: expected a tuple of {n_planes} decision "
                         f"plane(s)")
    dec = decs[0]
    dev = dec.device
    if dec.dim() != 3:
        raise ValueError(f"dec: expected (T/32, R, B), got {tuple(dec.shape)}")
    Tw, R, B = dec.shape
    T = Tw * 32
    C = int(chunk_size)
    if C % 32 != 0 or T % C != 0:
        raise ValueError(f"chunk_size={C} must be a multiple of 32 dividing T={T}")
    n_chunks = T // C
    for p, d in enumerate(decs):
        _check(f"decs[{p}]", d, torch.int32, (Tw, R, B), dev)
    _check("lo", lo, torch.int32, (R, n_chunks), dev)
    _check("delta", delta, torch.int32, (R, n_chunks), dev)
    _check("j_end", j_end, torch.int32, (R,), dev)
    if (t_len is None) != (n_lanes is None):
        raise ValueError(f"{name}: t_len and n_lanes go together")
    if t_len is not None:
        _check("t_len", t_len, torch.int32, (R,), dev)
        if int(n_lanes) < 1:
            raise ValueError(f"n_lanes must be positive, got {n_lanes}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and (B % 32 != 0 or not 32 <= B <= MAX_BAND):
        raise ValueError(f"{name}: the kernel takes band widths 32..{MAX_BAND} in "
                         f"steps of 32, got {B}")
    return R, T, C, B


def _walk(name, wrapper, n_planes, decs, lo, delta, j_end, chunk_size, t_len,
          n_lanes):
    """The body of :func:`backtrack` and :func:`backtrack_skip`."""
    R, T, C, B = _backtrack_prologue(name, decs, n_planes, lo, delta, j_end,
                                     chunk_size, t_len, n_lanes)
    counts = t_len is not None
    dev = decs[0].device
    if dev.type == "cpu":
        path = backtrack_plain(decs, lo, delta, j_end, C)
        return (path, path_counts_plain(path, int(n_lanes), t_len)) if counts else path
    lib = kernel_build.load_library()
    path = torch.empty((R, T), dtype=torch.int32, device=dev)
    cnt = torch.empty((R, int(n_lanes)), dtype=torch.int32, device=dev) if counts else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    planes = tuple(d.data_ptr() for d in decs)
    with _on(dev):
        code = getattr(lib, "nadavca_" + name)(
            *planes, lo.data_ptr(), delta.data_ptr(), j_end.data_ptr(), ptr(t_len),
            path.data_ptr(), ptr(cnt), R, T, C, B, int(n_lanes) if counts else 0,
            _stream(dev))
    kernel_build.check_launch(lib, code, name)
    wrapper.launches += 1
    if counts:
        path_counts.launches += 1
        return path, cnt
    return path


def backtrack(decs, lo: torch.Tensor, delta: torch.Tensor, j_end: torch.Tensor,
              chunk_size: int, t_len: Optional[torch.Tensor] = None,
              n_lanes: Optional[int] = None):
    """Per-sample reference positions from the packed decision words, and on
    request the path's segment counts.

    decs: the plane tuple of :func:`viterbi_fill`, each (T/32, R, B) i32; lo,
    delta (R, n_chunks) i32; j_end (R,) i32 the final band slot. Returns path
    (R, T) i32 with ``path[r, t] = lo[r, t // C] + j[t]`` — the return value
    of ``backtrack_pallas`` (kernel and epilogue together). With ``t_len``
    (R,) i32 and ``n_lanes``, returns (path, cnt) with cnt (R, n_lanes) i32
    the counts of :func:`path_counts_plain` — the contract of
    ``path_counts_pallas`` — emitted by the same launch. Two planes go to
    :func:`backtrack_skip`; what is launched and counted here is the
    one-plane walk. On CUDA tensors B is a multiple of 32 up to 1024.
    """
    if isinstance(decs, (tuple, list)) and len(decs) == 2:
        return backtrack_skip(decs, lo, delta, j_end, chunk_size, t_len, n_lanes)
    return _walk("backtrack", backtrack, 1, decs, lo, delta, j_end, chunk_size,
                 t_len, n_lanes)


backtrack.launches = 0


def backtrack_skip(decs, lo, delta, j_end, chunk_size: int,
                   t_len: Optional[torch.Tensor] = None,
                   n_lanes: Optional[int] = None):
    """The walk over two decision planes: the advance at the pointer is
    ``bit0 + 2 * bit1``. Arguments and result as :func:`backtrack`."""
    return _walk("backtrack_skip", backtrack_skip, 2, decs, lo, delta, j_end,
                 chunk_size, t_len, n_lanes)


backtrack_skip.launches = 0

KERNELS = (viterbi_fill, backtrack, viterbi_fill_skip, viterbi_fill_pair,
           backtrack_skip, path_counts)
# every launch count: the kernels', and that of the band gather folded into
# the fills
COUNTERS = KERNELS + (band_gather_folded,)


def reset_launches() -> None:
    for k in COUNTERS:
        k.launches = 0


# ------------------------------------------------------------- the alignment
def final_slot_and_score(v_fin, acc, lo_last, n_ref):
    """Best valid final slot and score: first maximum of the band row among
    slots whose position lies inside the window."""
    B = v_fin.shape[1]
    lane = torch.arange(B, dtype=torch.int64, device=v_fin.device)[None, :]
    i_fin = lo_last.to(torch.int64)[:, None] + lane
    v_valid = torch.where(i_fin < n_ref.to(torch.int64)[:, None], v_fin,
                          torch.full((), NEG_INF, dtype=v_fin.dtype,
                                     device=v_fin.device))
    j_end = torch.argmax(v_valid, dim=1)
    score = acc + torch.gather(v_valid, 1, j_end[:, None])[:, 0]
    return j_end.to(torch.int32), score


def cuda_viterbi_batch(x, t_len, mu, sigma, n_ref, lo, delta, cfg: AlignConfig,
                       with_path: bool = True, count_lanes: Optional[int] = None):
    """Fill (with its band gather) → score (→ backtrack), twin of
    ``pallas_viterbi_batch``.

    Same contract as ``banded_dp.banded_viterbi_batch`` but taking chunked
    bands (lo, delta (R, n_chunks) from ``sched.build_chunked_bands``).
    Returns (ViterbiResult, decs) with ``decs`` the tuple of decision planes.
    With ``count_lanes`` the walk also emits the path's segment counts over
    that many lanes into ``ViterbiResult.counts``. Spans: ``nadavca.fill``,
    ``nadavca.final_slot``, ``nadavca.walk``.
    """
    with span("nadavca.fill"):
        decs, v_fin, acc = viterbi_fill(x, t_len, mu, sigma, lo, delta, n_ref, cfg)
    with span("nadavca.final_slot"):
        j_end, score = final_slot_and_score(v_fin, acc, lo[:, -1], n_ref)
    if not with_path:
        return ViterbiResult(score=score, path=None, final_j=j_end), decs
    with span("nadavca.walk"):
        if count_lanes is None:
            path, cnt = backtrack(decs, lo, delta, j_end, cfg.signal_chunk), None
        else:
            path, cnt = backtrack(decs, lo, delta, j_end, cfg.signal_chunk,
                                  t_len=t_len, n_lanes=count_lanes)
    return ViterbiResult(score=score, path=path, final_j=j_end, counts=cnt), decs
