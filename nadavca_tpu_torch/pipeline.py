"""Per-batch orchestration: reads → anchored, padded batches → device DP → SNPs.

Counterpart of ``nadavca_tpu/pipeline.py``. The host does ingest,
normalization, anchoring, window/level precompute and batch padding (numpy);
``stage_batch`` puts the batch on the requested device (on a CUDA device from
page-locked memory, without waiting: ``utils/upload.py``); ``device_compute``
runs the banded Viterbi (the CUDA kernels of ``ops/cuda_dp`` under backend
``"cuda"``, the plain loop of ``ops/banded_dp`` under ``"scan"``) and the
rescore: the local re-DP (``snp_rescore="local"``, the default; the CUDA
kernels of ``ops/cuda_rescore`` under ``"cuda"``, with genome substitution
tables when the caller built them) or the closed-form fixed-path rescore as
eager PyTorch. ``cfg.use_skip`` and ``cfg.dp_pair_step`` select the fill and
backtrack variants inside ``ops/cuda_dp``. There is no jit layer:
``align_batch`` calls ``device_compute`` directly.

Host prep runs either in Python (``preprocess_read``) or in the native C++
engine (``prep_native``, the JAX package's ``csrc/prep.cpp``);
``make_preprocessor`` picks one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .anchor import Anchor, SeedIndex, anchor_basecall, signal_anchor_path
from .config import AlignConfig
from .genome import Genome, kmer_ids
from .kmer_model import KmerModel
from .ops import banded_dp, cuda_dp, cuda_rescore
from .sched.bands import ChunkedBands, build_chunked_bands
from .utils.profiling import span
from .utils.upload import Upload, host_full


@dataclasses.dataclass
class ReadRecord:
    """A read after host-side preprocessing, ready for batching."""

    read_id: str
    signal: np.ndarray        # (T,) float32 normalized
    anchor: Anchor
    anchor_path: np.ndarray   # (T,) float64 window k-mer position per sample
    window_codes: np.ndarray  # (L,) int8
    # expected levels of the window, computed once during preprocessing and
    # reused by assemble_batch
    mu: Optional[np.ndarray] = None      # (N,) f32
    sigma: Optional[np.ndarray] = None   # (N,) f32


@dataclasses.dataclass
class Batch:
    """Padded device-ready batch plus host-side metadata. Where CUDA is
    present, every array ``stage_batch`` uploads (the bands' too) is a numpy
    view of a page-locked torch tensor, which it holds as its ``base``
    (``utils.upload``)."""

    x: np.ndarray             # (R, T) f32
    t_len: np.ndarray         # (R,) i32
    mu: np.ndarray            # (R, N) f32
    sigma: np.ndarray         # (R, N) f32
    n_ref: np.ndarray         # (R,) i32
    bands: ChunkedBands
    codes: np.ndarray         # (R, L) i32 window bases (4 = pad)
    ids: np.ndarray           # (R, N) i32 kmer ids (-1 = pad)
    window_start: np.ndarray  # (R,) i32 genome coord of window start
    window_len: np.ndarray    # (R,) i32 = L true bases
    strand: np.ndarray        # (R,) i32
    read_ids: List[str]
    contigs: List[str]        # contig per read (padded rows repeat the first)
    n_reads: int              # true (unpadded) read count

    @property
    def shapes(self):
        return (self.x.shape, self.mu.shape)


def preprocess_read(
    signal: np.ndarray,
    basecall: str,
    move_index: np.ndarray,
    index: SeedIndex,
    genome: Genome,
    read_id: str = "?",
    model: Optional[KmerModel] = None,
) -> Optional[ReadRecord]:
    """Anchor one normalized read; None if anchoring fails.

    When a pore model is given, the read is re-calibrated against it: a
    trimmed linear fit of the signal onto the expected levels along the
    anchor path refines the raw median/MAD normalization, whose shift is
    biased by the window's level composition.
    """
    a = anchor_basecall(index, basecall)
    if a is None:
        return None
    window = genome.window(a.contig, a.ref_start, a.ref_end, a.strand)
    path = signal_anchor_path(a, move_index, len(signal))
    signal = np.asarray(signal, np.float32)
    mu = sigma = None
    if model is not None:
        mu, sigma = model.expected_signal(window)
        if len(mu) > 1:
            ap = np.clip(np.round(path).astype(np.int64), 0, len(mu) - 1)
            pred = mu[ap].astype(np.float64)
            x = signal.astype(np.float64)
            keep = np.ones(len(x), bool)
            for _ in range(2):  # fit, trim outliers, refit
                vp = pred[keep].var()
                if vp < 1e-6 or keep.sum() < 16:
                    break
                aa = np.cov(pred[keep], x[keep])[0, 1] / vp
                bb = x[keep].mean() - aa * pred[keep].mean()
                resid = x - (aa * pred + bb)
                rs = resid[keep].std()
                # accept only a sane, well-correlated fit — a decorrelated
                # anchor (bad basecall / misanchor) would otherwise drive the
                # slope toward 0 and exploding 1/a scale corrections
                r2 = 1.0 - (resid[keep] ** 2).mean() / max(x[keep].var(), 1e-9)
                if 0.5 < aa < 2.0 and r2 > 0.5:
                    signal = ((x - bb) / aa).astype(np.float32)
                keep = np.abs(resid) < 3.0 * rs
    return ReadRecord(
        read_id=read_id,
        signal=signal,
        anchor=a,
        anchor_path=path,
        window_codes=window,
        mu=mu,
        sigma=sigma,
    )


def make_preprocessor(
    genome: Genome,
    cfg: AlignConfig,
    model: Optional[KmerModel] = None,
    mode: str = "auto",
):
    """Callable(raw_read) -> Optional[ReadRecord], native C++ or Python.

    mode: "auto" (native when g++ builds it, else Python), "native" (raises
    if it cannot be built), "python". The native engine (``csrc/prep.cpp``)
    releases the GIL while it runs, so prep threads overlap.
    """
    from .io import fast5 as fast5mod

    if mode not in ("auto", "native", "python"):
        raise ValueError(f"unknown prep mode {mode!r}")
    if mode != "python":
        from . import prep_native

        try:
            native = prep_native.NativePrep(genome)
        except (OSError, RuntimeError):
            if mode == "native":
                raise
        else:
            def work_native(raw):
                if raw.basecall is None or raw.move_index is None:
                    return None
                return native.prep_read(
                    raw.signal_pa, raw.basecall, raw.move_index, cfg,
                    model=model, read_id=raw.read_id)

            return work_native

    index = SeedIndex(genome)

    def work_python(raw):
        if raw.basecall is None or raw.move_index is None:
            return None
        sig = fast5mod.normalize_signal(raw.signal_pa, cfg.normalization)
        return preprocess_read(sig, raw.basecall, raw.move_index, index,
                               genome, raw.read_id, model=model)

    return work_python


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _bucket(v: int, edges) -> int:
    for e in edges:
        if v <= e:
            return e
    return _round_up(v, edges[-1] if edges else 1024)


def assemble_batch(
    records: Sequence[ReadRecord],
    model: KmerModel,
    cfg: AlignConfig,
    pad_reads_to: Optional[int] = None,
    pad_signal_to: Optional[int] = None,
    pad_window_to: Optional[int] = None,
) -> Batch:
    """Pad preprocessed reads into one device batch.

    Shapes are canonicalized exactly as the JAX package does — R rounds up to
    max(cfg.read_tile, 8), T to the signal bucket edges, L to a 256 multiple —
    so both packages build the same batch from the same records. An empty
    ``records`` yields an all-padding batch (n_reads=0).
    """
    n = len(records)
    tile = max(cfg.read_tile, 8)
    R = pad_reads_to or _round_up(max(n, 1), tile)
    assert R % tile == 0 and R >= n, (R, tile, n)
    T_raw = max([len(r.signal) for r in records] + [pad_signal_to or 1])
    T = _round_up(_bucket(T_raw, cfg.bucket_edges), cfg.signal_chunk)
    L_raw = max([len(r.window_codes) for r in records]
                + [pad_window_to or (model.k + 1)])
    L = _round_up(L_raw, 256)
    N = L - model.k + 1

    # the uploaded arrays are page-locked where CUDA is present
    x = host_full((R, T), 0, np.float32)
    t_len = host_full(R, 0, np.int32)
    mu = host_full((R, N), 0, np.float32)
    sigma = host_full((R, N), 1, np.float32)
    n_ref = host_full(R, 0, np.int32)
    anchors = np.zeros((R, T), np.float64)
    codes = host_full((R, L), 4, np.int32)
    ids = host_full((R, N), -1, np.int32)
    wstart = host_full(R, 0, np.int32)
    wlen = host_full(R, 0, np.int32)
    strand = host_full(R, 1, np.int32)
    read_ids = []
    contigs = []

    for r, rec in enumerate(records):
        t = len(rec.signal)
        x[r, :t] = rec.signal
        t_len[r] = t
        if rec.mu is not None:
            m, s = rec.mu, rec.sigma
        else:
            m, s = model.expected_signal(rec.window_codes)
        mu[r, : len(m)] = m
        sigma[r, : len(m)] = s
        n_ref[r] = len(m)
        anchors[r, :t] = rec.anchor_path
        anchors[r, t:] = rec.anchor_path[-1] if t else 0
        lw = len(rec.window_codes)
        codes[r, :lw] = rec.window_codes
        ids[r, : len(m)] = kmer_ids(rec.window_codes, model.k)
        wstart[r] = rec.anchor.ref_start
        wlen[r] = lw
        strand[r] = rec.anchor.strand
        read_ids.append(rec.read_id)
        contigs.append(rec.anchor.contig)
    # padded rows: minimally alive so the DP is well-defined
    t_len[n:] = 1
    n_ref[n:] = 1

    contigs += [contigs[0] if contigs else ""] * (R - n)
    bands = build_chunked_bands(anchors, t_len, n_ref, cfg.band_width, cfg.signal_chunk)
    return Batch(
        x=x, t_len=t_len, mu=mu, sigma=sigma, n_ref=n_ref, bands=bands,
        codes=codes, ids=ids, window_start=wstart, window_len=wlen,
        strand=strand, read_ids=read_ids, contigs=contigs, n_reads=n,
    )


def batch_rows(batch: Batch, start: int, stop: int) -> Batch:
    """Rows ``[start, stop)`` of an assembled batch, as a batch of its own.
    The true reads are the batch's first ``n_reads`` rows, so the padding
    rows of the slice stay padding (a slice past them is all padding)."""
    rows = slice(start, stop)
    n = max(0, min(stop, batch.n_reads) - start)
    b = batch.bands
    return dataclasses.replace(
        batch, x=batch.x[rows], t_len=batch.t_len[rows], mu=batch.mu[rows],
        sigma=batch.sigma[rows], n_ref=batch.n_ref[rows],
        bands=dataclasses.replace(b, lo=b.lo[rows], delta=b.delta[rows]),
        codes=batch.codes[rows], ids=batch.ids[rows],
        window_start=batch.window_start[rows], window_len=batch.window_len[rows],
        strand=batch.strand[rows], read_ids=batch.read_ids[start:start + n],
        contigs=batch.contigs[rows], n_reads=n)


def path_to_segments(path: np.ndarray, t_len: int, n_ref: int):
    """Per-reference-position signal sample ranges from a Viterbi path.

    The path (window k-mer position per signal sample) is monotone
    nondecreasing, so each position's [start, end) range falls out of two
    bisections. Unvisited positions get (-1, -1).
    """
    p = np.asarray(path[:t_len])
    pos = np.arange(n_ref)
    s = np.searchsorted(p, pos, side="left")
    e = np.searchsorted(p, pos, side="right")
    visited = e > s
    return np.where(visited, s, -1), np.where(visited, e, -1)


def check_supported(cfg: AlignConfig, backend: str = "auto", device=None) -> None:
    """Raise for a configuration the device path cannot run: before any
    kernel launches, so that nothing fails half way through a batch. On a
    CUDA device the kernel backend takes band widths up to
    ``cuda_dp.MAX_BAND`` and, with the local rescore, k up to
    ``cuda_rescore.MAX_K``."""
    if cfg.snp_rescore not in ("local", "fixed"):
        raise ValueError(f"unknown snp_rescore {cfg.snp_rescore!r}")
    if (device is not None and torch.device(device).type == "cuda"
            and resolve_backend(cfg, backend) == "cuda"):
        if cfg.band_width > cuda_dp.MAX_BAND:
            raise ValueError(f"band_width {cfg.band_width} exceeds {cuda_dp.MAX_BAND} "
                             f"slots, the most the CUDA kernels take")
        if cfg.snp_rescore == "local" and cfg.k > cuda_rescore.MAX_K:
            raise ValueError(f"k={cfg.k} exceeds {cuda_rescore.MAX_K}, the longest "
                             f"k-mer the CUDA rescore kernels are built for")


def device_compute(
    x, t_len, mu, sigma, n_ref, lo, delta, codes, ids, lm, ls,
    woff, subst,
    cfg: AlignConfig, backend: str, k: int, rescore: bool = True, woff_range=None,
):
    """The per-device compute body: banded Viterbi, then the rescore.

    lo/delta are always chunked (R, n_chunks); the scan backend expands them
    here. ``woff`` (R,) i32 and ``subst`` (the genome's ``SubstTables``) are
    None off the tables path; ``woff_range`` the smallest and largest offset,
    from the host. Under backend ``"cuda"`` with the local rescore
    the walk also emits the path's segment counts, which the rescore takes
    (span ``nadavca.rescore``). Returns (score (R,), path (R, T) i32, base_ll (R, L, 4), or None when
    ``rescore`` is False).
    """
    check_supported(cfg, backend, x.device)
    local = rescore and cfg.snp_rescore == "local"
    if backend == "cuda":
        res, _ = cuda_dp.cuda_viterbi_batch(
            x, t_len, mu, sigma, n_ref, lo, delta, cfg,
            count_lanes=cuda_rescore.count_lanes(ids.shape[1]) if local else None)
    elif backend == "scan":
        T = x.shape[1]
        lo_full = torch.repeat_interleave(lo, cfg.signal_chunk, dim=1)[:, :T]
        res = banded_dp.banded_viterbi_batch(
            x, t_len, mu, sigma, n_ref, lo_full, cfg)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if not rescore:
        return res.score, res.path, None
    with span("nadavca.rescore"):
        if not local:
            stats = banded_dp.segment_stats_batch(res.path, x, t_len, mu.shape[1])
            base_ll = banded_dp.base_loglik_batch(codes, ids, stats, lm, ls, k)
        elif backend == "cuda":
            base_ll = cuda_rescore.base_loglik_local_cuda(
                x, res.path, t_len, codes, ids, lm, ls, k, cfg,
                t_w=cfg.snp_local_window, tables=subst, window_off=woff,
                cnt=res.counts, window_off_range=woff_range)
        else:
            base_ll = banded_dp.base_loglik_local_batch(
                x, res.path, t_len, codes, ids, lm, ls, k, cfg,
                t_w=cfg.snp_local_window)
    return res.score, res.path, base_ll


def resolve_backend(cfg: AlignConfig, backend: str = "auto") -> str:
    """"auto" means "cuda": the kernel semantics, with the kernels' plain
    versions on CPU tensors. "scan" is the per-step reference loop."""
    if backend == "auto":
        backend = "cuda"
    if backend not in ("cuda", "scan"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def stage_batch(batch: Batch, model: KmerModel, cfg: AlignConfig,
                backend: str, device="cuda", subst=None,
                upload: Optional[Upload] = None) -> dict:
    """Put everything ``device_compute`` consumes on ``device``.

    Band levels are sliced on the device (by the fills' producer warps), so
    no (n_chunks, R, B) band array crosses the host-device link. ``subst``
    (``ops.subst_tables.SubstTables`` of the genome, already on ``device``) is
    used by the kernel backend's local rescore only; the per-read table
    offsets are computed here (span ``nadavca.upload.offsets``) and checked
    against the table's tail pad. The copies are those of ``utils.upload``:
    asynchronous on a CUDA device, the caller's stream made to wait for them
    on return; on the tables path the model's level vectors are the ones
    the tables put on the device, and no batch uploads them. ``upload``, the
    :class:`~.utils.upload.Upload` this staging joins
    (``parallel.sharded.shard_batch``'s), else one of its own.
    """
    if upload is None:
        with Upload(device) as up:
            return stage_batch(batch, model, cfg, backend, device, subst, up)
    backend = resolve_backend(cfg, backend)
    put = upload.put
    # the signal first: on a CUDA device its copy, the largest, runs while
    # the host computes the table offsets and issues the other copies
    staged = dict(x=put(batch.x), t_len=put(batch.t_len), mu=put(batch.mu),
                  sigma=put(batch.sigma), n_ref=put(batch.n_ref),
                  lo=put(batch.bands.lo), delta=put(batch.bands.delta))
    woff = woff_range = lm = ls = None
    if subst is not None and backend == "cuda" and cfg.snp_rescore == "local":
        with span("nadavca.upload.offsets"):
            off = subst.window_offsets(
                batch.contigs, batch.window_start, batch.window_len, batch.strand,
                padded_len=batch.codes.shape[1])
            woff_range = (int(off.min()), int(off.max())) if len(off) else None
        woff = put(off)
        lm, ls = subst.level_mean, subst.level_std
    else:
        subst = None
    staged.update(codes=put(batch.codes), ids=put(batch.ids))
    if lm is None:
        lm = put(model.level_mean.astype(np.float32))
        ls = put(model.level_std.astype(np.float32))
    staged.update(
        lm=lm, ls=ls, woff=woff, woff_range=woff_range, subst=subst,
        backend=backend, k=model.k,
    )
    return staged


def align_batch(
    batch: Batch,
    model: KmerModel,
    cfg: AlignConfig,
    backend: str = "auto",
    device="cuda",
    subst=None,
    staged: Optional[dict] = None,
    rescore: bool = True,
):
    """Run the device part on one batch: DP + base log-likelihoods.

    backend: "auto" or "cuda" (the kernels), "scan". ``subst``: the genome's
    substitution tables for the local rescore. Pass ``staged`` (from
    :func:`stage_batch`) to skip the in-line upload. Returns a dict of tensors
    on the device: score (R,), path (R, T), base_loglik (R, L, 4), or None
    without ``rescore``.
    """
    a = staged if staged is not None else stage_batch(
        batch, model, cfg, backend, device=device, subst=subst)
    score, path, base_ll = device_compute(
        a["x"], a["t_len"], a["mu"], a["sigma"], a["n_ref"], a["lo"],
        a["delta"], a["codes"], a["ids"], a["lm"],
        a["ls"], a["woff"], a["subst"], cfg=cfg, backend=a["backend"], k=a["k"],
        rescore=rescore, woff_range=a.get("woff_range"),
    )
    return {
        "score": score,
        "path": path,
        "base_loglik": base_ll,
    }
