"""Public Python API: ``align_signal`` and ``call_snps``.

Counterpart of ``nadavca_tpu/api.py`` with the same signatures plus
``device`` (default ``"cuda"``; pass ``"cpu"`` to run the plain versions).
Ingest and anchoring run on the host, reads are padded into bucketed batches,
and each batch runs the banded Viterbi and the rescore on the device. With
``cfg.snp_joint_rescore`` the calls of ``call_snps`` are refined by the joint
pass (``joint.py``) on the same device.

Each entry point is split into ingest (:func:`_iter_raw`) and a body that
takes any iterable of :class:`RawRead` (``align_reads``, ``call_snps_reads``),
so reads made in memory — for example by the simulator — need no fast5 file
and no ``h5py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import call as callmod
from . import joint
from .config import AlignConfig, DEFAULT_CONFIG
from .genome import Genome
from .io import fast5 as fast5mod
from .io.fast5 import RawRead
from .kmer_model import KmerModel, default_model
from .ops.subst_tables import build_subst_tables
from .pipeline import (Batch, ReadRecord, align_batch, assemble_batch,
                       check_supported, make_preprocessor, path_to_segments,
                       resolve_backend)


@dataclasses.dataclass
class ReadAlignment:
    """Refined signal↔reference alignment of one read.

    ``seg_start``/``seg_end`` give, for each reference position in
    ``[ref_start, ref_end)``, the half-open range of signal sample indices
    aligned to it (-1/-1 if the Viterbi path never visits the position).
    ``base_loglik`` (optional) is the (window_len, 4) per-position
    base-substitution log-likelihood table the SNP caller consumes.
    """

    read_id: str
    contig: str
    strand: int               # +1 forward, -1 reverse
    ref_start: int            # genome coordinates of the aligned window
    ref_end: int
    seg_start: np.ndarray     # (window_len,) int
    seg_end: np.ndarray       # (window_len,) int
    score: float              # alignment log-likelihood
    base_loglik: Optional[np.ndarray] = None  # (window_len, 4) float32

    def __len__(self) -> int:
        return self.ref_end - self.ref_start


PathsLike = Union[str, Sequence[str]]


def raw_read_from_simulated(rd) -> RawRead:
    """A :class:`RawRead` from an ``io.simulator.SimulatedRead``, in memory.

    The unit-scale signal is embedded in a picoamp-like scale by the affine
    map ``write_fast5`` uses; normalization undoes it.
    """
    return RawRead(
        read_id=rd.read_id,
        signal_pa=(80.0 + 12.0 * np.asarray(rd.signal)).astype(np.float32),
        basecall=rd.basecall,
        move_index=np.asarray(rd.move_index, np.int64),
    )


def _iter_raw(fast5: PathsLike) -> Iterator[RawRead]:
    """Yield raw reads from a fast5 file, a directory, or a list of either."""
    paths = [fast5] if isinstance(fast5, (str, os.PathLike)) else list(fast5)
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            yield from fast5mod.iter_fast5_dir(p)
        else:
            yield from fast5mod.read_fast5(p)


def _as_genome(reference: Union[str, Genome]) -> Genome:
    if isinstance(reference, Genome):
        return reference
    return Genome.from_fasta(os.fspath(reference))


def _preprocess(
    raws: Iterable[RawRead],
    genome: Genome,
    model: KmerModel,
    cfg: AlignConfig,
    workers: int = 1,
    prep: str = "auto",
) -> List[ReadRecord]:
    """Host prep of every read on ``workers`` threads, by the engine
    ``pipeline.make_preprocessor`` picks for ``prep``: "auto" is the native
    C++ engine where g++ builds it (else Python), "native" raises where it
    cannot be built, "python" is the Python path."""
    work = make_preprocessor(genome, cfg, model=model, mode=prep)
    raws = list(raws)
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as pool:
            results = list(pool.map(work, raws))
    else:
        results = [work(r) for r in raws]
    return [r for r in results if r is not None]


def _batches(
    records: Sequence[ReadRecord], batch_reads: int
) -> Iterator[List[ReadRecord]]:
    records = sorted(records, key=lambda r: len(r.signal))
    for i in range(0, len(records), batch_reads):
        yield list(records[i : i + batch_reads])


def _run_batches(
    records: Sequence[ReadRecord],
    model: KmerModel,
    cfg: AlignConfig,
    backend: str,
    batch_reads: int,
    device,
    subst=None,
    rescore: bool = True,
) -> Iterator[Tuple[List[ReadRecord], Batch, dict]]:
    for group in _batches(records, batch_reads):
        batch = assemble_batch(group, model, cfg)
        out = align_batch(batch, model, cfg, backend=backend, device=device,
                          subst=subst, rescore=rescore)
        yield group, batch, out


def _maybe_subst(genome: Genome, model: KmerModel, cfg: AlignConfig,
                 backend: str, device):
    """The genome's substitution tables, built once per call, when the kernel
    backend will run the local rescore; None otherwise."""
    if resolve_backend(cfg, backend) != "cuda" or cfg.snp_rescore != "local":
        return None
    return build_subst_tables(genome, model, device=device)


def align_reads(
    genome: Genome,
    raws: Iterable[RawRead],
    config: Optional[AlignConfig] = None,
    model: Optional[KmerModel] = None,
    backend: str = "auto",
    batch_reads: int = 256,
    compute_probabilities: bool = True,
    workers: int = 1,
    prep: str = "auto",
    device="cuda",
) -> List[ReadAlignment]:
    """Body of :func:`align_signal` over reads already in memory."""
    cfg = config or DEFAULT_CONFIG
    check_supported(cfg, backend, device)
    model = model or default_model(cfg.k)
    records = _preprocess(raws, genome, model, cfg, workers, prep=prep)
    subst = _maybe_subst(genome, model, cfg, backend, device) \
        if compute_probabilities else None
    order = {r.read_id: i for i, r in enumerate(records)}
    results: List[Optional[ReadAlignment]] = [None] * len(records)
    for group, batch, out in _run_batches(records, model, cfg, backend,
                                          batch_reads, device, subst,
                                          rescore=compute_probabilities):
        paths = out["path"].cpu().numpy()
        scores = out["score"].cpu().numpy()
        bll = out["base_loglik"].cpu().numpy() if compute_probabilities else None
        for r in range(batch.n_reads):
            rec = group[r]
            seg_start, seg_end = path_to_segments(
                paths[r], int(batch.t_len[r]), int(batch.n_ref[r])
            )
            wlen = int(batch.window_len[r])
            results[order[rec.read_id]] = ReadAlignment(
                read_id=rec.read_id,
                contig=rec.anchor.contig,
                strand=rec.anchor.strand,
                ref_start=rec.anchor.ref_start,
                ref_end=rec.anchor.ref_end,
                seg_start=seg_start,
                seg_end=seg_end,
                score=float(scores[r]),
                base_loglik=bll[r, :wlen] if bll is not None else None,
            )
    return [a for a in results if a is not None]


def align_signal(
    reference: Union[str, Genome],
    fast5: PathsLike,
    config: Optional[AlignConfig] = None,
    model: Optional[KmerModel] = None,
    backend: str = "auto",
    batch_reads: int = 256,
    compute_probabilities: bool = True,
    workers: int = 1,
    prep: str = "auto",
    device="cuda",
) -> List[ReadAlignment]:
    """Align raw signal of every read in ``fast5`` to ``reference``.

    ``reference`` is a FASTA path (or an already-loaded :class:`Genome`),
    ``fast5`` a file, directory, or list of either, ``config`` an
    :class:`AlignConfig` (defaults otherwise). Returns one
    :class:`ReadAlignment` per successfully anchored read, in input order;
    unanchorable or basecall-less reads are silently dropped. ``prep``
    ("auto", "native" or "python") picks the host prep engine and
    ``workers`` its threads (see :func:`_preprocess`).
    """
    return align_reads(
        _as_genome(reference), _iter_raw(fast5), config=config, model=model,
        backend=backend, batch_reads=batch_reads,
        compute_probabilities=compute_probabilities, workers=workers,
        prep=prep, device=device)


def _accumulate_reads(genome, raws, cfg, model, backend, batch_reads, workers,
                      prep, dev):
    """Align every read and scatter its base log-likelihoods into per-contig
    locus accumulators on ``dev``. Returns (records, {contig: (acc, cov,
    votes)})."""
    records = _preprocess(raws, genome, model, cfg, workers, prep=prep)
    subst = _maybe_subst(genome, model, cfg, backend, dev)
    accs = {c.name: callmod.make_accumulators(len(c), with_votes=True, device=dev)
            for c in genome}
    for group, batch, out in _run_batches(records, model, cfg, backend,
                                          batch_reads, dev, subst):
        by_contig: dict = {}
        for r in range(batch.n_reads):
            by_contig.setdefault(group[r].anchor.contig, []).append(r)
        for cname, rows in by_contig.items():
            rows_arr = np.asarray(rows, np.int64)
            rows_t = torch.from_numpy(rows_arr).to(dev)
            acc, cov, votes = accs[cname]
            accs[cname] = callmod.accumulate_batch(
                acc, cov,
                out["base_loglik"][rows_t],
                torch.from_numpy(batch.window_start[rows_arr]).to(dev),
                torch.from_numpy(batch.window_len[rows_arr]).to(dev),
                torch.from_numpy(batch.strand[rows_arr]).to(dev),
                votes=votes, cfg=cfg,
            )
    return records, accs


def call_snps_reads(
    genome: Genome,
    raws: Iterable[RawRead],
    config: Optional[AlignConfig] = None,
    model: Optional[KmerModel] = None,
    backend: str = "auto",
    batch_reads: int = 256,
    min_coverage: int = 2,
    workers: int = 1,
    prep: str = "auto",
    device="cuda",
) -> List[callmod.SnpCall]:
    """Body of :func:`call_snps` over reads already in memory."""
    cfg = config or DEFAULT_CONFIG
    check_supported(cfg, backend, device)
    model = model or default_model(cfg.k)
    dev = torch.device(device)
    records, accs = _accumulate_reads(genome, raws, cfg, model, backend,
                                      batch_reads, workers, prep, dev)
    calls: List[callmod.SnpCall] = []
    if cfg.snp_joint_rescore:
        # the records are still in memory, so the joint pass re-scores the
        # candidate clusters directly, on the same device
        records_by_id = {r.read_id: r for r in records}
        metas_by_contig: dict = {}
        for r in records:
            metas_by_contig.setdefault(r.anchor.contig, []).append(
                joint.ReadMeta(r.read_id, r.anchor.contig,
                               int(r.anchor.ref_start),
                               len(r.window_codes), int(r.anchor.strand)))
        for cname, (acc, cov, votes) in accs.items():
            calls.extend(joint.refine_contig_calls(
                acc.cpu().numpy(), cov.cpu().numpy(), votes.cpu().numpy(),
                genome[cname].codes, cname, cfg, model,
                metas_by_contig.get(cname, []), records_by_id,
                min_coverage=min_coverage, device=dev))
        return calls
    for cname, (acc, cov, votes) in accs.items():
        calls.extend(
            callmod.call_snps(
                acc.cpu().numpy(), cov.cpu().numpy(), genome[cname].codes,
                cname, cfg, min_coverage=min_coverage,
                votes=votes.cpu().numpy(),
            )
        )
    return calls


def call_snps(
    reference: Union[str, Genome],
    fast5: PathsLike,
    config: Optional[AlignConfig] = None,
    model: Optional[KmerModel] = None,
    backend: str = "auto",
    batch_reads: int = 256,
    min_coverage: int = 2,
    workers: int = 1,
    prep: str = "auto",
    device="cuda",
) -> List[callmod.SnpCall]:
    """Signal-level SNP calls over all reads in ``fast5`` vs ``reference``.

    Per-read base log-likelihoods from the banded DP are scatter-added into
    per-contig locus accumulators, converted to posteriors, and thresholded
    into :class:`~nadavca_tpu_torch.call.SnpCall` records. ``prep`` and
    ``workers`` as in :func:`align_signal`.
    """
    return call_snps_reads(
        _as_genome(reference), _iter_raw(fast5), config=config, model=model,
        backend=backend, batch_reads=batch_reads, min_coverage=min_coverage,
        workers=workers, prep=prep, device=device)
