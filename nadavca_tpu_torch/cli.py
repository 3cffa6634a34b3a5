"""Command-line interface: ``align``, ``snp`` and ``simulate``.

Counterpart of ``nadavca_tpu/cli.py``, with the same subcommands, arguments
and outputs. Reads stream from disk through a pool of prep threads
(``--workers``; the native prep releases the GIL) into length-bucketed
batches; a background thread assembles and uploads the next batch while the
devices run the current one, and results are drained one batch late.
Long-read buckets take the wide band (``_cfg_for_group``). ``snp`` sums every
batch into one genome accumulator on the devices, checkpoints it with the
read manifest (``--checkpoint``), and resumes by skipping the merged reads
before their signal is loaded.

Each command reports through the process's registry
(``utils.metrics.PROCESS``, reset at its start) one ``[metrics]`` line on
stderr; ``padding_waste`` is the padding share over every batch of the job.
``--profile DIR`` traces the whole command, every thread, with the spans
``nadavca.tables``, ``.prep``, ``.prep_wait``, ``.drain``, ``.checkpoint``
and ``.calls`` of this module around those of the step (``README.md``).

Several devices and processes (``parallel/``), as in the JAX package:

- ``--devices N`` splits each batch's rows over N devices of this process
  (``cuda:0 .. cuda:N-1``; ``all`` is every card; with ``--device cpu``, N
  shards on the CPU, and ``all`` is 1). More devices than the machine has
  raises before any read is loaded. ``snp`` keeps its accumulators
  replicated, genome-sharded (``--genome-sharded``) or as per-device
  partials merged only at checkpoints and at the end (``--merge``), with
  the JAX package's thresholds, and writes one checkpoint file in the JAX
  package's one-process layout.
- ``snp --coordinator HOST:PORT --num-processes N --process-id I`` joins a
  ``torch.distributed`` group (``parallel/distributed.py``: NCCL when every
  mesh position has a card of its own, gloo otherwise). Each process drives
  ``--devices`` local devices (position ``r·n + i`` of the group's mesh on
  ``cuda:((r·n + i) mod cards)``; more than the cards present raises, as in
  one process), every process as many. Each process streams its own shard
  of the inputs, the processes agree on every batch's shape, process 0
  writes the checkpoint's accumulators and the VCF; the checkpoint does not
  depend on how many devices a process drives. Without ``--coordinator`` the
  run is one process, as in the JAX package. ``align --num-processes N
  --process-id I`` shards the inputs over processes that each run their
  ``--devices`` and needs no process group.

Differences from the JAX package's CLI:

- ``--backend`` takes ``auto|cuda|scan`` and ``--device cuda|cpu`` (default
  ``cuda``) names the device; on the CPU every kernel runs its plain version.
- ``main(argv, reads=...)`` takes the reads from a sequence of ``RawRead``
  in memory instead of the ``fast5_dir`` argument, which is then only a
  label: for machines without ``h5py``. Under ``--num-processes N`` such
  reads are sharded by their index in the sequence (``i % N == I``), where
  files are sharded by their sorted index.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import queue
import sys
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import api
from . import call as callmod
from . import joint
from .config import AlignConfig, DEFAULT_CONFIG
from .genome import Genome
from .io import fast5 as fast5mod
from .io.fast5 import RawRead
from .kmer_model import KmerModel, default_model
from .pipeline import (_bucket, _round_up, assemble_batch, check_supported,
                       make_preprocessor, path_to_segments)
from .parallel import distributed as dist
from .parallel import sharded
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.metrics import PROCESS as METRICS, Metrics
from .utils.profiling import span

# the environment variable of the crash points of the checkpoint protocol
CRASH_POINT_ENV = "NADAVCA_TPU_CRASH_POINT"


def _load_cfg(args) -> AlignConfig:
    if getattr(args, "configuration", None):
        return AlignConfig.from_yaml(args.configuration)
    return DEFAULT_CONFIG


def _load_model(args, cfg) -> KmerModel:
    if getattr(args, "model", None):
        return KmerModel.load_tsv(args.model)
    return default_model(cfg.k)


def _device(args) -> torch.device:
    """The run's first device, with an explicit index: batches are staged on
    a worker thread, which must not depend on a current device."""
    dev = torch.device(args.device)
    return torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev


def _check_supported(args, cfg: AlignConfig, dev: torch.device) -> None:
    """Refuse what this CLI cannot run before any read is loaded:
    ``--device cuda`` without a card (nothing falls back to the CPU), and a
    configuration the device cannot take, also under the wide band of long
    reads."""
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "--device cpu runs the plain versions")
    check_supported(cfg, args.backend, dev)
    check_supported(dataclasses.replace(
        cfg, band_width=max(cfg.band_width, cfg.band_width_long)), args.backend, dev)


def _n_devices(args, dev: torch.device) -> int:
    """``--devices``: an int, or ``all`` (every card; 1 on the CPU)."""
    d = str(args.devices)
    if d != "all":
        return int(d)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _parse_devices(args, dev: torch.device) -> sharded.Mesh:
    """The mesh of one process: ``cuda:0 .. cuda:N-1`` or N CPU shards. More
    devices than there are raises: nothing runs on fewer."""
    try:
        return sharded.make_mesh(_n_devices(args, dev), dev)
    except ValueError as e:
        raise SystemExit(f"--devices {args.devices}: {e}") from None


def _init_distributed(args, dev: torch.device):
    """Join the process group if ``--coordinator`` was given.

    Returns (multihost, process_id, num_processes, the mesh). Without a
    coordinator the run is one process, whatever ``--num-processes`` says
    (as in the JAX package). ``--devices`` is checked against the cards
    before the group is joined, as in one process."""
    mesh = _parse_devices(args, dev)
    if not args.coordinator:
        return False, 0, 1, mesh
    devs = dist.initialize_distributed(args.coordinator, args.num_processes,
                                       args.process_id, device=dev.type,
                                       n_local=len(mesh.devices))
    if dist.process_count() == 1:
        return False, 0, 1, mesh
    return True, dist.process_index(), dist.process_count(), sharded.process_mesh(devs)


def _stream_groups(records, batch_reads, cfg):
    """Group a STREAM of records into length-bucketed batches on the fly.

    Each record lands in the bin of its padded signal length (the bucket
    edges ``assemble_batch`` pads to) and of its band (above
    ``adaptive_band_threshold`` samples the wide one); a full bin becomes a
    batch at once, and the end of the stream flushes the partial bins.
    """
    bins = {}
    for rec in records:
        t = len(rec.signal)
        key = (_bucket(t, cfg.bucket_edges),
               t > cfg.adaptive_band_threshold)
        bins.setdefault(key, []).append(rec)
        if len(bins[key]) >= batch_reads:
            yield bins.pop(key)
    for key in sorted(bins):
        yield bins[key]


def _prefetched(groups, prepare, depth=2):
    """Run ``prepare`` over ``groups`` on a background thread, at most
    ``depth`` results ahead of the consumer, so ingest, assembly and upload
    overlap the device work of earlier batches. An exception on the thread
    is raised here, in the consumer."""
    q = queue.Queue(maxsize=depth)
    sentinel = object()
    failed = []

    def worker():
        try:
            for g in groups:
                q.put(prepare(g))
        except BaseException as e:  # re-raised by the consumer below
            failed.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        with span("nadavca.prep_wait"):
            item = q.get()
        if item is sentinel:
            if failed:
                raise failed[0]
            return
        yield item


def _cfg_for_group(cfg, group):
    """Adaptive band: long-read buckets get ``band_width_long``.

    Longer reads accumulate more anchor drift, so their buckets run with the
    wide band; short buckets keep the narrow band's throughput.
    """
    t_max = max(len(r.signal) for r in group)
    if t_max > cfg.adaptive_band_threshold and cfg.band_width < cfg.band_width_long:
        return dataclasses.replace(cfg, band_width=cfg.band_width_long)
    return cfg


def _filtered(raws, skip_ids=None, skipped=None, include_ids=None):
    for raw in raws:
        if include_ids is not None and raw.read_id not in include_ids:
            continue
        if skip_ids and raw.read_id in skip_ids:
            if skipped is not None:
                skipped[0] += 1
            continue
        yield raw


def _iter_raw_reads(directory, shard=None, skip_ids=None, skipped=None,
                    include_ids=None, reads: Optional[Sequence[RawRead]] = None):
    """Stream raw reads; with shard=(pid, n) only every n-th FILE (round-
    robin by sorted index, ``distributed.shard_files_for_process``) is read. ``skip_ids`` (resume manifest) filters by
    read id BEFORE the signal is loaded from disk; ``skipped`` is a 1-element
    counter list; ``include_ids`` loads ONLY those ids (joint-rescore
    re-ingest). With ``reads`` the reads come from that sequence, filtered
    alike (``shard`` by the index in the sequence), and ``directory`` is not
    read."""
    if reads is not None:
        if shard is not None:
            pid, n = shard
            reads = (r for i, r in enumerate(reads) if i % n == pid)
        yield from _filtered(reads, skip_ids, skipped, include_ids)
        return
    paths = []
    for root, _dirs, files in sorted(os.walk(directory)):
        for fn in sorted(files):
            if fn.endswith(".fast5"):
                paths.append(os.path.join(root, fn))
    if shard is not None:
        paths = dist.shard_files_for_process(paths, *shard)
    for p in paths:
        yield from fast5mod.read_fast5(p, skip_ids=skip_ids, skipped=skipped,
                                       include_ids=include_ids)
    from .io import pod5 as pod5mod

    if pod5mod.HAVE_POD5:
        # pod5 inputs are sharded by the same round-robin rule
        yield from _filtered(pod5mod.iter_pod5_dir(directory, shard=shard),
                             skip_ids, skipped, include_ids)


def _stream_records(args, cfg, genome, metrics, model=None,
                    skip_ids=None, shard=None, include_ids=None):
    """Generator of prepped ReadRecords, produced with bounded lookahead.

    Ingest (lazy, resume-manifest-aware) and per-read prep, fanned over
    ``--workers`` threads, run as a producer: records are yielded as they
    finish while later reads are still being read, so the device loop
    downstream overlaps host ingest with device work.
    """
    from concurrent.futures import ThreadPoolExecutor

    skip_ids = skip_ids or set()
    workers = max(1, args.workers)
    work = make_preprocessor(genome, cfg, model=model, mode=args.prep)

    skipped = [0]
    raws = _iter_raw_reads(args.fast5_dir, shard=shard,
                           skip_ids=skip_ids, skipped=skipped,
                           include_ids=include_ids, reads=args.raw_reads)
    if args.basecalls:
        # sidecar basecall source (pod5 stores raw signal only): join
        # basecall + move table onto signal-only reads by read_id
        from .io.sidecar import join_basecalls, load_sidecar_basecalls

        raws = join_basecalls(raws, load_sidecar_basecalls(args.basecalls))
    n_in = n_ok = 0
    try:
        with ThreadPoolExecutor(workers) as pool:
            inflight = collections.deque()

            def drain_one():
                nonlocal n_in, n_ok
                rec = inflight.popleft().result()
                n_in += 1
                if rec is not None:
                    n_ok += 1
                return rec

            for raw in raws:
                inflight.append(pool.submit(work, raw))
                # lookahead bound: keeps every worker busy without
                # materializing the corpus when the consumer lags
                while len(inflight) >= workers * 8:
                    rec = drain_one()
                    if rec is not None:
                        yield rec
            while inflight:
                rec = drain_one()
                if rec is not None:
                    yield rec
    finally:
        metrics.count("reads_resumed_skip", skipped[0])
        metrics.count("reads_ingested", n_ok)
        metrics.count("reads_skipped", n_in - n_ok)


def _count_padding(metrics: Metrics, batch) -> None:
    """Count a batch's true reads' signal samples and the samples they take
    padded to the batch's length."""
    n = batch.n_reads
    metrics.count("signal_samples_true", int(batch.t_len[:n].sum()))
    metrics.count("signal_samples_padded", n * batch.x.shape[1])


def _padding_waste(metrics: Metrics) -> None:
    """Gauge ``padding_waste``: the share of the signal axis that is padding,
    over the true reads of every batch the job ran (none before a batch)."""
    c = metrics.counters
    if c.get("signal_samples_padded"):
        metrics.gauge("padding_waste",
                      1.0 - c["signal_samples_true"] / c["signal_samples_padded"])


def _final_calls(args, cfg, model, genome, contig_off, a_np, c_np, v_np,
                 metas_by_contig, min_coverage, dev, shard=None, multihost=False):
    """Accumulators → SNP calls, with the joint adjacent-hypothesis pass.

    When cfg.snp_joint_rescore is on, candidate clusters are re-scored by
    full re-alignment over every covering read (``joint.py``) on ``dev``:
    the reads that cover a cluster are ingested and prepped again by id. The
    cluster plan is a function of the merged accumulators, so every process
    derives the same one; each scores only its own shard's reads, and under
    a process group the per-read matrices are gathered with one all_gather
    per contig (every process takes part).
    """
    all_calls: List[callmod.SnpCall] = []
    if not cfg.snp_joint_rescore:
        for cname, coff in contig_off.items():
            l = len(genome[cname])
            all_calls.extend(callmod.call_snps(
                a_np[coff:coff + l], c_np[coff:coff + l],
                genome[cname].codes, cname, cfg,
                min_coverage=min_coverage, votes=v_np[coff:coff + l]))
        return all_calls

    plans = {}
    for cname, coff in contig_off.items():
        l = len(genome[cname])
        plans[cname] = joint.cluster_plan(
            a_np[coff:coff + l], c_np[coff:coff + l], v_np[coff:coff + l],
            genome[cname].codes, cfg, min_coverage=min_coverage)
    needed = set()
    for cname, plan in plans.items():
        needed |= joint.needed_read_ids(
            plan, (metas_by_contig or {}).get(cname, []), cfg.k)
    records_by_id = {}
    if needed:
        for rec in _stream_records(args, cfg, genome, Metrics(), model=model,
                                   shard=shard, include_ids=needed):
            records_by_id[rec.read_id] = rec
    for cname, coff in contig_off.items():
        plan = plans[cname]
        if not plan:
            continue
        l = len(genome[cname])
        mats = joint.partial_deltas(
            plan, (metas_by_contig or {}).get(cname, []), records_by_id,
            model, cfg, device=dev)
        if multihost:
            mats = _gather_rows(mats)
        all_calls.extend(joint.decide(
            plan, mats, c_np[coff:coff + l],
            genome[cname].codes, cname, cfg, acc=a_np[coff:coff + l]))
    return all_calls


def _gather_rows(mats):
    """Every process's per-read matrices of each cluster, concatenated in
    rank order: each cluster's local rows packed into one NaN-padded block
    (the same layout on every process, since the plan is the same), one
    all_gather, then the padding rows dropped."""
    n_h = [m.shape[1] for m in mats]
    all_n = dist.process_allgather(np.asarray([m.shape[0] for m in mats], np.int64))
    n_max = int(all_n.max()) if len(mats) else 0
    if n_max == 0:
        return mats
    blk = np.full((n_max, int(sum(n_h))), np.nan, np.float32)
    col = 0
    for m in mats:
        blk[: m.shape[0], col:col + m.shape[1]] = m
        col += m.shape[1]
    g = dist.process_allgather(blk)
    merged = []
    col = 0
    for ci in range(len(mats)):
        merged.append(np.concatenate(
            [g[p, : int(all_n[p, ci]), col:col + n_h[ci]] for p in range(len(g))],
            axis=0))
        col += n_h[ci]
    return merged


# The JAX package pads every batch of a bucket to one read count so that all
# of them reuse one compiled XLA executable. Nothing here is compiled per
# shape, so a batch is padded only to the read tile times the devices, so
# that its rows split into whole tiles; the true reads' results do not
# depend on the padding.
def _shard_rows(cfg, mesh, n_reads: int) -> int:
    return _round_up(max(n_reads, 1), max(cfg.read_tile, 8) * len(mesh.devices))


def _shard_of(args):
    """``(process_id, num_processes)`` of ``align --num-processes N``."""
    if not (args.num_processes and args.num_processes > 1):
        return None
    if args.process_id is None:
        raise SystemExit(
            "--num-processes > 1 requires --process-id: without it every "
            "process would silently run shard 0 (duplicate outputs, the "
            "other shards never aligned)")
    if not 0 <= args.process_id < args.num_processes:
        raise SystemExit(
            f"--process-id {args.process_id} out of range "
            f"[0, {args.num_processes})")
    return args.process_id, args.num_processes


def cmd_align(args) -> int:
    cfg = _load_cfg(args)
    dev = _device(args)
    _check_supported(args, cfg, dev)
    mesh = _parse_devices(args, dev)
    # align has no cross-read reduction, so multi-process align is pure input
    # sharding: each process handles its slice of the inputs with its own
    # devices and writes its own per-read outputs (no process group needed)
    shard = _shard_of(args)
    model = _load_model(args, cfg)
    genome = Genome.from_fasta(args.reference)
    metrics = METRICS
    metrics.reset()
    os.makedirs(args.output, exist_ok=True)
    t0 = time.time()  # end-to-end clock: ingest runs INSIDE the loop below
    records = _stream_records(args, cfg, genome, metrics, model=model,
                              shard=shard)
    n_done = 0
    align_steps = {}

    def _prep(group):
        with span("nadavca.prep"):
            gcfg = _cfg_for_group(cfg, group)
            batch = assemble_batch(group, model, gcfg,
                                   pad_reads_to=_shard_rows(gcfg, mesh, len(group)))
            return group, gcfg, batch, sharded.shard_batch(mesh, batch, model, gcfg,
                                                           args.backend)

    pending = collections.deque()

    def _drain_one():
        nonlocal n_done
        group, batch, out = pending.popleft()
        with span("nadavca.drain"):
            paths = out["path"].cpu().numpy()  # device fetch (true sync)
        for r in range(batch.n_reads):
            t = int(batch.t_len[r])
            n = int(batch.n_ref[r])
            seg_start, seg_end = path_to_segments(paths[r], t, n)
            rec = group[r]
            out_path = os.path.join(args.output, f"{rec.read_id}.txt")
            callmod.write_alignment(
                out_path, rec.read_id, rec.anchor.contig, rec.anchor.strand,
                rec.anchor.ref_start, rec.anchor.ref_end, seg_start, seg_end,
            )
            n_done += 1
        metrics.count("reads_aligned", batch.n_reads)

    # lagged drain: batch N's path fetch + file writes overlap the device
    # work of batch N+1 (already launched)
    for group, gcfg, batch, blocks in _prefetched(
            _stream_groups(records, args.batch_reads, cfg), _prep):
        _count_padding(metrics, batch)
        metrics.count(f"batches_band_{gcfg.band_width}")
        if gcfg not in align_steps:
            align_steps[gcfg] = sharded.make_sharded_align(mesh, gcfg)
        pending.append((group, batch, align_steps[gcfg](blocks)))
        while len(pending) > 1:
            _drain_one()
    while pending:
        _drain_one()
    dt = time.time() - t0
    # ingest→outputs wall including every host stage
    metrics.gauge("reads_per_s_e2e", n_done / dt if dt > 0 else 0.0)
    _padding_waste(metrics)
    metrics.report(sys.stderr)
    print(f"aligned {n_done} reads -> {args.output}", file=sys.stderr)
    return 0


def _crash_point(tag: str, pid: int, n: int) -> None:
    """Fault injection for the checkpoint protocol's crash tests: when the
    environment variable ``CRASH_POINT_ENV`` equals ``{tag}@{pid}:{n}`` the
    process dies at once (``os._exit(57)``, no cleanup: the closest
    controllable stand-in for a SIGKILL at a chosen point of the save)."""
    if os.environ.get(CRASH_POINT_ENV) == f"{tag}@{pid}:{n}":
        os._exit(57)


def _ckpt_shard_path(path: str, pid: int) -> str:
    """Process 0 owns the accumulator file; the others keep manifest shards."""
    return path if pid == 0 else f"{path}.p{pid}"


def _load_checkpoint_of_group(path: str, pid: int, nproc: int):
    """The checkpoint of a process group: process 0's file holds the merged
    accumulators and its manifest, process i > 0's ``<path>.p<i>`` its
    manifest. EVERY process validates EVERY shard (the filesystem is
    shared), so that all of them raise the same error on a mismatch instead
    of one exiting while the rest wait in the first collective. Returns
    (accumulators by contig, this process's manifest, its read metas)."""
    accs, m0, meta0, rm0 = load_checkpoint(path, with_meta=True)
    metas = {0: meta0}
    manifests = {0: (m0, rm0)}
    for q in range(1, nproc):
        _, mq, metaq, rmq = load_checkpoint(_ckpt_shard_path(path, q), with_meta=True)
        metas[q] = metaq
        manifests[q] = (mq, rmq)
    if accs or any(m for m, _ in manifests.values()):
        for q, metaq in metas.items():
            if metaq.get("num_processes") != nproc:
                raise SystemExit(
                    f"checkpoint shard {q} was written by num_processes="
                    f"{metaq.get('num_processes')} but this run has {nproc}; "
                    "input sharding would mismatch — restart without resume")
        counts = {q: m.get("n_batches") for q, m in metas.items()}
        if len(set(counts.values())) > 1:
            raise SystemExit(
                f"checkpoint shard files disagree on the batch counter "
                f"({counts}): the job died mid-save — restart without resume")
    return (accs,) + manifests[pid]


def _device_gauges(metrics: Metrics, mesh: sharded.Mesh) -> None:
    cards = [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]
    if cards:
        metrics.gauge("peak_device_mb", max(
            torch.cuda.max_memory_allocated(d) for d in cards) / 2**20)


def _run_snp_multihost(args, cfg, model, tables, mesh, records, contig_off, Gp,
                       genome_sharded, merge_deferred, state, metrics, done_ids,
                       metas_by_contig=None, save_ckpt=None):
    """The batch loop of a process group: every process STREAMS its own
    shard of the reads (``records`` is the lazy producer), and the batches
    run on the main thread, where every collective runs, in the same order
    on every process.

    Each record lands in a bin keyed by ``(signal bucket edge, window pad
    edge, long-band flag)``; each round the processes gather their smallest
    ready key (int32) and all run the smallest. A process without records for
    the agreed key runs an all-padding batch (n_reads = 0 rows accumulate
    nothing), so every process joins every collective while streaming on
    its own. The long flag keys the adaptive band per bucket, as in one
    process. Returns (reads run here, the accumulators)."""
    b = args.batch_reads
    # int32 on purpose (the JAX package's key encoding); INF means done
    INF = np.iinfo(np.int32).max

    def key_of(rec):
        t = len(rec.signal)
        return (_bucket(t, cfg.bucket_edges),
                _round_up(max(len(rec.window_codes), model.k + 1), 256),
                int(t > cfg.adaptive_band_threshold))

    it = iter(records)
    bins = {}
    exhausted = False

    def local_candidate():
        """Smallest key with a full bin, streaming until one fills; at
        stream end, the smallest non-empty bin; None when fully drained."""
        nonlocal exhausted
        while True:
            full = [k for k, v in bins.items() if len(v) >= b]
            if full:
                return min(full)
            if exhausted:
                nonempty = [k for k, v in bins.items() if v]
                return min(nonempty) if nonempty else None
            try:
                rec = next(it)
            except StopIteration:
                exhausted = True
                continue
            bins.setdefault(key_of(rec), []).append(rec)

    steps = {}
    n_done = 0
    rounds = 0
    last_saved = None
    while True:
        cand = local_candidate()
        enc = np.asarray(cand if cand is not None else (INF,) * 3, np.int32)
        if cand is not None and not (enc < INF).all():
            raise ValueError(f"bin key {cand} does not fit int32")
        agreed = min(tuple(int(v) for v in row)
                     for row in dist.process_allgather(enc))
        if agreed[0] == INF:
            break
        t_edge, l_edge, long_flag = agreed
        gcfg = cfg
        if long_flag and cfg.band_width < cfg.band_width_long:
            gcfg = dataclasses.replace(cfg, band_width=cfg.band_width_long)
        mine = bins.get(agreed, [])
        group, rest = mine[:b], mine[b:]
        if rest:
            bins[agreed] = rest
        else:
            bins.pop(agreed, None)
        batch = assemble_batch(group, model, gcfg,
                               pad_reads_to=_shard_rows(gcfg, mesh, len(group)),
                               pad_signal_to=t_edge, pad_window_to=l_edge)
        coffs = np.asarray([contig_off.get(c, 0) for c in batch.contigs], np.int64)
        blocks = sharded.shard_batch(mesh, batch, model, gcfg, args.backend, tables,
                                     window_start=batch.window_start + coffs)
        if gcfg not in steps:
            steps[gcfg] = sharded.make_sharded_step(
                mesh, gcfg, Gp, genome_sharded=genome_sharded, with_path=False,
                merge_deferred=merge_deferred)
        score, *state = steps[gcfg](blocks, *state)
        with span("nadavca.drain"):
            score.cpu()  # local pacing sync
        n_done += batch.n_reads
        done_ids.update(batch.read_ids[:batch.n_reads])
        if metas_by_contig is not None:
            for r in range(batch.n_reads):
                metas_by_contig.setdefault(batch.contigs[r], []).append(
                    joint.ReadMeta(batch.read_ids[r], batch.contigs[r],
                                   int(batch.window_start[r]),
                                   int(batch.window_len[r]),
                                   int(batch.strand[r])))
        metrics.count("reads_called", batch.n_reads)
        metrics.count(f"batches_band_{gcfg.band_width}")
        _count_padding(metrics, batch)
        rounds += 1
        # the round counter advances in lockstep on every process (the agreed
        # key is a function of the gathered candidates), so the barrier
        # inside save_ckpt lines up
        if save_ckpt is not None and rounds % args.checkpoint_every == 0:
            save_ckpt(state, rounds)
            last_saved = rounds
    if save_ckpt is not None and last_saved != rounds:
        save_ckpt(state, rounds)
    return n_done, state


def cmd_snp(args) -> int:
    t_e2e = time.time()  # end-to-end clock: genome load → ingest → VCF
    cfg = _load_cfg(args)
    dev = _device(args)
    _check_supported(args, cfg, dev)
    multihost, pid, nproc, mesh = _init_distributed(args, dev)
    dev = mesh.devices[0]
    n_dev = mesh.size
    model = _load_model(args, cfg)
    genome = Genome.from_fasta(args.reference)
    metrics = METRICS
    metrics.reset()

    # ONE accumulator over the concatenated genome: all contigs live in one
    # (G, 4) array, so a batch spanning contigs is a single device step, and
    # the accumulators never leave the devices between batches
    contig_off = {}
    off = 0
    for c in genome:
        contig_off[c.name] = off
        off += len(c)
    G_total = off
    # the layout and the merge cadence, with the JAX package's thresholds: the
    # accumulators are genome-sharded once too big to replicate, and merged
    # only at checkpoints and at the end while a full-genome partial per
    # device (Gp·36 bytes) stays small
    if args.genome_sharded == "on":
        genome_sharded = n_dev > 1
    elif args.genome_sharded == "off":
        genome_sharded = False
    else:
        genome_sharded = n_dev > 1 and G_total >= (1 << 22)
    Gp = _round_up(max(G_total, 1), n_dev * 128) if genome_sharded else G_total
    if args.merge == "per-batch":
        merge_deferred = False
    elif args.merge == "deferred":
        merge_deferred = n_dev > 1
    else:
        merge_deferred = n_dev > 1 and Gp <= (1 << 26)
    merge_fn = (sharded.make_merge_fn(mesh, Gp, genome_sharded)
                if merge_deferred else None)

    def merged_host(state):
        """The merged accumulators, whole, on the host (a collective under
        a process group: every process calls it)."""
        t0 = time.time()
        if merge_fn is not None:
            state = merge_fn(*state)
        out = tuple(sharded.fetch(mesh, x, genome_sharded) for x in state)
        metrics.gauge("merge_s", time.time() - t0)
        return out

    ckpt_accs, done_ids, resumed_metas = {}, set(), []
    if args.checkpoint and multihost:
        ckpt_accs, done_ids, resumed_metas = _load_checkpoint_of_group(
            args.checkpoint, pid, nproc)
    elif args.checkpoint:
        ckpt_accs, done_ids, _, resumed_metas = load_checkpoint(
            args.checkpoint, with_meta=True)
    if done_ids:
        print(f"resuming: {len(done_ids)} reads already merged (process {pid})",
              file=sys.stderr)
    records = _stream_records(args, cfg, genome, metrics, model=model,
                              skip_ids=done_ids,
                              shard=(pid, nproc) if multihost else None)

    restored = None
    if ckpt_accs:
        restored = (np.zeros((Gp, 4), np.float32), np.zeros((Gp,), np.int32),
                    np.zeros((Gp, 4), np.int32))
        for cname, coff in contig_off.items():
            if cname in ckpt_accs:
                l = len(genome[cname])
                for dst, src in zip(restored, ckpt_accs[cname]):
                    dst[coff:coff + l] = src
    state = sharded.make_accumulators_sharded(mesh, Gp, genome_sharded,
                                              merge_deferred, state=restored)

    # per-read placement metadata for the joint rescore pass (tiny); a
    # resumed run seeds it from the checkpoint so pre-checkpoint reads stay
    # re-loadable as joint evidence
    metas_by_contig = {} if cfg.snp_joint_rescore else None
    if metas_by_contig is not None:
        for m in resumed_metas:
            metas_by_contig.setdefault(m.contig, []).append(m)

    def accs_by_contig(a_np, c_np, v_np):
        return {cname: (a_np[coff:coff + len(genome[cname])],
                        c_np[coff:coff + len(genome[cname])],
                        v_np[coff:coff + len(genome[cname])])
                for cname, coff in contig_off.items()}

    def flat_metas():
        return [m for ms in (metas_by_contig or {}).values() for m in ms]

    def save_ckpt(merged):
        if args.checkpoint:
            with span("nadavca.checkpoint"):
                save_checkpoint(args.checkpoint, accs_by_contig(*merged), done_ids,
                                read_metas=flat_metas())

    def save_ckpt_of_group(state, n_batches):
        """Manifests first, then a barrier, then process 0 writes the merged
        accumulators: the accumulator file only advances once every manifest
        of that batch is on disk (a crash mid-save can lose a window's
        contributions, but a resume never counts a read twice)."""
        meta = {"n_batches": int(n_batches), "num_processes": int(nproc)}
        with span("nadavca.checkpoint"):
            if pid != 0:
                save_checkpoint(_ckpt_shard_path(args.checkpoint, pid), {}, done_ids,
                                meta=meta, read_metas=flat_metas())
                _crash_point("post_manifest", pid, n_batches)
            dist.sync_global_devices()
            _crash_point("pre_acc", pid, n_batches)
            # the deferred merge and the fetch of genome slices are
            # collectives: every process joins them, though only process 0
            # writes
            merged = merged_host(state)
            if pid == 0:
                save_checkpoint(args.checkpoint, accs_by_contig(*merged), done_ids,
                                meta=meta, read_metas=flat_metas())
            _crash_point("post_save", pid, n_batches)

    t0 = time.time()
    with span("nadavca.tables"):
        subst = api._maybe_subst(genome, model, cfg, args.backend, mesh.devices[0])
        tables = sharded.replicate_tables(mesh, subst)
    metrics.gauge("subst_build_s", time.time() - t0)
    t0 = time.time()

    if multihost:
        n_done, state = _run_snp_multihost(
            args, cfg, model, tables, mesh, records, contig_off, Gp,
            genome_sharded, merge_deferred, state, metrics, done_ids,
            metas_by_contig=metas_by_contig,
            save_ckpt=save_ckpt_of_group if args.checkpoint else None)
        dt = time.time() - t0
        metrics.gauge("reads_per_s", n_done / dt if dt > 0 else 0.0)
        a_np, c_np, v_np = merged_host(state)
        # every process joins _final_calls (the joint pass gathers its
        # per-shard matrices); only process 0 writes the VCF
        with span("nadavca.calls"):
            all_calls = _final_calls(args, cfg, model, genome, contig_off, a_np,
                                     c_np, v_np, metas_by_contig, args.min_coverage,
                                     dev, shard=(pid, nproc), multihost=True)
        dt_e2e = time.time() - t_e2e
        metrics.gauge("reads_per_s_e2e", n_done / dt_e2e if dt_e2e > 0 else 0.0)
        _padding_waste(metrics)
        _device_gauges(metrics, mesh)
        metrics.report(sys.stderr)
        if pid == 0:
            callmod.write_vcf(args.output, all_calls)
            print(f"{len(all_calls)} SNP calls ({nproc} processes, {n_done} reads "
                  f"on process 0) -> {args.output}", file=sys.stderr)
        return 0

    n_done = 0
    n_batches = 0

    def _prep(group):
        with span("nadavca.prep"):
            gcfg = _cfg_for_group(cfg, group)
            batch = assemble_batch(group, model, gcfg,
                                   pad_reads_to=_shard_rows(gcfg, mesh, len(group)))
            coffs = np.asarray([contig_off[c] for c in batch.contigs], np.int64)
            return group, gcfg, batch, sharded.shard_batch(
                mesh, batch, model, gcfg, args.backend, tables,
                window_start=batch.window_start + coffs)

    steps = {}
    seen_shapes = set()
    # steady-state window: wall time only over contiguous spans of batches
    # whose shape ran before. The first batch of a shape closes the span and
    # runs synchronously outside it: the kernel library loads (and, on a
    # fresh checkout, builds) at the first launch.
    steady_reads, steady_secs, span_t0 = 0, 0.0, None
    # lagged drain: launch batch N+1 before syncing batch N's result, so host
    # Python overlaps device work; depth 2 bounds device queueing. Fetching
    # the score to the host is the sync.
    pending = collections.deque()
    for group, gcfg, batch, blocks in _prefetched(
            _stream_groups(records, args.batch_reads, cfg), _prep):
        _count_padding(metrics, batch)
        metrics.count(f"batches_band_{gcfg.band_width}")
        shape_key = (batch.shapes, gcfg.band_width)
        known = shape_key in seen_shapes
        if not known:
            if span_t0 is not None:
                steady_secs += time.time() - span_t0
                span_t0 = None
            with span("nadavca.drain"):
                while pending:
                    pending.popleft().cpu()
        elif span_t0 is None:
            span_t0 = time.time()
        if gcfg not in steps:
            # the SNP loop never reads the Viterbi path
            steps[gcfg] = sharded.make_sharded_step(
                mesh, gcfg, Gp, genome_sharded=genome_sharded, with_path=False,
                merge_deferred=merge_deferred)
        score, *state = steps[gcfg](blocks, *state)
        with span("nadavca.drain"):
            if known:
                pending.append(score)
                while len(pending) > 2:
                    pending.popleft().cpu()
                steady_reads += batch.n_reads
            else:
                score.cpu()
        seen_shapes.add(shape_key)
        n_done += batch.n_reads
        n_batches += 1
        done_ids.update(batch.read_ids[: batch.n_reads])
        if metas_by_contig is not None:
            for r in range(batch.n_reads):
                metas_by_contig.setdefault(batch.contigs[r], []).append(
                    joint.ReadMeta(batch.read_ids[r], batch.contigs[r],
                                   int(batch.window_start[r]),
                                   int(batch.window_len[r]),
                                   int(batch.strand[r])))
        metrics.count("reads_called", batch.n_reads)
        if args.checkpoint and n_batches % args.checkpoint_every == 0:
            save_ckpt(merged_host(state))
    with span("nadavca.drain"):
        while pending:
            pending.popleft().cpu()
    if span_t0 is not None:  # the final drain belongs to the open steady span
        steady_secs += time.time() - span_t0
    merged = merged_host(state)
    save_ckpt(merged)
    with span("nadavca.calls"):
        all_calls = _final_calls(args, cfg, model, genome, contig_off, *merged,
                                 metas_by_contig, args.min_coverage, dev)
    callmod.write_vcf(args.output, all_calls)
    dt = time.time() - t0
    metrics.gauge("reads_per_s", n_done / dt if dt > 0 else 0.0)
    dt_e2e = time.time() - t_e2e
    # genome load + ingest + prep + device + VCF, one clock: ingest overlaps
    # the device loop through the streamed producer, but nothing is excluded
    metrics.gauge("reads_per_s_e2e", n_done / dt_e2e if dt_e2e > 0 else 0.0)
    if steady_secs > 0:
        # throughput once each bucket shape has run once
        metrics.gauge("reads_per_s_steady", steady_reads / steady_secs)
    _padding_waste(metrics)
    _device_gauges(metrics, mesh)
    metrics.report(sys.stderr)
    print(f"{len(all_calls)} SNP calls from {n_done} reads -> {args.output}",
          file=sys.stderr)
    return 0


def cmd_simulate(args) -> int:
    from .io.simulator import random_genome, simulate_read

    rng = np.random.default_rng(args.seed)
    cfg = _load_cfg(args)
    model = _load_model(args, cfg)
    if args.reference and os.path.exists(args.reference):
        genome = Genome.from_fasta(args.reference)
    else:
        genome = random_genome(rng, length=args.genome_length)
    os.makedirs(args.output, exist_ok=True)
    ref_path = os.path.join(args.output, "reference.fasta")
    genome.to_fasta(ref_path)

    # optionally plant SNPs into the written reference (reads keep the truth)
    truth = []
    if args.snps > 0:
        contig = genome.contigs[0]
        codes = contig.codes.copy()
        positions = rng.choice(len(codes) - 20, size=args.snps, replace=False) + 10
        for p in sorted(positions):
            orig = int(codes[p])
            codes[p] = (orig + int(rng.integers(1, 4))) % 4
            truth.append((contig.name, int(p), orig, int(codes[p])))
        mutated = Genome.from_dict({contig.name: ""})
        mutated.contigs[0].codes = codes
        mutated._by_name = {contig.name: mutated.contigs[0]}
        mutated.to_fasta(ref_path)
        with open(os.path.join(args.output, "truth_snps.tsv"), "w") as f:
            f.write("contig\tpos0\tsample_base\tref_base\n")
            for cname, p, orig, new in truth:
                f.write(f"{cname}\t{p}\t{'ACGT'[orig]}\t{'ACGT'[new]}\n")

    contig = genome.contigs[0].name
    # --read-length accepts a comma-separated list ("300,1800"): reads cycle
    # through the lengths, so one dataset can mix short and long reads (and
    # drive the adaptive band)
    lengths = [int(v) for v in str(args.read_length).split(",")]
    reads = [
        simulate_read(genome, contig, model, rng,
                      read_len=lengths[i % len(lengths)],
                      read_id=f"sim{i:05d}")
        for i in range(args.reads)
    ]
    per_file = max(1, args.reads // max(1, args.files))
    for fi in range(0, len(reads), per_file):
        fast5mod.write_fast5(
            os.path.join(args.output, f"reads_{fi // per_file:03d}.fast5"),
            reads[fi : fi + per_file],
        )
    print(f"simulated {len(reads)} reads -> {args.output}", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nadavca-tpu-torch",
        description="nanopore raw-signal alignment and SNP calling on GPUs",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("reference", help="reference FASTA")
        sp.add_argument("fast5_dir", help="directory of .fast5 files")
        sp.add_argument("--configuration", help="YAML config override")
        sp.add_argument("--model", help="k-mer model tsv (default: builtin)")
        sp.add_argument("--batch-reads", type=int, default=256)
        sp.add_argument("--backend", default="auto",
                        choices=["auto", "cuda", "scan"],
                        help="cuda (auto): the kernels; scan: the per-step "
                             "reference loop")
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the batches run (cpu: every kernel's "
                             "plain version)")
        sp.add_argument("--workers", type=int, default=2,
                        help="host ingest/preprocess threads")
        sp.add_argument("--basecalls",
                        help="sidecar basecall file (tsv: read_id/basecall/"
                             "move_csv, or .sam with mv:B:c tags) joined to "
                             "signal-only reads, e.g. pod5 input")
        sp.add_argument("--prep", default="auto",
                        choices=["auto", "native", "python"],
                        help="per-read prep engine (native = C++ csrc/prep.cpp)")
        sp.add_argument("--devices", default="1",
                        help="number of devices of this process to split "
                             "batches over (int or 'all'; default 1)")
        sp.add_argument("--profile",
                        help="write a torch.profiler chrome trace here")
        sp.add_argument("--coordinator",
                        help="process group address host:port (snp: joins a "
                             "torch.distributed group, each process driving "
                             "its --devices; every process passes the same "
                             "value)")
        sp.add_argument("--num-processes", type=int,
                        help="total processes in the group (align: input "
                             "sharding, no group)")
        sp.add_argument("--process-id", type=int,
                        help="this process's rank (0-based)")

    sa = sub.add_parser("align", help="signal→reference alignments per read")
    common(sa)
    sa.add_argument("-o", "--output", required=True, help="output directory")
    sa.set_defaults(fn=cmd_align)

    ss = sub.add_parser("snp", help="signal-level SNP calls")
    common(ss)
    ss.add_argument("-o", "--output", required=True, help="output VCF path")
    ss.add_argument("--min-coverage", type=int, default=3)
    ss.add_argument("--genome-sharded", default="auto",
                    choices=["auto", "on", "off"],
                    help="shard the locus accumulators over devices "
                         "(auto: on for >= 2**22 positions with > 1 device)")
    ss.add_argument("--checkpoint", help="accumulator checkpoint path (resume)")
    ss.add_argument("--checkpoint-every", type=int, default=8,
                    help="save the checkpoint every N batches")
    ss.add_argument("--merge", default="auto",
                    choices=["auto", "deferred", "per-batch"],
                    help="accumulator merge cadence across devices: "
                         "'deferred' keeps per-device full-genome partials "
                         "and sums them only at checkpoints and before "
                         "calling; 'per-batch' merges every batch; auto: "
                         "deferred up to 2**26 genome positions")
    ss.set_defaults(fn=cmd_snp)

    sm = sub.add_parser("simulate", help="generate synthetic fast5 test data")
    sm.add_argument("--reference", help="FASTA to simulate from (default: random)")
    sm.add_argument("-o", "--output", required=True)
    sm.add_argument("--reads", type=int, default=32)
    sm.add_argument("--files", type=int, default=4)
    sm.add_argument("--read-length", default="600",
                    help="bases per read, or a comma list cycled over reads "
                         "(mixed-length datasets, e.g. '300,1800')")
    sm.add_argument("--genome-length", type=int, default=5000)
    sm.add_argument("--snps", type=int, default=0)
    sm.add_argument("--seed", type=int, default=0)
    sm.add_argument("--configuration")
    sm.add_argument("--model")
    sm.set_defaults(fn=cmd_simulate)
    return p


def main(argv=None, reads: Optional[Sequence[RawRead]] = None) -> int:
    """Run one subcommand. ``reads``, a sequence of ``RawRead`` in memory,
    replaces the reads of the ``fast5_dir`` argument of ``align`` and
    ``snp``."""
    from .utils.profiling import trace

    args = build_parser().parse_args(argv)
    args.raw_reads = reads
    try:
        with trace(getattr(args, "profile", None)):
            return args.fn(args)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
