"""Command-line interface: ``align``, ``snp`` and ``simulate``.

Counterpart of ``nadavca_tpu/cli.py`` in one process on one device, with the
same subcommands, arguments and outputs. Reads stream from disk through a
pool of prep threads (``--workers``; the native prep releases the GIL) into
length-bucketed batches; a background thread assembles and uploads the next
batch while the device runs the current one, and results are drained one
batch late. Long-read buckets take the wide band (``_cfg_for_group``).
``snp`` sums every batch into one genome accumulator on the device,
checkpoints it with the read manifest (``--checkpoint``), and resumes by
skipping the merged reads before their signal is loaded.

Differences from the JAX package's CLI:

- ``--backend`` takes ``auto|cuda|scan`` and ``--device cuda|cpu`` (default
  ``cuda``) names the device; on the CPU every kernel runs its plain version.
- The multi-device and multi-process paths are not ported yet (ROADMAP.md,
  Queue 1 item 4): ``--devices`` other than 1, ``--coordinator`` and ``snp``
  with ``--num-processes`` > 1 raise ``NotImplementedError``.
  ``--merge`` and ``--genome-sharded`` are accepted; with one device they
  change nothing, as in the JAX package. ``align --num-processes N
  --process-id I`` shards the input files and needs no process group.
- ``main(argv, reads=...)`` takes the reads from a sequence of ``RawRead``
  in memory instead of the ``fast5_dir`` argument, which is then only a
  label: for machines without ``h5py``.
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
from .pipeline import (_bucket, align_batch, assemble_batch, check_supported,
                       make_preprocessor, path_to_segments, stage_batch)
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.metrics import Metrics

_NOT_PORTED = ("is part of the multi-device path, which is not ported yet "
               "(ROADMAP.md, Queue 1 item 4)")


def _load_cfg(args) -> AlignConfig:
    if getattr(args, "configuration", None):
        return AlignConfig.from_yaml(args.configuration)
    return DEFAULT_CONFIG


def _load_model(args, cfg) -> KmerModel:
    if getattr(args, "model", None):
        return KmerModel.load_tsv(args.model)
    return default_model(cfg.k)


def _device(args) -> torch.device:
    """The run's one device, with an explicit index: batches are staged on
    a worker thread, which must not depend on a current device."""
    dev = torch.device(args.device)
    return torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev


def _check_one_process(args, cfg: AlignConfig, dev: torch.device,
                       cmd: str) -> None:
    """Refuse what this CLI cannot run before any read is loaded: the
    multi-device flags, ``--device cuda`` without a card (nothing falls back
    to the CPU), and a configuration the device cannot take, also under the
    wide band of long reads."""
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "--device cpu runs the plain versions")
    if str(args.devices) != "1":
        raise NotImplementedError(f"--devices {args.devices} {_NOT_PORTED}")
    if args.coordinator:
        raise NotImplementedError(f"--coordinator {_NOT_PORTED}")
    if cmd == "snp" and (args.num_processes or 1) > 1:
        raise NotImplementedError(f"snp --num-processes {_NOT_PORTED}")
    check_supported(cfg, args.backend, dev)
    check_supported(dataclasses.replace(
        cfg, band_width=max(cfg.band_width, cfg.band_width_long)), args.backend, dev)


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
    robin by sorted index) is read. ``skip_ids`` (resume manifest) filters by
    read id BEFORE the signal is loaded from disk; ``skipped`` is a 1-element
    counter list; ``include_ids`` loads ONLY those ids (joint-rescore
    re-ingest). With ``reads`` the reads come from that sequence, filtered
    alike, and ``directory`` is not read."""
    if reads is not None:
        yield from _filtered(reads, skip_ids, skipped, include_ids)
        return
    paths = []
    for root, _dirs, files in sorted(os.walk(directory)):
        for fn in sorted(files):
            if fn.endswith(".fast5"):
                paths.append(os.path.join(root, fn))
    if shard is not None:
        pid, n = shard
        paths = [p for i, p in enumerate(paths) if i % n == pid]
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


def _padding_waste(batch) -> float:
    """Share of the signal axis that is padding, over the true reads."""
    n_true = max(batch.n_reads, 1)
    return 1.0 - (float(batch.t_len[:n_true].sum()) / (n_true * batch.x.shape[1]))


def _final_calls(args, cfg, model, genome, contig_off, a_np, c_np, v_np,
                 metas_by_contig, min_coverage, dev):
    """Accumulators → SNP calls, with the joint adjacent-hypothesis pass.

    When cfg.snp_joint_rescore is on, candidate clusters are re-scored by
    full re-alignment over every covering read (``joint.py``) on ``dev``:
    the reads that cover a cluster are ingested and prepped again by id.
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
                                   include_ids=needed):
            records_by_id[rec.read_id] = rec
    for cname, coff in contig_off.items():
        plan = plans[cname]
        if not plan:
            continue
        l = len(genome[cname])
        mats = joint.partial_deltas(
            plan, (metas_by_contig or {}).get(cname, []), records_by_id,
            model, cfg, device=dev)
        all_calls.extend(joint.decide(
            plan, mats, c_np[coff:coff + l],
            genome[cname].codes, cname, cfg, acc=a_np[coff:coff + l]))
    return all_calls


# The JAX package pads every batch of a bucket to one read count so that all
# of them reuse one compiled XLA executable. Nothing here is compiled per
# shape, so a batch is padded only as assemble_batch pads by default (to the
# read tile); the true reads' results do not depend on the padding.


def cmd_align(args) -> int:
    cfg = _load_cfg(args)
    dev = _device(args)
    _check_one_process(args, cfg, dev, "align")
    model = _load_model(args, cfg)
    genome = Genome.from_fasta(args.reference)
    metrics = Metrics()
    os.makedirs(args.output, exist_ok=True)
    # align has no cross-read reduction, so multi-process align is pure file
    # sharding: each process handles its slice of the inputs and writes its
    # own per-read outputs (no process group needed)
    shard = None
    if args.num_processes and args.num_processes > 1:
        if args.raw_reads is not None:
            raise ValueError("reads given in memory cannot be sharded by file "
                             "(--num-processes > 1)")
        if args.process_id is None:
            raise SystemExit(
                "--num-processes > 1 requires --process-id: without it every "
                "process would silently run shard 0 (duplicate outputs, the "
                "other shards never aligned)")
        if not 0 <= args.process_id < args.num_processes:
            raise SystemExit(
                f"--process-id {args.process_id} out of range "
                f"[0, {args.num_processes})")
        shard = (args.process_id, args.num_processes)
    t0 = time.time()  # end-to-end clock: ingest runs INSIDE the loop below
    records = _stream_records(args, cfg, genome, metrics, model=model,
                              shard=shard)
    n_done = 0

    def _prep(group):
        gcfg = _cfg_for_group(cfg, group)
        batch = assemble_batch(group, model, gcfg)
        return group, gcfg, batch, stage_batch(batch, model, gcfg, args.backend,
                                               device=dev)

    pending = collections.deque()

    def _drain_one():
        nonlocal n_done
        group, batch, out = pending.popleft()
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
    for group, gcfg, batch, staged in _prefetched(
            _stream_groups(records, args.batch_reads, cfg), _prep):
        metrics.gauge("padding_waste", _padding_waste(batch))
        metrics.count(f"batches_band_{gcfg.band_width}")
        # the alignment files hold the segments only: no rescore
        out = align_batch(batch, model, gcfg, staged=staged, rescore=False)
        pending.append((group, batch, out))
        while len(pending) > 1:
            _drain_one()
    while pending:
        _drain_one()
    dt = time.time() - t0
    # ingest→outputs wall including every host stage
    metrics.gauge("reads_per_s_e2e", n_done / dt if dt > 0 else 0.0)
    metrics.report(sys.stderr)
    print(f"aligned {n_done} reads -> {args.output}", file=sys.stderr)
    return 0


def cmd_snp(args) -> int:
    t_e2e = time.time()  # end-to-end clock: genome load → ingest → VCF
    cfg = _load_cfg(args)
    dev = _device(args)
    _check_one_process(args, cfg, dev, "snp")
    model = _load_model(args, cfg)
    genome = Genome.from_fasta(args.reference)
    metrics = Metrics()

    # ONE accumulator over the concatenated genome: all contigs live in one
    # (G, 4) array, so a batch spanning contigs is a single device step, and
    # the accumulators never leave the device between batches
    contig_off = {}
    off = 0
    for c in genome:
        contig_off[c.name] = off
        off += len(c)
    G = off

    ckpt_accs, done_ids, resumed_metas = {}, set(), []
    if args.checkpoint:
        ckpt_accs, done_ids, _, resumed_metas = load_checkpoint(
            args.checkpoint, with_meta=True)
    if done_ids:
        print(f"resuming: {len(done_ids)} reads already merged", file=sys.stderr)
    records = _stream_records(args, cfg, genome, metrics, model=model,
                              skip_ids=done_ids)

    acc, cov, votes = callmod.make_accumulators(G, with_votes=True, device=dev)
    if ckpt_accs:
        a_np = np.zeros((G, 4), np.float32)
        c_np = np.zeros((G,), np.int32)
        v_np = np.zeros((G, 4), np.int32)
        for cname, coff in contig_off.items():
            if cname in ckpt_accs:
                ck = ckpt_accs[cname]
                l = len(genome[cname])
                a_np[coff:coff + l] = ck[0]
                c_np[coff:coff + l] = ck[1]
                if len(ck) > 2:
                    v_np[coff:coff + l] = ck[2]
        acc, cov, votes = (torch.from_numpy(a).to(dev) for a in (a_np, c_np, v_np))

    # per-read placement metadata for the joint rescore pass (tiny); a
    # resumed run seeds it from the checkpoint so pre-checkpoint reads stay
    # re-loadable as joint evidence
    metas_by_contig = {} if cfg.snp_joint_rescore else None
    if metas_by_contig is not None:
        for m in resumed_metas:
            metas_by_contig.setdefault(m.contig, []).append(m)

    def save_ckpt():
        if not args.checkpoint:
            return
        a_np, c_np, v_np = (t.cpu().numpy() for t in (acc, cov, votes))
        save_checkpoint(
            args.checkpoint,
            {cname: (a_np[coff:coff + len(genome[cname])],
                     c_np[coff:coff + len(genome[cname])],
                     v_np[coff:coff + len(genome[cname])])
             for cname, coff in contig_off.items()},
            done_ids,
            read_metas=[m for ms in (metas_by_contig or {}).values() for m in ms])

    subst = api._maybe_subst(genome, model, cfg, args.backend, dev)
    t0 = time.time()
    n_done = 0
    n_batches = 0

    def _prep(group):
        gcfg = _cfg_for_group(cfg, group)
        batch = assemble_batch(group, model, gcfg)
        staged = stage_batch(batch, model, gcfg, args.backend, device=dev,
                             subst=subst)
        coffs = np.asarray([contig_off[c] for c in batch.contigs], np.int64)
        extra = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("wstart", batch.window_start.astype(np.int64) + coffs),
            ("wlen", batch.window_len), ("strand", batch.strand))}
        return group, gcfg, batch, staged, extra

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
    for group, gcfg, batch, staged, extra in _prefetched(
            _stream_groups(records, args.batch_reads, cfg), _prep):
        metrics.gauge("padding_waste", _padding_waste(batch))
        metrics.count(f"batches_band_{gcfg.band_width}")
        shape_key = (batch.shapes, gcfg.band_width)
        known = shape_key in seen_shapes
        if not known:
            if span_t0 is not None:
                steady_secs += time.time() - span_t0
                span_t0 = None
            while pending:
                pending.popleft().cpu()
        elif span_t0 is None:
            span_t0 = time.time()
        out = align_batch(batch, model, gcfg, staged=staged)
        acc, cov, votes = callmod.accumulate_batch(
            acc, cov, out["base_loglik"], extra["wstart"], extra["wlen"],
            extra["strand"], votes=votes, cfg=cfg)
        if known:
            pending.append(out["score"])
            while len(pending) > 2:
                pending.popleft().cpu()
            steady_reads += batch.n_reads
        else:
            out["score"].cpu()
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
            save_ckpt()
    while pending:
        pending.popleft().cpu()
    if span_t0 is not None:  # the final drain belongs to the open steady span
        steady_secs += time.time() - span_t0
    save_ckpt()
    a_np, c_np, v_np = (t.cpu().numpy() for t in (acc, cov, votes))
    all_calls = _final_calls(args, cfg, model, genome, contig_off,
                             a_np, c_np, v_np, metas_by_contig,
                             args.min_coverage, dev)
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
        description="nanopore raw-signal alignment and SNP calling on one GPU",
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
                        help="number of devices (only 1 is supported)")
        sp.add_argument("--profile",
                        help="write a torch.profiler chrome trace here")
        sp.add_argument("--coordinator",
                        help="multi-process coordinator address (not supported)")
        sp.add_argument("--num-processes", type=int,
                        help="total processes (align: file sharding)")
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
                    help="shard the locus accumulators over devices (one "
                         "device: no effect)")
    ss.add_argument("--checkpoint", help="accumulator checkpoint path (resume)")
    ss.add_argument("--checkpoint-every", type=int, default=8,
                    help="save the checkpoint every N batches")
    ss.add_argument("--merge", default="auto",
                    choices=["auto", "deferred", "per-batch"],
                    help="accumulator merge cadence across devices (one "
                         "device: no effect)")
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
    with trace(getattr(args, "profile", None)):
        return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
