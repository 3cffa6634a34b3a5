"""One run of a cell: set-up, the measured window, the traced reading and the
check of what the window produced.

The window drives the card's part of ``nadavca_tpu_torch``'s SNP job as
``cli.cmd_snp`` runs it on one device, batch after batch:
``parallel.sharded.shard_batch`` (the upload through ``pipeline.
stage_batch``), the step of ``parallel.sharded.make_sharded_step`` (fill,
walk and local rescore through ``pipeline.align_batch``, then
``call.accumulate_batch`` into the genome accumulators), and the CLI's lagged
drain (at most two scores pending before a ``.cpu()``). One client, a closed
loop. The batches are a pool made in set-up by the CLI's own grouping
(``cli._stream_groups``, ``cli._cfg_for_group``) and ``pipeline.
assemble_batch``, cycled in an order fixed by the seed; the window runs whole
cycles until ``seconds`` have passed, then drains.

What is checked, once the window has closed (``reference.py``): the batching
against the reference's own; for a sample of reads drawn from the seed, two
in every batch, every Viterbi score the step returned for them and their base
log-likelihoods; for the genome, the coverage, the accumulated
log-likelihoods and the alt votes; and the SNP calls the program derives from
its accumulators. The log-likelihoods are read from one more whole cycle of
the same step after the window and the peak memory's reading, with a
recorder on ``call.accumulate_batch``; the window itself runs unobserved.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import gen, reference, spec
from . import trace as tracemod

FORBIDDEN = ("jax", "jaxlib", "flax", "nadavca_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class PoolBatch:
    """One assembled batch of the pool, on the host."""

    cfg: object                  # the program's AlignConfig of the group
    batch: object                # the program's pipeline.Batch
    members: List[int]           # stream indices of its reads, row by row
    window_start: np.ndarray     # the scatter's window starts (contig offsets added)

    @property
    def R(self) -> int:
        return int(self.batch.x.shape[0])

    @property
    def T(self) -> int:
        return int(self.batch.x.shape[1])

    @property
    def L(self) -> int:
        return int(self.batch.codes.shape[1])

    @property
    def N(self) -> int:
        return int(self.batch.mu.shape[1])

    @property
    def band(self) -> int:
        return int(self.cfg.band_width)


@dataclasses.dataclass
class Ctx:
    """What a per-layer metric's reader may read."""

    cell: spec.Cell
    inputs: gen.Inputs
    pool: List[PoolBatch]
    window_batches: List[PoolBatch]
    trace: Optional[tracemod.Trace]
    setup: Dict[str, float]


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _records(inputs: gen.Inputs):
    """The program's ReadRecord of every read, in stream order: the signal,
    the true window as an Anchor, the per-sample anchor path (the true one,
    whole k-mer positions as int32, which ``assemble_batch`` copies into its
    float64 anchors) and the window's reference bases. Host prep is not part
    of the cell."""
    from nadavca_tpu_torch.anchor import Anchor
    from nadavca_tpu_torch.pipeline import ReadRecord

    out = []
    for i, rid in enumerate(inputs.read_ids):
        s, b = int(inputs.start[i]), int(inputs.bases[i])
        out.append(ReadRecord(
            read_id=rid, signal=inputs.signal[i],
            anchor=Anchor(contig=inputs.contig, strand=int(inputs.strand[i]),
                          ref_start=s, ref_end=s + b,
                          base_to_window=np.arange(b, dtype=np.float64), score=b),
            anchor_path=inputs.path[i],
            window_codes=inputs.window(i)))
    return out


class _Recorder:
    """Keeps the base log-likelihoods each step hands to
    ``call.accumulate_batch`` (a reference to the tensor, no copy), so that
    the check can read the program's own rescore output of every pool batch.
    Attached only to the untimed cycle after the window."""

    def __init__(self, callmod):
        self.callmod = callmod
        self.orig = callmod.accumulate_batch
        self.got: List = []

    def __enter__(self):
        orig, got = self.orig, self.got

        def accumulate_batch(acc, cov, base_ll, *a, **kw):
            got.append(base_ll)
            return orig(acc, cov, base_ll, *a, **kw)

        self.callmod.accumulate_batch = accumulate_batch
        return self

    def __exit__(self, *exc):
        self.callmod.accumulate_batch = self.orig


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        process_age_s: float = 0.0, t_start: Optional[float] = None,
        root: str = spec.ROOT) -> dict:
    """One run of ``cell_name``; returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``trace`` also
    ``breakdown``, and ``checks`` last). ``t_start``: the clock reading at
    the start of the process's own code, ``process_age_s`` the process's age
    then, so that ``setup_s`` runs from the process's start."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from nadavca_tpu_torch import api, cli
    from nadavca_tpu_torch import call as callmod
    from nadavca_tpu_torch.config import AlignConfig
    from nadavca_tpu_torch.genome import Contig, Genome
    from nadavca_tpu_torch.kmer_model import KmerModel
    from nadavca_tpu_torch.parallel import sharded
    from nadavca_tpu_torch.pipeline import assemble_batch

    cell = spec.cell(cell_name, root)
    conf, traffic = cell.config, cell.traffic
    align = conf["align"]
    dev = torch.device(device)
    setup: Dict[str, float] = {"start_s": time.perf_counter() - t_start + process_age_s}

    # ---------------------------------------------------------------- set-up
    t0 = time.perf_counter()
    inputs = gen.make_inputs(conf, traffic, seed, device=device)
    setup["inputs_s"] = time.perf_counter() - t0
    cfg = AlignConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in align.items()})
    model = KmerModel(cfg.k, inputs.level_mean, inputs.level_std)
    genome = Genome([Contig(inputs.contig, inputs.ref)])
    G = len(inputs.ref)
    mesh = sharded.make_mesh(1, device)
    t0 = time.perf_counter()
    subst = api._maybe_subst(genome, model, cfg, "auto", mesh.devices[0])
    tables = sharded.replicate_tables(mesh, subst)
    _sync(dev)
    setup["tables_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    records = _records(inputs)
    index = {rid: i for i, rid in enumerate(inputs.read_ids)}
    pool: List[PoolBatch] = []
    assemble_s = []
    for group in cli._stream_groups(records, traffic["batch_reads"], cfg):
        if len(group) < traffic["batch_reads"]:
            continue        # a partial bin at the end of the stream
        t1 = time.perf_counter()
        gcfg = cli._cfg_for_group(cfg, group)
        batch = assemble_batch(group, model, gcfg,
                               pad_reads_to=cli._shard_rows(gcfg, mesh, len(group)))
        assemble_s.append(time.perf_counter() - t1)
        # one contig, at offset 0 of the CLI's concatenated genome
        pool.append(PoolBatch(gcfg, batch, [index[r.read_id] for r in group],
                              batch.window_start.astype(np.int64)))
    del records
    setup["pool_s"] = time.perf_counter() - t0
    setup["assemble_s"] = float(sum(assemble_s))
    setup["assemble_batches"] = len(pool)
    order = np.random.default_rng([int(seed), 0xC1C1E]).permutation(len(pool))
    steps = {}
    for pb in pool:
        if pb.cfg not in steps:
            steps[pb.cfg] = sharded.make_sharded_step(
                mesh, pb.cfg, G, genome_sharded=False, with_path=False,
                merge_deferred=False)

    spans = contextlib.nullcontext
    if trace:
        from torch.profiler import record_function
        spans = record_function

    def one_cycle(state, pending, scores):
        for b in order:
            pb = pool[b]
            with spans("bench.upload"):
                blocks = sharded.shard_batch(mesh, pb.batch, model, pb.cfg, "auto",
                                             tables, window_start=pb.window_start)
            with spans("bench.step"):
                score, *state = steps[pb.cfg](blocks, *state)
            pending.append((len(scores), score))
            scores.append(None)
            with spans("bench.drain"):
                while len(pending) > 2:
                    j, s = pending.popleft()
                    scores[j] = s.cpu()
        return state

    def drain(pending, scores):
        while pending:
            j, s = pending.popleft()
            scores[j] = s.cpu()

    # warm-up: one whole cycle, every shape of the pool once
    t0 = time.perf_counter()
    pending = collections.deque()
    warm: List = []
    state = sharded.make_accumulators_sharded(mesh, G)
    state = one_cycle(state, pending, warm)
    drain(pending, warm)
    _sync(dev)
    del state
    gc.collect()
    state = sharded.make_accumulators_sharded(mesh, G)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    setup["warmup_s"] = time.perf_counter() - t0

    # ---------------------------------------------------------------- window
    scores: List = []
    n_cycles = 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t_start + process_age_s
    with spans("bench.window"):
        w0 = time.perf_counter()
        cycle_ends = []
        while True:
            state = one_cycle(state, pending, scores)
            n_cycles += 1
            cycle_ends.append(time.perf_counter() - w0)
            if cycle_ends[-1] >= seconds:
                break
        with spans("bench.drain"):
            drain(pending, scores)
        w1 = time.perf_counter()
    tr = None
    t0 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
        tr = tracemod.from_profile(prof)
    trace_s = time.perf_counter() - t0
    window_s = w1 - w0
    n_batches = len(scores)
    n_reads = sum(pool[b].batch.n_reads for b in order) * n_cycles
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    # one more whole cycle, untimed and after the peak's reading, with the
    # log-likelihoods each step hands to the scatter recorded for the check;
    # its sums join the window's in the accumulators
    with _Recorder(callmod) as rec:
        state = one_cycle(state, pending, scores)
        drain(pending, scores)
    if len(rec.got) != len(order):
        raise RuntimeError(
            f"call.accumulate_batch was called {len(rec.got)} times in a cycle of "
            f"{len(order)} batches: the step no longer hands its log-likelihoods to "
            "call.accumulate_batch, which the check reads them from")
    recorded = {int(b): rec.got[j] for j, b in enumerate(order)}
    n_sums = n_cycles + 1

    # ------------------------------------------------- the program's outputs
    t0 = time.perf_counter()
    acc, cov, votes = (s[0].cpu().numpy() for s in state)
    del state, rec, tables, subst, steps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    calls = callmod.call_snps(acc, cov, inputs.ref, inputs.contig, cfg,
                              min_coverage=int(conf["min_coverage"]), votes=votes)
    all_scores = [None if s is None else s.numpy() for s in scores]
    outputs_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    check_parts: Dict[str, float] = {}
    checks = check(cell, inputs, pool, order, n_sums, all_scores, recorded,
                   acc, cov, votes, calls, seed, root, check_parts)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    check_s = time.perf_counter() - t0

    ctx = Ctx(cell, inputs, pool, [pool[b] for b in order] * n_cycles, tr, setup)
    result = {
        "correct": bool(correct),
        "attempted": int(n_reads),
        "failed": int(sum(s is None for s in all_scores[:n_batches])
                      * traffic["batch_reads"]),
        "metrics": {},
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    t0 = time.perf_counter()
    if trace:
        result["metrics"] = spec.read_layers(cell.per_layer, ctx)
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tracemod.breakdown(tr)
    else:
        values = {"reads_per_s": n_reads / window_s, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    layers_s = time.perf_counter() - t0
    result["checks"] = checks
    result["_window"] = {"seconds": window_s, "cycles": n_cycles, "batches": n_batches,
                         "setup": setup, "setup_s": setup_s, "check_s": check_s,
                         "check_parts": check_parts, "outputs_s": outputs_s,
                         "trace_s": trace_s, "layers_s": layers_s,
                         "cycle_ends_s": cycle_ends}
    return result


def sample_reads(batches, traffic, tile: int, seed) -> Dict[int, tuple]:
    """The reads whose answers are compared, drawn from the seed: in every
    batch ``check_reads_per_batch`` of its reads, each in another row tile of
    ``tile`` rows as far as the tiles go. {stream index: (batch, row)}."""
    rng = np.random.default_rng([int(seed), 0xC4EC])
    k = int(traffic["check_reads_per_batch"])
    out = {}
    for b, pb in enumerate(batches):
        n = len(pb.members)
        tiles = np.arange(n) // tile
        tile_rank = rng.permutation(int(tiles[-1]) + 1)
        rank_in_tile = np.empty(n, np.int64)
        for t in range(len(tile_rank)):
            rows = np.flatnonzero(tiles == t)
            rank_in_tile[rng.permutation(rows)] = np.arange(len(rows))
        rows = np.lexsort((tile_rank[tiles], rank_in_tile))[:k]
        out.update({pb.members[r]: (b, int(r)) for r in rows})
    return dict(sorted(out.items()))


def read_gaps(pairs) -> Dict[str, float]:
    """The per-read numbers of the check. ``pairs``: for each sampled read,
    (scores of the side under test, reference score, samples, (L, 4)
    log-likelihoods of the side under test, reference's). The score gap is
    taken per sample of the read (the score is a sum over its samples, of
    terms that largely cancel); a log-likelihood entry is off where it lies
    more than 0.05 + 1e-4 of the reference's value from it, or where one
    side keeps a position the other masks."""
    score_gap, off, total = 0.0, 0, 0
    for got, s_ref, t_len, ll, ll_ref in pairs:
        for s in got:
            score_gap = max(score_gap, abs(s - s_ref) / t_len)
        ll = np.asarray(ll, np.float64)
        live = (ll != 0).any(axis=1) | (ll_ref != 0).any(axis=1)
        gap = np.abs(ll - ll_ref)[live]
        off += int((gap > 0.05 + 1e-4 * np.abs(ll_ref[live])).sum())
        total += int(live.sum()) * 4
    return {"score_gap_per_sample": score_gap, "ll_off_share": off / max(total, 1)}


def check(cell, inputs, pool, order, n_sums, scores, recorded, acc, cov,
          votes, calls, seed, root: str = spec.ROOT, seconds=None) -> Dict[str, dict]:
    """Every number compared, each with its limit (``limits/<cell>.json``).
    ``n_sums``: the whole cycles of ``order`` summed into the accumulators;
    ``scores``: what each of their steps returned, in order (None where it
    never came); ``recorded``: each pool batch's log-likelihoods as the last
    cycle handed them to the scatter. ``seconds``, a dict, receives the time
    each part took."""
    seconds = {} if seconds is None else seconds
    t0 = time.perf_counter()
    conf, traffic = cell.config, cell.traffic
    align = conf["align"]
    limits = spec.limits(cell.name, root)
    G = len(inputs.ref)
    out: Dict[str, float] = {}

    # batching: the reference's own grouping of the same stream
    t_len = [len(s) for s in inputs.signal]
    ref_batches = reference.group(t_len, inputs.bases, align, traffic["batch_reads"])
    out["batching_mismatch"] = float(
        abs(len(ref_batches) - len(pool))
        + sum(rb.members != pb.members or rb.T != pb.T or rb.L != pb.L
              or rb.band != pb.band for rb, pb in zip(ref_batches, pool)))

    # answers that never came
    out["undrained_batches"] = float(sum(s is None for s in scores))

    # a sample of reads, drawn from the seed: every score the steps returned
    # for them, and their base log-likelihoods
    rb_of = {m: rb for rb in ref_batches for m in rb.members}
    slots = list(order) * n_sums
    sample = sample_reads(pool, traffic, align["read_tile"], seed)
    jobs = [(inputs.signal[m], inputs.path[m], inputs.window(m),
             rb_of.get(m) or reference.RefBatch([m], pool[b].T, pool[b].L, pool[b].band),
             align, inputs.level_mean, inputs.level_std) for m, (b, _) in sample.items()]
    pairs = []
    for (m, (b, r)), (s_ref, ll_ref) in zip(sample.items(),
                                            reference.answers_of_reads(jobs)):
        got = [float(scores[j][r]) for j, bb in enumerate(slots)
               if bb == b and scores[j] is not None]
        pairs.append((got, s_ref, len(inputs.signal[m]), recorded[b][r].cpu().numpy(),
                      ll_ref))
    out.update(read_gaps(pairs))
    seconds["reads"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # the genome: coverage from the windows alone; log-likelihoods and votes
    # as the scatter of the program's own log-likelihoods of every pool read
    members = [m for pb in pool for m in pb.members]
    cov_ref = reference.coverage(inputs.start[members], inputs.bases[members],
                                 inputs.strand[members], G) * n_sums
    out["cov_mismatch"] = float((cov.astype(np.int64) != cov_ref).sum())
    acc_ref = votes_ref = 0
    for b, pb in enumerate(pool):
        m = pb.members
        a, v = reference.scatter(
            recorded[b][:len(m)], inputs.start[m], inputs.bases[m], inputs.strand[m],
            G, align["snp_ll_clip"], align["snp_vote_margin"])
        acc_ref, votes_ref = acc_ref + a, votes_ref + v
    acc_ref = acc_ref.cpu().numpy() * n_sums
    votes_ref = votes_ref.cpu().numpy() * n_sums
    out["acc_rel_gap"] = float(np.abs(acc.astype(np.float64) - acc_ref).max()
                               / max(np.abs(acc_ref).max(), 1e-30))
    out["votes_mismatch"] = float((votes.astype(np.int64) != votes_ref).sum())
    seconds["genome"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # the calls the program derives from its accumulators
    want, near = reference.call_snps(acc, cov, votes, inputs.ref, align,
                                     int(conf["min_coverage"]),
                                     device=recorded[0].device)
    got = {c.position: "ACGT".index(c.alt_base) for c in calls}
    diff = {g for g in set(want) | set(got) if want.get(g) != got.get(g)}
    out["calls_mismatch"] = float(len(diff - near))
    seconds["calls"] = time.perf_counter() - t0

    return {name: {"value": out[name], "limit": float(limits[name])} for name in out}
