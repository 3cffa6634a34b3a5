#!/usr/bin/env python3
"""GPU smoke gate of the PyTorch/CUDA port (``nadavca_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``nadavca_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version on the card (at the main and the wide
shape; the walk also at 384 and 1024 slots, the two-sample fill at 384, the
two rescore tile kernels also on rows shorter than 2304 samples, on rows
of 2561, and at k = 9, the R10.4.1 pore's 9-mer model, at T 22,016 and band
256 with 12.5 samples a base), drives the port's main path — the default
configuration: reads → banded Viterbi (the fill gathering its own band
levels) → the local re-DP rescore with genome tables in one kernel → SNP
calls — through the public ``api`` at a realistic batch size, checks the
result, and prints one JSON line per phase. Then ``band_width=384`` through
the same entry points on one batch, and the skip transition
(``use_skip=True, log_p_skip=-4.6``) on reads simulated with pore skips, at
the main path's size: the skip fill with two decision planes and the
two-plane backtrack. Further paths run at a smaller depth:
``dp_pair_step=True`` (the two-sample fill, gathering its own band levels),
the joint refiner (``snp_joint_rescore``, with and without
``snp_joint_skip``), ``snp_rescore="fixed"`` (the closed-form rescore) and
the local rescore without genome tables (K6 with the shear gather folded
in, one launch). Last, the command line as users run it, through
``cli.main([...], reads=...)`` on the card: ``snp`` on the main path's reads
with the native C++ prep on ``min(8, cpu_count)`` threads and with the
Python prep on one (the api's calls), ``align`` (the api's alignments), the
adaptive band on reads of 300 and 1800 bases (the long bucket at 256 slots;
the calls of the same run on the CPU), checkpoint and resume, and the native
prep held against the Python prep on the card's host, with ms per read of
each. Before the command line: the single-core C++ core (``ops/cpu_ref``) on
16 reads of the main world, ms per read on one host core and its paths
against the card's, and one batch of reads above 65,536 samples (T =
131,072, B = 256) through ``api.call_snps``, held against the ``scan`` twin
on the card. Then the JAX package's own test worlds (``reference_worlds``:
an N run in the reference, a one-read batch, a window narrower than the
band, 5 % indel basecalls, and the accuracy sweep's three quick-grid cells)
through the kernels with genome tables, each against the ``scan`` twin on
the card by the run rule of ``nadavca_tpu_torch/utils/parity.py``. Then several devices and processes on the one card
(``multi_device``): ``parallel.sharded`` on the mesh ``[cuda:0, cuda:0]`` in
its three layouts against one device, in one process and in two spawned
gloo ranks of that mesh each (the seconds and the bytes handed to gloo per
layout), ``cli snp`` in two gloo ranks (spawned) against one process, with
a checkpoint and a resume, and the JAX package's config 4 (a 4.6 Mb genome,
genome-sharded with deferred merges) in two ranks against one process. The earlier phases keep ``prep="python"``, so their numbers compare
with those of earlier runs. The last line is
``{"ok": true, "device": {...}}``; any failure raises and the exit code is not
0. Without a CUDA device it exits with code 2 and prints no result. ``--small``
cuts every size (for a quick look, not for numbers).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import nadavca_tpu_torch as nt
from nadavca_tpu_torch import api, call as callmod, cli, joint, pipeline, prep_native
from nadavca_tpu_torch.genome import Contig, Genome
from nadavca_tpu_torch.io import fast5 as fast5mod
from nadavca_tpu_torch.io.simulator import random_genome, simulate_read
from nadavca_tpu_torch.ops import banded_dp, cuda_dp, cuda_rescore
from nadavca_tpu_torch.ops.subst_tables import build_subst_tables
from nadavca_tpu_torch.parallel import sharded
from nadavca_tpu_torch.utils import kernel_build, parity
from nadavca_tpu_torch.utils.parity import (CPU_REF_TIE_SHARE, LONG_TIE_SHARE,
                                            hold_against_scan, tie_only_differences)
from nadavca_tpu_torch.utils.checkpoint import load_checkpoint

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores (the kernels here use no tensor core)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 instructions per second outside the tensor cores (132 SMs x 128
# lanes x 1.98 GHz): an add, a multiply or a maximum is one instruction, and
# under -fmad=false no multiply-add fuses two, so this is the instruction
# floor of the kernels' arithmetic
FP32_INSTR_PER_S = 67e12 / 2

KERNEL_INFO = {
    # folded into the three fills' producer warps
    "band_gather": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/viterbi_fill.cu",
        replaces="nadavca_tpu/ops/pallas_dp.py:520"),
    "viterbi_fill": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/viterbi_fill.cu",
        replaces="nadavca_tpu/ops/pallas_dp.py:188"),
    "backtrack": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/backtrack.cu",
        replaces="nadavca_tpu/ops/pallas_dp.py:676"),
    "viterbi_fill_skip": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/viterbi_fill.cu",
        replaces="nadavca_tpu/ops/pallas_dp.py:293"),
    "viterbi_fill_pair": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/viterbi_fill.cu",
        replaces="nadavca_tpu/ops/pallas_dp.py:79"),
    "backtrack_skip": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/backtrack.cu",
        replaces="nadavca_tpu/ops/pallas_dp.py:717"),
    # the walk's counts epilogue, emitted by the backtrack's own launch
    "path_counts": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/backtrack.cu",
        replaces="nadavca_tpu/ops/pallas_rescore.py:35"),
    # folded into the two rescore tile kernels
    "shear_gather": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/rescore.cu",
        replaces="nadavca_tpu/ops/pallas_rescore.py:627"),
    # K5 with K4's gather and the tensor code around them folded in
    "rescore_local_tab": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/rescore.cu",
        replaces="nadavca_tpu/ops/pallas_rescore.py:218"),
    # K6 likewise, without genome tables
    "rescore_local": dict(
        route="cuda", source="nadavca_tpu_torch/csrc/rescore.cu",
        replaces="nadavca_tpu/ops/pallas_rescore.py:191"),
}
# the kernels folded into others: the launches that carry them
FOLDED_INTO = {"band_gather": "viterbi_fill, viterbi_fill_skip, viterbi_fill_pair",
               "path_counts": "backtrack, backtrack_skip",
               "shear_gather": "rescore_local_tab, rescore_local"}
# every launch count: the kernels' and those of the three folded ones (the
# band gather, the path counts, the shear gather)
ALL_COUNTERS = cuda_dp.COUNTERS + cuda_rescore.KERNELS
# kernel against plain version in the rescore: the same float32 operations in
# the same order (no fused multiply-add on either side), so the difference is
# expected to be 0; the bound leaves room for a last-bit difference per step
RESCORE_ATOL, RESCORE_RTOL = 1e-3, 1e-5
# share of the planted SNPs the default caller must find on the smoke world
# (information beyond that: recall and precision are printed)
MIN_RECALL = 0.5
# the skip configuration of this slice, and the pore-skip rate of its reads
SKIP_FIELDS = dict(use_skip=True, log_p_skip=-4.6)
SKIP_PROB = 0.08
# the 9-mer model's k, and its signal's samples a base (5 kHz at 400 bases/s)
K9, K9_DWELL = 9, 12.5


def reset_launches() -> None:
    cuda_dp.reset_launches()
    cuda_rescore.reset_launches()


def read_launches() -> dict:
    return {k.__name__: k.launches for k in ALL_COUNTERS}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    sync()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    sync()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int) -> float:
    """Milliseconds of device time per call of ``fn``: the kernels' time in a
    ``torch.profiler`` trace of ``reps`` calls, without the host's gaps
    between them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA")
    return us / reps / 1e3


def wall_ms(fn) -> float:
    """Milliseconds of one call of ``fn`` ending in a synchronise."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


# ------------------------------------------------------------------ the world
def make_world(seed: int, genome_len: int, n_snps: int, n_reads: int,
               read_len, skip_prob: float = 0.0):
    """Simulated reads of a sample genome, and a reference that differs from
    it at ``n_snps`` planted positions (the caller must find those). With
    ``skip_prob`` a position emits no sample with that probability.
    ``read_len`` is a length or a tuple of lengths the reads cycle through."""
    lengths = read_len if isinstance(read_len, tuple) else (read_len,)
    rng = np.random.default_rng(seed)
    model = nt.default_model()
    sample = random_genome(rng, length=genome_len)
    contig = sample.contigs[0]
    codes = contig.codes.copy()
    truth = {}
    positions = rng.choice(len(codes) - 20, size=n_snps, replace=False) + 10
    for p in sorted(int(p) for p in positions):
        orig = int(codes[p])
        codes[p] = (orig + int(rng.integers(1, 4))) % 4
        truth[p] = "ACGT"[orig]                 # the sample's base = the alt to call
    reference = Genome([Contig(contig.name, codes)])
    reads = [simulate_read(sample, contig.name, model, rng,
                           read_len=lengths[i % len(lengths)],
                           read_id=f"sim{i:05d}", skip_prob=skip_prob)
             for i in range(n_reads)]
    return model, reference, reads, truth


def records_of(reads, reference, model, cfg):
    raws = [api.raw_read_from_simulated(r) for r in reads]
    return raws, api._preprocess(raws, reference, model, cfg, prep="python")


# ---------------------------------------------------------- phase 3: kernels
def staged_batch(records, model, cfg, subst=None):
    batch = pipeline.assemble_batch(records, model, cfg)
    return batch, pipeline.stage_batch(batch, model, cfg, "cuda", device="cuda",
                                       subst=subst)


def check_kernels(tag: str, batch, a, cfg, reps: int):
    """Each kernel against its plain version on the card, at this batch's
    shapes. Returns {kernel name: numbers}."""
    R, T = batch.x.shape
    B, C = cfg.band_width, cfg.signal_chunk
    n_chunks = T // C
    N = batch.mu.shape[1]
    out = {}

    # --- the band gather, folded into the fills' producer warps: no launch
    # of its own. Its plain version and the library's two gathers are timed
    # on the rows, its bound is its own bytes, and its time is that of the
    # fill launch that carries it (set below); its exactness is the fill's
    # (bit-equal to the plain gather and fill)
    idx = (a["lo"].long()[:, :, None]
           + torch.arange(B, device="cuda")[None, None, :]).reshape(R, -1)
    pad = max(int(idx.max()) + 1 - N, 0)
    mu_pad = torch.nn.functional.pad(a["mu"], (0, pad), value=0.0)
    sg_pad = torch.nn.functional.pad(a["sigma"], (0, pad), value=1.0)
    nbytes = 2 * R * N * 4 + R * n_chunks * 4 + 2 * n_chunks * R * B * 4
    # the yardstick: two torch.gather calls on pre-padded rows with a
    # prebuilt index (no transpose to chunk-major, index build not timed)
    lib_call = lambda: (torch.gather(mu_pad, 1, idx), torch.gather(sg_pad, 1, idx))
    out["band_gather"] = dict(
        max_abs_err=0.0,
        plain_ms=event_ms(lambda: cuda_dp.band_gather_plain(
            a["mu"], a["sigma"], a["lo"], B), 3, 1),
        library_ms=event_ms(lib_call, reps),
        library_device_ms=device_ms(lib_call, reps),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes, operations=0)
    del idx, mu_pad, sg_pad

    # --- fill, with the band gather in its producer warps: decision words
    # exact; V and acc within float32 rounding of a 128-step chunk (the two
    # sides run the same operations, but logf and the order inside the row
    # maximum may differ in the last bit)
    rows = (a["x"], a["t_len"], a["mu"], a["sigma"], a["lo"], a["delta"], a["n_ref"])
    # 2 mul + 2 add (emission), add, compare, max, add for each live cell
    out["viterbi_fill"], decs, v_fin, acc = check_fill(
        tag, "viterbi_fill", lambda: cuda_dp.viterbi_fill(*rows, cfg),
        lambda: plain_fill(cuda_dp.viterbi_fill_plain, rows, cfg), batch, cfg,
        ops_per_cell=8, reps=reps)
    out["band_gather"].update(ms=out["viterbi_fill"]["ms"],
                              ms_of="the viterbi_fill launch it is folded into")

    # --- backtrack and its counts epilogue: an integer walk over the same
    # bits, so exact
    out["backtrack"], out["path_counts"], _ = check_backtrack(
        tag, "backtrack", decs, v_fin, acc, a, C, cuda_rescore.count_lanes(N), reps)
    return out


def plain_fill(fill_plain, rows, cfg):
    """The plain band gather and a plain fill: what the fill kernels compute
    from the level rows."""
    x, t_len, mu, sigma, lo, delta, n_ref = rows
    mu_b, sg_b = cuda_dp.band_gather_plain(mu, sigma, lo, cfg.band_width)
    return fill_plain(x, t_len, mu_b, sg_b, lo, delta, n_ref, cfg)


def check_fill(tag, name, run, plain, batch, cfg, ops_per_cell, reps, exact=False):
    """One fill against its plain version: every plane of decision words
    equal, V and acc within float32 rounding (with ``exact`` equal). ``run``
    and ``plain`` take no argument. Returns (numbers, decs, V, acc) of the
    kernel."""
    R, T = batch.x.shape
    N = batch.mu.shape[1]
    B, n_chunks = cfg.band_width, T // cfg.signal_chunk
    decs, v_fin, acc = run()
    sync()
    (p_decs, p_v, p_acc), plain_ms = timed(plain)
    assert len(decs) == len(p_decs)
    for p, (dec, p_dec) in enumerate(zip(decs, p_decs)):
        n_diff = int((dec != p_dec).sum())
        assert n_diff == 0, f"{tag}: {name}: {n_diff} words of plane {p} differ"
    live_v = p_v > banded_dp.NEG_INF / 2
    assert bool((live_v == (v_fin > banded_dp.NEG_INF / 2)).all())
    err_v = float(((v_fin - p_v).abs() * live_v).max())
    err_acc = float((acc - p_acc).abs().max())
    tol_acc = 1e-3 + 1e-5 * float(p_acc.abs().max())
    assert err_v <= 1e-3 and err_acc <= tol_acc, (tag, name, err_v, err_acc, tol_acc)
    if exact:
        assert torch.equal(v_fin, p_v) and torch.equal(acc, p_acc), (tag, name, err_v,
                                                                      err_acc)
    live_steps = int(batch.t_len.astype(np.int64).sum())
    nbytes = (R * T * 4 + 2 * R * N * 4 + 2 * R * n_chunks * 4
              + 2 * R * 4 + len(decs) * (T // 32) * R * B * 4 + R * B * 4 + R * 4)
    serial_steps = int(batch.t_len.max())
    nums = dict(
        max_abs_err=max(err_v, err_acc), ms=event_ms(run, reps),
        device_ms=device_ms(run, reps), plain_ms=plain_ms, library_ms=None,
        **bound(nbytes, ops_per_cell * live_steps * B),
        serial_steps=serial_steps, planes=len(decs))
    nums["ns_per_step"] = nums["ms"] / serial_steps * 1e6
    # the kernel's (slots per lane, chain warps per read)
    nums["layout_S_W"] = list(cuda_dp.fill_layout(B, cfg.use_skip, cfg.dp_pair_step))
    return nums, decs, v_fin, acc


def check_backtrack(tag, name, decs, v_fin, acc, a, C, n_lanes, reps):
    """The walk over ``decs`` (one or two planes) against its plain version,
    without and with its counts epilogue over ``n_lanes``: an integer walk
    over the same bits, so paths and counts are equal. The walk without and
    with counts is timed in turns (without, with, with, without). Returns
    (numbers of the walk, numbers of the counts, path)."""
    Tw, R, B = decs[0].shape
    T = Tw * 32
    n_chunks = T // C
    t_len = a["t_len"]
    j_end, _ = cuda_dp.final_slot_and_score(v_fin, acc, a["lo"][:, -1], a["n_ref"])
    walk = lambda: cuda_dp.backtrack(decs, a["lo"], a["delta"], j_end, C)
    walk_counts = lambda: cuda_dp.backtrack(decs, a["lo"], a["delta"], j_end, C,
                                            t_len=t_len, n_lanes=n_lanes)
    path = walk()
    path_c, cnt = walk_counts()
    sync()
    p_path, plain_ms = timed(
        lambda: cuda_dp.backtrack_plain(decs, a["lo"], a["delta"], j_end, C))
    n_diff = int((path != p_path).sum())
    assert n_diff == 0, f"{tag}: {name}: {n_diff} path entries differ"
    assert torch.equal(path_c, path), f"{tag}: {name}: the walk with counts differs"
    p_cnt, cnt_plain_ms = timed(lambda: cuda_dp.path_counts_plain(p_path, n_lanes, t_len))
    n_diff = int((cnt != p_cnt).sum())
    assert n_diff == 0, f"{tag}: {name}: {n_diff} counts differ"
    # what this run's data needs: one decision word per plane and (word row,
    # visited slot) along each path, the band tables, and the path written once
    lo_rep = torch.repeat_interleave(a["lo"], C, dim=1).long()
    key = (torch.arange(T, device="cuda")[None, :] // 32) * B + (path.long() - lo_rep)
    words = int((key[:, 1:] != key[:, :-1]).sum()) + R
    nbytes = len(decs) * words * 4 + 2 * R * n_chunks * 4 + R * 4 + R * T * 4
    turns = [event_ms(f, reps) for f in (walk, walk_counts, walk_counts, walk)]
    # shift, mask, add, subtract per step and plane
    nums = dict(
        max_abs_err=0.0, ms=(turns[0] + turns[3]) / 2,
        plain_ms=plain_ms, library_ms=None,
        **bound(nbytes, 4 * len(decs) * R * T),
        ms_in_turns_without_counts=[turns[0], turns[3]],
        ms_in_turns_with_counts=[turns[1], turns[2]],
        chain_lookups=T // 32, planes=len(decs))
    # yardstick of the counts: torch.searchsorted on the prebuilt sentinel
    # path and lanes (the sentinel pass itself not timed)
    live = torch.arange(T, device="cuda")[None, :] < t_len[:, None]
    path_safe = torch.where(live, path, torch.full_like(path, n_lanes))
    lanes = torch.arange(n_lanes, dtype=torch.int32,
                         device="cuda")[None, :].expand(R, n_lanes).contiguous()
    counts = dict(
        max_abs_err=0.0, ms=(turns[1] + turns[2] - turns[0] - turns[3]) / 2,
        plain_ms=cnt_plain_ms,
        library_ms=event_ms(lambda: torch.searchsorted(path_safe, lanes), reps),
        # what the epilogue adds: the counts written once and t_len read once
        **bound(R * n_lanes * 4 + R * 4, 0), n_lanes=n_lanes)
    return nums, counts, path


def check_wide_walks(records, records_skip, model, reps: int) -> dict:
    """The walk (one plane, and two under skip) and its counts at B = 384 and
    1024 against their plain versions, on the fill kernel's words for
    ``records`` (and ``records_skip``) banded that wide; at 384 the
    two-sample fill on ``records`` too."""
    out = {}
    for B in (384, 1024):
        for name, recs, fields in (("backtrack", records, {}),
                                   ("backtrack_skip", records_skip, SKIP_FIELDS)):
            cfg_b = nt.AlignConfig(band_width=B, **fields)
            batch_b, a_b = staged_batch(recs, model, cfg_b)
            decs, v_fin, acc = cuda_dp.viterbi_fill(
                a_b["x"], a_b["t_len"], a_b["mu"], a_b["sigma"], a_b["lo"],
                a_b["delta"], a_b["n_ref"], cfg_b)
            nums, counts, _ = check_backtrack(
                f"B={B}", name, decs, v_fin, acc, a_b, cfg_b.signal_chunk,
                cuda_rescore.count_lanes(batch_b.mu.shape[1]), reps)
            out[f"{name}_B{B}"] = dict(
                R=batch_b.x.shape[0], T=batch_b.x.shape[1], max_abs_err=0.0,
                ms=nums["ms"], plain_ms=nums["plain_ms"], bound_ms=nums["bound_ms"],
                bound_by=nums["bound_by"], counts_ms=counts["ms"])
            if B == 384 and not fields:
                out["viterbi_fill_pair_B384"] = dict(
                    R=batch_b.x.shape[0], T=batch_b.x.shape[1],
                    **check_pair_fill(f"B={B}", batch_b, a_b, B, reps))
            del decs, v_fin, acc, a_b
    return out


def count_skips(path, t_len) -> int:
    """Advance-by-2 steps among the live samples of a batch of paths."""
    T = path.shape[1]
    live = torch.arange(1, T, device=path.device)[None, :] < t_len[:, None]
    return int((((path[:, 1:] - path[:, :-1]) == 2) & live).sum())


def check_skip_kernels(tag: str, batch, a, cfg, reps: int):
    """The skip fill (two planes), the two-plane backtrack and the two-sample
    fill against their plain versions on the card, at this batch's shapes.
    ``cfg`` is the skip configuration; the two-sample fill runs the same
    batch without skip. Returns {kernel name: numbers}."""
    B, C = cfg.band_width, cfg.signal_chunk
    out = {}
    rows = (a["x"], a["t_len"], a["mu"], a["sigma"], a["lo"], a["delta"], a["n_ref"])
    # 15 operations per live cell, the TPU launcher's own count with two
    # planes: emission 4, three transition adds, two maxima, two compares,
    # the and-not, the final add, two pack updates
    out["viterbi_fill_skip"], decs, v_fin, acc = check_fill(
        tag, "viterbi_fill_skip", lambda: cuda_dp.viterbi_fill(*rows, cfg),
        lambda: plain_fill(cuda_dp.viterbi_fill_plain, rows, cfg), batch, cfg,
        ops_per_cell=15, reps=reps)
    assert len(decs) == 2 and not bool((decs[0] & decs[1]).any())
    out["backtrack_skip"], counts, path = check_backtrack(
        tag, "backtrack_skip", decs, v_fin, acc, a, C,
        cuda_rescore.count_lanes(batch.mu.shape[1]), reps)
    out["backtrack_skip"]["counts_ms"] = counts["ms"]
    n_skips = count_skips(path, a["t_len"])
    assert n_skips > 0, f"{tag}: the skip paths hold no advance-by-2 step"
    out["backtrack_skip"]["advance_by_2_steps"] = n_skips
    del decs, path

    out["viterbi_fill_pair"] = check_pair_fill(tag, batch, a, B, reps)
    cfg_pair = nt.AlignConfig(band_width=B, dp_pair_step=True)
    # the single-step fill and the two-sample fill, each gathering its own
    # band levels, in turns on the same inputs
    cfg_single = nt.AlignConfig(band_width=B)
    turns = []
    for c in (cfg_single, cfg_pair, cfg_pair, cfg_single):
        turns.append(event_ms(lambda: cuda_dp.viterbi_fill(*rows, c), reps))
    out["viterbi_fill_pair"]["single_step_ms_in_turns"] = [turns[0], turns[3]]
    out["viterbi_fill_pair"]["pair_ms_in_turns"] = [turns[1], turns[2]]
    return out


def check_pair_fill(tag, batch, a, B: int, reps: int) -> dict:
    """The two-sample fill, gathering its own band levels, against the plain
    band gather and pair fill on the card: decision words, V and acc equal to
    the bit. Returns its numbers."""
    cfg_pair = nt.AlignConfig(band_width=B, dp_pair_step=True)
    rows = (a["x"], a["t_len"], a["mu"], a["sigma"], a["lo"], a["delta"], a["n_ref"])
    # per pair: three emissions (12), K0 K1 K2 (4), three sums, two maxima,
    # two compares, one add (8): 12 for each live cell
    nums, decs, _, _ = check_fill(
        tag, "viterbi_fill_pair", lambda: cuda_dp.viterbi_fill(*rows, cfg_pair),
        lambda: plain_fill(cuda_dp.viterbi_fill_pair_plain, rows, cfg_pair), batch,
        cfg_pair, ops_per_cell=12, reps=reps, exact=True)
    assert len(decs) == 1
    return nums


def bound(nbytes: int, ops: int) -> dict:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=nbytes, operations=ops)


def timed(fn):
    """(result, milliseconds) of one call ending in a synchronise."""
    box = {}
    ms = wall_ms(lambda: box.update(out=fn()))
    return box["out"], ms


def live_close(tag, got, want):
    """Largest difference over live values; dead slots (~-1e30 on both sides)
    must be dead on both."""
    live = want.abs() < 1e20
    assert bool((live == (got.abs() < 1e20)).all()), f"{tag}: dead slots differ"
    diff = ((got - want).abs() * live)
    tol = RESCORE_ATOL + RESCORE_RTOL * (want.abs() * live)
    assert bool((diff <= tol).all()), (
        f"{tag}: differs from its plain version by {float(diff.max())}")
    return float(diff.max())


def check_rescore_kernels(tag: str, batch, a, path, cnt, cfg, tables, reps: int,
                          exact: bool = False):
    """The two rescore tile kernels (K5 with tables, K6 without, each with K4
    folded in) against their plain versions on the card at this batch's
    shapes, on the path and counts the card's walk gave; with ``exact`` K5
    too to the bit (K6 always). Returns {kernel name: numbers}."""
    R, T = batch.x.shape
    L = batch.codes.shape[1]
    N = batch.ids.shape[1]
    k, t_w = cfg.k, cfg.snp_local_window
    x, t_len, codes = a["x"], a["t_len"], a["codes"]
    slab = T >= cuda_rescore.SPAN + 256
    out = {}

    # --- K5 with K4's gather and the tensor code around them: the same
    # operations in the same order as the plain composition
    local_args = (x, path, t_len, cnt, codes, a["woff"], tables.tab, tables.valid, N,
                  cfg, t_w)
    # the offsets' range from the host, as the pipeline hands it over
    kern = lambda: cuda_rescore.rescore_local_tab(*local_args,
                                                  woff_range=a["woff_range"])
    got = kern()
    sync()
    want, plain_ms = timed(lambda: cuda_rescore.rescore_local_tab_plain(*local_args))
    assert torch.equal(got == 0, want == 0), f"{tag}: rescore_local_tab masks differ"
    err = live_close(f"{tag}: rescore_local_tab", got, want)
    assert not exact or torch.equal(got, want), f"{tag}: rescore_local_tab differs"
    # what this run's data needs: the DP over the live samples of the
    # positions that are not masked (8 operations per cell and sample, 4 * k
    # cells), the samples of x and the inputs read once, the output written
    # once
    S, W, kk, p_lo, valid_i = cuda_rescore.local_windows(path, t_len, codes, N, k, t_w,
                                                         cnt)
    S_c = S.clamp(0, T - 1).contiguous()
    if slab:
        W = torch.where(cuda_rescore.span_ok(S_c, T), W, torch.zeros_like(W))
    cols = a["woff"].long()[:, None] + torch.arange(L, device="cuda")
    computed = valid_i & (kk == k) & tables.valid[cols] & (W > 0)
    n_cols = int(torch.unique(cols).numel())
    w_sum = int(W[computed].sum())
    ops = 8 * 4 * k * w_sum
    nbytes = (R * T * 4 + R * cnt.shape[1] * 4 + 2 * R * 4 + R * L * 4 + R * 4
              + n_cols * (3 * 4 * k * 4 + 1) + R * L * 4 * 4)
    out["rescore_local_tab"] = dict(
        max_abs_err=err, ms=event_ms(kern, reps), device_ms=device_ms(kern, reps),
        plain_ms=plain_ms, library_ms=None, **bound(nbytes, ops),
        instruction_floor_ms=ops / FP32_INSTR_PER_S * 1e3,
        live_samples=w_sum, positions_computed=int(computed.sum()),
        mean_window=w_sum / max(int(computed.sum()), 1), max_window=int(W.max()),
        slab_rule=slab, zero_share=float((want == 0).all(2).float().mean()))
    del got, want
    if slab:
        # a synthetic count row in which every odd read's tiles spread beyond
        # the slab: the span mask, which simulated reads hardly ever trip
        cnt_syn = cnt.clone()
        ramp = (torch.arange(cnt.shape[1], device="cuda", dtype=torch.int32) * 40)
        cnt_syn[1::2] = ramp.clamp(max=T - 1)
        syn_args = (x, path, t_len, cnt_syn) + local_args[4:]
        got = cuda_rescore.rescore_local_tab(*syn_args, woff_range=a["woff_range"])
        want = cuda_rescore.rescore_local_tab_plain(*syn_args)
        assert torch.equal(got == 0, want == 0), f"{tag}: span masks differ"
        live_close(f"{tag}: rescore_local_tab on broken tiles", got, want)
        masked = (want[1::2] == 0).all(2).float().mean()
        assert 0.0 < float(masked) < 1.0, float(masked)
        out["rescore_local_tab"]["broken_tile_zero_share_odd_reads"] = float(masked)
        del got, want
    # --- K4, folded into both tile kernels: no launch of its own. Its plain
    # version and the library's gather are timed on this batch's windows, its
    # bound is its own bytes, and its time is that of the tables kernel that
    # carries it on the main path (above); its exactness is the tile
    # kernels' (equal to the compositions that hold the plain gather)
    idx = (S_c.long()[:, :, None] + torch.arange(t_w, device="cuda")).clamp(0, T - 1)
    idx = idx.reshape(R, L * t_w)
    out["shear_gather"] = dict(
        max_abs_err=0.0, ms=out["rescore_local_tab"]["ms"],
        ms_of="the rescore_local_tab launch it is folded into",
        plain_ms=timed(lambda: cuda_rescore.shear_gather_plain(x, S_c, t_w,
                                                               slab=slab))[1],
        # yardstick: torch.gather with the prebuilt (R, L*t_w) index, plus the
        # transpose to (t_w, R, L)
        library_ms=event_ms(lambda: torch.gather(x, 1, idx).reshape(R, L, t_w)
                            .permute(2, 0, 1).contiguous(), 3, 1),
        **bound(t_w * R * L * 4 + R * T * 4 + R * L * 4 + R * (L // 128) * 4, 0))
    del idx
    out["rescore_local"] = check_rescore_local(
        f"{tag}: rescore_local", (x, path, t_len, cnt, codes, a["ids"], a["lm"], a["ls"],
                                  cfg, t_w), reps)
    return out


def check_rescore_local(tag, args, reps: int) -> dict:
    """The no-tables tile kernel against its plain version, the composition
    it replaces: equal to the bit. ``args`` are :func:`cuda_rescore.
    rescore_local`'s. Returns its numbers."""
    x, path, t_len, cnt, codes, ids, lm, ls, cfg, t_w = args
    R, T = x.shape
    L, N = codes.shape[1], ids.shape[1]
    k = cfg.k
    kern = lambda: cuda_rescore.rescore_local(*args)
    got = kern()
    sync()
    want, plain_ms = timed(lambda: cuda_rescore.rescore_local_plain(*args))
    assert torch.equal(got, want), (
        f"{tag}: differs from its plain version by {float((got - want).abs().max())}")
    # what this run's data needs: the DP over the live samples of the
    # positions that are not masked (8 operations per cell and sample, 4 * k
    # cells), x and the inputs read once (the ids, the three per-k-mer
    # vectors), the output written once
    S, W, kk, p_lo, valid_i = cuda_rescore.local_windows(path, t_len, codes, N, k, t_w,
                                                         cnt)
    S_c = S.clamp(0, T - 1)
    if T >= cuda_rescore.SPAN + 256:
        W = torch.where(cuda_rescore.span_ok(S_c, T), W, torch.zeros_like(W))
    _, _, _, slots_ok = cuda_rescore.batch_constants(p_lo, kk, codes, ids, lm, ls, k)
    computed = valid_i & (W > 0) & slots_ok
    assert not bool(((want != 0).any(2) & ~computed).any()), f"{tag}: masks differ"
    w_sum = int(W[computed].sum())
    ops = 8 * 4 * k * w_sum
    nbytes = (R * T * 4 + R * cnt.shape[1] * 4 + 2 * R * 4 + R * L * 4 + R * N * 4
              + 3 * lm.shape[0] * 4 + R * L * 4 * 4)
    return dict(max_abs_err=0.0, ms=event_ms(kern, reps), device_ms=device_ms(kern, reps),
                plain_ms=plain_ms, library_ms=None, **bound(nbytes, ops),
                instruction_floor_ms=ops / FP32_INSTR_PER_S * 1e3, live_samples=w_sum,
                positions_computed=int(computed.sum()), R=R, T=T, L=L,
                edge_positions_scored=int((computed & (kk < k)).sum()))


def check_k9_tiles(seed: int, small: bool, reps: int) -> dict:
    """The K = 9 instantiations of both rescore tile kernels, at the 9-mer
    cell's shape: reads simulated under ``KmerModel.synthetic(9)`` at 12.5
    samples a base, those that fit T = 22,016, band 256, t_w 192. The fill
    and the walk on the card give the path and its counts; with the launch
    counts zeroed just before, each tile kernel gives its plain version's
    (R, L, 4) result to the bit. Returns the shape and the two kernels'
    numbers."""
    model = nt.KmerModel.synthetic(k=K9)
    cfg = nt.AlignConfig(k=K9, band_width=256)
    n_reads, bases, R = (12, 400, 8) if small else (64, 1690, 32)
    rng = np.random.default_rng(seed + 9)
    sample = random_genome(rng, length=40_000)
    name = sample.contigs[0].name
    reads = [simulate_read(sample, name, model, rng, read_len=bases,
                           mean_dwell=K9_DWELL, read_id=f"k9_{i:03d}")
             for i in range(n_reads)]
    _, records = records_of(reads, sample, model, cfg)
    records = [r for r in records if len(r.signal) <= 22016][:R]
    assert len(records) == R, len(records)
    tables = build_subst_tables(sample, model, device="cuda")
    batch, a = staged_batch(records, model, cfg, subst=tables)
    if not small:
        assert batch.x.shape == (R, 22016), batch.x.shape
    res, _ = cuda_dp.cuda_viterbi_batch(
        a["x"], a["t_len"], a["mu"], a["sigma"], a["n_ref"], a["lo"], a["delta"], cfg,
        count_lanes=cuda_rescore.count_lanes(batch.mu.shape[1]))
    sync()
    reset_launches()
    nums = check_rescore_kernels("k9", batch, a, res.path, res.counts, cfg, tables,
                                 reps, exact=True)
    launches = read_launches()
    assert launches["rescore_local_tab"] > 0 and launches["rescore_local"] > 0, launches
    assert launches["viterbi_fill"] == 0, launches
    return {"R": R, "T": batch.x.shape[1], "B": cfg.band_width, "k": K9,
            "L": batch.codes.shape[1], "t_w": cfg.snp_local_window,
            "samples_a_base": K9_DWELL, "kernels": {
                n: nums[n] for n in ("rescore_local_tab", "rescore_local")}}


def check_span_mask(reps: int) -> dict:
    """``base_loglik_local_cuda`` without tables on a crafted batch in which
    two reads dwell long enough for a 128-position tile to spread over more
    than 2048 samples: the card masks exactly the positions the plain
    versions mask. The rows hold 2561 samples, so all but the first are not
    16-byte aligned and the threads copy the slab; there the no-tables kernel
    is also held against its plain version on the card, to the bit."""
    rng = np.random.default_rng(9)
    model = nt.default_model()
    cfg = nt.AlignConfig()
    k, R, L, T, t_w = model.k, 8, 256, 2561, 96
    N = L - k + 1
    codes = rng.integers(0, 4, (R, L)).astype(np.int32)
    ids = np.stack([nt.kmer_ids(c.astype(np.int8), k) for c in codes]).astype(np.int32)
    path = np.zeros((R, T), np.int32)
    t_len = np.zeros(R, np.int32)
    for r in range(R):
        dwell = rng.integers(4, 12, N)
        if r in (0, 5):
            dwell[30:50] = 100
        p = np.repeat(np.arange(N), dwell)[:T]
        t_len[r] = len(p)
        path[r, :len(p)] = p
        path[r, len(p):] = p[-1]
    arrs = [rng.normal(size=(R, T)).astype(np.float32), path, t_len, codes, ids,
            model.level_mean.astype(np.float32), model.level_std.astype(np.float32)]
    # no walk made this path: its counts come from the plain version
    cnt = cuda_dp.path_counts_plain(torch.from_numpy(path), cuda_rescore.count_lanes(N),
                                    torch.from_numpy(t_len))
    on = lambda dev: cuda_rescore.base_loglik_local_cuda(
        *(torch.from_numpy(v).to(dev) for v in arrs), k, cfg, t_w=t_w, cnt=cnt.to(dev))
    before = cuda_rescore.rescore_local.launches
    got, want = on("cuda").cpu(), on("cpu")
    assert cuda_rescore.rescore_local.launches == before + 1
    # the per-k-mer logs: torch.log on the card, on the CPU
    torch.testing.assert_close(got, want, rtol=RESCORE_RTOL, atol=RESCORE_ATOL)
    x_d, path_d, t_len_d, codes_d, ids_d, lm_d, ls_d = (torch.from_numpy(v).to("cuda")
                                                        for v in arrs)
    nums = check_rescore_local("T=2561: rescore_local", (
        x_d, path_d, t_len_d, cnt.to("cuda"), codes_d, ids_d, lm_d, ls_d, cfg, t_w), reps)
    t_short = np.minimum(t_len, 2303)
    cnt_short = cuda_dp.path_counts_plain(
        torch.from_numpy(np.ascontiguousarray(path[:, :2303])),
        cuda_rescore.count_lanes(N), torch.from_numpy(t_short))
    short = lambda dev: cuda_rescore.base_loglik_local_cuda(
        *(torch.from_numpy(np.ascontiguousarray(v[:, :2303]) if v.shape == (R, T)
                           else t_short if v is t_len else v).to(dev)
          for v in arrs), k, cfg, t_w=t_w, cnt=cnt_short.to(dev))
    unmasked = short("cuda").cpu()
    masked = (got == 0).all(2) & (unmasked != 0).any(2)
    assert masked[0].any() and masked[5].any() and not masked[1].any()
    return {"span_masked_positions": int(masked.sum()), "rescore_local_T2561": nums}


def check_argmax_tie() -> None:
    """The final slot is the FIRST maximum, as ``jnp.argmax`` gives it."""
    v = torch.full((4, 256), -3.0, device="cuda")
    v[0, 17] = v[0, 200] = 1.5          # two equal maxima: the first wins
    v[1, :] = 2.0                       # all equal: slot 0
    v[2, 255] = v[2, 254] = 0.25
    v[3, 5] = v[3, 6] = 9.0             # slot 5 is beyond the window: masked out
    acc = torch.zeros(4, device="cuda")
    lo_last = torch.zeros(4, dtype=torch.int32, device="cuda")
    n_ref = torch.tensor([256, 256, 256, 256], dtype=torch.int32, device="cuda")
    j_end, score = cuda_dp.final_slot_and_score(v, acc, lo_last, n_ref)
    assert j_end.tolist() == [17, 0, 254, 5], j_end.tolist()
    n_ref[3] = 5
    j_end, _ = cuda_dp.final_slot_and_score(v, acc, lo_last, n_ref)
    assert j_end.tolist()[3] == 0, j_end.tolist()
    assert score.tolist()[:3] == [1.5, 2.0, 0.25]


# -------------------------------------------------------- phase 4: main path
def run_api(reference, raws, fast5_dir, cfg, model, device, batch_reads):
    """call_snps and align_signal through the public entry points: from fast5
    files when h5py is there to write them, else from the reads in memory."""
    kw = dict(config=cfg, model=model, backend="cuda", batch_reads=batch_reads,
              prep="python", device=device)
    t0 = time.perf_counter()
    if fast5_dir is not None:
        calls = api.call_snps(reference, fast5_dir, **kw)
    else:
        calls = api.call_snps_reads(reference, raws, **kw)
    if device == "cuda":
        sync()
    t1 = time.perf_counter()
    if fast5_dir is not None:
        alns = api.align_signal(reference, fast5_dir, **kw)
    else:
        alns = api.align_reads(reference, raws, **kw)
    if device == "cuda":
        sync()
    t2 = time.perf_counter()
    return calls, alns, t1 - t0, t2 - t1


def stage_split(records, reference, raws, model, cfg, batch_reads, tables):
    """Milliseconds of each stage of one batch of the kernel path with the
    local rescore on the card, under ``cfg`` (fill and backtrack are the
    variants ``cfg`` selects)."""
    group = sorted(records, key=lambda r: len(r.signal))[-batch_reads:]
    ids = {r.read_id for r in group}
    t0 = time.perf_counter()
    api._preprocess([r for r in raws if r.read_id in ids], reference, model, cfg,
                    prep="python")
    prep_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = pipeline.assemble_batch(group, model, cfg)
    assemble_ms = (time.perf_counter() - t0) * 1e3
    st = {}
    split = {"host_prep": prep_ms, "assemble": assemble_ms}
    split["h2d"] = wall_ms(lambda: st.update(
        a=pipeline.stage_batch(batch, model, cfg, "cuda", device="cuda", subst=tables)))
    a = st["a"]
    C = cfg.signal_chunk
    k, t_w = cfg.k, cfg.snp_local_window
    # the fill with its band gather
    split["viterbi_fill"] = wall_ms(lambda: st.update(fill=cuda_dp.viterbi_fill(
        a["x"], a["t_len"], a["mu"], a["sigma"], a["lo"], a["delta"], a["n_ref"], cfg)))
    decs, v_fin, acc = st["fill"]
    split["final_slot"] = wall_ms(lambda: st.update(end=cuda_dp.final_slot_and_score(
        v_fin, acc, a["lo"][:, -1], a["n_ref"])))
    N = batch.ids.shape[1]
    # the walk with its counts epilogue, as the local rescore's path runs it
    split["backtrack"] = wall_ms(lambda: st.update(walk=cuda_dp.backtrack(
        decs, a["lo"], a["delta"], st["end"][0], C, t_len=a["t_len"],
        n_lanes=cuda_rescore.count_lanes(N))))
    path, cnt = st["walk"]
    # the local rescore as the pipeline calls it, then its one kernel on the
    # same inputs; what is left is the host code around the launch
    split["rescore_total"] = wall_ms(lambda: st.update(
        ll=cuda_rescore.base_loglik_local_cuda(
            a["x"], path, a["t_len"], a["codes"], a["ids"], a["lm"], a["ls"], k, cfg,
            t_w=t_w, tables=tables, window_off=a["woff"], cnt=cnt,
            window_off_range=a["woff_range"])))
    split["rescore_kernel"] = wall_ms(lambda: cuda_rescore.rescore_local_tab(
        a["x"], path, a["t_len"], cnt, a["codes"], a["woff"], tables.tab, tables.valid,
        N, cfg, t_w, woff_range=a["woff_range"]))
    split["rescore_host"] = split["rescore_total"] - split["rescore_kernel"]
    n = batch.n_reads
    G = len(reference.contigs[0])
    accs = callmod.make_accumulators(G, with_votes=True, device="cuda")
    dev = torch.device("cuda")
    ws, wl, sd = (torch.from_numpy(v[:n]).to(dev) for v in
                  (batch.window_start, batch.window_len, batch.strand))
    split["scatter"] = wall_ms(lambda: st.update(accs=callmod.accumulate_batch(
        accs[0], accs[1], st["ll"][:n], ws, wl, sd, votes=accs[2], cfg=cfg)))
    acc_g, cov_g, votes_g = (t.cpu().numpy() for t in st["accs"])
    t0 = time.perf_counter()
    callmod.call_snps(acc_g, cov_g, reference.contigs[0].codes,
                      reference.contigs[0].name, cfg, min_coverage=2, votes=votes_g)
    split["call"] = (time.perf_counter() - t0) * 1e3
    return batch, a, path, cnt, st["end"][1], st["ll"], split


def path_of(aln, n_samples: int) -> np.ndarray:
    """The per-sample window position of an alignment, rebuilt from its
    segments (-1 where no position holds the sample)."""
    p = np.full(n_samples, -1, np.int64)
    for pos in np.nonzero(aln.seg_start >= 0)[0]:
        p[aln.seg_start[pos]:aln.seg_end[pos]] = pos
    return p


def assert_agree(tag, card, cpu, ll_rtol, ll_atol, levels=None) -> int:
    """(calls, alignments) of the same entry points on the card and on the
    CPU (plain versions): calls equal, segments equal, scores and base
    log-likelihoods within tolerance.

    With ``levels`` ({read id: (mu, sigma)} of each read's window) a read's
    segments may differ where a sample sits on one or the other of two
    positions, at most 2 apart, with identical levels: a tie in exact
    arithmetic, which the last bit of the card's ``logf`` against the CPU's
    ``log`` can break either way. Such a read's base log-likelihoods are not
    compared (its local windows differ by that sample). Returns the number of
    such reads; any other difference fails."""
    (calls, alns), (c_calls, c_alns) = card, cpu
    assert len(alns) == len(c_alns) > 0, (tag, len(alns), len(c_alns))
    n_tied = 0
    for g, c in zip(alns, c_alns):
        assert g.read_id == c.read_id
        assert np.isfinite(g.score) and np.isfinite(g.base_loglik).all()
        assert abs(g.score - c.score) <= 2e-3 * max(1.0, abs(c.score)), (tag, g.read_id)
        # segments are the path on live samples: equal
        same = (np.array_equal(g.seg_start, c.seg_start)
                and np.array_equal(g.seg_end, c.seg_end))
        if not same and levels is not None:
            n = int(max(g.seg_end.max(), c.seg_end.max()))
            pa, pb = path_of(g, n), path_of(c, n)
            t = np.nonzero(pa != pb)[0]
            mu, sigma = levels[g.read_id]
            assert (pa[t] >= 0).all() and (pb[t] >= 0).all(), (tag, g.read_id)
            tie = ((mu[pa[t]] == mu[pb[t]]) & (sigma[pa[t]] == sigma[pb[t]])
                   & (np.abs(pa[t] - pb[t]) <= 2))
            assert tie.all(), (tag, g.read_id, int((~tie).sum()), len(t))
            n_tied += 1
            continue
        assert same, (tag, g.read_id)
        np.testing.assert_allclose(g.base_loglik, c.base_loglik, rtol=ll_rtol,
                                   atol=ll_atol, err_msg=f"{tag}: {g.read_id}")
    key = lambda c: (c.contig, c.position, c.ref_base, c.alt_base, c.coverage)
    assert [key(c) for c in calls] == [key(c) for c in c_calls], tag
    np.testing.assert_allclose([c.probability for c in calls],
                               [c.probability for c in c_calls], atol=1e-5)
    return n_tied


def expect_launches(tag, got, per_kernel) -> None:
    """Every kernel's count is what the path must give it; a kernel not named
    in ``per_kernel`` must not have been launched at all."""
    for name, n in got.items():
        want = per_kernel.get(name, 0)
        assert n == want, (tag, name, n, want, got)


def scores_close(tag, got, want, n) -> float:
    """Largest score difference over the first n reads, within 2e-3 relative to
    the score's size (float32 sums of ~1e4 terms)."""
    diff = (got[:n] - want[:n]).abs()
    tol = 2e-3 * want[:n].abs().clamp(min=1.0)
    assert bool((diff <= tol).all()), (tag, float(diff.max()))
    return float(diff.max())


def skip_phase(seed, model, n_reads, read_len, genome_len, batch_reads) -> dict:
    """This slice's path at full width: the skip configuration through the
    public entry points, on reads simulated with pore skips."""
    cfg = nt.AlignConfig(**SKIP_FIELDS)
    t0 = time.perf_counter()
    _, reference, reads, truth = make_world(seed + 2, genome_len, 20, n_reads,
                                            read_len, skip_prob=SKIP_PROB)
    raws, records = records_of(reads, reference, model, cfg)
    world_s = time.perf_counter() - t0
    n_batches = -(-len(records) // batch_reads)
    reset_launches()
    calls, alns, snp_s, aln_s = run_api(reference, raws, None, cfg, model, "cuda",
                                        batch_reads)
    launches = read_launches()
    expect_launches("skip", launches, {k: 2 * n_batches for k in (
        "band_gather_folded", "viterbi_fill_skip", "backtrack_skip", "path_counts",
        "rescore_local_tab", "shear_gather_folded")})
    assert len(alns) >= 0.9 * len(reads), (len(alns), len(reads))

    # (a) the same entry points on the CPU, where the plain versions run
    t0 = time.perf_counter()
    cpu = run_api(reference, raws, None, cfg, model, "cpu", batch_reads)[:2]
    assert read_launches() == launches, "a CPU run must not launch a kernel"
    levels = {r.read_id: (r.mu, r.sigma) for r in records}
    n_tied = assert_agree("skip", (calls, alns), cpu, RESCORE_RTOL, RESCORE_ATOL,
                          levels=levels)
    assert n_tied <= 0.05 * len(alns), (n_tied, len(alns))
    del cpu
    cpu_compare_s = time.perf_counter() - t0

    # (b) one batch stage by stage, and the scan twin under skip on the card
    tables = build_subst_tables(reference, model, device="cuda")
    batch, a, path, _, score, base_ll, split = stage_split(
        records, reference, raws, model, cfg, batch_reads, tables)
    n = batch.n_reads
    T = batch.x.shape[1]
    live = torch.arange(T, device="cuda")[None, :] < a["t_len"][:, None]
    live[n:] = False
    step = (path[:, 1:] - path[:, :-1])[live[:, 1:]]
    assert int(step.min()) >= 0 and int(step.max()) == 2, (int(step.min()), int(step.max()))
    n_skips = count_skips(path[:n], a["t_len"][:n])
    scan = pipeline.align_batch(
        batch, model, nt.AlignConfig(snp_rescore="fixed", **SKIP_FIELDS),
        backend="scan", device="cuda")
    # under skip the twin's emission is the Gaussian log-density written out,
    # not the kernel's em_const - d*d*inv2v, so more ties fall the other way
    n_tie = tie_only_differences("scan twin under skip", path, scan["path"], live,
                                 a["mu"], a["sigma"], max_share=1e-3)
    score_diff = scores_close("scan twin under skip", score, scan["score"], n)
    del scan, base_ll

    called = {c.position: c.alt_base for c in calls}
    tp = sum(1 for p, b in truth.items() if called.get(p) == b)
    recall = tp / max(len(truth), 1)
    assert recall >= MIN_RECALL, f"skip: only {tp} of {len(truth)} planted SNPs were called"
    return {"phase": "skip_path",
            "config": "AlignConfig(use_skip=True, log_p_skip=-4.6)",
            "skip_prob": SKIP_PROB, "reads": len(reads), "aligned": len(alns),
            "batches": n_batches, "batch_shape": list(batch.x.shape),
            "window_shape": list(batch.codes.shape),
            "world_seconds": round(world_s, 3),
            "call_snps_seconds": snp_s, "align_signal_seconds": aln_s,
            "reads_per_s_call_snps": len(alns) / snp_s,
            "launches": launches, "stage_ms_one_batch": split,
            "device_ms_one_batch": sum(split[k] for k in DEVICE_STAGES),
            "advance_by_2_steps_one_batch": n_skips,
            "live_samples_one_batch": int(live.sum()),
            "calls": len(calls), "planted": len(truth), "true_positive": tp,
            "recall": recall, "precision": tp / max(len(calls), 1),
            "cpu_plain_agrees_reads": len(alns) - n_tied,
            "cpu_plain_reads_differing_by_ties_only": n_tied,
            "cpu_compare_seconds": cpu_compare_s,
            "scan_on_card_tie_differences": n_tie,
            "scan_on_card_max_score_diff": score_diff}


# live samples of the smoke batch (seed 0) on which the two-sample fill's path
# differs from the single-step fill's: the TPU pair body's defect (ROADMAP.md,
# Queue 3), reproduced bit for bit since the first two-sample kernel
PAIR_DEFECT_ENTRIES_SEED0 = 2814


def pair_phase(reference, sub, model, batch_reads, expect_diff=None) -> dict:
    """``dp_pair_step=True`` on one batch: the two-sample fill (gathering its
    own band levels) through the entry point, and its result against the
    single-step kernel's; ``expect_diff``, where given, the number of path
    entries that must differ."""
    cfg, cfg_pair = nt.AlignConfig(), nt.AlignConfig(dp_pair_step=True)
    kw = dict(model=model, backend="cuda", batch_reads=batch_reads, prep="python",
              device="cuda")
    reset_launches()
    p_alns = api.align_reads(reference, sub, config=cfg_pair, **kw)
    sync()
    launches = read_launches()
    n_b = -(-len(p_alns) // batch_reads)
    expect_launches("pair", launches, {k: n_b for k in (
        "band_gather_folded", "viterbi_fill_pair", "backtrack", "path_counts",
        "rescore_local_tab", "shear_gather_folded")})
    s_alns = api.align_reads(reference, sub, config=cfg, **kw)
    assert [a.read_id for a in p_alns] == [a.read_id for a in s_alns]
    for p, q in zip(p_alns, s_alns):
        assert np.isfinite(p.base_loglik).all()
        assert abs(p.score - q.score) <= 2e-3 * max(1.0, abs(q.score)), p.read_id
    # paths: both fills carry the same values, but the two-sample body's
    # per-sample bits do not always walk the optimal path (ROADMAP.md,
    # Queue 3), so the differences are counted and bounded, not required to
    # be ties
    records = api._preprocess(sub, reference, model, cfg, prep="python")
    batch = pipeline.assemble_batch(
        sorted(records, key=lambda r: len(r.signal))[-batch_reads:], model, cfg)
    a = pipeline.stage_batch(batch, model, cfg, "cuda", device="cuda")
    dp = (a["x"], a["t_len"], a["mu"], a["sigma"], a["n_ref"], a["lo"], a["delta"])
    r_pair, _ = cuda_dp.cuda_viterbi_batch(*dp, cfg_pair)
    r_single, _ = cuda_dp.cuda_viterbi_batch(*dp, cfg)
    n = batch.n_reads
    live = torch.arange(batch.x.shape[1], device="cuda")[None, :] < a["t_len"][:, None]
    live[n:] = False
    diff = (r_pair.path != r_single.path) & live
    n_diff, n_live = int(diff.sum()), int(live.sum())
    assert n_diff <= 5e-3 * n_live, (n_diff, n_live)
    assert expect_diff is None or n_diff == expect_diff, (n_diff, expect_diff)
    r, t = torch.nonzero(diff, as_tuple=True)
    pa, pb = r_pair.path[r, t].long(), r_single.path[r, t].long()
    n_tie = int(((a["mu"][r, pa] == a["mu"][r, pb])
                 & (a["sigma"][r, pa] == a["sigma"][r, pb])).sum())
    return {"reads": len(sub), "launches": launches,
            "path_entries_differing_from_single_step": n_diff,
            "of_which_between_identical_levels": n_tie, "live_samples": n_live,
            "max_score_diff": scores_close("pair", r_pair.score, r_single.score, n)}


def joint_phase(reference, sub, model, batch_reads) -> dict:
    """The joint refiner through ``call_snps_reads`` on the card, and its pass
    alone on the card and on the CPU from the same accumulators and records."""
    key = lambda c: (c.contig, c.position, c.ref_base, c.alt_base, c.coverage)
    dev = torch.device("cuda")
    out = {}
    for name, fields in (("joint", dict(snp_joint_rescore=True)),
                         ("joint_skip", dict(snp_joint_rescore=True,
                                             snp_joint_skip=True))):
        cfg = nt.AlignConfig(**fields)
        sync()
        t0 = time.perf_counter()
        calls = api.call_snps_reads(reference, sub, config=cfg, model=model,
                                    backend="cuda", batch_reads=batch_reads,
                                    prep="python", device="cuda")
        sync()
        api_s = time.perf_counter() - t0
        records, accs = api._accumulate_reads(reference, sub, cfg, model, "cuda",
                                              batch_reads, 1, "python", dev)
        contig = reference.contigs[0]
        acc, cov, votes = (t.cpu().numpy() for t in accs[contig.name])
        metas = [joint.ReadMeta(r.read_id, r.anchor.contig, int(r.anchor.ref_start),
                                len(r.window_codes), int(r.anchor.strand))
                 for r in records]
        by_id = {r.read_id: r for r in records}
        plan = joint.cluster_plan(acc, cov, votes, contig.codes, cfg, min_coverage=2)
        assert plan, f"{name}: no candidate cluster to refine"
        seconds = {}
        lists = {}
        for where in ("cuda", "cpu"):
            t0 = time.perf_counter()
            lists[where] = joint.refine_contig_calls(
                acc, cov, votes, contig.codes, contig.name, cfg, model, metas, by_id,
                min_coverage=2, device=where)
            if where == "cuda":
                sync()
            seconds[where] = time.perf_counter() - t0
        assert [key(c) for c in lists["cuda"]] == [key(c) for c in lists["cpu"]], name
        assert [key(c) for c in calls] == [key(c) for c in lists["cuda"]], name
        np.testing.assert_allclose([c.probability for c in lists["cuda"]],
                                   [c.probability for c in lists["cpu"]], atol=1e-4)
        out[name] = {"reads": len(sub), "clusters": len(plan),
                     "hypothesis_rows": sum(
                         (1 + len(c.hyps)) * len(joint.reads_covering(c.span, metas, cfg.k))
                         for c in plan),
                     "calls": len(calls), "call_snps_seconds": api_s,
                     "joint_pass_seconds_card": seconds["cuda"],
                     "joint_pass_seconds_cpu": seconds["cpu"]}
    return out


# ------------------------------------- the single-core C++ core, long reads
# reads of the main world that the C++ core aligns and rescores
CPU_REF_READS = 16
# Queue 3 item 5 of the roadmap: reads above the last bucket edge (65,536
# samples), so that the batch pads to 131,072, at the long band
LONG_READS, LONG_BASES = 8, 8000


def cpu_ref_phase(records, model, cfg) -> dict:
    """The C++ core (``ops/cpu_ref``, one host core, one read at a time) on
    ``CPU_REF_READS`` reads of the main world: ms per read of its banded
    Viterbi and of its local rescore, and its paths against the card's
    kernels on the same reads and bands (per-sample ``lo`` expanded from the
    chunked bands): different on broken ties only."""
    from nadavca_tpu_torch.ops import cpu_ref

    batch, a = staged_batch(records[:CPU_REF_READS], model, cfg)
    res, _ = cuda_dp.cuda_viterbi_batch(a["x"], a["t_len"], a["mu"], a["sigma"],
                                        a["n_ref"], a["lo"], a["delta"], cfg)
    t0 = time.perf_counter()
    cpu_ref.get_lib()
    build_s = time.perf_counter() - t0
    T = batch.x.shape[1]
    lo_t = batch.bands.expand(T)
    paths = np.zeros((batch.x.shape[0], T), np.int32)
    vit_s = loc_s = 0.0
    for r in range(batch.n_reads):
        t, n = int(batch.t_len[r]), int(batch.n_ref[r])
        t0 = time.perf_counter()
        _, p = cpu_ref.banded_viterbi_cpu(batch.x[r, :t], batch.mu[r, :n],
                                          batch.sigma[r, :n], lo_t[r, :t],
                                          cfg.band_width, cfg.log_p_stay, cfg.log_p_move)
        t1 = time.perf_counter()
        cpu_ref.base_loglik_local_cpu(batch.x[r, :t], batch.codes[r, :batch.window_len[r]],
                                      p, model.level_mean, model.level_std, cfg.k,
                                      cfg.log_p_stay, cfg.log_p_move, cfg.snp_local_window)
        loc_s += time.perf_counter() - t1
        vit_s += t1 - t0
        paths[r, :t] = p
    live = torch.arange(T, device="cuda")[None, :] < a["t_len"][:, None]
    live[batch.n_reads:] = False
    # the core's float32 log-density rounds unlike the kernels' folded
    # polynomial, so a tie in a homopolymer run may fall the other way; every
    # difference must be such a tie. Readings: 0 of 157,684 live samples on
    # the card, 28 of 48,241 (5.8e-4) in a CPU rehearsal
    n_tie = tie_only_differences("C++ core against the card", res.path,
                                 torch.from_numpy(paths).to("cuda"), live, a["mu"],
                                 a["sigma"], max_share=CPU_REF_TIE_SHARE)
    n = batch.n_reads
    return {"phase": "cpu_ref", "reads": n, "mean_samples": float(batch.t_len[:n].mean()),
            "band_width": cfg.band_width, "t_w": cfg.snp_local_window,
            "build_or_load_seconds": build_s, "ms_per_read": (vit_s + loc_s) * 1e3 / n,
            "viterbi_ms_per_read": vit_s * 1e3 / n, "local_rescore_ms_per_read":
            loc_s * 1e3 / n, "host_cores": 1, "path_tie_differences_vs_card": n_tie,
            "live_samples": int(live.sum())}


def long_read_phase(seed, model, small=False) -> dict:
    """One batch of ``LONG_READS`` reads of ``LONG_BASES`` bases (above
    65,536 samples each; ``_bucket`` pads them to 131,072) at the long band
    through ``api.call_snps``, then the same batch at the pipeline level held
    against the ``scan`` twin on the card (paths equal but ties, the local
    rescore within 2e-3). Peak device memory of the call and the decision
    words' bytes. ``small``: reads of 1500 bases."""
    cfg = nt.AlignConfig(band_width=nt.AlignConfig().band_width_long)
    n_bases = 1500 if small else LONG_BASES
    t0 = time.perf_counter()
    _, ref, reads, _ = make_world(seed + 8, 4 * n_bases, 0, LONG_READS, n_bases)
    raws, records = records_of(reads, ref, model, cfg)
    world_s = time.perf_counter() - t0
    assert len(records) == LONG_READS, len(records)
    if not small:
        assert min(len(r.signal) for r in records) > 65536, [len(r.signal) for r in records]
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    calls = api.call_snps_reads(ref, raws, config=cfg, model=model, backend="cuda",
                                batch_reads=LONG_READS, prep="python", device="cuda")
    sync()
    api_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = read_launches()
    expect_launches("long reads", launches, {k: 1 for k in LOCAL_KERNELS})
    tables = build_subst_tables(ref, model, device="cuda")
    batch, a = staged_batch(records, model, cfg, subst=tables)
    if not small:
        assert batch.x.shape[1] == 131072, batch.x.shape
    N = batch.ids.shape[1]
    res, decs = cuda_dp.cuda_viterbi_batch(
        a["x"], a["t_len"], a["mu"], a["sigma"], a["n_ref"], a["lo"], a["delta"], cfg,
        count_lanes=cuda_rescore.count_lanes(N))
    dec_bytes = sum(d.numel() * d.element_size() for d in decs)
    del decs
    base_ll = cuda_rescore.base_loglik_local_cuda(
        a["x"], res.path, a["t_len"], a["codes"], a["ids"], a["lm"], a["ls"], cfg.k, cfg,
        t_w=cfg.snp_local_window, tables=tables, window_off=a["woff"], cnt=res.counts,
        window_off_range=a["woff_range"])
    t0 = time.perf_counter()
    twin = hold_against_scan("long reads against the scan twin", batch, a, res.path,
                             base_ll, model, cfg, ll_atol=2e-3, tie_share=LONG_TIE_SHARE)
    twin.pop("cmp")
    return {"phase": "long_reads", "reads": LONG_READS, "bases": n_bases,
            "samples": [len(r.signal) for r in records],
            "batch_shape": list(batch.x.shape), "window_shape": list(batch.codes.shape),
            "band_width": cfg.band_width, "world_seconds": world_s,
            "call_snps_seconds": api_s, "calls": len(calls), "launches": launches,
            "peak_device_mb_call": peak_mb, "decision_word_bytes": dec_bytes,
            "decision_word_bytes_rule": "R*T*B/8 per plane",
            "scan_twin": twin, "scan_twin_seconds": time.perf_counter() - t0}


# ------------------------------------------ the JAX package's own test worlds
# the most live samples on which the kernels' path may differ from the scan
# twin's by a tie in each cell of the accuracy sweep's quick grid (seed 7):
# the readings of the plain versions on the CPU (10, 10 and 42) with headroom
QUICK_CELL_TIES = (20, 20, 60)


def load_sweep():
    """``scripts/torch_accuracy_sweep.py`` as a module (its worlds and
    cells)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_accuracy_sweep.py")
    spec = importlib.util.spec_from_file_location("torch_accuracy_sweep", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["torch_accuracy_sweep"] = mod     # its dataclass resolves here
    spec.loader.exec_module(mod)
    return mod


def reference_worlds_phase(small=False) -> dict:
    """Worlds 1, 2, 3 and 5 of the JAX package's own tests
    (``utils/worlds.py``: an N run in the reference, a one-read batch padded
    to its tile, a window narrower than the band, 5 % indel basecalls) and the
    three cells of the accuracy sweep's quick grid (seed 7), each through the
    kernels with genome tables as ``api.call_snps`` runs them and held
    against the ``scan`` twin on the card (``parity.kernels_against_scan``):
    paths by the run rule within each world's limit, rescores within 2e-3
    where no tie moved a window (the positions a tie moved are counted),
    calls equal outside the tables' masks. ``small``: the first cell only."""
    from nadavca_tpu_torch.utils import worlds

    sweep = load_sweep()
    todo = [(name, build, limit) for name, (build, limit) in worlds.CARD_WORLDS.items()]
    cells = sweep.QUICK_GRID[:1] if small else sweep.QUICK_GRID
    for i, cell in enumerate(cells):
        todo.append((f"quick_cell_{i}", cell, QUICK_CELL_TIES[i]))
    out, n_batches = {}, 0
    t_phase = time.perf_counter()
    reset_launches()
    for name, build, limit in todo:
        t0 = time.perf_counter()
        if name.startswith("quick_cell"):
            model, ref, _, _, recs = sweep.prepare(build, 7)
            cfg = nt.AlignConfig()
            batches = [pipeline.assemble_batch(recs[j:j + sweep.BATCH_READS], model, cfg)
                       for j in range(0, len(recs), sweep.BATCH_READS)]
            w = dict(model=model, genome=ref, codes=ref["ref"].codes, cfg=cfg,
                     batches=batches, min_coverage=sweep.MIN_COV, votes=True)
        else:
            w = build()
        t1 = time.perf_counter()
        got = parity.kernels_against_scan(
            name, w["batches"], w["model"], w["cfg"], w["genome"], "cuda", limit,
            codes=w["codes"], min_coverage=w["min_coverage"], votes=w["votes"])
        sync()
        n_batches += len(w["batches"])
        out[name] = {"reads": sum(b.n_reads for b in w["batches"]),
                     "live_samples": sum(int(b.t_len[:b.n_reads].sum()) for b in w["batches"]),
                     "batch_shapes": [list(b.x.shape) for b in w["batches"]],
                     "tie_differences": got["tie_differences"],
                     "tie_limit": limit if isinstance(limit, int) else "samples in the N run",
                     "excluded_positions": got["excluded_positions"],
                     "compared_positions": got["compared_positions"],
                     "ll_max_abs_diff": got["ll_max_abs_diff"], "calls": len(got["calls"]),
                     "world_seconds": t1 - t0, "seconds": time.perf_counter() - t1}
        del got          # the kernels' outputs of the world, on the card
    launches = read_launches()
    expect_launches("reference worlds", launches, {k: n_batches for k in LOCAL_KERNELS})
    return {"phase": "reference_worlds", "worlds": out, "launches": launches,
            "seconds": time.perf_counter() - t_phase}


# --------------------------------------------------- phase 6: the command line
# prep threads of the CLI phase (the card's host has 8 cores)
CLI_WORKERS = min(8, os.cpu_count() or 1)
# the kernels one batch of the default configuration launches: the band
# gather runs inside the fill, K4's gather and the glue inside the rescore,
# so neither has a launch of its own
LOCAL_KERNELS = ("band_gather_folded", "viterbi_fill", "backtrack", "path_counts",
                 "rescore_local_tab", "shear_gather_folded")
# the kernels one batch of `align` launches: the files hold segments only
ALIGN_KERNELS = ("band_gather_folded", "viterbi_fill", "backtrack")


def run_cli(argv, raws) -> tuple:
    """``cli.main(argv, reads=raws)``: (seconds, the run's metrics line)."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv, reads=raws)
    secs = time.perf_counter() - t0
    assert rc == 0, (argv, err.getvalue()[-2000:])
    line = [l for l in err.getvalue().splitlines() if l.startswith("[metrics] ")][-1]
    return secs, json.loads(line[len("[metrics] "):])


def vcf_rows(path) -> list:
    """(contig, pos0, ref, alt, coverage, posterior) of each VCF record."""
    rows = []
    for line in open(path):
        if line.startswith("#"):
            continue
        c = line.rstrip("\n").split("\t")
        dp, pp = c[7].split(";")
        rows.append((c[0], int(c[1]) - 1, c[3], c[4], int(dp[3:]), float(pp[3:])))
    return rows


def vcf_body(path) -> list:
    return [l for l in open(path) if not l.startswith("##")]


def batches_of(m) -> dict:
    """Batches of the run by band width, from the CLI's counters."""
    return {int(k.rsplit("_", 1)[1]): int(v) for k, v in m["counters"].items()
            if k.startswith("batches_band_")}


def recall_of(rows, truth) -> int:
    called = {r[1]: r[3] for r in rows}
    return sum(1 for p, b in truth.items() if called.get(p) == b)


def same_calls(tag, got, want, pp_atol) -> None:
    """The same calls and coverage; posteriors within ``pp_atol`` (the card
    adds with atomics, so float sums may differ in their last bits)."""
    assert [g[:5] for g in got] == [w[:5] for w in want], (tag, got, want)
    assert all(abs(g[5] - w[5]) <= pp_atol for g, w in zip(got, want)), tag


def segments_of_file(path, n_pos):
    seg_start = np.full(n_pos, -1, np.int64)
    seg_end = np.full(n_pos, -1, np.int64)
    for line in open(path).read().splitlines()[1:]:
        i, a, b = (int(v) for v in line.split("\t"))
        seg_start[i], seg_end[i] = a, b
    return types.SimpleNamespace(seg_start=seg_start, seg_end=seg_end)


def prep_ms_per_read(reference, model, cfg, raws, mode, workers) -> float:
    work = pipeline.make_preprocessor(reference, cfg, model, mode=mode)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(work, raws))
    return (time.perf_counter() - t0) * 1e3 / len(raws)


def cli_phase(seed, model, reference, raws, records, api_calls, truth,
              batch_reads) -> dict:
    """The command line in one process on the card, as users run it, every
    run through ``cli.main([...], reads=...)`` with ``--backend cuda
    --device cuda``: ``snp`` and ``align`` on the main path's reads (native
    prep on CLI_WORKERS threads, then Python prep on one), the adaptive band
    on reads of mixed length, checkpoint and resume, and the native prep
    against the Python prep on the card's host."""
    cfg = nt.AlignConfig()
    W = CLI_WORKERS
    t0 = time.perf_counter()
    prep_native.get_lib()                    # g++ builds csrc/prep.cpp here
    out = {"phase": "cli", "workers": W,
           "prep_native_build_seconds": time.perf_counter() - t0}
    api_rows = [(c.contig, c.position, c.ref_base, c.alt_base, c.coverage,
                 c.probability) for c in api_calls]
    api_tp = recall_of(api_rows, truth)
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "reference.fasta")
        reference.to_fasta(ref)
        base = [ref, "(in memory)", "--backend", "cuda", "--device", "cuda",
                "--batch-reads", str(batch_reads)]
        snp = ["snp", *base, "--min-coverage", "2"]

        # (1) snp: the main path's kernels, the api's calls
        runs = {}
        for name, prep, workers in (("snp_native", "native", W),
                                    ("snp_python", "python", 1)):
            vcf = os.path.join(tmp, f"{name}.vcf")
            reset_launches()
            secs, m = run_cli(snp + ["-o", vcf, "--prep", prep,
                                     "--workers", str(workers)], raws)
            launches = read_launches()
            n_b = sum(batches_of(m).values())
            expect_launches(f"cli {name}", launches, {k: n_b for k in LOCAL_KERNELS})
            rows = vcf_rows(vcf)
            same_calls(f"cli {name} against the api", rows, api_rows, 1e-5)
            tp = recall_of(rows, truth)
            assert tp >= api_tp, (name, tp, api_tp)
            runs[name] = rows
            out[name] = {"prep": prep, "workers": workers, "seconds": secs,
                         "reads": len(raws),
                         "reads_per_s": m["counters"]["reads_called"] / secs,
                         "batches_by_band": batches_of(m), "launches": launches,
                         "calls": len(rows), "true_positive": tp,
                         "planted": len(truth), "api_true_positive": api_tp,
                         "metrics": m}

        # (2) align: each file is the alignment api.align_reads gives the read
        # (with the same prep), or differs from it by broken ties between
        # identical levels only
        aln_dir = os.path.join(tmp, "aln")
        reset_launches()
        secs, m = run_cli(["align", *base, "-o", aln_dir, "--prep", "native",
                           "--workers", str(W)], raws)
        launches = read_launches()
        expect_launches("cli align", launches,
                        {k: sum(batches_of(m).values()) for k in ALIGN_KERNELS})
        api_alns = api.align_reads(reference, raws, config=cfg, model=model,
                                   backend="cuda", batch_reads=batch_reads,
                                   prep="native", device="cuda")
        assert sorted(os.listdir(aln_dir)) == sorted(f"{a.read_id}.txt" for a in api_alns)
        levels = {r.read_id: (r.mu, r.sigma) for r in records}
        want = os.path.join(tmp, "want.txt")
        n_tied = n_tie_samples = 0
        for a in api_alns:
            got = os.path.join(aln_dir, f"{a.read_id}.txt")
            callmod.write_alignment(want, a.read_id, a.contig, a.strand, a.ref_start,
                                    a.ref_end, a.seg_start, a.seg_end)
            if open(got).read() == open(want).read():
                continue
            g = segments_of_file(got, len(a.seg_start))
            n = int(max(g.seg_end.max(), a.seg_end.max()))
            pa = torch.from_numpy(path_of(g, n))[None]
            pb = torch.from_numpy(path_of(a, n))[None]
            mu, sigma = (torch.from_numpy(v)[None] for v in levels[a.read_id])
            n_tie_samples += tie_only_differences(
                f"cli align {a.read_id}", pa, pb, (pa >= 0) & (pb >= 0), mu, sigma,
                max_share=0.05)
            n_tied += 1
        assert n_tied <= 0.05 * len(api_alns), n_tied
        out["align"] = {"seconds": secs, "reads_per_s_e2e": m["gauges"]["reads_per_s_e2e"],
                        "files": len(api_alns), "launches": launches,
                        "files_equal_to_api": len(api_alns) - n_tied,
                        "files_differing_by_ties_only": n_tied,
                        "tie_samples": n_tie_samples}

        # (3) the adaptive band: reads of 300 and 1800 bases (~2.9k and ~18k
        # samples); the long bucket runs at band_width_long on the card, with
        # the calls of the same run on the CPU (the plain versions)
        _, ref_m, reads_m, truth_m = make_world(seed + 6, 6000, 2, 32, (300, 1800))
        raws_m = [api.raw_read_from_simulated(r) for r in reads_m]
        assert max(len(r.signal) for r in reads_m) > cfg.adaptive_band_threshold
        ref_mp = os.path.join(tmp, "mixed.fasta")
        ref_m.to_fasta(ref_mp)
        band = {}
        for where in ("cuda", "cpu"):
            vcf = os.path.join(tmp, f"mixed_{where}.vcf")
            reset_launches()
            secs, m = run_cli(["snp", ref_mp, "(in memory)", "--backend", "cuda",
                               "--device", where, "--min-coverage", "2",
                               "--workers", str(W), "-o", vcf], raws_m)
            band[where] = {"seconds": secs, "batches_by_band": batches_of(m),
                           "launches": read_launches(), "rows": vcf_rows(vcf)}
        assert band["cuda"]["batches_by_band"].get(cfg.band_width_long, 0) >= 1, band
        assert band["cuda"]["batches_by_band"] == band["cpu"]["batches_by_band"]
        expect_launches("cli adaptive band", band["cuda"]["launches"],
                        {k: sum(band["cuda"]["batches_by_band"].values())
                         for k in LOCAL_KERNELS})
        assert not any(band["cpu"]["launches"].values()), "a CPU run launched a kernel"
        same_calls("adaptive band, card against CPU", band["cuda"]["rows"],
                   band["cpu"]["rows"], 1e-5)
        out["adaptive_band"] = {
            "reads": len(raws_m), "read_lengths": [300, 1800],
            "samples_max": max(len(r.signal) for r in reads_m),
            "batches_by_band": band["cuda"]["batches_by_band"],
            "launches": band["cuda"]["launches"], "calls": len(band["cuda"]["rows"]),
            "true_positive": recall_of(band["cuda"]["rows"], truth_m),
            "planted": len(truth_m), "seconds_card": band["cuda"]["seconds"],
            "seconds_cpu": band["cpu"]["seconds"]}

        # (4) checkpoint and resume: a run that saves after every batch, then
        # a resumed run that finds every read merged (its VCF from the saved
        # accumulators, byte for byte); and a run cut after the first half of
        # the reads, resumed over all of them (the api's calls)
        ck = os.path.join(tmp, "state.npz")
        full, again = os.path.join(tmp, "ck_full.vcf"), os.path.join(tmp, "ck_again.vcf")
        run_cli(snp + ["-o", full, "--checkpoint", ck, "--checkpoint-every", "1",
                       "--workers", str(W)], raws)
        _, m = run_cli(snp + ["-o", again, "--checkpoint", ck, "--workers", str(W)], raws)
        assert vcf_body(again) == vcf_body(full)
        assert m["counters"]["reads_ingested"] == 0
        ck2 = os.path.join(tmp, "cut.npz")
        cut, resumed = os.path.join(tmp, "cut.vcf"), os.path.join(tmp, "resumed.vcf")
        half = len(raws) // 2
        _, m_cut = run_cli(snp + ["-o", cut, "--checkpoint", ck2, "--checkpoint-every",
                                  "1", "--workers", str(W)], raws[:half])
        _, m_res = run_cli(snp + ["-o", resumed, "--checkpoint", ck2,
                                  "--workers", str(W)], raws)
        assert m_res["counters"]["reads_resumed_skip"] == m_cut["counters"]["reads_called"]
        same_calls("resumed after a cut", vcf_rows(resumed), api_rows, 1e-5)
        out["checkpoint"] = {"resumed_equals_uninterrupted_bytes": True,
                             "cut_after_reads": half,
                             "resumed_skipped": m_res["counters"]["reads_resumed_skip"],
                             "resumed_ingested": m_res["counters"]["reads_ingested"],
                             "calls": len(vcf_rows(resumed))}

    # (5) the native prep against the Python prep on this host: anchors,
    # paths and windows exact, the calibrated signal to float tolerance
    # (tests/test_prep_native.py); then ms per read of each, 1 and W threads
    work = pipeline.make_preprocessor(reference, cfg, model, mode="native")
    by_id = {r.read_id: r for r in records}
    n_ok = 0
    for raw in raws:
        nt_rec, py = work(raw), by_id.get(raw.read_id)
        assert (nt_rec is None) == (py is None), raw.read_id
        if py is None:
            continue
        n_ok += 1
        assert (nt_rec.anchor.contig, nt_rec.anchor.strand, nt_rec.anchor.ref_start,
                nt_rec.anchor.ref_end, nt_rec.anchor.score) == (
            py.anchor.contig, py.anchor.strand, py.anchor.ref_start,
            py.anchor.ref_end, py.anchor.score), raw.read_id
        for f in ("window_codes", "anchor_path", "mu", "sigma"):
            assert np.array_equal(getattr(nt_rec, f), getattr(py, f)), (raw.read_id, f)
        np.testing.assert_allclose(nt_rec.signal, py.signal, rtol=1e-5, atol=2e-5)
    out["prep_parity"] = {"reads": len(raws), "anchored": n_ok}
    out["prep_ms_per_read"] = {
        f"{mode}_{w}_threads": prep_ms_per_read(reference, model, cfg, raws, mode, w)
        for mode in ("native", "python") for w in (1, W)}
    return out


# ------------------------------------------------ phase 7: several devices
# ranks of the process-group parts, all on the one card (gloo: NCCL takes
# one rank a card)
MD_RANKS = 2
# the accumulator's tolerance against one device (tests/test_sharded.py);
# cov and votes are integer sums and must be exact
MD_ACC_TOL = dict(rtol=1e-4, atol=1e-2)
# config 4 of the JAX package's BASELINE.json: a whole bacterial genome
# (--small: a cut genome, its layout set by flag)
CONFIG4_GENOME, CONFIG4_SMALL = 4_600_000, 60_000
# the longest a spawned rank may take
RANK_TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def cli_rank(argv, raws, q) -> None:
    """One spawned rank: ``cli.main(argv, reads=raws)``; puts (process id,
    return code, stderr, launches) on ``q``, or the traceback."""
    err = io.StringIO()
    rank = int(argv[argv.index("--process-id") + 1])
    try:
        reset_launches()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv, reads=raws)
        q.put((rank, rc, err.getvalue(), read_launches()))
    except BaseException:
        q.put((rank, 1, err.getvalue() + traceback.format_exc(), {}))
        raise


def run_ranks(argv, raws, n=MD_RANKS):
    """``cli snp`` in n spawned ranks of one gloo group on the card, every
    rank given all the reads (each keeps its share). Returns (seconds, per
    rank: its metrics line and launches). Every rank is stopped before it
    returns; a rank that failed or did not answer raises."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=cli_rank, args=(
        argv + ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                "--process-id", str(i)], raws, q)) for i in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(n):
            rank, rc, err, launches = q.get(timeout=RANK_TIMEOUT_S)
            assert rc == 0, (rank, err[-3000:])
            line = [l for l in err.splitlines() if l.startswith("[metrics] ")][-1]
            out[rank] = {"metrics": json.loads(line[len("[metrics] "):]),
                         "launches": launches}
        secs = time.perf_counter() - t0
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return secs, [out[i] for i in range(n)]


def rank_summary(ranks) -> list:
    return [{"reads": r["metrics"]["counters"]["reads_called"],
             "tables_build_s": r["metrics"]["gauges"]["subst_build_s"],
             "merge_s": r["metrics"]["gauges"]["merge_s"],
             "reads_per_s": r["metrics"]["gauges"]["reads_per_s"],
             "peak_device_mb": r["metrics"]["gauges"]["peak_device_mb"],
             "viterbi_fill_launches": r["launches"].get("viterbi_fill", 0)}
            for r in ranks]


def sharded_part(reference, model, records, cfg, batch_reads, tables) -> dict:
    """(a) ``parallel.sharded`` on the mesh [cuda:0, cuda:0]: the main
    world's batches split in two blocks of rows, in each layout, against one
    device; merging the deferred partials twice gives the same result."""
    G = len(reference.contigs[0])
    order = sorted(records, key=lambda r: len(r.signal))
    batches = [pipeline.assemble_batch(order[i:i + batch_reads], model, cfg,
                                       pad_reads_to=batch_reads)
               for i in range(0, len(order), batch_reads)]
    codes = reference.contigs[0].codes

    def run(mesh, gs, md):
        Gp = -(-G // (mesh.size * 128)) * mesh.size * 128 if gs else G
        reps = sharded.replicate_tables(mesh, tables)
        accs = sharded.make_accumulators_sharded(mesh, Gp, gs, md)
        step = sharded.make_sharded_step(mesh, cfg, Gp, gs, with_path=False,
                                         merge_deferred=md)
        reset_launches()
        t0 = time.perf_counter()
        for b in batches:
            _, *accs = step(sharded.shard_batch(mesh, b, model, cfg, "cuda", reps), *accs)
        sync()
        secs = time.perf_counter() - t0
        launches = read_launches()
        same_merge = None
        if md:
            merge = sharded.make_merge_fn(mesh, Gp, gs)
            m1, m2 = merge(*accs), merge(*accs)
            same_merge = all(torch.equal(x, y) for a, b in zip(m1, m2)
                             for x, y in zip(a, b))
            assert same_merge, "merging the partials twice differs"
            accs = m1
        acc, cov, votes = (sharded.fetch(mesh, a, gs)[:G] for a in accs)
        calls = callmod.call_snps(acc, cov, codes, reference.contigs[0].name, cfg,
                                  min_coverage=2, votes=votes)
        return dict(acc=acc, cov=cov, votes=votes, calls=calls, seconds=secs,
                    launches=launches, merge_twice_equal=same_merge)

    one = run(sharded.make_mesh(1, "cuda"), False, False)
    mesh2 = sharded.Mesh((torch.device("cuda", 0),) * 2)
    out = {"mesh": ["cuda:0", "cuda:0"], "batches": len(batches),
           "rows_per_block": batch_reads // 2, "one_device_seconds": one["seconds"],
           "calls": len(one["calls"]), "one_device": (one["acc"], one["cov"], one["votes"]),
           "batches_of_world": batches}
    key = lambda c: (c.position, c.ref_base, c.alt_base, c.coverage)
    for name, gs, md in (("replicated", False, False), ("genome_sharded", True, False),
                         ("deferred", False, True)):
        got = run(mesh2, gs, md)
        n_fill = got["launches"]["viterbi_fill"]
        assert n_fill == 2 * len(batches), (name, got["launches"])
        assert np.array_equal(got["cov"], one["cov"]), name
        assert np.array_equal(got["votes"], one["votes"]), name
        np.testing.assert_allclose(got["acc"], one["acc"], **MD_ACC_TOL)
        assert [key(c) for c in got["calls"]] == [key(c) for c in one["calls"]], name
        assert all(abs(a.probability - b.probability) <= 1e-5
                   for a, b in zip(got["calls"], one["calls"])), name
        out[name] = {"seconds": got["seconds"], "launches": got["launches"],
                     "cov_equal": int((got["cov"] == one["cov"]).sum()),
                     "votes_equal": int((got["votes"] == one["votes"]).all(1).sum()),
                     "positions": G,
                     "acc_max_abs_diff": float(np.abs(got["acc"] - one["acc"]).max()),
                     "calls_equal": len(got["calls"]),
                     "merge_twice_equal": got["merge_twice_equal"]}
    return out


# (d): the local devices of each rank, all on the one card
MD_LOCAL = 2
MD_LAYOUTS = (("replicated", False, False), ("genome_sharded", True, False),
              ("deferred", False, True))


def _count_wire_bytes(box: list) -> None:
    """Add the bytes handed to each collective of this process to box[0]."""
    import torch.distributed as tdist

    def counted(fn):
        def call(*args, **kw):
            t = args[-1] if fn.__name__ == "reduce_scatter_tensor" else args[0]
            if isinstance(t, list):
                t = t[0]
            box[0] += t.numel() * t.element_size()
            return fn(*args, **kw)
        return call

    for name in ("all_reduce", "reduce_scatter_tensor", "all_gather"):
        setattr(tdist, name, counted(getattr(tdist, name)))


def group_rank(rank, port, batches, model, reference, q) -> None:
    """One spawned rank of part (d): the rank's rows of each batch on its
    ``MD_LOCAL`` mesh positions ([cuda:0, cuda:0]) of a gloo group of
    ``MD_RANKS`` ranks, through ``parallel.sharded`` in each layout. Puts
    (rank, per layout: seconds, launches, bytes, the merged accumulators)
    on ``q``, or the traceback."""
    from nadavca_tpu_torch.parallel import distributed as dist

    try:
        devs = dist.initialize_distributed(f"127.0.0.1:{port}", MD_RANKS, rank,
                                           "cuda", n_local=MD_LOCAL)
        assert torch.distributed.get_backend() == "gloo"
        wire = [0]
        _count_wire_bytes(wire)
        mesh = sharded.process_mesh(devs)
        cfg = nt.AlignConfig()
        G = len(reference.contigs[0])
        reps = sharded.replicate_tables(mesh, build_subst_tables(reference, model,
                                                                 device="cuda"))
        out = {}
        for name, gs, md in MD_LAYOUTS:
            Gp = -(-G // (mesh.size * 128)) * mesh.size * 128 if gs else G
            accs = sharded.make_accumulators_sharded(mesh, Gp, gs, md)
            step = sharded.make_sharded_step(mesh, cfg, Gp, gs, with_path=False,
                                             merge_deferred=md)
            reset_launches()
            sync()
            w0, t0 = wire[0], time.perf_counter()
            for b in batches:
                r = b.x.shape[0] // MD_RANKS
                rows = pipeline.batch_rows(b, rank * r, (rank + 1) * r)
                _, *accs = step(sharded.shard_batch(mesh, rows, model, cfg, "cuda", reps),
                                *accs)
            sync()
            secs, step_bytes = time.perf_counter() - t0, wire[0] - w0
            launches = read_launches()
            w0, t0 = wire[0], time.perf_counter()
            if md:
                merge = sharded.make_merge_fn(mesh, Gp, gs)
                m1, m2 = merge(*accs), merge(*accs)
                assert all(torch.equal(x, y) for a, b in zip(m1, m2)
                           for x, y in zip(a, b)), "merging the partials twice differs"
                accs = m1
            got = [sharded.fetch(mesh, a, gs)[:G] for a in accs]
            out[name] = {"seconds": secs, "launches": launches, "Gp": Gp,
                         "bytes_per_batch": step_bytes / len(batches),
                         "merge_fetch_seconds": time.perf_counter() - t0,
                         "merge_fetch_bytes": wire[0] - w0, "accs": got}
        torch.distributed.destroy_process_group()
        q.put((rank, out))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise


def group_part(model, reference, batches, one) -> dict:
    """(d) ``parallel.sharded`` under a process group whose ranks drive
    several devices: ``MD_RANKS`` spawned gloo ranks, each with the mesh
    [cuda:0, cuda:0], run the main world's batches in each layout against
    one device (``one``: acc, cov, votes). Gates: ``cov`` and ``votes``
    exact, ``acc`` within ``MD_ACC_TOL`` on every rank, the deferred merge
    pure, ``viterbi_fill`` launched at least once a position and batch."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=group_rank, args=(r, port, batches, model, reference, q))
             for r in range(MD_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(MD_RANKS):
            rank, res = q.get(timeout=RANK_TIMEOUT_S)
            assert isinstance(res, dict), (rank, res[-3000:])
            got[rank] = res
        secs = time.perf_counter() - t0
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    out = {"ranks": MD_RANKS, "positions_per_rank": MD_LOCAL,
           "mesh_per_rank": ["cuda:0"] * MD_LOCAL, "backend": "gloo",
           "batches": len(batches), "rows_per_position": batches[0].x.shape[0]
           // (MD_RANKS * MD_LOCAL), "seconds_with_process_start": secs}
    for name, _, _ in MD_LAYOUTS:
        per = [got[r][name] for r in range(MD_RANKS)]
        for r, res in enumerate(per):
            acc, cov, votes = res["accs"]
            assert np.array_equal(cov, one[1]), (name, r, "cov")
            assert np.array_equal(votes, one[2]), (name, r, "votes")
            np.testing.assert_allclose(acc, one[0], **MD_ACC_TOL)
            n_fill = res["launches"]["viterbi_fill"]
            assert n_fill >= MD_LOCAL * len(batches), (name, r, res["launches"])
        out[name] = {
            "Gp": per[0]["Gp"],
            "seconds": [res["seconds"] for res in per],
            "gloo_bytes_per_batch": [res["bytes_per_batch"] for res in per],
            "merge_fetch_seconds": [res["merge_fetch_seconds"] for res in per],
            "merge_fetch_gloo_bytes": [res["merge_fetch_bytes"] for res in per],
            "viterbi_fill_launches": [res["launches"]["viterbi_fill"] for res in per],
            "cov_equal": int((per[0]["accs"][1] == one[1]).sum()),
            "acc_max_abs_diff": max(float(np.abs(res["accs"][0] - one[0]).max())
                                    for res in per)}
    return out


def multi_device_phase(seed, model, reference, raws, records, batch_reads,
                       smi, small=False) -> dict:
    """Several devices on the one card: (a) the sharded step in one process,
    (b) the CLI in two processes against one process, with a checkpoint and
    a resume, (c) config 4's 4.6 Mb genome in two processes, genome-sharded
    with deferred merges (both chosen by ``auto``), against one process.
    Two ranks on one card check the protocol; they are no scaling number.
    ``small`` cuts (c)'s genome and sets its layout by flag."""
    cfg = nt.AlignConfig()
    W = max(1, CLI_WORKERS // MD_RANKS)
    out = {"phase": "multi_device", "nvidia_smi": smi, "ranks": MD_RANKS,
           "backend": "gloo"}
    t0 = time.perf_counter()
    tables = build_subst_tables(reference, model, device="cuda")
    out["a_sharded"] = sharded_part(reference, model, records, cfg, batch_reads, tables)
    del tables
    out["a_sharded"]["seconds"] = time.perf_counter() - t0
    one = out["a_sharded"].pop("one_device")
    batches = out["a_sharded"].pop("batches_of_world")
    # (d) two ranks of two positions each against the same one device
    t0 = time.perf_counter()
    out["d_group_of_two_devices_a_rank"] = group_part(model, reference, batches, one)
    out["d_group_of_two_devices_a_rank"]["seconds"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the main world through the CLI: one process, then two ranks
        # that save after every round, then two that resume
        t0 = time.perf_counter()
        ref = os.path.join(tmp, "reference.fasta")
        reference.to_fasta(ref)
        base = ["snp", ref, "(in memory)", "--backend", "cuda", "--device", "cuda",
                "--batch-reads", str(batch_reads), "--min-coverage", "2",
                "--workers", str(W)]
        one_vcf, mh_vcf, again_vcf = (os.path.join(tmp, f) for f in
                                      ("one.vcf", "mh.vcf", "again.vcf"))
        one_s, _ = run_cli(base + ["-o", one_vcf], raws)
        ck = os.path.join(tmp, "mh.npz")
        mh_s, ranks = run_ranks(base + ["-o", mh_vcf, "--checkpoint", ck,
                                        "--checkpoint-every", "1"], raws)
        assert os.path.exists(ck) and os.path.exists(ck + ".p1")
        res_s, res_ranks = run_ranks(base + ["-o", again_vcf, "--checkpoint", ck], raws)
        one_body, mh_body = vcf_body(one_vcf), vcf_body(mh_vcf)
        assert mh_body == one_body, "two ranks: another VCF than one process"
        assert vcf_body(again_vcf) == mh_body, "resumed: another VCF"
        assert sum(r["metrics"]["counters"]["reads_resumed_skip"]
                   for r in res_ranks) == sum(r["metrics"]["counters"]["reads_called"]
                                              for r in ranks)
        assert all(r["launches"].get("viterbi_fill", 0) >= 1 for r in ranks)
        out["b_cli_two_processes"] = {
            "reads": len(raws), "one_process_seconds": one_s,
            "two_ranks_seconds": mh_s, "resume_seconds": res_s,
            "vcf_records": len(one_body) - 1, "vcf_bytes_equal": True,
            "resumed_vcf_bytes_equal": True, "ranks": rank_summary(ranks),
            "seconds": time.perf_counter() - t0}

        # (c) config 4: 512 reads of 1000 bases over a 4.6 Mb genome;
        # genome-sharded (auto: G >= 2**22) with deferred merges (auto)
        t0 = time.perf_counter()
        G4 = CONFIG4_SMALL if small else CONFIG4_GENOME
        _, ref4, reads4, _ = make_world(seed + 7, G4, 0, len(raws), 1000)
        raws4 = [api.raw_read_from_simulated(r) for r in reads4]
        ref4p = os.path.join(tmp, "config4.fasta")
        ref4.to_fasta(ref4p)
        world_s = time.perf_counter() - t0
        base4 = ["snp", ref4p, "(in memory)", "--backend", "cuda", "--device", "cuda",
                 "--batch-reads", str(batch_reads), "--workers", str(W)]
        layout4 = ["--genome-sharded", "on", "--merge", "deferred"] if small else []
        ck1, ck2 = os.path.join(tmp, "c4_one.npz"), os.path.join(tmp, "c4_mh.npz")
        torch.cuda.reset_peak_memory_stats()
        one4_s, one4_m = run_cli(base4 + ["-o", os.path.join(tmp, "c4_one.vcf"),
                                          "--checkpoint", ck1], raws4)
        mh4_s, ranks4 = run_ranks(base4 + layout4 + [
            "-o", os.path.join(tmp, "c4_mh.vcf"), "--checkpoint", ck2], raws4)
        (a1, c1, v1), = load_checkpoint(ck1)[0].values()
        (a2, c2, v2), = load_checkpoint(ck2)[0].values()
        assert np.array_equal(c2, c1) and np.array_equal(v2, v1), "config 4: cov/votes"
        np.testing.assert_allclose(a2, a1, **MD_ACC_TOL)
        Gp4 = -(-G4 // (MD_RANKS * 128)) * MD_RANKS * 128
        out["c_config4"] = {
            "genome": G4, "reads": len(raws4), "read_len": 1000,
            "world_seconds": world_s, "covered_positions": int((c1 > 0).sum()),
            "genome_sharded": True, "merge": "deferred",
            "partial_mb_per_rank": Gp4 * 36 / 1e6,
            "cov_equal": int((c2 == c1).sum()), "votes_equal": int((v2 == v1).all(1).sum()),
            "acc_max_abs_diff": float(np.abs(a2 - a1).max()),
            "one_process": {"seconds": one4_s,
                            "tables_build_s": one4_m["gauges"]["subst_build_s"],
                            "reads_per_s": one4_m["gauges"]["reads_per_s"],
                            "peak_device_mb": one4_m["gauges"]["peak_device_mb"]},
            "two_ranks_seconds": mh4_s, "ranks": rank_summary(ranks4),
            "seconds": time.perf_counter() - t0}
    return out


DEVICE_STAGES = ("h2d", "viterbi_fill", "final_slot", "backtrack", "rescore_total",
                 "scatter")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this gate runs on the card only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "h5py": fast5mod.HAVE_H5PY})

    # ---- phase 2: build
    t0 = time.perf_counter()
    lib = kernel_build.load_library()
    # the fill's (S, W) table in the kernels and its copy in the wrapper agree
    for B in range(128, 1025, 128):
        for variant, skip, pair in ((0, False, False), (1, True, False), (2, False, True)):
            assert lib.nadavca_fill_slots_per_lane(B, variant) == \
                cuda_dp.fill_layout(B, skip, pair)[0], (B, variant)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "compiled_now": kernel_build.last_build_seconds is not None,
          "sources": [s.split("nadavca_tpu_torch/")[-1] for s in kernel_build.sources()]})

    # ---- worlds
    small = args.small
    cfg = nt.AlignConfig()                       # the default: snp_rescore="local"
    assert cfg.snp_rescore == "local"
    cfg_fixed = nt.AlignConfig(snp_rescore="fixed")
    cfg_wide = nt.AlignConfig(snp_rescore="fixed", band_width=cfg.band_width_long)
    cfg_skip = nt.AlignConfig(**SKIP_FIELDS)
    cfg_skip_wide = nt.AlignConfig(band_width=cfg.band_width_long, **SKIP_FIELDS)
    n_reads, read_len, genome_len, batch_reads = (
        (48, 300, 3000, 32) if small else (512, 1000, 25000, 256))
    wide_reads, wide_len = (8, 400) if small else (32, 2000)
    t0 = time.perf_counter()
    model, reference, reads, truth = make_world(
        args.seed, genome_len, 20, n_reads, read_len)
    raws, records = records_of(reads, reference, model, cfg)
    world_s = time.perf_counter() - t0
    # long reads for the wide band: ~20k samples each
    _, ref_w, reads_w, _ = make_world(args.seed + 1, 6000, 0, wide_reads, wide_len)
    _, records_w = records_of(reads_w, ref_w, model, cfg_wide)
    tables, subst_build_ms = timed(
        lambda: build_subst_tables(reference, model, device="cuda"))

    # ---- phase 3: kernels against their plain versions
    top = sorted(records, key=lambda r: len(r.signal))[-batch_reads:]
    batch, a = staged_batch(top, model, cfg, subst=tables)
    main_nums = check_kernels("main", batch, a, cfg, reps=10)
    res, _ = cuda_dp.cuda_viterbi_batch(
        a["x"], a["t_len"], a["mu"], a["sigma"], a["n_ref"], a["lo"], a["delta"], cfg,
        count_lanes=cuda_rescore.count_lanes(batch.mu.shape[1]))
    main_nums.update(check_rescore_kernels("main", batch, a, res.path, res.counts, cfg,
                                           tables, reps=10))
    del res
    batch_w, a_w = staged_batch(records_w, model, cfg_wide)
    wide_nums = check_kernels("wide", batch_w, a_w, cfg_wide, reps=5)
    # the fused rescore at the wide shape, on the wide band's path
    cfg_wide_local = nt.AlignConfig(band_width=cfg.band_width_long)
    tables_w = build_subst_tables(ref_w, model, device="cuda")
    _, a_wl = staged_batch(records_w, model, cfg_wide_local, subst=tables_w)
    res, _ = cuda_dp.cuda_viterbi_batch(
        a_wl["x"], a_wl["t_len"], a_wl["mu"], a_wl["sigma"], a_wl["n_ref"], a_wl["lo"],
        a_wl["delta"], cfg_wide_local,
        count_lanes=cuda_rescore.count_lanes(batch_w.mu.shape[1]))
    wide_nums.update(check_rescore_kernels("wide", batch_w, a_wl, res.path, res.counts,
                                           cfg_wide_local, tables_w, reps=5))
    del res, a_wl, tables_w
    # and on short reads, below T = 2304: no slab rule, the whole row staged
    _, ref_sh, reads_sh, _ = make_world(args.seed + 5, 3000, 0, batch_reads // 2, 150)
    _, records_sh = records_of(reads_sh, ref_sh, model, cfg)
    tables_sh = build_subst_tables(ref_sh, model, device="cuda")
    batch_sh, a_sh = staged_batch(records_sh, model, cfg, subst=tables_sh)
    assert batch_sh.x.shape[1] < cuda_rescore.SPAN + 256, batch_sh.x.shape
    res, _ = cuda_dp.cuda_viterbi_batch(
        a_sh["x"], a_sh["t_len"], a_sh["mu"], a_sh["sigma"], a_sh["n_ref"], a_sh["lo"],
        a_sh["delta"], cfg, count_lanes=cuda_rescore.count_lanes(batch_sh.mu.shape[1]))
    short_nums = check_rescore_kernels("short", batch_sh, a_sh, res.path, res.counts,
                                       cfg, tables_sh, reps=10)
    del res, a_sh, tables_sh
    check_argmax_tie()
    span = check_span_mask(reps=10)
    k9_nums = check_k9_tiles(args.seed, small, reps=5)
    del a_w, a
    # the skip fill, the two-plane backtrack and the two-sample fill, on reads
    # simulated with pore skips, at the same two shapes
    _, ref_s, reads_s, _ = make_world(args.seed + 3, genome_len, 0, batch_reads,
                                      read_len, skip_prob=SKIP_PROB)
    _, records_s = records_of(reads_s, ref_s, model, cfg_skip)
    batch_s, a_s = staged_batch(records_s, model, cfg_skip)
    main_nums.update(check_skip_kernels("main, skips", batch_s, a_s, cfg_skip, reps=10))
    _, ref_sw, reads_sw, _ = make_world(args.seed + 4, 6000, 0, wide_reads, wide_len,
                                        skip_prob=SKIP_PROB)
    _, records_sw = records_of(reads_sw, ref_sw, model, cfg_skip_wide)
    batch_sw, a_sw = staged_batch(records_sw, model, cfg_skip_wide)
    wide_nums.update(check_skip_kernels("wide, skips", batch_sw, a_sw, cfg_skip_wide,
                                        reps=5))
    # the walk past 256 slots, one and two planes, on the main batches' reads
    walks = check_wide_walks(top, records_s, model, reps=5)
    emit({"phase": "kernel_checks", "argmax_first_max": True, **span, "shapes": [
        {"R": b.x.shape[0], "T": b.x.shape[1], "B": c.band_width, "N": b.mu.shape[1],
         "L": b.codes.shape[1], "t_w": c.snp_local_window,
         "skip_batch_T": bs.x.shape[1], "kernels": nums}
        for b, bs, c, nums in ((batch, batch_s, cfg, main_nums),
                               (batch_w, batch_sw, cfg_wide, wide_nums))],
        "short_rows": {"R": batch_sh.x.shape[0], "T": batch_sh.x.shape[1],
                       "L": batch_sh.codes.shape[1], "kernels": short_nums},
        "k9": k9_nums,
        "walks_past_256_slots": walks})
    if not small:
        assert batch.x.shape == batch_s.x.shape == (256, 11136), batch.x.shape
        assert batch.codes.shape == (256, 1024), batch.codes.shape
        assert batch_w.x.shape == batch_sw.x.shape == (32, 22016), batch_sw.x.shape
    del a_s, a_sw, batch_s, batch_sw, batch_w

    # ---- phase 4: the main path — the default configuration through the api
    with tempfile.TemporaryDirectory() as tmp:
        fast5_dir = None
        if fast5mod.HAVE_H5PY:
            fast5_dir = tmp
            per = 128
            for i in range(0, len(reads), per):
                fast5mod.write_fast5(f"{tmp}/reads_{i // per:03d}.fast5", reads[i:i + per])
        n_batches = -(-len(records) // batch_reads)
        reset_launches()
        calls, alns, snp_s, aln_s = run_api(reference, raws, fast5_dir, cfg, model,
                                            "cuda", batch_reads)
        launches = read_launches()
        expect_launches("local", launches, {k: 2 * n_batches for k in LOCAL_KERNELS})
        assert len(alns) >= 0.9 * len(reads), (len(alns), len(reads))

    # the result is right: (a) the same entry points on the CPU, where every
    # wrapper runs its plain version, agree; the plain versions repeat the
    # kernels' operations in the same order. One batch's worth of reads, in
    # memory: the CPU run is the long part of this script.
    sub = raws[:batch_reads]
    t0 = time.perf_counter()
    card_sub = run_api(reference, sub, None, cfg, model, "cuda", batch_reads)[:2]
    seen = read_launches()
    assert_agree("local", card_sub,
                 run_api(reference, sub, None, cfg, model, "cpu", batch_reads)[:2],
                 RESCORE_RTOL, RESCORE_ATOL)
    assert read_launches() == seen, "a CPU run must not launch a kernel"
    # align_signal without probabilities runs no rescore: one walk per batch,
    # without counts, and the same segments
    reset_launches()
    bare = api.align_reads(reference, sub, config=cfg, model=model, backend="cuda",
                           batch_reads=batch_reads, prep="python", device="cuda",
                           compute_probabilities=False)
    sync()
    bare_launches = read_launches()
    expect_launches("align without probabilities", bare_launches, {
        k_: -(-len(bare) // batch_reads) for k_ in ("band_gather_folded", "viterbi_fill",
                                                     "backtrack")})
    for b, c in zip(bare, card_sub[1], strict=True):
        assert b.base_loglik is None and np.array_equal(b.seg_start, c.seg_start)
    del card_sub, bare

    # the fixed path of the first slice, at the same depth, on the card and on
    # the CPU
    reset_launches()
    f_calls, f_alns = run_api(reference, sub, None, cfg_fixed, model, "cuda",
                              batch_reads)[:2]
    fixed_launches = read_launches()
    n_sub = -(-len(f_alns) // batch_reads)
    expect_launches("fixed", fixed_launches, {k: 2 * n_sub for k in (
        "band_gather_folded", "viterbi_fill", "backtrack")})   # two entry points
    # float32 closed-form terms from statistics summed in float64
    assert_agree("fixed", (f_calls, f_alns),
                 run_api(reference, sub, None, cfg_fixed, model, "cpu", batch_reads)[:2],
                 ll_rtol=2e-3, ll_atol=5e-3)
    assert read_launches() == fixed_launches, "a CPU run must not launch a kernel"
    cpu_compare_s = time.perf_counter() - t0

    # a band wider than 256 slots through the entry points, on one batch of
    # reads, held against the CPU run of the same reads
    t0 = time.perf_counter()
    cfg_384 = nt.AlignConfig(band_width=384)
    sub_384 = raws[:64]
    reset_launches()
    card_384 = run_api(reference, sub_384, None, cfg_384, model, "cuda", 64)[:2]
    launches_384 = read_launches()
    expect_launches("band 384", launches_384, {k_: 2 for k_ in LOCAL_KERNELS})
    levels = {r.read_id: (r.mu, r.sigma) for r in records}
    n_tied_384 = assert_agree(
        "band 384", card_384, run_api(reference, sub_384, None, cfg_384, model, "cpu",
                                      64)[:2], RESCORE_RTOL, RESCORE_ATOL, levels=levels)
    assert n_tied_384 <= 0.05 * len(card_384[1]), n_tied_384
    band_384 = {"reads": len(sub_384), "aligned": len(card_384[1]),
                "calls": len(card_384[0]), "launches": launches_384,
                "cpu_plain_reads_differing_by_ties_only": n_tied_384,
                "seconds": time.perf_counter() - t0}
    del card_384

    torch.cuda.reset_peak_memory_stats()
    batch, a, path, cnt, _, base_ll, split = stage_split(
        records, reference, raws, model, cfg, batch_reads, tables)
    split["subst_build_once_per_genome"] = subst_build_ms
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n = batch.n_reads
    k = cfg.k
    path_np = path.cpu().numpy()
    for r in range(n):
        d = np.diff(path_np[r, : int(batch.t_len[r])])
        assert d.size == 0 or (d.min() >= 0 and d.max() <= 1), (r, d.min(), d.max())

    # (b) the scan twin on the card
    twin = hold_against_scan("scan twin on the card", batch, a, path, base_ll,
                             model, cfg, ll_atol=1e-3)
    cmp = twin.pop("cmp")

    # K6: the local rescore without genome tables, through the pipeline, held
    # against K5's result on the same positions; one launch from the walk's
    # counts to the masked result. The batch's peak device memory, and the
    # stage timed as the pipeline calls it, then its one kernel
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    no_tab = pipeline.align_batch(batch, model, cfg, backend="cuda", device="cuda",
                                  subst=None)
    sync()
    no_tab_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    k6_launches = read_launches()
    expect_launches("no tables", k6_launches, {k_: 1 for k_ in (
        "band_gather_folded", "viterbi_fill", "backtrack", "path_counts",
        "shear_gather_folded", "rescore_local")})
    assert torch.equal(no_tab["path"], path)
    torch.testing.assert_close(no_tab["base_loglik"][cmp], base_ll[cmp],
                               rtol=1e-5, atol=1e-3)
    k6_max_diff = float((no_tab["base_loglik"][cmp] - base_ll[cmp]).abs().max())
    del no_tab
    no_tab_args = (a["x"], path, a["t_len"], a["codes"], a["ids"], a["lm"], a["ls"])
    no_tab_stage = [wall_ms(lambda: cuda_rescore.base_loglik_local_cuda(
        *no_tab_args, k, cfg, t_w=cfg.snp_local_window, cnt=cnt)) for _ in range(3)]
    no_tab_kernel = [wall_ms(lambda: cuda_rescore.rescore_local(
        a["x"], path, a["t_len"], cnt, a["codes"], a["ids"], a["lm"], a["ls"], cfg,
        cfg.snp_local_window)) for _ in range(3)]

    called = {c.position: c.alt_base for c in calls}
    tp = sum(1 for p, b in truth.items() if called.get(p) == b)
    recall = tp / max(len(truth), 1)
    f_called = {c.position: c.alt_base for c in f_calls}
    assert recall >= MIN_RECALL, f"only {tp} of {len(truth)} planted SNPs were called"
    emit({"phase": "main_path", "config": "AlignConfig() (snp_rescore=local)",
          "ingest": "fast5" if fast5mod.HAVE_H5PY else "memory",
          "reads": len(reads), "aligned": len(alns), "batches": n_batches,
          "batch_shape": list(batch.x.shape), "window_shape": list(batch.codes.shape),
          "band_width": cfg.band_width, "t_w": cfg.snp_local_window,
          "world_seconds": round(world_s, 3),
          "call_snps_seconds": snp_s, "align_signal_seconds": aln_s,
          "reads_per_s_call_snps": len(alns) / snp_s,
          "launches": launches, "stage_ms_one_batch": split,
          "device_ms_one_batch": sum(split[k] for k in DEVICE_STAGES),
          "launches_align_without_probabilities": bare_launches,
          "band_width_384": band_384,
          "peak_device_mb_one_batch": peak_mb,
          "calls": len(calls), "planted": len(truth), "true_positive": tp,
          "recall": recall, "precision": tp / max(len(calls), 1),
          "cpu_plain_agrees_reads": len(f_alns), "cpu_compare_seconds": cpu_compare_s,
          "scan_on_card_tie_differences": twin["tie_differences"],
          "scan_on_card_live_samples": twin["live_samples"],
          "scan_rescore_interior_positions": twin["interior_positions"],
          "span_masked_interior_positions": twin["span_masked_interior_positions"]})
    del batch, a, path, base_ll, tables

    # ---- phase 5: this slice's paths
    skip_out = skip_phase(args.seed, model, n_reads, read_len, genome_len, batch_reads)
    emit(skip_out)
    pair_out = pair_phase(reference, sub, model, batch_reads,
                          None if small or args.seed else PAIR_DEFECT_ENTRIES_SEED0)
    joint_out = joint_phase(reference, sub, model, batch_reads)
    emit({"phase": "other_paths", "dp_pair_step": pair_out, **joint_out,
          "fixed": {"reads": len(sub), "launches": fixed_launches,
                    "calls": len(f_calls),
                    "true_positive": sum(1 for p, b in truth.items()
                                         if f_called.get(p) == b)},
          "local_without_tables": {"launches": k6_launches,
                                   "max_abs_diff_vs_tables_interior": k6_max_diff,
                                   "rescore_total_ms": no_tab_stage,
                                   "rescore_kernel_ms": no_tab_kernel,
                                   "peak_device_mb_one_batch": no_tab_peak_mb}})
    # ---- the C++ core against the card, and a batch of long reads
    emit(cpu_ref_phase(records, model, cfg))
    emit(long_read_phase(args.seed, model, small))
    # ---- the JAX package's own test worlds, against the scan twin
    emit(reference_worlds_phase(small))
    # ---- phase 6: the command line, as users run it
    emit(cli_phase(args.seed, model, reference, raws, records, calls, truth,
                   batch_reads))
    # ---- phase 7: several devices and processes, on the one card
    emit(multi_device_phase(args.seed, model, reference, raws, records, batch_reads,
                            smi, small))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    # each kernel's count comes from the path that runs it: the skip kernels
    # from the skip path, the two-sample fill from its own, K6 from the path
    # without genome tables, every other kernel from the main path. A folded
    # kernel's count is that of the launches that carry it on the main path
    # (the fills that gathered their own band levels, the walks that emitted
    # counts, the tables rescores that gathered their own samples)
    counts = dict(launches, rescore_local=k6_launches["rescore_local"],
                  shear_gather=launches["shear_gather_folded"],
                  band_gather=launches["band_gather_folded"],
                  viterbi_fill_pair=pair_out["launches"]["viterbi_fill_pair"],
                  **{k_: skip_out["launches"][k_]
                     for k_ in ("viterbi_fill_skip", "backtrack_skip")})
    extra = {name: {"folded_into": into} for name, into in FOLDED_INTO.items()}
    for name in ("rescore_local_tab", "rescore_local"):
        extra[name] = {"instruction_floor_ms": main_nums[name]["instruction_floor_ms"]}
    for name in ("band_gather", "shear_gather"):
        extra[name]["ms_of"] = main_nums[name]["ms_of"]
    return finish(smi, main_nums, counts, extra)


def finish(smi: str, nums: dict, launches: dict, extra: dict) -> int:
    kernels = []
    for name, info in KERNEL_INFO.items():
        k = dict(name=name, **info)
        k["launches"] = launches[name]
        assert k["launches"] > 0, f"{name} was launched by no path"
        k["ok"] = True        # a kernel that disagreed would have raised above
        k.update({f: nums[name][f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        k.update(extra.get(name, {}))
        kernels.append(k)
    assert len(kernels) == 10
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
