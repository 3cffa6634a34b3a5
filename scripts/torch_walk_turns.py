#!/usr/bin/env python3
"""Time the port's walk (``csrc/backtrack.cu``) against an older version of it,
in turns, on one NVIDIA card.

    python3 scripts/torch_walk_turns.py --old DIR [--reps 20]

``DIR`` is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit) whose
``nadavca_tpu_torch/csrc/backtrack.cu`` has the one-warp-per-read walk with the
C interface ``nadavca_backtrack(dec, lo, delta, j_end, path, R, T, C, B,
stream)`` and its two-plane twin, and whose ``path_counts.cu`` has
``nadavca_path_counts(path, t_len, cnt, R, T, n_lanes, stream)``. Those two
sources are built with ``nvcc`` into a library of their own under
``DIR/_walk_build`` and bound with ``ctypes``; this checkout's kernels are
built as the port builds them.

On the batches ``chip_smoke.py`` checks its kernels on (same seeds): the
default batch (R=256, T=11136, B=128), the batch with pore skips (two planes),
and the wide batches (R=32, T=22016, B=256, one and two planes), each walk is
timed by CUDA events in turns (old, new, new, old) after checking that both
give the plain version's path. On the default batch also: the new walk
without and with its counts epilogue in turns, the old path-counts kernel
together with the sentinel pass it needed, and ``torch.searchsorted`` on the
same path. Prints one JSON line per measurement; the card's name and power
limit come first. Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs                                            # noqa: E402
import nadavca_tpu_torch as nt                                     # noqa: E402
from nadavca_tpu_torch.ops import cuda_dp, cuda_rescore           # noqa: E402
from nadavca_tpu_torch.utils import kernel_build                  # noqa: E402


def build_old(old_root: str) -> ctypes.CDLL:
    csrc = os.path.join(old_root, "nadavca_tpu_torch", "csrc")
    out = os.path.join(old_root, "_walk_build")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libold_walk.so")
    cmd = [kernel_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-shared",
           "-o", so, os.path.join(csrc, "backtrack.cu"),
           os.path.join(csrc, "path_counts.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nadavca_backtrack.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.nadavca_backtrack_skip.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.nadavca_path_counts.argtypes = [p, p, p, i, i, i, p]
    for f in (lib.nadavca_backtrack, lib.nadavca_backtrack_skip, lib.nadavca_path_counts):
        f.restype = i
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def old_walk(lib, decs, lo, delta, j_end, C):
    _, R, B = decs[0].shape
    T = decs[0].shape[0] * 32
    path = torch.empty((R, T), dtype=torch.int32, device="cuda")
    if len(decs) == 2:
        code = lib.nadavca_backtrack_skip(decs[0].data_ptr(), decs[1].data_ptr(),
                                          lo.data_ptr(), delta.data_ptr(),
                                          j_end.data_ptr(), path.data_ptr(), R, T, C, B,
                                          stream())
    else:
        code = lib.nadavca_backtrack(decs[0].data_ptr(), lo.data_ptr(), delta.data_ptr(),
                                     j_end.data_ptr(), path.data_ptr(), R, T, C, B,
                                     stream())
    assert code == 0, code
    return path


def old_counts(lib, path, t_len, n_lanes):
    """The old route to the counts: the sentinel pass, then its own kernel."""
    R, T = path.shape
    live = torch.arange(T, device="cuda")[None, :] < t_len[:, None]
    path_safe = torch.where(live, path, torch.full((), n_lanes, dtype=torch.int32,
                                                   device="cuda"))
    cnt = torch.empty((R, n_lanes), dtype=torch.int32, device="cuda")
    code = lib.nadavca_path_counts(path_safe.data_ptr(), t_len.data_ptr(), cnt.data_ptr(),
                                   R, T, n_lanes, stream())
    assert code == 0, code
    return cnt


def batches(seed: int):
    """(name, cfg, staged arrays) of chip_smoke.py's kernel-check batches."""
    cfg = nt.AlignConfig()
    cfg_skip = nt.AlignConfig(**cs.SKIP_FIELDS)
    cfg_wide = nt.AlignConfig(snp_rescore="fixed", band_width=cfg.band_width_long)
    cfg_skip_wide = nt.AlignConfig(band_width=cfg.band_width_long, **cs.SKIP_FIELDS)
    n_reads, read_len, genome_len, batch_reads = 512, 1000, 25000, 256
    model, reference, reads, _ = cs.make_world(seed, genome_len, 20, n_reads, read_len)
    _, records = cs.records_of(reads, reference, model, cfg)
    top = sorted(records, key=lambda r: len(r.signal))[-batch_reads:]
    yield "main", cfg, cs.staged_batch(top, model, cfg)
    _, ref_s, reads_s, _ = cs.make_world(seed + 3, genome_len, 0, batch_reads, read_len,
                                         skip_prob=cs.SKIP_PROB)
    _, records_s = cs.records_of(reads_s, ref_s, model, cfg_skip)
    yield "main, skips", cfg_skip, cs.staged_batch(records_s, model, cfg_skip)
    _, ref_w, reads_w, _ = cs.make_world(seed + 1, 6000, 0, 32, 2000)
    _, records_w = cs.records_of(reads_w, ref_w, model, cfg_wide)
    yield "wide", cfg_wide, cs.staged_batch(records_w, model, cfg_wide)
    _, ref_sw, reads_sw, _ = cs.make_world(seed + 4, 6000, 0, 32, 2000,
                                           skip_prob=cs.SKIP_PROB)
    _, records_sw = cs.records_of(reads_sw, ref_sw, model, cfg_skip_wide)
    yield "wide, skips", cfg_skip_wide, cs.staged_batch(records_sw, model, cfg_skip_wide)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="root of the older checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_walk_turns: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.emit({"nvidia_smi": smi, "torch": torch.__version__})
    lib = build_old(args.old)
    kernel_build.load_library()
    reps = args.reps
    for name, cfg, (batch, a) in batches(args.seed):
        C = cfg.signal_chunk
        decs, v_fin, acc = cuda_dp.viterbi_fill(a["x"], a["t_len"], a["mu"], a["sigma"],
                                                a["lo"], a["delta"], a["n_ref"], cfg)
        j_end, _ = cuda_dp.final_slot_and_score(v_fin, acc, a["lo"][:, -1], a["n_ref"])
        walk_args = (decs, a["lo"], a["delta"], j_end, C)
        new = lambda: cuda_dp.backtrack(*walk_args)
        old = lambda: old_walk(lib, *walk_args)
        want = cuda_dp.backtrack_plain(*walk_args)
        assert torch.equal(new(), want) and torch.equal(old(), want), name
        turns = [cs.event_ms(f, reps) for f in (old, new, new, old)]
        out = {"batch": name, "R": batch.x.shape[0], "T": batch.x.shape[1],
               "B": cfg.band_width, "planes": len(decs), "reps": reps,
               "old_new_new_old_ms": turns,
               "speedup": (turns[0] + turns[3]) / (turns[1] + turns[2])}
        if name == "main":
            n_lanes = cuda_rescore.count_lanes(batch.mu.shape[1])
            t_len = a["t_len"]
            new_c = lambda: cuda_dp.backtrack(*walk_args, t_len=t_len, n_lanes=n_lanes)
            path = want
            want_c = cuda_dp.path_counts_plain(path, n_lanes, t_len)
            assert torch.equal(new_c()[1], want_c)
            assert torch.equal(old_counts(lib, path, t_len, n_lanes), want_c)
            c_turns = [cs.event_ms(f, reps) for f in (new, new_c, new_c, new)]
            live = torch.arange(path.shape[1], device="cuda")[None, :] < t_len[:, None]
            path_safe = torch.where(live, path, torch.full_like(path, n_lanes))
            lanes = torch.arange(n_lanes, dtype=torch.int32, device="cuda")[None, :] \
                .expand(path.shape[0], n_lanes).contiguous()
            out.update({
                "n_lanes": n_lanes,
                "new_walk_without_with_with_without_counts_ms": c_turns,
                "counts_added_ms": (c_turns[1] + c_turns[2] - c_turns[0] - c_turns[3]) / 2,
                "old_sentinel_pass_and_path_counts_ms": cs.event_ms(
                    lambda: old_counts(lib, path, t_len, n_lanes), reps),
                "searchsorted_ms": cs.event_ms(
                    lambda: torch.searchsorted(path_safe, lanes), reps)})
        cs.emit(out)
        del decs, v_fin, acc
    return 0


if __name__ == "__main__":
    sys.exit(main())
