#!/usr/bin/env python3
"""Time the port's local rescore against an older version of it, in turns,
on one NVIDIA card.

    python3 scripts/torch_rescore_turns.py --old DIR [--reps 20]

``DIR`` is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit) in which the rescore without
genome tables was two kernels with tensor code around them:
``nadavca_tpu_torch/csrc/shear_gather.cu`` with ``nadavca_shear_gather``
(the sample windows as a (t_w, R, L) array) and ``rescore.cu`` with
``nadavca_rescore`` (the local DP on them and on (k*4, R, L) constants), and
with tables the fused ``nadavca_rescore_local_tab``. Those two sources are
built with ``nvcc`` into a library of their own under ``DIR/_rescore_build``
and bound with ``ctypes``; the tensor code around the older kernels is this
checkout's ``cuda_rescore.local_windows``, ``span_ok``, ``shear_slab_base``
and ``batch_constants``, which the new kernel left unchanged, strung together
as the older ``base_loglik_local_cuda`` did. This checkout's
``base_loglik_local_cuda`` runs one ``rescore_local`` launch without tables
and one ``rescore_local_tab`` launch with them.

On ``chip_smoke.py``'s default batch (seed 0: R=256, T=11136, L=1024,
t_w=192), its wide batch banded at 256 (R=32, T=22016) and a batch of short
reads (T < 2304, no slab rule), on the path and counts the card's walk
gives, after checking that both versions give the same (R, L, 4) result to
the bit:

- without tables, the whole rescore old, new, new, old, by CUDA events (the
  stream's time from the first launch to the last, host gaps included) and
  by the host's clock around a synchronise; the kernels alone in the same
  order (the older K4 + K6 on inputs made beforehand against the new
  kernel); the peak device memory of one call of each;
- with tables, the older fused kernel against this checkout's in the same
  turns, the control.

Before the batches, from this checkout's build: the registers and spills of
both tile kernels (``ptxas -v``) and, from their SASS (``cuobjdump -sass``),
the instructions and the compiler's stall cycles per sample of the DP loop
at k = 6.

Prints one JSON line per batch; the card's name and power limit come first.
Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import chip_smoke as cs                                            # noqa: E402
import nadavca_tpu_torch as nt                                     # noqa: E402
from nadavca_tpu_torch.ops import cuda_dp, cuda_rescore           # noqa: E402
from nadavca_tpu_torch.ops.subst_tables import build_subst_tables  # noqa: E402
from nadavca_tpu_torch.utils import kernel_build                  # noqa: E402
from torch_fill_turns import demangle, sass_instructions          # noqa: E402

LOCAL_KERNELS = ("rescore_local_tab_kernel", "rescore_local_kernel")


def compiler_report() -> dict:
    """Registers and spills of each tile kernel (``ptxas -v``), and the DP
    loop of the k = 6 ones from their SASS: the largest basic block that
    loads a sample from shared memory (LDS), its instructions and the
    compiler's stall cycles per sample, and its opcodes."""
    so = kernel_build.build_library()
    text = open(os.path.join(os.path.dirname(so), "ptxas.log")).read()
    regs, name = {}, None
    for line in text.split("== rescore.cu")[1].split("\n== ")[0].splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = demangle(m.group(1))
        local = name and any(kn in name for kn in LOCAL_KERNELS)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and local:
            regs.setdefault(name, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and local:
            regs.setdefault(name, {})["registers"] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(kernel_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    loops = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        fname = demangle(body.split("\n", 1)[0].strip())
        kname = next((kn for kn in LOCAL_KERNELS if f"{kn}<6>" in fname), None)
        if kname is None:
            continue
        instrs, targets = sass_instructions(body)
        blocks, cur = [], []
        for ins in instrs:
            if ins[0] in targets and cur:
                blocks.append(cur)
                cur = []
            cur.append(ins)
            if ins[1].split(".")[0] in ("BRA", "EXIT", "BAR", "RET"):
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        cands = [b for b in blocks if any(op.startswith("LDS") for _, op, _ in b)
                 and any(op.startswith("FMNMX") for _, op, _ in b)]
        if cands:
            big = max(cands, key=len)
            samples = sum(op.startswith("LDS") for _, op, _ in big)
            loops[kname] = {
                "block_instructions": len(big), "samples": samples,
                "instructions_per_sample": len(big) / samples,
                "stall_cycles_per_sample": sum(st for _, _, st in big) / samples,
                "opcodes": dict(collections.Counter(
                    op.split(".")[0] for _, op, _ in big).most_common())}
    return {"ptxas": regs, "dp_loop_k6": loops}


def build_old(old_root: str) -> ctypes.CDLL:
    csrc = os.path.join(old_root, "nadavca_tpu_torch", "csrc")
    out = os.path.join(old_root, "_rescore_build")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libold_rescore.so")
    cmd = [kernel_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-shared",
           "-o", so, os.path.join(csrc, "shear_gather.cu"),
           os.path.join(csrc, "rescore.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nadavca_shear_gather.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.nadavca_rescore.argtypes = [p] * 8 + [i] * 4 + [f, f, p]
    lib.nadavca_rescore_local_tab.argtypes = [p] * 9 + [i] * 8 + [f, f, p]
    for fn in (lib.nadavca_shear_gather, lib.nadavca_rescore, lib.nadavca_rescore_local_tab):
        fn.restype = i
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def old_prelude(x, path, t_len, codes, ids, lm, ls, N, cfg, t_w, cnt):
    """The tensor code the older version ran before its kernels: windows,
    span mask, per-batch constants."""
    T = x.shape[1]
    S, W, kk, p_lo, valid_i = cuda_rescore.local_windows(path, t_len, codes, N, cfg.k,
                                                         t_w, cnt)
    S_c = S.clamp(0, T - 1).contiguous()
    if T >= cuda_rescore.SPAN + 256:
        W = torch.where(cuda_rescore.span_ok(S_c, T), W, torch.zeros_like(W))
    em, mu, iv, slots_ok = cuda_rescore.batch_constants(p_lo, kk, codes, ids, lm, ls,
                                                        cfg.k)
    return S_c, W.contiguous(), kk.contiguous(), valid_i, em, mu, iv, slots_ok


def old_kernels(lib, x, S_c, W, kk, ref, em, mu, iv, cfg, t_w):
    """The older K4 (under the slab rule where T allows it) and K6."""
    R, T = x.shape
    L = S_c.shape[1]
    slab = T >= cuda_rescore.SPAN + 256
    base = cuda_rescore.shear_slab_base(S_c, T, cuda_rescore.SPAN).contiguous() \
        if slab else None
    xs = torch.empty((t_w, R, L), dtype=torch.float32, device=x.device)
    code = lib.nadavca_shear_gather(x.data_ptr(), S_c.data_ptr(),
                                    base.data_ptr() if slab else None, xs.data_ptr(),
                                    R, T, L, t_w, cuda_rescore.SPAN, cuda_rescore.LT,
                                    stream())
    assert code == 0, code
    out = torch.empty((4, R, L), dtype=torch.float32, device=x.device)
    code = lib.nadavca_rescore(xs.data_ptr(), em.data_ptr(), mu.data_ptr(), iv.data_ptr(),
                               W.data_ptr(), kk.data_ptr(), ref.data_ptr(), out.data_ptr(),
                               R, L, t_w, cfg.k, float(cfg.log_p_stay),
                               float(cfg.log_p_move), stream())
    assert code == 0, code
    return out


def old_local(lib, x, path, t_len, codes, ids, lm, ls, N, cfg, t_w, cnt):
    """The older ``base_loglik_local_cuda`` without tables: prelude, K4, K6,
    and the masks and layout after them."""
    S_c, W, kk, valid_i, em, mu, iv, slots_ok = old_prelude(
        x, path, t_len, codes, ids, lm, ls, N, cfg, t_w, cnt)
    scores = old_kernels(lib, x, S_c, W, kk, codes.clamp(0, 3), em, mu, iv, cfg, t_w)
    all_ok = valid_i & (W > 0) & slots_ok
    out = scores.permute(1, 2, 0)
    out = torch.where(all_ok[:, :, None], out, torch.zeros_like(out))
    return out.contiguous()


def old_local_tab(lib, x, path, t_len, cnt, codes, woff, tables, N, cfg, t_w):
    """The older fused tables rescore through its bare C interface."""
    R, T = x.shape
    L = codes.shape[1]
    out = torch.empty((R, L, 4), dtype=torch.float32, device=x.device)
    code = lib.nadavca_rescore_local_tab(
        x.data_ptr(), cnt.data_ptr(), path.data_ptr(), t_len.data_ptr(), codes.data_ptr(),
        woff.data_ptr(), tables.tab.data_ptr(), tables.valid.data_ptr(), out.data_ptr(),
        R, T, L, N, cnt.shape[1], t_w, cfg.k, tables.tab.shape[2],
        float(cfg.log_p_stay), float(cfg.log_p_move), stream())
    assert code == 0, code
    return out


def batches(seed: int):
    """(name, cfg, batch, staged arrays, tables) of the three batches."""
    cfg = nt.AlignConfig()
    model, reference, reads, _ = cs.make_world(seed, 25000, 20, 512, 1000)
    _, records = cs.records_of(reads, reference, model, cfg)
    top = sorted(records, key=lambda r: len(r.signal))[-256:]
    tables = build_subst_tables(reference, model, device="cuda")
    yield ("main", cfg, *cs.staged_batch(top, model, cfg, subst=tables), tables)
    cfg_w = nt.AlignConfig(band_width=cfg.band_width_long)
    _, ref_w, reads_w, _ = cs.make_world(seed + 1, 6000, 0, 32, 2000)
    _, records_w = cs.records_of(reads_w, ref_w, model, cfg_w)
    tables_w = build_subst_tables(ref_w, model, device="cuda")
    yield ("wide", cfg_w, *cs.staged_batch(records_w, model, cfg_w, subst=tables_w),
           tables_w)
    _, ref_s, reads_s, _ = cs.make_world(seed + 5, 3000, 0, 128, 150)
    _, records_s = cs.records_of(reads_s, ref_s, model, cfg)
    tables_s = build_subst_tables(ref_s, model, device="cuda")
    yield ("short", cfg, *cs.staged_batch(records_s, model, cfg, subst=tables_s),
           tables_s)


def peak_mb(fn) -> float:
    cs.sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    cs.sync()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="root of the older checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rescore_turns: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.emit({"nvidia_smi": smi, "torch": torch.__version__})
    lib = build_old(args.old)
    kernel_build.load_library()
    cs.emit(compiler_report())
    reps = args.reps
    for name, cfg, batch, a, tables in batches(args.seed):
        N = batch.ids.shape[1]
        t_w = cfg.snp_local_window
        res, _ = cuda_dp.cuda_viterbi_batch(
            a["x"], a["t_len"], a["mu"], a["sigma"], a["n_ref"], a["lo"], a["delta"],
            cfg, count_lanes=cuda_rescore.count_lanes(N))
        path, cnt = res.path, res.counts
        common = (a["x"], path, a["t_len"])
        kmer = (a["ids"], a["lm"], a["ls"])
        old = lambda: old_local(lib, *common, a["codes"], *kmer, N, cfg, t_w, cnt)
        new = lambda: cuda_rescore.base_loglik_local_cuda(
            *common, a["codes"], *kmer, cfg.k, cfg, t_w=t_w, cnt=cnt)
        got_old, got_new = old(), new()
        assert torch.equal(got_old == 0, got_new == 0), name
        err = float((got_old - got_new).abs().max())
        assert err <= 1e-3, (name, err)
        del got_old, got_new
        turns = [cs.event_ms(f, reps) for f in (old, new, new, old)]
        wall = [sum(cs.wall_ms(f) for _ in range(reps)) / reps
                for f in (old, new, new, old)]
        # the kernels alone, on inputs made beforehand
        S_c, W, kk, _, em, mu, iv, _ = old_prelude(*common, a["codes"], *kmer, N, cfg,
                                                   t_w, cnt)
        ref = a["codes"].clamp(0, 3)
        k_old = lambda: old_kernels(lib, a["x"], S_c, W, kk, ref, em, mu, iv, cfg, t_w)
        k_new = lambda: cuda_rescore.rescore_local(*common, cnt, a["codes"], *kmer, cfg,
                                                   t_w)
        k_turns = [cs.event_ms(f, reps) for f in (k_old, k_new, k_new, k_old)]
        k_dev = [cs.device_ms(f, reps) for f in (k_old, k_new)]
        del S_c, W, kk, em, mu, iv
        # the tables rescore: the older fused kernel against this one, the
        # control
        tab_args = (*common, cnt, a["codes"], a["woff"], tables, N, cfg, t_w)
        t_old = lambda: old_local_tab(lib, *tab_args)
        t_new = lambda: cuda_rescore.rescore_local_tab(
            *common, cnt, a["codes"], a["woff"], tables.tab, tables.valid, N, cfg, t_w,
            woff_range=a["woff_range"])
        tab_err = float((t_old() - t_new()).abs().max())
        assert tab_err <= 1e-3, (name, tab_err)
        tab_turns = [cs.event_ms(f, reps) for f in (t_old, t_new, t_new, t_old)]
        cs.emit({"batch": name, "R": batch.x.shape[0], "T": batch.x.shape[1],
                 "L": batch.codes.shape[1], "t_w": t_w, "reps": reps,
                 "max_abs_diff_old_new": err, "control_tables_max_abs_diff": tab_err,
                 "no_tables_whole_old_new_new_old_ms_events": turns,
                 "no_tables_whole_old_new_new_old_ms_host": wall,
                 "no_tables_kernels_old_new_new_old_ms": k_turns,
                 "no_tables_kernels_device_ms_old_new": k_dev,
                 "speedup_whole_events": (turns[0] + turns[3]) / (turns[1] + turns[2]),
                 "speedup_kernels": (k_turns[0] + k_turns[3]) / (k_turns[1] + k_turns[2]),
                 "peak_mb_old": peak_mb(old), "peak_mb_new": peak_mb(new),
                 "control_tables_old_new_new_old_ms": tab_turns})
        del res, path, cnt
    return 0


if __name__ == "__main__":
    sys.exit(main())
