#!/usr/bin/env python3
"""Time the port's Viterbi fills (``csrc/viterbi_fill.cu``) against an older
version of them, in turns, on one NVIDIA card, and report what the compiler
made of them.

    python3 scripts/torch_fill_turns.py --old DIR [--reps 20] [--out DIR]

``DIR`` is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit) in which the two-sample fill
takes gathered bands: ``nadavca_tpu_torch/csrc/band_gather.cu`` with
``nadavca_band_gather``, ``viterbi_fill_pair.cu`` with
``nadavca_viterbi_fill_pair`` on (n_chunks, R, B) bands, and
``viterbi_fill.cu`` with the single-step fills ``nadavca_viterbi_fill`` /
``nadavca_viterbi_fill_skip`` on the (R, N) level rows. Those three sources
are built with ``nvcc`` (one process each, started together) into a library
of their own under ``DIR/_fill_build`` and bound with ``ctypes``; this
checkout's kernels, all three of whose fills gather their band levels from
the rows themselves, are built as the port builds them.

On the batches ``chip_smoke.py`` checks its kernels on (same seeds: the
default batch R=256, T=11136, B=128, the batch with pore skips, the wide
batches R=32, T=22016, B=256 without and with skips, and the default reads
banded at B=384 and 512), after checking that every version gives the plain
version's decision words (and the two-sample fills, V and acc to the bit):

- the older band gather followed by the older two-sample fill (K1b + K7b)
  against this checkout's two-sample fill with the gather folded in: old,
  new, new, old (the batches without skips);
- the single-step fill (K1, or K7a on the batches with skips) of both
  checkouts in the same turns, the control;
- every layout (S slots per lane, W = ceil(B / (32 S)) warps per read) each
  kernel can run at that band width, forward then backward, the table's
  marked;
- nanoseconds per serial step (ms / t_len.max()) of each.

Then, from this checkout's build: the registers, shared memory and spills of
each fill kernel (``ptxas -v``), and from its SASS (``cuobjdump -sass``) the
instructions and the compiler's stall cycles per sample (per pair for the
two-sample fill) of the unrolled loops of a chain warp and of a producer
warp. The full SASS of the fill kernels goes to ``fill_sass.txt`` in
``--out``, by default the build directory beside the library and its
``ptxas.log``. Prints one JSON line per measurement; the card's name, power
limit and SM clock come first. Needs a card; exits 2 without one.
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
from nadavca_tpu_torch.ops import cuda_dp                          # noqa: E402
from nadavca_tpu_torch.utils import kernel_build                  # noqa: E402
from torch_walk_turns import batches                               # noqa: E402

FILL_NAMES = ("viterbi_fill_kernel", "viterbi_fill_skip_kernel", "viterbi_fill_pair_kernel")


def build_old(old_root: str) -> ctypes.CDLL:
    csrc = os.path.join(old_root, "nadavca_tpu_torch", "csrc")
    out = os.path.join(old_root, "_fill_build")
    os.makedirs(out, exist_ok=True)
    nvcc = kernel_build.find_nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-fmad=false", "-Xcompiler", "-fPIC"]
    objs, procs = [], []
    for name in ("band_gather", "viterbi_fill", "viterbi_fill_pair"):
        obj = os.path.join(out, name + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc] + flags + ["-c", os.path.join(csrc, name + ".cu"), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out_text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError("nvcc failed on the older fill:\n" + out_text)
    so = os.path.join(out, "libold_fill.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-o", so] + objs, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nadavca_viterbi_fill.argtypes = [p] * 10 + [i] * 5 + [f, f, p]
    lib.nadavca_viterbi_fill_skip.argtypes = [p] * 11 + [i] * 5 + [f, f, f, p]
    lib.nadavca_viterbi_fill_pair.argtypes = [p] * 10 + [i] * 4 + [f] * 5 + [p]
    lib.nadavca_band_gather.argtypes = [p] * 5 + [i] * 4 + [p]
    for fn in (lib.nadavca_viterbi_fill, lib.nadavca_viterbi_fill_skip,
               lib.nadavca_viterbi_fill_pair, lib.nadavca_band_gather):
        fn.restype = i
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def old_gather(lib, args, B):
    """A standalone band gather of the rows in ``args`` through ``lib``'s bare
    C interface (the older checkout's, or this one's)."""
    x, _, mu, sigma, lo, _, _ = args
    R, N = mu.shape
    n_chunks = lo.shape[1]
    mu_b = torch.empty((n_chunks, R, B), dtype=torch.float32, device=x.device)
    sg_b = torch.empty_like(mu_b)
    code = lib.nadavca_band_gather(mu.data_ptr(), sigma.data_ptr(), lo.data_ptr(),
                                   mu_b.data_ptr(), sg_b.data_ptr(), R, N, n_chunks, B,
                                   stream())
    assert code == 0, code
    return mu_b, sg_b


def launch(fn, args, cfg, n_planes, extra, rows: bool):
    """A fill of either library's C interface on the wrapper's outputs. With
    ``rows`` the level arguments are the (R, N) rows and N goes after B, else
    gathered bands (the older two-sample fill). ``extra`` are the float
    constants, then any further int arguments."""
    x, t_len, mu, sigma, lo, delta, n_ref = args
    R, T = x.shape
    B = cfg.band_width
    decs, v_out, acc = cuda_dp._fill_outputs(R, T, B, x.device, n_planes)
    code = fn(x.data_ptr(), t_len.data_ptr(), mu.data_ptr(), sigma.data_ptr(),
              lo.data_ptr(), delta.data_ptr(), n_ref.data_ptr(),
              *(d.data_ptr() for d in decs), v_out.data_ptr(), acc.data_ptr(),
              R, T, cfg.signal_chunk, B, *([mu.shape[1]] if rows else []), *extra,
              stream())
    assert code == 0, code
    return decs, v_out, acc


def fill_fns(lib, cfg, layout_s=None):
    """(callable (args) -> outputs) of the single-step fill of ``lib`` on the
    level rows in ``args``: the table's layout, or ``layout_s`` slots per lane
    through the layout entry."""
    if cfg.use_skip:
        consts = [cfg.log_p_stay, cfg.log_p_move, cfg.log_p_skip]
        fn = lib.nadavca_viterbi_fill_skip if layout_s is None else \
            lib.nadavca_viterbi_fill_skip_layout
        planes = 2
    else:
        consts = [cfg.log_p_stay, cfg.log_p_move - cfg.log_p_stay]
        fn = lib.nadavca_viterbi_fill if layout_s is None else \
            lib.nadavca_viterbi_fill_layout
        planes = 1
    extra = consts + ([] if layout_s is None else [layout_s])
    return lambda args: launch(fn, args, cfg, planes, extra, rows=True)


def pair_consts(cfg_pair):
    cs_, cm = cfg_pair.log_p_stay, cfg_pair.log_p_move
    return [cs_, cm, cs_ + cs_, cs_ + cm, cm + cm]


def old_pair_fn(lib, cfg_pair):
    """The older band gather followed by the older two-sample fill on its
    bands, from the rows in ``args``."""
    def gather_then_fill(args):
        mu_b, sg_b = old_gather(lib, args, cfg_pair.band_width)
        return launch(lib.nadavca_viterbi_fill_pair, args[:2] + (mu_b, sg_b) + args[4:],
                      cfg_pair, 1, pair_consts(cfg_pair), rows=False)
    return gather_then_fill


def new_pair_fn(lib, cfg_pair, layout_s=None):
    """This checkout's two-sample fill on the rows: the table's layout, or
    ``layout_s`` slots per lane."""
    if layout_s is None:
        return lambda args: launch(lib.nadavca_viterbi_fill_pair, args, cfg_pair, 1,
                                   pair_consts(cfg_pair), rows=True)
    return lambda args: launch(lib.nadavca_viterbi_fill_pair_layout, args, cfg_pair, 1,
                               pair_consts(cfg_pair) + [layout_s], rows=True)


def assert_same(tag, got, want, exact=False):
    (decs, v, acc), (p_decs, p_v, p_acc) = got, want
    assert len(decs) == len(p_decs), tag
    for d, p in zip(decs, p_decs):
        n = int((d != p).sum())
        assert n == 0, f"{tag}: {n} decision words differ"
    live = p_v > -5e29
    assert bool((live == (v > -5e29)).all()), tag
    assert float(((v - p_v).abs() * live).max()) <= 1e-3, tag
    torch.testing.assert_close(acc, p_acc, rtol=1e-5, atol=1e-3)
    if exact:
        assert torch.equal(v, p_v) and torch.equal(acc, p_acc), tag


def layouts(B: int, pair: bool = False):
    """Every S a fill takes at band width B (W <= 8 warps: B / (32 S), or
    for the two-sample fill ceil(B / (32 S)))."""
    if pair:
        return [s for s in (2, 4, 8) if -(-B // (32 * s)) <= 8]
    return [s for s in (2, 4, 8) if B % (32 * s) == 0 and B // (32 * s) <= 8]


def time_layouts(fns, args, reps):
    """Each layout's ms, forward then backward."""
    order = list(fns) + list(fns)[::-1]
    ms = collections.defaultdict(list)
    for s in order:
        ms[s].append(cs.event_ms(lambda: fns[s](args), reps))
    return ms


def demangle(name: str) -> str:
    try:
        out = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout
    except FileNotFoundError:
        return name
    return out.strip() or name


def ptxas_report() -> list:
    """Registers, shared memory and spills of each fill kernel, from the
    ``-Xptxas -v`` log the build keeps."""
    log_path = os.path.join(os.path.dirname(kernel_build.build_library()), "ptxas.log")
    text = open(log_path).read()
    section = text.split("== viterbi_fill.cu")[1].split("\n== ")[0]
    out, name = [], None
    for line in section.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = demangle(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.append({"kernel": name, "stack": int(m.group(1)),
                        "spill_stores": int(m.group(2)), "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and name and out and out[-1]["kernel"] == name:
            out[-1]["registers"] = int(m.group(1))
            m2 = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem"] = int(m2.group(1)) if m2 else 0
    return out


BRANCHES = ("BRA", "EXIT", "RET", "BSYNC", "WARPSYNC", "CALL", "BAR", "BRX", "JMP")


def sass_instructions(body: str):
    """(address, opcode, stall cycles) of each instruction of one function
    in ``cuobjdump -sass`` output, and the branch targets. The stall count is
    bits 105-108 of the 128-bit instruction (the control bits the compiler
    sets for the warp scheduler), in the second 64-bit word."""
    lines = body.splitlines()
    instrs, targets = [], set()
    for i, line in enumerate(lines):
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);"
                      r"\s*/\* 0x[0-9a-f]{16} \*/", line)
        if not m or i + 1 >= len(lines):
            continue
        hi = re.search(r"/\* (0x[0-9a-f]{16}) \*/", lines[i + 1])
        stall = (int(hi.group(1), 16) >> 41) & 0xF if hi else 0
        op = m.group(3)
        instrs.append((int(m.group(1), 16), op, stall))
        if op.split(".")[0] in ("BRA", "BSSY", "CALL", "JMP", "BRX"):
            for t in re.findall(r"0x([0-9a-f]+)", m.group(4)):
                targets.add(int(t, 16))
    return instrs, targets


def sass_report(out_dir: str) -> list:
    """For each fill kernel, its unrolled sample loops: the basic blocks of a
    chain warp (one SHFL.UP per sample and plane) and of a producer warp (one
    SHFL.IDX of x per sample), each with its instructions and the compiler's
    stall cycles per sample, and its opcodes by count. Blocks end at a
    branch, a barrier or a branch target."""
    so = kernel_build.build_library()
    cuobjdump = os.path.join(os.path.dirname(kernel_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    keep, report = [], []
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = demangle(body.split("\n", 1)[0].strip())
        if not any(f in name for f in FILL_NAMES):
            continue
        keep.append(f"Function : {name}\n{body}")
        instrs, targets = sass_instructions(body)
        blocks, cur = [], []
        for ins in instrs:
            if ins[0] in targets and cur:
                blocks.append(cur)
                cur = []
            cur.append(ins)
            if ins[1].split(".")[0] in BRANCHES:
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        # shuffles a step: per sample one SHFL.UP a plane in the chain, one
        # SHFL.IDX of x in the producer; per pair two of each
        planes = 2 if ("skip" in name or "pair" in name) else 1
        x_per = 2 if "pair" in name else 1
        entry = {"kernel": name, "instructions": len(instrs),
                 "step": "pair" if "pair" in name else "sample"}
        for role, key, per in (("chain", "SHFL.UP", planes), ("producer", "SHFL.IDX", x_per)):
            # a producer block holds no SHFL.UP (a chain block may hold SHFL.IDX)
            cands = [b for b in blocks if any(op.startswith(key) for _, op, _ in b)
                     and (role == "chain"
                          or not any(op.startswith("SHFL.UP") for _, op, _ in b))]
            if not cands:
                continue
            big = max(cands, key=len)
            steps = sum(op.startswith(key) for _, op, _ in big) // per
            ops = collections.Counter(op.split(".")[0] for _, op, _ in big)
            entry[role] = {"block_instructions": len(big), "steps": steps,
                           "instructions_per_step": len(big) / steps,
                           "stall_cycles_per_step": sum(st for _, _, st in big) / steps,
                           "opcodes": dict(ops.most_common())}
        report.append(entry)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "fill_sass.txt"), "w") as f:
        f.write("\n".join(keep))
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="root of the older checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="where fill_sass.txt goes (default: the build directory)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fill_turns: no CUDA device", file=sys.stderr)
        return 2
    smi = lambda q: subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.emit({"nvidia_smi": smi("name,power.limit"),
             "clocks": smi("clocks.sm,clocks.max.sm"), "torch": torch.__version__})
    old = build_old(args.old)
    new = kernel_build.load_library()
    for B in range(128, 1025, 128):
        for variant, skip, pair in ((0, False, False), (1, True, False), (2, False, True)):
            assert new.nadavca_fill_slots_per_lane(B, variant) == \
                cuda_dp.fill_layout(B, skip, pair)[0], (B, variant)
    cs.emit({"ptxas": ptxas_report()})
    cs.emit({"sass": sass_report(
        args.out or os.path.dirname(kernel_build.build_library()))})
    reps = args.reps
    for name, cfg, (batch, a) in all_batches(args.seed):
        B = cfg.band_width
        fargs = (a["x"], a["t_len"], a["mu"], a["sigma"], a["lo"], a["delta"], a["n_ref"])
        steps = int(a["t_len"].max())
        mu_b, sg_b = cuda_dp.band_gather_plain(a["mu"], a["sigma"], a["lo"], B)
        bands = fargs[:2] + (mu_b, sg_b) + fargs[4:]
        o_mu, o_sg = old_gather(old, fargs, B)
        assert torch.equal(o_mu, mu_b) and torch.equal(o_sg, sg_b), name
        del o_mu, o_sg
        out = {"batch": name, "R": batch.x.shape[0], "T": batch.x.shape[1], "B": B,
               "serial_steps": steps, "reps": reps}
        turns = []
        if cfg.use_skip:
            # K7a alone: the control
            want = cuda_dp.viterbi_fill_plain(*bands, cfg)
            f_old, f_new = fill_fns(old, cfg), fill_fns(new, cfg)
            assert_same(f"{name}: old", f_old(fargs), want)
            assert_same(f"{name}: new", f_new(fargs), want)
            out["control_single_step_old_new_new_old_ms"] = [
                cs.event_ms(lambda: f(fargs), reps) for f in (f_old, f_new, f_new, f_old)]
        else:
            # the older gather + two-sample fill against this checkout's, the
            # single-step fill (K1) of both in the same turns as the control
            cfg_pair = nt.AlignConfig(band_width=B, dp_pair_step=True)
            want = cuda_dp.viterbi_fill_pair_plain(*bands, cfg_pair)
            p_old, p_new = old_pair_fn(old, cfg_pair), new_pair_fn(new, cfg_pair)
            assert_same(f"{name}: old pair", p_old(fargs), want, exact=True)
            assert_same(f"{name}: new pair", p_new(fargs), want, exact=True)
            assert_same(f"{name}: pair wrapper", cuda_dp.viterbi_fill(*fargs, cfg_pair),
                        want, exact=True)
            single = nt.AlignConfig(band_width=B)
            f_old, f_new = fill_fns(old, single), fill_fns(new, single)
            assert_same(f"{name}: single", f_new(fargs), f_old(fargs))
            order = (p_old, f_old, p_new, f_new, p_new, f_new, p_old, f_old)
            t = [cs.event_ms(lambda: f(fargs), reps) for f in order]
            turns = [t[0], t[2], t[4], t[6]]
            out.update(
                kernel="band_gather + viterbi_fill_pair -> viterbi_fill_pair (folded)",
                pair_old_new_new_old_ms=turns,
                pair_speedup=(turns[0] + turns[3]) / (turns[1] + turns[2]),
                pair_ns_per_step_old=(turns[0] + turns[3]) / 2 / steps * 1e6,
                pair_ns_per_step_new=(turns[1] + turns[2]) / 2 / steps * 1e6,
                control_single_step_old_new_new_old_ms=[t[1], t[3], t[5], t[7]],
                pair_device_ms_old=cs.device_ms(lambda: p_old(fargs), reps),
                pair_device_ms_new=cs.device_ms(lambda: p_new(fargs), reps))
            # the two-sample fill's layouts
            S_kept, W_kept = cuda_dp.fill_layout(B, pair_step=True)
            fns = {s: new_pair_fn(new, cfg_pair, s) for s in layouts(B, pair=True)}
            for s, f in fns.items():
                assert_same(f"{name}: pair S={s}", f(fargs), want, exact=True)
            ms = time_layouts(fns, fargs, reps)
            out["pair_layout_kept"] = [S_kept, W_kept]
            out["pair_layouts"] = [
                {"S": s, "W": -(-B // (32 * s)), "kept": s == S_kept, "ms_in_turns": ms[s],
                 "ns_per_step": sum(ms[s]) / len(ms[s]) / steps * 1e6} for s in fns]
        # the single-step fill's layouts
        want = cuda_dp.viterbi_fill_plain(*bands, cfg if cfg.use_skip
                                          else nt.AlignConfig(band_width=B))
        cfg_s = cfg if cfg.use_skip else nt.AlignConfig(band_width=B)
        S_kept, W_kept = cuda_dp.fill_layout(B, cfg.use_skip)
        fns = {s: fill_fns(new, cfg_s, s) for s in layouts(B)}
        for s, f in fns.items():
            assert_same(f"{name}: S={s}", f(fargs), want)
        ms = time_layouts(fns, fargs, reps)
        out["single_step_layout_kept"] = [S_kept, W_kept]
        out["single_step_layouts"] = [
            {"S": s, "W": B // (32 * s), "kept": s == S_kept, "ms_in_turns": ms[s],
             "ns_per_step": sum(ms[s]) / len(ms[s]) / steps * 1e6} for s in fns]
        out["clocks_after"] = smi("clocks.sm")
        cs.emit(out)
        del want, mu_b, sg_b, bands
    return 0


def all_batches(seed: int):
    """The walk's batches (``torch_walk_turns.batches``), then the default
    reads banded at B = 384 and 512."""
    yield from batches(seed)
    model, reference, reads, _ = cs.make_world(seed, 25000, 20, 512, 1000)
    for B in (384, 512):
        cfg = nt.AlignConfig(band_width=B)
        _, records = cs.records_of(reads, reference, model, cfg)
        top = sorted(records, key=lambda r: len(r.signal))[-256:]
        yield f"main, B={B}", cfg, cs.staged_batch(top, model, cfg)


if __name__ == "__main__":
    sys.exit(main())
