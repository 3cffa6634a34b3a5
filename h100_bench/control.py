"""Readings that set the check's limits: the program over many seeds, and the
control, which the check has to fail.

    python3 h100_bench/control.py --workload <name> --control-seeds a,b,c \\
        [--program-seeds d,e,... --seconds 1]

The control is the reference put in the program's place and computed in the
precision below the configuration's float32: every intermediate rounded to
bfloat16 (``reference.Precision("bfloat16")``). It gives the sampled reads'
scores and log-likelihoods, which the check compares with the float64
reference as it compares the program's, and their sums into the genome,
compared as the check compares the accumulators. The program's readings are whole runs
of the cell (``cell.run``) with a short window, several seeds in one process
so that start-up is paid once. Each reading is one JSON line on standard
output. The benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(cell_name: str, seed: int, root: str, precision: str = "bfloat16",
                    device: str = "cpu"):
    """The check's per-read numbers for the reference in ``precision`` in
    the program's place, on the cell's pool and sample of ``seed``."""
    from h100_bench import cell, gen, reference, spec

    c = spec.cell(cell_name, root)
    align = c.config["align"]
    inputs = gen.make_inputs(c.config, c.traffic, seed, device=device)
    batches = reference.group([len(s) for s in inputs.signal], inputs.bases, align,
                              c.traffic["batch_reads"])
    low = reference.Precision(precision)
    sample = cell.sample_reads(batches, c.traffic, align["read_tile"], seed)
    jobs = [(inputs.signal[m], inputs.path[m], inputs.window(m), batches[b], align,
             inputs.level_mean, inputs.level_std) for m, (b, _) in sample.items()]
    ref = reference.answers_of_reads(jobs)
    lows = reference.answers_of_reads([j + (low,) for j in jobs])
    pairs = [([s_low], s_ref, len(j[0]), ll_low, ll_ref)
             for j, (s_ref, ll_ref), (s_low, ll_low) in zip(jobs, ref, lows)]
    # the scatter layer: the sampled reads' log-likelihoods summed into their
    # genome positions read by read, the control's in its precision
    where = dict(starts=inputs.start[list(sample)], wlens=inputs.bases[list(sample)],
                 strands=inputs.strand[list(sample)], clip=align["snp_ll_clip"])
    acc_ref = reference.window_sums([ll for _, ll in ref], **where)
    acc_low = reference.window_sums([ll for _, ll in lows], q=low, **where)
    nums = cell.read_gaps(pairs)
    nums["acc_rel_gap"] = float(np.abs(acc_low - acc_ref).max()
                                / max(np.abs(acc_ref).max(), 1e-30))
    return nums


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--program-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from h100_bench import cell

    for s in filter(None, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        nums = control_numbers(args.workload, int(s), ROOT, device=args.device)
        print(json.dumps({"workload": args.workload, "side": "control_bfloat16",
                          "seed": int(s), "numbers": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    for s in filter(None, args.program_seeds.split(",")):
        res = cell.run(args.workload, int(s), args.seconds, False, device=args.device,
                       root=ROOT)
        print(json.dumps({"workload": args.workload, "side": "program", "seed": int(s),
                          "numbers": {k: v["value"] for k, v in res["checks"].items()},
                          "metrics": res["metrics"], "window": res["_window"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
