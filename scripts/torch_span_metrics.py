#!/usr/bin/env python3
"""What the program's spans and counters say about one traced run of a
benchmark cell.

    python3 scripts/torch_span_metrics.py --workload NAME --seed N --seconds S

Runs ``h100_bench.cell.run`` traced on the card, keeping the window's
profile and the process registry's counters
(``nadavca_tpu_torch.utils.metrics.PROCESS``) at the window's start and end,
and reads with ``h100_bench/program_trace.py`` what the benchmark's own
traced run does not read yet: ``accumulate_ms_per_batch``,
``merge_ms_per_batch``, ``h2d_gb_per_s``, ``upload_async_share`` (the share
of the window's ``upload_bytes`` copied without waiting, from page-locked
memory: ``upload_async_bytes`` over ``upload_bytes``), ``launches_per_batch``, the idle
time by program span (``idle_gaps_program``), the device time by innermost
program span and the step's device operations by name; and the device bytes
of the genome tables built in set-up (``subst_table_bytes``). Three checks:
``accumulate_ms_per_batch`` against ``scatter_ms_per_batch``; the HtoD time
launched inside ``nadavca.upload`` against ``h2d_ms_per_batch`` times the
batches; and, for every operation name, the time put down to a program span
plus the rest against ``Trace.by_name`` (the largest difference, in ns).
Prints one JSON line with the cell's own result (``correct``, its per-layer
metrics, its breakdown) and these numbers; the traced ``reads_per_s`` is the
window's reads over its seconds. Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    sys.path.insert(0, REPO)
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(REPO, ".cache", "cuda"))
    import torch
    from torch import profiler as tprof

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from h100_bench import cell
    from h100_bench import program_trace as pt
    from h100_bench import trace as tracemod
    from nadavca_tpu_torch.utils.metrics import PROCESS

    kept = {}
    base = tprof.profile

    class Kept(base):
        """The cell's profiler, kept, with the counters around the window."""

        def __enter__(self):
            out = super().__enter__()
            kept["prof"] = self
            kept["start"] = dict(PROCESS.counters)
            return out

        def __exit__(self, *exc):
            kept["end"] = dict(PROCESS.counters)
            return super().__exit__(*exc)

    tprof.profile = Kept
    try:
        res = cell.run(args.workload, args.seed, args.seconds, True)
    finally:
        tprof.profile = base

    tr = tracemod.from_profile(kept["prof"])
    prog = pt.from_profile(kept["prof"], tr)
    window = res.pop("_window")
    n = window["batches"]
    upload, upload_async = (kept["end"].get(k, 0) - kept["start"].get(k, 0)
                            for k in ("upload_bytes", "upload_async_bytes"))
    m = {k: v["value"] for k, v in res["metrics"].items()}
    new = {"accumulate_ms_per_batch": pt.ms_per_batch(tr, prog, "nadavca.accumulate", n),
           "merge_ms_per_batch": pt.ms_per_batch(tr, prog, "nadavca.merge", n),
           "h2d_gb_per_s": pt.h2d_gb_per_s(tr, prog, upload),
           "upload_async_share": upload_async / upload if upload else None,
           "launches_per_batch": pt.launches_per_batch(tr, prog, n)}

    by_span = collections.Counter()
    step_ops = collections.Counter()
    for (name, a, b), stack in zip(tr.device, prog.launched_in, strict=True):
        by_span[stack[-1][len(pt.PREFIX):] if stack else pt.OUTSIDE] += (b - a) * 1e-9
        if pt.PREFIX + "step" in stack:
            step_ops[name[:80]] += 1
    total = tr.by_name()
    split = pt.device_ns_by_name(tr, prog)
    h2d_in_upload = pt.device_s_inside(tr, prog, pt.PREFIX + "upload",
                                       lambda x: "HtoD" in x)
    checks = {
        "accumulate_over_scatter": (new["accumulate_ms_per_batch"]
                                    / m["scatter_ms_per_batch"]
                                    if new["accumulate_ms_per_batch"] else None),
        "h2d_in_upload_over_h2d": (h2d_in_upload / (m["h2d_ms_per_batch"] * n * 1e-3)
                                   if m.get("h2d_ms_per_batch") else None),
        "by_name_max_gap_ns": max((abs(i + o - total[k] * 1e9) for k, (i, o)
                                   in split.items()), default=0.0),
        "attributed_s": sum(i for i, _ in split.values()) * 1e-9,
        "unattributed_s": sum(o for _, o in split.values()) * 1e-9,
    }
    out = {"workload": args.workload, "seed": args.seed, "correct": res["correct"],
           "device": res["device"], "batches": n, "cycles": window["cycles"],
           "window_s": window["seconds"],
           "traced_reads_per_s": res["attempted"] / window["seconds"],
           "window_upload_bytes": upload,
           "subst_table_bytes": kept["start"].get("subst_table_bytes"),
           "metrics": m, "new": new, "checks": checks,
           "breakdown": res["breakdown"],
           "idle_gaps_program": pt.breakdown_program(tr, prog),
           "device_s_by_span": dict(by_span.most_common()),
           "step_ops_per_batch": {k: v / n for k, v in step_ops.most_common(30)},
           "program_spans": len(prog.spans),
           # the page-locked blocks PyTorch's host allocator holds (the pool's
           # batches, rounded up by the allocator, and the small staging blocks)
           "host_memory_stats": {
               k: v for k, v in getattr(torch.cuda, "host_memory_stats", dict)().items()
               if "bytes" in k}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
