#!/usr/bin/env python3
"""End-to-end reads/s of two checkouts of the port, in turns, on one card.

    python3 scripts/torch_e2e_turns.py --old DIR [--pairs 2]

``DIR`` is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit). Each measurement is a fresh
process that imports one checkout's ``nadavca_tpu_torch`` and
``chip_smoke.py``, builds the smoke world of ``chip_smoke.py`` (seed 0, 512
reads × 1000 bases; the same reads simulated with pore skips for the skip
configuration), warms the kernels up on one small batch, then times
``api.call_snps_reads`` on the card for ``AlignConfig()`` and for the skip
configuration, and ``api.align_reads``. As a control it also times the host
prep of the same reads alone (``api._preprocess``: Python and numpy, no
card), which no change to the device path touches: a slot in which the host
is busier shows there as well. The processes run in the order new, old, old,
new, repeated ``--pairs`` times, so that neither side has the same slots.
Prints one JSON line per process and a summary line with the medians. Needs
a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import nadavca_tpu_torch as nt
    from nadavca_tpu_torch import api

    if not torch.cuda.is_available():
        raise SystemExit(2)
    kw = dict(backend="cuda", batch_reads=256, prep="python", device="cuda")
    out = {"root": os.path.relpath(root, REPO) if root != REPO else "."}
    for name, fields, skip_prob, seed in (("default", {}, 0.0, 0),
                                          ("skip", cs.SKIP_FIELDS, cs.SKIP_PROB, 2)):
        cfg = nt.AlignConfig(**fields)
        model, reference, reads, _ = cs.make_world(seed, 25000, 20, 512, 1000,
                                                   skip_prob=skip_prob)
        raws = [api.raw_read_from_simulated(r) for r in reads]
        api.call_snps_reads(reference, raws[:32], config=cfg, model=model, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api._preprocess(raws, reference, model, cfg, prep="python")
        out[f"{name}_host_prep_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        calls = api.call_snps_reads(reference, raws, config=cfg, model=model, **kw)
        torch.cuda.synchronize()
        out[f"{name}_call_snps_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        alns = api.align_reads(reference, raws, config=cfg, model=model, **kw)
        torch.cuda.synchronize()
        out[f"{name}_align_s"] = time.perf_counter() - t0
        out[f"{name}_reads_per_s"] = len(alns) / out[f"{name}_call_snps_s"]
        out[f"{name}_calls"] = len(calls)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="root of the older checkout")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.worker))), flush=True)
        return 0
    if not args.old:
        ap.error("--old is required")
    sides = {"new": REPO, "old": os.path.abspath(args.old)}
    results = {"new": [], "old": []}
    for _ in range(args.pairs):
        for side in ("new", "old", "old", "new"):
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--worker", sides[side]],
                               capture_output=True, text=True, cwd=sides[side])
            if p.returncode != 0:
                sys.stderr.write(p.stdout + p.stderr)
                return p.returncode
            res = json.loads(p.stdout.strip().splitlines()[-1])
            res["side"] = side
            results[side].append(res)
            print(json.dumps(res), flush=True)
    keys = [k for k in results["new"][0] if k.endswith(("_s", "_per_s"))]
    print(json.dumps({"medians": {side: {k: statistics.median(r[k] for r in rs)
                                         for k in keys}
                                  for side, rs in results.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
