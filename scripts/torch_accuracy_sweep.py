"""Calling accuracy of the PyTorch/CUDA port over coverage × noise × SNP
density: the port's own copy of ``scripts/accuracy_sweep.py``.

The worlds are the JAX script's, drawn through the port's copy of the
simulator (the same reads for the same seed): SNPs planted into a reference
at a given density, reads simulated from the TRUE genome at a given coverage
and noise with 2 % basecall substitutions, 5 % indels and 3 % pore skips.
Each world runs through the port's pipeline (anchor → banded Viterbi → local
rescore → accumulate → call), batch for batch as the JAX script runs it, and
its calls are scored against the planted truth.

Usage:
  python scripts/torch_accuracy_sweep.py --grid quick --backend scan --device cpu
  python scripts/torch_accuracy_sweep.py --grid full --seeds 7,8,9,10 \\
      --backend both --device cuda

``--backend cuda`` runs the kernels with genome tables, as ``api.call_snps``
runs them (their plain versions on ``--device cpu``); ``scan`` the per-step
twin; ``both`` runs the two on every world and reports their call sets'
symmetric difference. Prints one JSON line per (cell, seed, backend), then
per backend the micro-F1 over the 16×-dense cells (coverage 16, density
1/500) and over all worlds run, as ``scripts/joint_lab.py`` reports them
(``--out FILE`` also writes every line to FILE). Imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the caller's floor: sites below it are honest no-calls, out of recall (the
# CLI default)
MIN_COV = 3
# reads per batch, as the JAX script batches them
BATCH_READS = 256


@dataclasses.dataclass(frozen=True)
class Cell:
    coverage: int
    noise: float
    density: float       # SNPs per base
    read_len: int = 600
    genome_len: int = 8000


QUICK_GRID = [
    Cell(coverage=6, noise=0.8, density=1 / 1000),
    Cell(coverage=12, noise=0.8, density=1 / 1000),
    Cell(coverage=12, noise=1.0, density=1 / 500),
]

FULL_GRID = [
    Cell(coverage=c, noise=nz, density=d)
    for c in (4, 8, 16)
    for nz in (0.8, 1.0, 1.2)
    for d in (1 / 2000, 1 / 500)
]


def dense16(cell: Cell) -> bool:
    """The 16×-dense cells, where the caller's accuracy tail lives."""
    return cell.coverage == 16 and cell.density == 1 / 500


def build_world(cell: Cell, seed: int):
    """Truth genome + SNP-planted reference + simulated reads: the JAX
    script's draws, in its order, through the port's simulator."""
    from nadavca_tpu_torch.genome import Genome, decode_bases
    from nadavca_tpu_torch.io.simulator import random_genome, simulate_read
    from nadavca_tpu_torch.kmer_model import default_model

    rng = np.random.default_rng(seed)
    model = default_model()
    true_genome = random_genome(rng, length=cell.genome_len)
    ref_codes = true_genome["ref"].codes.copy()
    k = model.k
    n_snps = max(1, int(cell.density * cell.genome_len))
    # min spacing 2k keeps each SNP's k-mer neighborhood independent
    candidates = rng.permutation(np.arange(2 * k, cell.genome_len - 2 * k))
    positions, last_taken = [], []
    for p in candidates:
        if all(abs(p - q) >= 2 * k for q in last_taken[-8:]) and \
           all(abs(p - q) >= 2 * k for q in positions):
            positions.append(int(p))
            if len(positions) == n_snps:
                break
    truth = {}
    for p in positions:
        orig = int(ref_codes[p])
        ref_codes[p] = (orig + 1 + int(rng.integers(0, 3))) % 4
        truth[p] = orig
    ref_genome = Genome.from_dict({"ref": decode_bases(ref_codes)})

    n_reads = int(np.ceil(cell.coverage * cell.genome_len / cell.read_len))
    reads = [
        simulate_read(
            true_genome, "ref", model, rng, read_len=cell.read_len,
            start=int(rng.integers(0, cell.genome_len - cell.read_len + 1)),
            strand=1 if rng.random() < 0.5 else -1,
            mean_dwell=9.0, noise_scale=cell.noise,
            basecall_sub_rate=0.02, basecall_ins_rate=0.025,
            basecall_del_rate=0.025, skip_prob=0.03,
        )
        for _ in range(n_reads)
    ]
    return model, true_genome, ref_genome, reads, truth


def score(calls: set, truth: dict, cov: np.ndarray, k: int) -> dict:
    """TP / FP / FN against the planted truth (only truth sites with callable
    coverage count toward recall), and the false calls within k bases of a
    missed site (the signal-space k-mer shift, reported apart)."""
    truth_set = {(p, "ACGT"[b]) for p, b in truth.items()}
    callable_truth = {(p, a) for (p, a) in truth_set if cov[p] >= MIN_COV}
    tp = len(calls & callable_truth)
    fp = len(calls - truth_set)
    fn = len(callable_truth - calls)
    fp_pos = sorted(p for (p, _) in (calls - truth_set))
    fn_pos = sorted(p for (p, _) in (callable_truth - calls))
    n_shifted = sum(1 for p in fp_pos if any(abs(p - q) <= k for q in fn_pos))
    recall = tp / max(1, tp + fn)
    precision = tp / max(1, tp + fp)
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return dict(n_truth=len(truth_set), n_callable=len(callable_truth), tp=tp, fp=fp,
                fn=fn, n_shifted=n_shifted, recall=round(recall, 4),
                precision=round(precision, 4), f1=round(f1, 4))


def prepare(cell: Cell, seed: int):
    """The world and its anchored records, sorted by signal length."""
    from nadavca_tpu_torch.anchor import SeedIndex
    from nadavca_tpu_torch.pipeline import preprocess_read

    model, _, ref_genome, reads, truth = build_world(cell, seed)
    index = SeedIndex(ref_genome)
    records = []
    for rd in reads:
        rec = preprocess_read(rd.signal.astype(np.float32), rd.basecall,
                              rd.move_index, index, ref_genome, rd.read_id)
        if rec is not None:
            records.append(rec)
    records.sort(key=lambda r: len(r.signal))
    return model, ref_genome, reads, truth, records


def run_cell(cell: Cell, backend: str, seed: int, device: str = "cpu", cfg=None,
             world=None):
    """One world through the port; returns (metrics dict, call set).
    ``world``: the result of :func:`prepare`, to run one world under two
    backends without building it twice."""
    import torch

    from nadavca_tpu_torch import call as callmod
    from nadavca_tpu_torch.config import AlignConfig
    from nadavca_tpu_torch.ops.subst_tables import build_subst_tables
    from nadavca_tpu_torch.pipeline import align_batch, assemble_batch

    cfg = cfg or AlignConfig()
    t0 = time.time()
    model, ref_genome, reads, truth, records = world or prepare(cell, seed)
    t1 = time.time()
    subst = (build_subst_tables(ref_genome, model, device=device)
             if backend == "cuda" else None)
    G = len(ref_genome["ref"])
    acc, cov, votes = callmod.make_accumulators(G, with_votes=True, device=device)
    for i in range(0, len(records), BATCH_READS):
        batch = assemble_batch(records[i:i + BATCH_READS], model, cfg)
        n = batch.n_reads
        out = align_batch(batch, model, cfg, backend=backend, device=device, subst=subst)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)
        acc, cov, votes = callmod.accumulate_batch(
            acc, cov, out["base_loglik"][:n], put(batch.window_start),
            put(batch.window_len), put(batch.strand), votes=votes, cfg=cfg)
    acc, cov, votes = acc.cpu().numpy(), cov.cpu().numpy(), votes.cpu().numpy()
    calls = callmod.call_snps(acc, cov, ref_genome["ref"].codes, "ref", cfg,
                              min_coverage=MIN_COV, votes=votes)
    called = {(c.position, c.alt_base) for c in calls}
    metrics = dict(coverage=cell.coverage, noise=cell.noise, density=cell.density,
                   seed=seed, backend=backend, device=device, n_reads=len(reads),
                   n_anchored=len(records), **score(called, truth, cov, model.k),
                   prep_s=round(t1 - t0, 3), align_call_s=round(time.time() - t1, 3),
                   calls=sorted([int(p), b] for p, b in called))
    return metrics, called


def micro_f1(rows) -> dict:
    tp, fp, fn = (sum(r[key] for r in rows) for key in ("tp", "fp", "fn"))
    prec, rec = tp / max(1, tp + fp), tp / max(1, tp + fn)
    return dict(worlds=len(rows), tp=tp, fp=fp, fn=fn,
                micro_f1=2 * prec * rec / max(1e-9, prec + rec))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", choices=("quick", "full"), default="quick")
    ap.add_argument("--backend", choices=("scan", "cuda", "both"), default="scan")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--seeds", default="7")
    ap.add_argument("--out", default=None, help="also write every JSON line here")
    args = ap.parse_args(argv)

    grid = QUICK_GRID if args.grid == "quick" else FULL_GRID
    seeds = [int(s) for s in args.seeds.split(",")]
    backends = ["scan", "cuda"] if args.backend == "both" else [args.backend]
    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    rows = {be: [] for be in backends}
    for cell in grid:
        for seed in seeds:
            world = prepare(cell, seed)
            cell_calls = {}
            for be in backends:
                m, calls = run_cell(cell, be, seed, device=args.device, world=world)
                cell_calls[be] = calls
                m["dense16"] = dense16(cell)
                rows[be].append(m)
                emit(m)
            if len(backends) == 2:
                diff = cell_calls["scan"] ^ cell_calls["cuda"]
                emit(dict(coverage=cell.coverage, noise=cell.noise, density=cell.density,
                          seed=seed, backend="scan^cuda", n_call_diffs=len(diff),
                          diffs=sorted(diff)[:10]))
    for be in backends:
        emit(dict(summary=be, device=args.device, grid=args.grid, seeds=seeds,
                  dense16=micro_f1([r for r in rows[be] if r["dense16"]]),
                  all=micro_f1(rows[be])))
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
