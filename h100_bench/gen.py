"""The benchmark's inputs, made from the seed: genome, planted SNPs, pore model
and reads with their true alignment.

A vectorised copy of the squiggle simulator of ``nadavca_tpu_torch/io/
simulator.py`` (geometric dwell per k-mer position, Gaussian samples around
the pore model's level), made for pools of thousands of reads: the genome and
the windows in NumPy, the samples in a few large PyTorch calls on the card.
It imports nothing of the program, so the reference and the tests use it
too.

The work is the same for every seed: the reads' lengths and dwell times come
from the traffic file's ``shape_seed``, and only the genome, the SNPs, where
and on which strand each read lies, the noise and the order of the reads
change with ``--seed``. Each padded batch shape then holds the same number of
reads in every run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

# complement of the codes A=0 C=1 G=2 T=3 (N=4 stays N)
_COMPLEMENT = np.array([3, 2, 1, 0, 4], np.int8)


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[codes[::-1]]


def kmer_ids(codes: np.ndarray, k: int) -> np.ndarray:
    """Big-endian base-4 id of every k-mer of ``codes`` (len - k + 1 of
    them), -1 where a k-mer holds a base other than ACGT."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, np.int64)
    ids = np.zeros(n, np.int64)
    bad = np.zeros(n, bool)
    for off in range(k):
        w = codes[off:off + n].astype(np.int64)
        bad |= w > 3
        ids = ids * 4 + np.clip(w, 0, 3)
    ids[bad] = -1
    return ids


def pore_model(k: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(level_mean, level_std), each (4^k,) float32: the arithmetic of the
    program's packaged default model (a synthetic, deterministic table with
    the levels dominated by the central bases, unit scale)."""
    rng = np.random.default_rng(seed)
    n = 4 ** k
    base_vals = rng.normal(0.0, 1.0, size=(k, 4))
    pos = np.arange(k)
    weights = np.exp(-0.5 * ((pos - (k - 1) / 2.0) / (k / 4.0)) ** 2)
    weights = weights / weights.sum()
    levels = np.zeros(n, np.float64)
    rem = np.arange(n)
    for p in range(k - 1, -1, -1):
        levels += weights[p] * base_vals[p, rem % 4]
        rem = rem // 4
    levels += rng.normal(0.0, 0.05, size=n)
    levels = (levels - levels.mean()) / levels.std()
    stds = np.exp(rng.normal(np.log(0.18), 0.15, size=n))
    return levels.astype(np.float32), stds.astype(np.float32)


def batch_keys(t: np.ndarray, align: dict) -> np.ndarray:
    """The bin of each read of ``t`` samples: (n, 2) int64 rows (its padded
    length — the first bucket edge at or above it, beyond the last a
    multiple of the last — and whether it takes the wide band)."""
    edges = np.asarray(align["bucket_edges"], np.int64)
    t = np.asarray(t, np.int64)
    i = np.searchsorted(edges, t, side="left")
    b = np.where(i < len(edges), edges[np.minimum(i, len(edges) - 1)],
                 -(-t // edges[-1]) * edges[-1])
    return np.stack([b, t > align["adaptive_band_threshold"]], axis=1)


def _draw_bases(rng, lengths: dict, n: int) -> np.ndarray:
    if lengths["kind"] == "fixed":
        return np.full(n, int(lengths["bases"]), np.int64)
    if lengths["kind"] == "lognormal":
        b = np.exp(rng.normal(np.log(lengths["median"]), lengths["sigma_ln"], n))
        return np.clip(np.round(b), lengths["min"], lengths["max"]).astype(np.int64)
    raise ValueError(f"unknown length kind {lengths['kind']!r}")


def _batches_per_key(traffic: dict, align: dict, k: int) -> Dict[Tuple[int, bool], int]:
    """How many full batches each bin gets: the traffic's ``batches`` shared
    out by each bin's share of the length distribution (largest remainder),
    the shares estimated from 65,536 lengths at the mean dwell."""
    rng = np.random.default_rng([traffic["shape_seed"], 1])
    bases = _draw_bases(rng, traffic["lengths"], 1 << 16)
    t_est = (bases - k + 1) * float(traffic["mean_dwell"])
    keys, counts = np.unique(batch_keys(t_est.astype(np.int64), align), axis=0,
                             return_counts=True)
    share = counts / counts.sum() * traffic["batches"]
    n = np.floor(share).astype(np.int64)
    for i in np.argsort(-(share - n), kind="stable")[:traffic["batches"] - int(n.sum())]:
        n[i] += 1
    return {(int(a), bool(b)): int(c) for (a, b), c in zip(keys, n) if c > 0}


@dataclasses.dataclass
class Shapes:
    """The reads' sizes, the same for every seed: bases and per-position dwell
    times of read i (in the order of the bins, not yet shuffled)."""

    bases: np.ndarray        # (n,) int64
    dwell_off: np.ndarray    # (n + 1,) int64 offsets into ``dwells``
    dwells: np.ndarray       # (sum of k-mer positions,) int32, each >= 1

    @property
    def t_len(self) -> np.ndarray:
        return np.add.reduceat(self.dwells.astype(np.int64), self.dwell_off[:-1])


def read_shapes(traffic: dict, align: dict, k: int) -> Shapes:
    """Bases and dwell times of every read of the pool, from the traffic's
    ``shape_seed`` alone: reads are drawn until each bin holds its batches'
    worth (``batch_reads`` each), so every batch is full."""
    want = {key: n * traffic["batch_reads"]
            for key, n in _batches_per_key(traffic, align, k).items()}
    got: Dict[Tuple[int, bool], List[Tuple[int, np.ndarray]]] = {key: [] for key in want}
    rng = np.random.default_rng([traffic["shape_seed"], 2])
    p = 1.0 / float(traffic["mean_dwell"])
    while any(len(got[key]) < n for key, n in want.items()):
        bases = _draw_bases(rng, traffic["lengths"], 4096)
        # dwell times only for reads that may land in a bin still short of
        # reads (their length within 10% of the mean dwell's estimate)
        t_est = (bases - k + 1) * float(traffic["mean_dwell"])
        open_keys = {key for key, n in want.items() if len(got[key]) < n}
        cand = np.zeros(len(bases), bool)
        for f in (0.9, 1.0, 1.1):
            keys = batch_keys((t_est * f).astype(np.int64), align)
            cand |= np.array([(int(a), bool(b)) in open_keys for a, b in keys])
        bases = bases[cand]
        if len(bases) == 0:
            continue
        npos = bases - k + 1
        # geometric dwells (>= 1) by inversion, in float32 for speed
        u = rng.random(int(npos.sum()), dtype=np.float32)
        dw = (np.log1p(-u) * np.float32(1.0 / np.log1p(-p))).astype(np.int32) + 1
        off = np.concatenate([[0], np.cumsum(npos)])
        t = np.add.reduceat(dw.astype(np.int64), off[:-1])
        keys = batch_keys(t, align)
        for i in range(len(bases)):
            key = (int(keys[i, 0]), bool(keys[i, 1]))
            if key in want and len(got[key]) < want[key]:
                got[key].append((int(bases[i]), dw[off[i]:off[i + 1]]))
    reads = [r for key in sorted(got) for r in got[key]]
    dwells = np.concatenate([d for _, d in reads])
    off = np.concatenate([[0], np.cumsum([len(d) for _, d in reads])]).astype(np.int64)
    return Shapes(np.array([b for b, _ in reads], np.int64), off, dwells)


@dataclasses.dataclass
class Inputs:
    """Everything a run feeds to both sides, in stream order."""

    contig: str
    ref: np.ndarray              # (G,) int8 reference genome
    sample: np.ndarray           # (G,) int8 the sequenced genome (SNPs planted)
    level_mean: np.ndarray       # (4^k,) float32
    level_std: np.ndarray        # (4^k,) float32
    read_ids: List[str]
    signal: List[np.ndarray]     # (t,) float32 each, at the pore model's scale
    path: List[np.ndarray]       # (t,) int32 each: true k-mer position per sample
    start: np.ndarray            # (n,) int64 genome start of each read's window
    bases: np.ndarray            # (n,) int64 window length
    strand: np.ndarray           # (n,) int64 +1 / -1

    def window(self, i: int) -> np.ndarray:
        """The reference bases of read i's window, in the read's direction."""
        w = self.ref[self.start[i]:self.start[i] + self.bases[i]]
        return reverse_complement(w) if self.strand[i] < 0 else w


def make_inputs(config: dict, traffic: dict, seed: int, device: str = "cpu") -> Inputs:
    """Genome, SNPs and reads of one run; the samples are drawn on ``device``
    (the same seed gives the same inputs on one kind of device)."""
    k = int(config["align"]["k"])
    shapes = read_shapes(traffic, config["align"], k)
    rng = np.random.default_rng([int(seed), 0x5eed])
    G = int(config["genome"]["length"])
    ref = rng.integers(0, 4, size=G, dtype=np.int8)
    n_snp = int(round(G * float(traffic["snp_rate"])))
    snp_pos = np.sort(rng.choice(G, size=n_snp, replace=False)).astype(np.int64)
    sample = ref.copy()
    sample[snp_pos] = (ref[snp_pos] + rng.integers(1, 4, size=n_snp)) % 4
    mean, std = pore_model(k, int(config["pore_model"]["seed"]))

    n = len(shapes.bases)
    order = rng.permutation(n)
    bases = shapes.bases[order]
    start = np.floor(rng.random(n) * (G - bases + 1)).astype(np.int64)
    strand = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int64)

    # every read's window of the sample genome, in its direction, end to end
    b_off = np.concatenate([[0], np.cumsum(bases)])
    rev = np.repeat(strand < 0, bases)
    li = np.arange(b_off[-1]) - np.repeat(b_off[:-1], bases)
    g = np.repeat(start, bases) + np.where(rev, np.repeat(bases, bases) - 1 - li, li)
    codes = sample[g]
    codes = np.where(rev, 3 - codes, codes).astype(np.int64)
    del li, g, rev
    # k-mer ids of each read's k-mer positions
    npos = bases - k + 1
    p_off = np.concatenate([[0], np.cumsum(npos)])
    ids_all = np.zeros(len(codes) - k + 1, np.int64)
    for off in range(k):
        ids_all = ids_all * 4 + codes[off:len(codes) - k + 1 + off]
    ids = ids_all[np.arange(p_off[-1]) + np.repeat(b_off[:-1] - p_off[:-1], npos)]
    del codes, ids_all
    # dwell times in stream order, then the samples: true k-mer position and
    # a Gaussian draw around its level, made on ``device`` in a few large
    # calls (hundreds of millions of samples in the long mix)
    dw_src = shapes.dwell_off[order]
    dwells = shapes.dwells[np.arange(p_off[-1]) + np.repeat(dw_src - p_off[:-1], npos)]
    t_len = np.add.reduceat(dwells.astype(np.int64), p_off[:-1])
    t_off = np.concatenate([[0], np.cumsum(t_len)])
    dev = torch.device(device)
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(int(rng.integers(0, 2 ** 62)))
    gk = torch.repeat_interleave(torch.arange(p_off[-1], dtype=torch.int32, device=dev),
                                 torch.from_numpy(dwells).to(dev))
    del dwells
    sig = torch.randn(len(gk), generator=gen_t, device=dev, dtype=torch.float32)
    sig *= float(traffic["noise_scale"])
    sig *= torch.from_numpy(std[ids]).to(dev)[gk]
    sig += torch.from_numpy(mean[ids]).to(dev)[gk]
    gk -= torch.repeat_interleave(torch.from_numpy(p_off[:-1].astype(np.int32)).to(dev),
                                  torch.from_numpy(t_len).to(dev))
    signal = np.split(sig.cpu().numpy(), t_off[1:-1])
    path = np.split(gk.cpu().numpy(), t_off[1:-1])
    del sig, gk
    return Inputs(
        contig=config["genome"]["contig"], ref=ref, sample=sample,
        level_mean=mean, level_std=std, read_ids=[f"r{i}" for i in range(n)],
        signal=signal, path=path, start=start, bases=bases, strand=strand)
