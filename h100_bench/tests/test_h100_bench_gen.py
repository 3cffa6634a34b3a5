"""The generator: the same seed gives the same pool, another seed another
pool of the same sizes."""

import json
import os

import numpy as np

from conftest import ROOT, TINY_CELL
from h100_bench import gen, reference, spec


def _inputs(root, seed):
    c = spec.cell(TINY_CELL, root)
    return c, gen.make_inputs(c.config, c.traffic, seed)


def test_same_seed_same_pool(tiny_root):
    _, a = _inputs(tiny_root, 2 ** 33 + 5)
    _, b = _inputs(tiny_root, 2 ** 33 + 5)
    assert np.array_equal(a.ref, b.ref) and np.array_equal(a.sample, b.sample)
    assert np.array_equal(a.start, b.start) and np.array_equal(a.strand, b.strand)
    assert all(np.array_equal(x, y) for x, y in zip(a.signal, b.signal))


def test_other_seed_other_pool_same_sizes(tiny_root):
    c, a = _inputs(tiny_root, 2 ** 33 + 5)
    _, b = _inputs(tiny_root, 2 ** 33 + 6)
    assert not np.array_equal(a.ref, b.ref)
    assert not np.array_equal(a.start, b.start)
    ta = sorted(len(s) for s in a.signal)
    assert ta == sorted(len(s) for s in b.signal)
    assert sorted(a.bases) == sorted(b.bases)
    align = c.config["align"]
    ga = reference.group([len(s) for s in a.signal], a.bases, align, 8)
    gb = reference.group([len(s) for s in b.signal], b.bases, align, 8)
    assert sorted((g.T, g.band) for g in ga) == sorted((g.T, g.band) for g in gb)
    assert len(ga) == c.traffic["batches"]


def test_signal_follows_the_true_path(tiny_root):
    _, a = _inputs(tiny_root, 77)
    k = 6
    for i in range(4):
        w = a.sample[a.start[i]:a.start[i] + a.bases[i]]
        if a.strand[i] < 0:
            w = gen.reverse_complement(w)
        ids = gen.kmer_ids(w, k)
        p = a.path[i]
        assert p[0] == 0 and p[-1] == len(ids) - 1 and (np.diff(p) >= 0).all()
        z = (a.signal[i] - a.level_mean[ids][p]) / a.level_std[ids][p]
        assert abs(float(z.mean())) < 0.2 and 0.8 < float(z.std()) < 1.2


def test_every_pool_batch_is_full_at_full_size():
    """The long mix's bins hold whole batches only (sizes only, no signal)."""
    with open(os.path.join(ROOT, "h100_bench", "traffic", "snp_long.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(ROOT, "h100_bench", "configs", "lambda_phage.json")) as f:
        align = json.load(f)["align"]
    sh = gen.read_shapes(traffic, align, 6)
    keys = [(int(b), bool(w)) for b, w in gen.batch_keys(sh.t_len, align)]
    counts = {k: keys.count(k) for k in set(keys)}
    assert sum(counts.values()) == traffic["batches"] * traffic["batch_reads"]
    assert all(n % traffic["batch_reads"] == 0 for n in counts.values())
    assert sum(1 for k in keys if k[1]) == len(keys)     # all take the wide band
