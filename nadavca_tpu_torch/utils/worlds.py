"""The JAX package's own test worlds, as builders over a package namespace.

Each builder draws the numbers of one JAX test (``tests/test_edge_cases.py``,
``tests/test_anchor_indel.py``) from its seed, in its order, through the
simulator, anchorer and batch assembler of the namespace it is given: the
port's own (:data:`PORT`, the default) or, in the tests that hold the two
packages to each other, the JAX package's. A world is a dict: the pore
``model``, the reference ``genome`` and its ``codes`` (one contig, ``"ref"``),
the simulated ``reads``, the configuration ``cfg``, the ``batches`` its
records assemble into, and how the JAX test calls it (``min_coverage``,
``votes``). :func:`three_contigs` is the multi-contig world, which neither
package's simulator makes; only the port builds it.

Run by the tests, ``chip_smoke.py``'s ``reference_worlds`` phase and
``tests/test_torch_card.py``; nothing of the pipeline calls it.
"""

from __future__ import annotations

import types

import numpy as np
import torch

import nadavca_tpu_torch
from nadavca_tpu_torch import anchor, genome, pipeline
from nadavca_tpu_torch.io import simulator

# 5 % indel basecalls and 2 % substitutions (tests/test_anchor_indel.py)
INDEL = dict(basecall_sub_rate=0.02, basecall_ins_rate=0.025, basecall_del_rate=0.025)
# the N run of world 1, in reference coordinates
N_RUN = (600, 620)


def namespace(root, anchor_mod, genome_mod, pipeline_mod, simulator_mod):
    """The functions a builder draws with, from one package's modules."""
    return types.SimpleNamespace(
        AlignConfig=root.AlignConfig, default_model=root.default_model,
        Genome=genome_mod.Genome, decode_bases=genome_mod.decode_bases,
        SeedIndex=anchor_mod.SeedIndex, anchor_basecall=anchor_mod.anchor_basecall,
        signal_anchor_path=anchor_mod.signal_anchor_path,
        random_genome=simulator_mod.random_genome,
        simulate_read=simulator_mod.simulate_read,
        preprocess_read=pipeline_mod.preprocess_read,
        assemble_batch=pipeline_mod.assemble_batch)


PORT = namespace(nadavca_tpu_torch, anchor, genome, pipeline, simulator)


def records(pkg, reads, index, ref, model=None):
    """Anchored records of the reads (those that anchor), in read order."""
    recs = [pkg.preprocess_read(r.signal.astype(np.float32), r.basecall, r.move_index,
                                index, ref, r.read_id, model=model) for r in reads]
    return [r for r in recs if r is not None]


def _world(pkg, model, ref, codes, reads, recs, cfg, **calling):
    return dict(model=model, genome=ref, codes=codes, reads=reads, cfg=cfg,
                batches=[pkg.assemble_batch(recs, model, cfg)], **calling)


def n_run(pkg=PORT) -> dict:
    """World 1 (``test_reference_with_N_bases``, seed 8): 8 reads of 300
    bases simulated from a clean 1200-base genome, aligned against the same
    genome with ``N`` at 600–619."""
    rng = np.random.default_rng(8)
    model = pkg.default_model()
    clean = pkg.random_genome(rng, length=1200)
    codes = clean["ref"].codes.copy()
    codes[N_RUN[0]:N_RUN[1]] = 4
    ref = pkg.Genome.from_dict({"ref": pkg.decode_bases(codes)})
    index = pkg.SeedIndex(ref)
    reads = [pkg.simulate_read(clean, "ref", model, rng, read_len=300,
                               start=int(rng.integers(400, 700)), strand=1)
             for _ in range(8)]
    return _world(pkg, model, ref, codes, reads, records(pkg, reads, index, ref, model),
                  pkg.AlignConfig(read_tile=8), min_coverage=1, votes=True)


def samples_in_n_run(batch, path_a, path_b) -> int:
    """The tie limit of world 1: the live samples that either path places
    inside the N run (the k-mer positions that hold an N, whose level is 0
    and spread 1)."""
    n_pos = batch.ids.shape[1]
    in_run = torch.from_numpy((batch.ids < 0)
                              & (np.arange(n_pos)[None, :] < batch.n_ref[:, None]))
    live = torch.arange(batch.x.shape[1])[None, :] < torch.from_numpy(batch.t_len)[:, None]
    live[batch.n_reads:] = False
    placed = torch.zeros_like(live)
    for path in (path_a, path_b):
        placed |= torch.gather(in_run, 1, torch.as_tensor(path).cpu().long())
    return int((placed & live).sum())


def one_read(pkg=PORT) -> dict:
    """World 2 (``test_single_read_batch``, seed 9): one read of 200 bases
    of a 600-base genome, in a batch padded to its read tile of 8 rows."""
    rng = np.random.default_rng(9)
    model = pkg.default_model()
    ref = pkg.random_genome(rng, length=600)
    rd = pkg.simulate_read(ref, "ref", model, rng, read_len=200, strand=1)
    return _world(pkg, model, ref, ref["ref"].codes, [rd],
                  records(pkg, [rd], pkg.SeedIndex(ref), ref, model),
                  pkg.AlignConfig(read_tile=8), min_coverage=1, votes=True)


def narrow_window(pkg=PORT) -> dict:
    """World 3 (``test_window_shorter_than_band``, seed 10): a read of the
    whole of a 60-base genome, so its window (55 k-mer positions) is
    narrower than the band of 128 slots."""
    rng = np.random.default_rng(10)
    model = pkg.default_model()
    ref = pkg.random_genome(rng, length=60)
    rd = pkg.simulate_read(ref, "ref", model, rng, read_len=60, strand=1,
                           basecall_sub_rate=0.0)
    return _world(pkg, model, ref, ref["ref"].codes, [rd],
                  records(pkg, [rd], pkg.SeedIndex(ref), ref, model),
                  pkg.AlignConfig(read_tile=8), min_coverage=1, votes=True)


def indel_calls(pkg=PORT) -> dict:
    """World 5 (``test_e2e_snp_recall_unchanged_with_indels``, seed 2025): 12
    reads of 600 bases with 5 % indel basecalls, on both strands, over a
    3000-base genome with SNPs planted at 1000 and 2000 (``truth``: position
    to the sample's base), called without votes at coverage 2."""
    rng = np.random.default_rng(2025)
    model = pkg.default_model()
    true_genome = pkg.random_genome(rng, length=3000)
    codes = true_genome["ref"].codes.copy()
    truth = {}
    for p in (1000, 2000):
        orig = int(codes[p])
        codes[p] = (orig + 1) % 4
        truth[p] = orig
    ref = pkg.Genome.from_dict({"ref": pkg.decode_bases(codes)})
    reads = [pkg.simulate_read(true_genome, "ref", model, rng, read_len=600,
                               start=rng.integers(0, 2400), strand=1 if i % 2 else -1,
                               mean_dwell=9.0, noise_scale=0.8, **INDEL)
             for i in range(12)]
    w = _world(pkg, model, ref, codes, reads,
               records(pkg, reads, pkg.SeedIndex(ref), ref), pkg.AlignConfig(),
               min_coverage=2, votes=False)
    w["truth"] = truth
    return w


# world 9: contig lengths and the SNPs planted into each
CONTIGS = {"chr1": 1500, "chr2": 1200, "chr3": 900}
CONTIG_SNPS = {"chr1": (400, 1100), "chr2": (300, 800), "chr3": (250, 600)}


def three_contigs(reads_per_strand: int = 5, seed: int = 33):
    """World 9: a sample genome of three contigs built with
    ``Genome.from_dict``, the reference with two SNPs planted in each, and
    reads of 400 bases from every contig on both strands, interleaved read by
    read (their ids sort in that order, as a fast5 file lists them).
    Returns (sample, reference, reads)."""
    rng = np.random.default_rng(seed)
    model = nadavca_tpu_torch.default_model()
    sample = genome.Genome.from_dict({name: "".join("ACGT"[i] for i in rng.integers(0, 4, n))
                                      for name, n in CONTIGS.items()})
    reference = genome.Genome([genome.Contig(c.name, c.codes.copy()) for c in sample])
    for c in reference:
        for p in CONTIG_SNPS[c.name]:
            c.codes[p] = (c.codes[p] + 2) % 4
    per_contig = [[(strand, name) for strand in (1, -1) for _ in range(reads_per_strand)]
                  for name in CONTIGS]
    order = [key for trio in zip(*per_contig) for key in trio]
    reads = [simulator.simulate_read(sample, name, model, rng, read_len=400, strand=strand,
                                     read_id=f"r{j:03d}_{name}_{strand:+d}")
             for j, (strand, name) in enumerate(order)]
    return sample, reference, reads


# worlds 1, 2, 3 and 5 as the card checks run them (``chip_smoke.py``,
# ``tests/test_torch_card.py``), each with the most live samples on which the
# kernels' path may differ from the scan twin's by a tie: world 1 the samples
# placed in its N run, the others from the readings of the kernels' plain
# versions on the CPU with headroom (0, 0, and 72 of 63,488)
CARD_WORLDS = {"n_run": (n_run, samples_in_n_run), "one_read": (one_read, 0),
               "narrow_window": (narrow_window, 0), "indel_calls": (indel_calls, 100)}
