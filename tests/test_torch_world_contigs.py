"""World 9: a reference of three contigs, which neither package's simulator
makes (it writes one contig), built with ``Genome.from_dict``: two SNPs
planted in each contig, reads from every contig on both strands, written
into fast5 files that interleave the contigs, so that every batch mixes
them.

Under ``--backend scan`` the port's ``snp`` gives the JAX CLI's VCF (all but
the ``##`` meta lines, which name the package that wrote them) byte for byte,
and its ``align`` the JAX CLI's alignment files: byte for byte, but for the
reads that cross a 7-base homopolymer, where the two packages' ``scan``
backends break a tie between the two positions of identical level
differently (XLA's float32 emission is not torch's, bit for bit); such a
file differs from the JAX one only by samples that the run rule of
``nadavca_tpu_torch.utils.parity`` explains. With the kernels'
plain versions and genome tables (``--backend cuda --device cpu``, where each
batch's reads look up three contigs' columns of the tables), two gloo ranks
give the VCF of one process byte for byte, as
``tests/test_torch_multiprocess.py`` runs them.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import cli as jcli
from nadavca_tpu.io import fast5 as jfast5

from nadavca_tpu_torch import cli
from nadavca_tpu_torch.genome import Genome
from nadavca_tpu_torch.io import fast5 as fast5mod
from nadavca_tpu_torch.kmer_model import default_model
from nadavca_tpu_torch.utils import parity, worlds

from test_torch_multiprocess import body, reap, start

pytestmark = pytest.mark.skipif(not jfast5.HAVE_H5PY, reason="h5py unavailable")

CONTIGS, SNPS = worlds.CONTIGS, worlds.CONTIG_SNPS
BATCH = 8
# alignment files that may differ from the JAX CLI's by ties (6 of 30 on the
# CPU, at 7-base homopolymers), and the differing samples in all of them (43)
TIE_FILES, TIE_SAMPLES = 8, 60
ARGS = ["--batch-reads", str(BATCH), "--min-coverage", "2"]
SCAN = ["--backend", "scan", "--device", "cpu"]
PLAIN = ["--backend", "cuda", "--device", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """reference.fasta and three fast5 files of the reads, the contigs
    interleaved read by read."""
    _, reference, reads = worlds.three_contigs()
    d = str(tmp_path_factory.mktemp("contigs"))
    n = len(reads) // 3
    for f in range(3):
        fast5mod.write_fast5(os.path.join(d, f"reads_{f}.fast5"), reads[f * n:(f + 1) * n])
    ref = os.path.join(d, "reference.fasta")
    reference.to_fasta(ref)
    return ref, d, reads


def test_files_mix_the_three_contigs(world):
    """Every run of a batch's reads in a file holds every contig (the CLI
    batches reads in file order within a length bucket)."""
    ref, d, reads = world
    assert [c.name for c in Genome.from_fasta(ref)] == list(CONTIGS)
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".fast5"):
            ids = [r.read_id for r in fast5mod.read_fast5(os.path.join(d, fn))]
            assert len(ids) == len(reads) // 3
            for i in range(0, len(ids) - 2, 3):
                assert {x.split("_")[1] for x in ids[i:i + 3]} == set(CONTIGS)


def test_snp_under_scan_gives_the_jax_cli_vcf(world, tmp_path):
    ref, d, _ = world
    mine, theirs = str(tmp_path / "port.vcf"), str(tmp_path / "jax.vcf")
    assert cli.main(["snp", ref, d, "-o", mine, *ARGS, *SCAN]) == 0
    assert jcli.main(["snp", ref, d, "-o", theirs, *ARGS, "--backend", "scan"]) == 0
    assert body(mine) == body(theirs)
    calls = {(l.split("\t")[0], int(l.split("\t")[1]) - 1)
             for l in body(mine) if not l.startswith("#")}
    # planted SNPs only, on every contig (at about 2× coverage a site may
    # fall short of the caller's three votes, in both packages alike)
    assert calls <= {(name, p) for name, ps in SNPS.items() for p in ps}, calls
    assert {name for name, _ in calls} == set(CONTIGS) and len(calls) >= 4


def _aligned_path(text):
    """(header, per-sample k-mer position) of one alignment file."""
    lines = text.splitlines()
    rows = np.array([[int(v) for v in l.split("\t")] for l in lines[1:]])
    path = np.full(int(rows[:, 2].max()), -1, np.int64)
    for i, s, e in rows:
        path[s:e] = i
    return lines[0], path


def _tie_samples(genome, model, a, b):
    """Samples on which two alignment files of one read differ, all of them
    ties along a run of identical levels of the read's window."""
    head, pa = _aligned_path(a)
    head_b, pb = _aligned_path(b)
    assert head == head_b and len(pa) == len(pb)
    f = dict(kv.split("=") for kv in head[2:].split())
    window = genome.window(f["contig"], int(f["start"]), int(f["end"]),
                           1 if f["strand"] == "+" else -1)
    mu, sigma = model.expected_signal(window)
    live = torch.from_numpy((pa >= 0) & (pb >= 0))[None]
    got = parity.run_tie_differences(f["read"], pa[None], pb[None], live, mu[None],
                                     sigma[None], max_count=len(pa))
    return got["differing"]


def test_align_under_scan_gives_the_jax_cli_files(world, tmp_path):
    ref, d, reads = world
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main(["align", ref, d, "-o", mine, "--batch-reads", str(BATCH), *SCAN]) == 0
    assert jcli.main(["align", ref, d, "-o", theirs, "--batch-reads", str(BATCH),
                      "--backend", "scan"]) == 0
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs)) and len(names) >= len(reads) - 2
    genome, model = Genome.from_fasta(ref), default_model()
    tie_files = tie_samples = 0
    for n in names:
        a, b = open(os.path.join(mine, n)).read(), open(os.path.join(theirs, n)).read()
        if a != b:
            tie_files += 1
            tie_samples += _tie_samples(genome, model, a, b)
    print(f"alignment files differing by ties: {tie_files} of {len(names)}, "
          f"{tie_samples} samples")
    assert tie_files <= TIE_FILES and tie_samples <= TIE_SAMPLES
    assert {n.split("_")[1] for n in names} == set(CONTIGS)


def test_two_gloo_ranks_give_the_vcf_of_one_process(world, tmp_path):
    ref, d, _ = world
    argv = ["snp", ref, d, *ARGS, *PLAIN]
    one, two = str(tmp_path / "one.vcf"), str(tmp_path / "two.vcf")
    rcs, errs = reap(start(argv + ["-o", two], 2) + start(argv + ["-o", one]))
    assert rcs == [0, 0, 0], errs
    assert open(two).read() == open(one).read()
    assert {l.split("\t")[0] for l in body(one) if not l.startswith("#")} == set(CONTIGS)
