"""The port's command line with the joint pass (``snp_joint_rescore``).

The joint pass re-ingests the reads that cover a candidate cluster by id
(``include_ids``); after a resume it finds the reads merged before the
checkpoint through the read placements the checkpoint stores. On
``tests/test_joint.py``'s world (24 reads of 400 bases, 2 planted SNPs) the
calls sit at the planted positions, as there through the JAX package's api.
"""

import os

import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import cli as jcli
from nadavca_tpu.io import fast5 as jfast5

from nadavca_tpu_torch import api, cli
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.io import fast5 as fast5mod

pytestmark = pytest.mark.skipif(not jfast5.HAVE_H5PY, reason="h5py unavailable")

SCAN = ["--backend", "scan", "--device", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("joint"))
    assert jcli.main(["simulate", "-o", d, "--reads", "24", "--files", "2",
                      "--read-length", "400", "--genome-length", "2000",
                      "--snps", "2", "--seed", "3"]) == 0
    cfg = str(tmp_path_factory.mktemp("cfg") / "joint.yaml")
    AlignConfig(snp_joint_rescore=True).to_yaml(cfg)
    truth = {}
    with open(os.path.join(d, "truth_snps.tsv")) as f:
        next(f)
        for line in f:
            _, pos, sample_b, _ = line.split()
            truth[int(pos)] = sample_b
    return os.path.join(d, "reference.fasta"), d, cfg, truth


def _calls(path):
    return [tuple(l.split("\t")[:5]) for l in open(path) if not l.startswith("#")]


@pytest.fixture(scope="module")
def joint_vcf(world, tmp_path_factory):
    ref, d, cfg, _ = world
    out = str(tmp_path_factory.mktemp("joint_out") / "calls.vcf")
    assert cli.main(["snp", ref, d, "-o", out, "--configuration", cfg,
                     "--batch-reads", "16", *SCAN]) == 0
    return out


def test_joint_pass_through_the_cli(world, joint_vcf):
    """The calls sit at the planted positions, and are the api's."""
    ref, d, _, truth = world
    got = _calls(joint_vcf)
    assert {int(c[1]) - 1: c[4] for c in got} == truth
    calls = api.call_snps(ref, d, config=AlignConfig(snp_joint_rescore=True),
                          backend="scan", min_coverage=3, device="cpu")
    assert got == [(c.contig, str(c.position + 1), ".", c.ref_base, c.alt_base)
                   for c in calls]


def test_joint_pass_after_a_resume(world, joint_vcf, tmp_path):
    """A run cut after the first file's reads, then resumed over both: the
    joint pass re-ingests reads merged before the checkpoint, and the calls
    are the uninterrupted run's."""
    ref, d, cfg, _ = world
    reads = list(fast5mod.iter_fast5_dir(d))
    ckpt = str(tmp_path / "state.npz")
    base = ["snp", ref, "(in memory)", "--configuration", cfg, "--batch-reads",
            "16", *SCAN, "--checkpoint", ckpt]
    assert cli.main(base + ["-o", str(tmp_path / "cut.vcf")], reads=reads[:12]) == 0
    out = str(tmp_path / "resumed.vcf")
    assert cli.main(base + ["-o", out], reads=reads) == 0
    assert _calls(out) == _calls(joint_vcf)
