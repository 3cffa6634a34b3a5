"""The port's command line across processes: the checkpoint protocol of a
process group, its crash consistency, and the joint pass over two ranks
(gloo on the CPU, as ``tests/test_multihost.py`` drives the JAX CLI).

Ranks above 0 write their manifests to ``<checkpoint>.p<i>``, all ranks meet
at a barrier, the accumulators are merged, and rank 0 writes them: a crash
after a whole save resumes to the uninterrupted VCF, and a save torn between
the barrier and rank 0's write is refused by every rank on resume. The
crash points come from ``cli.CRASH_POINT_ENV`` (``tag@rank:batch``).
"""

import os

import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.io import fast5 as jfast5

from nadavca_tpu_torch import cli
from nadavca_tpu_torch.config import AlignConfig

from test_torch_multiprocess import PLAIN, body, run_ranks, simulate

pytestmark = pytest.mark.skipif(not jfast5.HAVE_H5PY, reason="h5py unavailable")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """8 reads of 300 bases in 4 files, one read a batch; and the VCF of one
    process."""
    ref, d = simulate(tmp_path_factory, "world", "--reads", "8", "--files", "4",
                      "--read-length", "300", "--genome-length", "1000",
                      "--snps", "2", "--seed", "9")
    argv = ["snp", ref, d, "--batch-reads", "1", "--min-coverage", "2", *PLAIN]
    one = str(tmp_path_factory.mktemp("one") / "one.vcf")
    assert cli.main(argv + ["-o", one]) == 0
    assert len(body(one)) >= 2
    return argv, one


def test_checkpoint_and_resume(world, tmp_path):
    """Manifest shards and rank 0's accumulators after every round; a rerun
    skips every read and gives the VCF from the restored accumulators."""
    argv, one = world
    ck = str(tmp_path / "state.npz")
    base = argv + ["--checkpoint", ck, "--checkpoint-every", "1"]
    rcs, errs = run_ranks(base + ["-o", str(tmp_path / "a.vcf")], 2)
    assert rcs == [0, 0], errs
    assert os.path.exists(ck) and os.path.exists(ck + ".p1")
    rcs, errs = run_ranks(base + ["-o", str(tmp_path / "b.vcf")], 2)
    assert rcs == [0, 0], errs
    assert all("resuming: 4 reads" in e for e in errs), errs
    assert open(tmp_path / "a.vcf").read() == open(one).read()
    assert open(tmp_path / "b.vcf").read() == open(one).read()


def test_crash_consistency(world, tmp_path):
    """(a) Rank 0 dies right after a whole save of round 2: the resume
    validates, skips the merged reads and gives the uninterrupted VCF.
    (b) Rank 0 dies after the manifest barrier of round 2, before writing
    the accumulators: rank 1 fails in the merge instead of waiting, and the
    torn checkpoint (accumulators of round 1, manifests of round 2) is
    refused by every rank."""
    argv, one = world
    ck = str(tmp_path / "a.npz")
    base = argv + ["--checkpoint", ck, "--checkpoint-every", "1"]
    rcs, errs = run_ranks(base + ["-o", str(tmp_path / "a_crash.vcf")], 2,
                          {cli.CRASH_POINT_ENV: "post_save@0:2"}, timeout=120)
    assert rcs[0] == 57, errs
    rcs, errs = run_ranks(base + ["-o", str(tmp_path / "a.vcf")], 2)
    assert rcs == [0, 0], errs
    assert any("resuming: " in e for e in errs), errs
    assert open(tmp_path / "a.vcf").read() == open(one).read()

    ck = str(tmp_path / "b.npz")
    base = argv + ["--checkpoint", ck, "--checkpoint-every", "1"]
    rcs, errs = run_ranks(base + ["-o", str(tmp_path / "b_crash.vcf")], 2,
                          {cli.CRASH_POINT_ENV: "pre_acc@0:2"}, timeout=120)
    assert rcs[0] == 57 and rcs[1] not in (0, None) and rcs[1] > 0, (rcs, errs)
    rcs, errs = run_ranks(base + ["-o", str(tmp_path / "b.vcf")], 2)
    assert all(rc not in (0, None) and rc > 0 for rc in rcs), (rcs, errs)
    assert all("died mid-save" in e for e in errs), errs
    assert not os.path.exists(tmp_path / "b.vcf")


def _joint_over_two_ranks(world, tmp_path, devices):
    argv, _ = world
    cfg = str(tmp_path / "joint.yaml")
    AlignConfig(snp_joint_rescore=True).to_yaml(cfg)
    argv = argv + ["--configuration", cfg, "--devices", devices]
    one, mh = str(tmp_path / "one.vcf"), str(tmp_path / "mh.vcf")
    rcs, errs = run_ranks(argv + ["-o", mh], 2, one=one)
    assert rcs == [0, 0, 0], errs
    assert open(mh).read() == open(one).read() and len(body(one)) >= 2


def test_joint_pass_over_two_ranks(world, tmp_path):
    """``snp_joint_rescore``: each rank re-ingests and scores its own
    shard's covering reads, and the per-read matrices are gathered."""
    _joint_over_two_ranks(world, tmp_path, "1")


def test_joint_pass_over_two_ranks_of_two_devices(world, tmp_path):
    """The same with two devices a rank (against one process on two): the
    pass runs on each rank's first device, one all_gather a process."""
    _joint_over_two_ranks(world, tmp_path, "2")
