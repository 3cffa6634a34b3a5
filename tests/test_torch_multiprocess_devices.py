"""The port's command line in a process group whose processes drive several
devices each: ``snp --coordinator ... --devices 2`` in two gloo ranks on the
CPU, the JAX package's config-5 layout (process-major mesh positions).

The VCF is the one process's at ``--devices 4`` byte for byte, and under
``scan`` the JAX CLI's one-process VCF; so it is with genome-sharded
accumulators and deferred merges (``tests/test_torch_multiprocess_ckpt.py``
runs the joint pass at two devices a rank). A checkpoint written by
two ranks of two devices, the port's or the JAX CLI's, resumes in two ranks
of one device and of two. Each rank holds more reads a batch than one read
tile, so both of its positions hold reads.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import cli as jcli
from nadavca_tpu.io import fast5 as jfast5

from nadavca_tpu_torch import cli
from nadavca_tpu_torch.config import AlignConfig

from test_torch_multiprocess import (PLAIN, REPO, SCAN, body, free_port, metrics_of,
                                     reap, run_ranks, simulate, start)

pytestmark = pytest.mark.skipif(not jfast5.HAVE_H5PY, reason="h5py unavailable")

# 20 reads in 4 files: a rank streams 2 files (10 reads), batches of up to
# 10 padded to 16 rows, 8 (one read tile) a position
N_READS = 20
BATCH = ["--batch-reads", "10", "--min-coverage", "2"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """20 reads of 150 bases over 600 bases (not a multiple of 4·128, so a
    genome-sharded ``Gp`` pads), 3 planted SNPs; a configuration with an
    8-row read tile."""
    ref, d = simulate(tmp_path_factory, "world", "--reads", str(N_READS), "--files",
                      "4", "--read-length", "150", "--genome-length", "600",
                      "--snps", "3", "--seed", "21")
    cfg = os.path.join(d, "tile8.yaml")
    AlignConfig(read_tile=8).to_yaml(cfg)
    return ref, d, cfg


def _argv(world, *extra):
    ref, d, cfg = world
    return ["snp", ref, d, *BATCH, "--configuration", cfg, *extra]


@pytest.fixture(scope="module")
def one_process(world, tmp_path_factory):
    """The VCFs of one process: the port's on four devices (plain versions)
    and the JAX CLI's (``scan``)."""
    d = tmp_path_factory.mktemp("one")
    out = {"plain": str(d / "plain.vcf"), "scan": str(d / "scan.vcf")}
    assert cli.main(_argv(world, *PLAIN, "--devices", "4", "-o", out["plain"])) == 0
    assert jcli.main(_argv(world, "--backend", "scan", "-o", out["scan"])) == 0
    assert len(body(out["plain"])) >= 2
    return out


@pytest.mark.parametrize("backend", ["plain", "scan"])
def test_two_ranks_of_two_devices_give_the_one_process_vcf(world, one_process, tmp_path,
                                                           backend):
    mh = str(tmp_path / "mh.vcf")
    rcs, errs = run_ranks(_argv(world, *(PLAIN if backend == "plain" else SCAN),
                                "--devices", "2", "-o", mh), 2, timeout=120)
    assert rcs == [0, 0], errs
    if backend == "plain":
        assert open(mh).read() == open(one_process["plain"]).read()
    assert body(mh) == body(one_process[backend])
    m = [metrics_of(e) for e in errs]
    assert [x["counters"]["reads_called"] for x in m] == [N_READS // 2] * 2


def test_genome_sharded_with_deferred_merges(world, tmp_path):
    """``Gp`` = 1024 rows (600 padded) in four slices of 256, two a rank;
    deferred partials merged once. Against one process on four devices."""
    argv = _argv(world, *PLAIN, "--genome-sharded", "on", "--merge", "deferred")
    mh, one = str(tmp_path / "mh.vcf"), str(tmp_path / "one.vcf")
    procs = start(argv + ["--devices", "2", "-o", mh], 2)
    assert cli.main(argv + ["--devices", "4", "-o", one]) == 0
    rcs, errs = reap(procs, timeout=120)
    assert rcs == [0, 0], errs
    assert open(mh).read() == open(one).read() and len(body(one)) >= 2


def _jax_ranks(argv, n, env_extra):
    """Start the JAX CLI in n processes of two CPU devices each."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2", **env_extra)
    return [subprocess.Popen(
        [sys.executable, "-m", "nadavca_tpu.cli", *argv, "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]


@pytest.fixture(scope="module")
def cut_checkpoints(world, tmp_path_factory):
    """Checkpoints of two ranks of two devices, cut by rank 0's exit right
    after the whole save of round 1: the port's (plain versions) and the JAX
    CLI's (``scan``)."""
    d = tmp_path_factory.mktemp("cut")
    ck = {"plain": str(d / "port.npz"), "scan": str(d / "jax.npz")}
    crash = {cli.CRASH_POINT_ENV: "post_save@0:1"}
    argv = _argv(world, "--checkpoint-every", "1", "-o", str(d / "cut.vcf"))
    procs = start(argv + [*PLAIN, "--devices", "2", "--checkpoint", ck["plain"]], 2,
                  crash)
    procs += _jax_ranks(argv + ["--backend", "scan", "--checkpoint", ck["scan"]], 2,
                        crash)
    rcs, errs = reap(procs, timeout=120)
    assert rcs[0] == rcs[2] == 57, errs
    return ck


@pytest.mark.parametrize("writer, devices", [("plain", "1"), ("plain", "2"), ("scan", "2")],
                         ids=["port_2x2_in_2x1", "port_2x2_in_2x2", "jax_2x2_in_2x2"])
def test_a_two_by_two_checkpoint_resumes(world, one_process, cut_checkpoints, tmp_path,
                                         writer, devices):
    """The resume skips round 1's reads, merges the rest into the restored
    accumulators, and gives the uninterrupted VCF (the JAX CLI's checkpoint
    under ``scan``, the port's under the plain versions)."""
    ck = str(tmp_path / "state.npz")
    for suffix in ("", ".p1"):
        shutil.copy(cut_checkpoints[writer] + suffix, ck + suffix)
    out = str(tmp_path / "resumed.vcf")
    rcs, errs = run_ranks(_argv(world, *(PLAIN if writer == "plain" else SCAN),
                                "--devices", devices, "--checkpoint", ck, "-o", out),
                          2, timeout=120)
    assert rcs == [0, 0], errs
    m = [metrics_of(e)["counters"] for e in errs]
    assert 0 < sum(x["reads_resumed_skip"] for x in m) < N_READS, m
    assert sum(x["reads_resumed_skip"] + x["reads_called"] for x in m) == N_READS
    assert body(out) == body(one_process[writer])
