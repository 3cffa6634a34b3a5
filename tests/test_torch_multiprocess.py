"""The port's command line across processes: ``snp --coordinator`` with gloo
ranks on the CPU, as ``tests/test_multihost.py`` drives the JAX CLI.

Each rank is ``python -m nadavca_tpu_torch.cli`` on one CPU device; the
processes shard the input files, agree on every batch's shape, and merge
their accumulators by gloo collectives. The VCF is the one-process run's,
byte for byte: with two ranks (and the JAX CLI's, under ``scan``), with
three uneven ranks whose short shard runs all-padding batches, and on reads
of mixed length (the adaptive band keyed per bucket). Ports are chosen free
just before each launch (``tests/test_torch_multiprocess_ckpt.py`` has the
checkpoints and the joint pass).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import cli as jcli
from nadavca_tpu.io import fast5 as jfast5

from nadavca_tpu_torch import cli
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.utils.checkpoint import load_checkpoint

pytestmark = pytest.mark.skipif(not jfast5.HAVE_H5PY, reason="h5py unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN = ["--backend", "cuda", "--device", "cpu"]
SCAN = ["--backend", "scan", "--device", "cpu"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(extra=None) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **(extra or {}))
    return env


def start(argv, n=0, extra_env=None):
    """Start ``python -m nadavca_tpu_torch.cli argv``: n ranks of one group,
    or (n = 0) one process without a group."""
    port = free_port()
    group = lambda i: ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                       str(n), "--process-id", str(i)]
    return [subprocess.Popen(
        [sys.executable, "-m", "nadavca_tpu_torch.cli", *argv, *(group(i) if n else [])],
        env=rank_env(extra_env), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(max(n, 1))]


def reap(procs, timeout=240):
    """(return codes, stderrs) of started processes. One still running at
    the timeout is killed (its code is then < 0)."""
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=timeout)[1])
        except subprocess.TimeoutExpired:
            p.kill()
            errs.append(p.communicate()[1])
    return [p.returncode for p in procs], errs


def run_ranks(argv, n, extra_env=None, timeout=240, one=None):
    """``argv`` in n ranks of one group and, with ``one`` (an output path),
    in one process beside them; (return codes, stderrs), the one process's
    last."""
    procs = start(argv, n, extra_env)
    if one is not None:
        procs += start(argv[:argv.index("-o")] + ["-o", one] + argv[argv.index("-o") + 2:])
    return reap(procs, timeout)


def metrics_of(err: str) -> dict:
    line = [l for l in err.splitlines() if l.startswith("[metrics] ")][-1]
    return json.loads(line[len("[metrics] "):])


def body(path):
    return [l for l in open(path) if not l.startswith("##")]


def simulate(tmp_path_factory, name, *args):
    d = str(tmp_path_factory.mktemp(name))
    assert cli.main(["simulate", "-o", d, *args]) == 0
    return os.path.join(d, "reference.fasta"), d


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return simulate(tmp_path_factory, "world", "--reads", "8", "--files", "4",
                    "--read-length", "300", "--genome-length", "1000", "--snps", "2",
                    "--seed", "9")


def test_two_ranks_give_the_vcf_of_one_process_and_of_the_jax_cli(world, tmp_path):
    ref, d = world
    argv = ["snp", ref, d, "--batch-reads", "2", "--min-coverage", "2"]
    one, mh, jx = (str(tmp_path / f) for f in ("one.vcf", "mh.vcf", "jax.vcf"))
    procs = start(argv + ["-o", mh, *SCAN], 2) + start(argv + ["-o", one, *SCAN])
    assert jcli.main(argv + ["-o", jx, "--backend", "scan"]) == 0
    rcs, errs = reap(procs)
    assert rcs == [0, 0, 0], errs
    assert open(mh).read() == open(one).read()
    assert body(mh) == body(jx)
    assert len(body(mh)) >= 2          # the header and at least one call
    m = [metrics_of(e) for e in errs[:2]]
    assert [x["counters"]["reads_called"] for x in m] == [4, 4]


def test_three_uneven_ranks_genome_sharded(tmp_path_factory, tmp_path):
    """5 files over 3 ranks (2/2/1 files): the short rank runs all-padding
    batches in the agreed rounds; the kernel backend's plain versions with
    genome-sharded accumulators (reduce-scatter) and the genome tables."""
    ref, d = simulate(tmp_path_factory, "uneven", "--reads", "25", "--files", "5",
                      "--read-length", "300", "--genome-length", "2500", "--snps", "3",
                      "--seed", "11")
    argv = ["snp", ref, d, "--batch-reads", "8", "--min-coverage", "2", *PLAIN]
    one, mh = str(tmp_path / "one.vcf"), str(tmp_path / "mh.vcf")
    rcs, errs = run_ranks(argv + ["-o", mh, "--genome-sharded", "on"], 3, one=one)
    assert rcs == [0, 0, 0, 0], errs
    assert open(mh).read() == open(one).read() and len(body(one)) >= 2
    m = [metrics_of(e) for e in errs[:3]]
    rounds = {x["counters"]["batches_band_128"] for x in m}
    assert len(rounds) == 1, m            # every rank ran every round
    called = [x["counters"]["reads_called"] for x in m]
    assert sum(called) == 25 and min(called) < 8 * rounds.pop() - 8


def test_mixed_lengths_run_the_band_of_their_bucket(tmp_path_factory, tmp_path):
    """Reads of 300 and 600 bases with ``adaptive_band_threshold`` at 4000
    samples: the long ones run at 256 slots on every rank, in their own
    rounds, as in one process; the merged accumulators (the checkpoint's)
    are the one-process run's."""
    ref, d = simulate(tmp_path_factory, "mixed", "--reads", "12", "--files", "3",
                      "--read-length", "300,600", "--genome-length", "1500",
                      "--snps", "2", "--seed", "17")
    cfg = str(tmp_path / "mixed.yaml")
    AlignConfig(adaptive_band_threshold=4000).to_yaml(cfg)
    argv = ["snp", ref, d, "--batch-reads", "4", "--min-coverage", "2",
            "--configuration", cfg, *PLAIN]
    one, mh = str(tmp_path / "one.vcf"), str(tmp_path / "mh.vcf")
    ck1, ckm = str(tmp_path / "one.npz"), str(tmp_path / "mh.npz")
    procs = start(argv + ["-o", mh, "--checkpoint", ckm], 2)
    procs += start(argv + ["-o", one, "--checkpoint", ck1])
    rcs, errs = reap(procs)
    assert rcs == [0, 0, 0], errs
    assert open(mh).read() == open(one).read() and len(body(one)) >= 2
    for e in errs:
        assert metrics_of(e)["counters"]["batches_band_256"] >= 1, e
    (a1, c1, v1), (am, cm, vm) = (load_checkpoint(p)[0]["ref"] for p in (ck1, ckm))
    np.testing.assert_array_equal(cm, c1)
    np.testing.assert_array_equal(vm, v1)
    np.testing.assert_allclose(am, a1, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("device, ranks, cards, backend", [
    ("cpu", 3, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 2, 2, "nccl"),
    ("cuda", 4, 8, "nccl")])
def test_the_backend_rule(monkeypatch, device, ranks, cards, backend):
    """NCCL only when every rank has a card of its own (rank r on cuda:r);
    gloo on the CPU and for ranks that share a card (round robin)."""
    from nadavca_tpu_torch.parallel import distributed as dist

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dist.choose_backend(device, ranks) == backend
    for r in range(ranks):
        want = torch.device("cuda", r % cards) if device == "cuda" else torch.device("cpu")
        assert dist.rank_devices(device, r, ranks) == [want]


@pytest.mark.parametrize("device, ranks, n_local, cards, backend", [
    ("cpu", 2, 4, 0, "gloo"), ("cuda", 2, 2, 4, "nccl"), ("cuda", 2, 2, 3, "gloo"),
    ("cuda", 2, 4, 4, "gloo"), ("cuda", 3, 2, 8, "nccl")])
def test_the_backend_rule_with_several_devices_a_rank(monkeypatch, device, ranks,
                                                       n_local, cards, backend):
    """Position r·n + i of the group's mesh on cuda:((r·n + i) mod cards):
    NCCL only when no two positions share a card."""
    from nadavca_tpu_torch.parallel import distributed as dist

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dist.choose_backend(device, ranks, n_local) == backend
    for r in range(ranks):
        want = [torch.device("cuda", (r * n_local + i) % cards) if device == "cuda"
                else torch.device("cpu") for i in range(n_local)]
        assert dist.rank_devices(device, r, ranks, n_local) == want
