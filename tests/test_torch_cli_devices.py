"""The port's command line on several devices of one process, on the CPU.

``--device cpu --devices N`` runs N shards on the CPU (the counterpart of the
JAX tests' virtual CPU devices). Every layout and merge cadence gives the VCF
of one device byte for byte; ``align`` the same files; a checkpoint written
on two devices resumes, and so does one the JAX CLI wrote on two of its
devices. What the CLI refuses, it refuses before any read is loaded.
"""

import json
import os
import shutil

import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import cli as jcli
from nadavca_tpu.io import fast5 as jfast5

from nadavca_tpu_torch import cli
from nadavca_tpu_torch.io import fast5 as fast5mod

pytestmark = pytest.mark.skipif(not jfast5.HAVE_H5PY, reason="h5py unavailable")

# the kernels' plain versions (the scan twin's per-step loop runs once a
# shard, which the shard counts here would multiply)
CPU = ["--backend", "cuda", "--device", "cpu", "--batch-reads", "8",
       "--min-coverage", "2"]


def _metrics(err: str) -> dict:
    line = [l for l in err.splitlines() if l.startswith("[metrics] ")][-1]
    return json.loads(line[len("[metrics] "):])


def _calls(path):
    return [l.split("\t") for l in open(path) if not l.startswith("#")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """16 reads of 300 bases over 1500 bases, 2 planted SNPs, 4 files; and
    the one-device VCF."""
    d = str(tmp_path_factory.mktemp("world"))
    assert cli.main(["simulate", "-o", d, "--reads", "16", "--files", "4",
                     "--read-length", "300", "--genome-length", "1500",
                     "--snps", "2", "--seed", "13"]) == 0
    ref = os.path.join(d, "reference.fasta")
    one = os.path.join(d, "one.vcf")
    assert cli.main(["snp", ref, d, "-o", one, *CPU]) == 0
    assert len(_calls(one)) >= 1
    return ref, d, one


@pytest.mark.parametrize("merge, layout", [
    ("per-batch", "off"), ("per-batch", "on"), ("deferred", "off"), ("deferred", "on")])
def test_snp_on_two_devices_gives_the_one_device_vcf(world, tmp_path, merge, layout):
    ref, d, one = world
    out = str(tmp_path / "two.vcf")
    assert cli.main(["snp", ref, d, "-o", out, *CPU, "--devices", "2",
                     "--merge", merge, "--genome-sharded", layout]) == 0
    assert open(out).read() == open(one).read()


@pytest.mark.parametrize("devices", ["all", "3"])
def test_align_on_several_devices_gives_the_one_device_files(world, tmp_path, devices):
    """``all`` is one device on the CPU; three shards of 8-read batches
    leave the last shards all padding."""
    ref, d, _ = world
    base = ["align", ref, d, "--backend", "cuda", "--device", "cpu",
            "--batch-reads", "8"]
    one, many = str(tmp_path / "one"), str(tmp_path / "many")
    assert cli.main(base + ["-o", one]) == 0
    assert cli.main(base + ["-o", many, "--devices", devices]) == 0
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(many)) and len(names) >= 12
    for n in names:
        assert open(os.path.join(one, n)).read() == open(os.path.join(many, n)).read()


def test_align_shards_files_over_processes_of_two_devices(world, tmp_path):
    """``align --num-processes 2 --process-id I --devices 2``: each process
    aligns its files on its two devices, without a group; together they
    write the one device's files."""
    ref, d, _ = world
    base = ["align", ref, d, "--backend", "cuda", "--device", "cpu",
            "--batch-reads", "8"]
    one = str(tmp_path / "one")
    assert cli.main(base + ["-o", one]) == 0
    parts = [str(tmp_path / f"p{i}") for i in range(2)]
    for i, out in enumerate(parts):
        assert cli.main(base + ["-o", out, "--devices", "2", "--num-processes", "2",
                                "--process-id", str(i)]) == 0
    got = [sorted(os.listdir(p)) for p in parts]
    assert got[0] and got[1] and not set(got[0]) & set(got[1])
    assert sorted(got[0] + got[1]) == sorted(os.listdir(one))
    for p, names in zip(parts, got):
        for n in names:
            assert open(os.path.join(p, n)).read() == open(os.path.join(one, n)).read()


def test_num_processes_without_a_coordinator_runs_as_one_process(world, tmp_path):
    """As in the JAX CLI: without ``--coordinator`` there is no group, and
    the one process runs every read."""
    ref, d, one = world
    out = str(tmp_path / "p.vcf")
    assert cli.main(["snp", ref, d, "-o", out, *CPU, "--num-processes", "2",
                     "--process-id", "0"]) == 0
    assert open(out).read() == open(one).read()


def test_more_devices_than_cards_raise_before_any_read(world, tmp_path, monkeypatch):
    ref, d, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_reads(*a, **k):
        raise AssertionError("a read was loaded")

    monkeypatch.setattr(cli, "_stream_records", no_reads)
    for cmd, out in (("snp", "x.vcf"), ("align", "aln")):
        with pytest.raises(SystemExit, match="--devices 3"):
            cli.main([cmd, ref, d, "-o", str(tmp_path / out), "--device", "cuda",
                      "--devices", "3"])
        assert not os.path.exists(tmp_path / out)
    # under a coordinator too, before the group is joined (nothing listens
    # at the coordinator's address)
    with pytest.raises(SystemExit, match="--devices 3"):
        cli.main(["snp", ref, d, "-o", str(tmp_path / "y.vcf"), "--device", "cuda",
                  "--devices", "3", "--coordinator", "127.0.0.1:1",
                  "--num-processes", "2", "--process-id", "0"])
    assert not os.path.exists(tmp_path / "y.vcf")


def test_two_device_checkpoint_resume(world, tmp_path, capsys):
    """Deferred partials on two devices, saved after every batch: the run
    gives the one-device VCF, a resume that finds every read merged gives
    it again from the checkpoint (restored into device 0's partial), and a
    run cut after half the reads, resumed, gives the same calls."""
    ref, d, one = world
    ck = str(tmp_path / "state.npz")
    base = ["snp", ref, d, *CPU, "--devices", "2", "--merge", "deferred",
            "--checkpoint", ck]
    out1, out2 = str(tmp_path / "c1.vcf"), str(tmp_path / "c2.vcf")
    assert cli.main(base + ["-o", out1, "--checkpoint-every", "1"]) == 0
    capsys.readouterr()
    assert cli.main(base + ["-o", out2]) == 0
    m = _metrics(capsys.readouterr().err)
    assert m["counters"]["reads_resumed_skip"] == 16 and m["counters"]["reads_ingested"] == 0
    assert open(out1).read() == open(one).read() == open(out2).read()

    reads = list(fast5mod.iter_fast5_dir(d))
    ck2 = str(tmp_path / "cut.npz")
    cut = ["snp", ref, "(in memory)", *CPU, "--devices", "2", "--merge", "deferred",
           "--checkpoint", ck2, "--checkpoint-every", "1"]
    assert cli.main(cut + ["-o", str(tmp_path / "cut.vcf")], reads=reads[:8]) == 0
    capsys.readouterr()
    out3 = str(tmp_path / "c3.vcf")
    assert cli.main(cut + ["-o", out3], reads=reads) == 0
    m = _metrics(capsys.readouterr().err)
    assert m["counters"]["reads_resumed_skip"] == 8 and m["counters"]["reads_ingested"] == 8
    _same_calls(out3, one)


def _same_calls(got, want):
    """The same calls and coverage; posteriors to their sixth digit (the
    float sums run in another order)."""
    g, w = _calls(got), _calls(want)
    assert g and [r[:5] for r in g] == [r[:5] for r in w]
    for a, b in zip(g, w):
        assert a[7].split(";")[0] == b[7].split(";")[0]
        assert abs(float(a[7].split("PP=")[1]) - float(b[7].split("PP=")[1])) <= 2e-6


def test_a_two_device_jax_checkpoint_resumes_in_the_port(world, tmp_path, capsys):
    """The JAX CLI merges half the files on two of its virtual devices
    (deferred partials) and writes its one-process checkpoint; the port
    resumes it on two devices over all files to the one-device calls."""
    ref, d, one = world
    half = str(tmp_path / "half")
    os.makedirs(half)
    for f in sorted(f for f in os.listdir(d) if f.endswith(".fast5"))[:2]:
        shutil.copy(os.path.join(d, f), half)
    ck = str(tmp_path / "jax.npz")
    assert jcli.main(["snp", ref, half, "-o", str(tmp_path / "half.vcf"),
                      "--backend", "scan", "--batch-reads", "8", "--devices", "2",
                      "--merge", "deferred", "--checkpoint", ck]) == 0
    capsys.readouterr()
    out = str(tmp_path / "resumed.vcf")
    assert cli.main(["snp", ref, d, "-o", out, *CPU, "--devices", "2",
                     "--checkpoint", ck]) == 0
    m = _metrics(capsys.readouterr().err)
    assert m["counters"]["reads_resumed_skip"] == 8 and m["counters"]["reads_ingested"] == 8
    _same_calls(out, one)
