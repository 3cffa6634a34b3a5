"""The port's command line (``nadavca_tpu_torch.cli``) on the CPU.

The JAX package's CLI is the reference: under ``--backend scan`` the port's
``snp`` VCF body and ``align`` files are byte-identical to it (the VCF's
``##source`` header names the package that wrote it). Worlds are made by the
JAX package's ``simulate``, which the port's reproduces byte for byte.
"""

import json
import os
import shutil
import threading
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import cli as jcli
from nadavca_tpu.io import fast5 as jfast5
from nadavca_tpu.io import sidecar as jsidecar

from nadavca_tpu_torch import api, cli
from nadavca_tpu_torch.genome import Contig, Genome
from nadavca_tpu_torch.io import fast5 as fast5mod
from nadavca_tpu_torch.io import pod5 as pod5mod
from nadavca_tpu_torch.io import sidecar
from nadavca_tpu_torch.io.simulator import simulate_read
from nadavca_tpu_torch.kmer_model import default_model
from nadavca_tpu_torch.utils import checkpoint, metrics as metricsmod, profiling

from test_pod5_sidecar import _make_world

GOLD = os.path.join(os.path.dirname(__file__), "goldens")

pytestmark = pytest.mark.skipif(not jfast5.HAVE_H5PY, reason="h5py unavailable")

SCAN = ["--backend", "scan", "--device", "cpu"]


def _body(path):
    """A VCF without its ``##`` meta lines (they name the writing package)."""
    return [l for l in open(path) if not l.startswith("##")]


def _calls(path):
    return [l.split("\t")[:5] for l in open(path) if not l.startswith("#")]


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert open(os.path.join(a, n)).read() == open(os.path.join(b, n)).read(), n


def _simulate(main, out, *args):
    assert main(["simulate", "-o", out, *args]) == 0
    return os.path.join(out, "reference.fasta")


def _metrics(err: str) -> dict:
    line = [l for l in err.splitlines() if l.startswith("[metrics] ")][-1]
    return json.loads(line[len("[metrics] "):])


SIM_ARGS = ["--reads", "24", "--files", "2", "--read-length", "400",
            "--genome-length", "2000", "--snps", "2", "--seed", "3"]


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sim"))
    return _simulate(jcli.main, d, *SIM_ARGS), d


@pytest.fixture(scope="module")
def port_sim_vcf(sim, tmp_path_factory):
    ref, d = sim
    out = str(tmp_path_factory.mktemp("port_sim") / "calls.vcf")
    assert cli.main(["snp", ref, d, "-o", out, "--batch-reads", "16",
                     "--min-coverage", "2", *SCAN]) == 0
    return out


@pytest.fixture(scope="module")
def port_sim_aln(sim, tmp_path_factory):
    ref, d = sim
    out = str(tmp_path_factory.mktemp("port_sim") / "aln")
    assert cli.main(["align", ref, d, "-o", out, "--batch-reads", "16", *SCAN]) == 0
    return out


@pytest.mark.parametrize("cmd", ["snp", "align"])
def test_goldens_through_the_cli(cmd, tmp_path):
    """``tests/goldens`` as ``tests/test_golden.py`` drives the JAX CLI."""
    data = os.path.join(GOLD, "data")
    out = str(tmp_path / ("calls.vcf" if cmd == "snp" else "aln"))
    assert cli.main([cmd, os.path.join(data, "reference.fasta"), data, "-o", out,
                     "--batch-reads", "16", *SCAN]) == 0
    if cmd == "snp":
        assert _body(out) == _body(os.path.join(GOLD, "calls.vcf"))
        assert len(_calls(out)) >= 1
    else:
        _same_tree(out, os.path.join(GOLD, "aln"))


def test_simulate_matches_the_jax_simulate(sim, tmp_path):
    _, jdir = sim
    d = str(tmp_path / "port")
    _simulate(cli.main, d, *SIM_ARGS)
    assert sorted(os.listdir(d)) == sorted(os.listdir(jdir))
    for f in ("reference.fasta", "truth_snps.tsv"):
        assert open(os.path.join(d, f)).read() == open(os.path.join(jdir, f)).read()
    ours = list(fast5mod.iter_fast5_dir(d))
    theirs = list(jfast5.iter_fast5_dir(jdir))
    assert len(ours) == len(theirs) == 24
    for a, b in zip(ours, theirs):
        assert (a.read_id, a.basecall) == (b.read_id, b.basecall)
        np.testing.assert_array_equal(a.signal_pa, b.signal_pa)
        np.testing.assert_array_equal(a.move_index, b.move_index)


def test_snp_matches_the_jax_cli(sim, port_sim_vcf, tmp_path):
    """24 reads of 400 bases, 2 planted SNPs: both are found, and the VCF
    body is the JAX CLI's."""
    ref, d = sim
    out = str(tmp_path / "jax.vcf")
    assert jcli.main(["snp", ref, d, "-o", out, "--backend", "scan",
                      "--batch-reads", "16", "--min-coverage", "2"]) == 0
    assert _body(port_sim_vcf) == _body(out)
    truth = [l.split("\t") for l in open(os.path.join(d, "truth_snps.tsv"))][1:]
    called = {(c[0], int(c[1]) - 1, c[4]) for c in _calls(port_sim_vcf)}
    assert {(t[0], int(t[1]), t[2]) for t in truth} <= called


def test_align_matches_the_jax_cli(sim, port_sim_aln, tmp_path):
    ref, d = sim
    theirs = str(tmp_path / "jax")
    assert jcli.main(["align", ref, d, "-o", theirs, "--backend", "scan",
                      "--batch-reads", "16"]) == 0
    _same_tree(port_sim_aln, theirs)
    assert len(os.listdir(port_sim_aln)) >= 20


def test_reads_in_memory_give_the_vcf_of_the_directory(sim, port_sim_vcf, tmp_path):
    """``main(argv, reads=...)``: the same reads from memory, the directory
    argument only a label."""
    ref, d = sim
    reads = list(fast5mod.iter_fast5_dir(d))
    out = str(tmp_path / "mem.vcf")
    assert cli.main(["snp", ref, "(in memory)", "-o", out, "--batch-reads", "16",
                     "--min-coverage", "2", *SCAN], reads=reads) == 0
    assert open(out).read() == open(port_sim_vcf).read()


def test_kernel_backend_on_the_cpu_gives_the_api_calls(tmp_path):
    """``--backend cuda --device cpu`` (every kernel's plain version, genome
    tables) on a genome of two contigs: the CLI sums every batch into one
    accumulator over the concatenated contigs, ``api.call_snps`` into one per
    contig, and they must give the same calls on both contigs."""
    rng = np.random.default_rng(21)
    model = default_model()
    sample = Genome.from_dict({
        name: "".join("ACGT"[i] for i in rng.integers(0, 4, 1500))
        for name in ("chrA", "chrB")})
    reference = Genome([Contig(c.name, c.codes.copy()) for c in sample])
    for c, p in ((reference.contigs[0], 700), (reference.contigs[1], 300),
                 (reference.contigs[1], 1100)):
        c.codes[p] = (c.codes[p] + 2) % 4
    reads = [simulate_read(sample, name, model, rng, read_len=400,
                           read_id=f"{name}_{i:02d}")
             for name in ("chrA", "chrB") for i in range(16)]
    d = str(tmp_path / "data")
    os.makedirs(d)
    fast5mod.write_fast5(os.path.join(d, "reads.fast5"), reads)
    ref = os.path.join(d, "reference.fasta")
    reference.to_fasta(ref)
    out = str(tmp_path / "cuda.vcf")
    assert cli.main(["snp", ref, d, "-o", out, "--batch-reads", "16",
                     "--min-coverage", "2", "--backend", "cuda",
                     "--device", "cpu"]) == 0
    calls = api.call_snps(ref, d, backend="cuda", batch_reads=16, min_coverage=2,
                          device="cpu")
    assert {(c.contig, c.position) for c in calls} >= {
        ("chrA", 700), ("chrB", 300), ("chrB", 1100)}
    got = [l.split("\t") for l in open(out) if not l.startswith("#")]
    assert [c[:5] for c in got] == [[c.contig, str(c.position + 1), ".", c.ref_base,
                                     c.alt_base] for c in calls]
    assert [c[7].split(";")[0] for c in got] == [f"DP={c.coverage}" for c in calls]
    np.testing.assert_allclose([float(c[7].split("PP=")[1]) for c in got],
                               [c.probability for c in calls], atol=2e-6)


# ------------------------------------------------------------- checkpoints
def test_snp_checkpoint_resume(sim, port_sim_vcf, tmp_path, capsys):
    """As ``tests/test_checkpoint_cli.py``: a run that checkpoints after every
    batch gives the uninterrupted run's VCF, and a resumed run, all of whose
    reads are merged, loads none and gives the same VCF from the
    checkpoint's accumulators."""
    ref, d = sim
    ckpt = str(tmp_path / "state.npz")
    out1, out2 = str(tmp_path / "c1.vcf"), str(tmp_path / "c2.vcf")
    base = ["snp", ref, d, "--batch-reads", "16", "--min-coverage", "2", *SCAN,
            "--checkpoint", ckpt]
    assert cli.main(base + ["-o", out1, "--checkpoint-every", "1"]) == 0
    assert os.path.exists(ckpt)
    capsys.readouterr()
    assert cli.main(base + ["-o", out2]) == 0
    m = _metrics(capsys.readouterr().err)
    assert m["counters"]["reads_resumed_skip"] == 24
    assert m["counters"]["reads_ingested"] == 0
    assert open(out1).read() == open(port_sim_vcf).read()
    assert open(out2).read() == open(out1).read()


def test_resume_loads_only_the_unmerged_reads(sim, tmp_path, monkeypatch):
    """With 20 of 24 reads in the manifest, 4 signal datasets are read."""
    ref, d = sim
    all_ids = [r.read_id for r in fast5mod.iter_fast5_dir(d)]
    G = 2000
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(ckpt, {"ref": (np.zeros((G, 4), np.float32),
                                              np.zeros(G, np.int32),
                                              np.zeros((G, 4), np.int32))},
                               set(all_ids[:20]))
    n_signal_reads = [0]
    orig = fast5mod._read_signal

    def counting(dset):
        n_signal_reads[0] += 1
        return orig(dset)

    monkeypatch.setattr(fast5mod, "_read_signal", counting)
    assert cli.main(["snp", ref, d, "-o", str(tmp_path / "out.vcf"),
                     "--batch-reads", "16", *SCAN, "--checkpoint", ckpt]) == 0
    assert n_signal_reads[0] == 4, n_signal_reads


def test_a_jax_checkpoint_resumes_in_the_port(sim, port_sim_vcf, tmp_path, capsys):
    """The JAX CLI merges the reads of one of the two files and writes its
    checkpoint; the port resumes it over both to the calls of the
    uninterrupted run (the float sums run in another order, so the
    posteriors are compared to their sixth digit)."""
    ref, d = sim
    half = str(tmp_path / "half")
    os.makedirs(half)
    shutil.copy(os.path.join(d, "reads_000.fast5"), half)
    ckpt = str(tmp_path / "jax_state.npz")
    assert jcli.main(["snp", ref, half, "-o", str(tmp_path / "half.vcf"),
                      "--backend", "scan", "--batch-reads", "16",
                      "--checkpoint", ckpt]) == 0
    capsys.readouterr()
    out = str(tmp_path / "resumed.vcf")
    assert cli.main(["snp", ref, d, "-o", out, "--batch-reads", "16",
                     "--min-coverage", "2", *SCAN, "--checkpoint", ckpt]) == 0
    m = _metrics(capsys.readouterr().err)
    assert m["counters"]["reads_resumed_skip"] == 12
    assert m["counters"]["reads_ingested"] == 12
    got = [l.split("\t") for l in open(out) if not l.startswith("#")]
    want = [l.split("\t") for l in open(port_sim_vcf) if not l.startswith("#")]
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:5] == w[:5] and g[7].split(";")[0] == w[7].split(";")[0]
        assert abs(float(g[7].split("PP=")[1]) - float(w[7].split("PP=")[1])) <= 2e-6


# ------------------------------------------------------ pod5 and sidecars
class _FakeReader:
    fakes = []

    def __init__(self, path):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def reads(self):
        return iter(self.fakes)


@pytest.mark.parametrize("with_sidecar", [True, False], ids=["sidecar", "no_sidecar"])
def test_pod5_reads_through_the_cli(tmp_path, monkeypatch, with_sidecar):
    """``tests/test_pod5_sidecar.py`` with the port: signal-only pod5 reads
    are called once ``--basecalls`` joins their basecalls, and dropped
    without."""
    ref_path, data, sc, pos, orig, fakes = _make_world(tmp_path)
    monkeypatch.setattr(_FakeReader, "fakes", fakes)
    monkeypatch.setattr(pod5mod, "HAVE_POD5", True)
    monkeypatch.setattr(pod5mod, "_pod5", types.SimpleNamespace(Reader=_FakeReader))
    out = tmp_path / "calls.vcf"
    argv = ["snp", str(ref_path), str(data), "-o", str(out), "--workers", "1",
            "--batch-reads", "16", *SCAN]
    assert cli.main(argv + (["--basecalls", str(sc)] if with_sidecar else [])) == 0
    called = {int(c[1]) - 1: c[4] for c in _calls(str(out))}
    if with_sidecar:
        assert called.get(pos) == "ACGT"[orig], (pos, called)
    else:
        assert called == {}


SAM_MV = ("@HD\tVN:1.6\n"
          "read1\t4\t*\t0\t0\t*\t*\t0\t0\tACG\t!!!\tts:i:10\tmv:B:c,5,1,0,1,1\n")
SAM_FLAGS = (
    "@HD\tVN:1.6\n"
    "read1\t0\tc\t1\t60\t3M\t*\t0\t0\tACG\t!!!\tmv:B:c,5,1,0,1,1\n"
    "read1\t256\tc\t9\t0\t3M\t*\t0\t0\tTTT\t!!!\tmv:B:c,5,1,1,1,0\n"
    "read2\t2048\tc\t1\t60\t1M2H\t*\t0\t0\tA\t!\tmv:B:c,5,1,0,1,1\n"
    "read3\t16\tc\t1\t60\t3M\t*\t0\t0\tACG\t!!!\tmv:B:c,5,1,0,1,1\n"
    "read4\t0\tc\t1\t60\t2M1H\t*\t0\t0\tAC\t!!\tmv:B:c,5,1,0,1,1\n")
TSV = "# read_id\tbasecall\tmoves\nr1\tACGT\t0,4,9,12\nr2\tTT\t3,5\n"


@pytest.mark.parametrize("name,text,want", [
    ("mv.sam", SAM_MV, {"read1": ("ACG", [10, 20, 25])}),
    ("flags.sam", SAM_FLAGS, {"read1": ("ACG", [0, 10, 15]),
                              "read3": ("CGT", [0, 10, 15])}),
    ("calls.tsv", TSV, {"r1": ("ACGT", [0, 4, 9, 12]), "r2": ("TT", [3, 5])}),
], ids=["sam_mv_tag", "sam_flags", "tsv"])
def test_sidecar_parsing_matches_the_jax_package(tmp_path, name, text, want):
    p = tmp_path / name
    p.write_text(text)
    ours = sidecar.load_sidecar_basecalls(str(p))
    theirs = jsidecar.load_sidecar_basecalls(str(p))
    assert set(ours) == set(theirs) == set(want)
    for rid, (bc, mv) in want.items():
        assert ours[rid][0] == theirs[rid][0] == bc
        np.testing.assert_array_equal(ours[rid][1], mv)
        np.testing.assert_array_equal(theirs[rid][1], mv)


# ------------------------------------------------------------ refusals
def test_cuda_without_a_card_raises_before_any_read(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = os.path.join(GOLD, "data")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["snp", os.path.join(data, "reference.fasta"), data,
                  "-o", str(tmp_path / "out.vcf")])
    assert not os.path.exists(tmp_path / "out.vcf")


def test_align_shards_files_and_refuses_reads_in_memory(sim, port_sim_aln, tmp_path):
    """``align --num-processes 2 --process-id I`` aligns every other file;
    the two shards together are the whole output. Reads in memory, which
    have no files, are sharded by their index instead (``i % 2 == I``)."""
    ref, d = sim
    base = ["align", ref, d, "--batch-reads", "16", *SCAN, "--num-processes", "2"]
    for pid in (0, 1):
        assert cli.main(base + ["-o", str(tmp_path / "aln"),
                                "--process-id", str(pid)]) == 0
    _same_tree(str(tmp_path / "aln"), port_sim_aln)
    reads = list(fast5mod.iter_fast5_dir(d))[:3]
    assert cli.main(base + ["-o", str(tmp_path / "x"), "--process-id", "1"],
                    reads=reads) == 0
    assert os.listdir(tmp_path / "x") == [f"{reads[1].read_id}.txt"]


# --------------------------------------------------------------- utils
def test_metrics_stage_timer_and_trace(tmp_path, capsys):
    """Counters and gauges, and a span: a no-op with no profiler running, a
    named range in the ``--profile`` trace (every thread's) under one."""
    m = metricsmod.Metrics()
    m.count("reads", 3)
    m.count("reads")
    m.gauge("reads_per_s", 12.34567)
    snap = m.snapshot()
    assert snap["counters"]["reads"] == 4
    assert snap["gauges"]["reads_per_s"] == 12.3457
    m.report()
    assert capsys.readouterr().err.startswith("[metrics] {")
    m.reset()
    assert m.snapshot()["counters"] == {} and m.snapshot()["gauges"] == {}
    assert not profiling.profiler_on()
    with profiling.span("nadavca.prep"):
        pass
    with profiling.trace(str(tmp_path / "tr")):
        assert profiling.profiler_on()
        with profiling.span("nadavca.prep"):
            torch.ones(4).sum()

        def on_a_thread():
            with profiling.span("nadavca.drain"):
                pass

        worker = threading.Thread(target=on_a_thread)
        worker.start()
        worker.join(60)
        assert not worker.is_alive()
    assert not profiling.profiler_on()
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    threads = {e["name"]: e["tid"] for e in events
               if e.get("name", "").startswith("nadavca.")}
    assert set(threads) == {"nadavca.prep", "nadavca.drain"}
    assert threads["nadavca.prep"] != threads["nadavca.drain"]
    with profiling.trace(None):
        pass


def test_prefetch_keeps_order_and_raises_the_workers_error():
    """The background thread's results come in order; an exception there is
    raised in the consumer, not lost with the thread."""
    assert list(cli._prefetched(iter(range(7)), lambda g: g * g)) == [
        g * g for g in range(7)]

    def prepare(g):
        if g == 3:
            raise ValueError("bad batch")
        return g

    got = []
    with pytest.raises(ValueError, match="bad batch"):
        for item in cli._prefetched(iter(range(7)), prepare):
            got.append(item)
    assert got == [0, 1, 2]
