"""The port's spans and counters (``utils/profiling.span``,
``utils/metrics.PROCESS``) on the CPU.

A span is a ``torch.profiler.record_function`` range while a profiler runs
and a shared no-op otherwise; the step's spans nest as the program calls
them, and the scatter's ``index_add_`` lies inside ``nadavca.accumulate``.
``upload_bytes`` counts the host bytes handed to the device; the CLI's
``padding_waste`` is the share over every batch of the job, and its
``--profile`` trace holds the CLI's own spans.
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu_torch import api, cli
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.io.simulator import random_genome, simulate_read
from nadavca_tpu_torch.kmer_model import default_model
from nadavca_tpu_torch.parallel import sharded
from nadavca_tpu_torch.pipeline import _bucket, _round_up, assemble_batch, make_preprocessor
from nadavca_tpu_torch.utils import metrics as metricsmod
from nadavca_tpu_torch.utils import profiling

CFG = AlignConfig(read_tile=8)
# (parent, child): every child range lies inside a parent range
STEP_NESTING = [("nadavca.upload", "nadavca.upload.offsets"),
                ("nadavca.step", "nadavca.fill"), ("nadavca.step", "nadavca.final_slot"),
                ("nadavca.step", "nadavca.walk"), ("nadavca.step", "nadavca.rescore"),
                ("nadavca.step", "nadavca.accumulate"), ("nadavca.step", "nadavca.merge"),
                ("nadavca.accumulate", "aten::index_add_")]
CLI_SPANS = {"nadavca.tables", "nadavca.prep", "nadavca.prep_wait", "nadavca.upload",
             "nadavca.step", "nadavca.drain", "nadavca.checkpoint", "nadavca.calls"}


@pytest.fixture(scope="module")
def world():
    """A 2 kb genome, 8 reads of 240 bases and 8 of 90: four signal buckets
    (2,176 to 2,816 samples, 1,024 and 1,280)."""
    rng = np.random.default_rng(15)
    model = default_model()
    genome = random_genome(rng, length=2000)
    reads = [simulate_read(genome, "ref", model, rng, read_len=240 if i < 8 else 90,
                           strand=1 if i % 2 else -1, read_id=f"r{i:02d}")
             for i in range(16)]
    raws = [api.raw_read_from_simulated(r) for r in reads]
    prep = make_preprocessor(genome, CFG, model=model, mode="python")
    records = [prep(r) for r in raws]
    assert all(r is not None for r in records)
    return dict(model=model, genome=genome, raws=raws, records=records)


def _ranges(prof, prefix=("nadavca.", "aten::index_add_")):
    """(name, start, end) of the host events whose names start with a prefix."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(prefix) and str(e.device_type()).endswith("CPU")]


def _inside(child, parents) -> bool:
    return any(a <= child[1] and child[2] <= b for _, a, b in parents)


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.profiler_on()
    with profiling.span("nadavca.step"):
        with profiling.span("nadavca.fill"):
            pass
    assert profiling.span("nadavca.a") is profiling.span("nadavca.b")


def test_the_step_records_its_spans_nested(world):
    from torch.profiler import ProfilerActivity, profile

    model, genome = world["model"], world["genome"]
    mesh = sharded.make_mesh(1, "cpu")
    tables = sharded.replicate_tables(
        mesh, api._maybe_subst(genome, model, CFG, "auto", mesh.devices[0]))
    batch = assemble_batch(world["records"][:8], model, CFG)
    G = len(genome["ref"])
    step = sharded.make_sharded_step(mesh, CFG, G, with_path=False)
    state = sharded.make_accumulators_sharded(mesh, G)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.profiler_on()
        blocks = sharded.shard_batch(mesh, batch, model, CFG, "auto", tables)
        score, *state = step(blocks, *state)
    assert not profiling.profiler_on()
    got = _ranges(prof)
    by_name = {}
    for r in got:
        by_name.setdefault(r[0], []).append(r)
    for parent, child in STEP_NESTING:
        assert by_name.get(child) and by_name.get(parent), (parent, child, sorted(by_name))
        for c in by_name[child]:
            assert _inside(c, by_name[parent]), (parent, c)
    # the per-block fresh accumulators and the sums into the state
    assert len(by_name["nadavca.merge"]) == 2
    assert len(by_name["aten::index_add_"]) == 3
    assert not any(_inside(c, by_name["nadavca.merge"])
                   for c in by_name["nadavca.accumulate"])
    assert int(state[1][0].sum()) > 0


def test_upload_bytes_are_the_staged_arrays(world):
    model, genome = world["model"], world["genome"]
    mesh = sharded.make_mesh(2, "cpu")
    tables = sharded.replicate_tables(
        mesh, api._maybe_subst(genome, model, CFG, "auto", mesh.devices[0]))
    batch = assemble_batch(world["records"][:8], model, CFG, pad_reads_to=16)
    reg = metricsmod.PROCESS
    before = reg.counters.get("upload_bytes", 0.0)
    blocks = sharded.shard_batch(mesh, batch, model, CFG, "auto", tables)
    want = 0
    for b in blocks:
        # the level vectors came with the tables: no batch uploads them
        assert b.staged["lm"] is tables[b.device].level_mean
        assert b.staged["ls"] is tables[b.device].level_std
        want += sum(v.numel() * v.element_size() for name, v in b.staged.items()
                    if isinstance(v, torch.Tensor) and name not in ("lm", "ls"))
        want += sum(v.numel() * v.element_size() for v in (b.wstart, b.wlen, b.strand))
    assert want > batch.x.nbytes
    assert reg.counters["upload_bytes"] - before == want


def _cli_snp(world, tmp_path, *extra):
    path = str(tmp_path / "ref.fa")
    world["genome"].to_fasta(path)
    argv = ["snp", path, "(in memory)", "-o", str(tmp_path / "calls.vcf"),
            "--device", "cpu", "--batch-reads", "8", "--prep", "python",
            "--workers", "1", *extra]
    assert cli.main(argv, reads=world["raws"]) == 0
    return metricsmod.PROCESS.snapshot()


def test_padding_waste_is_the_jobs_share(world, tmp_path):
    """Four batches, each padded to its own bucket: the gauge is the share
    over all of them, which none of them has alone."""
    snap = _cli_snp(world, tmp_path)
    t = np.array([len(r.signal) for r in world["records"]])
    padded = np.array([_round_up(_bucket(v, CFG.bucket_edges), CFG.signal_chunk)
                       for v in t])
    c = snap["counters"]
    assert c["signal_samples_true"] == t.sum()
    assert c["signal_samples_padded"] == padded.sum()
    job = 1.0 - t.sum() / padded.sum()
    assert snap["gauges"]["padding_waste"] == pytest.approx(job, abs=1e-4)
    # the batches are the reads of one padded length each
    per_batch = [1.0 - t[padded == p].sum() / padded[padded == p].sum()
                 for p in np.unique(padded)]
    assert len(per_batch) >= 2
    assert all(abs(w - job) > 1e-3 for w in per_batch), (per_batch, job)
    assert c["upload_bytes"] > padded.sum() * 4


def test_the_cli_profile_holds_the_cli_spans(world, tmp_path):
    d = str(tmp_path / "prof")
    _cli_snp(world, tmp_path, "--profile", d, "--checkpoint",
             str(tmp_path / "ck.npz"), "--checkpoint-every", "1")
    with open(os.path.join(d, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert CLI_SPANS <= names, CLI_SPANS - names
