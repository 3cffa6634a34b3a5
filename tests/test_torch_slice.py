"""The slices as a whole: reads → banded Viterbi → rescore → SNP calls, port
vs JAX package on the golden dataset (16 simulated reads), for both rescores:
``"local"`` (the default: restricted re-DP per substitution) and ``"fixed"``
(the documented approximation).

The JAX ``api`` cannot run its ``pallas`` backend on the CPU (no ``interpret``
argument), so the JAX side is driven one level below: ``assemble_batch`` →
``align_batch(interpret=True)`` → ``accumulate_batch`` → ``call_snps``. The
Viterbi path does not depend on the rescore, so it is computed once per
backend and the local rescore is called on it directly, with the genome
tables under ``pallas``, as ``pipeline.device_compute`` does. The port goes
through its ``api`` on ``device="cpu"``, where its kernels' plain versions run.

Interpret mode has no span mask; the golden batch is longer than 2304 samples,
so the port applies it. The JAX output is zeroed here by the JAX package's own
rule before it is accumulated (see tests/test_torch_rescore.py).

The goldens (``tests/goldens``) were written by the JAX package's CLI with
``--backend scan --batch-reads 16`` and its defaults (``min_coverage`` 3); the
port's ``scan`` backend reproduces them byte for byte through its ``api`` and
``call.write_vcf`` / ``write_alignment``.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import nadavca_tpu
from nadavca_tpu import api as japi
from nadavca_tpu import call as jcall
from nadavca_tpu import pipeline as jpipe
from nadavca_tpu.io import fast5 as jfast5
from nadavca_tpu.ops import banded_dp as jbanded
from nadavca_tpu.ops import pallas_rescore
from nadavca_tpu.ops.subst_tables import build_subst_tables as jax_build_tables

import nadavca_tpu_torch
from nadavca_tpu_torch import api as tapi
from nadavca_tpu_torch import call as tcall
from nadavca_tpu_torch import convert
from nadavca_tpu_torch import pipeline as tpipe

from test_torch_rescore import jax_span_ok

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
DATA = os.path.join(GOLD, "data")
REF = os.path.join(DATA, "reference.fasta")

pytestmark = pytest.mark.skipif(
    not (jfast5.HAVE_H5PY and os.path.exists(REF)),
    reason="golden dataset or h5py missing")

# thresholds low enough that 16 reads over 1.5 kb yield a call list to compare
THRESHOLDS = dict(snp_min_alt_votes=1, snp_threshold=0.6)
OVERRIDES = dict(snp_rescore="fixed", **THRESHOLDS)
MIN_COV = 1
BACKENDS = {"cuda": "pallas", "scan": "scan"}      # port backend -> JAX backend


@pytest.fixture(scope="module")
def jax_side():
    """Records and one batch, built once with the JAX package."""
    # kernel_unroll=1 only shortens the interpret-mode compile
    cfg = nadavca_tpu.AlignConfig(kernel_unroll=1, **OVERRIDES)
    genome = nadavca_tpu.Genome.from_fasta(REF)
    model = nadavca_tpu.default_model(cfg.k)
    records = japi._preprocess(japi._iter_raw(DATA), genome, model, cfg,
                               prep="python")
    group = sorted(records, key=lambda r: len(r.signal))
    batch = jpipe.assemble_batch(group, model, cfg)
    return dict(cfg=cfg, genome=genome, model=model, records=records,
                group=group, batch=batch, aligned={})


def _jax_local(js, backend, out):
    """The JAX local rescore on the path of ``out``, as device_compute runs it."""
    cfg, batch, model = js["cfg"], js["batch"], js["model"]
    common = (jnp.asarray(batch.x), out["path"], jnp.asarray(batch.t_len),
              jnp.asarray(batch.codes), jnp.asarray(batch.ids),
              jnp.asarray(model.level_mean), jnp.asarray(model.level_std))
    if backend == "scan":
        return np.asarray(jbanded.base_loglik_local_batch(
            *common, model.k, cfg, t_w=cfg.snp_local_window))
    tables = jax_build_tables(js["genome"], model)
    woff = tables.window_offsets(
        batch.contigs, batch.window_start, batch.window_len, batch.strand,
        padded_len=batch.codes.shape[1])
    ll = np.asarray(pallas_rescore.base_loglik_local_pallas(
        *common, model.k, cfg, t_w=cfg.snp_local_window, interpret=True,
        tables_tab=tables.tab4, tables_valid=tables.valid,
        window_off=jnp.asarray(woff)))
    assert batch.x.shape[1] >= 2304          # the span mask applies on the chip
    ok = jax_span_ok(np.asarray(out["path"]), batch.t_len, batch.ids.shape[1],
                      batch.codes.shape[1], model.k)
    return np.where(ok[:, :, None], ll, 0.0).astype(np.float32)


def _jax_run(js, backend, rescore):
    cfg, batch, genome = js["cfg"], js["batch"], js["genome"]
    if backend not in js["aligned"]:         # Viterbi + fixed rescore, once
        js["aligned"][backend] = jpipe.align_batch(
            batch, js["model"], cfg, backend=backend,
            interpret=(backend == "pallas"))
    out = js["aligned"][backend]
    base_ll = out["base_loglik"] if rescore == "fixed" else jnp.asarray(
        _jax_local(js, backend, out))
    n = batch.n_reads
    contig = genome.contigs[0]
    acc, cov, votes = jcall.make_accumulators(len(contig), with_votes=True)
    acc, cov, votes = jcall.accumulate_batch(
        acc, cov, base_ll[:n], jnp.asarray(batch.window_start[:n]),
        jnp.asarray(batch.window_len[:n]), jnp.asarray(batch.strand[:n]),
        votes=votes, cfg=cfg)
    calls = jcall.call_snps(np.asarray(acc), np.asarray(cov), contig.codes,
                            contig.name, cfg, min_coverage=MIN_COV,
                            votes=np.asarray(votes))
    return dict(path=np.array(out["path"]), score=np.array(out["score"]),
                base_ll=np.array(base_ll), calls=calls)


@pytest.mark.parametrize("rescore,backend", [
    pytest.param("fixed", "cuda", id="cuda"),
    pytest.param("fixed", "scan", id="scan"),
    pytest.param("local", "cuda", id="local-cuda"),
    pytest.param("local", "scan", id="local-scan"),
])
def test_slice_matches_jax(jax_side, rescore, backend):
    js = jax_side
    want = _jax_run(js, BACKENDS[backend], rescore)
    batch, group = js["batch"], js["group"]
    # "local" is the default of AlignConfig: only the thresholds are set
    cfg = nadavca_tpu_torch.AlignConfig(
        **(OVERRIDES if rescore == "fixed" else THRESHOLDS))
    assert cfg.snp_rescore == rescore

    calls = tapi.call_snps(REF, DATA, cfg, backend=backend, batch_reads=16,
                           min_coverage=MIN_COV, prep="python", device="cpu")
    key = lambda c: (c.contig, c.position, c.ref_base, c.alt_base, c.coverage)
    assert len(want["calls"]) >= 1
    assert [key(c) for c in calls] == [key(c) for c in want["calls"]]
    # posteriors of float32 sums of per-read values that agree to ~1e-3
    np.testing.assert_allclose([c.probability for c in calls],
                               [c.probability for c in want["calls"]], atol=1e-5)

    alns = tapi.align_signal(REF, DATA, cfg, backend=backend, batch_reads=16,
                             prep="python", device="cpu")
    by_id = {a.read_id: a for a in alns}
    assert len(alns) == batch.n_reads == 16
    assert [a.read_id for a in alns] == [r.read_id for r in js["records"]]
    for r in range(batch.n_reads):
        rec = group[r]
        a = by_id[rec.read_id]
        s, e = jpipe.path_to_segments(want["path"][r], int(batch.t_len[r]),
                                      int(batch.n_ref[r]))
        # segments come from the path alone: identical
        np.testing.assert_array_equal(a.seg_start, s)
        np.testing.assert_array_equal(a.seg_end, e)
        assert (a.contig, a.strand, a.ref_start, a.ref_end) == (
            rec.anchor.contig, rec.anchor.strand, rec.anchor.ref_start,
            rec.anchor.ref_end)
        # the tolerance of tests/test_pallas_dp.py for scores
        np.testing.assert_allclose(a.score, want["score"][r], rtol=1e-4, atol=1e-2)
        wlen = int(batch.window_len[r])
        np.testing.assert_allclose(a.base_loglik, want["base_ll"][r, :wlen],
                                   rtol=1e-4, atol=2e-3)


def test_handed_over_batch_gives_the_same_device_outputs(jax_side):
    """convert.batch_from_numpy: the JAX package's batch, as numpy, drives the
    port's device step directly."""
    import dataclasses

    js = jax_side
    jb = js["batch"]
    d = {f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)}
    d["bands"] = dataclasses.asdict(jb.bands)
    tb = convert.batch_from_numpy(d)
    model = convert.kmer_model_from_numpy(js["model"].level_mean,
                                          js["model"].level_std, js["model"].k)
    cfg = convert.config_from_dict(dataclasses.asdict(js["cfg"]))
    genome = convert.genome_from_codes(
        {c.name: c.codes for c in js["genome"].contigs})
    assert [len(c) for c in genome.contigs] == [len(c) for c in js["genome"].contigs]
    # the port builds the same batch from the same files
    mine = tpipe.assemble_batch(
        sorted(tapi._preprocess(tapi._iter_raw(DATA), genome, model, cfg,
                                prep="python"),
               key=lambda r: len(r.signal)), model, cfg)
    for name in ("x", "t_len", "mu", "sigma", "n_ref", "codes", "ids",
                 "window_start", "window_len", "strand"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(tb, name))
    np.testing.assert_array_equal(mine.bands.lo, tb.bands.lo)
    np.testing.assert_array_equal(mine.bands.delta, tb.bands.delta)
    out_a = tpipe.align_batch(tb, model, cfg, backend="cuda", device="cpu")
    out_b = tpipe.align_batch(tb, model, cfg, backend="scan", device="cpu")
    live = np.arange(tb.x.shape[1])[None, :] < tb.t_len[:, None]
    # the two backends of the port agree with each other on live samples
    assert ((out_a["path"].numpy() == out_b["path"].numpy()) | ~live).all()
    np.testing.assert_allclose(out_a["score"].numpy(), out_b["score"].numpy(),
                               rtol=1e-4, atol=1e-2)


def _vcf_body(path):
    return [l for l in open(path) if not l.startswith("#")]


def test_scan_backend_reproduces_the_golden_vcf(tmp_path):
    calls = tapi.call_snps(REF, DATA, backend="scan", batch_reads=16,
                           min_coverage=3, prep="python", device="cpu")
    out = str(tmp_path / "calls.vcf")
    tcall.write_vcf(out, calls)
    body = _vcf_body(os.path.join(GOLD, "calls.vcf"))
    assert len(body) >= 1 and _vcf_body(out) == body


def test_scan_backend_reproduces_the_golden_alignments(tmp_path):
    alns = tapi.align_signal(REF, DATA, backend="scan", batch_reads=16,
                             prep="python", device="cpu")
    gold = os.path.join(GOLD, "aln")
    names = sorted(os.listdir(gold))
    assert sorted(f"{a.read_id}.txt" for a in alns) == names
    for a in alns:
        out = str(tmp_path / f"{a.read_id}.txt")
        tcall.write_alignment(out, a.read_id, a.contig, a.strand, a.ref_start,
                              a.ref_end, a.seg_start, a.seg_end)
        assert open(out).read() == open(os.path.join(gold, f"{a.read_id}.txt")).read(), \
            f"alignment drift: {a.read_id}"


def test_default_config_runs_with_no_config_at_all():
    """``call_snps(ref, fast5)`` with nothing else is the kernel backend with
    the local rescore and genome tables (here on the CPU: plain versions)."""
    calls = tapi.call_snps(REF, DATA, device="cpu")
    assert [(c.contig, c.position, c.ref_base, c.alt_base) for c in calls] == [
        ("ref", 719, "C", "A")]
    alns = tapi.align_signal(REF, DATA, device="cpu", compute_probabilities=False)
    assert len(alns) == 16 and all(a.base_loglik is None for a in alns)


@pytest.mark.parametrize("what", ["native"])
def test_not_ported_yet_raises(what, tmp_path):
    """Named for what it held before the native prep was ported (that
    ``prep="native"`` raised); the port now has it, and it reproduces the
    golden VCF through ``api.call_snps`` under ``scan``."""
    calls = tapi.call_snps(REF, DATA, backend="scan", batch_reads=16,
                           min_coverage=3, prep=what, device="cpu")
    out = str(tmp_path / "calls.vcf")
    tcall.write_vcf(out, calls)
    body = _vcf_body(os.path.join(GOLD, "calls.vcf"))
    assert len(body) >= 1 and _vcf_body(out) == body


def test_unknown_backend_and_prep_raise():
    cfg = nadavca_tpu_torch.AlignConfig(snp_rescore="fixed")
    with pytest.raises(ValueError):
        tapi.call_snps(REF, DATA, cfg, backend="pallas", device="cpu")
    with pytest.raises(ValueError):
        tapi.call_snps(REF, DATA, cfg, prep="fast", device="cpu")
    assert tpipe.resolve_backend(cfg, "auto") == "cuda"
