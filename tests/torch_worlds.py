"""The JAX package's own test worlds, built through both packages.

The builders of ``nadavca_tpu_torch.utils.worlds`` take a package namespace
(:data:`JAX` or :data:`PORT`) and draw the same numbers from the same seed
through that package's copy of the simulator, the anchorer and the batch
assembler, so the two worlds can be held equal array for array before
anything is compared. The runners drive
each package one level below its ``api``, as the JAX tests do: a batch
through ``align_batch``, the accumulators, ``call_snps``.

Imported by ``tests/test_torch_world_*.py``; not a test module itself.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import torch

import jax.numpy as jnp
import nadavca_tpu
from nadavca_tpu import anchor as janchor
from nadavca_tpu import call as jcall
from nadavca_tpu import genome as jgenome
from nadavca_tpu import pipeline as jpipe
from nadavca_tpu.io import simulator as jsim
from nadavca_tpu.ops.subst_tables import build_subst_tables as jbuild_tables

from nadavca_tpu_torch import pipeline as tpipe
from nadavca_tpu_torch.ops.subst_tables import build_subst_tables as tbuild_tables
from nadavca_tpu_torch.utils import parity, worlds


JAX = worlds.namespace(nadavca_tpu, janchor, jgenome, jpipe, jsim)
PORT = worlds.PORT

BATCH_FIELDS = ("x", "t_len", "mu", "sigma", "n_ref", "codes", "ids",
                "window_start", "window_len", "strand")


def assert_same_reads(a, b):
    """Two packages' simulated reads, equal array for array."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.read_id == rb.read_id and ra.basecall == rb.basecall
        assert (ra.ref_start, ra.ref_end, ra.strand) == (rb.ref_start, rb.ref_end, rb.strand)
        for f in ("signal", "move_index", "true_path", "window_codes"):
            np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f), err_msg=f)


def assert_same_batch(a, b):
    """Two packages' assembled batches, equal array for array."""
    assert a.n_reads == b.n_reads and a.read_ids == b.read_ids
    assert a.contigs == b.contigs
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.bands.lo, b.bands.lo)
    np.testing.assert_array_equal(a.bands.delta, b.bands.delta)


# ------------------------------------------------------------------ runners
def jax_align(batch, model, cfg, backend="scan", genome=None):
    """The JAX package's ``align_batch`` as numpy: path, score, base_loglik.
    ``"pallas"`` runs in interpret mode with the genome's tables."""
    subst = jbuild_tables(genome, model) if backend == "pallas" else None
    out = jpipe.align_batch(batch, model, cfg, backend=backend,
                            interpret=backend == "pallas", subst=subst)
    return {k: np.array(v) for k, v in out.items()}


def port_align(batch, model, cfg, backend="scan", genome=None):
    """The port's ``align_batch`` on the CPU: ``"scan"`` the twin, ``"cuda"``
    the kernels' plain versions, with the genome's tables when ``genome`` is
    given."""
    tables = (tbuild_tables(genome, model, device="cpu")
              if genome is not None and backend == "cuda" else None)
    return tpipe.align_batch(batch, model, cfg, backend=backend, device="cpu",
                             subst=tables)


def jax_calls(batch, base_ll, codes, contig, cfg, min_coverage, votes=True):
    """The JAX package's accumulators and ``call_snps`` over one batch (with
    the per-read votes, or without as ``tests/test_anchor_indel.py`` calls)."""
    n = batch.n_reads
    acc, cov, *v = jcall.make_accumulators(len(codes), with_votes=votes)
    acc, cov, *v = jcall.accumulate_batch(
        acc, cov, jnp.asarray(np.asarray(base_ll)[:n]), jnp.asarray(batch.window_start[:n]),
        jnp.asarray(batch.window_len[:n]), jnp.asarray(batch.strand[:n]),
        votes=v[0] if votes else None, cfg=cfg)
    return jcall.call_snps(np.asarray(acc), np.asarray(cov), codes, contig, cfg,
                           min_coverage=min_coverage,
                           votes=np.asarray(v[0]) if votes else None)


def assert_same_calls(got, want):
    """Equal call lists; the posteriors within 1e-5 (float32 sums of per-read
    values that agree to ~1e-3)."""
    assert parity.call_keys(got) == parity.call_keys(want)
    np.testing.assert_allclose([c.probability for c in got],
                               [c.probability for c in want], atol=1e-5)


def kernel_compare(batch, out, k, tables):
    """(R, L) the positions a kernel run's rescore (``out``) scores as the
    ``scan`` twin does (``parity.kernel_compare_mask``)."""
    return parity.kernel_compare_mask(out["path"], batch.t_len, batch.window_len,
                                      batch.codes.shape[1], batch.ids.shape[1], k, tables)


def hold(tag, a, b, batch, k, max_ties, compare=None):
    """:func:`parity.hold_runs` on two runs of one batch (dicts with ``path``
    and ``base_loglik``)."""
    held = parity.hold_runs(tag, a["path"], a["base_loglik"], b["path"], b["base_loglik"],
                            batch.t_len, batch.mu, batch.sigma, k, max_ties,
                            n_reads=batch.n_reads, compare=compare)
    print(f"{tag}: {held.as_dict()} of {int(batch.t_len[:batch.n_reads].sum())} live")
    return held


# ---------------------------------------------------------- the accuracy sweeps
SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")


def load_script(name):
    """A script of ``scripts/`` as a module, as ``tests/test_accuracy.py``
    loads the JAX sweep."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod        # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod


def check_quick_cell(sweep, tsweep, i):
    """Quick-grid cell ``i`` at seed 7 (``tests/test_accuracy.py``): the
    port's call set under ``scan`` equals the JAX package's under ``scan``,
    and clears the JAX test's floors."""
    cell, jcell = tsweep.QUICK_GRID[i], sweep.QUICK_GRID[i]
    assert (cell.coverage, cell.noise, cell.density, cell.read_len, cell.genome_len) == \
           (jcell.coverage, jcell.noise, jcell.density, jcell.read_len, jcell.genome_len)
    m, calls = tsweep.run_cell(cell, "scan", seed=7)
    jm, jcalls = sweep.run_cell(jcell, "scan", seed=7)
    assert calls == jcalls, sorted(calls ^ jcalls)
    for key in ("n_reads", "n_anchored", "tp", "fp", "fn", "n_shifted"):
        assert m[key] == jm[key], (key, m, jm)
    assert m["n_anchored"] >= 0.95 * m["n_reads"], m
    assert m["recall"] >= 0.80, f"recall floor: {m}"
    assert m["precision"] >= 0.75, f"precision floor: {m}"
    assert m["fp"] - m["n_shifted"] <= 1, f"unexplained FPs: {m}"
