"""World 1 of the JAX package's own tests through the port: an N run in the
reference (``tests/test_edge_cases.py::test_reference_with_N_bases``, seed 8,
8 reads of 300 bases simulated from the clean genome and aligned against one
with ``N`` at 600–619).

Along the N run the batch's levels are 0 and spreads 1 over 25 consecutive
k-mer positions, so every way of placing the samples there scores the same:
the two packages, and the port's two backends, may place them differently
(up to 17 positions apart), and both are optimal. The paths are held by the
run rule (``nadavca_tpu_torch.utils.parity``), with the differences bounded
by the live samples that either path places inside the run; the rescores
within 2e-3 at every position whose window touches no segment bound that
the paths place differently; the calls exactly, and none inside the run.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu_torch.utils import parity, worlds

import torch_worlds as W
from test_torch_rescore import jax_span_ok

N_LO, N_HI = worlds.N_RUN


@pytest.fixture(scope="module")
def world():
    j, p = worlds.n_run(W.JAX), worlds.n_run(W.PORT)
    for w in (j, p):
        (w["batch"],) = w["batches"]
    return dict(jax=j, port=p, runs={})


def _run(world, name):
    """Each run of the world once: the JAX ``scan`` and ``pallas`` (interpret
    mode, ``kernel_unroll=1``, tables), the port's ``scan`` twin and its
    kernels' plain versions with and without tables."""
    if name not in world["runs"]:
        j, p = world["jax"], world["port"]
        if name == "jax_scan":
            out = W.jax_align(j["batch"], j["model"], j["cfg"], "scan")
        elif name == "jax_pallas":
            out = W.jax_align(j["batch"], j["model"],
                              dataclasses.replace(j["cfg"], kernel_unroll=1), "pallas",
                              genome=j["genome"])
            # interpret mode has no span mask; the port applies it from T = 2304
            b = j["batch"]
            assert b.x.shape[1] >= 2304
            ok = jax_span_ok(out["path"], b.t_len, b.ids.shape[1], b.codes.shape[1],
                             j["model"].k)
            out["base_loglik"] = np.where(ok[:, :, None], out["base_loglik"], 0.0)
        elif name == "scan":
            out = W.port_align(p["batch"], p["model"], p["cfg"], "scan")
        elif name == "kernels":
            out = W.port_align(p["batch"], p["model"], p["cfg"], "cuda")
        else:
            out = W.port_align(p["batch"], p["model"], p["cfg"], "cuda", genome=p["genome"])
        world["runs"][name] = out
    return world["runs"][name]


def _hold(world, name_a, name_b, compare=None):
    b, k = world["port"]["batch"], world["port"]["model"].k
    a, c = _run(world, name_a), _run(world, name_b)
    bound = worlds.samples_in_n_run(b, a["path"], c["path"])
    held = W.hold(f"{name_a} against {name_b}", a, c, b, k, max_ties=bound,
                  compare=compare)
    # every difference lies inside the N run
    diff = torch.as_tensor(np.asarray(a["path"])) != torch.as_tensor(np.asarray(c["path"]))
    diff &= parity.live_mask(b.t_len, b.x.shape[1], b.n_reads)
    r, t = torch.nonzero(diff, as_tuple=True)
    pa = torch.as_tensor(np.asarray(a["path"]))[r, t].long()
    assert bool((torch.from_numpy(b.ids)[r, pa] < 0).all())
    return held, bound


def test_both_packages_build_the_same_world(world):
    j, p = world["jax"], world["port"]
    W.assert_same_reads(j["reads"], p["reads"])
    np.testing.assert_array_equal(j["codes"], p["codes"])
    W.assert_same_batch(j["batch"], p["batch"])
    assert p["batch"].n_reads == 8
    # the N run: level 0 and spread 1 over the 25 k-mer positions that hold an N
    b = p["batch"]
    run = (b.ids < 0) & (np.arange(b.ids.shape[1])[None, :] < b.n_ref[:, None])
    assert run.sum(1).max() == 25
    assert (b.mu[run] == 0).all() and (b.sigma[run] == 1).all()


def test_scan_twin_against_the_jax_scan(world):
    """573 of 23,818 live entries differ on the CPU, all inside the run."""
    held, bound = _hold(world, "scan", "jax_scan")
    assert 0 < held.tie_differences <= bound
    assert held.max_gap > 2            # the near rule would not explain these
    assert held.compared_positions > 3500


@pytest.mark.parametrize("name", ["kernels", "tables"])
def test_kernels_against_the_scan_twin(world, name):
    """The kernels' plain versions, without and with tables, against the
    ``scan`` twin, where their rescore scores as the twin's does."""
    b, k = world["port"]["batch"], world["port"]["model"].k
    compare = W.kernel_compare(b, _run(world, name), k, tables=name == "tables")
    held, bound = _hold(world, name, "scan", compare=compare)
    assert held.tie_differences <= bound and held.compared_positions > 1800


def test_table_kernels_against_the_jax_pallas_backend(world):
    """The kernel twin with tables against the JAX ``pallas`` backend in
    interpret mode (599 of 23,818 entries differ, all inside the run)."""
    held, bound = _hold(world, "tables", "jax_pallas")
    assert held.tie_differences <= bound and held.compared_positions > 3500


@pytest.mark.parametrize("name", ["scan", "kernels", "tables", "jax_pallas"])
def test_calls_equal_the_jax_scan_and_none_in_the_run(world, name):
    """The JAX test's own assert (no call in 600–619), and the call set of
    every run equal to the JAX ``scan`` backend's; runs with tables against
    the JAX ``scan`` output masked as the tables path masks it."""
    j, p = world["jax"], world["port"]
    cfg, codes = p["cfg"], p["codes"]
    ref = _run(world, "jax_scan")["base_loglik"]
    got = _run(world, name)["base_loglik"]
    if name in ("tables", "jax_pallas"):
        ref = parity.masked_like_tables(ref, got)
    want = W.jax_calls(j["batch"], ref, codes, "ref", j["cfg"], min_coverage=1)
    calls = (W.jax_calls(j["batch"], got, codes, "ref", j["cfg"], min_coverage=1)
             if name == "jax_pallas"
             else parity.calls_of([p["batch"]], [got], codes, "ref", cfg, min_coverage=1))
    assert all(not (N_LO <= c.position < N_HI) for c in calls), calls
    W.assert_same_calls(calls, want)
