"""``parallel.sharded`` in a process group whose ranks hold several mesh
positions: two spawned gloo ranks of four CPU positions each against the JAX
package's 8-device mesh (``tests/conftest.py``).

The world and batch are ``tests/test_torch_sharded.py``'s (16 reads, 2 rows
a position, the ``scan`` backend); the parent computes the JAX side with that
file's ``_jax`` helper and hands the batch to the ranks as numpy, and the
ranks (``tests/torch_sharded_rank.py``) import only the port. In every
layout, from zeros and from a restored state, ``cov`` and ``votes`` equal the
JAX mesh's exactly, ``acc`` within ``test_torch_sharded.py``'s tolerance,
and each rank's score and path are its rows of the JAX result.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.pipeline import assemble_batch

from test_torch_multiprocess import free_port, rank_env
from test_torch_sharded import ACC, JCFG, SCORE, _jax, world  # noqa: F401 (fixture)

RANK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sharded_rank.py")
WORLD, N_LOCAL = 2, 4
# (name, genome-sharded, deferred, batches, restored state)
LAYOUTS = [("replicated", False, False, 1), ("genome_sharded", True, False, 1),
           ("deferred", False, True, 2), ("deferred_genome_sharded", True, True, 2)]

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _restored(G):
    rng = np.random.default_rng(5)
    return (rng.normal(0, 1, (G, 4)).astype(np.float32),
            rng.integers(0, 9, G).astype(np.int32),
            rng.integers(0, 9, (G, 4)).astype(np.int32))


@pytest.fixture(scope="module")
def group_runs(world, tmp_path_factory):
    """Every run of both ranks: {run: [rank 0's outputs, rank 1's]}; and the
    JAX batch."""
    jb = assemble_batch(world["records"][:16], world["model"], JCFG, pad_reads_to=16)
    d = {f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)}
    d["bands"] = dataclasses.asdict(jb.bands)
    state = _restored(world["G"])
    runs = [(n, gs, md, nb, None) for n, gs, md, nb in LAYOUTS]
    runs += [(n + "_restored", gs, md, 1, state) for n, gs, md, _ in LAYOUTS]
    m = world["model"]
    tmp = tmp_path_factory.mktemp("group")
    job = str(tmp / "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"batch": d, "model": (m.level_mean, m.level_std, m.k),
                     "G": world["G"], "runs": runs}, f)
    port = free_port()
    outs = [str(tmp / f"rank{r}.pkl") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, RANK, job, outs[r], str(port), str(r), str(WORLD), str(N_LOCAL)],
        env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=120)[1])
        except subprocess.TimeoutExpired:
            p.kill()
            errs.append(p.communicate()[1])
    assert [p.returncode for p in procs] == [0] * WORLD, errs
    got = {}
    for path in outs:
        with open(path, "rb") as f:
            for name, res in pickle.load(f).items():
                got.setdefault(name, []).append(res)
    return got, jb, state


def _same(ranks, want):
    """Ranks' rows joined in rank order and each rank's whole accumulators
    against the JAX mesh's (score, path, acc, cov, votes)."""
    np.testing.assert_allclose(np.concatenate([r[0] for r in ranks]), want[0], **SCORE)
    np.testing.assert_array_equal(np.concatenate([r[1] for r in ranks]), want[1])
    for r in ranks:
        np.testing.assert_array_equal(r[3], want[3])
        np.testing.assert_array_equal(r[4], want[4])
        np.testing.assert_allclose(r[2], want[2], **ACC)


@pytest.mark.parametrize("name, gs, md, n_batches", LAYOUTS, ids=[l[0] for l in LAYOUTS])
def test_two_ranks_of_four_positions_equal_the_jax_mesh(world, group_runs, name, gs, md,
                                                        n_batches):
    got, jb, state = group_runs
    want = _jax(world, 8, jb, gs, md, n_batches=n_batches)
    _same(got[name], want)
    restored = got[name + "_restored"]
    one = want if n_batches == 1 else _jax(world, 8, jb, gs, md)
    _same(restored, (one[0], one[1], one[2] + state[0], one[3] + state[1],
                     one[4] + state[2]))
