"""The port's ``parallel.sharded`` on 4 and 8 CPU shards against the JAX package's
``parallel.sharded`` on the 8-device virtual mesh (``tests/conftest.py``).

The world is ``tests/test_sharded.py``'s: 16 reads of 300 bases over a
2048-base genome, ``read_tile=8``, the ``scan`` backend. The JAX batch is
handed to the port as numpy (``convert.batch_from_numpy``), so both packages
shard the same rows. Tolerances: scores rtol 1e-5 / atol 1e-3; paths, ``cov``
and ``votes`` exact; ``acc`` rtol 1e-4 / atol 1e-2 (the JAX tests' own).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.anchor import SeedIndex
from nadavca_tpu.config import AlignConfig as JaxConfig
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.parallel import sharded as jsharded
from nadavca_tpu.pipeline import assemble_batch, preprocess_read, stage_batch

from nadavca_tpu_torch import call as tcall
from nadavca_tpu_torch import convert
from nadavca_tpu_torch import pipeline as tpipe
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.parallel import sharded

# kernel_unroll=1 only shortens the interpret-mode compile
JCFG = JaxConfig(read_tile=8, kernel_unroll=1)
CFG = AlignConfig(read_tile=8)
ACC = dict(rtol=1e-4, atol=1e-2)
SCORE = dict(rtol=1e-5, atol=1e-3)
# the port's shards under the scan backend (its per-step loop runs once a
# shard, so fewer shards keep the file short); the kernel backend runs 8
N = 4

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(31)
    model = default_model()
    genome = random_genome(rng, length=2048)
    index = SeedIndex(genome)
    reads = [simulate_read(genome, "ref", model, rng, read_len=300,
                           strand=1 if i % 2 else -1) for i in range(16)]
    records = [preprocess_read(r.signal.astype(np.float32), r.basecall,
                               r.move_index, index, genome, r.read_id)
               for r in reads]
    records = [r for r in records if r is not None]
    tmodel = convert.kmer_model_from_numpy(model.level_mean, model.level_std, model.k)
    return dict(model=model, tmodel=tmodel, genome=genome, records=records,
                G=len(genome["ref"]))


def _port_batch(jb):
    d = {f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)}
    d["bands"] = dataclasses.asdict(jb.bands)
    return convert.batch_from_numpy(d)


def _jax(w, n, batch, genome_sharded=False, merge_deferred=False, backend="scan",
         n_batches=1, cfg=JCFG):
    """JAX sharded step over ``n_batches`` copies of ``batch``; numpy out."""
    mesh = jsharded.make_mesh(n, cfg.data_axis)
    staged = stage_batch(batch, w["model"], cfg, backend)
    step = jsharded.make_sharded_step(
        mesh, cfg, w["G"], backend=staged["backend"], k=w["model"].k,
        genome_sharded=genome_sharded, interpret=backend == "pallas",
        use_bands=staged["mu_b"] is not None, use_tables=staged["ttab"] is not None,
        merge_deferred=merge_deferred)
    accs = jsharded.make_accumulators_sharded(mesh, cfg, w["G"], genome_sharded,
                                              merge_deferred=merge_deferred)
    inputs = {k: v for k, v in jsharded.shard_staged(mesh, cfg, staged).items()
              if k not in ("backend", "k") and v is not None}
    extra = jsharded.shard_batch_arrays(mesh, cfg, {
        k: jnp.asarray(getattr(batch, f)) for k, f in
        (("wstart", "window_start"), ("wlen", "window_len"), ("strand", "strand"))})
    for _ in range(n_batches):
        score, path, *accs = step(inputs, extra["wstart"], extra["wlen"],
                                  extra["strand"], *accs)
    if merge_deferred:
        accs = jsharded.make_merge_fn(mesh, cfg, w["G"], genome_sharded)(*accs)
    return (np.asarray(score), np.asarray(path)) + tuple(np.asarray(a) for a in accs)


@pytest.fixture(scope="module", autouse=True)
def aligned_once():
    """Each block of a batch is aligned once in this module: the runs of
    one batch differ only in how its blocks' outputs are summed, so the
    first run's outputs (computed by ``pipeline.align_batch`` itself) serve
    the later ones. Keyed by the block's staged dict, kept alive here."""
    memo = {}
    orig = tpipe.align_batch

    def once(batch, model, cfg, **kw):
        key = (id(kw.get("staged")), kw.get("backend"), kw.get("rescore", True))
        if kw.get("staged") is None:
            return orig(batch, model, cfg, **kw)
        if key not in memo:
            memo[key] = (kw["staged"], orig(batch, model, cfg, **kw))
        return memo[key][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "align_batch", once)
        yield


_BLOCKS = {}


def _blocks(w, n, tb, backend, cfg=CFG):
    """The blocks of ``tb`` on n CPU shards, made once per (batch, n,
    backend), so that every run of that batch reuses their alignment."""
    key = (id(tb), n, backend)
    if key not in _BLOCKS:
        mesh = sharded.make_mesh(n, "cpu")
        _BLOCKS[key] = (tb, mesh, sharded.shard_batch(mesh, tb, w["tmodel"], cfg, backend))
    return _BLOCKS[key][1:]


def _port(w, n, tb, genome_sharded=False, merge_deferred=False, backend="scan",
          n_batches=1, cfg=CFG):
    """The port's sharded step on n CPU shards; (score, path, acc, cov,
    votes) as numpy, the accumulators merged and whole."""
    mesh, blocks = _blocks(w, n, tb, backend, cfg)
    step = sharded.make_sharded_step(mesh, cfg, w["G"], genome_sharded=genome_sharded,
                                     merge_deferred=merge_deferred)
    accs = sharded.make_accumulators_sharded(mesh, w["G"], genome_sharded, merge_deferred)
    for _ in range(n_batches):
        score, path, *accs = step(blocks, *accs)
    if merge_deferred:
        accs = sharded.make_merge_fn(mesh, w["G"], genome_sharded)(*accs)
    return (score.numpy(), path.numpy()) + tuple(
        sharded.fetch(mesh, a, genome_sharded) for a in accs)


def _same(got, want, scores=True):
    s, p, acc, cov, votes = got
    if scores:
        np.testing.assert_allclose(s, want[0], **SCORE)
        np.testing.assert_array_equal(p, want[1])
    np.testing.assert_array_equal(cov, want[3])
    np.testing.assert_array_equal(votes, want[4])
    np.testing.assert_allclose(acc, want[2], **ACC)


@pytest.fixture(scope="module")
def batch16(world):
    jb = assemble_batch(world["records"][:16], world["model"], JCFG, pad_reads_to=16)
    return jb, _port_batch(jb)


@pytest.fixture(scope="module")
def jax8(world, batch16):
    return _jax(world, 8, batch16[0])


@pytest.mark.parametrize("n", [N, 1])
def test_replicated_matches_the_jax_mesh(world, batch16, jax8, n):
    """Replicated accumulators on N shards and on one device: the JAX
    package's 8-device step."""
    _same(_port(world, n, batch16[1]), jax8)


def test_genome_sharded_matches_replicated_and_jax(world, batch16, jax8):
    got = _port(world, N, batch16[1], genome_sharded=True)
    _same(got, _port(world, N, batch16[1]))
    _same(got, _jax(world, 8, batch16[0], genome_sharded=True))
    _same(got, jax8)


@pytest.mark.parametrize("genome_sharded", [False, True], ids=["replicated", "sharded"])
def test_deferred_merge_matches_per_batch(world, batch16, genome_sharded):
    """Two batches into per-shard partials and ONE merge equal the per-batch
    sums, in both layouts, and the JAX package's deferred run."""
    tb = batch16[1]
    got = _port(world, N, tb, genome_sharded, merge_deferred=True, n_batches=2)
    _same(got, _port(world, N, tb, genome_sharded, n_batches=2))
    _same(got, _jax(world, 8, batch16[0], genome_sharded, merge_deferred=True,
                    n_batches=2), scores=False)


def test_merge_is_pure_and_partials_grow_in_place(world, batch16):
    """Merging twice gives the same result, and the partials are left as
    they were; each shard's partial holds only its own rows' contribution."""
    mesh, blocks = _blocks(world, N, batch16[1], "scan")
    G = world["G"]
    step = sharded.make_sharded_step(mesh, CFG, G, merge_deferred=True, with_path=False)
    accs = sharded.make_accumulators_sharded(mesh, G, merge_deferred=True)
    ids = [id(t) for a in accs for t in a]
    _, *accs = step(blocks, *accs)
    assert [id(t) for a in accs for t in a] == ids    # grown in place
    before = [t.clone() for a in accs for t in a]
    merge = sharded.make_merge_fn(mesh, G)
    m1, m2 = merge(*accs), merge(*accs)
    for a, b in zip(m1, m2):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(before, (t for a in accs for t in a)))
    # shard i's partial: its rows alone, scattered as accumulate_batch does
    for blk, a, c, v in zip(blocks, *accs):
        out = tpipe.align_batch(blk.batch, None, CFG, staged=blk.staged)
        z = tcall.make_accumulators(G, with_votes=True, device="cpu")
        wa, wc, wv = tcall.accumulate_batch(z[0], z[1], out["base_loglik"], blk.wstart,
                                            blk.wlen, blk.strand, votes=z[2], cfg=CFG)
        assert torch.equal(c, wc) and torch.equal(v, wv)
        torch.testing.assert_close(a, wa, **ACC)


def test_all_padding_shards_and_a_restored_state(world):
    """5 reads padded to 16 rows on 8 shards: shards 3..7 hold padding only.
    Every layout equals one device; a run seeded with a restored state adds
    to it, in the deferred layout through shard 0's partial only."""
    jb = assemble_batch(world["records"][:5], world["model"], JCFG, pad_reads_to=16)
    tb = _port_batch(jb)
    mesh, blocks = _blocks(world, 8, tb, "cuda")
    assert [b.batch.n_reads for b in blocks] == [2, 2, 1, 0, 0, 0, 0, 0]
    one = _port(world, 1, tb, backend="cuda")
    for gs, md in ((False, False), (True, False), (False, True), (True, True)):
        _same(_port(world, 8, tb, gs, md, backend="cuda"), one)
    G = world["G"]
    rng = np.random.default_rng(5)
    state = (rng.normal(0, 1, (G, 4)).astype(np.float32),
             rng.integers(0, 9, G).astype(np.int32),
             rng.integers(0, 9, (G, 4)).astype(np.int32))
    for gs, md in ((False, False), (True, False), (True, True)):
        accs = sharded.make_accumulators_sharded(mesh, G, gs, md, state=state)
        if md:
            assert all(int(c.abs().sum()) == 0 for c in accs[1][1:])
        _, *accs = sharded.make_sharded_step(mesh, CFG, G, gs, with_path=False,
                                             merge_deferred=md)(blocks, *accs)
        if md:
            accs = sharded.make_merge_fn(mesh, G, gs)(*accs)
        got = [sharded.fetch(mesh, a, gs) for a in accs]
        np.testing.assert_array_equal(got[1], one[3] + state[1])
        np.testing.assert_array_equal(got[2], one[4] + state[2])
        np.testing.assert_allclose(got[0], one[2] + state[0], **ACC)


def test_kernel_backend_matches_pallas_interpret(world):
    """The port's kernel backend (its plain versions on the CPU) on 8 shards
    against the JAX ``pallas`` backend in interpret mode on its 8-device
    mesh, padded as ``tests/test_sharded.py`` pads it (64 rows, 8 a shard:
    the fill kernel's read tile). No position of this batch falls under the
    port's span mask."""
    jb = assemble_batch(world["records"], world["model"], JCFG, pad_reads_to=64)
    tb = _port_batch(jb)
    got = _port(world, 8, tb, backend="cuda")
    want = _jax(world, 8, jb, backend="pallas")
    np.testing.assert_allclose(got[0], want[0], **SCORE)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_allclose(got[2], want[2], **ACC)


def test_batch_rows_and_the_in_place_scatter(world, batch16):
    """``pipeline.batch_rows`` keeps every field of its rows; padding rows
    stay padding. ``call.accumulate_batch_`` adds in place what
    ``accumulate_batch`` returns."""
    tb = batch16[1]
    blk = tpipe.batch_rows(tb, 4, 12)
    assert blk.x.shape[0] == 8 and blk.n_reads == min(8, tb.n_reads - 4)
    np.testing.assert_array_equal(blk.bands.lo, tb.bands.lo[4:12])
    assert blk.read_ids == tb.read_ids[4:12]
    assert tpipe.batch_rows(tb, 16, 16).n_reads == 0
    (blk1,) = _blocks(world, 1, tb, "scan")[1]
    out = tpipe.align_batch(blk1.batch, None, CFG, staged=blk1.staged)
    G = world["G"]
    args = (out["base_loglik"], torch.from_numpy(tb.window_start),
            torch.from_numpy(tb.window_len), torch.from_numpy(tb.strand))
    z = tcall.make_accumulators(G, with_votes=True, device="cpu")
    want = tcall.accumulate_batch(z[0], z[1], *args, votes=z[2], cfg=CFG)
    acc, cov, votes = tcall.make_accumulators(G, with_votes=True, device="cpu")
    tcall.accumulate_batch_(acc, cov, votes, *args, cfg=CFG)
    assert torch.equal(cov, want[1]) and torch.equal(votes, want[2])
    torch.testing.assert_close(acc, want[0], rtol=0, atol=0)
