"""The upload (``utils/upload.py``, ``pipeline.stage_batch``,
``parallel.sharded.shard_batch``) on the CPU, where CUDA is absent.

Here a batch's arrays are plain numpy, the same batch the JAX package's
``assemble_batch`` builds from the same records, and every array takes the
blocking ``torch.from_numpy(a).to(device)``: the staged tensors equal those
copies element for element, ``upload_bytes`` counts their bytes and
``upload_async_bytes`` counts none. The page-locked, asynchronous path runs
on the card only (``tests/test_torch_card.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import anchor as janchor
from nadavca_tpu import kmer_model as jkmer
from nadavca_tpu import pipeline as jpipe
from nadavca_tpu.config import AlignConfig as JaxConfig

from nadavca_tpu_torch import api
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.io.simulator import random_genome, simulate_read
from nadavca_tpu_torch.kmer_model import default_model
from nadavca_tpu_torch.parallel import sharded
from nadavca_tpu_torch.pipeline import assemble_batch, make_preprocessor, stage_batch
from nadavca_tpu_torch.utils import metrics as metricsmod
from nadavca_tpu_torch.utils import upload

CFG = AlignConfig(read_tile=8)
UPLOADED = ("x", "t_len", "mu", "sigma", "n_ref", "codes", "ids", "window_start",
            "window_len", "strand")

pytestmark = pytest.mark.skipif(torch.cuda.is_available(),
                                reason="the CPU path: CUDA is present here")


@pytest.fixture(scope="module")
def world():
    """A 2 kb genome, 12 reads of 200 bases on both strands."""
    rng = np.random.default_rng(16)
    model = default_model()
    genome = random_genome(rng, length=2000)
    reads = [simulate_read(genome, "ref", model, rng, read_len=200,
                           strand=1 if i % 2 else -1, read_id=f"u{i:02d}")
             for i in range(12)]
    prep = make_preprocessor(genome, CFG, model=model, mode="python")
    records = [prep(api.raw_read_from_simulated(r)) for r in reads]
    assert all(r is not None for r in records)
    return dict(model=model, genome=genome, records=records)


def _counts():
    c = metricsmod.PROCESS.counters
    return c.get("upload_bytes", 0.0), c.get("upload_async_bytes", 0.0)


def test_host_arrays_are_plain_numpy():
    for fill, dtype in ((0, np.float32), (1, np.float32), (4, np.int32), (-1, np.int32)):
        a = upload.host_full((3, 5), fill, dtype)
        assert type(a) is np.ndarray and upload.tensor_under(a) is None
        np.testing.assert_array_equal(a, np.full((3, 5), fill, dtype))
        assert a.dtype == dtype
    src = np.arange(-3, 9, dtype=np.int64).reshape(3, 4)
    got = upload.host_copy(src, np.int32)
    assert got.dtype == np.int32 and upload.tensor_under(got) is None
    np.testing.assert_array_equal(got, src.astype(np.int32))


def test_tensor_under_finds_the_tensor_of_a_view():
    t = torch.arange(40, dtype=torch.int32).reshape(8, 5)
    rows = t.numpy()[2:6]
    v = upload.tensor_under(rows)
    assert v.data_ptr() == rows.__array_interface__["data"][0]
    assert v.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
    assert torch.equal(v, torch.from_numpy(rows))
    assert torch.equal(upload.tensor_under(rows[1]), t[3])
    assert upload.tensor_under(np.zeros(3, np.int32)) is None
    assert upload.tensor_under(rows.view(np.float32)) is None


def test_assemble_batch_is_the_jax_packages_batch(world):
    """Plain ndarrays (no tensor under them), dtype for dtype and value for
    value the batch the JAX package assembles from the same records."""
    model, records = world["model"], world["records"]
    batch = assemble_batch(records, model, CFG, pad_reads_to=16)
    jrecs = [jpipe.ReadRecord(
        read_id=r.read_id, signal=r.signal,
        anchor=janchor.Anchor(**dataclasses.asdict(r.anchor)),
        anchor_path=r.anchor_path, window_codes=r.window_codes, mu=r.mu, sigma=r.sigma)
        for r in records]
    jmodel = jkmer.KmerModel(model.k, model.level_mean, model.level_std)
    want = jpipe.assemble_batch(jrecs, jmodel, JaxConfig(read_tile=8), pad_reads_to=16)
    pairs = [(f, getattr(batch, f), getattr(want, f)) for f in UPLOADED]
    pairs += [(f, getattr(batch.bands, f), getattr(want.bands, f)) for f in ("lo", "delta")]
    for name, got, ref in pairs:
        assert type(got) is np.ndarray and upload.tensor_under(got) is None, name
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert (batch.read_ids, batch.contigs, batch.n_reads) == (
        want.read_ids, want.contigs, want.n_reads)


def _blocking(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _assert_staged(staged, blk, model, subst, dev):
    want = {f: getattr(blk, f) for f in ("x", "t_len", "mu", "sigma", "n_ref",
                                         "codes", "ids")}
    want.update(lo=blk.bands.lo, delta=blk.bands.delta,
                woff=subst.window_offsets(blk.contigs, blk.window_start,
                                          blk.window_len, blk.strand,
                                          padded_len=blk.codes.shape[1]))
    # the level vectors came with the tables: no batch uploads them
    kept = dict(lm=model.level_mean.astype(np.float32),
                ls=model.level_std.astype(np.float32))
    assert staged["lm"] is subst.level_mean and staged["ls"] is subst.level_std
    for name, a in {**want, **kept}.items():
        got, ref = staged[name], _blocking(a, dev)
        assert got.device == ref.device and got.dtype == ref.dtype, name
        assert torch.equal(got, ref), name
    assert staged["woff_range"] == (int(want["woff"].min()), int(want["woff"].max()))
    return sum(np.ascontiguousarray(a).nbytes for a in want.values())


@pytest.mark.parametrize("n_devices", [1, 2])
def test_shard_batch_stages_the_blocking_copies(world, n_devices):
    model, genome = world["model"], world["genome"]
    mesh = sharded.make_mesh(n_devices, "cpu")
    tables = sharded.replicate_tables(
        mesh, api._maybe_subst(genome, model, CFG, "auto", mesh.devices[0]))
    batch = assemble_batch(world["records"], model, CFG, pad_reads_to=16)
    wstart = batch.window_start.astype(np.int64) + 7
    before = _counts()
    blocks = sharded.shard_batch(mesh, batch, model, CFG, "auto", tables,
                                 window_start=wstart)
    after = _counts()
    assert len(blocks) == n_devices
    r = 16 // n_devices
    want_bytes = 0
    for i, (b, dev) in enumerate(zip(blocks, mesh.devices, strict=True)):
        assert b.device == dev
        want_bytes += _assert_staged(b.staged, b.batch, model, tables[dev], dev)
        for got, a in ((b.wstart, wstart[i * r:(i + 1) * r]),
                       (b.wlen, batch.window_len[i * r:(i + 1) * r]),
                       (b.strand, batch.strand[i * r:(i + 1) * r])):
            ref = _blocking(a, dev)
            assert got.dtype == ref.dtype and torch.equal(got, ref)
            want_bytes += a.nbytes
    assert b.wstart.dtype == torch.int64
    assert after[0] - before[0] == want_bytes
    assert after[1] - before[1] == 0


def test_stage_batch_alone_stages_the_blocking_copies(world):
    model, genome = world["model"], world["genome"]
    dev = torch.device("cpu")
    subst = api._maybe_subst(genome, model, CFG, "auto", dev)
    batch = assemble_batch(world["records"][:8], model, CFG)
    before = _counts()
    staged = stage_batch(batch, model, CFG, "auto", device=dev, subst=subst)
    after = _counts()
    assert after[0] - before[0] == _assert_staged(staged, batch, model, subst, dev)
    assert after[1] - before[1] == 0
    # the blocking copy to the CPU is the array itself, as before
    assert staged["x"].data_ptr() == batch.x.__array_interface__["data"][0]
