"""The port's native host prep (``prep_native`` + ``csrc/prep.cpp``).

The C++ source is the JAX package's, byte for byte, so the port's
``NativePrep`` must give the JAX package's records bit for bit. Against the
port's own Python prep it is held to ``tests/test_prep_native.py``'s
tolerances: anchors, paths and windows exact, the calibrated signal to float
tolerance (the double-precision fit sums in another order).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import prep_native as jprep_native
from nadavca_tpu.config import AlignConfig as JaxConfig
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model as jax_default_model

from nadavca_tpu_torch import pipeline, prep_native
from nadavca_tpu_torch.anchor import SeedIndex
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.genome import Contig, Genome
from nadavca_tpu_torch.io import fast5 as fast5mod
from nadavca_tpu_torch.io.fast5 import RawRead
from nadavca_tpu_torch.kmer_model import default_model
from nadavca_tpu_torch.utils import kernel_build, native_build

CFG = AlignConfig()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world():
    """``tests/test_prep_native.py``'s world: 12 reads of 400 bases, both
    strands, on a 20 kb genome, as raw picoamp-scale signal."""
    rng = np.random.default_rng(11)
    jgenome = random_genome(rng, length=20000)
    reads = [
        simulate_read(jgenome, "ref", jax_default_model(), rng, read_len=400,
                      start=int(rng.integers(0, 19000)),
                      strand=1 if i % 2 else -1, read_id=f"r{i}")
        for i in range(12)
    ]
    genome = Genome([Contig(c.name, c.codes.copy()) for c in jgenome])
    raws = [RawRead(read_id=rd.read_id,
                    signal_pa=(rd.signal * 23.0 + 90.0).astype(np.float32),
                    basecall=rd.basecall, move_index=rd.move_index)
            for rd in reads]
    return jgenome, genome, raws


def _native_records(genome, raws, model):
    native = prep_native.NativePrep(genome)
    return [native.prep_read(r.signal_pa, r.basecall, r.move_index, CFG,
                             model=model, read_id=r.read_id) for r in raws]


def _assert_records_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.read_id, a.anchor.contig, a.anchor.strand, a.anchor.ref_start,
            a.anchor.ref_end, a.anchor.score) == (
        b.read_id, b.anchor.contig, b.anchor.strand, b.anchor.ref_start,
        b.anchor.ref_end, b.anchor.score)
    for name in ("signal", "anchor_path", "window_codes", "mu", "sigma"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert np.array_equal(a.anchor.base_to_window, b.anchor.base_to_window)


@pytest.mark.parametrize("with_model", [True, False], ids=["model", "no_model"])
def test_native_prep_matches_the_jax_packages_bit_for_bit(world, with_model):
    jgenome, genome, raws = world
    jnative = jprep_native.NativePrep(jgenome)
    jcfg = JaxConfig()
    got = _native_records(genome, raws, default_model() if with_model else None)
    n_ok = 0
    for raw, rec in zip(raws, got):
        want = jnative.prep_read(raw.signal_pa, raw.basecall, raw.move_index, jcfg,
                                 model=jax_default_model() if with_model else None,
                                 read_id=raw.read_id)
        _assert_records_equal(rec, want)
        n_ok += rec is not None
    assert n_ok >= 10, n_ok


def test_native_prep_matches_the_python_prep(world):
    _, genome, raws = world
    model = default_model()
    index = SeedIndex(genome)
    n_ok = 0
    for raw, nt in zip(raws, _native_records(genome, raws, model)):
        sig = fast5mod.normalize_signal(raw.signal_pa, CFG.normalization)
        py = pipeline.preprocess_read(sig, raw.basecall, raw.move_index, index,
                                      genome, raw.read_id, model=model)
        assert (py is None) == (nt is None), raw.read_id
        if py is None:
            continue
        n_ok += 1
        assert (nt.anchor.contig, nt.anchor.strand, nt.anchor.ref_start,
                nt.anchor.ref_end, nt.anchor.score) == (
            py.anchor.contig, py.anchor.strand, py.anchor.ref_start,
            py.anchor.ref_end, py.anchor.score)
        np.testing.assert_array_equal(nt.window_codes, py.window_codes)
        np.testing.assert_array_equal(nt.anchor_path, py.anchor_path)
        np.testing.assert_array_equal(nt.anchor.base_to_window,
                                      py.anchor.base_to_window)
        np.testing.assert_array_equal(nt.mu, py.mu)
        np.testing.assert_array_equal(nt.sigma, py.sigma)
        np.testing.assert_allclose(nt.signal, py.signal, rtol=1e-5, atol=2e-5)
    assert n_ok >= 10, n_ok


def test_native_prep_without_a_model_skips_the_calibration(world):
    _, genome, raws = world
    raw = raws[0]
    nt = _native_records(genome, [raw], None)[0]
    sig = fast5mod.normalize_signal(raw.signal_pa, CFG.normalization)
    py = pipeline.preprocess_read(sig, raw.basecall, raw.move_index,
                                  SeedIndex(genome), genome, raw.read_id, model=None)
    assert nt.mu is None and nt.sigma is None
    np.testing.assert_allclose(nt.signal, py.signal, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(nt.anchor_path, py.anchor_path)


def test_native_prep_refuses_a_garbage_read(world):
    """A read with no genome support gives None, as does one without a
    basecall through the preprocessor."""
    _, genome, _ = world
    rng = np.random.default_rng(0)
    bc = "".join("ACGT"[i] for i in rng.integers(0, 4, size=300))
    raw = rng.normal(90.0, 10.0, size=3000).astype(np.float32)
    mv = np.sort(rng.integers(0, 3000, size=300)).astype(np.int64)
    native = prep_native.NativePrep(genome)
    assert native.prep_read(raw, bc, mv, CFG, model=default_model()) is None
    work = pipeline.make_preprocessor(genome, CFG, default_model(), mode="native")
    assert work(RawRead(read_id="x", signal_pa=raw, basecall=None,
                        move_index=None)) is None


def test_preprocessor_modes(world, monkeypatch):
    """"native" and "auto" run the native engine here (g++ is present),
    "python" the Python path; unknown modes raise. Where the engine does not
    build, "auto" falls back to Python and "native" raises."""
    _, genome, raws = world
    model = default_model()
    want = _native_records(genome, raws, model)
    for mode in ("native", "auto"):
        work = pipeline.make_preprocessor(genome, CFG, model, mode=mode)
        assert work.__name__ == "work_native"
        for rec, w in zip(map(work, raws), want):
            _assert_records_equal(rec, w)
    assert pipeline.make_preprocessor(genome, CFG, model,
                                      mode="python").__name__ == "work_python"
    with pytest.raises(ValueError):
        pipeline.make_preprocessor(genome, CFG, model, mode="fast")

    def no_toolchain():
        raise RuntimeError("g++ could not build prep.cpp")

    monkeypatch.setattr(prep_native, "get_lib", no_toolchain)
    assert pipeline.make_preprocessor(genome, CFG, model,
                                      mode="auto").__name__ == "work_python"
    with pytest.raises(RuntimeError):
        pipeline.make_preprocessor(genome, CFG, model, mode="native")


def test_native_prep_in_threads_gives_the_sequential_records(world):
    """The engine releases the GIL and keeps no per-call state in the index:
    eight threads over the reads, many times over, give the same records."""
    _, genome, raws = world
    model = default_model()
    work = pipeline.make_preprocessor(genome, CFG, model, mode="native")
    want = [work(r) for r in raws]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(work, raws * 6))
    for i, rec in enumerate(got):
        _assert_records_equal(rec, want[i % len(raws)])


def test_prep_source_is_the_jax_packages_and_no_kernel_source():
    """``prep.cpp`` is a copy of the JAX package's, built by g++: it is none
    of the four ``.cu`` sources nvcc compiles, and the kernels' build hash
    does not read it."""
    ours = os.path.join(native_build.CSRC_DIR, "prep.cpp")
    with open(ours, "rb") as a, open(os.path.join(REPO, "csrc", "prep.cpp"), "rb") as b:
        assert a.read() == b.read()
    names = {os.path.basename(s) for s in kernel_build.sources()}
    assert names == {"backtrack.cu", "rescore.cu", "scatter.cu", "viterbi_fill.cu"}, names
    assert os.path.exists(prep_native.get_lib()._name)
    assert os.path.dirname(prep_native.get_lib()._name) == native_build.BUILD_ROOT

