"""The port's single-core C++ core (``ops/cpu_ref``) against the JAX
package's and against the port's float64 oracle.

``nadavca_tpu_torch/csrc/banded_dp.cpp`` is a byte-for-byte copy of
``csrc/banded_dp.cpp``, so both bindings must return the same floats; the
oracle is held at ``tests/test_cpu_ref.py``'s tolerances. Tests that build
the library skip without g++.
"""

import os
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.ops import cpu_ref as jcpu_ref

from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.io.simulator import random_genome, simulate_read
from nadavca_tpu_torch.kmer_model import default_model
from nadavca_tpu_torch.ops import cpu_ref, dp_spec
from nadavca_tpu_torch.utils import kernel_build, native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = AlignConfig()
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


@pytest.fixture(scope="module")
def case():
    """``tests/test_cpu_ref.py``'s read: 400 bases, the band from the true
    path."""
    rng = np.random.default_rng(6)
    model = default_model()
    genome = random_genome(rng, length=1200)
    read = simulate_read(genome, "ref", model, rng, read_len=400, strand=1,
                         mean_dwell=8.0)
    mu, sigma = model.expected_signal(read.window_codes)
    lo = dp_spec.make_band(read.true_path.astype(np.float64), len(mu),
                           CFG.band_width).astype(np.int32)
    return model, read, mu, sigma, lo


def test_source_is_the_jax_packages_and_builds_with_gxx_only():
    """``banded_dp.cpp`` is the JAX package's source byte for byte, built by
    g++ (``native_build``), never by nvcc."""
    ours = os.path.join(native_build.CSRC_DIR, "banded_dp.cpp")
    with open(ours, "rb") as a, open(os.path.join(REPO, "csrc", "banded_dp.cpp"), "rb") as b:
        assert a.read() == b.read()
    assert ours not in kernel_build.sources()


@needs_gxx
@pytest.mark.parametrize("use_skip", [False, True], ids=["no_skip", "skip"])
def test_viterbi_equals_the_jax_binding_and_the_oracle(case, use_skip):
    model, read, mu, sigma, lo = case
    skip = dict(log_p_skip=-4.0, use_skip=True) if use_skip else {}
    args = (read.signal.astype(np.float32), mu, sigma, lo, CFG.band_width,
            CFG.log_p_stay, CFG.log_p_move)
    score, path = cpu_ref.banded_viterbi_cpu(*args, **skip)
    j_score, j_path = jcpu_ref.banded_viterbi_cpu(*args, **skip)
    assert score == j_score
    np.testing.assert_array_equal(path, j_path)
    assert path.dtype == np.int64
    assert os.path.dirname(cpu_ref.get_lib()._name) == native_build.BUILD_ROOT
    cfg = AlignConfig(**skip)
    s_score, s_path = dp_spec.banded_viterbi(
        read.signal, mu.astype(np.float64), sigma.astype(np.float64),
        lo.astype(np.int64), cfg)
    assert np.isclose(score, s_score, rtol=1e-4, atol=0.05)
    assert np.mean(path == s_path) > 0.999


@needs_gxx
def test_local_rescore_equals_the_jax_binding_and_the_oracle(case):
    model, read, _, _, _ = case
    args = (read.signal.astype(np.float32), read.window_codes.astype(np.int32),
            read.true_path.astype(np.int32), model.level_mean, model.level_std,
            model.k, CFG.log_p_stay, CFG.log_p_move, CFG.snp_local_window)
    ll = cpu_ref.base_loglik_local_cpu(*args)
    np.testing.assert_array_equal(ll, jcpu_ref.base_loglik_local_cpu(*args))
    want = dp_spec.base_substitution_loglik_local(
        read.window_codes, read.true_path, read.signal.astype(np.float64),
        model.level_mean.astype(np.float64), model.level_std.astype(np.float64),
        model.k, CFG, max_window=CFG.snp_local_window)
    np.testing.assert_allclose(ll, want, rtol=5e-3, atol=5e-2)
    np.testing.assert_array_equal(ll.argmax(1), want.argmax(1))


@needs_gxx
def test_mismatched_lengths_raise_before_the_library_is_called(case):
    model, read, mu, sigma, lo = case
    x = read.signal.astype(np.float32)
    with pytest.raises(ValueError, match="lo"):
        cpu_ref.banded_viterbi_cpu(x, mu, sigma, lo[:-1], 128, -0.1, -2.0)
    with pytest.raises(ValueError, match="path"):
        cpu_ref.base_loglik_local_cpu(x, read.window_codes, read.true_path[:-1],
                                      model.level_mean, model.level_std, model.k,
                                      -0.1, -2.0)
