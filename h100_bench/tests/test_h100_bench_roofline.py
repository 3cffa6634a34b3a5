"""The roofline counts of each kernel's metric, against a hand count at a
tiny shape."""

import types

import numpy as np

from h100_bench import roofline, spec


def _pool_batch(R=2, T=256, L=256, k=6, band=128, t_len=(200, 256)):
    batch = types.SimpleNamespace(
        x=np.zeros((R, T), np.float32), codes=np.zeros((R, L), np.int32),
        mu=np.zeros((R, L - k + 1), np.float32), t_len=np.array(t_len, np.int32),
        n_reads=R)
    return types.SimpleNamespace(
        batch=batch, R=R, T=T, L=L, N=L - k + 1, band=band, members=[0, 1],
        cfg=types.SimpleNamespace(signal_chunk=128, band_width=band))


def test_fill_bound_by_hand():
    pb = _pool_batch()
    mod = spec.reader("fill_roofline_pct").__globals__
    # 8 ops a cell: (200 + 256) samples x 128 slots
    ops = 8 * 456 * 128
    nbytes = (2 * 256 * 4 + 2 * 2 * 251 * 4 + 2 * 2 * 2 * 4 + 2 * 2 * 4
              + 8 * 2 * 128 * 4 + 2 * 128 * 4 + 2 * 4)
    assert mod["batch_bound_s"](pb) == max(ops / 67e12, nbytes / 3.35e12)
    assert ops / 67e12 > nbytes / 3.35e12


def test_walk_bound_by_hand():
    pb = _pool_batch()
    mod = spec.reader("walk_roofline_pct").__globals__
    nbytes = 2 * 8 * 4 + 2 * 2 * 2 * 4 + 2 * 4 + 2 * 256 * 4
    assert mod["batch_bound_s"](pb) == max(4 * 2 * 256 / 67e12, nbytes / 3.35e12)


def test_rescore_bound_by_hand():
    """Two forward reads of 30 bases, 10 samples a k-mer position: 25
    positions each, kept where all 6 k-mers lie on the path (positions 5..24
    of 0..29), each with 60 samples."""
    import h100_bench.gen as gen
    pb = _pool_batch(t_len=(250, 250))
    k = 6
    inputs = types.SimpleNamespace(
        window=lambda m: np.zeros(30, np.int8),
        path=[np.repeat(np.arange(25), 10)] * 2,
        start=np.array([0, 100]), bases=np.array([30, 30]), strand=np.array([1, 1]))
    mod = spec.reader("rescore_roofline_pct").__globals__
    w_sum = 2 * 20 * 60
    n_cols = 256 + 100
    lanes = 256
    nbytes = (2 * 256 * 4 + 2 * lanes * 4 + 2 * 2 * 4 + 2 * 256 * 4 + 2 * 4
              + n_cols * (3 * 4 * k * 4 + 1) + 2 * 256 * 4 * 4)
    got = mod["batch_bound_s"](pb, inputs, {"k": k, "snp_local_window": 192})
    assert got == max(8 * 4 * k * w_sum / 67e12, nbytes / 3.35e12)
    assert gen.kmer_ids(np.zeros(30, np.int8), k).shape == (25,)


def test_share_is_none_without_device_time():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 4.0) == 25.0
