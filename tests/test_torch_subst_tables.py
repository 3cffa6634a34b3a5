"""The port's genome substitution tables vs the JAX package's.

The same genome (two contigs, one with a run of N) and the same pore model go
through both ``build_subst_tables``; the port's ``(3, k*4, rows_p)`` layout is
the JAX package's ``(3, k*4, rows_p/128, 1, 128)`` with the last three axes
joined, so the comparison is bit for bit.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import nadavca_tpu
from nadavca_tpu.ops import subst_tables as jtables

import nadavca_tpu_torch
from nadavca_tpu_torch import convert
from nadavca_tpu_torch.ops import subst_tables as ttables


def _build_both(k):
    rng = np.random.default_rng(11)
    a = "".join("ACGT"[c] for c in rng.integers(0, 4, 700))
    b = "".join("ACGT"[c] for c in rng.integers(0, 4, 400))
    a = a[:300] + "N" * 9 + a[309:]
    seqs = {"chrA": a, "chrB": b}
    jg = nadavca_tpu.Genome.from_dict(seqs)
    tg = nadavca_tpu_torch.Genome.from_dict(seqs)
    jm, tm = nadavca_tpu.default_model(k), nadavca_tpu_torch.default_model(k)
    return (jtables.build_subst_tables(jg, jm, pad=1024),
            ttables.build_subst_tables(tg, tm, pad=1024, device="cpu"), tg)


@pytest.fixture(scope="module")
def both():
    return _build_both(6)


def test_tables_equal_bit_for_bit(both):
    jt, tt, _ = both
    tab4 = np.asarray(jt.tab4)
    assert tt.tab.shape == (3, 24, tab4.shape[2] * 128) and tt.tab.is_contiguous()
    np.testing.assert_array_equal(tt.tab.numpy(), tab4.reshape(3, 24, -1))
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    assert tt.contig_offsets == jt.contig_offsets
    assert (tt.g_total, tt.k) == (jt.g_total, jt.k)
    # the N run and the contig gap invalidate their neighbourhoods
    va = tt.valid.numpy()
    assert va[100] and not va[300:309].any() and not va[700:716].any()
    # fills of the padded tail
    rows = 2 * tt.g_total + 1024
    t = tt.tab.numpy()
    assert (t[0, :, rows:] == -1e30).all() and (t[1, :, rows:] == 0).all()
    assert (t[2, :, rows:] == 1).all() and not va[rows:].any()


def test_tables_equal_bit_for_bit_at_k9():
    """The 9-mer model (R10.4.1's k): 36 rows a column, the same numbers."""
    jt, tt, _ = _build_both(9)
    tab4 = np.asarray(jt.tab4)
    assert tt.tab.shape == (3, 36, tab4.shape[2] * 128) and jt.k == tt.k == 9
    np.testing.assert_array_equal(tt.tab.numpy(), tab4.reshape(3, 36, -1))
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    assert (tt.contig_offsets, tt.g_total) == (jt.contig_offsets, jt.g_total)
    # the model's level vectors come with the tables
    m = nadavca_tpu_torch.default_model(9)
    assert torch.equal(tt.level_mean, torch.from_numpy(m.level_mean))
    assert torch.equal(tt.level_std, torch.from_numpy(m.level_std))


def test_handed_over_tables_are_the_same_object_state(both):
    jt, tt, _ = both
    got = convert.subst_tables_from_numpy(
        np.asarray(jt.tab4), np.asarray(jt.valid), jt.contig_offsets,
        jt.g_total, jt.k, device="cpu")
    assert torch.equal(got.tab, tt.tab) and torch.equal(got.valid, tt.valid)
    assert got.contig_offsets == tt.contig_offsets
    assert (got.g_total, got.k, got.rows_p) == (tt.g_total, tt.k, tt.rows_p)
    with pytest.raises(ValueError):
        convert.subst_tables_from_numpy(
            np.asarray(jt.tab4)[:, :20], np.asarray(jt.valid),
            jt.contig_offsets, jt.g_total, jt.k, device="cpu")


@pytest.mark.parametrize("strand", [1, -1])
def test_window_offsets_equal(both, strand):
    jt, tt, _ = both
    rng = np.random.default_rng(5)
    names = ["chrA", "chrB", "chrA", "chrB", ""]
    wstart = rng.integers(0, 200, 5).astype(np.int32)
    wlen = rng.integers(50, 200, 5).astype(np.int32)
    sd = np.full(5, strand, np.int32)
    want = jt.window_offsets(names, wstart, wlen, sd, padded_len=256)
    got = tt.window_offsets(names, wstart, wlen, sd, padded_len=256)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32
    # a reverse window is a forward slice of the reverse-complement block: the
    # table's mu at slot k-1 (the k-mer that STARTS at the base) with the
    # reference base kept is that k-mer's level
    if strand < 0:
        tg = both[2]
        model = nadavca_tpu_torch.default_model()
        win = tg.window("chrB", int(wstart[1]), int(wstart[1] + wlen[1]), -1)
        ids = nadavca_tpu_torch.kmer_ids(win, model.k)
        k = model.k
        mu = tt.tab[1].numpy()
        for i in range(k, int(wlen[1]) - k):
            col = got[1] + i
            assert mu[(k - 1) * 4 + int(win[i]), col] == model.level_mean[ids[i]]


def test_overrun_raises_on_both_with_the_same_message(both):
    jt, tt, _ = both
    names = ["chrB"]
    args = (np.asarray([390], np.int32), np.asarray([10], np.int32),
            np.asarray([-1], np.int32))
    with pytest.raises(ValueError) as je:
        jt.window_offsets(names, *args, padded_len=4096)
    with pytest.raises(ValueError) as te:
        tt.window_offsets(names, *args, padded_len=4096)
    assert str(te.value) == str(je.value)
    assert "rebuild with build_subst_tables(pad>=" in str(te.value)
    # without padded_len nothing is checked, as in the JAX package
    np.testing.assert_array_equal(tt.window_offsets(names, *args),
                                  jt.window_offsets(names, *args))
