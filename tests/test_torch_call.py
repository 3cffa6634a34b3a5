"""The port's SNP-calling layer vs ``nadavca_tpu.call``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import call as jcall
from nadavca_tpu.config import AlignConfig as JaxConfig

from nadavca_tpu_torch import call as tcall
from nadavca_tpu_torch import convert
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.ops import cuda_scatter

import torch_scatter_cases as SC

G, R, L = 300, 6, 64


def _inputs():
    rng = np.random.default_rng(5)
    base_ll = (rng.normal(0, 6, size=(R, L, 4))).astype(np.float32)
    base_ll[:, :, 0] = 0.0
    base_ll[0, 3] = [0.0, 40.0, -40.0, 1.0]            # beyond the clip
    base_ll[1, 5] = [0.0, 2.0, 2.0, -1.0]              # a tie for the best base
    # forward and reverse reads, one window hanging over each genome end
    window_start = np.array([10, 50, -20, 280, 100, 120], np.int32)
    window_len = np.array([64, 40, 64, 64, 0, 33], np.int32)
    strand = np.array([1, -1, 1, -1, 1, -1], np.int32)
    return base_ll, window_start, window_len, strand


def test_scatter_values_match_jax():
    base_ll, ws, wl, st = _inputs()
    jout = jcall.scatter_values(jnp.asarray(base_ll), jnp.asarray(ws),
                                jnp.asarray(wl), jnp.asarray(st), G, JaxConfig())
    tout = tcall.scatter_values(torch.from_numpy(base_ll), torch.from_numpy(ws),
                                torch.from_numpy(wl), torch.from_numpy(st), G,
                                AlignConfig())
    # index arithmetic, a clip and compares: exact
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (tout[0] == G).any() and (tout[0] < G).any()


def test_accumulate_batch_matches_jax():
    base_ll, ws, wl, st = _inputs()
    rng = np.random.default_rng(6)
    acc0 = rng.normal(size=(G, 4)).astype(np.float32)
    cov0 = rng.integers(0, 5, size=G).astype(np.int32)
    votes0 = rng.integers(0, 3, size=(G, 4)).astype(np.int32)
    jacc, jcov, jvotes = jcall.accumulate_batch(
        jnp.asarray(acc0), jnp.asarray(cov0), jnp.asarray(base_ll),
        jnp.asarray(ws), jnp.asarray(wl), jnp.asarray(st),
        votes=jnp.asarray(votes0), cfg=JaxConfig())
    acc, cov, votes = convert.accumulators_from_numpy(acc0, cov0, votes0, "cpu")
    tacc, tcov, tvotes = tcall.accumulate_batch(
        acc, cov, torch.from_numpy(base_ll), torch.from_numpy(ws),
        torch.from_numpy(wl), torch.from_numpy(st), votes=votes,
        cfg=AlignConfig())
    # integer sums are exact; the float sums add the same few values in
    # another order
    np.testing.assert_array_equal(tcov.numpy(), np.asarray(jcov))
    np.testing.assert_array_equal(tvotes.numpy(), np.asarray(jvotes))
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), atol=1e-4)
    assert tuple(tacc.shape) == (G, 4) and tuple(tcov.shape) == (G,)
    # the arguments are left as they were
    np.testing.assert_array_equal(acc.numpy(), acc0)
    # without votes: two results
    out = tcall.accumulate_batch(
        acc, cov, torch.from_numpy(base_ll), torch.from_numpy(ws),
        torch.from_numpy(wl), torch.from_numpy(st), cfg=AlignConfig())
    assert len(out) == 2
    np.testing.assert_array_equal(out[1].numpy(), tcov.numpy())


def test_make_accumulators_and_posteriors():
    acc, cov, votes = tcall.make_accumulators(17, with_votes=True, device="cpu")
    assert acc.shape == (17, 4) and acc.dtype == torch.float32
    assert cov.shape == (17,) and cov.dtype == torch.int32
    assert votes.shape == (17, 4) and votes.dtype == torch.int32
    assert len(tcall.make_accumulators(17, device="cpu")) == 2
    a = np.random.default_rng(1).normal(0, 5, size=(50, 4)).astype(np.float32)
    # one softmax in float32 on each side
    np.testing.assert_allclose(tcall.posteriors(torch.from_numpy(a)).numpy(),
                               np.asarray(jcall.posteriors(jnp.asarray(a))),
                               atol=1e-6)


def test_call_snps_on_handed_over_accumulators(tmp_path):
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 4, size=G).astype(np.int8)
    acc = rng.normal(0, 1, size=(G, 4)).astype(np.float32)
    cov = rng.integers(0, 8, size=G).astype(np.int32)
    votes = rng.integers(0, 6, size=(G, 4)).astype(np.int32)
    for g in (20, 23, 90, 150, 151, 220):          # strong alts, two clusters
        alt = (int(ref[g]) + 1) % 4
        acc[g, alt] += 30.0 + g * 0.01
        votes[g, alt] = 5
        cov[g] = 6
    jc = jcall.call_snps(acc, cov, ref, "ref", JaxConfig(), min_coverage=2,
                         votes=votes)
    tc = tcall.call_snps(acc, cov, ref, "ref", AlignConfig(), min_coverage=2,
                         votes=votes)
    assert len(jc) >= 3
    key = lambda c: (c.contig, c.position, c.ref_base, c.alt_base, c.coverage)
    assert [key(c) for c in tc] == [key(c) for c in jc]
    np.testing.assert_allclose([c.probability for c in tc],
                               [c.probability for c in jc], atol=1e-5)
    # the writers: same body, the source line names the package
    pj, pt = str(tmp_path / "j.vcf"), str(tmp_path / "t.vcf")
    jcall.write_vcf(pj, jc)
    tcall.write_vcf(pt, tc)
    lj, lt = open(pj).read().splitlines(), open(pt).read().splitlines()
    assert lt[1] == "##source=nadavca_tpu_torch"
    assert [l for l in lt if not l.startswith("##source")] == \
        [l for l in lj if not l.startswith("##source")]
    s, e = np.array([0, -1, 3]), np.array([3, -1, 9])
    jcall.write_alignment(pj, "r", "ref", -1, 5, 8, s, e)
    tcall.write_alignment(pt, "r", "ref", -1, 5, 8, s, e)
    assert open(pj).read() == open(pt).read()


# ----------------------------------------------- the scatter kernel's wrapper
@pytest.mark.parametrize("case", SC.CASES)
def test_index_add_windows_on_the_cpu(case):
    """On CPU tensors the wrapper runs its plain version: the NumPy statement
    of the scatter (cov and votes exact, acc to float32 rounding), the body
    the port had before the kernel to the bit, and no launch."""
    base_ll, ws, wl, st, g, with_votes = SC.make_case(case)
    acc0, cov0, votes0 = SC.start_accumulators(g)
    if not with_votes:
        votes0 = None
    t = lambda a: None if a is None else torch.from_numpy(a.copy())
    acc, cov, votes = t(acc0), t(cov0), t(votes0)
    args = (torch.from_numpy(base_ll), torch.from_numpy(ws), torch.from_numpy(wl),
            torch.from_numpy(st))
    before = cuda_scatter.index_add_windows.launches
    cuda_scatter.index_add_windows(acc, cov, votes, *args, AlignConfig())
    assert cuda_scatter.index_add_windows.launches == before, "no kernel on the CPU"
    w_acc, w_cov, w_votes = SC.numpy_scatter(acc0, cov0, votes0, base_ll, ws, wl, st)
    np.testing.assert_array_equal(cov.numpy(), w_cov)
    assert (votes is None) == (w_votes is None)
    if votes is not None:
        np.testing.assert_array_equal(votes.numpy(), w_votes)
    np.testing.assert_allclose(acc.numpy(), w_acc, rtol=0,
                               atol=1e-6 * np.nanmax(np.abs(w_acc)), equal_nan=True)
    old = SC.padded_scatter(t(acc0), t(cov0), t(votes0), *args)
    for got, want in zip((acc, cov, votes), old):
        assert (got is None and want is None) or torch.equal(got.nan_to_num(), want.nan_to_num())
    if case == "nan_rows":
        assert np.isnan(w_acc).any()


def _scatter_args(**swap):
    base_ll, ws, wl, st, g, _ = SC.make_case("forward")
    acc, cov, votes = (torch.from_numpy(a) for a in SC.start_accumulators(g))
    args = dict(acc=acc, cov=cov, votes=votes, base_ll=torch.from_numpy(base_ll),
                window_start=torch.from_numpy(ws), window_len=torch.from_numpy(wl),
                strand=torch.from_numpy(st))
    return {**args, **{k: f(args[k]) for k, f in swap.items()}}


@pytest.mark.parametrize("swap, err", [
    (dict(acc=lambda a: a.double()), TypeError),
    (dict(cov=lambda a: a.long()), TypeError),
    (dict(votes=lambda a: a[:, :3].contiguous()), ValueError),
    (dict(base_ll=lambda a: a.half()), TypeError),
    (dict(base_ll=lambda a: a[:, :, :3]), ValueError),
    (dict(window_len=lambda a: a.float()), TypeError),
    (dict(strand=lambda a: a[:-1]), ValueError),
    (dict(acc=lambda a: a.t().contiguous().t()), ValueError),
    (dict(base_ll=lambda a: a.to("meta")), ValueError),
], ids=["acc_f64", "cov_i64", "votes_shape", "ll_f16", "ll_shape", "wlen_float",
        "strand_rows", "acc_strided", "ll_device"])
def test_index_add_windows_rejects_bad_arguments(swap, err):
    """A wrong dtype, shape, layout or device raises before anything is added
    or launched."""
    args = _scatter_args(**swap)
    acc_before = args["acc"].clone()
    before = cuda_scatter.index_add_windows.launches
    with pytest.raises(err):
        cuda_scatter.index_add_windows(**args, cfg=AlignConfig())
    assert cuda_scatter.index_add_windows.launches == before
    assert torch.equal(args["acc"], acc_before)
