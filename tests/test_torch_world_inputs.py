"""World 6 of the JAX package's own tests through the port: the model and
fast5 inputs of real data (``tests/test_real_data_hardening.py``).

The same files go through both packages: an ONT-shaped 4096-entry pore model
on the picoamp scale, the same with CRLF line ends read with
``normalize="never"``, a table already on the normalised scale, and an
incomplete table. The port's ``KmerModel.load_tsv`` gives the JAX package's
arrays exactly and raises as it does; the port's ``io/fast5`` names vbz when
a signal needs ONT's vbz filter.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu.kmer_model import KmerModel as JModel

from nadavca_tpu_torch.io import fast5 as f5
from nadavca_tpu_torch.kmer_model import KmerModel, default_model

from test_real_data_hardening import _write_ont_model

h5py = pytest.importorskip("h5py")


def _pa_scale(path):
    return _write_ont_model(path, scale_pa=True, extra_cols=True), {}


def _crlf(path):
    return _write_ont_model(path, scale_pa=True, crlf=True, extra_cols=False), \
        {"normalize": "never"}


def _normalised(path):
    default_model(6).save_tsv(path)
    return None, {}


@pytest.mark.parametrize("write", [_pa_scale, _crlf, _normalised],
                         ids=["pa_scale", "crlf_never", "normalised"])
def test_load_tsv_gives_the_jax_arrays(tmp_path, write):
    p = str(tmp_path / "model.tsv")
    written, kw = write(p)
    m, jm = KmerModel.load_tsv(p, **kw), JModel.load_tsv(p, **kw)
    assert m.k == jm.k == 6
    np.testing.assert_array_equal(m.level_mean, jm.level_mean)
    np.testing.assert_array_equal(m.level_std, jm.level_std)
    assert m.level_mean.dtype == jm.level_mean.dtype
    if write is _pa_scale:          # the JAX test's own asserts
        mu_pa, sg_pa = written
        assert abs(float(m.level_mean.mean())) < 1e-3
        assert abs(float(m.level_mean.std()) - 1.0) < 1e-3
        np.testing.assert_allclose(m.level_std, sg_pa / mu_pa.std(), rtol=1e-4)
        assert (np.argsort(m.level_mean) == np.argsort(mu_pa)).all()
    elif write is _crlf:
        np.testing.assert_allclose(m.level_mean, written[0].astype(np.float32), rtol=1e-5)
    else:
        base = default_model(6)
        np.testing.assert_allclose(m.level_mean, base.level_mean, atol=2e-6)
        np.testing.assert_allclose(m.level_std, base.level_std, atol=2e-6)


def test_incomplete_table_raises_as_the_jax_loader(tmp_path):
    p = str(tmp_path / "partial.tsv")
    with open(p, "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\n")
        f.write("AAAAAA\t90.0\t2.0\n")
    for loader in (KmerModel.load_tsv, JModel.load_tsv):
        with pytest.raises(ValueError, match="covers 1/4096"):
            loader(p)


def test_vbz_fast5_names_vbz(tmp_path):
    """A signal stored under ONT's vbz filter (not installed here) fails with
    a message that names vbz, not a bare HDF5 error."""
    path = str(tmp_path / "vbz.fast5")
    with h5py.File(path, "w") as f:
        g = f.create_group("read_abc")
        raw = g.create_group("Raw")
        try:
            dset = raw.create_dataset(
                "Signal", shape=(100,), dtype=np.int16, compression=f5.VBZ_FILTER_ID,
                allow_unknown_filter=True, chunks=(100,))
            dset.id.write_direct_chunk((0,), b"\x01\x02\x03\x04" * 10)
        except (ValueError, TypeError) as e:    # h5py too old for the flag
            pytest.skip(f"cannot fabricate unknown-filter dataset: {e}")
        ch = g.create_group("channel_id")
        ch.attrs["digitisation"] = 8192.0
        ch.attrs["offset"] = 0.0
        ch.attrs["range"] = 1400.0
        ch.attrs["sampling_rate"] = 4000.0
    with pytest.raises(RuntimeError, match="vbz"):
        f5.read_fast5(path)
