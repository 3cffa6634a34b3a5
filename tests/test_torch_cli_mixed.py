"""The port's command line on reads of mixed length: the adaptive band.

``simulate --read-length 300,1800`` cycles short reads (~2.9k samples) and
long ones (~18k, above ``adaptive_band_threshold`` = 16384), so the long
bucket runs at ``band_width_long`` = 256 slots. Under ``--backend scan`` the
port's ``snp`` VCF body and ``align`` files are byte-identical to the JAX
CLI's, and the CLI's grouping helpers agree with the JAX package's.
"""

import dataclasses
import json
import os

import pytest
import torch

torch.set_num_threads(1)

from nadavca_tpu import cli as jcli
from nadavca_tpu.config import AlignConfig as JaxConfig
from nadavca_tpu.io import fast5 as jfast5

from nadavca_tpu_torch import cli
from nadavca_tpu_torch.config import AlignConfig
from nadavca_tpu_torch.genome import Genome
from nadavca_tpu_torch.io import fast5 as fast5mod
from nadavca_tpu_torch.kmer_model import default_model
from nadavca_tpu_torch.pipeline import make_preprocessor

pytestmark = pytest.mark.skipif(not jfast5.HAVE_H5PY, reason="h5py unavailable")

SCAN = ["--backend", "scan", "--device", "cpu"]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mixed"))
    assert jcli.main(["simulate", "-o", d, "--reads", "8", "--files", "2",
                      "--read-length", "300,1800", "--genome-length", "4000",
                      "--snps", "1", "--seed", "3"]) == 0
    return os.path.join(d, "reference.fasta"), d


def _metrics(err: str) -> dict:
    line = [l for l in err.splitlines() if l.startswith("[metrics] ")][-1]
    return json.loads(line[len("[metrics] "):])


def test_snp_matches_the_jax_cli_with_the_wide_band(mixed, tmp_path, capsys):
    ref, d = mixed
    ours, theirs = str(tmp_path / "port.vcf"), str(tmp_path / "jax.vcf")
    argv = ["snp", ref, d, "--batch-reads", "16", "--min-coverage", "2"]
    capsys.readouterr()
    assert cli.main(argv + ["-o", ours, *SCAN]) == 0
    m = _metrics(capsys.readouterr().err)
    # the four long reads are one batch at 256 slots, the short ones two
    # batches (two signal buckets) at 128
    assert m["counters"]["batches_band_256"] == 1
    assert m["counters"]["batches_band_128"] == 2
    assert jcli.main(argv + ["-o", theirs, "--backend", "scan"]) == 0
    body = [l for l in open(ours) if not l.startswith("##")]
    assert body == [l for l in open(theirs) if not l.startswith("##")]
    assert len(body) >= 2


def test_align_matches_the_jax_cli_with_the_wide_band(mixed, tmp_path):
    ref, d = mixed
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["align", ref, d, "--batch-reads", "16"]
    assert cli.main(argv + ["-o", ours, *SCAN]) == 0
    assert jcli.main(argv + ["-o", theirs, "--backend", "scan"]) == 0
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and len(names) == 8
    for n in names:
        assert open(os.path.join(ours, n)).read() == \
            open(os.path.join(theirs, n)).read(), n


@pytest.mark.parametrize("batch_reads", [1, 3, 16])
def test_grouping_helpers_match_the_jax_ones(mixed, batch_reads):
    """``_stream_groups`` bins and ``_cfg_for_group``'s band, against the JAX
    package's on the same records."""
    ref, d = mixed
    genome = Genome.from_fasta(ref)
    cfg, jcfg = AlignConfig(), JaxConfig()
    work = make_preprocessor(genome, cfg, default_model(), mode="native")
    records = [r for r in map(work, fast5mod.iter_fast5_dir(d)) if r is not None]
    assert len(records) == 8
    ours = list(cli._stream_groups(records, batch_reads, cfg))
    theirs = list(jcli._stream_groups(records, batch_reads, jcfg))
    assert [[r.read_id for r in g] for g in ours] == \
        [[r.read_id for r in g] for g in theirs]
    bands = [cli._cfg_for_group(cfg, g).band_width for g in ours]
    assert bands == [jcli._cfg_for_group(jcfg, g).band_width for g in theirs]
    assert set(bands) == {128, 256}
    for g in ours:
        got = dataclasses.asdict(cli._cfg_for_group(cfg, g))
        assert got == dataclasses.asdict(jcli._cfg_for_group(jcfg, g))
