"""The port imports on a machine without a GPU and never reaches for JAX."""

import ast
import importlib
import os
import pkgutil

import torch

torch.set_num_threads(1)

import nadavca_tpu_torch

PKG_DIR = os.path.dirname(nadavca_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _python_sources():
    for root, _dirs, files in os.walk(PKG_DIR):
        if "_build" in root:
            continue
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)
    yield os.path.join(REPO, "chip_smoke.py")
    for fn in sorted(os.listdir(os.path.join(REPO, "scripts"))):
        if fn.startswith("torch_") and fn.endswith(".py"):
            yield os.path.join(REPO, "scripts", fn)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_import_and_exports():
    for name in ("AlignConfig", "DEFAULT_CONFIG", "Genome", "KmerModel",
                 "ReadAlignment", "SnpCall", "align_signal", "call_snps",
                 "default_model", "encode_bases", "decode_bases",
                 "reverse_complement", "kmer_ids"):
        assert hasattr(nadavca_tpu_torch, name), name
    # every module imports here, where there is no nvcc, no triton and no card
    for m in pkgutil.walk_packages(nadavca_tpu_torch.__path__,
                                   nadavca_tpu_torch.__name__ + "."):
        importlib.import_module(m.name)


def test_no_jax_and_nothing_of_the_jax_package():
    checked = set()
    for path in _python_sources():
        roots = _imported_roots(path)
        assert "jax" not in roots, f"{path} imports jax"
        assert "jaxlib" not in roots, f"{path} imports jaxlib"
        assert "nadavca_tpu" not in roots, f"{path} imports nadavca_tpu"
        checked.add(os.path.relpath(path, REPO))
    assert len(checked) >= 21
    for rel in ("nadavca_tpu_torch/ops/subst_tables.py",
                "nadavca_tpu_torch/ops/cuda_rescore.py",
                "nadavca_tpu_torch/ops/cuda_dp.py",
                "nadavca_tpu_torch/joint.py",
                "nadavca_tpu_torch/convert.py", "chip_smoke.py",
                "nadavca_tpu_torch/parallel/__init__.py",
                "nadavca_tpu_torch/parallel/sharded.py",
                "nadavca_tpu_torch/parallel/distributed.py",
                "nadavca_tpu_torch/ops/dp_spec.py",
                "nadavca_tpu_torch/ops/cpu_ref.py",
                "nadavca_tpu_torch/utils/parity.py",
                "nadavca_tpu_torch/utils/worlds.py",
                "scripts/torch_accuracy_sweep.py"):
        assert rel in checked, rel


def test_every_kernel_source_has_a_declared_entry_point():
    """Each ``csrc/*.cu`` exports what ``kernel_build._declare`` binds, so a
    new source cannot be left without its wrapper."""
    import re

    from nadavca_tpu_torch.utils import kernel_build

    exported = set()
    for src in kernel_build.sources():
        exported.update(re.findall(r"NADAVCA_EXPORT\s+[\w\s\*]+?\b(nadavca_\w+)\s*\(",
                                   open(src).read()))
    declared = set(re.findall(r"lib\.(nadavca_\w+)\.argtypes",
                              open(kernel_build.__file__).read()))
    # seven launchers (the path counts run inside the walk's, the band and
    # shear gathers inside the fills and the rescores), the port-only
    # scatter's and the error string, plus the fills' three explicit-layout
    # launchers and their layout table
    assert exported == declared and len(exported) == 13, (exported ^ declared)
    names = {os.path.basename(s) for s in kernel_build.sources()}
    # the folded kernels are no sources of their own
    assert names == {"backtrack.cu", "rescore.cu", "scatter.cu", "viterbi_fill.cu"}, names


def test_default_model_and_config_match_the_jax_package():
    import dataclasses

    import numpy as np

    import nadavca_tpu
    from nadavca_tpu_torch import convert

    a, b = nadavca_tpu.default_model(), nadavca_tpu_torch.default_model()
    assert a.k == b.k
    np.testing.assert_array_equal(a.level_mean, b.level_mean)
    np.testing.assert_array_equal(a.level_std, b.level_std)
    d = dataclasses.asdict(nadavca_tpu.AlignConfig())
    assert d == dataclasses.asdict(nadavca_tpu_torch.AlignConfig())
    assert convert.config_from_dict(d) == nadavca_tpu_torch.AlignConfig()


def test_config_yaml_round_trip(tmp_path):
    import nadavca_tpu

    p = str(tmp_path / "cfg.yaml")
    cfg = nadavca_tpu_torch.AlignConfig(snp_rescore="fixed", band_width=256)
    cfg.to_yaml(p)
    assert nadavca_tpu_torch.AlignConfig.from_yaml(p) == cfg
    j = nadavca_tpu.AlignConfig.from_yaml(p)
    assert j.snp_rescore == "fixed" and j.band_width == 256
