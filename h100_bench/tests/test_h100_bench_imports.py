"""Loading the harness and the reference brings in no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``nadavca_tpu`` (compared as whole
names: the port's ``nadavca_tpu_torch`` begins with the JAX package's name);
the reference and the generator load nothing of the port either."""

import json
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(imports: str):
    p = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, imports=imports)],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_either_package():
    mods = _top_level("import h100_bench.reference, h100_bench.gen, h100_bench.control")
    assert not mods & {"jax", "jaxlib", "flax", "nadavca_tpu", "nadavca_tpu_torch"}


def test_the_harness_and_the_port_load_no_jax():
    mods = _top_level(
        "import h100_bench.cell, h100_bench.run, h100_bench.trace\n"
        "import nadavca_tpu_torch.cli, nadavca_tpu_torch.parallel.sharded")
    assert "nadavca_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "nadavca_tpu"}


def test_the_harness_names_what_it_finds():
    from h100_bench import cell
    sys.modules.setdefault("nadavca_tpu_fake_sibling", object())
    assert "nadavca_tpu_fake_sibling" not in cell.forbidden_modules()
    assert all(m in cell.FORBIDDEN for m in cell.forbidden_modules())
