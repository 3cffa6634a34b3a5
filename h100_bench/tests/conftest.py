"""The benchmark's own tests: run from the checkout's root with
``python -m pytest h100_bench/tests -q``. Cases marked ``cuda`` need a card
and skip without one."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CELL = "tiny.tinyreads"
# the limits the tiny cell is held to: those of the cell whose reads it
# shrinks
LIMITS_OF = "ecoli_k12_mg1655.snp_long"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
        "torch.cuda.is_available() is false")


def make_tiny_root(path: str) -> str:
    """A checkout-like directory holding one tiny cell: a 4 kb genome, reads
    of 60-300 bases (wide band above 2,000 samples, the slab rule above
    2,304), four batches of 8 reads, every read checked."""
    b = os.path.join(path, "h100_bench")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(b, d), exist_ok=True)
    with open(os.path.join(ROOT, "h100_bench", "configs", "lambda_phage.json")) as f:
        conf = json.load(f)
    conf.update(name="tiny")
    conf["genome"]["length"] = 4000
    conf["align"]["adaptive_band_threshold"] = 2000
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(ROOT, "h100_bench", "traffic", "snp_long.json")) as f:
        traffic = json.load(f)
    traffic.update(name="tinyreads", batch_reads=8, batches=4, check_reads_per_batch=8,
                   snp_rate=0.005, lengths={"kind": "lognormal", "median": 150,
                                            "sigma_ln": 0.5, "min": 60, "max": 300})
    with open(os.path.join(b, "traffic", "tinyreads.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(ROOT, "h100_bench", "limits", LIMITS_OF + ".json"),
                os.path.join(b, "limits", TINY_CELL + ".json"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="h100_bench/configs/tiny.json")]
    bench["workloads"] = [dict(name=TINY_CELL, config="tiny", traffic="tinyreads",
                               chips=1, why="tiny")]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny_checkout")))
