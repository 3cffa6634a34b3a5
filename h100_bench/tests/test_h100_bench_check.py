"""The check that decides ``correct``, driven at a tiny size on the CPU (the
program's kernels run their plain versions there): a sound run passes; the
control (the reference in bfloat16 in the program's place) and runs with the
timed path broken underneath fail."""

import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, TINY_CELL
from h100_bench import cell, control

SEED = 2 ** 32 + 1234567


def _run(root):
    return cell.run(TINY_CELL, SEED, 0.5, False, device="cpu", root=root)


def _failed(res):
    return sorted(k for k, c in res["checks"].items() if c["value"] > c["limit"])


@pytest.fixture(scope="module")
def sound(tiny_root):
    torch.set_num_threads(2)
    return _run(tiny_root)


def test_a_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] >= 32
    assert list(sound)[-1] == "_window" and "checks" in sound
    assert set(sound["metrics"]) == {"reads_per_s", "setup_s"}


def test_the_traced_run_reads_its_layers(tiny_root):
    res = cell.run(TINY_CELL, SEED + 1, 0.2, True, device="cpu", root=tiny_root)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    # the CPU has no device trace: only what the set-up and the batches give
    assert set(m) == {"padding_pct", "tables_s", "assemble_ms_per_batch"}
    assert 0 < m["padding_pct"]["value"] < 100
    assert res["device"]["window_s"] > 0
    assert {n for n, _ in res["breakdown"]["idle_gaps"]} >= {"upload", "step"}


def test_the_control_fails(tiny_root):
    nums = control.control_numbers(TINY_CELL, SEED, tiny_root)
    import json
    with open(os.path.join(tiny_root, "h100_bench", "limits", TINY_CELL + ".json")) as f:
        lim = json.load(f)
    assert any(nums[k] > lim[k] for k in nums), nums


def _broken_step(monkeypatch, how):
    from nadavca_tpu_torch import call as callmod
    from nadavca_tpu_torch import pipeline
    from nadavca_tpu_torch.parallel import sharded

    if how == "state_unchanged":
        make = sharded.make_sharded_step

        def make_sharded_step(*a, **kw):
            step = make(*a, **kw)

            def broken(blocks, acc, cov, votes):
                score, *_ = step(blocks, acc, cov, votes)
                return score, acc, cov, votes
            return broken
        monkeypatch.setattr(sharded, "make_sharded_step", make_sharded_step)
    elif how == "half_the_batch_left_out":
        orig = callmod.accumulate_batch

        def accumulate_batch(acc, cov, base_ll, wstart, wlen, strand, **kw):
            n = int((wlen > 0).sum())          # the true reads lead the batch
            return orig(acc, cov, base_ll[:n // 2], wstart[:n // 2], wlen[:n // 2],
                        strand[:n // 2], **kw)
        monkeypatch.setattr(callmod, "accumulate_batch", accumulate_batch)
    else:
        orig = pipeline.align_batch

        def align_batch(*a, **kw):
            out = orig(*a, **kw)
            if how == "score_altered":
                out["score"] = out["score"].clone()
                out["score"][0] += 1.0
            else:
                ll = out["base_loglik"].clone()
                ll[0] *= 1.1                   # one read's answer 10% off
                out["base_loglik"] = ll
            return out
        monkeypatch.setattr(pipeline, "align_batch", align_batch)


@pytest.mark.parametrize("how", ["state_unchanged", "half_the_batch_left_out",
                                 "score_altered", "loglik_altered"])
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, how):
    torch.set_num_threads(2)
    _broken_step(monkeypatch, how)
    res = _run(tiny_root)
    assert not res["correct"], (how, res["checks"])
    assert _failed(res), how


def test_a_module_loaded_after_the_window_stops_the_result(tiny_root, monkeypatch,
                                                          capsys):
    """A per-layer reader that loads a module named ``jax`` (a stand-in):
    the run names it and prints no result line."""
    import types
    from h100_bench import run, spec

    def reader(metric):
        def read(ctx):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return None
        return read
    monkeypatch.setattr(spec, "reader", reader)
    monkeypatch.setenv("CUDA_CACHE_PATH", str(tiny_root))
    torch.set_num_threads(2)
    rc = run.main(["--workload", TINY_CELL, "--seed", str(SEED + 2), "--seconds", "0.2",
                   "--trace", "1"], root=tiny_root, device="cpu")
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "jax" in out.err


def test_the_sample_covers_every_batch_in_two_row_tiles():
    from h100_bench.reference import RefBatch
    batches = [RefBatch(list(range(b * 256, (b + 1) * 256)), 11136, 1024, 128)
               for b in range(16)]
    traffic = {"check_reads_per_batch": 2}
    sample = cell.sample_reads(batches, traffic, 32, SEED)
    assert sample == cell.sample_reads(batches, traffic, 32, SEED)
    assert sample != cell.sample_reads(batches, traffic, 32, SEED + 1)
    by_batch = {}
    for m, (b, r) in sample.items():
        assert batches[b].members[r] == m
        by_batch.setdefault(b, []).append(r)
    assert sorted(by_batch) == list(range(16))
    assert all(len({r // 32 for r in rows}) == 2 for rows in by_batch.values())


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "h100_bench", "run.py"),
                        "--workload", "ecoli_k12_mg1655.snp_long", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_outside_a_checkout_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's own
    files, the program is missing: no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "h100_bench"), tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                        "ecoli_k12_mg1655.snp_long", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                        "ecoli_k12_mg1655.snp_long", "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    import json
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0 and res["correct"], p.stderr[-2000:]
