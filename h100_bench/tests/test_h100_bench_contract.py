"""BENCHMARK.json and the files it names, against the benchmark's contract."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    for w in bench["command"]:
        assert TEXT.match(w)
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_texts(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert TEXT.match(m["layer"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(
        bench["workloads"])
    assert "setup_s" in names


def test_every_cell_has_its_files(bench):
    confs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        conf = confs[w["config"]]
        used.add(conf["name"])
        assert conf["file"].startswith("h100_bench/")
        for path in (conf["file"], f"h100_bench/traffic/{w['traffic']}.json",
                     f"h100_bench/limits/{w['name']}.json"):
            assert os.path.isfile(os.path.join(ROOT, path)), path
    assert used == set(confs)
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "h100_bench", "layers",
                                           m["name"] + ".py")), m["name"]


def test_every_moves_is_reported_where_listed(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert sum(reports(m, cell) for m in e2e.values()) >= 2
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in (m.get("workloads") or cells):
            assert cell in cells and reports(e2e[m["moves"]], cell)


def test_limits_name_every_number_compared(bench):
    keys = {"batching_mismatch", "undrained_batches", "score_gap_per_sample",
            "ll_off_share", "cov_mismatch", "acc_rel_gap", "votes_mismatch",
            "calls_mismatch"}
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "h100_bench", "limits", w["name"] + ".json")) as f:
            lim = json.load(f)
        assert set(lim) == keys, w["name"]
        assert all(0 <= v < 1 for v in lim.values()), w["name"]


def test_a_full_check_fits_with_24_cells(bench):
    rs = bench["run_seconds"]
    n = 24
    assert (2 + 14 * n) * (rs + 60) + n * 2 * 90 + 1200 <= 43200
