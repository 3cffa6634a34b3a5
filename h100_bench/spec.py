"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
``configs/<config>.json``, ``traffic/<traffic>.json`` and one reader a
per-layer metric, ``layers/<metric>.py``. Adding a configuration, a mix, a
metric or a cell adds files and entries; no file here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(root, os.path.basename(HERE), "traffic",
                                       w["traffic"] + ".json")),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def limits(name: str, root: str = ROOT) -> dict:
    """The limit of every number the check compares in cell ``name``."""
    return load_json(os.path.join(root, os.path.basename(HERE), "limits", name + ".json"))


def reader(metric: str) -> Callable:
    """The ``read(ctx)`` function of ``layers/<metric>.py``."""
    path = os.path.join(HERE, "layers", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "h100_bench_layer_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_layers(metrics: List[dict], ctx) -> Dict[str, dict]:
    """Each per-layer metric its reader finds something for; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
