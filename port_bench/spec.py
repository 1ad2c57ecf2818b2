"""The benchmark as data: ``BENCHMARK.json`` at the root of the checkout
names the cells, configurations and metrics; each configuration is
``configs/<name>.json`` (the file its entry names), each traffic mix
``traffic/<name>.json``, each per-layer metric a reader
``metrics/<name>.py`` with a function ``read(ctx)``, and each cell's
comparison limits ``limits/<cell>.json``. Nothing here knows a cell by
name."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class CellSpec:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the metric entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, here: Path = HERE) -> CellSpec:
    """The cell ``name`` of ``BENCHMARK.json``, with its files loaded."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(here / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(here / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return CellSpec(name, config, traffic, limits,
                    [m for m in bench["end_to_end"] if _reports(m, name)],
                    [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, here: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
