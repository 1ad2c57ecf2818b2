"""The harness as data, its last line, and a run driven on the CPU.

Run from the root of the repository:
``python -m pytest port_bench/tests -p no:cacheprovider``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import check, run, spec
from port_bench.tests.tiny import PB, tiny_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_loads_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        sp = spec.cell(w["name"])
        assert set(sp.limits) == set(check.NAMES)
        assert sp.traffic["name"] == w["traffic"]
        assert sp.config["name"] == w["config"]
        assert any(m["name"] == "setup_s" for m in sp.end_to_end)
        assert len(sp.end_to_end) >= 2 and sp.per_layer
        for m in sp.per_layer:
            assert callable(spec.reader(m["name"]))


def test_benchmark_json_keeps_the_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in bench["configs"]:
        with open(PB.parent / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_cell_added_as_files_runs_without_an_edit(tmp_path):
    """A new configuration, traffic mix, metric and cell, each a file of its
    own and an entry in BENCHMARK.json, load and run on the CPU."""
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    here = root / "port_bench"
    small = tiny_spec()
    (here / "configs" / "tiny-scene.json").write_text(
        json.dumps(dict(small.config, name="tiny-scene")))
    (here / "traffic" / "train8-short.json").write_text(
        json.dumps(dict(small.traffic, name="train8-short")))
    (here / "limits" / "tiny-scene.train8-short.json").write_text(
        json.dumps(small.limits))
    (here / "metrics" / "walk.steps.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    bench["configs"].append({"name": "tiny-scene", "source": "x",
                             "file": "port_bench/configs/tiny-scene.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-scene.train8-short",
                               "config": "tiny-scene",
                               "traffic": "train8-short", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "walk.steps", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer", "moves": "train_mpix_s",
                               "workloads": ["tiny-scene.train8-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    sp = spec.cell("tiny-scene.train8-short", root=root, here=here)
    assert [m["name"] for m in sp.per_layer] == ["walk.steps"]
    for m in sp.per_layer:
        m["reader"] = spec.reader(m["name"], here=here)
    out = run.run_cell(sp, 2 ** 33 + 5, 0.5, True, "cpu", say=lambda s: None)
    assert out["correct"]
    assert out["metrics"]["walk.steps"]["value"] == out["attempted"] >= 4


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_schema(traced):
    sp = tiny_spec()
    out = run.run_cell(sp, 4_000_000_007, 0.5, traced, "cpu",
                       say=lambda s: None)
    out.pop("_readings")
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = ({m["name"] for m in sp.per_layer} if traced
            else {m["name"] for m in sp.end_to_end})
    got = set(out["metrics"])
    assert got <= want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert set(out["checks"]) == set(check.NAMES)
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    if traced:
        assert {"device.idle_share", "rechart.ms", "train.mfu"} <= got
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert got == want
        json.dumps(out)


def test_without_a_card_it_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "blender-nvs.train8", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=PB.parent, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_without_the_port_it_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(PB, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(PB.parent / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "blender-nvs.train8", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
