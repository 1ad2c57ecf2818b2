"""A cell small enough for the CPU, built from the benchmark's own files
with its sizes cut, for the tests of this directory."""

from __future__ import annotations

import json
from pathlib import Path

from port_bench import spec

HERE = Path(__file__).resolve().parent
PB = HERE.parent

# the sizes cut for the CPU: 64x64 images, 300 surfels grown to cover
# the surface, 6 views, a 2e4 texel budget, 16x16 tiles, a re-chart every
# 20 steps so that set-up and a traced stretch are short
SMALL = dict(image_height=64, image_width=64, surfels=300,
             scale_multiplier=3.0, train_views=6, pixel_num=2e4,
             tile_size=16, gt_downscale=1, build_chart_every=20)
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "step_gap": 1e-3,
          "grad_median_gap": 1e-4, "rechart_gap": 1e-5}


def tiny_spec(config: str = "blender-nvs", traffic: str = "train8",
              name: str = "tiny") -> spec.CellSpec:
    with open(PB / "configs" / f"{config}.json") as f:
        cfg = dict(json.load(f), **SMALL)
    with open(PB / "traffic" / f"{traffic}.json") as f:
        tr = dict(json.load(f), start_step=3081, window_from=3111,
                  trace_steps=4, count_views=2)
    bench = spec.load_benchmark()
    e2e = [m for m in bench["end_to_end"]]
    per_layer = [dict(m, reader=spec.reader(m["name"]))
                 for m in bench["per_layer"]
                 if "blender-nvs.train8" in m.get("workloads", [])]
    return spec.CellSpec(name, cfg, tr, dict(LIMITS), e2e, per_layer)
