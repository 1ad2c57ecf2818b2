#!/usr/bin/env python3
"""Time a flat-tier training step of the tree at ``--root`` on one card.

    python3 tools/flat_step_ab.py --root DIR [--tag NAME]

Imports ``chip_smoke.py`` and ``gstex_torch`` from ``--root`` (this
repository, or a checkout of another commit), builds that tree's flat
kernels, and times one ``gstex-blender-nvs`` training step as
``chip_smoke.py``'s phase 9 does: the trained-scene statistics at their
auto chart pad (40, 80), re-charted, on the 800x800 view of its phase 9,
against a seeded ground-truth image. Prints one JSON line: the step's
host ms (median of 20, min and max), the card's busy ms and idle share,
and each ``gstex.*`` stage's device ms from a ``torch.profiler`` trace.
Run it on two trees in turns within one call (A, B, B, A) to compare
them on one card.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flat_step_ab: no CUDA device")
    import chip_smoke as cs
    from gstex_torch.configs.methods import get_method
    from gstex_torch.data.synthetic import orbit_c2w
    from gstex_torch.models import init_io
    from gstex_torch.ops import _build
    from gstex_torch.ops import rasterize_bwd as rbwd
    from gstex_torch.ops import rasterize_fwd as rfwd
    from gstex_torch.ops.camera import make_camera
    from gstex_torch.train import step as train_step

    if Path(cs.__file__).resolve().parent != root:
        raise SystemExit(f"flat_step_ab: imported {cs.__file__}, not the "
                         f"tree at {root}")
    _build.build(["rasterize_fwd", "rasterize_bwd", "ssim_fused"])
    method = get_method("gstex-blender-nvs")
    cfg = method.model
    params, buffers = init_io.load_scene_npz(cfg, cs.STATS, seed=1,
                                             device=cs.DEVICE)
    cfg = dataclasses.replace(cfg, chart_pad=tuple(params.texture.shape[1:3]))
    cam = make_camera(1.2 * cs.H, 1.2 * cs.H, cs.W / 2, cs.H / 2, cs.H, cs.W,
                      orbit_c2w(4.0, 0.0), device=cs.DEVICE)
    cfg, state = cs.recharted_state(cfg, method.optim, params, buffers, cam)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(0)
    img = torch.rand((cs.H, cs.W, 3), generator=gen, device=cs.DEVICE)
    timing = cs.step_timing(lambda: train_step.train_step(
        cfg, method.optim, state, cam, img),
        (rfwd.rasterize_fwd, rbwd.rasterize_bwd), cs.H * cs.W)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "tag": args.tag or str(root), "card": smi,
        "chart_pad": list(cfg.chart_pad),
        **{k: timing[k] for k in ("step_ms", "step_ms_min", "step_ms_max",
                                  "device_busy_ms", "device_idle_share",
                                  "launches_per_step")},
        "stage_device_ms": {k: v.get("device_ms")
                            for k, v in timing["trace_stage_ms"].items()},
    }), flush=True)


if __name__ == "__main__":
    main()
