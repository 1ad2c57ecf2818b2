"""gstex-torch-experiments: the paper's sweeps over
``python -m gstex_torch.scripts.train`` (counterpart of
``gstex_tpu/scripts/experiments.py``).

Trains and evaluates every scene of a sweep, one process a run, and logs
each command and the run's abridged eval metrics (``KEEP_KEYS``) to
``<output-root>/<sweep>/log.json``:

    python -m gstex_torch.scripts.experiments blender-nvs \\
        --data-root /data/nerf_synthetic
    python -m gstex_torch.scripts.experiments dtu-lod --data-root /data/dtu \\
        --train-args --max-num-iterations 100 --device cpu

The NVS sweeps start each scene from ``<init-root>/<scene>/init_nvs/
point_cloud.ply`` where it exists; the LOD sweeps train each scene at
every size of ``LOD_SIZES`` from ``init_lod/pc_<size>.ply``, or from that
many random points.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

BLENDER_SCENES = ["chair", "drums", "ficus", "hotdog", "lego", "materials",
                  "mic", "ship"]
DTU_SCANS = [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114, 118, 122]
LOD_SIZES = [128, 512, 2048, 8192, 32768]

KEEP_KEYS = ["psnr", "ssim", "lpips", "gaussian_count", "texel_count",
             "pixel_scale", "fps"]


def run_one(method, data, out_dir, extra_args, log):
    cmd = [sys.executable, "-m", "gstex_torch.scripts.train", method,
           "--data", str(data), "--output-dir", str(out_dir)] + extra_args
    log["commands"].append(" ".join(cmd))
    t0 = time.time()
    subprocess.run(cmd, check=True)
    entry = {"data": str(data), "train_s": round(time.time() - t0, 1)}
    eval_json = Path(out_dir) / "eval.json"
    if eval_json.exists():
        results = json.loads(eval_json.read_text())
        entry.update({k: results[k] for k in KEEP_KEYS if k in results})
    log["runs"].append(entry)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Train and evaluate every scene of a sweep.")
    p.add_argument("sweep", choices=["blender-nvs", "dtu-nvs", "blender-lod",
                                     "dtu-lod"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--init-root", default=None,
                   help="root holding <scene>/init_nvs/point_cloud.ply")
    p.add_argument("--output-root", default="outputs/experiments")
    p.add_argument("--scenes", nargs="*", default=None)
    p.add_argument("--train-args", nargs=argparse.REMAINDER, default=[],
                   help="flags passed to every train run (e.g. "
                        "--train-args --max-num-iterations 100)")
    args = p.parse_args(argv)

    root = Path(args.data_root)
    out_root = Path(args.output_root) / args.sweep
    out_root.mkdir(parents=True, exist_ok=True)
    log = {"commands": [], "runs": []}

    blender = args.sweep.startswith("blender")
    scenes = args.scenes or (BLENDER_SCENES if blender
                             else [f"scan{s}" for s in DTU_SCANS])
    nvs = args.sweep.endswith("nvs")
    method = (("gstex-blender-nvs" if blender else "gstex-dtu-nvs") if nvs
              else ("gstex-blender-lod" if blender else "gstex-dtu-lod"))

    for scene in scenes:
        data = root / scene
        init_root = (Path(args.init_root) / scene if args.init_root
                     else data)
        if nvs:
            extra = list(args.train_args)
            ply = init_root / "init_nvs" / "point_cloud.ply"
            if ply.exists():
                extra += ["--init-ply", str(ply)]
            run_one(method, data, out_root / scene, extra, log)
        else:
            for size in LOD_SIZES:
                ply = init_root / "init_lod" / f"pc_{size}.ply"
                extra = (["--init-lod-ply", str(ply)] if ply.exists()
                         else ["--num-random", str(size)])
                extra += list(args.train_args)
                run_one(method, data, out_root / f"{scene}_{size}", extra,
                        log)
        (out_root / "log.json").write_text(json.dumps(log, indent=2))

    print(json.dumps(log["runs"], indent=2))
    return log


if __name__ == "__main__":
    main()
