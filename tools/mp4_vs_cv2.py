#!/usr/bin/env python3
"""Compare the port's mp4 writer (``gstex_torch/data/video.py``) with
what ``gstex-render --video`` writes, ``cv2.VideoWriter(path,
fourcc("mp4v"), fps, (w, h))``, on the same rendered frames: each file's
bytes, and each frame's PSNR as ``cv2.VideoCapture`` (ffmpeg) reads it
back, against the frame written.

    python3 tools/mp4_vs_cv2.py [--size 800] [--frames 8] [--fps 24]
        [--out DIR]

The frames are views of ``assets/trained_scene_stats.npz`` on an orbit,
rendered by the port on the CPU (its texels 5x the loader's fills, as
``chip_smoke.py``'s capture has them). Needs cv2, so it runs beside the
tests, not on the card. Prints one JSON object.
"""

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gstex_torch.data import video  # noqa: E402
from gstex_torch.data.synthetic import orbit_camera  # noqa: E402
from gstex_torch.models import gstex as model, init_io  # noqa: E402
from gstex_torch.scripts.render import demand_caps  # noqa: E402


def frames(size: int, n: int) -> list[np.ndarray]:
    cfg = model.GStexConfig(renderer="pallas", chart_pad=(8, 8),
                            background_color="black")
    params, buffers = init_io.params_from_scene_stats(
        cfg, ROOT / "assets" / "trained_scene_stats.npz", seed=0,
        device="cpu")
    params = params._replace(texture=5.0 * params.texture)
    cams = [orbit_camera(size, size, dist=4.0, azimuth=float(a),
                         device="cpu")
            for a in np.linspace(0, 2 * np.pi, n, endpoint=False)]
    step = cfg.sh_degree * cfg.sh_degree_interval
    out = []
    with torch.no_grad():
        cap, s_max = demand_caps(cfg, params, buffers, cams, step)
        cfg = dataclasses.replace(cfg, pair_cap=cap, s_max=s_max)
        for cam in cams:
            rgb = model.render(cfg, params, buffers, cam, step,
                               torch.zeros(3), eval_only=True)["rgb"]
            out.append((rgb.clamp(0, 1) * 255).to(torch.uint8).numpy())
    return out


def db(a, b) -> float:
    """PSNR in dB of two uint8 images."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255 ** 2 / mse))


def read(path) -> list[np.ndarray]:
    cap = cv2.VideoCapture(str(path))
    got = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        got.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    return got


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    torch.set_num_threads(4)
    imgs = frames(args.size, args.frames)
    out = Path(args.out or tempfile.mkdtemp())
    out.mkdir(parents=True, exist_ok=True)
    h, w = imgs[0].shape[:2]
    cv_path, port_path = out / "cv2.mp4", out / "port.mp4"
    writer = cv2.VideoWriter(str(cv_path), cv2.VideoWriter_fourcc(*"mp4v"),
                             args.fps, (w, h))
    for f in imgs:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    port = video.open(port_path, args.fps, (w, h))
    for f in imgs:
        port.write(f)
    port.close()
    psnr = {name: [round(db(a, b), 3) for a, b in zip(read(path), imgs)]
            for name, path in (("cv2", cv_path), ("port", port_path))}
    print(json.dumps({
        "size": [w, h], "frames": len(imgs), "fps": args.fps,
        "qscale": video.QSCALE,
        "bytes": {"cv2": cv_path.stat().st_size,
                  "port": port_path.stat().st_size},
        "psnr_rgb": psnr, "port_psnr_y": [round(db(
            video.reconstruct(f[:h & ~1, :w & ~1])[0],
            video.rgb_to_planes(f[:h & ~1, :w & ~1])[0][:h & ~1, :w & ~1]),
            3) for f in imgs],
        "port_encode_ms": [round(x, 3) for x in port.encode_ms]}))


if __name__ == "__main__":
    main()
