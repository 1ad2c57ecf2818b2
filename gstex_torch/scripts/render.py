"""gstex-torch-render: render views of a trained scene to PNG frames.

The counterpart of ``gstex-render`` for the port. The scene comes from
``--scene-npz`` (a gstex-npz export or a trained-scene-statistics file).
Modes:

- ``dataset``: the cameras of ``--data``'s ``transforms_<split>.json``;
- ``spiral``: ``--frames`` views on an orbit, around the mean camera
  distance of ``--data`` when given, else at distance 4 from the origin
  at ``--height`` x ``--width``.

Pair capacities are sized from one demand pass over every camera
(``settle_caps``), so no frame overflows. ``--renderer`` names the tier
(``models.gstex.render``): the default ``pallas`` takes the flat kernels
where the dispatch rule keeps the scene's chart pad on them (up to about
(80, 88) at 32x32 tiles) and the dense-list kernels otherwise;
``pallas4`` the dense-list kernels, as do ``pallas3``, ``pallas2`` and
``pallas1`` (their pair-space kernels train; a frame takes the
dense-list eval kernel); ``xla`` the pure-torch tier.

    python -m gstex_torch.scripts.render spiral \\
        --scene-npz assets/trained_scene_stats.npz --frames 8
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..data.png import write_png
from ..data.synthetic import orbit_c2w, orbit_camera
from ..models import gstex as model
from ..models.init_io import load_scene_npz
from ..ops.binning import sorted_pairs, settle_caps
from ..ops.camera import make_camera
from ..ops.cull import make_pair_cull
from ..ops.prepare import prepare_splats
from ..utils.device import resolve_device

# the viewer's default background, used when the config's is "random"
_EVAL_BACKGROUND = (0.1490, 0.1647, 0.2157)


def eval_background(cfg: model.GStexConfig, device) -> torch.Tensor:
    if cfg.background_color == "white":
        return torch.ones(3, device=device)
    if cfg.background_color == "black":
        return torch.zeros(3, device=device)
    return torch.tensor(_EVAL_BACKGROUND, device=device)


def demand_caps(cfg: model.GStexConfig, params, buffers, cams,
                step: int) -> tuple[int, int]:
    """(pair_cap, s_max) from the largest pair demand over ``cams``: one
    pair expansion per camera, with the cull where ``cfg.pair_cull`` has
    the render cull, then ``settle_caps``. The caps hold for both list
    layouts: each counts the same pairs, and the per-tile cap that bounds
    the flat walk is the dense lists' row length."""
    total, hottest = 0, 0
    for cam in cams:
        prep = prepare_splats(
            params.means, params.log_scales, params.quats,
            params.opacity_logits, params.features_dc,
            params.features_rest, buffers.mappings, cam,
            active_sh_degree=model.active_sh_degree(cfg, step),
            sh_degree=cfg.sh_degree, fix_init=cfg.fix_init,
            extent_sigma=cfg.sigma_factor)
        grid = cfg.grid(cam.height, cam.width)
        cull_fn = (make_pair_cull(prep.geom, cam, grid) if cfg.pair_cull
                   else None)
        pairs = sorted_pairs(prep.centers, prep.extents, prep.depths,
                              prep.valid, grid, 1 << 24, cull_fn)
        total = max(total, pairs.total)
        hottest = max(hottest, int(pairs.tile_counts.max()))
    return settle_caps(total, hottest)


def _cameras(args, device):
    if args.data is not None:
        from ..data.blender import parse_blender

        ds = parse_blender(args.data, args.split)
        cams = [make_camera(ds.fx[i], ds.fy[i], ds.cx[i], ds.cy[i],
                            ds.heights[i], ds.widths[i], ds.c2ws[i],
                            device=device) for i in range(len(ds.c2ws))]
        if args.mode == "dataset":
            return cams
        # spiral around the mean camera distance
        center = ds.c2ws[:, :, 3].mean(axis=0)
        radius = float(np.linalg.norm(center) + 1e-3) or 4.0
        base = cams[0]
        return [make_camera(base.fx, base.fy, base.cx, base.cy, base.height,
                            base.width, orbit_c2w(radius, float(az)),
                            device=device)
                for az in np.linspace(0, 2 * np.pi, args.frames,
                                      endpoint=False)]
    if args.mode == "dataset":
        raise SystemExit("mode 'dataset' needs --data")
    return [orbit_camera(args.height, args.width, dist=4.0,
                         azimuth=float(az), device=device)
            for az in np.linspace(0, 2 * np.pi, args.frames, endpoint=False)]


def main(argv=None) -> list[dict]:
    """Render the frames; returns one summary dict per frame (finite
    output, alpha coverage, total pairs, overflow)."""
    p = argparse.ArgumentParser(
        description="Render views of a trained GStex scene to PNG frames.")
    p.add_argument("mode", choices=["dataset", "spiral"])
    p.add_argument("--scene-npz", required=True,
                   help="gstex-npz export or trained-scene-statistics file")
    p.add_argument("--data", default=None,
                   help="Blender dataset directory (transforms_<split>.json)")
    p.add_argument("--split", default="test")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--output-path", default="renders")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random fills of a statistics file")
    p.add_argument("--renderer", default="pallas",
                   help="render tier: pallas (flat kernels up to about "
                        "(80, 88) charts, else dense), pallas4, pallas3, "
                        "pallas2, pallas1 (dense-list eval kernel), xla "
                        "(pure torch), oracle")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model.GStexConfig(renderer=args.renderer)
    params, buffers = load_scene_npz(cfg, args.scene_npz, seed=args.seed,
                                     device=device)
    # a trained scene renders at its full SH degree
    step = cfg.sh_degree * cfg.sh_degree_interval
    cams = _cameras(args, device)
    pair_cap, s_cap = demand_caps(cfg, params, buffers, cams, step)
    cfg = dataclasses.replace(cfg, pair_cap=pair_cap, s_max=s_cap)
    bg = eval_background(cfg, device)

    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = []
    with torch.no_grad():
        for i, cam in enumerate(cams):
            out = model.render(cfg, params, buffers, cam, step, bg,
                               eval_only=True)
            maps = [out[k] for k in ("rgb", "img", "texture_rgb", "depth",
                                     "alpha")]
            finite = all(bool(torch.isfinite(m).all()) for m in maps)
            rgb = (out["rgb"].clamp(0, 1) * 255).to(torch.uint8)
            write_png(out_dir / f"frame_{i:05d}.png", rgb.cpu().numpy())
            summary.append({
                "frame": i, "finite": finite,
                "alpha_coverage": float((out["alpha"] > 0).float().mean()),
                "total_pairs": out["total_pairs"],
                "overflow": out["overflow"],
            })
    print(f"wrote {len(cams)} frames to {out_dir}")
    return summary


if __name__ == "__main__":
    main()
