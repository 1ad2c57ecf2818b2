"""gstex-torch-render: render views of a trained scene to PNG frames.

The counterpart of ``gstex-render`` for the port (the reference's
``ns-render``). The scene comes from exactly one of

- ``--load-config``: a ``gstex-torch-train`` run directory (or its
  ``config.json``), rebuilt by ``scripts/eval_setup.py``: the latest
  checkpoint's state, rendered at its step with the run's model config
  (renderer, chart pad, background), the cameras of its own dataset
  through its own parser (Blender or nerfstudio);
- ``--scene-npz``: a gstex-npz export or a trained-scene-statistics file,
  at the least chart pad that holds its charts, rendered at its full SH
  degree, with the cameras of ``--data``'s Blender
  ``transforms_<split>.json`` where given.

Modes:

- ``dataset``: the cameras of the ``--split`` split (a run without one
  falls back to its train split, as ``gstex-render`` does);
- ``interpolate``: ``--frames`` poses between those cameras, linear in
  position and by spherical linear interpolation in rotation;
- ``spiral``: ``--frames`` views on an orbit around the mean camera
  distance of those cameras, or with none at distance 4 from the origin
  at ``--height`` x ``--width``;
- ``camera-path``: the keyframes of a nerfstudio ``camera_path.json``
  (``--camera-path-filename``: ``camera_to_world``, ``fov`` in degrees,
  ``render_height`` and ``render_width``).

Pair capacities are sized from one demand pass over every camera
(``settle_caps``), so no frame overflows. ``--renderer`` names the tier
(``models.gstex.render``; default: the run's, else ``pallas``): ``pallas``
takes the flat kernels where the dispatch rule keeps the scene's chart pad
on them (up to about (80, 88) at 32x32 tiles) and the dense-list kernels
otherwise; ``pallas4`` the dense-list kernels, as do ``pallas3``,
``pallas2`` and ``pallas1`` (their pair-space kernels train; a frame takes
the dense-list eval kernel); ``xla`` the pure-torch tier.

``--camera-type equirectangular`` renders, at each of the mode's poses, a
lat-long panorama of ``--pano-width`` x ``--pano-width``/2 from six cube
faces through the tier's eval path (``ops/pano.py``); ``ods`` the
omni-directional stereo pair at ``--ipd``, the left eye above the right.
``--video`` also writes ``render.mp4`` beside the PNGs, one frame a
written PNG (the panorama for ``--camera-type``) at ``--fps`` frames a
second, through the port's own MPEG-4 Part 2 writer (``data/video.py``;
the JAX package uses cv2's ``VideoWriter`` with fourcc ``mp4v``).

    python -m gstex_torch.scripts.render interpolate \\
        --load-config outputs/RUN --frames 30

    python -m gstex_torch.scripts.render spiral \\
        --scene-npz assets/trained_scene_stats.npz --frames 8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..data import video
from ..data.png import write_png
from ..data.synthetic import orbit_c2w, orbit_camera
from ..models import gstex as model
from ..models.init_io import dump_chart_pad, load_scene_npz
from ..ops.binning import settle_caps, sorted_pairs, tile_ranges
from ..ops.camera import make_camera
from ..ops import pano
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
        # every pair has a slot: the expansion is sized to the view's
        # true pair count
        _, _, _, counts = tile_ranges(prep.centers, prep.extents, grid,
                                      prep.valid)
        demand = int(torch.where(prep.depths > 1e-6, counts, 0).sum())
        pairs = sorted_pairs(prep.centers, prep.extents, prep.depths,
                             prep.valid, grid, max(min(demand, 1 << 24), 1),
                             cull_fn)
        total = max(total, int(pairs.total))
        hottest = max(hottest, int(pairs.tile_counts.max()))
    return settle_caps(total, hottest)


def _interp_poses(c2ws, steps: int) -> list[np.ndarray]:
    """``steps`` (3, 4) poses along the cameras ``c2ws``: positions
    linear, rotations by ``scipy``'s ``Slerp``, at even times from the
    first camera to the last."""
    from scipy.spatial.transform import Rotation, Slerp

    n = len(c2ws)
    times = np.arange(n)
    slerp = Slerp(times, Rotation.from_matrix(np.stack(
        [c[:3, :3] for c in c2ws])))
    t_new = np.linspace(0, n - 1, steps)
    r_new = slerp(t_new).as_matrix()
    pos = np.stack([c[:3, 3] for c in c2ws])
    p_new = np.stack([np.interp(t_new, times, pos[:, i]) for i in range(3)],
                     1)
    return [np.concatenate([r_new[i], p_new[i][:, None]], 1)
            for i in range(steps)]


def camera_path_cameras(spec: dict, device) -> list:
    """The cameras of a nerfstudio ``camera_path.json``: each keyframe's
    ``camera_to_world`` (4x4, row-major) at ``render_height`` x
    ``render_width``, its vertical ``fov`` in degrees (the path's where a
    keyframe has none; 50 by default) as ``fy = fx``, the principal point
    at the centre."""
    h = int(spec.get("render_height", 1080))
    w = int(spec.get("render_width", 1920))
    cams = []
    for kf in spec["camera_path"]:
        c2w = np.array(kf["camera_to_world"], np.float64).reshape(4, 4)[:3]
        fov_deg = float(kf.get("fov", spec.get("fov", 50.0)))
        fy = 0.5 * h / np.tan(0.5 * np.deg2rad(fov_deg))
        cams.append(make_camera(fy, fy, w / 2, h / 2, h, w, c2w,
                                device=device))
    return cams


def _dataset_cameras(args, device):
    """The cameras of ``--data``'s Blender split, or None."""
    if args.data is None:
        return None
    from ..data.blender import parse_blender

    ds = parse_blender(args.data, args.split)
    return [make_camera(ds.fx[i], ds.fy[i], ds.cx[i], ds.cy[i],
                        ds.heights[i], ds.widths[i], ds.c2ws[i],
                        device=device) for i in range(len(ds.c2ws))]


def _cameras(args, base, device) -> list:
    """The mode's cameras, from the dataset cameras ``base`` (None where
    the scene came without any)."""
    if args.mode == "camera-path":
        if args.camera_path_filename is None:
            raise SystemExit("mode 'camera-path' needs "
                             "--camera-path-filename")
        spec = json.loads(Path(args.camera_path_filename).read_text())
        return camera_path_cameras(spec, device)
    if base is None:
        if args.mode != "spiral":
            raise SystemExit(f"mode {args.mode!r} needs --load-config or "
                             f"--data")
        return [orbit_camera(args.height, args.width, dist=4.0,
                             azimuth=float(az), device=device)
                for az in np.linspace(0, 2 * np.pi, args.frames,
                                      endpoint=False)]
    if args.mode == "dataset":
        return base
    c2ws = [c.c2w.cpu().numpy() for c in base]
    if args.mode == "interpolate":
        poses = _interp_poses(c2ws, args.frames)
    else:
        # spiral around the mean camera distance
        center = np.mean([c[:3, 3] for c in c2ws], axis=0)
        radius = float(np.linalg.norm(center) + 1e-3) or 4.0
        poses = [orbit_c2w(radius, float(az)) for az in np.linspace(
            0, 2 * np.pi, args.frames, endpoint=False)]
    cam = base[0]
    return [make_camera(cam.fx, cam.fy, cam.cx, cam.cy, cam.height,
                        cam.width, pose, device=device) for pose in poses]


def _eyes(args) -> list[float]:
    """The ipd offsets of each frame's panoramas: one for equirectangular,
    the left and the right eye for ODS."""
    return [0.0] if args.camera_type == "equirectangular" else [-args.ipd,
                                                                 args.ipd]


def _scene(args, device):
    """(cfg, params, buffers, step, dataset cameras or None)."""
    if args.load_config is not None:
        from .eval_setup import eval_setup

        trainer, _, _ = eval_setup(args.load_config, device=device)
        cache = (trainer.eval_cache if args.split == "test"
                 else trainer.train_cache) or trainer.train_cache
        st = trainer.state
        cfg = trainer.mcfg
        if args.renderer is not None:
            cfg = dataclasses.replace(cfg, renderer=args.renderer)
        return cfg, st.params, st.buffers, st.step, cache.cameras
    cfg = model.GStexConfig(renderer=args.renderer or "pallas",
                            chart_pad=dump_chart_pad(args.scene_npz))
    params, buffers = load_scene_npz(cfg, args.scene_npz, seed=args.seed,
                                     device=device)
    # a scene from a file renders at its full SH degree
    return (cfg, params, buffers, cfg.sh_degree * cfg.sh_degree_interval,
            _dataset_cameras(args, device))


def main(argv=None) -> list[dict]:
    """Render the frames; returns one summary dict per frame (finite
    output, alpha coverage, total pairs, overflow; with ``--video`` the
    frame's bytes and encode ms in render.mp4)."""
    p = argparse.ArgumentParser(
        description="Render views of a trained GStex scene to PNG frames.")
    p.add_argument("mode", choices=["dataset", "interpolate", "spiral",
                                    "camera-path"])
    source = p.add_mutually_exclusive_group(required=True)
    source.add_argument("--load-config", default=None,
                        help="gstex-torch-train run directory, or its "
                             "config.json")
    source.add_argument("--scene-npz", default=None,
                        help="gstex-npz export or trained-scene-statistics "
                             "file")
    p.add_argument("--data", default=None,
                   help="with --scene-npz: Blender dataset directory "
                        "(transforms_<split>.json)")
    p.add_argument("--camera-path-filename", default=None,
                   help="nerfstudio camera_path.json (mode camera-path)")
    p.add_argument("--split", default="test")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--output-path", default="renders")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random fills of a statistics file")
    p.add_argument("--renderer", default=None,
                   help="render tier (default: the run's, else pallas): "
                        "pallas (flat kernels up to about (80, 88) charts, "
                        "else dense), pallas4, pallas3, pallas2, pallas1 "
                        "(dense-list eval kernel), xla (pure torch), "
                        "oracle")
    p.add_argument("--background-color", default=None,
                   choices=["random", "white", "black"],
                   help="eval background (default: the run's, else "
                        "random: the viewer's grey)")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--video", action="store_true",
                   help="also write render.mp4 (MPEG-4 Part 2, data/video.py)")
    p.add_argument("--camera-type", default="perspective",
                   choices=["perspective", "equirectangular", "ods"],
                   help="equirectangular / ods: a panorama at each pose "
                        "from six cube faces (ops/pano.py)")
    p.add_argument("--pano-width", type=int, default=2048,
                   help="panorama width (height = width / 2)")
    p.add_argument("--ipd", type=float, default=0.064,
                   help="ODS inter-pupillary distance (world units)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg, params, buffers, step, base = _scene(args, device)
    if args.background_color is not None:
        cfg = dataclasses.replace(cfg, background_color=args.background_color)
    cams = _cameras(args, base, device)
    panoramic = args.camera_type != "perspective"
    face_res = pano.default_face_res(args.pano_width)
    # the caps cover what is rendered: the poses' cube faces for panoramas
    rendered = ([f for cam in cams for ipd in _eyes(args)
                 for f in pano.face_cameras(cam.c2w, face_res, ipd, device)]
                if panoramic else cams)
    with torch.no_grad():
        pair_cap, s_cap = demand_caps(cfg, params, buffers, rendered, step)
    cfg = dataclasses.replace(cfg, pair_cap=pair_cap, s_max=s_cap)
    bg = eval_background(cfg, device)

    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = []
    writer = None

    def save(i, rgb) -> dict:
        """Write frame i's PNG (and, with --video, append it to
        render.mp4: its bytes and encode ms there)."""
        nonlocal writer
        frame = rgb.cpu().numpy()
        write_png(out_dir / f"frame_{i:05d}.png", frame)
        if not args.video:
            return {}
        if writer is None:
            writer = video.open(out_dir / "render.mp4", args.fps,
                                (frame.shape[1], frame.shape[0]))
        writer.write(frame)
        return {"video": {"bytes": writer.sizes[-1],
                          "encode_ms": writer.encode_ms[-1]}}

    def render_one(cam):
        return model.render(cfg, params, buffers, cam, step, bg,
                            eval_only=True)["rgb"]

    try:
        with torch.no_grad():
            for i, cam in enumerate(cams):
                if panoramic:
                    w = args.pano_width
                    if args.camera_type == "equirectangular":
                        img = pano.render_equirect(
                            render_one, cam.c2w, w // 2, w, face_res,
                            device=device)
                    else:
                        img = pano.render_ods(
                            render_one, cam.c2w, w // 2, w, ipd=args.ipd,
                            face_res=face_res, device=device)
                    vid = save(i, (img.clamp(0, 1) * 255).to(torch.uint8))
                    summary.append({
                        "frame": i, "finite": bool(torch.isfinite(img).all()),
                        "height": img.shape[0], "width": img.shape[1],
                        "faces": 6 * len(_eyes(args)), **vid})
                    continue
                out = model.render(cfg, params, buffers, cam, step, bg,
                                   eval_only=True)
                maps = [out[k] for k in ("rgb", "img", "texture_rgb",
                                         "depth", "alpha")]
                finite = all(bool(torch.isfinite(m).all()) for m in maps)
                vid = save(i, (out["rgb"].clamp(0, 1) * 255).to(
                    torch.uint8))
                summary.append({
                    "frame": i, "finite": finite,
                    "alpha_coverage": float(
                        (out["alpha"] > 0).float().mean()),
                    "total_pairs": int(out["total_pairs"]),
                    "overflow": int(out["overflow"]), **vid,
                })
    finally:
        if writer is not None:
            writer.close()
    if writer is not None:
        print(f"wrote {out_dir / 'render.mp4'} ({len(writer.sizes)} frames "
              f"at {args.fps} fps)")
    print(f"wrote {len(cams)} frames to {out_dir}")
    return summary


if __name__ == "__main__":
    main()
