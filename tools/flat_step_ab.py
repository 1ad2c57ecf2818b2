#!/usr/bin/env python3
"""Time a training step or an eval frame of the tree at ``--root`` on one
card, on the flat, the dense or a pair-space tier.

    python3 tools/flat_step_ab.py --root DIR
        [--tier flat|dense|pallas3|pallas2|dtu_pallas1]
        [--mode step|eval|chunk] [--data DIR] [--tag NAME]

Imports ``chip_smoke.py`` and ``gstex_torch`` from ``--root`` (this
repository, or a checkout of another commit), builds that tree's kernels
of the tier, and times one ``gstex-blender-nvs`` training step (``--mode
step``) or one eval frame of the same state (``--mode eval``, the
forward-only ``models.gstex.render``) as ``chip_smoke.py``'s phase 10
does, or (``--mode chunk``) runs ``chip_smoke.py``'s phase 5e check
(``scan_check``: a chunk of 8 steps through the captured graph against
eager steps, its gates, times and ``kept_graph_cost``; then, where that
tree has it, ``accum_scan_check``, the same with groups accumulating
gradients) on the state and 8
views of an orbit, with seeded ground-truth images: the trained-scene statistics at their auto chart pad, re-charted,
on the 800x800 view of its phase 10, against a seeded ground-truth image.
``--tier flat`` takes pixel_num 1e6, pad (40, 80); ``--tier dense``
pixel_num 4e6, pad (64, 128), which the dispatch sends to the dense
kernels; ``--tier pallas3`` and ``pallas2`` pixel_num 1e5, pad (16, 24),
on that renderer (the v3 or v2 training kernels; the eval frame takes the
dense eval kernel). ``--tier dtu_pallas1`` (step only) is ``chip_smoke.py``'s
phase 10 at the nerfstudio path's shapes: a ``gstex-dtu-nvs`` state on
``renderer="pallas1"`` from the seed ply of a DTU-like capture at its
auto pad (40, 80), re-charted, stepping on its first masked 800x600 train
view; the capture is written into ``--data`` (as phase 8 writes it) unless
it is there, so that turns of two trees share it. Prints one JSON line:
the step's or frame's host ms
(``ms``, median of 20, ``ms_min`` and ``ms_max``), the card's busy ms
and idle share, and each ``gstex.*`` stage's device ms from a
``torch.profiler`` trace. Run it on two trees in turns within one call
(A, B, B, A) to compare them on one card.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


def dtu_state(cs, data: Path):
    """The nerfstudio path's training state on ``pallas1`` and its first
    train view: (optim, cfg, state, cam, img, mask); writes the capture
    into ``data`` first where it is missing."""
    from gstex_torch.configs.methods import get_method
    from gstex_torch.data.manager import FullImageCache
    from gstex_torch.data.nerfstudio_parser import parse_nerfstudio
    from gstex_torch.data.synthetic import write_nerfstudio_dataset
    from gstex_torch.models import gstex as model
    from gstex_torch.models import init_io

    if not (data / "init.ply").exists():
        cfg = model.GStexConfig(renderer="pallas", chart_pad=cs.PAD,
                                pair_cap=1 << 21, s_max=2048,
                                background_color="black")
        params, buffers = init_io.params_from_scene_stats(
            cfg, cs.STATS, seed=0, device=cs.DEVICE)
        params = params._replace(texture=cs.GT_TEXEL_SCALE * params.texture)
        write_nerfstudio_dataset(data, cfg, params, buffers, cs.DTU_VIEWS,
                                 cs.DTU_H, cs.DTU_W)
    method = get_method("gstex-dtu-nvs")
    cfg = dataclasses.replace(method.model, renderer="pallas1")
    raw = init_io.raw_from_gaussian_ply(data / "init.ply",
                                        fix_init=cfg.fix_init,
                                        device=cs.DEVICE)
    params, buffers = model.init_params(cfg, *(raw[k] for k in (
        "means", "log_scales", "quats", "opacity_logits", "features_dc",
        "features_rest")))
    cfg = dataclasses.replace(cfg, chart_pad=tuple(params.texture.shape[1:3]))
    views = FullImageCache.build(parse_nerfstudio(
        data, "train", downscale_factor=method.downscale_factor,
        eval_mode=method.eval_mode, eval_interval=method.eval_interval),
        device=cs.DEVICE)
    cam, img, mask = views.get(0)
    cfg, state = cs.recharted_state(cfg, method.optim, params, buffers, cam)
    return method.optim, cfg, state, cam, img, mask


def smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--tier", choices=("flat", "dense", "pallas3", "pallas2",
                                       "dtu_pallas1"), default="flat")
    ap.add_argument("--mode", choices=("step", "eval", "chunk"),
                    default="step")
    ap.add_argument("--data", default=None,
                    help="the DTU-like capture's directory (dtu_pallas1)")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    if args.tier == "dtu_pallas1" and (args.mode != "step" or not args.data):
        ap.error("--tier dtu_pallas1 times a step and needs --data")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flat_step_ab: no CUDA device")
    import chip_smoke as cs
    from gstex_torch.configs.methods import get_method
    from gstex_torch.data.synthetic import orbit_c2w
    from gstex_torch.models import init_io
    from gstex_torch.models import gstex as model
    from gstex_torch.ops import _build
    from gstex_torch.ops import rasterize_bwd as rbwd
    from gstex_torch.ops import rasterize_dense as rdense
    from gstex_torch.ops import rasterize_eval as reval
    from gstex_torch.ops import rasterize_fwd as rfwd
    from gstex_torch.ops import rasterize_v1 as rv1
    from gstex_torch.ops import rasterize_v2 as rv2
    from gstex_torch.ops import rasterize_v3 as rv3
    from gstex_torch.ops import ssim_fused
    from gstex_torch.ops.camera import make_camera
    from gstex_torch.scripts import render as render_cli
    from gstex_torch.train import step as train_step

    if Path(cs.__file__).resolve().parent != root:
        raise SystemExit(f"flat_step_ab: imported {cs.__file__}, not the "
                         f"tree at {root}")
    # (eval, forward, backward) kernels of the tier; its texel budget
    kernels, pixel_num = {
        "flat": ((reval.rasterize_eval, rfwd.rasterize_fwd,
                  rbwd.rasterize_bwd), None),
        "dense": ((rdense.rasterize_dense_eval, rdense.rasterize_dense_fwd,
                   rdense.rasterize_dense_bwd), cs.DENSE_PIXEL_NUM),
        "pallas3": ((rdense.rasterize_dense_eval, rv3.rasterize_v3_fwd,
                     rv3.rasterize_v3_bwd), cs.PAIR_PIXEL_NUM),
        "pallas2": ((rdense.rasterize_dense_eval, rv2.rasterize_v2_fwd,
                     rv2.rasterize_v2_bwd), cs.PAIR_PIXEL_NUM),
        "dtu_pallas1": ((rdense.rasterize_dense_eval, rv1.rasterize_v1_fwd,
                         rv1.rasterize_v1_bwd), None)}[args.tier]
    _build.build([fn.__name__ for fn in kernels] + ["ssim_fused"])
    if args.tier == "dtu_pallas1":
        optim, cfg, state, cam, img, mask = dtu_state(
            cs, Path(args.data).resolve())
    else:
        method = get_method("gstex-blender-nvs")
        optim, mask = method.optim, None
        cfg = dataclasses.replace(method.model, pixel_num=(
            pixel_num or method.model.pixel_num))
        params, buffers = init_io.load_scene_npz(cfg, cs.STATS, seed=1,
                                                 device=cs.DEVICE)
        cfg = dataclasses.replace(cfg,
                                  chart_pad=tuple(params.texture.shape[1:3]))
        cam = make_camera(1.2 * cs.H, 1.2 * cs.H, cs.W / 2, cs.H / 2, cs.H,
                          cs.W, orbit_c2w(4.0, 0.0), device=cs.DEVICE)
        cfg, state = cs.recharted_state(cfg, optim, params, buffers, cam)
        if args.tier in ("pallas3", "pallas2"):
            cfg = dataclasses.replace(cfg, renderer=args.tier)
        gen = torch.Generator(device=cs.DEVICE).manual_seed(0)
        img = torch.rand((cs.H, cs.W, 3), generator=gen, device=cs.DEVICE)
    if args.mode == "chunk":
        views = [(make_camera(1.2 * cs.H, 1.2 * cs.H, cs.W / 2, cs.H / 2,
                              cs.H, cs.W, orbit_c2w(4.0, 0.4 * i),
                              device=cs.DEVICE),
                  torch.rand((cs.H, cs.W, 3), generator=gen,
                             device=cs.DEVICE))
                 for i in range(cs.SCAN_STEPS)]
        counters = (*kernels[1:], ssim_fused.fused_ssim_value_and_grad)
        res = cs.scan_check(cfg, optim, state, views, counters,
                            tier=args.tier)
        print(json.dumps({"tag": args.tag or str(root), "card": smi(),
                          **res}), flush=True)
        if hasattr(cs, "accum_scan_check"):
            res = cs.accum_scan_check(cfg, optim, state, views, counters,
                                      res, tier=args.tier)
            print(json.dumps({"tag": args.tag or str(root), "card": smi(),
                              "path": "scan_accumulating", **res}),
                  flush=True)
        return
    if args.mode == "step":
        timing = cs.step_timing(lambda: train_step.train_step(
            cfg, optim, state, cam, img, mask), kernels[1:],
            cam.height * cam.width)
    else:
        bg = render_cli.eval_background(cfg, cs.DEVICE)

        def frame():
            with torch.no_grad():
                return model.render(cfg, state.params, state.buffers, cam,
                                    cs.STEP, bg, eval_only=True)
        kernels[0].launches = 0
        ms, lo, hi = cs.host_ms(frame)
        busy, _, trace = cs.device_ms(frame, 5)
        timing = dict(step_ms=ms, step_ms_min=lo, step_ms_max=hi,
                      device_busy_ms=busy,
                      device_idle_share=1.0 - busy / ms,
                      launches_per_step={kernels[0].__name__:
                                         kernels[0].launches / 21},
                      trace_stage_ms=trace)
    print(json.dumps({
        "tag": args.tag or str(root), "card": smi(), "tier": args.tier,
        "mode": args.mode, "chart_pad": list(cfg.chart_pad),
        # a step's or an eval frame's host ms
        "ms": timing["step_ms"], "ms_min": timing["step_ms_min"],
        "ms_max": timing["step_ms_max"],
        **{k: timing[k] for k in ("device_busy_ms", "device_idle_share",
                                  "launches_per_step")},
        "stage_device_ms": {k: v.get("device_ms")
                            for k, v in timing["trace_stage_ms"].items()},
    }), flush=True)


if __name__ == "__main__":
    main()
