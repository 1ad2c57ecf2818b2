"""gstex-torch-parity: the parity harness of ``gstex-parity`` for the port.

Given a Blender or DTU scene and its 2DGS init ply:

1. **config 1 (gradcheck)**: 2DGS mode (``pixel_num=0``), the forward
   and backward of one train view through the kernel tier against the
   pure-torch ``xla`` tier: the render and every parameter gradient;
2. **config 2 (training)**: the method trained through
   ``gstex_torch.scripts.train`` (``--quick N``: N steps), its mean eval
   PSNR held against the paper's Table 1 (33.25 dB Blender, 32.87 dB
   DTU).

    python -m gstex_torch.scripts.parity --data DATA_DIR \\
        --init-ply DATA_DIR/init_nvs/point_cloud.ply --dataset blender

**The synthetic held-out protocol** (``--synthetic``, no dataset): a
textured surfel sphere (``data/synthetic.py:surface_scene``) is rendered
at ``--res`` from ``--views`` orbit views, every 5th held out; the ground
truth comes from the ``xla`` tier, certified against the per-pixel oracle
(``ops/rasterize_ref.py``) on 8 views at 256² and on a 128-pixel window
at full resolution (``--gt-renderer oracle_certified``). A perturbed-
geometry, zeroed-texture init trains on the other views; ``parity.json``
reports the held-out views' metrics, then the trained state is rendered
through the kernel tier and the ``xla`` tier (renderer consistency) and
differentiated through both (trained-state gradcheck), each under its
gate. The full protocol:

    python -m gstex_torch.scripts.parity --synthetic --res 800 \\
        --n-gauss 20000 --views 125 --quick 15000 \\
        --output-dir parity_out_torch

``--device cpu`` runs on the CPU (the kernels' plain versions), at a
small ``--res`` and ``--n-gauss``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..configs.methods import get_method
from ..data.manager import FullImageCache
from ..data.synthetic import orbit_camera, surface_scene
from ..models import gstex as model
from ..models import init_io
from ..ops.camera import make_camera
from ..train import optim
from ..train.trainer import Trainer, TrainerConfig
from ..utils.device import resolve_device
from .render import demand_caps
from .train import build_dataset
from .train import main as train_main

TABLE1_PSNR = {"blender": 33.25, "dtu": 32.87}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over max |b|."""
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def _value_and_grad(cfg, params, buffers, cam, step, gt, background):
    """(loss, rgb, gradient of each leaf) of one render of ``params``."""
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    out = model.render(cfg, model.GStexParams(*leaves), buffers, cam, step,
                       background)
    total, _ = model.loss_fn(cfg, out, gt, step)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return total.detach(), out["rgb"].detach(), model.GStexParams(*grads)


def gradcheck(method, data_dir, init_ply, renderer="pallas", device=None):
    """Config 1: 2DGS mode's forward and backward on the first train view,
    through ``renderer`` and through the ``xla`` tier; the largest
    differences relative to the ``xla`` tier's largest value."""
    dev = resolve_device(device)
    mcfg = dataclasses.replace(method.model, pixel_num=0.0, renderer="xla")
    cache = FullImageCache.build(build_dataset(method, data_dir, "train"),
                                 device=dev)
    raw = init_io.raw_from_gaussian_ply(init_ply, sh_degree=mcfg.sh_degree,
                                        fix_init=mcfg.fix_init, device=dev)
    params, buffers = model.init_params(
        mcfg, raw["means"], raw["log_scales"], raw["quats"],
        raw["opacity_logits"], raw["features_dc"], raw["features_rest"])
    cam, img, _ = cache.get(0)
    step, bg = 15000, torch.zeros(3, device=dev)
    # the method's capacities are seeds: sized to the view's demand, as the
    # train CLI sizes them, so that neither tier renders truncated lists
    with torch.no_grad():
        pair_cap, s_max = demand_caps(mcfg, params, buffers, [cam], step)
    mcfg = dataclasses.replace(mcfg, pair_cap=pair_cap, s_max=s_max)
    gt = model.composite_gt(img, bg)
    l_ref, rgb_ref, g_ref = _value_and_grad(mcfg, params, buffers, cam, step,
                                            gt, bg)
    l_pl, rgb_pl, g_pl = _value_and_grad(
        dataclasses.replace(mcfg, renderer=renderer), params, buffers, cam,
        step, gt, bg)
    grad_diffs = {k: _rel(a, b) for k, a, b in zip(params._fields, g_pl,
                                                   g_ref)}
    rgb_diff = _rel(rgb_pl, rgb_ref)
    return {
        "loss_xla": float(l_ref), "loss_pallas": float(l_pl),
        "rgb_rel_diff": rgb_diff,
        "grad_rel_diffs": grad_diffs,
        "gradcheck_pass": rgb_diff < 1e-3
        and max(grad_diffs.values()) < 5e-3,
    }


def heldout_config(renderer: str) -> model.GStexConfig:
    """The synthetic protocol's model config: (8, 8) charts, 32x32 tiles,
    a 1e6 texel budget and a black background."""
    return model.GStexConfig(chart_pad=(8, 8), tile_h=32, tile_w=32,
                             pair_cap=1 << 19, s_max=2048, pixel_num=1e6,
                             background_color="black", renderer=renderer)


def heldout_cameras(res: int, views: int, device) -> tuple[list, set]:
    """``views`` orbit cameras at evenly spaced azimuths, and the held-out
    indices: every 5th view, between training azimuths."""
    cams = [orbit_camera(res, res, dist=4.0, azimuth=2 * np.pi * i / views,
                         elevation=0.35, device=device)
            for i in range(views)]
    return cams, {i for i in range(views) if i % 5 == 4}


def render_views(cfg: model.GStexConfig, params, buffers, cams) -> list:
    """The ``rgb`` of each camera through ``cfg.renderer`` at step 10000
    (the kernel tiers through their eval kernel), on a black background;
    raises where a view's pair lists overflow (a truncated render)."""
    bg = torch.zeros(3, device=params.means.device)
    views = []
    with torch.no_grad():
        for cam in cams:
            out = model.render(cfg, params, buffers, cam, 10000, bg,
                               eval_only=cfg.renderer.startswith("pallas"))
            if int(out["overflow"]) > 0:
                raise RuntimeError(
                    f"{cfg.renderer} render overflowed its pair lists "
                    f"(pair_cap {cfg.pair_cap}, s_max {cfg.s_max})")
            views.append(out["rgb"])
    return views


def _scaled(cam, res: int, rs: float = None, shift: float = 0.0):
    """``cam`` at ``res`` x ``res``: intrinsics scaled by ``rs`` (default
    res over the camera's size) and the principal point moved by
    −``shift`` pixels of the original camera."""
    rs = res / cam.width if rs is None else rs
    return make_camera(float(cam.fx) * rs, float(cam.fy) * rs,
                       (float(cam.cx) - shift) * rs,
                       (float(cam.cy) - shift) * rs, res, res, cam.c2w,
                       device=cam.c2w.device)


def certify_gt(cfg, params, buffers, cams, eval_idx, gen: str,
               certifier: str, res: int) -> dict:
    """The ground-truth generator ``gen`` against ``certifier``: on 8
    views (evenly spread) at min(res, 256)² — systematic errors of the
    generator do not depend on the resolution — and on a centred
    min(res, 128)-pixel window of the first held-out view at the full
    resolution's intrinsics. Passes where both stay under 1e-3."""
    t0 = time.time()
    cert_res = min(res, 256)
    n_cert = min(8, len(cams))
    picks = [cams[int(i)] for i in np.linspace(0, len(cams) - 1, n_cert)
             .astype(int)]
    small = [_scaled(c, cert_res) for c in picks]
    cfg_c = dataclasses.replace(cfg, renderer=certifier)
    cfg_g = dataclasses.replace(cfg, renderer=gen)
    diffs = [float((a - b).abs().max()) for a, b in zip(
        render_views(cfg_c, params, buffers, small),
        render_views(cfg_g, params, buffers, small))]
    win = min(res, 128)
    window = [_scaled(cams[sorted(eval_idx)[0]], win, rs=1.0,
                      shift=(res - win) // 2)]
    win_diff = float((render_views(cfg_c, params, buffers, window)[0]
                      - render_views(cfg_g, params, buffers, window)[0])
                     .abs().max())
    out = {"certifier": certifier, "views_checked": n_cert,
           "cert_res": cert_res, "max_abs_diff": max(diffs),
           "fullres_window": win, "fullres_window_max_abs_diff": win_diff,
           "pass": max(diffs) < 1e-3 and win_diff < 1e-3,
           "seconds": time.time() - t0}
    print(f"[parity] GT certification vs {certifier}: max abs diff "
          f"{max(diffs):.2e} over {n_cert} views, full-res {win}px window "
          f"{win_diff:.2e} ({'PASS' if out['pass'] else 'FAIL'})",
          flush=True)
    return out


def perturbed_init(params_gt, n_gauss: int, seed: int):
    """The init: the ground truth's geometry perturbed (means by 0.3 of
    the point spacing, log scales by 0.2, both Gaussian), texture and
    colours zeroed — the analog of starting from a pretrained 2DGS ply."""
    dev = params_gt.means.device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    spacing = 1.2 * float(np.sqrt(4.0 * np.pi / n_gauss))
    noise = lambda x: torch.randn(x.shape, generator=gen, device=dev)
    return params_gt._replace(
        means=params_gt.means + 0.3 * spacing * noise(params_gt.means),
        log_scales=params_gt.log_scales + 0.2 * noise(params_gt.log_scales),
        texture=torch.zeros_like(params_gt.texture),
        features_dc=torch.zeros_like(params_gt.features_dc),
        features_rest=0.0 * params_gt.features_rest)


def synthetic_heldout(renderer: str, res: int, iters: int, out_dir: Path,
                      n_gauss: int = 20000, seed: int = 0, views: int = 125,
                      gt_renderer: str = "oracle", device=None,
                      params_gt=None, buffers_gt=None, params_init=None):
    """The held-out protocol (see the module docstring); returns the eval
    metrics of the held-out views (``Trainer.eval_all``'s schema) with the
    run's settings, the GT certification, and, for a kernel ``renderer``,
    the renderer consistency and the trained-state gradcheck.

    ``params_gt`` / ``buffers_gt`` replace the drawn ground-truth scene
    and ``params_init`` the drawn init (another package's draws, say)."""
    dev = resolve_device(device)
    cfg = heldout_config(renderer)
    if params_gt is None:
        scene = surface_scene(n_gauss, chart_pad=cfg.chart_pad, seed=seed,
                              device=dev)
        params_gt, buffers_gt = model.init_params(
            cfg, scene["means"], scene["log_scales"], scene["quats"],
            scene["opacity_logits"], scene["features_dc"],
            scene["features_rest"])
    cams, eval_idx = heldout_cameras(res, views, dev)

    if gt_renderer == "oracle_certified":
        gen, certifier = "xla", "oracle"
    else:
        gen, certifier = gt_renderer, None
    t_gt = time.time()
    gt_views = render_views(dataclasses.replace(cfg, renderer=gen),
                            params_gt, buffers_gt, cams)
    print(f"[parity] {len(gt_views)} GT views via {gen} renderer: "
          f"{time.time() - t_gt:.1f}s", flush=True)
    gt_certification = None
    if certifier:
        gt_certification = certify_gt(cfg, params_gt, buffers_gt, cams,
                                      eval_idx, gen, certifier, res)
    # the views as 8-bit images, as a dataset holds them
    images = [(torch.clamp(v, 0, 1) * 255).to(torch.uint8).to(torch.float32)
              / 255.0 for v in gt_views]
    del gt_views

    params0 = (params_init if params_init is not None
               else perturbed_init(params_gt, n_gauss, seed))
    train_cache = FullImageCache(
        cameras=[c for i, c in enumerate(cams) if i not in eval_idx],
        images=[v for i, v in enumerate(images) if i not in eval_idx])
    eval_cache = FullImageCache(
        cameras=[c for i, c in enumerate(cams) if i in eval_idx],
        images=[v for i, v in enumerate(images) if i in eval_idx])
    tcfg = TrainerConfig(max_num_iterations=iters, steps_per_save=0,
                         steps_per_eval_image=0, log_every=100,
                         output_dir=str(Path(out_dir) / "synthetic_run"))
    tr = Trainer(tcfg, cfg, optim.OptimConfig(max_steps=iters), params0,
                 buffers_gt, train_cache, eval_cache)
    t0 = time.time()
    tr.train()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_seconds = time.time() - t0
    # the trained params, for ``--scene-npz`` and other packages' loaders
    init_io.export_npz(Path(out_dir) / "trained_params.npz", tr.state.params,
                       tr.state.buffers)
    agg = tr.eval_all()
    agg.update(train_seconds=train_seconds, iters=iters, res=res,
               n_gaussians=n_gauss, held_out_views=sorted(eval_idx),
               gt_renderer=gt_renderer, gt_certification=gt_certification,
               train_views=len(train_cache))
    if renderer != "xla":
        agg.update(renderer_consistency(tr.mcfg, tr.state, eval_cache,
                                        iters))
        agg.update(trained_state_gradcheck(tr.mcfg, tr.state,
                                           eval_cache.get(0)[0], iters))
    return agg


def trained_state_gradcheck(mcfg, state, cam, iters):
    """The loss and every parameter gradient of the trained state through
    ``mcfg.renderer`` against the ``xla`` tier, on a ground truth 0.02
    above the ``xla`` render. A transmittance break that one tier takes
    and the other does not swaps a whole splat's contribution, so a
    handful of entries may differ by much; the gate holds the loss to
    1e-3, each gradient's largest difference to 5e-2 of its largest
    entry, and the share of entries off by more than 1e-2 of it to
    1e-5."""
    dev = state.params.means.device
    bg = torch.zeros(3, device=dev)
    cfg_x = dataclasses.replace(mcfg, renderer="xla")
    with torch.no_grad():
        gt = torch.clamp(model.render(cfg_x, state.params, state.buffers,
                                      cam, iters, bg)["rgb"] + 0.02, 0, 1)
    l_ref, _, g_ref = _value_and_grad(cfg_x, state.params, state.buffers,
                                      cam, iters, gt, bg)
    l_pl, _, g_pl = _value_and_grad(mcfg, state.params, state.buffers, cam,
                                    iters, gt, bg)
    fields = model.GStexParams._fields
    grad_diffs = {k: _rel(a, b) for k, a, b in zip(fields, g_pl, g_ref)}
    flip_fracs = {
        k: float(((a - b).abs() > 1e-2 * (b.abs().max() + 1e-12))
                 .float().mean())
        for k, a, b in zip(fields, g_pl, g_ref)}
    l_ref, l_pl = float(l_ref), float(l_pl)
    out = {
        "trained_gradcheck_loss_xla": l_ref,
        "trained_gradcheck_loss_pallas": l_pl,
        "trained_gradcheck_grad_rel_diffs": grad_diffs,
        "trained_gradcheck_flip_frac_gt_1e2": flip_fracs,
        "trained_gradcheck_pass": bool(
            abs(l_pl - l_ref) / max(abs(l_ref), 1e-12) < 1e-3
            and max(grad_diffs.values()) < 5e-2
            and max(flip_fracs.values()) <= 1e-5),
    }
    print(f"[parity] trained-state gradcheck: loss {l_ref:.6f} vs "
          f"{l_pl:.6f}, max grad rel diff {max(grad_diffs.values()):.2e} "
          f"({'PASS' if out['trained_gradcheck_pass'] else 'FAIL'})",
          flush=True)
    return out


def renderer_consistency(mcfg, state, eval_cache, iters, n_views: int = 4):
    """The trained state rendered through ``mcfg.renderer``'s eval path
    and through the ``xla`` tier on the first ``n_views`` held-out views.
    Both stop a pixel's blend where T·(1 − α) falls to T_EPS, so a last
    bit of α can flip one whole splat, whose weight is at most 0.1; the
    gate bounds the distribution: mean < 5e-4, p99 of each pixel's
    largest channel difference < 5e-3, pixels above 5e-3 at most 1e-4 of
    all, and every difference under 0.1."""
    cfg_x = dataclasses.replace(mcfg, renderer="xla")
    bg = torch.zeros(3, device=state.params.means.device)
    diffs = []
    n_cons = min(n_views, len(eval_cache))
    with torch.no_grad():
        for i in range(n_cons):
            cam = eval_cache.get(i)[0]
            rp = model.render(mcfg, state.params, state.buffers, cam, iters,
                              bg, eval_only=True)["rgb"]
            rx = model.render(cfg_x, state.params, state.buffers, cam, iters,
                              bg)["rgb"]
            diffs.append((rp - rx).abs().cpu().numpy())
    d = np.stack(diffs)
    px = d.max(-1).reshape(-1)
    p99 = float(np.percentile(px, 99))
    flip_frac = float((px > 5e-3).mean())
    out = {
        "renderer_consistency_views": n_cons,
        "renderer_consistency_max_rgb_diff": float(d.max()),
        "renderer_consistency_mean_rgb_diff": float(d.mean()),
        "renderer_consistency_p99_rgb_diff": p99,
        "renderer_consistency_flip_frac_gt_5e3": flip_frac,
        "renderer_consistency_pass": bool(
            d.mean() < 5e-4 and p99 < 5e-3 and flip_frac <= 1e-4
            and d.max() < 0.1),
    }
    print(f"[parity] renderer consistency over {n_cons} views: max "
          f"{d.max():.2e} mean {d.mean():.2e} p99 {p99:.2e} flips "
          f"{flip_frac:.2e} "
          f"({'PASS' if out['renderer_consistency_pass'] else 'FAIL'})",
          flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Parity harness: gradcheck and Table-1 training on a "
                    "dataset, or the synthetic held-out protocol.")
    p.add_argument("--data", default=None)
    p.add_argument("--init-ply", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="held-out-view metrics on a synthetic textured "
                        "scene (no dataset)")
    p.add_argument("--res", type=int, default=800)
    p.add_argument("--n-gauss", type=int, default=20000,
                   help="synthetic scene size")
    p.add_argument("--views", type=int, default=125,
                   help="synthetic views, every 5th held out (125: 100 "
                        "train views, Blender's density)")
    p.add_argument("--gt-renderer", default="oracle_certified",
                   choices=["oracle_certified", "oracle", "xla", "pallas"],
                   help="synthetic ground truth: oracle_certified (the xla "
                        "tier, certified by the per-pixel oracle on sample "
                        "views), or one tier for every view (the oracle "
                        "costs O(HW*N) a view: small scales only)")
    p.add_argument("--dataset", choices=["blender", "dtu"],
                   default="blender")
    p.add_argument("--output-dir", default="parity_out")
    p.add_argument("--renderer", default=None,
                   help="tier under test (default pallas)")
    p.add_argument("--quick", type=int, default=0,
                   help="train only N steps (the verdict then reads quick)")
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    renderer = args.renderer or "pallas"
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.synthetic:
        iters = args.quick or 2000
        print(f"[parity] synthetic held-out protocol: {iters} iters at "
              f"{args.res}^2 ({renderer})", flush=True)
        report = {"mode": "synthetic_heldout", "renderer": renderer,
                  "gt_renderer": args.gt_renderer}
        report["heldout"] = synthetic_heldout(
            renderer, args.res, iters, out_dir, n_gauss=args.n_gauss,
            views=args.views, gt_renderer=args.gt_renderer,
            device=args.device)
        report["psnr"] = report["heldout"]["psnr"]
        (out_dir / "parity.json").write_text(json.dumps(report, indent=1))
        print(json.dumps({k: v for k, v in report["heldout"].items()
                          if not isinstance(v, dict)}, indent=1))
        print(f"[parity] wrote {out_dir / 'parity.json'}")
        return report

    if not args.data or not args.init_ply:
        raise SystemExit("--data/--init-ply required (or use --synthetic)")
    name = ("gstex-blender-nvs" if args.dataset == "blender"
            else "gstex-dtu-nvs")
    method = get_method(name)
    report = {"dataset": args.dataset, "data": args.data,
              "renderer": renderer,
              "target_psnr_table1": TABLE1_PSNR[args.dataset]}

    print("[parity] config 1: 2DGS-mode gradcheck (pixel_num=0)")
    t0 = time.time()
    report["gradcheck"] = gradcheck(method, args.data, args.init_ply,
                                    renderer=renderer, device=args.device)
    report["gradcheck"]["seconds"] = time.time() - t0
    print(json.dumps(report["gradcheck"], indent=1))

    if not args.skip_train:
        iters = args.quick or method.trainer.max_num_iterations
        print(f"[parity] config 2: textured training ({iters} iters)")
        train_argv = [
            name, "--data", args.data, "--init-ply", args.init_ply,
            "--max-num-iterations", str(iters),
            "--steps-per-eval-image", "0", "--renderer", renderer,
            "--output-dir", str(out_dir / "run")]
        if args.device:
            train_argv += ["--device", args.device]
        agg = train_main(train_argv)["eval"]
        if agg:
            report["eval"] = agg
            report["psnr"] = agg.get("psnr")
            full = iters >= method.trainer.max_num_iterations
            report["verdict"] = (
                "PASS" if full and agg.get("psnr", 0)
                >= TABLE1_PSNR[args.dataset] - 0.3 else
                "QUICK (not comparable — partial schedule)" if not full
                else "FAIL")
    (out_dir / "parity.json").write_text(json.dumps(report, indent=1))
    print(f"[parity] wrote {out_dir / 'parity.json'}")
    return report


if __name__ == "__main__":
    main()
