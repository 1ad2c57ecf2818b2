#!/usr/bin/env python3
"""Drive gstex_torch's render and training paths on one CUDA card and hold
each of its kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name and power limit (exit 1 without a CUDA card);
2. build: nvcc builds the four kernels from ``gstex_torch/csrc``, one
   process each, all at once (ptxas registers, spills, shared memory);
3. kernels vs plain, at 800x800, 32x32 tiles, (8, 8) charts and caps from
   ``settle_caps``, for the trained-scene statistics in ``assets/`` and a
   50k-surfel ``surface_scene``: the eval kernel (max abs <= 1e-4 per map),
   the forward kernel lean and full (max abs <= 1e-4 on all 14 planes,
   ncontrib equal), the backward kernel lean and full under seeded
   cotangents (per record-field group and for the charts, max abs <= 1e-4
   of the plain version's max abs; texture sign flips <= 1e-5), and the
   SSIM kernel and its float32 plain version on a render and a noisy copy,
   each against a float64 evaluation (|loss| <= 1e-6, gradient max abs
   <= 3e-5 of the float64 max), and to each other (the loss to 1e-6, the
   gradient to twice 3e-5);
4. eval main path: ``gstex_torch.scripts.render spiral`` renders 8 frames
   of the trained scene; the eval kernel must launch once per frame;
5. training main path: an 8-view 800x800 Blender dataset rendered from the
   trained scene (seed 0 fills, texels scaled by 5), then
   ``gstex_torch.scripts.train gstex-blender-nvs`` for 120 steps from the
   same geometry with other fills (seed 1), across the re-chart at step
   100: one launch of each training kernel per step, no overflow, finite
   and falling loss, a checkpoint;
6. training shapes and timing: for each scene at its training chart pad
   ((40, 80) for the trained scene) and after a re-chart, the forward and
   backward kernels against their plain versions, lean and full, with the
   gates of phase 3; then an eval frame and a training step timed whole on
   the host clock (median of 20), the card's busy time and each
   ``gstex.*`` stage's host and device time from a ``torch.profiler``
   trace, and each kernel alone beside its plain version and its bound;
7. the ``kernels`` line, the nvidia-smi line and the final result.

Peak rates for the bounds are the H100 SXM data-sheet numbers: 3.35 TB/s of
HBM and 67 TFLOP/s fp32 outside the tensor cores.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
STATS = ROOT / "assets" / "trained_scene_stats.npz"
H = W = 800
PAD = (8, 8)
TOL = 1e-4
BWD_TOL = 1e-4        # of the plain version's max abs, per field group
FLIP_TOL = 1e-5       # texture gradient sign flips
SSIM_LOSS_TOL = 1e-6
# of the float64 gradient's max abs: float32 roundoff alone is ~1.2e-5
SSIM_GRAD_TOL = 3e-5
FRAMES = 8
VIEWS = 8
TRAIN_STEPS = 120
GT_TEXEL_SCALE = 5.0
STEP = 3000          # a trained scene renders at its full SH degree (3)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# fp32 operations counted from the kernels' sources, a division, an expf,
# a min/max, a floor or a compare-and-select each counted as one:
# - RESPONSE: one splat at one live pixel (ray-plane hit, falloff, alpha),
#   in every kernel that walks;
# - BLEND: a forward pair of weight > 0 (uv, bilinear fetch, the eval
#   kernel's eight sums); BLEND_FULL adds m, the normal, reg and m1;
# - BWD: a backward pair of weight > 0 (T recovery, the 3x3 hat-weight
#   fetch and its gradient, the chain rule to 20 record fields and the
#   chart texels); BWD_FULL adds the reg chain and the normal terms;
# - SSIM: one pixel and channel (5 blurs and 3 adjoint blurs of 2 x 11
#   taps, the map and its derivatives).
RESPONSE_FLOPS = 34
BLEND_FLOPS = 75
BLEND_FULL_FLOPS = 96
BWD_FLOPS = 350
BWD_FULL_FLOPS = 390
SSIM_FLOPS = 400
MAPS = {"img": slice(0, 3), "texture_rgb": slice(3, 6), "depth": 6,
        "alpha": 7}
# the port's kernels by stage, read from their own device rows: the
# profiler credits a launch made through ctypes to the op around it, and a
# gstex.* range is no op
STAGE_KERNELS = {"eval_kernel": ("rasterize_eval_kernel",),
                 "fwd_kernel": ("rasterize_fwd_kernel",),
                 "ssim_kernel": ("ssim_tile_kernel", "ssim_sum_kernel"),
                 "bwd_kernel": ("rasterize_bwd_kernel",)}
FIELD_GROUPS = {"normal": [0, 1, 2], "plane": [3], "axis1": [4, 5, 6, 7],
                "axis2": [8, 9, 10, 11], "uv": [15, 19], "opacity": [20],
                "rgb": [21, 22, 23], "xy": [24, 25]}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps):
    """Mean ms of ``fn()`` on the current stream over ``reps`` runs, after
    one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """CUDA-event ms of one call of ``fn()`` and its result, with no
    warm-up: for the plain versions, host-bound loops that take
    seconds."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def host_ms(fn, reps=20):
    """Median, min and max ms of ``fn()`` ending in a synchronize, on the
    host clock (which spreads on a shared CPU), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def device_ms(fn, reps):
    """From a ``torch.profiler`` trace of ``reps`` runs of ``fn()`` (one
    stream, so kernels do not overlap), per run: the ms the card spent
    running kernels and copies, the five kernels that took most of it,
    and each ``gstex.*`` stage's host ms and the device ms of the kernels
    launched inside it; the port's kernels (``STAGE_KERNELS``) are read
    from their own device rows, ``ssim_kernel`` and ``bwd_kernel`` as
    parts of ``loss`` and ``backward``. ``backward`` adds the device ms of the autograd
    engine's nodes, which run on its own thread, outside the stage that
    waits for them; ``autograd_params`` is that less the backward
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    # kernel and copy rows only: a CPU op's row repeats its kernels' time,
    # and a range's device row spans its kernels and the gaps between them
    events = sorted((e for e in rows if e.device_type == DeviceType.CUDA
                     and not e.is_user_annotation),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events)
    top = [[e.key[:100], e.self_device_time_total / 1e3 / reps]
           for e in events[:5]]
    cpu = [e for e in rows if e.device_type == DeviceType.CPU]
    stages = {e.key[len("gstex."):]: {
        "host_ms": e.cpu_time_total / 1e3 / reps,
        "device_ms": e.device_time_total / 1e3 / reps}
        for e in cpu if e.key.startswith("gstex.")}
    for stage, names in STAGE_KERNELS.items():
        us = sum(e.self_device_time_total for e in events
                 if any(f"{n}(" in e.key for n in names))
        if us:
            stages.setdefault(stage, {})["device_ms"] = us / 1e3 / reps
    if "backward" in stages:
        stages["backward"]["device_ms"] += sum(
            e.device_time_total for e in cpu
            if e.key.startswith("autograd::engine::evaluate_function")
        ) / 1e3 / reps
        stages["autograd_params"] = {
            "device_ms": stages["backward"]["device_ms"]
            - stages["bwd_kernel"]["device_ms"]}
    return busy_us / 1e3 / reps, top, stages


def scenes(model, init_io):
    """(name, cfg, params, buffers) for the two scenes of phase 3."""
    from gstex_torch.data.synthetic import surface_scene

    cfg = model.GStexConfig(renderer="pallas", chart_pad=PAD, tile_h=32,
                            tile_w=32)
    yield ("trained_scene_stats", cfg,
           *init_io.params_from_scene_stats(cfg, STATS, device=DEVICE))
    s = surface_scene(50_000, chart_pad=PAD, seed=0, device=DEVICE)
    params = model.GStexParams(*(s[f] for f in model.GStexParams._fields))
    n = s["means"].shape[0]
    buffers = model.GStexBuffers(
        texture_hw=s["texture_hw"], mappings=s["mappings"],
        pixel_scale=torch.tensor(0.01, device=DEVICE),
        test_colors=torch.full((n, 3), 0.5, device=DEVICE))
    yield "surface_scene_50k", cfg, params, buffers


class Frame:
    """One frame of ``models.gstex.render``'s eval path, stage by stage,
    so that the kernels' inputs can be reused."""

    def __init__(self, cfg, params, buffers, cam, bg):
        self.cfg, self.params, self.buffers = cfg, params, buffers
        self.cam, self.bg = cam, bg
        self.grid = cfg.grid(cam.height, cam.width)

    def prepare(self):
        from gstex_torch.models.gstex import active_sh_degree
        from gstex_torch.ops.prepare import prepare_splats

        p, cfg = self.params, self.cfg
        self.prep = prepare_splats(
            p.means, p.log_scales, p.quats, p.opacity_logits, p.features_dc,
            p.features_rest, self.buffers.mappings, self.cam,
            active_sh_degree=active_sh_degree(cfg, STEP),
            sh_degree=cfg.sh_degree, fix_init=cfg.fix_init,
            extent_sigma=cfg.sigma_factor)

    def cull_binning(self):
        from gstex_torch.ops.binning import build_tile_bins_flat
        from gstex_torch.ops.cull import make_pair_cull

        prep = self.prep
        self.bins = build_tile_bins_flat(
            prep.centers, prep.extents, prep.depths, prep.valid, self.grid,
            pair_cap=self.cfg.pair_cap, s_cap=self.cfg.s_max,
            cull_fn=make_pair_cull(prep.geom, self.cam, self.grid))

    def records(self):
        from gstex_torch.ops.records import assemble_records, cam_info
        from gstex_torch.ops.sh import sh_to_rgb

        self.inputs = (
            assemble_records(self.prep.geom, self.cam.c2w[:3, 3],
                             self.buffers.texture_hw),
            self.bins.gids, self.bins.starts, self.bins.counts,
            sh_to_rgb(self.params.texture).contiguous(), cam_info(self.cam))

    def kernel(self):
        from gstex_torch.ops.rasterize_eval import rasterize_eval

        self.maps = rasterize_eval(*self.inputs, self.grid, self.cfg.s_max)

    def plain(self):
        from gstex_torch.ops.rasterize_eval import rasterize_eval_reference

        return rasterize_eval_reference(*self.inputs, self.grid,
                                        self.cfg.s_max)

    def compose(self):
        m = self.maps
        rgb = m[0:3] + m[3:6] + (1.0 - m[7]) * self.bg[:, None, None]
        self.rgb = torch.clamp(rgb, 0.0, 1.0).permute(1, 2, 0)

    STAGES = ("prepare", "cull_binning", "records", "kernel", "compose")

    def run(self):
        for stage in self.STAGES:
            getattr(self, stage)()


def active_bytes(ids, texture_hw, extra=0):
    """Record bytes plus active chart texel bytes (one extra row and
    column with ``extra=1``) of the gaussians ``ids``."""
    hw = texture_hw[ids].long() + extra
    return int(ids.numel()) * 32 * 4 + int((hw[:, 0] * hw[:, 1]).sum()) * 12


def walked_ids(gids, starts, walked):
    """The distinct gaussians of the first ``walked[t]`` slots of each
    tile's segment."""
    n = int(walked.sum())
    seg = torch.repeat_interleave(starts.long(), walked)
    rank = (torch.arange(n, device=seg.device)
            - torch.repeat_interleave(torch.cumsum(walked, 0) - walked,
                                      walked))
    return torch.unique(gids.long()[seg + rank])


def bound_of(bytes_once, ops, **extra):
    bytes_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_once, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, **extra}


def eval_bound(frame, stats):
    """Least time the card could take for the eval kernel's work on this
    frame's data: each read gaussian's record and (8, 8) chart once, the
    walked gids, starts, counts, cam_info and the eight output planes;
    RESPONSE_FLOPS per response the data needed and BLEND_FLOPS per blend
    of weight > 0."""
    grid, (records, gids, starts, _, charts, info) = frame.grid, frame.inputs
    walked = stats.walked
    n_walked = int(walked.sum())
    used = int(walked_ids(gids, starts, walked).numel())
    per_splat = records.shape[1] * 4 + charts[0].numel() * 4
    out_bytes = 8 * grid.height * grid.width * 4
    bytes_once = (used * per_splat + n_walked * 4 + 2 * starts.numel() * 4
                  + info.numel() * 4 + out_bytes)
    ops = (int(stats.evaluated) * RESPONSE_FLOPS
           + int(stats.blended) * BLEND_FLOPS)
    return bound_of(bytes_once, ops, walked_pairs=n_walked,
                    gaussians_read=used, responses=int(stats.evaluated),
                    blends=int(stats.blended))


def fwd_bound(inputs, texture_hw, grid, stats, lean):
    """The forward kernel: the records and active texels of the gaussians
    the walks read, the walked gids, starts, counts and cam_info once, the
    fourteen planes and ncontrib written once; RESPONSE_FLOPS per
    response and BLEND_FLOPS (BLEND_FULL_FLOPS) per blend."""
    _, gids, starts, _, _, info = inputs
    ids = walked_ids(gids, starts, stats.walked)
    bytes_once = (active_bytes(ids, texture_hw) + int(stats.walked.sum()) * 4
                  + 2 * starts.numel() * 4 + info.numel() * 4
                  + 15 * grid.height * grid.width * 4)
    ops = (int(stats.evaluated) * RESPONSE_FLOPS + int(stats.blended)
           * (BLEND_FLOPS if lean else BLEND_FULL_FLOPS))
    return bound_of(bytes_once, ops, responses=int(stats.evaluated),
                    blends=int(stats.blended))


def bwd_bound(inputs, texture_hw, grid, s_cap, ncon, blends, lean):
    """The backward kernel: the records and active texels (plus the row
    and column the hat weights reach) of the gaussians walked, the walked
    gids, starts and counts, three forward planes, ncontrib and the twelve
    cotangent planes read once, and the walked gaussians' record and
    active texel gradients written once; RESPONSE_FLOPS per (pixel, pair)
    below the pixel's ncontrib and BWD_FLOPS (BWD_FULL_FLOPS) per pair of
    weight > 0."""
    from gstex_torch.ops.rasterize_bwd import tile_planes, walk_starts

    _, gids, starts, counts, _, info = inputs
    walk = walk_starts(counts, ncon, grid, s_cap)
    ids = walked_ids(gids, starts, walk)
    planes = tile_planes(torch.stack(
        [ncon.float(), torch.ones_like(ncon, dtype=torch.float32)]), grid)
    responses = int((torch.minimum(planes[0], walk[:, None].float())
                     * planes[1]).sum())
    hw_px = grid.height * grid.width
    bytes_once = (active_bytes(ids, texture_hw, extra=1)
                  + active_bytes(ids, texture_hw) + int(walk.sum()) * 4
                  + 2 * starts.numel() * 4 + info.numel() * 4
                  + 16 * hw_px * 4)
    ops = (responses * RESPONSE_FLOPS
           + blends * (BWD_FLOPS if lean else BWD_FULL_FLOPS))
    return bound_of(bytes_once, ops, responses=responses, blends=blends)


def ssim_bound(shape):
    """The SSIM kernel: both images read once, the gradient written once;
    SSIM_FLOPS fp32 operations per pixel and channel."""
    n = shape[0] * shape[1] * shape[2]
    return bound_of(3 * n * 4 + 4, n * SSIM_FLOPS)


def cotangents(seed=0):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    g = torch.randn((12, H, W), generator=gen, device=DEVICE)
    g[6] *= 0.1
    g[8:] *= 0.1
    return g.contiguous()


def bwd_errors(d_rec, d_ch, ref_rec, ref_ch):
    errs = {}
    for name, fields in FIELD_GROUPS.items():
        scale = float(ref_rec[:, fields].abs().max()) + 1e-12
        errs[name] = float((d_rec[:, fields] - ref_rec[:, fields]).abs()
                           .max()) / scale
    scale = float(ref_ch.abs().max()) + 1e-12
    errs["texture"] = float((d_ch - ref_ch).abs().max()) / scale
    big = ref_ch.abs() > 1e-6 * scale
    flips = (torch.sign(d_ch) != torch.sign(ref_ch)) & big
    return errs, float(flips.sum()) / max(int(big.sum()), 1)


def check_fwd_bwd(inputs, grid, s_cap, lean, **where):
    """The forward kernel, then the backward kernel under seeded
    cotangents, against their plain versions on one view's inputs; fails
    the run on a disagreement. Returns each kernel's max abs error and its
    plain version's ms."""
    from gstex_torch.ops import rasterize_bwd as rbwd
    from gstex_torch.ops import rasterize_fwd as rfwd

    maps, ncon = rfwd.rasterize_fwd(*inputs, grid, s_cap, lean=lean)
    fwd_plain_ms, (ref_maps, ref_ncon) = once_ms(
        lambda: rfwd.rasterize_fwd_reference(*inputs, grid, s_cap,
                                             lean=lean))
    err = float((maps - ref_maps).abs().max())
    same = bool(torch.equal(ncon, ref_ncon))
    emit("kernel_vs_plain", kernel="rasterize_fwd", lean=lean,
         max_abs_err=err, tol=TOL, ncontrib_equal=same, **where)
    require(err <= TOL and same,
            f"{where}: forward kernel and plain version differ "
            f"(lean={lean}): {err}, ncontrib equal {same}")

    g = cotangents()
    d_rec, d_ch = rbwd.rasterize_bwd(*inputs, maps, ncon, g, grid, s_cap,
                                     lean=lean)
    bwd_plain_ms, (ref_rec, ref_ch) = once_ms(
        lambda: rbwd.rasterize_bwd_reference(*inputs, maps, ncon, g, grid,
                                             s_cap, lean=lean))
    errs, flip = bwd_errors(d_rec, d_ch, ref_rec, ref_ch)
    abs_err = max(float((d_rec - ref_rec).abs().max()),
                  float((d_ch - ref_ch).abs().max()))
    emit("kernel_vs_plain", kernel="rasterize_bwd", lean=lean,
         max_abs_err=abs_err, rel_err=errs, tol=BWD_TOL,
         texture_flip_frac=flip, flip_tol=FLIP_TOL, **where)
    require(max(errs.values()) <= BWD_TOL and flip <= FLIP_TOL,
            f"{where}: backward kernel and plain version differ "
            f"(lean={lean}): {errs}, flips {flip}")
    return {"rasterize_fwd": (err, fwd_plain_ms),
            "rasterize_bwd": (abs_err, bwd_plain_ms)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on "
                         "the card only")
    # the package is imported only once a card is known to be present
    from gstex_torch.configs.methods import get_method
    from gstex_torch.data.blender import load_image
    from gstex_torch.data.synthetic import (orbit_c2w, orbit_camera,
                                            surface_scene,
                                            write_blender_dataset)
    from gstex_torch.models import gstex as model
    from gstex_torch.models import init_io
    from gstex_torch.ops import _build
    from gstex_torch.ops import rasterize_bwd as rbwd
    from gstex_torch.ops import rasterize_eval as reval
    from gstex_torch.ops import rasterize_fwd as rfwd
    from gstex_torch.ops import ssim_fused
    from gstex_torch.ops.camera import make_camera
    from gstex_torch.scripts import render as render_cli
    from gstex_torch.scripts import train as train_cli
    from gstex_torch.train import step as train_step

    kernels_src = ["rasterize_eval", "rasterize_fwd", "rasterize_bwd",
                   "ssim_fused"]
    assert not torch.backends.cudnn.allow_tf32

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # 2. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    _build.build(kernels_src)
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in _build.build_logs.get(k, "")
                    .splitlines()
                    if "registers" in ln or "spill" in ln]
                for k in kernels_src})

    # 3. kernels vs plain, on the bins of each scene's first spiral view
    cam = orbit_camera(H, W, dist=4.0, device=DEVICE)
    frames = {}
    worst = dict.fromkeys(kernels_src, 0.0)
    with torch.no_grad():
        for name, cfg, params, buffers in scenes(model, init_io):
            pair_cap, s_cap = render_cli.demand_caps(cfg, params, buffers,
                                                     [cam], STEP)
            cfg = dataclasses.replace(cfg, pair_cap=pair_cap, s_max=s_cap)
            frame = Frame(cfg, params, buffers, cam,
                          render_cli.eval_background(cfg, DEVICE))
            frame.run()
            ref, stats = frame.plain()
            torch.cuda.synchronize()
            errs = {k: float((frame.maps[sl] - ref[sl]).abs().max())
                    for k, sl in MAPS.items()}
            worst["rasterize_eval"] = max(worst["rasterize_eval"],
                                          *errs.values())
            frames[name] = (frame, stats)
            emit("kernel_vs_plain", kernel="rasterize_eval", scene=name,
                 max_abs_err=errs, tol=TOL, pair_cap=pair_cap, s_cap=s_cap,
                 total_pairs=frame.bins.total_pairs,
                 overflow=frame.bins.overflow,
                 max_tile_count=int(frame.bins.counts.max()),
                 alpha_coverage=float((frame.maps[7] > 0).float().mean()))
            require(frame.bins.overflow == 0, f"{name}: binning overflowed")
            require(all(e <= TOL for e in errs.values()),
                    f"{name}: eval kernel and plain version differ by "
                    f"{max(errs.values())} > {TOL}")

            for lean in (True, False):
                check_fwd_bwd(frame.inputs, frame.grid, s_cap, lean,
                              scene=name, chart_pad=list(PAD))

        # SSIM on a render and a noisy copy of it
        pred = frames["trained_scene_stats"][0].rgb.contiguous()
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        noisy = torch.clamp(pred + 0.05 * torch.randn(
            pred.shape, generator=gen, device=DEVICE), 0, 1).contiguous()
        # kernel and plain version compute in float32, each with its own
        # roundoff; both are held to a float64 evaluation, and so to each
        # other at twice the gradient gate
        kernel = ssim_fused.fused_ssim_value_and_grad(pred, noisy)
        plain = ssim_fused.fused_ssim_reference(pred, noisy)
        exact = ssim_fused.fused_ssim_reference(pred.double(),
                                                noisy.double())
        scale = float(exact[1].abs().max())

        def ssim_errors(got, ref):
            grad_abs = float((got[1].double() - ref[1].double()).abs().max())
            return abs(float(got[0]) - float(ref[0])), grad_abs / scale

        errs = {"kernel_vs_float64": ssim_errors(kernel, exact),
                "plain_vs_float64": ssim_errors(plain, exact),
                "kernel_vs_plain": ssim_errors(kernel, plain)}
        grad_abs = float((kernel[1] - plain[1]).abs().max())
        worst["ssim_fused"] = max(errs["kernel_vs_plain"][0], grad_abs)
        emit("kernel_vs_plain", kernel="ssim_fused", shape=list(pred.shape),
             loss=float(kernel[0]), grad_max=scale,
             loss_abs_err_and_grad_rel_err=errs, loss_tol=SSIM_LOSS_TOL,
             grad_tol=SSIM_GRAD_TOL, kernel_vs_plain_grad_tol_factor=2)
        for k, (loss_err, grad_err) in errs.items():
            f = 2 if k == "kernel_vs_plain" else 1
            require(loss_err <= SSIM_LOSS_TOL
                    and grad_err <= f * SSIM_GRAD_TOL,
                    f"SSIM {k}: loss {loss_err}, gradient {grad_err}")

        # 4. eval main path, through the CLI a user calls
        reval.rasterize_eval.launches = 0
        with tempfile.TemporaryDirectory() as tmp:
            summary = render_cli.main([
                "spiral", "--scene-npz", str(STATS), "--frames", str(FRAMES),
                "--height", str(H), "--width", str(W),
                "--output-path", tmp])
            eval_launches = reval.rasterize_eval.launches
            pngs = len(list(Path(tmp).glob("frame_*.png")))
        emit("main_path", path="eval", frames=len(summary), pngs=pngs,
             launches=eval_launches, summary=summary)
        require(eval_launches == FRAMES,
                f"the eval kernel launched {eval_launches} times for "
                f"{FRAMES} frames")
        require(pngs == FRAMES and len(summary) == FRAMES,
                "the CLI did not write every frame")
        require(all(s["finite"] and s["alpha_coverage"] > 0
                    and s["overflow"] == 0 for s in summary),
                "a frame is not finite, empty or overflowed")

    # 5. training main path, through the CLI a user calls
    tmp = tempfile.TemporaryDirectory()
    data = Path(tmp.name) / "data"
    cfg0 = model.GStexConfig(renderer="pallas", chart_pad=PAD,
                             pair_cap=1 << 21, s_max=2048)
    p0, b0 = init_io.params_from_scene_stats(cfg0, STATS, seed=0,
                                             device=DEVICE)
    # texels 5x the loader's fills, so the run starts well away from them
    p0 = p0._replace(texture=GT_TEXEL_SCALE * p0.texture)
    write_blender_dataset(data, cfg0, p0, b0, VIEWS, H, W)
    del p0, b0
    train_counters = (rfwd.rasterize_fwd, rbwd.rasterize_bwd,
                      ssim_fused.fused_ssim_value_and_grad)
    for fn in train_counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = train_cli.main([
        "gstex-blender-nvs", "--data", str(data), "--init-npz", str(STATS),
        "--seed", "1", "--max-num-iterations", str(TRAIN_STEPS),
        "--output-dir", str(Path(tmp.name) / "run")])
    train_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in train_counters}
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    first, last = (statistics.mean(losses[:10]),
                   statistics.mean(losses[-10:]))
    run_cfg = json.loads((Path(tmp.name) / "run" / "config.json")
                         .read_text())
    emit("main_path", path="train", steps=len(hist), seconds=train_s,
         launches=launches, chart_pad=run_cfg["model"]["chart_pad"],
         pair_cap=run_cfg["model"]["pair_cap"],
         first10_loss=first, last10_loss=last,
         losses=[round(x, 6) for x in losses[::10]],
         psnr_first=hist[0]["psnr"], psnr_last=hist[-1]["psnr"],
         max_overflow=max(h["overflow"] for h in hist),
         max_total_pairs=max(h["total_pairs"] for h in hist),
         checkpoint=Path(res["checkpoint"]).name)
    require(len(hist) == TRAIN_STEPS, f"{len(hist)} steps ran")
    require(all(v == TRAIN_STEPS for v in launches.values()),
            f"training kernels launched {launches} for {TRAIN_STEPS} steps")
    require(all(h["overflow"] == 0 for h in hist), "a step overflowed")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            "a loss is not finite")
    require(len(set(losses)) > 3, "the loss did not change")
    require(last < first, f"the loss did not fall: {first} -> {last}")
    require(Path(res["checkpoint"]).exists(), "no checkpoint")

    # 6. timing: an eval frame, then a training step
    timings = {}
    with torch.no_grad():
        for name, (frame, stats) in frames.items():
            kernel_ms = cuda_ms(frame.kernel, 50)
            plain_ms, _ = once_ms(frame.plain)

            def whole():
                return model.render(frame.cfg, frame.params, frame.buffers,
                                    frame.cam, STEP, frame.bg,
                                    eval_only=True)
            frame_ms, lo, hi = host_ms(whole)
            busy_ms, top, trace = device_ms(whole, 5)
            timings[name] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                                 frame_ms=frame_ms, frame_ms_min=lo,
                                 frame_ms_max=hi, trace_stage_ms=trace,
                                 device_busy_ms=busy_ms,
                                 device_idle_share=1.0 - busy_ms / frame_ms,
                                 device_top_ms=top,
                                 mpix_per_s=H * W / frame_ms / 1e3,
                                 **eval_bound(frame, stats))
            emit("timing", path="eval", scene=name, card=smi,
                 **timings[name])

    method = get_method("gstex-blender-nvs")
    image = torch.as_tensor(load_image(data / "train" / "r_0.png"),
                            device=DEVICE)
    train_scenes = []
    mcfg = method.model
    params, buffers = init_io.load_scene_npz(mcfg, STATS, seed=1,
                                             device=DEVICE)
    mcfg = dataclasses.replace(mcfg, chart_pad=tuple(
        params.texture.shape[1:3]))
    train_scenes.append(("trained_scene_stats", mcfg, params, buffers,
                         image))
    bcfg = dataclasses.replace(mcfg, chart_pad=PAD, background_color="black")
    s = surface_scene(50_000, chart_pad=PAD, seed=0, device=DEVICE)
    params, buffers = model.init_params(
        bcfg, s["means"], s["log_scales"], s["quats"], s["opacity_logits"],
        s["features_dc"], s["features_rest"])
    train_scenes.append(("surface_scene_50k", bcfg, params, buffers,
                         torch.zeros((H, W, 3), device=DEVICE)))
    train_t = {}
    main_err = {}
    for name, cfg, params, buffers, img in train_scenes:
        tcam = make_camera(1.2 * H, 1.2 * H, W / 2, H / 2, H, W,
                           orbit_c2w(4.0, 0.0), device=DEVICE)
        with torch.no_grad():
            pair_cap, s_cap = render_cli.demand_caps(cfg, params, buffers,
                                                     [tcam], STEP)
        cfg = dataclasses.replace(cfg, pair_cap=pair_cap, s_max=s_cap)
        state = train_step.init_state(cfg, method.optim, params, buffers,
                                      seed=0)
        state.step = STEP
        # a re-charted state: at the trained scene's pad (40, 80) its
        # active charts grow past the init's 8x8
        train_step.rechart_step(cfg, state)
        hw = state.buffers.texture_hw
        charts = dict(chart_pad=list(cfg.chart_pad),
                      max_active_hw=[int(x) for x in hw.amax(0)],
                      above_8x8=int(((hw[:, 0] > 8) | (hw[:, 1] > 8)).sum()))
        require(max(cfg.chart_pad) <= 8 or charts["above_8x8"] > 0,
                f"{name}: no active chart past 8x8 after the re-chart")
        lean = model.lean_losses(cfg)
        # the kernels' inputs of this step's view, from the state as it is
        with torch.no_grad():
            frame = Frame(cfg, state.params, state.buffers, tcam, None)
            for stage in ("prepare", "cull_binning", "records"):
                getattr(frame, stage)()
        k_in, grid = frame.inputs, frame.grid
        # each kernel against its plain version at the training shapes,
        # lean and full; the main path's mode keeps its plain ms
        checks = {mode: check_fwd_bwd(k_in, grid, s_cap, mode, scene=name,
                                      path="train", **charts)
                  for mode in (True, False)}
        if name == "trained_scene_stats":
            main_err = {k: max(c[k][0] for c in checks.values())
                        for k in ("rasterize_fwd", "rasterize_bwd")}

        def step():
            return train_step.train_step(cfg, method.optim, state, tcam, img)
        for fn in train_counters:
            fn.launches = 0
        step_ms, lo, hi = host_ms(step)
        per_step = {fn.__name__: fn.launches / 21 for fn in train_counters}
        busy_ms, top, trace = device_ms(step, 5)
        # each kernel alone on this view's inputs, beside its plain version
        maps, ncon = rfwd.rasterize_fwd(*k_in, grid, s_cap, lean=lean)
        g = cotangents()
        with torch.no_grad():
            _, stats = reval.rasterize_eval_reference(*k_in, grid, s_cap)
        kt = {
            "rasterize_fwd": dict(
                ms=cuda_ms(lambda: rfwd.rasterize_fwd(*k_in, grid, s_cap,
                                                      lean=lean), 20),
                plain_ms=checks[lean]["rasterize_fwd"][1],
                **fwd_bound(k_in, frame.buffers.texture_hw, grid, stats,
                            lean)),
            "rasterize_bwd": dict(
                ms=cuda_ms(lambda: rbwd.rasterize_bwd(
                    *k_in, maps, ncon, g, grid, s_cap, lean=lean), 20),
                plain_ms=checks[lean]["rasterize_bwd"][1],
                **bwd_bound(k_in, frame.buffers.texture_hw, grid, s_cap,
                            ncon, int(stats.blended), lean)),
        }
        train_t[name] = dict(step_ms=step_ms, step_ms_min=lo, step_ms_max=hi,
                             trace_stage_ms=trace, device_busy_ms=busy_ms,
                             device_idle_share=1.0 - busy_ms / step_ms,
                             device_top_ms=top,
                             mpix_per_s=H * W / step_ms / 1e3,
                             launches_per_step=per_step, lean=lean,
                             pair_cap=pair_cap, s_cap=s_cap,
                             total_pairs=frame.bins.total_pairs,
                             kernels=kt, **charts)
        emit("timing", path="train", scene=name, card=smi, **train_t[name])
        del state, frame, k_in, maps, ncon
    tmp.cleanup()
    # the SSIM kernel on phase 3's 800x800 pair, the training loss's shape;
    # its time does not depend on the data
    ssim_t = dict(
        ms=cuda_ms(lambda: ssim_fused.fused_ssim_value_and_grad(pred, noisy),
                   20),
        plain_ms=cuda_ms(lambda: ssim_fused.fused_ssim_reference(
            pred, noisy), 5),
        float64_ms=cuda_ms(lambda: ssim_fused.fused_ssim_reference(
            pred.double(), noisy.double()), 5),
        **ssim_bound(pred.shape))
    emit("timing", path="ssim", card=smi, shape=list(pred.shape), **ssim_t)

    main_e = timings["trained_scene_stats"]
    main_t = dict(train_t["trained_scene_stats"]["kernels"],
                  ssim_fused=ssim_t)
    worst.update(main_err)
    kernels = [{
        "name": "rasterize_eval",
        "route": "cuda",
        "source": "gstex_torch/csrc/rasterize_eval.cu",
        "replaces": "gstex_tpu/ops/rasterize_pallas5.py:363",
        "launches": eval_launches,
        "max_abs_err": worst["rasterize_eval"],
        "ms": main_e["kernel_ms"],
        "plain_ms": main_e["plain_ms"],
        "bound_ms": main_e["bound_ms"],
        "bound_by": main_e["bound_by"],
        "library_ms": None,   # no single PyTorch call computes this
    }]
    replaces = {"rasterize_fwd": "gstex_tpu/ops/rasterize_pallas5.py:140",
                "rasterize_bwd": "gstex_tpu/ops/rasterize_pallas5.py:561",
                "ssim_fused": "gstex_tpu/ops/ssim_fused.py:63"}
    counter = {"rasterize_fwd": "rasterize_fwd",
               "rasterize_bwd": "rasterize_bwd",
               "ssim_fused": "fused_ssim_value_and_grad"}
    for k, where in replaces.items():
        kernels.append({
            "name": k, "route": "cuda", "source": f"gstex_torch/csrc/{k}.cu",
            "replaces": where, "launches": launches[counter[k]],
            "max_abs_err": worst[k], "ms": main_t[k]["ms"],
            "plain_ms": main_t[k]["plain_ms"],
            "bound_ms": main_t[k]["bound_ms"],
            "bound_by": main_t[k]["bound_by"],
            # no single PyTorch call computes any of these (the SSIM's
            # plain version is five conv2d calls plus autograd)
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
