#!/usr/bin/env python3
"""Drive gstex_torch's render path on one CUDA card and hold its kernel
against the plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name and power limit (exit 1 without a CUDA card);
2. build: nvcc builds every kernel of the path from ``gstex_torch/csrc``;
3. kernel vs plain: the CUDA eval kernel against its plain version on the
   same bins, at 800x800, 32x32 tiles, (8, 8) charts, caps from
   ``settle_caps``, for the trained-scene statistics in ``assets/`` and a
   50k-surfel ``surface_scene``; max abs difference <= 1e-4 per map and no
   overflow;
4. main path: ``gstex_torch.scripts.render spiral`` renders 8 frames of
   the trained scene at 800x800; the kernel's launch count must rise by 8
   and the frames be finite with alpha coverage > 0;
5. timing: one frame split into its stages with CUDA events, the whole
   frame on the host clock (median of 20), the card's kernel time per
   frame from a ``torch.profiler`` trace (the rest of the frame is the
   card's idle share), the kernel and its plain version alone;
6. the ``kernels`` line, the nvidia-smi line and the final result.

Peak rates for the bound are the H100 SXM data-sheet numbers: 3.35 TB/s of
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
FRAMES = 8
STEP = 3000          # a trained scene renders at its full SH degree (3)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# fp32 operations of the kernel (csrc/rasterize_eval.cu), a division, an
# expf, a min/max or a floor each counted as one: the response of one
# splat at one live pixel (ray-plane hit, falloff, alpha), and the blend
# of a pair whose weight is > 0 (uv, bilinear fetch, eight sums)
RESPONSE_FLOPS = 34
BLEND_FLOPS = 75
MAPS = {"img": slice(0, 3), "texture_rgb": slice(3, 6), "depth": 6,
        "alpha": 7}


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


def device_ms(fn, reps):
    """Mean ms per ``fn()`` that the card spent running kernels and
    copies, and the five kernels that took most of it, from a
    ``torch.profiler`` trace of ``reps`` runs (one stream, so kernels do
    not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
    # kernel and copy rows only: a CPU op's row repeats its kernels' time
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events)
    top = [[e.key[:100], e.self_device_time_total / 1e3 / reps]
           for e in events[:5]]
    return busy_us / 1e3 / reps, top


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
    so each stage can be timed and the kernel's inputs reused."""

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


def bound(frame, stats):
    """Least time the card could take for the kernel's work on this
    frame's data, and which of bytes or operations sets it."""
    grid, (records, gids, starts, _, charts, info) = frame.grid, frame.inputs
    walked = stats.walked
    n_walked = int(walked.sum())
    # the gaussians the walks read: each record and chart read once
    seg = torch.repeat_interleave(starts.long(), walked)
    rank = (torch.arange(n_walked, device=seg.device)
            - torch.repeat_interleave(torch.cumsum(walked, 0) - walked,
                                      walked))
    used = int(torch.unique(gids.long()[seg + rank]).numel())
    per_splat = records.shape[1] * 4 + charts[0].numel() * 4
    out_bytes = 8 * grid.height * grid.width * 4
    bytes_once = (used * per_splat + n_walked * 4 + 2 * starts.numel() * 4
                  + info.numel() * 4 + out_bytes)
    ops = (int(stats.evaluated) * RESPONSE_FLOPS
           + int(stats.blended) * BLEND_FLOPS)
    bytes_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": bytes_once, "ops": ops, "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        # every walked pair's record and chart staged once per tile
        "pair_traffic_ms": (n_walked * per_splat + out_bytes)
        / HBM_BYTES_PER_S * 1e3,
        "walked_pairs": n_walked, "gaussians_read": used,
        "responses": int(stats.evaluated), "blends": int(stats.blended),
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on "
                         "the card only")
    # the package is imported only once a card is known to be present
    from gstex_torch.models import gstex as model
    from gstex_torch.models import init_io
    from gstex_torch.ops import _build
    from gstex_torch.ops import rasterize_eval as reval
    from gstex_torch.data.synthetic import orbit_camera
    from gstex_torch.scripts import render as render_cli

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

    # 2. build
    t0 = time.perf_counter()
    _build.build(["rasterize_eval"])
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln for ln in _build.build_logs.get("rasterize_eval",
                                                    "").splitlines()
                if "registers" in ln or "spill" in ln])

    # 3. kernel vs plain, on the bins of each scene's first spiral view
    cam = orbit_camera(H, W, dist=4.0, device=DEVICE)
    frames = {}
    worst = 0.0
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
            worst = max(worst, *errs.values())
            frames[name] = (frame, stats)
            emit("kernel_vs_plain", scene=name, max_abs_err=errs, tol=TOL,
                 pair_cap=pair_cap, s_cap=s_cap,
                 total_pairs=frame.bins.total_pairs,
                 overflow=frame.bins.overflow,
                 max_tile_count=int(frame.bins.counts.max()),
                 alpha_coverage=float((frame.maps[7] > 0).float().mean()))
            require(frame.bins.overflow == 0, f"{name}: binning overflowed")
            require(all(e <= TOL for e in errs.values()),
                    f"{name}: kernel and plain version differ by "
                    f"{max(errs.values())} > {TOL}")

        # 4. the main path, through the CLI a user calls
        reval.rasterize_eval.launches = 0
        with tempfile.TemporaryDirectory() as tmp:
            summary = render_cli.main([
                "spiral", "--scene-npz", str(STATS), "--frames", str(FRAMES),
                "--height", str(H), "--width", str(W),
                "--output-path", tmp])
            launches = reval.rasterize_eval.launches
            pngs = len(list(Path(tmp).glob("frame_*.png")))
        emit("main_path", frames=len(summary), pngs=pngs,
             launches=launches, summary=summary)
        require(launches == FRAMES,
                f"the kernel launched {launches} times for {FRAMES} frames")
        require(pngs == FRAMES and len(summary) == FRAMES,
                "the CLI did not write every frame")
        require(all(s["finite"] and s["alpha_coverage"] > 0
                    and s["overflow"] == 0 for s in summary),
                "a frame is not finite, empty or overflowed")

        # 5. timing
        timings = {}
        for name, (frame, stats) in frames.items():
            stage_ms = {st: cuda_ms(getattr(frame, st), 10)
                        for st in Frame.STAGES}
            kernel_ms = cuda_ms(frame.kernel, 50)
            plain_ms = cuda_ms(frame.plain, 2)

            def whole():
                out = model.render(frame.cfg, frame.params, frame.buffers,
                                   frame.cam, STEP, frame.bg, eval_only=True)
                torch.cuda.synchronize()
                return out
            whole()
            per_frame = []
            for _ in range(20):
                t0 = time.perf_counter()
                whole()
                per_frame.append((time.perf_counter() - t0) * 1e3)
            # the host clock spreads (shared CPU cores): report the median
            frame_ms = statistics.median(per_frame)
            busy_ms, top = device_ms(whole, 5)
            timings[name] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                                 frame_ms=frame_ms,
                                 frame_ms_min=min(per_frame),
                                 frame_ms_max=max(per_frame),
                                 stage_ms=stage_ms,
                                 device_busy_ms=busy_ms,
                                 device_idle_share=1.0 - busy_ms / frame_ms,
                                 device_top_ms=top,
                                 mpix_per_s=H * W / frame_ms / 1e3,
                                 **bound(frame, stats))
            emit("timing", scene=name, card=smi, **timings[name])

    main_t = timings["trained_scene_stats"]
    kernels = [{
        "name": "rasterize_eval",
        "route": "cuda",
        "source": "gstex_torch/csrc/rasterize_eval.cu",
        "replaces": "gstex_tpu/ops/rasterize_pallas5.py:363",
        "launches": launches,
        "max_abs_err": worst,
        "ms": main_t["kernel_ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,   # no single PyTorch call computes this
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
