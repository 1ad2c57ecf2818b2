#!/usr/bin/env python3
"""Drive gstex_torch's render and training paths on one CUDA card and hold
each of its kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name and power limit (exit 1 without a CUDA card);
2. build: nvcc builds the fourteen kernel sources from
   ``gstex_torch/csrc`` (seventeen kernels: the three flat sources each
   hold a bf16 chart entry too), one process each, all at once (ptxas
   registers, spills, shared memory; the flat kernels' and their bf16
   entries', the dense backward's and the three pair-space backwards'
   shared memory per launch, which no chart pad enters);
3. kernels vs plain, at 800x800, 32x32 tiles, (8, 8) charts and caps from
   ``settle_caps``, for the trained-scene statistics in ``assets/`` and a
   50k-surfel ``surface_scene``: the eval kernel (bit for bit); phase 10
   holds both scenes' training kernels, flat and dense, at their
   training pads, under the gates named here: the forward kernel lean
   and full (max abs <= 1e-4 on all 14 planes, ncontrib equal), the
   backward kernel lean and full under seeded cotangents (per
   record-field group and for the charts, max abs <= 1e-4 of the plain
   version's max abs; texture sign flips <= 1e-5); the SSIM kernel and
   its float32 plain version on a render and a noisy copy
   (800x800, and its first 600 rows: the DTU path's 800x600), each
   against a float64 evaluation (|loss| <= 1e-6, gradient max abs
   <= 3e-5 of the float64 max), and to each other (the loss to 1e-6, the
   gradient to twice 3e-5); then the pair-space v3, v2 and v1 kernels
   on per-slot copies of the dense lists of the trained scene at
   pixel_num 1e5, re-charted, at their main path's (16, 24) (there also
   the dense eval kernel, bit for bit under three tile orders: block,
   longest first, reversed): each against its plain
   version, lean and full; the v3, v2 and v1 backwards also under the
   three tile orders (within 1e-5 of each field group's max of their own
   order); v3 and v2, summed per gaussian, against the dense kernels on
   the same pairs (v3's
   product scan may break a pixel's walk one slot apart from the serial
   product at no more than 1e-5 of the pixels; the maps are held to 1e-4
   elsewhere); v1 against v2, which it equals but for its rounding of the
   distortion depth m (ncontrib and every plane but reg and m1 bit for
   bit, those within 1e-6 of their max; gradients within 1e-5 of each
   field group's max, no sign flips); the v3, v2 and v1 forwards under
   the three tile orders, each bit-equal to its own order's output and
   to its plain version's ncontrib and t_final (v2 and v1: every plane);
4. eval main path: ``gstex_torch.scripts.render spiral`` renders 8 frames
   of the trained scene; the eval kernel must launch once per frame;
5. training main path: an 8-view 800x800 Blender dataset rendered from the
   trained scene (seed 0 fills, texels scaled by 5), then
   ``gstex_torch.scripts.train gstex-blender-nvs`` for 120 steps from the
   same geometry with other fills (seed 1), across the re-chart at step
   100: one launch of each training kernel per step, no overflow, finite
   and falling loss, a checkpoint; the run takes the trainer's default
   ``steps_per_sync`` of 8: one captured CUDA graph, replayed for every
   chunked step but the capture's warm-up (chunks end on each log step);
   then a test split of two views;
5b. the run resumed: ``--load-checkpoint`` of its step-120 checkpoint to
   step 140 with ``--steps-per-save 10 --steps-per-eval-image 10 --vis
   tensorboard,wandb`` (every checkpoint kept): it starts at step 120,
   saves at steps 120 and 130 (files named by the steps taken, 121 and
   131) and at 140, writes the JAX package's ``events.jsonl`` rows and
   ``images/eval_rgb_*.png``, each sink writes its files or prints its
   notice, and each flat training kernel launches once a step; then on to step 160
   with ``--set model.use_normal_loss=true --set model.lambda_normal=0.05``:
   a finite, non-zero normal term, the flat forward and backward
   launched once a step, in full mode only;
5f. the bf16 chart stream: ``gstex_torch.scripts.train gstex-blender-nvs
   --set model.texel_dtype=bf16`` for 40 steps from phase 5's init on
   its dataset, through the captured chunk: each flat kernel's bf16
   forward and backward entries launched once a step and the float32
   flat entries never, the closing eval on the bf16 eval entry, the loss
   finite and falling, ``texel_dtype`` in the run's ``config.json``; then
   one ``render spiral --load-config`` frame of the run, one launch of
   the bf16 eval entry;
5c. camera pose optimization: a copy of phase 5's dataset whose training
   poses are right-multiplied by the exp map of a seeded SO3xR3 tangent
   (σ 0.02), then ``gstex_torch.scripts.train gstex-blender-nvs --set
   trainer.camera_opt=SO3xR3`` for 120 steps from phase 5's init across
   the re-chart at 100: the flat forward, backward and SSIM kernels once
   a step, finite ``camera_opt_*`` scalars and loss, JAX's
   ``events.jsonl`` rows with them, the deltas exactly zero until the
   pose optimizer's one update at the 100th step (100-step accumulation)
   and non-zero from then on, ``pose-000000120.npz`` written; resumed
   from step 120 to 130, the deltas and the pose optimizer's state
   restored bit for bit; 20 ``SE3`` steps, finite; 20 steps at pixel_num
   4e6, pad (64, 128): the dense forward and backward once a step, the
   flat ones never; then one camopt step of the step-120 state through
   the kernels against the same step through their plain versions (the
   pose gradient and accumulator within 1e-3 of the plain one's max abs),
   and a camopt step and a plain step of that state timed by CUDA events
   (median of 20);
5d. the tile-row mesh (``gstex_torch/parallel/``), run after phase 7,
   whose runs it reuses: the view of training camera 3 of the runs of
   phases 5 (flat, (40, 80)), 6 (dense, (64, 128)) and 7 (the pallas3
   run's (16, 24) state, on ``pallas3`` and ``pallas1``) rendered whole
   and as the bands of 2 and 4 ranks (each band its own grid at pixel
   offset (0, r·band_h)): through the tier's eval kernel and its
   training kernels, the stitched maps bit-equal to the whole frame's
   and the bands' pair counts summing to the frame's, the bands'
   backwards under seeded cotangents summed within 1e-4 of each
   parameter's max abs of the frame's, each kernel launched once a band;
   then two ranks sharing the card over gloo (asked for explicitly;
   gloo stages its collectives through the host): from phase 5's
   step-120 state, a sharded step, a sharded camopt step and a 2-row
   data-parallel step against the single rank's (the loss to 1e-5, each
   gradient within 1e-4 of its max abs), ``make_sharded_train_scan`` on
   two views against two sharded steps (phase 5e's gates), then ``Trainer(num_devices=2)``
   for 10 steps at 800x800 from phase 5's init on phase 5's dataset: the
   flat forward and backward once a step on each rank, no overflow, the
   replicas' parameters and buffers equal bit for bit; then NCCL on a
   group of one rank a card (``torch.cuda.device_count()``): the sharded
   step's gradients all-reduced (with two cards or more, the gloo group's
   checks and trainer run too). Each rank's step time and the gradient
   all-reduce's bytes and time are information only;
5e. the scanned dispatch (``train/step.py:make_train_scan``), run after
   phase 6, whose state it reuses: on phase 5's step-120 state (flat, (40,
   80)) and phase 6's (dense, (64, 128)), a chunk of 8 steps through the
   captured graph against 8 eager steps from an equal copy, twice (the
   first chunk captures, the second only replays), beside a second eager
   copy: the losses within 1e-4, each leaf's params within 0.1 of the
   eager change and its moments within 0.25 of the eager moments, both
   as L2 norms (two eager runs depart by up to 0.011 and 0.112;
   ``scan_check``); the
   warm-up step under ``set_sync_debug_mode("error")``; the graph's
   kernel nodes of each of the port's kernels against one step's
   launches; eager and chunked step ms on the host clock, the replays
   alone by CUDA events, each one's busy ms and the card's idle share
   from a ``torch.profiler`` trace; what keeping the graph beside its
   executable costs in replay ms and memory (``kept_graph_cost``).
   Phases 5 and 7 check every graph their trainers capture the same way
   (``CaptureRecorder``);
6. the large-chart main path: ``gstex_torch.scripts.train
   gstex-blender-nvs --pixel-num 4e6`` on phase 5's dataset plus a test
   split, 120 steps across the re-chart: the auto chart pad is (64, 128),
   which the dispatch rule (``rasterize_api.flat_pad_rule``) sends to the
   dense tier, so every step launches the dense-list forward and backward
   kernels once and the flat training kernels never; the closing eval
   pass launches the dense-list eval kernel; then 8 spiral frames
   through ``gstex_torch.scripts.render --renderer pallas4``;
7. the pair-space main path: ``gstex_torch.scripts.train
   gstex-blender-nvs --pixel-num 1e5 --renderer pallas3`` on phase 6's
   dataset, 120 steps across the re-chart: the auto chart pad is (16, 24);
   every step launches the v3 forward and backward kernels once and no
   other training kernel; the closing eval pass launches the dense-list
   eval kernel; then the same with ``--renderer pallas2`` and the v2
   kernels; the pair buffer's bytes and each run's peak memory;
8. the nerfstudio main path: a DTU-like capture written from the trained
   scene (16 views of 1600x1200 intrinsics, their images downscaled by 2
   to 800x600 in ``images_2/``, black background, object masks, the
   surfels as a seed ply in COLMAP axes), then ``gstex_torch.scripts.train
   gstex-dtu-nvs --renderer pallas1 --init-ply`` for 120 steps across the
   re-chart: the auto chart pad is (40, 80); every step launches the v1
   forward and backward kernels and the SSIM kernel once and no other
   training kernel; the closing eval pass over the interval split
   launches the dense-list eval kernel; the pair buffer's bytes, the peak
   memory and the eval PSNR;
9. serving the trained runs: on phase 5's run (the flat tier, Blender)
   ``gstex_torch.scripts.eval --load-config`` prints the JAX package's
   schema with a finite PSNR, the flat eval kernel launching once per
   test view and once for the warm-up; ``render --load-config`` writes
   its frames in the ``dataset``, ``interpolate``, ``spiral`` and
   ``camera-path`` modes, one eval-kernel launch a frame; ``export``
   writes the ``gstex-ply``, ``gstex-npz`` and ``gaussian-ply`` files,
   and the gstex-npz export rendered through ``render --scene-npz`` on
   the test cameras gives the run's own frames bit for bit; on phase 8's
   run (the v1 tier, nerfstudio) the same eval, the ``dataset`` and
   ``interpolate`` renders and the exports, on the dense eval kernel;
9b. the synthetic held-out parity protocol, ``gstex_torch.scripts.parity
   --synthetic`` at 800², 20000 surfels, 10 views (8 train, 2 held out)
   and 500 steps on the flat tier, the ground truth from the xla tier
   without the oracle's certification: renderer consistency and the
   trained-state gradcheck pass their gates, the held-out PSNR is
   finite, and the flat training kernels launch once a step (and once for
   the gradcheck), the SSIM kernel once more (the gradcheck's reference
   loss), the flat eval kernel for the eval pass and the consistency
   check;
9c. texture painting: on phase 5's run (flat, pad (40, 80)) and phase
   6's (dense, (64, 128)), an ``EditSession`` with a polyline from each of
   two test cameras; each edit's texture-edit kernel against its plain
   version (each accumulator channel within 1e-5 of its max, the texels
   reached the same set), timed alone and beside its bound; the stack
   replayed through ``edit_texture`` (one texture-edit and one dense-eval
   launch an edit), a texel changed, one ``draw_from_view`` timed; the
   ``render_eval_images`` set with the edited charts, its ``edit`` image
   from the run's eval kernel within 1e-6 of the pure-torch tier's; then
   ``gstex-torch-viewer`` on phase 5's run on a free port: a ``/frame``
   (a JPEG of the resolution cap's size, decoded by the port's decoder,
   one eval launch a band), a polyline painted over HTTP, ``/state``
   showing the edit;
9d. captured data and panoramas: a nerfstudio capture of 16 JPEG frames
   (quality 95, ``data/jpeg.py``) rendered from the trained scene at
   800x800 through an OPENCV lens (k1 -0.05, k2 0.01, p1 1e-3, p2
   -1e-3); the host JPEG decoder's time a frame (the C++ build at first
   use, its plain version once, equal bytes) and the capture's load time
   (decode and undistortion in the thread pool, to the card); then
   ``gstex-dtu-nvs --renderer pallas --set model.num_downscales=2 --set
   model.resolution_schedule=30`` for 120 steps: 30 steps at 200x200, 30
   at 400x400, 60 at 800x800, each launching the flat forward, backward
   and SSIM kernels once, the loss falling (overall and at full size),
   the held-out PSNR against the undistorted frames above 20 dB;
   OPENCV_FISHEYE and FISHEYE624 copies of 4 frames loaded (new
   intrinsics, the fisheye624 mask's coverage) and trained 20 steps with
   a finite loss; then on phase 5's run (flat) and phase 6's (dense)
   ``render dataset --camera-type equirectangular|ods --pano-width 2048``
   (6 and 12 launches of the run's eval kernel a panorama, PNGs of
   2048x1024 and 2048x2048), each panorama timed, the equirect's centre
   crop within 0.06 of the 90-degree pinhole render at its pose;
9e. LPIPS and DBSCAN: ``utils/lpips.py`` with seeded random weights of
   the AlexNet shapes on phase 3's 800x800 render and its noisy copy
   (finite, zero for identical images, within 1e-4 of the CPU's value,
   reported by the eval metrics under ``GSTEX_LPIPS_NPZ``, timed), and
   ``tools/dbscan.py`` on 5000 surfels of phase 5's trained run (the W2
   distances of 256 rows within 1e-5 of the CPU's, the 5000x5000 matrix,
   ``estimate_eps`` and ``DBSCAN.fit`` timed, at least one cluster);
10. training shapes and timing: for each scene at its training chart pad
   and after a re-chart (the trained scene at (40, 80), the surface scene
   at (8, 8), the trained scene at pixel_num 4e6 at (64, 128), and a
   2000-surfel subsample of it at (88, 88), the last two on the dense
   tier), the tier's forward and backward kernels against their plain
   versions, lean and full, with the gates of phase 3, and its eval kernel
   (bit for bit; the dense one under the three tile orders); dense
   against flat at (40, 80), and there the dense forward and backward
   under the three tile orders (the forward's maps and ncontrib bit-equal
   to its plain version under each, the backward within 1e-5 of each
   field group's max) and the flat kernels' bf16 chart entries: each
   against its plain version on the same bf16 charts, lean and full,
   under the gates above (eval bit for bit, the chart gradient float32),
   against the float32 entries (maps within 1e-2 and not equal), and
   timed beside them, in turns, with their bounds (texels read at 2 B a
   channel); at
   (64, 128) the three flat kernels timed beside the three dense ones on
   the same view (informational: the dispatch sends that pad to dense);
   then an eval frame of the state served at its training pad and a
   training step, each timed whole on the host clock (median of 20),
   the card's busy time and each ``gstex.*`` stage's host and device time
   from a ``torch.profiler`` trace, and each kernel alone beside its plain
   version and its bound; then the trained scene at pixel_num 1e5,
   re-charted at (16, 24): a training step on ``pallas3``, ``pallas2``,
   ``pallas1`` and ``pallas4`` timed the same way (the trace's
   ``pair_gather`` range and ``index_backward``, autograd's scatter-add
   through the gathers, beside the kernels), and the six pair-space
   kernels alone beside their plain versions and bounds (each backward
   kernel timed alone, its gradients' zeroing outside the window and
   reported as ``zero_ms``, the wrapper's whole call as ``call_ms``);
   then phase 8's
   shapes (a ``gstex-dtu-nvs`` state from its seed ply at (40, 80),
   re-charted, on a masked 800x600 train view): a ``pallas1`` step timed
   the same way, and on that view's per-slot copies the v1 kernels
   against their plain versions, lean and full, under phase 3's gates
   (the last tile row is partial; the forward also under the three tile
   orders, bit for bit), and alone beside their bounds;
11. the ``kernels`` line (the three bf16 entries from phase 10's (40, 80)
    pairs and phase 5f's run; texture_edit's from phase 9c; the v1
    kernels' numbers from phase 10's
    nerfstudio view, where their main path runs them; the flat eval
    kernel's ``ms_by_pad`` at (8, 8) and (40, 80), the dense forward's and
    backward's at (64, 128) and (16, 24), the dense eval kernel's at
    (64, 128), (16, 24) and (88, 88) with ``bound_ms_by_pad``, the SSIM
    kernel's
    ``ms_by_shape`` at 800x800x3 and 600x800x3), the nvidia-smi line and
    the final result.

Peak rates for the bounds are the H100 SXM data-sheet numbers: 3.35 TB/s of
HBM and 67 TFLOP/s fp32 outside the tensor cores.
"""

import copy
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
STATS = ROOT / "assets" / "trained_scene_stats.npz"
H = W = 800
PAD = (8, 8)
# the large-chart main path: this texel budget gives the trained scene an
# auto chart pad of (64, 128), which the dispatch sends to the dense tier
DENSE_PIXEL_NUM = 4e6
DENSE_PAD = (64, 128)
# few surfels, many texels each: 2000 of the trained scene's surfels at
# pixel_num 1e6 resolve to an (88, 88) pad
SUBSAMPLE = 2000
SUBSAMPLE_PAD = (88, 88)
# the pair-space main path: a texel budget whose charts the v3 and v2
# kernels take (Ch <= 40), at a pair buffer that fits the card
PAIR_PIXEL_NUM = 1e5
PAIR_PAD = (16, 24)
# the nerfstudio main path: DTU's 1600x1200 captures, trained at half size
DTU_VIEWS = 16
DTU_H, DTU_W = 600, 800
DTU_PAD = (40, 80)
V1_M_PLANES = [11, 13]   # reg and m1: the planes the depth map m enters
V1_M_TOL = 1e-6       # of their max
V1_BWD_TOL = 1e-5     # of each field group's max, against v2
# pixels whose ncontrib v3 may place one slot apart from the serial walk
PAIR_NCON_FRAC = 1e-5
TOL = 1e-4
BWD_TOL = 1e-4        # of the plain version's max abs, per field group
SCHEDULE_TOL = 1e-5   # one backward under two tile orders, per field group
FLIP_TOL = 1e-5       # texture gradient sign flips
ERR_SLICE = 1 << 28   # elements per slice of an error's temporaries (1 GB)
SSIM_LOSS_TOL = 1e-6
# of the float64 gradient's max abs: float32 roundoff alone is ~1.2e-5
SSIM_GRAD_TOL = 3e-5
FRAMES = 8
VIEWS = 8
TRAIN_STEPS = 120
# the bf16 chart stream (GStexConfig.texel_dtype="bf16"): the flat kernels'
# bf16 entries against their float32 entries on the same pairs. A texel
# rounds to bf16 by at most 2^-9 of itself, and the maps sum weights of
# at most 1 over such texels: they move, by less than this
BF16_VS_F32_TOL = 1e-2
BF16_TRAIN_STEPS = 40
BF16_NAMES = ("rasterize_eval_bf16", "rasterize_fwd_bf16",
              "rasterize_bwd_bf16")
# bytes of one texel's three channels: float32, and the bf16 table's
TEXEL_BYTES = 12
BF16_TEXEL_BYTES = 6
TEST_VIEWS = 2
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
# v1 takes the falloff as the larger of two exps: one more per response
V1_RESPONSE_FLOPS = 35
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
STAGE_KERNELS = {"eval_kernel": ("rasterize_eval_kernel",
                                 "rasterize_eval_bf16_kernel",
                                 "rasterize_dense_eval_kernel"),
                 "fwd_kernel": ("rasterize_fwd_kernel",
                                "rasterize_fwd_bf16_kernel",
                                "rasterize_dense_fwd_kernel",
                                "rasterize_v3_fwd_kernel",
                                "rasterize_v2_fwd_kernel",
                                "rasterize_v1_fwd_kernel"),
                 "ssim_kernel": ("ssim_fused_kernel",),
                 "bwd_kernel": ("rasterize_bwd_kernel",
                                "rasterize_bwd_bf16_kernel",
                                "rasterize_dense_bwd_kernel",
                                "rasterize_v3_bwd_kernel",
                                "rasterize_v2_bwd_kernel",
                                "rasterize_v1_bwd_kernel")}
FIELD_GROUPS = {"normal": [0, 1, 2], "plane": [3], "axis1": [4, 5, 6, 7],
                "axis2": [8, 9, 10, 11], "uv": [15, 19], "opacity": [20],
                "rgb": [21, 22, 23], "xy": [24, 25]}


T0 = time.perf_counter()


def plain(o):
    """A tensor as JSON takes it (the binning's counts are 0-d device
    tensors): its number, or its list."""
    if isinstance(o, torch.Tensor):
        return o.item() if o.numel() == 1 else o.tolist()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def emit(phase, **fields):
    """One JSON line; ``t`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0,
                                                  1), **fields},
                     default=plain), flush=True)


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


def graph_ms(fn, reps):
    """Mean device ms of ``fn()``'s launches, replayed from a CUDA graph
    captured after one warm-up run, so that no host work between launches
    enters the time (for a kernel shorter than its wrapper's host
    overhead)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms


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
    kernel, and ``index_backward`` the part of it in autograd's indexing
    nodes (on the pair-space tiers, the scatter-add through the gathers
    of the per-slot copies and the copy that places them)."""
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
        stages["index_backward"] = {"device_ms": sum(
            e.device_time_total for e in cpu if e.key in (
                "autograd::engine::evaluate_function: IndexBackward0",
                "autograd::engine::evaluate_function: IndexPutBackward0",
                "autograd::engine::evaluate_function: IndexCopyBackward0"))
            / 1e3 / reps}
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


def flat_tier(bf16=False):
    """How this script calls the flat pair-list kernels and their plain
    versions: each takes (inputs, grid, s_cap, ...), ``inputs`` being
    (records, gids, starts, counts, charts, cam_info). With ``bf16`` the
    kernels' bf16 chart entries, which the same wrappers launch on
    bfloat16 charts (``bf16_inputs``) and whose launches count apart."""
    from gstex_torch.ops import rasterize_bwd as rbwd
    from gstex_torch.ops import rasterize_eval as reval
    from gstex_torch.ops import rasterize_fwd as rfwd

    sfx = "_bf16" if bf16 else ""
    return SimpleNamespace(
        names=(f"rasterize_eval{sfx}", f"rasterize_fwd{sfx}",
               f"rasterize_bwd{sfx}"),
        flat=lambda i: i,
        eval=lambda i, g, s: reval.rasterize_eval(*i, g, s),
        fwd=lambda i, g, s, lean: rfwd.rasterize_fwd(*i, g, s, lean=lean),
        fwd_plain=lambda i, g, s, lean: rfwd.rasterize_fwd_reference(
            *i, g, s, lean=lean),
        bwd=lambda i, m, n, c, g, s, lean: rbwd.rasterize_bwd(
            *i, m, n, c, g, s, lean=lean),
        bwd_plain=lambda i, m, n, c, g, s, lean: rbwd.rasterize_bwd_reference(
            *i, m, n, c, g, s, lean=lean))


def dense_tier():
    """The dense-list kernels and their plain versions behind the same
    calls: ``inputs`` is (records, ids, counts, charts, cam_info), and the
    list length ``ids.shape[1]`` stands where the flat tier has s_cap.
    ``flat`` gives the same lists as flat-tier inputs, for the walk
    statistics and the bounds."""
    from gstex_torch.ops import rasterize as plain
    from gstex_torch.ops import rasterize_dense as rd

    def flat(i):
        records, ids, counts, charts, info = i
        return (records, *plain.flat_view(ids, counts), charts, info)

    return SimpleNamespace(
        names=("rasterize_dense_eval", "rasterize_dense_fwd",
               "rasterize_dense_bwd"),
        flat=flat,
        eval=lambda i, g, s: rd.rasterize_dense_eval(*i, g),
        fwd=lambda i, g, s, lean: rd.rasterize_dense_fwd(*i, g, lean=lean),
        fwd_plain=lambda i, g, s, lean: plain.forward_scan(*i, g, lean=lean),
        bwd=lambda i, m, n, c, g, s, lean: rd.rasterize_dense_bwd(
            *i, m, n, c, g, lean=lean),
        bwd_plain=lambda i, m, n, c, g, s, lean: plain.backward_walk(
            *i, m, n, c, g, lean=lean))


def pair_tier(version):
    """The v3, v2 or v1 pair-space kernels and their plain versions behind
    the same calls: ``inputs`` is (records_t, charts_g, counts, cam_info);
    the record gradients come back as ``(T·S, 32)`` rows, one per slot;
    the kernels take a tile ``order`` (their wrapper's own where none is
    given)."""
    from gstex_torch.ops import rasterize_v1, rasterize_v2, rasterize_v3

    mod = {3: rasterize_v3, 2: rasterize_v2, 1: rasterize_v1}[version]
    name = f"rasterize_v{version}"
    fwd, bwd = getattr(mod, f"{name}_fwd"), getattr(mod, f"{name}_bwd")
    fwd_ref = getattr(mod, f"{name}_fwd_reference")
    bwd_ref = getattr(mod, f"{name}_bwd_reference")

    def rows(d):
        return d[0].reshape(-1, d[0].shape[-1]), d[1]
    return SimpleNamespace(
        names=(None, f"{name}_fwd", f"{name}_bwd"),
        fwd=lambda i, g, s, lean, **order: fwd(*i, g, lean=lean, **order),
        fwd_plain=lambda i, g, s, lean: fwd_ref(*i, g, lean=lean),
        bwd=lambda i, m, n, c, g, s, lean, order=None: rows(bwd(
            *i, m, n, c, g, lean=lean, order=order)),
        bwd_plain=lambda i, m, n, c, g, s, lean: rows(bwd_ref(
            *i, m, n, c, g, lean=lean)))


def pair_copies(dframe):
    """A dense frame's inputs as the pair-space kernels take them."""
    from gstex_torch.ops.pair_inputs import pair_inputs

    records, _, _, charts, info = dframe.inputs
    return (*pair_inputs(records, charts, dframe.bins), info)


class Frame:
    """One frame of ``models.gstex.render``'s eval path, stage by stage,
    so that the kernels' inputs can be reused; on the flat lists, or with
    ``dense`` on the dense ones."""

    def __init__(self, cfg, params, buffers, cam, bg, dense=False):
        self.cfg, self.params, self.buffers = cfg, params, buffers
        self.cam, self.bg, self.dense = cam, bg, dense
        self.grid = cfg.grid(cam.height, cam.width)
        self.tier = dense_tier() if dense else flat_tier()

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
        from gstex_torch.ops import binning
        from gstex_torch.ops.cull import make_pair_cull

        prep = self.prep
        build = (binning.build_tile_bins if self.dense
                 else binning.build_tile_bins_flat)
        self.bins = build(
            prep.centers, prep.extents, prep.depths, prep.valid, self.grid,
            self.cfg.pair_cap, self.cfg.s_max,
            cull_fn=make_pair_cull(prep.geom, self.cam, self.grid))

    def records(self):
        from gstex_torch.ops.records import assemble_records, cam_info
        from gstex_torch.ops.sh import sh_to_rgb

        b = self.bins
        lists = ((b.ids, b.counts) if self.dense
                 else (b.gids, b.starts, b.counts))
        self.inputs = (
            assemble_records(self.prep.geom, self.cam.c2w[:3, 3],
                             self.buffers.texture_hw),
            *lists, sh_to_rgb(self.params.texture).contiguous(),
            cam_info(self.cam))

    def kernel(self):
        self.maps = self.tier.eval(self.inputs, self.grid, self.cfg.s_max)

    def plain(self):
        """The eval kernel's plain version (the first eight planes of the
        lean forward walk, which both tiers' eval kernels follow): its
        maps and the walk's ``WalkStats``."""
        from gstex_torch.ops.rasterize_eval import rasterize_eval_reference

        return rasterize_eval_reference(*self.tier.flat(self.inputs),
                                        self.grid, self.cfg.s_max)

    def compose(self):
        m = self.maps
        rgb = m[0:3] + m[3:6] + (1.0 - m[7]) * self.bg[:, None, None]
        self.rgb = torch.clamp(rgb, 0.0, 1.0).permute(1, 2, 0)

    STAGES = ("prepare", "cull_binning", "records", "kernel", "compose")

    def run(self):
        for stage in self.STAGES:
            getattr(self, stage)()


def active_bytes(ids, texture_hw, extra=0, texel_bytes=TEXEL_BYTES):
    """Record bytes plus active chart texel bytes (one extra row and
    column with ``extra=1``; ``texel_bytes`` a texel) of the gaussians
    ``ids``."""
    hw = texture_hw[ids].long() + extra
    return (int(ids.numel()) * 32 * 4
            + int((hw[:, 0] * hw[:, 1]).sum()) * texel_bytes)


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


def fwd_bound(inputs, texture_hw, grid, stats, lean, planes=15,
              list_arrays=2, texel_bytes=TEXEL_BYTES):
    """A forward walk over flat-tier inputs: the records and active texels
    (``texel_bytes`` each: 6 for the bf16 table) of the gaussians the
    walks read, the walked ids, the per-tile list
    arrays (starts and counts; the dense lists have counts only) and
    cam_info once, and the output planes written once (fourteen and
    ncontrib; eight for the dense eval kernel, which also blends lean);
    RESPONSE_FLOPS per response and BLEND_FLOPS (BLEND_FULL_FLOPS) per
    blend."""
    _, gids, starts, _, _, info = inputs
    ids = walked_ids(gids, starts, stats.walked)
    bytes_once = (active_bytes(ids, texture_hw, texel_bytes=texel_bytes)
                  + int(stats.walked.sum()) * 4
                  + list_arrays * starts.numel() * 4 + info.numel() * 4
                  + planes * grid.height * grid.width * 4)
    ops = (int(stats.evaluated) * RESPONSE_FLOPS + int(stats.blended)
           * (BLEND_FLOPS if lean else BLEND_FULL_FLOPS))
    return bound_of(bytes_once, ops, responses=int(stats.evaluated),
                    blends=int(stats.blended))


def walk_responses(counts, ncon, grid, s_cap):
    """The backward walk's (pixel, slot) responses: per in-image pixel,
    its ncontrib capped by its tile's walk; and the walk per tile."""
    from gstex_torch.ops.rasterize_bwd import tile_planes, walk_starts

    walk = walk_starts(counts, ncon, grid, s_cap)
    planes = tile_planes(torch.stack(
        [ncon.float(), torch.ones_like(ncon, dtype=torch.float32)]), grid)
    return int((torch.minimum(planes[0], walk[:, None].float())
                * planes[1]).sum()), walk


def walked_slots(ids, walked):
    """The gaussian of each of the first ``walked[t]`` slots of every
    tile's list, one entry per slot."""
    rank = torch.arange(ids.shape[1], device=ids.device)
    return ids[rank[None, :] < walked[:, None]].long()


def pair_bounds(pinputs, ids, texture_hw, grid, stats, ncon, lean,
                response_flops=RESPONSE_FLOPS):
    """The pair-space kernels' bounds. Operations: the dense tier's on the
    same pairs (``response_flops`` per response the walks need, v1's one
    more than the others', BLEND_FLOPS or
    BLEND_FULL_FLOPS per forward blend, BWD_FLOPS or BWD_FULL_FLOPS per
    backward pair). Bytes, what each kernel needs of pair space: per walked
    slot its own record copy and the active texels of its own chart copy
    (the backward: plus the row and column the hat weights reach), counts
    and cam_info, the forward's fifteen output planes; for the backward the
    twelve cotangents, three maps and ncontrib read and the walked slots'
    record and active texel gradients written once. The copies' full pads
    are the gather's traffic (``pair_copy_bytes``), paid in the
    ``pair_gather`` stage and its backward, not by the kernels."""
    records_t, charts_g, counts, info = pinputs
    small = counts.numel() * 4 + info.numel() * 4
    hw_px = grid.height * grid.width
    blends = int(stats.blended)
    fwd_ops = (int(stats.evaluated) * response_flops
               + blends * (BLEND_FLOPS if lean else BLEND_FULL_FLOPS))
    responses, walk = walk_responses(counts, ncon, grid, records_t.shape[1])
    bwd_ops = (responses * response_flops
               + blends * (BWD_FLOPS if lean else BWD_FULL_FLOPS))
    fwd_slots = walked_slots(ids, stats.walked)
    bwd_slots = walked_slots(ids, walk)
    fwd_bytes = (active_bytes(fwd_slots, texture_hw) + small
                 + 15 * hw_px * 4)
    bwd_bytes = (active_bytes(bwd_slots, texture_hw, extra=1)
                 + active_bytes(bwd_slots, texture_hw) + small
                 + 16 * hw_px * 4)
    slots = int(counts.sum())
    copy_bytes = slots * (records_t.shape[-1] + charts_g[0, 0].numel()) * 4
    return (bound_of(fwd_bytes, fwd_ops, slots=slots,
                     walked_slots=int(fwd_slots.numel()),
                     responses=int(stats.evaluated), blends=blends),
            bound_of(bwd_bytes, bwd_ops, slots=slots,
                     walked_slots=int(bwd_slots.numel()),
                     responses=responses, blends=blends),
            dict(pair_copy_bytes=copy_bytes,
                 pair_copy_bytes_ms=copy_bytes / HBM_BYTES_PER_S * 1e3))


def bwd_bound(inputs, texture_hw, grid, s_cap, ncon, blends, lean,
              list_arrays=2, texel_bytes=TEXEL_BYTES):
    """The backward kernel: the records and active texels (``texel_bytes``
    each; plus the row and column the hat weights reach) of the gaussians
    walked, the walked
    gids, starts and counts, three forward planes, ncontrib and the twelve
    cotangent planes read once, and the walked gaussians' record and
    active texel gradients (float32) written once; RESPONSE_FLOPS per
    (pixel, pair) below the pixel's ncontrib and BWD_FLOPS
    (BWD_FULL_FLOPS) per pair of weight > 0."""
    _, gids, starts, counts, _, info = inputs
    responses, walk = walk_responses(counts, ncon, grid, s_cap)
    ids = walked_ids(gids, starts, walk)
    hw_px = grid.height * grid.width
    bytes_once = (active_bytes(ids, texture_hw, extra=1,
                               texel_bytes=texel_bytes)
                  + active_bytes(ids, texture_hw) + int(walk.sum()) * 4
                  + list_arrays * starts.numel() * 4 + info.numel() * 4
                  + 16 * hw_px * 4)
    ops = (responses * RESPONSE_FLOPS
           + blends * (BWD_FLOPS if lean else BWD_FULL_FLOPS))
    return bound_of(bytes_once, ops, responses=responses, blends=blends)


def ssim_bound(shape):
    """The SSIM kernel: both images read once, the gradient written once;
    SSIM_FLOPS fp32 operations per pixel and channel."""
    n = shape[0] * shape[1] * shape[2]
    return bound_of(3 * n * 4 + 4, n * SSIM_FLOPS)


def cotangents(height=H, width=W, seed=0):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    g = torch.randn((12, height, width), generator=gen, device=DEVICE)
    g[6] *= 0.1
    g[8:] *= 0.1
    return g.contiguous()


def bwd_errors(d_rec, d_ch, ref_rec, ref_ch):
    """Per record-field group, and for the charts, the max abs error over
    the reference's max abs; the fraction of chart gradients above 1e-6 of
    that max whose sign flips; and the max abs error of all. The charts are
    read in slices of about ERR_SLICE elements: the pair-space chart
    gradients of the nerfstudio path's view hold 19 GB each."""
    errs = {}
    for name, fields in FIELD_GROUPS.items():
        scale = float(ref_rec[:, fields].abs().max()) + 1e-12
        errs[name] = float((d_rec[:, fields] - ref_rec[:, fields]).abs()
                           .max()) / scale
    step = max(1, ERR_SLICE // max(1, ref_ch[0].numel()))
    parts = [(d_ch[i:i + step], ref_ch[i:i + step])
             for i in range(0, ref_ch.shape[0], step)]
    scale = max(float(b.abs().max()) for _, b in parts) + 1e-12
    ch_err, flips, big_n = 0.0, 0, 0
    for a, b in parts:
        ch_err = max(ch_err, float((a - b).abs().max()))
        big = b.abs() > 1e-6 * scale
        flips += int(((torch.sign(a) != torch.sign(b)) & big).sum())
        big_n += int(big.sum())
    errs["texture"] = ch_err / scale
    abs_err = max(float((d_rec - ref_rec).abs().max()), ch_err)
    return errs, flips / max(big_n, 1), abs_err


def check_fwd_bwd(tier, inputs, grid, s_cap, lean, **where):
    """A tier's forward kernel, then its backward kernel under seeded
    cotangents, against their plain versions on one view's inputs; fails
    the run on a disagreement. Returns each kernel's max abs error and its
    plain version's ms."""
    _, fwd_name, bwd_name = tier.names
    maps, ncon = tier.fwd(inputs, grid, s_cap, lean)
    fwd_plain_ms, (ref_maps, ref_ncon) = once_ms(
        lambda: tier.fwd_plain(inputs, grid, s_cap, lean))
    err = float((maps - ref_maps).abs().max())
    same = bool(torch.equal(ncon, ref_ncon))
    emit("kernel_vs_plain", kernel=fwd_name, lean=lean, max_abs_err=err,
         tol=TOL, ncontrib_equal=same, **where)
    require(err <= TOL and same,
            f"{where}: {fwd_name} kernel and plain version differ "
            f"(lean={lean}): {err}, ncontrib equal {same}")

    g = cotangents(grid.height, grid.width)
    d_rec, d_ch = tier.bwd(inputs, maps, ncon, g, grid, s_cap, lean)
    bwd_plain_ms, (ref_rec, ref_ch) = once_ms(
        lambda: tier.bwd_plain(inputs, maps, ncon, g, grid, s_cap, lean))
    errs, flip, abs_err = bwd_errors(d_rec, d_ch, ref_rec, ref_ch)
    emit("kernel_vs_plain", kernel=bwd_name, lean=lean, max_abs_err=abs_err,
         rel_err=errs, tol=BWD_TOL, texture_flip_frac=flip,
         flip_tol=FLIP_TOL, **where)
    require(max(errs.values()) <= BWD_TOL and flip <= FLIP_TOL,
            f"{where}: {bwd_name} kernel and plain version differ "
            f"(lean={lean}): {errs}, flips {flip}")
    return {fwd_name: (err, fwd_plain_ms), bwd_name: (abs_err, bwd_plain_ms)}


def tile_orders(counts, s_max):
    """Three orders in which blocks may take the tiles: block order,
    longest first (the wrappers' own) and reversed."""
    from gstex_torch.ops.rasterize_fwd import tile_order

    first = tile_order(counts, s_max)
    return {"block": torch.arange(counts.numel(), dtype=torch.int32,
                                  device=DEVICE),
            "longest_first": first, "reversed": first.flip(0).contiguous()}


def check_eval(frame, **where):
    """A frame's eval kernel against its plain version (the first eight
    planes of the lean forward walk, which both tiers' eval kernels
    follow), bit for bit; the dense one also under the three tile orders.
    Returns the max abs error, the plain version's ms and the walk's
    statistics."""
    from gstex_torch.ops import rasterize_dense as rd

    name = frame.tier.names[0]
    maps = frame.tier.eval(frame.inputs, frame.grid, frame.cfg.s_max)
    plain_ms, (ref, stats) = once_ms(frame.plain)
    errs = {k: float((maps[sl] - ref[sl]).abs().max())
            for k, sl in MAPS.items()}
    equal = bool(torch.equal(maps, ref))
    orders = {}
    if frame.dense:
        i = frame.inputs
        orders = {k: bool(torch.equal(rd.rasterize_dense_eval(
            *i, frame.grid, order=o), ref))
            for k, o in tile_orders(i[2], i[1].shape[1]).items()}
    emit("kernel_vs_plain", kernel=name, bit_equal=equal, max_abs_err=errs,
         tol=0.0, orders_bit_equal=orders, s_max=frame.cfg.s_max,
         total_pairs=frame.bins.total_pairs, overflow=frame.bins.overflow,
         max_tile_count=int(frame.bins.counts.max()),
         alpha_coverage=float((maps[7] > 0).float().mean()), **where)
    require(frame.bins.overflow == 0, f"{where}: binning overflowed")
    require(equal and all(orders.values()),
            f"{where}: {name} and its plain version differ by "
            f"{max(errs.values())}; under the tile orders: {orders}")
    return max(errs.values()), plain_ms, stats


def check_dense_vs_flat(flat_frame, dense_frame, lean, **where):
    """The two tiers on one view's pairs: the dense kernels' maps, ncontrib
    and gradients against the flat kernels', under the gates that hold a
    kernel to its plain version."""
    flat, dense = flat_frame.tier, dense_frame.tier
    grid, s_cap = flat_frame.grid, flat_frame.cfg.s_max
    fi, di = flat_frame.inputs, dense_frame.inputs
    eval_err = float((dense.eval(di, grid, s_cap)
                      - flat.eval(fi, grid, s_cap)).abs().max())
    maps, ncon = dense.fwd(di, grid, s_cap, lean)
    fmaps, fncon = flat.fwd(fi, grid, s_cap, lean)
    fwd_err = float((maps - fmaps).abs().max())
    same = bool(torch.equal(ncon, fncon))
    g = cotangents()
    d_rec, d_ch = dense.bwd(di, maps, ncon, g, grid, s_cap, lean)
    f_rec, f_ch = flat.bwd(fi, fmaps, fncon, g, grid, s_cap, lean)
    errs, flip, _ = bwd_errors(d_rec, d_ch, f_rec, f_ch)
    emit("dense_vs_flat", lean=lean, eval_max_abs_err=eval_err,
         fwd_max_abs_err=fwd_err, ncontrib_equal=same, tol=TOL,
         bwd_rel_err=errs, bwd_tol=BWD_TOL, texture_flip_frac=flip,
         flip_tol=FLIP_TOL, **where)
    require(eval_err <= TOL and fwd_err <= TOL and same,
            f"{where}: dense and flat forward differ (lean={lean}): "
            f"{eval_err}, {fwd_err}, ncontrib equal {same}")
    require(max(errs.values()) <= BWD_TOL and flip <= FLIP_TOL,
            f"{where}: dense and flat backward differ (lean={lean}): "
            f"{errs}, flips {flip}")


def check_dense_schedules(dframe, lean, **where):
    """The dense forward and backward under three tile orders (block,
    longest first, reversed): the forward's maps and ncontrib bit-equal to
    its plain version under each (a tile order changes no pixel's
    operations); the gradients agree within the order of the atomics,
    1e-5 of each field group's max, no more than FLIP_TOL sign flips."""
    from gstex_torch.ops import rasterize_dense as rd

    tier, i, grid = dframe.tier, dframe.inputs, dframe.grid
    counts, s_max = i[2], i[1].shape[1]
    maps, ncon = tier.fwd(i, grid, s_max, lean)
    ref_maps, ref_ncon = tier.fwd_plain(i, grid, s_max, lean)
    g = cotangents(grid.height, grid.width)
    ref = tier.bwd(i, maps, ncon, g, grid, s_max, lean)
    errs, fwd_equal = {}, {}
    for name, order in tile_orders(counts, s_max).items():
        o_maps, o_ncon = rd.rasterize_dense_fwd(*i, grid, lean=lean,
                                                order=order)
        fwd_equal[name] = bool(torch.equal(o_maps, ref_maps)
                               and torch.equal(o_ncon, ref_ncon))
        got = rd.rasterize_dense_bwd(*i, maps, ncon, g, grid, lean=lean,
                                     order=order)
        e, flip, _ = bwd_errors(*got, *ref)
        errs[name] = (max(e.values()), flip)
    emit("dense_schedules", lean=lean, fwd_bit_equal_to_plain=fwd_equal,
         bwd_max_rel_err_and_flips=errs, tol=SCHEDULE_TOL,
         flip_tol=FLIP_TOL, **where)
    require(all(fwd_equal.values()),
            f"{where}: the dense forward differs from its plain version "
            f"under a tile order: {fwd_equal}")
    require(all(e <= SCHEDULE_TOL and f <= FLIP_TOL
                for e, f in errs.values()),
            f"{where}: the dense backward's tile orders disagree: {errs}")


def check_ssim(ssim_fused, pred, noisy):
    """The SSIM kernel and its float32 plain version, each against a
    float64 evaluation (they compute in float32, each with its own
    roundoff), and so to each other at twice the gradient gate. Returns
    the kernel's largest error against the plain version."""
    kernel = ssim_fused.fused_ssim_value_and_grad(pred, noisy)
    plain = ssim_fused.fused_ssim_reference(pred, noisy)
    exact = ssim_fused.fused_ssim_reference(pred.double(), noisy.double())
    scale = float(exact[1].abs().max())

    def ssim_errors(got, ref):
        grad_abs = float((got[1].double() - ref[1].double()).abs().max())
        return abs(float(got[0]) - float(ref[0])), grad_abs / scale

    errs = {"kernel_vs_float64": ssim_errors(kernel, exact),
            "plain_vs_float64": ssim_errors(plain, exact),
            "kernel_vs_plain": ssim_errors(kernel, plain)}
    emit("kernel_vs_plain", kernel="ssim_fused", shape=list(pred.shape),
         loss=float(kernel[0]), grad_max=scale,
         loss_abs_err_and_grad_rel_err=errs, loss_tol=SSIM_LOSS_TOL,
         grad_tol=SSIM_GRAD_TOL, kernel_vs_plain_grad_tol_factor=2)
    for k, (loss_err, grad_err) in errs.items():
        f = 2 if k == "kernel_vs_plain" else 1
        require(loss_err <= SSIM_LOSS_TOL and grad_err <= f * SSIM_GRAD_TOL,
                f"SSIM {k} at {list(pred.shape)}: loss {loss_err}, "
                f"gradient {grad_err}")
    return max(errs["kernel_vs_plain"][0],
               float((kernel[1] - plain[1]).abs().max()))


def check_pair_vs_dense(dframe, pinputs, tier, lean, **where):
    """A pair-space tier against the dense kernels on the same pairs: maps
    and ncontrib, and the pair-space gradients summed per gaussian against
    the dense backward's, under the gates that hold a kernel to its plain
    version; v3 may place ncontrib one slot apart at no more than
    PAIR_NCON_FRAC of the pixels, whose maps are left out."""
    dense, grid, s_cap = dframe.tier, dframe.grid, dframe.cfg.s_max
    di, name = dframe.inputs, tier.names[1][:len("rasterize_v3")]
    maps, ncon = tier.fwd(pinputs, grid, s_cap, lean)
    dmaps, dncon = dense.fwd(di, grid, s_cap, lean)
    same = ncon == dncon
    n_diff = int((~same).sum())
    fwd_err = float((maps - dmaps)[:, same].abs().max())
    g = cotangents()
    d_rec, d_ch = tier.bwd(pinputs, maps, ncon, g, grid, s_cap, lean)
    ids = dframe.bins.ids.reshape(-1).long()
    records, charts = di[0], di[3]
    d_rec = torch.zeros_like(records).index_add_(0, ids, d_rec)
    d_ch = torch.zeros_like(charts).index_add_(
        0, ids, d_ch.reshape(ids.numel(), *charts.shape[1:]))
    f_rec, f_ch = dense.bwd(di, dmaps, dncon, g, grid, s_cap, lean)
    errs, flip, _ = bwd_errors(d_rec, d_ch, f_rec, f_ch)
    allowed = 0 if name.endswith("v2") else PAIR_NCON_FRAC * same.numel()
    emit("pair_vs_dense", tier=name, lean=lean, ncontrib_diff_pixels=n_diff,
         ncontrib_diff_allowed=allowed, fwd_max_abs_err=fwd_err, tol=TOL,
         bwd_rel_err=errs, bwd_tol=BWD_TOL, texture_flip_frac=flip,
         flip_tol=FLIP_TOL, **where)
    require(n_diff <= allowed and fwd_err <= TOL,
            f"{where}: {name} and dense forward differ (lean={lean}): "
            f"{n_diff} ncontrib pixels, {fwd_err}")
    require(max(errs.values()) <= BWD_TOL and flip <= FLIP_TOL,
            f"{where}: {name} and dense backward differ (lean={lean}): "
            f"{errs}, flips {flip}")


def check_v1_vs_v2(pinputs, grid, s_cap, lean, **where):
    """The v1 kernels against the v2 kernels on the same pairs: ncontrib
    and every plane but reg and m1 bit for bit, those two within V1_M_TOL
    of their max (v1 computes the distortion depth m by a divide, v2 by a
    reciprocal and a multiply); the pair-space gradients within V1_BWD_TOL
    of each field group's max, no texture sign flips."""
    v1, v2 = pair_tier(1), pair_tier(2)
    maps1, ncon1 = v1.fwd(pinputs, grid, s_cap, lean)
    maps2, ncon2 = v2.fwd(pinputs, grid, s_cap, lean)
    rest = [c for c in range(maps2.shape[0]) if c not in V1_M_PLANES]
    same_ncon = bool(torch.equal(ncon1, ncon2))
    rest_equal = bool(torch.equal(maps1[rest], maps2[rest]))
    m_scale = float(maps2[V1_M_PLANES].abs().max())
    m_err = float((maps1[V1_M_PLANES] - maps2[V1_M_PLANES]).abs().max())
    g = cotangents()
    d1 = v1.bwd(pinputs, maps1, ncon1, g, grid, s_cap, lean)
    d2 = v2.bwd(pinputs, maps2, ncon2, g, grid, s_cap, lean)
    errs, flip, _ = bwd_errors(*d1, *d2)
    emit("v1_vs_v2", lean=lean, ncontrib_equal=same_ncon,
         other_planes_equal=rest_equal, m_planes_max_abs_err=m_err,
         m_planes_max=m_scale, m_tol=V1_M_TOL, bwd_rel_err=errs,
         bwd_tol=V1_BWD_TOL, texture_flip_frac=flip, **where)
    require(same_ncon and rest_equal and m_err <= V1_M_TOL * m_scale,
            f"{where}: v1 and v2 forward differ (lean={lean}): ncontrib "
            f"equal {same_ncon}, other planes equal {rest_equal}, reg/m1 "
            f"{m_err} of {m_scale}")
    require(max(errs.values()) <= V1_BWD_TOL and flip == 0.0,
            f"{where}: v1 and v2 backward differ (lean={lean}): {errs}, "
            f"flips {flip}")


def check_orders(version, pinputs, grid, s_cap, lean, **where):
    """A pair-space backward under the three tile orders against its own
    order's gradients: within SCHEDULE_TOL of each field group's max, no
    more than FLIP_TOL sign flips (the texel atomics add in no fixed
    order)."""
    tier = pair_tier(version)
    maps, ncon = tier.fwd(pinputs, grid, s_cap, lean)
    g = cotangents(grid.height, grid.width)
    ref = tier.bwd(pinputs, maps, ncon, g, grid, s_cap, lean)
    errs = {}
    for name, order in tile_orders(pinputs[2],
                                   pinputs[0].shape[1]).items():
        e, flip, _ = bwd_errors(*tier.bwd(pinputs, maps, ncon, g, grid,
                                          s_cap, lean, order=order), *ref)
        errs[name] = (max(e.values()), flip)
    emit("pair_bwd_schedules", kernel=tier.names[2], lean=lean,
         bwd_max_rel_err_and_flips=errs, tol=SCHEDULE_TOL,
         flip_tol=FLIP_TOL, **where)
    require(all(e <= SCHEDULE_TOL and f <= FLIP_TOL
                for e, f in errs.values()),
            f"{where}: the {tier.names[2]} tile orders disagree: {errs}")


def check_fwd_orders(version, pinputs, grid, s_cap, lean, **where):
    """A pair-space forward under the three tile orders: under each, its
    maps and ncontrib bit-equal to its own order's (a tile order changes
    no pixel's operations), and its ncontrib and t_final (v2 and v1: every
    plane) bit-equal to its plain version's."""
    tier = pair_tier(version)
    ref_maps, ref_ncon = tier.fwd_plain(pinputs, grid, s_cap, lean)
    own_maps, own_ncon = tier.fwd(pinputs, grid, s_cap, lean)
    equal = {}
    for name, order in tile_orders(pinputs[2],
                                   pinputs[0].shape[1]).items():
        maps, ncon = tier.fwd(pinputs, grid, s_cap, lean, order=order)
        equal[name] = dict(
            own_order=bool(torch.equal(maps, own_maps)
                           and torch.equal(ncon, own_ncon)),
            plain_ncontrib=bool(torch.equal(ncon, ref_ncon)),
            plain_t_final=bool(torch.equal(maps[12], ref_maps[12])),
            plain_maps=bool(torch.equal(maps, ref_maps)))
    emit("pair_fwd_schedules", kernel=tier.names[1], lean=lean,
         bit_equal=equal, **where)
    gate = ("own_order", "plain_ncontrib",
            "plain_t_final" if version == 3 else "plain_maps")
    require(all(e[k] for e in equal.values() for k in gate),
            f"{where}: the {tier.names[1]} tile orders are not bit-equal: "
            f"{equal}")


def check_pairs(dframe, note, **where):
    """The pair-space tiers on a dense frame's lists: each kernel against
    its plain version, lean and full; v3 and v2 against the dense kernels,
    v1 against v2; each forward and backward under three tile orders.
    Returns each kernel's plain ms in lean mode."""
    pinputs = pair_copies(dframe)
    emit("pair_buffer", pair_bytes=sum(x.numel() * x.element_size()
                                       for x in pinputs[:2]),
         slots=int(pinputs[2].sum()), s_max=dframe.cfg.s_max, **where)
    plain_ms = {}
    for version in (3, 2, 1):
        tier = pair_tier(version)
        for lean in (True, False):
            checks = check_fwd_bwd(tier, pinputs, dframe.grid,
                                   dframe.cfg.s_max, lean, **where)
            note(checks)
            if lean:
                plain_ms.update({k: v[1] for k, v in checks.items()})
            if version == 1:
                check_v1_vs_v2(pinputs, dframe.grid, dframe.cfg.s_max, lean,
                               **where)
            else:
                check_pair_vs_dense(dframe, pinputs, tier, lean, **where)
            check_orders(version, pinputs, dframe.grid, dframe.cfg.s_max,
                         lean, **where)
            check_fwd_orders(version, pinputs, dframe.grid,
                             dframe.cfg.s_max, lean, **where)
    return plain_ms


def time_kernels(frame, lean, **where):
    """CUDA-event ms of a frame's three kernels alone on its inputs, so
    that the two tiers can be read side by side on one view's pairs."""
    tier, i, grid, s_cap = frame.tier, frame.inputs, frame.grid, \
        frame.cfg.s_max
    maps, ncon = tier.fwd(i, grid, s_cap, lean)
    g = cotangents()
    ms = {
        tier.names[0]: cuda_ms(lambda: tier.eval(i, grid, s_cap), 20),
        tier.names[1]: cuda_ms(lambda: tier.fwd(i, grid, s_cap, lean), 20),
        tier.names[2]: cuda_ms(lambda: tier.bwd(i, maps, ncon, g, grid, s_cap,
                                                lean), 20)}
    emit("timing", **{**where, "path": "kernels"}, lean=lean, kernel_ms=ms)
    return ms


def bf16_inputs(inputs):
    """Flat-tier inputs with the charts rounded to bf16, as the flat
    path's table is (``rasterize_api._table``)."""
    records, gids, starts, counts, charts, info = inputs
    return (records, gids, starts, counts,
            charts.to(torch.bfloat16).contiguous(), info)


def bf16_kernel_checks(frame, stats, lean, note, smi, **where):
    """Phase 10's bf16 chart stream on a flat frame's pairs (the trained
    scene at (40, 80)): each flat kernel's bf16 entry against its plain
    version on the same bf16 charts under the float32 rows' gates (eval
    bit for bit; forward, lean and full, 1e-4 and ncontrib equal;
    backward 1e-4 of each field group's max), its chart gradient float32;
    against the float32 entries on the float32 charts (maps within
    BF16_VS_F32_TOL and not equal); each timed beside its float32 entry,
    in turns (float32, bf16, bf16, float32), in mode ``lean``; and its
    bound, the operations the float32 entry's and the texels read at 2 B
    a channel. Returns, per bf16 entry, its ms, plain ms and bound, and
    the float32 entry's ms."""
    tier32, tier16 = frame.tier, flat_tier(bf16=True)
    grid, s_cap = frame.grid, frame.cfg.s_max
    i32 = frame.inputs
    i16 = bf16_inputs(i32)
    f16 = copy.copy(frame)
    f16.tier, f16.inputs = tier16, i16
    eval16, fwd16, bwd16 = tier16.names
    with torch.no_grad():
        err, eval_plain_ms, _ = check_eval(f16, **where)
    note({eval16: (err, eval_plain_ms)})
    checks = {mode: check_fwd_bwd(tier16, i16, grid, s_cap, mode, **where)
              for mode in (True, False)}
    for c in checks.values():
        note(c)

    g = cotangents(grid.height, grid.width)
    runs = []
    for tier, i in ((tier32, i32), (tier16, i16)):
        maps, ncon = tier.fwd(i, grid, s_cap, lean)
        runs.append((tier.eval(i, grid, s_cap), maps, ncon,
                     tier.bwd(i, maps, ncon, g, grid, s_cap, lean)))
    (e32, m32, n32, d32), (e16, m16, n16, d16) = runs
    diffs = {eval16: float((e16 - e32).abs().max()),
             fwd16: float((m16 - m32).abs().max())}
    bwd_rel, _, _ = bwd_errors(*d16, *d32)
    emit("bf16_vs_f32", lean=lean, max_abs_diff=diffs, tol=BF16_VS_F32_TOL,
         ncontrib_equal=bool(torch.equal(n16, n32)),
         bwd_rel_diff=bwd_rel, chart_grad_dtype=str(d16[1].dtype), **where)
    require(all(0.0 < d <= BF16_VS_F32_TOL for d in diffs.values()),
            f"{where}: the bf16 entries' maps against the float32 ones: "
            f"{diffs} (within {BF16_VS_F32_TOL}, and not equal)")
    require(d16[1].dtype == torch.float32,
            f"{where}: the bf16 backward's chart gradient is {d16[1].dtype}")

    ms = {n: [] for n in tier32.names + tier16.names}
    for tier, i in ((tier32, i32), (tier16, i16), (tier16, i16),
                    (tier32, i32)):
        maps, ncon = tier.fwd(i, grid, s_cap, lean)
        ms[tier.names[0]].append(cuda_ms(lambda: tier.eval(i, grid, s_cap),
                                         50))
        ms[tier.names[1]].append(cuda_ms(
            lambda: tier.fwd(i, grid, s_cap, lean), 20))
        ms[tier.names[2]].append(cuda_ms(
            lambda: tier.bwd(i, maps, ncon, g, grid, s_cap, lean), 20))
    ms = {k: statistics.mean(v) for k, v in ms.items()}
    tex_hw = frame.buffers.texture_hw
    blends = int(stats.blended)
    bounds = {
        eval16: fwd_bound(i16, tex_hw, grid, stats, True, planes=8,
                          texel_bytes=BF16_TEXEL_BYTES),
        fwd16: fwd_bound(i16, tex_hw, grid, stats, lean,
                         texel_bytes=BF16_TEXEL_BYTES),
        bwd16: bwd_bound(i16, tex_hw, grid, s_cap, n16, blends, lean,
                         texel_bytes=BF16_TEXEL_BYTES)}
    res = {
        n16_: dict(ms=ms[n16_], f32_ms=ms[n32_],
                   plain_ms=(eval_plain_ms if n16_ == eval16
                             else checks[lean][n16_][1]),
                   **bounds[n16_])
        for n32_, n16_ in zip(tier32.names, tier16.names)}
    emit("timing", **{**where, "path": "bf16_kernels"}, card=smi, lean=lean,
         kernels=res)
    return res


def bf16_main_path(train_cli, render_cli, data, root, counters):
    """Phase 5f: ``gstex_torch.scripts.train gstex-blender-nvs --set
    model.texel_dtype=bf16`` for BF16_TRAIN_STEPS steps from phase 5's init
    on phase 5's dataset, through the captured chunk: each flat kernel's
    bf16 forward and backward entries launched once a step, the float32
    flat entries never, the closing eval on the bf16 eval entry, the loss
    finite and falling, ``texel_dtype`` in the run's ``config.json``; then
    one ``render spiral --load-config`` frame of the run, one launch of
    the bf16 eval entry. ``counters`` are the three flat kernels' six
    entries. Returns the run's launches by entry."""
    from gstex_torch.train import step as train_step

    for fn in counters:
        fn.launches = 0
    train_step.TrainScan.captures = train_step.TrainScan.replays = 0
    run = root / "run_bf16"
    t0 = time.perf_counter()
    with CaptureRecorder("phase 5f") as recorder:
        res = train_cli.main([
            "gstex-blender-nvs", "--data", str(data), "--scene-npz",
            str(STATS), "--seed", "1", "--max-num-iterations",
            str(BF16_TRAIN_STEPS), "--set", "model.texel_dtype=bf16",
            "--output-dir", str(run)])
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    scan_runs = dict(captures=train_step.TrainScan.captures,
                     replays=train_step.TrainScan.replays,
                     graphs=recorder.graphs)
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    first, last = (statistics.mean(losses[:10]),
                   statistics.mean(losses[-10:]))
    run_cfg = json.loads((run / "config.json").read_text())
    emit("main_path", path="train_bf16", steps=len(hist), seconds=seconds,
         launches=launches, texel_dtype=run_cfg["model"]["texel_dtype"],
         chart_pad=run_cfg["model"]["chart_pad"], first10_loss=first,
         last10_loss=last, losses=[round(x, 6) for x in losses[::5]],
         psnr_first=hist[0]["psnr"], psnr_last=hist[-1]["psnr"],
         eval=res["eval"], **scan_runs)
    require(run_cfg["model"]["texel_dtype"] == "bf16",
            f"the bf16 run's config.json says {run_cfg['model']}")
    require(len(hist) == BF16_TRAIN_STEPS, f"{len(hist)} bf16 steps ran")
    require(launches["rasterize_fwd_bf16"] == BF16_TRAIN_STEPS
            and launches["rasterize_bwd_bf16"] == BF16_TRAIN_STEPS
            and launches["rasterize_eval_bf16"] >= 1
            and all(launches[k] == 0 for k in ("rasterize_eval",
                                                "rasterize_fwd",
                                                "rasterize_bwd")),
            f"the bf16 run launched {launches} for {BF16_TRAIN_STEPS} steps")
    require(scan_runs["captures"] == 1 == len(recorder.graphs)
            and scan_runs["replays"] >= BF16_TRAIN_STEPS // 2,
            f"the bf16 run did not go through the captured scan: "
            f"{scan_runs}")
    require(all(h["overflow"] == 0 for h in hist), "a bf16 step overflowed")
    require(all(np.isfinite(x) for x in losses), "a bf16 loss is not finite")
    require(last < first, f"the bf16 loss did not fall: {first} -> {last}")

    for fn in counters:
        fn.launches = 0
    with tempfile.TemporaryDirectory() as out, torch.no_grad():
        summary = render_cli.main(["spiral", "--load-config", str(run),
                                   "--frames", "1", "--output-path", out])
        pngs = len(list(Path(out).glob("frame_*.png")))
    served = {fn.__name__: fn.launches for fn in counters}
    emit("main_path", path="serve_bf16", launches=served, summary=summary)
    require(served == {k: int(k == "rasterize_eval_bf16") for k in served},
            f"render --load-config of the bf16 run launched {served}")
    require(pngs == 1 and summary[0]["finite"]
            and summary[0]["alpha_coverage"] > 0,
            f"the bf16 run's frame: {summary}")
    return launches


# phase 9e: LPIPS on the eval images' size and DBSCAN on the trained
# scene. LPIPS on the card against the same function on the CPU (float32
# convolutions in another order), and DBSCAN's W2 distances on the card
# against the CPU's, of their max
LPIPS_CPU_TOL = 1e-4
W2_CPU_TOL = 1e-5
DBSCAN_SURFELS = 5000


def tools_main_path(run_dir, pred, noisy, smi):
    """Phase 9e. LPIPS (``utils/lpips.py``) with seeded random weights of
    the AlexNet shapes on an 800x800 render and a noisy copy: finite and
    positive, zero for identical images, within LPIPS_CPU_TOL of the CPU's
    value, reported by ``utils/metrics.image_metrics`` under
    ``GSTEX_LPIPS_NPZ``, timed. DBSCAN (``tools/dbscan.py``) on
    DBSCAN_SURFELS surfels of phase 5's trained run: ``pairwise_w2`` of
    256 rows against the CPU's (within W2_CPU_TOL of the max), the whole
    (N, N) matrix, ``estimate_eps`` and ``DBSCAN.fit`` timed, the
    clusters found."""
    from gstex_torch.tools import dbscan
    from gstex_torch.utils import lpips as lpips_mod
    from gstex_torch.utils import metrics

    rng = np.random.default_rng(0)
    weights = {}
    for i, (c, k, *_) in enumerate(lpips_mod._ALEX_CFG):
        c_in = 3 if i == 0 else lpips_mod.CHANNELS[i - 1]
        weights[f"conv{i}_w"] = (0.05 * rng.standard_normal(
            (c, c_in, k, k))).astype(np.float32)
        weights[f"conv{i}_b"] = (0.1 * rng.standard_normal(c)).astype(
            np.float32)
        weights[f"lin{i}_w"] = np.abs(0.01 * rng.standard_normal(c)).astype(
            np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "lpips_alex.npz"
        np.savez(path, **weights)
        metric = lpips_mod.load(path)
        value = metric(pred, noisy)
        same = metric(pred, pred)
        cpu = metric(pred.cpu(), noisy.cpu())
        lpips_ms = cuda_ms(lambda: metric(pred, noisy), 10)
        os.environ["GSTEX_LPIPS_NPZ"] = str(path)
        try:
            reported = metrics.image_metrics(pred, noisy)["lpips"]
        finally:
            del os.environ["GSTEX_LPIPS_NPZ"]
    emit("main_path", path="lpips", card=smi, shape=list(pred.shape),
         lpips=value, identical=same, cpu=cpu, reported=reported,
         ms=lpips_ms, tol=LPIPS_CPU_TOL)
    require(np.isfinite(value) and value > 0 and abs(same) <= 1e-6
            and abs(value - cpu) <= LPIPS_CPU_TOL * abs(cpu)
            and reported is not None and reported > 0,
            f"LPIPS on the card: {value} (identical {same}, CPU {cpu}, "
            f"reported {reported})")

    ck = sorted((run_dir / "checkpoints").glob("step-*.ckpt.pt"))[-1]
    p = torch.load(ck, map_location=DEVICE, weights_only=True)["params"]
    keep = torch.randperm(p["means"].shape[0], generator=torch.Generator(
    ).manual_seed(0))[:DBSCAN_SURFELS].to(DEVICE)
    means, log_scales, quats = (p[k][keep].contiguous() for k in (
        "means", "log_scales", "quats"))
    rows = np.arange(256)
    d_card = dbscan.pairwise_w2(means, log_scales, quats, query_idx=rows)
    d_cpu = dbscan.pairwise_w2(means.cpu(), log_scales.cpu(), quats.cpu(),
                               query_idx=rows, device="cpu")
    w2_err = float(np.abs(d_card - d_cpu).max() / np.abs(d_cpu).max())
    t0 = time.perf_counter()
    full = dbscan.pairwise_w2(means, log_scales, quats)
    w2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eps = dbscan.estimate_eps(means, log_scales, quats)
    eps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = dbscan.DBSCAN(eps=eps, min_pts=5).fit(means, log_scales, quats)
    fit_s = time.perf_counter() - t0
    stats = dbscan.DBSCAN.cluster_stats(labels)
    emit("main_path", path="dbscan", card=smi, surfels=DBSCAN_SURFELS,
         w2_rel_err_vs_cpu=w2_err, tol=W2_CPU_TOL, pairwise_w2_s=w2_s,
         estimate_eps_s=eps_s, fit_s=fit_s, eps=eps,
         num_clusters=stats["num_clusters"], num_noise=stats["num_noise"],
         largest=max(stats["sizes"].values(), default=0))
    require(w2_err <= W2_CPU_TOL and full.shape == (DBSCAN_SURFELS,) * 2
            and np.isfinite(full).all() and np.isfinite(eps) and eps > 0
            and stats["num_clusters"] >= 1
            and labels.shape == (DBSCAN_SURFELS,),
            f"DBSCAN on the card: W2 against the CPU {w2_err}, eps {eps}, "
            f"{stats['num_clusters']} clusters")
    return dict(lpips_ms=lpips_ms, pairwise_w2_s=w2_s, fit_s=fit_s)


def recharted_state(cfg, optim, params, buffers, cam):
    """A training state of ``params`` with the caps ``cam``'s view
    demands, at step STEP and re-charted: at a scene-sized pad its active
    charts grow past the init's 8x8. Returns the config with the caps and
    the state."""
    from gstex_torch.scripts import render as render_cli
    from gstex_torch.train import step as train_step

    with torch.no_grad():
        pair_cap, s_cap = render_cli.demand_caps(cfg, params, buffers, [cam],
                                                 STEP)
    cfg = dataclasses.replace(cfg, pair_cap=pair_cap, s_max=s_cap)
    state = train_step.init_state(cfg, optim, params, buffers, seed=0)
    state.step = STEP
    train_step.rechart_step(cfg, state)
    return cfg, state


def step_timing(step, counters, pixels):
    """A training step timed whole on the host clock (median of 20, after a
    warm-up) and traced over 5 more; the launches of ``counters`` per step
    and the peak memory of those runs."""
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, lo, hi = host_ms(step)
    per_step = {fn.__name__: fn.launches / 21 for fn in counters}
    busy_ms, top, trace = device_ms(step, 5)
    return dict(step_ms=step_ms, step_ms_min=lo, step_ms_max=hi,
                trace_stage_ms=trace, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / step_ms, device_top_ms=top,
                mpix_per_s=pixels / step_ms / 1e3, launches_per_step=per_step,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def pair_frame(cfg, params, buffers, cam):
    """One view's dense lists as a training step makes them, the walk's
    statistics, and the per-slot copies the pair-space kernels take."""
    with torch.no_grad():
        frame = Frame(cfg, params, buffers, cam, None, dense=True)
        for stage in ("prepare", "cull_binning", "records"):
            getattr(frame, stage)()
        _, stats = frame.plain()
        return frame, stats, pair_copies(frame)


def pair_bwd_alone(version, p_in, maps, ncon, g, grid, lean, reps=20):
    """A pair-space backward kernel alone: CUDA events around its launches
    only (mean of ``reps``), its record and ``(T, S, Ch, Cw, 3)`` chart
    gradients allocated and zeroed outside the window (the kernel adds
    into them, which does not change its time); and the zeroing's own
    ms. Launched through ``pair_inputs``' launcher, not the wrapper, so
    no count moves."""
    from gstex_torch.ops import pair_inputs as pin
    from gstex_torch.ops.rasterize_fwd import tile_order

    records_t, charts_g, counts, info = p_in
    order = tile_order(counts, records_t.shape[1])
    d_rec, d_ch = torch.zeros_like(records_t), torch.zeros_like(charts_g)
    ptrs = (records_t, charts_g, counts, info, maps, ncon, g, d_rec, d_ch,
            order)
    name = f"rasterize_v{version}_bwd"
    ms = cuda_ms(lambda: pin._launch(
        name, len(ptrs), ptrs, (*pin._geometry(grid, charts_g), int(lean)),
        records_t.device), reps)
    zero_ms = cuda_ms(lambda: (d_rec.zero_(), d_ch.zero_()), reps)
    return ms, zero_ms


def time_pair_kernels(versions, p_in, frame, stats, lean, plain_ms):
    """Each pair-space kernel of ``versions`` alone on a view's per-slot
    copies (CUDA events, mean of 20) beside its plain version's ms and its
    bound: the forward's call, the backward's kernel alone
    (``pair_bwd_alone``), with its gradients' zeroing as ``zero_ms`` and
    the wrapper's whole call as ``call_ms``; and the copies' full-pad
    bytes."""
    grid, s_cap = frame.grid, frame.cfg.s_max
    g = cotangents(grid.height, grid.width)
    out = {}
    for version in versions:
        tier = pair_tier(version)
        _, fwd_name, bwd_name = tier.names
        maps, ncon = tier.fwd(p_in, grid, s_cap, lean)
        fwd_b, bwd_b, copies = pair_bounds(
            p_in, frame.bins.ids, frame.buffers.texture_hw, grid, stats, ncon,
            lean, V1_RESPONSE_FLOPS if version == 1 else RESPONSE_FLOPS)
        out[fwd_name] = dict(
            ms=cuda_ms(lambda: tier.fwd(p_in, grid, s_cap, lean), 20),
            plain_ms=plain_ms[fwd_name], **fwd_b)
        call_ms = cuda_ms(lambda: tier.bwd(p_in, maps, ncon, g, grid, s_cap,
                                           lean), 20)
        torch.cuda.empty_cache()
        ms, zero_ms = pair_bwd_alone(version, p_in, maps, ncon, g, grid, lean)
        out[bwd_name] = dict(ms=ms, zero_ms=zero_ms, call_ms=call_ms,
                             plain_ms=plain_ms[bwd_name], **bwd_b)
    return out, copies


def dtu_main_path(root, counters):
    """Phase 8: write a DTU-like nerfstudio capture from the trained scene
    and train ``gstex-dtu-nvs --renderer pallas1`` on it from its seed ply,
    through the CLI a user calls; fails the run unless the v1 kernels took
    every step. Returns the launch counts of ``counters``."""
    from gstex_torch.data.synthetic import write_nerfstudio_dataset
    from gstex_torch.models import gstex as model
    from gstex_torch.models import init_io
    from gstex_torch.ops import rasterize_api
    from gstex_torch.scripts import train as train_cli

    cfg = model.GStexConfig(renderer="pallas", chart_pad=PAD,
                            pair_cap=1 << 21, s_max=2048,
                            background_color="black")
    params, buffers = init_io.params_from_scene_stats(cfg, STATS, seed=0,
                                                      device=DEVICE)
    # texels 5x the loader's fills: the seed ply carries the surfels'
    # geometry and dc colour, not their texture
    params = params._replace(texture=GT_TEXEL_SCALE * params.texture)
    t0 = time.perf_counter()
    paths = write_nerfstudio_dataset(root / "dtu", cfg, params, buffers,
                                     DTU_VIEWS, DTU_H, DTU_W)
    write_s = time.perf_counter() - t0
    del params, buffers
    torch.cuda.empty_cache()

    real_gather = rasterize_api.pair_inputs
    gathered = []

    def gather(records, texture, bins, *cap):
        out = real_gather(records, texture, bins, *cap)
        gathered.append(sum(x.numel() * x.element_size() for x in out[:2]))
        return out
    rasterize_api.pair_inputs = gather
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        res = train_cli.main([
            "gstex-dtu-nvs", "--data", str(root / "dtu"), "--init-ply",
            str(paths["init_ply"]), "--renderer", "pallas1",
            "--max-num-iterations", str(TRAIN_STEPS), "--output-dir",
            str(root / "run_dtu")])
    finally:
        rasterize_api.pair_inputs = real_gather
    run_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    run_cfg = json.loads((root / "run_dtu" / "config.json").read_text())
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    first, last = (statistics.mean(losses[:10]),
                   statistics.mean(losses[-10:]))
    n_eval = (DTU_VIEWS + 7) // 8      # every 8th view, from the first
    num_tiles = -(-DTU_H // 32) * -(-DTU_W // 32)
    emit("main_path", path="train_dtu_pallas1", steps=len(hist),
         dataset_seconds=write_s, seconds=run_s, launches=launches,
         image_hw=[DTU_H, DTU_W], views=DTU_VIEWS, eval_views=n_eval,
         chart_pad=run_cfg["model"]["chart_pad"],
         renderer=run_cfg["model"]["renderer"],
         num_gaussians=run_cfg["num_gaussians"],
         # the demand-sized list length, from the pair buffer's size
         s_max=max(gathered) // (4 * num_tiles * (
             32 + 3 * DTU_PAD[0] * DTU_PAD[1])),
         first10_loss=first, last10_loss=last,
         losses=[round(x, 6) for x in losses[::10]],
         psnr_first=hist[0]["psnr"], psnr_last=hist[-1]["psnr"],
         max_overflow=max(h["overflow"] for h in hist),
         max_total_pairs=max(h["total_pairs"] for h in hist),
         pair_buffer_bytes=max(gathered),
         pair_buffer_with_grad_bytes=2 * max(gathered),
         gathers=len(gathered), eval=res["eval"],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         checkpoint=Path(res["checkpoint"]).name)
    require(tuple(run_cfg["model"]["chart_pad"]) == DTU_PAD,
            f"dtu: the run's chart pad is {run_cfg['model']['chart_pad']}, "
            f"not {DTU_PAD}")
    require(len(hist) == TRAIN_STEPS, f"dtu: {len(hist)} steps")
    own = ("rasterize_v1_fwd", "rasterize_v1_bwd",
           "fused_ssim_value_and_grad")
    require(all(launches[k] == TRAIN_STEPS for k in own),
            f"dtu: kernels launched {launches} for {TRAIN_STEPS} steps")
    require(all(v == 0 for k, v in launches.items()
                if k not in own and k != "rasterize_dense_eval"),
            f"dtu: other training kernels ran: {launches}")
    # the step-0 eval image; the closing pass: a warm-up, each view
    require(launches["rasterize_dense_eval"] == 2 + n_eval,
            f"dtu: the dense eval kernel launched "
            f"{launches['rasterize_dense_eval']} times, not {2 + n_eval}")
    require(len(gathered) == TRAIN_STEPS, f"dtu: {len(gathered)} gathers")
    require(all(h["overflow"] == 0 for h in hist), "dtu: a step overflowed")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            "dtu: a loss is not finite")
    require(last < first, f"dtu: the loss did not fall: {first} -> {last}")
    require(res["eval"] is not None and res["eval"]["psnr"] > 10,
            f"dtu: the eval pass read {res['eval']}")
    require(Path(res["checkpoint"]).exists(), "dtu: no checkpoint")
    return launches


# the JSON that gstex-eval prints, and its results' keys
EVAL_SCHEMA = {"experiment_name", "method_name", "checkpoint", "results"}
EVAL_RESULTS = {"psnr", "ssim", "lpips", "psnr_std", "ssim_std", "fps",
                "num_rays_per_sec", "gaussian_count", "texel_count",
                "pixel_scale"}
SERVE_FRAMES = 4


def serve_main_path(root, counters, eval_kernel, views, data=None):
    """Phase 9 on one trained run ``root``: ``gstex_torch.scripts.eval
    --load-config`` (JAX's schema, a finite PSNR, one ``eval_kernel``
    launch per eval view and one for the warm-up), ``render
    --load-config`` (one launch a frame) in its ``dataset`` and
    ``interpolate`` modes and ``export`` in its three kinds; with the
    run's Blender ``data``, also the ``spiral`` and ``camera-path`` modes
    and the gstex-npz export rendered through ``--scene-npz`` on the same
    cameras bit-equal to the run's own frames. ``counters`` are zeroed before
    each command and every other one must stay at zero."""
    from gstex_torch.data.synthetic import orbit_c2w
    from gstex_torch.scripts import eval as eval_cli
    from gstex_torch.scripts import export as export_cli
    from gstex_torch.scripts import render as render_cli

    def run(name, fn, args, launches):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        out = fn(args)
        seconds = time.perf_counter() - t0
        got = {c.__name__: c.launches for c in counters}
        want = {k: (launches if k == eval_kernel.__name__ else 0)
                for k in got}
        require(got == want, f"{root.name}: {name} launched {got}, not "
                             f"{want}")
        return out, seconds
    res, eval_s = run("eval", eval_cli.main, [
        "--load-config", str(root / "config.json"), "--output-path",
        str(root / "eval_cli.json")], views + 1)
    results = res["results"]
    emit("main_path", path="serve_eval", run=root.name, seconds=eval_s,
         eval_launches=views + 1, **res)
    require(set(res) == EVAL_SCHEMA and set(results) == EVAL_RESULTS,
            f"{root.name}: eval printed {sorted(res)}, {sorted(results)}")
    require(np.isfinite(results["psnr"]) and results["psnr"] > 10,
            f"{root.name}: eval PSNR {results['psnr']}")
    frames = {}
    path_json = root / "camera_path.json"
    path_json.write_text(json.dumps({
        "render_height": H, "render_width": W,
        "camera_path": [{"camera_to_world": np.concatenate(
            [orbit_c2w(3.8, az), [[0, 0, 0, 1]]]).reshape(-1).tolist(),
            "fov": 45.0} for az in (0.3, 1.3)]}))
    modes = {"dataset": views, "interpolate": SERVE_FRAMES}
    if data is not None:
        # orbits about the origin see the Blender scene, which sits there;
        # the nerfstudio parser moves a capture's world to its cameras'
        modes.update({"spiral": SERVE_FRAMES, "camera-path": 2})
    for mode, n in modes.items():
        out_dir = root / f"frames_{mode}"
        summary, sec = run(f"render {mode}", render_cli.main, [
            mode, "--load-config", str(root), "--frames", str(n),
            "--camera-path-filename", str(path_json), "--output-path",
            str(out_dir)], n)
        pngs = sorted(out_dir.glob("frame_*.png"))
        frames[mode] = dict(frames=len(summary), pngs=len(pngs), seconds=sec)
        require(len(pngs) == n and all(
            f["finite"] and f["alpha_coverage"] > 0 and f["overflow"] == 0
            for f in summary), f"{root.name}: render {mode}: {summary}")
    exports = {}
    for kind in export_cli.WRITERS:
        path = root / f"export.{kind}" if kind != "gstex-npz" else (
            root / "export.npz")
        _, sec = run(f"export {kind}", export_cli.main, [
            kind, "--load-config", str(root), "--output-path", str(path)], 0)
        exports[kind] = dict(bytes=path.stat().st_size, seconds=sec)
    if data is None:
        emit("main_path", path="serve_render_export", run=root.name,
             render=frames, exports=exports)
        return results
    cfg = json.loads((root / "config.json").read_text())["model"]
    npz_dir = root / "frames_export"
    run("render the export", render_cli.main, [
        "dataset", "--scene-npz", str(root / "export.npz"), "--data",
        str(data), "--renderer", cfg["renderer"], "--background-color",
        cfg["background_color"], "--output-path", str(npz_dir)], views)
    own = sorted((root / "frames_dataset").glob("frame_*.png"))
    from_npz = sorted(npz_dir.glob("frame_*.png"))
    same = [a.read_bytes() == b.read_bytes() for a, b in zip(own, from_npz)]
    emit("main_path", path="serve_render_export", run=root.name,
         render=frames, exports=exports, export_frames_bit_equal=same)
    require(len(same) == views and all(same),
            f"{root.name}: the export's frames differ from the run's: "
            f"{same}")
    return results


def dtu_step_timing(root, counters, smi, note):
    """Phase 9 at the nerfstudio main path's shapes: a ``gstex-dtu-nvs``
    state from phase 8's seed ply at its auto pad (40, 80), re-charted, on
    the v1 tier: a training step on a train view with its mask, timed
    whole and traced by stage; then on that view's per-slot copies the v1
    kernels against their plain versions, lean and full, under phase 3's
    gates (at 800x600 the bottom row of tiles is partial; the backward
    under one tile order, as three more backwards' gradients would not fit
    beside the copies, the forward under three, bit for bit), and alone
    beside their bounds. Returns the kernels' timings."""
    from gstex_torch.configs.methods import get_method
    from gstex_torch.data.manager import FullImageCache
    from gstex_torch.data.nerfstudio_parser import parse_nerfstudio
    from gstex_torch.models import gstex as model
    from gstex_torch.models import init_io
    from gstex_torch.train import step as train_step

    method = get_method("gstex-dtu-nvs")
    cfg = dataclasses.replace(method.model, renderer="pallas1")
    raw = init_io.raw_from_gaussian_ply(root / "dtu" / "init.ply",
                                        fix_init=cfg.fix_init, device=DEVICE)
    params, buffers = model.init_params(cfg, *(raw[k] for k in (
        "means", "log_scales", "quats", "opacity_logits", "features_dc",
        "features_rest")))
    cfg = dataclasses.replace(cfg, chart_pad=tuple(params.texture.shape[1:3]))
    require(cfg.chart_pad == DTU_PAD,
            f"dtu timing: chart pad {cfg.chart_pad}, not {DTU_PAD}")
    views = FullImageCache.build(parse_nerfstudio(
        root / "dtu", "train", downscale_factor=method.downscale_factor,
        eval_mode=method.eval_mode, eval_interval=method.eval_interval),
        device=DEVICE)
    cam, img, mask = views.get(0)
    cfg, state = recharted_state(cfg, method.optim, params, buffers, cam)
    del params, buffers, raw
    hw = state.buffers.texture_hw
    lean = model.lean_losses(cfg)
    charts = dict(chart_pad=list(cfg.chart_pad), lists="dense",
                  max_active_hw=[int(x) for x in hw.amax(0)],
                  image_hw=[cam.height, cam.width])
    timing = step_timing(lambda: train_step.train_step(
        cfg, method.optim, state, cam, img, mask), counters,
        cam.height * cam.width)
    emit("timing", path="train", scene="dtu_800x600", renderer="pallas1",
         card=smi, **timing, lean=lean, pair_cap=cfg.pair_cap,
         s_cap=cfg.s_max, **charts)
    frame, stats, p_in = pair_frame(cfg, state.params, state.buffers, cam)
    del state
    torch.cuda.empty_cache()
    plain_ms = {}
    for mode in (True, False):
        checks = check_fwd_bwd(pair_tier(1), p_in, frame.grid, cfg.s_max,
                               mode, scene="dtu_800x600", **charts)
        note(checks)
        check_fwd_orders(1, p_in, frame.grid, cfg.s_max, mode,
                         scene="dtu_800x600", **charts)
        if mode == lean:
            plain_ms = {k: v[1] for k, v in checks.items()}
    kt, copies = time_pair_kernels((1,), p_in, frame, stats, lean, plain_ms)
    emit("timing", path="pair_kernels", scene="dtu_800x600", card=smi,
         lean=lean, kernels=kt, **copies, **charts)
    return kt


# the scalars of a training log row, as the JAX package's trainer writes
# them (its step's metrics, then rays_per_sec and texel_count), and of an
# eval image's row; each row leads with step and t
LOG_KEYS = {"main_loss", "l1", "ssim_loss", "normal_loss", "reg_loss", "loss",
            "overflow", "total_pairs", "max_tile_count", "psnr",
            "rays_per_sec", "texel_count"}
EVAL_KEYS = {"eval_psnr", "eval_ssim"}
RESUME_STEPS = 20


class Tee:
    """Standard output kept as it is printed, for the checks after."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def captured(fn, *args):
    """``fn(*args)`` and what it printed."""
    import contextlib

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn(*args)
    return out, "".join(tee.text)


def resumed_main_path(train_cli, rasterize_api, data, ckpt, root, counters):
    """Phase 5's run resumed through ``--load-checkpoint`` from its step-120
    checkpoint to step 140, saving and rendering an eval image every 10
    steps, with the tensorboard and wandb sinks: the run starts at step
    120, saves at steps 120 and 130 (named by the steps taken, 121 and
    131) and at its end (140), writes JAX's ``events.jsonl`` rows and the
    ``eval_rgb`` images, each sink writes or prints its notice, each step
    launches the three flat training kernels once. Then on to step 160
    with the normal loss: a finite, non-zero normal term, the flat
    forward and backward kernels launched in full mode only."""
    fwd, bwd, ssim, ev = counters
    out = root / "run_resumed"
    for fn in counters:
        fn.launches = 0
    res, text = captured(train_cli.main, [
        "gstex-blender-nvs", "--data", str(data), "--scene-npz", str(STATS),
        "--seed", "1", "--load-checkpoint", str(ckpt),
        "--max-num-iterations", str(TRAIN_STEPS + RESUME_STEPS),
        "--steps-per-save", "10", "--steps-per-eval-image", "10",
        "--vis", "tensorboard,wandb",
        "--set", "trainer.save_only_latest_checkpoint=false",
        "--output-dir", str(out)])
    launches = {fn.__name__: fn.launches for fn in counters}
    hist = res["history"]
    rows = [json.loads(ln) for ln in
            (out / "events.jsonl").read_text().splitlines()]
    ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
    images = sorted(p.name for p in (out / "images").iterdir())
    notices = [ln for ln in text.splitlines() if ln.startswith("[writer]")]
    # each sink either writes (tensorboard its event files under tb/,
    # wandb its run under wandb/) or prints its notice
    noticed = {ln.split()[1] for ln in notices}
    wrote = {k: (out / d).is_dir() and any((out / d).iterdir())
             for k, d in (("tensorboard", "tb"), ("wandb", "wandb"))}
    emit("main_path", path="train_resumed", steps=len(hist),
         first_step=hist[0]["step"] if hist else None, launches=launches,
         checkpoints=ckpts, images=images, notices=notices, sinks=wrote,
         events_rows=len(rows), losses=[round(h["loss"], 6) for h in hist],
         eval=res["eval"])
    require([h["step"] for h in hist] == list(
        range(TRAIN_STEPS, TRAIN_STEPS + RESUME_STEPS)),
        f"the resumed run took steps {[h['step'] for h in hist]}")
    require(ckpts == [f"step-{n:09d}.ckpt.pt" for n in (
        TRAIN_STEPS + 1, TRAIN_STEPS + 11, TRAIN_STEPS + RESUME_STEPS)],
        f"the resumed run saved {ckpts}")
    require(images == [f"eval_rgb_{n:09d}.png" for n in (
        TRAIN_STEPS, TRAIN_STEPS + 10)], f"eval images {images}")
    logs = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "eval_psnr" in r]
    require([r["step"] for r in logs] == list(
        range(TRAIN_STEPS, TRAIN_STEPS + RESUME_STEPS, 10))
        and all(list(r)[:2] == ["step", "t"] and set(r) - {"step", "t"}
                == LOG_KEYS for r in logs),
        f"events.jsonl log rows {logs}")
    require(len(evals) == 2 and all(set(r) - {"step", "t"} == EVAL_KEYS
                                    for r in evals),
            f"events.jsonl eval rows {evals}")
    require(noticed <= set(wrote) and len(noticed) == len(notices)
            and all((k in noticed) != wrote[k] for k in wrote),
            f"sinks that wrote {wrote}, notices {notices}")
    require(all(np.isfinite(h["loss"]) for h in hist), "a loss is not finite")
    require(all(launches[fn.__name__] == RESUME_STEPS
                for fn in (fwd, bwd, ssim)),
            f"the resumed run's training kernels launched {launches}")
    require(launches[ev.__name__] == 2 + 1 + TEST_VIEWS,
            f"the eval kernel launched {launches[ev.__name__]} times")

    # on with the normal loss, the flat kernels' modes recorded
    modes = []
    real = {k: getattr(rasterize_api, k)
            for k in ("rasterize_fwd", "rasterize_bwd")}

    def recording(name):
        def call(*args, lean, **kw):
            modes.append((name, lean))
            return real[name](*args, lean=lean, **kw)
        return call
    for fn in counters:
        fn.launches = 0
    for k in real:
        setattr(rasterize_api, k, recording(k))
    try:
        res = train_cli.main([
            "gstex-blender-nvs", "--data", str(data), "--scene-npz",
            str(STATS), "--seed", "1", "--load-checkpoint",
            str(out / "checkpoints" / ckpts[-1]), "--max-num-iterations",
            str(TRAIN_STEPS + 2 * RESUME_STEPS), "--steps-per-eval-image",
            "0", "--set", "model.use_normal_loss=true", "--set",
            "model.lambda_normal=0.05", "--output-dir",
            str(root / "run_normal")])
    finally:
        for k, fn in real.items():
            setattr(rasterize_api, k, fn)
    launches = {fn.__name__: fn.launches for fn in counters}
    terms = [h["normal_loss"] for h in res["history"]]
    emit("main_path", path="train_normal_loss", steps=len(terms),
         launches=launches, normal_loss=[round(t, 8) for t in terms[::5]],
         kernel_modes=sorted({f"{k}:{'lean' if m else 'full'}"
                              for k, m in modes}),
         losses=[round(h["loss"], 6) for h in res["history"][::5]])
    require(len(terms) == RESUME_STEPS, f"{len(terms)} normal-loss steps")
    require(all(np.isfinite(t) and t != 0.0 for t in terms),
            f"the normal loss terms {terms}")
    require(all(np.isfinite(h["loss"]) for h in res["history"]),
            "a normal-loss step's loss is not finite")
    require(launches[fwd.__name__] == launches[bwd.__name__] == RESUME_STEPS
            and modes and not any(m for _, m in modes),
            f"the full kernels: launches {launches}, modes {set(modes)}")


# camera pose optimization (phase 5c): the training poses perturbed by a
# seeded SO3xR3 tangent of this spread, as tests/test_pose_opt.py's
# recovery protocol perturbs them
POSE_SIGMA = 0.02
CAMOPT_KEYS = {"camera_opt_regularizer", "camera_opt_translation",
               "camera_opt_rotation"}
# the pose optimizer's accumulation: one update every 100 steps, made by
# the 100th (index 99)
POSE_EVERY = 100
CAMOPT_RESUME_STEPS = 10
CAMOPT_SHORT_STEPS = 20
# a camopt step's pose gradient through the kernels against the same step
# through their plain versions, of the plain gradient's max abs: the
# backward kernel is within ~1e-6 of each record field group's max and
# the SSIM kernel ~1.2e-5 of its gradient's (phase 3), and the pose
# gradient sums them over every pixel
POSE_GRAD_TOL = 1e-3
TIMED_STEPS = 20


def perturbed_dataset(data, out, seed=0):
    """A copy of the Blender dataset ``data`` whose training poses are
    right-multiplied by the exp map of a seeded SO3xR3 tangent (σ
    ``POSE_SIGMA`` a component); the frames and the test split are
    links. Returns the tangents (views, 6)."""
    from gstex_torch.ops import pose_opt

    out.mkdir()
    for split in ("train", "test"):
        (out / split).symlink_to(data / split, target_is_directory=True)
    (out / "transforms_test.json").write_text(
        (data / "transforms_test.json").read_text())
    meta = json.loads((data / "transforms_train.json").read_text())
    perts = np.random.default_rng(seed).normal(
        0.0, POSE_SIGMA, (len(meta["frames"]), 6))
    adj = pose_opt.exp_map_SO3xR3(torch.tensor(perts))
    for frame, a in zip(meta["frames"], adj):
        c2w = torch.tensor(frame["transform_matrix"], dtype=torch.float64)
        c2w = pose_opt.apply_correction(c2w[:3], a)
        frame["transform_matrix"] = torch.cat(
            [c2w, c2w.new_tensor([[0.0, 0.0, 0.0, 1.0]])]).tolist()
    (out / "transforms_train.json").write_text(json.dumps(meta))
    return perts


def camopt_run(train_cli, data, out, steps, *extra, load=None):
    args = ["gstex-blender-nvs", "--data", str(data), "--scene-npz",
            str(STATS), "--seed", "1", "--max-num-iterations", str(steps),
            "--steps-per-eval-image", "0", *extra, "--output-dir", str(out)]
    if load is not None:
        args += ["--load-checkpoint", str(load)]
    return train_cli.main(args)


def camopt_main_path(train_cli, data, root, counters, dense_counters):
    """``gstex-blender-nvs --set trainer.camera_opt=SO3xR3`` on a copy of
    phase 5's dataset with perturbed training poses, 120 steps from phase
    5's init across the re-chart at 100: the flat forward, backward and
    SSIM kernels once a step, finite ``camera_opt_*`` scalars and loss,
    the deltas exactly zero until the pose optimizer's one update at the
    100th step and non-zero from then on, ``pose-000000120.npz`` written;
    then resumed from step 120 to 130, its deltas and pose optimizer state
    restored bit for bit from the sidecar; then 20 ``SE3`` steps, and 20
    steps at pixel_num 4e6, whose pad (64, 128) takes the dense kernels
    and never the flat ones. Returns the run's directory and the
    launches of its kernels."""
    from gstex_torch.utils import checkpoint as ckpt_io

    fwd, bwd, ssim, ev = counters
    all_counters = counters + dense_counters
    pdata = root / "data_camopt"
    perts = perturbed_dataset(data, pdata)
    out = root / "run_camopt"
    for fn in all_counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = camopt_run(train_cli, pdata, out, TRAIN_STEPS,
                     "--set", "trainer.camera_opt=SO3xR3")
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in all_counters}
    hist = res["history"]
    rows = [json.loads(ln) for ln in
            (out / "events.jsonl").read_text().splitlines()]
    logs = [r for r in rows if "loss" in r]
    moved = [h["step"] for h in hist
             if h["camera_opt_translation"] > 0 or h["camera_opt_rotation"] > 0]
    sidecar = out / "checkpoints" / f"pose-{TRAIN_STEPS:09d}.npz"
    leaves = dict(zip(ckpt_io.POSE_LEAVES, ckpt_io.load_aux(sidecar))) \
        if sidecar.exists() else {}
    delta = leaves.get("delta", np.zeros((VIEWS, 6)))
    cosine = [float(d @ -p / (np.linalg.norm(d) * np.linalg.norm(p)
                              + 1e-30)) for d, p in zip(delta, perts)]
    run_cfg = json.loads((out / "config.json").read_text())
    emit("main_path", path="train_camopt", steps=len(hist), seconds=seconds,
         launches=launches, chart_pad=run_cfg["model"]["chart_pad"],
         camera_opt=run_cfg["trainer"]["camera_opt"],
         losses=[round(h["loss"], 6) for h in hist[::10]],
         camera_opt_translation=[h["camera_opt_translation"]
                                 for h in hist[POSE_EVERY - 2:]],
         camera_opt_rotation=[h["camera_opt_rotation"]
                              for h in hist[POSE_EVERY - 2:]],
         camera_opt_regularizer=[h["camera_opt_regularizer"]
                                 for h in hist[::20]],
         first_moved_step=moved[0] if moved else None,
         sidecar=sidecar.name if sidecar.exists() else None,
         sidecar_mini_step=int(leaves.get("mini_step", -1)),
         sidecar_gradient_step=int(leaves.get("gradient_step", -1)),
         delta_vs_inverse_perturbation_cosine=cosine,
         eval=res["eval"], max_overflow=max(h["overflow"] for h in hist))
    require(len(hist) == TRAIN_STEPS, f"{len(hist)} camopt steps ran")
    require(all(launches[fn.__name__] == TRAIN_STEPS
                for fn in (fwd, bwd, ssim)),
            f"camopt training kernels launched {launches} for "
            f"{TRAIN_STEPS} steps")
    require(all(v == 0 for k, v in launches.items()
                if k.startswith("rasterize_dense")),
            f"dense kernels ran on the flat camopt path: {launches}")
    # the closing eval pass: a warm-up render and each test view
    require(launches[ev.__name__] == 1 + TEST_VIEWS,
            f"the eval kernel launched {launches[ev.__name__]} times")
    require(all(np.isfinite(h[k]) for h in hist
                for k in CAMOPT_KEYS | {"loss"}),
            "a camopt step's loss or camera_opt scalar is not finite")
    require(moved == list(range(POSE_EVERY - 1, TRAIN_STEPS)),
            f"the deltas moved at steps {moved}, not from "
            f"{POSE_EVERY - 1} on")
    require(all(h["camera_opt_translation"] > 0
                and h["camera_opt_rotation"] > 0
                for h in hist[POSE_EVERY - 1:]),
            "the update moved only part of the deltas")
    require(logs and all(set(r) - {"step", "t"} == LOG_KEYS | CAMOPT_KEYS
                         for r in logs),
            f"events.jsonl camopt rows {logs[:1]}")
    require(sidecar.exists() and int(leaves["gradient_step"]) == 1
            and int(leaves["mini_step"]) == TRAIN_STEPS % POSE_EVERY,
            f"the pose sidecar {sidecar.name}: {leaves.keys()}")

    # resumed from step 120: the sidecar restored bit for bit
    restored = {}
    real_load = ckpt_io.load_pose
    for fn in all_counters:
        fn.launches = 0

    def recording(path, pose):
        real_load(path, pose)
        restored[Path(path).name] = ckpt_io.pose_leaves(pose)
    ckpt_io.load_pose = recording
    try:
        res2 = camopt_run(train_cli, pdata, root / "run_camopt_resumed",
                          TRAIN_STEPS + CAMOPT_RESUME_STEPS,
                          "--set", "trainer.camera_opt=SO3xR3",
                          load=res["checkpoint"])
    finally:
        ckpt_io.load_pose = real_load
    saved = ckpt_io.load_aux(sidecar)
    got = restored.get(sidecar.name, [])
    bit_equal = len(got) == len(saved) and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(got, saved))
    after = ckpt_io.load_aux(root / "run_camopt_resumed" / "checkpoints"
                             / f"pose-{TRAIN_STEPS + 10:09d}.npz")
    resumed_launches = {fn.__name__: fn.launches for fn in all_counters}
    emit("main_path", path="train_camopt_resumed",
         steps=[h["step"] for h in res2["history"]],
         launches=resumed_launches,
         restored_from=sorted(restored), bit_equal=bit_equal,
         mini_step_after=int(after[1]),
         losses=[round(h["loss"], 6) for h in res2["history"]])
    require(bit_equal, f"the resumed pose state is not the sidecar's: "
                       f"{sorted(restored)}")
    require([h["step"] for h in res2["history"]] == list(
        range(TRAIN_STEPS, TRAIN_STEPS + CAMOPT_RESUME_STEPS)),
        "the resumed camopt run took other steps")
    require(all(resumed_launches[fn.__name__] == CAMOPT_RESUME_STEPS
                for fn in (fwd, bwd, ssim)),
            f"the resumed camopt run launched {resumed_launches}")
    require(int(after[1]) == (TRAIN_STEPS + CAMOPT_RESUME_STEPS)
            % POSE_EVERY and np.array_equal(after[0], saved[0]),
            "the resumed run's accumulation did not go on from the sidecar")

    # the other mode, and the dense tier
    short = {}
    for name, extra, own, never in (
            ("SE3", ["--set", "trainer.camera_opt=SE3"],
             (fwd, bwd, ssim), dense_counters[:2]),
            ("SO3xR3_dense", ["--set", "trainer.camera_opt=SO3xR3",
                              "--pixel-num", str(DENSE_PIXEL_NUM)],
             dense_counters[:2] + (ssim,), (fwd, bwd))):
        for fn in all_counters:
            fn.launches = 0
        r = camopt_run(train_cli, pdata, root / f"run_camopt_{name}",
                       CAMOPT_SHORT_STEPS, *extra)
        got = {fn.__name__: fn.launches for fn in all_counters}
        pad = json.loads((root / f"run_camopt_{name}" / "config.json")
                         .read_text())["model"]["chart_pad"]
        short[name] = dict(launches=got, chart_pad=pad)
        emit("main_path", path=f"train_camopt_{name}",
             steps=len(r["history"]), launches=got, chart_pad=pad,
             losses=[round(h["loss"], 6) for h in r["history"][::5]])
        require(len(r["history"]) == CAMOPT_SHORT_STEPS
                and all(np.isfinite(h[k]) for h in r["history"]
                        for k in CAMOPT_KEYS | {"loss"}),
                f"{name}: a loss or camera_opt scalar is not finite")
        require(all(got[fn.__name__] == CAMOPT_SHORT_STEPS for fn in own)
                and all(got[fn.__name__] == 0 for fn in never),
                f"{name}: kernels launched {got}")
        torch.cuda.empty_cache()
    require(tuple(short["SO3xR3_dense"]["chart_pad"]) == DENSE_PAD,
            f"the dense camopt run's pad is {short['SO3xR3_dense']}")
    return out, launches, short


def camopt_step_check(run_dir, counters, smi):
    """One camopt step of ``run_dir``'s state (its step-120 checkpoint
    and pose sidecar) on a training view, through the kernels and through
    their plain versions (``rasterize_fwd_reference``,
    ``rasterize_bwd_reference``, ``fused_ssim_reference``), from equal
    copies: the pose gradient and the pose accumulator within
    ``POSE_GRAD_TOL`` of the plain one's max abs, the loss, each kernel
    launched once by the kernel step and never by the plain one. Then a
    camopt step and a plain training step of that state timed by CUDA
    events, median of 20 after 2 warm-ups, and each traced over 5
    (``device_ms``: busy ms, top kernels, ``gstex.*`` stages)."""
    from gstex_torch.ops import rasterize_api
    from gstex_torch.ops import rasterize_bwd as rbwd
    from gstex_torch.ops import rasterize_fwd as rfwd
    from gstex_torch.ops import ssim_fused
    from gstex_torch.scripts.eval_setup import eval_setup
    from gstex_torch.train import step as train_step
    from gstex_torch.utils import checkpoint as ckpt_io

    tr, _, _ = eval_setup(run_dir)
    aux = ckpt_io.latest_aux(run_dir / "checkpoints", "pose")
    idx = 3
    cam, img, mask = tr.train_cache.get(idx)

    def fresh():
        st = train_step.init_state(tr.mcfg, tr.ocfg, tr.state.params,
                                   tr.state.buffers, seed=7)
        st.step = tr.state.step
        pose = train_step.init_pose_state(
            len(tr.train_cache), device=tr.state.params.means.device)
        ckpt_io.load_pose(aux, pose)
        return st, pose

    def camopt_step(st, pose):
        return train_step.train_step_camopt(tr.mcfg, tr.ocfg, st, pose,
                                            "SO3xR3", cam, idx, img, mask)

    plain = {
        (rasterize_api, "rasterize_fwd"):
            lambda *a, lean, order=None: rfwd.rasterize_fwd_reference(
                *a, lean=lean),
        (rasterize_api, "rasterize_bwd"):
            lambda *a, lean, order=None: rbwd.rasterize_bwd_reference(
                *a, lean=lean),
        (ssim_fused, "fused_ssim_value_and_grad"):
            ssim_fused.fused_ssim_reference}
    real = {k: getattr(*k) for k in plain}
    got = {}
    for name in ("kernels", "plain"):
        st, pose = fresh()
        for fn in counters:
            fn.launches = 0
        if name == "plain":
            for (mod, attr), fn in plain.items():
                setattr(mod, attr, fn)
        try:
            m = camopt_step(st, pose)
            torch.cuda.synchronize()
        finally:
            for (mod, attr), fn in real.items():
                setattr(mod, attr, fn)
        got[name] = dict(
            grad=pose.delta.grad.detach().clone(),
            acc=pose.optimizer.state[pose.delta]["acc"].clone(),
            loss=float(m["loss"]),
            launches={fn.__name__: fn.launches for fn in counters})
    k, p = got["kernels"], got["plain"]
    err = lambda a, b: float((a - b).abs().max() / b.abs().max())
    grad_err, acc_err = err(k["grad"], p["grad"]), err(k["acc"], p["acc"])

    # the step timed (camopt, then plain training, from the same state),
    # then traced
    timing, traces = {}, {}
    for name in ("camopt", "plain"):
        st, pose = fresh()
        call = ((lambda: camopt_step(st, pose)) if name == "camopt" else
                (lambda: train_step.train_step(tr.mcfg, tr.ocfg, st, cam,
                                               img, mask)))
        times = []
        for i in range(TIMED_STEPS + 2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            torch.cuda.synchronize()
            if i >= 2:
                times.append(a.elapsed_time(b))
        timing[f"{name}_step_ms"] = statistics.median(times)
        timing[f"{name}_step_ms_min"] = min(times)
        timing[f"{name}_step_ms_max"] = max(times)
        busy, top, stages = device_ms(call, 5)
        timing[f"{name}_busy_ms"] = busy
        traces[name] = dict(top=top, stages=stages)
    emit("main_path", path="camopt_step_check", view=idx,
         step=tr.state.step, chart_pad=list(tr.mcfg.chart_pad),
         pose_grad_err=grad_err, pose_acc_err=acc_err,
         pose_grad_max=float(p["grad"].abs().max()),
         pose_grad_row=k["grad"][idx].tolist(),
         loss_kernels=k["loss"], loss_plain=p["loss"],
         launches_kernels=k["launches"], launches_plain=p["launches"],
         tol=POSE_GRAD_TOL, card=smi, trace=traces, **timing)
    require(grad_err <= POSE_GRAD_TOL and acc_err <= POSE_GRAD_TOL,
            f"the pose gradient through the kernels departs from the plain "
            f"versions' by {grad_err} (accumulator {acc_err})")
    require(float(p["grad"][idx, :3].abs().max()) > 0,
            "no gradient reached the camera's translation")
    require(all(v == 1 for v in k["launches"].values())
            and all(v == 0 for v in p["launches"].values()),
            f"launches: kernels {k['launches']}, plain {p['launches']}")
    require(abs(k["loss"] - p["loss"]) <= 1e-5 * abs(p["loss"]),
            f"losses {k['loss']} and {p['loss']}")
    return timing


# phase 5e: a chunk of the trainer's default size through the captured
# graph against as many eager steps from the same state
SCAN_STEPS = 8
SCAN_LOSS_TOL = 1e-4      # a step's loss, relative to the eager step's
# the departures of a chunk from eager steps. The backward kernels add
# with atomics, and two eager runs depart by about as much: after 8 or 16
# steps their params by up to 0.011 of the change, their moments by up
# to 0.112 of the means' (chaotic: surfels near the camera), both as L2
# norms; the tolerances leave room over those
SCAN_MOMENT_TOL = 0.25    # Adam's moments, L2 of the eager moments' L2
SCAN_PARAM_L2_TOL = 0.1   # the params, L2 of the eager change's L2
SCAN_PARAM_TOL = 1e-3     # (information) of the eager run's largest change
SCAN_KERNELS = {"fused_ssim_value_and_grad": "ssim_fused_kernel"}


def scan_departures(want, got, init):
    """How far state ``got`` departs from ``want`` after the same steps
    from params ``init``, per leaf: the L2 norm of the params' difference
    over that of ``want``'s change, the share of elements further apart
    than ``SCAN_PARAM_TOL`` of ``want``'s largest change, and the L2 norm
    of the Adam moments' difference over that of ``want``'s moments. (L2
    norms: with Adam's eps of 1e-15 an element whose gradient is rounding
    noise moves by about ±lr either way, so a max over millions of
    elements is one element's noise.)"""
    out = {"param_l2_of_change": {}, "param_share_past_tol": {},
           "moment_rel_err": {}}
    rel = lambda d, ref: float(d.norm()) / max(float(ref.norm()), 1e-30)
    for name, a, b, p0 in zip(want.params._fields, want.params, got.params,
                              init):
        out["param_l2_of_change"][name] = rel(a - b, a - p0)
        out["param_share_past_tol"][name] = float(
            ((a - b).abs() > SCAN_PARAM_TOL * float((a - p0).abs().max()))
            .float().mean())
        sa, sb = want.optimizer.state[a], got.optimizer.state[b]
        if sa:
            out["moment_rel_err"][name] = max(
                rel(sa[k] - sb[k], sa[k]) for k in ("exp_avg", "exp_avg_sq"))
    return out


def scan_gates(dep, found, where):
    """Fail unless each leaf's params (``scan_departures``: ``dep`` of the
    chunk) lie within ``SCAN_PARAM_L2_TOL`` of the eager change and its
    moments within ``SCAN_MOMENT_TOL`` of the eager moments."""
    require(all(v <= SCAN_PARAM_L2_TOL
                for v in dep["param_l2_of_change"].values()),
            f"{where}: params after the chunk: {found}")
    require(all(v <= SCAN_MOMENT_TOL for v in dep["moment_rel_err"].values()),
            f"{where}: Adam moments after the chunk: {found}")


def graph_nodes(scan, where):
    """One captured step's launches of each kernel (``{wrapper name:
    launches}``, as the scan counts a replay) and the captured graph's
    kernel nodes (``TrainScan.graph_kernels``); fails unless each kernel
    that launched has as many nodes in the graph as it launched."""
    per_step = {fn.__name__: k for fn, k in scan.launches_per_step.items()}
    kernels = {name: SCAN_KERNELS.get(name, f"{name}_kernel")
               for name in per_step}
    nodes = scan.graph_kernels(sorted(kernels.values()))
    require(per_step and all(nodes[kernels[n]] == k
                             for n, k in per_step.items()),
            f"{where}: graph kernel nodes {nodes} against one step's "
            f"launches {per_step}")
    return per_step, nodes


class CaptureRecorder:
    """While open, ``graph_nodes`` of every graph a ``TrainScan``
    captures, right after its capture (a trainer drops its scans at the
    end of ``train``), in ``self.graphs``."""

    def __init__(self, where):
        from gstex_torch.train import step as train_step

        self.cls, self.where, self.graphs = train_step.TrainScan, where, []

    def __enter__(self):
        real = self.real = self.cls._capture

        def capture(scan):
            real(scan)
            per_step, nodes = graph_nodes(scan, self.where)
            self.graphs.append(dict(launches_per_replay=per_step,
                                    graph_kernel_nodes=nodes))
        self.cls._capture = capture
        return self

    def __exit__(self, *exc):
        self.cls._capture = self.real


def rss_bytes():
    """This process's resident set, in bytes."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def kept_graph_cost(scan, reps=2):
    """What keeping a graph beside its executable (``keep_graph=True``, as
    every ``TrainScan`` captures) costs against torch's default: the
    scan's step captured twice more, kept and not, each into its own
    pool; for each, the device memory the capture reserved, the host's
    resident set across the capture and its instantiation, and the replay
    ms of a chunk of ``SCAN_STEPS`` (CUDA events, ``reps`` chunks after a
    warm-up, in turns kept, default, kept, default, over
    ``SCAN_STEPS``). The launches the captures count are taken back."""
    from gstex_torch.ops import launch_counts

    graphs, out = {}, {}
    for keep in (True, False):
        before = launch_counts.snapshot()
        scan.state.optimizer.zero_grad(set_to_none=True)
        # as the capture's own start does, so that the delta is its pool
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem, rss = torch.cuda.memory_reserved(), rss_bytes()
        graph = torch.cuda.CUDAGraph(keep_graph=keep)
        with torch.cuda.graph(graph):
            scan._step()
        if keep:
            graph.instantiate()
        torch.cuda.synchronize()
        launch_counts.take_back(before)
        graphs[keep] = graph
        out["kept" if keep else "default"] = dict(
            reserved_bytes=torch.cuda.memory_reserved() - mem,
            host_rss_bytes=rss_bytes() - rss, replay_ms=[])

    def chunk(graph):
        scan.tables.pos.zero_()
        for _ in range(SCAN_STEPS):
            graph.replay()

    for keep in (True, False, True, False):
        out["kept" if keep else "default"]["replay_ms"].append(
            cuda_ms(lambda: chunk(graphs[keep]), reps) / SCAN_STEPS)
    del graphs
    torch.cuda.empty_cache()
    return out


def scan_check(cfg, ocfg, st0, views, counters, **where):
    """Phase 5e on one state: from equal copies of ``st0`` (the same
    background generator), ``SCAN_STEPS`` eager ``train_step`` calls on
    ``views`` against one chunk of ``make_train_scan`` (its warm-up step
    under ``set_sync_debug_mode("error")``, one captured step, then
    replays), twice: the first chunk captures, the second only replays.
    A second eager copy gives the departure of two eager runs, for scale
    (the backward kernels add with atomics, so no bit equality is
    asked). Gates, on ``scan_departures`` of the chunk from the eager
    run: each step's loss within ``SCAN_LOSS_TOL`` of the eager step's
    (relative); for each leaf, the params within ``SCAN_PARAM_L2_TOL`` of
    the eager change and the Adam moments within ``SCAN_MOMENT_TOL`` of
    the eager moments (L2 norms); the kernels
    launched as many times (``counters``) by both; the captured graph's
    kernel nodes of each of the port's kernels equal to one eager step's
    launches of it. Then the step time on the host clock, eager (one
    step, then its metrics read) and chunked (a chunk, then its metrics
    read once, over ``SCAN_STEPS``), median of 20 and of 5, min-max; a
    chunk's graph replays alone by CUDA events, over ``SCAN_STEPS``; one
    ``torch.profiler`` trace of each for the busy ms and the card's idle
    share; ``kept_graph_cost``. The scan's graph is freed at the end."""
    from gstex_torch.train import step as train_step

    cams = [c for c, _ in views]
    imgs = [i for _, i in views]
    h, w = cams[0].height, cams[0].width

    def fresh():
        st = train_step.init_state(cfg, ocfg, st0.params, st0.buffers,
                                   seed=7)
        st.step = st0.step
        return st

    eager, again, chunk = fresh(), fresh(), fresh()
    init = [p.detach().clone() for p in eager.params]
    scan = train_step.make_train_scan(cfg, ocfg, chunk, h, w,
                                      capacity=SCAN_STEPS)
    chunks = []
    for part in ("capture", "replay"):
        for fn in counters:
            fn.launches = 0
        want = [float(train_step.train_step(cfg, ocfg, eager, c, i)["loss"])
                for c, i in views]
        eager_launches = {fn.__name__: fn.launches for fn in counters}
        for c, i in views:
            train_step.train_step(cfg, ocfg, again, c, i)
        for fn in counters:
            fn.launches = 0
        got = scan(cams, imgs)["loss"].tolist()
        torch.cuda.synchronize()
        scan_launches = {fn.__name__: fn.launches for fn in counters}
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        dep = scan_departures(eager, chunk, init)
        chunks.append(dict(part=part, loss_eager=want, loss_chunk=got,
                           loss_rel_err=loss_err, **dep,
                           eager_repeat=scan_departures(eager, again, init),
                           launches_eager=eager_launches,
                           launches_chunk=scan_launches))
        require(loss_err <= SCAN_LOSS_TOL,
                f"{where}: a chunk's losses {got} against eager {want}")
        scan_gates(dep, chunks[-1], where)
        require(scan_launches == eager_launches and all(
            v == SCAN_STEPS for v in eager_launches.values()
            if v), f"{where}: launches {scan_launches} against eager "
                   f"{eager_launches}")
    del again
    per_step, nodes = graph_nodes(scan, where)
    del init

    # the times: eager steps, chunks, one replay, and their traces
    turn = iter(range(10 ** 9))

    def eager_step():
        i = next(turn) % len(views)
        m = train_step.train_step(cfg, ocfg, eager, cams[i], imgs[i])
        return float(m["loss"])

    def chunk_step():
        ms = scan(cams, imgs)
        return torch.stack([v.to(torch.float64) for v in ms.values()]).cpu()

    eager_ms, eager_lo, eager_hi = host_ms(eager_step)
    chunk_ms, chunk_lo, chunk_hi = host_ms(chunk_step, reps=5)
    def replays():
        scan.tables.pos.zero_()
        for _ in range(SCAN_STEPS):
            scan.graph.replay()

    replay_ms = cuda_ms(replays, 2) / SCAN_STEPS
    eager_busy, eager_top, eager_stages = device_ms(eager_step, 5)
    chunk_busy, chunk_top, _ = device_ms(chunk_step, 1)
    kept = kept_graph_cost(scan)
    n = SCAN_STEPS
    res = dict(where, steps=n, chunks=chunks, graph_kernel_nodes=nodes,
               launches_per_replay=per_step,
               eager_step_ms=eager_ms, eager_step_ms_min=eager_lo,
               eager_step_ms_max=eager_hi, chunk_step_ms=chunk_ms / n,
               chunk_step_ms_min=chunk_lo / n, chunk_step_ms_max=chunk_hi / n,
               graph_replay_ms=replay_ms,
               eager_busy_ms=eager_busy,
               eager_idle_share=1.0 - eager_busy / eager_ms,
               chunk_busy_ms=chunk_busy / n,
               chunk_idle_share=(1.0 - chunk_busy / chunk_ms
                                 if chunk_busy > 0 else None),
               eager_stage_ms=eager_stages, eager_top_ms=eager_top,
               chunk_top_ms=chunk_top, kept_graph=kept)
    del scan, eager, chunk
    torch.cuda.empty_cache()
    return res


def scan_main_path(root, counters, smi):
    """Phase 5e: ``scan_check`` on phase 5's step-120 state (flat, (40,
    80)) and phase 6's (dense, (64, 128)), each on its first
    ``SCAN_STEPS`` training views."""
    from gstex_torch.scripts.eval_setup import eval_setup

    out = {}
    for run, tier in (("run", "flat"), ("run_dense", "dense")):
        tr, _, _ = eval_setup(root / run, device=DEVICE)
        views = [tr.train_cache.get(i)[:2] for i in range(SCAN_STEPS)]
        res = scan_check(tr.mcfg, tr.ocfg, tr.state, views, counters,
                         tier=tier, chart_pad=list(tr.mcfg.chart_pad),
                         pair_cap=tr.mcfg.pair_cap, step=tr.state.step)
        emit("main_path", path="scan", card=smi, **res)
        out[tier] = res
        del tr, views
        torch.cuda.empty_cache()
    return out


def parity_main_path(out, counters):
    """``gstex_torch.scripts.parity --synthetic`` at full width (800², 20k
    surfels), 10 views (8 train, 2 held out) and 500 steps, its ground
    truth from the xla tier uncertified (``--gt-renderer xla``: the
    oracle's certification, 60 s here, is the CPU tests' and the full
    protocol's): the renderer consistency and the trained-state gradcheck
    under their gates, a finite held-out PSNR; the flat training kernels launched once a step
    and once more by the gradcheck, the SSIM kernel also by its reference
    loss, the eval kernel by the eval pass (a warm-up and each held-out
    view) and the consistency check (each held-out view, at most 4)."""
    from gstex_torch.scripts import parity

    fwd, bwd, ssim, ev = counters
    # 10 views: the xla tier's ground truth takes 3-4 s a view on the card
    iters, views = 500, 10
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    rep = parity.main(["--synthetic", "--res", str(H), "--n-gauss", "20000",
                       "--views", str(views), "--quick", str(iters),
                       "--gt-renderer", "xla", "--output-dir", str(out)])
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    h = rep["heldout"]
    held = views // 5
    emit("main_path", path="parity", seconds=seconds, launches=launches,
         psnr=h["psnr"], psnr_std=h["psnr_std"], ssim=h["ssim"],
         ssim_std=h["ssim_std"], train_seconds=h["train_seconds"],
         gt_certification=h["gt_certification"],
         **{k: v for k, v in h.items()
            if k.startswith(("renderer_consistency", "trained_gradcheck"))})
    require(h["renderer_consistency_pass"], "renderer consistency failed")
    require(h["trained_gradcheck_pass"], "trained-state gradcheck failed")
    require(np.isfinite(h["psnr"]) and h["psnr"] > 10,
            f"held-out PSNR {h['psnr']}")
    want = {fwd.__name__: iters + 1, bwd.__name__: iters + 1,
            ssim.__name__: iters + 2, ev.__name__: 1 + held + min(4, held)}
    require(launches == want, f"parity launches {launches}, not {want}")


# texture painting (phase 9c). fp32 operations a pair beyond its response,
# counted from csrc/texture_edit.cu as the other kernels' are: an applied
# pair's T update, weight and window test; a pair inside its window, its
# tent (uv, clamps, floors, four weights) and its 20 products and tests
EDIT_APPLY_FLOPS = 6
EDIT_HIT_FLOPS = 110
EDIT_TOL = 1e-5       # of each accumulator channel's max: REDs reorder sums
OVERLAY_TOL = 1e-6
STROKE_WIDTH = 8
STROKE_RGB = ((255, 0, 0), (0, 255, 0))


def stroke_points(cam, k):
    """The k-th test stroke: a polyline across the middle of the view."""
    h, w = cam.height, cam.width
    return [(int(w * (0.3 + 0.05 * k)), int(h * 0.35)),
            (int(w * 0.5), int(h * (0.5 + 0.05 * k))),
            (int(w * 0.7), int(h * 0.4))]


def check_texture_edit(cfg, params, buffers, cam, tex, canvas, **where):
    """The texture-edit kernel against its plain version on one edit's
    inputs (``editing.edit_view``'s lists, the window at ±DEPTH_WINDOW of
    its depth): each accumulator channel within EDIT_TOL of its max, the
    texels with a weight the same set. Times the kernel alone (CUDA
    events around its launches into one accumulator zeroed outside), its
    whole call (the zeroing in it) and the plain version once; the bound:
    the listed gaussians' records, the ids, counts and six input planes
    read once, the touched texels' five channels written once;
    RESPONSE_FLOPS a response, EDIT_APPLY_FLOPS an applied pair and
    EDIT_HIT_FLOPS a pair in its window, as this edit's data needs."""
    from gstex_torch.models import editing
    from gstex_torch.ops import texture_edit as te
    from gstex_torch.ops.rasterize_fwd import tile_order
    from gstex_torch.ops.records import assemble_records, cam_info

    prep, bins, grid, depth = editing.edit_view(cfg, params, buffers, cam,
                                                tex)
    change = torch.as_tensor(canvas, dtype=torch.float32,
                             device=DEVICE) / 255.0
    planes = te.edit_planes(change[..., :3], change[..., 3:],
                            depth - editing.DEPTH_WINDOW,
                            depth + editing.DEPTH_WINDOW)
    records = assemble_records(prep.geom, cam.c2w[:3, 3], buffers.texture_hw)
    info = cam_info(cam)
    ch, cw = params.texture.shape[1:3]
    args = (records, bins.ids, bins.counts, planes, info, grid, ch, cw)
    order = tile_order(bins.counts, bins.ids.shape[1])
    launches = te.scatter_canvas.launches
    got = te.scatter_canvas(*args, order=order)
    stats = {}
    plain_ms, want = once_ms(
        lambda: te.scatter_canvas_reference(*args, stats=stats))
    abs_err = float((got - want).abs().max())
    rel = [float((got[..., c] - want[..., c]).abs().max()
                 / want[..., c].abs().max().clamp(min=1e-30))
           for c in range(te.ACCUM)]
    same_set = bool(torch.equal(got[..., 4] > 0, want[..., 4] > 0))
    accum = torch.zeros_like(got)
    ms = cuda_ms(lambda: te.launch(records, bins.ids, bins.counts, planes,
                                   info, accum, order, grid), 20)
    call_ms = cuda_ms(lambda: te.scatter_canvas(*args, order=order), 20)
    # the comparison's launches are not the main path's
    te.scatter_canvas.launches = launches
    touched = int((want[..., 4] > 0).sum())
    listed = bins.ids[bins.mask]
    bytes_once = (int(torch.unique(listed).numel()) * 32 * 4
                  + int(listed.numel()) * 4 + bins.counts.numel() * 4
                  + planes.numel() * 4 + info.numel() * 4
                  + touched * te.ACCUM * 4)
    ops = (stats["responses"] * RESPONSE_FLOPS
           + stats["applied"] * EDIT_APPLY_FLOPS
           + stats["hits"] * EDIT_HIT_FLOPS)
    bound = bound_of(bytes_once, ops, texels_touched=touched, **stats)
    painted = int((change[..., 3] > 0).sum())
    emit("texture_edit", ms=ms, call_ms=call_ms, plain_ms=plain_ms,
         max_abs_err=abs_err, rel_err_by_channel=rel, same_texels=same_set,
         painted_pixels=painted, **bound, **where)
    require(same_set, f"texture_edit {where}: the kernel reached other "
                      f"texels than its plain version")
    require(max(rel) <= EDIT_TOL, f"texture_edit {where}: {rel}")
    require(stats["hits"] > 0 and painted > 0,
            f"texture_edit {where}: the stroke reached nothing")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                max_abs_err=abs_err, **bound)


def edit_main_path(root, counters, eval_kernel, smi):
    """Phase 9c on one trained run ``root``: an ``EditSession`` with a
    polyline from each of two test cameras; each edit's texture-edit
    kernel against its plain version (``check_texture_edit``); the stack
    replayed (``edit_texture``: one texture-edit and one dense-eval launch
    an edit, nothing else) and timed, at least one texel changed; one
    ``draw_from_view`` timed whole; ``render_eval_images`` with the edited
    charts, every key finite, its ``edit`` image from the run's eval
    kernel (one launch) within OVERLAY_TOL of img + tex(edited) + (1 −
    α)·bg of the pure-torch tier."""
    from gstex_torch.models import editing
    from gstex_torch.models import gstex as model
    from gstex_torch.ops.sh import sh_to_rgb
    from gstex_torch.scripts.eval_setup import eval_setup
    from gstex_torch.scripts.render import eval_background

    trainer, _, _ = eval_setup(root, device=DEVICE)
    cfg, st = trainer.mcfg, trainer.state
    params, buffers = st.params, st.buffers
    cams = trainer.eval_cache.cameras[:2]
    sess = editing.EditSession(cfg)
    for k, cam in enumerate(cams):
        sess.add_polyline(cam, stroke_points(cam, k), rgb=STROKE_RGB[k],
                          width=STROKE_WIDTH)
    where = dict(run=root.name, chart_pad=list(cfg.chart_pad), card=smi)
    canvases = [torch.as_tensor(e["canvas"], dtype=torch.float32,
                                device=DEVICE) / 255.0 for e in sess.edits]
    with torch.no_grad():
        tex0 = sh_to_rgb(params.texture)
        tex, checks = tex0, []
        for k, cam in enumerate(cams):
            checks.append(check_texture_edit(
                cfg, params, buffers, cam, tex, sess.edits[k]["canvas"],
                edit=k, **where))
            tex = editing.draw_from_view(cfg, params, buffers, cam, tex,
                                         canvases[k])
            torch.cuda.empty_cache()
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        edited = sess.edit_texture(params, buffers)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3
        launches = {c.__name__: c.launches for c in counters}
        changed = int(((edited - tex0).abs().amax(-1) > 1e-3).sum())
        draw_ms, draw_lo, draw_hi = host_ms(
            lambda: editing.draw_from_view(cfg, params, buffers, cams[0],
                                           tex0, canvases[0]), reps=5)
        torch.cuda.empty_cache()
        bg = eval_background(cfg, DEVICE)
        for c in counters:
            c.launches = 0
        images = model.render_eval_images(cfg, params, buffers, cams[0],
                                          st.step, bg, edit_texture=edited)
        overlay_launches = {c.__name__: c.launches for c in counters}
        plain = model.render(dataclasses.replace(cfg, renderer="xla"),
                             params, buffers, cams[0], st.step, bg,
                             eval_only=True, albedo=edited)
        want = torch.clamp(plain["img"] + plain["texture_rgb"] + (
            1.0 - plain["alpha"][..., None]) * bg, 0.0, 1.0)
        overlay_err = float((images["edit"] - want).abs().max())
        edit_moved = float((images["edit"] - images["rgb"]).abs().max())
        finite = {k: bool(torch.isfinite(v).all())
                  for k, v in images.items()}
    emit("main_path", path="texture_edit", edits=len(sess.edits),
         launches=launches, replay_ms=replay_ms, draw_from_view_ms=draw_ms,
         draw_from_view_ms_min=draw_lo, draw_from_view_ms_max=draw_hi,
         texels_changed=changed, overlay_launches=overlay_launches,
         overlay_max_abs_err=overlay_err, edit_vs_rgb_max=edit_moved,
         image_keys=sorted(images), **where)
    want_launches = {k: (2 if k in ("scatter_canvas", "rasterize_dense_eval")
                         else 0) for k in launches}
    require(launches == want_launches,
            f"{root.name}: the replay launched {launches}")
    require(changed > 0, f"{root.name}: the edits changed no texel")
    require(all(finite.values()), f"{root.name}: not finite: {finite}")
    require(overlay_err <= OVERLAY_TOL,
            f"{root.name}: the edit overlay is {overlay_err} off the plain "
            f"tier's")
    require(edit_moved > 0, f"{root.name}: the edit overlay shows no edit")
    require(overlay_launches == {k: int(k == eval_kernel.__name__)
                                 for k in overlay_launches},
            f"{root.name}: the overlay launched {overlay_launches}")
    del trainer, params, buffers, edited, images
    torch.cuda.empty_cache()
    return dict(checks=checks, launches=launches["scatter_canvas"],
                draw_ms=draw_ms)


def viewer_main_path(root, counters, eval_kernel):
    """Phase 9c's viewer: ``gstex-torch-viewer --load-config root --port
    0`` serves a test camera over HTTP: a ``/frame`` (a JPEG of the
    resolution cap's size, banded, decoded by the port's decoder), a
    polyline painted through ``/control``, ``/state`` showing one edit, and the ``edit`` output's
    frame; the eval kernel launched once a band of every frame, the
    texture-edit kernel and the dense eval kernel (its depth pass) once."""
    import math
    import urllib.request

    from gstex_torch.data.png import read_image
    from gstex_torch.models.editing import camera_to_json
    from gstex_torch.scripts import viewer as viewer_cli

    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    viewer = viewer_cli.start(["--load-config", str(root), "--port", "0",
                               "--device", DEVICE])
    base = f"http://127.0.0.1:{viewer.port}"

    def post(path, payload):
        req = urllib.request.Request(base + path, method="POST",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    cam = viewer.trainer.eval_cache.cameras[0]
    cd = camera_to_json(cam)
    res = viewer.rsm.pick_res(moving=False)
    scale = res / max(cam.height, cam.width)
    shape = (round(cam.height * scale), round(cam.width * scale), 3)

    def frame(output, client):
        post("/render", {"camera": cd, "output": output, "client": client})
        deadline = time.time() + 120
        while time.time() < deadline:
            status, ctype, body = get(f"/frame?client={client}")
            if status == 200:
                return ctype, body
            time.sleep(0.05)
        require(False, f"{root.name}: no {output} frame from the viewer")

    try:
        ctype, body = frame("rgb", "rgb")
        path = root / "viewer_frame.jpg"
        path.write_bytes(body)
        img = read_image(path)
        post("/control", {"action": "set_line", "rgb": [255, 0, 0],
                          "width": STROKE_WIDTH})
        post("/control", {"action": "start_polyline", "camera": cd})
        for x, y in ((0.35, 0.4), (0.5, 0.55), (0.65, 0.45)):
            post("/control", {"action": "click", "x": x, "y": y})
        post("/control", {"action": "end_polyline"})
        state = json.loads(get("/state")[2])
        edit_ctype, edit_body = frame("edit", "edit")
    finally:
        viewer.close()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    edit_path = root / "viewer_edit.jpg"
    edit_path.write_bytes(edit_body)
    edit_shape = read_image(edit_path).shape
    # the cap's frame is banded; the edit frame may come at a lower rung
    # of the ladder while the camera counts as moving
    bands = math.ceil(shape[0] / viewer.BAND_ROWS)
    emit("main_path", path="viewer", run=root.name, seconds=seconds,
         frame_shape=list(img.shape), content_type=ctype,
         frame_bytes=len(body), edit_content_type=edit_ctype,
         frame_std=float(img.std()), state=state, bands=bands,
         edit_frame_shape=list(edit_shape), launches=launches)
    require(ctype == edit_ctype == "image/jpeg" and img.shape == shape
            and body[:3] == b"\xff\xd8\xff",
            f"{root.name}: the viewer sent {ctype} {img.shape}, not a JPEG "
            f"of {shape}")
    require(img.std() > 1.0, f"{root.name}: the viewer's frame is blank")
    require(state["edits"] == 1, f"{root.name}: /state read {state}")
    # the run's frames on its (flat) eval kernel, the edit's depth pass on
    # the dense one
    want = {k: 0 for k in launches}
    want.update(scatter_canvas=1, rasterize_dense_eval=1)
    want[eval_kernel.__name__] = launches[eval_kernel.__name__]
    require(launches == want and want[eval_kernel.__name__] >= bands + 2
            and edit_shape[2] == 3,
            f"{root.name}: the viewer launched {launches} for a frame of "
            f"{bands} bands and an edit frame {edit_shape}")
    return dict(launches=launches, bands=bands, seconds=seconds)


# phase 9d: a captured JPEG dataset through an OPENCV lens, trained under
# the progressive-resolution schedule (200², 400², then 800²), fisheye
# copies of a few of its frames, panoramas and the data layer's timings
CAPTURE_VIEWS = 16
CAPTURE_DISTORTION = {"k1": -0.05, "k2": 0.01, "p1": 1e-3, "p2": -1e-3}
CAPTURE_DOWNSCALES = 2
CAPTURE_SCHEDULE = 30
# the held-out PSNR of the captured run against its undistorted frames,
# stated before the first run (phase 8's runs read 32-33 dB)
CAPTURE_PSNR_GATE = 20.0
FISHEYE_MODELS = {
    "OPENCV_FISHEYE": {"k1": 0.05, "k2": -0.01, "k3": 0.002, "k4": -0.001},
    "FISHEYE624": {"k1": 0.02, "k2": -0.003, "p1": 1e-4, "s1": 1e-4},
}
FISHEYE_VIEWS = 4
FISHEYE_STEPS = 20
PANO_WIDTH = 2048
# the equirect's centre crop against the pinhole render at its pose, per
# channel (tests/test_pano.py's bound at the centre pixel)
PANO_CENTRE_TOL = 0.06
PANO_CROP = 32


def capture_expected_sizes(steps):
    """The schedule's image side at each step: 800 / 2^max(downscales −
    step // schedule, 0), floored as the trainer floors it."""
    return [H // 2 ** max(CAPTURE_DOWNSCALES - s // CAPTURE_SCHEDULE, 0)
            for s in range(steps)]


def captured_main_path(root, counters, train_counters, eval_kernel):
    """Phase 9d (a), (b), (e): a nerfstudio capture of JPEG frames
    (``data/jpeg.py`` at quality 95) through an OPENCV lens, written from
    the trained scene at 800x800; the host decoder's time a frame and
    the dataset's load (decode and undistortion) time; ``gstex-dtu-nvs
    --renderer pallas`` under ``num_downscales=2`` trained on it, each
    step's image size and flat-kernel launches recorded; then
    OPENCV_FISHEYE and FISHEYE624 copies of a few of its frames loaded
    and trained 20 steps. Returns what it measured."""
    import shutil

    from gstex_torch.data import jpeg
    from gstex_torch.data.manager import FullImageCache
    from gstex_torch.data.nerfstudio_parser import parse_nerfstudio
    from gstex_torch.data.synthetic import write_nerfstudio_dataset
    from gstex_torch.models import gstex as model
    from gstex_torch.models import init_io
    from gstex_torch.scripts import train as train_cli
    from gstex_torch.train import step as step_mod

    cfg = model.GStexConfig(renderer="pallas", chart_pad=PAD,
                            pair_cap=1 << 21, s_max=2048,
                            background_color="black")
    params, buffers = init_io.params_from_scene_stats(cfg, STATS, seed=0,
                                                      device=DEVICE)
    params = params._replace(texture=GT_TEXEL_SCALE * params.texture)
    cap = root / "capture"
    t0 = time.perf_counter()
    paths = write_nerfstudio_dataset(
        cap, cfg, params, buffers, CAPTURE_VIEWS, H, W, masks=False,
        image_format="jpeg", distortion=CAPTURE_DISTORTION)
    write_s = time.perf_counter() - t0
    del params, buffers
    torch.cuda.empty_cache()

    # (e) the host decoder a frame, its plain version once, the load
    frames = sorted((cap / "images_2").glob("*.jpg"))
    data = frames[0].read_bytes()
    t0 = time.perf_counter()
    first = jpeg.decode(data)             # builds the host library
    build_s = time.perf_counter() - t0
    decode_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        jpeg.decode(data)
        decode_ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    plain = jpeg.decode_plain(data)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    require(np.array_equal(plain, first) and first.shape == (H, W, 3),
            "capture: the C++ decoder and its plain version disagree")
    parsed = parse_nerfstudio(cap, downscale_factor=2, eval_mode="all")
    load_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = FullImageCache.build(parsed, device=DEVICE)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
    cam = cache.cameras[0]
    new_k = [float(v) for v in cam.intrins]
    timing = dict(decode_ms=statistics.median(decode_ms),
                  decode_ms_min=min(decode_ms), plain_decode_ms=plain_ms,
                  host_build_s=build_s, frame_bytes=len(data),
                  load_s=min(load_s), load_s_first=load_s[0],
                  frames=len(frames), frame_hw=[H, W])
    emit("main_path", path="capture_timing", **timing,
         intrinsics_raw=[float(parsed.fx[0]), float(parsed.fy[0]),
                         float(parsed.cx[0]), float(parsed.cy[0])],
         intrinsics_undistorted=new_k, dataset_seconds=write_s)
    require(all(c.height == H and c.width == W for c in cache.cameras),
            "capture: an undistorted frame changed size")
    del cache
    torch.cuda.empty_cache()

    # (a) the schedule's run, each step's image size and launches: the
    # single steps' (the downscaled ones), then a chunk's, a step each
    real_step, real_scan = step_mod.train_step, step_mod.TrainScan.__call__
    steps = []

    def recording(*args, **kwargs):
        before = [c.launches for c in train_counters]
        out = real_step(*args, **kwargs)
        img = args[4]
        steps.append((int(img.shape[0]), int(img.shape[1]),
                      [c.launches - b for c, b in zip(train_counters,
                                                     before)]))
        return out

    def recording_scan(scan, cams, images):
        before = [c.launches for c in train_counters]
        out = real_scan(scan, cams, images)
        n = len(cams)
        steps.extend([(int(images[0].shape[0]), int(images[0].shape[1]),
                       [(c.launches - b) / n for c, b in zip(
                           train_counters, before)])] * n)
        return out
    for c in counters:
        c.launches = 0
    step_mod.train_step = recording
    step_mod.TrainScan.__call__ = recording_scan
    t0 = time.perf_counter()
    try:
        res = train_cli.main([
            "gstex-dtu-nvs", "--data", str(cap), "--init-ply",
            str(paths["init_ply"]), "--renderer", "pallas",
            "--max-num-iterations", str(TRAIN_STEPS),
            "--set", f"model.num_downscales={CAPTURE_DOWNSCALES}",
            "--set", f"model.resolution_schedule={CAPTURE_SCHEDULE}",
            "--output-dir", str(root / "run_capture")])
    finally:
        step_mod.train_step = real_step
        step_mod.TrainScan.__call__ = real_scan
    run_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    want = capture_expected_sizes(TRAIN_STEPS)
    full = want.index(H)
    first, last = (statistics.mean(losses[:10]),
                   statistics.mean(losses[-10:]))
    first_full = statistics.mean(losses[full:full + 10])
    sides = sorted({(h, w) for h, w, _ in steps})
    emit("main_path", path="capture_train", steps=len(hist), seconds=run_s,
         sizes=[list(x) for x in sides],
         steps_per_size={f"{h}x{w}": sum(1 for a, b, _ in steps
                                         if (a, b) == (h, w))
                         for h, w in sides},
         launches=launches, first10_loss=first, last10_loss=last,
         first10_full_loss=first_full, eval=res["eval"],
         losses=[round(x, 6) for x in losses[::10]],
         max_overflow=max(h["overflow"] for h in hist),
         psnr_gate=CAPTURE_PSNR_GATE)
    require([h for h, _, _ in steps] == want
            and [w for _, w, _ in steps] == want,
            f"capture: the steps trained at {[x[:2] for x in steps]}")
    require(all(d == [1] * len(train_counters) for _, _, d in steps),
            f"capture: a step launched {[d for *_, d in steps]}")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            "capture: a loss is not finite")
    require(last < first and last < first_full,
            f"capture: the loss did not fall: {first} (full size "
            f"{first_full}) -> {last}")
    require(res["eval"] is not None
            and res["eval"]["psnr"] > CAPTURE_PSNR_GATE,
            f"capture: the held-out eval read {res['eval']}")

    # (b) fisheye copies of the first frames
    meta = json.loads((cap / "transforms.json").read_text())
    fisheye = {}
    for name, coeffs in FISHEYE_MODELS.items():
        d = root / f"capture_{name.lower()}"
        (d / "images_2").mkdir(parents=True)
        copy = dict(meta, camera_model=name,
                    frames=meta["frames"][:FISHEYE_VIEWS])
        for k in ("k1", "k2", "k3", "k4", "p1", "p2"):
            copy[k] = 0.0
        copy.update(coeffs)
        for fr in copy["frames"]:
            src = cap / "images_2" / Path(fr["file_path"]).name
            shutil.copy(src, d / "images_2" / src.name)
        for f in ("points3D.ply", "init.ply"):
            shutil.copy(cap / f, d / f)
        (d / "transforms.json").write_text(json.dumps(copy))
        parsed = parse_nerfstudio(d, downscale_factor=2, eval_mode="all")
        t0 = time.perf_counter()
        fcache = FullImageCache.build(parsed, device=DEVICE)
        torch.cuda.synchronize()
        fload = time.perf_counter() - t0
        fcam = fcache.cameras[0]
        coverage = (None if fcache.masks is None
                    else float(fcache.masks[0].mean()))
        del fcache
        for c in counters:
            c.launches = 0
        fres = train_cli.main([
            "gstex-dtu-nvs", "--data", str(d), "--init-ply",
            str(d / "init.ply"), "--renderer", "pallas",
            "--max-num-iterations", str(FISHEYE_STEPS),
            "--output-dir", str(root / f"run_{name.lower()}")])
        flosses = [h["loss"] for h in fres["history"]]
        fisheye[name] = dict(
            camera_type=parsed.camera_type, load_s=fload,
            image_hw=[fcam.height, fcam.width],
            intrinsics=[float(v) for v in fcam.intrins],
            mask_coverage=coverage, steps=len(flosses),
            loss_first=flosses[0], loss_last=flosses[-1],
            launches={c.__name__: c.launches for c in counters})
        require(len(flosses) == FISHEYE_STEPS and all(
            x == x and abs(x) != float("inf") for x in flosses),
            f"{name}: {len(flosses)} steps, losses {flosses}")
        require(name != "FISHEYE624" or 0.5 < coverage < 1.0,
                f"{name}: mask coverage {coverage}")
        torch.cuda.empty_cache()
    emit("main_path", path="capture_fisheye", **fisheye)
    return dict(timing=timing, train_s=run_s, eval=res["eval"],
                fisheye=fisheye)


def panorama_main_path(root, counters, eval_kernel):
    """Phase 9d (c) on one trained run ``root``: ``gstex_torch.scripts.
    render dataset --split test --camera-type equirectangular|ods
    --pano-width 2048`` (6 eval-kernel launches a panorama, 12 an ODS
    pair; PNGs of 2048x1024 and 2048x2048); one panorama of each kind
    timed on the host clock after a warm-up, the resample alone beside
    it; the equirect's centre crop against the 90° pinhole render at its
    pose, read along the crop's own rays."""
    from gstex_torch.models import gstex as model
    from gstex_torch.ops import pano
    from gstex_torch.ops.camera import (camera_rotation_gsplat, make_camera,
                                        ray_dirs_typed)
    from gstex_torch.scripts import render as render_cli
    from gstex_torch.scripts.eval_setup import eval_setup
    from gstex_torch.data.png import read_png

    out = {}
    for kind, faces in (("equirectangular", 6), ("ods", 12)):
        for c in counters:
            c.launches = 0
        out_dir = root / f"pano_{kind}"
        t0 = time.perf_counter()
        summary = render_cli.main([
            "dataset", "--split", "test", "--load-config", str(root),
            "--camera-type", kind, "--pano-width", str(PANO_WIDTH),
            "--output-path", str(out_dir)])
        cli_s = time.perf_counter() - t0
        got = {c.__name__: c.launches for c in counters}
        want = {k: 0 for k in got}
        want[eval_kernel.__name__] = faces * len(summary)
        shape = read_png(sorted(out_dir.glob("frame_*.png"))[0]).shape
        hw = (PANO_WIDTH // 2 if kind == "equirectangular" else PANO_WIDTH,
              PANO_WIDTH)
        require(got == want, f"{root.name}: {kind} launched {got}, not "
                             f"{want}")
        require(shape == hw + (3,) and all(s["finite"] for s in summary),
                f"{root.name}: {kind} wrote {shape}: {summary}")
        out[kind] = dict(cli_seconds=cli_s, frames=len(summary),
                         launches=got[eval_kernel.__name__], shape=shape)

    # timing and the centre crop, on the run's first test camera
    trainer, _, _ = eval_setup(root, device=DEVICE)
    st, cfg = trainer.state, trainer.mcfg
    c2w = trainer.eval_cache.cameras[0].c2w
    face_res = pano.default_face_res(PANO_WIDTH)
    cams = [f for ipd in (0.0, -0.064, 0.064)
            for f in pano.face_cameras(c2w, face_res, ipd, DEVICE)]
    with torch.no_grad():
        pair_cap, s_cap = render_cli.demand_caps(cfg, st.params, st.buffers,
                                                 cams, st.step)
    cfg = dataclasses.replace(cfg, pair_cap=pair_cap, s_max=s_cap)
    bg = render_cli.eval_background(cfg, DEVICE)

    def render_one(cam):
        return model.render(cfg, st.params, st.buffers, cam, st.step, bg,
                            eval_only=True)["rgb"]

    h, w = PANO_WIDTH // 2, PANO_WIDTH
    runs = {
        "equirectangular": lambda: pano.render_equirect(
            render_one, c2w, h, w, face_res, device=DEVICE),
        "ods": lambda: pano.render_ods(render_one, c2w, h, w,
                                       face_res=face_res, device=DEVICE)}
    with torch.no_grad():
        for kind, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                img = fn()
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            out[kind]["ms"] = statistics.median(ms)
            out[kind]["ms_min"] = min(ms)
        faces = [render_one(c) for c in cams[:6]]
        compose_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = pano.compose_equirect(faces, h, w)
            torch.cuda.synchronize()
            compose_ms.append(1e3 * (time.perf_counter() - t0))
        out["compose_ms"] = statistics.median(compose_ms)
        face_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_one(cams[0])
            torch.cuda.synchronize()
            face_ms.append(1e3 * (time.perf_counter() - t0))
        out["face_ms"] = statistics.median(face_ms)
        # the centre crop, read from a 90-degree pinhole along its rays
        f = face_res / 2.0
        pin = make_camera(f, f, f, f, face_res, face_res, c2w,
                          device=DEVICE)
        ref = render_one(pin)
        equi = make_camera(w / 2, w / 2, w / 2, h / 2, h, w, c2w,
                           device=DEVICE)
        r0, c0 = h // 2 - PANO_CROP // 2, w // 2 - PANO_CROP // 2
        ys, xs = torch.meshgrid(
            torch.arange(r0, r0 + PANO_CROP, dtype=torch.float32,
                         device=DEVICE),
            torch.arange(c0, c0 + PANO_CROP, dtype=torch.float32,
                         device=DEVICE), indexing="ij")
        d = ray_dirs_typed(xs, ys, equi, "equirectangular")
        dc = d @ camera_rotation_gsplat(c2w)       # world -> camera
        u = f * dc[..., 0] / dc[..., 2] + f - 0.5
        v = f * dc[..., 1] / dc[..., 2] + f - 0.5
        x0, y0 = torch.floor(u).long(), torch.floor(v).long()
        wx, wy = (u - x0)[..., None], (v - y0)[..., None]
        want = ((1 - wy) * ((1 - wx) * ref[y0, x0] + wx * ref[y0, x0 + 1])
                + wy * ((1 - wx) * ref[y0 + 1, x0]
                        + wx * ref[y0 + 1, x0 + 1]))
        crop = img[r0:r0 + PANO_CROP, c0:c0 + PANO_CROP]
        diff = (crop - want).abs()
        out["centre_crop"] = dict(max_abs=float(diff.max()),
                                  mean_abs=float(diff.mean()),
                                  crop=PANO_CROP, tol=PANO_CENTRE_TOL,
                                  ref_std=float(want.std()))
    emit("main_path", path="panorama", run=root.name, face_res=face_res,
         width=PANO_WIDTH, **out)
    require(out["centre_crop"]["max_abs"] <= PANO_CENTRE_TOL,
            f"{root.name}: the equirect's centre differs from the pinhole "
            f"by {out['centre_crop']}")
    del trainer
    torch.cuda.empty_cache()
    return out


def subsample_stats(path, n, seed=0):
    """A trained-scene-statistics file holding ``n`` of the asset's
    surfels, drawn with numpy from ``seed``."""
    with np.load(STATS) as d:
        d = dict(d)
    total = d["xyz"].shape[0]
    keep = np.sort(np.random.default_rng(seed).choice(total, n,
                                                      replace=False))
    np.savez(path, **{k: (v[keep] if v.ndim and v.shape[0] == total else v)
                      for k, v in d.items()})
    return path


# ---------------------------------------------------------------------------
# phase 5d: the tile-row mesh (parallel/shard.py)
# ---------------------------------------------------------------------------

MESH_NDEVS = (2, 4)
# the band renders, stated before the first run: each band's maps,
# stitched, bit-equal to the whole frame's through the same kernel (a
# band's tiles hold the frame's lists: the bands' pair counts sum to the
# frame's); the bands' backwards summed within BWD_TOL of each leaf's
# max abs of the frame's (the kernels add gradients in another order)
MESH_LOSS_TOL = 1e-5     # a sharded step's loss against the single rank's
MESH_GRAD_TOL = 1e-4     # its gradients, of the single rank's max abs
MESH_TRAIN_STEPS = 10
MESH_VIEWS = (3, 4)      # the training views of the checks
BAND_MAPS = ("img", "texture_rgb", "depth", "alpha", "rgb")
BAND_TRAIN_MAPS = BAND_MAPS + ("normal", "reg")


def grad_errors(got, want):
    """Per leaf, the max abs difference over the max abs of ``want``
    (leaves without a gradient must have none in both)."""
    errs = {}
    for name, a, b in zip(GRAD_LEAVES, got, want):
        require((a is None) == (b is None), f"{name}: a gradient is missing")
        if b is not None:
            errs[name] = float((a - b).abs().max()) / (
                float(b.abs().max()) + 1e-30)
    return errs


GRAD_LEAVES = ("means", "log_scales", "quats", "opacity_logits",
               "features_dc", "features_rest", "texture")


def band_render_check(cfg, state, cam, counters, **where):
    """One state's view rendered whole and as the bands of MESH_NDEVS
    ranks (``shard.render_band``: its grid at pixel offset (0, r·band_h))
    through the tier's eval kernel and its training kernels, with seeded
    cotangents on the training maps; ``counters`` the tier's (eval,
    forward, backward) wrappers, each launched once a band."""
    from gstex_torch.models import gstex as model
    from gstex_torch.parallel import shard

    params, buffers, step = state.params, state.buffers, state.step
    leaves = list(params)
    h, w = cam.height, cam.width
    bg = torch.full((3,), 0.25, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    with torch.no_grad():
        whole_eval = model.render(cfg, params, buffers, cam, step, bg,
                                  eval_only=True)
    whole = model.render(cfg, params, buffers, cam, step, bg)
    cot = {k: torch.randn(whole[k].shape, generator=gen, device=DEVICE)
           for k in BAND_TRAIN_MAPS}
    g_whole = torch.autograd.grad(
        sum((whole[k] * cot[k]).sum() for k in BAND_TRAIN_MAPS), leaves,
        allow_unused=True)
    out = {}
    for ndev in MESH_NDEVS:
        bgrid, band_h = shard.band_grid(cfg, h, w, ndev)
        for fn in counters:
            fn.launches = 0
        evals, trains, g_sum, pairs = [], [], None, 0
        for r in range(ndev):
            with torch.no_grad():
                evals.append(shard.render_band(cfg, params, buffers, cam,
                                               step, bg, bgrid, r,
                                               eval_only=True))
            t = shard.render_band(cfg, params, buffers, cam, step, bg, bgrid,
                                  r)
            pairs += int(t["total_pairs"])
            rows = slice(r * band_h, (r + 1) * band_h)
            pad = band_h - cot["rgb"][rows].shape[0]
            loss = sum((t[k] * torch.nn.functional.pad(
                cot[k][rows], (0, 0) * (cot[k].dim() - 1) + (0, pad))).sum()
                for k in BAND_TRAIN_MAPS)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            g_sum = g if g_sum is None else [
                None if a is None else a + b for a, b in zip(g_sum, g)]
            trains.append({k: t[k].detach() for k in BAND_TRAIN_MAPS})
            del t, loss, g
        stitch = lambda bands, k: torch.cat([b[k] for b in bands])[:h]
        eval_equal = {k: bool(torch.equal(stitch(evals, k), whole_eval[k]))
                      for k in BAND_MAPS}
        train_equal = {k: bool(torch.equal(stitch(trains, k),
                                           whole[k].detach()))
                       for k in BAND_TRAIN_MAPS}
        errs = grad_errors(g_sum, g_whole)
        launches = {fn.__name__: fn.launches for fn in counters}
        emit("mesh_band", ndev=ndev, band_h=band_h, eval_equal=eval_equal,
             train_equal=train_equal, band_pairs=pairs,
             frame_pairs=int(whole["total_pairs"]), grad_rel_err=errs,
             tol=BWD_TOL, launches=launches, renderer=cfg.renderer,
             chart_pad=list(cfg.chart_pad), **where)
        require(all(eval_equal.values()) and all(train_equal.values()),
                f"{where} ndev {ndev}: a band's maps differ from the "
                f"frame's: eval {eval_equal}, train {train_equal}")
        require(pairs == int(whole["total_pairs"]),
                f"{where} ndev {ndev}: {pairs} band pairs, "
                f"{int(whole['total_pairs'])} in the frame")
        require(max(errs.values()) <= BWD_TOL,
                f"{where} ndev {ndev}: band gradients {errs}")
        require(all(v == ndev for v in launches.values()),
                f"{where} ndev {ndev}: launches {launches}")
        out[ndev] = dict(grad_rel_err=max(errs.values()), launches=launches)
        del evals, trains, g_sum
    return out


def mesh_rank_main(rank, world, backend, rdv, run_dir, data, trainer_steps,
                   out):
    """One rank of phase 5d's process group (``backend`` gloo: every rank
    on ``cuda:0``, the card shared; nccl: rank r on ``cuda:r``). Rank 0
    writes what it gathered to ``out``."""
    from gstex_torch.parallel.distributed import init_distributed

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    init_distributed(f"file://{rdv}/rendezvous", world, rank,
                     backend=backend)
    try:
        res = mesh_rank_checks(world, backend, Path(run_dir), Path(data),
                               trainer_steps, Path(out).parent)
        if rank == 0:
            Path(out).write_text(json.dumps(res, default=plain))
    finally:
        torch.distributed.destroy_process_group()


def mesh_rank_checks(world, backend, run_dir, data, trainer_steps, root):
    """Phase 5d on a group of ``world`` ranks: from phase 5's step-120
    state, one sharded step, one sharded camopt step and (two ranks or
    more) one data-parallel step, each against the single-rank step on
    rank 0; then (``trainer_steps``) ``Trainer(num_devices=world)`` from
    phase 5's init on phase 5's dataset. Returns rank 0's findings and
    every rank's times and launches."""
    import torch.distributed as dist

    from gstex_torch.configs.methods import get_method
    from gstex_torch.data.blender import parse_blender
    from gstex_torch.data.manager import FullImageCache
    from gstex_torch.models import gstex as model
    from gstex_torch.models import init_io
    from gstex_torch.ops import rasterize_bwd as rbwd
    from gstex_torch.ops import rasterize_fwd as rfwd
    from gstex_torch.parallel import shard
    from gstex_torch.parallel.distributed import make_mesh
    from gstex_torch.scripts.eval_setup import eval_setup
    from gstex_torch.train import step as train_step
    from gstex_torch.train.trainer import Trainer

    rank = dist.get_rank()
    counters = (rfwd.rasterize_fwd, rbwd.rasterize_bwd)
    tr, _, _ = eval_setup(run_dir, device=DEVICE)
    cfg, ocfg = tr.mcfg, tr.ocfg
    cams = [tr.train_cache.get(i) for i in MESH_VIEWS]
    cam, img, _ = cams[0]
    h, w = cam.height, cam.width

    def fresh():
        st = train_step.init_state(cfg, ocfg, tr.state.params,
                                   tr.state.buffers, seed=7)
        st.step = tr.state.step
        return st

    def pose():
        p = train_step.init_pose_state(len(tr.train_cache), device=DEVICE)
        with torch.no_grad():
            p.delta[MESH_VIEWS[0]] = torch.tensor(
                [0.004, -0.003, 0.002, 0.001, -0.002, 0.0015], device=DEVICE)
        return p

    def grads(st):
        return [None if p.grad is None else p.grad.detach().clone()
                for p in st.params]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    found, mine = {}, {}
    mesh = make_mesh(world)
    # the single rank's step and the sharded step from equal states
    want = None
    if rank == 0:
        st = fresh()
        m = train_step.train_step(cfg, ocfg, st, cam, img)
        want = (float(m["loss"]), grads(st))
        del st
    st = fresh()
    for fn in counters:
        fn.launches = 0
    m, mine["step_ms"] = timed(lambda: shard.make_sharded_train_step(
        cfg, mesh, h, w)(st, cam, img))
    mine["step_launches"] = {fn.__name__: fn.launches for fn in counters}
    if rank == 0:
        found["step"] = dict(loss=float(m["loss"]), loss_single=want[0],
                             grad_rel_err=grad_errors(grads(st), want[1]))
    # the all-reduce alone, on this step's gradients
    nbytes = sum(p.grad.numel() * p.grad.element_size() for p in st.params
                 if p.grad is not None)
    _, mine["allreduce_ms"] = timed(
        lambda: shard.reduce_gradients(mesh, list(st.params)))
    mine["allreduce_bytes"] = nbytes
    del st

    # the camopt step
    if rank == 0:
        st, p = fresh(), pose()
        m = train_step.train_step_camopt(cfg, ocfg, st, p, "SO3xR3", cam,
                                         MESH_VIEWS[0], img)
        want = (float(m["loss"]), grads(st), p.delta.grad.detach().clone())
        del st, p
    st, p = fresh(), pose()
    m = shard.make_sharded_train_step_camopt(cfg, "SO3xR3", mesh, h, w)(
        st, p, cam, MESH_VIEWS[0], img)
    if rank == 0:
        pg = p.delta.grad
        found["camopt"] = dict(
            loss=float(m["loss"]), loss_single=want[0],
            grad_rel_err=grad_errors(grads(st), want[1]),
            pose_grad_rel_err=float((pg - want[2]).abs().max())
            / float(want[2].abs().max()))
    del st, p

    # the sharded scan: a chunk against as many sharded steps, and a second
    # run of those for scale
    views = [tr.train_cache.get(i)[:2] for i in MESH_VIEWS]
    steps, again, chunk = fresh(), fresh(), fresh()
    init = [q.detach().clone() for q in steps.params]
    step_fn = shard.make_sharded_train_step(cfg, mesh, h, w)
    want = [float(step_fn(steps, c, i)["loss"]) for c, i in views]
    for c, i in views:
        step_fn(again, c, i)
    for fn in counters:
        fn.launches = 0
    got = shard.make_sharded_train_scan(cfg, mesh, h, w)(
        chunk, [c for c, _ in views], [i for _, i in views])
    mine["scan_launches"] = {fn.__name__: fn.launches for fn in counters}
    if rank == 0:
        found["scan"] = dict(
            loss=got["loss"].tolist(), loss_steps=want,
            loss_rel_err=max(abs(a - b) / abs(b) for a, b in
                             zip(got["loss"].tolist(), want)),
            **scan_departures(steps, chunk, init),
            eager_repeat=scan_departures(steps, again, init))
    del steps, again, chunk, init

    # one data-parallel step: a row a rank, each its own view
    if world >= 2 and world % 2 == 0:
        dmesh = make_mesh(world, data_parallel=2)
        views = [(c, i) for c, i, _ in cams]
        if rank == 0:
            st = fresh()
            bgs = shard.backgrounds(cfg, st.generator, 2, DEVICE)
            gsum = None
            for (c, i), bg in zip(views, bgs):
                out = model.render(cfg, st.params, st.buffers, c, st.step, bg)
                loss, _ = model.loss_fn(cfg, out, model.composite_gt(i, bg),
                                        st.step)
                g = torch.autograd.grad(loss, list(st.params),
                                        allow_unused=True)
                gsum = g if gsum is None else [
                    None if a is None else a + b for a, b in zip(gsum, g)]
            want = [None if g is None else g / 2 for g in gsum]
            del st
        st = fresh()
        shard.make_batch_sharded_train_step(cfg, dmesh, h, w)(
            st, [c for c, _ in views], [i for _, i in views])
        if rank == 0:
            found["data_parallel"] = dict(
                grad_rel_err=grad_errors(grads(st), want))
        del st
    del tr
    torch.cuda.empty_cache()

    # the Trainer on the mesh: phase 5's command's run, on `world` ranks
    if trainer_steps:
        method = get_method("gstex-blender-nvs")
        params, buffers = init_io.load_scene_npz(method.model, STATS, seed=1,
                                                 device=DEVICE)
        mcfg = dataclasses.replace(method.model, chart_pad=tuple(
            params.texture.shape[1:3]))
        cache = FullImageCache.build(parse_blender(data, "train"),
                                     seed=method.trainer.seed, device=DEVICE)
        tcfg = dataclasses.replace(
            method.trainer, max_num_iterations=trainer_steps,
            steps_per_save=0, steps_per_eval_image=0, log_every=1,
            vis="wandb", demand_size_caps=True, num_devices=world,
            output_dir=str(root / "mesh_run"))
        optim = dataclasses.replace(method.optim, max_steps=trainer_steps)
        trainer = Trainer(tcfg, mcfg, optim, params, buffers, cache)
        del params, buffers
        for fn in counters:
            fn.launches = 0
        hist, t_ms = timed(trainer.train)
        mine["trainer_launches"] = {fn.__name__: fn.launches
                                    for fn in counters}
        mine["trainer_step_ms"] = t_ms / trainer_steps
        digest = hashlib.sha256()
        for leaf in list(trainer.state.params) + list(trainer.state.buffers):
            digest.update(leaf.detach().cpu().numpy().tobytes())
        mine["state_sha256"] = digest.hexdigest()
        if rank == 0:
            found["trainer"] = dict(
                steps=len(hist), losses=[h["loss"] for h in hist],
                chart_pad=list(mcfg.chart_pad),
                max_overflow=max(h["overflow"] for h in hist))
    every = [None] * world
    dist.all_gather_object(every, mine)
    found["ranks"] = every
    return found


def mesh_main_path(root, data, counters, smi):
    """Phase 5d. The band renders of phases 5, 6 and 7's states through
    the flat, dense and pair-space kernels (``band_render_check``); then
    two ranks sharing the card over gloo (``mesh_rank_checks``: a sharded,
    a camopt and a data-parallel step against the single rank's, 10 steps
    of ``Trainer(num_devices=2)``); then NCCL on a group of one rank a
    card."""
    from gstex_torch.scripts.eval_setup import eval_setup

    flat, dense, v3, v1 = (counters[k] for k in ("flat", "dense", "pallas3",
                                                 "pallas1"))
    t0 = time.perf_counter()
    band = {}
    for run, tiers in (("run", (("flat", flat, None),)),
                       ("run_dense", (("dense", dense, None),)),
                       ("run_pallas3", (("pallas3", v3, "pallas3"),
                                        ("pallas1", v1, "pallas1")))):
        tr, _, _ = eval_setup(root / run, device=DEVICE)
        cam = tr.train_cache.get(MESH_VIEWS[0])[0]
        for name, fns, renderer in tiers:
            cfg = (tr.mcfg if renderer is None
                   else dataclasses.replace(tr.mcfg, renderer=renderer))
            band[name] = band_render_check(cfg, tr.state, cam, fns,
                                           tier=name, run=run)
        del tr
        torch.cuda.empty_cache()
    band_s = time.perf_counter() - t0

    def group(world, backend, steps):
        rdv = tempfile.mkdtemp(dir=root)
        out = Path(rdv) / "rank0.json"
        t = time.perf_counter()
        torch.multiprocessing.start_processes(
            mesh_rank_main, args=(world, backend, rdv, str(root / "run"),
                                  str(data), steps, str(out)),
            nprocs=world, start_method="spawn")
        res = json.loads(out.read_text())
        res["seconds"] = time.perf_counter() - t
        return res

    shared = group(2, "gloo", MESH_TRAIN_STEPS)
    n_cards = torch.cuda.device_count()
    nccl = group(n_cards, "nccl", MESH_TRAIN_STEPS if n_cards >= 2 else 0)
    for name, res in (("gloo_shared_card", shared), ("nccl", nccl)):
        emit("main_path", path=f"mesh_{name}", card=smi, **res)
        for check in ("step", "camopt", "data_parallel"):
            if check not in res:
                continue
            c = res[check]
            if "loss" in c:
                require(abs(c["loss"] - c["loss_single"]) <= MESH_LOSS_TOL,
                        f"{name} {check}: loss {c['loss']} against the "
                        f"single rank's {c['loss_single']}")
            worst = max(list(c["grad_rel_err"].values())
                        + [c.get("pose_grad_rel_err", 0.0)])
            require(worst <= MESH_GRAD_TOL,
                    f"{name} {check}: gradients {c}")
        if "trainer" in res:
            tr = res["trainer"]
            require(tr["steps"] == MESH_TRAIN_STEPS and tr["max_overflow"] == 0
                    and all(x == x for x in tr["losses"]),
                    f"{name}: the mesh trainer's run {tr}")
            require(len({r["state_sha256"] for r in res["ranks"]}) == 1,
                    f"{name}: the replicas differ after the run")
            require(all(v == MESH_TRAIN_STEPS for r in res["ranks"]
                        for v in r["trainer_launches"].values()),
                    f"{name}: trainer launches "
                    f"{[r['trainer_launches'] for r in res['ranks']]}")
        require(all(v == 1 for r in res["ranks"]
                    for v in r["step_launches"].values()),
                f"{name}: step launches "
                f"{[r['step_launches'] for r in res['ranks']]}")
        sc = res["scan"]
        require(sc["loss_rel_err"] <= SCAN_LOSS_TOL,
                f"{name}: the sharded scan's losses {sc['loss']} against "
                f"its steps' {sc['loss_steps']}")
        scan_gates(sc, sc, f"{name} sharded scan")
        require(all(v == len(MESH_VIEWS) for r in res["ranks"]
                    for v in r["scan_launches"].values()),
                f"{name}: scan launches "
                f"{[r['scan_launches'] for r in res['ranks']]}")
    require("data_parallel" in shared and "trainer" in shared,
            "the shared-card group skipped a check")
    return dict(band=band, band_seconds=band_s, gloo=shared, nccl=nccl)


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
    from gstex_torch.ops import rasterize_dense as rdense
    from gstex_torch.ops import rasterize_eval as reval
    from gstex_torch.ops import rasterize_api
    from gstex_torch.ops import rasterize_fwd as rfwd
    from gstex_torch.ops import rasterize_v1 as rv1
    from gstex_torch.ops import rasterize_v2 as rv2
    from gstex_torch.ops import rasterize_v3 as rv3
    from gstex_torch.ops import ssim_fused
    from gstex_torch.ops import texture_edit as tedit
    from gstex_torch.ops.camera import make_camera
    from gstex_torch.ops.pair_inputs import bwd_launch_smem
    from gstex_torch.ops.rasterize_api import use_flat_path
    from gstex_torch.scripts import render as render_cli
    from gstex_torch.scripts import train as train_cli
    from gstex_torch.train import step as train_step

    dense_src = list(dense_tier().names)
    pair_src = ["rasterize_v3_fwd", "rasterize_v3_bwd", "rasterize_v2_fwd",
                "rasterize_v2_bwd", "rasterize_v1_fwd", "rasterize_v1_bwd"]
    kernels_src = ["rasterize_eval", "rasterize_fwd", "rasterize_bwd",
                   "ssim_fused"] + dense_src + pair_src + ["texture_edit"]
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
                for k in kernels_src},
         launch_smem_bytes={
             "rasterize_eval": reval.launch_smem(),
             "rasterize_fwd": rfwd.launch_smem(),
             "rasterize_bwd_32x32": rbwd.launch_smem(32, 32),
             "rasterize_eval_bf16": reval.launch_smem(bf16=True),
             "rasterize_fwd_bf16": rfwd.launch_smem(bf16=True),
             "rasterize_bwd_bf16_32x32": rbwd.launch_smem(32, 32, bf16=True),
             "rasterize_dense_bwd_32x32": rdense.bwd_launch_smem(32, 32),
             **{f"rasterize_v{v}_bwd_32x32_16x24": bwd_launch_smem(
                 v, 32, 32, 16, 24) for v in (3, 2, 1)},
             "ssim_fused": ssim_fused.launch_smem()})

    # 3. kernels vs plain, on the bins of each scene's first spiral view
    cam = orbit_camera(H, W, dist=4.0, device=DEVICE)
    frames = {}
    worst = dict.fromkeys(kernels_src + list(BF16_NAMES), 0.0)

    def note(checks):
        for k, (err, _) in checks.items():
            worst[k] = max(worst[k], err)
    with torch.no_grad():
        for name, cfg, params, buffers in scenes(model, init_io):
            pair_cap, s_cap = render_cli.demand_caps(cfg, params, buffers,
                                                     [cam], STEP)
            cfg = dataclasses.replace(cfg, pair_cap=pair_cap, s_max=s_cap)
            frame = Frame(cfg, params, buffers, cam,
                          render_cli.eval_background(cfg, DEVICE))
            frame.run()
            err, _, stats = check_eval(frame, scene=name, pair_cap=pair_cap,
                                       chart_pad=list(PAD))
            worst["rasterize_eval"] = max(worst["rasterize_eval"], err)
            frames[name] = (frame, stats)

            # phase 10 holds both scenes' training kernels, flat and
            # dense, to their plain versions at their training pads; the
            # pair-space kernels are held at their main path's pad below

        # the pair-space kernels at their main path's pad: the trained
        # scene at pixel_num 1e5, re-charted so that its charts fill it
        pcfg = model.GStexConfig(renderer="pallas3", chart_pad=None,
                                 pixel_num=PAIR_PIXEL_NUM)
        pp, pb = init_io.params_from_scene_stats(pcfg, STATS, device=DEVICE)
        pcfg = dataclasses.replace(pcfg,
                                   chart_pad=tuple(pp.texture.shape[1:3]))
        require(pcfg.chart_pad == PAIR_PAD,
                f"pixel_num {PAIR_PIXEL_NUM}: chart pad {pcfg.chart_pad}, "
                f"not {PAIR_PAD}")
        pp, pb = model.rechart(pcfg, pp, pb)
        pair_cap, s_cap = render_cli.demand_caps(pcfg, pp, pb, [cam], STEP)
        pcfg = dataclasses.replace(pcfg, pair_cap=pair_cap, s_max=s_cap)
        pframe = Frame(pcfg, pp, pb, cam,
                       render_cli.eval_background(pcfg, DEVICE), dense=True)
        pframe.run()
        hw = pb.texture_hw
        where = dict(scene="trained_scene_1e5", chart_pad=list(PAIR_PAD),
                     max_active_hw=[int(x) for x in hw.amax(0)])
        worst["rasterize_dense_eval"] = max(worst["rasterize_dense_eval"],
                                            check_eval(pframe, **where)[0])
        pair_plain_ms = check_pairs(pframe, note, **where)
        del pframe, pp, pb
        torch.cuda.empty_cache()

        # SSIM on a render and a noisy copy of it, at the Blender path's
        # 800x800 and, cut to its rows, the DTU path's 800x600
        pred = frames["trained_scene_stats"][0].rgb.contiguous()
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        noisy = torch.clamp(pred + 0.05 * torch.randn(
            pred.shape, generator=gen, device=DEVICE), 0, 1).contiguous()
        ssim_pairs = {f"{h}x{w}x3": (pred[:h].contiguous(),
                                     noisy[:h].contiguous())
                      for h, w in ((H, W), (DTU_H, DTU_W))}
        for shape, (a, b) in ssim_pairs.items():
            worst["ssim_fused"] = max(worst["ssim_fused"],
                                      check_ssim(ssim_fused, a, b))

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
    train_counters = (rfwd.rasterize_fwd, rbwd.rasterize_bwd,
                      ssim_fused.fused_ssim_value_and_grad)
    dense_counters = (rdense.rasterize_dense_fwd, rdense.rasterize_dense_bwd,
                      rdense.rasterize_dense_eval)
    for fn in train_counters:
        fn.launches = 0
    train_step.TrainScan.captures = train_step.TrainScan.replays = 0
    t0 = time.perf_counter()
    with CaptureRecorder("phase 5") as recorder:
        res = train_cli.main([
            "gstex-blender-nvs", "--data", str(data), "--scene-npz",
            str(STATS), "--seed", "1", "--max-num-iterations",
            str(TRAIN_STEPS), "--output-dir", str(Path(tmp.name) / "run")])
    train_s = time.perf_counter() - t0
    scan_runs = dict(captures=train_step.TrainScan.captures,
                     replays=train_step.TrainScan.replays,
                     graphs=recorder.graphs)
    flat_launches = {fn.__name__: fn.launches for fn in train_counters}
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    first, last = (statistics.mean(losses[:10]),
                   statistics.mean(losses[-10:]))
    run_cfg = json.loads((Path(tmp.name) / "run" / "config.json")
                         .read_text())
    emit("main_path", path="train", steps=len(hist), seconds=train_s,
         launches=flat_launches, chart_pad=run_cfg["model"]["chart_pad"],
         pair_cap=run_cfg["model"]["pair_cap"],
         first10_loss=first, last10_loss=last,
         losses=[round(x, 6) for x in losses[::10]],
         psnr_first=hist[0]["psnr"], psnr_last=hist[-1]["psnr"],
         max_overflow=max(h["overflow"] for h in hist),
         max_total_pairs=max(h["total_pairs"] for h in hist),
         checkpoint=Path(res["checkpoint"]).name,
         steps_per_sync=run_cfg["trainer"]["steps_per_sync"], **scan_runs)
    require(len(hist) == TRAIN_STEPS, f"{len(hist)} steps ran")
    # the default steps_per_sync: chunks of up to 8 between the cadences
    # (a log every 10 steps), all at one size: one capture, and every
    # chunked step but the capture's warm-up a replay
    require(run_cfg["trainer"]["steps_per_sync"] == SCAN_STEPS
            and scan_runs["captures"] == 1 == len(recorder.graphs)
            and scan_runs["replays"] >= TRAIN_STEPS // 2,
            f"the run did not go through the captured scan: {scan_runs}")
    require(all(v == TRAIN_STEPS for v in flat_launches.values()),
            f"training kernels launched {flat_launches} for {TRAIN_STEPS} "
            f"steps")
    require(all(h["overflow"] == 0 for h in hist), "a step overflowed")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            "a loss is not finite")
    require(len(set(losses)) > 3, "the loss did not change")
    require(last < first, f"the loss did not fall: {first} -> {last}")
    require(Path(res["checkpoint"]).exists(), "no checkpoint")

    # a test split (two views between the training views), so that the
    # later runs close with an eval pass
    write_blender_dataset(data, cfg0, p0, b0, TEST_VIEWS, H, W, split="test",
                          azimuth0=0.4)
    del p0, b0
    # 5b. the run resumed from its checkpoint with a user's cadences and
    # sinks, then on with the normal loss
    resumed_main_path(train_cli, rasterize_api, data, Path(res["checkpoint"]),
                      Path(tmp.name), train_counters + (reval.rasterize_eval,))
    torch.cuda.empty_cache()

    # 5f. the bf16 chart stream: 40 steps of the same command with
    # --set model.texel_dtype=bf16, and a frame served from the run
    bf16_counters = (reval.rasterize_eval, rfwd.rasterize_fwd,
                     rbwd.rasterize_bwd, reval.rasterize_eval_bf16,
                     rfwd.rasterize_fwd_bf16, rbwd.rasterize_bwd_bf16)
    bf16_launches = bf16_main_path(train_cli, render_cli, data,
                                   Path(tmp.name), bf16_counters)
    torch.cuda.empty_cache()

    # 5c. camera pose optimization on perturbed poses: 120 steps, resumed
    # to 130, 20 SE3 steps and 20 at the dense pad; one step through the
    # kernels against their plain versions, and its time
    camopt_dir, camopt_launches, _ = camopt_main_path(
        train_cli, data, Path(tmp.name),
        train_counters + (reval.rasterize_eval,), dense_counters)
    camopt_step_check(camopt_dir, train_counters, smi)
    torch.cuda.empty_cache()

    # 6. the large-chart main path: the same command with a texel budget
    # whose charts the dispatch sends to the dense tier, on the same
    # dataset and its test split
    for fn in train_counters + dense_counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = train_cli.main([
        "gstex-blender-nvs", "--data", str(data), "--scene-npz", str(STATS),
        "--seed", "1", "--pixel-num", str(DENSE_PIXEL_NUM),
        "--max-num-iterations", str(TRAIN_STEPS),
        "--output-dir", str(Path(tmp.name) / "run_dense")])
    dense_train_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    run_cfg = json.loads((Path(tmp.name) / "run_dense" / "config.json")
                         .read_text())["model"]
    with tempfile.TemporaryDirectory() as frames_dir, torch.no_grad():
        summary = render_cli.main([
            "spiral", "--scene-npz", str(STATS), "--frames", str(FRAMES),
            "--height", str(H), "--width", str(W), "--renderer", "pallas4",
            "--output-path", frames_dir])
        pngs = len(list(Path(frames_dir).glob("frame_*.png")))
    dense_launches = {fn.__name__: fn.launches
                      for fn in train_counters + dense_counters}
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    first, last = (statistics.mean(losses[:10]),
                   statistics.mean(losses[-10:]))
    # the step-0 eval image, the closing pass over the test split (a
    # warm-up render and each view), and the spiral frames
    eval_expected = 1 + 1 + TEST_VIEWS + FRAMES
    emit("main_path", path="train_dense", steps=len(hist),
         seconds=dense_train_s, launches=dense_launches,
         chart_pad=run_cfg["chart_pad"], pair_cap=run_cfg["pair_cap"],
         s_max=run_cfg["s_max"], renderer=run_cfg["renderer"],
         first10_loss=first, last10_loss=last,
         losses=[round(x, 6) for x in losses[::10]],
         psnr_first=hist[0]["psnr"], psnr_last=hist[-1]["psnr"],
         max_overflow=max(h["overflow"] for h in hist),
         max_total_pairs=max(h["total_pairs"] for h in hist),
         eval=res["eval"], spiral_frames=len(summary), spiral_pngs=pngs,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    require(tuple(run_cfg["chart_pad"]) == DENSE_PAD,
            f"the run's chart pad is {run_cfg['chart_pad']}, not "
            f"{DENSE_PAD}")
    require(len(hist) == TRAIN_STEPS, f"{len(hist)} dense steps ran")
    require(all(dense_launches[k] == TRAIN_STEPS for k in (
        "rasterize_dense_fwd", "rasterize_dense_bwd",
        "fused_ssim_value_and_grad")),
            f"dense training kernels launched {dense_launches} for "
            f"{TRAIN_STEPS} steps")
    require(dense_launches["rasterize_fwd"] == 0
            and dense_launches["rasterize_bwd"] == 0,
            f"the flat training kernels ran on the large-chart path: "
            f"{dense_launches}")
    require(dense_launches["rasterize_dense_eval"] == eval_expected,
            f"the dense eval kernel launched "
            f"{dense_launches['rasterize_dense_eval']} times, not "
            f"{eval_expected}")
    require(all(h["overflow"] == 0 for h in hist), "a dense step overflowed")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            "a dense loss is not finite")
    require(last < first, f"the dense loss did not fall: {first} -> {last}")
    require(res["eval"] is not None and res["eval"]["psnr"] > 10,
            f"the eval pass read {res['eval']}")
    require(pngs == FRAMES and all(
        f["finite"] and f["alpha_coverage"] > 0 and f["overflow"] == 0
        for f in summary), "a pallas4 spiral frame is missing, not finite, "
                           "empty or overflowed")

    # 5e. the scanned dispatch: a chunk through the captured graph against
    # eager steps, on the states of phases 5 (flat) and 6 (dense)
    t5e = time.perf_counter()
    scan = scan_main_path(Path(tmp.name), train_counters + dense_counters[:2],
                          smi)
    emit("phase_5e", seconds=time.perf_counter() - t5e, nvidia_smi=smi,
         step_ms={tier: {k: r[k] for k in (
             "eager_step_ms", "chunk_step_ms", "graph_replay_ms",
             "eager_idle_share", "chunk_idle_share")}
             for tier, r in scan.items()})
    torch.cuda.empty_cache()

    # 7. the pair-space main path: the same command at a texel budget whose
    # charts the v3 and v2 kernels take, once through each
    pair_counters = (rv3.rasterize_v3_fwd, rv3.rasterize_v3_bwd,
                     rv2.rasterize_v2_fwd, rv2.rasterize_v2_bwd,
                     rv1.rasterize_v1_fwd, rv1.rasterize_v1_bwd)
    all_counters = train_counters + dense_counters + pair_counters
    real_gather = rasterize_api.pair_inputs
    pair_launches = {}
    for renderer in ("pallas3", "pallas2"):
        version = renderer[-1]
        gathered = []

        def gather(records, texture, bins, *cap):
            # the per-slot copies each step makes, as they are made
            out = real_gather(records, texture, bins, *cap)
            gathered.append(sum(x.numel() * x.element_size()
                                for x in out[:2]))
            return out
        rasterize_api.pair_inputs = gather
        torch.cuda.reset_peak_memory_stats()
        for fn in all_counters:
            fn.launches = 0
        train_step.TrainScan.captures = train_step.TrainScan.replays = 0
        t0 = time.perf_counter()
        try:
            with CaptureRecorder(f"phase 7 {renderer}") as recorder:
                res = train_cli.main([
                    "gstex-blender-nvs", "--data", str(data), "--scene-npz",
                    str(STATS), "--seed", "1", "--pixel-num",
                    str(PAIR_PIXEL_NUM), "--renderer", renderer,
                    "--max-num-iterations", str(TRAIN_STEPS), "--output-dir",
                    str(Path(tmp.name) / f"run_{renderer}")])
        finally:
            rasterize_api.pair_inputs = real_gather
        run_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in all_counters}
        pair_launches[renderer] = launches
        run_cfg = json.loads((Path(tmp.name) / f"run_{renderer}"
                              / "config.json").read_text())["model"]
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        first, last = (statistics.mean(losses[:10]),
                       statistics.mean(losses[-10:]))
        emit("main_path", path=f"train_{renderer}", steps=len(hist),
             seconds=run_s, launches=launches,
             chart_pad=run_cfg["chart_pad"], renderer=run_cfg["renderer"],
             first10_loss=first, last10_loss=last,
             losses=[round(x, 6) for x in losses[::10]],
             psnr_first=hist[0]["psnr"], psnr_last=hist[-1]["psnr"],
             max_overflow=max(h["overflow"] for h in hist),
             max_total_pairs=max(h["total_pairs"] for h in hist),
             pair_buffer_bytes=max(gathered),
             pair_buffer_with_grad_bytes=2 * max(gathered),
             gathers=len(gathered), eval=res["eval"],
             scan_captures=train_step.TrainScan.captures,
             scan_replays=train_step.TrainScan.replays,
             scan_graphs=recorder.graphs,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             checkpoint=Path(res["checkpoint"]).name)
        require(tuple(run_cfg["chart_pad"]) == PAIR_PAD,
                f"{renderer}: the run's chart pad is {run_cfg['chart_pad']}, "
                f"not {PAIR_PAD}")
        require(len(hist) == TRAIN_STEPS, f"{renderer}: {len(hist)} steps")
        own = (f"rasterize_v{version}_fwd", f"rasterize_v{version}_bwd",
               "fused_ssim_value_and_grad")
        require(all(launches[k] == TRAIN_STEPS for k in own),
                f"{renderer}: kernels launched {launches} for "
                f"{TRAIN_STEPS} steps")
        require(all(v == 0 for k, v in launches.items()
                    if k not in own and k != "rasterize_dense_eval"),
                f"{renderer}: other training kernels ran: {launches}")
        # the step-0 eval image; the closing pass: a warm-up, each view
        require(launches["rasterize_dense_eval"] == 2 + TEST_VIEWS,
                f"{renderer}: the dense eval kernel launched "
                f"{launches['rasterize_dense_eval']} times, not "
                f"{2 + TEST_VIEWS}")
        # a gather on the host a step, but a graph's replays make theirs
        # on the card and its capture made one that never ran
        scan_runs = (train_step.TrainScan.captures,
                     train_step.TrainScan.replays)
        require(len(gathered) - scan_runs[0] + scan_runs[1] == TRAIN_STEPS,
                f"{renderer}: {len(gathered)} pair gathers on the host, "
                f"(captures, replays) {scan_runs}")
        # each capture's graph holds the launches its replays count
        require(len(recorder.graphs) == scan_runs[0] >= 1,
                f"{renderer}: {len(recorder.graphs)} graphs checked, "
                f"{scan_runs[0]} captured")
        require(all(h["overflow"] == 0 for h in hist),
                f"{renderer}: a step overflowed")
        require(all(x == x and abs(x) != float("inf") for x in losses),
                f"{renderer}: a loss is not finite")
        require(last < first,
                f"{renderer}: the loss did not fall: {first} -> {last}")
        require(res["eval"] is not None and res["eval"]["psnr"] > 10,
                f"{renderer}: the eval pass read {res['eval']}")
        require(Path(res["checkpoint"]).exists(), f"{renderer}: no checkpoint")
        del res
        torch.cuda.empty_cache()

    # 5d. the tile-row mesh: band renders of the runs of phases 5, 6 and 7
    # through every tier's kernels, two ranks sharing the card over gloo,
    # then NCCL (after phase 7, whose runs it reuses)
    t5d = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = mesh_main_path(Path(tmp.name), data, {
        "flat": (reval.rasterize_eval, rfwd.rasterize_fwd,
                 rbwd.rasterize_bwd),
        "dense": dense_counters,
        "pallas3": (rdense.rasterize_dense_eval, rv3.rasterize_v3_fwd,
                    rv3.rasterize_v3_bwd),
        "pallas1": (rdense.rasterize_dense_eval, rv1.rasterize_v1_fwd,
                    rv1.rasterize_v1_bwd)}, smi)
    emit("phase_5d", seconds=time.perf_counter() - t5d, nvidia_smi=smi,
         band_seconds=mesh["band_seconds"],
         band_grad_rel_err={k: {n: v["grad_rel_err"] for n, v in b.items()}
                            for k, b in mesh["band"].items()},
         gloo_seconds=mesh["gloo"]["seconds"],
         nccl_seconds=mesh["nccl"]["seconds"],
         rank_step_ms=[r["step_ms"] for r in mesh["gloo"]["ranks"]],
         rank_trainer_step_ms=[r["trainer_step_ms"]
                               for r in mesh["gloo"]["ranks"]],
         allreduce_bytes=mesh["gloo"]["ranks"][0]["allreduce_bytes"],
         allreduce_ms_gloo_host_staged=[r["allreduce_ms"]
                                        for r in mesh["gloo"]["ranks"]],
         allreduce_ms_nccl=[r["allreduce_ms"] for r in mesh["nccl"]["ranks"]])
    torch.cuda.empty_cache()

    # 8. the nerfstudio main path: gstex-dtu-nvs on the v1 tier
    dtu_launches = dtu_main_path(Path(tmp.name), all_counters)
    torch.cuda.empty_cache()

    # 9. serving the runs of phases 5 (flat, Blender) and 8 (v1,
    # nerfstudio) through the CLIs a user calls
    serve_counters = all_counters + (reval.rasterize_eval,)
    serve_main_path(Path(tmp.name) / "run", serve_counters,
                    reval.rasterize_eval, TEST_VIEWS, data)
    serve_main_path(Path(tmp.name) / "run_dtu", serve_counters,
                    rdense.rasterize_dense_eval, (DTU_VIEWS + 7) // 8)
    torch.cuda.empty_cache()

    # 9b. the synthetic held-out parity protocol, cut to 10 views and 500
    # steps
    parity_main_path(Path(tmp.name) / "parity",
                     train_counters + (reval.rasterize_eval,))
    torch.cuda.empty_cache()

    # 9c. texture painting on the runs of phases 5 (flat, (40, 80)) and 6
    # (dense, (64, 128)), then the viewer serving phase 5's run
    edit_counters = serve_counters + (tedit.scatter_canvas,)
    edit_t = {
        "40x80": edit_main_path(Path(tmp.name) / "run", edit_counters,
                                reval.rasterize_eval, smi),
        "64x128": edit_main_path(Path(tmp.name) / "run_dense", edit_counters,
                                 rdense.rasterize_dense_eval, smi)}
    viewer_main_path(Path(tmp.name) / "run", edit_counters,
                     reval.rasterize_eval)
    torch.cuda.empty_cache()

    # 9d. captured data and panoramas: a JPEG capture through a lens under
    # the resolution schedule, fisheye copies, then panoramas of the runs
    # of phases 5 (flat) and 6 (dense)
    t9d = time.perf_counter()
    capture = captured_main_path(Path(tmp.name), serve_counters,
                                 train_counters, reval.rasterize_eval)
    panoramas = {
        "flat": panorama_main_path(Path(tmp.name) / "run", serve_counters,
                                   reval.rasterize_eval),
        "dense": panorama_main_path(Path(tmp.name) / "run_dense",
                                    serve_counters,
                                    rdense.rasterize_dense_eval)}
    emit("phase_9d", seconds=time.perf_counter() - t9d, nvidia_smi=smi,
         decode_ms=capture["timing"]["decode_ms"],
         load_s=capture["timing"]["load_s"],
         capture_eval_psnr=capture["eval"]["psnr"],
         equirect_ms={k: v["equirectangular"]["ms"]
                      for k, v in panoramas.items()},
         ods_ms={k: v["ods"]["ms"] for k, v in panoramas.items()})
    torch.cuda.empty_cache()

    # 9e. LPIPS on the 800x800 render and its noisy copy of phase 3, and
    # DBSCAN on phase 5's trained surfels
    t9e = time.perf_counter()
    tools_t = tools_main_path(Path(tmp.name) / "run", pred, noisy, smi)
    emit("phase_9e", seconds=time.perf_counter() - t9e, nvidia_smi=smi,
         **tools_t)
    torch.cuda.empty_cache()

    # 10. timing: an eval frame, then a training step
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
    black = torch.zeros((H, W, 3), device=DEVICE)
    mcfg = method.model
    bcfg = dataclasses.replace(mcfg, chart_pad=PAD, background_color="black")
    sub_npz = subsample_stats(Path(tmp.name) / "subsample.npz", SUBSAMPLE)

    def loaded(cfg, npz):
        """A scene from a statistics file at its auto chart pad."""
        params, buffers = init_io.load_scene_npz(cfg, npz, seed=1,
                                                 device=DEVICE)
        return (dataclasses.replace(cfg, chart_pad=tuple(
            params.texture.shape[1:3])), params, buffers, image)

    def surface():
        s = surface_scene(50_000, chart_pad=PAD, seed=0, device=DEVICE)
        return (bcfg, *model.init_params(
            bcfg, s["means"], s["log_scales"], s["quats"],
            s["opacity_logits"], s["features_dc"], s["features_rest"]),
            black)

    # (name, expected chart pad, how to make it): made one at a time, the
    # largest holds 8 GB of texture, gradient and Adam moments
    train_scenes = [
        ("trained_scene_stats", (40, 80), lambda: loaded(mcfg, STATS)),
        ("surface_scene_50k", PAD, surface),
        ("trained_scene_4e6", DENSE_PAD, lambda: loaded(dataclasses.replace(
            mcfg, pixel_num=DENSE_PIXEL_NUM), STATS)),
        (f"subsample_{SUBSAMPLE}", SUBSAMPLE_PAD,
         lambda: loaded(mcfg, sub_npz)),
    ]
    train_t = {}
    for name, want_pad, make in train_scenes:
        cfg, params, buffers, img = make()
        require(tuple(cfg.chart_pad) == want_pad,
                f"{name}: chart pad {cfg.chart_pad}, expected {want_pad}")
        dense = not use_flat_path(cfg.renderer, cfg.chart_pad,
                                  cfg.tile_h * cfg.tile_w)
        require(dense == (want_pad in (DENSE_PAD, SUBSAMPLE_PAD)),
                f"{name}: pad {want_pad} went to the "
                f"{'dense' if dense else 'flat'} tier")
        tcam = make_camera(1.2 * H, 1.2 * H, W / 2, H / 2, H, W,
                           orbit_c2w(4.0, 0.0), device=DEVICE)
        cfg, state = recharted_state(cfg, method.optim, params, buffers,
                                     tcam)
        del params, buffers
        pair_cap, s_cap = cfg.pair_cap, cfg.s_max
        hw = state.buffers.texture_hw
        charts = dict(chart_pad=list(cfg.chart_pad),
                      lists="dense" if dense else "flat",
                      max_active_hw=[int(x) for x in hw.amax(0)],
                      above_8x8=int(((hw[:, 0] > 8) | (hw[:, 1] > 8)).sum()))
        require(max(cfg.chart_pad) <= 8 or charts["above_8x8"] > 0,
                f"{name}: no active chart past 8x8 after the re-chart")
        lean = model.lean_losses(cfg)
        where = dict(scene=name, path="train", **charts)
        # the kernels' inputs of this step's view, from the state as it is
        with torch.no_grad():
            frame = Frame(cfg, state.params, state.buffers, tcam, None,
                          dense=dense)
            for stage in ("prepare", "cull_binning", "records"):
                getattr(frame, stage)()
        tier, k_in, grid = frame.tier, frame.inputs, frame.grid
        eval_name, fwd_name, bwd_name = tier.names
        # each kernel against its plain version at the training shapes,
        # lean and full; the main path's mode keeps its plain ms
        checks = {mode: check_fwd_bwd(tier, k_in, grid, s_cap, mode, **where)
                  for mode in (True, False)}
        if name in ("trained_scene_stats", "trained_scene_4e6",
                    f"subsample_{SUBSAMPLE}"):
            for c in checks.values():
                note(c)
        with torch.no_grad():
            err, eval_plain_ms, stats = check_eval(frame, **where)
        worst[eval_name] = max(worst[eval_name], err)
        if name == "trained_scene_stats":
            # both tiers take (40, 80): the dense kernels against the flat
            with torch.no_grad():
                dframe = Frame(cfg, state.params, state.buffers, tcam, None,
                               dense=True)
                for stage in ("prepare", "cull_binning", "records"):
                    getattr(dframe, stage)()
            for mode in (True, False):
                check_dense_vs_flat(frame, dframe, mode, **where)
                check_dense_schedules(dframe, mode, **where)
            for f in (frame, dframe):
                time_kernels(f, lean, card=smi, **where)
            del dframe
            # the bf16 chart stream's entries on the same pairs
            bf16_t = bf16_kernel_checks(frame, stats, lean, note, smi,
                                        **where)
        if name == "trained_scene_4e6":
            # informational, for the flat-or-dense question: the three
            # flat kernels on this view's pairs beside the three dense
            # ones (the dispatch sends this pad to dense), before the
            # timed steps move the state
            with torch.no_grad():
                fframe = Frame(cfg, state.params, state.buffers, tcam, None)
                for stage in ("prepare", "cull_binning", "records"):
                    getattr(fframe, stage)()
            check_dense_vs_flat(fframe, frame, lean, **where)
            emit("flat_vs_dense", card=smi, lean=lean,
                 flat_kernel_ms=time_kernels(fframe, lean, card=smi, **where),
                 dense_kernel_ms=time_kernels(frame, lean, card=smi, **where),
                 **where)
            del fframe

        timing = step_timing(lambda: train_step.train_step(
            cfg, method.optim, state, tcam, img), all_counters, H * W)
        # each kernel alone on this view's inputs, beside its plain version
        flat_in = tier.flat(k_in)
        arrays = 1 if dense else 2
        maps, ncon = tier.fwd(k_in, grid, s_cap, lean)
        g = cotangents()
        tex_hw = frame.buffers.texture_hw
        kt = {
            fwd_name: dict(
                ms=cuda_ms(lambda: tier.fwd(k_in, grid, s_cap, lean), 20),
                plain_ms=checks[lean][fwd_name][1],
                **fwd_bound(flat_in, tex_hw, grid, stats, lean,
                            list_arrays=arrays)),
            bwd_name: dict(
                ms=cuda_ms(lambda: tier.bwd(k_in, maps, ncon, g, grid, s_cap,
                                            lean), 20),
                plain_ms=checks[lean][bwd_name][1],
                **bwd_bound(flat_in, tex_hw, grid, s_cap, ncon,
                            int(stats.blended), lean, list_arrays=arrays)),
        }
        train_t[name] = dict(timing, lean=lean, pair_cap=pair_cap,
                             s_cap=s_cap, total_pairs=frame.bins.total_pairs,
                             kernels=kt, **charts)
        emit("timing", path="train", scene=name, card=smi, **train_t[name])
        # the tier's eval kernel alone, and an eval frame of this state
        # served at its training pad
        kt[eval_name] = dict(
            ms=cuda_ms(lambda: tier.eval(k_in, grid, s_cap), 50),
            plain_ms=eval_plain_ms,
            **fwd_bound(flat_in, tex_hw, grid, stats, True, planes=8,
                        list_arrays=arrays))
        bg = render_cli.eval_background(cfg, DEVICE)

        def whole():
            with torch.no_grad():
                return model.render(cfg, state.params, state.buffers, tcam,
                                    STEP, bg, eval_only=True)
        frame_ms, lo, hi = host_ms(whole)
        busy_ms, top, trace = device_ms(whole, 5)
        emit("timing", path="eval", scene=name, card=smi,
             kernel=eval_name, kernel_ms=kt[eval_name]["ms"],
             plain_ms=eval_plain_ms, frame_ms=frame_ms, frame_ms_min=lo,
             frame_ms_max=hi, trace_stage_ms=trace, device_busy_ms=busy_ms,
             device_idle_share=1.0 - busy_ms / frame_ms, device_top_ms=top,
             mpix_per_s=H * W / frame_ms / 1e3,
             **{k: v for k, v in kt[eval_name].items()
                if k not in ("ms", "plain_ms")}, **charts)
        del state, frame, k_in, flat_in, maps, ncon, tier
        torch.cuda.empty_cache()

    # the pair-space tiers and the dense tier, one state at (16, 24)
    cfg, params, buffers, img = loaded(dataclasses.replace(
        mcfg, pixel_num=PAIR_PIXEL_NUM), STATS)
    require(tuple(cfg.chart_pad) == PAIR_PAD,
            f"pixel_num {PAIR_PIXEL_NUM}: chart pad {cfg.chart_pad}")
    cfg, state = recharted_state(cfg, method.optim, params, buffers, tcam)
    del params, buffers
    # each renderer's steps start from their own copy of this state
    start = (model.GStexParams(*(p.detach().clone() for p in state.params)),
             state.buffers)
    lean = model.lean_losses(cfg)
    hw = state.buffers.texture_hw
    charts = dict(chart_pad=list(cfg.chart_pad), lists="dense",
                  max_active_hw=[int(x) for x in hw.amax(0)])
    frame, stats, p_in = pair_frame(cfg, state.params, state.buffers, tcam)
    # the dense eval kernel's bound at this pad (its ms: dense_ms below)
    eval_bound_1e5 = fwd_bound(frame.tier.flat(frame.inputs), hw, frame.grid,
                               stats, True, planes=8, list_arrays=1)
    for renderer in ("pallas3", "pallas2", "pallas1", "pallas4"):
        rcfg = dataclasses.replace(cfg, renderer=renderer)
        r_state = train_step.init_state(cfg, method.optim, *start, seed=0)
        r_state.step = STEP
        timing = step_timing(lambda: train_step.train_step(
            rcfg, method.optim, r_state, tcam, img), all_counters, H * W)
        train_t[f"trained_scene_1e5_{renderer}"] = dict(
            timing, lean=lean, pair_cap=cfg.pair_cap, s_cap=cfg.s_max,
            total_pairs=frame.bins.total_pairs, **charts)
        emit("timing", path="train", scene="trained_scene_1e5",
             renderer=renderer, card=smi,
             **train_t[f"trained_scene_1e5_{renderer}"])
    # each pair-space kernel alone on this view's copies, beside its plain
    # version (phase 3, the same scene and pad) and its bound; the dense
    # kernels on the same lists
    pair_t, copies = time_pair_kernels((3, 2, 1), p_in, frame, stats, lean,
                                       pair_plain_ms)
    dense_ms = time_kernels(frame, lean, card=smi, scene="trained_scene_1e5",
                            **charts)
    emit("timing", path="pair_kernels", scene="trained_scene_1e5", card=smi,
         lean=lean, kernels=pair_t, dense_kernel_ms=dense_ms, **copies,
         **charts)
    del state, r_state, start, frame, p_in
    torch.cuda.empty_cache()
    # the nerfstudio main path's shapes: pad (40, 80), 800x600, masks
    dtu_t = dtu_step_timing(Path(tmp.name), all_counters, smi, note)
    torch.cuda.empty_cache()
    tmp.cleanup()
    # the SSIM kernel on phase 3's pairs, the training loss's shapes (its
    # time does not depend on the data); the 800x800 one for the kernels
    # line
    ssim_by_shape = {}
    for shape, (a, b) in ssim_pairs.items():
        ssim_by_shape[shape] = dict(
            ms=graph_ms(lambda: ssim_fused.fused_ssim_value_and_grad(a, b),
                        100),
            # the same call with its wrapper's host work, as a step pays it
            call_ms=cuda_ms(
                lambda: ssim_fused.fused_ssim_value_and_grad(a, b), 100),
            plain_ms=cuda_ms(lambda: ssim_fused.fused_ssim_reference(a, b),
                             5),
            float64_ms=cuda_ms(lambda: ssim_fused.fused_ssim_reference(
                a.double(), b.double()), 5),
            **ssim_bound(a.shape))
        emit("timing", path="ssim", card=smi, shape=list(a.shape),
             launches_per_call=1, **ssim_by_shape[shape])
    ssim_t = ssim_by_shape[f"{H}x{W}x3"]

    main_e = timings["trained_scene_stats"]
    main_t = dict(train_t["trained_scene_stats"]["kernels"],
                  ssim_fused=ssim_t, **train_t["trained_scene_4e6"]["kernels"],
                  **pair_t)
    # the v1 kernels at their main path's shapes: the nerfstudio view at
    # (40, 80); their (16, 24) times stand on the trained_scene_1e5
    # pair_kernels line beside v3's and v2's
    main_t.update(dtu_t)
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
        # served at (8, 8), and at the trained scene's training pad
        "ms_by_pad": {"8x8": main_e["kernel_ms"], "40x80": main_t[
            "rasterize_eval"]["ms"]},
    }]
    # kernel: (the TPU kernel it replaces, the counter and the main-path
    # run that drove it)
    driven = {
        "rasterize_fwd": ("gstex_tpu/ops/rasterize_pallas5.py:140",
                          flat_launches["rasterize_fwd"]),
        "rasterize_bwd": ("gstex_tpu/ops/rasterize_pallas5.py:561",
                          flat_launches["rasterize_bwd"]),
        "ssim_fused": ("gstex_tpu/ops/ssim_fused.py:63",
                       flat_launches["fused_ssim_value_and_grad"]),
        "rasterize_dense_fwd": ("gstex_tpu/ops/rasterize_pallas4.py:215",
                                dense_launches["rasterize_dense_fwd"]),
        "rasterize_dense_eval": ("gstex_tpu/ops/rasterize_pallas4.py:430",
                                 dense_launches["rasterize_dense_eval"]),
        "rasterize_dense_bwd": ("gstex_tpu/ops/rasterize_pallas4.py:585",
                                dense_launches["rasterize_dense_bwd"]),
        "rasterize_v3_fwd": ("gstex_tpu/ops/rasterize_pallas3.py:156",
                             pair_launches["pallas3"]["rasterize_v3_fwd"]),
        "rasterize_v3_bwd": ("gstex_tpu/ops/rasterize_pallas3.py:315",
                             pair_launches["pallas3"]["rasterize_v3_bwd"]),
        "rasterize_v2_fwd": ("gstex_tpu/ops/rasterize_pallas2.py:197",
                             pair_launches["pallas2"]["rasterize_v2_fwd"]),
        "rasterize_v2_bwd": ("gstex_tpu/ops/rasterize_pallas2.py:338",
                             pair_launches["pallas2"]["rasterize_v2_bwd"]),
        "rasterize_v1_fwd": ("gstex_tpu/ops/rasterize_pallas.py:307",
                             dtu_launches["rasterize_v1_fwd"]),
        "rasterize_v1_bwd": ("gstex_tpu/ops/rasterize_pallas_bwd.py:42",
                             dtu_launches["rasterize_v1_bwd"]),
    }
    for k, (where, n_launches) in driven.items():
        kernels.append({
            "name": k, "route": "cuda", "source": f"gstex_torch/csrc/{k}.cu",
            "replaces": where, "launches": n_launches,
            "max_abs_err": worst[k], "ms": main_t[k]["ms"],
            "plain_ms": main_t[k]["plain_ms"],
            "bound_ms": main_t[k]["bound_ms"],
            "bound_by": main_t[k]["bound_by"],
            # no single PyTorch call computes any of these (the SSIM's
            # plain version is five conv2d calls plus autograd)
            "library_ms": None,
        })
    # beyond the TPU's kernels: texture painting's, at (40, 80) on its main
    # path (phase 5's run replaying its two edits), and at (64, 128)
    edit_main = edit_t["40x80"]["checks"][0]
    kernels.append({
        "name": "texture_edit", "route": "cuda",
        "source": "gstex_torch/csrc/texture_edit.cu",
        # plain JAX there: no pallas_call
        "replaces": "gstex_tpu/ops/texture_edit.py:42",
        "launches": edit_t["40x80"]["launches"],
        "max_abs_err": max(c["max_abs_err"] for t in edit_t.values()
                           for c in t["checks"]),
        "ms": edit_main["ms"], "plain_ms": edit_main["plain_ms"],
        "bound_ms": edit_main["bound_ms"], "bound_by": edit_main["bound_by"],
        "library_ms": None,   # no single PyTorch call computes this
        "call_ms": edit_main["call_ms"],
        "ms_by_pad": {pad: t["checks"][0]["ms"] for pad, t in edit_t.items()},
        "bound_ms_by_pad": {pad: t["checks"][0]["bound_ms"]
                            for pad, t in edit_t.items()},
    })
    # the flat kernels' bf16 chart entries, on phase 10's (40, 80) pairs
    # and phase 5f's run
    tpu_lines = {"rasterize_eval_bf16": "gstex_tpu/ops/rasterize_pallas5.py:363",
                 "rasterize_fwd_bf16": "gstex_tpu/ops/rasterize_pallas5.py:140",
                 "rasterize_bwd_bf16": "gstex_tpu/ops/rasterize_pallas5.py:561"}
    for k in BF16_NAMES:
        t = bf16_t[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": f"gstex_torch/csrc/{k[:-len('_bf16')]}.cu",
            "replaces": tpu_lines[k], "launches": bf16_launches[k],
            "max_abs_err": worst[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,   # no single PyTorch call computes this
            "f32_ms": t["f32_ms"], "bytes_ms": t["bytes_ms"],
            "ops_ms": t["ops_ms"]})
    by_name = {k["name"]: k for k in kernels}
    for k in ("rasterize_dense_fwd", "rasterize_dense_bwd"):
        by_name[k]["ms_by_pad"] = {"64x128": main_t[k]["ms"],
                                   "16x24": dense_ms[k]}
    dense_eval = {"64x128": main_t["rasterize_dense_eval"],
                  "16x24": dict(ms=dense_ms["rasterize_dense_eval"],
                                **eval_bound_1e5),
                  "88x88": train_t[f"subsample_{SUBSAMPLE}"]["kernels"][
                      "rasterize_dense_eval"]}
    by_name["rasterize_dense_eval"]["ms_by_pad"] = {
        pad: t["ms"] for pad, t in dense_eval.items()}
    by_name["rasterize_dense_eval"]["bound_ms_by_pad"] = {
        pad: t["bound_ms"] for pad, t in dense_eval.items()}
    by_name["ssim_fused"]["ms_by_shape"] = {
        shape: t["ms"] for shape, t in ssim_by_shape.items()}
    require(all(k["launches"] > 0 for k in kernels),
            f"a kernel of the main paths never launched: "
            f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}, default=plain), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
