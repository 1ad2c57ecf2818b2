#!/usr/bin/env python3
"""Time compile-time variants of the port's kernels on one card, on the
main path's shapes.

    python3 tools/kernel_variants.py [--kernels eval dense_fwd ssim ...]
        [--reps N] [--ssim-parent CSRC] [--parent CSRC] [--dtu-data DIR]

Each variant is this tree's ``gstex_torch/csrc`` with a few source lines
substituted (a chunk size, a launch bound, the ring, the tile order, a
walk option, a band height, a second launch), built by ``nvcc`` with
the port's flags into ``build/variants/`` and swapped in under the
kernel's wrapper, so that every variant runs through the same Python
call; an SSIM variant may also fix the strips' height
(``ssim_fused.launch_geometry``'s ``tile_h``). A variant whose
substitution no longer matches the source is reported as absent. The scenes are ``chip_smoke.py``'s: the
trained-scene statistics at (8, 8) on phase 3's view, and re-charted on
phase 10's view at their auto pad (40, 80), at pixel_num 4e6 (64, 128)
and at 1e5 (16, 24); the pair-space kernels on per-slot copies of the
(16, 24) lists, and with ``--dtu-data DIR`` the v1 forward also on the
nerfstudio path's view (``flat_step_ab.py``'s ``dtu_pallas1`` state:
800x600, pad (40, 80), its capture written into DIR unless it is there);
SSIM on seeded 800x800x3 and 800x600x3 image pairs (the training loss's
shapes on the Blender and the DTU path). Per scene each variant is timed
in two turns (CUDA events, mean of ``--reps``), in the listed order and
then reversed, and held to the first variant's output (the eval kernels,
the dense, the v2 and the v1 forward: bit for bit; the v3 forward: ncontrib and
t_final bit for bit, the other planes to chip_smoke's 1e-4; backwards:
chip_smoke's gates; SSIM: the float64 gates of chip_smoke, and whether
its gradient is bit-equal to the first), SSIM by CUDA-graph replay
(``chip_smoke.graph_ms``: its wrapper's host work would hide it). With
``--ssim-parent CSRC`` the SSIM kernel of an older tree (its C entry as
at 21285d5) runs beside the SSIM variants; with ``--parent CSRC`` the
pair-space forwards of an older tree whose C entries take no tile order
(v3 and v1 as at 8a8a6e3, v2 as at d7a8d9f) run beside theirs. Prints one
JSON line per variant with its ``ptxas`` registers and spills, and one
per (scene, variant) with its times.
"""

import argparse
import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def const(name, value):
    """Set ``constexpr ... name = ...;`` to ``value``."""
    return (rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};")


def walk_ring(on):
    """The ring argument of the kernel's forward_tile / backward_tile."""
    return (r"(_tile<kChunk, Slots, (?:true|false), )(true|false)",
            rf"\g<1>{'true' if on else 'false'}")


def min_blocks(n):
    return (r"(__launch_bounds__\((?:kThreads|kBlock))(, \d+)?\)",
            rf"\g<1>, {n})" if n else r"\g<1>)")


BLOCK_ORDER = (r"order\[blockIdx\.x\]", "blockIdx.x")
# the eval kernels: the training forward's accumulators and run-time lean
# switch, writing the eval planes
LEAN_AT_RUN_TIME = [
    ("tile_walk.cuh", r"float acc\[kEval \? 8 : 13\]", "float acc[13]"),
    ("tile_walk.cuh", r"c < \(kEval \? 8 : 13\)", "c < 13"),
    ("tile_walk.cuh", r"if constexpr \(!kEval\) \{\n(\s*)if \(!lean\)",
     r"{\n\1if (!lean)")]
# forward_tile's loop over a chunk's splats kept rolled
NO_SPLAT_UNROLL = (
    "tile_walk.cuh", r"\n([ ]*)for \(int s = 0; s < n; \+\+s\) \{",
    r"\n\1#pragma unroll 1\n\1for (int s = 0; s < n; ++s) {")
RING = [walk_ring(True), const("kChunk", 64), const("kIdBufs", 3)]
C_256 = [const("kShflT", "true"), const("kBlock", 256)]

# the SSIM kernel's loss in a second, one-block launch, as the first port
# added it: no ticket, a fold kernel after the tile kernel
SSIM_FOLD_KERNEL = r"""__global__ void ssim_fold_kernel(const double* __restrict__ partial,
                                 int n, double m, float* __restrict__ loss) {
  __shared__ double red[kThreads / 32];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partial[i];
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0) *loss = static_cast<float>(total / m);
}

}  // namespace"""
SSIM_FOLD_LAUNCH = r"""const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  ssim_fold_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial),
      static_cast<int>(grid.x * grid.y * grid.z),
      static_cast<double>(height - kR) * (width - kR) * channels,
      static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}"""
SSIM_TWO_LAUNCHES = [
    (r"last = atomicAdd\(&g_ticket, 1u\) == n - 1;", "last = false;"),
    (r"\}  // namespace", SSIM_FOLD_KERNEL),
    (r"return static_cast<int>\(cudaGetLastError\(\)\);\n\}\s*$",
     SSIM_FOLD_LAUNCH),
]


SSIM_IEEE_DIV = [(r"div_rn\(1\.0f, b1 \* b2\)", "1.0f / (b1 * b2)"),
                 (r"div_rn\(-s_map, b2\)", "-s_map / b2"),
                 (r"div_rn\(-s_map, b1\)", "-s_map / b1")]


def ssim_bound(n):
    return (r"__launch_bounds__\(kThreads, \d+\)",
            f"__launch_bounds__(kThreads, {n})")


# the v1 and v3 backwards' options: each against the v2 backward's
# configuration that both took
PAIR_BWD = [
    ("as built: 64 a chunk, ring, longest first, transposed reduction, "
     "384 threads, texel REDs", []),
    ("32 a chunk", [const("kChunk", 32)]),
    ("16 a chunk", [const("kChunk", 16)]),
    ("no ring (staged by plain loads)", [walk_ring(False)]),
    ("tiles in block order", [BLOCK_ORDER]),
    ("lane-0 reduction", [const("kShflT", "false")]),
    ("256 threads", [const("kBlock", 256)]),
]

# the v3 and v1 forwards' options: each against the configuration as
# built (the dense forward's; v3 at 512 threads, one block an SM)
PAIR_FWD = [
    ("as built: 64 a chunk, ring, longest first", []),
    ("32 a chunk", [const("kChunk", 32)]),
    ("16 a chunk", [const("kChunk", 16)]),
    ("no ring (staged by plain loads)", [walk_ring(False)]),
    ("tiles in block order", [BLOCK_ORDER]),
    ("the first port's options on the new slots: 16 a chunk, no ring, "
     "block order, no launch-bound minimum",
     [const("kChunk", 16), walk_ring(False), BLOCK_ORDER, min_blocks(0)]),
]
V1_FWD = PAIR_FWD + [
    ("1 block an SM", [min_blocks(1)]),
    ("2 pixels a thread (512 threads, 1 block an SM)",
     [const("kBlock", 512), min_blocks(1)]),
]
# the v2 forward's: against the form as built (512 threads, 2 pixels each,
# one block an SM), the v1 forward's form and the first port's options
V2_FWD = PAIR_FWD + [
    ("4 pixels a thread (256 threads, 2 blocks an SM)",
     [const("kBlock", 256), min_blocks(2)]),
]
# v3's own: threads a tile, and its walk's unrolling
V3_FWD = PAIR_FWD + [
    ("4 pixels a thread (256 threads, 2 blocks an SM)",
     [const("kBlock", 256), min_blocks(2)]),
    ("4 pixels a thread (256 threads, 1 block an SM)",
     [const("kBlock", 256), min_blocks(1)]),
    ("3 pixels a thread (384 threads, 1 block an SM)",
     [const("kBlock", 384), min_blocks(1)]),
    ("the pixel loop unrolled (no rotation)",
     [("tile_walk.cuh", r"#pragma unroll 1\n(\s*)for \(int j = 0; j < kPix;",
       r"#pragma unroll\n\1for (int j = 0; j < kPix;")]),
    ("all 16 slots of a chunk unrolled",
     [("tile_walk.cuh", *const("kScanUnroll", 16))]),
]

# kernel -> (source name, scenes, [(variant, [(pattern, replacement),
# ...][, strip height])]); each pattern must match the source once (a
# pattern given as (file, pattern, replacement) the named csrc header);
# the first variant is the source as it stands; an SSIM variant's strip
# height replaces the one-wave choice of ssim_fused.launch_geometry
VARIANTS = {
    "eval": ("rasterize_eval", "flat", [
        ("as built", []),
        ("64 a chunk, 2 blocks an SM", [const("kChunk", 64), min_blocks(2)]),
        ("32 a chunk, 2 blocks an SM", [const("kChunk", 32), min_blocks(2)]),
        ("64 a chunk, 3 blocks an SM", [const("kChunk", 64), min_blocks(3)]),
        ("64 a chunk, no launch bound", [const("kChunk", 64),
                                         min_blocks(0)]),
        ("tiles in block order", [BLOCK_ORDER]),
        ("no ring", [walk_ring(False)]),
        ("the lean switch at run time", LEAN_AT_RUN_TIME),
        ("the splat loop not unrolled", [NO_SPLAT_UNROLL]),
    ]),
    "dense_bwd": ("rasterize_dense_bwd", "dense", [
        ("as built", []),
        ("the dense walk: no ring, 32 a chunk, block order, lane-0 "
         "reduction, 256 threads",
         [walk_ring(False), const("kChunk", 32), const("kIdBufs", 1),
          BLOCK_ORDER, const("kShflT", "false"), const("kBlock", 256)]),
        ("(a) ring, 64 a chunk", RING + [
            BLOCK_ORDER, const("kShflT", "false"), const("kBlock", 256)]),
        ("(a) + (b) longest first", RING + [
            const("kShflT", "false"), const("kBlock", 256)]),
        ("(a) + (b) + (c) transposed reduction", RING + C_256),
        ("(a) + (b) + (c) + (d) 512 threads", RING + [
            const("kShflT", "true"), const("kBlock", 512)]),
        ("(a) + (b) + (c) + (d) 384 threads", RING + [
            const("kShflT", "true"), const("kBlock", 384)]),
        ("(a) + (b) + (d) 512 threads", RING + [
            const("kShflT", "false"), const("kBlock", 512)]),
        ("(a) + (b) + (c), 32 a chunk", [
            walk_ring(True), const("kChunk", 32), const("kIdBufs", 3)]
         + C_256),
    ]),
    "dense_fwd": ("rasterize_dense_fwd", "dense", [
        ("as built", []),
        ("the dense walk as at 21285d5: 32 a chunk, no ring, block order, "
         "no launch-bound minimum",
         [const("kChunk", 32), const("kIdBufs", 1), walk_ring(False),
          BLOCK_ORDER, min_blocks(0)]),
        ("32 a chunk", [const("kChunk", 32)]),
        ("no ring (staged by plain loads)", [walk_ring(False)]),
        ("tiles in block order", [BLOCK_ORDER]),
        ("no launch-bound minimum (the compiler's choice)", [min_blocks(0)]),
        ("3 blocks an SM", [min_blocks(3)]),
    ]),
    "ssim": ("ssim_fused", "ssim", [
        ("as built: bands of 8 rows (512 threads, 1 block an SM), strips "
         "118 wide, one wave, branch-free divisions", []),
        ("strips of 67 rows (two waves)", [], 67),
        ("strips of 200 rows", [], 200),
        ("bands of 4 rows (256 threads, 2 blocks an SM)",
         [const("kBand", 4), ssim_bound(2)]),
        ("bands of 2 rows (128 threads, 3 blocks an SM)",
         [const("kBand", 2), ssim_bound(3)]),
        ("strips 54 wide (256 threads, 2 blocks an SM)",
         [const("kMapW", 64), ssim_bound(2)]),
        ("IEEE division (a / b: its range check and slow-path branch)",
         SSIM_IEEE_DIV),
        ("two launches (the loss in a one-block fold kernel)",
         SSIM_TWO_LAUNCHES),
    ]),
    # the transposed reduction (c) on the backwards that share the walk
    "flat_bwd": ("rasterize_bwd", "flat", [
        ("as built", []),
        ("+ (c) transposed reduction",
         [(r"backward_tile<kChunk, Slots, false, true>\(",
           "backward_tile<kChunk, Slots, false, true, true>(")]),
    ]),
    "dense_eval": ("rasterize_dense_eval", "dense", [
        ("as built: 64 a chunk, ring, longest first, 2 blocks an SM", []),
        ("32 a chunk", [const("kChunk", 32)]),
        ("no ring (staged by plain loads)", [walk_ring(False)]),
        ("tiles in block order", [BLOCK_ORDER]),
        ("no launch-bound minimum (the compiler's choice)", [min_blocks(0)]),
        ("the first port's walk on forward_tile: 32 a chunk, no ring, block "
         "order, no minimum",
         [const("kChunk", 32), const("kIdBufs", 1), walk_ring(False),
          BLOCK_ORDER, min_blocks(0)]),
        ("the lean switch at run time", LEAN_AT_RUN_TIME),
        ("the splat loop not unrolled", [NO_SPLAT_UNROLL]),
    ]),
    "v2_bwd": ("rasterize_v2_bwd", "v2", [
        ("as built: 64 a chunk, ring, longest first, transposed reduction, "
         "384 threads, texel REDs", []),
        ("32 a chunk", [const("kChunk", 32)]),
        ("16 a chunk", [const("kChunk", 16)]),
        ("texel gradients staged in shared memory, 16 a chunk",
         [const("kStage", "true"), const("kChunk", 16)]),
        ("no ring (staged by plain loads)", [walk_ring(False)]),
        ("tiles in block order", [BLOCK_ORDER]),
        ("lane-0 reduction", [const("kShflT", "false")]),
        ("256 threads", [const("kBlock", 256)]),
        ("the first port's options on the new slots: 16 a chunk, staged, no "
         "ring, block order, lane-0 reduction, 256 threads",
         [const("kChunk", 16), const("kStage", "true"), walk_ring(False),
          BLOCK_ORDER, const("kShflT", "false"), const("kBlock", 256)]),
    ]),
    "v1_bwd": ("rasterize_v1_bwd", "v1", PAIR_BWD),
    "v3_bwd": ("rasterize_v3_bwd", "v3", PAIR_BWD),
    "v1_fwd": ("rasterize_v1_fwd", "v1", V1_FWD),
    "v2_fwd": ("rasterize_v2_fwd", "v2", V2_FWD),
    "v3_fwd": ("rasterize_v3_fwd", "v3", V3_FWD),
}


def build_variants(kernel, cases):
    """Build every variant of ``kernel``; returns {variant: (lib path,
    ptxas lines)} for those whose substitutions apply."""
    from gstex_torch.ops import _build

    src_dir = _build.CSRC
    name = VARIANTS[kernel][0]
    procs = {}
    absent = []
    for i, (label, subs, *_) in enumerate(cases):
        texts = {p.name: p.read_text()
                 for p in [src_dir / f"{name}.cu", *src_dir.glob("*.cuh")]}
        missing = []
        for sub in subs:
            file, pattern, repl = sub if len(sub) == 3 else (f"{name}.cu",
                                                             *sub)
            texts[file], n = re.subn(pattern, repl, texts[file],
                                     flags=re.MULTILINE)
            if n != 1:
                missing.append(pattern)
        if missing:
            absent.append((label, missing))
            continue
        out = ROOT / "build" / "variants" / f"{kernel}-{i}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for file, text in texts.items():
            (out / file).write_text(text)
        lib = out / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(out / f"{name}.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        lib)
    built = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_variants: {kernel} '{label}' did not "
                             f"build:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        built[label] = (lib, ptxas)
        print(json.dumps({"kernel": kernel, "variant": label,
                          "ptxas": ptxas}), flush=True)
    for label, missing in absent:
        print(json.dumps({"kernel": kernel, "variant": label,
                          "absent": missing}), flush=True)
    return built


# the forwards whose parent's C entry took no tile order (v3 and v1 as at
# 8a8a6e3, v2 as at d7a8d9f): the index of the order among the current
# entry's pointers
PARENT_ORDER_ARG = {"v1_fwd": 6, "v3_fwd": 6, "v2_fwd": 6}
PARENT = "the kernel as in the --parent tree"


class OrderlessEntry:
    """A C entry that takes no tile order behind the current entry's
    arguments: the wrapper sets ``argtypes`` and calls with the order
    pointer at ``at``, which is dropped."""

    def __init__(self, fn, at):
        self.fn, self.at = fn, at
        self.argtypes, self.restype = None, ctypes.c_int

    def __call__(self, *args):
        def drop(xs):
            return list(xs[:self.at]) + list(xs[self.at + 1:])
        self.fn.argtypes = drop(self.argtypes)
        self.fn.restype = self.restype
        return self.fn(*drop(args))


def parent_variant(kernel, csrc):
    """Build ``kernel``'s source of another tree (its C entry without a
    tile order) with the port's flags; returns (lib path, ptxas lines)."""
    from gstex_torch.ops import _build

    name = VARIANTS[kernel][0]
    out = ROOT / "build" / "variants" / f"{kernel}-parent"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    lib = out / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(out / f"{name}.cu")], capture_output=True,
                          text=True, check=True)
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    print(json.dumps({"kernel": kernel, "variant": PARENT, "ptxas": ptxas}),
          flush=True)
    return lib, ptxas


def load_variant(kernel, label, lib):
    """What ``_build.load`` would return for this variant's library."""
    cdll = ctypes.CDLL(str(lib))
    if label != PARENT:
        return cdll
    name = VARIANTS[kernel][0]
    return SimpleNamespace(**{f"gstex_{name}": OrderlessEntry(
        getattr(cdll, f"gstex_{name}"), PARENT_ORDER_ARG[kernel])})


def frame_of(cs, cfg, params, buffers, cam, dense):
    """A Frame of ``chip_smoke``'s eval path, through the records stage."""
    import torch

    with torch.no_grad():
        frame = cs.Frame(cfg, params, buffers, cam, None, dense=dense)
        for stage in ("prepare", "cull_binning", "records"):
            getattr(frame, stage)()
    return frame


def phase3_frame(cs, dense):
    """The trained-scene statistics at (8, 8) on phase 3's view."""
    import torch
    from gstex_torch.data.synthetic import orbit_camera
    from gstex_torch.models import gstex as model
    from gstex_torch.models import init_io
    from gstex_torch.scripts import render as render_cli

    cam = orbit_camera(cs.H, cs.W, dist=4.0, device=cs.DEVICE)
    with torch.no_grad():
        _, cfg, params, buffers = next(cs.scenes(model, init_io))
        pair_cap, s_cap = render_cli.demand_caps(cfg, params, buffers, [cam],
                                                 cs.STEP)
    cfg = dataclasses.replace(cfg, pair_cap=pair_cap, s_max=s_cap)
    return frame_of(cs, cfg, params, buffers, cam, dense)


def timing_frame(cs, pixel_num, dense):
    """Phase 10's state of the trained-scene statistics at ``pixel_num``,
    at its auto pad, re-charted, and its view's frame."""
    from gstex_torch.configs.methods import get_method
    from gstex_torch.data.synthetic import orbit_c2w
    from gstex_torch.models import init_io
    from gstex_torch.ops.camera import make_camera

    method = get_method("gstex-blender-nvs")
    cfg = dataclasses.replace(method.model, pixel_num=pixel_num)
    params, buffers = init_io.load_scene_npz(cfg, cs.STATS, seed=1,
                                             device=cs.DEVICE)
    cfg = dataclasses.replace(cfg, chart_pad=tuple(params.texture.shape[1:3]))
    cam = make_camera(1.2 * cs.H, 1.2 * cs.H, cs.W / 2, cs.H / 2, cs.H, cs.W,
                      orbit_c2w(4.0, 0.0), device=cs.DEVICE)
    cfg, state = cs.recharted_state(cfg, method.optim, params, buffers, cam)
    return frame_of(cs, cfg, state.params, state.buffers, cam, dense)


def ssim_pairs(cs):
    """(shape, prediction, ground truth): seeded pairs at the training
    loss's shapes; the kernel's time does not depend on the data."""
    import torch

    for shape in ((cs.H, cs.W, 3), (600, cs.W, 3)):
        gen = torch.Generator(device=cs.DEVICE).manual_seed(3)
        pred = torch.rand(shape, generator=gen, device=cs.DEVICE)
        noisy = torch.clamp(pred + 0.05 * torch.randn(
            shape, generator=gen, device=cs.DEVICE), 0, 1)
        yield shape, pred, noisy


PARENT_SSIM = "the kernel as at 21285d5 (32 x 32 tiles of one channel)"


def parent_ssim(csrc):
    """The SSIM kernel of an older source tree whose C entry is
    ``gstex_ssim_fused(x, y, taps (device), partial, loss, grad, h, w, c,
    c1, c2, stream)`` with one partial sum per 32 x 32 tile and channel
    (the tree at 21285d5), built with the port's flags; returns a call
    ``(pred, gt) -> (loss, grad)``."""
    import torch
    from gstex_torch.ops import _build
    from gstex_torch.ops.ssim import gaussian_window

    out = ROOT / "build" / "variants" / "ssim-parent"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libssim_fused.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(Path(csrc) / "ssim_fused.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).gstex_ssim_fused
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    taps = torch.as_tensor(gaussian_window(11, 1.5), device="cuda")

    def run(pred, gt):
        h, w, c = pred.shape
        partial = torch.empty(-(-h // 32) * -(-w // 32) * c,
                              dtype=torch.float64, device=pred.device)
        loss = torch.empty((), dtype=torch.float32, device=pred.device)
        grad = torch.empty_like(pred)
        rc = fn(pred.data_ptr(), gt.data_ptr(), taps.data_ptr(),
                partial.data_ptr(), loss.data_ptr(), grad.data_ptr(), h, w,
                c, 1e-4, 9e-4, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's ssim_fused failed: {rc}")
        return loss, grad
    return run


def time_ssim(cs, built, heights, reps, smi, parent=None):
    """Each SSIM variant (and, given, the parent tree's kernel) on each
    pair, held to the float64 evaluation by chip_smoke's gates."""
    import functools

    import torch
    from gstex_torch.ops import _build, ssim_fused

    labels = list(built) + ([PARENT_SSIM] if parent else [])
    one_wave = ssim_fused.launch_geometry

    def use(label):
        if label == PARENT_SSIM:
            return
        _build._loaded["ssim_fused"] = ctypes.CDLL(str(built[label][0]))
        ssim_fused._kernels.clear()
        ssim_fused.launch_geometry = (
            functools.partial(one_wave, tile_h=heights[label])
            if label in heights else one_wave)
    for shape, pred, noisy in ssim_pairs(cs):
        exact = ssim_fused.fused_ssim_reference(pred.double(),
                                                noisy.double())
        scale = float(exact[1].abs().max())
        calls = {label: (lambda: ssim_fused.fused_ssim_value_and_grad(
            pred, noisy)) for label in built}
        if parent:
            calls[PARENT_SSIM] = lambda: parent(pred, noisy)
        times = {label: [] for label in labels}
        checks = {}
        first = None
        try:
            for turn in (labels, labels[::-1]):
                for label in turn:
                    use(label)
                    run = calls[label]
                    loss, grad = run()
                    torch.cuda.synchronize()
                    first = grad if first is None else first
                    loss_err = abs(float(loss) - float(exact[0]))
                    grad_err = float((grad.double() - exact[1]).abs()
                                     .max()) / scale
                    cs.require(loss_err <= cs.SSIM_LOSS_TOL
                               and grad_err <= cs.SSIM_GRAD_TOL,
                               f"{shape}: SSIM variant '{label}': loss "
                               f"{loss_err}, gradient {grad_err}")
                    checks[label] = dict(
                        loss_abs_err=loss_err, grad_rel_err=grad_err,
                        grad_bit_equal_to_first=bool(torch.equal(grad,
                                                                 first)))
                    times[label].append(cs.graph_ms(run, reps))
        finally:
            ssim_fused.launch_geometry = one_wave
            _build._loaded.pop("ssim_fused")
            ssim_fused._kernels.clear()
        for label, ms in times.items():
            print(json.dumps({"kernel": "ssim", "shape": list(shape),
                              "variant": label,
                              "tile_h": heights.get(label, "one wave"),
                              **checks[label], "ms_turns": ms, "card": smi}),
                  flush=True)


def dtu_frame(cs, data):
    """The nerfstudio path's view as ``flat_step_ab.py --tier dtu_pallas1``
    trains it (its capture written into ``data`` unless it is there): the
    dense frame of its re-charted state and the per-slot copies."""
    sys.path.insert(0, str(ROOT / "tools"))
    from flat_step_ab import dtu_state

    _, cfg, state, cam, _, _ = dtu_state(cs, Path(data).resolve())
    frame, _, p_in = cs.pair_frame(cfg, state.params, state.buffers, cam)
    return frame, p_in


def scenes(cs, kind, dtu=None):
    """(scene, frame, tier, inputs) of each scene a kernel is timed on;
    the v1 kernels' also on the nerfstudio view, given its capture's
    directory ``dtu``."""
    from gstex_torch.configs.methods import get_method

    pixel_num = get_method("gstex-blender-nvs").model.pixel_num
    if kind == "flat":
        makers = (("trained_scene_stats_8x8", lambda: phase3_frame(cs, False)),
                  ("trained_scene_stats_40x80",
                   lambda: timing_frame(cs, pixel_num, False)))
    elif kind == "dense":
        makers = (("trained_scene_4e6",
                   lambda: timing_frame(cs, cs.DENSE_PIXEL_NUM, True)),
                  ("trained_scene_1e5",
                   lambda: timing_frame(cs, cs.PAIR_PIXEL_NUM, True)),
                  ("trained_scene_stats_8x8", lambda: phase3_frame(cs, True)))
    else:
        frame = timing_frame(cs, cs.PAIR_PIXEL_NUM, True)
        yield ("trained_scene_1e5", frame, cs.pair_tier(int(kind[1])),
               cs.pair_copies(frame))
        if dtu is not None and kind == "v1":
            frame = None   # its copies go before the DTU view's are made
            frame, p_in = dtu_frame(cs, dtu)
            yield "dtu_800x600", frame, cs.pair_tier(1), p_in
        return
    for label, make in makers:
        frame = make()
        yield label, frame, frame.tier, frame.inputs


def time_variants(cs, kernel, built, reps, smi, dtu=None):
    import torch
    from gstex_torch.models import gstex as model
    from gstex_torch.ops import _build
    from gstex_torch.ops import rasterize_fwd as rfwd

    name, kind, _ = VARIANTS[kernel]
    labels = list(built)
    for scene, frame, tier, k_in in scenes(cs, kind, dtu):
        grid, s_cap = frame.grid, frame.cfg.s_max
        lean = model.lean_losses(frame.cfg)
        if kernel in ("eval", "dense_eval"):
            def run():
                return tier.eval(k_in, grid, s_cap)
        elif kernel in ("dense_fwd", "v3_fwd", "v2_fwd", "v1_fwd"):
            def run():
                return tier.fwd(k_in, grid, s_cap, lean)
        else:
            maps, ncon = tier.fwd(k_in, grid, s_cap, lean)
            g = cs.cotangents()

            def run():
                return tier.bwd(k_in, maps, ncon, g, grid, s_cap, lean)
        times = {label: [] for label in labels}
        first = None
        for turn in (labels, labels[::-1]):
            for label in turn:
                _build._loaded[name] = load_variant(kernel, label,
                                                    built[label][0])
                out = run()
                torch.cuda.synchronize()
                if first is None:
                    first = out
                elif kernel in ("eval", "dense_eval"):
                    cs.require(torch.equal(out, first),
                               f"{scene}: eval variant '{label}' differs")
                elif kernel in ("dense_fwd", "v2_fwd", "v1_fwd"):
                    cs.require(torch.equal(out[0], first[0])
                               and torch.equal(out[1], first[1]),
                               f"{scene}: forward variant '{label}' differs")
                elif kernel == "v3_fwd":
                    err = float((out[0] - first[0]).abs().max())
                    cs.require(torch.equal(out[1], first[1])
                               and torch.equal(out[0][12], first[0][12])
                               and err <= cs.TOL,
                               f"{scene}: forward variant '{label}' differs: "
                               f"{err}")
                else:
                    errs, flip, _ = cs.bwd_errors(*out, *first)
                    cs.require(max(errs.values()) <= cs.BWD_TOL
                               and flip <= cs.FLIP_TOL,
                               f"{scene}: variant '{label}' differs: {errs}")
                times[label].append(cs.cuda_ms(run, reps))
        _build._loaded.pop(name)
        if kernel == "eval":
            # a yardstick: the flat training forward, lean, on the same pairs
            times["reference: the flat training forward, lean"] = [
                cs.cuda_ms(lambda: rfwd.rasterize_fwd(*k_in, grid, s_cap,
                                                      lean=True), reps)
                for _ in range(2)]
        if kernel == "dense_eval":
            times["reference: the dense training forward, lean"] = [
                cs.cuda_ms(lambda: tier.fwd(k_in, grid, s_cap, True), reps)
                for _ in range(2)]
        for label, ms in times.items():
            print(json.dumps({"kernel": kernel, "scene": scene,
                              "chart_pad": list(frame.cfg.chart_pad),
                              "lean": lean, "variant": label,
                              "ms_turns": ms, "card": smi}), flush=True)
        del frame, tier, k_in, run, first
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ssim-parent", metavar="CSRC", default=None,
                    help="also time, and compare bit for bit, the SSIM "
                         "kernel of this csrc directory (its C entry as "
                         "at 21285d5)")
    ap.add_argument("--parent", metavar="CSRC", default=None,
                    help="also time, and hold to the first variant, the "
                         "pair-space forwards of this csrc directory "
                         "(C entries without a tile order: v3 and v1 as at "
                         "8a8a6e3, v2 as at d7a8d9f)")
    ap.add_argument("--dtu-data", metavar="DIR", default=None,
                    help="also time the v1 forward on the nerfstudio "
                         "path's view, its capture written into DIR unless "
                         "it is there")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    import chip_smoke as cs
    from gstex_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build(["rasterize_eval", "rasterize_fwd", "rasterize_bwd",
                  "rasterize_dense_eval", "rasterize_dense_fwd",
                  "rasterize_dense_bwd", "rasterize_v3_fwd",
                  "rasterize_v3_bwd", "rasterize_v2_fwd", "rasterize_v2_bwd",
                  "rasterize_v1_fwd", "rasterize_v1_bwd"])
    for kernel in args.kernels:
        cases = VARIANTS[kernel][2]
        built = build_variants(kernel, cases)
        if args.parent and kernel in PARENT_ORDER_ARG:
            built[PARENT] = parent_variant(kernel, args.parent)
        if kernel == "ssim":
            heights = {c[0]: c[2] for c in cases if len(c) > 2}
            time_ssim(cs, built, heights, 2 * args.reps, smi,
                      parent_ssim(args.ssim_parent) if args.ssim_parent
                      else None)
        else:
            time_variants(cs, kernel, built, args.reps, smi,
                          args.dtu_data if kernel == "v1_fwd" else None)


if __name__ == "__main__":
    main()
