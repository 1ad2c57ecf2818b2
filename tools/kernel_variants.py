#!/usr/bin/env python3
"""Time compile-time variants of the port's kernels on one card, on the
main path's shapes.

    python3 tools/kernel_variants.py [--kernels eval dense_bwd ...]
        [--reps N]

Each variant is this tree's ``gstex_torch/csrc`` with a few source lines
substituted (a chunk size, a launch bound, the ring, the tile order, a
walk option), built by ``nvcc`` with the port's flags into
``build/variants/`` and swapped in under the kernel's wrapper, so that
every variant runs through the same Python call. A variant whose
substitution no longer matches the source is reported as absent. The
scenes are ``chip_smoke.py``'s: the trained-scene statistics at (8, 8) on
phase 3's view, and re-charted on phase 9's view at their auto pad
(40, 80), at pixel_num 4e6 (64, 128) and at 1e5 (16, 24); the v2 and v1
backwards on per-slot copies of the (16, 24) lists. Per scene each
variant is timed in two turns (CUDA events, mean of ``--reps``), in the
listed order and then reversed, and held to the first variant's output
(eval: bit for bit; backwards: chip_smoke's gates). Prints one JSON line
per variant with its ``ptxas`` registers and spills, and one per (scene,
variant) with its times.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def const(name, value):
    """Set ``constexpr ... name = ...;`` to ``value``."""
    return (rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};")


def walk_ring(on):
    """The ring argument of the kernel's forward_tile / backward_tile."""
    return (r"(_tile<kChunk, Slots, false, )(true|false)",
            rf"\g<1>{'true' if on else 'false'}")


def min_blocks(n):
    return (r"__launch_bounds__\(kThreads(, \d+)?\)",
            f"__launch_bounds__(kThreads, {n})" if n
            else "__launch_bounds__(kThreads)")


BLOCK_ORDER = (r"order\[blockIdx\.x\]", "blockIdx.x")
RING = [walk_ring(True), const("kChunk", 64), const("kIdBufs", 3)]
C_256 = [const("kShflT", "true"), const("kBlock", 256)]

# kernel -> (source name, scenes, [(variant, [(pattern, replacement),
# ...])]); each pattern must match the source once (a pattern given as
# (file, pattern, replacement) the named csrc header); the first variant
# is the source as it stands
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
        # the training forward's accumulators and run-time lean switch,
        # writing the eval planes
        ("the lean switch at run time", [
            ("tile_walk.cuh", r"float acc\[kEval \? 8 : 13\]",
             "float acc[13]"),
            ("tile_walk.cuh", r"c < \(kEval \? 8 : 13\)", "c < 13"),
            ("tile_walk.cuh",
             r"if constexpr \(!kEval\) \{\n(\s*)if \(!lean\)",
             r"{\n\1if (!lean)")]),
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
    # the transposed reduction (c) on the backwards that share the walk
    "flat_bwd": ("rasterize_bwd", "flat", [
        ("as built", []),
        ("+ (c) transposed reduction",
         [(r"backward_tile<kChunk, Slots, false, true>\(",
           "backward_tile<kChunk, Slots, false, true, true>(")]),
    ]),
    "v2_bwd": ("rasterize_v2_bwd", "v2", [
        ("as built", []),
        ("+ (c) transposed reduction",
         [(r"backward_tile<kPairChunk>\(",
           "backward_tile<kPairChunk, PairGradSlots, false, false, true>(")]),
    ]),
    "v1_bwd": ("rasterize_v1_bwd", "v1", [
        ("as built", []),
        ("+ (c) transposed reduction",
         [(r"backward_tile<kPairChunk, PairGradSlots, true>\(",
           "backward_tile<kPairChunk, PairGradSlots, true, false, true>(")]),
    ]),
}


def build_variants(kernel, cases):
    """Build every variant of ``kernel``; returns {variant: (lib path,
    ptxas lines)} for those whose substitutions apply."""
    from gstex_torch.ops import _build

    src_dir = _build.CSRC
    name = VARIANTS[kernel][0]
    procs = {}
    absent = []
    for i, (label, subs) in enumerate(cases):
        texts = {p.name: p.read_text()
                 for p in [src_dir / f"{name}.cu", *src_dir.glob("*.cuh")]}
        missing = []
        for sub in subs:
            file, pattern, repl = sub if len(sub) == 3 else (f"{name}.cu",
                                                             *sub)
            texts[file], n = re.subn(pattern, repl, texts[file])
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


def phase9_frame(cs, pixel_num, dense):
    """Phase 9's state of the trained-scene statistics at ``pixel_num``,
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


def scenes(cs, kind):
    """(scene, frame, tier, inputs) of each scene a kernel is timed on."""
    from gstex_torch.configs.methods import get_method

    pixel_num = get_method("gstex-blender-nvs").model.pixel_num
    if kind == "flat":
        makers = (("trained_scene_stats_8x8", lambda: phase3_frame(cs, False)),
                  ("trained_scene_stats_40x80",
                   lambda: phase9_frame(cs, pixel_num, False)))
    elif kind == "dense":
        makers = (("trained_scene_4e6",
                   lambda: phase9_frame(cs, cs.DENSE_PIXEL_NUM, True)),
                  ("trained_scene_1e5",
                   lambda: phase9_frame(cs, cs.PAIR_PIXEL_NUM, True)),
                  ("trained_scene_stats_8x8", lambda: phase3_frame(cs, True)))
    else:
        frame = phase9_frame(cs, cs.PAIR_PIXEL_NUM, True)
        yield ("trained_scene_1e5", frame, cs.pair_tier(int(kind[1])),
               cs.pair_copies(frame))
        return
    for label, make in makers:
        frame = make()
        yield label, frame, frame.tier, frame.inputs


def time_variants(cs, kernel, built, reps, smi):
    import torch
    from gstex_torch.models import gstex as model
    from gstex_torch.ops import _build
    from gstex_torch.ops import rasterize_fwd as rfwd

    name, kind, _ = VARIANTS[kernel]
    labels = list(built)
    for scene, frame, tier, k_in in scenes(cs, kind):
        grid, s_cap = frame.grid, frame.cfg.s_max
        lean = model.lean_losses(frame.cfg)
        if kernel == "eval":
            def run():
                return tier.eval(k_in, grid, s_cap)
        else:
            maps, ncon = tier.fwd(k_in, grid, s_cap, lean)
            g = cs.cotangents()

            def run():
                return tier.bwd(k_in, maps, ncon, g, grid, s_cap, lean)
        times = {label: [] for label in labels}
        first = None
        for turn in (labels, labels[::-1]):
            for label in turn:
                _build._loaded[name] = ctypes.CDLL(str(built[label][0]))
                out = run()
                torch.cuda.synchronize()
                if first is None:
                    first = out
                elif kernel == "eval":
                    cs.require(torch.equal(out, first),
                               f"{scene}: eval variant '{label}' differs")
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
                  "rasterize_dense_bwd", "rasterize_v2_fwd",
                  "rasterize_v2_bwd", "rasterize_v1_fwd", "rasterize_v1_bwd"])
    for kernel in args.kernels:
        built = build_variants(kernel, VARIANTS[kernel][2])
        time_variants(cs, kernel, built, args.reps, smi)


if __name__ == "__main__":
    main()
