"""Readings for a cell's comparison limits, on the card: for each seed the
port's first steps through the timed path against the reference (sound
runs), and on the control seeds the control and each planted fault
(``faults.py``) against the same reference.

    python3 -m port_bench.calibrate --workload <name> --seeds S [S ...] \
        [--control-seeds S [S ...]]

The control is the port with its bf16 chart stream
(``texel_dtype="bf16"``) where the cell's tier has one (the flat tier),
else the reference itself computing its per-pixel work in bfloat16. One
JSON line a reading on standard output; set-up is paid once a seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys

import torch

from . import check, faults, scene, spec, train_cell
from .reference import gstex_ref as ref


def program_first(sp, seed, inputs, texel_dtype="f32", fault=None):
    cell = train_cell.build(sp.config, sp.traffic, seed, "cuda",
                            texel_dtype=texel_dtype, inputs=inputs)
    tier = train_cell.tier(cell.mcfg, cell.pad)
    if fault is None:
        first = train_cell.first_steps(cell)
    else:
        with faults.planted(fault):
            first = train_cell.first_steps(cell)
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return first, tier


def reference_first(first, views, gts, bg, st):
    """The reference in the port's place: a ``first`` of its own steps."""
    records, params = check.reference_run(first, views, gts, bg, st, "cuda")
    beta = 1.0 - ref.BETA1
    return dict(first, losses=[r.loss for r in records],
                moments1={k: (torch.zeros_like(first["params0"][k])
                              if g is None else beta * g.detach().float().cpu())
                          for k, g in records[0].grads.items()},
                params1={k: v.float().cpu() for k, v in params.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    ref.no_tf32()
    sp = spec.cell(args.workload)
    cfg = sp.config
    st = scene.settings(cfg)
    bg = scene.background(cfg, "cuda")
    for seed in args.seeds:
        cell = train_cell.build(cfg, sp.traffic, seed, "cuda")
        inputs, tier = cell.inputs, train_cell.tier(cell.mcfg, cell.pad)
        first = train_cell.first_steps(cell)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        views, gts = inputs[2], inputs[3]
        records, ref_params = check.reference_run(first, views, gts, bg, st,
                                                  "cuda")

        def emit(variant, got):
            r = check.readings(got, records, ref_params, st, "cuda")
            print(json.dumps({"seed": seed, "variant": variant, "tier": tier,
                              **r}, default=float), flush=True)

        emit("sound", first)
        if seed in args.control_seeds:
            if tier == "flat":
                emit("control_bf16_charts",
                     program_first(sp, seed, inputs, texel_dtype="bf16")[0])
            else:
                emit("control_reference_bf16", reference_first(
                    first, views, gts, bg,
                    dataclasses.replace(st, dtype=torch.bfloat16)))
            for kind in faults.KINDS:
                emit("fault_" + kind,
                     program_first(sp, seed, inputs, fault=kind)[0])
        del inputs, records, ref_params, views, gts
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
