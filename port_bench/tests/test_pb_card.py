"""On the card, at the cells' own sizes: the control and each planted
fault come out not correct against the cell's limits on three seeds.
Run on the card with ``python -m pytest -p no:cacheprovider -o addopts=''
port_bench/tests/test_pb_card.py``; skipped without one."""

from __future__ import annotations

import dataclasses
import gc

import pytest
import torch

from port_bench import calibrate, check, faults, scene, spec, train_cell
from port_bench.reference import gstex_ref as ref

SEEDS = (3100000007, 3100000033, 3100000061)
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_at_full_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ref.no_tf32()
    sp = spec.cell(cell)
    st = scene.settings(sp.config)
    bg = scene.background(sp.config, "cuda")
    for seed in SEEDS:
        inputs = train_cell.make_inputs(sp.config, sp.traffic, seed, "cuda")
        first, tier = calibrate.program_first(sp, seed, inputs)
        views, gts = inputs[2], inputs[3]
        records, params = check.reference_run(first, views, gts, bg, st,
                                              "cuda")
        ok, rows = check.verdict(check.readings(first, records, params, st,
                                                "cuda"), sp.limits)
        assert ok, (seed, rows)
        if tier == "flat":
            control = calibrate.program_first(sp, seed, inputs,
                                              texel_dtype="bf16")[0]
        else:
            control = calibrate.reference_first(
                first, views, gts, bg,
                dataclasses.replace(st, dtype=torch.bfloat16))
        variants = [control] + [calibrate.program_first(
            sp, seed, inputs, fault=kind)[0] for kind in faults.KINDS]
        for got in variants:
            ok, rows = check.verdict(check.readings(got, records, params,
                                                    st, "cuda"),
                                     sp.limits)
            assert not ok, rows
        del inputs, records, params
        gc.collect()
        torch.cuda.empty_cache()
