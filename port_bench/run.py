"""Run one cell of the port's benchmark on the card this process sees.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up builds the cell's scene, ground truth
and the port's training state at the traffic's start step from the seed,
sizes the binning caps to every view's demand, captures the training
step's CUDA graph through the first steps the reference follows, and
warms every shape the window uses. ``--trace 0`` then trains for
``--seconds`` and prints the cell's end-to-end metrics; ``--trace 1``
trains a stretch of at least the traffic's ``trace_steps`` steps under
``torch.profiler`` and prints its per-layer metrics. Either way the
reference then follows the first steps from the same inputs, and the run
is ``correct`` when each compared number is within its limit
(``check.py``). The last line of standard output is the result, as JSON;
the compared numbers are also the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gstex_tpu")


def cache_dirs() -> None:
    """Fixed cache directories inside the checkout (the port's kernels
    build into its own ``build/kernels/``)."""
    base = ROOT / "build" / "port_bench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(spec, seed: int, seconds: float, traced: bool, device,
             t_start: float = T_START, say=print) -> dict:
    """One run of ``spec`` on ``device``: the result object, without the
    checks' printing."""
    import numpy as np
    import torch

    from . import check, scene, trace, train_cell, work
    from .reference import gstex_ref as ref

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.init()
    ref.no_tf32()
    cfg, traffic = spec.config, spec.traffic
    lap = lambda what: say(f"[port_bench] {what} at "
                           f"{time.perf_counter() - t_start:.2f} s")
    inputs = train_cell.make_inputs(cfg, traffic, seed, dev)
    lap("inputs")
    if cuda:
        # the peak is the port's: from its inputs on the card (the ground
        # truth a trainer holds) through set-up and the window
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cell = train_cell.build(cfg, traffic, seed, dev, inputs=inputs)
    del inputs
    lap("built")
    say(f"[port_bench] {spec.name}: {cell.state.params.means.shape[0]} "
        f"surfels, pad {cell.pad}, tier "
        f"{train_cell.tier(cell.mcfg, cell.pad)}, pair_cap "
        f"{cell.mcfg.pair_cap}, s_max {cell.mcfg.s_max}")
    first = train_cell.first_steps(cell)
    lap("first steps")
    train_cell.steps_until(cell, traffic["window_from"])
    graph_kernels = None
    if traced and cuda:
        graph_kernels = cell.scan.graph_kernels([])["all"]
    cell.synchronize()
    setup_s = time.perf_counter() - t_start
    pixels = cfg["image_height"] * cfg["image_width"]
    if traced:
        prof = trace.profiler()
        steps, failed, window_s, recharts, traced_views = \
            train_cell.traced_stretch(cell, traffic["trace_steps"], prof)
        summary = trace.summary(trace.events(prof))
        del prof
    else:
        steps, failed, window_s = train_cell.window(cell, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    step_now = cell.step
    if traced:
        counted_params = {k: v.detach().clone() for k, v in
                          train_cell.params_dict(cell.state.params).items()}
        counted_buffers = {k: v.clone() for k, v in
                           cell.state.buffers._asdict().items()}
    views, gts = cell.views, cell.gts
    keep = set(first["views"])
    gts = [g if i in keep else None for i, g in enumerate(gts)]
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    lap("window closed")
    st = scene.settings(cfg)
    bg = scene.background(cfg, dev)
    records, ref_params = check.reference_run(first, views, gts, bg, st, dev)
    lap("reference")
    values = check.readings(first, records, ref_params, st, dev)
    del ref_params
    correct, rows = check.verdict(values, spec.limits)
    metrics = {}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(steps),
              "failed": int(failed)}
    if traced:
        rng = np.random.default_rng(seed)
        sample = rng.choice(len(traced_views),
                            min(traffic["count_views"], len(traced_views)),
                            replace=False)
        counts = [ref.view_counts(counted_params, counted_buffers,
                                  views[traced_views[i]], step_now, st)
                  for i in sorted(sample)]
        lap("counted")
        ctx = {"trace": summary, "window_s": window_s, "steps": steps,
               "pixels": pixels, "recharts": recharts,
               "graph_kernels": graph_kernels, "counts": counts,
               "adam_elements": work.adam_elements(counted_params,
                                                   counted_buffers)}
        for m in spec.per_layer:
            value = m["reader"](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device_info.update(busy_s=summary["busy_s"], window_s=window_s)
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        say(f"[port_bench] traced {steps} steps in {window_s:.3f} s, busy "
            f"{summary['busy_s']:.3f} s, device span "
            f"{summary['device_span_s']:.3f} s; counted views "
            f"{json.dumps(counts)}")
    else:
        by_name = {
            "train_mpix_s": steps * pixels / window_s / 1e6,
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": float(by_name[m["name"]]),
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    result["_readings"] = values
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    from . import spec as spec_mod

    sp = spec_mod.cell(args.workload)
    chips = next(w for w in spec_mod.load_benchmark()["workloads"]
                 if w["name"] == args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); this "
              f"process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    for m in sp.per_layer:
        m["reader"] = spec_mod.reader(m["name"])
    say = lambda s: print(s, file=sys.stderr, flush=True)
    say(f"[port_bench] card: {power_limit()}")
    result = run_cell(sp, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", say=say)
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    readings = result.pop("_readings")
    say("[port_bench] readings " + json.dumps(
        {k: v for k, v in readings.items()}, default=float))
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
