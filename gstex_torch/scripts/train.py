"""gstex-torch-train: train a GStex method on a Blender-format dataset.

The counterpart of ``gstex-train`` for the port. The scene starts from
``--init-npz``, a gstex-npz export or a trained-scene-statistics file
(``models/init_io.py:load_scene_npz``; ``--seed`` seeds its random
fills). Pair capacities are sized from the first view's measured demand.
The run writes ``config.json``, ``metrics.jsonl`` and a checkpoint under
``--output-dir``, and, where the dataset has a test split, prints the
mean eval PSNR and SSIM.

    python -m gstex_torch.scripts.train gstex-blender-nvs \\
        --data DATA_DIR --init-npz assets/trained_scene_stats.npz

``--renderer`` overrides the method's render tier (``pallas``: the flat
kernels where they fit the scene's chart pad, the dense-list kernels
otherwise; ``pallas4``: the dense-list kernels; ``pallas3``, ``pallas2``:
the pair-space v3 and v2 kernels over the dense lists, for charts of at
most 40 and 42 rows; ``xla``: pure torch). A large texel budget makes
large charts, which train on the dense tier:

    python -m gstex_torch.scripts.train gstex-blender-nvs \\
        --data DATA_DIR --init-npz assets/trained_scene_stats.npz \\
        --pixel-num 4e6

and a small one makes charts that the pair-space tiers take (the
per-slot chart copies cost ``2 · tiles · s_max · Ch · Cw · 12`` bytes):

    python -m gstex_torch.scripts.train gstex-blender-nvs \\
        --data DATA_DIR --init-npz assets/trained_scene_stats.npz \\
        --pixel-num 1e5 --renderer pallas3

PLY and point-cloud init, ``--set`` overrides and the multi-device flags
of ``gstex-train`` are not offered yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

from ..configs.methods import get_method
from ..data.blender import parse_blender
from ..data.manager import FullImageCache
from ..models.init_io import load_scene_npz
from ..train.trainer import Trainer
from ..utils.checkpoint import latest_checkpoint
from ..utils.device import resolve_device


def main(argv=None) -> dict:
    """Train; returns ``{"history": per-step metrics, "checkpoint": path,
    "eval": mean eval metrics or None}``."""
    p = argparse.ArgumentParser(
        description="Train a GStex method on a Blender-format dataset.")
    p.add_argument("method")
    p.add_argument("--data", required=True,
                   help="dataset directory (transforms_<split>.json)")
    p.add_argument("--init-npz", required=True,
                   help="gstex-npz export or trained-scene-statistics file")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the scene loader's random fills")
    p.add_argument("--max-num-iterations", type=int, default=None)
    p.add_argument("--pixel-num", type=float, default=None)
    p.add_argument("--renderer", default=None,
                   help="render tier (default: the method's): pallas, "
                        "pallas4, pallas3, pallas2, xla, oracle")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    method = get_method(args.method)
    if args.pixel_num is not None:
        method.model = dataclasses.replace(method.model,
                                           pixel_num=args.pixel_num)
    if args.renderer is not None:
        method.model = dataclasses.replace(method.model,
                                           renderer=args.renderer)
    if args.max_num_iterations is not None:
        method.trainer = dataclasses.replace(
            method.trainer, max_num_iterations=args.max_num_iterations)
        method.optim = dataclasses.replace(method.optim,
                                           max_steps=args.max_num_iterations)
    out = args.output_dir or (f"outputs/{Path(args.data).name}/{method.name}/"
                              f"{time.strftime('%Y-%m-%d_%H%M%S')}")
    method.trainer = dataclasses.replace(method.trainer, output_dir=out,
                                         demand_size_caps=True)

    train_cache = FullImageCache.build(parse_blender(args.data, "train"),
                                       seed=method.trainer.seed,
                                       device=device)
    eval_cache = None
    if (Path(args.data) / "transforms_test.json").exists():
        eval_cache = FullImageCache.build(parse_blender(args.data, "test"),
                                          seed=1, device=device)
    params, buffers = load_scene_npz(method.model, args.init_npz,
                                     seed=args.seed, device=device)
    if method.model.chart_pad is None:
        method.model = dataclasses.replace(
            method.model, chart_pad=tuple(params.texture.shape[1:3]))
    run_config = {
        "method": method.name, "data": str(args.data),
        "init_npz": str(args.init_npz), "seed": args.seed,
        "model": dataclasses.asdict(method.model),
        "optim": dataclasses.asdict(method.optim),
        "trainer": dataclasses.asdict(method.trainer),
        "num_gaussians": int(params.means.shape[0]),
    }
    Path(out).mkdir(parents=True, exist_ok=True)
    (Path(out) / "config.json").write_text(
        json.dumps(run_config, indent=2, default=str))

    trainer = Trainer(method.trainer, method.model, method.optim, params,
                      buffers, train_cache, eval_cache, run_config)
    history = trainer.train()
    results = None
    if eval_cache is not None:
        results = trainer.eval_all()
        (Path(out) / "eval.json").write_text(json.dumps(results, indent=2))
        print(json.dumps(results))
    return {"history": history,
            "checkpoint": str(latest_checkpoint(Path(out) / "checkpoints")),
            "eval": results}


if __name__ == "__main__":
    main()
