"""gstex-torch-train: train a GStex method on a Blender or nerfstudio
dataset.

The counterpart of ``gstex-train`` for the port. The method names the
dataparser: ``transforms_<split>.json`` for the Blender methods, a
nerfstudio ``transforms.json`` (COLMAP captures such as DTU, images
downscaled by 2 from ``images_2/``, masks where the frames name them) for
``gstex-colmap-init``, ``gstex-dtu-nvs`` and ``gstex-dtu-lod``. The scene
starts, as in ``gstex-train`` and in its order, from ``--init-ply`` (a
2DGS gaussian ply), ``--init-npz`` (a point npz: xyz, colors, opacity,
scaling, rotation), ``--init-lod-ply`` (an xyz + rgb point ply),
``--init-pcd`` (a point cloud), the dataset's seed points, or
``--num-random`` random points; the nerfstudio methods map COLMAP axes to
the model's (``fix_init``). ``--scene-npz`` instead loads a whole scene
with its charts: a gstex-npz export or a trained-scene-statistics file
(``models/init_io.py:load_scene_npz``). ``--seed`` seeds every random
draw. Pair capacities are sized from the first view's measured demand
unless ``--set`` pins them. The run writes ``config.json``,
``events.jsonl`` (the logged scalars), ``images/`` (the eval renders) and
checkpoints under ``--output-dir`` (default
``outputs/{experiment}/{method}/{timestamp}``, the experiment being
``--experiment-name`` or the dataset directory's name), and, where the
dataset has an eval split, prints the mean eval PSNR and SSIM.

    python -m gstex_torch.scripts.train gstex-dtu-nvs \\
        --data DTU_SCAN_DIR --init-ply DTU_SCAN_DIR/init.ply

    python -m gstex_torch.scripts.train gstex-blender-nvs \\
        --data DATA_DIR --scene-npz assets/trained_scene_stats.npz

``--renderer`` overrides the method's render tier (``pallas``: the flat
kernels where they fit the scene's chart pad, the dense-list kernels
otherwise; ``pallas4``: the dense-list kernels; ``pallas3``, ``pallas2``,
``pallas1``: the pair-space v3, v2 and v1 kernels over the dense lists,
for charts of at most 40, 42 and 42 rows, whose per-slot chart copies
cost ``2 · tiles · s_max · Ch · Cw · 12`` bytes; ``xla``: pure torch).
``--set SECTION.FIELD=VALUE`` overrides any field of the model, optim or
trainer config (the value parsed as JSON, else taken as a string):

    python -m gstex_torch.scripts.train gstex-dtu-nvs \\
        --data DTU_SCAN_DIR --init-ply DTU_SCAN_DIR/init.ply \\
        --renderer pallas1 --set model.lambda_reg=0.1

``--steps-per-save``, ``--steps-per-eval-image`` and ``--vis`` (metric
sinks, comma separated: tensorboard, wandb, comet; a sink whose package
is missing is skipped with a notice) set the trainer's cadences and
sinks, after any ``--set``. ``--load-checkpoint`` resumes a run from a
checkpoint of the port (``.ckpt.pt``) or of ``gstex-train``
(``.ckpt.npz``), built from the same scene flags; it continues at the
checkpoint's step:

    python -m gstex_torch.scripts.train gstex-blender-nvs \
        --data DATA_DIR --scene-npz assets/trained_scene_stats.npz \
        --load-checkpoint RUN_DIR/checkpoints/step-000002000.ckpt.pt \
        --max-num-iterations 4000

``--viewer`` serves the interactive viewer on the training state while
the run trains (``--viewer-port``, default 7007): live frames, pause and
resume, texture painting (``gstex_torch/viewer/server.py``).

``--num-devices N`` trains on N ranks, one process and one card each,
over a tile-row mesh (``parallel/shard.py``; NCCL): every rank renders
one band of each view, and the gradients are summed over the ranks.
``--data-parallel B`` splits the N ranks into B rows, each training its
own camera a step. Started by ``torchrun``, the CLI joins the group the
environment describes, rank r on ``cuda:LOCAL_RANK``; otherwise it starts
the N ranks itself, rank r on ``cuda:r``, and refuses N beyond the
visible cards. ``--device cpu --num-devices N`` runs N gloo ranks on the
CPU. Rank 0 writes the run:

    python -m gstex_torch.scripts.train gstex-blender-nvs \
        --data DATA_DIR --scene-npz assets/trained_scene_stats.npz \
        --num-devices 4 --data-parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..configs.methods import get_method
from ..data.blender import parse_blender
from ..data.manager import FullImageCache
from ..data.nerfstudio_parser import parse_nerfstudio
from ..models import gstex as model
from ..models import init_io
from ..parallel.distributed import init_distributed
from ..train.trainer import Trainer
from ..utils import ply as ply_io
from ..utils.checkpoint import latest_checkpoint
from ..utils.device import resolve_device


def build_dataset(method, data_dir, split):
    """The method's dataparser on ``data_dir``; ``FileNotFoundError`` where
    a Blender dataset has no such split."""
    if method.dataparser == "blender":
        return parse_blender(data_dir, split=split)
    return parse_nerfstudio(
        data_dir, split=split, downscale_factor=method.downscale_factor,
        eval_mode=method.eval_mode, eval_interval=method.eval_interval)


def build_model(args, method, parsed, device):
    """(params, buffers) from the first init source given, in
    ``gstex-train``'s order."""
    mcfg = method.model
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.scene_npz:
        return init_io.load_scene_npz(mcfg, args.scene_npz, seed=args.seed,
                                      device=device)
    points = dict(sh_degree=mcfg.sh_degree, generator=gen,
                  fix_init_pts=mcfg.fix_init, device=device)
    if args.init_ply:
        raw = init_io.raw_from_gaussian_ply(args.init_ply,
                                            sh_degree=mcfg.sh_degree,
                                            fix_init=mcfg.fix_init,
                                            device=device)
    elif args.init_npz:
        raw = init_io.raw_from_npz(args.init_npz, sh_degree=mcfg.sh_degree,
                                   device=device)
    elif args.init_lod_ply:
        raw = init_io.raw_from_points(*ply_io.read_point_ply(
            args.init_lod_ply), **points)
    elif args.init_pcd:
        raw = init_io.raw_from_points(*ply_io.read_pcd(args.init_pcd),
                                      **points)
    elif parsed.points_xyz is not None:
        raw = init_io.raw_from_points(parsed.points_xyz, parsed.points_rgb,
                                      **points)
    else:
        raw = init_io.raw_random(args.num_random, sh_degree=mcfg.sh_degree,
                                 generator=gen, device=device)
    return model.init_params(
        mcfg, raw["means"], raw["log_scales"], raw["quats"],
        raw["opacity_logits"], raw["features_dc"], raw["features_rest"],
        generator=gen)


def apply_override(method, spec: str):
    """Apply one ``--set SECTION.FIELD=VALUE`` override (the counterpart of
    ``gstex-train``'s, the analog of the reference's nested tyro flags,
    ``method_configs.py:136-143``)."""
    try:
        key, raw = spec.split("=", 1)
        section, name = key.split(".", 1)
    except ValueError:
        raise SystemExit(f"--set expects SECTION.FIELD=VALUE, got {spec!r}")
    target = {"model": method.model, "optim": method.optim,
              "trainer": method.trainer}.get(section)
    if target is None:
        raise SystemExit(f"--set section must be model/optim/trainer, "
                         f"got {section!r}")
    types = {f.name: str(f.type) for f in dataclasses.fields(target)}
    if name not in types:
        raise SystemExit(f"--set: {section} has no field {name!r}; "
                         f"have {sorted(types)}")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    # a JSON list for a tuple field (also one whose default is None, as
    # the chart pad's)
    if isinstance(value, list) and "tuple" in types[name]:
        value = tuple(value)
    setattr(method, section, dataclasses.replace(target, **{name: value}))
    return method


def main(argv=None) -> dict:
    """Train; returns ``{"history": per-step metrics, "checkpoint": path,
    "eval": mean eval metrics or None}`` (rank 0's, over a mesh)."""
    args = parse_args(argv)
    if args.num_devices > 1 and not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            # torchrun: one process a rank, on its local card
            local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
            device = rank_device(args.device, local)
            init_distributed(device=device)
            return train(args, device)
        return launch(args, argv)
    return train(args, resolve_device(args.device))


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: its own card (``cuda:rank``), or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    torch.cuda.set_device(rank)
    return torch.device("cuda", rank)


def launch(args, argv) -> dict:
    """Start ``--num-devices`` ranks of this command, one process each
    (rank r on ``cuda:r`` or, with ``--device cpu``, a gloo rank on the
    CPU), and return rank 0's result."""
    n = args.num_devices
    if resolve_device(args.device).type == "cuda" and \
            n > torch.cuda.device_count():
        raise ValueError(f"--num-devices {n}: one card a rank, and "
                         f"{torch.cuda.device_count()} CUDA devices are "
                         f"visible")
    rdv = tempfile.mkdtemp(prefix="gstex-torch-train-")
    try:
        # this process's host threads shared among the ranks
        threads = max(1, torch.get_num_threads() // n)
        torch.multiprocessing.start_processes(
            _rank_main, args=(n, argv, rdv, threads), nprocs=n,
            start_method="spawn")
        return json.loads((Path(rdv) / "result.json").read_text())
    finally:
        shutil.rmtree(rdv, ignore_errors=True)


def _rank_main(rank: int, world: int, argv, rdv: str, threads: int) -> None:
    torch.set_num_threads(threads)
    args = parse_args(argv)
    device = rank_device(args.device, rank)
    init_distributed(f"file://{rdv}/rendezvous", world, rank, device=device)
    try:
        res = train(args, device)
        if rank == 0:
            (Path(rdv) / "result.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train a GStex method on a Blender or nerfstudio "
                    "dataset.")
    p.add_argument("method")
    p.add_argument("--data", required=True,
                   help="dataset directory (transforms_<split>.json, or a "
                        "nerfstudio transforms.json)")
    p.add_argument("--init-ply", default=None,
                   help="2DGS gaussian ply")
    p.add_argument("--init-npz", default=None,
                   help="point npz: xyz, colors, opacity, scaling, rotation")
    p.add_argument("--init-lod-ply", default=None,
                   help="xyz + red/green/blue point ply")
    p.add_argument("--init-pcd", default=None, help="point-cloud .pcd")
    p.add_argument("--num-random", type=int, default=50000,
                   help="random points where no other init is given")
    p.add_argument("--scene-npz", default=None,
                   help="a whole scene: gstex-npz export or "
                        "trained-scene-statistics file")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the init's random draws")
    p.add_argument("--max-num-iterations", type=int, default=None)
    p.add_argument("--pixel-num", type=float, default=None)
    p.add_argument("--renderer", default=None,
                   help="render tier (default: the method's): pallas, "
                        "pallas4, pallas3, pallas2, pallas1, xla, oracle")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.FIELD=VALUE",
                   help="override a config field, e.g. --set "
                        "model.lambda_reg=0.1 (sections: model, optim, "
                        "trainer; values parsed as JSON, else strings). "
                        "--set trainer.steps_per_sync=N (N >= 1, default "
                        "8) takes up to N steps a dispatch, chunks ending "
                        "on each cadence; on the card one captured CUDA "
                        "graph replayed a step; 1 takes one step at a "
                        "time")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--load-checkpoint", default=None,
                   help="resume from a .ckpt.pt (this CLI's) or .ckpt.npz "
                        "(gstex-train's) checkpoint")
    p.add_argument("--experiment-name", default=None,
                   help="the default output path's first part (default: "
                        "the dataset's directory name)")
    p.add_argument("--steps-per-save", type=int, default=None)
    p.add_argument("--steps-per-eval-image", type=int, default=None)
    p.add_argument("--vis", default=None,
                   help="metric sinks, comma separated: tensorboard, "
                        "wandb, comet")
    p.add_argument("--viewer", action="store_true",
                   help="serve the interactive viewer while training")
    p.add_argument("--viewer-port", type=int, default=7007)
    p.add_argument("--data-parallel", type=int, default=0,
                   help="camera-batch data parallelism: split "
                        "--num-devices into (data, tile) mesh rows; each "
                        "data row trains its own camera per step "
                        "(reference DDP world_size semantics)")
    p.add_argument("--num-devices", type=int, default=0,
                   help=">1: shard tile rows across a device mesh")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    return p.parse_args(argv)


def train(args, device) -> dict:
    """The run on ``device``: this process alone, or one rank of the
    ``--num-devices`` group (rank 0 writes the run directory and runs the
    closing eval)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    method = get_method(args.method)
    if args.pixel_num is not None:
        method.model = dataclasses.replace(method.model,
                                           pixel_num=args.pixel_num)
    if args.renderer is not None:
        method.model = dataclasses.replace(method.model,
                                           renderer=args.renderer)
    for spec in args.overrides:
        method = apply_override(method, spec)
    # caps sized to the scene's measured demand, unless pinned by --set
    if not any(o.split("=")[0] in ("model.pair_cap", "model.s_max")
               for o in args.overrides):
        method.trainer = dataclasses.replace(method.trainer,
                                             demand_size_caps=True)
    if args.max_num_iterations is not None:
        method.trainer = dataclasses.replace(
            method.trainer, max_num_iterations=args.max_num_iterations)
        method.optim = dataclasses.replace(method.optim,
                                           max_steps=args.max_num_iterations)
    for flag in ("steps_per_save", "steps_per_eval_image", "vis"):
        if getattr(args, flag) is not None:
            method.trainer = dataclasses.replace(
                method.trainer, **{flag: getattr(args, flag)})
    exp = args.experiment_name or Path(args.data).name
    out = args.output_dir or (f"outputs/{exp}/{method.name}/"
                              f"{time.strftime('%Y-%m-%d_%H%M%S')}")
    method.trainer = dataclasses.replace(
        method.trainer, output_dir=out, load_checkpoint=args.load_checkpoint,
        num_devices=args.num_devices, data_parallel=args.data_parallel)

    train_parsed = build_dataset(method, args.data, "train")
    train_cache = FullImageCache.build(train_parsed,
                                       seed=method.trainer.seed,
                                       device=device)
    eval_cache = None
    try:
        eval_parsed = build_dataset(method, args.data, "test")
    except FileNotFoundError:
        eval_parsed = None
    if (rank == 0 and eval_parsed is not None
            and len(eval_parsed.image_filenames) > 0):
        eval_cache = FullImageCache.build(eval_parsed, seed=1, device=device)
    params, buffers = build_model(args, method, train_parsed, device)
    if method.model.chart_pad is None:
        method.model = dataclasses.replace(
            method.model, chart_pad=tuple(params.texture.shape[1:3]))
    run_config = {
        "method": method.name, "data": str(args.data),
        "dataparser": method.dataparser,
        "downscale_factor": method.downscale_factor,
        "eval_mode": method.eval_mode, "eval_interval": method.eval_interval,
        "init": {k: getattr(args, k) for k in (
            "init_ply", "init_npz", "init_lod_ply", "init_pcd", "scene_npz",
            "num_random")},
        "seed": args.seed, "overrides": args.overrides,
        "model": dataclasses.asdict(method.model),
        "optim": dataclasses.asdict(method.optim),
        "trainer": dataclasses.asdict(method.trainer),
        "num_gaussians": int(params.means.shape[0]),
    }
    if rank == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "config.json").write_text(
            json.dumps(run_config, indent=2, default=str))

    trainer = Trainer(method.trainer, method.model, method.optim, params,
                      buffers, train_cache, eval_cache, run_config)
    viewer = args.viewer and rank == 0
    if viewer:
        trainer.attach_viewer(port=args.viewer_port)
    try:
        history = trainer.train()
    finally:
        if viewer:
            trainer.viewer.close()
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
