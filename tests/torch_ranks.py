"""gloo ranks on the CPU for the port's multi-rank tests (no JAX here:
each rank imports this module, torch and the port only).

``run_ranks(world, fn, payload, tmp)`` starts ``world`` processes once,
joined through ``file://`` under ``tmp`` (never a fixed port: several
test workers run at once), calls ``fn(payload)`` in each with the group
up and one thread a rank, and returns what rank 0's call returned."""

from __future__ import annotations

import hashlib
import importlib
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(world: int, fn, payload, tmp) -> object:
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    out = tmp / "rank0.pt"
    mp.start_processes(_rank, args=(world, fn.__module__, fn.__name__,
                                    payload, str(tmp)),
                       nprocs=world, start_method="spawn")
    return torch.load(out, weights_only=False)


def _rank(rank, world, module, name, payload, tmp):
    torch.set_num_threads(1)
    from gstex_torch.parallel.distributed import init_distributed

    init_distributed(f"file://{tmp}/rendezvous", world, rank, device="cpu")
    try:
        res = getattr(importlib.import_module(module), name)(payload)
        if rank == 0:
            torch.save(res, Path(tmp) / "rank0.pt")
    finally:
        dist.destroy_process_group()


def state_hash(state, pose=None) -> str:
    """A digest of a state's parameters, buffers, optimizer moments and
    host counts and step (and a pose's deltas): equal on bit-equal
    replicas."""
    h = hashlib.sha256()
    leaves = list(state.params) + list(state.buffers)
    for st in state.optimizer.state.values():
        leaves += [v for v in st.values() if torch.is_tensor(v)]
        h.update(repr([(k, v) for k, v in st.items()
                       if not torch.is_tensor(v)]).encode())
    if pose is not None:
        leaves.append(pose.delta)
    for x in leaves:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    h.update(str(state.step).encode())
    return h.hexdigest()


def hashes(mesh, state, pose=None) -> list[str]:
    """Every rank's ``state_hash`` of the mesh, in rank order."""
    mine = state_hash(state, pose)
    got = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(got, mine, group=mesh.group)
    return got


# --- tests/test_torch_shard.py's cases: the library on sub-meshes of one
# group of ranks ---------------------------------------------------------

def port_state(inputs, cfg):
    """A fresh port state (and the camera) from the shared numpy inputs."""
    from gstex_torch.models import gstex as model
    from gstex_torch.ops.camera import make_camera
    from gstex_torch.train import optim, step as step_mod

    params = model.GStexParams(*(torch.tensor(inputs["params"][k])
                                 for k in model.GStexParams._fields))
    buffers = model.GStexBuffers(*(torch.tensor(inputs["buffers"][k])
                                   for k in model.GStexBuffers._fields))
    state = step_mod.init_state(cfg, optim.OptimConfig(max_steps=100),
                                params, buffers, seed=3)
    cams = [make_camera(*c, device="cpu") for c in inputs["cams"]]
    return state, cams


def pose_state(inputs):
    from gstex_torch.train import step as step_mod

    pose = step_mod.init_pose_state(3, device="cpu")
    with torch.no_grad():
        pose.delta[1] = torch.as_tensor(inputs["delta1"])
    return pose


def shard_cases(payload) -> dict:
    """Each case on a mesh of the first ranks of the group; rank 0's
    results: the render, or the step's metrics, params after it, and the
    mesh's replica hashes."""
    from gstex_torch.parallel import shard
    from gstex_torch.parallel.distributed import (all_reduce_, make_mesh,
                                                  process_info)

    inputs, cfg, (h, w) = payload["inputs"], payload["cfg"], payload["hw"]
    gts = [torch.as_tensor(g) for g in inputs["gts"]]
    out = {}
    for kind, n, dp in payload["cases"]:
        mesh = make_mesh(n, dp)
        if mesh is None:
            continue
        state, cams = port_state(inputs, cfg)
        key = f"{kind}{n}x{dp}"
        if kind == "render":
            rgb = shard.make_sharded_render(cfg, mesh, h, w)(
                state, cams[0], torch.zeros(3))
            out[key] = {"rgb": rgb.numpy()}
            continue
        pose = None
        if kind == "step":
            m = shard.make_sharded_train_step(cfg, mesh, h, w)(
                state, cams[0], gts[0])
        elif kind == "masked":
            m = shard.make_sharded_train_step(cfg, mesh, h, w)(
                state, cams[0], gts[0], torch.as_tensor(inputs["mask"]))
        elif kind == "camopt":
            pose = pose_state(inputs)
            m = shard.make_sharded_train_step_camopt(cfg, "SO3xR3", mesh, h,
                                                     w)(
                state, pose, cams[0], 1, gts[0])
        else:
            m = shard.make_batch_sharded_train_step(cfg, mesh, h, w)(
                state, cams[1:3], gts[1:3])
        res = {"metrics": {k: float(v) for k, v in m.items()},
               "params": {k: v.detach().numpy()
                          for k, v in state.params._asdict().items()},
               "hashes": hashes(mesh, state, pose)}
        if pose is not None:
            res["delta"] = pose.delta.detach().numpy()
            res["acc"] = pose.optimizer.state[pose.delta]["acc"].numpy()
        out[key] = res
    # a gradient autograd leaves strided, all-reduced over the group
    strided = torch.arange(6.0).reshape(2, 3).t() * (dist.get_rank() + 1)
    all_reduce_(strided, None)
    out["strided"] = strided
    out["info"] = process_info()
    return out


# --- tests/test_torch_shard_trainer.py's cases: the Trainer on a group of
# 4 ranks --------------------------------------------------------------

def trainer(payload, out, cache=None, accumulate=(), **tkw):
    """The port's Trainer on the payload's dataset (its masks, given),
    its groups ``accumulate`` accumulating gradients."""
    from gstex_torch.data.blender import parse_blender
    from gstex_torch.data.manager import FullImageCache
    from gstex_torch.models import gstex as model
    from gstex_torch.train import optim
    from gstex_torch.train.trainer import Trainer, TrainerConfig

    cfg = payload["cfg"]
    if cache is None:
        cache = FullImageCache.build(parse_blender(payload["data"], "train"),
                                     seed=42, device="cpu")
        if payload.get("masks") is not None:
            cache.masks = [torch.as_tensor(m) for m in payload["masks"]]
    params, buffers = payload["scene"]
    tcfg = TrainerConfig(**{"max_num_iterations": 4, "steps_per_save": 1,
                            "steps_per_eval_image": 0, "log_every": 1,
                            "save_only_latest_checkpoint": False,
                            "vis": "wandb", "output_dir": str(out), **tkw})
    return Trainer(tcfg, cfg, optim.OptimConfig(
        max_steps=4, gradient_accumulation=accumulate),
                   model.GStexParams(*(p.clone() for p in params)),
                   model.GStexBuffers(*(b.clone() for b in buffers)), cache)


def trainer_cases(payload) -> dict:
    """The mesh runs of the trainer test: rank 0's histories, every rank's
    state hashes, and what each refusal said."""
    from pathlib import Path

    root = Path(payload["root"])
    out = {}

    def run(name, tr, skip=0):
        for _ in range(skip):
            tr.train_cache.next_train_idx()
        hist = tr.train()
        out[name] = {"history": hist,
                     "hashes": hashes(tr.mesh, tr.state, tr.pose),
                     "params": [p.detach().clone() for p in tr.state.params]}

    run("tile", trainer(payload, root / "tile", num_devices=4))
    # steps 1-3 in one chunk: make_sharded_train_scan
    run("scan", trainer(payload, root / "scan", num_devices=4, log_every=4,
                        steps_per_save=0, steps_per_sync=4))
    # the same with texture_dc and xyz accumulating 3 and 2 steps an
    # update: the scan's chunk reads the Adam table, the steps the host
    accum = (("texture_dc", 3), ("xyz", 2))
    run("tile_accum", trainer(payload, root / "tile_accum", num_devices=4,
                              accumulate=accum))
    run("scan_accum", trainer(payload, root / "scan_accum", num_devices=4,
                              log_every=4, steps_per_save=0,
                              steps_per_sync=4, accumulate=accum))
    ck = root / "tile" / "checkpoints" / "step-000000002.ckpt.pt"
    run("resumed", trainer(payload, root / "resumed", num_devices=4,
                           load_checkpoint=str(ck)), skip=2)
    run("dp", trainer(payload, root / "dp", num_devices=4, data_parallel=2,
                      max_num_iterations=2))
    run("camopt", trainer(payload, root / "camopt", num_devices=4,
                          camera_opt="SO3xR3", max_num_iterations=2))
    masked = dict(payload, masks=payload["test_masks"])
    run("masked", trainer(masked, root / "masked", num_devices=4,
                          max_num_iterations=2))
    try:
        trainer(masked, root / "dp_masked", num_devices=4,
                data_parallel=2).train()
    except ValueError as e:
        out["dp_masked"] = str(e)
    return out
