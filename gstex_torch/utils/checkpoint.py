"""Checkpoints of the train state (counterpart of
``gstex_tpu/utils/checkpoint.py``).

The port writes ``step-{:09d}.ckpt.pt`` files with ``torch.save``: the
step, params, buffers, the optimizer's state, the background generator's
state and the run's config as JSON. ``load_checkpoint`` also reads the
JAX package's ``step-{:09d}.ckpt.npz`` files (``load_jax_checkpoint``),
choosing by the file's suffix, also those of runs whose groups accumulate
(``optax.MultiSteps``). A camera-optimizing run's pose deltas and their
optimizer state ride a ``pose-{:09d}.npz`` sidecar in the JAX package's
own layout (``save_aux``, ``aux_for_checkpoint``, ``load_pose``), which
either package reads.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import torch

from ..models import gstex as model
from ..train import optim

SUFFIXES = (".ckpt.pt", ".ckpt.npz")


def save_checkpoint(ckpt_dir, state, config: dict | None = None,
                    keep_only_latest: bool = True) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step-{state.step:09d}.ckpt.pt"
    torch.save({
        "step": state.step,
        "params": {k: v.detach() for k, v in state.params._asdict().items()},
        "buffers": state.buffers._asdict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "config": json.dumps(config or {}, default=str),
    }, path)
    if keep_only_latest:
        for old in ckpt_dir.glob("step-*.ckpt.pt"):
            if old != path:
                old.unlink()
    return path


def latest_checkpoint(ckpt_dir) -> Path | None:
    ckpts = sorted(Path(ckpt_dir).glob("step-*.ckpt.pt"))
    return ckpts[-1] if ckpts else None


def load_checkpoint(path, state, seed: int = 0) -> dict:
    """Restore a checkpoint into ``state`` (built with the same config and
    scene size) in place: the port's ``.ckpt.pt`` or the JAX package's
    ``.ckpt.npz`` (``seed`` is the run's, for the latter's generator).
    Returns the saved config (``{}`` for a JAX checkpoint)."""
    name = Path(path).name
    if name.endswith(".ckpt.npz"):
        load_jax_checkpoint(path, state, seed=seed)
        return {}
    if not name.endswith(".ckpt.pt"):
        raise ValueError(f"{path}: a checkpoint ends in one of {SUFFIXES}")
    dev = state.params.means.device
    data = torch.load(path, map_location=dev, weights_only=True)
    _copy_params(state, data["params"].values())
    state.buffers = model.GStexBuffers(**data["buffers"])
    state.optimizer.load_state_dict(data["optimizer"])
    state.generator.set_state(data["generator"].cpu())
    state.step = int(data["step"])
    return json.loads(data["config"])


def _copy_params(state, saved) -> None:
    with torch.no_grad():
        for leaf, x in zip(state.params, saved):
            if leaf.shape != x.shape:
                raise ValueError(f"checkpoint leaf {tuple(x.shape)} does "
                                 f"not match the state's {tuple(leaf.shape)}")
            leaf.copy_(x)


def _group_leaf(group: str) -> str:
    return model.GStexParams._fields[optim.GROUP_OF_LEAF.index(group)]


def jax_leaf_paths(accumulated=()) -> list[str]:
    """The leaves of the JAX package's ``TrainState`` (params, buffers,
    ``opt_state``, step, key) in ``jax.tree.leaves`` order, each named by
    its ``jax.tree_util.keystr`` path. ``opt_state`` is
    ``optax.multi_transform`` over the seven groups of
    ``optim.GROUP_OF_LEAF``, its dict of groups flattened in key order;
    each group is ``optax.adam``'s chain: ``ScaleByAdamState(count, mu,
    nu)`` with mu and nu holding the group's one leaf, then a
    ``ScaleByScheduleState(count)`` where the group's lr is a schedule
    (xyz) and no leaf where it is a constant. A group named in
    ``accumulated`` is that chain inside ``optax.MultiSteps``:
    ``mini_step``, ``gradient_step``, the chain as ``inner_opt_state``,
    then ``acc_grads``."""
    paths = [f".params.{f}" for f in model.GStexParams._fields]
    paths += [f".buffers.{f}" for f in model.GStexBuffers._fields]
    lrs = optim.group_lrs(optim.OptimConfig())
    for group in sorted(lrs):
        leaf = _group_leaf(group)
        chain = f".opt_state.inner_states['{group}'].inner_state"
        if group in accumulated:
            multi, chain = chain, chain + ".inner_opt_state"
            paths += [f"{multi}.mini_step", f"{multi}.gradient_step"]
        paths += [f"{chain}[0].count", f"{chain}[0].mu.{leaf}",
                  f"{chain}[0].nu.{leaf}"]
        if callable(lrs[group]):
            paths.append(f"{chain}[1].count")
        if group in accumulated:
            paths.append(f"{multi}.acc_grads.{leaf}")
    return paths + [".step", ".key"]


def _adam_state(count, mu, nu, dev) -> dict:
    """A group's ``optim.Adam`` state from optax's ``ScaleByAdamState``."""
    return {"step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(mu).to(dev),
            "exp_avg_sq": torch.as_tensor(nu).to(dev)}


def load_jax_checkpoint(path, state, seed: int = 0) -> None:
    """Restore the JAX package's ``.ckpt.npz`` into ``state`` in place.

    The file holds ``jax.tree.leaves(TrainState)`` flat as ``leaf_0`` ..
    ``leaf_{n-1}`` (``jax_leaf_paths`` names them, for the groups that
    ``state.optimizer`` accumulates), read here with numpy alone. Params
    and buffers are copied; each group's ``ScaleByAdamState(count, mu,
    nu)`` becomes its ``optim.Adam`` state ``step``, ``exp_avg`` and
    ``exp_avg_sq`` (the xyz schedule's count equals its Adam count: both
    count the group's updates), and an accumulating group's
    ``MultiStepsState`` its ``mini_step``, ``gradient_step`` and ``acc``;
    the step is restored. The JAX state's threefry key, which draws the
    random backgrounds, has no torch counterpart: the state's generator
    is seeded from ``seed`` and the step instead, so a resumed run draws
    other backgrounds than the JAX run would have."""
    opt = state.optimizer
    paths = jax_leaf_paths(accumulated=tuple(opt.every))
    with np.load(path) as data:
        n = int(data["n"])
        if n != len(paths):
            raise ValueError(
                f"{path}: {n} leaves, a JAX TrainState of this optimizer "
                f"(accumulating {sorted(opt.every) or 'no group'}) has "
                f"{len(paths)}")
        leaves = {p: data[f"leaf_{i}"] for i, p in enumerate(paths)}
    dev = state.params.means.device
    _copy_params(state, (torch.as_tensor(leaves[f".params.{f}"])
                         for f in model.GStexParams._fields))
    ref = state.buffers
    state.buffers = model.GStexBuffers(**{
        f: torch.as_tensor(leaves[f".buffers.{f}"]).to(
            device=dev, dtype=getattr(ref, f).dtype).reshape(
                getattr(ref, f).shape)
        for f in model.GStexBuffers._fields})
    for group in opt.param_groups:
        name = group["name"]
        (p,) = group["params"]
        leaf = _group_leaf(name)
        chain = f".opt_state.inner_states['{name}'].inner_state"
        multi = chain
        if name in opt.every:
            chain += ".inner_opt_state"
        adam = f"{chain}[0]"
        opt.state[p] = _adam_state(leaves[f"{adam}.count"],
                                   leaves[f"{adam}.mu.{leaf}"],
                                   leaves[f"{adam}.nu.{leaf}"], dev)
        if name in opt.every:
            opt.state[p].update(
                acc=torch.as_tensor(leaves[f"{multi}.acc_grads.{leaf}"]).to(
                    dev),
                mini_step=int(leaves[f"{multi}.mini_step"]),
                gradient_step=int(leaves[f"{multi}.gradient_step"]))
    state.step = int(leaves[".step"])
    state.generator.manual_seed(seed * 1_000_003 + state.step)


# the pose sidecar: ``jax.tree.leaves(PoseState(delta, MultiStepsState))``
# of the JAX package's camera optimizer, in its order
POSE_LEAVES = ("delta", "mini_step", "gradient_step", "count", "mu", "nu",
               "schedule_count", "acc")


def pose_leaves(pose) -> list[np.ndarray]:
    """A ``step.PoseState`` as the JAX package's ``PoseState`` leaves
    (``POSE_LEAVES``): float32 arrays and int32 scalars."""
    st = pose.optimizer.state[pose.delta]
    f32 = lambda t: t.detach().cpu().numpy().astype(np.float32)
    count = np.int32(int(st["step"]))
    return [f32(pose.delta), np.int32(st["mini_step"]),
            np.int32(st["gradient_step"]), count, f32(st["exp_avg"]),
            f32(st["exp_avg_sq"]), count, f32(st["acc"])]


def load_pose(path, pose) -> None:
    """Restore a pose sidecar (the port's or the JAX package's) into
    ``pose`` in place."""
    leaves = dict(zip(POSE_LEAVES, load_aux(path)))
    if len(leaves) != len(POSE_LEAVES):
        raise ValueError(f"{path}: not a pose sidecar of "
                         f"{len(POSE_LEAVES)} leaves")
    if leaves["delta"].shape != tuple(pose.delta.shape):
        raise ValueError(f"{path}: deltas {leaves['delta'].shape}, the run "
                         f"has {tuple(pose.delta.shape)}")
    if int(leaves["schedule_count"]) != int(leaves["count"]):
        raise ValueError(f"{path}: the schedule's count "
                         f"{int(leaves['schedule_count'])} is not Adam's "
                         f"{int(leaves['count'])}")
    dev = pose.delta.device
    with torch.no_grad():
        pose.delta.copy_(torch.as_tensor(leaves["delta"]))
    pose.optimizer.state[pose.delta] = dict(
        _adam_state(leaves["count"], leaves["mu"], leaves["nu"], dev),
        acc=torch.as_tensor(leaves["acc"]).to(dev),
        mini_step=int(leaves["mini_step"]),
        gradient_step=int(leaves["gradient_step"]))


def save_aux(ckpt_dir, tag: str, leaves, step: int,
             keep_only_latest: bool = True) -> Path:
    """Save a sidecar's leaves (e.g. ``pose_leaves``) as
    ``{tag}-{step:09d}.npz`` beside the main checkpoint, in the JAX
    package's layout (``n``, ``leaf_0`` ..)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"{tag}-{step:09d}.npz"
    np.savez(path, n=len(leaves),
             **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    if keep_only_latest:
        for old in ckpt_dir.glob(f"{tag}-*.npz"):
            if old != path:
                old.unlink()
    return path


def latest_aux(ckpt_dir, tag: str) -> Path | None:
    files = sorted(Path(ckpt_dir).glob(f"{tag}-*.npz"))
    return files[-1] if files else None


def aux_for_checkpoint(ckpt_path, tag: str) -> Path | None:
    """The sidecar of the main checkpoint's step; where there is none (a
    run that keeps only its latest files pruned it), the newest sidecar,
    with a warning that it may be of a later step than the params."""
    ckpt_path = Path(ckpt_path)
    step = None
    stem = ckpt_path.name
    if stem.startswith("step-"):
        digits = stem[len("step-"):].split(".")[0]
        if digits.isdigit():
            step = int(digits)
    if step is not None:
        exact = ckpt_path.parent / f"{tag}-{step:09d}.npz"
        if exact.exists():
            return exact
    fallback = latest_aux(ckpt_path.parent, tag)
    if fallback is not None:
        warnings.warn(
            f"no {tag} aux file matches checkpoint step {step}; "
            f"falling back to newest sidecar {fallback.name}: its state "
            "may be from a later step than the restored params")
    return fallback


def load_aux(path) -> list[np.ndarray]:
    """A sidecar's leaves, in their saved order."""
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(int(data["n"]))]
