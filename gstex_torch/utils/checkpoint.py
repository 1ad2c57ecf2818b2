"""Checkpoints of the train state (counterpart of
``gstex_tpu/utils/checkpoint.py``).

The port writes ``step-{:09d}.ckpt.pt`` files with ``torch.save``: the
step, params, buffers, the optimizer's state, the background generator's
state and the run's config as JSON. ``load_checkpoint`` also reads the
JAX package's ``step-{:09d}.ckpt.npz`` files (``load_jax_checkpoint``),
choosing by the file's suffix.
"""

from __future__ import annotations

import json
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


def jax_leaf_paths() -> list[str]:
    """The leaves of the JAX package's ``TrainState`` (params, buffers,
    ``opt_state``, step, key) in ``jax.tree.leaves`` order, each named by
    its ``jax.tree_util.keystr`` path. ``opt_state`` is
    ``optax.multi_transform`` over the seven groups of
    ``optim.GROUP_OF_LEAF``, its dict of groups flattened in key order;
    each group is ``optax.adam``'s chain: ``ScaleByAdamState(count, mu,
    nu)`` with mu and nu holding the group's one leaf, then a
    ``ScaleByScheduleState(count)`` where the group's lr is a schedule
    (xyz) and no leaf where it is a constant."""
    paths = [f".params.{f}" for f in model.GStexParams._fields]
    paths += [f".buffers.{f}" for f in model.GStexBuffers._fields]
    lrs = optim.group_lrs(optim.OptimConfig())
    for group in sorted(lrs):
        leaf = model.GStexParams._fields[optim.GROUP_OF_LEAF.index(group)]
        chain = f".opt_state.inner_states['{group}'].inner_state"
        paths += [f"{chain}[0].count", f"{chain}[0].mu.{leaf}",
                  f"{chain}[0].nu.{leaf}"]
        if callable(lrs[group]):
            paths.append(f"{chain}[1].count")
    return paths + [".step", ".key"]


def load_jax_checkpoint(path, state, seed: int = 0) -> None:
    """Restore the JAX package's ``.ckpt.npz`` into ``state`` in place.

    The file holds ``jax.tree.leaves(TrainState)`` flat as ``leaf_0`` ..
    ``leaf_{n-1}`` (``jax_leaf_paths`` names them), read here with numpy
    alone. Params and buffers are copied; each group's
    ``ScaleByAdamState(count, mu, nu)`` becomes its ``torch.optim.Adam``
    state ``step``, ``exp_avg`` and ``exp_avg_sq`` (the xyz schedule's
    count equals its Adam count: both count the group's updates); the
    step is restored. The JAX state's threefry key, which draws the
    random backgrounds, has no torch counterpart: the state's generator
    is seeded from ``seed`` and the step instead, so a resumed run draws
    other backgrounds than the JAX run would have."""
    paths = jax_leaf_paths()
    with np.load(path) as data:
        n = int(data["n"])
        if n != len(paths):
            raise ValueError(f"{path}: {n} leaves, a JAX TrainState of this "
                             f"optimizer has {len(paths)} (per-group "
                             f"gradient accumulation is not read)")
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
    opt = state.optimizer
    for group in opt.param_groups:
        name = group["name"]
        (p,) = group["params"]
        adam = f".opt_state.inner_states['{name}'].inner_state[0]"
        leaf = model.GStexParams._fields[optim.GROUP_OF_LEAF.index(name)]
        count = int(leaves[f"{adam}.count"])
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(leaves[f"{adam}.mu.{leaf}"]).to(dev),
            "exp_avg_sq": torch.as_tensor(
                leaves[f"{adam}.nu.{leaf}"]).to(dev),
        }
    state.step = int(leaves[".step"])
    state.generator.manual_seed(seed * 1_000_003 + state.step)
