"""Checkpoints of the train state (counterpart of
``gstex_tpu/utils/checkpoint.py``): ``step-{:09d}.ckpt.pt`` files holding
the step, params, buffers, the optimizer's state and the run's config as
JSON, written with ``torch.save``. The format is the port's own; the JAX
package's ``.ckpt.npz`` files are not read yet.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..models import gstex as model


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


def load_checkpoint(path, state) -> dict:
    """Restore a checkpoint into ``state`` (built with the same config and
    scene size) in place; returns the saved config."""
    dev = state.params.means.device
    data = torch.load(path, map_location=dev, weights_only=True)
    with torch.no_grad():
        for leaf, saved in zip(state.params, data["params"].values()):
            if leaf.shape != saved.shape:
                raise ValueError(f"checkpoint leaf {tuple(saved.shape)} does "
                                 f"not match the state's {tuple(leaf.shape)}")
            leaf.copy_(saved)
    state.buffers = model.GStexBuffers(**data["buffers"])
    state.optimizer.load_state_dict(data["optimizer"])
    state.generator.set_state(data["generator"].cpu())
    state.step = int(data["step"])
    return json.loads(data["config"])
