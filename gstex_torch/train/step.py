"""Training and eval steps, single device (counterpart of
``gstex_tpu/train/step.py``).

One full-image camera per step: background, ground-truth composite,
render, loss = 0.8·L1 + 0.2·(1−SSIM) (+ the optional regularizers),
backward, per-group Adam. The JAX package's steps are pure functions of a
state; here the state is updated in place (the params are the optimizer's
leaves), which keeps one copy of each leaf and its Adam moments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.profiler import record_function

from ..models import gstex as model
from ..ops.camera import Camera
from . import optim


@dataclasses.dataclass
class TrainState:
    params: model.GStexParams      # leaves that require grad
    buffers: model.GStexBuffers
    optimizer: torch.optim.Adam
    step: int
    generator: torch.Generator     # draws the random backgrounds


def init_state(cfg: model.GStexConfig, ocfg: optim.OptimConfig,
               params: model.GStexParams, buffers: model.GStexBuffers,
               seed: int = 0) -> TrainState:
    """A state at step 0 whose params are fresh leaves copied from
    ``params``."""
    params = model.GStexParams(*(
        p.detach().clone().requires_grad_(True) for p in params))
    gen = torch.Generator(device=params.means.device).manual_seed(seed)
    return TrainState(params, buffers, optim.make_optimizer(ocfg, params), 0,
                      gen)


def train_step(cfg: model.GStexConfig, ocfg: optim.OptimConfig,
               state: TrainState, cam: Camera, image: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> dict:
    """One step; updates ``state`` and returns the step's metrics as 0-d
    tensors (``overflow``, ``total_pairs``, ``max_tile_count`` as ints).

    Its stages are ``torch.profiler`` ranges named ``gstex.*`` (the
    render's own inside ``models.gstex.render``; ``gstex.backward`` holds
    the host's wait for the backward, whose kernels run on the autograd
    engine's device thread)."""
    dev = state.params.means.device
    with record_function("gstex.background_gt"):
        background = model.sample_background(cfg, state.generator,
                                             device=dev)
        gt = model.composite_gt(image, background)
        state.optimizer.zero_grad(set_to_none=True)
    outputs = model.render(cfg, state.params, state.buffers, cam, state.step,
                           background)
    with record_function("gstex.loss"):
        loss, parts = model.loss_fn(cfg, outputs, gt, state.step, mask=mask)
    with record_function("gstex.backward"):
        loss.backward()
    with record_function("gstex.adam"):
        optim.set_step_lrs(state.optimizer, ocfg)
        state.optimizer.step()
    state.step += 1
    with record_function("gstex.metrics"):
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["loss"] = loss.detach()
        with torch.no_grad():
            mse = ((outputs["rgb"] - gt) ** 2).mean()
            metrics["psnr"] = 10.0 * -torch.log10(torch.clamp(mse,
                                                              min=1e-12))
    for k in ("overflow", "total_pairs", "max_tile_count"):
        metrics[k] = outputs[k]
    return metrics


def rechart_step(cfg: model.GStexConfig, state: TrainState) -> None:
    """Re-budget and resample the charts, refresh the mappings, and zero
    the texture group's Adam moments."""
    params, buffers = model.rechart(cfg, state.params, state.buffers)
    with torch.no_grad():
        state.params.texture.copy_(params.texture)
    state.buffers = buffers
    optim.reset_texture_moments(state.optimizer)


def eval_step(cfg: model.GStexConfig, state: TrainState, cam: Camera,
              background: torch.Tensor) -> dict:
    """The forward-only render of one view (no gradient)."""
    with torch.no_grad():
        return model.render(cfg, state.params, state.buffers, cam,
                            state.step, background, eval_only=True)
