"""Training and eval steps (counterpart of ``gstex_tpu/train/step.py``).

One full-image camera per step: background, ground-truth composite,
render, loss = 0.8·L1 + 0.2·(1−SSIM) (+ the optional regularizers),
backward, per-group Adam; ``train_step_camopt`` also optimizes the
training camera's pose. ``sharded_step`` is the same step over a mesh of
ranks (``parallel/shard.py``): each renders one band of the view and
differentiates its own terms of the loss, and the gradients are summed
over the mesh before the update. The JAX package's steps are pure
functions of a state; here the state is updated in place (the params are
the optimizer's leaves), which keeps one copy of each leaf and its Adam
moments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.profiler import record_function

from ..models import gstex as model
from ..ops import pose_opt
from ..ops.camera import Camera
from ..parallel import shard
from ..parallel.distributed import Mesh
from ..utils.device import resolve_device
from . import optim


@dataclasses.dataclass
class TrainState:
    params: model.GStexParams      # leaves that require grad
    buffers: model.GStexBuffers
    optimizer: optim.Adam
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
    ``ocfg`` is the config ``state.optimizer`` was made from; the
    optimizer holds its schedules.

    Its stages are ``torch.profiler`` ranges named ``gstex.*`` (the
    render's own inside ``models.gstex.render``; ``gstex.backward`` holds
    the host's wait for the backward, whose kernels run on the autograd
    engine's device thread)."""
    return _step(cfg, state, cam, image, mask)


@dataclasses.dataclass
class PoseState:
    """The camera optimizer's state: (num_cameras, 6) tangent deltas and
    their optimizer (``optim.make_pose_optimizer``)."""

    delta: torch.Tensor            # requires grad
    optimizer: optim.Adam


def init_pose_state(num_cameras: int, device=None) -> PoseState:
    """Zero deltas for ``num_cameras`` training cameras."""
    delta = torch.zeros((num_cameras, 6), dtype=torch.float32,
                        device=resolve_device(device), requires_grad=True)
    return PoseState(delta, optim.make_pose_optimizer(delta))


def train_step_camopt(cfg: model.GStexConfig, ocfg: optim.OptimConfig,
                      state: TrainState, pose: PoseState, mode: str,
                      cam: Camera, cam_idx: int, image: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> dict:
    """``train_step`` with the pose of training camera ``cam_idx``
    optimized with the model: the exp map of its delta (``mode`` SO3xR3
    or SE3) right-multiplies ``cam.c2w`` inside the differentiated render,
    the regularizer joins the loss, and one backward feeds the model's
    and the pose's optimizer. Adds the metrics
    ``camera_opt_regularizer``, ``camera_opt_translation`` and
    ``camera_opt_rotation`` (the norms after the update)."""
    return _step(cfg, state, cam, image, mask, (pose, mode, cam_idx))


def _step(cfg, state, cam, image, mask, camopt=None) -> dict:
    dev = state.params.means.device
    with record_function("gstex.background_gt"):
        background = model.sample_background(cfg, state.generator,
                                             device=dev)
        gt = model.composite_gt(image, background)
        state.optimizer.zero_grad(set_to_none=True)
    if camopt is not None:
        pose = camopt[0]
        cam = _corrected(camopt, cam)
    outputs = model.render(cfg, state.params, state.buffers, cam, state.step,
                           background)
    with record_function("gstex.loss"):
        loss, parts = model.loss_fn(cfg, outputs, gt, state.step, mask=mask)
        if camopt is not None:
            reg = pose_opt.regularizer(pose.delta)
            loss = loss + reg
    with record_function("gstex.backward"):
        loss.backward()
    with record_function("gstex.adam"):
        state.optimizer.step()
        if camopt is not None:
            pose.optimizer.step()
    state.step += 1
    with record_function("gstex.metrics"):
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["loss"] = loss.detach()
        if camopt is not None:
            metrics["camera_opt_regularizer"] = reg.detach()
            metrics.update(pose_opt.metrics(pose.delta))
        with torch.no_grad():
            mse = ((outputs["rgb"] - gt) ** 2).mean()
            metrics["psnr"] = 10.0 * -torch.log10(torch.clamp(mse,
                                                              min=1e-12))
    for k in ("overflow", "total_pairs", "max_tile_count"):
        metrics[k] = outputs[k]
    return metrics


def _corrected(camopt, cam: Camera) -> Camera:
    """``cam`` with its pose's correction (``camopt``: pose, mode,
    camera index), the pose's gradients zeroed."""
    pose, mode, cam_idx = camopt
    with record_function("gstex.pose"):
        pose.optimizer.zero_grad(set_to_none=True)
        adj = pose_opt.exp_map(mode, pose.delta[cam_idx])
        return dataclasses.replace(
            cam, c2w=pose_opt.apply_correction(cam.c2w, adj))


def sharded_step(cfg: model.GStexConfig, state: TrainState, mesh: Mesh,
                 height: int, width: int, cams, images, masks,
                 camopt=None) -> dict:
    """``_step`` over ``mesh``: one (camera, image, mask) a data row of
    the mesh, each row's ranks a band of its view. Every rank holds the
    whole state and ends the step with the same one. Returns the
    single-device step's metrics, the loss's as the mean over the rows
    (``shard.band_metrics``)."""
    dev = state.params.means.device
    row = mesh.data_rank
    with record_function("gstex.background_gt"):
        background = shard.backgrounds(cfg, state.generator, mesh.data,
                                       dev)[row]
        gt = model.composite_gt(images[row], background)
        state.optimizer.zero_grad(set_to_none=True)
    cam = cams[row]
    if camopt is not None:
        cam = _corrected(camopt, cam)
    bgrid, _ = shard.band_grid(cfg, height, width, mesh.tile)
    outputs = shard.render_band(cfg, state.params, state.buffers, cam,
                                state.step, background, bgrid,
                                mesh.tile_rank)
    reg = None
    with record_function("gstex.loss"):
        loss = shard.band_loss(cfg, mesh, outputs, gt, masks[row],
                               state.step, height, width)
        if camopt is not None:
            reg = pose_opt.regularizer(camopt[0].delta)
    with record_function("gstex.backward"):
        # the replicated regularizer is the first band's term
        shard.band_backward(mesh, loss,
                            reg if mesh.tile_rank == 0 else None)
    leaves = list(state.params)
    if camopt is not None:
        leaves.append(camopt[0].delta)
    with record_function("gstex.allreduce"):
        shard.reduce_gradients(mesh, leaves)
    with record_function("gstex.adam"):
        state.optimizer.step()
        if camopt is not None:
            camopt[0].optimizer.step()
    step = state.step
    state.step += 1
    with record_function("gstex.metrics"):
        metrics = shard.band_metrics(cfg, mesh, loss, outputs, step, height,
                                     width)
        if camopt is not None:
            metrics["loss"] = metrics["loss"] + reg.detach()
            metrics["camera_opt_regularizer"] = reg.detach()
            metrics.update(pose_opt.metrics(camopt[0].delta))
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
