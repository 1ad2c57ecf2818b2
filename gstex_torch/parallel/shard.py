"""Multi-GPU rendering and training over a tile-row mesh (counterpart of
``gstex_tpu/parallel/shard.py``).

Every rank holds the whole state (Gaussians, charts, Adam moments) and
renders one horizontal band of the image: the band's own grid of tiles,
at the pixel offset (0, r · band_h), through the same tier and kernels as
the whole frame (``models/gstex.py:render``). The loss is band-local: L1,
the regularizers and the PSNR's squared error are sums over the band's
rows inside the image, and SSIM runs on the band extended by a 10-row
halo, the first rows of the following band(s), so that every 11x11
window is evaluated on exactly one rank. Each rank differentiates its
own band's terms only; the halo's cotangent is sent back to the band it
came from, which adds it before its backward through the render. The
parameter (and pose) gradients are then summed over the mesh with one
all-reduce, and the same Adam update runs on every rank, so the replicas
stay bit-equal. Camera-batch data parallelism gives each row of a
(data, tile) mesh its own camera and averages the gradients over the
rows, as the reference's DDP does.

The makers return plain functions over the port's in-place state; they
hold no compiled program, only the band grid of their image size.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..models import gstex as model
from ..ops import ssim as ssim_ops
from ..ops.binning import TileGrid
from ..ops.camera import Camera
from .distributed import Mesh, all_gather, all_reduce_

# SSIM window extent: the windows whose top-left row a band owns reach
# this many rows into the following band(s) (11x11 VALID convolution)
HALO = 10


def band_grid(cfg: model.GStexConfig, height: int, width: int,
              ndev: int) -> tuple[TileGrid, int]:
    """Per-rank band grid: tile rows split evenly, the image's rows padded
    up to a multiple of ndev · tile_h. Returns (grid, band_h)."""
    nty = -(-cfg.grid(height, width).nty // ndev) * ndev
    band_h = nty // ndev * cfg.tile_h
    return TileGrid(height=band_h, width=width, tile_h=cfg.tile_h,
                    tile_w=cfg.tile_w), band_h


def render_band(cfg: model.GStexConfig, params, buffers, cam: Camera,
                step: int, background: torch.Tensor, bgrid: TileGrid,
                band: int, eval_only: bool = False) -> dict:
    """Band ``band`` of the view: ``models.gstex.render`` on the band's
    grid at pixel offset (0, band · band_h)."""
    return model.render(cfg, params, buffers, cam, step, background,
                        eval_only=eval_only, grid=bgrid,
                        px_offset=(0.0, float(band * bgrid.height)))


def backgrounds(cfg: model.GStexConfig, generator: torch.Generator, rows: int,
                device) -> torch.Tensor:
    """(rows, 3): one training background a data row. One row draws as
    the single-device step does; B rows draw B at once, each its own, as
    JAX's ``fold_in(bg_key, data index)`` gives each row its own. Every
    rank draws the same, so the generators stay in lockstep."""
    if rows == 1 or cfg.background_color != "random":
        return model.sample_background(cfg, generator,
                                       device=device).expand(rows, 3)
    return torch.rand((rows, 3), generator=generator, device=device)


class BandLoss(NamedTuple):
    """One band's loss, split at the band image. ``image_loss`` is the
    band's L1 and SSIM terms on ``rgb``, a detached copy of the rendered
    band, and on ``halos``, every band's first rows; ``map_loss`` the
    regularizers on the band's own maps (``None`` when lean); ``sums``
    (5,): the band's L1, SSIM, normal, reg and squared-error sums."""

    rendered: torch.Tensor
    rgb: torch.Tensor
    halos: torch.Tensor
    image_loss: torch.Tensor
    map_loss: Optional[torch.Tensor]
    sums: torch.Tensor


def band_loss(cfg: model.GStexConfig, mesh: Mesh, outputs: dict,
              gt: torch.Tensor, mask: Optional[torch.Tensor], step: int,
              height: int, width: int) -> BandLoss:
    """This rank's terms of the single-device loss (``loss_fn``):
    0.8 · L1 + 0.2 · (1 − SSIM) + normal + reg over the (H, W) frame, of
    which the band holds the rows inside the image and the SSIM windows
    whose top-left row it owns. ``gt`` (H, W, 3) and ``mask`` (H, W, 1),
    the whole frame's, as every rank has them. The mask is carried into
    the band and its halo as the single-device step applies it."""
    r, ndev = mesh.tile_rank, mesh.tile
    band_h = outputs["rgb"].shape[0]
    y0 = r * band_h
    n_px = height * width
    # rows past the image only ever meet zero weights below
    pad = (0, 0, 0, 0, 0, ndev * band_h + HALO - height)
    gt_pad = F.pad(gt, pad)
    gt_band = gt_pad[y0:y0 + band_h]
    gt_slab = gt_pad[y0:y0 + band_h + HALO]
    rows = torch.arange(y0, y0 + band_h, device=gt.device)
    rowmask = (rows < height).to(gt.dtype)
    rgb = outputs["rgb"].detach().requires_grad_(True)
    # the halo: the first rows of the next band(s), band r + j's first
    # min(band_h, HALO − (j − 1) · band_h) (the last bands' wrap to the
    # first and fall in windows no band owns)
    top = min(band_h, HALO)
    halos = all_gather(rgb[:top], mesh.tile_group).requires_grad_(True)
    hops = -(-HALO // band_h)
    pred_slab = torch.cat([rgb] + [
        halos[(r + j) % ndev, :min(band_h, HALO - (j - 1) * band_h)]
        for j in range(1, hops + 1)])
    if mask is not None:
        m_slab = F.pad(mask, pad)[y0:y0 + band_h + HALO]
        pred_slab = pred_slab * m_slab
        gt_slab = gt_slab * m_slab
    diff = pred_slab[:band_h] - gt_slab[:band_h]
    l1_sum = (diff.abs() * rowmask[:, None, None]).sum()
    own = max(0, min(height - HALO - y0, band_h))
    ssim_sum = ssim_ops.ssim_map(gt_slab, pred_slab)[:own].sum()
    lam = cfg.ssim_lambda
    image_loss = ((1.0 - lam) * l1_sum / (n_px * 3)
                  - lam * ssim_sum / ((height - HALO) * (width - HALO) * 3))
    with torch.no_grad():
        mse_sum = ((rgb - gt_band) ** 2 * rowmask[:, None, None]).sum()
    zero = torch.zeros((), device=gt.device)
    normal_sum = reg_sum = zero
    map_loss = None
    if not model.lean_losses(cfg):
        normal_sum = ((outputs["alpha"] - (outputs["normal"]
                                           * outputs["normal"]).sum(-1))
                      * rowmask[:, None]).sum()
        reg_sum = (outputs["reg"] * rowmask[:, None]).sum()
        map_loss = (model.schedule_value(cfg.lambda_normal, step) * normal_sum
                    + model.schedule_value(cfg.lambda_reg, step) * reg_sum
                    ) / n_px
    sums = torch.stack([l1_sum, ssim_sum, normal_sum, reg_sum,
                        mse_sum]).detach()
    return BandLoss(outputs["rgb"], rgb, halos, image_loss, map_loss, sums)


def band_backward(mesh: Mesh, loss: BandLoss,
                  extra: Optional[torch.Tensor] = None) -> None:
    """Backward of this rank's terms (and ``extra``, a term this rank
    alone adds, such as the pose regularizer on the first band) into the
    leaves' ``.grad``: the image terms' cotangents of the band and of the
    halos, the halos' summed over the tile axis so that each band gets
    what the bands above it took from its first rows, then one backward
    through the render."""
    g_rgb, g_halos = torch.autograd.grad(loss.image_loss,
                                         [loss.rgb, loss.halos])
    all_reduce_(g_halos, mesh.tile_group)
    g_rgb[:g_halos.shape[1]] += g_halos[mesh.tile_rank]
    outs, grads = [loss.rendered], [g_rgb]
    for term in (loss.map_loss, extra):
        if term is not None:
            outs.append(term)
            grads.append(torch.ones_like(term))
    torch.autograd.backward(outs, grads)


def reduce_gradients(mesh: Mesh, leaves) -> None:
    """Sum the leaves' gradients over the mesh, divided by its rows (the
    camera batch's mean, as DDP averages); one all-reduce a leaf. A leaf
    without a gradient has none on every rank."""
    for leaf in leaves:
        if leaf.grad is not None:
            all_reduce_(leaf.grad, mesh.group)
            if mesh.data > 1:
                leaf.grad.div_(mesh.data)


def band_metrics(cfg: model.GStexConfig, mesh: Mesh, loss: BandLoss,
                 outputs: dict, step: int, height: int,
                 width: int) -> dict:
    """The single-device step's metrics from the bands' sums, summed over
    the mesh (a mean over its rows): ``loss``, ``main_loss``, ``l1``,
    ``ssim_loss``, ``normal_loss``, ``reg_loss``, ``psnr``; ``overflow``
    summed, ``total_pairs`` and ``max_tile_count`` the largest band's (a
    band's demand sizes the caps). All are 0-d device tensors: nothing is
    read back to the host."""
    dev = loss.sums.device
    f64 = lambda v: torch.as_tensor(v, device=dev).to(torch.float64)
    totals = torch.cat([loss.sums.to(torch.float64),
                        f64(outputs["overflow"]).reshape(1)])
    all_reduce_(totals, mesh.group)
    sums = (totals[:5] / mesh.data).to(torch.float32)
    peaks = torch.stack([f64(outputs["total_pairs"]),
                         f64(outputs["max_tile_count"])])
    all_reduce_(peaks, mesh.group, op=torch.distributed.ReduceOp.MAX)
    n_px = height * width
    l1 = sums[0] / (n_px * 3)
    ssim_loss = 1.0 - sums[1] / ((height - HALO) * (width - HALO) * 3)
    normal_loss = reg_loss = torch.zeros((), device=dev)
    if not model.lean_losses(cfg):
        normal_loss = (model.schedule_value(cfg.lambda_normal, step)
                       * sums[2] / n_px)
        reg_loss = model.schedule_value(cfg.lambda_reg, step) * sums[3] / n_px
    main = (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * ssim_loss
    mse = sums[4] / (n_px * 3)
    return {"main_loss": main, "l1": l1, "ssim_loss": ssim_loss,
            "normal_loss": normal_loss, "reg_loss": reg_loss,
            "loss": main + normal_loss + reg_loss,
            "psnr": 10.0 * -torch.log10(torch.clamp(mse, min=1e-12)),
            "overflow": totals[5].to(torch.int64),
            "total_pairs": peaks[0].to(torch.int64),
            "max_tile_count": peaks[1].to(torch.int64)}


def make_sharded_train_step(cfg: model.GStexConfig, mesh: Mesh, height: int,
                            width: int):
    """Multi-GPU train step: (state, cam, image, mask=None) -> metrics.
    Each rank renders its band; the gradients are summed over the mesh;
    the same Adam update runs on every rank."""
    from ..train import step as step_mod

    def step_fn(state, cam, image, mask=None):
        return step_mod.sharded_step(cfg, state, mesh, height, width, [cam],
                                     [image], [mask])
    return step_fn


def make_sharded_train_step_camopt(cfg: model.GStexConfig, mode: str,
                                   mesh: Mesh, height: int, width: int):
    """The sharded step with the pose of training camera ``cam_idx``
    optimized with the model: (state, pose, cam, cam_idx, image,
    mask=None) -> metrics. The correction is applied to the camera on
    every rank before binning; the bands' pose gradients are summed over
    the mesh like the model's, and the regularizer is the first band's
    term."""
    from ..train import step as step_mod

    def step_fn(state, pose, cam, cam_idx, image, mask=None):
        return step_mod.sharded_step(cfg, state, mesh, height, width, [cam],
                                     [image], [mask],
                                     camopt=(pose, mode, cam_idx))
    return step_fn


def make_sharded_train_scan(cfg: model.GStexConfig, mesh: Mesh,
                            height: int, width: int):
    """n sharded steps under one call (the counterpart of the JAX
    package's ``make_sharded_train_scan``): ``(state, cams, images) ->
    metrics``, the n steps of ``make_sharded_train_step`` in order, their
    metrics stacked (n,) device tensors, read by the host once, after the
    chunk. The Adam updates read their per-step values from the chunk's
    table (``optim.Adam.step_table``, accumulating groups too), as the
    single-device scan's do, and the host counts move once, after the
    chunk. The steps are not captured into a CUDA graph: gloo stages its
    collectives through the host."""
    from ..train import step as step_mod

    def scan_fn(state, cams, images):
        if len(cams) != len(images):
            raise ValueError(f"{len(cams)} cameras and {len(images)} "
                             f"images")
        if any((c.height, c.width) != (height, width) for c in cams):
            raise ValueError(f"a chunk's cameras must all be "
                             f"{height}x{width}")
        dev = state.params.means.device
        table = state.optimizer.step_table(len(cams), dev)
        pos = torch.zeros(1, dtype=torch.int64, device=dev)
        rows = []
        for cam, image in zip(cams, images):
            rows.append(step_mod.sharded_step(
                cfg, state, mesh, height, width, [cam], [image], [None],
                table=table, pos=pos))
            pos += 1
        state.optimizer.advance(len(cams))
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    return scan_fn


def make_batch_sharded_train_step(cfg: model.GStexConfig, mesh: Mesh,
                                  height: int, width: int):
    """Camera-batch data parallelism over a (data, tile) mesh: (state,
    cams, images) -> metrics, with B = ``mesh.data`` cameras and images;
    data row d trains camera d with its bands on the tile axis, and the
    gradients are the mean over the cameras of each camera's. Metrics are
    the batch's means."""
    from ..train import step as step_mod

    def step_fn(state, cams, images):
        if len(cams) != mesh.data or len(images) != mesh.data:
            raise ValueError(f"{len(cams)} cameras and {len(images)} images "
                             f"for {mesh.data} data rows")
        return step_mod.sharded_step(cfg, state, mesh, height, width, cams,
                                     images, [None] * mesh.data)
    return step_fn


def make_sharded_render(cfg: model.GStexConfig, mesh: Mesh, height: int,
                        width: int):
    """Multi-GPU forward render: (state, cam, background) -> rgb (H, W, 3)
    on every rank of the tile axis: each renders its band through the
    tier's eval kernel, the bands are all-gathered and cropped to H."""
    bgrid, band_h = band_grid(cfg, height, width, mesh.tile)

    @torch.no_grad()
    def render_fn(state, cam, background):
        out = render_band(cfg, state.params, state.buffers, cam, state.step,
                          background, bgrid, mesh.tile_rank, eval_only=True)
        with record_function("gstex.allgather"):
            bands = all_gather(out["rgb"], mesh.tile_group)
        return bands.reshape(mesh.tile * band_h, width, 3)[:height]
    return render_fn
