"""A training cell: the port's state built from the benchmark's inputs,
stepped as ``gstex_torch.train.trainer.Trainer.train`` steps it (chunks of
``make_train_scan`` replayed from its CUDA graph, the host's read of each
chunk's metrics, ``rechart_step`` on its cadence, views in the data
manager's seeded per-epoch shuffle), and what the comparison with the
reference needs, copied to the host on the way.

Eval images and checkpoints, the trainer's other two cadences, are left
out: they are host work and disk writes. Chunks still end on their steps,
which are multiples of ``log_every``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from gstex_torch.data.manager import FullImageCache
from gstex_torch.models import gstex as model
from gstex_torch.ops.camera import make_camera
from gstex_torch.ops.rasterize_api import use_flat_path
from gstex_torch.scripts.render import demand_caps
from gstex_torch.train import optim
from gstex_torch.train import step as train_step

from . import cadence, scene


def tier(cfg: model.GStexConfig, pad) -> str:
    """The rasterizer tier the port's dispatch rule gives ``pad``."""
    return ("flat" if use_flat_path(cfg.renderer, pad,
                                    cfg.tile_h * cfg.tile_w) else "dense")


@dataclasses.dataclass
class Cell:
    cfg: dict
    traffic: dict
    device: torch.device
    mcfg: model.GStexConfig = None
    ocfg: optim.OptimConfig = None
    pad: tuple = None
    state: train_step.TrainState = None
    scan: train_step.TrainScan = None
    cache: FullImageCache = None
    views: list = None           # the reference's cameras
    gts: list = None
    inputs: tuple = None         # (geo, colours, views, gts)

    @property
    def step(self) -> int:
        return self.state.step

    def cadences(self):
        return (self.mcfg.build_chart_every, self.traffic["log_every"])

    def next_chunk(self) -> int:
        return cadence.chunk_size(self.step, self.traffic["steps_per_sync"],
                                  self.cadences(),
                                  self.cfg["max_num_iterations"])

    def chunk(self, n: int):
        """``n`` steps through the scan and the host's one read of their
        metrics: (a dict of (n,) numpy arrays, the views' indices)."""
        with record_function("bench.feed"):
            batch = [self.cache.next_train_idx() for _ in range(n)]
            cams = [c for _, (c, _, _) in batch]
            imgs = [img for _, (_, img, _) in batch]
        with record_function("bench.chunk"):
            ms = self.scan(cams, imgs)
        with record_function("bench.read"):
            keys = list(ms)
            host = torch.stack([ms[k].to(torch.float64)
                                for k in keys]).cpu().numpy()
        return {k: host[j] for j, k in enumerate(keys)}, [i for i, _ in batch]

    def rechart_if_due(self, timed: bool = False):
        """The re-chart, where the last step is on its cadence; with
        ``timed`` its seconds on the host clock with a synchronize on both
        sides (else, or where none was due, ``None``)."""
        if not self.rechart_due():
            return None
        with record_function("bench.rechart"):
            if timed:
                self.synchronize()
                t0 = time.perf_counter()
            train_step.rechart_step(self.mcfg, self.state)
            if timed:
                self.synchronize()
                return time.perf_counter() - t0
        return None

    def rechart_due(self) -> bool:
        """Is the last step taken on the re-chart's cadence?"""
        last = self.step - 1
        return (self.mcfg.build_chart_every > 0 and last > 0
                and last % self.mcfg.build_chart_every == 0)

    def run_chunk(self, n: int, timed_rechart: bool = False):
        """``chunk(n)`` and the cadence's re-chart: (metrics, views'
        indices, the re-chart's seconds or ``None``)."""
        metrics, views = self.chunk(n)
        return metrics, views, self.rechart_if_due(timed_rechart)

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def program_configs(cfg: dict, texel_dtype: str = "f32"):
    mcfg = model.GStexConfig(
        sh_degree=cfg["sh_degree"],
        sh_degree_interval=cfg["sh_degree_interval"],
        ssim_lambda=cfg["ssim_lambda"], pixel_num=cfg["pixel_num"],
        sigma_factor=cfg["sigma_factor"],
        build_chart_every=cfg["build_chart_every"],
        background_color=cfg["background_color"], fix_init=False,
        chart_pad=None, tile_h=cfg["tile_size"], tile_w=cfg["tile_size"],
        renderer=cfg["renderer"], texel_dtype=texel_dtype)
    ocfg = optim.OptimConfig(spatial_scale=cfg["spatial_scale"],
                             xyz_lr_mult=cfg["xyz_lr_mult"],
                             max_steps=cfg["max_num_iterations"])
    return mcfg, ocfg


def host(tensors) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def params_dict(params) -> dict:
    return dict(params._asdict())


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    """The benchmark's inputs from the seed: ``(geo, colours, views,
    gts)``. The charts take the pad the port resolves for the surfels
    (``resolve_chart_pad``, the method's auto pad)."""
    dev = torch.device(device)
    mcfg, _ = program_configs(cfg)
    geo = scene.surfels(cfg, dev)
    pad = model.resolve_chart_pad(mcfg, geo["log_scales"])
    cols = scene.colours(cfg, geo["means"].shape[0], pad, seed, 1, dev)
    views = scene.views(cfg, dev)
    gts = scene.ground_truth(cfg, geo, pad, views, seed,
                             traffic["start_step"], dev)
    return geo, cols, views, gts


def build(cfg: dict, traffic: dict, seed: int, device,
          texel_dtype: str = "f32", inputs=None) -> Cell:
    """The port's state at ``start_step`` with its scan, not yet stepped,
    from ``inputs`` (``make_inputs``'s; made here when not given)."""
    cell = Cell(cfg, traffic, torch.device(device))
    dev = cell.device
    mcfg, ocfg = program_configs(cfg, texel_dtype)
    start = traffic["start_step"]
    if inputs is None:
        inputs = make_inputs(cfg, traffic, seed, dev)
    geo, cols, views, gts = inputs
    pad = tuple(cols["texture"].shape[1:3])
    cell.views, cell.gts, cell.pad, cell.inputs = views, gts, pad, inputs
    params = model.GStexParams(
        means=geo["means"], log_scales=geo["log_scales"], quats=geo["quats"],
        opacity_logits=geo["opacity_logits"],
        features_dc=cols["features_dc"], features_rest=cols["features_rest"],
        texture=cols["texture"])
    hw, mappings, scale = model.build_charts(mcfg, params.log_scales,
                                             pad=tuple(pad))
    n = params.means.shape[0]
    buffers = model.GStexBuffers(
        texture_hw=hw, mappings=mappings,
        pixel_scale=torch.as_tensor(scale, dtype=torch.float32, device=dev),
        test_colors=torch.rand((n, 3), device=dev,
                               generator=scene.generator(seed, 3, dev)))
    cams = [make_camera(v.fx, v.fy, v.cx, v.cy, v.height, v.width,
                        v.c2w, device=dev) for v in views]
    with torch.no_grad():
        pair_cap, s_max = demand_caps(mcfg, params, buffers, cams, start)
    mcfg = dataclasses.replace(mcfg, pair_cap=pair_cap, s_max=s_max)
    state = train_step.init_state(mcfg, ocfg, params, buffers, seed=seed)
    state.step = start
    opt = state.optimizer
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"step": torch.tensor(float(start)),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
    cell.mcfg, cell.ocfg, cell.state = mcfg, ocfg, state
    cell.cache = FullImageCache(cameras=cams, images=gts,
                                rng=np.random.default_rng(seed))
    cell.scan = train_step.make_train_scan(
        mcfg, ocfg, state, views[0].height, views[0].width,
        capacity=traffic["steps_per_sync"])
    return cell


def first_steps(cell: Cell) -> dict:
    """What the comparison needs, through the window's own call. First the
    steps the reference follows: the chunks of ``compared_chunks`` (the
    cadence's first chunk, cut after them; no re-chart falls among them),
    keeping on the host the params before, the Adam moments after the
    first step (its gradient) and the params after, with each step's
    loss and view. Then chunks on the cadence to the first re-chart,
    keeping the charts' state on either side of it: ``rechart`` holds
    the log-scales, texture and dims before it, and the texture, dims,
    mappings and texel scale after."""
    st = cell.state
    out = {"step0": cell.step, "params0": host(params_dict(st.params)),
           "losses": [], "views": [], "chunks": []}
    for i, n in enumerate(cell.traffic["compared_chunks"]):
        metrics, idx = cell.chunk(n)
        out["losses"] += [float(v) for v in metrics["loss"]]
        out["views"] += idx
        out["chunks"].append(n)
        if i == 0:
            out["moments1"] = host({
                name: st.optimizer.state[p]["exp_avg"]
                for name, p in params_dict(st.params).items()})
        if cell.rechart_due():
            raise ValueError("a re-chart falls among the compared steps")
    out["params1"] = host(params_dict(st.params))
    while True:
        cell.chunk(cell.next_chunk())
        if cell.rechart_due():
            break
    before = host({"log_scales": st.params.log_scales,
                   "texture": st.params.texture,
                   "texture_hw": st.buffers.texture_hw})
    cell.rechart_if_due()
    after = host({"texture": st.params.texture,
                  **st.buffers._asdict()})
    out["rechart"] = {"before": before, "after": after}
    return out


def failed_steps(metrics: dict) -> int:
    """Steps whose loss is not finite or whose binning overflowed."""
    return int(np.sum(~np.isfinite(metrics["loss"])
                      | (metrics["overflow"] > 0)))


def steps_until(cell: Cell, step: int) -> None:
    """Chunks on the cadence until the state's step reaches ``step``."""
    while cell.step < step:
        cell.run_chunk(cell.next_chunk())


def window(cell: Cell, seconds: float):
    """Chunks on the cadence for ``seconds`` on the host clock (whole
    chunks; the window closes at a synchronize after the last chunk's
    read). Returns (steps, failed, elapsed s)."""
    steps = failed = 0
    cell.synchronize()
    t0 = time.perf_counter()
    while True:
        n = cell.next_chunk()
        metrics, _, _ = cell.run_chunk(n)
        steps += n
        failed += failed_steps(metrics)
        if time.perf_counter() - t0 >= seconds:
            break
    cell.synchronize()
    return steps, failed, time.perf_counter() - t0


def traced_stretch(cell: Cell, min_steps: int, profile):
    """At least ``min_steps`` steps on the cadence under ``profile``,
    through one re-chart or more, ending on a chunk; the window is timed
    inside the profiler, from a synchronize after it starts to one before
    it stops. Returns (steps, failed, elapsed s, re-chart seconds,
    views)."""
    steps = failed = 0
    recharts, views = [], []
    with profile:
        cell.synchronize()
        t0 = time.perf_counter()
        while steps < min_steps or not recharts:
            n = cell.next_chunk()
            metrics, idx, rs = cell.run_chunk(n, timed_rechart=True)
            steps += n
            views += idx
            failed += failed_steps(metrics)
            if rs is not None:
                recharts.append(rs)
        cell.synchronize()
        elapsed = time.perf_counter() - t0
    return steps, failed, elapsed, recharts, views
