"""Trainer: the outer loop with its step hooks (counterpart of
``gstex_tpu/train/trainer.py``), on one device.

Per step: the next camera of the epoch's random order, one train step,
the NaN gate, overflow-driven capacity growth, the re-chart every
``build_chart_every`` steps, the step's scalars every ``log_every`` steps,
an eval image and its scalars every ``steps_per_eval_image`` steps, the
whole eval set's ``eval_all_*`` scalars every
``steps_per_eval_all_images`` steps, checkpoints every ``steps_per_save``
steps and at the end. Scalars and images go through a ``Writer``
(``events.jsonl``, the console, ``images/`` and the ``vis`` sinks); the
``train_iteration`` and ``retexture_after`` sections of the wall-time
profiler are printed at the end. A run resumed from ``load_checkpoint``
(the port's ``.ckpt.pt`` or the JAX package's ``.ckpt.npz``) starts at
the checkpoint's step and keeps every cadence on that absolute step.
``attach_viewer`` serves the interactive viewer (``viewer/server.py``) on
the trainer's state: each step then runs under the viewer's
``train_lock``, the loop waits while the viewer is paused, and the
viewer's config follows the trainer's when the growth of capacities
replaces it. Under the progressive-resolution schedule
(``num_downscales`` > 0) a step's frame is resized by
``data/resize.py:resize_area`` (``cv2.resize(INTER_AREA)`` on the frame's
uint8 samples, recovered exactly from the cached k / 255), its camera
rescaled and its mask strided, as the JAX trainer's ``_run_one`` does,
and cropped to the frame where d does not divide its size; the small
frames are not cached. With ``camera_opt`` SO3xR3 or SE3 each step also
optimizes its training camera's pose (``step.train_step_camopt``), whose
deltas and optimizer state ride a ``pose-<step>.npz`` sidecar beside each
checkpoint in the JAX package's layout. With ``num_devices`` > 1 the
trainer is one rank of a process group of that many (``scripts/train.py``
starts them): each step renders this rank's band of the view and sums the
gradients over the mesh (``train/step.py:sharded_step``); with
``data_parallel`` B each step takes B cameras, one a row of the mesh, and
averages their gradients. Every rank holds the same state, draws the
same views and backgrounds, re-charts and grows its capacities on the
same (all-reduced) numbers; only rank 0 writes (the writer, checkpoints,
pose sidecars, eval images and scalars) and serves the viewer. Every rank
resumes from the same checkpoint. Steps are taken in chunks of up to
``steps_per_sync`` (``_chunk_size``: JAX's rules, each chunk ending on
its cadences), one scan a chunk (``train/step.py:make_train_scan``, on
the card one captured CUDA graph replayed a step; over the mesh
``parallel/shard.py:make_sharded_train_scan``), whose metrics the host
reads once; the NaN gate and the capacity growth look at every step of
the chunk, the cadences run after its last, and ``history`` keeps one row
a step. A viewer, pose optimization, a downscaled frame, a masked view,
data parallelism and (on the card) the ``xla`` and ``oracle`` renderers
take single steps; a group that accumulates gradients chunks like any
other (its ``mini_step`` moves in the chunk's Adam table). A chunk's
logged row carries its steps' largest ``overflow``, ``total_pairs`` and
``max_tile_count``, as the JAX trainer's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.manager import FullImageCache
from ..data.resize import resize_area
from ..models import gstex as model
from ..ops import pose_opt
from ..ops.binning import settle_caps
from ..ops.camera import make_camera
from ..parallel.distributed import make_mesh
from ..scripts.render import demand_caps, eval_background
from ..utils import checkpoint as ckpt_io
from ..utils import profiler
from ..utils.metrics import image_metrics
from ..utils.writer import NullWriter, Writer
from . import optim
from . import step as step_mod


@dataclasses.dataclass
class TrainerConfig:
    """The JAX package's ``TrainerConfig``, field for field."""

    max_num_iterations: int = 15000
    steps_per_save: int = 2000
    steps_per_eval_image: int = 500
    steps_per_eval_all_images: int = 0
    save_only_latest_checkpoint: bool = True
    seed: int = 42
    output_dir: str = "outputs/unnamed"
    load_checkpoint: Optional[str] = None
    log_every: int = 10
    num_devices: int = 0
    data_parallel: int = 0
    check_finite: bool = True
    # training steps under one dispatch (``train/step.py:make_train_scan``:
    # on CUDA one captured step replayed a step), clipped so that a chunk
    # ends on each cadence; 1 dispatches one step at a time
    steps_per_sync: int = 8
    # comma-separated metric sinks: tensorboard / wandb / comet (JSONL
    # and the console are always on); a missing sink is skipped with a
    # notice
    vis: str = "tensorboard"
    demand_size_caps: bool = False
    # camera pose optimization: off | SO3xR3 | SE3
    camera_opt: str = "off"


def _check_mesh(tcfg: TrainerConfig, mcfg: model.GStexConfig):
    """The JAX trainer's refusals of a mesh configuration, and the
    port's one more: the band loss has no estimated normals."""
    if tcfg.num_devices <= 1:
        return
    if tcfg.data_parallel > 1:
        if tcfg.num_devices % tcfg.data_parallel:
            raise ValueError(f"num_devices={tcfg.num_devices} not divisible "
                             f"by data_parallel={tcfg.data_parallel}")
        if mcfg.num_downscales > 0:
            raise ValueError("data_parallel requires num_downscales=0 "
                             "(uniform batch resolution per step)")
        if tcfg.camera_opt != "off":
            raise ValueError("camera_opt composes with tile-row sharding, "
                             "not camera-batch DP (data_parallel must be 1)")
    if mcfg.use_normal_loss:
        raise ValueError("use_normal_loss under num_devices > 1: the "
                         "estimated normals need the whole frame's depth, "
                         "and a rank renders one band (ROADMAP Known, not "
                         "faults)")
    if not dist.is_initialized() or dist.get_world_size() != \
            tcfg.num_devices:
        raise RuntimeError(
            f"num_devices={tcfg.num_devices} trains one process a rank: "
            f"start them with gstex-torch-train --num-devices "
            f"{tcfg.num_devices} (or torchrun), or join a group of that "
            f"size with parallel.distributed.init_distributed first")


# k / 255 for every uint8 k, as numpy's float32 division makes it (a
# division by a scalar on the card multiplies by its reciprocal instead)
_U8_TO_FLOAT = np.arange(256, dtype=np.float32) / np.float32(255.0)


def downscale(cam, img: torch.Tensor, mask, d: int):
    """The progressive-resolution schedule's frame at 1/d: the float
    k / 255 image's uint8 samples resized by ``resize_area``, the camera's
    intrinsics divided by d and its size floored, the mask strided
    (``gstex_tpu/train/trainer.py:_downscale`` and ``_run_one``) and
    cropped to the frame's size."""
    u8 = torch.round(img * 255.0).to(torch.uint8)
    small = resize_area(u8, d)
    lut = torch.as_tensor(_U8_TO_FLOAT, device=img.device)
    small = lut[small.long()]
    h, w = small.shape[:2]
    cam2 = make_camera(cam.fx / d, cam.fy / d, cam.cx / d, cam.cy / d, h, w,
                       cam.c2w, device=img.device)
    # the strided mask cropped to the frame, whose size is floored
    return cam2, small, (None if mask is None else mask[::d, ::d][:h, :w])


class Trainer:
    def __init__(self, tcfg: TrainerConfig, mcfg: model.GStexConfig,
                 ocfg: optim.OptimConfig, params, buffers,
                 train_cache: FullImageCache,
                 eval_cache: Optional[FullImageCache] = None,
                 run_config: Optional[dict] = None):
        if tcfg.steps_per_sync < 1:
            raise ValueError(f"steps_per_sync={tcfg.steps_per_sync} (at "
                             f"least 1)")
        if tcfg.camera_opt not in pose_opt.MODES:
            raise ValueError(f"camera_opt={tcfg.camera_opt!r} (expected "
                             f"one of {pose_opt.MODES})")
        _check_mesh(tcfg, mcfg)
        self.mesh = None
        if tcfg.num_devices > 1:
            self.mesh = make_mesh(tcfg.num_devices, tcfg.data_parallel)
        # rank 0 (or the one process) writes
        self.writes = self.mesh is None or self.mesh.rank == 0
        self.tcfg, self.mcfg, self.ocfg = tcfg, mcfg, ocfg
        self.train_cache = train_cache
        self.eval_cache = eval_cache
        self.run_config = run_config or {}
        self.out_dir = Path(tcfg.output_dir)
        self.writer = (Writer(self.out_dir, vis=tcfg.vis) if self.writes
                       else NullWriter())
        self.state = step_mod.init_state(mcfg, ocfg, params, buffers,
                                         seed=tcfg.seed)
        if tcfg.load_checkpoint:
            ckpt_io.load_checkpoint(tcfg.load_checkpoint, self.state,
                                    seed=tcfg.seed)
            self._say(f"resumed from {tcfg.load_checkpoint} at step "
                      f"{self.state.step}")
        self.pose = None
        if tcfg.camera_opt != "off":
            self.pose = step_mod.init_pose_state(
                len(train_cache), device=self.state.params.means.device)
            if tcfg.load_checkpoint:
                aux = ckpt_io.aux_for_checkpoint(tcfg.load_checkpoint,
                                                 "pose")
                if aux is not None:
                    ckpt_io.load_pose(aux, self.pose)
        if tcfg.demand_size_caps and len(train_cache) > 0:
            self.mcfg = self._demand_size_caps()
        self.history: list[dict] = []
        self._eval_counter = 0
        self.viewer = None
        # the scans by image size (``_scan_for``)
        self._scans: dict = {}

    def _say(self, msg: str) -> None:
        if self.writes:
            print(msg, flush=True)

    def attach_viewer(self, port: int = 7007):
        """Start the interactive viewer on this trainer's state; returns
        it (its ``port`` is the one bound, for ``port=0`` a free one)."""
        from ..viewer.server import Viewer

        self.viewer = Viewer(self.mcfg, lambda: self.state, trainer=self,
                             port=port).start()
        print(f"viewer on http://localhost:{self.viewer.port}")
        return self.viewer

    def _demand_size_caps(self) -> model.GStexConfig:
        """pair_cap / s_max sized to the first train view's measured
        demand (``settle_caps``)."""
        mcfg, st = self.mcfg, self.state
        cam = self.train_cache.get(0)[0]
        with torch.no_grad():
            p, s = demand_caps(mcfg, st.params, st.buffers, [cam],
                               mcfg.sh_degree * mcfg.sh_degree_interval)
        if (p, s) != (mcfg.pair_cap, mcfg.s_max):
            self._say(f"demand-sized capacities: pair_cap {mcfg.pair_cap}->"
                      f"{p}, s_max {mcfg.s_max}->{s}")
        return dataclasses.replace(mcfg, pair_cap=p, s_max=s)

    def train(self) -> list[dict]:
        """Run from the state's step to ``max_num_iterations``; returns
        the per-step metrics."""
        tcfg, st = self.tcfg, self.state
        t_last, since_log = time.time(), 0
        while st.step < tcfg.max_num_iterations:
            while self.viewer is not None and self.viewer.paused:
                time.sleep(0.1)
            lock = (self.viewer.train_lock if self.viewer is not None
                    else contextlib.nullcontext())
            with profiler.time_section("train_iteration"):
                with lock:
                    if self.mesh is not None and self.mesh.data > 1:
                        rows, scanned = [self._run_dp()], False
                    else:
                        rows, scanned = self._run_chunk(st.step)
            for step, idx, cam, metrics in rows:
                self.history.append(dict(metrics, step=step, camera=idx))
            since_log += len(rows)
            # the chunk's last step is the one its cadences run after;
            # growth and the NaN gate see every step of the chunk
            step, _, cam, metrics = rows[-1]
            if tcfg.check_finite:
                for s, _, _, m in rows:
                    if not math.isfinite(m["loss"]):
                        self._nan_abort(s, m)
            # the growth sizes the caps to the chunk's peak demand, and a
            # scanned chunk's row carries the peaks, as JAX's does
            peak = {k: max(r[3][k] for r in rows)
                    for k in step_mod.SCAN_COUNTS}
            if peak["overflow"] > 0:
                self._grow_capacities(step, dict(metrics, **peak))
            if scanned:
                metrics = dict(metrics, **peak)
            if (self.mcfg.build_chart_every > 0 and step > 0
                    and step % self.mcfg.build_chart_every == 0):
                with profiler.time_section("retexture_after"), lock:
                    step_mod.rechart_step(self.mcfg, st)
            if tcfg.log_every > 0 and step % tcfg.log_every == 0:
                now = time.time()
                metrics["rays_per_sec"] = (cam.height * cam.width * since_log
                                           / max(now - t_last, 1e-6))
                metrics["texel_count"] = float(model.texel_count(st.buffers))
                t_last, since_log = now, 0
                self.writer.scalars(step, metrics)
            if (self.writes and tcfg.steps_per_eval_image > 0
                    and self.eval_cache
                    and step % tcfg.steps_per_eval_image == 0):
                self.eval_one(step)
            if (self.writes and tcfg.steps_per_eval_all_images > 0
                    and self.eval_cache and step > 0
                    and step % tcfg.steps_per_eval_all_images == 0):
                agg = self.eval_all()
                self.writer.scalars(step, {f"eval_all_{k}": v
                                           for k, v in agg.items()
                                           if v is not None})
            if (tcfg.steps_per_save > 0 and step > 0
                    and step % tcfg.steps_per_save == 0):
                self.save()
        self._drop_scans()
        self.save()
        self._say(profiler.summary())
        self.writer.close()
        return self.history

    def _chunk_size(self, step: int) -> int:
        """Steps that one scan makes from ``step`` (the JAX trainer's
        ``_chunk_size``): ``steps_per_sync``, clipped so that the chunk
        ends on the next step of each cadence (an event at step s runs
        after step s), at ``max_num_iterations`` and before a change of
        the resolution schedule's factor; 1 with a viewer, pose
        optimization or a downscaled frame. The port adds one: 1 on the
        card for the renderers without kernels (``xla``, ``oracle``),
        whose plain versions read counts back to the host."""
        tcfg, mcfg = self.tcfg, self.mcfg
        n = tcfg.steps_per_sync
        if (n <= 1 or self.viewer is not None
                or self.pose is not None
                or model.downscale_factor(mcfg, step) > 1
                or (self.state.params.means.device.type == "cuda"
                    and not mcfg.renderer.startswith("pallas"))):
            return 1
        cadences = [c for c in (mcfg.build_chart_every, tcfg.log_every,
                                tcfg.steps_per_eval_image,
                                tcfg.steps_per_eval_all_images,
                                tcfg.steps_per_save) if c and c > 0]
        for c in cadences:
            nxt = step if step % c == 0 else step + (c - step % c)
            n = min(n, nxt - step + 1)
        n = min(n, tcfg.max_num_iterations - step)
        # no chunk across a change of the resolution schedule's factor
        while (n > 1 and model.downscale_factor(mcfg, step + n - 1)
               != model.downscale_factor(mcfg, step)):
            n -= 1
        return max(n, 1)

    def _scan_for(self, height: int, width: int):
        """The scan for (height, width), made at first use: over the mesh
        ``parallel.shard.make_sharded_train_scan``, else
        ``step.make_train_scan`` (whose graph's per-step values come from
        device tables, so nothing else keys it). Dropped when the
        capacities grow."""
        key = (height, width)
        if key not in self._scans:
            if self.mesh is not None:
                from ..parallel.shard import make_sharded_train_scan

                fn = make_sharded_train_scan(self.mcfg, self.mesh, height,
                                             width)
                self._scans[key] = lambda cams, imgs: fn(self.state, cams,
                                                         imgs)
            else:
                self._scans[key] = step_mod.make_train_scan(
                    self.mcfg, self.ocfg, self.state, height, width,
                    capacity=self.tcfg.steps_per_sync)
        return self._scans[key]

    def _drop_scans(self) -> None:
        """Release the scans and their graphs' memory."""
        self._scans = {}
        if self.state.params.means.device.type == "cuda":
            torch.cuda.empty_cache()

    def _run_chunk(self, step: int) -> tuple[list, bool]:
        """The next ``_chunk_size(step)`` views' steps: through the scan
        where they are more than one, share one size and have no mask,
        else one at a time. Returns (step, camera index, camera, float
        metrics) a step, the host's one read of the chunk's metrics, and
        whether the scan took them."""
        n = self._chunk_size(step)
        batch = [self.train_cache.next_train_idx() for _ in range(n)]
        same_size = len({(c.height, c.width) for _, (c, _, _) in batch}) == 1
        no_mask = all(m is None for _, (_, _, m) in batch)
        if n > 1 and same_size and no_mask:
            cams = [c for _, (c, _, _) in batch]
            scan = self._scan_for(cams[0].height, cams[0].width)
            ms = scan(cams, [img for _, (_, img, _) in batch])
            keys = list(ms)
            host = torch.stack([ms[k].to(torch.float64)
                                for k in keys]).cpu().numpy()
            return [(step + i, idx, cam,
                     {k: float(host[j, i]) for j, k in enumerate(keys)})
                    for i, (idx, (cam, _, _)) in enumerate(batch)], True
        return [(step + i, idx, *self._run_one(step + i, idx, cam, img, mask))
                for i, (idx, (cam, img, mask)) in enumerate(batch)], False

    def _run_one(self, step: int, idx: int, cam, img, mask):
        """One view's step, on this process or over the mesh: (camera,
        float metrics)."""
        tcfg, st = self.tcfg, self.state
        d = model.downscale_factor(self.mcfg, step)
        if d > 1:
            cam, img, mask = downscale(cam, img, mask, d)
        camopt = (None if self.pose is None
                  else (self.pose, tcfg.camera_opt, idx))
        if self.mesh is not None:
            metrics = step_mod.sharded_step(
                self.mcfg, st, self.mesh, cam.height, cam.width, [cam],
                [img], [mask], camopt)
        elif camopt is None:
            metrics = step_mod.train_step(self.mcfg, self.ocfg, st, cam, img,
                                          mask)
        else:
            metrics = step_mod.train_step_camopt(
                self.mcfg, self.ocfg, st, self.pose, tcfg.camera_opt, cam,
                idx, img, mask)
        return cam, {k: float(v) for k, v in metrics.items()}

    def _run_dp(self):
        """One data-parallel step: the next ``data_parallel`` views, one a
        row of the mesh, one update from the mean of their gradients (the
        reference DDP's per-iteration semantics). Returns (step, camera
        index, camera, float metrics)."""
        step = self.state.step
        batch = [self.train_cache.next_train_idx()
                 for _ in range(self.mesh.data)]
        res = {(c.height, c.width) for _, (c, _, _) in batch}
        if len(res) != 1:
            raise ValueError(f"data_parallel needs a uniform-resolution "
                             f"dataset; got {res}")
        if any(m is not None for _, (_, _, m) in batch):
            # JAX's batched step has no mask input and refuses masks
            raise ValueError("data_parallel does not support per-image "
                             "masks; run without --data-parallel")
        cams = [c for _, (c, _, _) in batch]
        metrics = step_mod.sharded_step(
            self.mcfg, self.state, self.mesh, cams[0].height, cams[0].width,
            cams, [img for _, (_, img, _) in batch], [None] * len(batch))
        return step, batch[0][0], cams[0], {k: float(v)
                                            for k, v in metrics.items()}

    def _grow_capacities(self, step: int, metrics: dict) -> None:
        """Overflow-driven capacity growth, sized to the step's measured
        demand with headroom (``settle_caps``), never below the
        overflowing caps doubled where they bound."""
        mcfg = self.mcfg
        total, hottest = int(metrics["total_pairs"]), int(
            metrics["max_tile_count"])
        new_p, new_s = settle_caps(total, hottest)
        if total >= mcfg.pair_cap:
            new_p = max(new_p, mcfg.pair_cap * 2)
        if hottest >= mcfg.s_max:
            new_s = max(new_s, mcfg.s_max * 2)
        new_p = min(max(new_p, mcfg.pair_cap), 1 << 23)
        new_s = min(max(new_s, mcfg.s_max), 4096)
        if (new_p, new_s) == (mcfg.pair_cap, mcfg.s_max):
            self._say(f"WARNING step {step}: overflow "
                      f"{int(metrics['overflow'])} at max capacities "
                      f"(s_max={mcfg.s_max})")
            return
        self._say(f"step {step}: overflow {int(metrics['overflow'])} — "
                  f"growing s_max {mcfg.s_max}->{new_s}, pair_cap "
                  f"{mcfg.pair_cap}->{new_p}")
        self.mcfg = dataclasses.replace(mcfg, s_max=new_s, pair_cap=new_p)
        # the scans hold the old caps' shapes
        self._drop_scans()
        if self.viewer is not None:
            self.viewer.cfg = self.mcfg

    def _nan_abort(self, step: int, metrics: dict):
        """Dump the step, its metrics and per-leaf param stats, and abort."""
        leaves = {}
        for name, leaf in self.state.params._asdict().items():
            x = leaf.detach()
            finite = torch.isfinite(x)
            leaves[name] = {
                "finite_frac": float(finite.float().mean()),
                "absmax": float(x[finite].abs().max()) if finite.any()
                else float("nan"),
            }
        path = self.out_dir / f"nan_dump_step{step}.json"
        if self.writes:
            path.write_text(json.dumps({"step": step, "metrics": metrics,
                                        "params": leaves}, indent=1))
        raise FloatingPointError(
            f"non-finite loss at step {step}; diagnostic at {path}")

    def _eval_metrics(self, i: int, step: Optional[int] = None) -> dict:
        """The metrics of eval view ``i``; given a ``step``, its render
        is also written as that step's ``eval_rgb`` image."""
        cam, img, _ = self.eval_cache.get(i)
        bg = eval_background(self.mcfg, img.device)
        out = step_mod.eval_step(self.mcfg, self.state, cam, bg)
        if step is not None:
            self.writer.image(step, "eval_rgb", out["rgb"])
        return image_metrics(out["rgb"], model.composite_gt(img, bg))

    def eval_one(self, step: int) -> dict:
        """PSNR, SSIM and LPIPS (``None``) of one eval view, cycling
        through the eval set; written as ``eval_*`` scalars and the
        ``eval_rgb`` image."""
        i = self._eval_counter % len(self.eval_cache)
        self._eval_counter += 1
        m = self._eval_metrics(i, step)
        self.writer.scalars(step, {f"eval_{k}": v for k, v in m.items()
                                   if v is not None})
        return m

    def eval_all(self, save_images: bool = False) -> dict:
        """The JAX package's ``eval_all`` schema over the eval set: each
        metric's mean, and its (population) ``_std`` where it is not
        ``None`` (LPIPS is); ``fps`` and ``num_rays_per_sec`` of the
        renders on the host clock, after one warm-up render outside it,
        each frame ending in a synchronize on CUDA, as JAX's host copy
        does; ``gaussian_count``, ``texel_count`` and ``pixel_scale``.
        ``save_images`` sends each eval render through the writer as
        image ``i`` of ``eval_all_rgb`` (``images/eval_all_rgb_<i>.png``
        and the sinks), as JAX's ``eval_all`` does."""
        n = len(self.eval_cache)
        cam, img, _ = self.eval_cache.get(0)
        bg = eval_background(self.mcfg, img.device)
        sync = (torch.cuda.synchronize if img.device.type == "cuda"
                else lambda: None)
        step_mod.eval_step(self.mcfg, self.state, cam, bg)
        sync()
        rows, t_render = [], 0.0
        for i in range(n):
            cam, img, _ = self.eval_cache.get(i)
            t0 = time.perf_counter()
            out = step_mod.eval_step(self.mcfg, self.state, cam, bg)
            sync()
            t_render += time.perf_counter() - t0
            rows.append(image_metrics(out["rgb"],
                                      model.composite_gt(img, bg)))
            if save_images:
                self.writer.image(i, "eval_all_rgb", out["rgb"])
        agg = {k: None if rows[0][k] is None
               else float(np.mean([r[k] for r in rows])) for k in rows[0]}
        agg.update({f"{k}_std": float(np.std([r[k] for r in rows]))
                    for k in rows[0] if rows[0][k] is not None})
        agg["fps"] = n / t_render
        agg["num_rays_per_sec"] = n * cam.height * cam.width / t_render
        agg["gaussian_count"] = float(self.state.params.means.shape[0])
        agg["texel_count"] = float(model.texel_count(self.state.buffers))
        agg["pixel_scale"] = float(self.state.buffers.pixel_scale)
        return agg

    def save(self) -> Optional[Path]:
        """The checkpoint (and pose sidecar) of the state as it is; rank 0
        alone writes, and the other ranks return ``None``."""
        if not self.writes:
            return None
        path = ckpt_io.save_checkpoint(
            self.out_dir / "checkpoints", self.state, self.run_config,
            keep_only_latest=self.tcfg.save_only_latest_checkpoint)
        if self.pose is not None:
            # the pose deltas ride a sidecar in the JAX package's layout,
            # so the main checkpoint's format stays as it is
            ckpt_io.save_aux(
                self.out_dir / "checkpoints", "pose",
                ckpt_io.pose_leaves(self.pose), self.state.step,
                keep_only_latest=self.tcfg.save_only_latest_checkpoint)
        print(f"saved {path}")
        return path
