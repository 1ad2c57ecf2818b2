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
from ..ops import launch_counts, pose_opt
from ..ops.camera import Camera, stack_cameras
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
    # the state's own buffers: a re-chart updates them in place
    buffers = model.GStexBuffers(*(b.clone() for b in buffers))
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


# the scan's metrics: the loss terms and PSNR (float32), then the
# binning's counts (ints)
SCAN_METRICS = ("main_loss", "l1", "ssim_loss", "normal_loss", "reg_loss",
                "loss", "psnr")
SCAN_COUNTS = ("overflow", "total_pairs", "max_tile_count")


class _ChunkTables:
    """The static buffers a captured step reads: row ``pos`` of each holds
    that step's camera, image, background, step number and Adam values,
    and the step writes its metrics to row ``pos`` and advances ``pos``."""

    def __init__(self, capacity: int, height: int, width: int, image_shape,
                 groups: int, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.capacity = capacity
        self.pos = torch.zeros(1, dtype=torch.int64, device=device)
        self.steps = torch.zeros(capacity, dtype=torch.int64, device=device)
        zeros = lambda *shape: torch.zeros(shape, **f32)
        self.cams = Camera(zeros(capacity), zeros(capacity), zeros(capacity),
                           zeros(capacity), height, width,
                           zeros(capacity, 3, 4))
        self.images = torch.zeros((capacity, *image_shape), **f32)
        self.backgrounds = torch.zeros((capacity, 3), **f32)
        self.adam = torch.zeros((capacity, groups, 4), **f32)
        # float32 metrics and int counts, all exact in float64
        self.metrics = torch.zeros(
            (capacity, len(SCAN_METRICS) + len(SCAN_COUNTS)),
            dtype=torch.float64, device=device)

    def row(self, table: torch.Tensor) -> torch.Tensor:
        return table.index_select(0, self.pos)[0]

    def camera(self) -> Camera:
        c = self.cams
        return Camera(self.row(c.fx), self.row(c.fy), self.row(c.cx),
                      self.row(c.cy), c.height, c.width, self.row(c.c2w))


class TrainScan:
    """``make_train_scan``'s callable: ``(cams, images) -> metrics``."""

    # graph captures and replays of every scan, since the last reset
    captures = 0
    replays = 0

    def __init__(self, cfg: model.GStexConfig, state: TrainState,
                 height: int, width: int, capacity: Optional[int] = None):
        self.cfg, self.state = cfg, state
        self.height, self.width = height, width
        self.capacity = capacity
        self.tables: Optional[_ChunkTables] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # kernel launches of one captured step, by wrapper
        self.launches_per_step: dict = {}
        # the captured graph in Graphviz form, once ``graph_kernels`` asks
        self._dot: Optional[str] = None

    def __call__(self, cams, images) -> dict:
        n = len(cams)
        if n < 1 or len(images) != n:
            raise ValueError(f"{n} cameras and {len(images)} images")
        if any((c.height, c.width) != (self.height, self.width)
               for c in cams):
            raise ValueError(f"a chunk's cameras must all be "
                             f"{self.height}x{self.width}")
        st = self.state
        dev = st.params.means.device
        if self.tables is None:
            self.tables = _ChunkTables(self.capacity or n, self.height,
                                       self.width, tuple(images[0].shape),
                                       len(st.optimizer.param_groups), dev)
        t = self.tables
        if n > t.capacity or tuple(images[0].shape) != t.images.shape[1:]:
            raise ValueError(f"a chunk of {n} {tuple(images[0].shape)} "
                             f"images; this scan holds {t.capacity} of "
                             f"{tuple(t.images.shape[1:])}")
        with torch.no_grad():
            t.steps[:n] = torch.arange(st.step, st.step + n, device=dev)
            stacked = stack_cameras(cams)
            for table, rows in zip(t.cams.intrins + (t.cams.c2w,),
                                   stacked.intrins + (stacked.c2w,)):
                table[:n] = rows
            for i in range(n):
                t.images[i] = images[i]
                # the backgrounds in the order the single steps draw them
                t.backgrounds[i] = model.sample_background(
                    self.cfg, st.generator, device=dev)
            t.adam[:n] = st.optimizer.step_table(n, dev)
            t.pos.zero_()
        if dev.type == "cuda":
            self._replay(n)
        else:
            for _ in range(n):
                self._step()
        st.step += n
        st.optimizer.advance(n)
        rows = t.metrics[:n].clone()
        k = len(SCAN_METRICS)
        out = {key: rows[:, j].to(torch.float32)
               for j, key in enumerate(SCAN_METRICS)}
        out.update({key: rows[:, k + j].to(torch.int64)
                    for j, key in enumerate(SCAN_COUNTS)})
        return out

    def _step(self) -> None:
        """One step from row ``pos`` of the tables, with no host sync."""
        t = self.tables
        metrics = _body(self.cfg, self.state, t.camera(), t.row(t.images),
                        None, t.row(t.backgrounds), t.row(t.steps),
                        table=t.adam, pos=t.pos)
        with torch.no_grad():
            row = torch.stack([torch.as_tensor(metrics[k]).to(
                device=t.metrics.device, dtype=torch.float64)
                for k in SCAN_METRICS + SCAN_COUNTS])
            t.metrics.index_copy_(0, t.pos, row[None])
            t.pos.add_(1)

    def _replay(self, n: int) -> None:
        replays = n
        if self.graph is None:
            self._warm_up()
            self._capture()
            # the warm-up made the chunk's first step
            replays = n - 1
        for _ in range(replays):
            self.graph.replay()
        TrainScan.replays += replays
        launch_counts.add(self.launches_per_step, replays)

    def _warm_up(self) -> None:
        """The chunk's first step, eagerly on a side stream (the moments
        exist after it), with every host sync an error."""
        dev = self.state.params.means.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._step()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)

    def _capture(self) -> None:
        """One whole step captured into ``self.graph``; the launches its
        capture counted are taken back (nothing ran) and kept as the
        count of one replay. The graph is kept beside its executable, for
        ``graph_kernels``."""
        self.state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        before = launch_counts.snapshot()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            self._step()
        graph.instantiate()
        self.launches_per_step = launch_counts.take_back(before)
        self.graph = graph
        self._dot = None
        TrainScan.captures += 1

    def graph_kernels(self, names) -> dict:
        """Kernel nodes of the captured step: ``{"all": total, name:
        nodes whose kernel's name holds name}``, from the graph's
        Graphviz form (``cudaGraphDebugDotPrint``)."""
        if self.graph is None:
            raise ValueError("no graph captured yet")
        if self._dot is None:
            import tempfile

            with tempfile.TemporaryDirectory() as tmp:
                path = f"{tmp}/graph.dot"
                self.graph.debug_dump(path)
                with open(path) as f:
                    self._dot = f.read()
        # a kernel node's label opens with "{KERNEL" and names its
        # function on the line after
        lines = self._dot.splitlines()
        funcs = [lines[i + 1] for i, ln in enumerate(lines[:-1])
                 if 'label="{KERNEL' in ln]
        return {"all": len(funcs),
                **{nm: sum(nm in f for f in funcs) for nm in names}}


def make_train_scan(cfg: model.GStexConfig, ocfg: optim.OptimConfig,
                    state: TrainState, height: int, width: int,
                    capacity: Optional[int] = None) -> TrainScan:
    """n training steps under one dispatch (the counterpart of the JAX
    package's ``make_train_scan``): returns ``(cams, images) -> metrics``,
    which trains ``state`` on the n same-size cameras and (H, W, C)
    images in order and returns the steps' metrics as stacked (n,) device
    tensors (``SCAN_METRICS`` float32, ``SCAN_COUNTS`` int64), for the
    host to read once.

    The chunk's per-step values go to static device tables first: the
    cameras, the images, the n backgrounds (drawn from ``state.generator``
    in the single steps' order), the step numbers (the SH degree and the
    loss schedules follow them on the device) and the Adam updates' rows
    (``optim.Adam.step_table``; an accumulating group's divisor and
    update flag among them). On CUDA the first call runs one step
    eagerly on a side stream under ``torch.cuda.set_sync_debug_mode
    ("error")``, then captures one whole step (background, ground truth,
    prepare, cull, binning, records, the forward, SSIM and backward
    kernels, Adam) into a ``torch.cuda.CUDAGraph``; every call replays it
    once a step, each replay reading the next row. A failed capture or
    replay raises. On the CPU the same step runs n times, uncaptured. Each
    kernel's ``launches`` count grows by the launches one replay holds.

    ``capacity`` (default: the first call's n) bounds n. The chunk takes
    no masks. The graph holds the addresses of the state's tensors:
    anything that replaces one (a checkpoint loaded, capacities grown)
    needs a new scan; ``rechart_step`` updates them in place.
    ``ocfg`` is the config ``state.optimizer`` was made from."""
    return TrainScan(cfg, state, height, width, capacity)


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
    metrics = _body(cfg, state, cam, image, mask, background, state.step,
                    camopt)
    state.step += 1
    return metrics


def _body(cfg, state, cam, image, mask, background, step, camopt=None,
          table=None, pos=None) -> dict:
    """The step after its background: the ground truth, the render, the
    loss, the backward and the updates. ``step`` is the step's number, an
    int or (in a scan) a 0-d device tensor; ``table`` and ``pos``, given,
    are the Adam updates' per-step rows (``optim.Adam.step``)."""
    with record_function("gstex.background_gt"):
        gt = model.composite_gt(image, background)
        state.optimizer.zero_grad(set_to_none=True)
    if camopt is not None:
        pose = camopt[0]
        cam = _corrected(camopt, cam)
    outputs = model.render(cfg, state.params, state.buffers, cam, step,
                           background)
    with record_function("gstex.loss"):
        loss, parts = model.loss_fn(cfg, outputs, gt, step, mask=mask)
        if camopt is not None:
            reg = pose_opt.regularizer(pose.delta)
            loss = loss + reg
    with record_function("gstex.backward"):
        loss.backward()
    with record_function("gstex.adam"):
        state.optimizer.step(table=table, pos=pos)
        if camopt is not None:
            pose.optimizer.step()
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
                 camopt=None, table=None, pos=None) -> dict:
    """``_step`` over ``mesh``: one (camera, image, mask) a data row of
    the mesh, each row's ranks a band of its view. Every rank holds the
    whole state and ends the step with the same one. Returns the
    single-device step's metrics, the loss's as the mean over the rows
    (``shard.band_metrics``). ``table`` and ``pos``, given, are the Adam
    updates' per-step rows (``optim.Adam.step``)."""
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
        state.optimizer.step(table=table, pos=pos)
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
    the texture group's Adam moments. Every tensor of the state is
    updated in place (the re-chart keeps all shapes), so that a captured
    scan (``make_train_scan``) reads the new charts."""
    params, buffers = model.rechart(cfg, state.params, state.buffers)
    with torch.no_grad():
        state.params.texture.copy_(params.texture)
        for old, new in zip(state.buffers, buffers):
            old.copy_(new)
    optim.reset_texture_moments(state.optimizer)


def eval_step(cfg: model.GStexConfig, state: TrainState, cam: Camera,
              background: torch.Tensor) -> dict:
    """The forward-only render of one view (no gradient)."""
    with torch.no_grad():
        return model.render(cfg, state.params, state.buffers, cam,
                            state.step, background, eval_only=True)
