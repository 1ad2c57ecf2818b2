"""The scanned multi-step dispatch (``train/step.py:make_train_scan``,
``train/trainer.py:_chunk_size``) on the CPU, where a chunk runs its step
n times uncaptured:

- a chunk of 4 views bit-equal to 4 ``train_step`` calls (metrics,
  params, Adam moments and counts, the background generator), with the
  SH degree and the reg schedule changing inside the chunk;
- the same chunk against JAX's ``make_train_scan`` on the ``xla`` tier
  from the same params (a white background, so that no random draw
  differs): each step's loss within 1e-5 relative and the params' updates
  over their group's lr within 1e-3, as ``test_torch_train.py`` holds one
  step, with at most 1e-3 of a leaf's elements apart where their gradient
  is below 1e-6 of the leaf's largest (with eps 1e-15 such an element
  still moves by about ±lr);
- the table-driven Adam step bit-equal to the host one over 5 updates of
  the exponentially decaying xyz schedule, a param without a gradient
  left alone by both;
- ``_chunk_size`` equal to JAX's over a grid of steps, cadences, limits
  and resolution schedules, and the port's own single-step rules;
- every kernel wrapper's launch count registered
  (``ops/launch_counts.py``), which a capture takes back and a replay
  adds;
- a ``Trainer`` at ``steps_per_sync=8`` across a re-chart, logs, eval
  images and saves bit-equal (params, buffers, history, ``events.jsonl``
  but its wall-clock fields) to the same run at ``steps_per_sync=1``.

The ``cuda``-marked tests need the card (the graph against eager steps;
the warm-up and an eager step under ``set_sync_debug_mode("error")``) and
skip here. JAX is imported where it is installed (the card's machine has
none), so on the card the file runs with ``--noconftest``.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import orbit_c2w, random_scene
from gstex_torch.models import gstex as tmodel
from gstex_torch.ops import camera as tcam
from gstex_torch.train import optim as toptim
from gstex_torch.train import step as tstep
from gstex_torch.train import trainer as ttrainer

try:  # the card's machine has neither
    import jax
    import jax.numpy as jnp

    from gstex_tpu.models import gstex as jmodel
    from gstex_tpu.ops import camera as jcam
    from gstex_tpu.train import optim as joptim
    from gstex_tpu.train import step as jstep
    from gstex_tpu.train import trainer as jtrainer
except ImportError:
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="compares with JAX")

H, W, N = 64, 96, 4
LEAVES = tmodel.GStexParams._fields
# the SH degree moves at steps 2 and 4, the reg weight at step 2: inside
# the chunk of steps 1-4
CFG_KW = dict(chart_pad=(4, 4), pair_cap=8192, s_max=64,
              background_color="white", sh_degree_interval=2,
              lambda_reg=[0.1, 0.2, 2])
OPTIM = dict(max_steps=50)
FIRST_STEP = 1


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene(n=64, seed=2):
    """The scene's leaves and buffers as numpy arrays."""
    s = {k: v.numpy() for k, v in
         random_scene(n, chart_pad=(4, 4), seed=seed, device="cpu").items()}
    buffers = dict(texture_hw=s["texture_hw"], mappings=s["mappings"],
                   pixel_scale=np.float32(0.01),
                   test_colors=np.full((n, 3), 0.5, np.float32))
    return {k: s[k] for k in LEAVES}, buffers


def views():
    rng = np.random.default_rng(5)
    c2ws = [orbit_c2w(3.0, 0.3 + 0.2 * i) for i in range(N)]
    return c2ws, rng.uniform(0, 1, (N, H, W, 4)).astype(np.float32)


def port_state(cfg, device="cpu"):
    leaves, buffers = scene()
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    st = tstep.init_state(cfg, toptim.OptimConfig(**OPTIM),
                          tmodel.GStexParams(*(t(leaves[k]) for k in LEAVES)),
                          tmodel.GStexBuffers(*(t(v)
                                                for v in buffers.values())),
                          seed=3)
    st.step = FIRST_STEP
    return st


def port_views(device="cpu"):
    c2ws, images = views()
    f = 1.2 * max(H, W)
    cams = [tcam.make_camera(f, f, W / 2, H / 2, H, W, c, device=device)
            for c in c2ws]
    return cams, [torch.as_tensor(i, device=device) for i in images]


@pytest.fixture(scope="module")
def port_runs(one_thread):
    """The chunk and the single steps, on the xla tier."""
    cfg = tmodel.GStexConfig(renderer="xla", **CFG_KW)
    ocfg = toptim.OptimConfig(**OPTIM)
    cams, images = port_views()
    chunk, single = port_state(cfg), port_state(cfg)
    init = [p.detach().clone() for p in chunk.params]
    scan = tstep.make_train_scan(cfg, ocfg, chunk, H, W)
    got = scan(cams, images)
    want = [tstep.train_step(cfg, ocfg, single, c, i)
            for c, i in zip(cams, images)]
    return dict(chunk=chunk, single=single, init=init, got=got, want=want)


def test_scan_equals_single_steps(port_runs):
    chunk, single = port_runs["chunk"], port_runs["single"]
    got, want = port_runs["got"], port_runs["want"]
    assert set(got) == set(tstep.SCAN_METRICS + tstep.SCAN_COUNTS)
    for k, v in got.items():
        assert v.shape == (N,)
        assert torch.equal(v, torch.stack([torch.as_tensor(m[k]).to(v.dtype)
                                           for m in want])), k
    assert chunk.step == single.step == FIRST_STEP + N
    for name, a, b in zip(LEAVES, chunk.params, single.params):
        assert torch.equal(a, b), name
        sa, sb = chunk.optimizer.state[a], single.optimizer.state[b]
        assert sa.keys() == sb.keys(), name
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (name, key)
    assert [g["lr"] for g in chunk.optimizer.param_groups] == \
        [g["lr"] for g in single.optimizer.param_groups]
    assert torch.equal(chunk.generator.get_state(),
                       single.generator.get_state())
    # the step numbers reached the SH degree: the chunk's last steps use
    # the higher bands, which only then get a gradient
    assert float(chunk.params.features_rest.grad.abs().max()) > 0


@needs_jax
def test_scan_matches_jax(port_runs):
    leaves, buffers = scene()
    jp = jmodel.GStexParams(*(jnp.asarray(leaves[k]) for k in LEAVES))
    jb = jmodel.GStexBuffers(**{k: jnp.asarray(v)
                                for k, v in buffers.items()})
    jcfg = jmodel.GStexConfig(renderer="xla", **CFG_KW)
    jstate, tx = jstep.init_state(jcfg, joptim.OptimConfig(**OPTIM), jp, jb,
                                  jax.random.key(0))
    jstate = jstate._replace(step=jnp.int32(FIRST_STEP))
    c2ws, images = views()
    f = 1.2 * max(H, W)
    cams = jcam.stack_cameras([jcam.make_camera(f, f, W / 2, H / 2, H, W, c)
                               for c in c2ws])
    jnew, jm = jstep.make_train_scan(jcfg, tx)(jstate, cams,
                                               jnp.asarray(images))
    got = port_runs["got"]
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    assert got["overflow"].tolist() == np.asarray(jm["overflow"]).tolist()
    assert got["total_pairs"].tolist() == \
        np.asarray(jm["total_pairs"]).tolist()
    lrs = toptim.group_lrs(toptim.OptimConfig(**OPTIM))
    chunk = port_runs["chunk"]
    for k, leaf in enumerate(LEAVES):
        lr = lrs[toptim.GROUP_OF_LEAF[k]]
        lr = lr(0) if callable(lr) else lr
        p0 = leaves[leaf]
        got_u = (chunk.params[k].detach().numpy() - p0) / lr
        want_u = (np.asarray(jnew.params[k]) - p0) / lr
        st = chunk.optimizer.state[chunk.params[k]]
        rms = (np.zeros(p0.shape, np.float32) if not st
               else st["exp_avg_sq"].sqrt().numpy())
        bad = np.abs(got_u - want_u) > 1e-3
        tiny = rms <= 1e-6 * rms.max()
        assert not (bad & ~tiny).any(), leaf
        assert bad.sum() <= 1e-3 * bad.size, leaf


def test_table_adam_equals_host_adam():
    """5 updates from the same random gradients; features_dc has none, as
    where the SH degree is above 0."""
    rng = np.random.default_rng(3)
    leaves, _ = scene(n=16)
    ocfg = toptim.OptimConfig(max_steps=10)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in leaves.items()} for _ in range(5)]
    runs = []
    for table in (False, True):
        params = tmodel.GStexParams(*(torch.tensor(leaves[k],
                                                   requires_grad=True)
                                      for k in LEAVES))
        opt = toptim.make_optimizer(ocfg, params)
        rows = opt.step_table(5, "cpu") if table else None
        pos = torch.zeros(1, dtype=torch.int64)
        for g in grads:
            for k, p in zip(LEAVES, params):
                p.grad = (None if k == "features_dc"
                          else torch.tensor(g[k]))
            opt.step(table=rows, pos=pos)
            pos += 1
        if table:
            opt.advance(5)
        runs.append((params, opt))
    (hp, ho), (tp, to) = runs
    for name, a, b in zip(LEAVES, hp, tp):
        assert torch.equal(a, b), name
        assert ho.state[a].keys() == to.state[b].keys()
        for key in ho.state[a]:
            assert torch.equal(ho.state[a][key], to.state[b][key]), name
    assert not ho.state[hp.features_dc]
    assert [g["lr"] for g in ho.param_groups] == \
        [g["lr"] for g in to.param_groups]
    assert to.param_groups[0]["lr"] < toptim.group_lrs(ocfg)["xyz"](0)
    with pytest.raises(ValueError, match="per-step path"):
        toptim.make_optimizer(toptim.OptimConfig(gradient_accumulation=(
            ("texture_dc", 4),)), hp).step_table(2, "cpu")


CADENCES = [dict(build_chart_every=100, log_every=10, steps_per_eval_image=500,
                 steps_per_eval_all_images=0, steps_per_save=2000),
            dict(build_chart_every=7, log_every=5, steps_per_eval_image=6,
                 steps_per_eval_all_images=11, steps_per_save=13),
            dict(build_chart_every=0, log_every=0, steps_per_eval_image=0,
                 steps_per_eval_all_images=0, steps_per_save=0),
            dict(build_chart_every=4, log_every=1, steps_per_eval_image=0,
                 steps_per_eval_all_images=0, steps_per_save=0)]


@needs_jax
@pytest.mark.parametrize("cadence", range(len(CADENCES)))
def test_chunk_size_matches_jax(cadence):
    cpu = SimpleNamespace(type="cpu")
    port_state_ns = SimpleNamespace(
        optimizer=SimpleNamespace(every={}),
        params=SimpleNamespace(means=SimpleNamespace(device=cpu)))
    c = CADENCES[cadence]
    mkeys = ("build_chart_every",)
    for sps in (1, 3, 8):
        for iters in (15000, 23):
            for downscales, schedule in ((0, 250), (2, 9)):
                mkw = dict(num_downscales=downscales,
                           resolution_schedule=schedule,
                           **{k: c[k] for k in mkeys})
                tkw = dict(steps_per_sync=sps, max_num_iterations=iters,
                           **{k: v for k, v in c.items() if k not in mkeys})
                j = SimpleNamespace(tcfg=jtrainer.TrainerConfig(**tkw),
                                    mcfg=jmodel.GStexConfig(**mkw),
                                    viewer=None, pose_state=None)
                t = SimpleNamespace(tcfg=ttrainer.TrainerConfig(**tkw),
                                    mcfg=tmodel.GStexConfig(renderer="pallas",
                                                            **mkw),
                                    viewer=None, pose=None,
                                    state=port_state_ns)
                for step in range(0, min(iters, 40)):
                    assert (ttrainer.Trainer._chunk_size(t, step)
                            == jtrainer.Trainer._chunk_size(j, step)), (
                        sps, iters, downscales, step)


def test_chunk_size_single_step_rules():
    """A viewer, pose optimization, an accumulating group, and on the card
    the renderers without kernels take single steps."""
    cuda = SimpleNamespace(type="cuda")

    def chunk(renderer="pallas", every=None, device="cpu", **extra):
        ns = SimpleNamespace(
            tcfg=ttrainer.TrainerConfig(), viewer=None, pose=None,
            mcfg=tmodel.GStexConfig(renderer=renderer),
            state=SimpleNamespace(
                optimizer=SimpleNamespace(every=every or {}),
                params=SimpleNamespace(means=SimpleNamespace(
                    device=cuda if device == "cuda" else
                    SimpleNamespace(type="cpu")))))
        vars(ns).update(extra)
        return ttrainer.Trainer._chunk_size(ns, 1)

    assert chunk() == chunk(renderer="xla") == chunk(device="cuda") == 8
    assert chunk(viewer=object()) == chunk(pose=object()) == 1
    assert chunk(every={"texture_dc": 4}) == 1
    assert chunk(renderer="xla", device="cuda") == 1
    assert chunk(renderer="oracle", device="cuda") == 1
    assert ttrainer.TrainerConfig().steps_per_sync == 8


def test_trainer_chunks_equal_single_steps(tmp_path, one_thread):
    """9 steps with a re-chart every 3, a log every 4, an eval image
    every 5 and a save every 6: chunks 1-3 and 7-8 go through the scan at
    steps_per_sync=8, the rest one at a time."""
    from gstex_torch.data.blender import parse_blender
    from gstex_torch.data.manager import FullImageCache
    from gstex_torch.data.synthetic import write_blender_dataset

    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(4, 4),
                             pixel_num=1e3, pair_cap=1 << 12, s_max=64,
                             build_chart_every=3)
    leaves, buffers = scene(n=40)
    params = tmodel.GStexParams(*(torch.tensor(leaves[k]) for k in LEAVES))
    bufs = tmodel.GStexBuffers(*(torch.tensor(np.array(v))
                                 for v in buffers.values()))
    data = tmp_path / "data"
    write_blender_dataset(data, cfg, params, bufs, 3, 32, 32, dist=3.0)
    write_blender_dataset(data, cfg, params, bufs, 1, 32, 32, split="test",
                          dist=3.0, azimuth0=0.4)
    runs = {}
    for sps in (8, 1):
        out = tmp_path / f"run{sps}"
        tcfg = ttrainer.TrainerConfig(
            max_num_iterations=9, steps_per_save=6, steps_per_eval_image=5,
            log_every=4, steps_per_sync=sps, vis="wandb",
            save_only_latest_checkpoint=False, output_dir=str(out))
        caches = [FullImageCache.build(parse_blender(data, split), seed=42,
                                       device="cpu")
                  for split in ("train", "test")]
        tr = ttrainer.Trainer(tcfg, cfg, toptim.OptimConfig(max_steps=9),
                              params, bufs, *caches)
        hist = tr.train()
        rows = [json.loads(ln) for ln in
                (out / "events.jsonl").read_text().splitlines()]
        for r in rows:
            r.pop("t", None)
            r.pop("rays_per_sec", None)
        runs[sps] = dict(tr=tr, hist=hist, rows=rows,
                         saves=sorted(p.name for p in
                                      (out / "checkpoints").iterdir()))
    a, b = runs[8], runs[1]
    assert a["hist"] == b["hist"]
    assert [h["step"] for h in a["hist"]] == list(range(9))
    assert a["rows"] == b["rows"]
    assert {r["step"] for r in a["rows"] if "eval_psnr" in r} == {0, 5}
    assert {r["step"] for r in a["rows"] if "loss" in r} == {0, 4, 8}
    assert a["saves"] == b["saves"] == ["step-000000007.ckpt.pt",
                                        "step-000000009.ckpt.pt"]
    for x, y in zip(list(a["tr"].state.params) + list(a["tr"].state.buffers),
                    list(b["tr"].state.params) + list(b["tr"].state.buffers)):
        assert torch.equal(x, y)


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def card_chunk(n=4):
    """A flat-tier state on the card, n views, and the scan's config."""
    cfg = tmodel.GStexConfig(renderer="pallas", **CFG_KW)
    cams, images = port_views("cuda")
    return cfg, cams[:n], images[:n]


WRAPPERS = {
    "rasterize_eval": "rasterize_eval", "rasterize_fwd": "rasterize_fwd",
    "rasterize_bwd": "rasterize_bwd",
    "rasterize_eval_bf16": "rasterize_eval",
    "rasterize_fwd_bf16": "rasterize_fwd",
    "rasterize_bwd_bf16": "rasterize_bwd",
    "rasterize_dense_eval": "rasterize_dense",
    "rasterize_dense_fwd": "rasterize_dense",
    "rasterize_dense_bwd": "rasterize_dense",
    "rasterize_v3_fwd": "rasterize_v3", "rasterize_v3_bwd": "rasterize_v3",
    "rasterize_v2_fwd": "rasterize_v2", "rasterize_v2_bwd": "rasterize_v2",
    "rasterize_v1_fwd": "rasterize_v1", "rasterize_v1_bwd": "rasterize_v1",
    "fused_ssim_value_and_grad": "ssim_fused",
    "scatter_canvas": "texture_edit"}


def test_every_kernel_wrapper_registers_its_count():
    """Each kernel wrapper registers its launch count with
    ``ops.launch_counts`` when its module is imported; ``take_back``
    undoes what a capture counted and returns it, ``add`` counts it once
    a replay."""
    import importlib

    from gstex_torch.ops import launch_counts

    for name, module in WRAPPERS.items():
        fn = getattr(importlib.import_module(f"gstex_torch.ops.{module}"),
                     name)
        assert fn in launch_counts.WRAPPERS, name
    assert sorted(fn.__name__ for fn in launch_counts.WRAPPERS) == sorted(
        WRAPPERS)
    fwd = launch_counts.WRAPPERS[
        [fn.__name__ for fn in launch_counts.WRAPPERS].index("rasterize_fwd")]
    before = launch_counts.snapshot()
    fwd.launches += 3
    assert launch_counts.take_back(before) == {fwd: 3}
    assert launch_counts.snapshot() == before
    launch_counts.add({fwd: 3}, 2)
    assert fwd.launches == before[fwd] + 6
    fwd.launches = before[fwd]


@pytest.mark.cuda
def test_graph_chunk_against_eager_steps():
    """A chunk of 4 through the captured graph against 4 eager steps: the
    losses within 1e-4, each kernel launched as often (the backward adds
    with atomics: no bit equality), and one node of the captured graph
    for each launch a replay counts."""
    cuda_or_skip()
    from gstex_torch.ops import rasterize_bwd, rasterize_fwd, ssim_fused

    cfg, cams, images = card_chunk()
    ocfg = toptim.OptimConfig(**OPTIM)
    counters = (rasterize_fwd.rasterize_fwd, rasterize_bwd.rasterize_bwd,
                ssim_fused.fused_ssim_value_and_grad)
    launches = []
    losses = []
    for chunked in (False, True):
        st = port_state(cfg, "cuda")
        for fn in counters:
            fn.launches = 0
        if chunked:
            scan = tstep.make_train_scan(cfg, ocfg, st, H, W)
            losses.append(scan(cams, images)["loss"].tolist())
            names = {"rasterize_fwd": "rasterize_fwd_kernel",
                     "rasterize_bwd": "rasterize_bwd_kernel",
                     "fused_ssim_value_and_grad": "ssim_fused_kernel"}
            nodes = scan.graph_kernels(sorted(names.values()))
            assert {names[fn.__name__]: k
                    for fn, k in scan.launches_per_step.items()} == {
                        k: nodes[k] for k in names.values()}
        else:
            losses.append([float(tstep.train_step(cfg, ocfg, st, c, i)["loss"])
                           for c, i in zip(cams, images)])
        launches.append([fn.launches for fn in counters])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    assert launches[0] == launches[1] == [len(cams)] * 3


@pytest.mark.cuda
def test_no_host_sync_in_a_step():
    """The scan's warm-up step runs under set_sync_debug_mode("error")
    (and raises on a sync); an eager train_step does too."""
    cuda_or_skip()
    cfg, cams, images = card_chunk(2)
    ocfg = toptim.OptimConfig(**OPTIM)
    st = port_state(cfg, "cuda")
    tstep.make_train_scan(cfg, ocfg, st, H, W)(cams, images)
    assert torch.cuda.get_sync_debug_mode() == 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        tstep.train_step(cfg, ocfg, st, cams[0], images[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
