"""Camera pose optimization, held against the JAX package on the CPU.

- ``ops/pose_opt.py``: both exp maps (θ at 0, near it, either side of
  the SE3 Taylor guard at 1e-2, far from it; batched), ``apply_correction``,
  ``regularizer`` and ``metrics``, and their gradients at δ = 0, against
  ``gstex_tpu/ops/pose_opt.py`` to 1e-6 absolute;
- ``train/optim.py``'s ``optax.MultiSteps`` accumulation: the pose
  optimizer against ``optax.MultiSteps(optax.adam(schedule))`` over 250
  seeded gradients at k = 100 and k = 4, the deltas and every state leaf
  to 1e-6 relative; a model group accumulating 4 steps against JAX's
  trainer for 8 steps, and that run's JAX checkpoint read and trained on;
- the camopt step: the port's trainer on ``renderer="pallas"`` (the
  kernels' plain versions) against JAX's on ``pallas_interpret`` at
  48x64 for 3 steps (each loss to 1e-5 relative, the pose accumulator to
  ``ACC_TOL`` of its max, the params as ``assert_params_agree`` holds
  them, JAX's ``events.jsonl`` keys);
- the pose gradient tier by tier: the port's ``xla`` tier equal to its
  ``pallas`` tier and to JAX's ``pallas_interpret``, which carry the
  camera origin's gradient through the records; JAX's ``xla`` tier,
  which drops it, departs in c2w's translation column only (pinned);
- the pose sidecars: a port run resumed bit for bit, JAX's ``load_aux``
  reading the port's sidecar, the port resuming a JAX camopt run
  (``.ckpt.npz`` and ``pose-*.npz``) in agreement with it;
- ``gstex-torch-train --set trainer.camera_opt=SE3`` end to end."""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gstex_torch.data.manager import FullImageCache as TCache
from gstex_torch.data.synthetic import orbit_c2w
from gstex_torch.data.synthetic import orbit_camera as torbit
from gstex_torch.models import gstex as tmodel
from gstex_torch.ops import camera as tcam
from gstex_torch.ops import pose_opt as tpose
from gstex_torch.scripts import parity as tparity
from gstex_torch.train import optim as toptim
from gstex_torch.train.trainer import Trainer as TTrainer
from gstex_torch.train.trainer import TrainerConfig as TTrainerConfig
from gstex_torch.utils import checkpoint as tckpt
from gstex_tpu.data.manager import FullImageCache as JCache
from gstex_tpu.data.synthetic import orbit_camera as jorbit
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.ops import camera as jcam
from gstex_tpu.ops import pose_opt as jpose
from gstex_tpu.train import optim as joptim
from gstex_tpu.train import step as jstep
from gstex_tpu.train.trainer import Trainer as JTrainer
from gstex_tpu.train.trainer import TrainerConfig as JTrainerConfig
from gstex_tpu.utils import checkpoint as jckpt
from test_torch_resume import CFG as RESUME_CFG
from test_torch_resume import STEPS as RESUME_STEPS
from test_torch_resume import (assert_params_agree, one_thread,
                               port_trainer, scene)

__all__ = ["one_thread", "scene"]   # fixtures reused

# the trainers' views; at 32x64 the texture group's third Adam update
# differs by more than assert_params_agree's 3e-3 of an lr on 9 of its
# 7200 elements, above its budget of 1e-3 of them, where the steps'
# gradients (within 1e-5 of their max) cancel in m / sqrt(v); at 48x64
# on 2
H, W, VIEWS, STEPS = 48, 64, 3, 3
# the pose gradient's tiers, at the size where they were found to part
GH, GW = 32, 64
CFG = dict(chart_pad=(4, 4), pixel_num=2e3, pair_cap=1 << 14, s_max=256,
           background_color="black")
# the pose accumulator (the mean of the steps' pose gradients): the
# packages' gradients differ by float32 rounding in the backward's sums
ACC_TOL = 1e-4
EXP_TOL = 1e-6


def tangents():
    """(name, (n, 6) float32): ω at 0, 1e-6, just either side of the SE3
    guard (|ω| = 1e-2), and far from it; translations drawn."""
    rng = np.random.default_rng(0)
    out = {}
    for name, norm in (("zero", 0.0), ("tiny", 1e-6), ("below_guard", 0.0099),
                       ("above_guard", 0.0101), ("far", 1.3)):
        w = rng.standard_normal((4, 3))
        w = norm * w / np.linalg.norm(w, axis=-1, keepdims=True)
        t = rng.standard_normal((4, 3)) * 0.1
        out[name] = np.concatenate([t, w], -1).astype(np.float32)
    return out


def jax_fn(mode):
    return {"SO3xR3": jpose.exp_map_SO3xR3, "SE3": jpose.exp_map_SE3}[mode]


@pytest.mark.parametrize("mode", ["SO3xR3", "SE3"])
def test_exp_maps_and_their_gradients_match_jax(mode):
    rng = np.random.default_rng(1)
    wgt = rng.standard_normal((4, 3, 4)).astype(np.float32)
    for name, x in tangents().items():
        got = tpose.exp_map(mode, torch.tensor(x)).numpy()
        want = np.asarray(jpose.exp_map(mode, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=EXP_TOL,
                                   err_msg=name)
    # batched over two leading axes
    x = rng.standard_normal((2, 3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tpose.exp_map(mode, torch.tensor(x)).numpy(),
        np.asarray(jax_fn(mode)(jnp.asarray(x))), rtol=0, atol=EXP_TOL)
    # the gradient at delta = 0, where every delta starts, through the
    # correction of a camera, and of the regularizer
    c2w = orbit_c2w(3.5, 0.7).astype(np.float32)
    d = torch.zeros((4, 6), requires_grad=True)
    adj = tpose.exp_map(mode, d)
    out = torch.stack([tpose.apply_correction(torch.tensor(c2w), a)
                       for a in adj])
    ((out * torch.tensor(wgt)).sum() + tpose.regularizer(d)).backward()

    def jloss(dj):
        a = jpose.exp_map(mode, dj)
        o = jnp.stack([jpose.apply_correction(jnp.asarray(c2w), a[i])
                       for i in range(4)])
        return (o * wgt).sum() + jpose.regularizer(dj)

    want = np.asarray(jax.grad(jloss)(jnp.zeros((4, 6), jnp.float32)))
    assert np.isfinite(d.grad.numpy()).all()
    np.testing.assert_allclose(d.grad.numpy(), want, rtol=0, atol=EXP_TOL)
    with pytest.raises(ValueError, match="SO3xR3"):
        tpose.exp_map("SO3", d)


def test_correction_regularizer_and_metrics_match_jax():
    rng = np.random.default_rng(2)
    delta = (0.05 * rng.standard_normal((5, 6))).astype(np.float32)
    c2w = orbit_c2w(3.0, 1.1).astype(np.float32)
    for i in range(5):
        adj = jpose.exp_map_SE3(jnp.asarray(delta[i]))
        np.testing.assert_allclose(
            tpose.apply_correction(torch.tensor(c2w),
                                   torch.tensor(np.asarray(adj))).numpy(),
            np.asarray(jpose.apply_correction(jnp.asarray(c2w), adj)),
            rtol=0, atol=EXP_TOL)
    td = torch.tensor(delta, requires_grad=True)
    reg = tpose.regularizer(td)
    reg.backward()
    jreg, jgrad = jax.value_and_grad(jpose.regularizer)(jnp.asarray(delta))
    assert abs(float(reg.detach()) - float(jreg)) <= EXP_TOL
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=EXP_TOL)
    got, want = tpose.metrics(td), jpose.metrics(jnp.asarray(delta))
    assert list(got) == list(want)
    for k in got:
        assert abs(float(got[k]) - float(want[k])) <= EXP_TOL, k
    assert tpose.MODES == jpose.MODES
    assert (tpose.TRANS_L2_PENALTY, tpose.ROT_L2_PENALTY) == (
        jpose.TRANS_L2_PENALTY, jpose.ROT_L2_PENALTY)


def jax_pose_leaves(delta, state):
    return [np.asarray(x) for x in
            jax.tree.leaves(jstep.PoseState(delta, state))]


def assert_leaves_agree(got, want, rel, what):
    """Each leaf within ``rel`` of its largest magnitude (an element that
    sums updates of both signs keeps the updates' absolute rounding, not
    its own relative one); the ints equal."""
    assert len(got) == len(want) == len(tckpt.POSE_LEAVES), what
    for name, a, b in zip(tckpt.POSE_LEAVES, got, want):
        assert np.shape(a) == np.shape(b), (what, name)
        np.testing.assert_allclose(a, b, rtol=rel,
                                   atol=rel * float(np.abs(b).max()),
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("k", [100, 4])
def test_multisteps_adam_matches_optax(k):
    """250 seeded gradients: at k = 100 two emitted updates (steps 99 and
    199), at k = 4 sixty-two; the deltas and every state leaf after each
    emitted update and at the end, to 1e-6 relative (the deltas zero
    until the first)."""
    rng = np.random.default_rng(k)
    grads = (rng.standard_normal((250, 3, 6)) * 10.0 ** rng.uniform(
        -4, -1, (250, 1, 6))).astype(np.float32)
    delta = torch.zeros((3, 6), requires_grad=True)
    if k == 100:
        opt = toptim.make_pose_optimizer(delta)
        tx = joptim.make_pose_optimizer()
    else:
        sched = toptim.exp_decay_schedule(1e-3, 5e-5, 30000)
        opt = toptim.Adam([("camera_opt", [delta])], {"camera_opt": sched},
                          every={"camera_opt": k}, eps=1e-15)
        tx = optax.MultiSteps(optax.adam(
            joptim.exp_decay_schedule(1e-3, 5e-5, 30000), b1=0.9, b2=0.999,
            eps=1e-15), every_k_schedule=k)
    pose = SimpleNamespace(delta=delta, optimizer=opt)
    jd = jnp.zeros((3, 6), jnp.float32)
    js = tx.init(jd)
    update = jax.jit(tx.update)
    assert_leaves_agree(tckpt.pose_leaves(pose), jax_pose_leaves(jd, js), 0,
                        "init")
    for i, g in enumerate(grads):
        delta.grad = torch.tensor(g)
        opt.step()
        upd, js = update(jnp.asarray(g), js, jd)
        jd = optax.apply_updates(jd, upd)
        if i % k == k - 1 or i == len(grads) - 1:
            assert_leaves_agree(tckpt.pose_leaves(pose),
                                jax_pose_leaves(jd, js), 1e-6, f"step {i}")
        if i < k - 1:
            assert not delta.detach().any(), i
    assert opt.state[delta]["gradient_step"] == 250 // k


@pytest.fixture(scope="module")
def camopt_scene():
    """Views of a surfel sphere (8-bit, 48x64) and a perturbed,
    untextured init, as numpy."""
    cfg = tmodel.GStexConfig(**CFG, renderer="xla")
    s = tparity.surface_scene(150, chart_pad=cfg.chart_pad, seed=1,
                              device="cpu")
    p, b = tmodel.init_params(cfg, s["means"], s["log_scales"], s["quats"],
                              s["opacity_logits"], s["features_dc"],
                              s["features_rest"])
    cams = [torbit(H, W, azimuth=2 * np.pi * i / VIEWS, device="cpu")
            for i in range(VIEWS)]
    views = [(torch.clamp(v, 0, 1) * 255).to(torch.uint8).numpy()
             for v in tparity.render_views(cfg, p, b, cams)]
    p0 = tparity.perturbed_init(p, 150, seed=1)
    to_np = lambda t: type(t)(*(x.numpy() for x in t))
    return views, to_np(p0), to_np(b)


def port_camopt_trainer(camopt_scene, out, steps=STEPS, **tkw):
    views, p0, b = camopt_scene
    cache = TCache(
        cameras=[torbit(H, W, azimuth=2 * np.pi * i / VIEWS, device="cpu")
                 for i in range(VIEWS)],
        images=[torch.as_tensor(v).float() / 255.0 for v in views])
    tcfg = TTrainerConfig(**{
        "max_num_iterations": steps, "steps_per_save": 1,
        "steps_per_eval_image": 0, "save_only_latest_checkpoint": False,
        "log_every": 1, "output_dir": str(out), "camera_opt": "SO3xR3",
        **tkw})
    return TTrainer(tcfg, tmodel.GStexConfig(**CFG, renderer="pallas"),
                    toptim.OptimConfig(max_steps=steps),
                    tmodel.GStexParams(*(torch.as_tensor(x) for x in p0)),
                    tmodel.GStexBuffers(*(torch.as_tensor(x) for x in b)),
                    cache)


@pytest.fixture(scope="module")
def jax_camopt_run(camopt_scene, tmp_path_factory):
    """JAX's trainer with camera_opt=SO3xR3 on ``pallas_interpret`` for
    3 steps, a checkpoint and a pose sidecar after each; returns its
    events rows, its trainer and its run dir."""
    views, p0, b = camopt_scene
    out = tmp_path_factory.mktemp("jax_camopt")
    cache = JCache(cameras=[jorbit(H, W, azimuth=2 * np.pi * i / VIEWS)
                            for i in range(VIEWS)], images=list(views))
    tcfg = JTrainerConfig(max_num_iterations=STEPS, steps_per_save=1,
                          steps_per_eval_image=0, log_every=1,
                          save_only_latest_checkpoint=False, steps_per_sync=1,
                          camera_opt="SO3xR3", output_dir=str(out))
    tr = JTrainer(tcfg, jmodel.GStexConfig(**CFG, renderer="pallas_interpret"),
                  joptim.OptimConfig(max_steps=STEPS),
                  jmodel.GStexParams(*(jnp.asarray(x) for x in p0)),
                  jmodel.GStexBuffers(*(jnp.asarray(x) for x in b)), cache)
    tr.train()
    rows = [json.loads(ln) for ln in
            (out / "events.jsonl").read_text().splitlines()]
    return [r for r in rows if "loss" in r], tr, out


def assert_acc_agrees(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=ACC_TOL * scale)


def test_camopt_steps_match_jax_pallas_interpret(camopt_scene,
                                                 jax_camopt_run, tmp_path):
    rows, jtr, _ = jax_camopt_run
    tr = port_camopt_trainer(camopt_scene, tmp_path)
    hist = tr.train()
    assert [h["step"] for h in hist] == [r["step"] for r in rows]
    for h, r in zip(hist, rows):
        assert h["loss"] == pytest.approx(r["loss"], rel=1e-5), h["step"]
        assert h["camera_opt_regularizer"] == pytest.approx(
            r["camera_opt_regularizer"], rel=1e-6)
        assert h["camera_opt_translation"] == r["camera_opt_translation"] \
            == h["camera_opt_rotation"] == r["camera_opt_rotation"] == 0.0
    port_rows = [json.loads(ln) for ln in
                 (tmp_path / "events.jsonl").read_text().splitlines()]
    assert [set(r) for r in port_rows if "loss" in r] == [set(r)
                                                          for r in rows]
    assert_params_agree(tr.state, jtr.state.params, STEPS)
    got = tckpt.pose_leaves(tr.pose)
    want = jax_pose_leaves(jtr.pose_state.delta, jtr.pose_state.opt_state)
    for name in ("delta", "mini_step", "gradient_step", "count", "mu", "nu",
                 "schedule_count"):
        i = tckpt.POSE_LEAVES.index(name)
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)
    assert int(got[1]) == STEPS
    assert_acc_agrees(got[-1], want[-1])


def c2w_gradient(pkg, renderer, camopt_scene):
    """The gradient of a weighted sum of the render's rgb with respect
    to c2w, at 32x64, from the scene's init."""
    _, p0, b = camopt_scene
    H, W = GH, GW
    wgt = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    c2w = orbit_c2w(3.5, 0.4).astype(np.float32)
    f = 1.2 * W
    if pkg == "torch":
        cfg = tmodel.GStexConfig(**CFG, renderer=renderer)
        cam = tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu")
        c = cam.c2w.clone().requires_grad_(True)
        out = tmodel.render(cfg, tmodel.GStexParams(
            *(torch.as_tensor(x) for x in p0)), tmodel.GStexBuffers(
            *(torch.as_tensor(x) for x in b)),
            dataclasses.replace(cam, c2w=c), 10000, torch.zeros(3))
        (out["rgb"] * torch.as_tensor(wgt)).sum().backward()
        return c.grad.numpy()
    cfg = jmodel.GStexConfig(**CFG, renderer=renderer)
    cam = jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w)
    jp = jmodel.GStexParams(*(jnp.asarray(x) for x in p0))
    jb = jmodel.GStexBuffers(*(jnp.asarray(x) for x in b))

    def loss(c2):
        out = jmodel.render(cfg, jp, jb, dataclasses.replace(cam, c2w=c2),
                            jnp.int32(10000), jnp.zeros(3))
        return (out["rgb"] * wgt).sum()

    return np.asarray(jax.jit(jax.grad(loss))(cam.c2w))


def test_pose_gradient_tiers_and_the_jax_xla_departure(camopt_scene):
    """The port follows JAX's pallas tiers on every tier: the camera
    origin's gradient reaches c2w[:, 3] through the records. JAX's xla
    tier returns zeros for the camera (``_raster_core_bwd``), so its
    translation column departs; its rotation columns agree."""
    t_xla = c2w_gradient("torch", "xla", camopt_scene)
    t_pl = c2w_gradient("torch", "pallas", camopt_scene)
    j_pl = c2w_gradient("jax", "pallas_interpret", camopt_scene)
    j_xla = c2w_gradient("jax", "xla", camopt_scene)
    scale = np.abs(j_pl).max()
    np.testing.assert_allclose(t_xla, t_pl, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(t_pl, j_pl, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(t_xla[:, :3], j_xla[:, :3], rtol=0,
                               atol=1e-5 * scale)
    # the pinned departure: the origin's share of the gradient is what
    # JAX's xla tier lacks, and it is large
    gap = np.abs(t_xla[:, 3] - j_xla[:, 3]).max()
    assert gap > 0.05 * np.abs(t_xla[:, 3]).max(), (t_xla[:, 3],
                                                     j_xla[:, 3])


def test_camopt_run_resumes_bit_for_bit(camopt_scene, tmp_path):
    whole = port_camopt_trainer(camopt_scene, tmp_path / "whole", steps=3)
    hist = whole.train()
    ckdir = tmp_path / "whole" / "checkpoints"
    assert sorted(p.name for p in ckdir.glob("pose-*.npz")) == [
        f"pose-{s:09d}.npz" for s in (2, 3)]
    part = port_camopt_trainer(camopt_scene, tmp_path / "part", steps=3,
                               load_checkpoint=str(
                                   ckdir / "step-000000002.ckpt.pt"))
    saved = tckpt.load_aux(ckdir / "pose-000000002.npz")
    for name, a, b in zip(tckpt.POSE_LEAVES, tckpt.pose_leaves(part.pose),
                          saved):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for _ in range(2):
        part.train_cache.next_train_idx()
    rest = part.train()
    assert [h["loss"] for h in rest] == [h["loss"] for h in hist[2:]]
    for a, b in zip(tckpt.pose_leaves(part.pose),
                    tckpt.pose_leaves(whole.pose)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(part.state.params, whole.state.params):
        assert torch.equal(a, b)
    # JAX reads the port's sidecar into its own PoseState
    pose, _ = jstep.init_pose_state(VIEWS)
    got = jckpt.load_aux(ckdir / "pose-000000003.npz", pose)
    for name, a, b in zip(tckpt.POSE_LEAVES, jax.tree.leaves(got),
                          tckpt.pose_leaves(whole.pose)):
        assert np.asarray(a).dtype == b.dtype, name
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


def test_step_matched_sidecar_and_its_fallback(tmp_path):
    leaves = [np.full(2, i, np.float32) for i in range(3)]
    for step in (4, 8):
        tckpt.save_aux(tmp_path, "pose", leaves, step,
                       keep_only_latest=False)
    ck = tmp_path / "step-000000004.ckpt.pt"
    assert tckpt.aux_for_checkpoint(ck, "pose").name == "pose-000000004.npz"
    assert (tckpt.aux_for_checkpoint(ck, "pose")
            == jckpt.aux_for_checkpoint(ck, "pose"))
    with pytest.warns(UserWarning, match="falling back"):
        got = tckpt.aux_for_checkpoint(tmp_path / "step-000000006.ckpt.pt",
                                       "pose")
    assert got.name == "pose-000000008.npz"
    tckpt.save_aux(tmp_path, "pose", leaves, 9)
    assert [p.name for p in tmp_path.glob("pose-*.npz")] == [
        "pose-000000009.npz"]
    assert tckpt.latest_aux(tmp_path, "pose").name == "pose-000000009.npz"


def test_port_resumes_a_jax_camopt_run(camopt_scene, jax_camopt_run,
                                       tmp_path):
    rows, jtr, out = jax_camopt_run
    ck = out / "checkpoints" / "step-000000002.ckpt.npz"
    tr = port_camopt_trainer(camopt_scene, tmp_path, load_checkpoint=str(ck))
    assert tr.state.step == 2
    want = jckpt.load_aux(out / "checkpoints" / "pose-000000002.npz",
                          jstep.init_pose_state(VIEWS)[0])
    for name, a, b in zip(tckpt.POSE_LEAVES, tckpt.pose_leaves(tr.pose),
                          jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    for _ in range(2):
        tr.train_cache.next_train_idx()
    hist = tr.train()
    assert [h["step"] for h in hist] == [2]
    assert hist[0]["loss"] == pytest.approx(rows[2]["loss"], rel=1e-5)
    assert_params_agree(tr.state, jtr.state.params, 1)
    assert_acc_agrees(tckpt.pose_leaves(tr.pose)[-1],
                      np.asarray(jtr.pose_state.opt_state.acc_grads))


ACCUM = (("texture_dc", 4),)


@pytest.fixture(scope="module")
def jax_accum_run(scene, tmp_path_factory):
    """JAX's trainer (``test_torch_resume.py``'s scene, xla tier) for 8
    steps with the texture group accumulating 4 steps an update."""
    views, p0, b = scene
    out = tmp_path_factory.mktemp("jax_accum")
    cache = JCache(cameras=[jorbit(48, 64, azimuth=2 * np.pi * i / 4)
                            for i in range(4)], images=list(views))
    tcfg = JTrainerConfig(max_num_iterations=RESUME_STEPS, steps_per_save=1,
                          steps_per_eval_image=0, log_every=1,
                          save_only_latest_checkpoint=False, steps_per_sync=1,
                          output_dir=str(out))
    tr = JTrainer(tcfg, jmodel.GStexConfig(**RESUME_CFG),
                  joptim.OptimConfig(max_steps=RESUME_STEPS,
                                     gradient_accumulation=ACCUM),
                  jmodel.GStexParams(*(jnp.asarray(x) for x in p0)),
                  jmodel.GStexBuffers(*(jnp.asarray(x) for x in b)), cache)
    tr.train()
    rows = [json.loads(ln) for ln in
            (out / "events.jsonl").read_text().splitlines()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}, tr, out


def accum_trainer(scene, out, **tkw):
    tr = port_trainer(scene, out, **tkw)
    ocfg = toptim.OptimConfig(max_steps=RESUME_STEPS,
                              gradient_accumulation=ACCUM)
    tr.state.optimizer = toptim.make_optimizer(ocfg, tr.state.params)
    tr.ocfg = ocfg
    return tr


def test_accumulated_texture_group_matches_jax(scene, jax_accum_run,
                                               tmp_path):
    jlosses, jtr, out = jax_accum_run
    tr = accum_trainer(scene, tmp_path)
    before = tr.state.params.texture.detach().clone()
    hist = tr.train()
    for h in hist:
        assert h["loss"] == pytest.approx(jlosses[h["step"]], rel=1e-5)
    assert_params_agree(tr.state, jtr.state.params, RESUME_STEPS)
    st = tr.state.optimizer.state[tr.state.params.texture]
    jst = jtr.state.opt_state.inner_states["texture_dc"].inner_state
    assert (st["mini_step"], st["gradient_step"], int(st["step"])) == (
        int(jst.mini_step), int(jst.gradient_step),
        int(jst.inner_opt_state[0].count)) == (0, 2, 2)
    assert not torch.equal(tr.state.params.texture, before)
    # the leaf order with a MultiSteps group, as JAX flattens it
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jtr.state)[0]]
    assert tckpt.jax_leaf_paths(accumulated=("texture_dc",)) == paths


def test_port_reads_an_accumulated_jax_checkpoint(scene, jax_accum_run,
                                                  tmp_path):
    """Step 6: two steps into the texture group's second accumulation."""
    jlosses, jtr, out = jax_accum_run
    ck = out / "checkpoints" / "step-000000006.ckpt.npz"
    want = jckpt.load_checkpoint(ck, jtr.state)
    tr = accum_trainer(scene, tmp_path)
    tckpt.load_checkpoint(ck, tr.state)
    assert tr.state.step == 6
    ms = want.opt_state.inner_states["texture_dc"].inner_state
    st = tr.state.optimizer.state[tr.state.params.texture]
    assert (st["mini_step"], st["gradient_step"]) == (2, 1) == (
        int(ms.mini_step), int(ms.gradient_step))
    np.testing.assert_array_equal(st["acc"].numpy(),
                                  np.asarray(ms.acc_grads.texture))
    np.testing.assert_array_equal(
        st["exp_avg"].numpy(), np.asarray(ms.inner_opt_state[0].mu.texture))
    assert np.abs(st["acc"].numpy()).max() > 0
    for _ in range(6):
        tr.train_cache.next_train_idx()
    hist = tr.train()
    assert [h["step"] for h in hist] == [6, 7]
    for h in hist:
        assert h["loss"] == pytest.approx(jlosses[h["step"]], rel=1e-5)
    assert_params_agree(tr.state, jtr.state.params, 2)
    # a checkpoint of the port's without accumulation is refused by count
    plain = port_trainer(scene, tmp_path / "plain")
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_checkpoint(ck, plain.state)


def test_mid_cycle_jax_checkpoint_chunks_from_its_mini_step(
        scene, jax_accum_run, tmp_path):
    """JAX's step-6 checkpoint (the texture group's ``mini_step`` 2 of 4)
    read by a port trainer that saves and logs only at the end: steps
    6-7 go through the scan in one chunk, whose Adam table starts from
    the checkpoint's ``mini_step`` and updates the group at step 7, as
    JAX's run did."""
    jlosses, jtr, out = jax_accum_run
    ck = out / "checkpoints" / "step-000000006.ckpt.npz"
    tr = port_trainer(scene, tmp_path, accumulate=ACCUM,
                      load_checkpoint=str(ck), steps_per_save=0, log_every=0)
    assert tr._chunk_size(6) == 2
    before = tr.state.params.texture.detach().clone()
    for _ in range(6):
        tr.train_cache.next_train_idx()
    hist = tr.train()
    assert [h["step"] for h in hist] == [6, 7]
    for h in hist:
        assert h["loss"] == pytest.approx(jlosses[h["step"]], rel=1e-5)
    assert_params_agree(tr.state, jtr.state.params, 2)
    assert not torch.equal(tr.state.params.texture, before)
    st = tr.state.optimizer.state[tr.state.params.texture]
    jst = jtr.state.opt_state.inner_states["texture_dc"].inner_state
    assert (st["mini_step"], st["gradient_step"], int(st["step"])) == (
        int(jst.mini_step), int(jst.gradient_step),
        int(jst.inner_opt_state[0].count)) == (0, 2, 2)


def test_train_cli_camopt(tmp_path):
    """``gstex-torch-train --set trainer.camera_opt=SE3``: the camopt rows
    in ``events.jsonl``, a pose sidecar beside the checkpoint."""
    from gstex_torch.data.synthetic import write_blender_dataset
    from gstex_torch.models.init_io import load_scene_npz
    from gstex_torch.scripts import train as ttrain
    from test_torch_train_cli import small_scene_npz

    stats = small_scene_npz(tmp_path / "scene.npz", n=200)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8))
    params, buffers = load_scene_npz(cfg, stats, seed=0, device="cpu")
    write_blender_dataset(tmp_path / "data", cfg, params, buffers, 2, 24, 32)
    out = tmp_path / "run"
    res = ttrain.main([
        "gstex-blender-nvs", "--data", str(tmp_path / "data"),
        "--scene-npz", str(stats), "--max-num-iterations", "3",
        "--steps-per-eval-image", "0", "--set", "trainer.camera_opt=SE3",
        "--set", "trainer.log_every=1", "--output-dir", str(out),
        "--device", "cpu"])
    assert [h["step"] for h in res["history"]] == [0, 1, 2]
    rows = [json.loads(ln) for ln in
            (out / "events.jsonl").read_text().splitlines()]
    assert all({"camera_opt_regularizer", "camera_opt_translation",
                "camera_opt_rotation"} <= set(r) for r in rows if "loss" in r)
    assert (out / "checkpoints" / "pose-000000003.npz").exists()
    cfg_json = json.loads((out / "config.json").read_text())
    assert cfg_json["trainer"]["camera_opt"] == "SE3"
