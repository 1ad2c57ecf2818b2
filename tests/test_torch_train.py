"""The training side of the model and the optimizer: gstex_torch
``loss_fn``, ``resample_charts``, ``rechart``, the LR schedules, one Adam
update and one whole ``train_step`` against gstex_tpu on the same numpy
inputs (the JAX renderer in ``pallas_interpret`` mode, its fused SSIM in
interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gstex_torch.data.synthetic import orbit_c2w, random_scene
from gstex_torch.models import gstex as tmodel
from gstex_torch.models.convert import params_from_jax
from gstex_torch.ops import camera as tcam
from gstex_torch.train import optim as toptim
from gstex_torch.train import step as tstep
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.ops import camera as jcam
from gstex_tpu.train import optim as joptim
from gstex_tpu.train import step as jstep

H, W = 64, 96
LEAVES = tmodel.GStexParams._fields


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def loss_inputs(seed=0, shape=(H, W)):
    rng = np.random.default_rng(seed)
    h, w = shape
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    n = rng.standard_normal((h, w, 3)).astype(np.float32)
    return {"rgb": f(h, w, 3), "alpha": f(h, w),
            "normal": n / np.linalg.norm(n, axis=-1, keepdims=True),
            "reg": 0.1 * f(h, w)}, f(h, w, 3)


@pytest.mark.parametrize("lean,shape", [(True, (H, W)), (False, (H, W)),
                                        (True, (41, 64))],
                         ids=["lean", "full", "unfused_shape"])
def test_loss_fn_matches_jax(lean, shape):
    outs, gt = loss_inputs(shape=shape)
    kw = {} if lean else dict(lambda_normal=0.05, lambda_reg=[0.1, 0.2, 500])
    step = 600
    jcfg = jmodel.GStexConfig(**kw)
    tcfg = tmodel.GStexConfig(**kw)
    assert tmodel.lean_losses(tcfg) == jmodel.lean_losses(jcfg) == lean

    def jloss(o):
        total, parts = jmodel.loss_fn(jcfg, o, jnp.asarray(gt), step)
        return total, parts

    (jtotal, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    touts = {k: torch.tensor(v, requires_grad=True) for k, v in outs.items()}
    ttotal, tparts = tmodel.loss_fn(tcfg, touts, torch.tensor(gt), step)
    ttotal.backward()
    assert abs(float(ttotal.detach()) - float(jtotal)) <= 1e-6
    for k in jparts:
        assert abs(float(tparts[k]) - float(jparts[k])) <= 1e-6, k
    for k in ("rgb",) if lean else outs:
        np.testing.assert_allclose(touts[k].grad.numpy(),
                                   np.asarray(jgrads[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)


def test_schedule_value_matches_jax():
    for v in (0.0, 0.3, [0.1, 0.2, 500]):
        for step in (0, 499, 500, 900):
            assert tmodel.schedule_value(v, step) == pytest.approx(
                float(jmodel.schedule_value(v, step)), rel=1e-7)


def test_resample_charts_matches_jax():
    rng = np.random.default_rng(1)
    n, pad = 40, (8, 8)
    tex = rng.standard_normal((n, *pad, 3)).astype(np.float32)
    old_hw = rng.integers(1, 9, (n, 2)).astype(np.int32)
    new_hw = rng.integers(1, 9, (n, 2)).astype(np.int32)
    want = np.asarray(jmodel.resample_charts(jnp.asarray(tex),
                                             jnp.asarray(old_hw),
                                             jnp.asarray(new_hw)))
    got = tmodel.resample_charts(torch.tensor(tex), torch.tensor(old_hw),
                                 torch.tensor(new_hw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def scene_state(n=64, pad=(8, 8), seed=2):
    s = {k: v.numpy() for k, v in
         random_scene(n, chart_pad=pad, seed=seed, device="cpu").items()}
    jp = jmodel.GStexParams(*(jnp.asarray(s[k]) for k in LEAVES))
    jb = jmodel.GStexBuffers(
        texture_hw=jnp.asarray(s["texture_hw"]),
        mappings=jnp.asarray(s["mappings"]), pixel_scale=jnp.float32(0.01),
        test_colors=jnp.full((n, 3), 0.5, jnp.float32))
    return jp, jb


def test_rechart_matches_jax():
    jp, jb = scene_state()
    cfg_kw = dict(chart_pad=(8, 8), pixel_num=3000)
    jp2, jb2 = jmodel.rechart(jmodel.GStexConfig(**cfg_kw), jp, jb)
    tp, tb = params_from_jax(to_np(jp), to_np(jb), device="cpu")
    tp2, tb2 = tmodel.rechart(tmodel.GStexConfig(**cfg_kw), tp, tb)
    np.testing.assert_array_equal(tb2.texture_hw.numpy(),
                                  np.asarray(jb2.texture_hw))
    np.testing.assert_allclose(tb2.mappings.numpy(),
                               np.asarray(jb2.mappings), rtol=1e-6)
    np.testing.assert_allclose(float(tb2.pixel_scale),
                               float(jb2.pixel_scale), rtol=1e-6)
    np.testing.assert_allclose(tp2.texture.numpy(), np.asarray(jp2.texture),
                               atol=1e-6)
    assert tmodel.texel_count(tb2) == int(jmodel.texel_count(jb2))
    for step in (0, 249, 250, 1000):
        cfg = tmodel.GStexConfig(num_downscales=2)
        assert tmodel.downscale_factor(cfg, step) == jmodel.downscale_factor(
            jmodel.GStexConfig(num_downscales=2), step)


@pytest.mark.parametrize("warmup", [0, 100])
def test_lr_schedules_match_jax(warmup):
    args = (8e-5, 8e-6, 15000, warmup)
    for ramp in ("cosine", "linear"):
        tf = toptim.exp_decay_schedule(*args, ramp=ramp)
        jf = joptim.exp_decay_schedule(*args, ramp=ramp)
        for step in (0, 1, 50, 100, 7500, 15000, 20000):
            assert tf(step) == pytest.approx(float(jf(jnp.int32(step))),
                                             rel=2e-6), (ramp, step)


def test_adam_matches_optax():
    """Three updates of fixed random gradients, a texture-moment reset
    between the second and the third: the port's grouped Adam against
    optax.multi_transform, as update / lr per group, at atol 1e-4: optax
    forms Adam's bias corrections 1 − β^t in float32 (1 − 0.999² keeps
    about 4 digits), torch in double. The params start at zero, so the
    float32 differences are the updates themselves."""
    jp, _ = scene_state(n=16)
    jp = jmodel.GStexParams(*(jnp.zeros_like(x) for x in jp))
    ocfg = toptim.OptimConfig(max_steps=100)
    rng = np.random.default_rng(3)
    grads = [jmodel.GStexParams(*(rng.standard_normal(np.shape(x))
                                  .astype(np.float32) for x in jp))
             for _ in range(3)]
    tx = joptim.make_optimizer(joptim.OptimConfig(max_steps=100))
    jstate = tx.init(jp)
    jparams = jp
    tparams = tmodel.GStexParams(*(torch.tensor(np.asarray(x),
                                                requires_grad=True)
                                   for x in jp))
    opt = toptim.make_optimizer(ocfg, tparams)
    lrs = toptim.group_lrs(ocfg)
    for i, g in enumerate(grads):
        if i == 2:
            jstate = joptim.reset_texture_moments(jstate)
            toptim.reset_texture_moments(opt)
        upd, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        before = [p.detach().clone() for p in tparams]
        for p, gi in zip(tparams, g):
            p.grad = torch.tensor(np.asarray(gi))
        opt.step()
        for leaf, group in zip(LEAVES, toptim.GROUP_OF_LEAF):
            lr = lrs[group](i) if callable(lrs[group]) else lrs[group]
            k = LEAVES.index(leaf)
            got = (tparams[k].detach() - before[k]).numpy() / lr
            want = np.asarray(upd[k]) / lr
            np.testing.assert_allclose(got, want, atol=1e-4,
                                       err_msg=f"{leaf} update {i}")
    # an accumulating group holds its whole state from the start
    acc = toptim.make_optimizer(
        toptim.OptimConfig(gradient_accumulation=(("texture_dc", 4),)),
        tparams)
    st = acc.state[tparams.texture]
    assert (st["mini_step"], st["gradient_step"], int(st["step"])) == (0, 0,
                                                                       0)
    assert not st["acc"].any() and acc.every == {"texture_dc": 4}


def test_train_step_matches_jax():
    """One step from the same params, camera and ground truth: the loss
    within 1e-5 relative, and each leaf's update over its group's lr at
    atol 1e-3. With eps = 1e-15, Adam's first update is the sign of the
    gradient, so elements whose gradient is below 1e-6 of their leaf's
    largest may flip; at most 1e-3 of a leaf's elements may."""
    jp, jb = scene_state(n=64, pad=(4, 4))
    cfg_kw = dict(chart_pad=(4, 4), pair_cap=8192, s_max=64,
                  background_color="white", sh_degree_interval=1000)
    jcfg = jmodel.GStexConfig(renderer="pallas_interpret", **cfg_kw)
    tcfg = tmodel.GStexConfig(renderer="pallas", **cfg_kw)
    ocfg = dict(max_steps=15000)
    c2w = orbit_c2w(3.0, 0.3)
    f = 1.2 * max(H, W)
    rng = np.random.default_rng(5)
    image = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)

    jp_np = to_np(jp)    # the JAX step donates (deletes) its state
    tp, tb = params_from_jax(jp_np, to_np(jb), device="cpu")
    jstate, tx = jstep.init_state(jcfg, joptim.OptimConfig(**ocfg), jp, jb,
                                  jax.random.key(0))
    jstate = jstate._replace(step=jnp.int32(1000))   # SH degree 1 active
    jcam_ = jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w)
    jnew, jm = jstep.make_train_step(jcfg, tx)(jstate, jcam_,
                                               jnp.asarray(image))

    tstate = tstep.init_state(tcfg, toptim.OptimConfig(**ocfg), tp, tb)
    tstate.step = 1000
    tcam_ = tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu")
    tm = tstep.train_step(tcfg, toptim.OptimConfig(**ocfg), tstate, tcam_,
                          torch.tensor(image))

    assert tstate.step == 1001
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert tm["overflow"] == int(jm["overflow"]) == 0
    lrs = toptim.group_lrs(toptim.OptimConfig(**ocfg))
    for k, leaf in enumerate(LEAVES):
        lr = lrs[toptim.GROUP_OF_LEAF[k]]
        lr = lr(0) if callable(lr) else lr
        got = (tstate.params[k].detach().numpy() - jp_np[k]) / lr
        want = (np.asarray(jnew.params[k]) - jp_np[k]) / lr
        g = tstate.params[k].grad
        grad = (np.zeros(want.shape, np.float32) if g is None
                else g.abs().numpy())
        bad = np.abs(got - want) > 1e-3
        tiny = grad <= 1e-6 * grad.max()
        assert not (bad & ~tiny).any(), leaf
        assert bad.sum() <= 1e-3 * bad.size, leaf
    assert np.abs((tstate.params.features_rest.detach().numpy()
                   - jp_np.features_rest)).max() > 0
