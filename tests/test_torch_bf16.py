"""The bf16 chart stream (``GStexConfig.texel_dtype="bf16"``): gstex_torch
``render`` against gstex_tpu ``render(renderer="pallas_interpret",
texel_dtype="bf16")`` on the same numpy scene, eval and training render at
pads (4, 4) and (8, 8): maps at both pads, leaf gradients at (4, 4) (at
(8, 8) the training maps are held to JAX's eval maps, which the same
blend computes, so that JAX's interpret gradient runs once); the chart
gradient kept
float32; one ``train_step`` against JAX's; a ``make_train_scan`` chunk
against single steps; the dense tier left float32, as in JAX.

On the CPU the flat kernels' wrappers run their plain versions, which read
the bf16 charts widened to float32 as the kernels do. Maps are held to
atol 5e-5, the tolerance of ``test_torch_render.py``; gradients to atol
3e-4 of the reference's max abs, the JAX package's own
(``test_torch_rasterize_train.py``); the step as ``test_torch_train.py``
holds one. The JAX interpret runs are the slow part: each runs once, in
one module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import orbit_c2w, surface_scene
from gstex_torch.models import gstex as tmodel
from gstex_torch.models.convert import params_from_jax
from gstex_torch.ops import camera as tcam
from gstex_torch.train import optim as toptim
from gstex_torch.train import step as tstep
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.ops import camera as jcam
from gstex_tpu.train import optim as joptim
from gstex_tpu.train import step as jstep

H, W = 32, 64
N = 150
STEP = 3000
BG = np.array([0.1, 0.3, 0.6], np.float32)
PADS = [(4, 4), (8, 8)]
LEAVES = tmodel.GStexParams._fields
EVAL_MAPS = ("rgb", "img", "texture_rgb", "depth", "alpha")
TRAIN_MAPS = EVAL_MAPS + ("normal", "reg")
# the geometry leaves and the texture: the leaves the blend reaches at the
# SH degree of STEP
GRAD_LEAVES = ("means", "log_scales", "quats", "opacity_logits",
               "features_dc", "features_rest", "texture")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module, its cached references included:
    the tier runs six test workers on the host's cores, and more threads
    each would only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_np(pad, seed=0, n=N):
    return {k: v.numpy() for k, v in
            surface_scene(n, chart_pad=pad, seed=seed, device="cpu").items()}


def jax_state(s):
    n = s["means"].shape[0]
    params = jmodel.GStexParams(*(jnp.asarray(s[k]) for k in LEAVES))
    buffers = jmodel.GStexBuffers(
        texture_hw=jnp.asarray(s["texture_hw"]),
        mappings=jnp.asarray(s["mappings"]), pixel_scale=jnp.float32(0.01),
        test_colors=jnp.full((n, 3), 0.5, jnp.float32))
    return params, buffers


def port_state(s, requires_grad=False):
    jp, jb = jax_state(s)
    tp, tb = params_from_jax(jax.tree.map(np.asarray, jp),
                             jax.tree.map(np.asarray, jb), device="cpu")
    if requires_grad:
        tp = tmodel.GStexParams(*(p.requires_grad_() for p in tp))
    return tp, tb


def cameras(azimuth=0.3):
    c2w = orbit_c2w(3.0, azimuth)
    f = 1.2 * max(H, W)
    return (jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w),
            tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu"))


def cfg_kw(pad, **kw):
    return dict(chart_pad=pad, pair_cap=8192, s_max=256, **kw)


def cotangents(seed=9):
    """A seeded weight for every element of every training map."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"rgb": f(H, W, 3), "img": f(H, W, 3), "texture_rgb": f(H, W, 3),
            "depth": 0.1 * f(H, W), "alpha": f(H, W),
            "normal": 0.1 * f(H, W, 3), "reg": 0.1 * f(H, W)}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's bf16 eval maps per pad; at the first pad also its training
    maps and the leaf gradients of the weighted sum of the training maps
    (None at the others)."""
    jc, _ = cameras()
    cot = cotangents()
    runs = {}
    for pad in PADS:
        jp, jb = jax_state(scene_np(pad))
        jcfg = jmodel.GStexConfig(renderer="pallas_interpret",
                                  texel_dtype="bf16", **cfg_kw(pad))
        # jitted: one compile runs the interpret kernels in half the time
        # of their op-by-op dispatch
        ev = jax.jit(lambda p: jmodel.render(jcfg, p, jb, jc, STEP,
                                             jnp.asarray(BG),
                                             eval_only=True))(jp)
        runs[pad] = ({k: np.asarray(ev[k]) for k in EVAL_MAPS}, None, None)
        if pad != PADS[0]:
            continue

        def loss(p):
            out = jmodel.render(jcfg, p, jb, jc, STEP, jnp.asarray(BG))
            return sum(jnp.sum(out[k] * cot[k]) for k in cot), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        runs[pad] = (runs[pad][0],
                     {k: np.asarray(out[k]) for k in TRAIN_MAPS},
                     {k: np.asarray(getattr(grads, k)) for k in LEAVES})
    return runs


def port_train(pad, texel_dtype, cot, renderer="pallas", n=N):
    """The port's training maps and leaf gradients of sum(maps · cot)."""
    _, tc = cameras()
    tp, tb = port_state(scene_np(pad, n=n), requires_grad=True)
    cfg = tmodel.GStexConfig(renderer=renderer, texel_dtype=texel_dtype,
                             **cfg_kw(pad))
    out = tmodel.render(cfg, tp, tb, tc, STEP, torch.tensor(BG))
    sum(torch.sum(out[k] * torch.tensor(v)) for k, v in cot.items()
        ).backward()
    return ({k: out[k].detach().numpy() for k in TRAIN_MAPS},
            {k: (getattr(tp, k).grad if getattr(tp, k).grad is not None
                 else torch.zeros_like(getattr(tp, k))) for k in LEAVES})


@pytest.mark.parametrize("pad", PADS, ids=["4x4", "8x8"])
def test_eval_render_matches_jax(jax_runs, pad):
    want = jax_runs[pad][0]
    _, tc = cameras()
    tp, tb = port_state(scene_np(pad))
    out = {}
    for dtype in ("bf16", "f32"):
        cfg = tmodel.GStexConfig(renderer="pallas", texel_dtype=dtype,
                                 **cfg_kw(pad))
        with torch.no_grad():
            out[dtype] = tmodel.render(cfg, tp, tb, tc, STEP,
                                       torch.tensor(BG), eval_only=True)
    for k in EVAL_MAPS:
        np.testing.assert_allclose(out["bf16"][k].numpy(), want[k],
                                   atol=5e-5, err_msg=k)
    assert float(out["bf16"]["alpha"].max()) > 0.3
    # the charts were streamed in bf16: the albedo's rounding shows
    assert float((out["bf16"]["rgb"] - out["f32"]["rgb"]).abs().max()) > 1e-4


@pytest.mark.parametrize("pad", PADS, ids=["4x4", "8x8"])
def test_training_render_and_gradients_match_jax(jax_runs, pad):
    """The training render's maps against JAX's (its eval maps at the
    pads where only those were run); the leaf gradients float32, finite,
    and against JAX's where JAX's were taken."""
    want_eval, want_maps, want_grads = jax_runs[pad]
    got_maps, got_grads = port_train(pad, "bf16", cotangents())
    for k in TRAIN_MAPS if want_maps else EVAL_MAPS:
        np.testing.assert_allclose(got_maps[k], (want_maps or want_eval)[k],
                                   atol=5e-5, err_msg=k)
    for k in GRAD_LEAVES:
        got = got_grads[k]
        assert got.dtype == torch.float32, k
        assert bool(torch.isfinite(got).all()), k
        if want_grads is None:
            continue
        scale = np.abs(want_grads[k]).max() + 1e-8
        np.testing.assert_allclose(got.numpy() / scale,
                                   want_grads[k] / scale, atol=3e-4,
                                   err_msg=f"grad {k}")
    assert float(got_grads["texture"].abs().max()) > 0


def test_chart_gradient_stays_float32():
    """Under a cotangent on the maps linear in the albedo (no ``rgb``,
    whose clip would see the rounding), the texel gradient does not
    depend on the texels: the bf16 render's texture gradient is
    bit-equal to the float32 render's. It would not be if the albedo were
    cast to bf16 before ``_Rasterize5.apply``: autograd then rounds the
    gradient it returns to bf16."""
    cot = {k: v for k, v in cotangents(seed=4).items()
           if k in ("img", "texture_rgb", "depth", "alpha")}
    maps_b, grads_b = port_train((4, 4), "bf16", cot, n=60)
    maps_f, grads_f = port_train((4, 4), "f32", cot, n=60)
    assert grads_b["texture"].dtype == torch.float32
    assert float(grads_b["texture"].abs().max()) > 0
    assert torch.equal(grads_b["texture"], grads_f["texture"])
    # the cast took place: the texture map moved by the bf16 rounding
    assert np.abs(maps_b["texture_rgb"] - maps_f["texture_rgb"]).max() > 1e-4


def test_dense_and_pair_tiers_stay_float32():
    """As in JAX, only the flat tier streams bf16: a ``pallas4`` (dense)
    and a ``pallas3`` (pair-space) render under ``texel_dtype="bf16"``
    are bit-equal to their float32 renders."""
    _, tc = cameras()
    tp, tb = port_state(scene_np((4, 4)))
    for renderer in ("pallas4", "pallas3"):
        outs = []
        for dtype in ("bf16", "f32"):
            cfg = tmodel.GStexConfig(renderer=renderer, texel_dtype=dtype,
                                     **cfg_kw((4, 4)))
            with torch.no_grad():
                outs.append(tmodel.render(cfg, tp, tb, tc, STEP,
                                          torch.tensor(BG))["rgb"])
        assert torch.equal(*outs), renderer


def test_train_step_matches_jax():
    """One bf16 step from the same params, camera and ground truth, held
    as ``test_torch_train.py::test_train_step_matches_jax`` holds the
    float32 one: the loss within 1e-5 relative, each leaf's update over
    its group's lr at atol 1e-3, where at most 1e-3 of a leaf's elements,
    those of gradient below 1e-6 of the leaf's largest, may flip. Both
    packages take their plain SSIM here (``fused_ssim=False``): the fused
    kernel, which the bf16 stream does not reach, is held in that test,
    and its interpret mode would double this one's time."""
    s = scene_np((4, 4))
    kw = cfg_kw((4, 4), background_color="white", sh_degree_interval=1000,
                texel_dtype="bf16", fused_ssim=False)
    jcfg = jmodel.GStexConfig(renderer="pallas_interpret", **kw)
    tcfg = tmodel.GStexConfig(renderer="pallas", **kw)
    ocfg = dict(max_steps=15000)
    jc, tc = cameras()
    rng = np.random.default_rng(5)
    image = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)

    jp, jb = jax_state(s)
    jp_np = jax.tree.map(np.asarray, jp)  # the JAX step donates its state
    tp, tb = port_state(s)
    jstate, tx = jstep.init_state(jcfg, joptim.OptimConfig(**ocfg), jp, jb,
                                  jax.random.key(0))
    jstate = jstate._replace(step=jnp.int32(1000))
    jnew, jm = jstep.make_train_step(jcfg, tx)(jstate, jc,
                                               jnp.asarray(image))
    tstate = tstep.init_state(tcfg, toptim.OptimConfig(**ocfg), tp, tb)
    tstate.step = 1000
    tm = tstep.train_step(tcfg, toptim.OptimConfig(**ocfg), tstate, tc,
                          torch.tensor(image))

    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert tm["overflow"] == int(jm["overflow"]) == 0
    lrs = toptim.group_lrs(toptim.OptimConfig(**ocfg))
    for k, leaf in enumerate(LEAVES):
        assert tstate.params[k].dtype == torch.float32, leaf
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
    for st in tstate.optimizer.state.values():
        assert all(v.dtype == torch.float32 for v in st.values()
                   if torch.is_tensor(v) and v.is_floating_point())


def test_scan_chunk_equals_single_steps():
    """A ``make_train_scan`` chunk of 2 views at bf16 on the flat tier is
    bit-equal to 2 ``train_step`` calls (metrics and params), as
    ``test_torch_scan.py`` holds the float32 chunk; its first loss
    differs from a float32 step's, so the cast ran inside it."""
    s = scene_np((4, 4), n=60)
    c2ws = [orbit_c2w(3.0, 0.3 + 0.2 * i) for i in range(2)]
    f = 1.2 * max(H, W)
    cams = [tcam.make_camera(f, f, W / 2, H / 2, H, W, c, device="cpu")
            for c in c2ws]
    rng = np.random.default_rng(5)
    images = [torch.as_tensor(rng.uniform(0, 1, (H, W, 4))
                              .astype(np.float32)) for _ in c2ws]
    ocfg = toptim.OptimConfig(max_steps=50)
    cfg = tmodel.GStexConfig(renderer="pallas", background_color="white",
                             texel_dtype="bf16", **cfg_kw((4, 4)))

    def state(c):
        st = tstep.init_state(c, ocfg, *port_state(s), seed=3)
        st.step = 1
        return st

    cfg32 = dataclasses.replace(cfg, texel_dtype="f32")
    chunk, single, f32 = state(cfg), state(cfg), state(cfg32)
    got = tstep.make_train_scan(cfg, ocfg, chunk, H, W)(cams, images)
    want = [tstep.train_step(cfg, ocfg, single, c, i)
            for c, i in zip(cams, images)]
    loss32 = tstep.train_step(cfg32, ocfg, f32, cams[0], images[0])["loss"]
    for k, v in got.items():
        assert torch.equal(v, torch.stack([torch.as_tensor(m[k]).to(v.dtype)
                                           for m in want])), k
    for name, a, b in zip(LEAVES, chunk.params, single.params):
        assert torch.equal(a, b), name
    assert float(got["loss"][0]) != float(loss32)
