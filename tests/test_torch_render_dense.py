"""The whole ``render`` on the tiers beside the flat kernels: gstex_torch
``models.gstex.render`` against gstex_tpu ``render`` on the same numpy
scene with ``renderer="oracle"``, ``"xla"`` (the config default),
``"pallas4"``, the pair-space ``"pallas3"`` and ``"pallas2"`` and
``extra=True``, for eval and training renders; the flat-or-dense
dispatch; cap sizing without the cull; and one ``train_step`` on the
dense tier and one on the v3 tier against JAX ``make_train_step``.

Maps are compared at ``test_torch_render.py``'s atol 5e-5 (the two
packages cull pairs from their own geometry and sum in another order)
with the JAX tier cross-checks' rtol 1e-4 beside it (depth sums reach ~3,
where float32 rounding alone passes 5e-5); a train step's loss at 1e-5
relative as in ``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_render as base
from gstex_torch.data.synthetic import orbit_c2w
from gstex_torch.models import gstex as tmodel
from gstex_torch.models.convert import params_from_jax
from gstex_torch.ops import camera as tcam
from gstex_torch.scripts.render import demand_caps
from gstex_torch.train import optim as toptim
from gstex_torch.train import step as tstep
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.ops import camera as jcam
from gstex_tpu.train import optim as joptim
from gstex_tpu.train import step as jstep

H, W = base.H, base.W
TRAIN_MAPS = base.MAPS + ("normal", "reg")


def both(kind="random", n=64, pad=(4, 4)):
    s = base.scene_np(kind, n=n, pad=pad)
    jp, jb = base.jax_params(s)
    tp, tb = params_from_jax(base.to_numpy(jp), base.to_numpy(jb),
                             device="cpu")
    return (jp, jb), (tp, tb)


def render_both(cfg_kw, n=64, jax_renderer=None, **call):
    (jp, jb), (tp, tb) = both(n=n, pad=cfg_kw["chart_pad"])
    jc, tc = base.cameras(0.3)
    jkw = dict(cfg_kw, renderer=jax_renderer or cfg_kw["renderer"])
    jout = jmodel.render(jmodel.GStexConfig(**jkw), jp, jb, jc, base.STEP,
                         jnp.asarray(base.BG), **call)
    with torch.no_grad():
        tout = tmodel.render(tmodel.GStexConfig(**cfg_kw), tp, tb, tc,
                             base.STEP, base.t(base.BG), **call)
    return jout, tout


def assert_maps(tout, jout, keys):
    for k in keys:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=5e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("renderer,extra", [
    ("xla", False), ("xla", True), ("oracle", False), ("oracle", True),
    ("pallas", True), ("pallas4", True)])
def test_torch_tiers_match_jax(renderer, extra):
    """The tiers without kernels, and ``extra=True``, which every kernel
    renderer hands to the pure-torch tier (as the JAX package hands it to
    its XLA tier)."""
    cfg_kw = dict(renderer=renderer, chart_pad=(4, 4), pair_cap=8192,
                  s_max=64, lambda_normal=0.05)
    jax_renderer = renderer + "_interpret" if "pallas" in renderer else None
    jout, tout = render_both(cfg_kw, n=32 if renderer == "oracle" else 64,
                             jax_renderer=jax_renderer, extra=extra)
    assert_maps(tout, jout, TRAIN_MAPS + (("uv",) if extra else ()))
    assert ("uv" in tout) == extra
    assert tout["total_pairs"] == int(jout["total_pairs"])
    assert tout["overflow"] == int(jout["overflow"]) == 0
    assert tout["max_tile_count"] == int(jout["max_tile_count"])
    assert float(tout["alpha"].max()) > 0.3


@pytest.mark.parametrize("eval_only", [True, False], ids=["eval", "train"])
def test_pallas4_matches_jax(eval_only):
    """The dense-list tier against JAX's v4 kernels in interpret mode; a
    non-zero ``lambda_normal`` keeps the port's training render out of
    lean mode, which the v4 kernels do not have."""
    cfg_kw = dict(renderer="pallas4", chart_pad=(4, 4), pair_cap=8192,
                  s_max=64, lambda_normal=0.05)
    jout, tout = render_both(cfg_kw, jax_renderer="pallas4_interpret",
                             eval_only=eval_only)
    assert_maps(tout, jout, base.MAPS if eval_only else TRAIN_MAPS)
    assert ("normal" in tout) == (not eval_only)
    assert tout["total_pairs"] == int(jout["total_pairs"])


@pytest.mark.parametrize("eval_only", [True, False], ids=["eval", "train"])
@pytest.mark.parametrize("renderer", ["pallas3", "pallas2"])
def test_pair_tiers_match_jax(monkeypatch, renderer, eval_only):
    """The pair-space tiers against JAX's v3 and v2 kernels in interpret
    mode: training renders through them, and ``eval_only`` renders, as in
    the JAX package, through the dense-list eval kernel (here its plain
    version)."""
    from gstex_torch.ops import rasterize_api

    taken = []
    for name in ("rasterize_pl", "rasterize_pl_eval"):
        real = getattr(tmodel, name)
        monkeypatch.setattr(
            tmodel, name,
            lambda *a, _real=real, _name=name, **k: (
                taken.append((_name, k.get("version"))), _real(*a, **k))[1])
    cfg_kw = dict(renderer=renderer, chart_pad=(4, 4), pair_cap=8192,
                  s_max=64, lambda_normal=0.05)
    jout, tout = render_both(cfg_kw, jax_renderer=renderer + "_interpret",
                             eval_only=eval_only)
    assert_maps(tout, jout, base.MAPS if eval_only else TRAIN_MAPS)
    assert tout["total_pairs"] == int(jout["total_pairs"])
    version = int(renderer[-1])
    assert taken == ([("rasterize_pl_eval", None)] if eval_only
                     else [("rasterize_pl", version)])
    assert rasterize_api.rasterize_pl is not tmodel.rasterize_pl


def test_default_config_renders():
    """``GStexConfig()`` (renderer "xla", 8x8 charts) renders, training
    and eval, and is differentiable."""
    _, (tp, tb) = both(n=32, pad=(8, 8))
    _, tc = base.cameras()
    cfg = tmodel.GStexConfig()
    leaves = tmodel.GStexParams(*(p.clone().requires_grad_(True)
                                  for p in tp))
    out = tmodel.render(cfg, leaves, tb, tc, base.STEP, base.t(base.BG))
    out["rgb"].sum().backward()
    # features_dc is zeroed in the view-dependent colour: the texture's dc
    # carries the albedo
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               and float(p.grad.abs().max()) > 0
               for name, p in zip(leaves._fields, leaves)
               if name != "features_dc")
    with torch.no_grad():
        ev = tmodel.render(cfg, tp, tb, tc, base.STEP, base.t(base.BG),
                           eval_only=True)
    torch.testing.assert_close(ev["rgb"], out["rgb"].detach())


@pytest.mark.parametrize("renderer,pad,tile,want", [
    ("pallas", (8, 8), 32, "flat"), ("pallas", (40, 80), 32, "flat"),
    ("pallas", (88, 88), 32, "dense"), ("pallas", (64, 128), 32, "dense"),
    ("pallas", (88, 88), 16, "flat"), ("pallas4", (8, 8), 32, "dense"),
    ("xla", (8, 8), 32, "dense")])
@pytest.mark.parametrize("eval_only", [True, False], ids=["eval", "train"])
def test_dispatch_takes_one_tier_for_training_and_eval(
        monkeypatch, renderer, pad, tile, want, eval_only):
    """Flat where the dispatch rule (the first flat backward's shared
    memory) keeps the pad, dense above it, and the same answer for a training and an eval render, so a
    scene trained on one tier is served by it. Large pads render (they
    raised before the dense tier)."""
    taken = []
    for name, tag in (("build_tile_bins_flat", "flat"),
                      ("build_tile_bins", "dense")):
        real = getattr(tmodel, name)
        monkeypatch.setattr(
            tmodel, name,
            lambda *a, _real=real, _tag=tag, **k: (taken.append(_tag),
                                                   _real(*a, **k))[1])
    n = 12
    s = base.scene_np("random", n=n, pad=(4, 4))
    s["texture"] = np.zeros((n, *pad, 3), np.float32)
    s["texture"][:, :4, :4] = base.scene_np("random", n=n,
                                            pad=(4, 4))["texture"]
    tp, tb = params_from_jax(*map(base.to_numpy, base.jax_params(s)),
                             device="cpu")
    _, tc = base.cameras()
    cfg = tmodel.GStexConfig(renderer=renderer, chart_pad=pad, tile_h=tile,
                             tile_w=tile, pair_cap=8192, s_max=64)
    with torch.no_grad():
        out = tmodel.render(cfg, tp, tb, tc, base.STEP, base.t(base.BG),
                            eval_only=eval_only)
    assert taken == [want]
    assert bool(torch.isfinite(out["rgb"]).all())
    assert float(out["alpha"].max()) > 0.1


def test_tiers_agree_on_one_scene():
    """Flat kernels' plain versions, dense kernels' plain versions and the
    pure-torch tier render the same training maps from the same params
    (one function, three routes: 1e-6)."""
    _, (tp, tb) = both(n=64, pad=(4, 4))
    _, tc = base.cameras()
    outs = {}
    for renderer in ("pallas", "pallas4", "xla"):
        cfg = tmodel.GStexConfig(renderer=renderer, chart_pad=(4, 4),
                                 pair_cap=8192, s_max=64, lambda_reg=0.1)
        with torch.no_grad():
            outs[renderer] = tmodel.render(cfg, tp, tb, tc, base.STEP,
                                           base.t(base.BG))
    for renderer in ("pallas4", "xla"):
        for k in TRAIN_MAPS:
            torch.testing.assert_close(outs[renderer][k], outs["pallas"][k],
                                       atol=1e-6, rtol=0, msg=k)


@pytest.mark.parametrize("pair_cull", [True, False], ids=["cull", "nocull"])
def test_demand_caps_cover_both_list_layouts(monkeypatch, pair_cull):
    """``demand_caps`` measures the pairs a render will see: with the cull
    where ``cfg.pair_cull`` has the render cull, without it otherwise (a
    culled demand pass under-counts an unculled render's tiles). Both list
    layouts see that demand, and the settled caps leave no overflow in the
    dense lists, whose ``s_max`` is a hard row length."""
    from gstex_torch.scripts import render as trender

    _, (tp, tb) = both("surface", n=100, pad=(4, 4))
    _, tc = base.cameras()
    cfg = tmodel.GStexConfig(chart_pad=(4, 4), pair_cull=pair_cull)
    with torch.no_grad():
        pair_cap, s_max = demand_caps(cfg, tp, tb, [tc], base.STEP)
        # the raw demand behind the caps
        monkeypatch.setattr(trender, "settle_caps", lambda t, h: (t, h))
        measured = demand_caps(cfg, tp, tb, [tc], base.STEP)
        for renderer in ("pallas", "pallas4"):
            c = tmodel.GStexConfig(renderer=renderer, chart_pad=(4, 4),
                                   pair_cull=pair_cull, pair_cap=pair_cap,
                                   s_max=s_max)
            out = tmodel.render(c, tp, tb, tc, base.STEP, base.t(base.BG),
                                eval_only=True)
            assert out["overflow"] == 0
            assert (out["total_pairs"], out["max_tile_count"]) == measured
    assert 1.25 * measured[1] <= s_max


def train_step_matches_jax(jax_renderer, torch_renderer):
    """One step from the same params, camera and ground truth through JAX
    ``make_train_step`` and the port's ``train_step``: the loss within
    1e-5 relative, the updates as ``test_torch_train.py`` holds the flat
    tier's."""
    LEAVES = tmodel.GStexParams._fields
    s = base.scene_np("random", n=64, pad=(4, 4), seed=2)
    jp, jb = base.jax_params(s)
    cfg_kw = dict(chart_pad=(4, 4), pair_cap=8192, s_max=64,
                  background_color="white", sh_degree_interval=1000)
    jcfg = jmodel.GStexConfig(renderer=jax_renderer, **cfg_kw)
    tcfg = tmodel.GStexConfig(renderer=torch_renderer, **cfg_kw)
    ocfg = dict(max_steps=15000)
    c2w = orbit_c2w(3.0, 0.3)
    f = 1.2 * max(H, W)
    image = np.random.default_rng(5).uniform(0, 1, (H, W, 4)).astype(
        np.float32)

    jp_np = base.to_numpy(jp)    # the JAX step donates (deletes) its state
    tp, tb = params_from_jax(jp_np, base.to_numpy(jb), device="cpu")
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

    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert tm["overflow"] == int(jm["overflow"]) == 0
    assert tm["total_pairs"] == int(jm["total_pairs"])
    lrs = toptim.group_lrs(toptim.OptimConfig(**ocfg))
    for k, leaf in enumerate(LEAVES):
        lr = lrs[toptim.GROUP_OF_LEAF[k]]
        lr = lr(0) if callable(lr) else lr
        got = (tstate.params[k].detach().numpy() - jp_np[k]) / lr
        want = (np.asarray(jnew.params[k]) - jp_np[k]) / lr
        g = tstate.params[k].grad
        grad = (np.zeros(want.shape, np.float32) if g is None
                else g.abs().numpy())
        # eps = 1e-15: Adam's first update is the gradient's sign, so
        # elements below 1e-6 of their leaf's largest gradient may flip
        bad = np.abs(got - want) > 1e-3
        tiny = grad <= 1e-6 * grad.max()
        assert not (bad & ~tiny).any(), leaf
        assert bad.sum() <= 1e-3 * bad.size, leaf


def test_dense_train_step_matches_jax():
    """One step on the dense tier (``renderer="pallas4"``) against JAX on
    its v4 kernels in interpret mode."""
    train_step_matches_jax("pallas4_interpret", "pallas4")


def test_pairs_train_step_matches_jax():
    """One step on the v3 pair-space tier (``renderer="pallas3"``, the
    chunk-scan plain version here) against JAX on its v3 kernels in
    interpret mode."""
    train_step_matches_jax("pallas3_interpret", "pallas3")
