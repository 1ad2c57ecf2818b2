"""The whole eval slice: gstex_torch ``render`` against gstex_tpu
``render(cfg(renderer="pallas_interpret"), eval_only=True)`` on the same
numpy scene, plus the scene loaders, the JAX-params bridge and the render
CLI. Maps are compared with atol 5e-5: the two packages cull pairs from
their own geometry and sum in another order (see test_torch_binning.py).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.blender import parse_blender, png_size
from gstex_torch.data.synthetic import orbit_c2w, random_scene, surface_scene
from gstex_torch.models import gstex as tmodel
from gstex_torch.models.convert import params_from_jax
from gstex_torch.models.init_io import (params_from_export_npz,
                                        params_from_scene_stats)
from gstex_torch.ops import camera as tcam
from gstex_torch.scripts import render as trender
from gstex_tpu.ops import camera as jcam
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.models import init_io as jinit_io

H, W = 64, 96
STEP = 3000
BG = np.array([0.1, 0.3, 0.6], np.float32)
MAPS = ("rgb", "img", "texture_rgb", "depth", "alpha")


def t(a):
    return torch.as_tensor(np.array(a))


def scene_np(kind="surface", n=300, pad=(4, 4), seed=0):
    gen = surface_scene if kind == "surface" else random_scene
    return {k: v.numpy() for k, v in
            gen(n, chart_pad=pad, seed=seed, device="cpu").items()}


def jax_params(s):
    n = s["means"].shape[0]
    params = jmodel.GStexParams(
        *(jnp.asarray(s[k]) for k in ("means", "log_scales", "quats",
                                      "opacity_logits", "features_dc",
                                      "features_rest", "texture")))
    buffers = jmodel.GStexBuffers(
        texture_hw=jnp.asarray(s["texture_hw"]),
        mappings=jnp.asarray(s["mappings"]),
        pixel_scale=jnp.float32(0.01),
        test_colors=jnp.asarray(np.full((n, 3), 0.5, np.float32)))
    return params, buffers


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def cameras(azimuth=0.3):
    c2w = orbit_c2w(3.0, azimuth)
    f = 1.2 * max(H, W)
    return (jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w),
            tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu"))


@pytest.mark.parametrize("kind,pad,azimuth", [("surface", (4, 4), 0.3),
                                              ("random", (8, 8), 1.7)])
def test_render_matches_jax(kind, pad, azimuth):
    s = scene_np(kind, pad=pad)
    cfg_kw = dict(renderer="pallas_interpret", chart_pad=pad, pair_cap=8192,
                  s_max=256)
    jp, jb = jax_params(s)
    tp, tb = params_from_jax(to_numpy(jp), to_numpy(jb), device="cpu")
    jc, tc = cameras(azimuth)
    jout = jmodel.render(jmodel.GStexConfig(**cfg_kw), jp, jb, jc, STEP,
                         jnp.asarray(BG), eval_only=True)
    tout = tmodel.render(tmodel.GStexConfig(**cfg_kw), tp, tb, tc, STEP,
                         t(BG), eval_only=True)
    for k in MAPS:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=5e-5, err_msg=k)
    assert tout["total_pairs"] == int(jout["total_pairs"])
    assert tout["overflow"] == int(jout["overflow"]) == 0
    assert float(tout["alpha"].max()) > 0.3


def test_params_from_jax_keeps_leaves():
    jp, jb = jax_params(scene_np())
    tp, tb = params_from_jax(to_numpy(jp), to_numpy(jb), device="cpu")
    for a, b in zip(tuple(tp) + tuple(tb), tuple(jp) + tuple(jb)):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_export_npz_round_trip(tmp_path):
    jp, jb = jax_params(scene_np(pad=(8, 8)))
    path = tmp_path / "scene.npz"
    jinit_io.export_npz(path, jp, jb)
    cfg = tmodel.GStexConfig(chart_pad=(8, 8))
    tp, tb = params_from_export_npz(cfg, path, device="cpu")
    jp2, jb2 = jinit_io.params_from_export_npz(
        jmodel.GStexConfig(chart_pad=(8, 8)), path)
    for name in tmodel.GStexParams._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp2, name)),
                                      err_msg=name)
    for name in ("texture_hw", "mappings", "pixel_scale"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb2, name)),
                                      err_msg=name)


def test_scene_stats_geometry_matches(tmp_path):
    jp, jb = jax_params(scene_np(pad=(8, 8)))
    path = tmp_path / "stats.npz"
    jinit_io.export_scene_stats(path, jp, jb)
    cfg = tmodel.GStexConfig(chart_pad=(8, 8))
    tp, tb = params_from_scene_stats(cfg, path, device="cpu")
    jp2, jb2 = jinit_io.params_from_scene_stats(
        jmodel.GStexConfig(chart_pad=(8, 8)), path)
    for name in ("means", "log_scales", "quats", "opacity_logits"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp2, name)))
    for name in ("texture_hw", "mappings", "pixel_scale"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb2, name)))
    assert tp.texture.shape == jp2.texture.shape
    assert tp.features_rest.shape == jp2.features_rest.shape


@pytest.mark.parametrize("chart_pad", [(8, 8), None], ids=["fixed", "auto"])
def test_init_params_matches_jax(chart_pad):
    s = scene_np(n=200)
    cfg_kw = dict(chart_pad=chart_pad, pixel_num=3000)
    raw = ("means", "log_scales", "quats", "opacity_logits", "features_dc",
           "features_rest")
    jp, jb = jmodel.init_params(jmodel.GStexConfig(**cfg_kw),
                                *(jnp.asarray(s[k]) for k in raw))
    tp, tb = tmodel.init_params(tmodel.GStexConfig(**cfg_kw),
                                *(t(s[k]) for k in raw))
    np.testing.assert_array_equal(tb.texture_hw.numpy(),
                                  np.asarray(jb.texture_hw))
    assert tp.texture.shape == jp.texture.shape
    np.testing.assert_allclose(tp.texture.numpy(), np.asarray(jp.texture))
    np.testing.assert_allclose(tb.mappings.numpy(), np.asarray(jb.mappings),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tb.pixel_scale), float(jb.pixel_scale),
                               rtol=1e-6)


@pytest.mark.parametrize("step", [0, 999, 1000, 2500, 10**6])
def test_active_sh_degree(step):
    cfg = tmodel.GStexConfig()
    assert tmodel.active_sh_degree(cfg, step) == int(
        jmodel.active_sh_degree(jmodel.GStexConfig(), step))


@pytest.mark.parametrize("color", ["white", "black", "random"])
def test_sample_background(color):
    cfg = tmodel.GStexConfig(background_color=color)
    bg = tmodel.sample_background(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    assert bg.shape == (3,) and bool(((bg >= 0) & (bg <= 1)).all())
    if color != "random":
        jbg = jmodel.sample_background(
            jmodel.GStexConfig(background_color=color), jax.random.key(0))
        np.testing.assert_array_equal(bg.numpy(), np.asarray(jbg))


def test_config_fields_match():
    jf = {f.name: f.default for f in dataclasses.fields(jmodel.GStexConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tmodel.GStexConfig)}
    assert jf == tf


@pytest.mark.parametrize("change,item", [
    (dict(renderer="pallas1"), None),
    (dict(renderer="pallas1_interpret", eval_only=False), None),
    (dict(renderer="pallas2"), None),
    (dict(renderer="pallas3"), None),
    (dict(renderer="pallas3_interpret", eval_only=False), None),
    (dict(texel_dtype="bf16"), "Queue 1 item 6"),
    (dict(eval_only=False, use_normal_loss=True), None)])
def test_unported_requests_raise(change, item):
    """A request of what is still to be ported raises, naming its ROADMAP
    item; the pair-space tiers and the normal loss (``item`` None), ported
    since, render: the v1 tier's too, its training render through the v1
    kernels' plain versions here, and the normal loss's training render
    with its depth-estimated normals."""
    change = dict(change)
    s = scene_np(n=20)
    tp, tb = params_from_jax(*map(to_numpy, jax_params(s)), device="cpu")
    _, tc = cameras()
    call = dict(extra=change.pop("extra", False),
                eval_only=change.pop("eval_only", True))
    cfg = tmodel.GStexConfig(**{"renderer": "pallas", "chart_pad": (4, 4),
                                **change})
    if item is None:
        with torch.no_grad():
            out = tmodel.render(cfg, tp, tb, tc, STEP, t(BG), **call)
        assert bool(torch.isfinite(out["rgb"]).all())
        assert float(out["alpha"].max()) > 0.1
        assert ("reg" in out) == (not call["eval_only"])
        assert ("estimated_normals" in out) == cfg.use_normal_loss
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tmodel.render(cfg, tp, tb, tc, STEP, t(BG), **call)


def test_unknown_renderer_is_refused():
    s = scene_np(n=20)
    tp, tb = params_from_jax(*map(to_numpy, jax_params(s)), device="cpu")
    _, tc = cameras()
    cfg = tmodel.GStexConfig(renderer="cuda", chart_pad=(4, 4))
    with pytest.raises(ValueError, match="unknown renderer"):
        tmodel.render(cfg, tp, tb, tc, STEP, t(BG), eval_only=True)


def _stats_file(tmp_path, n=300):
    jp, jb = jax_params(scene_np(n=n, pad=(8, 8)))
    path = tmp_path / "stats.npz"
    jinit_io.export_scene_stats(path, jp, jb)
    return path


def test_render_cli_spiral_writes_pngs(tmp_path):
    out = tmp_path / "frames"
    summary = trender.main([
        "spiral", "--scene-npz", str(_stats_file(tmp_path)), "--frames", "2",
        "--height", str(H), "--width", str(W), "--device", "cpu",
        "--output-path", str(out)])
    frames = sorted(out.glob("frame_*.png"))
    assert len(frames) == 2 and png_size(frames[0]) == (H, W)
    assert all(s["finite"] and s["alpha_coverage"] > 0 and s["overflow"] == 0
               for s in summary)


def test_render_cli_dataset_mode(tmp_path):
    data = tmp_path / "blender"
    (data / "test").mkdir(parents=True)
    frames = []
    for i, az in enumerate((0.0, 2.0)):
        trender.write_png(data / "test" / f"r_{i}.png",
                          np.zeros((H, W, 3), np.uint8))
        c2w = np.concatenate([orbit_c2w(3.0, az), [[0, 0, 0, 1]]])
        frames.append({"file_path": f"./test/r_{i}",
                       "transform_matrix": c2w.tolist()})
    (data / "transforms_test.json").write_text(json.dumps(
        {"camera_angle_x": 0.8, "frames": frames}))
    ds = parse_blender(data, "test")
    assert ds.heights[0] == H and ds.widths[0] == W
    out = tmp_path / "frames"
    summary = trender.main([
        "dataset", "--scene-npz", str(_stats_file(tmp_path)), "--data",
        str(data), "--device", "cpu", "--output-path", str(out)])
    assert len(summary) == 2 and len(list(out.glob("frame_*.png"))) == 2


def test_entry_points_need_a_gpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    path = _stats_file(tmp_path, n=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_scene_stats(tmodel.GStexConfig(), path)
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.main(["spiral", "--scene-npz", str(path), "--frames", "1",
                      "--output-path", str(tmp_path / "none")])
