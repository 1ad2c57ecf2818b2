"""Serving a port-trained run, held against the JAX package on the CPU:
``scripts/eval_setup.py`` restores a run saved after a re-chart bit for
bit; ``Trainer.eval_all`` has JAX's schema and its PSNR and SSIM (1e-4)
on the same views and params; ``scripts/eval.py``, ``scripts/render.py
--load-config`` (dataset, interpolate, spiral, camera-path, and the
equirectangular and ODS panoramas of ``--camera-type``) and
``scripts/export.py`` (all three kinds) run; a frame rendered from the
gstex-npz export equals the run's own frame bit for bit; the render's
interpolated poses (1e-12) and camera-path intrinsics (exact) are JAX's;
and the exports match JAX's writers and loaders: ``average_chart_colors``
to 1e-6, ``export_npz`` both ways leaf for leaf on the active texels,
``export_ply`` and ``export_gaussian_ply`` field for field (bit for bit,
the colours to 1e-6), ``export_scene_stats`` through JAX's
``params_from_scene_stats``.

One tiny run (32x32 images, 2 train and 2 test views, 300 surfels, 3
steps, re-charted at step 2) is trained once for the module."""

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.png import read_png
from gstex_torch.data.synthetic import orbit_c2w, write_blender_dataset
from gstex_torch.models import gstex as tmodel
from gstex_torch.models import init_io as tinit_io
from gstex_torch.models.convert import params_from_jax
from gstex_torch.scripts import eval as teval
from gstex_torch.scripts import export as texport
from gstex_torch.scripts import render as trender
from gstex_torch.scripts import train as ttrain
from gstex_torch.scripts.eval_setup import eval_setup
from gstex_torch.train import step as tstep
from gstex_torch.utils import ply as tply
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.models import init_io as jinit_io
from gstex_tpu.utils import ply as jply
from test_torch_render import jax_params, scene_np
from test_torch_train_cli import small_scene_npz

HW = 32
METRIC_TOL = 1e-4
COLOR_TOL = 1e-6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A gstex-blender-nvs run on the CPU whose checkpoint is saved after
    a re-chart: (run dir, dataset dir, scene-statistics file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("serve")
    stats = small_scene_npz(root / "scene.npz", n=300)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8))
    params, buffers = tinit_io.load_scene_npz(cfg, stats, seed=0,
                                              device="cpu")
    data = root / "data"
    write_blender_dataset(data, cfg, params, buffers, 2, HW, HW)
    write_blender_dataset(data, cfg, params, buffers, 2, HW, HW,
                          split="test", azimuth0=0.4)
    out = root / "run"
    ttrain.main(["gstex-blender-nvs", "--data", str(data), "--scene-npz",
                 str(stats), "--seed", "1", "--max-num-iterations", "3",
                 "--pixel-num", "2e4", "--set", "model.build_chart_every=2",
                 "--output-dir", str(out), "--device", "cpu"])
    yield out, data, stats
    torch.set_num_threads(n)


def test_eval_setup_restores_a_recharted_run_bit_for_bit(run):
    out, _, stats = run
    ck = next((out / "checkpoints").glob("step-*.ckpt.pt"))
    saved = torch.load(ck, weights_only=True)
    trainer, method, cfg = eval_setup(out / "config.json", device="cpu")
    st = trainer.state
    assert method.name == "gstex-blender-nvs" and st.step == 3
    assert tuple(trainer.mcfg.chart_pad) == tuple(cfg["model"]["chart_pad"])
    for name, leaf in st.params._asdict().items():
        assert torch.equal(leaf.detach(), saved["params"][name]), name
    for name, leaf in st.buffers._asdict().items():
        assert torch.equal(leaf, saved["buffers"][name]), name
    # the re-chart moved the charts away from what a fresh init gives
    mcfg = tmodel.GStexConfig(**{**cfg["model"], "chart_pad": tuple(
        cfg["model"]["chart_pad"])})
    _, fresh = tinit_io.load_scene_npz(mcfg, stats, seed=1, device="cpu")
    assert not torch.equal(fresh.texture_hw, st.buffers.texture_hw)
    opt = st.optimizer.state_dict()["state"]
    for k, v in saved["optimizer"]["state"].items():
        assert all(torch.equal(opt[k][f], v[f]) for f in v)
    assert torch.equal(st.generator.get_state(), saved["generator"])
    assert len(trainer.train_cache) == 2 and len(trainer.eval_cache) == 2


def test_eval_setup_without_a_checkpoint_raises(run, tmp_path):
    out, _, _ = run
    (tmp_path / "config.json").write_text((out / "config.json").read_text())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        eval_setup(tmp_path, device="cpu")


def jax_eval_all(trainer, data):
    """JAX's ``Trainer.eval_all`` on the port trainer's params, over the
    same test views parsed by JAX, rendered by its XLA tier as its own CPU
    tests render."""
    from gstex_tpu.data.blender import parse_blender
    from gstex_tpu.data.manager import FullImageCache
    from gstex_tpu.train.step import TrainState, make_eval_step
    from gstex_tpu.train.trainer import Trainer as JTrainer

    st = trainer.state
    jp = jmodel.GStexParams(*(jnp.asarray(p.detach().numpy())
                              for p in st.params))
    jb = jmodel.GStexBuffers(*(jnp.asarray(b.numpy()) for b in st.buffers))
    jcfg = jmodel.GStexConfig(**{
        **{k: getattr(trainer.mcfg, k) for k in
           jmodel.GStexConfig.__dataclass_fields__}, "renderer": "xla"})
    fake = SimpleNamespace(
        eval_cache=FullImageCache.build(parse_blender(data, "test"), seed=1),
        _eval=make_eval_step(jcfg), mcfg=jcfg,
        state=TrainState(jp, jb, (), jnp.int32(st.step), ()))
    fake._eval_background = lambda: JTrainer._eval_background(fake)
    return JTrainer.eval_all(fake)


def test_eval_cli_prints_jax_schema_and_metrics(run, tmp_path):
    out, data, _ = run
    path = tmp_path / "eval.json"
    got = teval.main(["--load-config", str(out), "--output-path", str(path),
                      "--save-images", "--device", "cpu"])
    assert json.loads(path.read_text()) == got
    assert set(got) == {"experiment_name", "method_name", "checkpoint",
                        "results"}
    assert got["method_name"] == "gstex-blender-nvs"
    res = got["results"]
    trainer, _, _ = eval_setup(out, device="cpu")
    ref = jax_eval_all(trainer, data)
    assert set(res) == set(ref)
    assert res["lpips"] is None and "lpips_std" not in res
    assert abs(res["psnr"] - ref["psnr"]) <= METRIC_TOL
    assert abs(res["ssim"] - ref["ssim"]) <= METRIC_TOL
    for k in ("gaussian_count", "texel_count", "pixel_scale"):
        assert res[k] == ref[k], k
    assert res["fps"] > 0 and res["num_rays_per_sec"] == pytest.approx(
        res["fps"] * HW * HW)
    assert sorted(p.name for p in (out / "images").glob("eval_all_rgb_*")) \
        == [f"eval_all_rgb_{i:09d}.png" for i in range(2)]


def test_eval_all_saves_images_as_jax_does(run, tmp_path, monkeypatch):
    """``eval_all(save_images=True)`` sends each render through the
    writer as JAX's ``eval_all`` does: the same file names under
    ``images/``, the same pixels (JAX's ``eval_all`` given the port's
    renders, so that only the saving is compared)."""
    from gstex_tpu.data.blender import parse_blender
    from gstex_tpu.data.manager import FullImageCache
    from gstex_tpu.train.trainer import Trainer as JTrainer
    from gstex_tpu.utils.writer import Writer as JWriter
    from PIL import Image

    out, data, _ = run
    trainer, _, _ = eval_setup(out, device="cpu")
    trainer.writer.out_dir = tmp_path / "port"
    trainer.writer.out_dir.mkdir()
    renders = []
    real_eval = tstep.eval_step

    def recording(*args):
        o = real_eval(*args)
        renders.append(o["rgb"].numpy())
        return o
    monkeypatch.setattr(tstep, "eval_step", recording)
    trainer.eval_all(save_images=True)
    jcfg = jmodel.GStexConfig(**{
        **{k: getattr(trainer.mcfg, k) for k in
           jmodel.GStexConfig.__dataclass_fields__}, "renderer": "xla"})
    fake = SimpleNamespace(
        eval_cache=FullImageCache.build(parse_blender(data, "test"), seed=1),
        _eval=lambda *a: {"rgb": jnp.asarray(renders.pop(0))}, mcfg=jcfg,
        writer=JWriter(tmp_path / "jax", use_tensorboard=False),
        state=SimpleNamespace(
            params=trainer.state.params, buffers=jmodel.GStexBuffers(
                *(jnp.asarray(b.numpy()) for b in trainer.state.buffers))))
    fake._eval_background = lambda: JTrainer._eval_background(fake)
    JTrainer.eval_all(fake, save_images=True)
    assert not renders
    names = sorted(p.name for p in (tmp_path / "jax" / "images").iterdir())
    assert names == [f"eval_all_rgb_{i:09d}.png" for i in range(2)]
    assert sorted(p.name for p in (tmp_path / "port" / "images").iterdir()) \
        == names
    for name in names:
        got = read_png(tmp_path / "port" / "images" / name)
        want = np.asarray(Image.open(tmp_path / "jax" / "images" / name))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["dataset", "interpolate", "spiral",
                                  "camera-path"])
def test_render_cli_load_config_modes(run, tmp_path, mode):
    out, _, _ = run
    extra = []
    if mode == "camera-path":
        kfs = [{"camera_to_world": np.concatenate(
            [orbit_c2w(3.5, az), [[0, 0, 0, 1]]]).reshape(-1).tolist(),
            "fov": 50.0} for az in (0.0, 1.0)]
        spec = tmp_path / "camera_path.json"
        spec.write_text(json.dumps({"camera_path": kfs, "render_height": 24,
                                    "render_width": 40}))
        extra = ["--camera-path-filename", str(spec)]
    frames = tmp_path / "frames"
    summary = trender.main([mode, "--load-config", str(out), "--frames", "3",
                            "--output-path", str(frames), "--device", "cpu",
                            *extra])
    want = {"dataset": 2, "interpolate": 3, "spiral": 3, "camera-path": 2}
    assert len(summary) == want[mode]
    assert len(list(frames.glob("frame_*.png"))) == want[mode]
    assert all(s["finite"] and s["overflow"] == 0 for s in summary)
    assert all(s["alpha_coverage"] > 0 for s in summary)


@pytest.mark.parametrize("flags,what", [(["--video", "--fps", "12"],
                                          "render.mp4")], ids=["video"])
def test_render_cli_refuses_what_is_not_ported(run, tmp_path, flags, what):
    """``--video --fps 12`` (once refused) writes render.mp4 beside the
    PNGs, as gstex-render does: one frame a PNG at 12 frames a second,
    read back by cv2 (ffmpeg) as its PNGs to the codec's loss."""
    import cv2

    from gstex_torch.data.png import read_png

    out, _, _ = run
    summary = trender.main(["spiral", "--load-config", str(out), "--frames",
                            "3", "--device", "cpu", "--output-path",
                            str(tmp_path), *flags])
    pngs = sorted(tmp_path.glob("frame_*.png"))
    assert len(pngs) == len(summary) == 3
    cap = cv2.VideoCapture(str(tmp_path / what))
    assert cap.get(cv2.CAP_PROP_FPS) == 12
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 3
    for png, s in zip(pngs, summary):
        ok, bgr = cap.read()
        assert ok and bgr.shape == (HW, HW, 3)
        err = np.abs(bgr[..., ::-1].astype(int) - read_png(png)).mean()
        assert err < 4 and s["video"]["bytes"] > 0
    assert not cap.read()[0]


@pytest.mark.parametrize("camera_type", ["equirectangular", "ods"])
def test_render_cli_panoramas(run, tmp_path, camera_type):
    """``--camera-type`` writes a panorama a pose: (w/2, w) lat-long, or
    (w, w) for the ODS pair, from 6 or 12 cube faces."""
    out, _, _ = run
    summary = trender.main(["spiral", "--load-config", str(out), "--frames",
                            "2", "--camera-type", camera_type,
                            "--pano-width", "32", "--device", "cpu",
                            "--output-path", str(tmp_path)])
    frames = sorted(tmp_path.glob("frame_*.png"))
    assert len(frames) == len(summary) == 2
    want = (16, 32) if camera_type == "equirectangular" else (32, 32)
    for f, s in zip(frames, summary):
        assert read_png(f).shape == want + (3,)
        assert s["finite"] and (s["height"], s["width"]) == want
        assert s["faces"] == (6 if camera_type == "equirectangular" else 12)


def test_export_cli_and_the_export_renders_the_run_bit_for_bit(run,
                                                                tmp_path):
    """The three exports of the run; the gstex-npz one, rendered through
    ``--scene-npz`` on the same test cameras and background, gives the
    run's own frames to the byte."""
    out, data, _ = run
    paths = {k: tmp_path / f"scene.{k}" for k in texport.WRITERS}
    for kind, path in paths.items():
        texport.main([kind, "--load-config", str(out), "--output-path",
                      str(path), "--device", "cpu"])
    npz = tmp_path / "scene.gstex-npz.npz"
    assert npz.exists() and paths["gstex-ply"].exists()
    raw = tinit_io.raw_from_gaussian_ply(paths["gaussian-ply"],
                                         device="cpu")
    trainer, _, _ = eval_setup(out, device="cpu")
    st = trainer.state
    assert torch.equal(raw["means"], st.params.means.detach())
    assert torch.equal(raw["features_rest"], st.params.features_rest.detach())

    run_frames, npz_frames = tmp_path / "run_frames", tmp_path / "npz_frames"
    trender.main(["dataset", "--load-config", str(out), "--output-path",
                  str(run_frames), "--device", "cpu"])
    trender.main(["dataset", "--scene-npz", str(npz), "--data", str(data),
                  "--background-color", "white", "--output-path",
                  str(npz_frames), "--device", "cpu"])
    a = sorted(run_frames.glob("frame_*.png"))
    b = sorted(npz_frames.glob("frame_*.png"))
    assert len(a) == len(b) == 2
    assert all(x.read_bytes() == y.read_bytes() for x, y in zip(a, b))


def test_interp_poses_match_jax():
    from gstex_tpu.scripts.render import _interp_poses

    c2ws = [orbit_c2w(3.0 + 0.1 * i, 0.7 * i, 0.2 + 0.05 * i)
            .astype(np.float32) for i in range(4)]
    got, want = trender._interp_poses(c2ws, 9), _interp_poses(c2ws, 9)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-12, rtol=0)


def test_camera_path_intrinsics_match_jax():
    """The keyframes' cameras as ``gstex-render camera-path`` makes them
    (``gstex_tpu/scripts/render.py``: fov to fy, the centre as the
    principal point)."""
    from gstex_tpu.ops.camera import make_camera as jmake_camera

    spec = {"render_height": 24, "render_width": 40, "fov": 40.0,
            "camera_path": [
                {"camera_to_world": np.concatenate([orbit_c2w(3.0, az), [
                    [0, 0, 0, 1]]]).reshape(-1).tolist(), "fov": fov}
                for az, fov in ((0.0, 50.0), (1.0, 30.0))]
            + [{"camera_to_world": np.eye(4).reshape(-1).tolist()}]}
    got = trender.camera_path_cameras(spec, "cpu")
    assert len(got) == 3
    for cam, kf in zip(got, spec["camera_path"]):
        h, w = 24, 40
        fy = 0.5 * h / np.tan(0.5 * np.deg2rad(kf.get("fov", spec["fov"])))
        c2w = np.array(kf["camera_to_world"]).reshape(4, 4)[:3]
        ref = jmake_camera(fy, fy, w / 2, h / 2, h, w, c2w)
        for f in ("fx", "fy", "cx", "cy"):
            assert float(getattr(cam, f)) == float(getattr(ref, f)), f
        assert (cam.height, cam.width) == (ref.height, ref.width)
        np.testing.assert_array_equal(cam.c2w.numpy(), np.asarray(ref.c2w))


def scene_pair(seed=0):
    """One scene as JAX and as port params: (jax params, jax buffers, port
    params, port buffers), charts active on parts of an (8, 12) pad."""
    s = scene_np(n=60, pad=(8, 12), seed=seed)
    rng = np.random.default_rng(seed)
    s["texture_hw"] = np.stack([rng.integers(1, 9, 60),
                                rng.integers(1, 13, 60)], 1).astype(np.int32)
    s["features_rest"] = rng.normal(0, 0.1, s["features_rest"].shape
                                    ).astype(np.float32)
    jp, jb = jax_params(s)
    tp, tb = params_from_jax(jp, jb, device="cpu")
    return jp, jb, tp, tb


@pytest.mark.parametrize("sh_degree", [3, 0])
def test_average_chart_colors_match_jax(sh_degree):
    jp, jb, tp, tb = scene_pair()
    want = np.asarray(jinit_io.average_chart_colors(jp.texture,
                                                    jb.texture_hw, sh_degree))
    got = tinit_io.average_chart_colors(tp.texture, tb.texture_hw,
                                        sh_degree).numpy()
    np.testing.assert_allclose(got, want, atol=COLOR_TOL, rtol=0)


def active_texels(texture, hw):
    return [np.asarray(texture[i, :h, :w]) for i, (h, w) in
            enumerate(np.asarray(hw))]


def test_export_npz_round_trips_with_jax(tmp_path):
    """The port's dump in JAX's loader, and JAX's dump in the port's: every
    leaf equal, the texture on the active texels."""
    jp, jb, tp, tb = scene_pair(1)
    cfg = tmodel.GStexConfig(chart_pad=(8, 12))
    tinit_io.export_npz(tmp_path / "port.npz", tp, tb)
    jinit_io.export_npz(tmp_path / "jax.npz", jp, jb)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") \
            as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jp2, jb2 = jinit_io.params_from_export_npz(
        jmodel.GStexConfig(chart_pad=(8, 12)), tmp_path / "port.npz")
    tp2, tb2 = tinit_io.params_from_export_npz(cfg, tmp_path / "jax.npz",
                                               device="cpu")
    for (name, j), t in zip(jp2._asdict().items(), tp2):
        if name != "texture":
            np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                          err_msg=name)
    for x, y, z in zip(active_texels(jp2.texture, jb.texture_hw),
                       active_texels(tp2.texture.numpy(), tb.texture_hw),
                       active_texels(tp.texture.numpy(), tb.texture_hw)):
        np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(y, z)
    for name in ("texture_hw", "mappings", "pixel_scale"):
        np.testing.assert_array_equal(np.asarray(getattr(jb2, name)),
                                      getattr(tb2, name).numpy())


def test_export_plys_match_jax(tmp_path):
    jp, jb, tp, tb = scene_pair(2)
    for writer in ("export_ply", "export_gaussian_ply"):
        getattr(tinit_io, writer)(tmp_path / "port.ply", tp, tb, 3)
        getattr(jinit_io, writer)(tmp_path / "jax.ply", jp, jb, 3)
        got = tply.read_ply(tmp_path / "port.ply")
        want = jply.read_ply(tmp_path / "jax.ply")
        assert list(got) == list(want)
        for k in got:
            tol = COLOR_TOL * 255 if k in ("red", "green", "blue") else 0.0
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                       err_msg=f"{writer}: {k}")


def test_export_scene_stats_round_trips_through_jax(tmp_path):
    jp, jb, tp, tb = scene_pair(3)
    tinit_io.export_scene_stats(tmp_path / "port.npz", tp, tb)
    jinit_io.export_scene_stats(tmp_path / "jax.npz", jp, jb)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") \
            as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    cfg = jmodel.GStexConfig(chart_pad=(8, 12))
    jp2, jb2 = jinit_io.params_from_scene_stats(cfg, tmp_path / "port.npz")
    for name in ("means", "log_scales", "quats", "opacity_logits"):
        want = getattr(tp, name).numpy().astype(np.float16)
        np.testing.assert_array_equal(
            np.asarray(getattr(jp2, name)), want.astype(np.float32),
            err_msg=name)
    np.testing.assert_array_equal(np.asarray(jb2.texture_hw),
                                  tb.texture_hw.numpy())
