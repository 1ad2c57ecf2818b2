"""The training entry point and what it reads and writes: the PNG decoder
against PIL, ``gstex_torch.scripts.train`` for a few steps on the CPU on a
dataset written by the port's own render, its checkpoint, and the
device default of ``sample_background``; the same entry points on the
dense-list tier (``--renderer pallas4``, and a chart pad too large for the
flat path), and training on the pair-space tiers (``--renderer pallas3``,
``pallas2``)."""

import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from gstex_torch.data.blender import load_image, parse_blender
from gstex_torch.data.png import read_png, write_png
from gstex_torch.data.synthetic import write_blender_dataset
from gstex_torch.models import gstex as tmodel
from gstex_torch.models.init_io import load_scene_npz
from gstex_torch.scripts import train as ttrain
from gstex_torch.train import optim as toptim
from gstex_torch.train import step as tstep
from gstex_torch.utils.checkpoint import load_checkpoint

STATS = "assets/trained_scene_stats.npz"


def _filter_rows(img: np.ndarray, ftype: int) -> bytes:
    """Encode every row of an (H, W, C) uint8 image with PNG filter
    ``ftype`` (the spec's definitions, written independently of the
    decoder under test)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y > 0 else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            pred = np.zeros_like(x)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + ((x - pred) % 256).astype(
            np.uint8).tobytes())
    return b"".join(out)


def _write_filtered(path, img, ftype):
    h, w, c = img.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                           {3: 2, 4: 6}[c], 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(_filter_rows(img, ftype))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decoder_matches_pil(tmp_path, channels, ftype):
    rng = np.random.default_rng(ftype * 10 + channels)
    img = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    img[4:9, 3:12] = img[4:5, 3:12]   # runs that the filters predict
    path = tmp_path / "f.png"
    _write_filtered(path, img, ftype)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_decoder_reads_pil_and_own_files(tmp_path, mode):
    rng = np.random.default_rng(7)
    c = len(mode)
    img = rng.integers(0, 256, (40, 33, c), dtype=np.uint8)
    img[10:30] = np.linspace(0, 255, 33 * c).reshape(33, c).astype(np.uint8)
    Image.fromarray(img, mode).save(tmp_path / "pil.png", optimize=True)
    np.testing.assert_array_equal(read_png(tmp_path / "pil.png"), img)
    write_png(tmp_path / "own.png", img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "own.png")), img)
    np.testing.assert_allclose(load_image(tmp_path / "own.png"), img / 255.0,
                               atol=1e-7)


@pytest.mark.parametrize("mode", ["1", "P", "I;16"])
def test_png_decoder_rejects_other_formats(tmp_path, mode):
    """Bit depths other than 8 and palette images raise (8-bit grey is
    read: ``test_torch_data_nerfstudio.py``)."""
    img = Image.fromarray(np.zeros((4, 4), np.uint8), "L")
    img.convert(mode).save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="colour type"):
        read_png(tmp_path / "p.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "x.png")


@pytest.fixture
def one_thread():
    """These tests run many small tensor ops; one intra-op thread keeps
    them from contending with the other test workers for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_scene_npz(path, n=1000, seed=0):
    """A trained-scene-statistics file holding n of the asset's surfels."""
    with np.load(STATS) as d:
        d = dict(d)
    keep = np.sort(np.random.default_rng(seed).choice(
        d["xyz"].shape[0], n, replace=False))
    per_surfel = {k for k, v in d.items() if v.ndim and v.shape[0] ==
                  d["xyz"].shape[0]}
    np.savez(path, **{k: (v[keep] if k in per_surfel else v)
                      for k, v in d.items()})
    return path


def test_train_cli_on_cpu(tmp_path, one_thread):
    """Three steps of gstex-blender-nvs at 64x96 on the CPU (the plain
    versions of the kernels), from a dataset rendered by the port's eval
    path; the checkpoint loads back into a fresh state."""
    stats = small_scene_npz(tmp_path / "scene.npz", n=300)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8))
    params, buffers = load_scene_npz(cfg, stats, seed=0, device="cpu")
    data = tmp_path / "data"
    write_blender_dataset(data, cfg, params, buffers, 3, 64, 96)
    write_blender_dataset(data, cfg, params, buffers, 1, 64, 96,
                          split="test")
    assert parse_blender(data, "train").heights[0] == 64
    out = tmp_path / "run"
    res = ttrain.main(["gstex-blender-nvs", "--data", str(data),
                       "--scene-npz", str(stats), "--seed", "1",
                       "--max-num-iterations", "3", "--pixel-num", "2e4",
                       "--output-dir", str(out), "--device", "cpu"])
    hist = res["history"]
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["overflow"] == 0 for h in hist)
    assert sorted(h["camera"] for h in hist) == [0, 1, 2]
    assert res["eval"]["psnr"] > 5
    assert (out / "config.json").exists() and (out / "events.jsonl").exists()

    mcfg = tmodel.GStexConfig(renderer="pallas", chart_pad=None,
                              pixel_num=2e4)
    p0, b0 = load_scene_npz(mcfg, stats, seed=1, device="cpu")
    state = tstep.init_state(mcfg, toptim.OptimConfig(), p0, b0)
    config = load_checkpoint(res["checkpoint"], state)
    assert config["method"] == "gstex-blender-nvs" and state.step == 3
    moved = [float((a.detach() - b).abs().max())
             for a, b in zip(state.params, p0)]
    assert moved[0] > 0 and moved[-1] > 0
    assert all(int(s["step"]) == 3 for s in state.optimizer.state.values())


@pytest.mark.parametrize("flags,pad", [
    (["--renderer", "pallas4", "--pixel-num", "2e4"], None),
    (["--pixel-num", "6e5"], (128, 128))], ids=["pallas4", "large_charts"])
def test_train_cli_on_the_dense_tier(tmp_path, one_thread, monkeypatch,
                                     flags, pad):
    """Two steps on the CPU through the dense lists: asked for by name, or
    taken because the texel budget makes charts too large for the flat
    path (60 surfels at 6e5 texels: the largest pad, (128, 128))."""
    from gstex_torch.scripts import render as trender

    taken = []
    real = tmodel.build_tile_bins
    monkeypatch.setattr(tmodel, "build_tile_bins",
                        lambda *a, **k: (taken.append(1), real(*a, **k))[1])
    monkeypatch.setattr(tmodel, "build_tile_bins_flat", None)
    stats = small_scene_npz(tmp_path / "scene.npz", n=60)
    cfg = tmodel.GStexConfig(renderer="pallas4", chart_pad=(8, 8))
    params, buffers = load_scene_npz(cfg, stats, seed=0, device="cpu")
    data = tmp_path / "data"
    write_blender_dataset(data, cfg, params, buffers, 2, 32, 48)
    write_blender_dataset(data, cfg, params, buffers, 1, 32, 48,
                          split="test")
    out = tmp_path / "run"
    res = ttrain.main(["gstex-blender-nvs", "--data", str(data),
                       "--scene-npz", str(stats), "--seed", "1",
                       "--max-num-iterations", "2", *flags,
                       "--output-dir", str(out), "--device", "cpu"])
    hist = res["history"]
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["overflow"] == 0 for h in hist)
    assert res["eval"]["psnr"] > 5
    import json
    run_cfg = json.loads((out / "config.json").read_text())["model"]
    assert run_cfg["renderer"] == ("pallas4" if pad is None else "pallas")
    if pad is not None:
        assert tuple(run_cfg["chart_pad"]) == pad
    # 3 views written, 2 training renders, the step-0 eval image, eval_all
    # (its warm-up render and the one eval view)
    assert len(taken) == 3 + 2 + 1 + 2

    frames = tmp_path / "frames"
    summary = trender.main([
        "spiral", "--scene-npz", str(stats), "--frames", "2", "--height",
        "32", "--width", "48", "--renderer", "pallas4", "--device", "cpu",
        "--output-path", str(frames)])
    assert len(list(frames.glob("frame_*.png"))) == 2
    assert all(s["finite"] and s["overflow"] == 0 for s in summary)
    assert len(taken) == 3 + 2 + 1 + 2 + 2


@pytest.mark.parametrize("renderer", ["pallas3", "pallas2"])
def test_train_cli_on_the_pair_tiers(tmp_path, one_thread, monkeypatch,
                                     renderer):
    """Two steps on the CPU through the pair-space tiers: every training
    render goes to ``rasterize_pl`` with the tier's version, once a step,
    and every eval render (the step-0 image, the closing pass's warm-up
    render and its view) to the dense-list eval path."""
    calls = []
    for name in ("rasterize_pl", "rasterize_pl_eval"):
        real = getattr(tmodel, name)
        monkeypatch.setattr(
            tmodel, name,
            lambda *a, _real=real, _name=name, **k: (
                calls.append((_name, k.get("version"))), _real(*a, **k))[1])
    stats = small_scene_npz(tmp_path / "scene.npz", n=300)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8))
    params, buffers = load_scene_npz(cfg, stats, seed=0, device="cpu")
    data = tmp_path / "data"
    write_blender_dataset(data, cfg, params, buffers, 2, 64, 96)
    write_blender_dataset(data, cfg, params, buffers, 1, 64, 96,
                          split="test")
    calls.clear()
    out = tmp_path / "run"
    res = ttrain.main(["gstex-blender-nvs", "--data", str(data),
                       "--scene-npz", str(stats), "--seed", "1",
                       "--max-num-iterations", "2", "--pixel-num", "2e4",
                       "--renderer", renderer, "--output-dir", str(out),
                       "--device", "cpu"])
    hist = res["history"]
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["overflow"] == 0 for h in hist)
    assert res["eval"]["psnr"] > 5
    version = int(renderer[-1])
    assert sorted(calls) == sorted([("rasterize_pl", version)] * 2
                                   + [("rasterize_pl_eval", None)] * 3)


def test_sample_background_defaults_to_the_card(monkeypatch):
    """Without a device, the background is drawn on the card: with no
    card present that raises, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for color in ("random", "white", "black"):
        cfg = tmodel.GStexConfig(background_color=color)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodel.sample_background(cfg)
        bg = tmodel.sample_background(cfg, device="cpu")
        assert bg.shape == (3,) and bg.device.type == "cpu"
    gen = torch.Generator().manual_seed(0)
    bg = tmodel.sample_background(tmodel.GStexConfig(), gen, device="cpu")
    assert float(bg.min()) >= 0 and float(bg.max()) < 1


@pytest.mark.parametrize("name", ["gstex", "gstex-blender-init",
                                  "gstex-blender-nvs", "gstex-blender-lod"])
def test_blender_methods_match_jax(name):
    """The port's Blender methods carry the JAX package's settings; only
    the renderer differs (the flat kernel path here, the backend's own
    choice there)."""
    import dataclasses

    from gstex_torch.configs.methods import get_method
    from gstex_tpu.configs import methods as jmethods

    got, want = get_method(name), jmethods.get_method(name)
    assert got.dataparser == want.dataparser == "blender"
    assert dataclasses.replace(got.model, renderer="x") == \
        tmodel.GStexConfig(**{**dataclasses.asdict(want.model),
                              "renderer": "x"})
    assert dataclasses.asdict(got.optim) == dataclasses.asdict(want.optim)
    assert got.trainer.max_num_iterations == want.trainer.max_num_iterations
    assert ({f.name for f in dataclasses.fields(got.trainer)}
            == {f.name for f in dataclasses.fields(want.trainer)})
    assert got.model.renderer == "pallas"


def test_unported_methods_and_trainer_options_raise(tmp_path):
    from gstex_torch.configs.methods import get_method
    from gstex_torch.train.trainer import Trainer, TrainerConfig

    # every method of the JAX package is ported; unknown names raise
    assert get_method("gstex-dtu-nvs").dataparser == "nerfstudio"
    with pytest.raises(KeyError):
        get_method("nope")
    cfg = tmodel.GStexConfig()
    # the scanned dispatch is ported: a chunk takes at least one step
    tcfg = TrainerConfig(output_dir=str(tmp_path), steps_per_sync=0)
    with pytest.raises(ValueError, match="steps_per_sync"):
        Trainer(tcfg, cfg, toptim.OptimConfig(), None, None, [])
    # multi-device training is ported: it needs its process group
    tcfg = TrainerConfig(output_dir=str(tmp_path), num_devices=4)
    with pytest.raises(RuntimeError, match="one process a rank"):
        Trainer(tcfg, cfg, toptim.OptimConfig(), None, None, [])
    # camera pose optimization is ported; a mode it lacks is refused
    tcfg = TrainerConfig(output_dir=str(tmp_path), camera_opt="SO3")
    with pytest.raises(ValueError, match="camera_opt"):
        Trainer(tcfg, cfg, toptim.OptimConfig(), None, None, [])


def test_trainer_nan_gate_and_cap_growth(tmp_path, one_thread):
    """A non-finite loss aborts with a diagnostic dump; an overflowing
    step grows the pair capacities to its measured demand."""
    import json

    from gstex_torch.data.blender import parse_blender as parse
    from gstex_torch.data.manager import FullImageCache
    from gstex_torch.train.trainer import Trainer, TrainerConfig

    stats = small_scene_npz(tmp_path / "scene.npz", n=300)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8),
                             pair_cap=4096, s_max=64)
    params, buffers = load_scene_npz(cfg, stats, seed=0, device="cpu")
    write_blender_dataset(tmp_path / "data", cfg, params, buffers, 2, 32, 48)
    cache = FullImageCache.build(parse(tmp_path / "data", "train"),
                                 device="cpu")
    tcfg = TrainerConfig(output_dir=str(tmp_path / "run"),
                         max_num_iterations=2, steps_per_save=0)
    trainer = Trainer(tcfg, cfg, toptim.OptimConfig(), params, buffers,
                      cache)
    trainer._grow_capacities(5, {"overflow": 10, "total_pairs": 9000,
                                 "max_tile_count": 100})
    assert trainer.mcfg.pair_cap >= 9000 and trainer.mcfg.s_max >= 128

    # the dense lists truncate at s_max: the overflowing step reports its
    # demand, the caps grow past it, and the next step drops nothing
    dense = tmodel.GStexConfig(renderer="pallas4", chart_pad=(8, 8),
                               pair_cap=4096, s_max=8)
    trainer = Trainer(tcfg, dense, toptim.OptimConfig(), params, buffers,
                      cache)
    hist = trainer.train()
    assert hist[0]["overflow"] > 0 and hist[0]["max_tile_count"] > 8
    assert trainer.mcfg.s_max >= hist[0]["max_tile_count"]
    assert hist[1]["overflow"] == 0

    bad = params._replace(texture=torch.full_like(params.texture,
                                                  float("nan")))
    trainer = Trainer(tcfg, cfg, toptim.OptimConfig(), bad, buffers, cache)
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train()
    dump = json.loads((tmp_path / "run" / "nan_dump_step0.json").read_text())
    assert dump["params"]["texture"]["finite_frac"] == 0.0


@pytest.mark.parametrize("name", ["gstex-colmap-init", "gstex-dtu-nvs",
                                  "gstex-dtu-lod"])
def test_nerfstudio_methods_match_jax(name):
    """The nerfstudio methods carry the JAX package's settings: the
    dataparser, its downscale and eval split, black background and the
    COLMAP axis fix; only the renderer differs, as for the Blender ones."""
    import dataclasses

    from gstex_torch.configs.methods import get_method
    from gstex_tpu.configs import methods as jmethods

    got, want = get_method(name), jmethods.get_method(name)
    assert got.dataparser == want.dataparser == "nerfstudio"
    assert (got.downscale_factor, got.eval_mode, got.eval_interval) == (
        want.downscale_factor, want.eval_mode, want.eval_interval) == (
        2, "interval", 8)
    assert dataclasses.replace(got.model, renderer="x") == \
        tmodel.GStexConfig(**{**dataclasses.asdict(want.model),
                              "renderer": "x"})
    assert got.model.fix_init and got.model.background_color == "black"
    assert dataclasses.asdict(got.optim) == dataclasses.asdict(want.optim)
    assert got.trainer.max_num_iterations == want.trainer.max_num_iterations
    assert got.model.renderer == "pallas"


def dtu_dataset(tmp_path, n=300, views=9, height=48, width=64):
    """A nerfstudio dataset (masks, seed plys in COLMAP axes) rendered from
    n of the asset's surfels, texels 5x the loader's fills so that
    training from the seed ply has something to learn."""
    from gstex_torch.data.synthetic import write_nerfstudio_dataset

    stats = small_scene_npz(tmp_path / "scene.npz", n=n)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8),
                             background_color="black")
    params, buffers = load_scene_npz(cfg, stats, seed=0, device="cpu")
    params = params._replace(texture=5.0 * params.texture)
    return write_nerfstudio_dataset(tmp_path / "data", cfg, params, buffers,
                                    views, height, width)


def test_train_cli_dtu_on_the_v1_tier(tmp_path, one_thread, monkeypatch):
    """Three steps of ``gstex-dtu-nvs --renderer pallas1 --init-ply`` on
    the CPU, on a nerfstudio dataset with masks: every training render
    goes to ``rasterize_pl`` version 1 with its view's mask in the loss,
    every eval render (the step-0 and step-2 images, the closing pass's
    warm-up render and the interval split's 2 views) to the dense-list
    eval path; the loss is finite and
    falls, and ``--set`` reaches the config."""
    import json

    paths = dtu_dataset(tmp_path)
    calls, masks = [], []
    for name in ("rasterize_pl", "rasterize_pl_eval"):
        real = getattr(tmodel, name)
        monkeypatch.setattr(
            tmodel, name,
            lambda *a, _real=real, _name=name, **k: (
                calls.append((_name, k.get("version"))), _real(*a, **k))[1])
    real_loss = tmodel.loss_fn
    monkeypatch.setattr(tmodel, "loss_fn", lambda *a, **k: (
        masks.append(k.get("mask")), real_loss(*a, **k))[1])
    out = tmp_path / "run"
    res = ttrain.main(["gstex-dtu-nvs", "--data", str(paths["transforms"]
                                                      .parent),
                       "--init-ply", str(paths["init_ply"]),
                       "--renderer", "pallas1", "--max-num-iterations", "3",
                       "--set", "model.pixel_num=2e4",
                       "--set", "trainer.steps_per_eval_image=2",
                       "--output-dir", str(out), "--device", "cpu"])
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert all(h["overflow"] == 0 for h in hist)
    assert res["eval"]["psnr"] > 20
    assert (out / "checkpoints").is_dir()
    assert sorted(calls) == sorted([("rasterize_pl", 1)] * 3
                                   + [("rasterize_pl_eval", None)] * 5)
    assert all(m is not None and m.shape[-1] == 1 for m in masks)
    assert 0 < float(masks[0].mean()) < 1
    run = json.loads((out / "config.json").read_text())
    assert run["model"]["pixel_num"] == 2e4
    assert run["model"]["renderer"] == "pallas1"
    assert run["trainer"]["steps_per_eval_image"] == 2
    assert run["dataparser"] == "nerfstudio"
    # the seed ply's surfels, mapped back from COLMAP axes onto the scene
    assert run["num_gaussians"] == 300


def test_train_cli_schedule_on_a_distorted_jpeg_capture(tmp_path, one_thread,
                                                        monkeypatch):
    """``gstex-dtu-nvs`` on a capture of JPEG frames through an OPENCV
    lens, under ``num_downscales=1, resolution_schedule=2``: the frames
    are undistorted at load, steps 0 and 1 train on frames at half size,
    step 2 at full size, and the loss stays finite."""
    from gstex_torch.data.synthetic import write_nerfstudio_dataset
    from gstex_torch.train import trainer as ttrainer

    stats = small_scene_npz(tmp_path / "scene.npz", n=300)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8),
                             background_color="black")
    params, buffers = load_scene_npz(cfg, stats, seed=0, device="cpu")
    paths = write_nerfstudio_dataset(
        tmp_path / "data", cfg, params, buffers, 6, 48, 64, masks=False,
        image_format="jpeg", distortion={"k1": -0.05, "k2": 0.01,
                                         "p1": 1e-3, "p2": -1e-3})
    assert all(p.suffix == ".jpg" for p in
               (tmp_path / "data" / "images_2").iterdir())
    sizes = []
    real = ttrainer.downscale
    monkeypatch.setattr(ttrainer, "downscale", lambda cam, img, m, d: (
        sizes.append((img.shape[:2], d)), real(cam, img, m, d))[1])
    res = ttrain.main(["gstex-dtu-nvs", "--data", str(paths["transforms"]
                                                      .parent),
                       "--init-ply", str(paths["init_ply"]),
                       "--renderer", "pallas", "--max-num-iterations", "3",
                       "--set", "model.pixel_num=2e4",
                       "--set", "model.num_downscales=1",
                       "--set", "model.resolution_schedule=2",
                       "--output-dir", str(tmp_path / "run"),
                       "--device", "cpu"])
    assert sizes == [((48, 64), 2)] * 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert len(res["history"]) == 3


def test_set_overrides_parse_and_refuse():
    from gstex_torch.configs.methods import get_method

    m = get_method("gstex-dtu-nvs")
    for spec in ("model.pixel_num=3e5", "model.chart_pad=[16,24]",
                 "model.background_color=white", "optim.xyz_lr_mult=2",
                 "trainer.log_every=5"):
        m = ttrain.apply_override(m, spec)
    assert m.model.pixel_num == 3e5 and m.model.chart_pad == (16, 24)
    assert m.model.background_color == "white"
    assert m.optim.xyz_lr_mult == 2 and m.trainer.log_every == 5
    for bad in ("model.pixel_num", "nope.x=1", "model.nope=1"):
        with pytest.raises(SystemExit):
            ttrain.apply_override(m, bad)


def test_init_npz_reads_what_jax_reads(tmp_path):
    """``--init-npz`` names the reference's point npz (xyz, colors,
    opacity, scaling, rotation) in both CLIs: the port's init builder and
    the JAX package's, given the same file, start from the same params."""
    import argparse

    from gstex_torch.configs.methods import get_method
    from gstex_tpu.configs import methods as jmethods
    from gstex_tpu.scripts import train as jtrain

    rng = np.random.default_rng(11)
    n = 200
    q = rng.standard_normal((n, 4)).astype(np.float32)
    np.savez(tmp_path / "init.npz",
             xyz=rng.standard_normal((n, 3)).astype(np.float32),
             colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
             opacity=rng.standard_normal((n, 1)).astype(np.float32),
             scaling=rng.uniform(-5, -3, (n, 3)).astype(np.float32),
             rotation=q / np.linalg.norm(q, axis=-1, keepdims=True))
    args = argparse.Namespace(
        init_ply=None, init_npz=str(tmp_path / "init.npz"),
        init_lod_ply=None, init_pcd=None, num_random=10, scene_npz=None,
        seed=0)
    parsed = argparse.Namespace(points_xyz=None, points_rgb=None)
    tp, tb = ttrain.build_model(args, get_method("gstex-dtu-nvs"), parsed,
                                torch.device("cpu"))
    jp, jb = jtrain.build_model(args, jmethods.get_method("gstex-dtu-nvs"),
                                parsed)
    assert tp.means.shape == (n, 3)
    for k, got in zip(tmodel.GStexParams._fields, tp):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tb.texture_hw.numpy(),
                                  np.asarray(jb.texture_hw))


@pytest.mark.parametrize("renderer", ["pallas4", "pallas3", "pallas2",
                                      "pallas1"])
def test_lean_training_equals_full_on_the_dense_list_tiers(renderer,
                                                           monkeypatch):
    """The JAX package's ``rasterize_pl`` always computes the normal and
    reg maps; the port's dense-list tiers skip them (lean) where the loss
    weighs them by a static 0. Nothing else reads them from a training
    render, so a step's loss and every gradient are the same either way,
    to the bit."""
    import test_torch_train as tt

    jp, jb = tt.scene_state(n=64, pad=(4, 4))
    cfg = tmodel.GStexConfig(renderer=renderer, chart_pad=(4, 4),
                             pair_cap=8192, s_max=64,
                             background_color="white")
    assert tmodel.lean_losses(cfg)
    from gstex_torch.models.convert import params_from_jax
    from gstex_torch.ops import camera as tcam
    from gstex_torch.data.synthetic import orbit_c2w

    f = 1.2 * max(tt.H, tt.W)
    cam = tcam.make_camera(f, f, tt.W / 2, tt.H / 2, tt.H, tt.W,
                           orbit_c2w(3.0, 0.3), device="cpu")
    image = torch.tensor(np.random.default_rng(5).uniform(
        0, 1, (tt.H, tt.W, 3)).astype(np.float32))
    runs = []
    for lean in (True, False):
        monkeypatch.setattr(tmodel, "lean_losses", lambda c, _l=lean: _l)
        tp, tb = params_from_jax(tt.to_np(jp), tt.to_np(jb), device="cpu")
        state = tstep.init_state(cfg, toptim.OptimConfig(), tp, tb)
        state.step = 1000
        out = tmodel.render(cfg, state.params, state.buffers, cam, 1000,
                            torch.ones(3))
        loss, _ = tmodel.loss_fn(cfg, out, image, 1000)
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in state.params],
                     float(out["reg"].detach().abs().max())))
    (loss_l, grads_l, reg_l), (loss_f, grads_f, reg_f) = runs
    assert reg_l == 0.0 < reg_f
    assert torch.equal(loss_l, loss_f)
    for k, (a, b) in enumerate(zip(grads_l, grads_f)):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), tmodel.GStexParams._fields[k]


def test_train_step_on_the_v1_tier_matches_jax():
    """One ``train_step`` under ``renderer="pallas1"`` (the v1 kernels'
    plain versions here) from the same params, camera and ground truth as
    JAX's ``make_train_step`` under its XLA tier, at
    ``test_torch_train.py``'s tolerances: the loss within 1e-5 relative,
    each leaf's update over its lr at atol 1e-3 but where the gradient is
    below 1e-6 of its leaf's largest (at most 1e-3 of the elements)."""
    import jax
    import jax.numpy as jnp

    import test_torch_train as tt
    from gstex_torch.data.synthetic import orbit_c2w
    from gstex_torch.models.convert import params_from_jax
    from gstex_torch.ops import camera as tcam
    from gstex_tpu.models import gstex as jmodel
    from gstex_tpu.ops import camera as jcam
    from gstex_tpu.train import optim as joptim
    from gstex_tpu.train import step as jstep

    jp, jb = tt.scene_state(n=64, pad=(4, 4))
    cfg_kw = dict(chart_pad=(4, 4), pair_cap=8192, s_max=64,
                  background_color="black", fix_init=True)
    jcfg = jmodel.GStexConfig(renderer="xla", **cfg_kw)
    tcfg = tmodel.GStexConfig(renderer="pallas1", **cfg_kw)
    ocfg = dict(max_steps=15000, spatial_scale=2.0)
    c2w = orbit_c2w(3.0, 0.3)
    f = 1.2 * max(tt.H, tt.W)
    rng = np.random.default_rng(6)
    image = rng.uniform(0, 1, (tt.H, tt.W, 3)).astype(np.float32)

    jp_np = tt.to_np(jp)
    tp, tb = params_from_jax(jp_np, tt.to_np(jb), device="cpu")
    jstate, tx = jstep.init_state(jcfg, joptim.OptimConfig(**ocfg), jp, jb,
                                  jax.random.key(0))
    jstate = jstate._replace(step=jnp.int32(1000))
    jcam_ = jcam.make_camera(f, f, tt.W / 2, tt.H / 2, tt.H, tt.W, c2w)
    jnew, jm = jstep.make_train_step(jcfg, tx)(jstate, jcam_,
                                               jnp.asarray(image))
    tstate = tstep.init_state(tcfg, toptim.OptimConfig(**ocfg), tp, tb)
    tstate.step = 1000
    tcam_ = tcam.make_camera(f, f, tt.W / 2, tt.H / 2, tt.H, tt.W, c2w,
                             device="cpu")
    tm = tstep.train_step(tcfg, toptim.OptimConfig(**ocfg), tstate, tcam_,
                          torch.tensor(image))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert tm["overflow"] == int(jm["overflow"]) == 0
    lrs = toptim.group_lrs(toptim.OptimConfig(**ocfg))
    for k, leaf in enumerate(tt.LEAVES):
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
