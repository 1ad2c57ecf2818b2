"""The port's interactive viewer (``gstex_torch/viewer/``) on the CPU: the
ten routes of the JAX package's ``tests/test_viewer.py`` against one
viewer served on a free port, a ``/frame`` that is the JPEG (quality 88,
``data/jpeg.py``) of the port's render of that camera, byte for byte, and
decodes back to the render within JPEG error (PSNR >= 35 dB), the render
panel's export rendered by ``scripts/render.py camera-path``, a trainer
with the viewer attached taking steps while frames are fetched (and
waiting while it is paused), and the ``--viewer`` flag and
``gstex-torch-viewer`` on a run. Every HTTP call has a timeout; the
resolution cap is 96 so that the CPU renders stay small."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gstex_torch.data import jpeg
from gstex_torch.data.png import read_image, read_png
from gstex_torch.data.synthetic import orbit_camera, write_blender_dataset
from gstex_torch.models import gstex as tmodel
from gstex_torch.models import init_io as tinit_io
from gstex_torch.models.convert import params_from_jax
from gstex_torch.scripts import render as trender
from gstex_torch.scripts import train as ttrain
from gstex_torch.scripts import viewer as tviewer
from gstex_torch.train import optim, step as train_step
from gstex_torch.viewer import server
from gstex_torch.viewer.server import Viewer
from test_torch_render import jax_params, scene_np, to_numpy
from test_torch_train_cli import small_scene_npz

CFG = dict(chart_pad=(4, 4), tile_h=8, tile_w=16, pair_cap=1 << 14,
           s_max=64, pixel_num=300, background_color="black")
MAX_RES = 96
TIMEOUT = 60
STEPS = 2
_BOUND = {}


def _post(path, payload, port=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port or _BOUND['port']}{path}",
        data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _get(path, port=None):
    """(status, content type, body)."""
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port or _BOUND['port']}{path}",
            timeout=TIMEOUT) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _img(body, tmp_path, name="frame.jpg"):
    """A frame's bytes decoded by the port (JPEG, by its signature)."""
    path = tmp_path / name
    path.write_bytes(body)
    return read_image(path)


def _frame(client="default", port=None, tries=300):
    for _ in range(tries):
        status, ctype, body = _get(f"/frame?client={client}", port)
        if status == 200:
            return ctype, body
        time.sleep(0.05)
    raise AssertionError(f"no frame for client {client}")


@pytest.fixture(scope="module")
def viewer():
    s = scene_np("random", n=32, pad=CFG["chart_pad"], seed=2)
    s["opacity_logits"] = s["opacity_logits"] + 2.0
    jp, jb = jax_params(s)
    params, buffers = params_from_jax(to_numpy(jp), to_numpy(jb),
                                      device="cpu")
    cfg = tmodel.GStexConfig(**CFG)
    state = train_step.init_state(cfg, optim.OptimConfig(), params, buffers)
    v = Viewer(cfg, lambda: state, port=0).start()
    v.max_res = MAX_RES
    _BOUND["port"] = v.port
    yield v
    v.close()
    assert not v.rsm.is_alive()


def _camera_dict(size=64, azimuth=0.0):
    cam = orbit_camera(size, size, dist=3.0, azimuth=azimuth, device="cpu")
    return {"fx": float(cam.fx), "fy": float(cam.fy), "cx": float(cam.cx),
            "cy": float(cam.cy), "height": size, "width": size,
            "c2w": cam.c2w.numpy().tolist()}


def test_page_and_state(viewer):
    status, ctype, html = _get("/")
    assert status == 200 and ctype == "text/html"
    assert "gstex-torch" in html.decode() and "Start Polyline" in html.decode()
    st = json.loads(_get("/state")[2])
    assert st["num_gaussians"] == 32 and st["texel_count"] > 0


def test_render_roundtrip(viewer, tmp_path):
    """A frame over HTTP is the JPEG at quality 88 of the port's eval
    render of the camera at the resolution cap, byte for byte, and the
    port's decoder reads it back to the render within JPEG error."""
    cd = _camera_dict()
    _post("/render", {"camera": cd, "output": "rgb", "client": "roundtrip"})
    ctype, body = _frame("roundtrip")
    assert ctype == "image/jpeg"
    img = _img(body, tmp_path)
    assert img.shape == (MAX_RES, MAX_RES, 3) and img.std() > 1.0
    st = viewer.get_state()
    with torch.no_grad():
        out = tmodel.render(viewer.cfg, st.params, st.buffers,
                            viewer._cam_from_dict(cd, MAX_RES), st.step,
                            torch.tensor(server.BACKGROUND), eval_only=True)
    want = (np.clip(out["rgb"].numpy(), 0, 1) * 255).astype(np.uint8)
    assert body == jpeg.encode(want, quality=88)
    mse = np.mean((img.astype(np.float64) - want) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 35.0


def test_pause_resume(viewer):
    assert _post("/control", {"action": "pause"})["paused"] is True
    assert _post("/control", {"action": "resume"})["paused"] is False


def test_paint_over_http(viewer):
    cam = _camera_dict()
    _post("/control", {"action": "set_line", "rgb": [0, 255, 0], "width": 3})
    _post("/control", {"action": "start_polyline", "camera": cam})
    _post("/control", {"action": "click", "x": 0.4, "y": 0.4})
    r = _post("/control", {"action": "click", "x": 0.6, "y": 0.6})
    assert r["polyline"] == 2
    _post("/control", {"action": "end_polyline"})
    assert json.loads(_get("/state")[2])["edits"] == 1
    canvas = viewer.edit_session.edits[0]["canvas"]
    assert canvas[..., 1].max() == 255 and canvas[..., 0].max() == 0
    tex = viewer.edit_texture
    assert tex is not None and tex.shape == viewer.get_state(
    ).params.texture.shape
    _post("/control", {"action": "undo"})
    assert json.loads(_get("/state")[2])["edits"] == 0
    assert viewer.edit_texture is None


def test_render_panel_keyframes_and_export(viewer, tmp_path):
    """Keyframes captured over HTTP, a camera_path.json exported, and that
    file rendered by the render CLI's ``camera-path`` mode."""
    viewer.out_dir = str(tmp_path)
    _post("/panel", {"action": "clear_keyframes"})
    for az in (0.0, 0.8, 1.6):
        r = _post("/panel", {"action": "add_keyframe",
                             "camera": _camera_dict(azimuth=az)})
    assert r["keyframes"] == 3
    r = _post("/panel", {"action": "export", "seconds": 2.0, "fps": 10,
                         "render_height": 32, "render_width": 48})
    spec = json.loads(open(r["path"]).read())
    assert spec["render_height"] == 32 and spec["render_width"] == 48
    assert len(spec["camera_path"]) == 20
    m0 = np.array(spec["camera_path"][0]["camera_to_world"]).reshape(4, 4)
    kf0 = np.array(spec["keyframes"][0]["matrix"]).reshape(-1, 4)
    np.testing.assert_allclose(m0[:3], kf0[:3], atol=1e-6)
    st = viewer.get_state()
    scene = tmp_path / "scene.npz"
    tinit_io.export_npz(scene, st.params, st.buffers)
    summary = trender.main([
        "camera-path", "--scene-npz", str(scene), "--camera-path-filename",
        r["path"], "--output-path", str(tmp_path / "frames"), "--device",
        "cpu"])
    frames = sorted((tmp_path / "frames").glob("frame_*.png"))
    assert len(summary) == len(frames) == 20
    assert read_png(frames[0]).shape[:2] == (32, 48)
    assert all(f["finite"] for f in summary)
    assert max(f["alpha_coverage"] for f in summary) > 0
    r = _post("/panel", {"action": "camera_path", "seconds": 1.0, "fps": 5})
    assert len(r["camera_path"]["camera_path"]) == 5


def test_control_panel_crop_and_colormap(viewer, tmp_path):
    d = _camera_dict()
    assert viewer.render(d, "accumulation", MAX_RES)[0]
    _post("/control", {"action": "set_crop", "enabled": True,
                       "min": [50, 50, 50], "max": [51, 51, 51]})
    st = json.loads(_get("/state")[2])
    assert st["crop"]["min"] == [50.0, 50.0, 50.0]
    cropped = _img(viewer.render(d, "accumulation", MAX_RES)[0], tmp_path)
    assert cropped.mean() < 4.0, "the crop box did not hide the scene"
    _post("/control", {"action": "set_crop", "enabled": False,
                       "min": [0, 0, 0], "max": [0, 0, 0]})
    full = _img(viewer.render(d, "accumulation", MAX_RES)[0], tmp_path)
    assert full.mean() > cropped.mean() + 2.0
    _post("/control", {"action": "set_colormap", "name": "turbo"})
    _post("/control", {"action": "set_max_res", "max_res": 192})
    st = json.loads(_get("/state")[2])
    assert st["colormap"] == "turbo" and st["max_res"] == 192
    assert viewer.rsm.pick_res(moving=False) == 192
    assert viewer.render(d, "depth", MAX_RES)[0]
    _post("/control", {"action": "set_max_res", "max_res": MAX_RES})
    _post("/control", {"action": "set_colormap", "name": "depth"})


def test_render_generation_interrupt(viewer):
    """A camera submitted after a banded render started abandons it; a
    render at the current generation completes."""
    gen0 = viewer.rsm.gen
    cd = _camera_dict(size=256)           # > BAND_ROWS: banded
    viewer.rsm.submit(_camera_dict(), "rgb")
    img, meta = viewer.render(cd, "rgb", 256, gen=gen0)
    assert img is None and meta.get("superseded") is True
    img2, meta2 = viewer.render(cd, "rgb", 256, gen=viewer.rsm.gen)
    assert img2 is not None and "superseded" not in meta2


def test_split_view(viewer, tmp_path):
    viewer.split_output = "depth"
    viewer.split_frac = 0.5
    try:
        cd = _camera_dict()
        rgb = _img(viewer.render(cd, "rgb", MAX_RES)[0], tmp_path)
        viewer.split_output = None
        plain = _img(viewer.render(cd, "rgb", MAX_RES)[0], tmp_path)
        half = MAX_RES // 2
        # left of the divider's JPEG blocks (16-pixel MCUs; the chroma
        # upsampling reads one chroma sample across), the frames agree
        np.testing.assert_array_equal(rgb[:, :half - 17],
                                      plain[:, :half - 17])
        assert not np.array_equal(rgb[:, half + 1:], plain[:, half + 1:])
        _post("/control", {"action": "set_split", "output": "accumulation",
                           "frac": 0.25})
        st = json.loads(_get("/state")[2])
        assert st["split"] == "accumulation"
        assert abs(st["split_frac"] - 0.25) < 1e-6
        _post("/control", {"action": "set_split", "output": None})
        assert json.loads(_get("/state")[2])["split"] is None
    finally:
        viewer.split_output = None


def test_output_name_routing(viewer):
    """Outputs the eval render lacks (uv, test, only_*) take the full eval
    image set; rgb, depth, accumulation and edit the eval render."""
    state = viewer.get_state()
    cam = viewer._cam_from_dict(_camera_dict(), 48)
    bg = torch.tensor([0.1, 0.1, 0.1])
    with torch.no_grad():
        fast = viewer._render_imgs(state.params, state.buffers, state.step,
                                   cam, bg, "edit")
        assert "uv" not in fast and np.array_equal(fast["edit"],
                                                   fast["rgb"])
        full = viewer._render_imgs(state.params, state.buffers, state.step,
                                   cam, bg, "uv")
        assert {"uv", "test", "only_rgb", "only_texture",
                "clean_normal_img", "edit"} <= set(full)
        assert not np.allclose(viewer._compose(full, "uv"),
                               viewer._compose(full, "rgb"))
        viewer.split_output = "uv"
        try:
            assert "uv" in viewer._render_imgs(state.params, state.buffers,
                                               state.step, cam, bg, "rgb")
        finally:
            viewer.split_output = None


def test_two_clients_interleave(viewer, tmp_path):
    cd = _camera_dict()
    _post("/render", {"camera": cd, "output": "rgb", "client": "A"})
    _post("/render", {"camera": cd, "output": "accumulation",
                      "client": "B"})
    a = _img(_frame("A")[1], tmp_path, "a.png")
    b = _img(_frame("B")[1], tmp_path, "b.png")
    assert a.shape[2] == 3 and b.shape[2] == 3
    assert not np.array_equal(a, b)
    gen_b = viewer.rsm.slot("B").gen
    _post("/render", {"camera": cd, "output": "rgb", "client": "A"})
    assert viewer.rsm.slot("B").gen == gen_b
    assert viewer.rsm.slot("A").gen > 0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A tiny Blender dataset and its scene file: 32x32, 2 train and 2
    test views of 300 surfels."""
    root = tmp_path_factory.mktemp("viewer_run")
    stats = small_scene_npz(root / "scene.npz", n=300)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8))
    params, buffers = tinit_io.load_scene_npz(cfg, stats, seed=0,
                                              device="cpu")
    write_blender_dataset(root / "data", cfg, params, buffers, 2, 32, 32)
    write_blender_dataset(root / "data", cfg, params, buffers, 2, 32, 32,
                          split="test", azimuth0=0.4)
    return root, stats


def _train_args(root, stats, out, steps):
    return ["gstex-blender-nvs", "--data", str(root / "data"),
            "--scene-npz", str(stats), "--max-num-iterations", str(steps),
            "--pixel-num", "2e4", "--steps-per-eval-image", "0",
            "--output-dir", str(out), "--device", "cpu"]


def test_trainer_with_viewer_trains_while_serving(data, monkeypatch):
    """``--viewer`` serves while the run trains: the trainer waits while
    the viewer is paused, then takes its steps while frames are fetched;
    the viewer is closed when training ends. Then ``gstex-torch-viewer``
    serves the run."""
    root, stats = data
    started = {}
    real_attach = ttrain.Trainer.attach_viewer

    def attach(self, port=7007):
        v = real_attach(self, port)
        v.max_res = MAX_RES
        v.paused = True
        started["viewer"], started["trainer"] = v, self
        return v
    monkeypatch.setattr(ttrain.Trainer, "attach_viewer", attach)
    out = root / "run"
    result = {}
    thread = threading.Thread(target=lambda: result.update(ttrain.main(
        _train_args(root, stats, out, STEPS) + ["--viewer", "--viewer-port",
                                            "0"])))
    thread.start()
    try:
        for _ in range(600):
            if "viewer" in started:
                break
            time.sleep(0.05)
        v, trainer = started["viewer"], started["trainer"]
        time.sleep(0.5)
        assert trainer.state.step == 0, "the trainer stepped while paused"
        st = json.loads(_get("/state", v.port)[2])
        assert st["paused"] is True and st["step"] == 0
        cd = _camera_dict(size=32)
        frames = 0
        while frames < 4:
            try:
                _post("/render", {"camera": cd, "output": "rgb",
                                  "client": f"c{frames}"}, v.port)
                _frame(f"c{frames}", v.port)
            except OSError:   # training ended and the viewer closed
                break
            frames += 1
            if frames == 1:
                _post("/control", {"action": "resume"}, v.port)
    finally:
        thread.join(timeout=300)
    assert not thread.is_alive()
    assert frames >= 1 and len(result["history"]) == STEPS
    assert v.closed and not v.rsm.is_alive()
    viewer = tviewer.start(["--load-config", str(out), "--port", "0",
                            "--device", "cpu"])
    try:
        viewer.max_res = MAX_RES
        st = json.loads(_get("/state", viewer.port)[2])
        assert st["step"] == STEPS and st["num_gaussians"] == 300
        _post("/render", {"camera": _camera_dict(size=32), "output": "test"},
              viewer.port)
        assert _frame(port=viewer.port)[0] == "image/jpeg"
    finally:
        viewer.close()
