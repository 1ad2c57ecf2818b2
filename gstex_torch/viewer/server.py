"""Interactive web viewer: live renders, training control, texture painting
(counterpart of ``gstex_tpu/viewer/server.py``).

A threaded HTTP server (standard library only) serves the embedded page
(``page.py``) and its routes: ``/render`` submits a camera, ``/frame``
returns the client's latest frame as a JPEG at quality 88 (``data/jpeg.py``,
as the JAX viewer's ``_to_jpeg`` sends it), ``/state`` the trainer's and
the viewer's state, ``/control`` pauses and resumes training, paints
polylines (``models/editing.py``), and sets the colormap, the resolution
cap, the split view and the crop box, ``/panel`` authors keyframed camera
paths (``render_panel.py``). One render thread (``RenderStateMachine``)
serves every client's latest camera, each in its own slot: a moving camera
renders at the largest resolution of ``RES_LADDER`` that keeps the target
rate, a settled one again at the cap; a tall frame renders in bands of
``BAND_ROWS`` rows, and a newer camera of the same client abandons it
between bands.

Every render and every replay of the edit stack holds the trainer's
``train_lock``, so none runs inside a training step, and runs under
``torch.no_grad`` (per thread: the render thread holds its own). Frames
come from the tier's eval kernel where the output is ``rgb``, ``depth``,
``accumulation`` or ``edit`` (the edited charts as the render's albedo);
the other outputs need ``render_eval_images``' maps from the pure-torch
tier.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data import jpeg
from ..models import editing, gstex as model
from ..ops.camera import make_camera
from .page import PAGE_HTML
from .render_panel import RenderPanel

RES_LADDER = [96, 192, 384, 768]
# the viewer's background, (3,)
BACKGROUND = (0.1490, 0.1647, 0.2157)


class _ClientSlot:
    """One client's render state: its pending job, its latest frame, and
    the generation counter a newer camera bumps."""

    def __init__(self):
        self.pending = None          # (camera_dict, output_name)
        self.result = None           # (jpeg_bytes, meta)
        self.gen = 0
        self.static_since = 0.0
        self.resettle = None         # (due_time, job) high-res re-render


class RenderStateMachine(threading.Thread):
    """Latest-camera-wins render thread with adaptive resolution."""

    def __init__(self, viewer):
        super().__init__(daemon=True)
        self.viewer = viewer
        self.wake = threading.Event()
        # guards the slots: HTTP handler threads write, this thread reads
        self.lock = threading.RLock()
        self.slots: dict = {}
        self.last_render_s = {r: 0.05 for r in RES_LADDER}
        self.target_fps = 12.0

    def slot(self, client: str = "default") -> _ClientSlot:
        with self.lock:
            s = self.slots.get(client)
            if s is None:
                s = self.slots[client] = _ClientSlot()
            return s

    # the single-client view (tests, embedding code)
    @property
    def gen(self) -> int:
        return self.slot().gen

    @property
    def result(self):
        return self.slot().result

    def submit(self, cam_dict, output_name, client: str = "default"):
        with self.lock:
            s = self.slot(client)
            # a banded render checks the generation between bands
            s.gen += 1
            s.pending = (cam_dict, output_name)
            s.static_since = time.time()
            s.resettle = None
        self.wake.set()

    def pick_res(self, moving: bool) -> int:
        ladder = [r for r in RES_LADDER if r <= self.viewer.max_res] \
            or RES_LADDER[:1]
        if not moving:
            return ladder[-1]
        # the largest resolution that still meets the target rate
        best = ladder[0]
        for r in ladder:
            if self.last_render_s[r] <= 1.0 / self.target_fps:
                best = r
        return best

    def _take_jobs(self):
        now = time.time()
        jobs = []
        with self.lock:
            for cid, s in self.slots.items():
                if s.pending is not None:
                    jobs.append((cid, s, s.pending, False))
                    s.pending = None
                elif s.resettle is not None and now >= s.resettle[0]:
                    job = s.resettle[1]
                    s.resettle = None
                    jobs.append((cid, s, job, True))
        return jobs

    def run(self):
        while not self.viewer.closed:
            self.wake.wait(timeout=0.1)
            self.wake.clear()
            for cid, s, job, settled in self._take_jobs():
                moving = (not settled
                          and time.time() - s.static_since < 0.35)
                res = self.pick_res(moving)
                try:
                    t0 = time.time()
                    img, meta = self.viewer.render(job[0], job[1], res,
                                                   gen=s.gen, client=cid)
                    if meta.get("superseded"):
                        continue   # a newer camera arrived mid-render
                    self.last_render_s[res] = time.time() - t0
                    with self.lock:
                        s.result = (img, meta)
                except Exception as e:  # the viewer outlives a bad frame
                    with self.lock:
                        s.result = (None, {"error": repr(e)})
                if moving:
                    # render again at the cap once the camera settles
                    with self.lock:
                        if s.pending is None:
                            s.resettle = (time.time() + 0.35, job)


class Viewer:
    """Owns the access to the model state, the render thread and the HTTP
    server. ``get_state()`` returns an object with ``params``, ``buffers``
    and ``step`` (the trainer's ``TrainState``)."""

    # rows per band of a tall frame: a newer camera waits one band
    BAND_ROWS = 128
    # outputs the forward-only eval render gives (``edit`` with the edited
    # charts as its albedo); the others need the full eval image set
    FAST_OUTPUTS = frozenset({"rgb", "depth", "accumulation", "edit", None})

    def __init__(self, cfg: model.GStexConfig, get_state, train_lock=None,
                 port: int = 7007, trainer=None, out_dir=None):
        self.cfg = cfg
        self.get_state = get_state
        self.train_lock = train_lock or threading.Lock()
        self.trainer = trainer
        self.closed = False
        self.paused = False
        self.edit_session = editing.EditSession(cfg)
        self.edit_texture = None
        self.current_polyline = []
        self.draw_camera = None
        self.line_rgb = (255, 0, 0)
        self.line_width = 5
        self.colormap = "depth"        # depth | turbo | gray
        self.max_res = RES_LADDER[-1]
        self.crop = None               # {"min": [3], "max": [3]} world box
        self.split_output = None       # the second output, None = off
        self.split_frac = 0.5
        self.panel = RenderPanel()
        self.out_dir = str(out_dir) if out_dir is not None else (
            str(trainer.out_dir) if trainer is not None else ".")
        self.rsm = RenderStateMachine(self)
        self.port = port
        self.httpd = None

    # -- rendering -----------------------------------------------------
    def _device(self):
        return self.get_state().params.means.device

    def _cam_from_dict(self, d, res):
        h, w = int(d["height"]), int(d["width"])
        scale = res / max(h, w)
        return make_camera(d["fx"] * scale, d["fy"] * scale,
                           d["cx"] * scale, d["cy"] * scale,
                           max(int(round(h * scale)), 8),
                           max(int(round(w * scale)), 8),
                           np.array(d["c2w"], np.float32),
                           device=self._device())

    def _crop_params(self, params):
        """Hide the gaussians outside the crop box by flooring their
        opacity logits."""
        if self.crop is None:
            return params
        dev = params.means.device
        lo = torch.tensor(self.crop["min"], dtype=torch.float32, device=dev)
        hi = torch.tensor(self.crop["max"], dtype=torch.float32, device=dev)
        inside = ((params.means >= lo) & (params.means <= hi)).all(
            -1, keepdim=True)
        return params._replace(opacity_logits=torch.where(
            inside, params.opacity_logits, -40.0))

    def _render_imgs(self, params, buffers, step, cam, bg,
                     output_name="rgb"):
        """The displayable images of one view, as numpy arrays: the eval
        render's where the outputs wanted are ``FAST_OUTPUTS``, else the
        full eval image set."""
        cmap = lambda d: _colormap(d, self.colormap)
        wanted = {output_name, self.split_output}
        if wanted <= self.FAST_OUTPUTS:
            out = model.render(self.cfg, params, buffers, cam, step, bg,
                               eval_only=True)
            imgs = {
                "rgb": out["rgb"],
                "depth": cmap(out["depth"]),
                "accumulation": out["alpha"][..., None].repeat(1, 1, 3),
            }
            if "edit" in wanted:
                imgs["edit"] = out["rgb"] if self.edit_texture is None else (
                    model.render(self.cfg, params, buffers, cam, step, bg,
                                 eval_only=True,
                                 albedo=self.edit_texture)["rgb"])
        else:
            imgs = model.render_eval_images(
                self.cfg, params, buffers, cam, step, bg,
                edit_texture=self.edit_texture)
            imgs["depth"] = cmap(imgs["depth"][..., 0])
            imgs["accumulation"] = imgs["accumulation"].repeat(1, 1, 3)
        return {k: np.asarray(v.detach().cpu()) if torch.is_tensor(v) else v
                for k, v in imgs.items()}

    def _band_cam(self, cam_dict, res, y0, rows):
        """The camera of rows [y0, y0 + rows) of the frame at ``res``: the
        same intrinsics with the principal point moved up by y0."""
        full = self._cam_from_dict(cam_dict, res)
        return make_camera(full.fx, full.fy, full.cx, full.cy - y0, rows,
                           full.width, full.c2w, device=full.c2w.device)

    def _compose(self, imgs, output_name):
        a = imgs.get(output_name, imgs["rgb"])
        if self.split_output:
            b = imgs.get(self.split_output, imgs["rgb"])
            col = int(np.clip(self.split_frac, 0.0, 1.0) * a.shape[1])
            a = a.copy()
            a[:, col:] = b[:, col:]
            a[:, max(col - 1, 0):col + 1] = 1.0   # the divider
        return a

    def render(self, cam_dict, output_name, res, gen=None,
               client: str = "default"):
        """``(jpeg_bytes, {"res", "step"})`` of the camera at ``res``, or
        ``(None, {"superseded": True})`` where a newer camera of the
        client arrived during a banded render."""
        state = self.get_state()
        full_cam = self._cam_from_dict(cam_dict, res)
        bg = torch.tensor(BACKGROUND, dtype=torch.float32,
                          device=full_cam.c2w.device)
        h = full_cam.height
        banded = h > self.BAND_ROWS and gen is not None
        stale = (lambda: gen is not None
                 and self.rsm.slot(client).gen != gen)
        with torch.no_grad(), self.train_lock:
            params = self._crop_params(state.params)
            if not banded:
                imgs = self._render_imgs(params, state.buffers, state.step,
                                         full_cam, bg, output_name)
                img = self._compose(imgs, output_name)
            else:
                rows_out = []
                y0 = 0
                while y0 < h:
                    if stale():
                        return None, {"superseded": True}
                    rows = min(self.BAND_ROWS, h - y0)
                    cam_b = self._band_cam(cam_dict, res, y0, rows)
                    imgs = self._render_imgs(params, state.buffers,
                                             state.step, cam_b, bg,
                                             output_name)
                    rows_out.append(self._compose(imgs, output_name))
                    y0 += rows
                if stale():
                    return None, {"superseded": True}
                img = np.concatenate(rows_out, axis=0)
        return to_jpeg(img), {"res": res, "step": int(state.step)}

    # -- painting ------------------------------------------------------
    def start_polyline(self, cam_dict):
        self.draw_camera = dict(cam_dict)
        self.current_polyline = []

    def add_click(self, x_frac, y_frac):
        if self.draw_camera is None:
            return
        h = int(self.draw_camera["height"])
        w = int(self.draw_camera["width"])
        self.current_polyline.append((int(w * x_frac), int(h * y_frac)))

    def end_polyline(self):
        if self.draw_camera is None or len(self.current_polyline) < 2:
            self.current_polyline = []
            return
        cam = self._cam_from_dict(self.draw_camera,
                                  max(int(self.draw_camera["height"]),
                                      int(self.draw_camera["width"])))
        self.edit_session.add_polyline(cam, self.current_polyline,
                                       rgb=self.line_rgb,
                                       width=self.line_width)
        self.current_polyline = []
        self._update_edit_texture()

    def undo_edit(self):
        self.edit_session.undo()
        self._update_edit_texture()

    def save_edits(self, out_dir="edits"):
        return str(self.edit_session.save(out_dir))

    def _update_edit_texture(self):
        """Replay the edit stack onto the current texture."""
        state = self.get_state()
        with self.train_lock:
            self.edit_session.cfg = self.cfg
            if self.edit_session.edits:
                self.edit_texture = self.edit_session.edit_texture(
                    state.params, state.buffers)
            else:
                self.edit_texture = None

    # -- server --------------------------------------------------------
    def state_json(self) -> dict:
        st = self.get_state()
        return {
            "step": int(st.step),
            "paused": self.paused,
            "num_gaussians": int(st.params.means.shape[0]),
            "texel_count": int(model.texel_count(st.buffers)),
            "edits": len(self.edit_session.edits),
            "keyframes": len(self.panel.keyframes),
            "colormap": self.colormap,
            "max_res": self.max_res,
            "crop": self.crop,
            "split": self.split_output,
            "split_frac": self.split_frac,
        }

    def control(self, body: dict) -> dict:
        """One ``/control`` action."""
        action = body.get("action")
        if action == "pause":
            self.paused = True
        elif action == "resume":
            self.paused = False
        elif action == "start_polyline":
            self.start_polyline(body["camera"])
        elif action == "click":
            self.add_click(body["x"], body["y"])
        elif action == "end_polyline":
            self.end_polyline()
        elif action == "undo":
            self.undo_edit()
        elif action == "save":
            self.save_edits()
        elif action == "set_line":
            self.line_rgb = tuple(body.get("rgb", self.line_rgb))
            self.line_width = int(body.get("width", self.line_width))
        elif action == "set_colormap":
            self.colormap = str(body.get("name", "depth"))
        elif action == "set_max_res":
            self.max_res = int(body.get("max_res", RES_LADDER[-1]))
        elif action == "set_split":
            out2 = body.get("output")
            self.split_output = str(out2) if out2 else None
            self.split_frac = float(body.get("frac", self.split_frac))
        elif action == "set_crop":
            self.crop = ({"min": [float(v) for v in body["min"]],
                          "max": [float(v) for v in body["max"]]}
                         if body.get("enabled", True) else None)
        return {"paused": self.paused,
                "polyline": len(self.current_polyline)}

    def panel_action(self, body: dict) -> dict:
        """One ``/panel`` action: keyframes and the camera path."""
        action = body.get("action")
        resp = {}
        path_args = dict(seconds=float(body.get("seconds", 4.0)),
                         fps=int(body.get("fps", 24)),
                         render_height=int(body.get("render_height", 1080)),
                         render_width=int(body.get("render_width", 1920)))
        if action == "add_keyframe":
            self.panel.add(body["camera"])
        elif action == "remove_keyframe":
            self.panel.remove(int(body.get("index", -1)))
        elif action == "clear_keyframes":
            self.panel.clear()
        elif action == "camera_path":
            resp["camera_path"] = self.panel.camera_path(**path_args)
        elif action == "export":
            resp["path"] = self.panel.export(self.out_dir, **path_args)
        resp["keyframes"] = len(self.panel.keyframes)
        return resp

    def start(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, PAGE_HTML.encode(), "text/html")
                elif self.path.startswith("/frame"):
                    q = parse_qs(urlparse(self.path).query)
                    cid = q.get("client", ["default"])[0]
                    r = viewer.rsm.slot(cid).result
                    if r is None or r[0] is None:
                        self._send(204, b"")
                    else:
                        self._send(200, r[0], "image/jpeg")
                elif self.path.startswith("/state"):
                    self._send(200, json.dumps(viewer.state_json()).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/render":
                    viewer.rsm.submit(body["camera"],
                                      body.get("output", "rgb"),
                                      client=body.get("client", "default"))
                    self._send(200, b"{}")
                elif self.path == "/control":
                    self._send(200, json.dumps(viewer.control(body)).encode())
                elif self.path == "/panel":
                    self._send(200,
                               json.dumps(viewer.panel_action(body)).encode())
                else:
                    self._send(404, b"{}")

        self.httpd = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        # port 0 asks the OS for a free port
        self.port = self.httpd.server_address[1]
        self.rsm.start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return self

    def close(self):
        """Stop the render thread and the server, and close its socket."""
        self.closed = True
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
        if self.rsm.is_alive():
            self.rsm.join(timeout=5.0)


def to_jpeg(img: np.ndarray) -> bytes:
    """A [0, 1] float frame as the JAX viewer's ``_to_jpeg`` sends it:
    clipped, scaled to uint8 by truncation, JPEG at quality 88."""
    return jpeg.encode((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8),
                       quality=88)


def _colormap(depth, name: str = "depth") -> np.ndarray:
    """Depth colourised: ``depth`` (blue to warm), ``turbo`` (a polynomial
    approximation of Google's turbo map) or ``gray``."""
    d = np.asarray(depth.detach().cpu() if torch.is_tensor(depth) else depth)
    lo, hi = d.min(), d.max()
    x = (d - lo) / (hi - lo + 1e-6)
    if name == "gray":
        rgb = np.stack([x, x, x], -1)
    elif name == "turbo":
        r = np.clip(1.61 * x - 0.43 + 0.34 * np.sin(6.5 * x - 3.6), 0, 1)
        g = np.clip(np.sin(np.pi * np.clip(x * 1.12 - 0.03, 0, 1)), 0, 1)
        b = np.clip(1.07 - 1.75 * x + 0.58 * np.sin(5.0 * x + 1.3), 0, 1)
        rgb = np.stack([r, g, b], -1)
    else:
        rgb = np.stack([x, x, 1.0 - x], -1)
    return rgb.astype(np.float32)
