"""Render panel: keyframed camera paths authored in the viewer
(counterpart of ``gstex_tpu/viewer/render_panel.py``).

Keyframes are captured from the live viewer camera, interpolated with a
Catmull-Rom position spline and piecewise quaternion slerp, and exported
in the nerfstudio ``camera_path.json`` schema that ``gstex_torch.scripts.
render camera-path`` reads (``scripts/render.py:camera_path_cameras``).
Host-side numpy only.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


def _quat_from_mat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _mat_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def _catmull_rom(p0, p1, p2, p3, t):
    """Centripetal-ish (uniform) Catmull-Rom point between p1 and p2."""
    t2, t3 = t * t, t * t * t
    return 0.5 * ((2 * p1) + (-p0 + p2) * t
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)


def interpolate_keyframes(c2ws: list, n_frames: int) -> list:
    """Smooth (4, 4) camera-to-world path through the keyframes: Catmull-Rom
    positions + piecewise slerp orientations."""
    c2ws = [np.asarray(c, np.float64).reshape(-1, 4)[:3] for c in c2ws]
    if len(c2ws) == 1:
        c2ws = c2ws * 2
    pos = np.stack([c[:, 3] for c in c2ws])
    quats = [_quat_from_mat(c[:, :3]) for c in c2ws]
    n_seg = len(c2ws) - 1
    out = []
    for f in range(n_frames):
        u = f / max(n_frames - 1, 1) * n_seg
        s = min(int(u), n_seg - 1)
        t = u - s
        p = _catmull_rom(pos[max(s - 1, 0)], pos[s], pos[s + 1],
                         pos[min(s + 2, n_seg)], t)
        r = _mat_from_quat(_slerp(quats[s], quats[s + 1], t))
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = p
        out.append(m)
    return out


class RenderPanel:
    """Keyframe list + camera_path.json authoring."""

    def __init__(self):
        self.keyframes: list[dict] = []    # viewer camera dicts

    def add(self, cam_dict: dict):
        self.keyframes.append(dict(cam_dict))

    def remove(self, index: int):
        if 0 <= index < len(self.keyframes):
            self.keyframes.pop(index)

    def clear(self):
        self.keyframes = []

    def camera_path(self, seconds: float = 4.0, fps: int = 24,
                    render_height: int = 1080,
                    render_width: int = 1920) -> dict:
        """The nerfstudio camera_path.json payload
        (``render_panel.py`` export format consumed by ns-render)."""
        if not self.keyframes:
            raise ValueError("no keyframes captured")
        n_frames = max(int(round(seconds * fps)), 1)
        c2ws = [np.array(k["c2w"], np.float64) for k in self.keyframes]
        path = interpolate_keyframes(c2ws, n_frames)
        kf0 = self.keyframes[0]
        fov = float(np.rad2deg(
            2 * np.arctan(0.5 * kf0["height"] / kf0["fy"])))
        frames = [{
            "camera_to_world": m.reshape(-1).tolist(),
            "fov": fov,
            "aspect": render_width / render_height,
        } for m in path]
        return {
            "camera_type": "perspective",
            "render_height": render_height,
            "render_width": render_width,
            "camera_path": frames,
            "fps": fps,
            "seconds": seconds,
            "keyframes": [{
                "matrix": np.array(k["c2w"], np.float64)
                .reshape(-1).tolist(),
                "fov": fov,
            } for k in self.keyframes],
        }

    def export(self, out_dir, seconds: float = 4.0, fps: int = 24,
               render_height: int = 1080, render_width: int = 1920) -> str:
        """Write camera_path.json (timestamped like the reference's
        ``camera_paths/<name>.json``); returns the path."""
        payload = self.camera_path(seconds, fps, render_height, render_width)
        out = Path(out_dir) / "camera_paths"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{time.strftime('%Y-%m-%d_%H%M%S')}.json"
        path.write_text(json.dumps(payload, indent=1))
        return str(path)
