"""nerfstudio ``transforms.json`` datasets (COLMAP-processed captures such
as DTU): counterpart of ``gstex_tpu/data/nerfstudio_parser.py``, whose
numpy code this module copies.

Mirrors the reference Nerfstudio dataparser
(``nerfstudio/data/dataparsers/nerfstudio_dataparser.py:85+``) for the
settings the gstex configs use (``gstex_configs.py:119-127``):
``orientation_method="none"``, ``center_method="none"``,
``auto_scale_poses=False``, ``downscale_factor`` (the ``images_{d}/``
convention), eval modes fraction / interval / filename / all,
``applied_transform``, per-frame intrinsics, ``camera_model``,
``mask_path``, and 3D seed points from a referenced ply or
``colmap/points3D``, carried through the same transform as the poses.
Distortion coefficients and the camera type are carried on the result;
``data/manager.py`` decides what it can load.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..utils.ply import read_point_ply
from .blender import ParsedDataset
from .colmap import read_points3d
from .pose_utils import auto_orient_and_center_poses, split_by_filename


def _frame_val(meta, frame, key):
    return frame.get(key, meta.get(key))


def parse_nerfstudio(
    data_dir,
    split: str = "train",
    downscale_factor: int = 1,
    eval_mode: str = "interval",       # fraction | filename | interval | all
    train_split_fraction: float = 0.9,
    eval_interval: int = 8,
    load_3d_points: bool = True,
    orientation_method: str = "none",  # pca | up | vertical | none
    center_method: str = "none",       # poses | focus | none
    auto_scale_poses: bool = False,
    scale_factor: float = 1.0,
) -> ParsedDataset:
    """Parse a nerfstudio ``transforms.json`` dataset.

    Pose-normalization defaults match the gstex method configs
    (``gstex_configs.py:119-127``: everything off); the full reference
    option surface (``nerfstudio_dataparser.py:50-73,236-254``) is exposed:
    ``orientation_method``/``center_method`` run
    ``auto_orient_and_center_poses``, ``auto_scale_poses`` normalizes the
    max camera-origin norm to 1, ``scale_factor`` scales on top, and the
    resulting transform/scale are recorded on the output
    (``dataparser_transform``/``dataparser_scale``) and applied to seed
    points, exactly as ``_load_3D_points`` does.
    """
    data_dir = Path(data_dir)
    meta_path = data_dir / "transforms.json"
    if not meta_path.exists():
        meta_path = data_dir.parent / "transforms.json"
        data_dir = data_dir.parent
    meta = json.loads(meta_path.read_text())

    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
    filenames, poses = [], []
    fx, fy, cx, cy, hh, ww, dist = [], [], [], [], [], [], []
    for frame in frames:
        fp = Path(frame["file_path"])
        if downscale_factor > 1:
            # images_{d}/ convention (nerfstudio_dataparser.py:431)
            cand = data_dir / f"images_{downscale_factor}" / fp.name
            filenames.append(cand if cand.exists() else data_dir / fp)
        else:
            filenames.append(data_dir / fp)
        poses.append(np.array(frame["transform_matrix"], np.float64))
        fx.append(_frame_val(meta, frame, "fl_x"))
        fy.append(_frame_val(meta, frame, "fl_y"))
        cx.append(_frame_val(meta, frame, "cx"))
        cy.append(_frame_val(meta, frame, "cy"))
        hh.append(_frame_val(meta, frame, "h"))
        ww.append(_frame_val(meta, frame, "w"))
        if "FISHEYE624" in str(meta.get("camera_model", "")).upper():
            # 12 rad/tan/thin-prism coefficients (reference cameras.py:51,
            # camera_utils.py:641 param order k0..k5 p0 p1 s0..s3)
            dist.append([_frame_val(meta, frame, k) or 0.0
                         for k in ("k1", "k2", "k3", "k4", "k5", "k6",
                                   "p1", "p2", "s1", "s2", "s3", "s4")])
        else:
            dist.append([_frame_val(meta, frame, k) or 0.0
                         for k in ("k1", "k2", "k3", "k4", "p1", "p2")])
    poses = np.stack(poses)

    if "applied_transform" in meta:
        at = np.array(meta["applied_transform"], np.float64)
        if at.shape == (3, 4):
            at = np.concatenate([at, [[0, 0, 0, 1]]], 0)
        poses = np.einsum("ij,njk->nik", at, poses)

    # pose normalization (nerfstudio_dataparser.py:236-254); datasets may
    # override the orientation method via meta
    orient = meta.get("orientation_override", orientation_method)
    poses34, transform34 = auto_orient_and_center_poses(
        poses, method=orient, center_method=center_method)
    pose_scale = 1.0
    if auto_scale_poses:
        pose_scale /= float(np.max(np.abs(poses34[:, :3, 3])))
    pose_scale *= scale_factor
    poses34 = poses34.copy()
    poses34[:, :3, 3] *= pose_scale
    poses = np.concatenate(
        [poses34, np.broadcast_to(np.array([[[0., 0., 0., 1.]]]),
                                  (poses34.shape[0], 1, 4))], axis=1)

    m = len(filenames)
    # train/eval split (nerfstudio_dataparser.py eval_mode handling)
    idx = np.arange(m)
    if eval_mode == "all":
        sel = idx
    elif eval_mode == "interval":
        is_eval = idx % eval_interval == 0
        sel = idx[~is_eval] if split == "train" else idx[is_eval]
    elif eval_mode == "filename":
        i_train, i_eval = split_by_filename(
            [Path(f).name for f in filenames])
        sel = i_train if split == "train" else i_eval
    elif eval_mode == "fraction":
        n_train = int(np.ceil(m * train_split_fraction))
        train_idx = np.linspace(0, m - 1, n_train).round().astype(int)
        train_set = set(train_idx.tolist())
        if split == "train":
            sel = np.array(sorted(train_set))
        else:
            sel = np.array([i for i in idx if i not in train_set])
    else:
        raise ValueError(f"eval_mode {eval_mode}")

    scale = 1.0 / downscale_factor
    out = ParsedDataset(
        image_filenames=[filenames[i] for i in sel],
        c2ws=poses[sel][:, :3, :4].astype(np.float32),
        fx=np.array([fx[i] for i in sel], np.float32) * scale,
        fy=np.array([fy[i] for i in sel], np.float32) * scale,
        cx=np.array([cx[i] for i in sel], np.float32) * scale,
        cy=np.array([cy[i] for i in sel], np.float32) * scale,
        heights=(np.array([hh[i] for i in sel], np.int64) * scale).astype(np.int64),
        widths=(np.array([ww[i] for i in sel], np.int64) * scale).astype(np.int64),
    )
    out.dataparser_transform = transform34.astype(np.float32)
    out.dataparser_scale = float(pose_scale)
    out.distortion = np.array([dist[i] for i in sel], np.float32)
    # camera_model: OPENCV (perspective) | OPENCV_FISHEYE (equidistant)
    # (nerfstudio transforms.json convention; full_images_datamanager.py
    # branches undistortion on CameraType at 366-517)
    model = str(meta.get("camera_model", "OPENCV")).upper()
    if "FISHEYE624" in model:
        out.camera_type = "fisheye624"
        out.fisheye_crop_radius = float(meta.get("fisheye_crop_radius", 0.0))
    elif "FISHEYE" in model:
        out.camera_type = "fisheye"
    elif "EQUIRECTANGULAR" in model:
        out.camera_type = "equirectangular"
    else:
        out.camera_type = "perspective"
    if any("mask_path" in fr for fr in frames):
        out.mask_filenames = [
            (data_dir / frames[i]["mask_path"]) if "mask_path" in frames[i]
            else None
            for i in sel]

    if load_3d_points:
        pts = rgb = None
        if "ply_file_path" in meta:
            pts, rgb = read_point_ply(data_dir / meta["ply_file_path"])
        else:
            colmap_dir = data_dir / "colmap" / "sparse" / "0"
            if not colmap_dir.exists():
                colmap_dir = data_dir / "colmap"
            try:
                p64, r8 = read_points3d(colmap_dir)
                pts, rgb = p64.astype(np.float32), r8.astype(np.float32)
            except (FileNotFoundError, OSError):
                pass
        if pts is not None:
            if "applied_transform" in meta:
                at = np.array(meta["applied_transform"], np.float64)[:3]
                pts = pts @ at[:, :3].T + at[:, 3]
            # same normalization as the poses (_load_3D_points,
            # nerfstudio_dataparser.py:392-411)
            pts = (pts @ transform34[:, :3].T + transform34[:, 3]) * pose_scale
            out.points_xyz = pts.astype(np.float32)
            out.points_rgb = rgb
    return out
