"""Pose preprocessing: auto-orientation, centring, the filename split
(counterpart of ``gstex_tpu/data/pose_utils.py``, whose numpy code this
module copies).

Re-implements the reference ``camera_utils.auto_orient_and_center_poses``
(``nerfstudio/cameras/camera_utils.py:522-630``), ``focus_of_attention``
(:484) and ``rotation_matrix`` (:456) used by the Nerfstudio dataparser's
pose normalization (``nerfstudio_dataparser.py:236-254``). The gstex method
configs run with orientation and centring "none" and no pose scaling; the
other methods are the parser's public surface.

numpy on the host, once at parse time.
"""

from __future__ import annotations

import numpy as np


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit-ish vector a to b (Rodrigues; reference
    ``camera_utils.rotation_matrix``)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-8:
        # exactly opposite: perturb deterministically (the reference uses
        # random noise; determinism is friendlier to tests/reproducibility)
        eps = np.array([0.0043, -0.0017, 0.0029])
        return rotation_matrix_between(a + eps, b)
    s = float(np.linalg.norm(v))
    skew = np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])
    if s == 0.0:
        return np.eye(3)
    return np.eye(3) + skew + skew @ skew * ((1 - c) / (s * s))


def focus_of_attention(poses: np.ndarray, initial_focus: np.ndarray) -> np.ndarray:
    """Closest point to the cameras' optical axes (reference
    ``camera_utils.focus_of_attention``): iteratively solve the least-squares
    line-intersection over cameras that face the current estimate."""
    active_directions = -poses[:, :3, 2:3]        # (M,3,1) look dirs
    active_origins = poses[:, :3, 3:4]
    focus_pt = initial_focus
    active = np.sum(active_directions[..., 0] * (focus_pt - active_origins[..., 0]),
                    axis=-1) > 0
    done = False
    while int(active.sum()) > 1 and not done:
        active_directions = active_directions[active]
        active_origins = active_origins[active]
        m = np.eye(3) - active_directions * np.transpose(active_directions, (0, 2, 1))
        mt_m = np.transpose(m, (0, 2, 1)) @ m
        focus_pt = np.linalg.inv(mt_m.mean(0)) @ (mt_m @ active_origins).mean(0)[:, 0]
        active = np.sum(active_directions[..., 0]
                        * (focus_pt - active_origins[..., 0]), axis=-1) > 0
        if active.all():
            done = True
    return focus_pt


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
) -> tuple[np.ndarray, np.ndarray]:
    """Orient/center camera-to-world poses (reference semantics).

    Args:
        poses: (M,4,4) c2w, OpenGL convention (+y up in camera frame).
        method: "pca" | "up" | "vertical" | "none".
        center_method: "poses" | "focus" | "none".
    Returns:
        (oriented (M,3,4), transform (3,4)) with
        ``oriented = transform @ poses``.
    """
    poses = np.asarray(poses, np.float64)
    origins = poses[:, :3, 3]
    mean_origin = origins.mean(0)
    translation_diff = origins - mean_origin

    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"Unknown center_method {center_method}")

    if method == "pca":
        _, eigvec = np.linalg.eigh(translation_diff.T @ translation_diff)
        eigvec = eigvec[:, ::-1].copy()
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate(
            [eigvec, eigvec @ -translation[:, None]], axis=-1)
        oriented = transform @ poses
        if oriented.mean(0)[2, 1] < 0:
            oriented[:, 1:3] = -oriented[:, 1:3]
    elif method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        if method == "vertical":
            x_axis_matrix = poses[:, :3, 0]
            _, S, Vh = np.linalg.svd(x_axis_matrix, full_matrices=False)
            if S[1] > 0.17 * np.sqrt(poses.shape[0]):
                up_vertical = Vh[2, :]
                up = up_vertical if np.dot(up_vertical, up) > 0 else -up_vertical
            else:
                up = up - Vh[0, :] * np.dot(up, Vh[0, :])
                up = up / np.linalg.norm(up)
        rotation = rotation_matrix_between(up, np.array([0.0, 0.0, 1.0]))
        transform = np.concatenate(
            [rotation, rotation @ -translation[:, None]], axis=-1)
        oriented = transform @ poses
    elif method == "none":
        transform = np.eye(4)[:3]
        transform = transform.copy()
        transform[:3, 3] = -translation
        oriented = transform @ poses
    else:
        raise ValueError(f"Unknown orientation method {method}")

    return oriented.astype(np.float64), transform


def split_by_filename(basenames: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """eval_mode="filename": frames carrying "train"/"eval" in their basename
    (reference ``dataparsers_utils.get_train_eval_split_filename``)."""
    i_train, i_eval = [], []
    for idx, b in enumerate(basenames):
        if "train" in b:
            i_train.append(idx)
        elif "eval" in b:
            i_eval.append(idx)
        else:
            raise ValueError(
                "frame should contain train/eval in its name to use "
                "eval_mode='filename'")
    return np.array(i_train, int), np.array(i_eval, int)
