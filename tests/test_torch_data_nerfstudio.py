"""The nerfstudio data path of the port against gstex_tpu on the same
files: ``parse_nerfstudio`` (poses, intrinsics, the four eval modes,
``images_2/``, ``applied_transform``, each orientation and centring
method, pose scaling, seed points from ``ply_file_path`` and from COLMAP
``points3D.bin`` / ``.txt``, masks), the COLMAP readers, ``pose_utils``,
the PLY and PCD readers and writers; the PNG codec's grey and grey-alpha
images and masks against PIL; JPEG frames, lens distortion and the other
camera models loading, and a progressive JPEG refused.

The parsers are numpy in both packages, so everything but the float32
casts is held exactly (atol 0).
"""

import json
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gstex_torch.data import colmap as tcolmap
from gstex_torch.data import pose_utils as tpose
from gstex_torch.data.manager import FullImageCache
from gstex_torch.data.nerfstudio_parser import parse_nerfstudio
from gstex_torch.data.png import read_mask, read_png, to_grey, write_png
from gstex_torch.utils import ply as tply
from gstex_tpu.data import colmap as jcolmap
from gstex_tpu.data import pose_utils as jpose
from gstex_tpu.data.nerfstudio_parser import \
    parse_nerfstudio as jparse_nerfstudio
from gstex_tpu.utils import ply as jply

FIELDS = ("c2ws", "fx", "fy", "cx", "cy", "heights", "widths")


def ring_poses(n=10, center=(0.5, -0.3, 1.2), radius=3.0, tilt=0.4):
    """OpenGL c2w poses on a tilted ring, looking at ``center``."""
    center = np.asarray(center)
    up = np.array([np.sin(tilt), 0.0, np.cos(tilt)])
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        o = center + radius * (np.cos(a) * np.array([0.0, 1.0, 0.0])
                               + np.sin(a) * np.cross(up, [0.0, 1.0, 0.0])
                               + (0.6 + 0.1 * np.sin(2 * a)) * up)
        fwd = (center - o) / np.linalg.norm(center - o)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], -1)
        c2w[:3, 3] = o
        poses.append(c2w)
    return np.stack(poses)


def points(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)),
            rng.integers(0, 256, (n, 3)).astype(np.uint8))


def write_points3d_bin(path, xyz, rgb):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(struct.pack("<QdddBBBd", i + 1, *p, *c, 0.5))
            track = 2 + i % 3
            f.write(struct.pack("<Q", track))
            f.write(struct.pack(f"<{2 * track}i", *range(2 * track)))


def write_points3d_text(path, xyz, rgb):
    lines = ["# 3D point list", "# POINT3D_ID, X, Y, Z, R, G, B, ERROR"]
    lines += [f"{i + 1} {' '.join(repr(float(v)) for v in p)} "
              f"{c[0]} {c[1]} {c[2]} 0.5 1 2 3 4"
              for i, (p, c) in enumerate(zip(xyz, rgb))]
    path.write_text("\n".join(lines) + "\n")


def write_dataset(root, n=10, seeds=None, names=None, per_frame=False,
                  applied=False, masks=False, downscaled=True, meta_extra=()):
    """A nerfstudio dataset of ``n`` 16x12 frames (and their 8x6
    ``images_2/`` copies): OPENCV intrinsics, per frame where
    ``per_frame``, an ``applied_transform``, masks, and seed points
    (``seeds``: "ply", "bin", "txt" or None)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir()
    if downscaled:
        (root / "images_2").mkdir()
    poses = ring_poses(n)
    rng = np.random.default_rng(1)
    frames = []
    for i in range(n):
        name = (names[i] if names else f"frame_{i:03d}") + ".png"
        write_png(root / "images" / name,
                  rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
        if downscaled:
            write_png(root / "images_2" / name,
                      rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
        fr = {"file_path": f"images/{name}",
              "transform_matrix": poses[i].tolist()}
        if per_frame:
            fr.update(fl_x=20.0 + i, fl_y=21.0 + i, cx=8.0 + 0.1 * i,
                      cy=6.0 - 0.1 * i)
        if masks and i % 3 != 2:
            (root / "masks").mkdir(exist_ok=True)
            write_png(root / "masks" / name,
                      rng.integers(0, 256, (6, 8), dtype=np.uint8))
            fr["mask_path"] = f"masks/{name}"
        frames.append(fr)
    meta = {"camera_model": "OPENCV", "fl_x": 20.0, "fl_y": 20.0, "cx": 8.0,
            "cy": 6.0, "w": 16, "h": 12, "k1": 0.0, "k2": 0.0, "p1": 0.0,
            "p2": 0.0, "frames": frames, **dict(meta_extra)}
    if applied:
        meta["applied_transform"] = [[0.0, 1.0, 0.0, 0.2],
                                     [1.0, 0.0, 0.0, -0.1],
                                     [0.0, 0.0, -1.0, 0.3]]
    xyz, rgb = points()
    if seeds == "ply":
        tply.write_ply(root / "sparse.ply", {
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
        meta["ply_file_path"] = "sparse.ply"
    elif seeds in ("bin", "txt"):
        model = root / "colmap" / "sparse" / "0"
        model.mkdir(parents=True)
        write = write_points3d_bin if seeds == "bin" else write_points3d_text
        write(model / f"points3D.{seeds}", xyz, rgb)
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def assert_parsed_equal(got, want):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert [str(p) for p in got.image_filenames] == \
        [str(p) for p in want.image_filenames]
    np.testing.assert_array_equal(got.dataparser_transform,
                                  want.dataparser_transform)
    assert got.dataparser_scale == want.dataparser_scale
    np.testing.assert_array_equal(got.distortion, want.distortion)
    assert got.camera_type == want.camera_type
    for k in ("points_xyz", "points_rgb"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got.mask_filenames is None) == (want.mask_filenames is None)
    if got.mask_filenames is not None:
        assert [str(p) for p in got.mask_filenames] == \
            [str(p) for p in want.mask_filenames]


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("mode,kw", [
    ("interval", dict(eval_interval=8)), ("interval", dict(eval_interval=3)),
    ("fraction", dict(train_split_fraction=0.7)), ("all", {})])
def test_eval_modes_and_downscale_match_jax(tmp_path, mode, kw, split):
    root = write_dataset(tmp_path / "d", per_frame=True)
    for d in (1, 2):
        args = dict(split=split, downscale_factor=d, eval_mode=mode, **kw)
        got = parse_nerfstudio(root, **args)
        assert_parsed_equal(got, jparse_nerfstudio(root, **args))
    assert all("images_2" in str(p) for p in got.image_filenames)
    assert got.points_xyz is None and got.mask_filenames is None


def test_filename_split_matches_jax(tmp_path):
    names = [f"{'eval' if i % 4 == 1 else 'train'}_{i:02d}" for i in range(8)]
    root = write_dataset(tmp_path / "d", n=8, names=names)
    for split in ("train", "test"):
        got = parse_nerfstudio(root, split=split, eval_mode="filename")
        assert_parsed_equal(got, jparse_nerfstudio(root, split=split,
                                                   eval_mode="filename"))
    assert len(got.image_filenames) == 2


@pytest.mark.parametrize("orient", ["none", "up", "pca", "vertical"])
@pytest.mark.parametrize("center", ["none", "poses", "focus"])
def test_pose_normalization_matches_jax(tmp_path, orient, center):
    """Each orientation and centring method, with pose scaling, an
    applied_transform and seed points carried through the same
    transform."""
    root = write_dataset(tmp_path / "d", seeds="ply", applied=True)
    args = dict(eval_mode="all", orientation_method=orient,
                center_method=center, auto_scale_poses=True,
                scale_factor=1.5)
    got = parse_nerfstudio(root, **args)
    assert_parsed_equal(got, jparse_nerfstudio(root, **args))
    assert np.abs(got.c2ws[:, :3, 3]).max() == pytest.approx(1.5, rel=1e-6)


@pytest.mark.parametrize("seeds", ["ply", "bin", "txt"])
def test_seed_points_and_masks_match_jax(tmp_path, seeds):
    root = write_dataset(tmp_path / "d", seeds=seeds, applied=True,
                         masks=True)
    for split in ("train", "test"):
        args = dict(split=split, downscale_factor=2, eval_mode="interval",
                    eval_interval=4)
        got = parse_nerfstudio(root, **args)
        assert_parsed_equal(got, jparse_nerfstudio(root, **args))
    assert got.points_xyz.shape == (40, 3)
    assert got.points_rgb.max() > 200
    assert any(m is None for m in got.mask_filenames)
    assert any(m is not None for m in got.mask_filenames)


def test_colmap_readers_match_jax(tmp_path):
    xyz, rgb = points(25, seed=3)
    write_points3d_bin(tmp_path / "points3D.bin", xyz, rgb)
    write_points3d_text(tmp_path / "points3D.txt", xyz, rgb)
    for reader, ext in (("read_points3d_bin", "bin"),
                        ("read_points3d_text", "txt")):
        path = tmp_path / f"points3D.{ext}"
        got = getattr(tcolmap, reader)(path)
        want = getattr(jcolmap, reader)(path)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(got[0], xyz)
        np.testing.assert_array_equal(got[1], rgb)
    got = tcolmap.read_points3d(tmp_path)
    np.testing.assert_array_equal(got[0], xyz)   # the .bin first
    with pytest.raises(FileNotFoundError):
        tcolmap.read_points3d(tmp_path / "none")


def test_pose_utils_match_jax():
    poses = ring_poses(12)
    a, b = np.array([0.3, -0.4, 0.9]), np.array([0.0, 0.0, 1.0])
    np.testing.assert_array_equal(tpose.rotation_matrix_between(a, b),
                                  jpose.rotation_matrix_between(a, b))
    np.testing.assert_array_equal(tpose.rotation_matrix_between(-b, b),
                                  jpose.rotation_matrix_between(-b, b))
    mean = poses[:, :3, 3].mean(0)
    np.testing.assert_array_equal(tpose.focus_of_attention(poses, mean),
                                  jpose.focus_of_attention(poses, mean))
    for orient in ("none", "up", "pca", "vertical"):
        for center in ("none", "poses", "focus"):
            got = tpose.auto_orient_and_center_poses(poses, orient, center)
            want = jpose.auto_orient_and_center_poses(poses, orient, center)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    names = ["train_a.png", "eval_b.png", "train_c.png"]
    for g, w in zip(tpose.split_by_filename(names),
                    jpose.split_by_filename(names)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tpose.split_by_filename(["other.png"])
    with pytest.raises(ValueError):
        tpose.auto_orient_and_center_poses(poses, "nope", "none")


def gaussian_ply_fields(n=30, seed=0, rest=True):
    rng = np.random.default_rng(seed)
    f = {k: rng.standard_normal(n).astype(np.float32)
         for k in ("x", "y", "z", "opacity", "scale_0", "scale_1",
                   "scale_2", "rot_0", "rot_1", "rot_2", "rot_3",
                   "f_dc_0", "f_dc_1", "f_dc_2")}
    if rest:
        f.update({f"f_rest_{j}": rng.standard_normal(n).astype(np.float32)
                  for j in range(45)})
    return f


@pytest.mark.parametrize("fmt", ["binary", "ascii"])
def test_ply_readers_and_writer_match_jax(tmp_path, fmt):
    fields = gaussian_ply_fields()
    path = tmp_path / "g.ply"
    if fmt == "binary":
        tply.write_ply(path, fields)
        jply.write_ply(tmp_path / "j.ply", fields)
        assert path.read_bytes() == (tmp_path / "j.ply").read_bytes()
    else:
        names = list(fields)
        header = ["ply", "format ascii 1.0", f"element vertex 30"]
        header += [f"property float {k}" for k in names]
        header += ["element face 0", "property list uchar int vertex_indices",
                   "end_header"]
        rows = [" ".join(repr(float(fields[k][i])) for k in names)
                for i in range(30)]
        path.write_text("\n".join(header + rows) + "\n")
    got, want = tply.read_ply(path), jply.read_ply(path)
    assert list(got) == list(want) == list(fields)
    for k in fields:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], fields[k])
    for sh in (3, 1):
        if sh == 1:
            for j in range(9, 45):
                del fields[f"f_rest_{j}"]
            tply.write_ply(path, fields)
        g, w = tply.read_gaussian_ply(path, sh), jply.read_gaussian_ply(
            path, sh)
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    pts = {"x": fields["x"], "y": fields["y"], "z": fields["z"],
           "red": np.arange(30.0), "green": np.ones(30), "blue": np.zeros(30)}
    tply.write_ply(tmp_path / "p.ply", pts)
    for g, w in zip(tply.read_point_ply(tmp_path / "p.ply"),
                    jply.read_point_ply(tmp_path / "p.ply")):
        np.testing.assert_array_equal(g, w)
    (tmp_path / "x.ply").write_bytes(b"nope")
    with pytest.raises(ValueError, match="not a PLY"):
        tply.read_ply(tmp_path / "x.ply")


def test_pcd_reader_matches_jax(tmp_path):
    pts = np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0], [-1.0, -2.0, -3.0]],
                   np.float32)
    rgb = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    packed = ((rgb[:, 0].astype(np.uint32) << 16)
              | (rgb[:, 1].astype(np.uint32) << 8) | rgb[:, 2])
    hdr = ("VERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
           "COUNT 1 1 1 1\nWIDTH 3\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
           "POINTS 3\n")
    files = {
        "ascii.pcd": hdr + "DATA ascii\n" + "\n".join(
            f"{p[0]} {p[1]} {p[2]} {float(v)}"
            for p, v in zip(pts, packed)) + "\n",
        "binary.pcd": (hdr + "DATA binary\n").encode() + b"".join(
            struct.pack("<ffff", *p, v)
            for p, v in zip(pts, packed.view(np.float32))),
        "rgb.pcd": ("FIELDS x y z r g b\nSIZE 4 4 4 4 4 4\n"
                    "TYPE F F F F F F\nCOUNT 1 1 1 1 1 1\nPOINTS 3\n"
                    "DATA ascii\n" + "\n".join(
                        f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}"
                        for p, c in zip(pts, rgb)) + "\n"),
        "grey.pcd": ("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                     "POINTS 2\nDATA ascii\n0 0 0\n1 1 1\n"),
    }
    for name, body in files.items():
        path = tmp_path / name
        (path.write_bytes if isinstance(body, bytes) else path.write_text)(
            body)
        got, want = tply.read_pcd(path), jply.read_pcd(path)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        if name != "grey.pcd":
            np.testing.assert_array_equal(got[1], rgb.astype(np.float32))
    assert (got[1] == 127.0).all()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_grey_images_and_masks_match_pil(tmp_path, mode):
    """Grey and grey-alpha PNGs decode as PIL decodes them, and masks of
    every colour type threshold PIL's ``convert("L")`` at 127, as the
    JAX package's manager does."""
    rng = np.random.default_rng(len(mode))
    shape = (23, 31) if mode == "L" else (23, 31, len(mode))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img.reshape(-1)[:300] = 120 + np.arange(300) % 16   # near the threshold
    path = tmp_path / "m.png"
    Image.fromarray(img, mode).save(path)
    got = read_png(path)
    np.testing.assert_array_equal(got.reshape(img.shape), img)
    pil_l = np.asarray(Image.open(path).convert("L"))
    np.testing.assert_array_equal(to_grey(got), pil_l)
    np.testing.assert_array_equal(read_mask(path),
                                  (pil_l > 127).astype(np.uint8))
    write_png(tmp_path / "own.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path /
                                                        "own.png")), img)


def test_manager_loads_masks_and_refuses_what_it_cannot_load(tmp_path):
    root = write_dataset(tmp_path / "d", masks=True)
    parsed = parse_nerfstudio(root, downscale_factor=2, eval_mode="all")
    cache = FullImageCache.build(parsed, device="cpu")
    assert cache.images[0].shape == (6, 8, 3)
    assert cache.cameras[0].height == 6 and cache.cameras[0].width == 8
    for i, mf in enumerate(parsed.mask_filenames):
        _, _, m = cache.get(i)
        if mf is None:
            assert m is None
            continue
        want = (np.asarray(Image.open(mf).convert("L")) > 127)
        assert m.shape == (6, 8, 1) and m.dtype == torch.float32
        np.testing.assert_array_equal(m[..., 0].numpy(), want)

    # JPEG frames load as PIL decodes them; read_png still names a JPEG
    jpg = tmp_path / "f.jpg"
    Image.fromarray(np.arange(144, dtype=np.uint8).reshape(6, 8, 3)).save(
        jpg, quality=90)
    with pytest.raises(ValueError, match="JPEG"):
        read_png(jpg)
    jparsed = parse_nerfstudio(root, eval_mode="all")
    jparsed.image_filenames[0] = jpg
    got = FullImageCache.build(jparsed, device="cpu").images[0]
    np.testing.assert_array_equal(
        np.round(got.numpy() * 255).astype(np.uint8),
        np.asarray(Image.open(jpg).convert("RGB")))

    # lens distortion and the other camera models load (their images and
    # intrinsics against the JAX package: test_torch_undistort.py); a
    # progressive frame loads as PIL reads it, and what PIL refuses too
    # (a 12-bit stream) still raises
    dist = write_dataset(tmp_path / "dist", meta_extra={"k1": 0.1}.items())
    cache = FullImageCache.build(parse_nerfstudio(dist, eval_mode="all"),
                                 device="cpu")
    assert float(cache.cameras[0].fx) != pytest.approx(
        float(parse_nerfstudio(dist, eval_mode="all").fx[0]))
    for model in ("OPENCV_FISHEYE", "FISHEYE624", "EQUIRECTANGULAR"):
        cam = write_dataset(tmp_path / model,
                            meta_extra={"camera_model": model}.items())
        parsed = parse_nerfstudio(cam, eval_mode="all")
        assert parsed.camera_type == jparse_nerfstudio(
            cam, eval_mode="all").camera_type
        assert len(FullImageCache.build(parsed, device="cpu")) == len(
            parsed.image_filenames)
    Image.fromarray(np.arange(144, dtype=np.uint8).reshape(6, 8, 3)).save(
        jpg, quality=90, progressive=True)
    got = FullImageCache.build(jparsed, device="cpu").images[0]
    np.testing.assert_array_equal(
        np.round(got.numpy() * 255).astype(np.uint8),
        np.asarray(Image.open(jpg).convert("RGB")))
    from jpeg_streams import frame_only

    jpg.write_bytes(frame_only(0xC1, precision=12))
    with pytest.raises(ValueError, match="12-bit.*PIL refuses"):
        FullImageCache.build(jparsed, device="cpu")
