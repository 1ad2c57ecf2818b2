"""PLY and PCD point files with numpy alone (counterpart of
``gstex_tpu/utils/ply.py``, whose numpy code this module copies: the port
imports nothing of the JAX package).

Covers the formats the reference consumes and produces: 2DGS gaussian
plys (``GStexModel.load_ply``, reference ``nerfstudio/models/gstex.py:
608-665``), point plys with red/green/blue (``load_from_lod_ply``,
``gstex.py:672``; a nerfstudio dataset's ``ply_file_path``), the
``gstex-ply`` exporter's output, and PCL ``.pcd`` point clouds. PLY:
ascii and binary_little_endian, element ``vertex`` only.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "<u2", "uint16": "<u2", "short": "<i2", "int16": "<i2",
    "uint": "<u4", "uint32": "<u4", "int": "<i4", "int32": "<i4",
}


def read_ply(path) -> dict[str, np.ndarray]:
    """Read the vertex element of a PLY file -> {property: (N,) array}."""
    data = Path(path).read_bytes()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    count = None
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError("list properties unsupported")
            props.append((tok[-1], _DTYPES[tok[1]]))
    if count is None:
        raise ValueError(f"{path}: no vertex element")

    if fmt == "ascii":
        arr = np.loadtxt(io.BytesIO(body), max_rows=count,
                         dtype=np.float64, ndmin=2)
        return {name: arr[:, i].astype(np.dtype(dt).base)
                for i, (name, dt) in enumerate(props)}
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported format {fmt}")
    dtype = np.dtype([(n, d) for n, d in props])
    arr = np.frombuffer(body, dtype=dtype, count=count)
    return {n: np.ascontiguousarray(arr[n]) for n, _ in props}


def write_ply(path, fields: dict[str, np.ndarray]):
    """Write a binary_little_endian vertex-only PLY."""
    names = list(fields)
    n = len(fields[names[0]])
    dtype = np.dtype([(k, "<f4") for k in names])
    arr = np.empty(n, dtype=dtype)
    for k in names:
        arr[k] = np.asarray(fields[k], np.float32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {k}" for k in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(arr.tobytes())


def read_gaussian_ply(path, sh_degree: int = 3):
    """Parse a 2DGS/3DGS gaussian ply into raw parameter arrays
    (``gstex.py:608-648`` field conventions). Returns a dict with
    means (N,3), features_dc (N,3), features_rest (N,K-1,3), opacity (N,1),
    scales (N,S) log-scales, quats (N,4) wxyz."""
    v = read_ply(path)
    n = v["x"].shape[0]
    means = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], 1).astype(np.float32)
    rest_names = sorted((k for k in v if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    k_rest = (sh_degree + 1) ** 2 - 1
    if rest_names:
        assert len(rest_names) == 3 * k_rest, (len(rest_names), k_rest)
        rest = np.stack([v[k] for k in rest_names], 1).astype(np.float32)
        # stored as (3, K-1) flattened channel-major (gstex.py:629): reshape
        # then transpose to (N, K-1, 3)
        rest = rest.reshape(n, 3, k_rest).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, k_rest, 3), np.float32)
    opacity = np.asarray(v["opacity"], np.float32).reshape(n, 1)
    scale_names = sorted((k for k in v if k.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    scales = np.stack([v[k] for k in scale_names], 1).astype(np.float32)
    rot_names = sorted((k for k in v if k.startswith("rot")),
                       key=lambda s: int(s.split("_")[-1]))
    quats = np.stack([v[k] for k in rot_names], 1).astype(np.float32)
    return {"means": means, "features_dc": dc, "features_rest": rest,
            "opacity": opacity, "scales": scales, "quats": quats}


def read_point_ply(path):
    """Read an xyz+rgb point cloud ply (``load_from_lod_ply``,
    ``gstex.py:672-694``). Returns (points (N,3) f32, colors (N,3) f32 0-255)."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    cols = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)
    return pts, cols


def read_pcd(path):
    """Read a PCL ``.pcd`` point cloud (ascii or binary; fields x y z and
    optionally packed ``rgb`` or separate r/g/b) — the reference reads pcd
    init files via open3d (``load_from_file``, ``gstex.py:697``); this is a
    dependency-free reader covering the common PCD layouts.

    Returns (points (N,3) f32, colors (N,3) f32 0-255; colors default to
    mid-gray when the file has no color field)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = [s.lower() for s in header["FIELDS"]]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(s) for s in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()
        np_type = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1",
                   ("U", 2): "u2", ("U", 4): "u4", ("I", 1): "i1",
                   ("I", 2): "i2", ("I", 4): "i4"}
        dtype = np.dtype([
            (name if c == 1 else name, f"{np_type[(t, s)]}"
             if c == 1 else (np_type[(t, s)], (c,)))
            for name, s, t, c in zip(fields, sizes, types, counts)])
        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            data = np.atleast_2d(data)
            cols = {}
            i = 0
            for name, c in zip(fields, counts):
                cols[name] = data[:, i] if c == 1 else data[:, i:i + c]
                i += c
            pts = np.stack([cols["x"], cols["y"], cols["z"]],
                           1).astype(np.float32)
            rgb_raw = cols.get("rgb")
            if rgb_raw is not None:
                vals = np.asarray(rgb_raw, np.float64)
                if (vals >= 0).all() and (vals == np.round(vals)).all() \
                        and (vals < 2 ** 32).all():
                    # packed uint printed as a decimal (common ascii form)
                    packed = vals.astype(np.uint32)
                else:
                    # float bit-pattern form
                    packed = vals.astype(np.float32).view(np.uint32)
            else:
                packed = None
        elif mode == "binary":
            data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype,
                                 count=n)
            pts = np.stack([data["x"], data["y"], data["z"]],
                           1).astype(np.float32)
            if "rgb" in fields:
                packed = np.ascontiguousarray(
                    data["rgb"]).view(np.uint32).reshape(-1)
            else:
                packed = None
        else:
            raise ValueError(f"unsupported PCD DATA mode {mode!r} "
                             f"(ascii/binary)")
        if packed is not None:
            colors = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                               packed & 0xFF], 1).astype(np.float32)
        elif all(k in fields for k in ("r", "g", "b")):
            if mode == "ascii":
                colors = np.stack([cols["r"], cols["g"], cols["b"]],
                                  1).astype(np.float32)
            else:
                colors = np.stack([data["r"], data["g"], data["b"]],
                                  1).astype(np.float32)
        else:
            colors = np.full((pts.shape[0], 3), 127.0, np.float32)
        return pts, colors
