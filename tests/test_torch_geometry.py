"""gstex_torch geometry ops against gstex_tpu on the same numpy inputs:
quaternions, SH, camera, ray–surfel intersection, chart sampling and
splat preparation. Tolerance atol 1e-6 / rtol 1e-5: both sides run the
same float32 formulas; only summation order inside the tiny products
differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import orbit_c2w, random_scene
from gstex_torch.ops import camera as tcam
from gstex_torch.ops import prepare as tprep
from gstex_torch.ops import quat as tquat
from gstex_torch.ops import sh as tsh
from gstex_torch.ops import surfel as tsurf
from gstex_tpu.ops import camera as jcam
from gstex_tpu.ops import prepare as jprep
from gstex_tpu.ops import quat as jquat
from gstex_tpu.ops import sh as jsh
from gstex_tpu.ops import surfel as jsurf

ATOL, RTOL = 1e-6, 1e-5
H, W = 64, 96


def close(a, b, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=msg)


def t(a):
    return torch.as_tensor(np.array(a))


def cameras(dist=3.0, azimuth=0.4):
    c2w = orbit_c2w(dist, azimuth)
    f = 1.2 * max(H, W)
    return (jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w),
            tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu"))


def test_quat(rng):
    q = rng.standard_normal((200, 4)).astype(np.float32) * 3.0
    close(tquat.normalize_quat(t(q)), jquat.normalize_quat(jnp.asarray(q)))
    close(tquat.quat_to_rotmat(t(q)), jquat.quat_to_rotmat(jnp.asarray(q)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_spherical_harmonics(rng, degree):
    dirs = rng.standard_normal((300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = rng.standard_normal((300, 16, 3)).astype(np.float32)
    close(tsh.eval_sh_bases(t(dirs)), jsh.eval_sh_bases(jnp.asarray(dirs)))
    close(tsh.spherical_harmonics(degree, t(dirs), t(coeffs)),
          jsh.spherical_harmonics(degree, jnp.asarray(dirs),
                                  jnp.asarray(coeffs)))
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)


def test_sh_rgb_conversions(rng):
    x = rng.uniform(-2, 2, (100, 3)).astype(np.float32)
    close(tsh.sh_to_rgb(t(x)), jsh.sh_to_rgb(jnp.asarray(x)))
    close(tsh.rgb_to_sh(t(x)), jsh.rgb_to_sh(jnp.asarray(x)))


@pytest.mark.parametrize("azimuth", [0.0, 2.1])
def test_camera(rng, azimuth):
    jc, tc = cameras(azimuth=azimuth)
    close(tcam.viewmat_from_c2w(tc.c2w), jcam.viewmat_from_c2w(jc.c2w))
    pts = rng.standard_normal((200, 3)).astype(np.float32)
    jxy, jz = jcam.project_points(jnp.asarray(pts),
                                  jcam.viewmat_from_c2w(jc.c2w), jc.intrins)
    txy, tz = tcam.project_points(t(pts), tcam.viewmat_from_c2w(tc.c2w),
                                  tc.intrins)
    close(txy, jxy, atol=1e-4)   # pixel units, ~1e2 magnitude
    close(tz, jz)
    px = rng.uniform(0, W, (50,)).astype(np.float32)
    py = rng.uniform(0, H, (50,)).astype(np.float32)
    close(tcam.pixel_ray_dirs(t(px), t(py), tc),
          jcam.pixel_ray_dirs(jnp.asarray(px), jnp.asarray(py), jc))
    q = rng.standard_normal((200, 4)).astype(np.float32)
    l0 = rng.uniform(0.01, 0.2, 200).astype(np.float32)
    l1 = rng.uniform(0.01, 0.2, 200).astype(np.float32)
    jout = jcam.surfel_aabb_2d(jnp.asarray(pts), jnp.asarray(l0),
                               jnp.asarray(l1),
                               jquat.quat_to_rotmat(jnp.asarray(q)),
                               jcam.viewmat_from_c2w(jc.c2w), jc.intrins)
    tout = tcam.surfel_aabb_2d(t(pts), t(l0), t(l1),
                               tquat.quat_to_rotmat(t(q)),
                               tcam.viewmat_from_c2w(tc.c2w), tc.intrins)
    for a, b in zip(tout, jout):
        close(a, b, atol=1e-3)   # pixel units, projected from 3σ corners


def _geoms():
    """The same prepared splats in both packages (JAX prepare on the
    port's numpy scene)."""
    scene = {k: v.numpy() for k, v in
             random_scene(120, chart_pad=(4, 4), seed=3,
                          device="cpu").items()}
    jc, tc = cameras()
    jp = jprep.prepare_splats(
        *(jnp.asarray(scene[k]) for k in (
            "means", "log_scales", "quats", "opacity_logits", "features_dc",
            "features_rest", "mappings")), jc, active_sh_degree=3)
    geom_np = [np.asarray(x) for x in jp.geom]
    return (scene, jc, tc, jp, jsurf.SplatGeom(*map(jnp.asarray, geom_np)),
            tsurf.SplatGeom(*map(t, geom_np)))


def test_intersect(rng):
    _, jc, tc, _, jg, tg = _geoms()
    px = rng.uniform(0, W, (40, 1, 2)).astype(np.float32)
    dirs = np.asarray(jcam.pixel_ray_dirs(jnp.asarray(px[..., 0]),
                                          jnp.asarray(px[..., 1]), jc))
    origin = np.asarray(jcam.camera_origin(jc.c2w))
    jr = jsurf.intersect(jg, jnp.asarray(origin), jnp.asarray(dirs),
                         jnp.asarray(px))
    tr = tsurf.intersect(tg, t(origin), t(dirs), t(px))
    for k in ("t", "uv", "n_eff"):
        close(tr[k], jr[k], atol=1e-5, msg=k)
    close(tr["alpha"], jr["alpha"], atol=1e-5, msg="alpha")


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (8, 8)])
def test_chart_sample_bilinear(rng, hw):
    chart = rng.standard_normal((8, 8, 3)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (64, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    close(tsurf.chart_sample_bilinear(t(chart), hw[0], hw[1], t(uv)),
          jsurf.chart_sample_bilinear(jnp.asarray(chart), hw[0], hw[1],
                                      jnp.asarray(uv)))


def test_prepare_splats():
    scene, jc, tc, jp, _, _ = _geoms()
    tp = tprep.prepare_splats(
        *(t(scene[k]) for k in (
            "means", "log_scales", "quats", "opacity_logits", "features_dc",
            "features_rest", "mappings")), tc, active_sh_degree=3)
    for name, a, b in zip(tsurf.SplatGeom._fields, tp.geom, jp.geom):
        atol = 1e-4 if name == "xy" else ATOL
        close(a, b, atol=atol, msg=name)
    close(tp.depths, jp.depths)
    close(tp.centers, jp.centers, atol=1e-3)
    close(tp.extents, jp.extents, atol=1e-3)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
