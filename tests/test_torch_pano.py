"""Panoramas: ``ops/camera.py:ray_dirs_typed`` and ``ops/pano.py``
against the JAX package's on the same inputs (directions and cameras to
1e-6, the resample to 1e-5), and ``render_equirect`` / ``render_ods`` of
a small scene through the port's ``xla`` tier against JAX's XLA tier at
the render tests' tolerance (atol 5e-5), every face through one
``render`` call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import orbit_c2w
from gstex_torch.models import gstex as tmodel
from gstex_torch.models.convert import params_from_jax
from gstex_torch.ops import camera as tcam
from gstex_torch.ops import pano as tpano
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.ops import camera as jcam
from gstex_tpu.ops import pano as jpano
from test_torch_render import BG, jax_params, scene_np, to_numpy

C2W = orbit_c2w(3.0, 0.4)


@pytest.mark.parametrize("camera_type",
                         ["perspective", "fisheye", "equirectangular"])
def test_ray_dirs_typed_matches_jax(camera_type):
    h, w = 24, 48
    if camera_type == "equirectangular":
        f, cx, cy = w / 2, w / 2, h / 2
    else:
        f, cx, cy = 30.0, w / 2 + 0.7, h / 2 - 0.3
    jc = jcam.make_camera(f, f, cx, cy, h, w, C2W)
    tc = tcam.make_camera(f, f, cx, cy, h, w, C2W, device="cpu")
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    want = jcam.ray_dirs_typed(jnp.asarray(xs), jnp.asarray(ys), jc,
                               camera_type)
    got = tcam.ray_dirs_typed(torch.as_tensor(xs), torch.as_tensor(ys), tc,
                              camera_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError):
        tcam.ray_dirs_typed(torch.as_tensor(xs), torch.as_tensor(ys), tc,
                            "orthographic")


@pytest.mark.parametrize("ipd", [0.0, -0.064, 0.064])
def test_face_cameras_match_jax(ipd):
    got = tpano.face_cameras(C2W, 24, ipd, device="cpu")
    want = jpano.face_cameras(C2W, 24, ipd)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g.height, g.width) == (w.height, w.width) == (24, 24)
        for a, b in zip(g.intrins, w.intrins):
            assert float(a) == pytest.approx(float(b), abs=1e-6)
        np.testing.assert_allclose(g.c2w.numpy(), np.asarray(w.c2w),
                                   rtol=0, atol=1e-6)


def test_equirect_dirs_and_compose_match_jax():
    h, w = 20, 40
    np.testing.assert_allclose(tpano.equirect_dirs_cam(h, w).numpy(),
                               np.asarray(jpano.equirect_dirs_cam(h, w)),
                               rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    faces = [rng.random((16, 16, 3), dtype=np.float32) for _ in range(6)]
    got = tpano.compose_equirect([torch.as_tensor(f) for f in faces], h, w)
    want = jpano.compose_equirect([jnp.asarray(f) for f in faces], h, w)
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert tpano.default_face_res(2048) == 512
    assert tpano.default_face_res(100) == 32


@pytest.fixture(scope="module")
def scenes():
    s = scene_np("surface", n=300)
    jp, jb = jax_params(s)
    tp, tb = params_from_jax(to_numpy(jp), to_numpy(jb), device="cpu")
    kw = dict(renderer="xla", chart_pad=(4, 4), pair_cap=8192, s_max=256)
    calls = []

    def port_one(cam):
        calls.append(cam)
        return tmodel.render(tmodel.GStexConfig(**kw), tp, tb, cam, 3000,
                             torch.as_tensor(BG), eval_only=True)["rgb"]

    # every face has one shape: one compile serves all of them
    jax_one = jax.jit(lambda cam: jmodel.render(
        jmodel.GStexConfig(**kw), jp, jb, cam, 3000, jnp.asarray(BG),
        eval_only=True)["rgb"])

    return port_one, jax_one, calls


@pytest.mark.parametrize("kind", ["equirectangular", "ods"])
def test_panoramas_match_jax(scenes, kind):
    port_one, jax_one, calls = scenes
    h, w = 16, 32
    calls.clear()
    if kind == "equirectangular":
        got = tpano.render_equirect(port_one, C2W, h, w, device="cpu")
        want = jpano.render_equirect(jax_one, C2W, h, w)
        assert got.shape == (h, w, 3) and len(calls) == 6
    else:
        got = tpano.render_ods(port_one, C2W, h, w, device="cpu")
        want = jpano.render_ods(jax_one, C2W, h, w)
        assert got.shape == (2 * h, w, 3) and len(calls) == 12
        # the eyes differ: each face moved along its own baseline
        assert not torch.equal(got[:h], got[h:])
    assert {(c.height, c.width) for c in calls} == {(8, 8)}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)
    # the scene is in view: the panorama is not all background
    assert float((got - torch.as_tensor(BG)).abs().max()) > 0.05
