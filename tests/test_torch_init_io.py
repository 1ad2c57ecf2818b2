"""The port's init paths against gstex_tpu on the same numpy inputs:
``knn_mean_dist``, ``raw_from_points``, ``raw_from_gaussian_ply`` with
and without the COLMAP axis fix, ``raw_from_npz``, and the quaternion
helpers under them (``rotmat_to_quat``, ``fix_init_rotation``,
``fix_init_points``, ``random_quats``). Where the JAX package draws
rotations from a key, the tests pass them in, so nothing random is
compared; the port's own draws are held to what they must be (unit
quaternions from JAX's formula).

Tolerances: the same float32 formulas in the same order, but reductions
and transcendentals of two libraries: 1e-6 relative and absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import colmap_axes, colmap_rotation
from gstex_torch.models import init_io as tinit
from gstex_torch.ops import quat as tquat
from gstex_torch.utils.ply import write_ply
from gstex_tpu.models import init_io as jinit
from gstex_tpu.ops import quat as jquat

TOL = dict(rtol=1e-6, atol=1e-6)
RAW = ("means", "log_scales", "quats", "opacity_logits", "features_dc",
       "features_rest")


def unit_quats(n, seed=0):
    q = np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def assert_raw_close(got, want, **tol):
    assert set(got) == set(want) == set(RAW)
    for k in RAW:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **(tol or TOL))


@pytest.mark.parametrize("n,chunk", [(4, 2048), (700, 128)])
def test_knn_mean_dist_matches_jax(n, chunk):
    pts = np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32)
    got = tinit.knn_mean_dist(torch.tensor(pts), chunk=chunk).numpy()
    want = jinit.knn_mean_dist(pts, chunk=chunk)
    np.testing.assert_allclose(got, want, **TOL)
    # the three unit points and the origin: the origin's neighbours are
    # all at 1, the others' at 1, sqrt 2 and sqrt 2
    d = tinit.knn_mean_dist(torch.eye(4)[:, :3]).numpy()
    np.testing.assert_allclose(d, [(1 + 2 * np.sqrt(2)) / 3] * 3 + [1.0],
                               rtol=1e-6)


@pytest.mark.parametrize("fix", [False, True], ids=["as_is", "fix_init"])
def test_raw_from_points_matches_jax(fix):
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((300, 3)).astype(np.float32)
    cols = rng.uniform(0, 255, (300, 3)).astype(np.float32)
    q = unit_quats(300)
    got = tinit.raw_from_points(pts, cols, sh_degree=2, quats=q,
                                fix_init_pts=fix, device="cpu")
    want = jinit.raw_from_points(pts, cols, sh_degree=2, quats=q,
                                 fix_init_pts=fix)
    assert_raw_close(got, want)
    assert got["features_rest"].shape == (300, 8, 3)


@pytest.mark.parametrize("fix", [False, True], ids=["as_is", "fix_init"])
def test_raw_from_gaussian_ply_matches_jax(tmp_path, fix):
    rng = np.random.default_rng(3)
    n = 50
    q = unit_quats(n, seed=3) * rng.uniform(0.5, 2.0, (n, 1))  # unnormalized
    fields = {"x": rng.standard_normal(n), "y": rng.standard_normal(n),
              "z": rng.standard_normal(n), "opacity": rng.standard_normal(n)}
    fields.update({f"scale_{j}": rng.uniform(-4, -1, n) for j in range(3)})
    fields.update({f"rot_{j}": q[:, j] for j in range(4)})
    fields.update({f"f_dc_{j}": rng.standard_normal(n) for j in range(3)})
    fields.update({f"f_rest_{j}": rng.standard_normal(n)
                   for j in range(45)})
    write_ply(tmp_path / "g.ply", fields)
    got = tinit.raw_from_gaussian_ply(tmp_path / "g.ply", fix_init=fix,
                                      device="cpu")
    want = jinit.raw_from_gaussian_ply(tmp_path / "g.ply", fix_init=fix)
    assert_raw_close(got, want)
    if not fix:
        np.testing.assert_array_equal(got["quats"].numpy(),
                                      q.astype(np.float32))


def test_raw_from_npz_matches_jax(tmp_path):
    """The point npz of the reference (``gstex.py:261-270``): every field
    given, so nothing is drawn in either package."""
    rng = np.random.default_rng(4)
    n = 80
    np.savez(tmp_path / "init.npz",
             xyz=rng.standard_normal((n, 3)).astype(np.float32),
             colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
             opacity=rng.standard_normal((n, 1)).astype(np.float32),
             scaling=rng.uniform(-4, -1, (n, 3)).astype(np.float32),
             rotation=unit_quats(n, seed=4))
    got = tinit.raw_from_npz(tmp_path / "init.npz", device="cpu")
    assert_raw_close(got, jinit.raw_from_npz(tmp_path / "init.npz"))


def test_quaternion_helpers_match_jax():
    q = unit_quats(500, seed=5)
    # every branch of rotmat_to_quat: near-identity and half-turns too
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    rm = jquat.quat_to_rotmat(jnp.asarray(q))
    got = tquat.rotmat_to_quat(torch.tensor(np.asarray(rm))).numpy()
    np.testing.assert_allclose(got, np.asarray(jquat.rotmat_to_quat(rm)),
                               **TOL)
    np.testing.assert_allclose(
        tquat.fix_init_rotation(torch.tensor(q)).numpy(),
        np.asarray(jquat.fix_init_rotation(jnp.asarray(q))), **TOL)
    pts = np.random.default_rng(6).standard_normal((20, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tquat.fix_init_points(torch.tensor(pts)).numpy(),
        np.asarray(jquat.fix_init_points(jnp.asarray(pts))))
    # the dataset writer's COLMAP axes are fix_init's inverse
    np.testing.assert_allclose(
        tquat.fix_init_points(torch.tensor(colmap_axes(pts))).numpy(), pts,
        atol=0)
    back = tquat.quat_to_rotmat(tquat.fix_init_rotation(
        colmap_rotation(torch.tensor(q))))
    np.testing.assert_allclose(back.numpy(), np.asarray(rm), atol=2e-6)


def test_random_quats_follow_jax_formula():
    key = jax.random.key(7)
    u, v, w = np.asarray(jax.random.uniform(key, (3, 1000)))
    got = tquat.quats_from_uniform(torch.tensor(u), torch.tensor(v),
                                   torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jquat.random_quats(key, 1000)),
                               **TOL)
    gen = torch.Generator().manual_seed(0)
    q = tquat.random_quats(4000, gen)
    assert q.shape == (4000, 4)
    torch.testing.assert_close(q.norm(dim=-1), torch.ones(4000), atol=1e-6,
                               rtol=0)
    # uniform on the sphere: each component's mean near 0, square near 1/4
    assert float(q.mean(0).abs().max()) < 0.05
    assert float(((q * q).mean(0) - 0.25).abs().max()) < 0.02
    again = tquat.random_quats(4000, torch.Generator().manual_seed(0))
    assert torch.equal(q, again)


def test_raw_random_draws_from_its_generator():
    raw = tinit.raw_random(500, scale=2.0, sh_degree=1,
                           generator=torch.Generator().manual_seed(3),
                           device="cpu")
    again = tinit.raw_random(500, scale=2.0, sh_degree=1,
                             generator=torch.Generator().manual_seed(3),
                             device="cpu")
    for k in RAW:
        assert torch.equal(raw[k], again[k]), k
    assert float(raw["means"].abs().max()) <= 1.0
    assert raw["features_rest"].shape == (500, 3, 3)
    np.testing.assert_allclose(raw["opacity_logits"].numpy(),
                               np.log(0.1 / 0.9), rtol=1e-6)
    want = jinit.knn_mean_dist(raw["means"].numpy())
    np.testing.assert_allclose(raw["log_scales"][:, 0].numpy(),
                               np.log(np.maximum(want, 1e-7)), **TOL)
