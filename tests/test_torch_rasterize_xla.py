"""The pure-torch tile renderer: gstex_torch ``ops/rasterize.py:rasterize``
against gstex_tpu ``ops/rasterize.py:rasterize`` on the same numpy scene
and dense lists, for the six maps, the ``uv`` map of ``extra_channels``
and the gradients of all seven param leaves under random cotangents; the
committed golden fixture; the per-pixel oracle against JAX's; and the
hand-derived backward against ``torch.autograd`` through the oracle.

Tolerances are the JAX package's own for its tier cross-checks
(``tests/test_pallas.py``): atol 2e-5 / rtol 1e-4 on the maps, atol 3e-4 on
gradients scaled by the reference's max abs; and ``tests/test_golden.py``'s
for the fixture: atol 3e-5 / rtol 1e-4 and 5e-4 scaled. The two packages
evaluate the same float32 formulas in another order (records here, geom
fields there), which is what the tolerances cover.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import orbit_c2w, random_scene
from gstex_torch.ops import camera as tcam
from gstex_torch.ops.binning import TileGrid, build_tile_bins
from gstex_torch.ops.prepare import prepare_splats
from gstex_torch.ops.rasterize import rasterize
from gstex_torch.ops.rasterize_ref import render_oracle
from gstex_tpu.data import synthetic as jsynthetic
from gstex_tpu.ops import binning as jbinning
from gstex_tpu.ops import camera as jcam
from gstex_tpu.ops.prepare import prepare_splats as jprepare
from gstex_tpu.ops.rasterize import rasterize as jrasterize
from gstex_tpu.ops.rasterize_ref import render_oracle as jrender_oracle

H, W = 64, 96
MAPS = ("img", "texture_rgb", "depth", "alpha", "normal", "reg")
LEAVES = ("means", "log_scales", "quats", "opacity_logits", "features_dc",
          "features_rest", "texture")
GOLDEN = Path(__file__).parent / "golden" / "rasterize_golden.npz"
# (tile, s_max, chart pad): the JAX tests' main case, 16x16 tiles, lists
# that truncate (overflow > 0), and a non-square pad with tall charts
CASES = {"tile32": (32, 64, (4, 4)), "tile16": (16, 64, (4, 4)),
         "truncating": (32, 16, (4, 4)), "pad6x10": (32, 64, (6, 10))}


def scene_np(n=48, seed=3, pad=(4, 4)):
    s = {k: v.numpy() for k, v in
         random_scene(n, chart_pad=pad, seed=seed, device="cpu").items()}
    if pad[0] != pad[1]:
        # active chart dims up to the pad in each direction
        rng = np.random.default_rng(seed)
        s["texture_hw"] = np.stack([rng.integers(1, pad[0] + 1, n),
                                    rng.integers(1, pad[1] + 1, n)],
                                   -1).astype(np.int32)
    return s


def cotangents_np(keys, seed=9):
    rng = np.random.default_rng(seed)
    scale = {"depth": 0.1, "normal": 0.1, "reg": 0.1}
    shape = {"img": (H, W, 3), "texture_rgb": (H, W, 3), "normal": (H, W, 3)}
    return {k: (scale.get(k, 1.0) * rng.standard_normal(shape.get(k, (H, W)))
                ).astype(np.float32) for k in keys}


def c2w():
    return orbit_c2w(3.0, 0.3)


def jax_run(s, tile, s_max, cot, render=jrasterize, extra=False):
    """JAX maps and leaf gradients of sum(maps · cotangents)."""
    f = 1.2 * max(H, W)
    cam = jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w())
    grid = jbinning.TileGrid(height=H, width=W, tile_h=tile, tile_w=tile)

    def loss(d):
        p = jprepare(d["means"], d["log_scales"], d["quats"],
                     d["opacity_logits"], d["features_dc"],
                     d["features_rest"], jnp.asarray(s["mappings"]), cam,
                     active_sh_degree=3)
        hw = jnp.asarray(s["texture_hw"])
        if render is jrender_oracle:
            out = render(p.geom, d["texture"], hw, cam, extra_channels=extra)
            overflow = 0
        else:
            bins = jbinning.build_tile_bins(p.centers, p.extents, p.depths,
                                            p.valid, grid, pair_cap=8192,
                                            s_max=s_max)
            out = render(p.geom, d["texture"], hw, bins, cam, grid,
                         extra_channels=extra)
            overflow = bins.overflow
        return sum(jnp.sum(out[k] * cot[k]) for k in cot), (out, overflow)

    leaves = {k: jnp.asarray(s[k]) for k in LEAVES}
    if not cot:
        out, overflow = loss(leaves)[1]
        return {k: np.asarray(v) for k, v in out.items()}, None, int(overflow)
    (_, (out, overflow)), grads = jax.value_and_grad(loss, has_aux=True)(
        leaves)
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: np.asarray(grads[k]) for k in LEAVES}, int(overflow))


def torch_run(s, tile, s_max, cot, render=rasterize, extra=False):
    """The port's maps and leaf gradients, same inputs."""
    f = 1.2 * max(H, W)
    cam = tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w(), device="cpu")
    grid = TileGrid(height=H, width=W, tile_h=tile, tile_w=tile)
    leaves = {k: torch.tensor(s[k], requires_grad=True) for k in LEAVES}
    p = prepare_splats(leaves["means"], leaves["log_scales"],
                       leaves["quats"], leaves["opacity_logits"],
                       leaves["features_dc"], leaves["features_rest"],
                       torch.tensor(s["mappings"]), cam, active_sh_degree=3)
    hw = torch.tensor(s["texture_hw"])
    if render is render_oracle:
        out = render(p.geom, leaves["texture"], hw, cam, extra_channels=extra)
        overflow = 0
    else:
        bins = build_tile_bins(p.centers.detach(), p.extents.detach(),
                               p.depths.detach(), p.valid, grid,
                               pair_cap=8192, s_max=s_max)
        out = render(p.geom, leaves["texture"], hw, bins, cam, grid,
                     extra_channels=extra)
        overflow = bins.overflow
    if cot:
        sum(torch.sum(out[k] * torch.tensor(cot[k])) for k in cot).backward()
    grads = {k: (leaves[k].grad.numpy() if leaves[k].grad is not None
                 else np.zeros_like(s[k])) for k in LEAVES}
    return {k: v.detach().numpy() for k, v in out.items()}, grads, overflow


def assert_maps_close(got, want, keys=MAPS, atol=2e-5):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=1e-4,
                                   err_msg=k)


def assert_grads_close(got, want, keys=LEAVES, atol=3e-4):
    for k in keys:
        scale = np.abs(want[k]).max() + 1e-8
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   atol=atol, err_msg=f"grad {k}")


@pytest.fixture(scope="module")
def results():
    """Each case runs once through both packages."""
    cache = {}

    def get(name):
        if name not in cache:
            tile, s_max, pad = CASES[name]
            s = scene_np(n=96 if name == "truncating" else 48, pad=pad)
            cot = cotangents_np(MAPS)
            cache[name] = (jax_run(s, tile, s_max, cot),
                           torch_run(s, tile, s_max, cot))
        return cache[name]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_maps_match_jax(results, case):
    (want, _, want_ovf), (got, _, got_ovf) = results(case)
    assert got_ovf == want_ovf
    assert (got_ovf > 0) == (case == "truncating")
    assert_maps_close(got, want)
    assert got["alpha"].max() > 0.3 and np.abs(got["reg"]).max() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(results, case):
    (_, want, _), (_, got, _) = results(case)
    assert_grads_close(got, want)
    for k in LEAVES:
        if k != "features_dc":
            assert np.abs(got[k]).max() > 0, k


def test_extra_channels_uv_matches_jax():
    s = scene_np()
    want, _, _ = jax_run(s, 32, 64, {}, extra=True)
    got, _, _ = torch_run(s, 32, 64, {}, extra=True)
    assert_maps_close(got, want)
    # uv accumulates w·uv over clamped chart coordinates, whose texel-scale
    # steps magnify rounding: the looser of the two map tolerances
    np.testing.assert_allclose(got["uv"], want["uv"], atol=5e-5, rtol=1e-4)
    assert got["uv"].shape == (H, W, 3) and got["uv"].max() > 0.1
    np.testing.assert_allclose(got["uv"][..., 2], 0.5 * got["alpha"],
                               atol=1e-6)


def test_tile_size_is_output_neutral(results):
    """The blend order is per pixel (depth, id), so 16x16 and 32x32 tiles
    render the same maps and gradients (sums over pixels in another order:
    1e-6 on the maps, 1e-5 scaled on the gradients)."""
    (_, _, _), (maps32, grads32, _) = results("tile32")
    (_, _, _), (maps16, grads16, _) = results("tile16")
    assert_maps_close(maps16, maps32, atol=1e-6)
    assert_grads_close(grads16, grads32, atol=1e-5)


def test_matches_golden_fixture():
    """The committed oracle-tier outputs and gradients of a fixed scene
    (``tests/test_golden.py``), through the port's pure-torch tier."""
    golden = dict(np.load(GOLDEN))
    scene = {k: np.asarray(v) for k, v in jsynthetic.random_scene(
        jax.random.key(42), 48, chart_pad=(4, 4)).items()}
    ks = jax.random.split(jax.random.key(7), 3)
    cot = {"img": np.asarray(jax.random.normal(ks[0], (H, W, 3))),
           "texture_rgb": np.asarray(jax.random.normal(ks[1], (H, W, 3))),
           "alpha": np.asarray(jax.random.normal(ks[2], (H, W)))}
    f = 1.2 * max(H, W)
    cam = tcam.make_camera(f, f, W / 2, H / 2, H, W, orbit_c2w(3.0, 0.0),
                           device="cpu")
    jc = jsynthetic.orbit_camera(H, W, dist=3.0)
    np.testing.assert_allclose(cam.c2w.numpy(), np.asarray(jc.c2w), atol=1e-6)
    grid = TileGrid(height=H, width=W, tile_h=32, tile_w=32)
    diff = ("means", "log_scales", "quats", "opacity_logits", "texture")
    leaves = {k: torch.tensor(scene[k], requires_grad=k in diff)
              for k in LEAVES}
    p = prepare_splats(leaves["means"], leaves["log_scales"],
                       leaves["quats"], leaves["opacity_logits"],
                       leaves["features_dc"], leaves["features_rest"],
                       torch.tensor(scene["mappings"]), cam,
                       active_sh_degree=3)
    bins = build_tile_bins(p.centers.detach(), p.extents.detach(),
                           p.depths.detach(), p.valid, grid, pair_cap=8192,
                           s_max=64)
    out = rasterize(p.geom, leaves["texture"],
                    torch.tensor(scene["texture_hw"]), bins, cam, grid)
    for k in MAPS:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   golden[f"out_{k}"], atol=3e-5, rtol=1e-4,
                                   err_msg=k)
    sum(torch.sum(out[k] * torch.tensor(cot[k])) for k in cot).backward()
    for k in diff:
        ref = golden[f"grad_{k}"]
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(leaves[k].grad.numpy() / scale,
                                   ref / scale, atol=5e-4,
                                   err_msg=f"grad {k}")
        assert np.abs(ref).max() > 0


@pytest.fixture(scope="module")
def tiny():
    """A scene small enough for the O(H·W·N) oracle under autograd."""
    s = scene_np(n=24, seed=7)
    cot = cotangents_np(MAPS, seed=2)
    return s, cot, torch_run(s, 32, 64, cot, render=render_oracle)


def test_oracle_matches_jax(tiny):
    s, cot, (got, got_grads, _) = tiny
    want, want_grads, _ = jax_run(s, 32, 64, cot, render=jrender_oracle)
    assert_maps_close(got, want)
    assert_grads_close(got_grads, want_grads)


def test_oracle_extra_channels(tiny):
    s, _, (plain, _, _) = tiny
    got, _, _ = torch_run(s, 32, 64, {}, render=render_oracle, extra=True)
    want, _, _ = jax_run(s, 32, 64, {}, render=jrender_oracle, extra=True)
    np.testing.assert_allclose(got["uv"], want["uv"], atol=5e-5, rtol=1e-4)
    assert set(got) == set(plain) | {"uv"}


def test_backward_matches_autograd_through_oracle(tiny):
    """The hand-derived back-to-front walk (T_k = T_{k+1} / (1 − α_k),
    suffix sums, prefixes from the forward's totals) against plain
    autograd through the per-pixel oracle, which shares none of it: maps
    at the tier tolerance, every leaf's gradient at 3e-4 scaled."""
    s, cot, (want, want_grads, _) = tiny
    got, got_grads, overflow = torch_run(s, 32, 64, cot)
    assert overflow == 0
    assert_maps_close(got, want)
    assert_grads_close(got_grads, want_grads)
    assert np.abs(want_grads["texture"]).max() > 0
