"""Texture painting in the port against the JAX package on the CPU:
``models/editing.py`` (``draw_from_view``, ``EditSession``), the
polyline canvases of ``utils/draw.py`` against ``cv2.polylines``, and
``models/gstex.py:render_eval_images`` (every key, with and without an
edited texture), on the same numpy scene at the JAX package's editing
test sizes (8x16 tiles, s_max 64, 48x64 images, chart pad (4, 4)).

Tolerances: ``draw_from_view``'s charts within 1e-5 (the accumulator's
float32 sums taken in another order, a few ulps between the packages'
responses and depths), texels whose window membership flips between the
packages exempted and counted (at most 2 % of the texels the edit
changed); the eval images within 5e-5, as ``test_torch_render.py`` holds
the renders (the packages cull pairs from their own geometry and sum in
another order); the polylines pixel for pixel; saved edits exactly.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.models import editing as tedit
from gstex_torch.models import gstex as tmodel
from gstex_torch.models.convert import params_from_jax
from gstex_torch.ops import camera as tcam
from gstex_torch.ops import sh as tsh
from gstex_torch.data.synthetic import orbit_c2w
from gstex_torch.utils.draw import polyline
from gstex_tpu.models import editing as jedit
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.ops import camera as jcam
from test_torch_render import jax_params, scene_np, to_numpy

H, W = 48, 64
N = 80
CFG = dict(chart_pad=(4, 4), tile_h=8, tile_w=16, pair_cap=1 << 14,
           s_max=64, pixel_num=300, background_color="black")
STEP = 3000
BG = np.array([0.1, 0.3, 0.6], np.float32)
DRAW_TOL = 1e-5
FLIP_SHARE = 0.02
IMG_TOL = 5e-5
_JAX = {}


def scene():
    """The JAX and port params and buffers of one random scene (as the JAX
    package's editing tests draw theirs: opacities raised by 2 logits; few
    enough surfels that no tile's list passes s_max, for the JAX
    package's edit overlay bins without the pair cull), its test colours
    seeded, and the two packages' camera."""
    s = scene_np("random", n=N, pad=CFG["chart_pad"], seed=1)
    s["opacity_logits"] = s["opacity_logits"] + 2.0
    jp, jb = jax_params(s)
    colors = np.random.default_rng(5).uniform(size=(N, 3))
    jb = jb._replace(test_colors=jnp.asarray(colors, jnp.float32))
    tp, tb = params_from_jax(to_numpy(jp), to_numpy(jb), device="cpu")
    c2w = orbit_c2w(3.0, 0.3)
    f = 1.2 * W
    jc = jcam.make_camera(f, f, W / 2, H / 2, H, W, c2w)
    tc = tcam.make_camera(f, f, W / 2, H / 2, H, W, c2w, device="cpu")
    return (jp, jb, jc), (tp, tb, tc)


def center_canvas():
    """The JAX package's test canvas: the centre painted red."""
    canvas = np.zeros((H, W, 4), np.float32)
    canvas[H // 2 - 8:H // 2 + 8, W // 2 - 12:W // 2 + 12] = [1, 0, 0, 1]
    return canvas


def jax_ref(name):
    """JAX's results, computed once per module."""
    if not _JAX:
        (jp, jb, jc), _ = scene()
        cfg = jmodel.GStexConfig(**CFG)
        cur = jnp.asarray(tsh.sh_to_rgb(torch.from_numpy(
            np.array(jp.texture))).numpy())
        new = jedit.draw_from_view(cfg, jp, jb, jc, cur,
                                   jnp.asarray(center_canvas()))
        _JAX["cur"] = np.asarray(cur)
        _JAX["draw"] = np.asarray(new)
        for edit in (False, True):
            imgs = jmodel.render_eval_images(
                cfg, jp, jb, jc, STEP, jnp.asarray(BG),
                edit_texture=new if edit else None)
            _JAX[f"images_{edit}"] = {k: np.asarray(v)
                                      for k, v in imgs.items()}
    return _JAX[name]


def test_draw_from_view_matches_jax():
    _, (tp, tb, tc) = scene()
    cfg = tmodel.GStexConfig(**CFG)
    cur = tsh.sh_to_rgb(tp.texture)
    np.testing.assert_array_equal(cur.numpy(), jax_ref("cur"))
    new = tedit.draw_from_view(cfg, tp, tb, tc, cur,
                               torch.from_numpy(center_canvas())).numpy()
    want = jax_ref("draw")
    changed = np.abs(want - jax_ref("cur")).max(-1) > 1e-3
    assert changed.sum() > 20, "the JAX edit changed too few texels"
    # red went up where the edit changed the charts
    assert (want - jax_ref("cur"))[changed][:, 0].mean() > 0
    diff = np.abs(new - want).max(-1)
    flipped = diff > DRAW_TOL
    assert flipped.sum() <= FLIP_SHARE * changed.sum(), (
        flipped.sum(), changed.sum(), diff.max())


def test_empty_canvas_draw_is_a_noop():
    _, (tp, tb, tc) = scene()
    cur = tsh.sh_to_rgb(tp.texture)
    new = tedit.draw_from_view(tmodel.GStexConfig(**CFG), tp, tb, tc, cur,
                               torch.zeros((H, W, 4)))
    assert torch.equal(new, cur)


@pytest.mark.parametrize("renderer", ["xla", "pallas"])
@pytest.mark.parametrize("edit", [False, True], ids=["plain", "edited"])
def test_render_eval_images_match_jax(renderer, edit):
    """Every key of the eval image set. With ``renderer="pallas"`` the
    ``edit`` image takes the flat eval kernel's path (its plain version on
    the CPU), as the viewer's live edits do on the card."""
    _, (tp, tb, tc) = scene()
    cfg = tmodel.GStexConfig(**CFG, renderer=renderer)
    edited = torch.from_numpy(jax_ref("draw")) if edit else None
    got = tmodel.render_eval_images(cfg, tp, tb, tc, STEP,
                                    torch.from_numpy(BG),
                                    edit_texture=edited)
    want = jax_ref(f"images_{edit}")
    assert set(got) == set(want)
    assert tmodel.render(cfg, tp, tb, tc, STEP, torch.from_numpy(BG),
                         eval_only=True)["overflow"] == 0
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=IMG_TOL,
                                   err_msg=k)
    assert float(got["test"].std()) > 0.01
    moved = float((got["edit"] - got["rgb"]).abs().max())
    assert moved > 0.05 if edit else moved == 0.0


@pytest.mark.parametrize("thickness", [1, 2, 3, 5, 8])
def test_polyline_matches_cv2(thickness):
    """Open polylines of 2-5 points, some reaching past the image, pixel
    for pixel as cv2 draws them."""
    rng = np.random.default_rng(thickness)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(16, 96, 2))
        n = int(rng.integers(2, 6))
        pts = np.stack([rng.integers(-20, w + 20, n),
                        rng.integers(-20, h + 20, n)], -1).astype(np.int32)
        want = np.zeros((h, w, 4), np.uint8)
        cv2.polylines(want, [pts], False, (0, 255, 0, 255), thickness)
        got = np.zeros((h, w, 4), np.uint8)
        polyline(got, pts, (0, 255, 0, 255), thickness)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def test_add_polyline_matches_jax():
    (_, _, jc), (_, _, tc) = scene()
    jsess = jedit.EditSession(jmodel.GStexConfig(**CFG))
    tsess = tedit.EditSession(tmodel.GStexConfig(**CFG))
    for sess, cam in ((jsess, jc), (tsess, tc)):
        sess.add_polyline(cam, [(10, 10), (40, 30), (50, 40)],
                          rgb=(0, 255, 0), width=4)
        sess.add_polyline(cam, [(5, 40), (60, 2)])
    for a, b in zip(jsess.edits, tsess.edits):
        np.testing.assert_array_equal(a["canvas"], b["canvas"])
        assert a["camera"] == b["camera"]
        assert a["canvas"].dtype == b["canvas"].dtype == np.uint8


def test_saved_edits_load_across_packages(tmp_path):
    (_, _, jc), (tp, tb, tc) = scene()
    cfg = tmodel.GStexConfig(**CFG)
    jsess = jedit.EditSession(jmodel.GStexConfig(**CFG))
    tsess = tedit.EditSession(cfg)
    for sess, cam in ((jsess, jc), (tsess, tc)):
        sess.add_polyline(cam, [(8, 30), (32, 20), (56, 28)],
                          rgb=(255, 0, 255), width=5)
    # JAX's files in the port, the port's in JAX
    from_jax = tedit.EditSession.load(
        cfg, jsess.save(tmp_path / "jax") / "info.json")
    from_port = jedit.EditSession.load(
        jmodel.GStexConfig(**CFG),
        tsess.save(tmp_path / "port") / "info.json")
    for loaded, saved in ((from_jax, jsess), (from_port, tsess)):
        assert len(loaded.edits) == 1
        np.testing.assert_array_equal(np.asarray(loaded.edits[0]["canvas"]),
                                      saved.edits[0]["canvas"])
        assert loaded.edits[0]["camera"] == saved.edits[0]["camera"]
    # the port replays the loaded stack as it replays its own
    assert torch.equal(from_jax.edit_texture(tp, tb),
                       tsess.edit_texture(tp, tb))
    from_jax.undo()
    from_jax.undo()
    assert from_jax.edits == []
