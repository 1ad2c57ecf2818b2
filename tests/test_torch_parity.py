"""The parity harness (``gstex_torch.scripts.parity``) against the JAX
package's (``gstex_tpu.scripts.parity``): the synthetic held-out protocol
on JAX's own draws of the scene and the init (ground-truth views within
1e-5, held-out PSNR within 0.05 dB and SSIM within 1e-4), the report's
schema key for key, the whole protocol through the kernel tier's plain
versions with every gate, and config 1's gradcheck on a written Blender
dataset. JAX runs on its XLA tier, as its own CPU tests do; sizes are
small (64² views, 128 surfels, 8 steps)."""

import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.configs.methods import get_method
from gstex_torch.data.synthetic import write_blender_dataset
from gstex_torch.models import gstex as tmodel
from gstex_torch.models import init_io as tinit
from gstex_torch.models.convert import params_from_jax
from gstex_torch.scripts import parity as tparity
from gstex_tpu.data.synthetic import orbit_camera as jorbit
from gstex_tpu.data.synthetic import surface_scene as jsurface
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.scripts import parity as jparity

RES, N, VIEWS, ITERS, SEED = 64, 128, 10, 8, 0
ARGS = ["--synthetic", "--res", str(RES), "--n-gauss", str(N), "--views",
        str(VIEWS), "--quick", str(ITERS), "--renderer", "xla",
        "--gt-renderer", "oracle"]
CERT_KEYS = {"certifier", "views_checked", "cert_res", "max_abs_diff",
             "fullres_window", "fullres_window_max_abs_diff", "pass",
             "seconds"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_report(tmp_path_factory):
    """JAX's ``main --synthetic`` (its ``synthetic_heldout`` on the XLA
    tier, oracle ground truth), its compile cache left as the tests set
    it."""
    out = tmp_path_factory.mktemp("jax_parity")
    with mock.patch("gstex_tpu.utils.tpu.enable_compilation_cache",
                    lambda *a, **k: None):
        return jparity.main(ARGS + ["--output-dir", str(out)])


def jax_draws():
    """JAX's ground-truth scene and perturbed init, drawn as its
    ``synthetic_heldout`` draws them, as numpy."""
    cfg = jmodel.GStexConfig(chart_pad=(8, 8), tile_h=32, tile_w=32,
                             pair_cap=1 << 19, s_max=2048, pixel_num=1e6,
                             background_color="black", renderer="xla")

    @jax.jit
    def gt_params():
        s = jsurface(jax.random.key(SEED), N, chart_pad=cfg.chart_pad)
        return jmodel.init_params(
            cfg, s["means"], s["log_scales"], s["quats"],
            s["opacity_logits"], s["features_dc"], s["features_rest"])

    p, b = gt_params()
    ks = jax.random.split(jax.random.key(SEED + 1), 3)
    spacing = 1.2 * float(np.sqrt(4.0 * np.pi / N))
    p0 = p._replace(
        means=p.means + 0.3 * spacing * jax.random.normal(ks[0],
                                                         p.means.shape),
        log_scales=p.log_scales + 0.2 * jax.random.normal(
            ks[1], p.log_scales.shape),
        texture=jnp.zeros_like(p.texture),
        features_dc=jnp.zeros_like(p.features_dc),
        features_rest=0.0 * p.features_rest)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return cfg, to_np(p), to_np(b), to_np(p0)


def test_heldout_on_jax_draws_matches_jax(jax_report, tmp_path):
    jcfg, p, b, p0 = jax_draws()
    tp, tb = params_from_jax(p, b, device="cpu")
    tp0, _ = params_from_jax(p0, b, device="cpu")
    # the ground-truth views: the port's oracle against JAX's
    cams, _ = tparity.heldout_cameras(RES, VIEWS, "cpu")
    got = tparity.render_views(tparity.heldout_config("oracle"), tp, tb,
                               cams)
    ocfg = dataclasses.replace(jcfg, renderer="oracle")
    jp, jb = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, b)
    render = jax.jit(lambda cam: jmodel.render(
        ocfg, jp, jb, cam, jnp.int32(10000), jnp.zeros(3))["rgb"])
    for i, g in enumerate(got):
        cam = jorbit(RES, RES, dist=4.0, azimuth=2 * np.pi * i / VIEWS,
                     elevation=0.35)
        np.testing.assert_allclose(g.numpy(), np.asarray(render(cam)),
                                   atol=1e-5, rtol=0, err_msg=f"view {i}")
    agg = tparity.synthetic_heldout(
        "xla", RES, ITERS, tmp_path, n_gauss=N, views=VIEWS,
        gt_renderer="oracle", device="cpu", params_gt=tp, buffers_gt=tb,
        params_init=tp0)
    ref = jax_report["heldout"]
    assert abs(agg["psnr"] - ref["psnr"]) <= 0.05, (agg["psnr"], ref["psnr"])
    assert abs(agg["ssim"] - ref["ssim"]) <= 1e-4, (agg["ssim"], ref["ssim"])
    assert agg["held_out_views"] == ref["held_out_views"] == [4, 9]
    assert (tmp_path / "trained_params.npz").exists()


def test_main_report_schema_matches_jax(jax_report, tmp_path):
    got = tparity.main(ARGS + ["--output-dir", str(tmp_path),
                               "--device", "cpu"])
    assert set(got) == set(jax_report)
    assert set(got["heldout"]) == set(jax_report["heldout"])
    for k, v in jax_report["heldout"].items():
        assert type(got["heldout"][k]) is type(v), k
    assert json.loads((tmp_path / "parity.json").read_text()) == got
    assert np.isfinite(got["psnr"])


def test_synthetic_protocol_through_the_kernel_tier(jax_report, tmp_path):
    """The whole protocol as the card runs it, through the kernel tier
    (here its plain versions): certified ground truth, training, renderer
    consistency and the trained-state gradcheck, every gate passing."""
    rep = tparity.main(ARGS[:-4] + ["--output-dir", str(tmp_path),
                                    "--device", "cpu"])
    h = rep["heldout"]
    assert rep["renderer"] == "pallas"
    assert rep["gt_renderer"] == h["gt_renderer"] == "oracle_certified"
    assert set(h["gt_certification"]) == CERT_KEYS
    assert h["gt_certification"]["pass"]
    assert h["renderer_consistency_pass"] and h["trained_gradcheck_pass"]
    extra = set(h) - set(jax_report["heldout"])
    assert extra == {k for k in h if k.startswith(
        ("renderer_consistency_", "trained_gradcheck_"))}
    assert set(h["trained_gradcheck_grad_rel_diffs"]) == set(
        tmodel.GStexParams._fields)
    assert np.isfinite(h["psnr"]) and h["train_views"] == 8


def test_gradcheck_on_a_blender_dataset(tmp_path):
    """Config 1 on a written dataset and a 2DGS ply of its scene: the
    kernel tier (its plain versions here) against the ``xla`` tier."""
    cfg = tparity.heldout_config("pallas")
    s = tparity.surface_scene(200, seed=3, device="cpu")
    params, buffers = tmodel.init_params(
        cfg, s["means"], s["log_scales"], s["quats"], s["opacity_logits"],
        s["features_dc"], s["features_rest"])
    write_blender_dataset(tmp_path / "data", cfg, params, buffers, 2, 48, 64)
    tinit.export_gaussian_ply(tmp_path / "init.ply", params, buffers)
    res = tparity.gradcheck(get_method("gstex-blender-nvs"),
                            tmp_path / "data", tmp_path / "init.ply",
                            renderer="pallas", device="cpu")
    assert res["gradcheck_pass"], res
    assert set(res["grad_rel_diffs"]) == set(tmodel.GStexParams._fields)
    assert res["loss_xla"] == pytest.approx(res["loss_pallas"], rel=1e-4)
