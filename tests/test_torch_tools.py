"""The rest of the JAX package's modules in the port, each held against its
JAX counterpart on the CPU: ``cull_gaussians`` and ``duplicate_gaussians``;
a run that ``gstex-train`` wrote (``renderer="xla"``, 1 step on a 32x32
Blender dataset) served by ``gstex-torch-eval`` (PSNR and SSIM within
1e-4 of ``gstex-eval`` on the same run), ``gstex-torch-render
--load-config`` and ``gstex-torch-export``; LPIPS on one random-weight
npz (within 1e-5, zero for identical images) and the ``lpips`` of both
packages' eval metrics with and without ``GSTEX_LPIPS_NPZ``; DBSCAN under
the 2-Wasserstein metric on ``tests/test_dbscan.py``'s blobs
(``pairwise_w2`` to 1e-5 relative, ``estimate_eps`` to 1e-5, equal
labels); ``gstex-torch-completions`` over every ``gstex-torch-*`` CLI; and
``gstex-torch-dev-test``'s commands, its ``_run`` stubbed so that the
suite never starts itself."""

import json
import re
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import random_scene, write_blender_dataset
from gstex_torch.models import gstex as tmodel
from gstex_torch.models import init_io as tinit_io
from gstex_torch.scripts import completions as tcompletions
from gstex_torch.scripts import dev_test as tdev_test
from gstex_torch.scripts import eval as teval
from gstex_torch.scripts import export as texport
from gstex_torch.scripts import render as trender
from gstex_torch.scripts.eval_setup import eval_setup
from gstex_torch.tools import dbscan as tdbscan
from gstex_torch.utils import lpips as tlpips
from gstex_torch.utils import metrics as tmetrics
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.ops.quat import random_quats
from gstex_tpu.tools import dbscan as jdbscan
from gstex_tpu.utils import lpips as jlpips
from gstex_tpu.utils import metrics as jmetrics
from test_lpips import random_weights
from test_torch_train_cli import small_scene_npz

ROOT = Path(__file__).resolve().parents[1]
LEAVES = tmodel.GStexParams._fields
HW = 32
METRIC_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module, its cached references included:
    the tier runs six test workers on the host's cores, and more threads
    each would only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- cull, dup

def scene(n=32, seed=0):
    s = {k: v.numpy() for k, v in
         random_scene(n, chart_pad=(4, 4), seed=seed, device="cpu").items()}
    colors = np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(
        np.float32)
    jp = jmodel.GStexParams(*(jnp.asarray(s[k]) for k in LEAVES))
    jb = jmodel.GStexBuffers(texture_hw=jnp.asarray(s["texture_hw"]),
                             mappings=jnp.asarray(s["mappings"]),
                             pixel_scale=jnp.float32(0.0125),
                             test_colors=jnp.asarray(colors))
    tp = tmodel.GStexParams(*(torch.tensor(s[k]) for k in LEAVES))
    tb = tmodel.GStexBuffers(texture_hw=torch.tensor(s["texture_hw"]),
                             mappings=torch.tensor(s["mappings"]),
                             pixel_scale=torch.tensor(0.0125),
                             test_colors=torch.tensor(colors))
    return (jp, jb), (tp, tb)


def assert_same(torch_state, jax_state):
    for got, want in zip((*torch_state[0], *torch_state[1]),
                         (*jax_state[0], *jax_state[1])):
        assert got.dtype == torch.from_numpy(np.array(want)).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["first_rows", "random_rows"])
def test_cull_and_duplicate_match_jax(case):
    """``tests/test_model.py``'s case (keep the first 20 of 32, then copy
    the first 5 of those) and a seeded random one: every leaf and buffer
    equal to JAX's, ``pixel_scale`` kept; masks as numpy arrays or
    tensors."""
    jax_state, torch_state = scene()
    if case == "first_rows":
        keep = np.zeros(32, bool)
        keep[:20] = True
        dup = np.zeros(20, bool)
        dup[:5] = True
    else:
        rng = np.random.default_rng(7)
        keep = rng.uniform(size=32) < 0.6
        dup = rng.uniform(size=int(keep.sum())) < 0.4
    j2 = jmodel.cull_gaussians(*jax_state, keep)
    t2 = tmodel.cull_gaussians(*torch_state, torch.from_numpy(keep))
    assert_same(t2, j2)
    assert t2[1].pixel_scale is torch_state[1].pixel_scale
    j3 = jmodel.duplicate_gaussians(*j2, dup)
    t3 = tmodel.duplicate_gaussians(*t2, dup)
    assert_same(t3, j3)
    assert t3[0].means.shape[0] == int(keep.sum() + dup.sum())
    with pytest.raises(ValueError, match="mask"):
        tmodel.cull_gaussians(*torch_state, keep[:5])


# ------------------------------------------------------------- a JAX run

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A ``gstex-train`` run of the JAX package on the CPU (its XLA tier,
    1 step, 200 random surfels) on a 32x32 Blender dataset of 2 train
    and 2 test views, and ``gstex-eval``'s output on it."""
    from gstex_tpu.scripts import eval as jeval
    from gstex_tpu.scripts import train as jtrain

    root = tmp_path_factory.mktemp("jax_run")
    stats = small_scene_npz(root / "scene.npz", n=300)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8))
    params, buffers = tinit_io.load_scene_npz(cfg, stats, seed=0,
                                              device="cpu")
    data = root / "data"
    write_blender_dataset(data, cfg, params, buffers, 2, HW, HW)
    run = root / "run"
    jtrain.main(["gstex-blender-nvs", "--data", str(data), "--num-random",
                 "200", "--max-num-iterations", "1", "--renderer", "xla",
                 "--set", "trainer.steps_per_sync=1", "--output-dir",
                 str(run)])
    # the test split, written after training so that the run closes
    # without an eval pass of its own
    write_blender_dataset(data, cfg, params, buffers, 2, HW, HW,
                          split="test", azimuth0=0.4)
    jeval.main(["--load-config", str(run), "--output-path",
                str(root / "jax_eval.json")])
    return run, json.loads((root / "jax_eval.json").read_text())


def test_eval_setup_restores_a_jax_run(jax_run):
    """The port rebuilds the JAX run from its ``config.json`` and its
    ``.ckpt.npz``: the checkpoint's params and buffers bit for bit, its
    step, the chart pad of its charts."""
    run, _ = jax_run
    ck = next((run / "checkpoints").glob("step-*.ckpt.npz"))
    trainer, method, cfg = eval_setup(run, device="cpu")
    with np.load(ck) as data:
        leaves = [data[f"leaf_{i}"] for i in range(11)]
        step = int(data[f"leaf_{int(data['n']) - 2}"])
    for got, want in zip((*trainer.state.params, *trainer.state.buffers),
                         leaves):
        np.testing.assert_array_equal(got.detach().numpy(), want)
    assert method.name == "gstex-blender-nvs" and "overrides" not in cfg
    assert trainer.state.step == step == 1
    assert trainer.mcfg.chart_pad == tuple(leaves[6].shape[1:3])
    assert trainer.mcfg.renderer == "xla"


def test_eval_cli_serves_a_jax_run(jax_run, tmp_path):
    """``gstex-torch-eval --load-config`` on the JAX run: JAX's schema, and
    PSNR and SSIM within 1e-4 of ``gstex-eval``'s."""
    run, want = jax_run
    got = teval.main(["--load-config", str(run / "config.json"),
                      "--output-path", str(tmp_path / "eval.json"),
                      "--device", "cpu"])
    assert set(got) == set(want)
    assert set(got["results"]) == set(want["results"])
    for k in ("psnr", "ssim"):
        assert abs(got["results"][k] - want["results"][k]) <= METRIC_TOL, k
    assert got["results"]["gaussian_count"] == want["results"][
        "gaussian_count"]


def test_render_and_export_serve_a_jax_run(jax_run, tmp_path):
    run, _ = jax_run
    summary = trender.main(["dataset", "--load-config", str(run),
                            "--output-path", str(tmp_path / "frames"),
                            "--device", "cpu"])
    assert len(summary) == 2 and all(s["finite"] for s in summary)
    assert len(list((tmp_path / "frames").glob("frame_*.png"))) == 2
    out = tmp_path / "scene.npz"
    texport.main(["gstex-npz", "--load-config", str(run), "--output-path",
                  str(out), "--device", "cpu"])
    with np.load(out) as d:
        assert len(d.files) > 0


# ------------------------------------------------------------------ LPIPS

def test_lpips_matches_jax(tmp_path):
    """One random-weight npz read by both packages: their LPIPS within
    1e-5, and zero for identical images."""
    rng = np.random.default_rng(3)
    path = tmp_path / "lpips.npz"
    np.savez(path, **random_weights(rng))
    img0 = rng.random((64, 96, 3)).astype(np.float32)
    img1 = np.clip(img0 + 0.1 * rng.random((64, 96, 3)).astype(np.float32),
                   0, 1)
    want = jlpips.load(path)(img0, img1)
    got = tlpips.load(path)(torch.from_numpy(img0), torch.from_numpy(img1))
    assert want > 0
    assert abs(got - want) <= 1e-5
    img = rng.random((35, 41, 3)).astype(np.float32)
    assert abs(tlpips.load(path)(torch.from_numpy(img),
                                 torch.from_numpy(img))) <= 1e-6


def test_metrics_report_lpips_where_both_packages_do(tmp_path, monkeypatch):
    """Under ``GSTEX_LPIPS_NPZ`` both packages' eval metrics report
    ``lpips``, within 1e-5 of each other; without it (and without
    ``weights/lpips_alex.npz``) both report None."""
    assert not tlpips.DEFAULT_PATH.exists()
    rng = np.random.default_rng(4)
    pred = rng.random((64, 64, 3)).astype(np.float32)
    gt = rng.random((64, 64, 3)).astype(np.float32)
    path = tmp_path / "lpips.npz"
    np.savez(path, **random_weights(rng))
    for env in (None, str(path)):
        if env is None:
            monkeypatch.delenv("GSTEX_LPIPS_NPZ", raising=False)
        else:
            monkeypatch.setenv("GSTEX_LPIPS_NPZ", env)
        # JAX's metrics look for the file once a process: both of its
        # globals are patched, so that teardown leaves neither the model
        # loaded here nor the check behind for later tests
        monkeypatch.setattr(jmetrics, "_lpips_checked", False)
        monkeypatch.setattr(jmetrics, "_lpips_model", None)
        want = jmetrics.image_metrics(jnp.asarray(pred), jnp.asarray(gt))
        got = tmetrics.image_metrics(torch.from_numpy(pred),
                                     torch.from_numpy(gt))
        if env is None:
            assert got["lpips"] is None and want["lpips"] is None
        else:
            assert got["lpips"] > 0
            assert abs(got["lpips"] - want["lpips"]) <= 1e-5
        for k in ("psnr", "ssim"):
            assert abs(got[k] - want[k]) <= METRIC_TOL, k


# ----------------------------------------------------------------- DBSCAN

def blobs():
    """``tests/test_dbscan.py::test_dbscan_two_blobs``'s data."""
    rng = np.random.default_rng(0)
    n_half = 60
    blob1 = rng.normal(0, 0.05, (n_half, 3))
    blob2 = rng.normal(0, 0.05, (n_half, 3)) + [5, 0, 0]
    outlier = np.array([[2.5, 2.5, 2.5]])
    means = np.concatenate([blob1, blob2, outlier]).astype(np.float32)
    n = means.shape[0]
    log_scales = np.full((n, 2), -4.0, np.float32)
    quats = np.array(random_quats(jax.random.key(1), n))
    return means, log_scales, quats, n_half


@pytest.mark.parametrize("spread", ["equal_scales", "mixed_scales"])
def test_dbscan_matches_jax(spread):
    means, log_scales, quats, n_half = blobs()
    if spread == "mixed_scales":
        log_scales = np.random.default_rng(2).uniform(
            -4.5, -3.0, log_scales.shape).astype(np.float32)
    want = jdbscan.pairwise_w2(means, log_scales, quats)
    got = tdbscan.pairwise_w2(means, log_scales, quats, chunk=50,
                              device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    eps_j = jdbscan.estimate_eps(means, log_scales, quats, k=4,
                                 percentile=90)
    eps_t = tdbscan.estimate_eps(means, log_scales, quats, k=4,
                                 percentile=90, device="cpu")
    assert abs(eps_t - eps_j) <= 1e-5 * eps_j
    eps = max(eps_j, 0.3)
    want_l = jdbscan.DBSCAN(eps=eps, min_pts=5).fit(means, log_scales, quats)
    got_l = tdbscan.DBSCAN(eps=eps, min_pts=5, chunk=50, device="cpu").fit(
        means, log_scales, quats)
    np.testing.assert_array_equal(got_l, want_l)
    stats = tdbscan.DBSCAN.cluster_stats(got_l)
    assert stats == jdbscan.DBSCAN.cluster_stats(want_l)
    assert stats["num_clusters"] == 2 and got_l[-1] == tdbscan.NOISE
    assert len(set(got_l[:n_half])) == 1


def test_dbscan_pieces_and_ply_match_jax(tmp_path):
    """``make_covariance_3d``, ``sqrtm_psd_3x3``, ``wasserstein2_sq`` and
    ``save_clustered_ply`` against JAX's."""
    means, log_scales, quats, _ = blobs()
    cov_j = jdbscan.make_covariance_3d(jnp.asarray(log_scales),
                                       jnp.asarray(quats))
    cov_t = tdbscan.make_covariance_3d(torch.from_numpy(log_scales),
                                       torch.from_numpy(quats))
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(cov_j)).max())
    a = np.random.default_rng(0).normal(size=(16, 3, 3)).astype(np.float32)
    psd = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(
        tdbscan.sqrtm_psd_3x3(torch.from_numpy(psd)).numpy(),
        np.asarray(jdbscan.sqrtm_psd_3x3(jnp.asarray(psd))), rtol=1e-4,
        atol=1e-5)
    mu = torch.from_numpy(means)
    d = tdbscan.wasserstein2_sq(mu[:5], cov_t[:5], mu[5:10], cov_t[5:10])
    dj = jdbscan.wasserstein2_sq(jnp.asarray(means[:5]), cov_j[:5],
                                 jnp.asarray(means[5:10]), cov_j[5:10])
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-9)
    labels = np.array([0, 1, -1, 1], np.int64)
    tdbscan.save_clustered_ply(tmp_path / "t.ply", means[:4], labels)
    jdbscan.save_clustered_ply(tmp_path / "j.ply", means[:4], labels)
    assert (tmp_path / "t.ply").read_bytes() == (
        tmp_path / "j.ply").read_bytes()


# ------------------------------------------------- completions, dev-test

def torch_clis() -> dict:
    """The ``gstex-torch-*`` entry points of ``pyproject.toml``."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v.split(":")[0] for k, v in scripts.items()
            if k.startswith("gstex-torch-")}


@pytest.mark.parametrize("cli,flags", [
    ("gstex-torch-train", ["--data", "--set", "--load-checkpoint",
                           "--renderer", "--device", "--num-devices"]),
    ("gstex-torch-eval", ["--load-config", "--output-path", "--device"]),
    ("gstex-torch-render", ["spiral", "camera-path", "--load-config",
                            "--scene-npz", "--camera-type"]),
    ("gstex-torch-export", ["gstex-npz", "gaussian-ply", "--load-config"]),
    ("gstex-torch-viewer", ["--load-config", "--port"]),
    ("gstex-torch-parity", ["--synthetic", "--gt-renderer"]),
    ("gstex-torch-experiments", ["blender-nvs", "--data-root"]),
    ("gstex-torch-completions", ["--output", "--install"]),
    ("gstex-torch-dev-test", ["--full", "--chip", "-k"]),
])
def test_completions_name_every_cli_and_its_flags(cli, flags):
    assert tcompletions.CLIS == torch_clis()
    script = tcompletions.generate_script()
    line = next(ln for ln in script.splitlines()
                if f"_{cli.replace('-', '_')}_complete()" in ln)
    body = script[script.index(line):].splitlines()[2]
    words = set(re.search(r'-W "([^"]*)"', body).group(1).split())
    assert f"complete -F _{cli.replace('-', '_')}_complete {cli}" in script
    assert set(flags) <= words, set(flags) - words


def test_completions_cli_writes_and_installs(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    text = tcompletions.main([])
    assert capsys.readouterr().out == text
    out = tmp_path / "c" / "gstex_torch.bash"
    tcompletions.main(["--output", str(out), "--install"])
    tcompletions.main(["--output", str(out), "--install"])
    assert out.read_text() == text
    assert (tmp_path / ".bashrc").read_text().count(f"source {out}") == 1
    with pytest.raises(SystemExit):
        tcompletions.main(["--install"])


def test_dev_test_runs_the_port_tests_and_the_chip_check(monkeypatch):
    calls = []

    def run(name, cmd, env=None):
        calls.append((name, cmd, env))
        return True
    monkeypatch.setattr(tdev_test, "_run", run)
    tdev_test.main([])
    (name, cmd, env), = calls
    assert name == "pytest" and env["JAX_PLATFORMS"] == "cpu"
    tests = {c for c in cmd if c.startswith("tests/")}
    assert tests == {f"tests/{p.name}" for p in
                     (ROOT / "tests").glob("test_torch_*.py")}
    assert cmd[1:3] == ["-m", "pytest"] and "-m" not in cmd[3:]
    calls.clear()
    tdev_test.main(["--full", "--chip", "-k", "bf16"])
    assert [c[0] for c in calls] == ["pytest", "chip_smoke"]
    assert calls[0][1][-4:] == ["-m", "", "-k", "bf16"]
    assert calls[1][1][-1] == "chip_smoke.py"
    monkeypatch.setattr(tdev_test, "_run", lambda *a, **k: False)
    with pytest.raises(SystemExit):
        tdev_test.main([])
