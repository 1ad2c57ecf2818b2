"""What a training run reads and writes around its steps, against the
JAX package: the train CLI's new flags (``--load-checkpoint``,
``--experiment-name``, ``--steps-per-save``, ``--steps-per-eval-image``,
``--vis``) reaching the trainer's config as ``gstex-train``'s do, with
its defaults and precedence; the ``Writer``'s ``events.jsonl`` rows,
console lines, images and missing-sink notice against JAX's on the same
calls; the trainer's cadences (eval images, the whole-eval-set scalars,
checkpoints on the absolute step of a resumed run); the wall-time
profiler and its trace; ``depth_to_normal`` and the normal loss against
JAX's (1e-6; the loss tolerances of ``test_torch_train.py``), and a CLI
run with the normal loss; the sweep runner's commands and ``log.json``."""

import json
import re
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gstex_torch.data.blender import parse_blender
from gstex_torch.data.manager import FullImageCache
from gstex_torch.data.synthetic import orbit_camera as torbit
from gstex_torch.data.synthetic import write_blender_dataset
from gstex_torch.models import gstex as tmodel
from gstex_torch.models.init_io import load_scene_npz
from gstex_torch.ops import normals as tnormals
from gstex_torch.scripts import experiments as texp
from gstex_torch.scripts import train as ttrain
from gstex_torch.train import optim as toptim
from gstex_torch.train.trainer import Trainer, TrainerConfig
from gstex_torch.utils import profiler as tprof
from gstex_torch.utils import writer as twriter
from gstex_tpu.data.synthetic import orbit_camera as jorbit
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.ops import normals as jnormals
from gstex_tpu.utils import writer as jwriter
from test_torch_train import loss_inputs
from test_torch_train_cli import small_scene_npz

NOTICE = re.compile(r"^\[writer\] (\w+) unavailable \((\w+)\); continuing "
                    r"with local sinks$", re.M)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 300-surfel scene file and a 3-view 48x64 Blender dataset of it
    with a 1-view test split."""
    root = tmp_path_factory.mktemp("train_io")
    stats = small_scene_npz(root / "scene.npz", n=300)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8))
    params, buffers = load_scene_npz(cfg, stats, seed=0, device="cpu")
    data = root / "scene0"
    write_blender_dataset(data, cfg, params, buffers, 3, 48, 64)
    write_blender_dataset(data, cfg, params, buffers, 1, 48, 64,
                          split="test")
    return stats, data


class _Stub:
    """A trainer that records its config and trains nothing."""

    seen = []

    def __init__(self, tcfg, *a, **k):
        _Stub.seen.append(tcfg)

    def train(self):
        return []

    def eval_all(self):
        return {}


@pytest.mark.parametrize("flags", [
    [],
    ["--load-checkpoint", "run/checkpoints/step-000000002.ckpt.npz",
     "--experiment-name", "exp", "--steps-per-save", "3",
     "--steps-per-eval-image", "4", "--vis", "wandb,comet",
     "--set", "trainer.steps_per_save=5", "--set", "trainer.log_every=2"]],
    ids=["defaults", "flags"])
def test_cli_flags_reach_the_config_as_jax(dataset, flags, tmp_path,
                                           monkeypatch):
    from gstex_tpu.scripts import train as jtrain

    _, data = dataset
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("gstex_tpu.train.trainer.Trainer", _Stub)
    monkeypatch.setattr(ttrain, "Trainer", _Stub)
    # the scene is not what this test reads: a one-surfel stand-in
    scene = SimpleNamespace(means=np.zeros((1, 3)),
                            texture=np.zeros((1, 8, 8, 3)))
    monkeypatch.setattr(jtrain, "build_model", lambda *a: (scene, None))
    monkeypatch.setattr(ttrain, "build_model", lambda *a: (scene, None))
    argv = ["gstex-blender-nvs", "--data", str(data), "--num-random", "50",
            "--max-num-iterations", "7"] + flags
    _Stub.seen.clear()
    jtrain.main(argv)
    ttrain.main(argv + ["--device", "cpu"])
    want, got = _Stub.seen
    for f in ("max_num_iterations", "steps_per_save", "steps_per_eval_image",
              "steps_per_eval_all_images", "vis", "load_checkpoint",
              "log_every", "save_only_latest_checkpoint", "seed"):
        assert getattr(got, f) == getattr(want, f), f
    exp = "exp" if flags else data.name
    for tc in (want, got):
        assert re.fullmatch(rf"outputs/{exp}/gstex-blender-nvs/"
                            r"\d{4}-\d\d-\d\d_\d{6}", tc.output_dir)
    if flags:
        assert got.steps_per_save == 3 and got.vis == "wandb,comet"


def test_writer_matches_jax(tmp_path, capsys):
    calls = [(0, {"loss": 0.5, "psnr": 20.0}), (5, {"loss": 0.25}),
             (10, {"eval_psnr": 21.5, "eval_ssim": 0.75})]
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    outs = {}
    for name, mod in (("jax", jwriter), ("port", twriter)):
        w = mod.Writer(tmp_path / name, vis="tensorboard,wandb")
        for step, vals in calls:
            w.scalars(step, vals)
        w.image(10, "eval_rgb", img)
        w.close()
        outs[name] = capsys.readouterr().out
    assert NOTICE.findall(outs["port"]) == NOTICE.findall(outs["jax"]) == [
        ("wandb", "ModuleNotFoundError")]
    rows = {n: [json.loads(ln) for ln in (tmp_path / n / "events.jsonl")
                .read_text().splitlines()] for n in ("jax", "port")}
    strip = lambda r: {k: v for k, v in r.items() if k != "t"}
    assert [strip(r) for r in rows["port"]] == [strip(r) for r in rows["jax"]]
    assert all(list(r)[:2] == ["step", "t"] for r in rows["port"])
    console = lambda s: [ln for ln in s.splitlines() if ln.startswith("[step")]
    assert console(outs["port"]) == console(outs["jax"])
    png = "images/eval_rgb_000000010.png"
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" /
                                                        png)),
                                  np.asarray(Image.open(tmp_path / "jax" /
                                                        png)))
    with pytest.raises(ValueError, match="unknown"):
        twriter.Writer(tmp_path / "x", vis="tensorbaord")


def test_trainer_cadences_and_resume(dataset, tmp_path, capsys):
    """Log rows each step; an eval image and its scalars every 2 steps;
    the whole eval set's ``eval_all_*`` scalars every 2 steps; saves every
    2 steps. Resumed from its step-3 checkpoint, the run starts at step 3
    and saves on the absolute step."""
    stats, data = dataset
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8),
                             pixel_num=2e4, pair_cap=1 << 14, s_max=256)
    params, buffers = load_scene_npz(cfg, stats, seed=1, device="cpu")

    def trainer(out, **kw):
        tcfg = TrainerConfig(**{
            "max_num_iterations": 3, "steps_per_save": 2,
            "steps_per_eval_image": 2, "steps_per_eval_all_images": 2,
            "log_every": 1, "save_only_latest_checkpoint": False,
            "output_dir": str(out), "vis": "comet", **kw})
        caches = [FullImageCache.build(parse_blender(data, s), device="cpu")
                  for s in ("train", "test")]
        return Trainer(tcfg, cfg, toptim.OptimConfig(), params, buffers,
                       *caches)

    # the profiler's sections are per process: drop what earlier tests on
    # this worker timed (a re-chart among them)
    tprof.reset()
    trainer(tmp_path / "a").train()
    out = capsys.readouterr().out
    assert NOTICE.findall(out) == [("comet", "ModuleNotFoundError")]
    assert "train_iteration" in out and "retexture_after" not in out
    rows = [json.loads(ln) for ln in
            (tmp_path / "a" / "events.jsonl").read_text().splitlines()]
    logs = [r["step"] for r in rows if "loss" in r]
    evals = [r["step"] for r in rows if "eval_psnr" in r]
    alls = [r for r in rows if "eval_all_psnr" in r]
    assert logs == [0, 1, 2] and evals == [0, 2]
    assert [r["step"] for r in alls] == [2]
    assert {"eval_all_fps", "eval_all_psnr_std", "eval_all_texel_count"} \
        <= set(alls[0]) and "eval_all_lpips" not in alls[0]
    assert sorted(p.name for p in (tmp_path / "a" / "images").iterdir()) == [
        "eval_rgb_000000000.png", "eval_rgb_000000002.png"]
    ckpts = tmp_path / "a" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == [
        "step-000000003.ckpt.pt"]

    tr = trainer(tmp_path / "b", max_num_iterations=6,
                 load_checkpoint=str(ckpts / "step-000000003.ckpt.pt"))
    hist = tr.train()
    assert [h["step"] for h in hist] == [3, 4, 5]
    assert sorted(p.name for p in (tmp_path / "b" / "checkpoints")
                  .iterdir()) == ["step-000000005.ckpt.pt",
                                  "step-000000006.ckpt.pt"]


def test_profiler(tmp_path):
    tprof.reset()

    @tprof.time_function
    def work():
        return sum(range(1000))

    for _ in range(3):
        work()
    with tprof.time_section("outer"):
        work()
    table = tprof.summary().splitlines()
    assert table[0].split() == ["section", "total_s", "calls", "mean_ms"]
    calls = {ln.split()[0]: int(ln.split()[2]) for ln in table[1:]}
    assert calls == {"test_profiler.<locals>.work": 4, "outer": 1}
    tprof.reset()
    assert tprof.summary().splitlines()[1:] == []
    tprof.start_trace(str(tmp_path / "trace"))
    torch.ones(8) @ torch.ones(8)
    path = tprof.stop_trace()
    assert "traceEvents" in json.loads(path.read_text())


def test_depth_to_normal_matches_jax():
    h, w = 24, 32
    depths = np.random.default_rng(4).uniform(2, 4, (h, w)).astype(
        np.float32)
    tcam = torbit(h, w, azimuth=0.7, device="cpu")
    jcam = jorbit(h, w, azimuth=0.7)
    np.testing.assert_allclose(
        tnormals.depths_to_points(torch.as_tensor(depths), tcam).numpy(),
        np.asarray(jnormals.depths_to_points(jnp.asarray(depths), jcam)),
        atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(
        tnormals.depth_to_normal(torch.as_tensor(depths), tcam).numpy(),
        np.asarray(jnormals.depth_to_normal(jnp.asarray(depths), jcam)),
        atol=1e-6, rtol=0)


def test_normal_loss_matches_jax():
    import jax

    outs, gt = loss_inputs(seed=2)
    est = np.random.default_rng(5).standard_normal(gt.shape).astype(
        np.float32)
    est /= np.linalg.norm(est, axis=-1, keepdims=True)
    kw = dict(use_normal_loss=True, lambda_normal=0.05)
    jcfg, tcfg = jmodel.GStexConfig(**kw), tmodel.GStexConfig(**kw)
    assert not tmodel.lean_losses(tcfg) and not jmodel.lean_losses(jcfg)

    def jloss(o):
        return jmodel.loss_fn(jcfg, {**o, "estimated_normals":
                                     jnp.asarray(est)}, jnp.asarray(gt), 700)

    (jtotal, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    touts = {k: torch.tensor(v, requires_grad=True) for k, v in outs.items()}
    ttotal, tparts = tmodel.loss_fn(
        tcfg, {**touts, "estimated_normals": torch.tensor(est)},
        torch.tensor(gt), 700)
    ttotal.backward()
    assert abs(float(ttotal.detach()) - float(jtotal)) <= 1e-6
    for k in jparts:
        assert abs(float(tparts[k].detach()) - float(jparts[k])) <= 1e-6, k
    assert float(tparts["normal_loss"].detach()) != 0.0
    for k in outs:
        np.testing.assert_allclose(touts[k].grad.numpy(),
                                   np.asarray(jgrads[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)


def test_cli_trains_with_the_normal_loss(dataset, tmp_path):
    """Two steps with the normal loss on: the full kernels' plain
    versions, a finite non-zero normal term, and the render's estimate
    equal to ``depth_to_normal`` of its own depth."""
    stats, data = dataset
    res = ttrain.main([
        "gstex-blender-nvs", "--data", str(data), "--scene-npz", str(stats),
        "--max-num-iterations", "2", "--pixel-num", "2e4", "--set",
        "model.use_normal_loss=true", "--set", "model.lambda_normal=0.05",
        "--vis", "wandb", "--output-dir", str(tmp_path), "--device", "cpu"])
    terms = [h["normal_loss"] for h in res["history"]]
    assert all(np.isfinite(terms)) and all(t != 0 for t in terms)
    cfg = tmodel.GStexConfig(renderer="pallas", chart_pad=(8, 8),
                             use_normal_loss=True, pair_cap=1 << 14,
                             s_max=256)
    params, buffers = load_scene_npz(cfg, stats, seed=0, device="cpu")
    cam = torbit(48, 64, device="cpu")
    out = tmodel.render(cfg, params, buffers, cam, 0, torch.zeros(3))
    torch.testing.assert_close(out["estimated_normals"],
                               tnormals.depth_to_normal(out["depth"], cam),
                               rtol=0, atol=0)
    assert not out["estimated_normals"].requires_grad


def test_experiments_sweep(dataset, tmp_path, monkeypatch):
    """The Blender NVS sweep over one scene: the train command it runs
    and the run's abridged eval metrics in ``log.json``."""
    _, data = dataset
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", str(ttrain.Path(__file__).parents[1]))
    # one intra-op thread in the train process, as in this module's tests
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    log = texp.main([
        "blender-nvs", "--data-root", str(data.parent), "--scenes",
        data.name, "--output-root", "sweep", "--train-args",
        "--max-num-iterations", "2", "--num-random", "200", "--pixel-num",
        "2e4", "--vis", "wandb", "--device", "cpu"])
    saved = json.loads((tmp_path / "sweep" / "blender-nvs" / "log.json")
                       .read_text())
    assert saved == log
    (cmd,) = log["commands"]
    assert cmd.startswith(f"{sys.executable} -m gstex_torch.scripts.train "
                          f"gstex-blender-nvs --data {data}")
    assert cmd.endswith("--max-num-iterations 2 --num-random 200 "
                        "--pixel-num 2e4 --vis wandb --device cpu")
    (run,) = log["runs"]
    assert set(run) == {"data", "train_s", *texp.KEEP_KEYS}
    assert run["lpips"] is None and np.isfinite(run["psnr"])
    assert texp.LOD_SIZES == [128, 512, 2048, 8192, 32768]
