"""The port's trainer and train CLI over a mesh of gloo ranks on the CPU
(``gstex-torch-train --device cpu --num-devices N [--data-parallel B]``).

- the CLI at 2 ranks and at 4 ranks in 2 rows of data parallelism, on a
  tiny Blender dataset: the runs train, rank 0 alone writes (each logged
  step once in ``events.jsonl``, one checkpoint, the closing eval), and
  the 2-rank run's losses are the one-process run's;
- the Trainer on one group of 4 ranks (``torch_ranks.trainer_cases``):
  the tile mesh, its steps 1-3 as one chunk of the sharded scan equal to
  the per-step run bit for bit (also with groups accumulating
  gradients), a resume from its step-2 checkpoint equal to the unbroken
  run bit for bit, data parallelism, camera pose optimization, a masked
  dataset against the one-process masked run; every run's replicas
  bit-equal; data parallelism on masks refused, as JAX refuses it;
- every refusal of JAX's trainer, the port's refusal of the normal loss
  under a mesh, of a mesh without its process group, and of
  ``--num-devices`` beyond the visible CUDA devices.

The flat tier on the CPU runs its kernels' plain versions."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gstex_torch.data.synthetic import surface_scene, write_blender_dataset
from gstex_torch.models import gstex as tmodel
from gstex_torch.scripts import train as train_cli
from gstex_torch.train import optim as toptim
from gstex_torch.train.trainer import Trainer, TrainerConfig
import torch_ranks

H, W, VIEWS = 48, 64, 4
CFG = tmodel.GStexConfig(renderer="pallas", chart_pad=(4, 4), pixel_num=2e3,
                         pair_cap=1 << 14, s_max=256)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One host thread here (and, through the CLI, in each rank it
    starts): the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 4-view train split and a 1-view test split of a 150-surfel
    scene; the scene itself, for the Trainer."""
    root = tmp_path_factory.mktemp("shard_data")
    s = surface_scene(150, chart_pad=(4, 4), device="cpu")
    params, buffers = tmodel.init_params(
        CFG, s["means"], s["log_scales"], s["quats"], s["opacity_logits"],
        s["features_dc"], s["features_rest"])
    write_blender_dataset(root, CFG, params, buffers, VIEWS, H, W)
    write_blender_dataset(root, CFG, params, buffers, 1, H, W,
                          split="test", azimuth0=0.4)
    return root, (params, buffers)


def cli(data_dir, out, *extra):
    return train_cli.main([
        "gstex-blender-nvs", "--data", str(data_dir), "--device", "cpu",
        "--num-random", "150", "--pixel-num", "2e3", "--renderer", "pallas",
        "--max-num-iterations", "3", "--steps-per-eval-image", "0",
        "--vis", "wandb", "--set", "trainer.log_every=1",
        "--output-dir", str(out), *extra])


@pytest.fixture(scope="module")
def cli_runs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_cli")
    return {name: (cli(data[0], root / name, *extra), root / name)
            for name, extra in (
                ("one", ()), ("two", ("--num-devices", "2")),
                ("dp", ("--num-devices", "4", "--data-parallel", "2")))}


@pytest.mark.parametrize("name", ["two", "dp"])
def test_cli_trains_on_gloo_ranks_and_rank_0_alone_writes(cli_runs, name):
    res, out = cli_runs[name]
    hist = res["history"]
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    rows = [json.loads(line) for line in
            (out / "events.jsonl").read_text().splitlines()]
    train_rows = [r["step"] for r in rows if "loss" in r]
    assert train_rows == [0, 1, 2]
    assert [p.name for p in (out / "checkpoints").iterdir()] == \
        ["step-000000003.ckpt.pt"]
    assert res["eval"] is not None and np.isfinite(res["eval"]["psnr"])
    assert json.loads((out / "config.json").read_text())["trainer"][
        "num_devices"] == {"two": 2, "dp": 4}[name]


def test_cli_two_ranks_train_as_one_process(cli_runs):
    one = [h["loss"] for h in cli_runs["one"][0]["history"]]
    two = [h["loss"] for h in cli_runs["two"][0]["history"]]
    np.testing.assert_allclose(two, one, atol=1e-5)
    a = torch.load(cli_runs["one"][1] / "checkpoints"
                   / "step-000000003.ckpt.pt", weights_only=True)
    b = torch.load(cli_runs["two"][1] / "checkpoints"
                   / "step-000000003.ckpt.pt", weights_only=True)
    for k in ("means", "texture", "opacity_logits"):
        np.testing.assert_allclose(b["params"][k], a["params"][k],
                                   atol=1e-5)


def disc_masks():
    yy, xx = np.mgrid[:H, :W]
    m = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (0.4 * H) ** 2)
    return [m[..., None].astype(np.float32) for _ in range(VIEWS)]


@pytest.fixture(scope="module")
def rank_runs(data, tmp_path_factory):
    payload = {"data": str(data[0]), "scene": data[1], "cfg": CFG,
               "root": str(tmp_path_factory.mktemp("shard_trainer")),
               "test_masks": disc_masks()}
    return payload, torch_ranks.run_ranks(4, torch_ranks.trainer_cases,
                                          payload,
                                          tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("name", ["tile", "scan", "resumed", "dp", "camopt",
                                  "masked", "scan_accum"])
def test_trainer_replicas_stay_bit_equal(rank_runs, name):
    got = rank_runs[1][name]
    assert len(set(got["hashes"])) == 1, got["hashes"]
    assert all(np.isfinite(h["loss"]) for h in got["history"])


def test_mesh_resume_equals_the_unbroken_run(rank_runs):
    runs = rank_runs[1]
    assert [h["step"] for h in runs["resumed"]["history"]] == [2, 3]
    assert [h["loss"] for h in runs["resumed"]["history"]] == \
        [h["loss"] for h in runs["tile"]["history"][2:]]
    assert runs["resumed"]["hashes"] == runs["tile"]["hashes"]


def test_mesh_scan_equals_the_per_step_run(rank_runs):
    """Steps 1-3 as one chunk of the sharded scan: the per-step run's
    metrics and state."""
    runs = rank_runs[1]
    assert [h["step"] for h in runs["scan"]["history"]] == [0, 1, 2, 3]
    assert runs["scan"]["history"] == runs["tile"]["history"]
    assert runs["scan"]["hashes"] == runs["tile"]["hashes"]


def test_mesh_scan_with_accumulating_groups_equals_the_per_step_run(
        rank_runs):
    """``texture_dc`` and ``xyz`` accumulating: steps 1-3 as one chunk of
    the sharded scan, its Adam updates from the chunk's table, give the
    per-step run's metrics and state (moments, means and host counts),
    and a state other than the plain runs'."""
    runs = rank_runs[1]
    assert [h["step"] for h in runs["scan_accum"]["history"]] == [
        0, 1, 2, 3]
    assert runs["scan_accum"]["history"] == runs["tile_accum"]["history"]
    assert runs["scan_accum"]["hashes"] == runs["tile_accum"]["hashes"]
    assert runs["scan_accum"]["hashes"] != runs["scan"]["hashes"]


def test_mesh_camopt_writes_one_pose_sidecar(rank_runs):
    payload, runs = rank_runs
    ck = Path(payload["root"]) / "camopt" / "checkpoints"
    assert sorted(p.name for p in ck.glob("pose-*.npz")) == \
        ["pose-000000002.npz"]
    assert all("camera_opt_regularizer" in h
               for h in runs["camopt"]["history"])


def test_masked_mesh_run_equals_the_one_process_run(rank_runs, tmp_path):
    """The port carries the mask into each band and its halo, where JAX's
    mesh step drops it (held in test_torch_shard.py)."""
    payload, runs = rank_runs
    one = torch_ranks.trainer(dict(payload, masks=payload["test_masks"]),
                              tmp_path, max_num_iterations=2)
    hist = one.train()
    np.testing.assert_allclose([h["loss"] for h in runs["masked"]["history"]],
                               [h["loss"] for h in hist], atol=1e-5)
    for a, b in zip(runs["masked"]["params"], one.state.params):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=1e-5)
    assert "masks" in runs["dp_masked"]


@pytest.mark.parametrize("change,match", [
    (dict(num_devices=4, data_parallel=3), "divisible"),
    (dict(num_devices=4, data_parallel=2), "num_downscales"),
    (dict(num_devices=4, data_parallel=2, camera_opt="SO3xR3"),
     "camera_opt"),
    (dict(num_devices=2), "use_normal_loss"),
    (dict(num_devices=2), "one process a rank"),
])
def test_mesh_refusals(tmp_path, change, match):
    cfg = CFG
    if match == "num_downscales":
        cfg = tmodel.GStexConfig(num_downscales=1)
    if match == "use_normal_loss":
        cfg = tmodel.GStexConfig(use_normal_loss=True)
    tcfg = TrainerConfig(output_dir=str(tmp_path), **change)
    with pytest.raises((ValueError, RuntimeError), match=match):
        Trainer(tcfg, cfg, toptim.OptimConfig(), None, None, [])


def test_cli_refuses_more_ranks_than_cards(data, tmp_path, monkeypatch):
    """One card a rank: no fallback to fewer cards or to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="num-devices 2: .*1 CUDA devices"):
        train_cli.main(["gstex-blender-nvs", "--data", str(data[0]),
                        "--num-devices", "2", "--output-dir",
                        str(tmp_path)])
