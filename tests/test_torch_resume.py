"""Training over several steps and resuming it, against the JAX package:
the port's trainer and JAX's from the same params, ground truth and camera
order for 8 steps on the ``xla`` tier with a black background (each
step's loss to 1e-5 relative, the final params to the single-step
tolerance of ``test_torch_train.py::test_train_step_matches_jax`` for
each of the 8 updates); the
JAX checkpoint's leaf order as the port writes it down; a JAX
``.ckpt.npz`` read by the port (params, buffers, step and every group's
Adam moments equal to JAX's own reading of it), then trained on to agree
with JAX's run; and a port run resumed from its own checkpoint equal to
an unbroken run bit for bit, also where groups accumulate gradients and
the checkpoint, written after a chunk of 5 steps, is mid-cycle."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.data.manager import FullImageCache as TCache
from gstex_torch.data.synthetic import orbit_camera as torbit
from gstex_torch.models import gstex as tmodel
from gstex_torch.scripts import parity as tparity
from gstex_torch.train import optim as toptim
from gstex_torch.train.trainer import Trainer as TTrainer
from gstex_torch.train.trainer import TrainerConfig as TTrainerConfig
from gstex_torch.utils import checkpoint as tckpt
from gstex_tpu.data.manager import FullImageCache as JCache
from gstex_tpu.data.synthetic import orbit_camera as jorbit
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.train import optim as joptim
from gstex_tpu.train.trainer import Trainer as JTrainer
from gstex_tpu.train.trainer import TrainerConfig as JTrainerConfig
from gstex_tpu.utils import checkpoint as jckpt

H, W, VIEWS, STEPS = 48, 64, 4, 8
CFG = dict(chart_pad=(4, 4), pixel_num=2e3, pair_cap=1 << 14, s_max=256,
           background_color="black", renderer="xla")
LEAVES = tmodel.GStexParams._fields
LRS = toptim.group_lrs(toptim.OptimConfig(max_steps=STEPS))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """A surfel sphere's views (8-bit) and a perturbed, untextured init,
    as numpy."""
    cfg = tmodel.GStexConfig(**CFG)
    s = tparity.surface_scene(150, chart_pad=cfg.chart_pad, seed=1,
                              device="cpu")
    p, b = tmodel.init_params(cfg, s["means"], s["log_scales"], s["quats"],
                              s["opacity_logits"], s["features_dc"],
                              s["features_rest"])
    cams = [torbit(H, W, azimuth=2 * np.pi * i / VIEWS, device="cpu")
            for i in range(VIEWS)]
    views = [(torch.clamp(v, 0, 1) * 255).to(torch.uint8).numpy()
             for v in tparity.render_views(cfg, p, b, cams)]
    p0 = tparity.perturbed_init(p, 150, seed=1)
    to_np = lambda t: type(t)(*(x.numpy() for x in t))
    return views, to_np(p0), to_np(b)


def port_trainer(scene, out, random_bg=False, accumulate=(), **tkw):
    views, p0, b = scene
    cfg = tmodel.GStexConfig(**{**CFG, **(
        {"background_color": "random"} if random_bg else {})})
    cache = TCache(
        cameras=[torbit(H, W, azimuth=2 * np.pi * i / VIEWS, device="cpu")
                 for i in range(VIEWS)],
        images=[torch.as_tensor(v).float() / 255.0 for v in views])
    tcfg = TTrainerConfig(**{
        "max_num_iterations": STEPS, "steps_per_save": 1,
        "steps_per_eval_image": 0, "save_only_latest_checkpoint": False,
        "log_every": 1, "output_dir": str(out), **tkw})
    params = tmodel.GStexParams(*(torch.as_tensor(x) for x in p0))
    buffers = tmodel.GStexBuffers(*(torch.as_tensor(x) for x in b))
    return TTrainer(tcfg, cfg, toptim.OptimConfig(
        max_steps=STEPS, gradient_accumulation=accumulate), params, buffers,
        cache)


@pytest.fixture(scope="module")
def jax_run(scene, tmp_path_factory):
    """JAX's trainer for 8 steps, a checkpoint after every step; returns
    its per-step losses, its trainer (final state) and its run dir."""
    views, p0, b = scene
    out = tmp_path_factory.mktemp("jax_run")
    cache = JCache(cameras=[jorbit(H, W, azimuth=2 * np.pi * i / VIEWS)
                            for i in range(VIEWS)], images=list(views))
    tcfg = JTrainerConfig(max_num_iterations=STEPS, steps_per_save=1,
                          steps_per_eval_image=0, log_every=1,
                          save_only_latest_checkpoint=False, steps_per_sync=1,
                          output_dir=str(out))
    tr = JTrainer(tcfg, jmodel.GStexConfig(**CFG),
                  joptim.OptimConfig(max_steps=STEPS),
                  jmodel.GStexParams(*(jnp.asarray(x) for x in p0)),
                  jmodel.GStexBuffers(*(jnp.asarray(x) for x in b)), cache)
    tr.train()
    rows = [json.loads(ln) for ln in
            (out / "events.jsonl").read_text().splitlines()]
    losses = {r["step"]: r["loss"] for r in rows if "loss" in r}
    return [losses[i] for i in range(STEPS)], tr, out


def jax_state(jax_run, step):
    _, tr, out = jax_run
    return jckpt.load_checkpoint(
        out / "checkpoints" / f"step-{step:09d}.ckpt.npz", tr.state)


def assert_params_agree(state, jparams, updates):
    """Each leaf's difference over its group's lr within 1e-3 for each of
    the ``updates`` since the packages shared a state (one update is held
    so in ``test_train_step_matches_jax``; the differences add up), on
    all but 1e-3 of the leaf's elements. That test exempts only elements
    of a near-zero gradient, where a first Adam update, the gradient's
    sign, may flip; a later update is m̂ / √v̂, which carries the
    gradient's relative float32 error wherever its terms cancel, so here
    any element may take the exemption."""
    for k, leaf in enumerate(LEAVES):
        lr = LRS[toptim.GROUP_OF_LEAF[k]]
        lr = lr(0) if callable(lr) else lr
        d = np.abs(state.params[k].detach().numpy()
                   - np.asarray(jparams[k])) / lr
        bad = d > 1e-3 * updates
        assert bad.sum() <= 1e-3 * bad.size, (leaf, int(bad.sum()), d.max())


def test_n_steps_match_jax(scene, jax_run, tmp_path):
    jlosses, jtr, _ = jax_run
    tr = port_trainer(scene, tmp_path)
    hist = tr.train()
    assert [h["camera"] for h in hist[:VIEWS]] == list(
        np.random.default_rng(0).permutation(VIEWS)[::-1])
    for i, (h, want) in enumerate(zip(hist, jlosses)):
        assert h["loss"] == pytest.approx(want, rel=1e-5), i
    assert tr.state.step == int(jtr.state.step) == STEPS
    assert_params_agree(tr.state, jtr.state.params, STEPS)


def test_jax_leaf_order_is_written_down(jax_run):
    _, tr, _ = jax_run
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tr.state)[0]]
    assert tckpt.jax_leaf_paths() == paths


def test_port_reads_jax_checkpoint_and_trains_on(scene, jax_run, tmp_path):
    jlosses, _, out = jax_run
    path = out / "checkpoints" / "step-000000002.ckpt.npz"
    want = jax_state(jax_run, 2)
    tr = port_trainer(scene, tmp_path, load_checkpoint=str(path),
                      max_num_iterations=4)
    st = tr.state
    assert st.step == int(want.step) == 2
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(st.params, k).detach().numpy(),
                                      np.asarray(getattr(want.params, k)))
    for k in tmodel.GStexBuffers._fields:
        got = getattr(st.buffers, k).numpy()
        ref = np.asarray(getattr(want.buffers, k))
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref)
    inner = want.opt_state.inner_states
    for group in st.optimizer.param_groups:
        adam = inner[group["name"]].inner_state[0]
        leaf = LEAVES[toptim.GROUP_OF_LEAF.index(group["name"])]
        s = st.optimizer.state[group["params"][0]]
        assert int(s["step"]) == int(adam.count) == 2, group["name"]
        np.testing.assert_array_equal(s["exp_avg"].numpy(),
                                      np.asarray(getattr(adam.mu, leaf)))
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(),
                                      np.asarray(getattr(adam.nu, leaf)))
    # the next two steps take the unbroken run's cameras
    for _ in range(2):
        tr.train_cache.next_train_idx()
    hist = tr.train()
    assert [h["step"] for h in hist] == [2, 3]
    for h in hist:
        assert h["loss"] == pytest.approx(jlosses[h["step"]], rel=1e-5)
    assert_params_agree(tr.state, jax_state(jax_run, 4).params, 2)


def test_resume_equals_an_unbroken_run(scene, tmp_path):
    """Random backgrounds: the generator's state rides the checkpoint."""
    whole = port_trainer(scene, tmp_path / "whole", random_bg=True,
                         max_num_iterations=4)
    hist = whole.train()
    ck = tmp_path / "whole" / "checkpoints" / "step-000000002.ckpt.pt"
    part = port_trainer(scene, tmp_path / "part", random_bg=True,
                        max_num_iterations=4, load_checkpoint=str(ck))
    for _ in range(2):
        part.train_cache.next_train_idx()
    rest = part.train()
    assert [h["loss"] for h in rest] == [h["loss"] for h in hist[2:]]
    for a, b in zip(part.state.params, whole.state.params):
        assert torch.equal(a, b)
    for a, b in zip(part.state.buffers, whole.state.buffers):
        assert torch.equal(a, b)
    for (_, a), (_, b) in zip(part.state.optimizer.state.items(),
                              whole.state.optimizer.state.items()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_accumulating_resume_mid_cycle_equals_an_unbroken_run(scene,
                                                              tmp_path):
    """``texture_dc`` accumulating 4 steps an update and ``xyz`` 5, a
    save every 5 steps and no log: steps 1-5 go through the scan in one
    chunk, and the checkpoint after it holds the counts ``advance`` left
    there, mid-cycle; a run resumed from it takes steps 6-7 in one chunk,
    bit-equal to the unbroken run."""
    kw = dict(random_bg=True, accumulate=(("texture_dc", 4), ("xyz", 5)),
              steps_per_save=5, log_every=0)
    whole = port_trainer(scene, tmp_path / "whole", **kw)
    assert [whole._chunk_size(s) for s in (0, 1, 6)] == [1, 5, 2]
    hist = whole.train()
    ck = tmp_path / "whole" / "checkpoints" / "step-000000006.ckpt.pt"
    saved = torch.load(ck, weights_only=True)["optimizer"]["state"]
    groups = list(toptim.GROUP_OF_LEAF)
    for group, k in (("xyz", 5), ("texture_dc", 4)):
        st = saved[groups.index(group)]
        assert (st["mini_step"], st["gradient_step"], int(st["step"])) == (
            6 % k, 1, 1), group
        assert float(st["acc"].abs().max()) > 0, group
    part = port_trainer(scene, tmp_path / "part", load_checkpoint=str(ck),
                        **kw)
    for _ in range(6):
        part.train_cache.next_train_idx()
    rest = part.train()
    assert [h["step"] for h in rest] == [6, 7]
    assert [h["loss"] for h in rest] == [h["loss"] for h in hist[6:]]
    for a, b in zip(part.state.params, whole.state.params):
        assert torch.equal(a, b)
    for (_, a), (_, b) in zip(part.state.optimizer.state.items(),
                              whole.state.optimizer.state.items()):
        assert a.keys() == b.keys()
        assert all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                   for k in a)
    st = part.state.optimizer.state[part.state.params.texture]
    assert (st["mini_step"], st["gradient_step"]) == (0, 2)


def test_load_checkpoint_takes_both_suffixes_only(scene, tmp_path):
    tr = port_trainer(scene, tmp_path)
    bad = tmp_path / "step-000000002.ckpt"
    bad.write_bytes(b"")
    with pytest.raises(ValueError, match="ckpt.pt"):
        tckpt.load_checkpoint(bad, tr.state)
    assert tckpt.SUFFIXES == (".ckpt.pt", ".ckpt.npz")
