"""The port's tile-row mesh (``gstex_torch/parallel/``) against the JAX
package's makers (``gstex_tpu/parallel/shard.py``) on the CPU.

One group of 8 gloo ranks, started once for the module
(``torch_ranks.run_ranks``), runs every case on a mesh of its first
ranks: the sharded render at 2 and 4 ranks, the train step at 2, 4 and 8
(8-row bands: the SSIM halo spans two bands), the camopt step at 2 and
4, the 2x2 data-parallel step, and a masked step at 4. JAX runs its makers on the first
devices of ``tests/conftest.py``'s 8 host devices, on the inputs of
``tests/test_sharding.py`` (64x48, 8x16 tiles, pad (4, 4), 48 surfels,
black background); the weights cross as numpy. The port runs the flat
tier (on the CPU, its kernels' plain versions); JAX its ``xla`` tier,
and ``pallas_interpret`` for the camopt step, whose pose gradient JAX's
``xla`` tier does not carry through the records (ROADMAP, PR 16). Each
sharded result is also held against the port's single-device step, and
every mesh's replicas against each other, bit for bit. The tolerances
are ``tests/test_sharding.py``'s. The masked step pins a departure:
JAX's trainer drops the mask on its mesh, the port carries it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gstex_torch.models import gstex as tmodel
from gstex_torch.models.convert import params_from_jax
from gstex_torch.parallel import scaling as tscaling
from gstex_torch.train import optim as toptim
from gstex_torch.train import step as tstep
from gstex_tpu.data.synthetic import orbit_camera as jorbit
from gstex_tpu.models import gstex as jmodel
from gstex_tpu.ops.camera import stack_cameras
from gstex_tpu.parallel import scaling as jscaling
from gstex_tpu.parallel import shard as jshard
from gstex_tpu.train import step as jstep
from test_sharding import CFG as JCFG
from test_sharding import H, W, setup
import torch_ranks

CFG = tmodel.GStexConfig(**{**dataclasses.asdict(JCFG),
                            "renderer": "pallas"})
DELTA1 = np.array([0.01, -0.02, 0.015, 0.004, -0.003, 0.002], np.float32)
CASES = [("render", 2, 0), ("render", 4, 0), ("step", 2, 0), ("step", 4, 0),
         ("step", 8, 0), ("camopt", 2, 0), ("camopt", 4, 0), ("dp", 4, 2),
         ("masked", 4, 0)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One host thread here (and, through the CLI, in each rank it
    starts): the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cam_tuple(cam):
    return (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
            cam.height, cam.width, np.array(cam.c2w))


@pytest.fixture(scope="module")
def inputs():
    """test_sharding.py's state, view and target, and the data-parallel
    step's two views and targets, as numpy."""
    state, tx, cam = setup()
    gt = jnp.clip(jmodel.render(JCFG, state.params, state.buffers, cam,
                                state.step, jnp.zeros(3))["rgb"] + 0.03,
                  0, 1)
    dp_cams = [jorbit(H, W, dist=3.0, azimuth=0.3 * i) for i in range(2)]
    dp_gts = [jnp.full((H, W, 3), 0.2 + 0.3 * i) for i in range(2)]
    np_tree = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}
    return {"jax": (state, tx, cam, gt, dp_cams, dp_gts),
            "params": np_tree(state.params),
            "buffers": np_tree(state.buffers),
            "cams": [cam_tuple(c) for c in [cam] + dp_cams],
            "gts": [np.asarray(g, np.float32) for g in [gt] + dp_gts],
            "delta1": DELTA1, "mask": disc_mask()}


def disc_mask():
    yy, xx = np.mgrid[:H, :W]
    inside = ((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (0.4 * W) ** 2
    return inside[..., None].astype(np.float32)


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """Every case's rank-0 results, from one group of 8 ranks."""
    payload = {"inputs": {k: v for k, v in inputs.items() if k != "jax"},
               "cfg": CFG, "hw": (H, W), "cases": CASES}
    return torch_ranks.run_ranks(8, torch_ranks.shard_cases, payload,
                                 tmp_path_factory.mktemp("shard_ranks"))


def single_state(inputs):
    return torch_ranks.port_state({k: v for k, v in inputs.items()
                                   if k != "jax"}, CFG)


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("tile",))


def assert_step_agrees(got, loss, means, texture):
    assert abs(got["metrics"]["loss"] - float(loss)) < 1e-5
    np.testing.assert_allclose(got["params"]["means"], np.asarray(means),
                               atol=1e-5)
    np.testing.assert_allclose(got["params"]["texture"],
                               np.asarray(texture), atol=1e-5)


def assert_replicas_equal(got):
    assert len(set(got["hashes"])) == 1, got["hashes"]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_render_matches_jax_and_single(inputs, port, n):
    state, _, cam, _, _, _ = inputs["jax"]
    want = jshard.make_sharded_render(JCFG, jax_mesh(n), H, W)(
        state, cam, jnp.zeros(3))
    got = port[f"render{n}x0"]["rgb"]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    tstate, cams = single_state(inputs)
    with torch.no_grad():
        single = tmodel.render(CFG, tstate.params, tstate.buffers, cams[0],
                               0, torch.zeros(3), eval_only=True)["rgb"]
    # a band's tiles hold the whole frame's lists: the same bits
    np.testing.assert_array_equal(got, single.numpy())


@pytest.fixture(scope="module")
def jax_step(inputs):
    state, tx, cam, gt, _, _ = inputs["jax"]
    s, m = jshard.make_sharded_train_step(JCFG, tx, jax_mesh(4), H, W)(
        state, cam, gt)
    return m["loss"], s.params.means, s.params.texture


@pytest.fixture(scope="module")
def single_step(inputs):
    tstate, cams = single_state(inputs)
    m = tstep.train_step(CFG, toptim.OptimConfig(max_steps=100), tstate,
                         cams[0], torch.as_tensor(inputs["gts"][0]))
    return m["loss"], tstate.params.means.detach(), \
        tstate.params.texture.detach()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_step_matches_jax_and_single(port, jax_step, single_step, n):
    """At 8 ranks a band is 8 rows: the SSIM halo takes rows of two
    bands, and its cotangent goes back to both."""
    got = port[f"step{n}x0"]
    assert_step_agrees(got, *jax_step)
    assert_step_agrees(got, *single_step)
    assert_replicas_equal(got)


@pytest.fixture(scope="module")
def jax_camopt(inputs):
    """JAX's sharded camopt step on ``pallas_interpret`` (2 devices)."""
    jcfg = dataclasses.replace(JCFG, renderer="pallas_interpret")
    state, tx, cam, gt, _, _ = inputs["jax"]
    pose, pose_tx = jstep.init_pose_state(3)
    pose = pose._replace(delta=pose.delta.at[1].set(jnp.asarray(DELTA1)))
    fn = jshard.make_sharded_train_step_camopt(jcfg, tx, pose_tx, "SO3xR3",
                                               jax_mesh(2), H, W)
    s, p, m = fn(state, pose, cam, jnp.int32(1), gt)
    return m, s.params.means, p.delta, p.opt_state.acc_grads


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_camopt_matches_jax_and_single(inputs, port, jax_camopt, n):
    got = port[f"camopt{n}x0"]
    m, means, delta, acc = jax_camopt
    assert abs(got["metrics"]["loss"] - float(m["loss"])) < 1e-5
    assert abs(got["metrics"]["camera_opt_regularizer"]
               - float(m["camera_opt_regularizer"])) < 1e-7
    np.testing.assert_allclose(got["params"]["means"], np.asarray(means),
                               atol=1e-5)
    np.testing.assert_allclose(got["delta"], np.asarray(delta), atol=1e-6)
    np.testing.assert_allclose(got["acc"], np.asarray(acc), atol=1e-4,
                               rtol=1e-3)
    # the port's single-device camopt step
    tstate, cams = single_state(inputs)
    pose = torch_ranks.pose_state(inputs)
    sm = tstep.train_step_camopt(CFG, toptim.OptimConfig(max_steps=100),
                                 tstate, pose, "SO3xR3", cams[0], 1,
                                 torch.as_tensor(inputs["gts"][0]))
    assert abs(got["metrics"]["loss"] - float(sm["loss"])) < 1e-5
    np.testing.assert_allclose(got["params"]["means"],
                               tstate.params.means.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got["delta"], pose.delta.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        got["acc"], pose.optimizer.state[pose.delta]["acc"].numpy(),
        atol=1e-4, rtol=1e-3)
    assert_replicas_equal(got)


def test_data_parallel_step_matches_jax_and_mean_gradients(inputs, port):
    """The 2x2 (data, tile) step: one update from the mean of the two
    views' gradients, as JAX's ``make_batch_sharded_train_step`` and the
    port's single-device gradients make it."""
    state, tx, _, _, dp_cams, dp_gts = inputs["jax"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "tile"))
    s, m = jshard.make_batch_sharded_train_step(JCFG, tx, mesh, H, W)(
        state, stack_cameras(dp_cams), jnp.stack(dp_gts))
    got = port["dp4x2"]
    assert_step_agrees(got, m["loss"], s.params.means, s.params.texture)
    assert_replicas_equal(got)
    # the port on one process: each view's gradients, their mean, Adam
    tstate, cams = single_state(inputs)
    grads = []
    for cam, gt in zip(cams[1:3], inputs["gts"][1:3]):
        out = tmodel.render(CFG, tstate.params, tstate.buffers, cam, 0,
                            torch.zeros(3))
        loss, _ = tmodel.loss_fn(CFG, out, torch.as_tensor(gt), 0)
        grads.append(torch.autograd.grad(loss, list(tstate.params),
                                         allow_unused=True))
    for leaf, g0, g1 in zip(tstate.params, *grads):
        leaf.grad = None if g0 is None else 0.5 * (g0 + g1)
    tstate.optimizer.step()
    np.testing.assert_allclose(got["params"]["means"],
                               tstate.params.means.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got["params"]["texture"],
                               tstate.params.texture.detach().numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_comm_volume_matches_jax(inputs, ndev):
    state = inputs["jax"][0]
    tparams, _ = params_from_jax(state.params, state.buffers, device="cpu")
    assert tscaling.comm_volume(tparams, 800, ndev) == \
        tuple(jscaling.comm_volume(state.params, 800, ndev))
    eff = tscaling.predicted_efficiency(70.0, tparams, 800, ndev,
                                        allreduce_gbps=100.0)
    want = jscaling.predicted_efficiency(70.0, state.params, 800, ndev,
                                         ici_gbps=100.0)
    assert eff == want


def test_masked_step_carries_the_mask_where_jax_drops_it(inputs, port,
                                                          jax_step):
    """The port's masked step on 4 ranks equals the masked single-device
    step of both packages. JAX's trainer calls its mesh step without the
    mask (``gstex_tpu/train/trainer.py:207-208``), which is its unmasked
    step: the departure ROADMAP records."""
    state, tx, cam, gt, _, _ = inputs["jax"]
    mask = jnp.asarray(inputs["mask"])
    s, m = jstep.make_train_step(JCFG, tx)(state, cam, gt, mask)
    got = port["masked4x0"]
    assert_step_agrees(got, m["loss"], s.params.means, s.params.texture)
    assert_replicas_equal(got)
    tstate, cams = single_state(inputs)
    sm = tstep.train_step(CFG, toptim.OptimConfig(max_steps=100), tstate,
                          cams[0], torch.as_tensor(inputs["gts"][0]),
                          torch.as_tensor(inputs["mask"]))
    assert_step_agrees(got, sm["loss"], tstate.params.means.detach(),
                       tstate.params.texture.detach())
    # JAX's mesh step, as its trainer calls it, is the unmasked step
    dropped_loss = float(jax_step[0])
    assert abs(dropped_loss - float(m["loss"])) > 1e-2
    assert abs(got["metrics"]["loss"] - dropped_loss) > 1e-2


def test_process_info(port):
    assert port["info"] == {"process_index": 0, "process_count": 8,
                            "local_devices": 1, "global_devices": 8}


def test_all_reduce_takes_a_strided_tensor(port):
    """A strided gradient (autograd's for some leaves on the card) is
    reduced in place through a contiguous copy; the backends refuse it
    as it is."""
    want = torch.arange(6.0).reshape(2, 3).t() * sum(range(1, 9))
    assert torch.equal(port["strided"], want)
