"""SSIM: gstex_torch ``ops/ssim.py`` against gstex_tpu ``ssim``, the plain
path of ``fused_ssim`` against gstex_tpu ``fused_ssim(..., interpret=True)``
(value and gradient), and the fused-path shape rule. Tolerances are the
JAX package's own (``tests/test_ssim.py``): 1e-6 on values, 1e-8 on the
gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.ops import ssim as tssim
from gstex_torch.ops import ssim_fused as tfused
from gstex_tpu.ops import ssim as jssim
from gstex_tpu.ops import ssim_fused as jfused

SHAPES = [(120, 64, 3), (160, 40, 3)]


def pair(shape, seed=2):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", SHAPES + [(64, 96, 3)])
def test_ssim_matches_jax(shape):
    a, b = pair(shape)
    want = float(jssim.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(tssim.ssim(torch.tensor(a), torch.tensor(b)))
    assert abs(got - want) <= 1e-6
    # per window, the two convolutions sum their taps in another order
    np.testing.assert_allclose(
        tssim.ssim_map(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jssim.ssim_map(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5)


def test_psnr_matches_jax():
    a, b = pair((16, 24, 3))
    np.testing.assert_allclose(
        float(tssim.psnr(torch.tensor(a), torch.tensor(b))),
        float(jssim.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    assert abs(float(tssim.psnr(torch.zeros(8, 8, 3),
                                torch.full((8, 8, 3), 0.1))) - 20.0) < 1e-4


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_ssim_matches_jax_value_and_grad(shape):
    a, b = pair(shape)
    assert tfused.fused_ssim_supported(shape)
    want, want_g = jax.value_and_grad(
        lambda x: jfused.fused_ssim(x, jnp.asarray(b), 1.0, True))(
            jnp.asarray(a))
    x = torch.tensor(a, requires_grad=True)
    y = torch.tensor(b, requires_grad=True)
    got = tfused.fused_ssim(x, y)
    (3.0 * got).backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    np.testing.assert_allclose(x.grad.numpy() / 3.0, np.asarray(want_g),
                               atol=1e-8)
    assert y.grad is None   # the ground truth gets no gradient


@pytest.mark.parametrize("shape", [(30, 64, 3), (41, 64, 3), (120, 64, 3),
                                   (160, 40, 3), (64, 96, 3), (800, 800, 3),
                                   (64, 10, 3), (56, 88, 3)])
def test_fused_ssim_supported_matches_jax(shape):
    assert tfused.fused_ssim_supported(shape) == \
        jfused.fused_ssim_supported(shape)


def test_fused_ssim_rejects_bad_inputs():
    a = torch.rand(40, 40, 3)
    with pytest.raises(ValueError, match="shape"):
        tfused.fused_ssim_value_and_grad(a, torch.rand(40, 41, 3))
    with pytest.raises(TypeError, match="float32"):
        tfused.fused_ssim_value_and_grad(a.double(), a.double())
    before = tfused.fused_ssim_value_and_grad.launches
    tfused.fused_ssim_value_and_grad(a, a)
    assert tfused.fused_ssim_value_and_grad.launches == before  # CPU: plain
