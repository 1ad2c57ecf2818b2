"""Eval metrics: the port's trainer scores an eval view as the JAX
package's ``utils.metrics.image_metrics`` does, on the uint8-quantized
render (PSNR to 1e-5 relative, SSIM to 1e-6), with ``lpips`` reported as
``None`` where no LPIPS weights exist."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstex_torch.train import trainer as ttrainer
from gstex_torch.utils import metrics as tmetrics
from gstex_tpu.utils import metrics as jmetrics

PSNR_RTOL = 1e-5
SSIM_ATOL = 1e-6


def render_pair(shape=(64, 80, 3), seed=0):
    """A float render (values past [0, 1] included, as a raw composite
    before its clip can hold) and a ground truth near it."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pred = (gt + rng.normal(0, 0.05, shape)).astype(np.float32)
    return pred, gt


def trainer_metrics(monkeypatch, pred, gt) -> dict:
    """``Trainer._eval_metrics`` on one eval view whose render is
    ``pred``: the eval step is stubbed to return it, so only the metric
    path runs."""
    monkeypatch.setattr(ttrainer.step_mod, "eval_step",
                        lambda *a: {"rgb": torch.as_tensor(pred)})
    monkeypatch.setattr(ttrainer, "eval_background",
                        lambda *a: torch.zeros(3))
    cache = SimpleNamespace(get=lambda i: (None, torch.as_tensor(gt), None))
    fake = SimpleNamespace(eval_cache=cache, mcfg=None, state=None)
    return ttrainer.Trainer._eval_metrics(fake, 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_trainer_eval_metrics_match_jax(monkeypatch, seed):
    pred, gt = render_pair(seed=seed)
    ref = jmetrics.image_metrics(jnp.asarray(pred), jnp.asarray(gt))
    got = trainer_metrics(monkeypatch, pred, gt)
    assert ref["lpips"] is None and got["lpips"] is None
    assert abs(got["psnr"] - ref["psnr"]) <= PSNR_RTOL * abs(ref["psnr"])
    assert abs(got["ssim"] - ref["ssim"]) <= SSIM_ATOL
    # the float render scores otherwise: the quantization is what agrees
    assert abs(got["psnr"] - float(tmetrics.psnr(
        torch.as_tensor(gt), torch.as_tensor(pred).clamp(0, 1)))) > \
        PSNR_RTOL * abs(ref["psnr"])


def test_quantize_uint8_matches_jax():
    pred, _ = render_pair(shape=(16, 24, 3), seed=3)
    ref = np.asarray(jmetrics.quantize_uint8(jnp.asarray(pred)))
    got = tmetrics.quantize_uint8(torch.as_tensor(pred)).numpy()
    np.testing.assert_array_equal(got, ref)
