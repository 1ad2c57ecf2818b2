"""Rebuild a trained run from its directory: the counterpart of
``gstex_tpu/scripts/eval_setup.py`` (the reference's ``eval_setup``,
``nerfstudio/utils/eval_utils.py:68-113``).

A ``gstex-torch-train`` run directory holds ``config.json`` (the method,
the dataset, and the model, optimizer and trainer configs with every
``--set`` override folded in and the chart pad pinned) and
``checkpoints/step-*.ckpt.pt``. ``eval_setup`` rebuilds the method from
the config, the train and test image caches through the run's own
dataparser, and a ``Trainer`` whose state is the latest checkpoint's.

The template state takes its leaf shapes from the checkpoint, never from a
fresh init: a re-chart changes the scene's ``texture_hw``, ``pixel_scale``
and ``mappings``, which only the checkpoint's buffers hold. The restored
params, buffers, optimizer state, generator and step are the saved ones
bit for bit. Pair capacities are sized from one demand pass over every
camera of both caches (``scripts.render.demand_caps``), so no eval or
render of a dataset view overflows.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from ..configs.methods import get_method
from ..data.manager import FullImageCache
from ..models import gstex as model
from ..train.optim import OptimConfig
from ..train.trainer import Trainer, TrainerConfig
from ..utils import checkpoint as ckpt_io
from ..utils.device import resolve_device
from .render import demand_caps
from .train import build_dataset


def run_dir_of(load_config) -> Path:
    """The run directory that ``--load-config`` names: the directory
    itself or its ``config.json``."""
    path = Path(load_config)
    return path.parent if path.name == "config.json" else path


def _tupled(value):
    """JSON lists back to the configs' tuples, nested ones too."""
    if isinstance(value, list):
        return tuple(_tupled(v) for v in value)
    return value


def _config(cls, saved: dict):
    return cls(**{k: _tupled(v) for k, v in saved.items()})


def eval_setup(load_config, device=None):
    """``(trainer, method, config)`` of the run at ``load_config`` (a run
    directory or its ``config.json``), on ``device`` (default the card).
    Raises ``FileNotFoundError`` where the run has no checkpoint."""
    run_dir = run_dir_of(load_config)
    dev = resolve_device(device)
    cfg = json.loads((run_dir / "config.json").read_text())
    method = get_method(cfg["method"])
    method.model = _config(model.GStexConfig, cfg["model"])
    method.optim = _config(OptimConfig, cfg["optim"])
    method.trainer = dataclasses.replace(
        _config(TrainerConfig, cfg["trainer"]), output_dir=str(run_dir),
        load_checkpoint=None, demand_size_caps=False)

    ck = ckpt_io.latest_checkpoint(run_dir / "checkpoints")
    if ck is None:
        raise FileNotFoundError(f"no checkpoint in {run_dir}/checkpoints")
    train_cache = FullImageCache.build(
        build_dataset(method, cfg["data"], "train"),
        seed=method.trainer.seed, device=dev)
    eval_cache = None
    try:
        eval_parsed = build_dataset(method, cfg["data"], "test")
    except FileNotFoundError:
        eval_parsed = None
    if eval_parsed is not None and len(eval_parsed.image_filenames) > 0:
        eval_cache = FullImageCache.build(eval_parsed, seed=1, device=dev)

    saved = torch.load(ck, map_location=dev, weights_only=True)
    params = model.GStexParams(**saved["params"])
    buffers = model.GStexBuffers(**saved["buffers"])
    cams = train_cache.cameras + (eval_cache.cameras if eval_cache else [])
    with torch.no_grad():
        pair_cap, s_max = demand_caps(method.model, params, buffers, cams,
                                      int(saved["step"]))
    method.model = dataclasses.replace(method.model, pair_cap=pair_cap,
                                       s_max=s_max)
    trainer = Trainer(method.trainer, method.model, method.optim, params,
                      buffers, train_cache, eval_cache, cfg)
    ckpt_io.load_checkpoint(ck, trainer.state)
    return trainer, method, cfg
