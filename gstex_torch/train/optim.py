"""Per-parameter-group Adam (counterpart of ``gstex_tpu/train/optim.py``).

| group         | param leaf      | lr                     | schedule |
|---------------|-----------------|------------------------|----------|
| xyz           | means           | spatial_scale · 1.6e-5 | exp → /10 over max_steps |
| features_dc   | features_dc     | 2.5e-3                 | — |
| features_rest | features_rest   | 1.25e-4                | — |
| opacity       | opacity_logits  | 0.05                   | — |
| scaling       | log_scales      | 5e-3                   | — |
| rotation      | quats           | 1e-3                   | — |
| texture_dc    | texture         | 1e-3                   | — |

``torch.optim.Adam`` with betas 0.9/0.999 and eps 1e-15, one param group
per row. The xyz learning rate is set before each update from the
group's count of updates already made, as optax evaluates a schedule.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.gstex import GStexParams


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Per-group optimizer settings (see module docstring)."""

    spatial_scale: float = 5.0
    xyz_lr_mult: float = 1.0
    max_steps: int = 15000
    features_dc_lr: float = 2.5e-3
    features_rest_lr: float = 2.5e-3 / 20
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    texture_lr: float = 1e-3
    adam_eps: float = 1e-15
    # per-group gradient accumulation, e.g. (("texture_dc", 4),)
    gradient_accumulation: tuple = ()


GROUP_OF_LEAF = GStexParams(
    means="xyz",
    log_scales="scaling",
    quats="rotation",
    opacity_logits="opacity",
    features_dc="features_dc",
    features_rest="features_rest",
    texture="texture_dc",
)


def exp_decay_schedule(lr_init: float, lr_final: float, max_steps: int,
                       warmup_steps: int = 0, ramp: str = "cosine"):
    """step -> lr: log-space interpolation from lr_init to lr_final over
    max_steps, after an optional warmup."""

    def fn(step):
        t = min(max((step - warmup_steps) / (max_steps - warmup_steps), 0.0),
                1.0)
        lr = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        if step < warmup_steps:
            frac = min(max(step / warmup_steps, 0.0), 1.0)
            lr = lr_init * (math.sin(0.5 * math.pi * frac)
                            if ramp == "cosine" else frac)
        return lr

    return fn


def group_lrs(cfg: OptimConfig) -> dict:
    """Group name -> constant lr, or a step -> lr schedule for xyz."""
    return {
        "xyz": exp_decay_schedule(cfg.spatial_scale * 1.6e-5 * cfg.xyz_lr_mult,
                                  cfg.spatial_scale * 1.6e-6, cfg.max_steps),
        "features_dc": cfg.features_dc_lr,
        "features_rest": cfg.features_rest_lr,
        "opacity": cfg.opacity_lr,
        "scaling": cfg.scaling_lr,
        "rotation": cfg.rotation_lr,
        "texture_dc": cfg.texture_lr,
    }


def make_optimizer(cfg: OptimConfig, params: GStexParams) -> torch.optim.Adam:
    """Adam over the seven leaves, one param group each (named by its
    ``GROUP_OF_LEAF`` group)."""
    if cfg.gradient_accumulation:
        raise NotImplementedError(
            "per-group gradient accumulation (optax.MultiSteps): ROADMAP "
            "Queue 1 item 9")
    lrs = group_lrs(cfg)
    groups = []
    for leaf, name in zip(params, GROUP_OF_LEAF):
        lr = lrs[name]
        groups.append({"params": [leaf], "name": name,
                       "lr": lr(0) if callable(lr) else lr})
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=cfg.adam_eps)


def set_step_lrs(opt: torch.optim.Adam, cfg: OptimConfig) -> None:
    """Set the scheduled groups' lr for their next update from the count
    of updates the group has made (optax's schedule count)."""
    lrs = group_lrs(cfg)
    for group in opt.param_groups:
        lr = lrs[group["name"]]
        if callable(lr):
            state = opt.state.get(group["params"][0])
            group["lr"] = lr(int(state["step"]) if state else 0)


def reset_texture_moments(opt: torch.optim.Adam) -> None:
    """Zero the texture group's Adam moments after a re-chart (its step
    count stays), as the reference's ``reshape_in_optim`` does."""
    for group in opt.param_groups:
        if group["name"] != "texture_dc":
            continue
        for p in group["params"]:
            state = opt.state.get(p)
            if state:
                state["exp_avg"].zero_()
                state["exp_avg_sq"].zero_()
