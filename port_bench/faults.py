"""Faults planted in the port's training step, for the checks that the
comparison catches them (``tests/test_pb_faults.py`` on the CPU,
``calibrate.py`` on the card). A training cell on one card can have three
of the kinds a comparison must catch; the fourth, an exchange between
cards left out, has no exchange here.

- ``unchanged``: the optimizer's update returns the state as it was;
- ``rechart_unchanged``: the re-chart returns the charts as they were;
- ``half_image``: the loss is the mean over the top half of the image
  only, the rest left out;
- ``altered``: the rendered image is altered where it is made, one level
  of eight bits (1/255) added to its red channel.
"""

from __future__ import annotations

import contextlib

import torch

from gstex_torch.models import gstex as model
from gstex_torch.train import optim
from gstex_torch.train import step as train_step

KINDS = ("unchanged", "rechart_unchanged", "half_image", "altered")


@contextlib.contextmanager
def planted(kind: str):
    """The port with fault ``kind`` for the duration of the block."""
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if kind == "unchanged":
        patch(optim.Adam, "step", lambda self, *a, **k: None)
    elif kind == "rechart_unchanged":
        patch(train_step, "rechart_step", lambda cfg, state: None)
    elif kind == "half_image":
        loss_fn = model.loss_fn

        def half(cfg, outputs, gt, step, mask=None):
            h = gt.shape[0] // 2
            return loss_fn(cfg, dict(outputs, rgb=outputs["rgb"][:h]),
                           gt[:h], step, mask=None if mask is None
                           else mask[:h])

        patch(model, "loss_fn", half)
    elif kind == "altered":
        render = model.render

        def altered(*args, **kwargs):
            out = render(*args, **kwargs)
            rgb = out["rgb"]
            return dict(out, rgb=torch.cat([rgb[..., :1] + 1.0 / 255.0,
                                            rgb[..., 1:]], -1))

        patch(model, "render", altered)
    else:
        raise ValueError(f"no fault {kind!r}; have {KINDS}")
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
