"""Method registry (counterpart of ``gstex_tpu/configs/methods.py``): the
Blender methods, with the JAX package's model, optimizer and trainer
settings. They render on the kernel path (``renderer="pallas"``: the flat
kernels where they take the scene's chart pad, else the dense-list ones).

| method             | pixel_num | bg    | iters | xyz lr    |
|--------------------|-----------|-------|-------|-----------|
| gstex-blender-init | 1e6       | white | 1     | 5·1.6e-5  |
| gstex-blender-nvs  | 1e6       | white | 15000 | 5·1.6e-5  |
| gstex-blender-lod  | 1e6       | white | 7000  | 5·1.6e-4  |

The nerfstudio-parser methods (``gstex-colmap-init``, ``gstex-dtu-*``)
raise ``NotImplementedError`` until that parser is ported.
"""

from __future__ import annotations

import dataclasses

from ..models.gstex import GStexConfig
from ..train.optim import OptimConfig
from ..train.trainer import TrainerConfig

NERFSTUDIO_METHODS = ("gstex-colmap-init", "gstex-dtu-nvs", "gstex-dtu-lod")


@dataclasses.dataclass
class MethodConfig:
    name: str
    dataparser: str                    # blender
    model: GStexConfig
    optim: OptimConfig
    trainer: TrainerConfig


def _blender(name, iters, pixel_num=1e6, xyz_mult=1.0, chart_pad=None):
    return MethodConfig(
        name=name,
        dataparser="blender",
        model=GStexConfig(pixel_num=pixel_num, background_color="white",
                          fix_init=False, chart_pad=chart_pad,
                          renderer="pallas"),
        optim=OptimConfig(spatial_scale=5.0, xyz_lr_mult=xyz_mult,
                          max_steps=iters),
        trainer=TrainerConfig(max_num_iterations=iters),
    )


def get_method(name: str) -> MethodConfig:
    methods = {
        "gstex": lambda: _blender("gstex", 15000),
        "gstex-blender-init": lambda: _blender("gstex-blender-init", 1),
        "gstex-blender-nvs": lambda: _blender("gstex-blender-nvs", 15000),
        "gstex-blender-lod": lambda: _blender("gstex-blender-lod", 7000,
                                              xyz_mult=10.0),
    }
    if name in NERFSTUDIO_METHODS:
        raise NotImplementedError(
            f"{name} reads nerfstudio/COLMAP data (nerfstudio_parser.py): "
            f"ROADMAP Queue 1 item 10")
    if name not in methods:
        raise KeyError(f"unknown method {name}; have {sorted(methods)}")
    return methods[name]()
