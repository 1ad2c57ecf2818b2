"""Method registry (counterpart of ``gstex_tpu/configs/methods.py``): the
GStex methods with the JAX package's model, optimizer, trainer and
dataparser settings. They render on the kernel path (``renderer="pallas"``:
the flat kernels where the dispatch rule keeps the scene's chart pad on
them, else the dense-list ones).

| method             | dataparser | pixel_num | bg    | fix_init | iters | xyz lr    |
|--------------------|------------|-----------|-------|----------|-------|-----------|
| gstex-blender-init | blender    | 1e6       | white | no       | 1     | 5·1.6e-5  |
| gstex-colmap-init  | nerfstudio | 1e7       | black | yes      | 1     | 2·1.6e-5  |
| gstex-blender-nvs  | blender    | 1e6       | white | no       | 15000 | 5·1.6e-5  |
| gstex-dtu-nvs      | nerfstudio | 1e6       | black | yes      | 15000 | 2·1.6e-5  |
| gstex-blender-lod  | blender    | 1e6       | white | no       | 7000  | 5·1.6e-4  |
| gstex-dtu-lod      | nerfstudio | 1e6       | black | yes      | 7000  | 2·1.6e-4  |

The nerfstudio methods read images downscaled by 2 (``images_2/``) and
hold out every 8th frame for eval.
"""

from __future__ import annotations

import dataclasses

from ..models.gstex import GStexConfig
from ..train.optim import OptimConfig
from ..train.trainer import TrainerConfig


@dataclasses.dataclass
class MethodConfig:
    name: str
    dataparser: str                    # blender | nerfstudio
    model: GStexConfig
    optim: OptimConfig
    trainer: TrainerConfig
    downscale_factor: int = 1
    eval_mode: str = "fraction"        # nerfstudio parser eval split
    eval_interval: int = 8


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


def _dtu(name, iters, pixel_num=1e6, xyz_mult=1.0, chart_pad=None):
    return MethodConfig(
        name=name,
        dataparser="nerfstudio",
        model=GStexConfig(pixel_num=pixel_num, background_color="black",
                          fix_init=True, chart_pad=chart_pad,
                          renderer="pallas"),
        optim=OptimConfig(spatial_scale=2.0, xyz_lr_mult=xyz_mult,
                          max_steps=iters),
        trainer=TrainerConfig(max_num_iterations=iters),
        downscale_factor=2,
        eval_mode="interval",
        eval_interval=8,
    )


def get_method(name: str) -> MethodConfig:
    methods = {
        "gstex": lambda: _blender("gstex", 15000),
        "gstex-blender-init": lambda: _blender("gstex-blender-init", 1),
        "gstex-blender-nvs": lambda: _blender("gstex-blender-nvs", 15000),
        "gstex-blender-lod": lambda: _blender("gstex-blender-lod", 7000,
                                              xyz_mult=10.0),
        # a 1e7 texel budget; the chart pad follows the scene
        # (resolve_chart_pad)
        "gstex-colmap-init": lambda: _dtu("gstex-colmap-init", 1,
                                          pixel_num=1e7),
        "gstex-dtu-nvs": lambda: _dtu("gstex-dtu-nvs", 15000),
        "gstex-dtu-lod": lambda: _dtu("gstex-dtu-lod", 7000, xyz_mult=10.0),
    }
    if name not in methods:
        raise KeyError(f"unknown method {name}; have {sorted(methods)}")
    return methods[name]()
