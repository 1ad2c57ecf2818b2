"""gstex_torch — GStex (textured 2D Gaussian surfels) on PyTorch and CUDA.

The port of ``gstex_tpu`` to one NVIDIA H100. Module and function names
mirror ``gstex_tpu`` so each piece has an obvious counterpart; the
public layouts (wxyz quats, (3,4) nerfstudio c2w, dense ``(N, Ch, Cw, 3)``
charts, ``(H, W, C)`` maps) are the same, so one scene feeds both
packages. The package imports torch and numpy only.

Geometry here is tiny ``(*,3) @ (3,3)`` products whose rounding moves
ray–surfel hits by whole texels on trained scenes, so TF32 is switched off
for every float32 product and convolution as soon as the package loads.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
    raise RuntimeError("gstex_torch needs true fp32 geometry; TF32 is on")
