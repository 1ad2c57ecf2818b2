"""gstex_torch stands alone: no module of the port, and not chip_smoke.py,
imports JAX or anything of gstex_tpu; the painting, viewer and data
modules import no image library (cv2, PIL). Importing the package turns TF32
off, so its float32 geometry runs in true float32."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "gstex_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "gstex_tpu")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_sources_found():
    assert len(SOURCES) > 30
    names = {p.relative_to(ROOT / "gstex_torch").as_posix() for p in SOURCES
             if p.is_relative_to(ROOT / "gstex_torch")}
    assert {"ops/rasterize_eval.py", "ops/rasterize_fwd.py",
            "ops/rasterize_bwd.py", "ops/ssim_fused.py", "train/trainer.py",
            "scripts/train.py", "utils/checkpoint.py", "ops/rasterize.py",
            "ops/rasterize_ref.py", "ops/rasterize_dense.py",
            "ops/rasterize_api.py", "ops/binning.py", "ops/pair_inputs.py",
            "ops/rasterize_v3.py", "ops/rasterize_v2.py",
            "ops/rasterize_v1.py", "data/nerfstudio_parser.py",
            "data/colmap.py", "data/pose_utils.py", "utils/ply.py",
            "data/jpeg.py", "data/undistort.py", "data/fisheye624.py",
            "data/resize.py", "ops/pano.py", "parallel/distributed.py",
            "parallel/shard.py", "parallel/scaling.py", "utils/lpips.py",
            "tools/dbscan.py", "scripts/completions.py",
            "scripts/dev_test.py"} <= names


def test_every_kernel_source_has_a_wrapper():
    """Each CUDA source under csrc/ is built by name from one module of
    ops/ (``_build.load("<name>")``), and from nowhere else."""
    sources = {p.stem for p in (ROOT / "gstex_torch" / "csrc").glob("*.cu")}
    assert sources == {"rasterize_eval", "rasterize_fwd", "rasterize_bwd",
                       "ssim_fused", "rasterize_dense_eval",
                       "rasterize_dense_fwd", "rasterize_dense_bwd",
                       "rasterize_v3_fwd", "rasterize_v3_bwd",
                       "rasterize_v2_fwd", "rasterize_v2_bwd",
                       "rasterize_v1_fwd", "rasterize_v1_bwd",
                       "texture_edit"}
    ops = "".join(p.read_text()
                  for p in (ROOT / "gstex_torch" / "ops").glob("*.py"))
    for name in sources:
        assert f'"{name}"' in ops, name


# the card's machine has neither cv2 nor PIL
NO_IMAGE_LIBRARY = ("ops/texture_edit.py", "models/editing.py",
                    "utils/draw.py", "viewer/server.py", "viewer/page.py",
                    "viewer/render_panel.py", "scripts/viewer.py",
                    "data/png.py", "data/jpeg.py", "data/undistort.py",
                    "data/fisheye624.py", "data/resize.py", "data/video.py",
                    "data/manager.py", "data/blender.py", "ops/pano.py",
                    "scripts/render.py", "train/trainer.py",
                    "chip_smoke.py")


@pytest.mark.parametrize("name", NO_IMAGE_LIBRARY)
def test_painting_and_viewer_import_no_image_library(name):
    path = ROOT / "gstex_torch" / name if name != "chip_smoke.py" else \
        ROOT / name
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in ("cv2", "PIL")]
    assert not bad, f"{name} imports {bad}"


def test_package_turns_tf32_off():
    import gstex_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
