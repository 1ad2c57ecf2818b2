"""gstex_torch stands alone: no module of the port, and not chip_smoke.py,
imports JAX or anything of gstex_tpu. Importing the package turns TF32
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
    assert len(SOURCES) > 20
    assert any(p.name == "rasterize_eval.py" for p in SOURCES)


def test_package_turns_tf32_off():
    import gstex_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
