#!/usr/bin/env python3
"""Compare the machine code (SASS) of kernels built from two source trees.

    python3 tools/compare_sass.py --old DIR [--new DIR] [NAME ...]

Compiles each ``NAME.cu`` (by default the twelve kernels besides the v2
forward: the flat three, SSIM, the dense three, the v3 forward and
backward, the v2 backward and the v1 forward and backward; all but SSIM
share ``csrc/tile_walk.cuh`` with it, and the pair-space ones
``csrc/pair_slots.cuh``) from the ``--old`` and ``--new`` csrc
directories (``--new`` defaults to this tree's ``gstex_torch/csrc``)
to ``sm_90a`` cubins with the port's
compiler flags, disassembles them with ``cuobjdump -sass`` and compares
the instructions. The anonymous namespace's mangled name carries a hash
of the file, which is left out. Prints one JSON line per kernel and
exits non-zero where any differs. Needs the CUDA toolkit, not a card.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNELS = ["rasterize_eval", "rasterize_fwd", "rasterize_bwd", "ssim_fused",
           "rasterize_dense_eval", "rasterize_dense_fwd",
           "rasterize_dense_bwd", "rasterize_v3_fwd", "rasterize_v3_bwd",
           "rasterize_v2_bwd", "rasterize_v1_fwd", "rasterize_v1_bwd"]


def sass(nvcc, cuobjdump, src: Path, out: Path) -> list[str]:
    from gstex_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(out), str(src)],
                   check=True)
    text = subprocess.run([cuobjdump, "-sass", str(out)], check=True,
                          capture_output=True, text=True).stdout
    return [re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", ln)
            for ln in text.splitlines() if "Function" in ln or "/*" in ln]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True)
    ap.add_argument("--new", default=str(ROOT / "gstex_torch" / "csrc"))
    ap.add_argument("names", nargs="*", default=KERNELS)
    args = ap.parse_args()
    from gstex_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent
                                                 / "cuobjdump")
    same_all = True
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.names:
            old = sass(nvcc, cuobjdump, Path(args.old) / f"{name}.cu",
                       Path(tmp) / f"{name}.old.cubin")
            new = sass(nvcc, cuobjdump, Path(args.new) / f"{name}.cu",
                       Path(tmp) / f"{name}.new.cubin")
            same = old == new
            same_all &= same
            print(json.dumps({"kernel": name, "identical_sass": same,
                              "sass_lines": [len(old), len(new)]}),
                  flush=True)
    if not same_all:
        raise SystemExit("compare_sass: the SASS differs")


if __name__ == "__main__":
    main()
