"""gstex-torch-dev-test: the port's local check (counterpart of
``gstex_tpu/scripts/dev_test.py``).

Runs the port's tests on the CPU (``tests/test_torch_*.py``, JAX on the
CPU as their reference; the ``cuda``-marked ones skip without a card), the
slow tier too with ``--full``; with ``--chip`` also ``python3
chip_smoke.py``, which needs one CUDA card. On the CPU
the tests prove only the kernels' plain versions; the kernels themselves
run in ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` on the
card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _run(name, cmd, env=None) -> bool:
    print(f"[dev-test] {name}: {' '.join(cmd)}", flush=True)
    r = subprocess.run(cmd, env=env, cwd=ROOT)
    if r.returncode != 0:
        print(f"[dev-test] {name} FAILED (rc={r.returncode})", flush=True)
        return False
    print(f"[dev-test] {name} passed", flush=True)
    return True


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Run the port's tests on the CPU, and its chip check.")
    p.add_argument("--full", action="store_true",
                   help="include the slow test tier (-m '')")
    p.add_argument("--chip", action="store_true",
                   help="also run python3 chip_smoke.py (needs a card)")
    p.add_argument("-k", default=None, help="pytest -k filter")
    args = p.parse_args(argv)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    pytest_cmd = [sys.executable, "-m", "pytest",
                  *sorted(str(f.relative_to(ROOT)) for f in
                          (ROOT / "tests").glob("test_torch_*.py")), "-q"]
    if args.full:
        pytest_cmd += ["-m", ""]
    if args.k:
        pytest_cmd += ["-k", args.k]
    ok = _run("pytest", pytest_cmd, env=env)
    if args.chip:
        ok &= _run("chip_smoke", [sys.executable, "chip_smoke.py"])
    if not ok:
        raise SystemExit(1)
    print("[dev-test] all green", flush=True)


if __name__ == "__main__":
    main()
