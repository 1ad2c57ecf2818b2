"""Builds the port's CUDA kernels and its host C++ at first use and loads
them with ctypes.

Each ``gstex_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into a shared
library with a plain C interface, ``build/kernels/lib<name>-<hash>.so`` at
the repository root (the hash is of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header is rebuilt). Each
``csrc/<name>.cpp`` (host code: the JPEG decoder) is compiled the same way
by the host compiler ``c++``, which nvcc needs anyway. Sources in the
repository are the only input; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# no --use_fast_math, and no FMA contraction: see the precision note in
# csrc/rasterize_eval.cu
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) per kernel source
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return str(path)


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names) -> None:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def _host_target(name: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for the host source ``csrc/<name>.cpp``, built
    by ``c++`` if it has no up-to-date library."""
    key = f"host:{name}"
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    out = _host_target(name)
    if not out.exists():
        cxx = shutil.which(os.environ.get("CXX", "c++"))
        if cxx is None:
            raise RuntimeError(f"no host C++ compiler (c++) to build "
                               f"csrc/{name}.cpp")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(
            [cxx, *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
            capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"c++ failed for {name}:\n{build_logs[name]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _loaded[key] = lib
    return lib
