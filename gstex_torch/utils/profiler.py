"""Wall-time profiler: a running table of labelled sections (counterpart
of ``gstex_tpu/utils/profiler.py``).

``time_section`` and ``time_function`` add each call's host wall time to
its section; ``summary`` prints the table, longest total first. The
device tier is ``torch.profiler``: ``start_trace`` / ``stop_trace`` write
a Chrome trace of the host ops and CUDA kernels (with the ``gstex.*``
ranges of ``models.gstex.render`` and ``train.step.train_step``) into a
directory.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from pathlib import Path

_TIMES: dict[str, list] = defaultdict(lambda: [0.0, 0])
_TRACE: dict = {}


@contextlib.contextmanager
def time_section(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rec = _TIMES[name]
        rec[0] += time.perf_counter() - t0
        rec[1] += 1


def time_function(fn):
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with time_section(fn.__qualname__):
            return fn(*a, **kw)

    return wrapper


def summary() -> str:
    rows = sorted(_TIMES.items(), key=lambda kv: -kv[1][0])
    lines = [f"{'section':40s} {'total_s':>10s} {'calls':>8s} "
             f"{'mean_ms':>10s}"]
    for name, (total, calls) in rows:
        lines.append(f"{name:40s} {total:10.2f} {calls:8d} "
                     f"{1000 * total / max(calls, 1):10.2f}")
    return "\n".join(lines)


def reset():
    _TIMES.clear()


def start_trace(log_dir: str):
    """Start a ``torch.profiler`` trace of the host and, where a card is
    present, its kernels; ``stop_trace`` writes it as
    ``<log_dir>/trace.json``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _TRACE.update(prof=prof, dir=Path(log_dir))


def stop_trace() -> Path:
    prof, log_dir = _TRACE.pop("prof"), _TRACE.pop("dir")
    prof.stop()
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    return path
