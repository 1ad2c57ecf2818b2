"""The kernel wrappers' launch counts.

Each wrapper of a hand-written kernel registers itself here (``counted``)
and adds one to its ``launches`` where it launches its kernel, and
nowhere else. A CUDA graph's capture runs the wrappers without running
their kernels, and its replays run the kernels without the wrappers, so
the code that captures a graph takes back the launches its capture
counted (``take_back``) and adds them once a replay (``add``).
"""

from __future__ import annotations

# every registered wrapper, in the order its module was imported
WRAPPERS: list = []


def counted(fn):
    """Register the kernel wrapper ``fn`` with a ``launches`` count of 0
    (usable as a decorator)."""
    fn.launches = 0
    WRAPPERS.append(fn)
    return fn


def snapshot() -> dict:
    """Every registered wrapper's count: ``{wrapper: launches}``."""
    return {fn: fn.launches for fn in WRAPPERS}


def take_back(before: dict) -> dict:
    """Set every count back to ``before`` (a ``snapshot``; 0 for a wrapper
    registered since) and return what each gained since, where it
    gained: ``{wrapper: launches}``."""
    gained = {}
    for fn in WRAPPERS:
        was = before.get(fn, 0)
        if fn.launches != was:
            gained[fn] = fn.launches - was
        fn.launches = was
    return gained


def add(launches: dict, times: int) -> None:
    """Add ``times`` × ``launches`` (``{wrapper: launches}``) to the
    counts."""
    for fn, k in launches.items():
        fn.launches += k * times
