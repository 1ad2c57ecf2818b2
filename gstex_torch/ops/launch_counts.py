"""The kernel wrappers' launch counts.

Each wrapper of a hand-written kernel registers itself here (``counted``)
and adds one to its ``launches`` where it launches its kernel, and
nowhere else; an entry that a wrapper of another name launches registers
an ``EntryCount``. A CUDA graph's capture runs the wrappers without running
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


class EntryCount:
    """The launch count of a kernel entry that has no wrapper of its own:
    a bf16 chart entry, which the float32 entry's wrapper launches when
    the charts are bfloat16. It carries a wrapper's ``__name__`` and
    ``launches``, and is not called."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0

    def __repr__(self):
        return f"EntryCount({self.__name__!r})"


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
