"""The trainer's chunking of steps, as the benchmark drives it: a copy of
``gstex_torch/train/trainer.py:Trainer._chunk_size`` for one device, no
viewer, no pose optimisation and no resolution schedule (a CPU test holds
the two equal)."""

from __future__ import annotations


def chunk_size(step: int, steps_per_sync: int, cadences, max_steps: int) -> int:
    """Steps one scan makes from ``step``: ``steps_per_sync``, clipped so
    that the chunk ends on the next step of each cadence (an event at step
    s runs after step s) and at ``max_steps``."""
    n = steps_per_sync
    if n <= 1:
        return 1
    for c in cadences:
        if c and c > 0:
            nxt = step if step % c == 0 else step + (c - step % c)
            n = min(n, nxt - step + 1)
    n = min(n, max_steps - step)
    return max(n, 1)
