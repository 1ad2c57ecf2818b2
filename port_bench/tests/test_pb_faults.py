"""The comparison fails a run whose timed path is broken underneath, once
for each fault a training cell on one card can have, and fails the
control; a sound run passes. The harness's look for a card is skipped:
the run is driven on the CPU at a tiny size (``tiny.py``)."""

from __future__ import annotations

import pytest

from port_bench import faults, run
from port_bench.tests.tiny import tiny_spec

QUIET = dict(say=lambda s: None)


@pytest.mark.parametrize("kind", faults.KINDS)
def test_a_fault_is_not_correct(kind):
    with faults.planted(kind):
        out = run.run_cell(tiny_spec(), 77, 0.2, False, "cpu", **QUIET)
    assert out["correct"] is False
    failed = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert failed, out["checks"]


def test_the_control_is_not_correct():
    """The port's bf16 chart stream in its place (the flat tier's
    lower-precision path)."""
    sp = tiny_spec()
    from port_bench import train_cell

    build = train_cell.build

    def bf16(*args, **kwargs):
        return build(*args, **dict(kwargs, texel_dtype="bf16"))

    train_cell.build = bf16
    try:
        out = run.run_cell(sp, 78, 0.2, False, "cpu", **QUIET)
    finally:
        train_cell.build = build
    assert out["correct"] is False, out["checks"]
