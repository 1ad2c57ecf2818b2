"""The flat-or-dense dispatch: ``use_flat_path`` answers as it did when
the flat backward kernel staged each splat's whole chart pad in shared
memory, for every chart pad from (4, 4) to (128, 128) and 16x16 and 32x32
tiles. The kernels no longer have that limit; the rule is a dispatch
decision, kept until the flat tier's place is decided by measurement."""

import pytest

from gstex_torch.ops.rasterize_api import use_flat_path

PADS = [(h, w) for h in range(4, 129, 4) for w in range(4, 129, 4)]
RENDERERS = ["pallas", "pallas5", "pallas_interpret", "pallas5_interpret",
             "pallas4", "pallas3", "xla"]


def staged_flat_backward_fits(pad, pixels: int) -> bool:
    """The first flat backward's shared memory: 14 per-pixel planes, and
    per staged splat two records (32 floats each: the record and its
    gradient sum) and two copies of the chart pad (the chart and its
    gradient), within the card's 227 KB per block."""
    per_splat = (2 * 32 + 2 * pad[0] * pad[1] * 3) * 4
    return 14 * pixels * 4 + per_splat <= 227 * 1024


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("renderer", RENDERERS)
def test_use_flat_path_keeps_the_staging_rule(renderer, tile):
    flat = renderer in ("pallas", "pallas5", "pallas_interpret",
                        "pallas5_interpret")
    got = {pad: use_flat_path(renderer, pad, tile * tile) for pad in PADS}
    want = {pad: flat and staged_flat_backward_fits(pad, tile * tile)
            for pad in PADS}
    assert got == want
    if flat:
        # both tiers occur on the grid, and (80, 88) is the last square-ish
        # pad on the flat tier at 32 x 32 tiles, as the docs say
        assert any(got.values()) and not all(got.values())
        if tile == 32:
            assert got[(80, 88)] and not got[(88, 88)]


def test_tiles_past_the_kernels_limit_are_dense():
    assert not use_flat_path("pallas", (8, 8), 64 * 64)
    assert use_flat_path("pallas", (8, 8), 32 * 32)
