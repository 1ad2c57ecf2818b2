"""Bytes the sharded train step moves, and the scaling they allow
(counterpart of ``gstex_tpu/parallel/scaling.py``).

A step of ``parallel/shard.py`` issues two collectives of any size:

1. the gradient all-reduce over the whole ``GStexParams`` (the padded
   texture charts dominate: N · Ch · Cw · 3 float32). A ring all-reduce
   moves ``2 · bytes · (n − 1) / n`` a rank;
2. the SSIM halo: 10 rows of each band's image (10 · W · 3 float32) out,
   and their cotangents back.

The loss's scalars are a few bytes. Compute a rank shrinks about 1/n
(its band) while the all-reduce's payload stays, so efficiency falls
where step_compute / n nears the all-reduce's time. No link rate is
assumed here: the caller gives the one it measured.
"""

from __future__ import annotations

from typing import NamedTuple


def _tree_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree))


class CommVolume(NamedTuple):
    grad_psum_bytes: int      # the whole gradient, all-reduced once a step
    halo_bytes: int           # the SSIM halo a band sends a step
    per_chip_allreduce_bytes: int  # ring traffic a rank (n ranks)


def comm_volume(params, width: int, ndev: int,
                halo_rows: int = 10) -> CommVolume:
    """Bytes each collective moves a train step on an ndev-rank mesh."""
    grad_bytes = _tree_bytes(params)
    halo = halo_rows * width * 3 * 4
    ring = int(2 * grad_bytes * (ndev - 1) / max(ndev, 1))
    return CommVolume(grad_psum_bytes=grad_bytes, halo_bytes=halo,
                      per_chip_allreduce_bytes=ring)


def predicted_efficiency(step_ms_single: float, params, width: int,
                         ndev: int, allreduce_gbps: float,
                         overlap: float = 0.0) -> dict:
    """Scaling efficiency at ndev ranks from a measured single-card step
    time and an all-reduce bandwidth (GB/s a rank, measured on the
    machine it is for). Compute shards ~1/ndev; the all-reduce's payload
    does not. ``overlap`` in [0, 1] is the share of the all-reduce hidden
    behind other work (0: fully exposed, the conservative bound)."""
    cv = comm_volume(params, width, ndev)
    comm_ms = cv.per_chip_allreduce_bytes / (allreduce_gbps * 1e9) * 1e3
    compute_ms = step_ms_single / ndev
    exposed = comm_ms * (1.0 - overlap)
    eff = compute_ms / (compute_ms + exposed)
    return {
        "ndev": ndev,
        "compute_ms": round(compute_ms, 3),
        "allreduce_ms": round(comm_ms, 3),
        "exposed_comm_ms": round(exposed, 3),
        "efficiency": round(eff, 4),
        "grad_psum_mb": round(cv.grad_psum_bytes / 1e6, 2),
        "halo_kb": round(cv.halo_bytes / 1e3, 1),
    }
