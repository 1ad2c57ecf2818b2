"""Process groups and the device mesh (counterpart of
``gstex_tpu/parallel/distributed.py``).

One process per rank, each with the whole training state. A rank joins
the group with ``init_distributed`` and lays the group out with
``make_mesh``, as JAX's ``data_tile_mesh`` lays out its devices: B rows
of the data axis, each a tile axis of N / B ranks, rank = row · (N / B) +
tile index. The backend is NCCL where each rank has its own CUDA device,
gloo for CPU ranks; ranks that share one card ask for gloo themselves.
Nothing here falls back from one backend to the other.

    init_distributed("tcp://host0:29500", num_processes=N, process_id=i)
    mesh = make_mesh(N)
    step = make_sharded_train_step(cfg, ocfg, mesh, H, W)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """NCCL for a rank on its own CUDA device, gloo for a CPU rank."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> bool:
    """Join the process group: at ``coordinator`` (``host:port``, or a
    ``tcp://`` or ``file://`` URL) as rank ``process_id`` of
    ``num_processes``, or, with no coordinator, where the environment
    (``torchrun``'s ``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) says.
    ``backend`` defaults to ``default_backend(device)`` (``device``
    defaults to CUDA). A single process without a group does nothing;
    returns whether a group is up."""
    if dist.is_initialized():
        return True
    if coordinator is None and "WORLD_SIZE" not in os.environ:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a "
                             f"coordinator address")
        return False
    backend = backend or default_backend(
        "cuda" if device is None else device)
    if coordinator is None:
        dist.init_process_group(backend)
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, tile) mesh of ``tile · data`` ranks.
    ``group`` spans the mesh and ``tile_group`` this rank's row of it.
    Every reduction over the data axis is part of a sum over the whole
    mesh (JAX's psum over the tile axis, then pmean over the data axis,
    is one sum over the mesh divided by B), so no group spans a column."""

    rank: int
    tile: int
    data: int
    group: object
    tile_group: object

    @property
    def tile_rank(self) -> int:
        return self.rank % self.tile

    @property
    def data_rank(self) -> int:
        return self.rank // self.tile


def make_mesh(num_devices: int, data_parallel: int = 0) -> Optional[Mesh]:
    """The mesh over ranks 0 .. ``num_devices`` − 1 of the group, with
    ``data_parallel`` rows (0 or 1: one row, the tile mesh). Every rank of
    the group calls it, in the same order (it makes process groups); a
    rank outside the mesh gets ``None``."""
    world = dist.get_world_size()
    if num_devices > world:
        raise ValueError(f"a mesh of {num_devices} ranks in a group of "
                         f"{world}")
    b = max(data_parallel, 1)
    if num_devices % b:
        raise ValueError(f"num_devices={num_devices} not divisible by "
                         f"data_parallel={b}")
    tile = num_devices // b
    group = (dist.group.WORLD if num_devices == world
             else dist.new_group(list(range(num_devices))))
    rows = [dist.new_group(list(range(d * tile, (d + 1) * tile)))
            if tile < num_devices else group for d in range(b)]
    rank = dist.get_rank()
    if rank >= num_devices:
        return None
    return Mesh(rank=rank, tile=tile, data=b, group=group,
                tile_group=rows[rank // tile])


def process_info() -> dict:
    """This process's rank and the group's size, one device a rank."""
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if up else 1,
    }


# gloo reduces and gathers in host memory: a CUDA tensor is copied to the
# host for it and back. Staging here keeps gloo's collectives on one path
# for CPU and CUDA tensors, the ones it has a CUDA path for (which stage
# the same way) and the ones it has none for.
def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """In-place all-reduce of ``t`` over ``group`` (a gradient autograd
    left strided is reduced through a contiguous copy: the backends take
    contiguous tensors only)."""
    buf = t.contiguous()
    if _staged(buf, group):
        buf = buf.cpu()
    dist.all_reduce(buf, op=op, group=group)
    if buf is not t:
        t.copy_(buf)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, stacked in rank order."""
    src = t.detach().contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)
