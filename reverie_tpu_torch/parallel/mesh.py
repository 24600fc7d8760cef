"""Sharding of the repetition (lane) axis over several devices.

Port of reverie_tpu/parallel/mesh.py.  Every lane of a proof is independent:
its tape rows come from its own player keys, its executor column reads only
itself and its transcript hash is per column.  So a mesh is an ordered list
of shards, each a (process, torch.device) pair, process-major, and every
device stage splits its lanes into contiguous slices in shard order
(`lane_slices`, np.array_split: the slices may be uneven, and empty).  A
shard runs the one-device work at its lane count; the rep hashes and the
opened lanes' records meet in host memory (backend/host.py,
parallel/distributed.py `gather_rows`).

reverie_tpu's NamedSharding tables (`_REP_AXIS_OF`, `input_shardings`,
`output_shardings`, `shard_inputs`) and its zero-key rep padding are not
ported: GSPMD needs equal shards, and this split does not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

REP_AXIS = "rep"


def process_index() -> int:
    """This process's rank in torch.distributed's default group, 0 without
    one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The processes of torch.distributed's default group, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclass(frozen=True)
class Shard:
    """One device of one process: the lanes of a slice run there."""

    process: int
    device: torch.device


@dataclass(frozen=True)
class Mesh:
    """Shards in lane order, process-major (each process's lanes are one
    contiguous run); `axis` names the sharded axis, as a jax Mesh's does."""

    shards: Tuple[Shard, ...]
    axis: str = REP_AXIS

    def __post_init__(self):
        if not self.shards:
            raise ValueError("Mesh: no shards")
        procs = [s.process for s in self.shards]
        if procs != sorted(procs):
            raise ValueError("Mesh: the shards must be process-major")

    def __len__(self) -> int:
        return len(self.shards)

    @property
    def processes(self) -> List[int]:
        return sorted({s.process for s in self.shards})

    def local_devices(self) -> List[torch.device]:
        """This process's shards' devices, in shard order."""
        me = process_index()
        return [s.device for s in self.shards if s.process == me]


def lane_slices(R: int, mesh: Mesh) -> List[slice]:
    """The contiguous lanes of each shard at R lanes, in shard order: the
    slices of np.array_split(np.arange(R), len(mesh))."""
    q, r = divmod(R, len(mesh))
    bounds = np.cumsum([0] + [q + (i < r) for i in range(len(mesh))])
    return [slice(int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:])]


def cuda_devices(n: Optional[int] = None) -> List[torch.device]:
    """The first n visible CUDA devices (all without n); raises when CUDA is
    absent or fewer than n are visible, never capping n."""
    if not torch.cuda.is_available():
        raise RuntimeError("reverie_tpu_torch.parallel: no CUDA device "
                           "(torch.cuda.is_available() is false); pass devices=")
    count = torch.cuda.device_count()
    n = count if n is None else n
    if not 1 <= n <= count:
        raise ValueError(f"reverie_tpu_torch.parallel: {n} devices asked for, "
                         f"{count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def local_shards(devices: Sequence) -> Tuple[Shard, ...]:
    """Shards of this process on `devices`, in their order."""
    me = process_index()
    return tuple(Shard(me, torch.device(d)) for d in devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = REP_AXIS, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of this process's shards: the first n_devices visible CUDA
    devices (all of them without n_devices), or one shard on each entry of
    `devices` (a device may repeat: several shards on one card, or CPU
    devices in the tests)."""
    if devices is None:
        devices = cuda_devices(n_devices)
    elif n_devices is not None and n_devices != len(devices):
        raise ValueError(f"make_mesh: n_devices={n_devices} but {len(devices)} devices given")
    return Mesh(local_shards(devices), axis)


def check_mesh(mesh) -> Optional[Mesh]:
    """mesh, when it is None or the port's Mesh; TypeError otherwise (a jax
    Mesh among others)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a reverie_tpu_torch.parallel Mesh (make_mesh, "
                        f"global_mesh, local_mesh), not {type(mesh).__module__}."
                        f"{type(mesh).__name__}")
    return mesh
