"""Lane sharding over several devices and processes (reverie_tpu.parallel's
port, less its GSPMD sharding tables: see mesh.py)."""

from .distributed import (
    allgather_blobs,
    batch_slices,
    gather_rows,
    global_mesh,
    initialize,
    local_mesh,
    mesh_is_multiprocess,
    prove_batch_distributed,
)
from .mesh import REP_AXIS, Mesh, Shard, lane_slices, make_mesh

__all__ = [
    "REP_AXIS",
    "Mesh",
    "Shard",
    "make_mesh",
    "lane_slices",
    "initialize",
    "global_mesh",
    "local_mesh",
    "mesh_is_multiprocess",
    "batch_slices",
    "allgather_blobs",
    "gather_rows",
    "prove_batch_distributed",
]
