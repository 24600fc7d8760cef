"""Multi-process proving over torch.distributed.

Port of reverie_tpu/parallel/distributed.py.  The two axes, both
embarrassingly parallel:

* ``global_mesh()`` -- ONE proof with its lanes sharded over every
  process's devices.  Each process runs its own shards; the per-lane rep
  hashes, online hashes and fail flags (97 B a lane) and then the opened
  lanes' records meet on every process (`gather_rows`), so that every
  process computes the same commitment, challenge and proof, as
  reverie_tpu's replicated output shardings give every process every
  buffer.

* ``prove_batch_distributed`` -- N independent proofs with the proof axis
  split across processes: each proves its slice, then the serialized proofs
  are all-gathered so every process returns the same full list.

The process group is gloo over TCP (`initialize`).  All the traffic is
host memory: the Fiat-Shamir step and the assembly run on the host, so what
crosses is already there (backend/host.py pulls every shard's buffers to
pinned host memory).  NCCL is not used: it moves device memory, so the
buffers would go back to the card first, and it allows one rank per GPU,
which would rule out two processes on one card, the one-card check of this
path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..proof.container import Proof
from .mesh import (REP_AXIS, Mesh, Shard, cuda_devices, local_shards, make_mesh,
                   process_count, process_index)


def initialize(coordinator_address: str, num_processes: int, process_id: int, **kw) -> None:
    """Join the multi-process runtime: torch.distributed's gloo group at
    tcp://coordinator_address ("host:port"), this process of rank
    process_id among num_processes.  Call once per process before building
    a mesh that spans processes."""
    import torch.distributed as dist

    dist.init_process_group(backend="gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def mesh_is_multiprocess(mesh: Optional[Mesh]) -> bool:
    """True if the mesh spans shards of more than one process."""
    return mesh is not None and len(mesh.processes) > 1


def global_mesh(axis: str = REP_AXIS, *, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over every device of every process (the lanes of one proof
    sharded over all of them), process-major: this process contributes
    `devices`, by default its visible CUDA devices."""
    import torch.distributed as dist

    mine = cuda_devices() if devices is None else [torch.device(d) for d in devices]
    if process_count() == 1:
        return Mesh(local_shards(mine), axis)
    every: List[Optional[list]] = [None] * process_count()
    dist.all_gather_object(every, [str(d) for d in mine])
    return Mesh(tuple(Shard(p, torch.device(d)) for p, devs in enumerate(every) for d in devs),
                axis)


def local_mesh(axis: str = REP_AXIS, *, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over this process's own devices only (by default its visible
    CUDA devices): independent per-process work inside a multi-process
    runtime."""
    return make_mesh(axis=axis, devices=devices)


def batch_slices(n: int) -> List[np.ndarray]:
    """Contiguous per-process index slices of an n-proof batch."""
    return np.array_split(np.arange(n), process_count())


def _allgather_rows(mat: np.ndarray) -> np.ndarray:
    """All-gather equal-shape row blocks from every process ->
    (num_processes * rows, cols), in process order."""
    import torch.distributed as dist

    if process_count() == 1:
        return np.asarray(mat)
    t = torch.from_numpy(np.ascontiguousarray(mat))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.cat(out).numpy()


def allgather_blobs(blobs: Sequence[bytes], max_rows: int) -> List[List[bytes]]:
    """All-gather variable-length byte strings: every process contributes up
    to ``max_rows`` blobs and receives every process's list (process order);
    padded rows come back as b""."""
    nproc = process_count()
    lens = np.zeros(max_rows, np.int64)
    lens[: len(blobs)] = [len(b) for b in blobs]
    all_lens = _allgather_rows(lens.reshape(max_rows, 1)).reshape(nproc, max_rows)
    maxlen = max(1, int(all_lens.max(initial=0)))
    mat = np.zeros((max_rows, maxlen), np.uint8)
    for i, b in enumerate(blobs):
        mat[i, : len(b)] = np.frombuffer(b, np.uint8)
    gathered = _allgather_rows(mat).reshape(nproc, max_rows, maxlen)
    return [[gathered[p, i, : all_lens[p, i]].tobytes() for i in range(max_rows)]
            for p in range(nproc)]


def gather_rows(mesh: Optional[Mesh], blocks: Sequence[np.ndarray], width: int) -> np.ndarray:
    """Every shard's (rows, width) block in shard order, on every process:
    `blocks` are this process's shards' blocks in their order (none for a
    shard with no rows).  Joined here, and on a mesh over several processes
    all-gathered in process order."""
    if len(blocks) == 1 and not mesh_is_multiprocess(mesh):
        return blocks[0]
    mine = np.concatenate(blocks) if blocks else np.zeros((0, width), np.uint8)
    if not mesh_is_multiprocess(mesh):
        return mine
    nproc = process_count()
    counts = _allgather_rows(np.array([[len(mine)]], np.int64)).ravel()
    most = int(counts.max())
    if most == 0 or width == 0:
        return np.zeros((int(counts.sum()), width), mine.dtype)
    pad = np.zeros((most, width), mine.dtype)
    pad[: len(mine)] = mine
    got = _allgather_rows(pad).reshape(nproc, most, width)
    return np.concatenate([got[p, : counts[p]] for p in range(nproc)])


def prove_batch_distributed(kkw, witnesses, seeds: np.ndarray, pipelined: bool = True):
    """Prove an N-statement batch with the proof axis split across processes.

    ``kkw``: a TorchKKW built per process (mesh=None or a local_mesh()).
    ``seeds``: (N, total_reps, 16), the same on every process, so proof i is
    byte-identical whichever process proves it.  Returns the full list of N
    proofs on every process (serialized bytes all-gathered)."""
    n = len(witnesses)
    if n == 0:
        return []
    seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(n, -1, 16)
    slices = batch_slices(n)
    mine = slices[process_index()]
    jobs = [witnesses[i] for i in mine]
    if pipelined and len(jobs) > 1:
        local = kkw.prove_many(jobs, seeds=seeds[mine])
    else:
        local = [kkw.prove(w2, wz, seeds=seeds[i]) for (w2, wz), i in zip(jobs, mine)]
    max_rows = max(len(s) for s in slices)
    per_proc = allgather_blobs([p.to_bytes() for p in local], max_rows)
    out: List[Optional[Proof]] = [None] * n
    for p, idx in enumerate(slices):
        for j, i in enumerate(idx):
            out[i] = Proof.from_bytes(per_proc[p][j])
    return out
