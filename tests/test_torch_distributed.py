"""Multi-process proving of the port (reverie_tpu_torch.parallel over
torch.distributed's gloo group): byte-identity with reverie_tpu.

Two child processes, each contributing 4 CPU shards to an 8-shard global
mesh over loopback (the twin of tests/test_distributed.py and
tests/dist_worker.py).  The children import neither jax nor reverie_tpu
(both are made unimportable there); this test computes reverie_tpu's golden
proofs and hands them over through files.  Each child checks: a global-mesh
GF(2) proof and its verify; the mixed z64 + B2A proof and its verify; a
global-mesh proof with fresh seeds, the same in both processes;
`prove_batch_distributed` at n = 4 and n = 3 (uneven slices); a streamed
proof on the global mesh; `allgather_blobs` of ragged and empty blobs."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

from reverie_tpu.circuit.builders import mixed_b2a_circuit, mul_bench_circuit
from reverie_tpu.proof import prove as golden_prove
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
NPROC = 2

_CHILD = r"""
import datetime, sys
sys.modules["jax"] = None
sys.modules["reverie_tpu"] = None
import numpy as np
import torch

pid, nproc, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from reverie_tpu_torch import StreamingKKW, TorchKKW
from reverie_tpu_torch.circuit.builders import mixed_b2a_circuit, mul_bench_circuit
from reverie_tpu_torch.parallel import distributed as dist
from reverie_tpu_torch.proof import Proof

dist.initialize(f"127.0.0.1:{port}", nproc, pid, timeout=datetime.timedelta(seconds=120))
CPU = torch.device("cpu")
gm = dist.global_mesh(devices=[CPU] * 4)
assert dist.mesh_is_multiprocess(gm) and len(gm) == 4 * nproc, gm
assert [s.process for s in gm.shards] == sorted([p for p in range(nproc)] * 4)
seeds = np.load(f"{d}/seeds.npy")
golden = lambda name: open(f"{d}/{name}.bin", "rb").read()

# 1. GF(2): the lanes of one proof over both processes' shards
prog, w2, wz = mul_bench_circuit(24)
kkw = TorchKKW(prog, mesh=gm)
proof = kkw.prove(w2, wz, seeds=seeds[0])
assert proof.to_bytes() == golden("gf2"), "global-mesh gf2 proof bytes differ"
assert kkw.verify(proof) is True
bad = Proof.from_bytes(proof.to_bytes())
bad.gf2.online[0].recons = bytes([bad.gf2.online[0].recons[0] ^ 1]) + bad.gf2.online[0].recons[1:]
assert kkw.verify(bad) is False
# fresh seeds are process 0's: both processes hold the same proof
mine = kkw.prove(w2, wz).to_bytes()
both = dist.allgather_blobs([mine], 1)
assert both[0][0] == both[1][0] == mine and kkw.verify(Proof.from_bytes(mine)) is True

# 2. the mixed z64 + B2A circuit
progb, w2b, wzb = mixed_b2a_circuit()
kb = TorchKKW(progb, mesh=gm)
pb = kb.prove(w2b, wzb, seeds=seeds[0])
assert pb.to_bytes() == golden("b2a"), "global-mesh b2a proof bytes differ"
assert kb.verify(pb) is True

# 3. the proof axis over the processes, each proving on its own device
for n in (4, 3):
    got = dist.prove_batch_distributed(TorchKKW(prog, device=CPU), [(w2, wz)] * n, seeds[:n])
    for i in range(n):
        assert got[i].to_bytes() == golden(f"batch{i}"), (n, i)

# 4. streamed on the global mesh
sk = StreamingKKW(progb, 24, mesh=gm)
ps = sk.prove(w2b, wzb, seeds=seeds[0])
assert ps.to_bytes() == golden("b2a"), "global-mesh streamed proof bytes differ"
assert sk.verify(ps) is True

# 5. ragged and empty blobs
blobs = [[b"", b"ab"], [b"xyz"]][pid]
assert dist.allgather_blobs(blobs, 2) == [[b"", b"ab"], [b"xyz", b""]]
assert dist.allgather_blobs([], 1) == [[b""], [b""]]
open(f"{d}/ok_{pid}", "w").write("OK")
print(f"proc {pid}: all distributed checks OK", flush=True)
# leave the gloo group together: a group torn down at exit while its peer
# is gone can abort the process after every check passed
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multiprocess_mesh_byte_identity(tmp_path):
    rng = np.random.RandomState(42)
    seeds = rng.randint(0, 256, size=(4, 256, 16), dtype=np.uint8)
    np.save(tmp_path / "seeds.npy", seeds)
    prog, w2, wz = mul_bench_circuit(24)
    progb, w2b, wzb = mixed_b2a_circuit()
    goldens = {"gf2": golden_prove(prog, w2, wz, seeds=seeds[0].reshape(32, 8, 16)),
               "b2a": golden_prove(progb, w2b, wzb, seeds=seeds[0].reshape(32, 8, 16)),
               **{f"batch{i}": golden_prove(prog, w2, wz, seeds=seeds[i].reshape(32, 8, 16))
                  for i in range(4)}}
    for name, proof in goldens.items():
        (tmp_path / f"{name}.bin").write_bytes(proof.to_bytes())

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = str(_free_port())
    logs = [open(tmp_path / f"child_{i}.log", "w") for i in range(NPROC)]
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(i), str(NPROC), port,
                               str(tmp_path)], cwd=REPO, env=env, stdout=log,
                              stderr=subprocess.STDOUT) for i, log in enumerate(logs)]
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=240))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for i, rc in enumerate(rcs):
        assert rc == 0, f"child {i} exited {rc}:\n" + (
            tmp_path / f"child_{i}.log").read_text()[-4000:]
        assert (tmp_path / f"ok_{i}").read_text() == "OK"
