"""Dump the structure of a bincode proof file (debugging aid); the port's
copy of reverie_tpu's tools/inspect_proof.py.

    python -m reverie_tpu_torch.tools.inspect_proof proof.bin

Prints the Fiat-Shamir commitment, per-domain opening counts, omitted-player
indices, and stream sizes -- the fields a verifier consumes
(proof/container.py; reference layout proof/mod.rs:40-66).
"""

import sys

from ..proof import Proof


def describe(name: str, ps) -> None:
    print(f"[{name}] {len(ps.online)} online openings, "
          f"{len(ps.preprocessing)} preprocessing openings")
    if ps.online:
        omits = [o.omit for o in ps.online]
        o = ps.online[0]
        print(f"  omit values: {omits}")
        print(f"  per opening: seeds {len(o.seeds)} B, recons {len(o.recons)} B, "
              f"corrs {len(o.corrs)} B, inputs {len(o.inputs)} B")
    if ps.preprocessing:
        p = ps.preprocessing[0]
        print(f"  per preprocessing: seed {len(p.seed)} B, "
              f"online commitment {len(p.comm_online)} B")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        return 2
    with open(argv[0], "rb") as f:
        blob = f.read()
    proof = Proof.from_bytes(blob)
    print(f"{argv[0]}: {len(blob)} bytes")
    print(f"commitment: {proof.comm.hex()}")
    describe("gf2", proof.gf2)
    describe("z64", proof.z64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
