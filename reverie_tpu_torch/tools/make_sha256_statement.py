"""Generate a SHA-256 preimage statement for the CLI; the port's copy of
reverie_tpu's tools/make_sha256_statement.py.

Writes a reference-compatible bincode program file (the statement: "I know a
message whose SHA-256 is <digest>") and the matching witness file, for any
message length (multi-block Merkle-Damgard chaining).

    python -m reverie_tpu_torch.tools.make_sha256_statement --message "secret" out_dir/
    python -m reverie_tpu_torch.tools.make_sha256_statement --message-file data.bin out_dir/
    python -m reverie_tpu_torch.cli --operation prove \\
        --program-path out_dir/program.bin --witness-path out_dir/witness.txt \\
        --proof-path out_dir/proof.bin [--segment-ops 60000]

Reference analog: mcircuit program files consumed by main.rs:66.
"""

import argparse
import hashlib
import os
import sys

from ..circuit import dumps_program, format_witness_bits
from ..circuit.sha256 import (
    block_to_witness_bits,
    count_and_gates,
    sha256_long_preimage_statement,
    sha256_pad_message,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--message", help="preimage as a UTF-8 string")
    g.add_argument("--message-file", help="preimage file (raw bytes)")
    args = ap.parse_args(argv)

    if args.message is not None:
        msg = args.message.encode()
    else:
        with open(args.message_file, "rb") as f:
            msg = f.read()
    padded = sha256_pad_message(msg)
    n_blocks = len(padded) // 64
    digest = hashlib.sha256(msg).digest()
    prog, n_in = sha256_long_preimage_statement(digest, n_blocks)

    wit = []
    for i in range(0, len(padded), 64):
        wit.extend(block_to_witness_bits(padded[i : i + 64]))
    assert len(wit) == n_in

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "program.bin"), "wb") as f:
        f.write(dumps_program(prog))
    with open(os.path.join(args.out_dir, "witness.txt"), "wb") as f:
        f.write(format_witness_bits(wit))
    print(
        f"digest {digest.hex()}\n"
        f"{n_blocks} block(s), {count_and_gates(prog)} AND gates, "
        f"{n_in} witness bits -> {args.out_dir}/program.bin, witness.txt"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
