"""Command-line interface of the port (reverie_tpu/cli.py's operations,
flags and output lines; reference src/main.rs:167-275).

    python -m reverie_tpu_torch.cli --operation prove --program-path prog.bin \\
        --witness-path wit.txt --proof-path proof.bin

Operations:
  prove       -- program + witness -> proof file
  verify      -- program + proof -> accept/reject
  oneshot     -- cleartext evaluation of the program on the witness
  oneshot-zk  -- prove then immediately verify in-process
  version_info

Program files are bincode-serialized instruction lists (same format the
reference consumes, main.rs:66); `--format bristol` accepts Bristol-fashion
text instead.  Witness files are ASCII '0'/'1' streams (witness.rs).
Proof files are bincode, byte-compatible with the reference and with
reverie_tpu's CLI: either CLI verifies the other's proofs.

`--backend cuda` (the default) proves and verifies on the CUDA card through
`make_system`, and never falls back to the CPU; `--backend cpu` runs
`TorchKKW` on the CPU device (see `app`).

A bincode program is mapped and read into arrays in C, with no op object
per op (`circuit.bincode.load_program_arrays`), so a file of tens of
millions of ops reaches `make_system` in seconds (oneshot's cleartext
evaluator reads op objects).  The whole compile is cached on disk, as
reverie_tpu's CLI caches it: keyed by a hash of the file's bytes, the
format and `--bristol-output`, under REVERIE_COMPILE_CACHE (default
~/.cache/reverie_tpu_torch/circuits; "" or "0" turns it off).  A streamed
proof compiles segments and caches nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import mmap
import os
import sys
import time


def _program_cache_key(data, fmt: str, bristol_output: str) -> bytes:
    """The compile cache's key of a program file (reverie_tpu/cli.py's):
    the file's bytes, with the format and the asserted Bristol output,
    name the compiled circuit."""
    h = hashlib.sha256()
    h.update(fmt.encode())
    h.update(bristol_output.encode())
    h.update(data)
    return h.digest()


def _load_program(path: str, fmt: str, bristol_output: str = "", objects: bool = False):
    """(the program of a file, its _program_cache_key).  A bincode file is
    mapped and read in C into OpArrays, with no op object per op
    (bincode.load_program_arrays), or with `objects` into a list of op
    objects (load_program: oneshot's cleartext evaluator); a Bristol file
    (`--format bristol`) into a list."""
    from .circuit import bristol_to_program, load_program, parse_bristol
    from .circuit.bincode import load_program_arrays

    if fmt == "bristol":
        with open(path, "rb") as f:
            data = f.read()
        key = _program_cache_key(data, fmt, bristol_output)
        circ = parse_bristol(data.decode())
        if bristol_output:
            from .circuit.bristol import bristol_with_output_assertion

            txt = bristol_output.strip()
            if set(txt) - {"0", "1"}:
                raise SystemExit(
                    f"--bristol-output must be '0'/'1' bits, got {txt!r}"
                )
            bits = [c == "1" for c in txt]
            if len(bits) != circ.n_output_bits:
                raise SystemExit(
                    f"--bristol-output has {len(bits)} bits, circuit outputs "
                    f"{circ.n_output_bits}"
                )
            return bristol_with_output_assertion(circ, bits), key
        return bristol_to_program(circ), key
    with open(path, "rb") as f:
        data = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                if os.fstat(f.fileno()).st_size else b"")
    try:
        key = _program_cache_key(data, fmt, bristol_output)
        return (load_program(data) if objects else load_program_arrays(data)), key
    finally:
        if isinstance(data, mmap.mmap):
            # a reader's error may still hold a view of it: then it is
            # unmapped when that is dropped
            with contextlib.suppress(BufferError):
                data.close()


def _load_witness(path: str):
    from .circuit import parse_witness_file

    return parse_witness_file(path)


def _backend_system(program, backend: str, segment_ops: int = 0, cache_key=None):
    """The prover and verifier of `program`: StreamingKKW in segments of
    `segment_ops` ops where that is set; else make_system on the card
    (its budget REVERIE_HBM_BUDGET or the card's free bytes), or TorchKKW
    on the CPU device, each compiling through the disk cache of
    `cache_key`.  On `cuda` without a card default_device raises."""
    import torch

    from . import StreamingKKW, TorchKKW, make_system
    from .device import default_device

    device = default_device() if backend == "cuda" else torch.device("cpu")
    if segment_ops:
        return StreamingKKW(program, segment_ops, device=device)
    if backend == "cuda":
        return make_system(program, cache_key=cache_key, device=device)
    return TorchKKW(program, cache_key=cache_key, device=device)


def cmd_prove(args) -> int:
    program, key = _load_program(args.program_path, args.format, args.bristol_output)
    witness = _load_witness(args.witness_path)
    print("Evaluating program in ~zero knowledge~")
    t0 = time.time()
    proof = _backend_system(program, args.backend, args.segment_ops, key).prove(witness, [])
    blob = proof.to_bytes()
    with open(args.proof_path, "wb") as f:
        f.write(blob)
    print(f"proof written: {len(blob)} bytes in {time.time() - t0:.2f}s")
    return 0


def cmd_verify(args) -> int:
    from .proof import Proof

    program, key = _load_program(args.program_path, args.format, args.bristol_output)
    with open(args.proof_path, "rb") as f:
        proof = Proof.from_bytes(f.read())
    print("Verifying Proof")
    t0 = time.time()
    ok = _backend_system(program, args.backend, args.segment_ops, key).verify(proof)
    print(f"verified in {time.time() - t0:.2f}s")
    if not ok:
        print("Unverifiable Proof", file=sys.stderr)
        return 1
    print("Ok(())")
    return 0


def cmd_oneshot(args) -> int:
    from .circuit import evaluate_composite_program

    program, _ = _load_program(args.program_path, args.format, args.bristol_output,
                               objects=True)
    witness = _load_witness(args.witness_path)
    print("Evaluating program in cleartext")
    evaluate_composite_program(program, witness, [])
    print("Ok(())")
    return 0


def cmd_oneshot_zk(args) -> int:
    program, key = _load_program(args.program_path, args.format, args.bristol_output)
    witness = _load_witness(args.witness_path)
    print("Evaluating program in ~zero knowledge~")
    sys_ = _backend_system(program, args.backend, args.segment_ops, key)
    proof = sys_.prove(witness, [])
    ok = sys_.verify(proof)
    if not ok:
        print("Unverifiable Proof", file=sys.stderr)
        return 1
    print("Ok(())")
    return 0


def cmd_version(args) -> int:
    """Version + build metadata (main.rs:277-286: `built` crate embeds the
    git SHA and dirty flag at build time; here they are resolved at run time
    from the enclosing git checkout when one exists)."""
    from . import __version__
    from .utils.buildinfo import git_commit_info

    print(f"reverie_tpu_torch_version: {__version__}")
    sha, dirty = git_commit_info()
    if sha is not None:
        print(f"reverie_tpu_torch_commit_sha: {sha}")
        print(f"reverie_tpu_torch_uncommitted_changes: {'TRUE' if dirty else 'FALSE'}")
    return 0


def app() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="reverie-tpu-torch",
                                description="Gotta go fast (on an H100)")
    p.add_argument(
        "--operation",
        required=True,
        choices=["prove", "verify", "oneshot", "oneshot-zk", "version_info"],
    )
    p.add_argument("--program-path")
    p.add_argument("--witness-path")
    p.add_argument("--proof-path")
    p.add_argument("--format", default="bincode", choices=["bincode", "bristol"])
    p.add_argument(
        "--bristol-output", default="",
        help="expected output bits (e.g. '01') for --format bristol: the"
             " circuit outputs are asserted equal to this public value",
    )
    p.add_argument(
        "--backend", default="cuda", choices=["cuda", "cpu"],
        help="cuda: make_system on the CUDA card (device budget"
             " REVERIE_HBM_BUDGET, else the card's free memory); exits with"
             " an error where there is no card, never proving on the CPU."
             " cpu: TorchKKW on the CPU device with the kernels' plain"
             " PyTorch versions, not reverie_tpu's NumPy golden prover: its"
             " proof bytes are TpuKKW's, which differ from reverie_tpu's"
             " --backend cpu only where a wire is overwritten after its"
             " AssertZero",
    )
    p.add_argument(
        "--segment-ops", type=int, default=0, metavar="N",
        help="stream the proof in segments of N ops (StreamingKKW:"
             " O(segment) device memory for circuits past the card, all op"
             " kinds; deep segments use the wave executor; proof bytes"
             " identical to unsegmented proving)",
    )
    return p


def main(argv=None) -> int:
    args = app().parse_args(argv)
    op = args.operation
    need = {
        "prove": ["program_path", "witness_path", "proof_path"],
        "verify": ["program_path", "proof_path"],
        "oneshot": ["program_path", "witness_path"],
        "oneshot-zk": ["program_path", "witness_path"],
        "version_info": [],
    }[op]
    for field in need:
        if getattr(args, field) is None:
            print(f"--{field.replace('_', '-')} is required for {op}", file=sys.stderr)
            return 2
    return {
        "prove": cmd_prove,
        "verify": cmd_verify,
        "oneshot": cmd_oneshot,
        "oneshot-zk": cmd_oneshot_zk,
        "version_info": cmd_version,
    }[op](args)


if __name__ == "__main__":
    sys.exit(main())
