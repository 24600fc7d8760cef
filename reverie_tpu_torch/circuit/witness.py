"""Witness file parsing; the port's copy of reverie_tpu/circuit/witness.py.

Mirrors the reference witness format (src/witness.rs:8-61): a byte stream in
which ASCII '0'/'1' characters are witness bits and every other byte is
skipped (whitespace, commas, ...).
"""

from __future__ import annotations

from typing import List


def parse_witness_bits(data: bytes) -> List[bool]:
    out: List[bool] = []
    for b in data:
        if b == 0x30:  # '0'
            out.append(False)
        elif b == 0x31:  # '1'
            out.append(True)
    return out


def parse_witness_file(path: str) -> List[bool]:
    with open(path, "rb") as f:
        return parse_witness_bits(f.read())


def format_witness_bits(bits) -> bytes:
    return bytes(0x31 if b else 0x30 for b in bits)
