"""A circuit as the benchmark builds it: one numpy column a field, one row an
op, and the program file it is handed to the system as.

The columns follow the program file (trailofbits/reverie's bincode
`Vec<CombineOperation>`, as `mcircuit` declares it): `kind` is the
CombineOperation variant (GF2, Z64, B2A, SIZE_HINT), `op` the gate's
Operation variant, `dst`, `src1`, `src2` and `const` its fields (B2A and
SIZE_HINT keep their two fields in `dst` and `src1`).  `to_bincode` writes
the file with no object an op, so a million-gate program takes a few numpy
passes: it is the benchmark's own writer, frozen, and the tests hold its
bytes to the port's.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

GF2, Z64, B2A, SIZE_HINT = 0, 1, 2, 3
INPUT, RANDOM, ADD, ADDC, SUB, SUBC, MUL, MULC, ASSERT_ZERO, CONST = range(10)

#: a gate's fields after its tag, in file order ("c" the constant: one byte in
#: a GF(2) gate, a u64 in a Z64 one; the rest u64)
FIELDS = {INPUT: ("dst",), RANDOM: ("dst",), ADD: ("dst", "src1", "src2"),
          ADDC: ("dst", "src1", "c"), SUB: ("dst", "src1", "src2"),
          SUBC: ("dst", "src1", "c"), MUL: ("dst", "src1", "src2"),
          MULC: ("dst", "src1", "c"), ASSERT_ZERO: ("src1",), CONST: ("dst", "c")}


class Program(NamedTuple):
    kind: np.ndarray  # (n,) uint8
    op: np.ndarray  # (n,) uint8
    dst: np.ndarray  # (n,) int64
    src1: np.ndarray  # (n,) int64
    src2: np.ndarray  # (n,) int64
    const: np.ndarray  # (n,) uint64

    def __len__(self) -> int:
        return len(self.kind)

    def count(self, kind: int, op: int) -> int:
        return int(((self.kind == kind) & (self.op == op)).sum())


def from_rows(rows: Sequence[tuple]) -> Program:
    """Rows (kind, op, dst, src1, src2, const) -> a Program."""
    a = np.asarray(rows, dtype=np.uint64).reshape(-1, 6)
    return Program(a[:, 0].astype(np.uint8), a[:, 1].astype(np.uint8), a[:, 2].astype(np.int64),
                   a[:, 3].astype(np.int64), a[:, 4].astype(np.int64), a[:, 5].copy())


def _record_len(p: Program) -> np.ndarray:
    n = np.full(len(p), 4 + 16, dtype=np.int64)  # B2A, SIZE_HINT: tag + two u64
    for op, fields in FIELDS.items():
        for kind, c_len in ((GF2, 1), (Z64, 8)):
            sel = (p.kind == kind) & (p.op == op)
            n[sel] = 8 + sum(c_len if f == "c" else 8 for f in fields)
    return n


def _put(buf: np.ndarray, at: np.ndarray, values: np.ndarray, width: int) -> None:
    """Write each value little-endian in `width` bytes at its offset."""
    le = values.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :width]
    buf[at[:, None] + np.arange(width)] = le


def to_bincode(p: Program) -> bytes:
    """The program file: u64 op count, then per op its u32 kind tag and, for
    a gate, its u32 op tag and fields (bincode 1.3 defaults)."""
    lens = _record_len(p)
    start = np.concatenate([[8], 8 + np.cumsum(lens)[:-1]]).astype(np.int64)
    buf = np.zeros(8 + int(lens.sum()), dtype=np.uint8)
    buf[:8] = np.frombuffer(np.uint64(len(p)).astype("<u8").tobytes(), dtype=np.uint8)
    _put(buf, start, p.kind.astype(np.uint64), 4)
    pair = (p.kind == B2A) | (p.kind == SIZE_HINT)
    _put(buf, start[pair] + 4, p.dst[pair].astype(np.uint64), 8)
    _put(buf, start[pair] + 12, p.src1[pair].astype(np.uint64), 8)
    for op, fields in FIELDS.items():
        for kind, c_len in ((GF2, 1), (Z64, 8)):
            sel = (p.kind == kind) & (p.op == op)
            if not sel.any():
                continue
            at = start[sel] + 4
            _put(buf, at, np.full(int(sel.sum()), op, dtype=np.uint64), 4)
            at = at + 4
            for f in fields:
                if f == "c":
                    c = p.const[sel] & np.uint64(1) if kind == GF2 else p.const[sel]
                    _put(buf, at, c, c_len)
                    at = at + c_len
                else:
                    _put(buf, at, getattr(p, f)[sel].astype(np.uint64), 8)
                    at = at + 8
    return buf.tobytes()


class Statement(NamedTuple):
    """A configuration's statement: its program, and `witnesses(rng, n)`
    -> (n, witness bits) uint8, n statements' GF(2) witnesses drawn from rng
    (every one satisfying the program)."""

    program: Program
    witnesses: object


class Shape(NamedTuple):
    """What a GF(2) program's proof moves, from its gates alone: tape
    shares a player (m2), transcript bytes a rep (online and
    preprocessing streams), and gates by opcode."""

    m2: int
    n_onl: int
    n_pre: int
    n_inputs: int
    n_muls: int
    n_asserts: int
    gates: dict  # {opcode: count} of the GF(2) gates


def shape(p: Program) -> Shape:
    gf2 = p.kind == GF2
    gates = {int(o): int(c) for o, c in zip(*np.unique(p.op[gf2], return_counts=True))}
    n_in, n_rand = gates.get(INPUT, 0), gates.get(RANDOM, 0)
    n_mul, n_az = gates.get(MUL, 0), gates.get(ASSERT_ZERO, 0)
    return Shape(n_in + n_rand + 2 * n_mul, n_in + n_mul + n_az, n_mul, n_in, n_mul, n_az, gates)
