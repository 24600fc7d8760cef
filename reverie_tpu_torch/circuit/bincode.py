"""Bincode-compatible (de)serialization of program files.

The port's copy of reverie_tpu/circuit/bincode.py.  The reference CLI
consumes program files that are bincode-serialized `Vec<CombineOperation>`
(reference main.rs:66,99) using bincode 1.3 defaults: fixed-width
little-endian integers, `usize` as u64, enum tag as u32, `Vec` length as
u64, `bool` as one byte (0/1).  Programs cross between reverie_tpu and the
port in this format.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, List, Sequence

from .ir import CombineOp, Gate, Kind, Op

_TAG = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# Fields per Operation variant, in order: wire indices are u64, `const` is
# one byte in GF2 gates and a u64 in Z64 gates.
_OP_FIELDS = {
    Op.INPUT: ("dst",),
    Op.RANDOM: ("dst",),
    Op.ADD: ("dst", "src1", "src2"),
    Op.ADDC: ("dst", "src1", "const"),
    Op.SUB: ("dst", "src1", "src2"),
    Op.SUBC: ("dst", "src1", "const"),
    Op.MUL: ("dst", "src1", "src2"),
    Op.MULC: ("dst", "src1", "const"),
    Op.ASSERT_ZERO: ("src1",),
    Op.CONST: ("dst", "const"),
}


def _write_gate(out: BinaryIO, gate: Gate, is_gf2: bool) -> None:
    out.write(_TAG.pack(int(gate.op)))
    for field in _OP_FIELDS[gate.op]:
        if field == "const":
            if is_gf2:
                out.write(bytes([gate.const & 1]))
            else:
                out.write(_U64.pack(gate.const & 0xFFFFFFFFFFFFFFFF))
        else:
            out.write(_U64.pack(getattr(gate, field)))


def _read_gate(buf: memoryview, pos: int, is_gf2: bool):
    (tag,) = _TAG.unpack_from(buf, pos)
    pos += 4
    op = Op(tag)
    kwargs = {}
    for field in _OP_FIELDS[op]:
        if field == "const":
            if is_gf2:
                kwargs["const"] = buf[pos]
                pos += 1
            else:
                (kwargs["const"],) = _U64.unpack_from(buf, pos)
                pos += 8
        else:
            (val,) = _U64.unpack_from(buf, pos)
            kwargs[field] = val
            pos += 8
    return Gate(op, **kwargs), pos


def dump_program(program: Sequence[CombineOp], out: BinaryIO) -> None:
    out.write(_U64.pack(len(program)))
    for op in program:
        out.write(_TAG.pack(int(op.kind)))
        if op.kind == Kind.GF2:
            _write_gate(out, op.gate, is_gf2=True)
        elif op.kind == Kind.Z64:
            _write_gate(out, op.gate, is_gf2=False)
        else:  # B2A / SizeHint: two u64 fields
            out.write(_U64.pack(op.a))
            out.write(_U64.pack(op.b))


def dumps_program(program: Sequence[CombineOp]) -> bytes:
    buf = io.BytesIO()
    dump_program(program, buf)
    return buf.getvalue()


def load_program(data: bytes) -> List[CombineOp]:
    buf = memoryview(data)
    (count,) = _U64.unpack_from(buf, 0)
    pos = 8
    out: List[CombineOp] = []
    for _ in range(count):
        (tag,) = _TAG.unpack_from(buf, pos)
        pos += 4
        kind = Kind(tag)
        if kind == Kind.GF2:
            gate, pos = _read_gate(buf, pos, is_gf2=True)
            out.append(CombineOp.gf2(gate))
        elif kind == Kind.Z64:
            gate, pos = _read_gate(buf, pos, is_gf2=False)
            out.append(CombineOp.z64(gate))
        else:
            (a,) = _U64.unpack_from(buf, pos)
            (b,) = _U64.unpack_from(buf, pos + 8)
            pos += 16
            if kind == Kind.B2A:
                out.append(CombineOp.b2a(a, b))
            else:
                out.append(CombineOp.size_hint(a, b))
    if pos != len(buf):
        raise ValueError(f"trailing bytes in program file: {len(buf) - pos}")
    return out
