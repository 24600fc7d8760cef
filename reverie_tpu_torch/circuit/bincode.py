"""Bincode-compatible (de)serialization of program files.

The port's copy of reverie_tpu/circuit/bincode.py.  The reference CLI
consumes program files that are bincode-serialized `Vec<CombineOperation>`
(reference main.rs:66,99) using bincode 1.3 defaults: fixed-width
little-endian integers, `usize` as u64, enum tag as u32, `Vec` length as
u64, `bool` as one byte (0/1).  Programs cross between reverie_tpu and the
port in this format.

`load_program` and `dump_program` read and write op objects in Python;
`load_program_arrays` and `dump_program_arrays` read and write the arrays
of `compile_native.OpArrays` (a table of the distinct ops and per op its
row) in one pass of the host C (native/bincode.c), with no object per op:
the route of a program file into make_system, TorchKKW and StreamingKKW
(the command line).  The Python reader is their plain twin and raises
their errors.
"""

from __future__ import annotations

import ctypes
import io
import struct
from typing import TYPE_CHECKING, BinaryIO, List, Sequence

import numpy as np

from .ir import CombineOp, Gate, Kind, Op

if TYPE_CHECKING:
    from .compile_native import OpArrays

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


def _read_op(buf: memoryview, pos: int):
    """(the op whose record starts at pos, the offset after it)."""
    (tag,) = _TAG.unpack_from(buf, pos)
    pos += 4
    kind = Kind(tag)
    if kind == Kind.GF2:
        gate, pos = _read_gate(buf, pos, is_gf2=True)
        return CombineOp.gf2(gate), pos
    if kind == Kind.Z64:
        gate, pos = _read_gate(buf, pos, is_gf2=False)
        return CombineOp.z64(gate), pos
    (a,) = _U64.unpack_from(buf, pos)
    (b,) = _U64.unpack_from(buf, pos + 8)
    if kind == Kind.B2A:
        return CombineOp.b2a(a, b), pos + 16
    return CombineOp.size_hint(a, b), pos + 16


def load_program(data: bytes) -> List[CombineOp]:
    buf = memoryview(data)
    (count,) = _U64.unpack_from(buf, 0)
    pos = 8
    out: List[CombineOp] = []
    for _ in range(count):
        op, pos = _read_op(buf, pos)
        out.append(op)
    if pos != len(buf):
        raise ValueError(f"trailing bytes in program file: {len(buf) - pos}")
    return out


# -- the op arrays, in C -------------------------------------------------------

#: the table columns of native/bincode.c's table_t, in its order, and dtypes
_TABLE = (("kind", np.int8), ("op", np.int8), ("dst", np.int64), ("src1", np.int64),
          ("src2", np.int64), ("a", np.int64), ("b", np.int64), ("cst", np.uint64))
#: the shortest record (a GF2 Input or AssertZero: two tags and a wire)
_MIN_RECORD = 16
#: per opcode, the u64 wires of its record and whether it has a constant
_WIRES = {op: sum(f != "const" for f in fields) for op, fields in _OP_FIELDS.items()}
_HAS_CONST = {op: "const" in fields for op, fields in _OP_FIELDS.items()}
#: the ops dump_program_arrays writes a C call at a time
_WRITE_OPS = 1 << 20


class _Table(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name, _ in _TABLE] + [("cap_rows", ctypes.c_int64)]


_lib = None


def _native():
    global _lib
    if _lib is None:
        from ..crypto.native import get_lib

        lib = get_lib()
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        lib.rb_read.argtypes = [P, I64, I64, P, I64, ctypes.POINTER(_Table),
                                ctypes.POINTER(I64), ctypes.POINTER(I64), ctypes.POINTER(I64)]
        lib.rb_read.restype = ctypes.c_int
        lib.rb_write.argtypes = [ctypes.POINTER(_Table), P, I64, I64, P]
        lib.rb_write.restype = I64
        _lib = lib
    return _lib


def _table(cols: dict) -> _Table:
    return _Table(*(cols[name].ctypes.data for name, _ in _TABLE), len(cols["kind"]))


def load_program_arrays(data) -> "OpArrays":
    """A program file's bytes (bytes, or a buffer such as an mmap) as
    compile_native.OpArrays, with no op objects: load_program's program
    and its errors (the same types and messages), read in C."""
    from .compile_native import OpArrays

    buf = np.frombuffer(data, np.uint8)
    (count,) = _U64.unpack_from(data, 0)
    cap = min(count, max(len(buf) - 8, 0) // _MIN_RECORD)
    code = np.empty(cap, np.int32)
    # pages of the table's unused rows are never touched
    cols = {name: np.empty(cap, dt) for name, dt in _TABLE}
    rows, n_ops, pos = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    # past cap records the file is short: C stops at the first record it
    # cannot read (a count past 2**63 is not an int64)
    rc = _native().rb_read(buf.ctypes.data, len(buf), min(count, cap + 1), code.ctypes.data, cap,
                           ctypes.byref(_table(cols)), ctypes.byref(rows),
                           ctypes.byref(n_ops), ctypes.byref(pos))
    del buf
    if rc == -1:
        raise MemoryError("load_program_arrays: out of memory")
    if rc == 1:
        _read_op(memoryview(data), pos.value)  # raises load_program's error
        raise AssertionError(f"native reader: record {n_ops.value} at {pos.value} refused")
    if rc == 2:
        raise ValueError(f"trailing bytes in program file: {len(data) - pos.value}")
    return OpArrays(code, **{name: col[: rows.value].copy() for name, col in cols.items()})


def dump_program_arrays(ops: "OpArrays", out: BinaryIO) -> None:
    """dump_program of a program held as OpArrays: the same bytes, written
    in C a block of ops at a time."""
    cols = ops.raw_table()
    kind, op = cols["kind"].astype(np.int64), cols["op"].astype(np.int64)
    gate = op >= 0
    opc = np.where(gate, op, 0)
    wires = np.array([_WIRES[Op(i)] for i in range(len(Op))], np.int64)[opc]
    const = np.array([_HAS_CONST[Op(i)] for i in range(len(Op))], np.int64)[opc]
    size = np.where(gate, 8 + 8 * wires + const * np.where(kind == Kind.GF2, 1, 8), 20)
    table = _table(cols)
    out.write(_U64.pack(ops.n))
    for lo in range(0, ops.n, _WRITE_OPS):
        hi = min(ops.n, lo + _WRITE_OPS)
        blob = np.empty(int(size[ops.code[lo:hi]].sum()), np.uint8)
        n = _native().rb_write(ctypes.byref(table), ops.code.ctypes.data, lo, hi,
                               blob.ctypes.data)
        if n != len(blob):
            raise AssertionError(f"native writer: {n} bytes, {len(blob)} expected")
        out.write(memoryview(blob))
