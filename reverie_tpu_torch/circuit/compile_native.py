"""The circuit compile on the port's host C (native/compile.c).

`compile.compile_program` and `compile.compile_segments` run here; the
Python functions they replaced stay in compile.py as their plain twins
(`compile_program_plain`, `compile_segments_plain`), equal field for field
(tests/test_torch_compile.py).  A program is lowered once to arrays
(`encode_program`): the table of its distinct op objects and per op a code
into it.  A program whose equal ops are one object (the bench builders)
costs a step per run of that object, not per op; the wires of each domain
are renumbered densely in the order of their ids.  The C passes then do the
per-op work: the carry pass of compile_segments and the levelizing compile
of a segment, which writes one row per emitted gate; numpy groups the rows
into the level tables of a `CompiledCircuit`.

`analyze` runs the compile without emitting rows: the totals of every
counter and the depth of the whole circuit, which `make_system` reads to
bound a circuit's device footprint before it compiles anything.
`SegmentCompiler` compiles segments one at a time, each as long as its
caller asks, and fills in the carries once the last one is in: so a caller
can size each segment by the one before (make_system).  A whole compile
with a `cache_key` is cached on disk (compile.compile_cache_path).

A program file becomes OpArrays with no op objects in C
(bincode.load_program_arrays); a list of op objects through
`OpArrays.from_program`.  Both share the one constructor from the raw
table, which renumbers the wires and sets the counting classes.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..crypto.native import get_lib
from .compile import (
    B2A_CORR,
    B2A_OUT,
    G_ADD,
    G_ADDC,
    G_ASSERT,
    G_CONST,
    G_INPUT,
    G_MUL,
    G_MULC,
    G_RANDOM,
    G_SUBC,
    N_KINDS,
    Z_SUB,
    CompiledCircuit,
    Segment,
    compile_cache_path,
    load_cached,
    store_cached,
)
from .ir import Kind, Op

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32

# the row columns of native/compile.c
C_LVL, C_KEY, C_DST, C_A, C_B, C_TAPE, C_WIT, C_ONL, C_REC, C_PRE, C_CORR, C_ZR, C_BITS = range(13)
NCOL = 13
#: the record slot lists, in CompiledCircuit's field order
SLOTS = ("input_slots2", "corr_slots2", "recon_slots2", "input_slotsz", "corr_slotsz",
         "recon_slotsz")
#: per compiled kind, its columns in compile_program_plain's order, and the
#: row column each is read from
_COLUMNS = {
    G_INPUT: ("dst", "tape", "wit", "onl", "rec"),
    G_ADD: ("dst", "a", "b"), Z_SUB: ("dst", "a", "b"),
    G_ADDC: ("dst", "a", "const"), G_SUBC: ("dst", "a", "const"), G_MULC: ("dst", "a", "const"),
    G_MUL: ("dst", "a", "b", "tape_ab", "tape_new", "onl", "pre", "rec", "corr"),
    G_ASSERT: ("a", "onl", "rec"),
    G_RANDOM: ("dst", "tape"),
    G_CONST: ("dst", "const"),
    B2A_CORR: ("dst", "tape", "bits", "pre", "corr"),
    B2A_OUT: ("dst", "zr", "bits", "onl", "rec"),
}
_SOURCE = {"dst": C_DST, "a": C_A, "b": C_B, "tape": C_TAPE, "tape_ab": C_TAPE, "wit": C_WIT,
           "onl": C_ONL, "rec": C_REC, "pre": C_PRE, "corr": C_CORR, "zr": C_ZR}
#: rows, GF(2) and z64 values, GF(2) MULs and GF(2) recons of one B2A
B2A_ROWS, B2A_VALS2, B2A_MULS2, B2A_RECONS2 = 380, 378, 63, 127
#: a class per (kind, opcode) for counting; B2A and SIZE_HINT use opcode 15
_NOOP = 15


class _Ops(ctypes.Structure):
    _fields_ = [(f, _P) for f in ("code", "kind", "op", "dst", "src1", "src2", "a", "b", "cst",
                                  "bsrc")]


class _Dom(ctypes.Structure):
    _fields_ = ([(f, _P) for f in ("map", "stamp", "last", "vlevel")]
                + [(f, _I64) for f in ("vcap", "n_vals", "tape", "onl", "pre", "wit", "n_inputs",
                                       "n_corrs", "n_recons")])


class _Out(ctypes.Structure):
    _fields_ = [("emit", ctypes.c_int), ("cap", _I64), ("col", _P), ("cst", _P), ("bits", _P),
                ("bits_cap", _I64), ("slots", _P * 6), ("slot_cap", _I64 * 6),
                ("level_used", _P), ("levels_cap", _I64), ("n_rows", _I64), ("n_bits", _I64),
                ("n_slots", _I64 * 6), ("overflow", _I64)]


class _Cross(ctypes.Structure):
    _fields_ = [(f, _P) for f in ("writer", "inmark", "outmark", "last")]


class _XList(ctypes.Structure):
    _fields_ = [(f, _P) for f in ("dom", "wire", "src", "val")] + [("n", _I64), ("cap", _I64)]


_lib = None


def _native():
    global _lib
    if _lib is None:
        lib = get_lib()
        ptr = ctypes.POINTER
        lib.rc_compile.argtypes = [ptr(_Ops), _I64, _I64, _I32, _P, _I64, _P, _I64, ptr(_Dom),
                                   ptr(_Dom), ptr(_Out), _P]
        lib.rc_compile.restype = ctypes.c_int
        lib.rc_carry_scan.argtypes = [ptr(_Ops), _I64, _I64, _I32, ptr(_Cross), ptr(_Cross),
                                      ptr(_XList), ptr(_XList)]
        lib.rc_carry_scan.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def distinct_ops(program: Sequence) -> Tuple[list, np.ndarray]:
    """(the distinct op objects of a program, by identity; per op its index
    among them, int32).  Runs of one object are found on the array of the
    program's object pointers, so a program of a few shared objects costs
    no Python step per op."""
    n = len(program)
    if n == 0:
        return [], np.zeros(0, np.int32)
    objs = np.fromiter(program, dtype=object, count=n)
    # an object array holds the objects' addresses (id() in CPython)
    ptr = np.empty(n, np.uintp)
    ctypes.memmove(_ptr(ptr), objs.ctypes.data, ptr.nbytes)
    starts = np.flatnonzero(np.concatenate(([True], ptr[1:] != ptr[:-1])))
    _, first, run_code = np.unique(ptr[starts], return_index=True, return_inverse=True)
    code = np.repeat(run_code.astype(np.int32).reshape(-1), np.diff(np.append(starts, n)))
    return objs[starts[first]].tolist(), code


class _NoGate:
    """The gate fields of an op without a gate (B2A, SIZE_HINT)."""

    dst = src1 = src2 = const = 0


class OpArrays:
    """A program as arrays: `code` (n,) int32, per op its row of the table
    of distinct ops: kind and opcode int8 (opcode -1 without a gate), dst,
    src1, src2, a, b int64 (renumbered wires; a B2A's b is its row of
    `bsrc`, the (B2A ops, 64) GF(2) wires it reads; a SIZE_HINT's a and b
    its two counts), the constant uint64; `wires2` / `wiresz` the wire ids
    of each domain, sorted (a renumbered wire is its index there).

    Made from the raw table (the wire ids as the program has them; a
    B2A's b its first GF(2) wire), with `extra2` / `extraz` more wire ids
    of each domain to number (a compile's carries): by the file reader
    (bincode.load_program_arrays) or from op objects (`from_program`),
    which alone sets `objects`, the table's op objects."""

    def __init__(self, code: np.ndarray, kind: np.ndarray, op: np.ndarray, dst: np.ndarray,
                 src1: np.ndarray, src2: np.ndarray, a: np.ndarray, b: np.ndarray,
                 cst: np.ndarray, extra2: Sequence[int] = (), extraz: Sequence[int] = (),
                 objects: Optional[list] = None):
        self.code = np.ascontiguousarray(code, np.int32)
        self.n = len(self.code)
        self.objects = objects
        self.kind = np.ascontiguousarray(kind, np.int8)
        self.op = np.ascontiguousarray(op, np.int8)
        self.cst = np.ascontiguousarray(cst, np.uint64)
        fields = {"dst": np.array(dst, np.int64), "src1": np.array(src1, np.int64),
                  "src2": np.array(src2, np.int64)}
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        gf2, z64, b2a = self.kind == Kind.GF2, self.kind == Kind.Z64, self.kind == Kind.B2A
        hint = self.kind == Kind.SIZE_HINT
        bsrc = b[b2a][:, None] + np.arange(64)

        def wires(sel, *more):
            return np.unique(np.concatenate([*(fields[f][sel] for f in fields), *more]))

        self.wires2 = wires(gf2, bsrc.reshape(-1), np.asarray(extra2, np.int64))
        self.wiresz = wires(z64, a[b2a], np.asarray(extraz, np.int64))
        for f, arr in fields.items():
            arr[gf2] = np.searchsorted(self.wires2, arr[gf2])
            arr[z64] = np.searchsorted(self.wiresz, arr[z64])
            arr[~(gf2 | z64)] = 0
            setattr(self, f, arr)
        self.a = np.where(b2a, np.searchsorted(self.wiresz, a), np.where(hint, a, 0))
        self.b = np.where(b2a, np.cumsum(b2a) - 1, np.where(hint, b, 0))
        self.bsrc = np.ascontiguousarray(np.searchsorted(self.wires2, bsrc), np.int64)
        #: the counting class of each distinct op: kind * 16 + opcode
        self.cls = self.kind.astype(np.int64) * 16 + np.where(self.op >= 0, self.op, _NOOP)
        self._struct = _Ops(*(_ptr(x) for x in (self.code, self.kind, self.op, self.dst,
                                                self.src1, self.src2, self.a, self.b, self.cst,
                                                self.bsrc)))

    @classmethod
    def from_program(cls, program: Sequence, extra2: Sequence[int] = (),
                     extraz: Sequence[int] = ()) -> "OpArrays":
        """A list of op objects as OpArrays, its table the distinct objects
        (distinct_ops; `objects`).  ValueError on an opcode past CONST."""
        objects, code = distinct_ops(program)
        U = len(objects)
        kind = np.fromiter((int(o.kind) for o in objects), np.int8, U)
        gates = [_NoGate if o.gate is None else o.gate for o in objects]
        op = np.fromiter((-1 if o.gate is None else int(o.gate.op) for o in objects), np.int64, U)
        bad = ((kind == Kind.GF2) | (kind == Kind.Z64)) & ((op < 0) | (op > Op.CONST))
        if bad.any():
            raise ValueError(f"bad opcode {objects[int(np.argmax(bad))].gate.op}")
        def u64s(values):  # as int64, as the file reader stores them
            return np.fromiter(values, np.uint64, U).view(np.int64)

        fields = {f: u64s(int(getattr(g, f)) for g in gates) for f in ("dst", "src1", "src2")}
        return cls(code, kind, op, **fields, a=u64s(int(o.a) for o in objects),
                   b=u64s(int(o.b) for o in objects),
                   cst=np.array([int(g.const) for g in gates], dtype=np.uint64),
                   extra2=extra2, extraz=extraz, objects=objects)

    def raw_table(self) -> Dict[str, np.ndarray]:
        """The table with the wire ids as the program has them (the
        constructor's arguments): kind, op, dst, src1, src2, a, b, cst."""
        gf2, z64, b2a = self.kind == Kind.GF2, self.kind == Kind.Z64, self.kind == Kind.B2A
        cols = {"kind": self.kind, "op": self.op}
        for f in ("dst", "src1", "src2"):
            arr = np.zeros(len(self.kind), np.int64)
            arr[gf2] = self.wires2[getattr(self, f)[gf2]]
            arr[z64] = self.wiresz[getattr(self, f)[z64]]
            cols[f] = arr
        cols["a"], cols["b"] = self.a.copy(), self.b.copy()
        cols["a"][b2a] = self.wiresz[self.a[b2a]]
        cols["b"][b2a] = self.wires2[self.bsrc[self.b[b2a], 0]]
        cols["cst"] = self.cst
        return cols

    def __len__(self) -> int:
        return self.n

    def class_counts(self, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
        """(64,) the ops of [lo, hi) per counting class."""
        code = self.code[lo : self.n if hi is None else hi]
        return np.bincount(self.cls[code], minlength=64) if len(code) else np.zeros(64, np.int64)


def encode_program(program) -> OpArrays:
    """`program` as OpArrays (an OpArrays is returned as it is)."""
    return program if isinstance(program, OpArrays) else OpArrays.from_program(program)


class _State:
    """The C passes' per-domain arrays for one program: the value maps and
    each wire's last value (the compile), the writers and marks of the
    carry pass."""

    def __init__(self, ops: OpArrays):
        self.ops = ops
        self.epoch = 0
        self.maps = [(np.zeros(len(w), np.int32), np.zeros(len(w), np.int32),
                      np.zeros(len(w), np.int32)) for w in (ops.wires2, ops.wiresz)]

    def run(self, lo: int, hi: int, carry2=(), carryz=(), emit: bool = True):
        """Compile ops [lo, hi) with the carried-in (renumbered) wires:
        (the two domains' _Dom, the _Out, its arrays)."""
        ops = self.ops
        carry2 = np.ascontiguousarray(carry2, np.int64)
        carryz = np.ascontiguousarray(carryz, np.int64)
        c = ops.class_counts(lo, hi)
        g2, gz, nb2a = c[0:16], c[16:32], int(c[2 * 16 + _NOOP])
        gates2, gatesz = int(g2[:_NOOP].sum()), int(gz[:_NOOP].sum())
        rows = gates2 + gatesz + B2A_ROWS * nb2a
        caps = (int(g2[Op.INPUT]), int(g2[Op.MUL]) + B2A_MULS2 * nb2a,
                int(g2[Op.MUL] + g2[Op.ASSERT_ZERO]) + B2A_RECONS2 * nb2a,
                int(gz[Op.INPUT]), int(gz[Op.MUL]) + nb2a, int(gz[Op.MUL] + gz[Op.ASSERT_ZERO]))
        doms = []
        for (mp, stamp, last), nc, gates, extra in ((self.maps[0], len(carry2), gates2,
                                                     B2A_VALS2 * nb2a),
                                                    (self.maps[1], len(carryz), gatesz, 2 * nb2a)):
            vcap = 1 + nc + gates + extra
            vlevel = np.empty(vcap, np.int32)
            doms.append((_Dom(_ptr(mp), _ptr(stamp), _ptr(last), _ptr(vlevel), vcap), vlevel))
        arrs = {"col": np.empty((NCOL, rows if emit else 0), np.int32),
                "cst": np.empty(rows if emit else 0, np.uint64),
                "bits": np.empty((2 * nb2a if emit else 0, 64), np.int32),
                "slots": [np.empty(k if emit else 0, np.int64) for k in caps],
                "level_used": np.zeros(rows + 2, np.uint8)}
        out = _Out(int(emit), rows, _ptr(arrs["col"]), _ptr(arrs["cst"]), _ptr(arrs["bits"]),
                   2 * nb2a, (_P * 6)(*(_ptr(s) for s in arrs["slots"])),
                   (_I64 * 6)(*caps), _ptr(arrs["level_used"]), rows + 2)
        self.epoch += 1
        res = np.zeros(1, np.int64)
        rc = _native().rc_compile(ctypes.byref(ops._struct), lo, hi, self.epoch, _ptr(carry2),
                                  len(carry2), _ptr(carryz), len(carryz),
                                  ctypes.byref(doms[0][0]), ctypes.byref(doms[1][0]),
                                  ctypes.byref(out), _ptr(res))
        if rc == 1:
            raise ValueError(f"bad opcode {_opcode(int(res[0]))}")
        if rc != 0:
            raise AssertionError("native compile: an output array was sized too small")
        return doms[0][0], doms[1][0], out, arrs

    def final_map(self, domain: int) -> Dict[int, int]:
        """{wire id: value} of the last compile's final wire -> value map."""
        mp, stamp, _ = self.maps[domain]
        wires = (self.ops.wires2, self.ops.wiresz)[domain]
        at = np.flatnonzero(stamp == self.epoch)
        return dict(zip(wires[at].tolist(), mp[at].tolist()))


def _opcode(v: int):
    try:
        return Op(v)
    except ValueError:
        return v


def _levels(col: np.ndarray, cst: np.ndarray, bits: np.ndarray, n: int) -> list:
    """The rows' level tables: per level (ascending, empty ones left out)
    {key: {column: array}}, keys in the order of their first row and rows
    in emission order, as compile_program_plain's _Builder keeps them."""
    if n == 0:
        return []
    gid = col[C_LVL, :n].astype(np.int64) * 32 + col[C_KEY, :n]
    order = (None if bool((gid[1:] >= gid[:-1]).all())
             else np.argsort(gid, kind="stable"))
    g = gid if order is None else gid[order]
    starts = np.flatnonzero(np.concatenate(([True], g[1:] != g[:-1])))
    ends = np.append(starts[1:], n)
    levels, groups, cur = [], [], None
    for st, en in zip(starts.tolist(), ends.tolist()):
        lvl, key = divmod(int(g[st]), 32)
        if lvl != cur and groups:
            levels.append(_table(groups, col, cst, bits))
            groups = []
        cur = lvl
        idx = slice(st, en) if order is None else order[st:en]
        first = st if order is None else int(order[st])
        if order is not None and int(order[en - 1]) - first == en - st - 1:
            idx = slice(first, first + en - st)  # a run: copy, not gather
        groups.append((first, key, idx))
    levels.append(_table(groups, col, cst, bits))
    return levels


def _table(groups, col, cst, bits) -> dict:
    table = {}
    for _, key, idx in sorted(groups):
        cols = {}
        for name in _COLUMNS[key % N_KINDS]:
            if name == "const":
                cols[name] = cst[idx].copy()
            elif name == "bits":
                cols[name] = bits[col[C_BITS, idx]]
            elif name == "tape_new":
                cols[name] = col[C_TAPE, idx] + 1
            else:
                cols[name] = col[_SOURCE[name], idx].copy()
        table[key] = cols
    return table


def _circuit(d2: _Dom, dz: _Dom, out: _Out, arrs: dict) -> CompiledCircuit:
    slots = {name: s[: out.n_slots[i]] for i, (name, s) in enumerate(zip(SLOTS, arrs["slots"]))}
    return CompiledCircuit(
        levels=_levels(arrs["col"], arrs["cst"], arrs["bits"], out.n_rows),
        n_vals2=d2.n_vals, n_valsz=dz.n_vals, m2=d2.tape, mz=dz.tape, onl2=d2.onl, pre2=d2.pre,
        onlz=dz.onl, prez=dz.pre, n_wit2=d2.wit, n_witz=dz.wit, n_inputs2=d2.n_inputs,
        n_corrs2=d2.n_corrs, n_recons2=d2.n_recons, n_inputsz=dz.n_inputs,
        n_corrsz=dz.n_corrs, n_reconsz=dz.n_recons, **slots)


def compile_program(program, carry_in: Optional[Sequence[int]] = None,
                    out_val_map: Optional[Dict[int, int]] = None,
                    carry_inz: Optional[Sequence[int]] = None,
                    out_val_mapz: Optional[Dict[int, int]] = None,
                    cache_key: Optional[bytes] = None) -> CompiledCircuit:
    """compile.compile_program on the C pass (its arguments, the disk cache
    of `cache_key` included; `program` may be an OpArrays without
    carries)."""
    path = None
    if (cache_key is not None and carry_in is None and out_val_map is None
            and carry_inz is None and out_val_mapz is None):
        path = compile_cache_path(cache_key)
        cc = None if path is None else load_cached(path)
        if cc is not None:
            return cc
    carry_in, carry_inz = list(carry_in or ()), list(carry_inz or ())
    if not carry_in and not carry_inz:
        ops = encode_program(program)
    else:
        ops = OpArrays.from_program(program, carry_in, carry_inz)
    st = _State(ops)
    cc = _circuit(*st.run(0, ops.n, np.searchsorted(ops.wires2, carry_in),
                          np.searchsorted(ops.wiresz, carry_inz)))
    for domain, dest in enumerate((out_val_map, out_val_mapz)):
        if dest is not None:
            dest.update(st.final_map(domain))
    if path is not None:
        store_cached(path, cc)
    return cc


def analyze(program) -> SimpleNamespace:
    """The whole circuit's counters and depth without its tables: the
    CompiledCircuit fields m2, mz, onl2, pre2, onlz, prez, n_wit2, n_witz,
    n_vals2, n_valsz, the record counts, and depth (its non-empty levels)."""
    ops = encode_program(program)
    d2, dz, out, arrs = _State(ops).run(0, ops.n, emit=False)
    return SimpleNamespace(
        m2=d2.tape, mz=dz.tape, onl2=d2.onl, pre2=d2.pre, onlz=dz.onl, prez=dz.pre,
        n_wit2=d2.wit, n_witz=dz.wit, n_vals2=d2.n_vals, n_valsz=dz.n_vals,
        n_inputs2=d2.n_inputs, n_corrs2=d2.n_corrs, n_recons2=d2.n_recons,
        n_inputsz=dz.n_inputs, n_corrsz=dz.n_corrs, n_reconsz=dz.n_recons,
        depth=int(arrs["level_used"].sum()))


#: Segment's base fields, and the CompiledCircuit count each advances by
_BASES = (("tape0", "m2"), ("wit0", "n_wit2"), ("onl0", "onl2"), ("pre0", "pre2"),
          ("rec0", "n_recons2"), ("cor0", "n_corrs2"), ("inp0", "n_inputs2"), ("tapez0", "mz"),
          ("witz0", "n_witz"), ("onlz0", "onlz"), ("prez0", "prez"), ("recz0", "n_reconsz"),
          ("corz0", "n_corrsz"), ("inpz0", "n_inputsz"))


class SegmentCompiler:
    """compile_segments one segment at a time: `add(hi)` compiles the ops
    from the end of the last segment to hi as the next segment and returns
    it (its cc and bases final; its carry_out, carry_out_vals and carry_src
    and their z64 twins are filled in by `finish`, which returns every
    segment).  Each op is compiled once."""

    def __init__(self, program):
        self.ops = encode_program(program)
        self.lo = 0
        self.segments: List[Segment] = []
        self._st = _State(self.ops)
        self._cross = []
        for last, wires in zip((m[2] for m in self._st.maps), (self.ops.wires2, self.ops.wiresz)):
            arrs = [np.full(len(wires), -1, np.int32) for _ in range(3)]
            self._cross.append((_Cross(*(_ptr(a) for a in arrs), _ptr(last)), arrs))
        self._ins: List[Tuple[np.ndarray, np.ndarray]] = []  # per segment and domain
        self._outs: List[np.ndarray] = []  # (domain, wire, src, val) per carry-out
        self._base = dict.fromkeys((b for b, _ in _BASES), 0)

    def add(self, hi: int) -> Segment:
        lo, s = self.lo, len(self.segments)
        c = self.ops.class_counts(lo, hi)
        cap = int(2 * c[:32].sum() + 64 * c[2 * 16 + _NOOP]) + 1
        lists = []
        for _ in range(2):
            arrs = (np.empty(cap, np.int8), np.empty(cap, np.int64), np.empty(cap, np.int32),
                    np.empty(cap, np.int32))
            lists.append((_XList(*(_ptr(a) for a in arrs), 0, cap), arrs))
        rc = _native().rc_carry_scan(ctypes.byref(self.ops._struct), lo, hi, s,
                                     ctypes.byref(self._cross[0][0]),
                                     ctypes.byref(self._cross[1][0]),
                                     ctypes.byref(lists[0][0]), ctypes.byref(lists[1][0]))
        if rc != 0:
            raise AssertionError("native carry pass: its lists were sized too small")
        (xin, (idom, iwire, isrc, _)), (xout, (odom, owire, osrc, oval)) = lists
        k = xout.n
        self._outs.append(np.stack([odom[:k].astype(np.int64), owire[:k], osrc[:k],
                                    oval[:k]]))
        ins = []
        for z in range(2):
            sel = idom[: xin.n] == z
            wires, srcs = iwire[: xin.n][sel], isrc[: xin.n][sel]
            order = np.argsort(wires, kind="stable")
            ins.append((wires[order], srcs[order]))
        self._ins.append(ins)
        cc = _circuit(*self._st.run(lo, hi, ins[0][0], ins[1][0]))
        seg = Segment(cc=cc, carry_in=self.ops.wires2[ins[0][0]].tolist(), carry_out=[],
                      carry_out_vals=np.zeros(0, np.int32), carry_src=[],
                      carry_inz=self.ops.wiresz[ins[1][0]].tolist(), **self._base)
        for base, count in _BASES:
            self._base[base] += getattr(cc, count)
        self.segments.append(seg)
        self.lo = hi
        return seg

    def finish(self) -> List[Segment]:
        outs = np.concatenate(self._outs, axis=1) if self._outs else np.zeros((4, 0), np.int64)
        rows = []  # per domain: per source segment its sorted carry-out wires
        for z, wires in enumerate((self.ops.wires2, self.ops.wiresz)):
            d = outs[:, outs[0] == z]
            per = {}
            for s in np.unique(d[2]).tolist():
                e = d[:, d[2] == s]
                order = np.argsort(e[1], kind="stable")
                per[s] = e[1][order]
                seg = self.segments[s]
                names = ("carry_out", "carry_out_vals") if z == 0 else ("carry_outz",
                                                                        "carry_outz_vals")
                setattr(seg, names[0], wires[e[1][order]].tolist())
                setattr(seg, names[1], e[3][order].astype(np.int32))
            rows.append(per)
        for seg, ins in zip(self.segments, self._ins):
            for z, (wires, srcs) in enumerate(ins):
                src = [(s, int(np.searchsorted(rows[z][s], w)))
                       for w, s in zip(wires.tolist(), srcs.tolist())]
                if z == 0:
                    seg.carry_src = src
                else:
                    seg.carry_srcz = src
        return self.segments


def compile_segments(program, seg_ops: int) -> List[Segment]:
    """compile.compile_segments on the C passes."""
    sc = SegmentCompiler(program)
    for lo in range(0, sc.ops.n, seg_ops):
        sc.add(min(lo + seg_ops, sc.ops.n))
    return sc.finish()
