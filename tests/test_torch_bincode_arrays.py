"""Program files read into arrays in C (circuit.bincode.load_program_arrays,
native/bincode.c), written from them (dump_program_arrays), proved from
them, and the compile's disk cache (cache_key), on the CPU:
- load_program_arrays equals OpArrays.from_program(load_program(b)) op for
  op, with the same distinct table rows and no duplicate, on reverie_tpu's
  dumps_program of the five-gate program, every GF(2) and Z64 opcode (Z64
  constants of 2**63 and more), B2A and SIZE_HINT, the B2A golden,
  wide_and_circuit, the SHA-256 statement and mul_bench_circuit (3 rows);
  the same errors as load_program on every truncation, trailing bytes and
  bad tags; dump_program_arrays equal to dumps_program byte for byte;
- TorchKKW, StreamingKKW and make_system on the arrays give the list's
  proof bytes;
- compile_program's cache under REVERIE_COMPILE_CACHE (a tmp_path here):
  a hit equal field for field with the same proof, a changed salt source
  a miss, "" and "0" no cache, an unreadable entry recompiled, carries
  and the streaming route never cached; the CLI's _program_cache_key
  equal to reverie_tpu's, and the CLI's verify reading the prove's entry.
Arrays and bytes: the tolerance is 0."""

import dataclasses
import functools
import hashlib
import io
import pathlib
import pickle
import shutil
import struct

import numpy as np
import pytest
import torch

import reverie_tpu.circuit as jcircuit
from reverie_tpu import cli as jcli
from reverie_tpu.circuit import builders as jbuilders
from reverie_tpu.circuit import sha256 as jsha256

from reverie_tpu_torch import StreamingKKW, TorchKKW, cli, make_system
from reverie_tpu_torch.circuit import Kind, builders, dumps_program, load_program
from reverie_tpu_torch.circuit import compile as tcompile
from reverie_tpu_torch.circuit import compile_native as native
from reverie_tpu_torch.circuit.bincode import _read_op, dump_program_arrays, load_program_arrays
from reverie_tpu_torch.circuit.compile_native import OpArrays
from reverie_tpu_torch.params import DEFAULT_PARAMS

from test_torch_cli import five_gate, fix_urandom, port
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def every_opcode():
    """Every GF(2) and Z64 opcode (Z64 constants 2**63 and past it, a GF(2)
    constant), a B2A and a SIZE_HINT, in reverie_tpu's classes."""
    g, z, G, Op = jcircuit.CombineOp.gf2, jcircuit.CombineOp.z64, jcircuit.Gate, jcircuit.Op
    prog = [jcircuit.CombineOp.size_hint(30, 300)]
    for make, c1, c2, c3 in ((g, 1, 1, 1), (z, 2**63, 2**64 - 1, 2**63 + 12345)):
        prog += [make(G(Op.INPUT, dst=0)), make(G(Op.INPUT, dst=1)), make(G(Op.RANDOM, dst=2)),
                 make(G(Op.ADD, dst=3, src1=0, src2=1)), make(G(Op.ADDC, dst=4, src1=3, const=c1)),
                 make(G(Op.SUB, dst=5, src1=4, src2=2)), make(G(Op.SUBC, dst=6, src1=5, const=c2)),
                 make(G(Op.MUL, dst=7, src1=6, src2=1)), make(G(Op.MULC, dst=8, src1=7, const=c3)),
                 make(G(Op.CONST, dst=9, const=c1)), make(G(Op.ASSERT_ZERO, src1=9)),
                 make(G(Op.MUL, dst=10**12, src1=8, src2=8))]
    return prog + [jcircuit.CombineOp.b2a(11, 40), jcircuit.CombineOp.size_hint(2**64 - 1, 7)]


PROGRAMS = {
    "five_gate": five_gate,
    "every_opcode": every_opcode,
    "b2a_size_hint": lambda: jbuilders.mixed_b2a_circuit()[0]
    + [jcircuit.CombineOp.size_hint(9, 70), jcircuit.CombineOp.b2a(3, 0)],
    "b2a_golden": lambda: jcircuit.load_program((GOLDEN / "b2a_program.bin").read_bytes()),
    "wide_and": lambda: jbuilders.wide_and_circuit(400, width=24, seed=7)[0],
    "sha256": lambda: jsha256.sha256_preimage_statement(hashlib.sha256(b"abc").digest())[0],
    "mul_bench": lambda: jbuilders.mul_bench_circuit(5000)[0],
}
FIELDS = ("kind", "op", "dst", "src1", "src2", "a", "b", "cst")


@functools.lru_cache(maxsize=None)
def blob_of(name: str) -> bytes:
    """reverie_tpu's dumps_program of PROGRAMS[name]."""
    return jcircuit.dumps_program(PROGRAMS[name]())


def rows(ops: OpArrays) -> list:
    """The raw table's rows, as tuples."""
    raw = ops.raw_table()
    return list(zip(*(raw[f].tolist() for f in FIELDS)))


def assert_same_program(got: OpArrays, want: OpArrays) -> None:
    """Op for op the same fields (a B2A's b through its bsrc row), the same
    wires of each domain and counting classes."""
    assert got.n == want.n
    for f in ("kind", "op", "dst", "src1", "src2", "a", "cst", "cls"):
        np.testing.assert_array_equal(getattr(got, f)[got.code], getattr(want, f)[want.code],
                                      err_msg=f)
    b2a = want.kind[want.code] == Kind.B2A
    np.testing.assert_array_equal(got.bsrc[got.b[got.code][b2a]],
                                  want.bsrc[want.b[want.code][b2a]])
    np.testing.assert_array_equal(got.b[got.code][~b2a], want.b[want.code][~b2a])
    np.testing.assert_array_equal(got.wires2, want.wires2)
    np.testing.assert_array_equal(got.wiresz, want.wiresz)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_load_program_arrays_equals_the_list_reader(name):
    blob = blob_of(name)
    got = load_program_arrays(blob)
    want = OpArrays.from_program(load_program(blob))
    assert got.objects is None and want.objects is not None
    assert_same_program(got, want)
    assert len(set(rows(got))) == len(rows(got))  # each distinct op once
    assert set(rows(got)) == set(rows(want))
    if name == "mul_bench":
        assert len(got.kind) == 3


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_dump_program_arrays_equals_dumps_program(name):
    blob = blob_of(name)
    for ops in (load_program_arrays(blob), OpArrays.from_program(load_program(blob))):
        out = io.BytesIO()
        dump_program_arrays(ops, out)
        assert out.getvalue() == blob


def test_gf2_constant_byte_as_read():
    """A GF(2) constant byte other than 0 and 1: both readers keep the byte,
    and dump_program_arrays writes its low bit, as dumps_program does."""
    prog = [jcircuit.CombineOp.gf2(jcircuit.Gate(jcircuit.Op.INPUT, dst=0)),
            jcircuit.CombineOp.gf2(jcircuit.Gate(jcircuit.Op.ADDC, dst=1, src1=0, const=1))]
    blob = bytearray(jcircuit.dumps_program(prog))
    assert blob[-1] == 1
    blob[-1] = 7
    listed = load_program(bytes(blob))
    assert listed[1].gate.const == 7
    got = load_program_arrays(bytes(blob))
    assert int(got.cst[got.code[1]]) == 7
    out = io.BytesIO()
    dump_program_arrays(got, out)
    blob[-1] = 1
    assert out.getvalue() == bytes(blob)


def error_of(read, data):
    """(type, message) of the error read(data) raises."""
    with pytest.raises(Exception) as e:
        read(data)
    return type(e.value), str(e.value)


def with_count(blob: bytes, count: int) -> bytes:
    return struct.pack("<Q", count) + blob[8:]


@pytest.mark.parametrize("name", ["five_gate", "every_opcode", "b2a_size_hint"])
def test_errors_equal_load_programs(name):
    """Every truncation of the file, trailing bytes, a count past or short of
    the records, an unknown kind tag and an unknown opcode tag in GF(2) and
    Z64: the same error type and message as load_program."""
    blob = blob_of(name)
    n = struct.unpack_from("<Q", blob)[0]
    bad = [blob[:cut] for cut in range(len(blob))]
    bad += [blob + b"\0", blob + bytes(9), with_count(blob, n + 1), with_count(blob, n - 1),
            with_count(blob, 2**64 - 1)]
    # the first record's kind tag, and the opcode tags (past the last
    # opcode) of the first GF(2) and the first Z64 record
    tags, pos, seen = [(8, 4), (8, 2**32 - 1)], 8, set()
    for op in load_program(blob):
        if op.kind in (Kind.GF2, Kind.Z64) and op.kind not in seen:
            seen.add(op.kind)
            tags += [(pos + 4, 10), (pos + 4, 2**31)]
        pos = _read_op(memoryview(blob), pos)[1]
    for at, tag in tags:
        b = bytearray(blob)
        b[at:at + 4] = struct.pack("<I", tag)
        bad.append(bytes(b))
    for data in bad:
        want = error_of(load_program, data)
        assert error_of(load_program_arrays, data) == want, (len(data), want)


# -- proofs from the arrays ----------------------------------------------------


CIRCUITS = {
    "mul": lambda: builders.mul_bench_circuit(30),
    "z64_mul": lambda: builders.z64_mul_bench_circuit(12),
    "b2a": builders.mixed_b2a_circuit,
    "wide_and": lambda: builders.wide_and_circuit(40, width=12, seed=3),
}
SYSTEMS = {
    "TorchKKW": lambda p: TorchKKW(p, device=CPU),
    "StreamingKKW": lambda p: StreamingKKW(p, 9, device=CPU),
    "make_system": lambda p: make_system(p, device=CPU, hbm_budget_bytes=200_000),
}


def seeds(seed: int = 15) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (256, 16), dtype=np.uint8)


@pytest.mark.parametrize("system", list(SYSTEMS))
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_proof_from_arrays_equals_the_lists(name, system):
    prog, w2, wz = CIRCUITS[name]()
    ops = load_program_arrays(dumps_program(prog))
    make = SYSTEMS[system]
    got = make(ops).prove(w2, wz, seeds=seeds())
    assert got.to_bytes() == make(prog).prove(w2, wz, seeds=seeds()).to_bytes()
    assert make(ops).verify(got) is True


def test_arrays_of_reverie_tpu_ops_are_refused():
    """An OpArrays made from reverie_tpu's op objects keeps them, and
    TorchKKW, StreamingKKW and make_system refuse it as they refuse the
    list."""
    ops = OpArrays.from_program(jbuilders.mul_bench_circuit(4)[0])
    for make in SYSTEMS.values():
        with pytest.raises(TypeError, match="bincode"):
            make(ops)


# -- the compile cache ---------------------------------------------------------


@pytest.fixture()
def cache(monkeypatch, tmp_path):
    """REVERIE_COMPILE_CACHE in the test's directory; returns it."""
    d = tmp_path / "cache"
    monkeypatch.setenv("REVERIE_COMPILE_CACHE", str(d))
    return d


def count_compiles(monkeypatch) -> list:
    calls = []
    real = native._State.run

    def run(self, *args, **kwargs):
        calls.append(args[:2])
        return real(self, *args, **kwargs)

    monkeypatch.setattr(native._State, "run", run)
    return calls


def assert_circuits_equal(a, b) -> None:
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "levels":
            assert len(x) == len(y)
            for lx, ly in zip(x, y):
                assert lx.keys() == ly.keys()
                for key in ly:
                    assert lx[key].keys() == ly[key].keys()
                    for col in ly[key]:
                        assert lx[key][col].dtype == ly[key][col].dtype
                        np.testing.assert_array_equal(lx[key][col], ly[key][col])
        elif isinstance(y, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", ["b2a", "wide_and"])
def test_cache_hit_equals_the_compile(name, cache, monkeypatch):
    """The second compile with a key reads the entry the first wrote: no C
    pass, a CompiledCircuit equal field for field, and TorchKKW on it gives
    the same proof; no temporary file is left."""
    prog, w2, wz = CIRCUITS[name]()
    calls = count_compiles(monkeypatch)
    first = tcompile.compile_program(prog, cache_key=b"key")
    assert len(calls) == 1 and [p.suffix for p in cache.iterdir()] == [".pkl"]
    again = tcompile.compile_program(load_program_arrays(dumps_program(prog)), cache_key=b"key")
    assert len(calls) == 1 and again is not first
    assert_circuits_equal(again, first)
    assert_circuits_equal(again, tcompile.compile_program_plain(prog))
    proof = TorchKKW(prog, DEFAULT_PARAMS, None, None, b"key", device=CPU).prove(w2, wz, seeds=seeds())
    assert len(calls) == 1
    assert proof.to_bytes() == TorchKKW(prog, cc=first, device=CPU).prove(
        w2, wz, seeds=seeds()).to_bytes()
    tcompile.compile_program(prog, cache_key=b"another key")
    assert len(calls) == 2 and len(list(cache.iterdir())) == 2


def test_cache_salt_covers_the_compiles_sources():
    names = {p.name for p in tcompile.CACHE_SOURCES}
    assert {"compile.py", "compile_native.py", "ir.py", "compile.c"} <= names
    assert all(p.is_file() for p in tcompile.CACHE_SOURCES)


@pytest.mark.parametrize("source", [p.name for p in tcompile.CACHE_SOURCES])
def test_a_changed_salt_source_misses(source, cache, monkeypatch, tmp_path):
    copies = []
    for p in tcompile.CACHE_SOURCES:
        copies.append(tmp_path / "src" / p.name)
        copies[-1].parent.mkdir(exist_ok=True)
        shutil.copy(p, copies[-1])
    monkeypatch.setattr(tcompile, "CACHE_SOURCES", tuple(copies))
    prog = CIRCUITS["mul"]()[0]
    calls = count_compiles(monkeypatch)
    tcompile.compile_program(prog, cache_key=b"key")
    tcompile.compile_program(prog, cache_key=b"key")
    assert len(calls) == 1
    changed = tmp_path / "src" / source
    changed.write_bytes(changed.read_bytes() + b"\n")
    tcompile.compile_program(prog, cache_key=b"key")
    assert len(calls) == 2 and len(list(cache.iterdir())) == 2


@pytest.mark.parametrize("value", ["0", ""])
def test_no_cache_when_turned_off(value, monkeypatch, tmp_path):
    monkeypatch.setenv("REVERIE_COMPILE_CACHE", value)
    monkeypatch.setenv("HOME", str(tmp_path))
    calls = count_compiles(monkeypatch)
    prog = CIRCUITS["mul"]()[0]
    for _ in range(2):
        tcompile.compile_program(prog, cache_key=b"key")
    assert len(calls) == 2 and not list(tmp_path.iterdir())


def test_default_cache_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("REVERIE_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    tcompile.compile_program(CIRCUITS["mul"]()[0], cache_key=b"key")
    assert len(list((tmp_path / ".cache" / "reverie_tpu_torch" / "circuits").iterdir())) == 1


@pytest.mark.parametrize("entry", ["garbage", "truncated", "empty", "foreign"])
def test_an_unreadable_entry_is_recompiled(entry, cache, monkeypatch):
    prog = CIRCUITS["b2a"]()[0]
    want = tcompile.compile_program(prog, cache_key=b"key")
    path = next(cache.iterdir())
    blob = path.read_bytes()
    path.write_bytes({"garbage": b"\x80\x05not a pickle", "truncated": blob[: len(blob) // 2],
                      "empty": b"", "foreign": pickle.dumps({"levels": []})}[entry])
    calls = count_compiles(monkeypatch)
    assert_circuits_equal(tcompile.compile_program(prog, cache_key=b"key"), want)
    assert len(calls) == 1 and path.read_bytes() == blob
    tcompile.compile_program(prog, cache_key=b"key")
    assert len(calls) == 1


def test_carries_and_streaming_are_not_cached(cache):
    """A compile with carries or an out map, and make_system's streaming
    route, write no entry (reverie_tpu's semantics: whole compiles only)."""
    prog = CIRCUITS["mul"]()[0]
    tcompile.compile_program(prog, carry_in=[], cache_key=b"key")
    tcompile.compile_program(prog, out_val_map={}, cache_key=b"key")
    sk = make_system(prog, DEFAULT_PARAMS, None, 20_000, b"key", device=CPU)
    assert isinstance(sk, StreamingKKW) and not cache.exists()


@pytest.mark.parametrize("fmt, out", [("bincode", ""), ("bristol", ""), ("bristol", "0110")])
def test_program_cache_key_equals_reverie_tpus(fmt, out):
    data = bytes(range(256)) * 3
    assert cli._program_cache_key(data, fmt, out) == jcli._program_cache_key(data, fmt, out)
    assert cli._program_cache_key(memoryview(data), fmt, out) == \
        jcli._program_cache_key(data, fmt, out)


def test_cli_reads_arrays_and_caches_the_compile(tmp_path, capsys, cache, monkeypatch):
    """The CLI reads a bincode file into OpArrays (op objects for oneshot);
    its prove writes the compile's entry under the file's key, and its
    verify compiles nothing; an empty file raises load_program's error."""
    prog_path = tmp_path / "prog.bin"
    prog_path.write_bytes(jcircuit.dumps_program(five_gate()))
    (tmp_path / "wit.txt").write_bytes(jcircuit.format_witness_bits([True, True]))
    program, key = cli._load_program(str(prog_path), "bincode")
    assert isinstance(program, OpArrays) and key == jcli._program_cache_key(
        prog_path.read_bytes(), "bincode", "")
    listed, _ = cli._load_program(str(prog_path), "bincode", objects=True)
    assert listed == load_program(prog_path.read_bytes())
    fix_urandom(monkeypatch, 3)
    proof = tmp_path / "proof.bin"
    assert port(capsys, "--operation", "prove", "--program-path", prog_path, "--witness-path",
                tmp_path / "wit.txt", "--proof-path", proof)[0] == 0
    assert len(list(cache.iterdir())) == 1
    calls = count_compiles(monkeypatch)
    rc, out, _ = port(capsys, "--operation", "verify", "--program-path", prog_path,
                      "--proof-path", proof)
    assert rc == 0 and out.endswith("Ok(())\n") and calls == []
    (tmp_path / "empty.bin").write_bytes(b"")
    assert error_of(lambda p: cli._load_program(p, "bincode"), str(tmp_path / "empty.bin")) == \
        error_of(load_program, b"")
