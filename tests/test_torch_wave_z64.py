"""The wave executor's z64 and B2A side (reverie_tpu_torch.backend.scan,
the plain version `wave_ref` of the CUDA kernel W2) on the CPU, against
reverie_tpu: `ScanExecutor` against reverie_tpu's ScanExecutor (JAX on the
CPU) in all three roles on the deep z64 chain, deep B2A, every z64 kind
and random mixed programs; the slot allocator across the two domains and
two numpy emulations of W2's z64 half, on the slot tables and on the
packed slots and staged words of its chunks; TorchKKW's routing of
deep mixed circuits to the waves, with proofs equal to the NumPy golden's
(to which reverie_tpu's tests hold TpuKKW on the same statements and
seeds).  Everything is integer: the tolerance is 0.  W2 itself
against the plain version: the `cuda` tests of tests/test_torch_package.py
(the card's machine has no jax)."""

import copy
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reverie_tpu.backend.tpu_scan import ScanExecutor as JScanExecutor
from reverie_tpu.circuit import dumps_program, load_program as j_load
from reverie_tpu.circuit.compile import compile_program as j_compile
from reverie_tpu.proof import prove as golden_prove
from reverie_tpu_torch import TorchKKW
from reverie_tpu_torch.backend import executor as tex, host, scan
from reverie_tpu_torch.circuit import dumps_program as t_dumps, load_program
from reverie_tpu_torch.circuit.compile import B2A_CORR, B2A_OUT, _NOP, G_ASSERT, compile_program
from reverie_tpu_torch.proof import Proof

from test_torch_package import (
    MODES, OUT_KEYS, Z64_PROGRAMS, deep_b2a, executor_inputs, on, random_mixed, z64_all_ops,
    z64_chain)
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
PROGRAMS = {"mixed_b2a": lambda: load_program((GOLDEN / "b2a_program.bin").read_bytes()),
            "chain150": lambda: z64_chain(150)[0], "deep_b2a": lambda: deep_b2a(200)[0],
            "all_ops": lambda: z64_all_ops(40)[0],
            **{f"random{s}": (lambda s=s: random_mixed(s)[0]) for s in range(1, 6)}}


def jax_inputs(inp: dict) -> dict:
    """The port's executor inputs in reverie_tpu's names and forms: int64
    words as lo / hi uint32 pairs, the GF(2) tape as tape2."""
    out = {}
    for k, v in inp.items():
        if v.dtype == np.int64:
            u = v.view(np.uint64)
            out[k + "_lo"] = jnp.asarray((u & 0xFFFF_FFFF).astype(np.uint32))
            out[k + "_hi"] = jnp.asarray((u >> 32).astype(np.uint32))
        else:
            out["tape2" if k == "tape" else k] = jnp.asarray(v)
    return out


@pytest.fixture(scope="module")
def circuits():
    """(reverie_tpu's, the port's) compiled circuit per program, once."""
    cache = {}

    def get(name):
        if name not in cache:
            prog = PROGRAMS[name]()
            cache[name] = (j_compile(j_load(t_dumps(prog))), compile_program(prog))
        return cache[name]
    return get


#: (program, role): the named statements in every role, the random ones
#: (seeds 1-5) in one role each, in turn
SCAN_CASES = [(name, mode) for name in PROGRAMS if not name.startswith("random")
              for mode in MODES] + [(f"random{s}", MODES[s % 3]) for s in range(1, 6)]


@pytest.mark.parametrize("name, mode", SCAN_CASES)
def test_scan_executor_matches_reverie_tpu(circuits, name, mode):
    """onl2, pre2, onlz, prez and fail equal reverie_tpu's ScanExecutor's
    on the same inputs (R = 40 in VERIFY_ONL, with each rep's omitted
    player in the records, else 24)."""
    jcc, cc = circuits(name)
    R = 40 if mode == tex.VERIFY_ONL else 24
    inp = executor_inputs(cc, mode, R, seed=3 + mode)
    got = scan.ScanExecutor(cc, mode, R, CPU)(on(inp, CPU))
    want = JScanExecutor(jcc, mode, total_reps=R)(jax_inputs(inp))
    for key, n in (("onl2", cc.onl2), ("pre2", cc.pre2), ("onlz", cc.onlz), ("prez", cc.prez)):
        assert got[key].shape == (max(n, 1), R), key
        np.testing.assert_array_equal(got[key][:n].numpy(), np.asarray(want[key])[:n],
                                      err_msg=key)
    np.testing.assert_array_equal(got["fail"].numpy(), np.asarray(want["fail"]))
    if mode == tex.VERIFY_ONL and (scan.waves(cc).zop == G_ASSERT).any():
        assert bool(got["fail"].any())  # random records fail the z64 asserts


@pytest.mark.parametrize("name", ["chain150", "deep_b2a", "random3"])
def test_scan_executor_matches_levelized(circuits, name):
    """Every output of the levelized Executor in each role, at a ragged R."""
    _, cc = circuits(name)
    for mode in MODES:
        inp = on(executor_inputs(cc, mode, 37, seed=mode), CPU)
        got = scan.ScanExecutor(cc, mode, 37, CPU)(inp)
        want = tex.Executor(cc, mode, 37, CPU)(inp)
        for key in OUT_KEYS:
            assert torch.equal(got[key], want[key]), (mode, key)


# -- the slot allocator across domains ------------------------------------------


def gf2_reads(t, zt, bits):
    """Per wave, the GF(2) slots its GF(2) gates and its B2A slots read."""
    op = t[..., 0]
    ra, rb = np.isin(op, scan._READS_A), np.isin(op, scan._READS_B)
    zop = zt[..., scan._ZOP]
    b2a = np.isin(zop, (B2A_CORR, B2A_OUT))
    for w in range(t.shape[0]):
        yield (set(t[w, ra[w], 2]) | set(t[w, rb[w], 3])
               | set(bits[zt[w, b2a[w], scan._ZBITS]].reshape(-1).tolist()))


@pytest.mark.parametrize("name", ["deep_b2a", "mixed_b2a", "random2"])
def test_allocator_holds_b2a_bits(circuits, name):
    """A GF(2) slot is not taken again before its value's last read by a
    B2A slot: every B2A bit finds, in its wave, the GF(2) value the SSA
    table reads, with the GF(2) slots cut to a few (most spilled) and
    all shared; and no wave writes a slot of either domain that it reads."""
    _, cc = circuits(name)
    wv = scan.waves(cc)
    t, (zt, bits) = scan.wave_table(wv, tex.PROVER), scan.zwave_table(wv, tex.PROVER)
    n2, nz = scan.live_sets(t, zt, bits)
    for cap in (n2, 4):
        sl = scan.allocate_waves(t, cap, zt, bits, nz)
        assert sl.n_shared <= cap and (sl.n_spill > 0) == (cap < n2)
        holder = {0: 0}  # GF(2) slot -> the SSA value it holds
        op = t[..., 0]
        writes = (op != _NOP) & (op != G_ASSERT)
        zop = zt[..., scan._ZOP]
        b2a = np.isin(zop, (B2A_CORR, B2A_OUT))
        for w, reads in enumerate(gf2_reads(sl.table, sl.ztable, sl.bits)):
            assert not reads & set(sl.table[w, writes[w], 1]), f"wave {w}"
            for s_row, v_row in zip(sl.ztable[w, b2a[w], scan._ZBITS],
                                    zt[w, b2a[w], scan._ZBITS]):
                for s, v in zip(sl.bits[s_row], bits[v_row]):
                    assert holder[int(s)] == int(v), f"wave {w}: bit slot {s} lost {v}"
            for s, v in zip(sl.table[w, writes[w], 1], t[w, writes[w], 1]):
                holder[int(s)] = int(v)
            zw = (zop[w] != _NOP) & (zop[w] != G_ASSERT)
            zreads = set(sl.ztable[w, np.isin(zop[w], scan._ZREADS_A), scan._ZA]) | set(
                sl.ztable[w, np.isin(zop[w], scan._ZREADS_B), scan._ZB])
            assert not zreads & set(sl.ztable[w, zw, scan._ZDST]), f"wave {w} (z64)"


def emulate_z64(zt: np.ndarray, bits: np.ndarray, mode: int, inp: dict, n_valsz: int,
                gf2_state, cc) -> dict:
    """W2's z64 half in numpy over the reps, one wave at a time, from each
    slot's 16 words of the slot table (zwave_table's columns, which the
    kernel first read as they are); gf2_state(w) gives the GF(2) (mask,
    corr) arenas before wave w."""
    R = inp["tapez"].shape[2]
    u = lambda a: a.view(np.uint64)  # noqa: E731
    vz = np.zeros((n_valsz + 1, 9, R), dtype=np.uint64)
    onlz = np.zeros((max(cc.onlz, 1), R), dtype=np.uint8)
    prez = np.zeros((max(cc.prez, 1), R), dtype=np.uint8)
    onl2 = {}
    fail = np.zeros(R, dtype=bool)
    tape, xin = u(inp["tapez"]), inp.get("witz" if mode == 0 else "inz")
    co, re = inp.get("coz"), inp.get("rez")

    def put8(rows, row, v):
        rows[row : row + 8] = ((v[None, :] >> (8 * np.arange(8, dtype=np.uint64))[:, None])
                               & 0xFF).astype(np.uint8)

    with np.errstate(over="ignore"):
        for w in range(zt.shape[0]):
            m2, c2 = gf2_state(w)
            new = []
            for word in zt[w].astype(np.int64):
                op, dst, a, b, brow, t0, t1, xr, rec, corr, onl, pre = word[:12]
                k = np.uint64((int(word[13]) & 0xFFFF_FFFF) << 32 | (int(word[12]) & 0xFFFF_FFFF))
                brec, bonl = word[14], word[15]
                A, B = vz[a], vz[b]
                if op == _NOP:
                    continue
                out = np.zeros((9, R), dtype=np.uint64)
                if op == 5:  # MUL
                    s = B[:8] * A[8] + A[:8] * B[8] + tape[t0] - tape[t1]
                    if mode == 1:
                        s = s + u(re[rec])
                    d = u(co[corr]) if mode == 1 else A[:8].sum(0) * B[:8].sum(0) - tape[t0].sum(0)
                    out[:8] = tape[t1]
                    out[8] = (np.uint64(0) if mode == 2 else s.sum(0) + d) + A[8] * B[8]
                    put8(prez, pre, d)
                    if mode != 2:
                        for p in range(8):
                            put8(onlz, onl + 8 * p, s[p])
                elif op == G_ASSERT:
                    if mode != 2:
                        s = A[:8] + (u(re[rec]) if mode == 1 else np.uint64(0))
                        fail |= (s.sum(0) + A[8]) != 0
                        for p in range(8):
                            put8(onlz, onl + 8 * p, s[p])
                    continue
                elif op in (0, 7, B2A_CORR):  # INPUT, RANDOM, B2A_CORR
                    out[:8] = tape[t0]
                    if op == 0 and mode != 2:
                        out[8] = u(xin[xr]) - (tape[t0].sum(0) if mode == 0 else np.uint64(0))
                        put8(onlz, onl, out[8])
                    elif op == B2A_CORR:
                        par = np.array([[bin(x).count("1") & 1 for x in m2[v]] for v in bits[brow]],
                                       dtype=np.uint64)
                        comp = (par << np.arange(64, dtype=np.uint64)[:, None]).sum(0)
                        out[8] = u(co[corr]) if mode == 1 else comp - tape[t0].sum(0)
                        put8(prez, pre, out[8])
                elif op == B2A_OUT:
                    sb = m2[bits[brow]].astype(np.uint64)
                    if mode == 1:
                        sb ^= inp["re2"][brec : brec + 64].astype(np.uint64)
                    bc = c2[bits[brow]].astype(np.uint64)
                    par = np.vectorize(lambda x: bin(int(x)).count("1") & 1)(sb).astype(np.uint64)
                    ob = bc if mode == 2 else par ^ bc
                    out[:8] = np.uint64(0) - B[:8]
                    out[8] = (ob << np.arange(64, dtype=np.uint64)[:, None]).sum(0) - B[8]
                    if mode != 2:
                        onl2[int(bonl)] = sb.astype(np.uint8)
                else:  # ADD, SUB, ADDC, SUBC, MULC, CONST
                    out[:8] = {1: A[:8] + B[:8], 9: A[:8] - B[:8], 4: A[:8] * k,
                               8: np.zeros_like(A[:8])}.get(op, A[:8])
                    out[8] = {1: A[8] + B[8], 9: A[8] - B[8], 2: A[8] + k, 3: A[8] - k,
                              4: A[8] * k, 8: np.full(R, k)}[op]
                new.append((dst, out))
            for dst, out in new:  # after the wave's reads, as after its barrier
                vz[dst] = out
    return dict(onlz=onlz, prez=prez, onl2=onl2, fail=fail)


def gf2_states(prog, mode: int, inp: dict, cc, R: int) -> list:
    """The GF(2) (mask, corr) arenas before each wave of prog, from the
    plain version's GF(2) waves on the inputs."""
    states = []
    st = dict(mask2=torch.zeros((prog.n_vals + 1, R), dtype=torch.uint8),
              corr2=torch.zeros((prog.n_vals + 1, R), dtype=torch.uint8),
              onl2=torch.zeros((cc.onl2 + 1, R), dtype=torch.uint8),
              pre2=torch.zeros((cc.pre2 + 1, R), dtype=torch.uint8),
              fail=torch.zeros(R, dtype=torch.bool))
    x = on({k: inp[k] for k in ("tape", "wit2", "in2", "co2", "re2") if k in inp}, CPU)
    xin = x.get("wit2") if mode == 0 else x.get("in2")
    cols = prog.table.to(torch.int64).permute(0, 2, 1)
    for w in range(cols.shape[0]):
        states.append((st["mask2"].numpy().copy(), st["corr2"].numpy().copy()))
        scan._gf2_wave(st, cols[w].contiguous(), mode, x["tape"], scan._rows(xin, R, CPU),
                       scan._rows(x.get("co2"), R, CPU), scan._rows(x.get("re2"), R, CPU))
    return states


def assert_z64_events(got: dict, want: dict, prog, cc, mode: int) -> None:
    """An emulation's onlz, prez, B2A onl2 rows and z64 fails against the
    plain version's outputs."""
    for key, n in (("onlz", cc.onlz), ("prez", cc.prez)):
        np.testing.assert_array_equal(got[key][:n], want[key][:n].numpy(), err_msg=key)
    for row, ev in got["onl2"].items():
        np.testing.assert_array_equal(ev, want["onl2"][row : row + 64].numpy())
    n_out = int((prog.ztable[..., scan._ZOP] == B2A_OUT).sum())
    assert n_out and len(got["onl2"]) == (0 if mode == 2 else n_out)
    if mode != tex.VERIFY_PRE:
        assert not (got["fail"] & ~want["fail"].numpy()).any()


@pytest.mark.parametrize("mode", MODES)
def test_emulated_w2_equals_the_plain_version(circuits, mode):
    """The z64 slot table's words, emulated as W2 reads them (emulate_z64),
    give the plain version's onlz, prez, B2A onl2 rows and z64 fails, on
    deep B2A (spilled and shared) and a random mixed program."""
    for name, capz in (("deep_b2a", 0), ("random4", 1)):
        _, cc = circuits(name)
        R = 16
        inp = executor_inputs(cc, mode, R, seed=11 + mode)
        prog = scan.circuit_program(cc, mode, CPU, R, capacityz=capz)
        assert (prog.n_spillz > 0) == (capz == 1)
        want = scan.ScanExecutor(cc, mode, R, CPU)(on(inp, CPU))
        states = gf2_states(prog, mode, inp, cc, R)
        got = emulate_z64(prog.ztable.numpy(), prog.bits.numpy(), mode, inp, prog.n_valsz,
                          lambda w: states[w], cc)
        assert_z64_events(got, want, prog, cc, mode)


def _put8(rows, row, v):
    rows[row : row + 8] = ((v[None, :] >> (8 * np.arange(8, dtype=np.uint64))[:, None])
                           & 0xFF).astype(np.uint8)


def _compose(bits64):
    return (bits64.astype(np.uint64) << np.arange(64, dtype=np.uint64)[:, None]).sum(0)


def _parity(v):
    return np.vectorize(lambda b: bin(int(b)).count("1") & 1)(v).astype(np.uint64)


def emulate_staged(packed, bits: np.ndarray, mode: int, inp: dict, n_sharedz: int,
                   n_spillz: int, gf2_state, cc, chunk: int) -> dict:
    """W2's z64 half as csrc/scan_z64.cu stages and runs it, in numpy over
    the R reps as one block: for each chunk of waves, its staged words from
    its fields of pack_ztable (field e's word for rep x at words[e, x]; a
    re2 field's eight rows of R bytes in its R words) and its bits rows;
    each slot decoded once from its packed words (its operands and its
    destination settled in shared memory or the spill arena, its first
    staged word and bits row counted from the chunk's) and run on them."""
    zslots, zfields, zoff = packed
    R = inp["tapez"].shape[2]
    u = lambda a: np.ascontiguousarray(a).view(np.uint64)  # noqa: E731
    src = {0: u(inp["tapez"]).reshape(-1, R), 1: inp.get("witz" if mode == 0 else "inz"),
           2: inp.get("coz"), 3: None if "rez" not in inp else u(inp["rez"]).reshape(-1, R)}
    shared = np.zeros((n_sharedz, 9, R), dtype=np.uint64)
    spill = np.zeros((max(n_spillz, 1), 9, R), dtype=np.uint64)
    onlz = np.zeros((max(cc.onlz, 1), R), dtype=np.uint8)
    prez = np.zeros((max(cc.prez, 1), R), dtype=np.uint8)
    onl2, fail = {}, np.zeros(R, dtype=bool)
    f = zfields.view(np.uint32).astype(np.int64)

    def ref(s):
        return (shared, s) if s < n_sharedz else (spill, s - n_sharedz)

    with np.errstate(over="ignore"):
        for ci, w0 in enumerate(range(0, zslots.shape[0], chunk)):
            fields = f[zoff[ci, 0] : zoff[ci + 1, 0]]
            words = np.zeros((len(fields), R), dtype=np.uint64)
            for e, field in enumerate(fields):
                source, row = field >> 29, field & 0x1FFFFFFF
                if source == 4:  # eight re2 rows, R bytes each
                    words[e].view(np.uint8)[:] = inp["re2"][row : row + 8].reshape(-1)
                else:
                    words[e] = u(src[source][row])
            brows = bits[zoff[ci, 1] : zoff[ci + 1, 1]]
            for w in range(w0, min(w0 + chunk, zslots.shape[0])):
                m2, c2 = gf2_state(w)
                new = []
                for word in zslots[w].view(np.uint32).astype(np.int64):
                    op = word[0] & 0xFF
                    if op == _NOP:
                        continue
                    dst, (aa, ai), (ba, bi) = ref(word[0] >> 8), ref(word[1]), ref(word[2])
                    A, B = aa[ai], ba[bi]
                    e, row = word[3] & 0xFFFF, word[3] >> 16
                    onl, pre = word[4], word[5]
                    k = np.uint64(word[7] << 32 | word[6])
                    IN = words[e : e + 25]
                    out = np.zeros((9, R), dtype=np.uint64)
                    if op == 5:  # MUL: t0, t1, rez, coz
                        s = B[:8] * A[8] + A[:8] * B[8] + IN[0:8] - IN[8:16]
                        if mode == 1:
                            s = s + IN[16:24]
                        d = IN[24] if mode == 1 else A[:8].sum(0) * B[:8].sum(0) - IN[0:8].sum(0)
                        out[:8] = IN[8:16]
                        out[8] = (np.uint64(0) if mode == 2 else s.sum(0) + d) + A[8] * B[8]
                        _put8(prez, pre, d)
                        if mode != 2:
                            for p in range(8):
                                _put8(onlz, onl + 8 * p, s[p])
                    elif op == G_ASSERT:
                        if mode != 2:
                            s = A[:8] + (IN[0:8] if mode == 1 else np.uint64(0))
                            fail |= (s.sum(0) + A[8]) != 0
                            for p in range(8):
                                _put8(onlz, onl + 8 * p, s[p])
                        continue
                    elif op in (0, 7, B2A_CORR):  # INPUT, RANDOM, B2A_CORR: t0, then xin / coz
                        out[:8] = IN[0:8]
                        if op == 0 and mode != 2:
                            out[8] = IN[8] - (IN[0:8].sum(0) if mode == 0 else np.uint64(0))
                            _put8(onlz, onl, out[8])
                        elif op == B2A_CORR:
                            out[8] = (IN[8] if mode == 1 else
                                      _compose(_parity(m2[brows[row]])) - IN[0:8].sum(0))
                            _put8(prez, pre, out[8])
                    elif op == B2A_OUT:  # re2's 64 rows in the eight words
                        sb = m2[brows[row]].astype(np.uint64)
                        if mode == 1:
                            sb ^= IN[0:8].view(np.uint8).reshape(64, R)
                        ob = c2[brows[row]] if mode == 2 else _parity(sb) ^ c2[brows[row]]
                        out[:8] = np.uint64(0) - B[:8]
                        out[8] = _compose(ob) - B[8]
                        if mode != 2:
                            onl2[int(onl)] = sb.astype(np.uint8)
                    else:  # ADD, SUB, ADDC, SUBC, MULC, CONST
                        out[:8] = {1: A[:8] + B[:8], 9: A[:8] - B[:8], 4: A[:8] * k,
                                   8: np.zeros_like(A[:8])}.get(op, A[:8])
                        out[8] = {1: A[8] + B[8], 9: A[8] - B[8], 2: A[8] + k, 3: A[8] - k,
                                  4: A[8] * k, 8: np.full(R, k)}[op]
                    new.append((dst, out))
                for (arr, i), out in new:  # after the wave's reads, as after its barrier
                    arr[i] = out
    return dict(onlz=onlz, prez=prez, onl2=onl2, fail=fail)


@pytest.mark.parametrize("chunk", [4, 32, 1])
@pytest.mark.parametrize("R", [16, 13])
@pytest.mark.parametrize("mode", MODES)
def test_staged_w2_equals_the_plain_version(circuits, mode, R, chunk):
    """pack_ztable's packed slots and each chunk's staged words and bits
    rows, emulated at the offsets W2 reads them (emulate_staged), give the
    plain version's onlz, prez, B2A onl2 rows and z64 fails: deep B2A with
    its z64 slots shared and spilled, a random mixed program spilled."""
    for name, capz in (("deep_b2a", 0), ("deep_b2a", 1), ("random4", 1)):
        _, cc = circuits(name)
        inp = executor_inputs(cc, mode, R, seed=5 * R + mode)
        prog = scan.circuit_program(cc, mode, CPU, R, capacityz=capz)
        assert (prog.n_spillz > 0) == (capz == 1)
        want = scan.ScanExecutor(cc, mode, R, CPU)(on(inp, CPU))
        states = gf2_states(prog, mode, inp, cc, R)
        packed = scan.pack_ztable(prog.ztable.numpy(), mode, chunk)
        got = emulate_staged(packed, prog.bits.numpy(), mode, inp, prog.n_sharedz,
                             prog.n_spillz, lambda w: states[w], cc, chunk)
        assert_z64_events(got, want, prog, cc, mode)


# -- proofs ---------------------------------------------------------------------


def seeds256(seed=42):
    """Rep seeds; 42 is reverie_tpu's tests/test_tpu_backend.py seeds256(),
    whose deep-scan tests hold TpuKKW to the NumPy golden's bytes on the
    same statements."""
    return np.random.RandomState(seed).randint(0, 256, (256, 16), dtype=np.uint8)


def tampered(proof: Proof, domain: str) -> Proof:
    """The proof with one flipped bit in the first online opening of
    `domain`: in its recons, or its corrs where it has no recons."""
    bad = copy.deepcopy(proof)
    o = getattr(bad, domain).online[0]
    field = "recons" if o.recons else "corrs"
    v = getattr(o, field)
    setattr(o, field, bytes([v[0] ^ 1]) + v[1:])
    return bad


def test_chain_proof_matches_tpu_and_golden():
    """The 150-MUL z64 chain (depth 153) on the wave route: the NumPy
    golden's bytes, which test_scan_executor_deep_z64_circuit of
    reverie_tpu's tests holds TpuKKW's scan executor to on this statement
    and seeds; it verifies, and a tampered z64 opening does not."""
    prog, wit2, witz = z64_chain(150)
    port = TorchKKW(prog, device=CPU)
    assert host.uses_waves(port.cc) and type(port._executor(0, 256)) is scan.ScanExecutor
    jprog = j_load(t_dumps(prog))
    proof = port.prove(wit2, witz, seeds=seeds256())
    assert proof.to_bytes() == golden_prove(jprog, wit2, witz,
                                            seeds=seeds256().reshape(32, 8, 16)).to_bytes()
    assert port.verify(proof) is True
    assert port.verify(tampered(proof, "z64")) is False


def test_deep_b2a_proof_matches_golden():
    """Deep B2A (mixed_b2a with a 200-MUL GF(2) chain) on the wave route:
    the NumPy golden's bytes, which test_scan_executor_deep_b2a_circuit of
    reverie_tpu's tests holds TpuKKW's scan executor to on this statement
    and seeds; it verifies, and tampered GF(2) and z64 openings do not."""
    prog, wit2, witz = deep_b2a(200)
    port = TorchKKW(prog, device=CPU)
    assert host.uses_waves(port.cc)
    proof = port.prove(wit2, witz, seeds=seeds256())
    want = golden_prove(j_load(t_dumps(prog)), wit2, witz, seeds=seeds256().reshape(32, 8, 16))
    assert proof.to_bytes() == want.to_bytes()
    assert port.verify_many([proof, tampered(proof, "gf2"), tampered(proof, "z64")]) == [
        True, False, False]


def test_golden_b2a_blob_on_the_waves(monkeypatch):
    """tests/golden/b2a_proof.bin (190 levels) reproduced on the wave route,
    and the levelized route's bytes with the threshold raised; it
    verifies."""
    prog = load_program((GOLDEN / "b2a_program.bin").read_bytes())
    seeds = np.frombuffer((GOLDEN / "b2a_seeds.bin").read_bytes(), np.uint8).reshape(256, 16)
    blob = (GOLDEN / "b2a_proof.bin").read_bytes()
    _, wit2, witz = deep_b2a(0)
    port = TorchKKW(prog, device=CPU)
    assert port.cc.depth == 190 and host.uses_waves(port.cc)
    assert port.prove(wit2, witz, seeds=seeds).to_bytes() == blob
    assert type(port._executor(0, 256)) is scan.ScanExecutor
    assert port.verify(Proof.from_bytes(blob)) is True
    monkeypatch.setattr(host, "SCAN_DEPTH_THRESHOLD", 190)
    levelized = TorchKKW(prog, device=CPU)
    assert levelized.prove(wit2, witz, seeds=seeds).to_bytes() == blob
    assert type(levelized._executor(0, 256)) is tex.Executor
    assert dumps_program(j_load(t_dumps(prog))) == t_dumps(prog)
