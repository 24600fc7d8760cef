"""The wave executor's slot allocator (reverie_tpu_torch.backend.scan
`allocate_slots`, `launch_plan`, `pack_table`), on the CPU: the live
values of the waves renumbered into slots that the wave kernel keeps in
shared memory, the longest-lived spilled past a capacity.  A slot is never
written in the wave of its previous value's last read; the slots equal the
live set; the plain version gives the same streams on the rewritten table
as on the SSA table, spilled or not.  Streams and fail are bytes and
booleans: the tolerance is 0."""

import hashlib

import numpy as np
import pytest
import torch

from reverie_tpu_torch import parity
from reverie_tpu_torch.backend import executor as tex, scan
from reverie_tpu_torch.circuit import sha256 as tsha
from reverie_tpu_torch.circuit.builders import (
    deep_b2a_circuit, z64_all_ops_circuit, z64_chain_circuit, z64_chains_circuit)
from reverie_tpu_torch.circuit.compile import (
    _NOP, B2A_CORR, B2A_OUT, G_ADD, G_ASSERT, G_INPUT, G_MUL, G_RANDOM, compile_program)

from test_torch_package import boundary_waves, random_waves, run_waves, wave_inputs
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
MODES = [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE]
_OP, _DST, _A, _B = (scan.SLOT_COLS.index(c) for c in ("op", "dst", "a", "b"))


@pytest.fixture(scope="module")
def sha256_table():
    cc = compile_program(tsha.sha256_preimage_statement(
        hashlib.sha256(parity.SHA256_MESSAGE).digest())[0])
    return cc, scan.wave_table(scan.waves(cc), tex.PROVER)


def slot_reads_and_writes(t: np.ndarray):
    """Per wave, the slots its gates read and the slots they write."""
    op = t[..., _OP]
    writes = (op != _NOP) & (op != G_ASSERT)
    reads_a, reads_b = np.isin(op, scan._READS_A), np.isin(op, scan._READS_B)
    for w in range(t.shape[0]):
        yield (set(t[w, reads_a[w], _A]) | set(t[w, reads_b[w], _B]),
               list(t[w, writes[w], _DST]))


def check_slots(ssa: np.ndarray, t: np.ndarray, n_shared: int, n_spill: int) -> None:
    """No wave reads a slot it writes, no two gates of a wave write one
    slot, and every read finds the value the SSA table reads there: the
    slot's last write is the operand's value."""
    holder = {0: 0}  # slot -> SSA value it holds
    op = ssa[..., _OP]
    writes = (op != _NOP) & (op != G_ASSERT)
    for w, (reads, wrote) in enumerate(slot_reads_and_writes(t)):
        assert not reads & set(wrote), f"wave {w} reads and writes a slot"
        assert len(set(wrote)) == len(wrote), f"wave {w} writes a slot twice"
        for col, kinds in ((_A, scan._READS_A), (_B, scan._READS_B)):
            sel = np.isin(op[w], kinds)
            for s, v in zip(t[w, sel, col], ssa[w, sel, col]):
                assert holder[int(s)] == int(v), f"wave {w}: slot {s} lost value {v}"
        for s, v in zip(t[w, writes[w], _DST], ssa[w, writes[w], _DST]):
            holder[int(s)] = int(v)
    assert t[..., _DST].max() <= n_shared + n_spill
    assert (t[..., _DST][~writes] == n_shared + n_spill).all()  # the trash row


def test_sha256_slots_equal_the_live_set(sha256_table):
    """SHA-256: 2,409 values live at once at most, plus value 0, and the
    linear scan takes exactly that many slots, all in shared memory under
    the launch plan (154,240 bytes of slots at 32 reps a block)."""
    cc, table = sha256_table
    assert scan.live_set(table) == 2410
    plans = [scan.launch_plan(2410, table, R) for R in (256, 40, 216, 16_384)]
    assert [(p.reps, p.chunk) for p in plans] == [(8, 32)] * 3 + [(32, 16)]
    plan = plans[-1]
    assert plan.capacity >= 2410 and plan.k == 1 and plan.threads_y == 32
    t, n_shared, n_spill = scan.allocate_slots(table, plan.capacity)
    assert (n_shared, n_spill) == (2410, 0)
    check_slots(table, t, n_shared, n_spill)
    assert 2 * n_shared * 32 == 154_240
    assert scan.prover_bytes(cc, 256) < (cc.m2 + cc.n_wit2 + 2 * cc.n_vals2) * 256


def test_sha256_forced_spill_keeps_every_value(sha256_table):
    """At a capacity of 1,000 slots the longest-lived values spill until
    the rest fit: the shared slots stay within it, and every spilled value
    outlives every shared one that was live beside it at the peak."""
    _, table = sha256_table
    t, n_shared, n_spill = scan.allocate_slots(table, 1000)
    assert n_shared <= 1000 and n_spill > 0
    check_slots(table, t, n_shared, n_spill)
    first, last = scan.live_intervals(table)
    vals = np.nonzero(first >= 0)[0]
    dst_ssa = table[..., _DST][(table[..., _OP] != _NOP) & (table[..., _OP] != G_ASSERT)]
    dst_slot = t[..., _DST][(table[..., _OP] != _NOP) & (table[..., _OP] != G_ASSERT)]
    spilled = np.zeros(first.shape, dtype=bool)
    spilled[dst_ssa[dst_slot >= n_shared]] = True
    span = last - first
    assert span[spilled].min() >= np.median(span[vals])


def test_two_block_sha256_live_set():
    """A two-block sha256_long_preimage_statement, its witness INPUTs at the
    front: 4,786 values live at once plus value 0.  At 32 reps a block they
    pass the shared memory and the longest-lived spill; the plan takes
    fewer reps a block, where they fit."""
    prog, _ = tsha.sha256_long_preimage_statement(hashlib.sha256(b"two blocks").digest(), 2)
    table = scan.wave_table(scan.waves(compile_program(prog)), tex.PROVER)
    n_live = scan.live_set(table)
    assert n_live == 4787
    plan = scan.launch_plan(n_live, table, 16_384)
    assert plan.reps < 32 and plan.capacity >= n_live
    cap = scan.launch_plan(n_live, table, 256, reps=32).capacity
    t, n_shared, n_spill = scan.allocate_slots(table, cap)
    assert n_spill > 0 and n_shared <= cap
    assert n_shared + n_spill >= n_live


@pytest.mark.parametrize("capacity", [0, 7, 1])
@pytest.mark.parametrize("mode", MODES)
def test_plain_version_equal_on_the_rewritten_table(mode, capacity):
    """Random wave tables (every gate kind, NOP waves, ASSERT_ZERO slots
    that fail in some reps): wave_gf2_ref on the slot table, all shared
    (capacity 0: the plan's), mostly spilled (7) and all spilled (1),
    equals it on the SSA table."""
    for seed, (n_waves, W, nop_wave) in enumerate([(40, 13, 7), (60, 40, 0), (30, 64, 29)]):
        table, sizes = random_waves(seed, n_waves, W, mode, nop_wave)
        live = scan.live_set(table)
        cap = capacity or scan.launch_plan(live, table, 37).capacity
        t, n_shared, n_spill = scan.allocate_slots(table, cap)
        check_slots(table, t, n_shared, n_spill)
        assert n_shared <= cap and (n_spill > 0) == (cap < live)
        if cap == 1:
            assert n_shared == 1
        inputs = wave_inputs(seed, mode, 37, sizes, CPU)
        want = run_waves(scan.wave_gf2_ref, torch.from_numpy(table), mode, inputs, sizes)
        got = scan.wave_gf2_ref(torch.from_numpy(t), mode, *inputs, n_shared + n_spill,
                                sizes["n_onl"], sizes["n_pre"])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        prog = scan.wave_program(table, mode, CPU, 37, capacity=capacity)
        via = scan.wave_run(prog, mode, *inputs, sizes["n_onl"], sizes["n_pre"])
        for g, w in zip(via, want):
            assert torch.equal(g, w)


def test_a_slot_freed_in_one_wave_is_taken_in_the_next():
    """The boundary of the race rule: a value last read in wave 1 gives its
    slot to a value written in wave 2, never to one written in wave 1."""
    table, sizes = boundary_waves()
    t, n_shared, n_spill = scan.allocate_slots(table, 16)
    check_slots(table, t, n_shared, n_spill)
    reads1, wrote1 = list(slot_reads_and_writes(t))[1]
    _, wrote2 = list(slot_reads_and_writes(t))[2]
    assert set(wrote2) & (reads1 - {0}), "wave 2 takes no slot freed in wave 1"
    assert not set(wrote1) & reads1
    inputs = wave_inputs(1, tex.PROVER, 8, sizes, CPU)
    want = run_waves(scan.wave_gf2_ref, torch.from_numpy(table), tex.PROVER, inputs, sizes)
    got = scan.wave_gf2_ref(torch.from_numpy(t), tex.PROVER, *inputs, n_shared + n_spill,
                            sizes["n_onl"], sizes["n_pre"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_allocator_rejects_bad_tables():
    table, _ = random_waves(2, 6, 8, tex.PROVER)
    with pytest.raises(ValueError, match="capacity"):
        scan.allocate_slots(table, 0)
    twice = table.copy()
    j = int(np.nonzero(np.isin(twice[1, :, _OP], (G_ADD, G_MUL, G_RANDOM)))[0][0])
    k = int(np.nonzero(np.isin(twice[2, :, _OP], (G_ADD, G_MUL, G_RANDOM)))[0][0])
    twice[2, k, _DST] = twice[1, j, _DST]
    with pytest.raises(ValueError, match="SSA"):
        scan.allocate_slots(twice, 8)


@pytest.mark.parametrize("mode", MODES)
def test_pack_table_round_trip(mode):
    """The packed slots decode to the table's fields; each slot's input
    fields (source << 30 | row) follow its word 5, in the order of
    scan._FIELDS, and chunk_off cuts them by chunks of waves."""
    table, _ = random_waves(3, 9, 13, mode, 2)
    t, _, _ = scan.allocate_slots(table, 64)
    slots, fields, chunk_off = scan.pack_table(t, mode, 4)
    assert slots.shape == (9, 13, scan.PACKED_WORDS) and slots.dtype == np.int32
    head = slots[..., 0].view(np.uint32)
    col = {c: scan.SLOT_COLS.index(c) for c in scan.SLOT_COLS}
    assert np.array_equal(head & 0x7F, t[..., col["op"]])
    assert np.array_equal((head >> 7) & 1, t[..., col["cbit"]])
    assert np.array_equal(head >> 8, t[..., col["dst"]])
    for i, name in enumerate(("a", "b", "onl", "pre"), start=1):
        assert np.array_equal(slots[..., i], t[..., col[name]])
    f = fields.view(np.uint32)
    n = 0
    for w in range(9):
        if w % 4 == 0:
            assert chunk_off[w // 4] == n
        for j in range(13):
            for i, (src, c) in enumerate(scan._FIELDS[mode].get(int(t[w, j, col["op"]]), ())):
                assert slots[w, j, 5] + i == n
                assert (f[n] >> 30, f[n] & 0x3FFFFFFF) == (src, t[w, j, c])
                n += 1
    assert n == len(fields) and list(chunk_off[-1:]) == [n] and len(chunk_off) == 4


@pytest.mark.parametrize("W, R, want", [(32, 256, (8, 1)), (32, 16_384, (32, 1)), (13, 40, (8, 1)),
                                        (64, 4096, (32, 1)), (256, 216, (8, 1)),
                                        (512, 0, (16, 2))])
def test_launch_plan(W, R, want):
    """Up to 8 x 132 lanes, 8 reps a block; past that the widest block
    whose shared memory holds the live set; the longest chunk that fits
    beside it; one slot a thread (4 reps each) where the block stays within
    1,024 threads; the plan's shared memory within a block's 227 KB.  The
    SHA-256 table's plans: test_sha256_slots_equal_the_live_set."""
    table, _ = random_waves(W, 40, W, tex.VERIFY_ONL)
    n_live = 100 if W < 512 else 2000
    plan = scan.launch_plan(n_live, table, R)
    assert (plan.reps, plan.k, plan.threads_y) == (*want, -(-W // want[1]))
    assert plan.reps // 4 * plan.threads_y <= scan.MAX_THREADS
    assert plan.fields == scan.chunk_fields(table, plan.chunk)
    assert plan.capacity >= n_live or plan.chunk == scan.CHUNKS[-1]
    longer = [c for c in scan.CHUNKS if c > plan.chunk]
    assert all(scan.slot_capacity(plan.reps, W, c, scan.chunk_fields(table, c)) < n_live
               for c in longer)
    smem = (scan.staged_bytes(plan.reps, W, plan.chunk, plan.fields)
            + 2 * plan.capacity * plan.reps)
    assert scan.SMEM_PER_BLOCK - 2 * plan.reps < smem <= scan.SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        scan.launch_plan(10, random_waves(1, 4, 1024, tex.PROVER)[0])
    with pytest.raises(ValueError):
        scan.launch_plan(10, table, reps=12)


def test_scan_executor_shares_one_allocation_across_roles(sha256_table):
    """The slots are allocated once per circuit and width, for every role
    (only the xin column differs), and kept on the circuit."""
    cc, _ = sha256_table
    progs = [scan.circuit_program(cc, mode, CPU, 256) for mode in MODES]
    for p in progs[1:]:
        for col in (_DST, _A, _B):
            assert torch.equal(p.table[..., col], progs[0].table[..., col])
    assert progs[0].n_shared == 2410 and progs[0].n_spill == 0
    assert scan.spill_rows(cc) == 0
    assert progs[0].smem_bytes <= scan.SMEM_PER_BLOCK


def test_circuit_waves_keeps_one_record_per_width(sha256_table):
    """A circuit keeps one CircuitWaves per wave width (the default's also
    under 0): its waves, one launch plan each side of R = 8 x SMS and one
    slot allocation per capacity, which executors and footprints share."""
    cc, table = sha256_table
    rec = scan.circuit_waves(cc)
    assert rec is scan.circuit_waves(cc, 32) is cc.wave_tables[0] is cc.wave_tables[32]
    assert rec.waves is scan.waves(cc) and np.array_equal(rec.table, table)
    assert rec.n_live == 2410
    assert rec.plan(256) is rec.plan(40) and rec.plan(16_384) is rec.plan(8 * scan.SMS + 1)
    assert rec.plan(256) != rec.plan(16_384) and rec.plan(256, reps=32).reps == 32
    progs = [scan.circuit_program(cc, tex.PROVER, CPU, R) for R in (256, 16_384)]
    for p, R in zip(progs, (256, 16_384)):
        assert p.plan == rec.plan(R) and p.n_shared == rec.allocation(p.plan.capacity).n_shared
    assert {(p.plan.capacity, 0, scan.NO_CARRY) for p in progs} <= set(rec.slots)
    assert scan.table_bytes(cc, 256) == 4 * (rec.waves.op.size * scan.PACKED_WORDS
                                             + rec.n_fields + -(-len(table) // 32) + 1)


def _par(v):
    return np.array([bin(int(b)).count("1") & 1 for b in np.ravel(v)], dtype=np.uint32).reshape(
        np.shape(v))


def run_packed(slots, fields, chunk_off, mode, tape, xin, co2, re2, n_shared, n_spill,
               n_onl, n_pre):
    """The wave kernel's decode and apply (csrc/scan_gf2.cu) on a packed
    program, in numpy over the reps: each slot's words as the kernel reads
    them, its input bytes through `fields`."""
    R = tape.shape[1]
    vals = np.zeros((n_shared + n_spill, R), dtype=np.uint32)
    onl = np.zeros((max(n_onl, 1), R), dtype=np.uint8)
    pre = np.zeros((max(n_pre, 1), R), dtype=np.uint8)
    fail = np.zeros(R, dtype=bool)
    src = {0: tape, 1: xin, 2: re2, 3: co2}
    f = fields.view(np.uint32)
    exp = lambda c: (0 - c.astype(np.uint32)) & 0xFF  # noqa: E731
    for wave in slots.view(np.uint32):
        writes = []
        for w in wave:
            kind, sub, k = w[7] & 3, (w[7] >> 2) & 3, np.uint32(w[7] >> 8)
            ma, mb, dst = w[6] & 0xFFFF, w[6] >> 16, w[0] >> 8
            byte = lambda i: src[int(f[w[5] + i] >> 30)][int(f[w[5] + i] & 0x3FFFFFFF)].astype(
                np.uint32)  # noqa: E731
            kk, mma, mmb = np.full(R, k, dtype=np.uint32), ma, mb
            if kind == 2:
                b0, b1 = byte(0), byte(1)
                kk, mma = b1, b0 ^ b1
                mmb = byte(3) if mode == tex.VERIFY_ONL else _par(b0)
                if mode == tex.VERIFY_ONL:
                    mma = mma ^ byte(2)
            elif sub == 1:
                kk = kk ^ byte(0)
            elif sub == 2:
                b0 = byte(0)
                in_c = ((byte(1) ^ _par(b0)) & 0xFF if mode == tex.PROVER else
                        byte(1) if mode == tex.VERIFY_ONL else np.zeros(R, dtype=np.uint32))
                kk = b0 | in_c << 8
                if mode != tex.VERIFY_PRE:
                    onl[w[3]] = exp(in_c)
            if kind == 0:
                continue
            xa, xb = vals[w[1]], vals[w[2]]
            if kind == 2:
                am, ac, bm, bc = xa & 0xFF, xa >> 8, xb & 0xFF, xb >> 8
                sh = ((bm & exp(ac)) ^ (am & exp(bc)) ^ mma) & 0xFF
                delta = mmb if mode == tex.VERIFY_ONL else (_par(am) & _par(bm)) ^ mmb
                recon = _par(sh) ^ delta if mode != tex.VERIFY_PRE else 0
                writes.append((dst, kk | ((recon ^ (ac & bc)) & 0xFF) << 8))
                if mode != tex.VERIFY_PRE:
                    onl[w[3]] = sh
                pre[w[4]] = exp(delta)
            elif kind == 3:
                sa = (xa ^ kk) & 0xFF
                fail |= (_par(sa) ^ (xa >> 8)) != 0
                onl[w[3]] = sa
            else:
                writes.append((dst, (xa & mma) ^ (xb & mmb) ^ kk))
        for dst, v in writes:  # after the wave's reads, as after its barrier
            vals[dst] = v
    return onl[:max(n_onl, 1)], pre[:max(n_pre, 1)], fail


@pytest.mark.parametrize("mode", MODES)
def test_packed_program_decodes_to_the_plain_version(mode):
    """pack_table's words, decoded and applied as the wave kernel does
    (run_packed), give the plain version's streams and fail, all in shared
    memory and mostly spilled, and on boundary_waves."""
    cases = [random_waves(5, 30, 13, mode, 4), random_waves(6, 20, 40, mode, 0),
             boundary_waves()]
    for cap, (table, sizes) in zip((0, 3, 0), cases):
        inputs = wave_inputs(7, mode, 24, sizes, CPU)
        want = run_waves(scan.wave_gf2_ref, torch.from_numpy(table), mode, inputs, sizes)
        prog = scan.wave_program(table, mode, CPU, 24, capacity=cap)
        packed = scan.pack_table(prog.table.numpy(), mode, prog.plan.chunk)
        npin = [None if x is None else x.numpy() for x in inputs]
        got = run_packed(*packed, mode, *npin, prog.n_shared, prog.n_spill, sizes["n_onl"],
                         sizes["n_pre"])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


# -- W2's staged chunks: the z64 words each chunk reads, the plan, the packing


DEEP = {"chain": lambda: z64_chain_circuit(5_000), "all_ops": lambda: z64_all_ops_circuit(200),
        "deep_b2a": lambda: deep_b2a_circuit(200)}


@pytest.fixture(scope="module")
def deep_circuits():
    """reverie_tpu's deep-scan statements, compiled once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = compile_program(DEEP[name]()[0])
        return cache[name]
    return get


@pytest.mark.parametrize("R", [256, 40, 216, 16_384])
@pytest.mark.parametrize("name", list(DEEP))
def test_w2_plans_of_the_deep_statements(deep_circuits, name, R):
    """W2's launch plan of each deep statement in each role at R: the
    block's shared memory (WaveProgram.smem_bytes, the sum of staged_bytes
    and the shared slots of both domains) within SMEM_PER_BLOCK with every
    live value shared; the chunk's staged z64 words and bits rows those of
    chunk_zwords and chunk_zbits in the role; one GF(2) slot a thread in
    whole warps of at most MAX_THREADS_Z64; where the blocks fit the card at
    once, 8 reps a block, 8 lanes a (rep, z64 slot) and the longest chunk
    that fits; past that, one lane.  At R = 16,384 the chain's online
    verify stages a shorter chunk than at 256 (25 words a MUL at 32 reps a
    block: 32 waves would take 204,800 bytes; the chunk whose blocks fit
    the card's shared memory in the fewest rounds) and proves at 32 reps a
    block."""
    cc = deep_circuits(name)
    zt = scan.circuit_waves(cc).ztables[0]
    for mode in MODES:
        prog = scan.circuit_program(cc, mode, CPU, R)
        p = prog.plan
        assert prog.smem_bytes == (
            scan.staged_bytes(p.reps, prog.table.shape[1], p.chunk, p.fields, p.Wz, p.zwords,
                              p.zbits)
            + 2 * prog.n_shared * p.reps + scan.ZBYTES * prog.n_sharedz * p.reps)
        assert prog.smem_bytes <= scan.SMEM_PER_BLOCK
        assert prog.n_spill == prog.n_spillz == 0
        assert (p.Wz, p.zwords, p.zbits) == (zt.shape[1], scan.chunk_zwords(zt, mode, p.chunk),
                                             scan.chunk_zbits(zt, p.chunk))
        threads = p.reps // 4 * p.threads_y
        assert p.k == 1 and threads <= scan.MAX_THREADS_Z64 and threads % 32 == 0
        if R <= 8 * scan.SMS:  # 8 reps, 8 lanes, the longest chunk that fits
            assert (p.reps, p.zlanes) == (8, 8)
            longer = [c for c in scan.CHUNKS if c > p.chunk]
            assert all(scan.staged_bytes(8, prog.table.shape[1], c, scan.chunk_fields(
                prog.table.numpy(), c), p.Wz, scan.chunk_zwords(zt, mode, c),
                scan.chunk_zbits(zt, c)) + prog.smem_bytes - scan.staged_bytes(
                8, prog.table.shape[1], p.chunk, p.fields, p.Wz, p.zwords, p.zbits)
                > scan.SMEM_PER_BLOCK for c in longer)
        else:
            assert p.zlanes == 1
    if name == "chain":
        online = [scan.circuit_program(cc, tex.VERIFY_ONL, CPU, r).plan for r in (256, R)]
        assert online[1].chunk < online[0].chunk if R == 16_384 else online[1] == online[0]
        if R == 16_384:
            prove = scan.circuit_program(cc, tex.PROVER, CPU, R).plan
            assert (prove.reps, prove.zlanes) == (32, 1)


@pytest.mark.parametrize("R", [256, 40, 216, 16_384])
def test_w2_plans_of_the_widest_z64_waves(R):
    """64 z64 chains side by side: build_waves' widest z64 waves (Wz = 64,
    64 MULs a wave), whose staged words fit a block only one wave a chunk
    (online: 64 x 25 words x 8 reps x 8 bytes = 102,400 bytes a wave; the
    shortest of CHUNKS, 4, would take 409,600).  In every role the plan
    stages one wave a chunk within SMEM_PER_BLOCK; the online verifier's
    z64 values, with its staged words, pass the block and partly spill."""
    cc = compile_program(z64_chains_circuit(64, 150)[0])
    rec = scan.circuit_waves(cc)
    zt = rec.ztables[0]
    assert rec.Wz == 64
    for mode in MODES:
        prog = scan.circuit_program(cc, mode, CPU, R)
        p = prog.plan
        W = prog.table.shape[1]
        assert (p.Wz, p.reps, p.chunk) == (64, 8, 1)
        assert p.zwords == scan.chunk_zwords(zt, mode, 1) == 64 * {0: 16, 1: 25, 2: 16}[mode]
        assert p.zlanes == (8 if R <= 8 * scan.SMS else 1)
        assert prog.smem_bytes <= scan.SMEM_PER_BLOCK
        assert all(scan.staged_bytes(8, W, c, scan.chunk_fields(prog.table.numpy(), c), 64,
                                     scan.chunk_zwords(zt, mode, c), scan.chunk_zbits(zt, c))
                   > scan.SMEM_PER_BLOCK for c in scan.CHUNKS)
        assert (prog.n_spillz > 0) == (mode == tex.VERIFY_ONL) and prog.n_spill == 0


def hand_ztable(kinds):
    """A z64 table (ZSLOT_COLS) of waves of the given kinds, NOP-padded to
    the widest: slot s of wave w takes tape rows 10 w + s and 50 + s, xin,
    rec, corr and brec rows 3 s, 4 s, 5 s and 64 s, bits rows in order."""
    Wz = max(map(len, kinds))
    t = np.zeros((len(kinds), Wz, len(scan.ZSLOT_COLS)), dtype=np.int32)
    col = {c: scan.ZSLOT_COLS.index(c) for c in scan.ZSLOT_COLS}
    t[..., col["op"]] = _NOP
    b2a = 0
    for w, ops in enumerate(kinds):
        for s, op in enumerate(ops):
            t[w, s, col["op"]], t[w, s, col["dst"]] = op, 10 * w + s + 1
            t[w, s, col["t0"]], t[w, s, col["t1"]] = 10 * w + s, 50 + s
            t[w, s, col["xin"]], t[w, s, col["rec"]] = 3 * s, 4 * s
            t[w, s, col["corr"]], t[w, s, col["brec"]] = 5 * s, 64 * s
            t[w, s, col["onl"]], t[w, s, col["pre"]], t[w, s, col["bonl"]] = 7 * w, 8 * w, 9 * w
            t[w, s, col["clo"]], t[w, s, col["chi"]] = -w, s
            if op in (B2A_CORR, B2A_OUT):
                t[w, s, col["bits"]] = b2a
                b2a += 1
    return t


#: the words W2 stages for a slot of each kind, by role, counted by hand:
#: a MUL's t0 and t1 (8 each), the online verifier's rez (8) and coz; an
#: INPUT's t0 and its witness or input word (none to preprocess); a B2A
#: correction's t0 (and coz online); a B2A_OUT's 64 re2 bytes (8 words)
#: and an ASSERT_ZERO's rez online
HAND_WORDS = {tex.PROVER: {G_MUL: 16, G_INPUT: 9, G_RANDOM: 8, B2A_CORR: 8},
              tex.VERIFY_ONL: {G_MUL: 25, G_INPUT: 9, G_RANDOM: 8, B2A_CORR: 9, B2A_OUT: 8,
                               G_ASSERT: 8},
              tex.VERIFY_PRE: {G_MUL: 16, G_INPUT: 8, G_RANDOM: 8, B2A_CORR: 8}}
HAND_WAVES = [[G_MUL, _NOP], [G_INPUT, G_ASSERT], [B2A_OUT, G_RANDOM], [G_ADD, B2A_CORR],
              [G_MUL, G_MUL]]


@pytest.mark.parametrize("mode", MODES)
def test_chunk_zwords_counts_by_hand(mode):
    """chunk_zwords: the most staged words of any chunk of waves, from wave
    0, against HAND_WORDS summed by hand; chunk_zbits: the B2A slots."""
    t = hand_ztable(HAND_WAVES)
    per = [sum(HAND_WORDS[mode].get(op, 0) for op in ops) for ops in HAND_WAVES]
    assert per == {tex.PROVER: [16, 9, 8, 8, 32], tex.VERIFY_ONL: [25, 17, 16, 9, 50],
                   tex.VERIFY_PRE: [16, 8, 8, 8, 32]}[mode]
    for chunk, want in ((1, max(per)), (2, max(per[0] + per[1], per[2] + per[3], per[4])),
                        (4, max(sum(per[:4]), per[4])), (8, sum(per))):
        assert scan.chunk_zwords(t, mode, chunk) == want, chunk
    assert [scan.chunk_zbits(t, c) for c in (1, 2, 4, 8)] == [1, 2, 2, 2]


@pytest.mark.parametrize("mode", MODES)
def test_pack_ztable_round_trip(mode):
    """pack_ztable's words decode to the table's columns; each slot's staged
    words, from its chunk's first field on, are its rows of each source in
    _ZFIELDS order (a tape row t as t * 8 + p, a rez row rec * 8 + p, a
    B2A_OUT's re2 rows brec + 8 m); zchunk_off cuts the fields and the bits
    rows by chunks of waves."""
    t = hand_ztable(HAND_WAVES)
    chunk = 2
    zslots, zfields, zoff = scan.pack_ztable(t, mode, chunk)
    assert zslots.shape == t.shape[:2] + (scan.ZPACKED_WORDS,) and zslots.dtype == np.int32
    col = {c: scan.ZSLOT_COLS.index(c) for c in scan.ZSLOT_COLS}
    w32 = zslots.view(np.uint32).astype(np.int64)
    f = zfields.view(np.uint32).astype(np.int64)
    assert zoff.shape == (3 + 1, 2) and list(zoff[-1]) == [len(f), 2]
    assert list(zoff[:, 1]) == [0, 0, 2, 2]
    n = 0
    for w, ops in enumerate(HAND_WAVES):
        c = w // chunk
        if w % chunk == 0:
            assert zoff[c, 0] == n
        for s in range(t.shape[1]):
            op = int(t[w, s, col["op"]])
            assert (w32[w, s, 0] & 0xFF, w32[w, s, 0] >> 8) == (op, t[w, s, col["dst"]])
            assert (w32[w, s, 1], w32[w, s, 2]) == (t[w, s, col["a"]], t[w, s, col["b"]])
            if op == _NOP:
                continue
            assert w32[w, s, 4] == t[w, s, col["bonl" if op == B2A_OUT else "onl"]]
            assert w32[w, s, 5] == t[w, s, col["pre"]]
            assert (zslots[w, s, 6], zslots[w, s, 7]) == (t[w, s, col["clo"]],
                                                         t[w, s, col["chi"]])
            if op in (B2A_CORR, B2A_OUT):
                assert zoff[c, 1] + (w32[w, s, 3] >> 16) == t[w, s, col["bits"]]
            t0, t1 = t[w, s, col["t0"]], t[w, s, col["t1"]]
            rec, corr, xin = t[w, s, col["rec"]], t[w, s, col["corr"]], t[w, s, col["xin"]]
            tape = lambda r: [(0, 8 * r + p) for p in range(8)]  # noqa: E731
            want = {G_MUL: tape(t0) + tape(t1) + ([(3, 8 * rec + p) for p in range(8)]
                                                  + [(2, corr)] if mode == tex.VERIFY_ONL
                                                  else []),
                    G_INPUT: tape(t0) + ([(1, xin)] if mode != tex.VERIFY_PRE else []),
                    G_RANDOM: tape(t0),
                    B2A_CORR: tape(t0) + ([(2, corr)] if mode == tex.VERIFY_ONL else []),
                    B2A_OUT: ([(4, t[w, s, col["brec"]] + 8 * m) for m in range(8)]
                              if mode == tex.VERIFY_ONL else []),
                    G_ASSERT: ([(3, 8 * rec + p) for p in range(8)]
                               if mode == tex.VERIFY_ONL else [])}.get(op, [])
            first = zoff[c, 0] + (w32[w, s, 3] & 0xFFFF) if want else n
            assert first == n
            assert [(x >> 29, x & 0x1FFFFFFF) for x in f[first : first + len(want)]] == want
            n += len(want)
    assert n == len(f)
