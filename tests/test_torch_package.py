"""Package-level checks of reverie_tpu_torch: it imports without jax and
without reverie_tpu, its CPU wrappers take the plain versions without
launching a kernel, the CUDA path never falls back to the CPU, and (on a
CUDA card only) each kernel equals its plain version byte for byte."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from reverie_tpu_torch import _build, device as tdevice
from reverie_tpu_torch.backend import executor as tex, scan
from reverie_tpu_torch.circuit import CombineOp, Gate, Op
from reverie_tpu_torch.circuit.builders import deep_b2a_circuit as deep_b2a
from reverie_tpu_torch.circuit.builders import z64_all_ops_circuit as z64_all_ops
from reverie_tpu_torch.circuit.builders import z64_chain_circuit as z64_chain
from reverie_tpu_torch.circuit.builders import z64_chains_circuit as z64_chains
from reverie_tpu_torch.circuit.compile import _NOP, G_ASSERT, compile_program, compile_segments
from reverie_tpu_torch.crypto.kernels import aes_planes, aes_tape, aes_tape_z64, blake3 as b3
from reverie_tpu_torch.crypto.kernels import blake3_tail
from reverie_tpu_torch.tools import r4_bwroof, r4_extract_probe, r5_u8emit
from blake3_cases import (CHUNK_CASES, HASHER_CASES, LEG_LENGTHS, TAIL_LENGTHS, TAIL_WIDTHS,
                          absorb_blocks)
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import sys
sys.modules["jax"] = None
import reverie_tpu_torch
import reverie_tpu_torch._build, reverie_tpu_torch.device, reverie_tpu_torch.parity
import reverie_tpu_torch.backend.executor, reverie_tpu_torch.backend.host
import reverie_tpu_torch.backend.scan, reverie_tpu_torch.backend.streaming
import reverie_tpu_torch.circuit.sha256
import reverie_tpu_torch.crypto.kernels.aes_tape, reverie_tpu_torch.crypto.kernels.blake3
import reverie_tpu_torch.crypto.kernels.blake3_tail
import reverie_tpu_torch.crypto.kernels.aes_tape_z64, reverie_tpu_torch.crypto.kernels.aes_planes
import reverie_tpu_torch.tools.r2_measure, reverie_tpu_torch.tools.r4_bwroof
import reverie_tpu_torch.tools.r5_u8emit, reverie_tpu_torch.tools.r4_extract_probe
import reverie_tpu_torch.tools.wave_times, reverie_tpu_torch.tools.stream_peak
import reverie_tpu_torch.tools.tail_times, reverie_tpu_torch.tools.tail_probe
import reverie_tpu_torch.tools.k3_times
import reverie_tpu_torch.parallel.mesh, reverie_tpu_torch.parallel.distributed
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "reverie_tpu") for m in sys.modules if sys.modules[m] is not None)
print("no-jax import ok")
"""


def _run(code_or_args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_imports_without_jax():
    res = _run(["-c", _NO_JAX])
    assert res.returncode == 0, res.stderr
    assert "no-jax import ok" in res.stdout


def test_cpu_wrappers_take_plain_path():
    counts = (aes_tape.LAUNCHES, aes_tape_z64.LAUNCHES, b3.LAUNCHES)
    keys = np.random.RandomState(0).randint(0, 256, (4, 8, 16), dtype=np.uint8)
    rk = aes_tape.round_keys(keys, torch.device("cpu"))
    tape = aes_tape.aes_ctr_tape_gf2(rk, 200)
    assert tape.device.type == "cpu" and tape.shape == (200, 4)
    tapez = aes_tape_z64.aes_ctr_tape_z64(rk, 9)
    assert tapez.device.type == "cpu" and tapez.dtype == torch.int64
    assert tapez.shape == (9, 8, 4)
    buf = torch.zeros((2048, 4), dtype=torch.uint8)
    cvs = b3.chunk_cvs(buf, 2)
    assert cvs.dtype == torch.int32 and cvs.shape == (8, 2, 4)
    assert (aes_tape.LAUNCHES, aes_tape_z64.LAUNCHES, b3.LAUNCHES) == counts


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tdevice.default_device()


def test_ptxas_summary_reads_each_kernel():
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16kernAEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_16kernAEv",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 420 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z5kernBv' for 'sm_90a'",
        "ptxas info    : Used 30 registers, used 1 barriers, 5120 bytes smem, 400 bytes cmem[0]",
    ])
    assert _build.ptxas_summary(log) == [
        {"kernel": "_ZN12_GLOBAL__N_16kernAEv", "registers": 80, "spill_stores": 8,
         "spill_loads": 4, "smem_static": 0},
        {"kernel": "_Z5kernBv", "registers": 30, "spill_stores": 0, "spill_loads": 0,
         "smem_static": 5120}]


def lookup_wavefronts(copies: int, trials: int = 20_000, seed: int = 0) -> float:
    """Mean shared-memory wavefronts of one warp lookup into a 256-word
    table held `copies` times (entry x of copy c at word x * copies + c,
    lane l reading copy l % copies), for uniform random byte indices: the
    most distinct words any of the 32 banks is asked for (equal words are
    one broadcast).  A model of the T-table AES kernels' lookups, not a
    measurement."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 256, (trials, 32)) * copies + np.arange(32) % copies
    per_bank = np.zeros((trials, 32), dtype=np.int64)
    for t, row in enumerate(words):
        np.add.at(per_bank[t], np.unique(row) % 32, 1)
    return float(per_bank.max(axis=1).mean())


def test_lookup_wavefronts_model():
    # one table: ~3.16 wavefronts per warp lookup; a copy per bank: 1
    assert 3.1 < lookup_wavefronts(1) < 3.2
    assert lookup_wavefronts(16) == pytest.approx(2.0, abs=1e-3)
    assert lookup_wavefronts(32) == 1.0


def warp_transpose32(x: np.ndarray) -> np.ndarray:
    """csrc/aes_core.cuh:warp_transpose32 on the uint32 words of 32 lanes,
    stage by stage (the shuffle of lane l reads lane l ^ j)."""
    x = x.astype(np.uint32)
    lane = np.arange(32)
    for j, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                 (1, 0x55555555)):
        m = np.uint32(m)
        y = x[lane ^ j]
        x = np.where(lane & j, (x & ~m) | ((y >> j) & m), (x & m) | ((y << j) & ~m))
    return x


def column_words(ks: np.ndarray) -> np.ndarray:
    """(..., 16) u8 keystream blocks -> (..., 4) big-endian column words."""
    c = ks.reshape(*ks.shape[:-1], 4, 4).astype(np.uint32)
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]


#: csrc/aes_planes.cu: after the transpose, lane l of word q holds this plane
LANE_PLANE = np.array([(3 - (l >> 3)) * 8 + (l & 7) for l in range(32)])


def stage_at(plane, w):
    """csrc/aes_planes.cu:stage_at (16 plane words a work item)."""
    return plane * 16 + (w ^ ((plane >> 1) & 15))


@pytest.mark.parametrize("seed", range(4))
def test_planes_bitslice_model(seed):
    # lane j runs key 32w + j; its keystream block's 4 column words go
    # through the warp transpose
    ks = np.random.RandomState(seed).randint(0, 256, (32, 16), dtype=np.uint8)
    words = column_words(ks)
    lane = np.arange(32)
    got = np.full(128, -1, np.int64)
    for q in range(4):
        t = warp_transpose32(words[:, q])
        # the transpose: bit m of lane l's word is bit l of lane m's word
        assert np.array_equal((t[:, None] >> lane) & 1, ((words[:, q][None, :] >> lane[:, None]) & 1))
        got[32 * q + LANE_PLANE] = t
    # the ballot definition: bit j of plane by*8 + bit is bit `bit` of byte
    # by of lane j's keystream
    bits = ((ks[:, :, None] >> np.arange(8)) & 1).reshape(32, 128).astype(np.int64)
    assert np.array_equal(got, (bits << lane[:, None]).sum(0))


def test_planes_stage_banks():
    # a warp's write (lane l: plane 32q + LANE_PLANE[l], its warp's w) and a
    # warp's read (thread t: plane 32 * pass + t // 16, w = t % 16) each hit
    # the 32 banks once, and every (plane, w) has its own word
    for q in range(4):
        for w in range(16):
            assert len(set(stage_at(32 * q + LANE_PLANE, w) % 32)) == 32
    t = np.arange(512)
    for p in range(4):
        addr = stage_at(32 * p + t // 16, t % 16).reshape(16, 32)
        assert all(len(set(row % 32)) == 32 for row in addr)
    planes, w = np.meshgrid(np.arange(128), np.arange(16))
    assert sorted(stage_at(planes, w).ravel()) == list(range(2048))


def test_planes_kernel_model_matches_plain():
    # the kernel's data path (transpose, stage, store) in numpy, on the plain
    # version's AES, equals the plain version: K = 64 keys, B = 3
    rk = aes_tape.round_keys(np.random.RandomState(5).randint(0, 256, (8, 8, 16), dtype=np.uint8),
                             torch.device("cpu"))
    B, Kw = 3, 2
    ks = aes_tape.aes_encrypt_ref(rk, aes_tape._counter_blocks(0, B, rk.device)).numpy()
    out = np.zeros((128, B, Kw), np.uint32)
    for b in range(B):  # one counter block's 2,048 staged words
        stage = np.zeros(2048, np.uint32)
        for w in range(Kw):
            words = column_words(ks[32 * w: 32 * w + 32, b])
            for q in range(4):
                stage[stage_at(32 * q + LANE_PLANE, w)] = warp_transpose32(words[:, q])
        for w in range(Kw):
            out[:, b, w] = stage[stage_at(np.arange(128), w)]
    ref = aes_planes.aes_ctr_planes_ref(rk, B).numpy().view(np.uint32).reshape(128, B, Kw)
    assert np.array_equal(out, ref)


#: opcodes of a random wave slot (circuit/compile.py G_*), NOP (127) apart
_WAVE_KINDS = (0, 1, 2, 3, 4, 5, 7, 8)


def random_waves(seed: int, n_waves: int, W: int, mode: int, nop_wave: int = -1):
    """A random pure-GF(2) wave table in scan.wave_table's layout, as
    build_waves would pack it: every operand made in an earlier wave (or
    value 0), fresh dst values, distinct event rows, unused rows at the
    trash rows, NOP slots mixed in (every slot of wave `nop_wave`), and
    ASSERT_ZERO slots in the middle wave and at the end.  -> (table, sizes) where sizes are the rows of the
    arena, the streams and the inputs."""
    rng = np.random.RandomState(seed)
    m2, n_x, n_rec, n_corr = 50, 6, 30, 20
    avail, masked, n_vals, n_onl, n_pre = [0], [], 1, 0, 0
    slots = []
    asserts = {(n_waves // 2, 0), (n_waves - 1, W - 1)}
    for w in range(n_waves):
        made, made_masked = [], []
        for j in range(W):
            if w == nop_wave or ((w, j) not in asserts and rng.rand() < 0.2):
                slots.append([_NOP, -1, 0, 0, 0, 0, 0, 0, 0, -2, -3, 0])
                continue
            op = G_ASSERT if (w, j) in asserts else int(rng.choice(_WAVE_KINDS))
            a, b = (int(v) for v in rng.choice(avail, 2))
            if op == G_ASSERT and masked:  # a value with a random mask: it
                a = int(rng.choice(masked))  # fails in about half the reps
            row = [op, -1, a, b, int(rng.randint(m2)), int(rng.randint(m2)),
                   int(rng.randint(n_x)), int(rng.randint(n_rec)), int(rng.randint(n_corr)),
                   -2, -3, int(rng.randint(2))]
            if op != G_ASSERT:
                row[1] = n_vals
                made.append(n_vals)
                if op in (0, 5, 7):  # INPUT, MUL, RANDOM
                    made_masked.append(n_vals)
                n_vals += 1
            if op in (0, 5, G_ASSERT):  # INPUT, MUL, ASSERT_ZERO: an onl event
                row[9], n_onl = n_onl, n_onl + 1
            if op == 5:  # MUL: a pre event
                row[10], n_pre = n_pre, n_pre + 1
            slots.append(row)
        avail += made
        masked += made_masked
    table = np.asarray(slots, dtype=np.int64).reshape(n_waves, W, len(scan.SLOT_COLS))
    table[..., 1][table[..., 1] == -1] = n_vals  # the trash rows of build_waves
    table[..., 9][table[..., 9] == -2] = n_onl
    table[..., 10][table[..., 10] == -3] = n_pre
    if mode == tex.VERIFY_PRE:
        table[..., 6] = 0
    sizes = dict(n_vals=n_vals, n_onl=n_onl, n_pre=n_pre, m2=m2, n_x=n_x, n_rec=n_rec,
                 n_corr=n_corr)
    return table.astype(np.int32), sizes


def boundary_waves():
    """A wave table whose values 1 and 2 are last read in wave 1 and whose
    wave 2 writes two new values (6 and 7), so that a slot freed in wave 1
    is taken in wave 2, then a MUL and an ASSERT_ZERO of it (scan.py's
    race rule at its boundary).  -> (table, sizes) as random_waves."""
    n_vals, n_onl, n_pre = 10, 4, 2
    nop = [_NOP, n_vals, 0, 0, 0, 0, 0, 0, 0, n_onl, n_pre, 0]
    waves = [
        [[7, 1, 0, 0, 1, 0, 0, 0, 0, n_onl, n_pre, 0],  # v1 = RANDOM
         [7, 2, 0, 0, 2, 0, 0, 0, 0, n_onl, n_pre, 0],  # v2 = RANDOM
         [0, 3, 0, 0, 3, 0, 0, 0, 0, 0, n_pre, 0]],  # v3 = INPUT (onl 0)
        [[1, 4, 1, 2, 0, 0, 0, 0, 0, n_onl, n_pre, 0],  # v4 = v1 + v2
         [5, 5, 3, 1, 4, 5, 0, 1, 0, 1, 0, 0],  # v5 = v3 * v1 (onl 1, pre 0)
         nop],
        [[7, 6, 0, 0, 6, 0, 0, 0, 0, n_onl, n_pre, 0],  # v6 = RANDOM
         [1, 7, 4, 5, 0, 0, 0, 0, 0, n_onl, n_pre, 0],  # v7 = v4 + v5
         [2, 8, 3, 0, 0, 0, 0, 0, 0, n_onl, n_pre, 1]],  # v8 = v3 + 1
        [[5, 9, 6, 7, 7, 8, 0, 2, 1, 2, 1, 0],  # v9 = v6 * v7, read by none
         [G_ASSERT, n_vals, 8, 0, 0, 0, 0, 3, 0, 3, n_pre, 0],  # ASSERT_ZERO v8
         nop],
    ]
    table = np.asarray(waves, dtype=np.int32)
    sizes = dict(n_vals=n_vals, n_onl=n_onl, n_pre=n_pre, m2=10, n_x=1, n_rec=4, n_corr=2)
    return table, sizes


def wave_inputs(seed: int, mode: int, R: int, sizes: dict, device):
    """The kernel's inputs at R lanes: a random tape, and random 0/1 witness
    bits (PROVER) or 0/1 input and correction records and recon bytes at
    each rep's omitted player's bit (VERIFY_ONL)."""
    rng = np.random.RandomState(seed)

    def rows(n, high=2):
        return torch.from_numpy(rng.randint(0, high, (n, R)).astype(np.uint8)).to(device)

    tape = rows(sizes["m2"], 256)
    xin = co2 = re2 = None
    if mode == tex.PROVER:
        xin = rows(sizes["n_x"])
    elif mode == tex.VERIFY_ONL:
        xin, co2 = rows(sizes["n_x"]), rows(sizes["n_corr"])
        omit = rng.randint(0, 8, R)
        re2 = torch.from_numpy((rng.randint(0, 2, (sizes["n_rec"], R)) << (7 - omit)).astype(
            np.uint8)).to(device)
    return tape, xin, co2, re2


def run_waves(fn, table, mode, inputs, sizes):
    return fn(table, mode, *inputs, sizes["n_vals"], sizes["n_onl"], sizes["n_pre"])


def run_program(table, mode, inputs, sizes, **plan):
    """The SSA `table` (numpy) through the slot allocator at the tape's
    lanes on its device (scan.wave_program; `capacity`, `reps` as there)
    and scan.wave_run -> (onl2, pre2, fail)."""
    tape = inputs[0]
    prog = scan.wave_program(table, mode, tape.device, tape.shape[1], **plan)
    return scan.wave_run(prog, mode, *inputs, sizes["n_onl"], sizes["n_pre"])[:3]


@pytest.mark.parametrize("mode", [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE])
def test_random_waves_fail_some_reps_on_cpu(mode):
    """The random tables of the wave-kernel tests, through the wrapper on
    the CPU (the plain version, no launch): their ASSERT_ZERO slots fail in
    some reps and pass in others, and every stream row is an event."""
    table, sizes = random_waves(4, 30, 40, mode, nop_wave=3)
    n0 = scan.LAUNCHES
    onl, pre, fail = run_program(table, mode,
                                 wave_inputs(4, mode, 256, sizes, torch.device("cpu")), sizes)
    assert scan.LAUNCHES == n0
    assert onl.shape == (sizes["n_onl"], 256) and pre.shape == (sizes["n_pre"], 256)
    if mode == tex.VERIFY_PRE:
        assert not bool(fail.any()) and not bool(onl.any())
    else:
        assert 0 < int(fail.sum()) < 256
    assert bool((pre == 0xFF).any()) and bool(((pre == 0) | (pre == 0xFF)).all())


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    res = _run([os.path.join(REPO, "chip_smoke.py")])
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


# -- on a CUDA card only ------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


def _tape_inputs(seed, R, omit_kind, device):
    """Round keys of R random reps and an omit vector: None, "random" (0-8)
    or "every" (rep r omits r % 9, so every value 0-8 occurs)."""
    rng = np.random.RandomState(seed)
    rk = aes_tape.round_keys(rng.randint(0, 256, (R, 8, 16), dtype=np.uint8), device)
    om = {None: None, "random": rng.randint(0, 9, R), "every": np.arange(R) % 9}[omit_kind]
    return rk, None if om is None else torch.from_numpy(om.astype(np.uint8)).to(device)


# the legs' R; R = 3 and 37 leave lanes of a warp (and of a 4-rep word) past
# R; m = 1 and small ragged m are shorter than one thread's run of counter
# blocks; start 2**32 - 2 puts the 32-bit carry of the counter inside a run
TAPE_CASES = [(256, 1000, None, 3), (40, 4097, "random", 3), (216, 129, None, 3),
              (3, 301, None, 3), (37, 1001, "random", 3), (40, 999, "every", 3),
              (8, 1, "random", 3), (64, 50_001, None, 2**32 - 2),
              (256, 7, "random", 2**32 - 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("R, m2, omit_kind, start", TAPE_CASES)
def test_aes_kernel_matches_plain(cuda_device, R, m2, omit_kind, start):
    rk, omit = _tape_inputs(R, R, omit_kind, cuda_device)
    n0 = aes_tape.LAUNCHES
    got = aes_tape.aes_ctr_tape_gf2(rk, m2, omit, start_block=start)
    assert aes_tape.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, aes_tape.aes_ctr_tape_gf2_ref(rk, m2, omit, start_block=start))


@pytest.mark.cuda
@pytest.mark.parametrize("R, mz, omit_kind, start", TAPE_CASES)
def test_aes_z64_kernel_matches_plain(cuda_device, R, mz, omit_kind, start):
    rk, omit = _tape_inputs(R + 1, R, omit_kind, cuda_device)
    n0 = aes_tape_z64.LAUNCHES
    got = aes_tape_z64.aes_ctr_tape_z64(rk, mz, omit, start_block=start)
    assert aes_tape_z64.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, aes_tape_z64.aes_ctr_tape_z64_ref(rk, mz, omit, start_block=start))


@pytest.mark.cuda
@pytest.mark.parametrize("R, n, base, offset", CHUNK_CASES)
def test_blake3_kernel_matches_plain(cuda_device, R, n, base, offset):
    """The chunk kernel on each of its routes (blake3.plan: R, and a buffer
    `offset` bytes into a 16-byte-aligned allocation) is one launch and
    equals the plain version."""
    rows = np.random.RandomState(n + R).randint(0, 256, (n * 1024 + 5) * R, dtype=np.uint8)
    flat = torch.empty(rows.size + offset, dtype=torch.uint8, device=cuda_device)
    buf = flat[offset:].view(n * 1024 + 5, R)
    buf.copy_(torch.from_numpy(rows).view(n * 1024 + 5, R))
    assert buf.data_ptr() % 16 == offset
    n0 = b3.LAUNCHES
    got = b3.chunk_cvs(buf, n, base)
    assert b3.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, b3.chunk_cvs_ref(buf, n, base)), b3.launch_plan(buf, n).line()


# -- the tail kernels (csrc/blake3_tail.cu) against the torch tail ---------


def _tail_stream(T: int, R: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(T + R).randint(
        0, 256, (T + 3, R), dtype=np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("R", TAIL_WIDTHS)
@pytest.mark.parametrize("T", TAIL_LENGTHS)
def test_blake3_tail_kernel_matches_plain(cuda_device, T, R):
    """hash_columns on the card (the chunk kernel, then one tail launch)
    equals the torch tail on the same bytes; each CV stack of the first k
    chunks (one launch) has the nodes of _tree_reduce(root=False), and
    finalize_columns on it and the chunks after it equals it too."""
    buf = _tail_stream(T, R)
    dbuf = buf.to(cuda_device)
    n = max(1, -(-T // 1024))
    n0, t0 = b3.LAUNCHES, blake3_tail.LAUNCHES
    got = b3.hash_columns(dbuf, T)
    assert (b3.LAUNCHES - n0, blake3_tail.LAUNCHES - t0) == (int(n > 1 and R > 0), int(R > 0))
    want = b3.hash_columns(buf, T)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    cvs = b3.chunk_cvs(buf, n - 1)
    for k in range(2, n):
        plain, dev = [cvs[:, :k]], [cvs[:, :k].to(cuda_device)]
        b3._tree_reduce(plain, root=False)
        t0 = blake3_tail.LAUNCHES
        b3.pair_levels(dev)
        assert blake3_tail.LAUNCHES - t0 == int(R > 0)
        nodes = lambda lv: {j: x.cpu() for j, x in enumerate(lv) if x.shape[1]}  # noqa: E731
        got_nodes, want_nodes = nodes(dev), nodes(plain)
        assert got_nodes.keys() == want_nodes.keys()
        assert all(torch.equal(got_nodes[j], want_nodes[j]) for j in want_nodes)
        dev[0] = torch.cat([dev[0], cvs[:, k:].to(cuda_device)], dim=1)
        assert torch.equal(b3.finalize_columns(dev, dbuf[(n - 1) * 1024 : T], T).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("R", TAIL_WIDTHS + (16_384,))
def test_blake3_pairs_kernel_matches_plain(cuda_device, R):
    """hash_rep_columns and hash_pair_columns on the card, one launch each,
    equal their plain versions."""
    ins = [torch.from_numpy(np.random.RandomState(R + i).randint(0, 256, (R, 32), dtype=np.uint8))
           for i in range(4)]
    dev = [x.to(cuda_device) for x in ins]
    t0 = blake3_tail.LAUNCHES
    rep, pair = b3.hash_rep_columns(*dev), b3.hash_pair_columns(dev[0], dev[1])
    assert blake3_tail.LAUNCHES - t0 == (2 if R else 0)
    torch.cuda.synchronize()
    assert torch.equal(rep.cpu(), b3.hash_rep_columns_ref(*ins))
    assert torch.equal(pair.cpu(), b3.hash_pair_columns_ref(ins[0], ins[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("T, block, R, nodes", HASHER_CASES)
def test_column_hasher_tail_on_cuda_matches_cpu(cuda_device, T, block, R, nodes):
    """ColumnHasher on the card at the CPU tests' cases: each absorb makes
    at most one chunk launch and one tail launch (its pairing), finalize
    one tail launch, and the hashes equal the hasher's on the CPU."""
    buf = _tail_stream(T, R)
    held = (nodes or 1 << 20) * b3.CV_BYTES * R
    hashes = []
    for dev in (torch.device("cpu"), cuda_device):
        h = b3.ColumnHasher(T, R, dev, held, b3.COMPRESS_BYTES * R)
        for lo, hi in absorb_blocks(T, block):
            n0, t0 = b3.LAUNCHES, blake3_tail.LAUNCHES
            h.absorb(buf[lo:hi].to(dev))
            assert b3.LAUNCHES - n0 <= 1 and blake3_tail.LAUNCHES - t0 <= 1
            sizes = [x.shape[1] for x in h.levels]
            assert sum(sizes) <= h.max_nodes or max(sizes) <= 1
        t0 = blake3_tail.LAUNCHES
        hashes.append(h.finalize().cpu())
        assert blake3_tail.LAUNCHES - t0 == (dev.type == "cuda")
    assert torch.equal(hashes[0], hashes[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", LEG_LENGTHS)
@pytest.mark.parametrize("R", TAIL_WIDTHS + (2048,))
@pytest.mark.parametrize("comm", [False, True])
def test_blake3_leg_kernel_matches_plain(cuda_device, lengths, R, comm):
    """hash_leg on the card (K3 on each stream's whole chunks, then one
    tail launch for the four streams and the pair hashes) equals its plain
    version on the same bytes, with the online hashes computed or the
    committed ones given; so does one launch on CV stacks at several
    offsets p0 (the first k chunks of each stream paired)."""
    bufs = [torch.from_numpy(np.random.RandomState(T + 7 * i + R).randint(
        0, 256, (T + 3, R), dtype=np.uint8)) for i, T in enumerate(lengths)]
    legs = [b3.stream_tail(b, T) for b, T in zip(bufs, lengths)]
    if comm:
        legs[1], legs[3] = [torch.from_numpy(np.random.RandomState(R + i).randint(
            0, 256, (R, 32), dtype=np.uint8)) for i in (1, 3)]
    dev = [x.to(cuda_device) if isinstance(x, torch.Tensor)
           else b3.stream_tail(bufs[i].to(cuda_device), x[2])
           for i, x in enumerate(legs)]
    t0 = blake3_tail.LAUNCHES
    got = b3.hash_leg(*dev)
    assert blake3_tail.LAUNCHES - t0 == int(R > 0)
    want = b3.hash_leg_ref(*legs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if comm or R == 0:
        return
    stacked = []
    for x in dev:
        levels, rem, T = x
        n = b3._last_chunk(T)[0]
        if n > 3:
            k = n // 2 + 1
            levels = blake3_tail.stack([levels[0][:, :k]])
            levels[0] = torch.cat([levels[0], x[0][0][:, k:]], dim=1)
        stacked.append((levels, rem, T))
    t0 = blake3_tail.LAUNCHES
    got = b3.hash_leg(*stacked)
    assert blake3_tail.LAUNCHES - t0 == 1
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_blake3_tail_plans_with_the_card(cuda_device):
    """A launch plans with its card's SMs and the kernel's registers, read
    from the device and the built kernel: launch_plan is plan at those, and
    every one of the plan's blocks fits the registers of an SM."""
    sms, registers = blake3_tail.card(cuda_device.index or 0)
    assert sms == torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert 0 < registers <= 255
    R = 256
    bufs = [torch.zeros((T + 3, R), dtype=torch.uint8, device=cuda_device)
            for T in LEG_LENGTHS[0]]
    legs = [b3.stream_tail(b, T) for b, T in zip(bufs, LEG_LENGTHS[0])]
    inputs = [(x[0], x[1], b3._last_chunk(x[2])[1]) for x in legs]
    p = blake3_tail.launch_plan(inputs)
    R_, shapes = blake3_tail._shapes(inputs)
    assert p == blake3_tail.plan(R_, tuple(shapes), sms, registers)
    assert p.threads * registers <= 65536


@pytest.mark.cuda
@pytest.mark.parametrize("n_and", [3000, 30_000])
def test_hash_phases_launch_the_tail_once_a_stream(cuda_device, n_and):
    """TorchKKW on the card at two sizes: the prove's, the online
    verify's and the preprocessing verify's hash phases launch the tail
    once each (all four streams, or two and the committed online hashes,
    with the pair hashes in the same launch), whatever the streams'
    lengths; the proof equals the CPU's."""
    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.circuit.builders import mul_bench_circuit

    prog, wit2, witz = mul_bench_circuit(n_and)
    seeds = np.random.RandomState(3).randint(0, 256, (256, 16), dtype=np.uint8)
    kkw = TorchKKW(prog, device=cuda_device)
    proof = kkw.prove(wit2, witz, seeds=seeds)
    assert kkw.last_timings["hash"]["launches"]["blake3_tail"] == 1
    assert proof.to_bytes() == TorchKKW(prog, device=torch.device("cpu")).prove(
        wit2, witz, seeds=seeds).to_bytes()
    assert kkw.verify(proof) is True
    tail = {k: v["launches"]["blake3_tail"] for k, v in kkw.last_timings.items()}
    assert (tail["onl_hash"], tail["pre_hash"]) == (1, 1)
    assert sum(tail.values()) == 2


@pytest.mark.cuda
def test_blake3_tail_rejects_bad_input(cuda_device):
    """On the card the tail raises on two nodes at a height above level 0,
    node CVs of another type or off the card, a stream buffer of another
    width, and pair inputs that are not contiguous or off the card."""
    R = 8
    cvs = torch.zeros((8, 2, R), dtype=torch.int32, device=cuda_device)
    rem = torch.zeros((1024, R), dtype=torch.uint8, device=cuda_device)
    for levels, r in (([cvs, cvs], rem), ([cvs.to(torch.int64)], rem), ([cvs.cpu()], rem),
                      ([cvs], rem[:, :4])):
        with pytest.raises(ValueError):
            b3.finalize_columns(levels, r, sum(x.shape[1] << j for j, x in enumerate(levels))
                                * 1024 + 1)
    rows = torch.zeros((R, 64), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        b3.hash_pair_columns(rows[:, :32], rows[:, 32:])
    with pytest.raises(ValueError):
        b3.hash_rep_columns(*[rows[:, :32].contiguous()] * 3,
                            torch.zeros((R, 32), dtype=torch.uint8))


# batch widths R = N * 256 whose outputs or inputs pass 2**31 bytes: the
# GF(2) tape at 8 proofs (2.25 GB), the z64 tape at 4 proofs (2.62 GB), the
# chunk CVs of 8 proofs' columns (a 2.25 GB stream); each equals the
# per-proof launches at R = 256, column block by column block
@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["aes_tape_gf2", "aes_tape_z64"])
def test_tape_kernels_at_batch_width(cuda_device, kernel):
    n, m = (8, 1_100_000) if kernel == "aes_tape_gf2" else (4, 40_000)
    fn = aes_tape.aes_ctr_tape_gf2 if kernel == "aes_tape_gf2" else aes_tape_z64.aes_ctr_tape_z64
    rk, omit = _tape_inputs(n, n * 256, "random", cuda_device)
    got = fn(rk, m, omit)
    assert got.numel() * got.element_size() > 2**31
    for p in range(n):
        part = fn(rk[p * 2048 : (p + 1) * 2048], m, omit[p * 256 : (p + 1) * 256])
        assert torch.equal(got[..., p * 256 : (p + 1) * 256], part), p


@pytest.mark.cuda
def test_blake3_kernel_at_batch_width(cuda_device):
    n, T = 8, 1_100_000
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    buf = torch.randint(0, 256, (T, n * 256), dtype=torch.uint8, device=cuda_device,
                        generator=gen)
    assert buf.numel() > 2**31
    got = b3.chunk_cvs(buf, T // 1024, 3)
    for p in range(n):
        part = b3.chunk_cvs(buf[:, p * 256 : (p + 1) * 256].contiguous(), T // 1024, 3)
        assert torch.equal(got[..., p * 256 : (p + 1) * 256], part), p


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_input(cuda_device):
    rk = torch.zeros((16, 11, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        aes_tape.aes_ctr_tape_gf2(rk[:, :, :8].contiguous(), 10)
    with pytest.raises(ValueError):
        aes_tape_z64.aes_ctr_tape_z64(rk[:12], 10)  # 12 keys: not 8 per rep
    with pytest.raises(ValueError):
        aes_tape_z64.aes_ctr_tape_z64(rk, 10, torch.zeros(2, dtype=torch.int64,
                                                          device=cuda_device))
    with pytest.raises(ValueError):  # omit off the card
        aes_tape_z64.aes_ctr_tape_z64(rk, 10, torch.zeros(2, dtype=torch.uint8))
    buf = torch.zeros((1024, 8), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        b3.chunk_cvs(buf.t(), 1)


@pytest.mark.cuda
# Kw = R / 4 plane words in groups of 16: R = 40, 216 and 4 leave the last
# group 10, 6 and 1 warps; B = 1 and odd B end a run mid-pair, B = 1 and 7
# are shorter than a pair; R = 256 at B = 4,129 gives several runs per
# resident block, the last of them one block long
@pytest.mark.parametrize("R, B", [(256, 33), (40, 1), (216, 7), (4, 1), (4, 3), (40, 999),
                                  (216, 129), (256, 4129), (256, 1)])
def test_planes_kernel_matches_plain(cuda_device, R, B):
    keys = np.random.RandomState(R).randint(0, 256, (R, 8, 16), dtype=np.uint8)
    rk = aes_tape.round_keys(keys, cuda_device)
    n0 = aes_planes.LAUNCHES
    got = aes_planes.aes_ctr_planes(rk, B)
    assert aes_planes.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, aes_planes.aes_ctr_planes_ref(rk, B))


@pytest.mark.cuda
@pytest.mark.parametrize("n, dtype", [(4099, torch.uint8), (1000, torch.int32),
                                      (3, torch.int64)])
def test_copy_kernel_matches_plain(cuda_device, n, dtype):
    x = r4_bwroof.random_tensor((n, 7), dtype, cuda_device, n)
    n0 = r4_bwroof.LAUNCHES
    got = r4_bwroof.copy(x)
    assert r4_bwroof.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, r4_bwroof.copy_ref(x))


@pytest.mark.cuda
@pytest.mark.parametrize("T, perm", [(64, False), (64, True), (1001, True), (1, False)])
def test_u8emit_kernel_matches_plain(cuda_device, T, perm):
    w = r4_bwroof.random_tensor((T, 128), torch.int32, cuda_device, T)
    n0 = r5_u8emit.LAUNCHES
    got = r5_u8emit.u32_to_u8_rows(w, perm)
    assert r5_u8emit.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, r5_u8emit.u32_to_u8_rows_ref(w, perm))


@pytest.mark.cuda
@pytest.mark.parametrize("n, R", [(1001, 256), (1000, 40), (7, 4), (0, 8)])
def test_pack_shift_kernel_matches_plain(cuda_device, n, R):
    x = r4_bwroof.random_tensor((n, R), torch.uint8, cuda_device, n + R)
    sh = torch.from_numpy(np.random.RandomState(R).randint(0, 9, R).astype(np.uint8)).to(
        cuda_device)
    n0 = r4_extract_probe.LAUNCHES
    got = r4_extract_probe.pack_shift(x, sh)
    assert r4_extract_probe.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, r4_extract_probe.pack_shift_ref(x, sh))


@pytest.mark.cuda
def test_new_cuda_wrappers_reject_bad_input(cuda_device):
    with pytest.raises(ValueError):  # not contiguous
        aes_planes.aes_ctr_planes(torch.zeros(11, 32, 16, dtype=torch.uint8,
                                              device=cuda_device).transpose(0, 1), 2)
    x = torch.zeros(64, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):  # not 16-byte aligned
        r4_bwroof.copy(x[1:17])
    with pytest.raises(ValueError):  # not contiguous
        r5_u8emit.u32_to_u8_rows(torch.zeros(128, 4, dtype=torch.int32,
                                             device=cuda_device).t())
    with pytest.raises(ValueError):  # R % 4 != 0
        r4_extract_probe.pack_shift(torch.zeros(9, 6, dtype=torch.uint8, device=cuda_device),
                                    torch.zeros(6, dtype=torch.uint8, device=cuda_device))


# (R, n_waves, W, nop_wave): R = 3 and 37 leave lanes of a 32-rep block
# past R, R = 40 and 216 are the verifiers' widths, 512 two proofs; one wave;
# an all-NOP wave; W = 13 below and W = 40 and 64 above the kernel's 32 slot
# threads (40 not a multiple of them)
WAVE_CASES = [(3, 1, 5, -1), (37, 40, 13, 7), (40, 60, 40, 0), (216, 30, 40, 29),
              (256, 100, 32, 50), (512, 80, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("R, n_waves, W, nop_wave", WAVE_CASES)
@pytest.mark.parametrize("mode", [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE])
def test_wave_kernel_matches_plain(cuda_device, mode, R, n_waves, W, nop_wave):
    table, sizes = random_waves(R + W, n_waves, W, mode, nop_wave)
    inputs = wave_inputs(R, mode, R, sizes, cuda_device)
    n0 = scan.LAUNCHES
    got = run_program(table, mode, inputs, sizes)
    assert scan.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    want = run_waves(scan.wave_gf2_ref, torch.from_numpy(table).to(cuda_device), mode, inputs,
                     sizes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if mode == tex.PROVER and R >= 37:  # a failing ASSERT_ZERO in some reps only
        assert 0 < int(got[2].sum()) < R


def _spill_capacity(table, spill: str) -> int:
    """A capacity that leaves most values of `table` spilled ("most": a
    quarter of its live set) or every value but the zero ("all")."""
    return 1 if spill == "all" else max(2, scan.live_set(table) // 4)


@pytest.mark.cuda
@pytest.mark.parametrize("spill", ["most", "all"])
@pytest.mark.parametrize("R, n_waves, W, nop_wave", WAVE_CASES)
@pytest.mark.parametrize("mode", [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE])
def test_wave_kernel_spills_match_plain(cuda_device, mode, R, n_waves, W, nop_wave, spill):
    """The WAVE_CASES with the shared slots cut so that most values, or all
    but the zero, live in the kernel's global spill arena: the same launch,
    equal to the plain version on the SSA table."""
    table, sizes = random_waves(R + W, n_waves, W, mode, nop_wave)
    cap = _spill_capacity(table, spill)
    prog = scan.wave_program(table, mode, cuda_device, R, capacity=cap)
    assert prog.n_spill > 0 and prog.n_shared <= cap
    inputs = wave_inputs(R, mode, R, sizes, cuda_device)
    n0 = scan.LAUNCHES
    got = scan.wave_run(prog, mode, *inputs, sizes["n_onl"], sizes["n_pre"])
    assert scan.LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    want = run_waves(scan.wave_gf2_ref, torch.from_numpy(table).to(cuda_device), mode, inputs,
                     sizes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [8, 37, 256])
@pytest.mark.parametrize("mode", [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE])
def test_wave_kernel_reuses_a_slot_at_the_boundary(cuda_device, mode, R):
    """boundary_waves: a slot freed in wave 1 and written in wave 2, in
    shared memory and spilled."""
    table, sizes = boundary_waves()
    inputs = wave_inputs(R, mode, R, sizes, cuda_device)
    want = run_waves(scan.wave_gf2_ref, torch.from_numpy(table), mode,
                     [None if t is None else t.cpu() for t in inputs], sizes)
    for cap in (0, 1):
        got = run_program(table, mode, inputs, sizes, capacity=cap)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [32, 16, 8])
@pytest.mark.parametrize("mode", [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE])
def test_wave_kernel_reps_per_block(cuda_device, mode, reps):
    """Each block width of the launch plan (32, 16, 8 reps), at a ragged R
    and W = 40 (two slots a thread at 32 reps), equal to the plain version."""
    table, sizes = random_waves(reps, 50, 40, mode, 3)
    R = 216 + reps // 8
    inputs = wave_inputs(reps, mode, R, sizes, cuda_device)
    prog = scan.wave_program(table, mode, cuda_device, R, reps=reps)
    assert prog.plan.reps == reps
    got = scan.wave_run(prog, mode, *inputs, sizes["n_onl"], sizes["n_pre"])
    torch.cuda.synchronize()
    want = run_waves(scan.wave_gf2_ref, torch.from_numpy(table).to(cuda_device), mode, inputs,
                     sizes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("spill", ["none", "most"])
@pytest.mark.parametrize("mode", [tex.PROVER, tex.VERIFY_ONL])
def test_wave_kernel_at_a_chunk_width(cuda_device, mode, spill):
    """R = 16,384 (a chunk of 64 proofs: 512 blocks), all in shared memory
    and with most values spilled: equal to the plain version."""
    table, sizes = random_waves(9, 60, 32, mode, 5)
    R = 16_384
    inputs = wave_inputs(9, mode, R, sizes, cuda_device)
    cap = 0 if spill == "none" else _spill_capacity(table, "most")
    prog = scan.wave_program(table, mode, cuda_device, R, capacity=cap)
    assert (prog.n_spill > 0) == (spill == "most")
    got = scan.wave_run(prog, mode, *inputs, sizes["n_onl"], sizes["n_pre"])
    torch.cuda.synchronize()
    want = run_waves(scan.wave_gf2_ref, torch.from_numpy(table).to(cuda_device), mode, inputs,
                     sizes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if mode == tex.PROVER:
        assert 0 < int(got[2].sum()) < R


def deep_chain(depth: int):
    """A GF(2) program `depth` levels deep over the port's own gates: a chain
    of MUL, ADDC and MULC from two inputs and a random, with a passing
    ASSERT_ZERO of x + x on the way."""
    g = CombineOp.gf2
    prog = [g(Gate(Op.INPUT, dst=0)), g(Gate(Op.INPUT, dst=1)), g(Gate(Op.RANDOM, dst=2))]
    for i in range(depth):
        op = (Op.MUL, Op.ADDC, Op.MULC)[i % 3]
        src2 = {"src2": (1, 2)[i % 2]} if op == Op.MUL else {"const": 1}
        prog.append(g(Gate(op, dst=3 + i, src1=2 + i if i else 0, **src2)))
    prog += [g(Gate(Op.ADD, dst=3 + depth, src1=2 + depth, src2=2 + depth)),
             g(Gate(Op.ASSERT_ZERO, src1=3 + depth))]
    return prog


@pytest.mark.cuda
def test_scan_executor_on_cuda_never_takes_the_plain_version(cuda_device, monkeypatch):
    """ScanExecutor on the card is one launch per call, equal to the CPU
    executor's outputs, and never calls wave_gf2_ref."""
    cc = compile_program(deep_chain(200))
    assert cc.depth > 128
    rng = np.random.RandomState(2)
    inp = {"tape": rng.randint(0, 256, (cc.m2, 256), dtype=np.uint8),
           "wit2": rng.randint(0, 2, (cc.n_wit2, 256), dtype=np.uint8)}
    want = scan.ScanExecutor(cc, tex.PROVER, 256, torch.device("cpu"))(
        {k: torch.from_numpy(v) for k, v in inp.items()})

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(scan, "wave_gf2_ref", no_plain)
    ex = scan.ScanExecutor(cc, tex.PROVER, 256, cuda_device)
    n0 = scan.LAUNCHES
    got = ex({k: torch.from_numpy(v).to(cuda_device) for k, v in inp.items()})
    assert scan.LAUNCHES == n0 + 1
    for key in ("onl2", "pre2", "onlz", "prez", "fail"):
        assert torch.equal(got[key].cpu(), want[key]), key


@pytest.mark.cuda
def test_wave_kernel_rejects_bad_input(cuda_device):
    table, sizes = random_waves(1, 4, 8, tex.PROVER)
    tape, xin, _, _ = wave_inputs(1, tex.PROVER, 64, sizes, cuda_device)
    prog = scan.wave_program(table, tex.PROVER, cuda_device, 64)
    args = (sizes["n_onl"], sizes["n_pre"])
    with pytest.raises(ValueError):  # the packed table off the card
        scan.wave_run(scan.wave_program(table, tex.PROVER, torch.device("cpu"), 64),
                      tex.PROVER, tape, xin, None, None, *args)
    with pytest.raises(ValueError):  # a table of another shape
        scan.wave_program(table[..., :-1], tex.PROVER, cuda_device, 64)
    with pytest.raises(ValueError):  # a tape that is not contiguous
        scan.wave_run(prog, tex.PROVER, tape.t().contiguous().t(), xin, None, None, *args)
    with pytest.raises(ValueError):  # a witness of another width
        scan.wave_run(prog, tex.PROVER, tape, xin[:, :32].contiguous(), None, None, *args)
    with pytest.raises(ValueError):
        scan.wave_run(prog, 3, tape, xin, None, None, *args)


# -- deep z64 and B2A circuits on the wave executor (W2) and the carries ------
# The statements of reverie_tpu's deep-scan tests (tests/test_tpu_backend.py;
# the port's builders z64_chain_circuit, deep_b2a_circuit,
# z64_all_ops_circuit); their CPU comparisons with reverie_tpu are in
# tests/test_torch_wave_z64.py and tests/test_torch_carries.py.

MODES = [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE]


def random_mixed(seed: int):
    """test_scan_vs_unrolled_randomized's random GF(2), Z64 and B2A program
    (64 GF(2) and 3 z64 inputs, 30-80 random ops)."""
    import random

    rng = random.Random(seed)
    g, z = CombineOp.gf2, CombineOp.z64
    prog = [g(Gate(Op.INPUT, dst=w)) for w in range(64)]
    prog += [z(Gate(Op.INPUT, dst=w)) for w in range(3)]
    g_kinds, z_kinds = [Op.ADD, Op.MUL, Op.ADDC, Op.MULC], [Op.ADD, Op.SUB, Op.MUL, Op.ADDC,
                                                           Op.MULC]
    for _ in range(rng.randrange(30, 80)):
        r = rng.random()
        if r < 0.55:
            k = g_kinds[rng.randrange(len(g_kinds))]
            a, b2, d = (rng.randrange(64) for _ in range(3))
            if k in (Op.ADDC, Op.MULC):
                prog.append(g(Gate(k, dst=d, src1=a, const=rng.getrandbits(1))))
            else:
                prog.append(g(Gate(k, dst=d, src1=a, src2=b2)))
        elif r < 0.9:
            k = z_kinds[rng.randrange(len(z_kinds))]
            a, b2, d = rng.randrange(3), rng.randrange(3), rng.randrange(3)
            if k in (Op.ADDC, Op.MULC):
                prog.append(z(Gate(k, dst=d, src1=a, const=rng.getrandbits(64))))
            else:
                prog.append(z(Gate(k, dst=d, src1=a, src2=b2)))
        else:
            prog.append(CombineOp.b2a(rng.randrange(3), 0))
    wit2 = [bool(rng.getrandbits(1)) for _ in range(64)]
    return prog, wit2, [rng.getrandbits(64) for _ in range(3)]


Z64_PROGRAMS = {"chain": z64_chain, "b2a": deep_b2a, "all_ops": lambda: z64_all_ops(60),
                "random1": lambda: random_mixed(1)}


def _words(rng, shape):
    return rng.randint(-2**63, 2**63 - 1, shape, dtype=np.int64)


def executor_inputs(cc, mode: int, R: int, seed: int) -> dict:
    """Random executor inputs of a role at R lanes, as numpy: both tapes,
    the witnesses (PROVER) or the injected records (VERIFY_ONL: each rep's
    GF(2) recon bits at its omitted player's bit, its z64 recon words at
    its omitted player's share, the tapes zero there)."""
    rng = np.random.RandomState(seed)
    inp = {"tape": rng.randint(0, 256, (cc.m2, R), dtype=np.uint8),
           "tapez": _words(rng, (cc.mz, 8, R))}
    if mode == tex.PROVER:
        inp["wit2"] = rng.randint(0, 2, (cc.n_wit2, R), dtype=np.uint8)
        inp["witz"] = _words(rng, (cc.n_witz, R))
    elif mode == tex.VERIFY_ONL:
        omit = rng.randint(0, 8, R)
        inp["tape"] &= ~(0x80 >> omit).astype(np.uint8)
        inp["tapez"] *= np.arange(8)[:, None] != omit
        inp["in2"] = rng.randint(0, 2, (cc.n_inputs2, R), dtype=np.uint8)
        inp["co2"] = rng.randint(0, 2, (cc.n_corrs2, R), dtype=np.uint8)
        inp["re2"] = (rng.randint(0, 2, (cc.n_recons2, R)) << (7 - omit)).astype(np.uint8)
        inp["inz"], inp["coz"] = _words(rng, (cc.n_inputsz, R)), _words(rng, (cc.n_corrsz, R))
        inp["rez"] = _words(rng, (cc.n_reconsz, 1, R)) * (np.arange(8)[:, None] == omit)
    return inp


def on(inp: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in inp.items()}


#: the rows of the global inputs a segment reads: (input, Segment base field,
#: CompiledCircuit count field)
SEGMENT_ROWS = (("tape", "tape0", "m2"), ("wit2", "wit0", "n_wit2"),
                ("in2", "inp0", "n_inputs2"), ("co2", "cor0", "n_corrs2"),
                ("re2", "rec0", "n_recons2"), ("tapez", "tapez0", "mz"),
                ("witz", "witz0", "n_witz"), ("inz", "inpz0", "n_inputsz"),
                ("coz", "corz0", "n_corrsz"), ("rez", "recz0", "n_reconsz"))


def run_segments(segments, make, inp: dict):
    """Each segment through make(seg) (an executor with its carries), its
    inputs cut from the global ones `inp` and its carried-in rows from the
    segments before (carry_src) -> per segment the executor's outputs."""
    outs = []
    for seg in segments:
        cc = seg.cc
        sub = {k: inp[k][getattr(seg, base): getattr(seg, base) + getattr(cc, n)]
               for k, base, n in SEGMENT_ROWS if k in inp}
        for names, src in ((("carry_mask2", "carry_corr2"), seg.carry_src),
                           (("carry_maskz", "carry_corrz"), seg.carry_srcz)):
            if src:
                for name in names:
                    sub[name] = torch.stack([outs[s][name][row] for s, row in src])
        outs.append(make(seg)(sub))
    return outs


def segment_executor(cls, mode: int, R: int, device):
    """make(seg) for run_segments: `cls` (Executor or ScanExecutor) with the
    segment's carries."""
    return lambda seg: cls(seg.cc, mode, R, device, carry_in=len(seg.carry_in),
                           carry_out_vals=seg.carry_out_vals, carry_inz=len(seg.carry_inz),
                           carry_outz_vals=seg.carry_outz_vals)


OUT_KEYS = ("onl2", "pre2", "onlz", "prez", "fail")
CARRY_KEYS = ("carry_mask2", "carry_corr2", "carry_maskz", "carry_corrz")


@pytest.mark.cuda
@pytest.mark.parametrize("R", [256, 40, 37])
@pytest.mark.parametrize("name", list(Z64_PROGRAMS))
@pytest.mark.parametrize("mode", MODES)
def test_z64_wave_kernel_matches_plain(cuda_device, mode, name, R):
    """W2 through ScanExecutor on the card, one launch, equal to the plain
    version on the CPU on every stream and fail: the deep z64 chain, deep
    B2A, every z64 kind and a random mixed program, at R = 256, the online
    verifier's 40 (random omits) and a ragged 37."""
    cc = compile_program(Z64_PROGRAMS[name]()[0])
    inp = executor_inputs(cc, mode, R, seed=R + mode)
    want = scan.ScanExecutor(cc, mode, R, torch.device("cpu"))(on(inp, "cpu"))
    ex = scan.ScanExecutor(cc, mode, R, cuda_device)
    assert ex.program.has_z64
    n0, n1 = scan.LAUNCHES_Z64, scan.LAUNCHES
    got = ex(on(inp, cuda_device))
    assert (scan.LAUNCHES_Z64, scan.LAUNCHES) == (n0 + 1, n1)
    for key in OUT_KEYS:
        assert torch.equal(got[key].cpu(), want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("W, reps", [(128, 16), (256, 8)])
@pytest.mark.parametrize("mode", MODES)
def test_z64_wave_kernel_wide_waves_match_plain(cuda_device, mode, W, reps):
    """Deep B2A in waves of W GF(2) slots at R = 2,051 (a ragged last
    block): W2's blocks of at most 512 threads take one GF(2) slot a
    thread, so the wide waves take narrower blocks; equal to the plain
    version on the CPU."""
    cc = compile_program(deep_b2a(200)[0])
    R = 2051
    inp = executor_inputs(cc, mode, R, seed=W + mode)
    want = scan.ScanExecutor(cc, mode, R, torch.device("cpu"), wave_width=W)(on(inp, "cpu"))
    ex = scan.ScanExecutor(cc, mode, R, cuda_device, wave_width=W)
    assert (ex.program.plan.reps, ex.program.plan.k) == (reps, 1)
    got = ex(on(inp, cuda_device))
    for key in OUT_KEYS:
        assert torch.equal(got[key].cpu(), want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("R", [256, 2560])
@pytest.mark.parametrize("mode", MODES)
def test_z64_wave_kernel_widest_z64_waves_match_plain(cuda_device, mode, R):
    """64 z64 chains side by side (Wz = 64, 64 MULs a wave): W2 stages one
    wave a chunk (chunks of 4 do not fit a block: 409,600 bytes of staged
    words online), the online verifier's z64 values partly spilled; on 8
    lanes a slot and on 1 (R = 2,560); equal to the plain version on the
    CPU."""
    cc = compile_program(z64_chains(64, 150)[0])
    inp = executor_inputs(cc, mode, R, seed=3 * R + mode)
    want = scan.ScanExecutor(cc, mode, R, torch.device("cpu"))(on(inp, "cpu"))
    ex = scan.ScanExecutor(cc, mode, R, cuda_device)
    p = ex.program.plan
    assert (p.Wz, p.chunk, p.zlanes) == (64, 1, 8 if R <= 8 * scan.SMS else 1)
    assert (ex.program.n_spillz > 0) == (mode == tex.VERIFY_ONL)
    got = ex(on(inp, cuda_device))
    for key in OUT_KEYS:
        assert torch.equal(got[key].cpu(), want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("carries", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_z64_wave_kernel_one_lane_matches_plain(cuda_device, mode, carries):
    """W2's one-lane kernels (one thread a (rep, z64 slot), past R = 8 x
    SMS) in each role, without carries and with them (the chain's segments,
    their carries chained from the segments before): streams, fail and
    carry outputs equal the plain version's on the CPU at R = 2,560."""
    R = 2560
    prog = z64_chain(150)[0]
    segments = compile_segments(prog, 40) if carries else []
    whole = compile_program(prog)
    inp = executor_inputs(whole, mode, R, seed=R + mode)
    if carries:
        assert len(segments) >= 3 and any(s.carry_inz for s in segments)
        want = run_segments(segments, segment_executor(scan.ScanExecutor, mode, R,
                                                       torch.device("cpu")), on(inp, "cpu"))
        execs = []

        def on_card(seg):
            execs.append(segment_executor(scan.ScanExecutor, mode, R, cuda_device)(seg))
            return execs[-1]
        got = run_segments(segments, on_card, on(inp, cuda_device))
    else:
        want = [scan.ScanExecutor(whole, mode, R, torch.device("cpu"))(on(inp, "cpu"))]
        execs = [scan.ScanExecutor(whole, mode, R, cuda_device)]
        got = [execs[0](on(inp, cuda_device))]
    assert all(ex.program.has_z64 and ex.program.plan.zlanes == 1 for ex in execs)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert torch.equal(g[key].cpu(), w[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("R", [256, 37])
@pytest.mark.parametrize("name", ["chain", "b2a", "random1"])
@pytest.mark.parametrize("mode", MODES)
def test_z64_wave_kernel_spills_match_plain(cuda_device, mode, name, R):
    """W2 with every z64 value but the zero and most GF(2) values spilled
    to its global arenas, equal to the plain version on the CPU."""
    cc = compile_program(Z64_PROGRAMS[name]()[0])
    inp = executor_inputs(cc, mode, R, seed=7 * R + mode)
    want = scan.ScanExecutor(cc, mode, R, torch.device("cpu"))(on(inp, "cpu"))
    prog = scan.circuit_program(cc, mode, cuda_device, R, capacity=3, capacityz=1)
    assert prog.n_spillz > 0 and prog.n_sharedz == 1 and prog.n_shared <= 3
    xin = inp.get("wit2" if mode == tex.PROVER else "in2")
    xinz = inp.get("witz" if mode == tex.PROVER else "inz")
    d = on({k: v for k, v in dict(inp, xin=xin, xinz=xinz).items() if v is not None},
           cuda_device)
    got = scan.wave_run(prog, mode, d["tape"], d.get("xin"), d.get("co2"), d.get("re2"),
                        cc.onl2, cc.pre2, d["tapez"], d.get("xinz"), d.get("coz"), d.get("rez"),
                        cc.onlz, cc.prez)
    for key in OUT_KEYS:
        assert torch.equal(getattr(got, key).cpu(), want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("name, seg_ops", [("chain", 40), ("b2a", 61), ("gf2", 50)])
@pytest.mark.parametrize("mode", MODES)
def test_wave_kernels_chain_segment_carries(cuda_device, mode, name, seg_ops):
    """compile_segments of a deep z64 chain, deep B2A and a deep GF(2)
    chain, each segment on the card (W2, or W1 for GF(2) segments) with
    its carries chained from the segments before: streams, fail and carry
    outputs equal the plain version's on the CPU."""
    prog = deep_chain(200) if name == "gf2" else Z64_PROGRAMS[name]()[0]
    segments = compile_segments(prog, seg_ops)
    assert len(segments) >= 3 and any(s.carry_in or s.carry_inz for s in segments)
    whole = compile_program(prog)
    inp = executor_inputs(whole, mode, 40, seed=mode)
    want = run_segments(segments, segment_executor(scan.ScanExecutor, mode, 40,
                                                   torch.device("cpu")), on(inp, "cpu"))
    n0 = scan.LAUNCHES + scan.LAUNCHES_Z64
    got = run_segments(segments, segment_executor(scan.ScanExecutor, mode, 40, cuda_device),
                       on(inp, cuda_device))
    assert scan.LAUNCHES + scan.LAUNCHES_Z64 == n0 + len(segments)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert torch.equal(g[key].cpu(), w[key]), key


# -- streaming on the card: the tape kernels at a window's start_block, the
# chunk kernel at a stream's chunk_base --------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("R", [256, 40, 216])
def test_column_hasher_on_cuda_matches_cpu(cuda_device, R):
    """ColumnHasher on the card, a 5-chunk ragged stream in blocks of 1,500
    bytes, its held CVs bound to two (paired into the CV stack past them,
    one parent at a time):
    the chunk kernel launched at chunk_base 1, 2 and 4; the hashes equal
    the hasher's on the CPU."""
    T = 5 * 1024 + 300
    buf = torch.from_numpy(np.random.RandomState(R).randint(0, 256, (T, R), dtype=np.uint8))
    hashes, bases = [], []
    for dev in (torch.device("cpu"), cuda_device):
        h = b3.ColumnHasher(T, R, dev, 2 * b3.CV_BYTES * R, b3.COMPRESS_BYTES * R)
        n0 = b3.LAUNCHES
        for lo in range(0, T, 1500):
            if dev.type == "cuda" and (h.rem_len + min(1500, T - lo)) // 1024:
                bases.append(h.chunk_base)
            h.absorb(buf[lo : lo + 1500].to(dev))
        hashes.append(h.finalize().cpu())
    assert b3.LAUNCHES - n0 == len(bases) and bases == [0, 1, 2, 4]
    assert torch.equal(hashes[0], hashes[1])


def _streaming_case(name):
    from reverie_tpu_torch.circuit.builders import mixed_b2a_circuit, mul_bench_circuit

    if name == "mul":
        return mul_bench_circuit(3000) + (500,)
    if name == "b2a":
        return mixed_b2a_circuit() + (7,)
    prog = deep_chain(400)
    return prog, [True, False], [], 140


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mul", "b2a", "deep"])
def test_streaming_on_cuda_matches_cpu(cuda_device, name):
    """StreamingKKW on the card: the proof equals TorchKKW's on the CPU with
    the same seeds, it verifies, a tampered one does not; the tape kernels
    ran at each window's start_block, the chunk kernel on 3,000 ANDs'
    streams, B2A's deep last segment on W2 and the deep chain's first two
    on W1."""
    from reverie_tpu_torch import StreamingKKW, TorchKKW
    from reverie_tpu_torch.proof import Proof

    prog, wit2, witz, seg_ops = _streaming_case(name)
    seeds = np.random.RandomState(5).randint(0, 256, (256, 16), dtype=np.uint8)
    want = TorchKKW(prog, device=torch.device("cpu")).prove(wit2, witz, seeds=seeds)
    sk = StreamingKKW(prog, seg_ops, device=cuda_device)
    assert len(sk.segments) >= 3
    proof = sk.prove(wit2, witz, seeds=seeds)
    assert proof.to_bytes() == want.to_bytes()
    launches = sk.last_timings["pass1"]["launches"]
    assert launches["aes_tape_gf2"] >= 3
    if name == "mul":  # the streams pass 1 KiB
        assert launches["blake3_chunk_cvs"] >= 2
    # the four streams' tails and the pair hashes, one launch
    assert sk.last_timings["hash_final"]["launches"]["blake3_tail"] == 1
    if name == "b2a":  # the last segment, 190 levels, on W2
        assert launches["aes_tape_z64"] >= 1 and launches["scan_z64"] == 1
    if name == "deep":
        assert launches["scan_gf2"] >= 2
    assert sk.verify(proof) is True
    for leg in ("onl_exec", "pre_exec"):
        assert sk.last_timings[leg]["launches"]["aes_tape_gf2"] >= 3
    raw = bytearray(proof.to_bytes())
    raw[len(raw) // 2] ^= 0x40
    assert sk.verify(Proof.from_bytes(bytes(raw))) is False


# -- shards of a mesh on the card (reverie_tpu_torch.parallel) ----------------

#: the lanes of a shard of a 12-shard mesh: 40 -> 4 / 3, 216 -> 18, 256 -> 22
#: / 21
SHARD_WIDTHS = (3, 4, 18, 21, 22)


@pytest.mark.cuda
@pytest.mark.parametrize("R", SHARD_WIDTHS)
def test_tape_and_chunk_kernels_at_shard_widths(cuda_device, R):
    """K1 and K4 (random omits) and K3 at a shard's lanes, each equal to its
    plain version."""
    rk, omit = _tape_inputs(R, R, "random", cuda_device)
    for fn, ref, m in ((aes_tape.aes_ctr_tape_gf2, aes_tape.aes_ctr_tape_gf2_ref, 4097),
                       (aes_tape_z64.aes_ctr_tape_z64, aes_tape_z64.aes_ctr_tape_z64_ref, 1001)):
        got = fn(rk, m, omit, start_block=3)
        torch.cuda.synchronize()
        assert torch.equal(got, ref(rk, m, omit, start_block=3)), fn.__name__
    buf = torch.from_numpy(np.random.RandomState(R).randint(
        0, 256, (3 * 1024 + 5, R), dtype=np.uint8)).to(cuda_device)
    assert torch.equal(b3.chunk_cvs(buf, 3, 1), b3.chunk_cvs_ref(buf, 3, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("R", SHARD_WIDTHS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("circuit", ["gf2", "deep_b2a"])
def test_wave_kernels_at_shard_widths(cuda_device, circuit, mode, R):
    """W1 (a GF(2) chain 200 deep) and W2 (deep B2A) at a shard's lanes in
    each role: one launch, every output equal to the CPU executor's."""
    cc = compile_program(deep_chain(200) if circuit == "gf2" else deep_b2a(150)[0])
    inp = executor_inputs(cc, mode, R, seed=R + mode)
    want = scan.ScanExecutor(cc, mode, R, torch.device("cpu"))(on(inp, torch.device("cpu")))
    counter = "LAUNCHES" if circuit == "gf2" else "LAUNCHES_Z64"
    n0 = getattr(scan, counter)
    got = scan.ScanExecutor(cc, mode, R, cuda_device)(on(inp, cuda_device))
    assert getattr(scan, counter) == n0 + 1
    for key, t in want.items():
        assert torch.equal(got[key].cpu(), t), key


@pytest.mark.cuda
def test_mesh_on_one_card_matches_unsharded(cuda_device):
    """Four shards on one card: the unsharded proof's bytes, one GF(2)
    tape launch a shard in each leg, and verify accepts."""
    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.circuit.builders import mul_bench_circuit
    from reverie_tpu_torch.parallel import make_mesh

    prog, wit2, witz = mul_bench_circuit(5000)
    seeds = np.random.RandomState(4).randint(0, 256, (256, 16), dtype=np.uint8)
    want = TorchKKW(prog, device=cuda_device).prove(wit2, witz, seeds=seeds).to_bytes()
    kkw = TorchKKW(prog, mesh=make_mesh(devices=[torch.device("cuda", 0)] * 4))
    proof = kkw.prove(wit2, witz, seeds=seeds)
    assert proof.to_bytes() == want
    assert kkw.last_timings["tape_gf2"]["launches"]["aes_tape_gf2"] == 4
    assert kkw.verify(proof) is True
    assert kkw.last_timings["onl_tape"]["launches"]["aes_tape_gf2"] == 4


@pytest.mark.cuda
def test_mesh_shards_stay_on_their_devices(cuda_device, monkeypatch):
    """On two cards each shard's kernels launch with its own card current,
    its executors live there, and the proof equals the unsharded one."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA cards, {torch.cuda.device_count()} visible")
    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.circuit.builders import mixed_b2a_circuit
    from reverie_tpu_torch.parallel import make_mesh

    lib = _build.kernels()
    data, current = [], []
    for mod, fn, entry in ((aes_tape, "aes_ctr_tape_gf2", "reverie_aes_tape_gf2"),
                           (aes_tape_z64, "aes_ctr_tape_z64", "reverie_aes_tape_z64"),
                           (b3, "chunk_cvs", "reverie_blake3_chunk_cvs")):
        wrapped, c_entry = getattr(mod, fn), getattr(lib, entry)
        monkeypatch.setattr(mod, fn, lambda t, *a, f=wrapped, **k: data.append(
            t.device.index) or f(t, *a, **k))
        monkeypatch.setattr(lib, entry, lambda *a, e=c_entry: current.append(
            torch.cuda.current_device()) or e(*a))
    prog, wit2, witz = mixed_b2a_circuit()
    seeds = np.random.RandomState(6).randint(0, 256, (256, 16), dtype=np.uint8)
    kkw = TorchKKW(prog, mesh=make_mesh(2))
    proof = kkw.prove(wit2, witz, seeds=seeds)
    assert kkw.verify(proof) is True
    assert data == current and set(data) == {0, 1}
    assert {ex.device.index for ex in kkw._executors.values()} == {0, 1}
    monkeypatch.undo()
    want = TorchKKW(prog, device=cuda_device).prove(wit2, witz, seeds=seeds)
    assert proof.to_bytes() == want.to_bytes()


@pytest.mark.cuda
def test_program_file_read_in_c_proves_on_cuda(cuda_device, tmp_path):
    """A 1M-AND program file, mapped and read by the C reader
    (load_program_arrays: 3 table rows, no op objects), proves on the card
    through make_system with no budget to mul_bench_circuit's list's bytes,
    and the proof verifies."""
    import mmap

    from reverie_tpu_torch import make_system
    from reverie_tpu_torch.circuit import dumps_program
    from reverie_tpu_torch.circuit.bincode import load_program_arrays
    from reverie_tpu_torch.circuit.builders import mul_bench_circuit

    prog, wit2, witz = mul_bench_circuit(1_000_000)
    path = tmp_path / "prog.bin"
    path.write_bytes(dumps_program(prog))
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        ops = load_program_arrays(mm)
    assert ops.n == len(prog) and len(ops.kind) == 3 and ops.objects is None
    seeds = np.random.RandomState(15).randint(0, 256, (256, 16), dtype=np.uint8)
    kkw = make_system(ops, device=cuda_device)
    proof = kkw.prove(wit2, witz, seeds=seeds)
    want = make_system(prog, device=cuda_device).prove(wit2, witz, seeds=seeds)
    assert proof.to_bytes() == want.to_bytes()
    assert kkw.verify(proof) is True
