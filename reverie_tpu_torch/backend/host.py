"""Host orchestration of the prove / verify path on one device.

Port of reverie_tpu/backend/tpu_host.py's `TpuKKW` (`_gf2_tape`,
`_z64_tape`, `_hash_fn`, `prove`, `prove_batch`, `prove_batch_chunked`,
`prove_many`, `_prove_dispatch`, `_prove_challenge`, `_prove_assemble`,
`_batch_dispatch`, `_batch_challenge`, `_batch_assemble`,
`_extract_gf2_dispatch`, `_extract_z64_dispatch`, `_parse_gf2_buf`,
`_parse_z64_buf`, `verify`, `verify_many`, `_verify_dispatch` with its
REVERIE_DEBUG omitted-lane checks, `_verify_finish`), of its
`device_footprint`, re-derived for the port's tensors, and of its helpers
`make_gf2_extractor` and `make_z64_extractor` in their gather forms,
`_pack_rows_device`, `_stack_streams`, `_u64s_from_stream`,
`build_online_injection_packed` and `make_online_unpacker`, for circuits
over GF(2), Z_2^64 and B2A bridges.  One proof is a batch of one: the
single and batch paths, and reverie_tpu's two sets of pipeline stages, are
one set of stages here, over N * 256 proof-major lanes.

The device runs the mask tapes (CUDA kernels), the executor (the levelized
torch one, or for circuits deeper than SCAN_DEPTH_THRESHOLD levels the wave
executor of scan.py, one CUDA kernel launch per call), the
transcript hashes (CUDA chunk kernel + torch tail), and the extraction of
the opened repetitions.  The host runs seed expansion, the Fiat-Shamir
challenge, the blake3 of the rep hashes and proof assembly, as in the
reference.  Each stage ends in an asynchronous device -> host pull that the
next stage waits on, so that in a pipeline one proof's host work overlaps
the next one's device work.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..circuit.compile import CompiledCircuit, compile_program
from ..circuit.ir import CombineOp, Gate, Kind, Op
from ..crypto import blake3, expand_seeds
from ..crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3
from ..params import DEFAULT_PARAMS, KEY_SIZE, ProtocolParams
from ..proof.challenge import challenge_to_opening
from ..proof.container import (
    OpenOnline,
    OpenPreprocessing,
    Proof,
    ProofSingle,
)
from ..device import default_device
from . import scan
from .executor import (
    PROVER,
    VERIFY_ONL,
    VERIFY_PRE,
    Executor,
    _classify,
    event_rows,
    prover_bytes,
    stream_bytes,
    table_bytes,
    take,
)


#: circuits deeper than this many levels run on the wave executor
#: (reverie_tpu/backend/tpu_host.py:71-72)
SCAN_DEPTH_THRESHOLD = 128


def uses_waves(cc: CompiledCircuit) -> bool:
    """True when TorchKKW runs cc on the wave executor (scan.ScanExecutor):
    deeper than SCAN_DEPTH_THRESHOLD, as TpuKKW._executor routes it (W1 for
    pure-GF(2) circuits, W2 for those with z64 or B2A gates)."""
    return cc.depth > SCAN_DEPTH_THRESHOLD


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters, by kernel."""
    return {"aes_tape_gf2": aes_tape.LAUNCHES, "aes_tape_z64": aes_tape_z64.LAUNCHES,
            "blake3_chunk_cvs": b3.LAUNCHES, "scan_gf2": scan.LAUNCHES,
            "scan_z64": scan.LAUNCHES_Z64}


class PhaseTimer:
    """Per phase: host wall time (time.perf_counter), the stream time between
    two CUDA events on a CUDA device, and the kernel launches made."""

    def __init__(self, device: torch.device):
        self.device = device
        self._rows = []

    @contextmanager
    def phase(self, name: str):
        ev = None
        if self.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        l0 = launch_counts()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            host_ms = (time.perf_counter() - t0) * 1e3
            if ev is not None:
                ev[1].record()
            l1 = launch_counts()
            self._rows.append((name, host_ms, ev,
                               {k: l1[k] - l0[k] for k in l0}))

    def report(self) -> Dict[str, dict]:
        """{phase: {host_ms, device_ms (None off CUDA), launches}}."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {
            name: {
                "host_ms": host_ms,
                "device_ms": ev[0].elapsed_time(ev[1]) if ev else None,
                "launches": launches,
            }
            for name, host_ms, ev, launches in self._rows
        }


# ---------------------------------------------------------------------------
# Extraction (prover) and injection (verifier) of the opened streams
# ---------------------------------------------------------------------------


def _take_rows(buf: torch.Tensor, slots: np.ndarray) -> torch.Tensor:
    """Rows `slots` of buf, as a slice where the slots form a run."""
    slots = np.asarray(slots, np.int64)
    meta = _classify(slots) + (len(slots),)
    index = (torch.as_tensor(slots, device=buf.device)
             if meta[0] == "gather" else None)
    return take(buf, meta, index)


def packed_len(n: int) -> int:
    """Bytes of a packed stream of n GF(2) records: the reference always
    emits the remainder byte (gf2/recon.rs:218-237)."""
    return n // 8 + 1


def _pack_rows_device(bits: torch.Tensor) -> torch.Tensor:
    """(N, K) 0/1 uint8 -> (packed_len(N), K) packed bytes, MSB first."""
    N, K = bits.shape
    n_chunks = packed_len(N)
    padded = torch.zeros((n_chunks * 8, K), dtype=torch.uint8, device=bits.device)
    padded[:N] = bits
    w = torch.tensor([128 >> j for j in range(8)], dtype=torch.uint8,
                     device=bits.device)
    return (padded.view(n_chunks, 8, K) * w[None, :, None]).sum(dim=1).to(torch.uint8)


def extract_gf2(cc: CompiledCircuit, onl2: torch.Tensor, pre2: torch.Tensor,
                cols: np.ndarray, omit_sel: np.ndarray, packed: bool = True) -> torch.Tensor:
    """Opened columns -> one flat uint8 buffer [recons | corrs | inputs],
    each (K, packed_len(n)) row-major (make_gf2_extractor, gather form);
    packed=False: each (K, n) 0/1 bits, for a caller that places them at a
    bit offset (the streaming prover's segments)."""
    dev = onl2.device
    cols_t = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
    shifts = torch.as_tensor((7 - np.asarray(omit_sel)).astype(np.uint8), device=dev)
    onl_sel = onl2.index_select(1, cols_t)  # (n_onl, K)
    pre_sel = pre2.index_select(1, cols_t)
    rec = (_take_rows(onl_sel, cc.recon_slots2) >> shifts[None, :]) & 1
    cor = _take_rows(pre_sel, cc.corr_slots2) & 1
    inp = _take_rows(onl_sel, cc.input_slots2) & 1
    pack = _pack_rows_device if packed else (lambda b: b)
    return torch.cat([pack(b).t().reshape(-1) for b in (rec, cor, inp)])


def extract_z64(cc: CompiledCircuit, onlz: torch.Tensor, prez: torch.Tensor,
                cols: np.ndarray, omit_sel: np.ndarray) -> torch.Tensor:
    """Opened columns -> one flat uint8 buffer [recons | corrs | inputs],
    each (K, n*8) row-major (make_z64_extractor, gather form).  A recon
    event is 64 stream rows (8 players x 8 bytes), of which the omitted
    player's 8 are opened; corr and input events are 8 rows."""
    omit_sel = np.asarray(omit_sel, np.int64)
    if (omit_sel >= 8).any():
        raise ValueError("extract_z64: an opened repetition omits no player")
    dev = onlz.device
    K = len(cols)
    cols_t = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
    parts = []
    nr = len(cc.recon_slotsz)
    if nr:
        rec = _take_rows(onlz, event_rows(cc.recon_slotsz, 64))
        rec = rec.index_select(1, cols_t).reshape(nr, 8, 8, K)
        idx = torch.as_tensor(omit_sel, device=dev).view(1, 1, 1, K)
        rec = rec.gather(1, idx.expand(nr, 1, 8, K))[:, 0]  # (nr, 8, K)
        parts.append(rec.permute(2, 0, 1).reshape(-1))
    for slots, src in ((cc.corr_slotsz, prez), (cc.input_slotsz, onlz)):
        if len(slots):
            ev = _take_rows(src, event_rows(slots, 8)).index_select(1, cols_t)
            parts.append(ev.reshape(len(slots), 8, K).permute(2, 0, 1).reshape(-1))
    if not parts:
        return torch.zeros((0,), dtype=torch.uint8, device=dev)
    return torch.cat(parts)


def _stack_streams(streams: List[bytes], nb: int) -> np.ndarray:
    """Per-rep byte streams -> (nb, R) uint8, zero-padded / truncated to nb
    rows per rep (lenient parsing, online.rs:124,163,171)."""
    out = np.zeros((nb, len(streams)), dtype=np.uint8)
    for r, s in enumerate(streams):
        n = min(len(s), nb)
        out[:n, r] = np.frombuffer(s[:n], dtype=np.uint8)
    return out


def _unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(nb, R) packed bytes -> (n, R) 0/1 uint8, MSB first."""
    nb, R = packed.shape
    if n == 0:
        return torch.zeros((0, R), dtype=torch.uint8, device=packed.device)
    sh = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None, :] >> sh[None, :, None]) & 1).reshape(nb * 8, R)[:n]


def _u64s_from_stream(stream: bytes, n: int) -> np.ndarray:
    """The first n little-endian u64 words of a byte stream as int64,
    truncated to whole words and zero-padded to n (lenient parsing)."""
    words = np.frombuffer(stream[: len(stream) // 8 * 8], dtype="<i8")
    out = np.zeros(n, dtype=np.int64)
    k = min(n, len(words))
    out[:k] = words[:k]
    return out


#: the online records a VERIFY_ONL executor takes: its input, the field of
#: the opening that holds them, their count on a CompiledCircuit, their
#: first record on a Segment
ONLINE_RECORDS = (("co2", "corrs", "n_corrs2", "cor0"), ("in2", "inputs", "n_inputs2", "inp0"),
                  ("re2", "recons", "n_recons2", "rec0"), ("coz", "corrs", "n_corrsz", "corz0"),
                  ("inz", "inputs", "n_inputsz", "inpz0"), ("rez", "recons", "n_reconsz", "recz0"))


def online_streams(openings2: List[OpenOnline], openingsz: List[OpenOnline], counts) -> dict:
    """The online openings on the host, as the verifier reads them: each
    GF(2) stream packed, (packed_len(n), R) uint8, each z64 stream as (n, R)
    int64 words, n the count on `counts` (an object with ONLINE_RECORDS'
    count attributes; lenient parsing: zero-padded or truncated to n), and
    the omits 'omit' and 'omitz' (R,) int64 of the two domains, which a
    malformed proof can make differ (build_online_injection_packed)."""
    out = {"omit": np.array([o.omit for o in openings2], dtype=np.int64),
           "omitz": np.array([o.omit for o in openingsz], dtype=np.int64)}
    for name, field, count, _ in ONLINE_RECORDS:
        n = getattr(counts, count)
        if name.endswith("2"):
            out[name] = _stack_streams([getattr(o, field) for o in openings2], packed_len(n))
        else:
            out[name] = np.stack([_u64s_from_stream(getattr(o, field), n) for o in openingsz],
                                 axis=1)
    return out


def unpack_window(packed: np.ndarray, base: int, n: int, device) -> torch.Tensor:
    """Bits base .. base + n - 1 of each column of packed (nb, R) host
    bytes, MSB first -> (n, R) 0/1 uint8 on device; only their bytes are
    copied, and base need not be a multiple of 8."""
    lo, hi = base // 8, (base + n + 7) // 8
    off = base - 8 * lo
    return _unpack_bits(torch.from_numpy(packed[lo:hi]).to(device), off + n)[off:]


def online_inputs(streams: dict, cc: CompiledCircuit, device, seg=None) -> dict:
    """The VERIFY_ONL inputs of cc on the device, from online_streams: the
    records seg.<first> .. + cc.<count> of each stream (seg None: from
    record 0), only those copied to the device.  The recon bits move to
    the omitted player's bit, and the z64 recon words become one-hot shares
    at its slot (make_online_unpacker)."""
    inj = {}
    for name, _, count, first in ONLINE_RECORDS:
        n, base = getattr(cc, count), 0 if seg is None else getattr(seg, first)
        if name.endswith("2"):
            inj[name] = unpack_window(streams[name], base, n, device)
        else:
            inj[name] = torch.from_numpy(streams[name][base : base + n]).to(device)
    shift = torch.as_tensor((7 - streams["omit"]).astype(np.uint8), device=device)
    onehot = (torch.arange(8, device=device)[:, None]
              == torch.as_tensor(streams["omitz"], device=device)[None, :]).to(torch.int64)
    inj["re2"] = inj["re2"] << shift[None, :]
    inj["rez"] = inj["rez"][:, None, :] * onehot
    return inj


# ---------------------------------------------------------------------------
# Asynchronous pulls, seeds and the device footprint
# ---------------------------------------------------------------------------


class _Pull:
    """A device -> host copy in flight.  On CUDA: a non_blocking copy into a
    pinned host tensor, on the compute stream, with an event recorded after
    it; `numpy()` waits on that event before it reads.  On the CPU the same
    code is a plain copy.  The source tensor may be dropped at once: the
    caching allocator hands its memory only to later work of the same
    stream."""

    def __init__(self, t: torch.Tensor):
        cuda = t.device.type == "cuda"
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        self._host.copy_(t, non_blocking=cuda)
        self._event = None
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _seeds(seeds: Optional[np.ndarray], n: int, R: int) -> np.ndarray:
    """(n, R, 16) uint8 rep seeds, fresh random ones where None."""
    if seeds is None:
        seeds = np.frombuffer(os.urandom(n * R * KEY_SIZE), dtype=np.uint8)
    return np.ascontiguousarray(seeds, dtype=np.uint8).reshape(n, R, KEY_SIZE)


def device_footprint(cc: CompiledCircuit, R: int) -> int:
    """Peak device bytes of a prove at R lanes (R = N * 256 for a batch of
    N proofs): the larger of the executor's peak (its own prover_bytes:
    tapes, witness columns, arenas, streams) and the hash (the streams, once
    the tapes and arenas are freed, and the largest transient of one
    stream's hash, blake3.hash_columns_transient_bytes), plus the
    executor's index or wave tables.  The round keys are freed before the
    executor runs.  The executor is the one TorchKKW picks (uses_waves):
    the levelized one (executor.py) or the wave executor (scan.py)."""
    hashing = stream_bytes(cc, R) + max(
        b3.hash_columns_transient_bytes(n, R) for n in (cc.onl2, cc.pre2, cc.onlz, cc.prez))
    if uses_waves(cc):
        return max(scan.prover_bytes(cc, R), hashing) + scan.table_bytes(cc, R)
    return max(prover_bytes(cc, R), hashing) + table_bytes(cc)


def pipeline_footprint(cc: CompiledCircuit, R: int) -> int:
    """Peak device bytes of prove_batch_chunked at chunk R / 256 (R = 256:
    prove_many): one chunk's device_footprint while the chunk before keeps
    its four streams (executor.stream_bytes) for its challenge and
    extraction."""
    return device_footprint(cc, R) + stream_bytes(cc, R)


def largest_batch(cc: CompiledCircuit, free_bytes: int, most: int) -> int:
    """The most proofs N <= most such that prove_batch_chunked at chunk N
    fits in free_bytes by pipeline_footprint (so does prove_batch of N,
    whose device_footprint is smaller); 0 if not even one proof does."""
    return max((n for n in range(1, most + 1)
                if pipeline_footprint(cc, n * 256) <= free_bytes), default=0)


def _check_omitted_lanes(tape: torch.Tensor, tapez: torch.Tensor,
                         omit: np.ndarray, omitz: np.ndarray) -> None:
    """REVERIE_DEBUG: the online verifier's tapes are zero at each rep's
    omitted player (verifier/online.rs:141-160), one device reduction per
    domain; a tape kernel that ignores the omit then fails loudly."""
    dev = tape.device
    bit = np.where(omit < 8, 0x80 >> np.clip(omit, 0, 7), 0).astype(np.uint8)
    if bool((tape & torch.as_tensor(bit, device=dev)[None, :]).any()):
        raise AssertionError(
            "REVERIE_DEBUG: gf2 tape is nonzero at the omitted player's bit lane")
    cols = np.nonzero(omitz < 8)[0]
    if cols.size and tapez.shape[0]:
        sel = tapez[:, torch.as_tensor(omitz[cols], device=dev),
                    torch.as_tensor(cols, device=dev)]
        if bool(sel.any()):
            raise AssertionError(
                "REVERIE_DEBUG: z64 tape is nonzero at the omitted player's lane")


def challenge_omits(comm: bytes, params: ProtocolParams) -> np.ndarray:
    """(total_reps,) int64: per rep the player the challenge of `comm`
    leaves unopened, 8 for a rep whose preprocessing is opened."""
    omit = np.full(params.total_reps, 8, dtype=np.int64)
    for rep, player in challenge_to_opening(comm, params).items():
        omit[rep] = player
    return omit


def assemble_proof(comm: bytes, seeds: np.ndarray, player_keys: np.ndarray,
                   omit: np.ndarray, ho2: np.ndarray, hoz: np.ndarray,
                   open2: list, openz: list) -> Proof:
    """One proof: rep seeds (R, 16), player keys (R, 8, 16), omits (R,),
    the online hashes (R, 32) of each domain and, per opened rep in rep
    order, its (recons, corrs, inputs) streams of each domain."""
    p2, pz = ProofSingle([], []), ProofSingle([], [])
    j = 0
    for r in range(len(omit)):
        if omit[r] < 8:
            ks = player_keys[r].copy()
            ks[omit[r]] = 0
            p2.online.append(OpenOnline(int(omit[r]), ks.tobytes(), *open2[j]))
            pz.online.append(OpenOnline(int(omit[r]), ks.tobytes(), *openz[j]))
            j += 1
        else:
            p2.preprocessing.append(OpenPreprocessing(seeds[r].tobytes(), ho2[r].tobytes()))
            pz.preprocessing.append(OpenPreprocessing(seeds[r].tobytes(), hoz[r].tobytes()))
    return Proof(comm, p2, pz)


def commitment_ok(comm: bytes, hashes_online: np.ndarray, hashes_pre: np.ndarray,
                  params: ProtocolParams) -> bool:
    """The rep hashes of both legs (online_reps, 32) and
    (preprocessing_reps, 32), put back in rep order by the challenge of
    `comm`, hash to `comm`."""
    open_map = challenge_to_opening(comm, params)
    ordered = np.zeros((params.total_reps, 32), dtype=np.uint8)
    io_ = ip = 0
    for i in range(params.total_reps):
        if i in open_map:
            ordered[i] = hashes_online[io_]
            io_ += 1
        else:
            ordered[i] = hashes_pre[ip]
            ip += 1
    return blake3(ordered.tobytes()) == comm


def check_formats(proof: Proof, params: ProtocolParams) -> bool:
    """Both domains' openings have the shapes params asks for."""
    return all(single.check_format(params.online_reps, params.preprocessing_reps)
               for single in (proof.gf2, proof.z64))


def opened_keys(openings: List[OpenOnline]) -> np.ndarray:
    """(n, 8, 16) uint8 player keys of online openings."""
    return np.stack([np.frombuffer(o.seeds, dtype=np.uint8).reshape(8, KEY_SIZE)
                     for o in openings])


def preprocessing_seeds(openings: List[OpenPreprocessing]) -> np.ndarray:
    """(n, 16) uint8 rep seeds of preprocessing openings."""
    return np.stack([np.frombuffer(p.seed, dtype=np.uint8) for p in openings])


def committed_hashes(openings: List[OpenPreprocessing]) -> np.ndarray:
    """(n, 32) uint8 online commitments of preprocessing openings."""
    return np.stack([np.frombuffer(p.comm_online, dtype=np.uint8) for p in openings])


def witness_columns(wit_gf2, wit_z64, n_wit2: int, n_witz: int, which) -> tuple:
    """A statement's witnesses as (n_wit2,) uint8 and (n_witz,) int64, cut
    to the circuit's inputs; AssertionError when one is too short."""
    w2 = np.asarray([1 if b else 0 for b in wit_gf2], dtype=np.uint8)
    wz = np.asarray([int(v) & 0xFFFF_FFFF_FFFF_FFFF for v in wit_z64],
                    dtype=np.uint64).view(np.int64)
    if len(w2) < n_wit2 or len(wz) < n_witz:
        raise AssertionError(f"witness {which} is too short")
    return w2[:n_wit2], wz[:n_witz]


# ---------------------------------------------------------------------------
# The proof system
# ---------------------------------------------------------------------------


def check_program(program: Sequence[CombineOp]) -> None:
    """Raise TypeError unless every op is one of the port's own circuit
    objects.  reverie_tpu's classes are distinct (IntEnum comparison would
    make them appear to work): a program built there crosses over as
    bincode, `circuit.load_program(reverie_tpu.circuit.dumps_program(p))`."""
    for op in program:
        gate = getattr(op, "gate", None)
        if not (isinstance(op, CombineOp) and type(op.kind) is Kind
                and (gate is None or (isinstance(gate, Gate) and type(gate.op) is Op))):
            raise TypeError(
                f"TorchKKW takes reverie_tpu_torch.circuit ops, not {type(op).__module__}."
                f"{type(op).__name__}; carry the program over as bincode bytes "
                "(reverie_tpu_torch.circuit.load_program)")


class TorchKKW:
    """Compile a circuit once; prove and verify on one device.

    The positional arguments are TpuKKW's, in its order, less its
    `cache_key` (the port keeps no compile cache); `device` is keyword-only.
    `device` defaults to the CUDA device (raising without one); the CPU
    device runs the kernels' plain PyTorch versions.  `params` sets the
    repetitions (a proof's lanes are params.total_reps); `cc`, the
    program's compiled circuit where the caller has it already
    (make_system), is used as is.

    Entry points: `prove` and `verify` (one proof); `prove_batch` (N proofs
    as one device batch of N * 256 lanes); `prove_batch_chunked` (that
    batch in chunks, pipelined); `prove_many` (one proof after another,
    pipelined); `verify_many` (pipelined verification).  Each proof is
    byte-equal to `prove`'s with the same seeds, and each verdict equal to
    `verify`'s.

    After each call, `last_timings` holds that call's PhaseTimer report:
    one row per phase after `prove`, `verify` and `prove_batch`; one row
    per phase and chunk or proof, "<phase>[<i>]", after
    `prove_batch_chunked`, `prove_many` and `verify_many` of more than one
    chunk or proof."""

    def __init__(self, program: Sequence[CombineOp],
                 params: ProtocolParams = DEFAULT_PARAMS, mesh=None,
                 cc: Optional[CompiledCircuit] = None, *,
                 device: Optional[torch.device] = None):
        if mesh is not None:
            raise NotImplementedError(
                "TorchKKW runs on one device; sharding over several is "
                "ROADMAP Queue 1 item 12")
        check_program(program)
        self.device = default_device() if device is None else torch.device(device)
        self.params = params
        self.cc = compile_program(program) if cc is None else cc
        self._executors: Dict[tuple, object] = {}
        self.last_timings: Dict[str, dict] = {}

    def _executor(self, mode: int, R: int):
        """The executor of one role at R lanes, built once: the wave
        executor (scan.ScanExecutor) for circuits deeper than
        SCAN_DEPTH_THRESHOLD levels, the levelized Executor otherwise
        (uses_waves).  Every entry point takes its executors here."""
        key = (mode, R)
        if key not in self._executors:
            make = scan.ScanExecutor if uses_waves(self.cc) else Executor
            self._executors[key] = make(self.cc, mode, R, self.device)
        return self._executors[key]

    def _omit_tensor(self, omit: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        if omit is None:
            return None
        return torch.as_tensor(np.asarray(omit).astype(np.uint8), device=self.device)

    def _gf2_tape(self, player_keys: np.ndarray,
                  omit: Optional[np.ndarray] = None) -> torch.Tensor:
        """(R, 8, 16) player keys -> (m2, R) uint8 mask tape on the device
        (the AES tape kernel on CUDA, whatever the size)."""
        rk = aes_tape.round_keys(player_keys, self.device)
        return aes_tape.aes_ctr_tape_gf2(rk, self.cc.m2, self._omit_tensor(omit))

    def _z64_tape(self, player_keys: np.ndarray,
                  omit: Optional[np.ndarray] = None) -> torch.Tensor:
        """(R, 8, 16) player keys -> (mz, 8, R) int64 z64 mask tape on the
        device (the z64 tape kernel on CUDA, whatever the size)."""
        rk = aes_tape.round_keys(player_keys, self.device)
        return aes_tape_z64.aes_ctr_tape_z64(rk, self.cc.mz, self._omit_tensor(omit))

    def _hash_fn(self, out: Dict[str, torch.Tensor],
                 comm2: Optional[torch.Tensor] = None,
                 commz: Optional[torch.Tensor] = None):
        """Per-rep combined hashes H(H(pre2 || onl2) || H(prez || onlz))
        of an executor's four streams (transcript/mod.rs:77-96 +
        combine.rs:104-118) -> (rep_h, ho2, hoz), each (R, 32).  With
        comm2/commz the online hashes are the committed values (preprocess
        verification, verifier/preprocess.rs:55-57)."""
        cc = self.cc
        hp2 = b3.hash_columns(out["pre2"], cc.pre2)
        hpz = b3.hash_columns(out["prez"], cc.prez)
        if comm2 is None:
            ho2 = b3.hash_columns(out["onl2"], cc.onl2)
            hoz = b3.hash_columns(out["onlz"], cc.onlz)
        else:
            ho2, hoz = comm2, commz
        h2 = b3.hash_pair_columns(hp2, ho2)
        hz = b3.hash_pair_columns(hpz, hoz)
        return b3.hash_pair_columns(h2, hz), ho2, hoz

    # -- proving ------------------------------------------------------------
    def prove(self, wit_gf2, wit_z64, seeds: Optional[np.ndarray] = None) -> Proof:
        """`seeds` (total_reps, 16) makes the proof deterministic."""
        return self.prove_batch([(wit_gf2, wit_z64)], seeds)[0]

    def prove_batch(self, witnesses, seeds: Optional[np.ndarray] = None) -> List[Proof]:
        """Prove N statements of this circuit in one device batch.
        `witnesses`: [(wit_gf2, wit_z64)] * N; `seeds`: (N, total_reps, 16)
        makes the proofs deterministic.  The N * 256 repetitions are one
        lane axis, proof-major (lane p * 256 + r is rep r of proof p): one
        tape per domain, one executor run and one hash of every stream; the
        challenges are per proof on the host, and one extraction gathers all
        N * 40 opened lanes.  Peak device memory is about
        device_footprint(cc, N * 256)."""
        return self._prove_pipeline(witnesses, seeds, max(len(witnesses), 1))

    def prove_batch_chunked(self, witnesses, seeds: Optional[np.ndarray] = None,
                            chunk: int = 64) -> List[Proof]:
        """prove_batch in chunks of `chunk` statements, software-pipelined:
        the device runs chunk i + 1 while chunk i's challenge, pulls and
        assembly run on the host.  Peak device memory is about
        pipeline_footprint(cc, chunk * 256), since chunk i's streams stay
        live (awaiting its challenge and extraction) while chunk i + 1 runs:
        largest_batch gives the most `chunk` that fits the card."""
        if chunk < 1:
            raise ValueError("prove_batch_chunked: chunk must be at least 1")
        return self._prove_pipeline(witnesses, seeds, chunk)

    def prove_many(self, jobs, seeds: Optional[np.ndarray] = None) -> List[Proof]:
        """Prove statements one after another, software-pipelined: proof
        i + 1's device work is queued before proof i's challenge, pulls and
        assembly run on the host.  `jobs`: [(wit_gf2, wit_z64)] * N;
        `seeds`: (N, total_reps, 16).  While the BLAKE3 tail keeps the host
        busy launching kernels there is little device work to overlap: on
        an H100 this ran within the run-to-run spread of N prove() calls
        (PERF.md §5); prove_batch is the faster way to prove many
        statements of one circuit."""
        return self._prove_pipeline(jobs, seeds, 1)

    def _prove_pipeline(self, witnesses, seeds, width: int) -> List[Proof]:
        """Prove in groups of `width` statements through the three-stage
        pipeline: dispatch group g, then the challenge of group g - 1, then
        the assembly of group g - 2.  A group's state goes once its proofs
        are assembled."""
        n = len(witnesses)
        seeds = _seeds(seeds, n, self.params.total_reps)
        bounds = [(lo, min(lo + width, n)) for lo in range(0, n, width)]
        k = len(bounds)
        timer = PhaseTimer(self.device)
        states: List[Optional[dict]] = [None] * k
        proofs: List[Proof] = []
        for g, (lo, hi) in enumerate(bounds):
            states[g] = self._prove_dispatch(witnesses[lo:hi], seeds[lo:hi], lo, timer,
                                             "" if k == 1 else f"[{g}]")
            if g >= 1:
                self._prove_challenge(states[g - 1])
            if g >= 2:
                proofs += self._prove_assemble(states[g - 2])
                states[g - 2] = None
        if k:
            self._prove_challenge(states[k - 1])
        for g in range(max(k - 2, 0), k):
            proofs += self._prove_assemble(states[g])
            states[g] = None
        self.last_timings = timer.report()
        return proofs

    def _prove_dispatch(self, witnesses, seeds: np.ndarray, first: int,
                        timer: PhaseTimer, tag: str) -> dict:
        """Pipeline stage 1 for N statements (the first numbered `first`):
        seed expansion, both tapes, the executor and the transcript hashes
        on N * 256 lanes, then the asynchronous pull of the rep hashes and
        fail flags."""
        cc, dev = self.cc, self.device
        N, R = len(witnesses), self.params.total_reps
        wit2 = np.zeros((cc.n_wit2, N), dtype=np.uint8)
        witz = np.zeros((cc.n_witz, N), dtype=np.int64)
        for p, (wit_gf2, wit_z64) in enumerate(witnesses):
            wit2[:, p], witz[:, p] = witness_columns(wit_gf2, wit_z64, cc.n_wit2, cc.n_witz,
                                                     first + p)
        with timer.phase("expand_seeds" + tag):
            player_keys = expand_seeds(seeds.reshape(N * R, KEY_SIZE)).reshape(
                N * R, 8, KEY_SIZE)
        with timer.phase("tape_gf2" + tag):
            tape = self._gf2_tape(player_keys)
        with timer.phase("tape_z64" + tag):
            tapez = self._z64_tape(player_keys)
        with timer.phase("execute" + tag):
            # one witness column uploaded per proof, repeated over its 256
            # lanes on the device
            inp = {"tape": tape, "tapez": tapez,
                   "wit2": torch.from_numpy(wit2).to(dev).repeat_interleave(R, dim=1),
                   "witz": torch.from_numpy(witz).to(dev).repeat_interleave(R, dim=1)}
            del tape, tapez  # the tapes go with the executor's inputs
            out = self._executor(PROVER, N * R)(inp)
            del inp
        with timer.phase("hash" + tag):
            rep_h, ho2, hoz = self._hash_fn(out)
            pull = _Pull(torch.cat([rep_h.reshape(-1), ho2.reshape(-1), hoz.reshape(-1),
                                    out["fail"].to(torch.uint8)]))
        return dict(N=N, first=first, seeds=seeds, player_keys=player_keys, out=out,
                    pull=pull, timer=timer, tag=tag)

    def _prove_challenge(self, st: dict) -> None:
        """Pipeline stage 2: wait for the hash pull; per statement, the
        commitment and the Fiat-Shamir challenge on the host (raising
        before any extraction if a witness failed an AssertZero); then one
        extraction of all opened lanes and its asynchronous pull."""
        N, R = st["N"], self.params.total_reps
        RT = N * R
        with st["timer"].phase("challenge" + st["tag"]):
            buf = st.pop("pull").numpy()
            rep_h = buf[: RT * 32].reshape(N, R, 32)
            st["ho2"] = buf[RT * 32 : 2 * RT * 32].reshape(N, R, 32)
            st["hoz"] = buf[2 * RT * 32 : 3 * RT * 32].reshape(N, R, 32)
            failed = buf[3 * RT * 32 :].reshape(N, R).any(axis=1)
            if failed.any():
                raise AssertionError(f"witness {st['first'] + int(np.argmax(failed))} "
                                     "is invalid (AssertZero failed)")
            comms = [blake3(rep_h[p].tobytes()) for p in range(N)]
            omits = np.stack([challenge_omits(c, self.params) for c in comms])
            omit = omits.reshape(RT)
            cols = np.nonzero(omit < 8)[0]
            out = st.pop("out")
            g2 = extract_gf2(self.cc, out["onl2"], out["pre2"], cols, omit[cols])
            gz = extract_z64(self.cc, out["onlz"], out["prez"], cols, omit[cols])
            del out
            # one flat buffer, pulled once: [gf2 openings | z64 openings]
            st["xpull"], st["n_g2"] = _Pull(torch.cat([g2, gz])), g2.numel()
        st.update(comms=comms, omits=omits, K=len(cols))

    def _parse_gf2_buf(self, buf: np.ndarray, K: int):
        """Pulled GF(2) extraction buffer -> per-rep (recons, corrs,
        inputs)."""
        cc = self.cc
        nb_r, nb_c, nb_i = (packed_len(n) for n in (cc.n_recons2, cc.n_corrs2, cc.n_inputs2))
        rec = buf[: K * nb_r].reshape(K, nb_r)
        cor = buf[K * nb_r : K * (nb_r + nb_c)].reshape(K, nb_c)
        inp = buf[K * (nb_r + nb_c) :].reshape(K, nb_i)
        return [(rec[j].tobytes(), cor[j].tobytes(), inp[j].tobytes())
                for j in range(K)]

    def _parse_z64_buf(self, buf: np.ndarray, K: int):
        """Pulled z64 extraction buffer -> per-rep (recons, corrs, inputs),
        8 bytes per event."""
        cc = self.cc
        nr, nc = len(cc.recon_slotsz), len(cc.corr_slotsz)
        ni = len(cc.input_slotsz)
        o1, o2 = K * nr * 8, K * (nr + nc) * 8
        rec = buf[:o1].reshape(K, nr * 8)
        cor = buf[o1:o2].reshape(K, nc * 8)
        inp = buf[o2:].reshape(K, ni * 8)
        return [(rec[j].tobytes(), cor[j].tobytes(), inp[j].tobytes())
                for j in range(K)]

    def _prove_assemble(self, st: dict) -> List[Proof]:
        """Pipeline stage 3: wait for the openings' pull and assemble the N
        proofs; the opened lanes come in lane order, proof by proof."""
        R, K = self.params.total_reps, st["K"]
        with st["timer"].phase("extract_pull" + st["tag"]):
            buf = st["xpull"].numpy()
            open2 = self._parse_gf2_buf(buf[: st["n_g2"]], K)
            openz = self._parse_z64_buf(buf[st["n_g2"] :], K)
            proofs, j = [], 0
            for p in range(st["N"]):
                omit = st["omits"][p]
                k = int((omit < 8).sum())
                proofs.append(assemble_proof(
                    st["comms"][p], st["seeds"][p], st["player_keys"][p * R : (p + 1) * R],
                    omit, st["ho2"][p], st["hoz"][p], open2[j : j + k], openz[j : j + k]))
                j += k
        return proofs

    # -- verification -------------------------------------------------------
    def verify(self, proof: Proof, strict_zero_check: bool = True) -> bool:
        return self.verify_many([proof], strict_zero_check)[0]

    def verify_many(self, proofs: Sequence[Proof],
                    strict_zero_check: bool = True) -> List[bool]:
        """Verify a stream of proofs, software-pipelined: proof i + 1's
        injection and uploads overlap proof i's device work and pulls.
        Returns the verdicts in order, each equal to `verify`'s; a
        malformed proof gives False in its place."""
        timer = PhaseTimer(self.device)
        results: List[bool] = []
        prev = None
        for i, proof in enumerate(proofs):
            st = self._verify_dispatch(proof, timer, "" if len(proofs) == 1 else f"[{i}]")
            if i >= 1:
                results.append(prev is not False and self._verify_finish(prev, strict_zero_check))
            prev = st
        if proofs:
            results.append(prev is not False and self._verify_finish(prev, strict_zero_check))
        self.last_timings = timer.report()
        return results

    def _verify_dispatch(self, proof: Proof, timer: PhaseTimer, tag: str):
        """Both re-executions (online, preprocessing), their hashes and
        the asynchronous pulls of those; False for a malformed proof."""
        cc, dev = self.cc, self.device
        if not check_formats(proof, self.params):
            return False

        # ---- online re-execution (the opened reps as one batch) -----------
        Ro = self.params.online_reps
        with timer.phase("onl_inject" + tag):
            streams = online_streams(proof.gf2.online, proof.z64.online, cc)
            inj, omit, omitz = online_inputs(streams, cc, dev), streams["omit"], streams["omitz"]
            del streams
            player_keys = opened_keys(proof.gf2.online)
            player_keysz = opened_keys(proof.z64.online)
        with timer.phase("onl_tape" + tag):
            tape = self._gf2_tape(player_keys, omit)
            tapez = self._z64_tape(player_keysz, omitz)
            if os.environ.get("REVERIE_DEBUG"):
                _check_omitted_lanes(tape, tapez, omit, omitz)
        with timer.phase("onl_exec" + tag):
            out = self._executor(VERIFY_ONL, Ro)({"tape": tape, "tapez": tapez, **inj})
            del tape, tapez, inj
        with timer.phase("onl_hash" + tag):
            rep_h, _, _ = self._hash_fn(out)
            # pulled under the preprocessing leg's device work
            pull_onl = _Pull(torch.cat([rep_h.reshape(-1), out["fail"].to(torch.uint8)]))
            del out

        # ---- preprocessing re-execution -----------------------------------
        Rp = self.params.preprocessing_reps

        def comms(openings):
            return torch.from_numpy(committed_hashes(openings)).to(dev)

        with timer.phase("pre_tape" + tag):
            pk2 = expand_seeds(preprocessing_seeds(proof.gf2.preprocessing)).reshape(
                Rp, 8, KEY_SIZE)
            pkz = expand_seeds(preprocessing_seeds(proof.z64.preprocessing)).reshape(
                Rp, 8, KEY_SIZE)
            tape = self._gf2_tape(pk2)
            tapez = self._z64_tape(pkz)
        with timer.phase("pre_exec" + tag):
            out = self._executor(VERIFY_PRE, Rp)({"tape": tape, "tapez": tapez})
            del tape, tapez
        with timer.phase("pre_hash" + tag):
            rep_h, _, _ = self._hash_fn(out, comms(proof.gf2.preprocessing),
                                        comms(proof.z64.preprocessing))
            pull_pre = _Pull(rep_h)
        return dict(pull_onl=pull_onl, pull_pre=pull_pre, comm=proof.comm,
                    timer=timer, tag=tag)

    def _verify_finish(self, st: dict, strict_zero_check: bool = True) -> bool:
        """Wait for the hash pulls, reorder the rep hashes per the
        challenge and compare the commitment."""
        Ro = self.params.online_reps
        with st["timer"].phase("finish" + st["tag"]):
            buf = st["pull_onl"].numpy()
            hashes_online = buf[: Ro * 32].reshape(Ro, 32)
            if strict_zero_check and buf[Ro * 32 :].any():
                return False
            return commitment_ok(st["comm"], hashes_online, st["pull_pre"].numpy(),
                                 self.params)
