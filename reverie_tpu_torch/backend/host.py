"""Host orchestration of the prove / verify path on one device.

Port of reverie_tpu/backend/tpu_host.py's `TpuKKW` (`_gf2_tape`,
`_z64_tape`, `_hash_fn`, `prove`, `_prove_dispatch`, `_prove_challenge`,
`_prove_assemble`, `_extract_gf2_dispatch`, `_extract_z64_dispatch`,
`_parse_gf2_buf`, `_parse_z64_buf`, `verify`, `_verify_dispatch`,
`_verify_finish`) and of its helpers `make_gf2_extractor` and
`make_z64_extractor` in their gather forms, `_pack_rows_device`,
`_stack_streams`, `_u64s_from_stream`, `build_online_injection_packed` and
`make_online_unpacker`, for circuits over GF(2), Z_2^64 and B2A bridges.

The device runs the mask tapes (CUDA kernels), the levelized executor, the
transcript hashes (CUDA chunk kernel + torch tail), and the extraction of
the opened repetitions.  The host runs seed expansion, the Fiat-Shamir
challenge, the blake3 of the rep hashes and proof assembly, as in the
reference.
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
from ..params import DEFAULT_PARAMS as PARAMS, KEY_SIZE
from ..proof.challenge import challenge_to_opening
from ..proof.container import (
    OpenOnline,
    OpenPreprocessing,
    Proof,
    ProofSingle,
)
from ..device import default_device
from .executor import (
    PROVER,
    VERIFY_ONL,
    VERIFY_PRE,
    Executor,
    _classify,
    event_rows,
    take,
)


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters, by kernel."""
    return {"aes_tape_gf2": aes_tape.LAUNCHES, "aes_tape_z64": aes_tape_z64.LAUNCHES,
            "blake3_chunk_cvs": b3.LAUNCHES}


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


def _pack_rows_device(bits: torch.Tensor) -> torch.Tensor:
    """(N, K) 0/1 uint8 -> (N//8 + 1, K) packed bytes, MSB first, with the
    reference's always-emitted remainder byte (gf2/recon.rs:218-237)."""
    N, K = bits.shape
    n_chunks = N // 8 + 1
    padded = torch.zeros((n_chunks * 8, K), dtype=torch.uint8, device=bits.device)
    padded[:N] = bits
    w = torch.tensor([128 >> j for j in range(8)], dtype=torch.uint8,
                     device=bits.device)
    return (padded.view(n_chunks, 8, K) * w[None, :, None]).sum(dim=1).to(torch.uint8)


def extract_gf2(cc: CompiledCircuit, onl2: torch.Tensor, pre2: torch.Tensor,
                cols: np.ndarray, omit_sel: np.ndarray) -> torch.Tensor:
    """Opened columns -> one flat uint8 buffer [recons | corrs | inputs],
    each (K, n//8 + 1) row-major (make_gf2_extractor, gather form)."""
    dev = onl2.device
    cols_t = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
    shifts = torch.as_tensor((7 - np.asarray(omit_sel)).astype(np.uint8), device=dev)
    onl_sel = onl2.index_select(1, cols_t)  # (n_onl, K)
    pre_sel = pre2.index_select(1, cols_t)
    rec = (_take_rows(onl_sel, cc.recon_slots2) >> shifts[None, :]) & 1
    cor = _take_rows(pre_sel, cc.corr_slots2) & 1
    inp = _take_rows(onl_sel, cc.input_slots2) & 1
    return torch.cat([_pack_rows_device(b).t().reshape(-1) for b in (rec, cor, inp)])


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


def online_injection(cc: CompiledCircuit, openings2: List[OpenOnline],
                     openingsz: List[OpenOnline], device: torch.device):
    """Online openings -> (VERIFY_ONL inputs on device, GF(2) omit (R,),
    z64 omit (R,)).  The packed GF(2) streams go to the device and are
    unpacked there; the z64 streams are parsed into words on the host, and
    the recon words become one-hot shares at the omitted player on the
    device (build_online_injection_packed + make_online_unpacker).  The two
    domains carry their own omits: a malformed proof can make them
    differ."""
    omit = np.array([o.omit for o in openings2], dtype=np.int64)
    omitz = np.array([o.omit for o in openingsz], dtype=np.int64)

    def bits(streams, n):
        packed = _stack_streams(streams, n // 8 + 1)
        return _unpack_bits(torch.from_numpy(packed).to(device), n)

    def words(streams, n):
        return torch.from_numpy(np.stack(
            [_u64s_from_stream(st, n) for st in streams], axis=1)).to(device)

    shift = torch.as_tensor((7 - omit).astype(np.uint8), device=device)
    onehot = (torch.arange(8, device=device)[:, None]
              == torch.as_tensor(omitz, device=device)[None, :]).to(torch.int64)
    inj = dict(
        co2=bits([o.corrs for o in openings2], cc.n_corrs2),
        in2=bits([o.inputs for o in openings2], cc.n_inputs2),
        re2=bits([o.recons for o in openings2], cc.n_recons2) << shift[None, :],
        coz=words([o.corrs for o in openingsz], cc.n_corrsz),
        inz=words([o.inputs for o in openingsz], cc.n_inputsz),
        rez=words([o.recons for o in openingsz], cc.n_reconsz)[:, None, :] * onehot,
    )
    return inj, omit, omitz


# ---------------------------------------------------------------------------
# The proof system
# ---------------------------------------------------------------------------


def _not_ported(name: str, item: int):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"TorchKKW.{name} is not ported yet (ROADMAP Queue 1 item {item})")
    method.__name__ = name
    return method


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

    `device` defaults to the CUDA device (raising without one); the CPU
    device runs the kernels' plain PyTorch versions.  After each prove or
    verify, `last_timings` holds the PhaseTimer report of that call."""

    prove_many = _not_ported("prove_many", 8)
    prove_batch = _not_ported("prove_batch", 8)
    prove_batch_chunked = _not_ported("prove_batch_chunked", 8)
    verify_many = _not_ported("verify_many", 8)

    def __init__(self, program: Sequence[CombineOp],
                 device: Optional[torch.device] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "TorchKKW runs on one device; sharding over several is "
                "ROADMAP Queue 1 item 12")
        check_program(program)
        self.device = default_device() if device is None else torch.device(device)
        self.cc = compile_program(program)
        self._executors: Dict[tuple, Executor] = {}
        self.last_timings: Dict[str, dict] = {}

    def _executor(self, mode: int, R: int) -> Executor:
        key = (mode, R)
        if key not in self._executors:
            self._executors[key] = Executor(self.cc, mode, R, self.device)
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
        timer = PhaseTimer(self.device)
        st = self._prove_dispatch(wit_gf2, wit_z64, seeds, timer)
        with timer.phase("challenge"):
            self._prove_challenge(st)
        with timer.phase("extract_pull"):
            proof = self._prove_assemble(st)
        self.last_timings = timer.report()
        return proof

    def _prove_dispatch(self, wit_gf2, wit_z64, seeds, timer: PhaseTimer) -> dict:
        cc, dev = self.cc, self.device
        R = PARAMS.total_reps
        if seeds is None:
            seeds = np.frombuffer(os.urandom(R * KEY_SIZE), dtype=np.uint8)
        seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(R, KEY_SIZE)
        wit2 = np.asarray([1 if b else 0 for b in wit_gf2], dtype=np.uint8)
        witz = np.asarray([int(v) & 0xFFFF_FFFF_FFFF_FFFF for v in wit_z64],
                          dtype=np.uint64).view(np.int64)
        if len(wit2) < cc.n_wit2 or len(witz) < cc.n_witz:
            raise AssertionError("witness is too short")
        with timer.phase("expand_seeds"):
            player_keys = expand_seeds(seeds).reshape(R, 8, KEY_SIZE)
        with timer.phase("tape_gf2"):
            tape = self._gf2_tape(player_keys)
        with timer.phase("tape_z64"):
            tapez = self._z64_tape(player_keys)
        with timer.phase("execute"):
            # one witness column uploaded per domain; broadcast to R on device
            w2 = torch.from_numpy(wit2[: cc.n_wit2]).to(dev)
            wz = torch.from_numpy(witz[: cc.n_witz]).to(dev)
            out = self._executor(PROVER, R)(
                {"tape": tape, "tapez": tapez,
                 "wit2": w2[:, None].expand(cc.n_wit2, R),
                 "witz": wz[:, None].expand(cc.n_witz, R)})
        with timer.phase("hash"):
            rep_h, ho2, hoz = self._hash_fn(out)
            # one device -> host pull: hashes + per-rep fail flags
            dbuf = torch.cat([rep_h.reshape(-1), ho2.reshape(-1), hoz.reshape(-1),
                              out["fail"].to(torch.uint8)]).cpu().numpy()
        return dict(seeds=seeds, player_keys=player_keys, out=out, dbuf=dbuf)

    def _prove_challenge(self, st: dict) -> None:
        R = PARAMS.total_reps
        buf = st.pop("dbuf")
        rep_h = buf[: R * 32].reshape(R, 32)
        st["ho2"] = buf[R * 32 : 2 * R * 32].reshape(R, 32)
        st["hoz"] = buf[2 * R * 32 : 3 * R * 32].reshape(R, 32)
        if buf[3 * R * 32 :].any():
            raise AssertionError("witness is invalid (AssertZero failed)")
        comm = blake3(rep_h.tobytes())
        open_map = challenge_to_opening(comm, PARAMS)
        omit = np.full(R, 8, dtype=np.int64)
        for rep, p in open_map.items():
            omit[rep] = p
        cols = np.nonzero(omit < 8)[0]
        out = st.pop("out")
        g2 = extract_gf2(self.cc, out["onl2"], out["pre2"], cols, omit[cols])
        gz = extract_z64(self.cc, out["onlz"], out["prez"], cols, omit[cols])
        # one flat buffer, pulled once: [gf2 openings | z64 openings]
        st["xbuf"], st["n_g2"] = torch.cat([g2, gz]), g2.numel()
        st.update(comm=comm, omit=omit, K=len(cols))

    def _parse_gf2_buf(self, buf: np.ndarray, K: int):
        """Pulled GF(2) extraction buffer -> per-rep (recons, corrs,
        inputs)."""
        cc = self.cc
        nb_r, nb_c = cc.n_recons2 // 8 + 1, cc.n_corrs2 // 8 + 1
        nb_i = cc.n_inputs2 // 8 + 1
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

    def _prove_assemble(self, st: dict) -> Proof:
        R = PARAMS.total_reps
        buf = st["xbuf"].cpu().numpy()
        n_g2 = st["n_g2"]
        open2 = self._parse_gf2_buf(buf[:n_g2], st["K"])
        openz = self._parse_z64_buf(buf[n_g2:], st["K"])
        seeds, player_keys, omit = st["seeds"], st["player_keys"], st["omit"]
        ho2, hoz = st["ho2"], st["hoz"]
        p2 = ProofSingle([], [])
        pz = ProofSingle([], [])
        j = 0
        for r in range(R):
            if omit[r] < 8:
                ks = player_keys[r].copy()
                ks[omit[r]] = 0
                p2.online.append(OpenOnline(int(omit[r]), ks.tobytes(), *open2[j]))
                pz.online.append(OpenOnline(int(omit[r]), ks.tobytes(), *openz[j]))
                j += 1
            else:
                p2.preprocessing.append(
                    OpenPreprocessing(seeds[r].tobytes(), ho2[r].tobytes()))
                pz.preprocessing.append(
                    OpenPreprocessing(seeds[r].tobytes(), hoz[r].tobytes()))
        return Proof(st["comm"], p2, pz)

    # -- verification -------------------------------------------------------
    def verify(self, proof: Proof, strict_zero_check: bool = True) -> bool:
        timer = PhaseTimer(self.device)
        st = self._verify_dispatch(proof, timer)
        ok = st is not False and self._verify_finish(st, strict_zero_check)
        self.last_timings = timer.report()
        return ok

    def _verify_dispatch(self, proof: Proof, timer: PhaseTimer):
        """Both re-executions (online, preprocessing) and their hashes;
        False for a malformed proof."""
        cc, dev = self.cc, self.device
        if not proof.gf2.check_format(PARAMS.online_reps, PARAMS.preprocessing_reps):
            return False
        if not proof.z64.check_format(PARAMS.online_reps, PARAMS.preprocessing_reps):
            return False

        def keys(openings):
            return np.stack([np.frombuffer(o.seeds, dtype=np.uint8).reshape(8, KEY_SIZE)
                             for o in openings])

        # ---- online re-execution (the opened reps as one batch) -----------
        Ro = PARAMS.online_reps
        with timer.phase("onl_inject"):
            inj, omit, omitz = online_injection(cc, proof.gf2.online,
                                                proof.z64.online, dev)
            player_keys, player_keysz = keys(proof.gf2.online), keys(proof.z64.online)
        with timer.phase("onl_tape"):
            tape = self._gf2_tape(player_keys, omit)
            tapez = self._z64_tape(player_keysz, omitz)
        with timer.phase("onl_exec"):
            out = self._executor(VERIFY_ONL, Ro)({"tape": tape, "tapez": tapez, **inj})
        with timer.phase("onl_hash"):
            rep_h, _, _ = self._hash_fn(out)
            dbuf_onl = torch.cat([rep_h.reshape(-1),
                                  out["fail"].to(torch.uint8)]).cpu().numpy()

        # ---- preprocessing re-execution -----------------------------------
        Rp = PARAMS.preprocessing_reps

        def seeds(openings):
            return np.stack([np.frombuffer(p.seed, dtype=np.uint8) for p in openings])

        def comms(openings):
            return torch.from_numpy(np.stack([
                np.frombuffer(p.comm_online, dtype=np.uint8) for p in openings
            ])).to(dev)

        with timer.phase("pre_tape"):
            pk2 = expand_seeds(seeds(proof.gf2.preprocessing)).reshape(Rp, 8, KEY_SIZE)
            pkz = expand_seeds(seeds(proof.z64.preprocessing)).reshape(Rp, 8, KEY_SIZE)
            tape = self._gf2_tape(pk2)
            tapez = self._z64_tape(pkz)
        with timer.phase("pre_exec"):
            out = self._executor(VERIFY_PRE, Rp)({"tape": tape, "tapez": tapez})
        with timer.phase("pre_hash"):
            rep_h, _, _ = self._hash_fn(out, comms(proof.gf2.preprocessing),
                                        comms(proof.z64.preprocessing))
            hashes_pre = rep_h.cpu().numpy()
        return dict(dbuf_onl=dbuf_onl, hashes_pre=hashes_pre, comm=proof.comm)

    def _verify_finish(self, st: dict, strict_zero_check: bool = True) -> bool:
        """Reorder the rep hashes per the challenge and compare the
        commitment."""
        Ro = PARAMS.online_reps
        buf = st["dbuf_onl"]
        hashes_online = buf[: Ro * 32].reshape(Ro, 32)
        if strict_zero_check and buf[Ro * 32 :].any():
            return False
        hashes_pre = st["hashes_pre"]
        open_map = challenge_to_opening(st["comm"], PARAMS)
        ordered = np.zeros((PARAMS.total_reps, 32), dtype=np.uint8)
        io_ = ip = 0
        for i in range(PARAMS.total_reps):
            if i in open_map:
                ordered[i] = hashes_online[io_]
                io_ += 1
            else:
                ordered[i] = hashes_pre[ip]
                ip += 1
        return blake3(ordered.tobytes()) == st["comm"]
