"""Streaming segmented prover and verifier: O(segment) device memory.

Port of reverie_tpu/backend/streaming.py (`StreamingKKW`, :115-834).
`TorchKKW` holds the whole arena, the four transcript streams and both
tapes of a circuit on the device; here the program is cut into segments
(circuit/compile.py `compile_segments`) and proved in two passes:

  pass 1: each segment in order makes its GF(2) and z64 tape windows (the
    tape kernels at the window's first counter block), runs its executor
    with the rows carried in from the segments before, and absorbs its
    stream bytes into one incremental per-rep BLAKE3 state per stream
    (crypto/kernels/blake3.py `ColumnHasher`: the chunk kernel at the
    stream's chunk base); the streams are then dropped.  The finalized
    hashes give the commitment and the Fiat-Shamir challenge, equal to
    unsegmented proving.
  pass 2: the segments run again, each extracting the opened reps'
    recon, correction and input records (host.extract_gf2 /
    host.extract_z64 on its own compiled circuit), pulled asynchronously
    and placed at the segment's record bases on the host as they arrive:
    the GF(2) records packed on the device at the segment's bit offset
    and ORed into the packed host rows, the z64 bytes copied into theirs,
    each pull freed once placed; the proof is assembled from those rows.

Verification runs its online leg (the opened reps) and its preprocessing
leg (the others) segment by segment in the same way; the proof's online
streams stay on the host, rep-major, and each segment copies only its
window of them (a column range) to the device, where it is turned to
(record, rep) (host.online_inputs; a GF(2) window starts at a bit
offset).  Every proof is byte-equal to `TorchKKW`'s with the same seeds,
every verdict equal to its verdict.

A segment deeper than SCAN_DEPTH_THRESHOLD levels runs on the wave
executor (scan.ScanExecutor: W1 or W2 with carries), the others on the
levelized `Executor`, as `TorchKKW` routes a whole circuit (host.uses_waves,
read at each call).  A segment's executor is built when the segment runs
and dropped after it, its index or wave tables with it (what is costly to
derive, the wave slots and plans, stays cached on the segment's compiled
circuit, on the host).  So what the device holds is O(segment): one
segment's tapes, executor and streams, the carries a later segment reads,
and the four streams' hash states, which hold one segment's stream bytes
of CVs at most.

On a mesh (reverie_tpu_torch.parallel) each segment runs on every shard
before the next, each shard over its slice of the lanes with its own
carries and hash states; the hashes and each segment's opened records
meet in host memory in lane order (host.Lanes), as in `TorchKKW`.
"""

from __future__ import annotations

import collections
import os
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..circuit.compile import Segment, compile_segments
from ..circuit.compile_native import SegmentCompiler
from ..crypto import blake3, expand_seeds
from ..crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3
from ..params import DEFAULT_PARAMS, KEY_SIZE, ProtocolParams
from ..proof.container import Proof
from . import host, profiling, scan
from .executor import PROVER, VERIFY_ONL, VERIFY_PRE, Executor, stream_bytes

#: z64 tape words a 1 KiB keystream refill holds, and its AES counter blocks
Z64_REFILL_WORDS, Z64_REFILL_BLOCKS = 128, 64

STREAMS = ("onl2", "pre2", "onlz", "prez")
_CARRIES = (("carry_mask2", "carry_corr2"), ("carry_maskz", "carry_corrz"))
#: the totals over the segments that the streaming prover reads
_TOTALS = ("n_wit2", "n_witz", *STREAMS, "n_recons2", "n_corrs2", "n_inputs2",
           "n_reconsz", "n_corrsz", "n_inputsz")


def _absorb(hashers: Dict[str, b3.ColumnHasher], cc, out: Dict[str, torch.Tensor]) -> None:
    for name, h in hashers.items():
        h.absorb(out[name][: getattr(cc, name)])


def _rep_hashes(hashers: Dict[str, b3.ColumnHasher], comm2=None, commz=None):
    """(rep hashes, ho2, hoz), each (R, 32): H(H(pre2 || onl2) || H(prez ||
    onlz)) of the finalized streams (host.TorchKKW._hash_fn), one launch
    of the tail kernel on CUDA (blake3.hash_leg); with comm2 / commz the
    online hashes are the committed values."""
    def tail(name, given=None):
        return hashers[name].tail() if given is None else given

    return b3.hash_leg(tail("pre2"), tail("onl2", comm2), tail("prez"), tail("onlz", commz),
                       hashers["pre2"].max_pairs)


def _column(w: np.ndarray, R: int, device) -> torch.Tensor:
    """A witness column (n,) repeated over R lanes on the device."""
    t = torch.from_numpy(np.ascontiguousarray(w)).to(device)
    return t[:, None].expand(t.shape[0], R).contiguous()


def sized_segments(program, target: float, per_op: float, R: int
                   ) -> Tuple[List[Segment], int]:
    """(compile_segments with each segment sized by the one before it, the
    most ops a segment took): the first takes half of target / per_op ops
    (per_op: an estimate of the circuit's device bytes an op at R lanes;
    half, as a bound from below may be under a segment's rate), each next
    one the ops that fill `target` bytes at the rate of the last one's
    device_footprint at R.  Each op is compiled once
    (compile_native.SegmentCompiler)."""
    sc = SegmentCompiler(program)
    n, k, most = sc.ops.n, max(1, int(target / max(per_op, 1e-9) / 2)), 1
    while sc.lo < n:
        lo = sc.lo
        seg = sc.add(min(n, lo + k))
        most = max(most, sc.lo - lo)
        k = max(1, int((sc.lo - lo) * target / max(host.device_footprint(seg.cc, R), 1)))
    return sc.finish(), most


class StreamingKKW:
    """Prove and verify one circuit segment by segment, in segments of at
    most `seg_ops` ops, on one device (the CUDA device unless the
    keyword-only `device` says otherwise; the CPU runs the kernels' plain
    versions) or on the shards of a `mesh` (reverie_tpu_torch.parallel),
    each running every segment on its slice of the lanes with its own
    carries and hash states; the positional arguments are reverie_tpu's
    StreamingKKW's (no `cache_key`: it compiles segments, never the whole
    program).  `program` is a list of the port's op objects or a program's
    OpArrays (circuit.bincode.load_program_arrays).  `segments`, keyword-only, are the program's compiled
    segments where the caller has them (make_system), used as they are.  Proof bytes equal `TorchKKW.prove`'s with the same
    seeds, verdicts its verify's.  After each call `last_timings` holds its
    PhaseTimer report: pass1, hash_final, challenge, pass2, pack after
    `prove`; onl_inject, onl_exec, onl_hash, pre_tape, pre_exec, pre_hash
    after `verify`.  Each row (host.PhaseTimer.report): host_ms, device_ms
    (stream time between two CUDA events; None off CUDA), launches,
    h2d_bytes and h2d_pinned_bytes (onl_exec's: the online windows, copied
    from pageable memory), start_ns and end_ns on the profiler's clock
    (Unix ns), its child spans [[name, start_ns, end_ns]] (each blocking
    wait on a pull "wait"; onl_inject's "parse" and "round_keys",
    pre_tape's "expand_seeds" and "round_keys") and wait_ms, the sum of
    the "wait" ones."""

    def __init__(self, program, seg_ops: int,
                 params: ProtocolParams = DEFAULT_PARAMS, mesh=None, *,
                 device: Optional[torch.device] = None,
                 segments: Optional[List[Segment]] = None):
        if seg_ops < 1:
            raise ValueError("StreamingKKW: seg_ops must be at least 1")
        self.lanes = host.Lanes(mesh, device)
        self.mesh, self.device = self.lanes.mesh, self.lanes.device
        self.params = params
        #: the most ops a segment holds
        self.seg_ops = seg_ops
        if segments is None:
            host.check_program(program)
            segments = compile_segments(program, seg_ops)
        #: the compiled segments (`segments`, where the caller compiled and
        #: checked them: make_system's sized_segments)
        self.segments = segments
        self.totals = {k: sum(getattr(s.cc, k) for s in self.segments) for k in _TOTALS}
        #: a segment's rows of each stream at most: a stream's hash holds
        #: that many bytes a lane of CVs at most (ColumnHasher's
        #: held_bytes), so the four hold one segment's streams' bytes
        self._seg_rows = {k: max(getattr(s.cc, k) for s in self.segments) for k in STREAMS}
        #: a segment's stream rows at most: an executor holds its streams
        #: three times over (executor.prover_bytes); a hash's tree runs with
        #: no executor alive, beside one segment's streams and the CVs, and
        #: holds twice that much at once
        self._stream_rows = max(stream_bytes(s.cc, 1) for s in self.segments)
        # per segment: the segments whose carry outputs no later one reads
        last = {src: s for s, seg in enumerate(self.segments)
                for src, _ in seg.carry_src + seg.carry_srcz}
        self._done_after: List[List[int]] = [[] for _ in self.segments]
        for src, s in last.items():
            self._done_after[s].append(src)
        self._carry_index: Dict[tuple, tuple] = {}
        self.last_timings: Dict[str, dict] = {}

    def _executor(self, s: int, mode: int, R: int, device: Optional[torch.device] = None):
        """The executor of segment s in one role at R lanes on `device` (by
        default the first), with its carries: the wave executor where the
        segment is deeper than host.SCAN_DEPTH_THRESHOLD levels, the
        levelized one otherwise."""
        seg = self.segments[s]
        make = scan.ScanExecutor if host.uses_waves(seg.cc) else Executor
        return make(seg.cc, mode, R, self.device if device is None else device,
                    carry_in=len(seg.carry_in), carry_out_vals=seg.carry_out_vals,
                    carry_inz=len(seg.carry_inz), carry_outz_vals=seg.carry_outz_vals)

    def _hashers(self, R: int, names=STREAMS,
                 device: Optional[torch.device] = None) -> Dict[str, b3.ColumnHasher]:
        """The streams' incremental hashes at R lanes on `device` (by
        default the first), each holding at most a segment's rows of its
        stream (_seg_rows) in CVs, its tree two segments' streams in
        compressions."""
        device = self.device if device is None else device
        return {k: b3.ColumnHasher(self.totals[k], R, device, self._seg_rows[k] * R,
                                   2 * self._stream_rows * R)
                for k in names}

    # -- the segment inputs -------------------------------------------------
    @staticmethod
    def _tape2(seg, rk: torch.Tensor, omit: Optional[torch.Tensor]) -> torch.Tensor:
        """(m2, R) GF(2) tape rows tape0 .. tape0 + m2 of the circuit: the
        tape kernel from counter block tape0 // 128, cut at the window's
        first slot."""
        R = rk.shape[0] // 8
        if seg.cc.m2 == 0:
            return torch.empty((0, R), dtype=torch.uint8, device=rk.device)
        b0 = seg.tape0 // aes_tape.BATCH
        off = seg.tape0 - b0 * aes_tape.BATCH
        return aes_tape.aes_ctr_tape_gf2(rk, off + seg.cc.m2, omit, b0)[off:]

    @staticmethod
    def _tapez(seg, rk: torch.Tensor, omit: Optional[torch.Tensor]) -> torch.Tensor:
        """(mz, 8, R) z64 tape words tapez0 .. tapez0 + mz of the circuit:
        the z64 tape kernel from the refill that holds word tapez0."""
        R = rk.shape[0] // 8
        if seg.cc.mz == 0:
            return torch.empty((0, 8, R), dtype=torch.int64, device=rk.device)
        b0 = seg.tapez0 // Z64_REFILL_WORDS
        off = seg.tapez0 - b0 * Z64_REFILL_WORDS
        return aes_tape_z64.aes_ctr_tape_z64(rk, off + seg.cc.mz, omit,
                                             b0 * Z64_REFILL_BLOCKS)[off:]

    def _gather_carry(self, s: int, z: int, carries: Dict[int, dict], inp: dict,
                      device: torch.device) -> None:
        """Segment s's carried-in rows of domain z (0 GF(2), 1 z64), in
        carry_in order, from the carry outputs of the segments that last
        wrote them: one index_select per source segment and array, then
        one to restore the order."""
        key = (s, z, device)
        if key not in self._carry_index:
            seg = self.segments[s]
            src = seg.carry_srcz if z else seg.carry_src
            by_src: Dict[int, list] = {}
            for pos, (sv, row) in enumerate(src):
                by_src.setdefault(sv, []).append((row, pos))
            order = np.asarray([pos for rows in by_src.values() for _, pos in rows])
            inv = np.empty(len(order), dtype=np.int64)
            inv[order] = np.arange(len(order))
            self._carry_index[key] = (
                [(sv, torch.as_tensor([r for r, _ in rows], device=device))
                 for sv, rows in by_src.items()],
                torch.as_tensor(inv, device=device))
        parts, inv = self._carry_index[key]
        for name in _CARRIES[z]:
            rows = torch.cat([carries[sv][name].index_select(0, idx) for sv, idx in parts])
            inp[name] = rows.index_select(0, inv)

    def _run_segments(self, mode: int, shards: List[dict],
                      on_out: Callable[[int, int, dict], None]) -> List[torch.Tensor]:
        """Run every segment in order in one role, each on every shard
        before the next segment, calling on_out(i, s, out) on shard i's
        outputs of segment s; returns each shard's fail flags (its lanes,).
        A shard: its device 'dev'; 'rk2' / 'rkz', the round keys of its
        GF(2) and z64 tapes (the online verifier opens the two domains with
        their own keys); 'omit' / 'omitz' (its lanes,) numpy or None; 'wit'
        the witness columns (PROVER); 'inject'(seg), the segment's
        VERIFY_ONL inputs.  Each shard keeps its own carries."""
        debug = mode == VERIFY_ONL and os.environ.get("REVERIE_DEBUG")
        for sh in shards:
            dev = sh["dev"]
            sh["R"] = sh["rk2"].shape[0] // 8
            sh["om2"], sh["omz"] = (
                None if sh.get(o) is None
                else torch.as_tensor(sh[o].astype(np.uint8), device=dev)
                for o in ("omit", "omitz"))
            sh["carries"] = {}
            sh["fail"] = torch.zeros((sh["R"],), dtype=torch.bool, device=dev)
        for s, seg in enumerate(self.segments):
            cc = seg.cc
            for i, sh in enumerate(shards):
                dev, R, carries = sh["dev"], sh["R"], sh["carries"]
                inp = {"tape": self._tape2(seg, sh["rk2"], sh["om2"]),
                       "tapez": self._tapez(seg, sh["rkz"], sh["omz"])}
                if debug:
                    host._check_omitted_lanes(inp["tape"], inp["tapez"], sh["omit"],
                                              sh["omitz"])
                if sh.get("wit") is not None:
                    wit = sh["wit"]
                    inp["wit2"] = _column(wit[0][seg.wit0 : seg.wit0 + cc.n_wit2], R, dev)
                    inp["witz"] = _column(wit[1][seg.witz0 : seg.witz0 + cc.n_witz], R, dev)
                if sh.get("inject") is not None:
                    inp.update(sh["inject"](seg))
                for z, src in enumerate((seg.carry_src, seg.carry_srcz)):
                    if src:
                        self._gather_carry(s, z, carries, inp, dev)
                out = self._executor(s, mode, R, dev)(inp)
                del inp  # and the executor, its tables with it
                sh["fail"] |= out["fail"]
                if seg.carry_out or seg.carry_outz:
                    carries[s] = {k: out[k] for names in _CARRIES for k in names if k in out}
                for src in self._done_after[s]:
                    carries.pop(src, None)
                on_out(i, s, out)
                del out
        return [sh.pop("fail") for sh in shards]

    # -- proving ------------------------------------------------------------
    @profiling.entry
    def prove(self, wit_gf2, wit_z64=(), seeds: Optional[np.ndarray] = None) -> Proof:
        """`seeds` (total_reps, 16) makes the proof deterministic."""
        params, T = self.params, self.totals
        R = params.total_reps
        timer = host.PhaseTimer(self.lanes.devices)
        seeds = self.lanes.seeds(seeds, 1, R)[0]
        wit = host.witness_columns(wit_gf2, wit_z64, T["n_wit2"], T["n_witz"], 0)
        player_keys = expand_seeds(seeds).reshape(R, 8, KEY_SIZE)
        lanes = self.lanes.split(R)
        rks = [aes_tape.round_keys(player_keys[sl], dev) for dev, sl in lanes]

        def shards(which):
            return [dict(dev=lanes[i][0], rk2=rks[i], rkz=rks[i], wit=wit) for i in which]

        hashers = [self._hashers(sl.stop - sl.start, device=dev) for dev, sl in lanes]
        with timer.phase("pass1"):
            fails = self._run_segments(
                PROVER, shards(range(len(lanes))),
                lambda i, s, out: _absorb(hashers[i], self.segments[s].cc, out))
        with timer.phase("hash_final"):
            pulls = [host._Pull(torch.cat([*_rep_hashes(h), fail.to(torch.uint8)[:, None]],
                                          dim=1)) for h, fail in zip(hashers, fails)]
            hashers.clear()
            rows = self.lanes.gather([p.numpy() for p in pulls], host.HASH_ROW)
            rep_h, ho2, hoz = (rows[:, 32 * i : 32 * (i + 1)] for i in range(3))
            if rows[:, 96].any():
                raise AssertionError("witness 0 is invalid (AssertZero failed)")
        with timer.phase("challenge"):
            comm = blake3(np.ascontiguousarray(rep_h).tobytes())
            omit = host.challenge_omits(comm, params)
        K = int((omit < 8).sum())
        # this process's opened rows (its shards' lanes are one run), and
        # the shards that hold any: pass 2 runs on those only
        mine = (host.opened_rows(omit, slice(lanes[0][1].start, lanes[-1][1].stop))
                if lanes else slice(0, 0))
        opened = [i for i, (_, sl) in enumerate(lanes) if (omit[sl] < 8).any()]
        # the opened records, K rows each: GF(2) packed, z64 as bytes
        bits2 = [np.zeros((K, host.packed_len(T[n])), dtype=np.uint8)
                 for n in ("n_recons2", "n_corrs2", "n_inputs2")]
        bytesz = [np.zeros((K, 8 * T[n]), dtype=np.uint8)
                  for n in ("n_reconsz", "n_corrsz", "n_inputsz")]
        pending = collections.deque()

        def place(s: int, rows: slice, pull) -> None:
            seg = self.segments[s]
            cc, buf, o, k = seg.cc, pull.numpy(), 0, rows.stop - rows.start
            for dest, n, base in zip(bits2, (cc.n_recons2, cc.n_corrs2, cc.n_inputs2),
                                     (seg.rec0, seg.cor0, seg.inp0)):
                nb = host.window_bytes(base % 8, n)
                dest[rows, base // 8 : base // 8 + nb] |= buf[o : o + k * nb].reshape(k, nb)
                o += k * nb
            for dest, n, base in zip(bytesz, (cc.n_reconsz, cc.n_corrsz, cc.n_inputsz),
                                     (seg.recz0, seg.corz0, seg.inpz0)):
                dest[rows, 8 * base : 8 * (base + n)] = buf[o : o + k * 8 * n].reshape(k, 8 * n)
                o += k * 8 * n

        def extract(i: int, s: int, out: dict) -> None:
            seg, sl = self.segments[s], lanes[opened[i]][1]
            cols = np.nonzero(omit[sl] < 8)[0]
            dev = out["onl2"].device
            cols_t, omit_t = host.upload_array(cols, dev), host.upload_array(omit[sl][cols], dev)
            g2 = host.extract_gf2(seg.cc, out["onl2"], out["pre2"], cols_t, omit_t,
                                  leads=(seg.rec0 % 8, seg.cor0 % 8, seg.inp0 % 8))
            gz = host.extract_z64(seg.cc, out["onlz"], out["prez"], cols_t, omit_t)
            pending.append((s, host.opened_rows(omit, sl), host._Pull(torch.cat([g2, gz]))))
            # the pulls of earlier segments were queued ahead of this one's
            # work: place them while the card runs it
            while len(pending) > 1:
                place(*pending.popleft())

        with timer.phase("pass2"):
            self._run_segments(PROVER, shards(opened), extract)
            while pending:
                place(*pending.popleft())
        with timer.phase("pack"):
            # every process's opened rows, on every process
            packed = [self.lanes.gather([b[mine]], b.shape[1]) for b in bits2]
            bytesz = [self.lanes.gather([b[mine]], b.shape[1]) for b in bytesz]
            open2 = [tuple(p[j].tobytes() for p in packed) for j in range(K)]
            openz = [tuple(b[j].tobytes() for b in bytesz) for j in range(K)]
            proof = host.assemble_proof(comm, seeds, player_keys, omit, ho2, hoz, open2, openz)
        self.last_timings = timer.report()
        return proof

    # -- verification -------------------------------------------------------
    @profiling.entry
    def verify(self, proof: Proof, strict_zero_check: bool = True) -> bool:
        """The online and preprocessing re-executions segment by segment;
        False for a malformed proof."""
        timer = host.PhaseTimer(self.lanes.devices)
        try:
            return self._verify(proof, strict_zero_check, timer)
        finally:
            self.last_timings = timer.report()

    def _verify(self, proof: Proof, strict_zero_check: bool, timer: host.PhaseTimer) -> bool:
        params, T = self.params, self.totals
        if not host.check_formats(proof, params):
            return False

        # ---- online re-execution (the opened reps as one batch) -----------
        Ro = params.online_reps
        lanes = self.lanes.split(Ro)
        with timer.phase("onl_inject"):
            with timer.span("parse"):
                on2, onz = proof.gf2.online, proof.z64.online
                streams = host.online_streams(on2, onz, SimpleNamespace(**T))
                keys2, keysz = host.opened_keys(on2), host.opened_keys(onz)
                mines = [host._lanes_of(streams, sl) for _, sl in lanes]
            del streams
            with timer.span("round_keys"):
                shards = [dict(dev=dev, omit=mine["omit"], omitz=mine["omitz"],
                               rk2=aes_tape.round_keys(keys2[sl], dev),
                               rkz=aes_tape.round_keys(keysz[sl], dev),
                               inject=lambda seg, mine=mine, dev=dev: host.online_inputs(
                                   mine, seg.cc, dev, seg))
                          for (dev, sl), mine in zip(lanes, mines)]

        hashers = [self._hashers(sl.stop - sl.start, device=dev) for dev, sl in lanes]
        with timer.phase("onl_exec"):
            fails = self._run_segments(
                VERIFY_ONL, shards,
                lambda i, s, out: _absorb(hashers[i], self.segments[s].cc, out))
        with timer.phase("onl_hash"):
            pulls = [host._Pull(torch.cat([_rep_hashes(h)[0], fail.to(torch.uint8)[:, None]],
                                          dim=1)) for h, fail in zip(hashers, fails)]
            onl = self.lanes.gather([p.numpy() for p in pulls], 33)
            if strict_zero_check and onl[:, 32].any():
                return False

        # ---- preprocessing re-execution -----------------------------------
        Rp = params.preprocessing_reps
        lanes = self.lanes.split(Rp)
        with timer.phase("pre_tape"):
            with timer.span("expand_seeds"):
                pre2, prez = proof.gf2.preprocessing, proof.z64.preprocessing
                pk2 = expand_seeds(host.preprocessing_seeds(pre2)).reshape(Rp, 8, KEY_SIZE)
                pkz = expand_seeds(host.preprocessing_seeds(prez)).reshape(Rp, 8, KEY_SIZE)
                comm2, commz = host.committed_hashes(pre2), host.committed_hashes(prez)
            with timer.span("round_keys"):
                shards = [dict(dev=dev, rk2=aes_tape.round_keys(pk2[sl], dev),
                               rkz=aes_tape.round_keys(pkz[sl], dev)) for dev, sl in lanes]
        hashers = [self._hashers(sl.stop - sl.start, ("pre2", "prez"), dev) for dev, sl in lanes]
        with timer.phase("pre_exec"):
            self._run_segments(VERIFY_PRE, shards,
                               lambda i, s, out: _absorb(hashers[i], self.segments[s].cc, out))
        with timer.phase("pre_hash"):
            pulls = [host._Pull(_rep_hashes(h, torch.from_numpy(comm2[sl]).to(dev),
                                            torch.from_numpy(commz[sl]).to(dev))[0])
                     for h, (dev, sl) in zip(hashers, lanes)]
            hashes_pre = self.lanes.gather([p.numpy() for p in pulls], 32)
        return host.commitment_ok(proof.comm, onl[:, :32], hashes_pre, params)
