"""Host orchestration of the prove / verify path on one device or a mesh.

Port of reverie_tpu/backend/tpu_host.py's `TpuKKW` (`_gf2_tape`,
`_z64_tape`, `_hash_fn`, `prove`, `prove_batch`, `prove_batch_chunked`,
`prove_many`, `_prove_dispatch`, `_prove_challenge`, `_prove_assemble`,
`_batch_dispatch`, `_batch_challenge`, `_batch_assemble`,
`_extract_gf2_dispatch`, `_extract_z64_dispatch`, `_parse_gf2_buf`,
`_parse_z64_buf`, `verify`, `verify_many`, `_verify_dispatch` with its
REVERIE_DEBUG omitted-lane checks, `_verify_finish`), of its
`device_footprint`, re-derived for the port's tensors, and of its helpers
`make_gf2_extractor` and `make_z64_extractor` in their gather forms,
`_pack_rows_device`, `_stack_streams` and `_u64s_from_stream` (here one
rep-major `_stream_rows`), `build_online_injection_packed` and
`make_online_unpacker`, for circuits
over GF(2), Z_2^64 and B2A bridges.  One proof is a batch of one: the
single and batch paths, and reverie_tpu's two sets of pipeline stages, are
one set of stages here, over N * 256 proof-major lanes.

The device runs the mask tapes (CUDA kernels), the executor (the levelized
torch one, or for circuits deeper than SCAN_DEPTH_THRESHOLD levels the wave
executor of scan.py, one CUDA kernel launch per call), the
transcript hashes (the CUDA chunk and tail kernels), and the extraction of
the opened repetitions.  The host runs seed expansion, the Fiat-Shamir
challenge, the blake3 of the rep hashes and proof assembly, as in the
reference.  Each stage ends in an asynchronous device -> host pull that the
next stage waits on, so that in a pipeline one proof's host work overlaps
the next one's device work.

On a mesh (reverie_tpu_torch.parallel; `Lanes`) every device stage runs on
each shard, over its contiguous slice of the stage's lanes, exactly as on
one device at that lane count; each stage is dispatched on every shard
before the next.  The pulled rep hashes and opened records meet in host
memory in lane order (on a mesh over several processes, all-gathered over
gloo), where the challenge and assembly run as before: the proof bytes do
not depend on the mesh.
"""

from __future__ import annotations

import ctypes
import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..circuit.compile import B2A_CORR, N_KINDS, CompiledCircuit, compile_program
from ..circuit.compile_native import OpArrays, distinct_ops
from ..circuit.ir import CombineOp, Gate, Kind, Op
from ..crypto import blake3, expand_seeds
from ..crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3, blake3_tail
from ..params import DEFAULT_PARAMS, KEY_SIZE, ProtocolParams
from ..proof.challenge import challenge_to_opening
from ..proof.container import (
    OpenOnline,
    OpenPreprocessing,
    Proof,
    ProofSingle,
)
from ..device import default_device
from ..parallel.distributed import _allgather_rows, gather_rows, mesh_is_multiprocess
from ..parallel.mesh import check_mesh, lane_slices, process_index
from . import profiling, scan
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
            "blake3_chunk_cvs": b3.LAUNCHES, "blake3_tail": blake3_tail.LAUNCHES,
            "scan_gf2": scan.LAUNCHES, "scan_z64": scan.LAUNCHES_Z64}


class _Row:
    """An open phase: its name, its children (name, start, end) in
    perf_counter_ns, whether one is open, the bytes `upload` handed to
    a device in it, and of those the bytes copied from pinned memory, and
    the sizes of its work (PhaseTimer.count)."""

    __slots__ = ("name", "spans", "child", "h2d_bytes", "h2d_pinned_bytes", "counters")

    def __init__(self, name: str):
        self.name = name
        self.spans: List[tuple] = []
        self.child = False
        self.h2d_bytes = 0
        self.h2d_pinned_bytes = 0
        self.counters: Dict[str, object] = {}

    def child_range(self, child: str) -> str:
        """The profiler range of a child: "<phase>.<child><tag>", the
        phase's "[i]" tag kept last."""
        base, bracket, tag = self.name.rpartition("[")
        if bracket and tag.endswith("]"):
            return f"{base}.{child}[{tag}"
        return f"{self.name}.{child}"


class _Child:
    """A child span of an open phase's row (PhaseTimer.span)."""

    __slots__ = ("row", "name", "rf", "t0")

    def __init__(self, row: _Row, name: str):
        self.row, self.name = row, name

    def __enter__(self):
        # stamped around its profiler range, whose cost is then the child's
        # and not its phase's self time
        row = self.row
        row.child = True
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if profiling.enabled():
            self.rf = profiling.annotate(row.child_range(self.name))
            self.rf.__enter__()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        row = self.row
        row.spans.append((self.name, self.t0, time.perf_counter_ns()))
        row.child = False
        return False


#: the PhaseTimer whose phase is open, into which span() records; None
#: outside every phase
_current: Optional["PhaseTimer"] = None


def span(name: str):
    """A child span `name` of the open phase of the current PhaseTimer
    (PhaseTimer.span), for code that does not hold the timer; nothing
    outside a phase."""
    t = _current
    return profiling.NOTHING if t is None else t.span(name)


class PhaseTimer:
    """Per phase: host wall time, the stream time between two CUDA events
    on each CUDA device of `devices` (the longest reported: on a mesh the
    phase ends with its slowest card; not the device's busy time, since it
    holds any gap in which the stream waited for the host), the kernel
    launches made, the host bytes handed to a device by `upload` (and, of
    those, the ones copied from pinned memory), and the phase's child spans
    (span): named host intervals inside it, such as each blocking wait on a
    pull ("wait").

    Times are stamped on the profiler's clock: time.perf_counter_ns plus
    one offset to time.time_ns taken when the timer is made, the Unix
    nanoseconds of torch.profiler's events.  While a profiler records,
    each phase is also a record_function range of its name, and each child
    one of "<phase>.<child><tag>" ("challenge.commit[3]")."""

    def __init__(self, devices: Sequence[torch.device]):
        cuda = [torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
                for d in map(torch.device, devices) if d.type == "cuda"]
        self.devices = list(dict.fromkeys(cuda))
        #: each device's current stream, on which a phase's events are
        #: recorded (taken once: a call does not switch streams)
        self.streams = [torch.cuda.current_stream(d) for d in self.devices]
        self._rows = []
        self._open: Optional[_Row] = None
        #: perf_counter_ns + offset = time.time_ns
        self.offset = time.time_ns() - time.perf_counter_ns()

    @contextmanager
    def phase(self, name: str):
        global _current
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in self.devices]
        for s, ev in zip(self.streams, evs):
            ev[0].record(s)
        l0 = launch_counts()
        row = _Row(name)
        outer, _current, self._open = _current, self, row
        # stamped around its profiler range, as a child is
        t0 = time.perf_counter_ns()
        try:
            with profiling.annotate(name):
                yield
        finally:
            t1 = time.perf_counter_ns()
            _current, self._open = outer, None
            for s, ev in zip(self.streams, evs):
                ev[1].record(s)
            l1 = launch_counts()
            self._rows.append((row, t0, t1, evs, {k: l1[k] - l0[k] for k in l0}))

    def span(self, name: str):
        """A host-only child span of the open phase (no CUDA events, no
        launch counts): recorded as [name, start_ns, end_ns] into the
        phase's row.  Nothing outside a phase; one opened inside an open
        child is part of that child, not a span of its own."""
        row = self._open
        return profiling.NOTHING if row is None or row.child else _Child(row, name)

    def count(self, **sizes) -> None:
        """Sizes of the open phase's work (not timings), reported with its
        row under their names; nothing outside a phase."""
        if self._open is not None:
            self._open.counters.update(sizes)

    def report(self) -> Dict[str, dict]:
        """{phase: {host_ms, device_ms (None off CUDA), launches,
        h2d_bytes, h2d_pinned_bytes, start_ns, end_ns, wait_ms, spans}}:
        spans [[child, start_ns, end_ns]] in order, wait_ms the sum of the
        "wait" children's; and the row's counters (count), where it has
        any."""
        for d in self.devices:
            torch.cuda.synchronize(d)
        off = self.offset
        return {
            row.name: {
                "host_ms": (t1 - t0) / 1e6,
                "device_ms": max((a.elapsed_time(b) for a, b in evs), default=None),
                "launches": launches,
                "h2d_bytes": row.h2d_bytes,
                "h2d_pinned_bytes": row.h2d_pinned_bytes,
                "start_ns": t0 + off,
                "end_ns": t1 + off,
                "wait_ms": sum(e - s for n, s, e in row.spans if n == "wait") / 1e6,
                "spans": [[n, s + off, e + off] for n, s, e in row.spans],
                **row.counters,
            }
            for row, t0, t1, evs, launches in self._rows
        }


# ---------------------------------------------------------------------------
# Extraction (prover) and injection (verifier) of the opened streams
# ---------------------------------------------------------------------------


def _take_rows(buf: torch.Tensor, slots: np.ndarray) -> torch.Tensor:
    """Rows `slots` of buf, as a slice where the slots form a run."""
    slots = np.asarray(slots, np.int64)
    meta = _classify(slots) + (len(slots),)
    index = upload_array(slots, buf.device) if meta[0] == "gather" else None
    return take(buf, meta, index)


def _take_events(buf: torch.Tensor, starts: np.ndarray, width: int) -> torch.Tensor:
    """Rows of the events that start at `starts`, `width` rows each: a
    slice where the events lie back to back (found on the starts, not on
    their rows), else _take_rows of their rows."""
    starts = np.asarray(starts, np.int64)
    if len(starts) and (np.diff(starts) == width).all():
        return buf[starts[0] : starts[0] + len(starts) * width]
    return _take_rows(buf, event_rows(starts, width))


def packed_len(n: int) -> int:
    """Bytes of a packed stream of n GF(2) records: the reference always
    emits the remainder byte (gf2/recon.rs:218-237)."""
    return n // 8 + 1


def window_bytes(lead: int, n: int) -> int:
    """Bytes that hold n GF(2) records after `lead` (< 8) bits: a segment's
    window of a packed stream whose first record is bit `lead` of its first
    byte (none for no records)."""
    return (lead + n + 7) // 8 if n else 0


def _pack_rows_device(bits: torch.Tensor, lead: Optional[int] = None) -> torch.Tensor:
    """(N, K) 0/1 uint8 -> (packed_len(N), K) packed bytes, MSB first; with
    `lead`, the N bits after `lead` zero bits, in window_bytes(lead, N)
    bytes (the inverse of unpack_window's offset)."""
    N, K = bits.shape
    n_chunks = packed_len(N) if lead is None else window_bytes(lead, N)
    lead = lead or 0
    padded = torch.zeros((n_chunks * 8, K), dtype=torch.uint8, device=bits.device)
    padded[lead : lead + N] = bits
    # bit j of a byte is record 8 * byte + 7 - j (made on the device: no copy)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    return (padded.view(n_chunks, 8, K) << shifts[None, :, None]).sum(dim=1).to(torch.uint8)


def extract_gf2(cc: CompiledCircuit, onl2: torch.Tensor, pre2: torch.Tensor,
                cols: torch.Tensor, omit_sel: torch.Tensor,
                leads: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Opened columns -> one flat uint8 buffer [recons | corrs | inputs],
    each (K, packed_len(n)) row-major (make_gf2_extractor, gather form);
    with leads = (recons, corrs, inputs) bit offsets, each packed after its
    lead zero bits into (K, window_bytes(lead, n)), for a caller that ORs it
    into whole rows at a byte offset (the streaming prover's segments).
    cols and omit_sel are int64 tensors on the streams' device
    (upload_array)."""
    shifts = (7 - omit_sel).to(torch.uint8)
    onl_sel = onl2.index_select(1, cols)  # (n_onl, K)
    pre_sel = pre2.index_select(1, cols)
    rec = (_take_rows(onl_sel, cc.recon_slots2) >> shifts[None, :]) & 1
    cor = _take_rows(pre_sel, cc.corr_slots2) & 1
    inp = _take_rows(onl_sel, cc.input_slots2) & 1
    leads = (None, None, None) if leads is None else leads
    return torch.cat([_pack_rows_device(b, lead).t().reshape(-1)
                      for b, lead in zip((rec, cor, inp), leads)])


def extract_z64(cc: CompiledCircuit, onlz: torch.Tensor, prez: torch.Tensor,
                cols: torch.Tensor, omit_sel: torch.Tensor) -> torch.Tensor:
    """Opened columns -> one flat uint8 buffer [recons | corrs | inputs],
    each (K, n*8) row-major (make_z64_extractor, gather form).  A recon
    event is 64 stream rows (8 players x 8 bytes), of which the omitted
    player's 8 are opened; corr and input events are 8 rows.  cols and
    omit_sel (each < 8) are int64 tensors on the streams' device
    (upload_array)."""
    dev = onlz.device
    K = len(cols)
    parts = []
    nr = len(cc.recon_slotsz)
    if nr:
        rec = _take_events(onlz, cc.recon_slotsz, 64)
        rec = rec.index_select(1, cols).reshape(nr, 8, 8, K)
        idx = omit_sel.view(1, 1, 1, K)
        rec = rec.gather(1, idx.expand(nr, 1, 8, K))[:, 0]  # (nr, 8, K)
        parts.append(rec.permute(2, 0, 1).reshape(-1))
    for slots, src in ((cc.corr_slotsz, prez), (cc.input_slotsz, onlz)):
        if len(slots):
            ev = _take_events(src, slots, 8).index_select(1, cols)
            parts.append(ev.reshape(len(slots), 8, K).permute(2, 0, 1).reshape(-1))
    if not parts:
        return torch.zeros((0,), dtype=torch.uint8, device=dev)
    return torch.cat(parts)


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """Host tensor t on `device`.  On CUDA, from pinned memory (t contiguous
    and pinned), one non_blocking copy: the host goes on at once, and the
    caching host allocator hands t's block to no later tensor until the
    copy is done; from pageable memory a copy that returns when the stream
    has reached it.  Counted into the open phase's row (PhaseTimer):
    h2d_bytes, and h2d_pinned_bytes for a pinned copy."""
    device = torch.device(device)
    pinned = device.type == "cuda" and t.is_contiguous() and t.is_pinned()
    row = None if _current is None else _current._open
    if row is not None:
        nbytes = t.numel() * t.element_size()
        row.h2d_bytes += nbytes
        row.h2d_pinned_bytes += nbytes if pinned else 0
    return t.to(device, non_blocking=pinned)


def upload_array(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`, a tensor of its dtype; on CUDA copied
    from pinned memory (upload): the host goes on at once, where a pageable
    copy would wait for the work queued on the stream before it.  Copied
    row-major first: upload sends only a contiguous pinned tensor without
    waiting, and columns picked out of an array are column-major."""
    t = torch.tensor(np.ascontiguousarray(a))
    return upload(t.pin_memory() if torch.device(device).type == "cuda" else t, device)


def _stream_rows(streams: List[bytes], n: int, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """Per-rep byte streams -> (R, n) host rows of dtype (uint8: bytes;
    int64: little-endian words, as the host), rep-major, in pinned memory
    when `pin`: each rep's first n whole items, zero-padded / truncated to
    n (lenient parsing, online.rs:124,163,171), one contiguous copy a rep
    (one stack of them where every stream holds its n items)."""
    out = torch.empty((len(streams), n), dtype=dtype, pin_memory=pin)
    if out.numel() == 0:
        return out
    rows = out.numpy().view(np.uint8)
    need = rows.shape[1]
    if all(len(s) >= need for s in streams):
        np.stack([np.frombuffer(s, dtype=np.uint8, count=need) for s in streams], out=rows)
        return out
    size = out.element_size()
    for r, s in enumerate(streams):
        k = min(len(s) // size * size, need)
        rows[r, :k] = np.frombuffer(s, dtype=np.uint8, count=k)
        rows[r, k:] = 0
    return out


def _unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(nb, R) packed bytes -> (n, R) 0/1 uint8, MSB first."""
    nb, R = packed.shape
    if n == 0:
        return torch.zeros((0, R), dtype=torch.uint8, device=packed.device)
    sh = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None, :] >> sh[None, :, None]) & 1).reshape(nb * 8, R)[:n]


#: the online records a VERIFY_ONL executor takes: its input, the field of
#: the opening that holds them, their count on a CompiledCircuit, their
#: first record on a Segment
ONLINE_RECORDS = (("co2", "corrs", "n_corrs2", "cor0"), ("in2", "inputs", "n_inputs2", "inp0"),
                  ("re2", "recons", "n_recons2", "rec0"), ("coz", "corrs", "n_corrsz", "corz0"),
                  ("inz", "inputs", "n_inputsz", "inpz0"), ("rez", "recons", "n_reconsz", "recz0"))


def online_streams(openings2: List[OpenOnline], openingsz: List[OpenOnline], counts,
                   pin: bool = False, z64: bool = True) -> dict:
    """The online openings on the host, as the verifier reads them, in the
    proof's order, rep-major: each GF(2) stream packed, (R,
    window_bytes(0, n)) uint8 (the bytes that hold its n records; the
    remainder byte past them is never read), each z64 stream (R, n) int64
    words, n the count on `counts` (an object with ONLINE_RECORDS' count
    attributes; lenient parsing: zero-padded or truncated); the omits of
    the two domains, which a malformed proof can make differ
    (build_online_injection_packed), as 'omits' (R, 2) int64 and its
    columns 'omit' and 'omitz' (numpy views).  Host tensors, in pinned
    memory when `pin` (for a CUDA device, to which online_inputs then
    copies each whole with one non_blocking copy).  With z64 False the z64
    streams are left out, for online_streams_z64 to add."""
    omits = torch.empty((len(openings2), 2), dtype=torch.int64, pin_memory=pin)
    om = omits.numpy()
    om[:, 0] = [o.omit for o in openings2]
    om[:, 1] = [o.omit for o in openingsz]
    out = {"omits": omits, "omit": om[:, 0], "omitz": om[:, 1]}
    for name, field, count, _ in ONLINE_RECORDS:
        if name.endswith("2"):
            out[name] = _stream_rows([getattr(o, field) for o in openings2],
                                     window_bytes(0, getattr(counts, count)), torch.uint8, pin)
    if z64:
        out.update(online_streams_z64(openingsz, counts, pin))
    return out


def online_streams_z64(openingsz: List[OpenOnline], counts, pin: bool = False) -> dict:
    """The z64 half of online_streams: each z64 stream (R, n) int64 words,
    rep-major."""
    return {name: _stream_rows([getattr(o, field) for o in openingsz], getattr(counts, count),
                               torch.int64, pin)
            for name, field, count, _ in ONLINE_RECORDS if not name.endswith("2")}


def _rep_major_to_records(t: torch.Tensor) -> torch.Tensor:
    """(R, n) on the device -> (n, R), a new tensor of the default strides
    (a transposing copy; `contiguous()` would keep a size-1 axis's)."""
    out = torch.empty((t.shape[1], t.shape[0]), dtype=t.dtype, device=t.device)
    return out.copy_(t.t())


def unpack_window(rows: torch.Tensor, base: int, n: int, device) -> torch.Tensor:
    """Bits base .. base + n - 1 of each row of rows (R, nb) host bytes,
    rep-major, MSB first -> (n, R) 0/1 uint8 on device, record-major: only
    their bytes are copied (`upload`), and base need not be a multiple of
    8; the bytes are turned to (byte, rep) on the device."""
    lo, hi = base // 8, (base + n + 7) // 8
    off = base - 8 * lo
    packed = _rep_major_to_records(upload(rows[:, lo:hi], device))
    return _unpack_bits(packed, off + n)[off:]


def online_inputs(streams: dict, cc: CompiledCircuit, device, seg=None) -> dict:
    """The VERIFY_ONL inputs of cc on the device, from online_streams: the
    records seg.<first> .. + cc.<count> of each stream (seg None: from
    record 0), only those copied to the device, and turned there to
    (record, rep).  The recon bits move to the omitted player's bit, and
    the z64 recon words become one-hot shares at its slot
    (make_online_unpacker)."""
    inj = {}
    for name, _, count, first in ONLINE_RECORDS:
        n, base = getattr(cc, count), 0 if seg is None else getattr(seg, first)
        if name.endswith("2"):
            inj[name] = unpack_window(streams[name], base, n, device)
        else:
            inj[name] = _rep_major_to_records(upload(streams[name][:, base : base + n], device))
    omits = upload(streams["omits"], device)
    shift = (7 - omits[:, 0]).to(torch.uint8)
    onehot = (torch.arange(8, device=device)[:, None] == omits[None, :, 1]).to(torch.int64)
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
        """The host copy, once the copy is done: a blocking wait, the child
        span "wait" of the open phase."""
        with span("wait"):
            if self._event is not None:
                self._event.synchronize()
        return self._host.numpy()


#: glibc's mallopt parameters (malloc.h)
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3


@functools.cache
def keep_freed_heap() -> bool:
    """Have the process's C library keep the heap that freed proofs give
    back (once a process; False where the C library is not glibc).  A
    prove call returns its openings as bytes, ~32 MB a proof of 50k z64
    MULs and ~10 MB a 1M-AND one, in blocks that glibc serves from its
    heap once a freed one has raised its mmap threshold.  By default it
    then hands the freed heap back to the system when a call's proofs go,
    and the next call faults every page in again: in a virtual machine
    ~2.4 us a 4 KiB page, four times the copy that fills it, and more or
    less of it from call to call as proofs kept alive pin the heap's top.
    Fixed thresholds end that: blocks under 32 MiB come from the heap, and
    up to 2 GiB of free heap is kept for the next call (mallopt; as
    MALLOC_MMAP_THRESHOLD_ and MALLOC_TRIM_THRESHOLD_ would in the
    environment)."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (AttributeError, OSError):
        return False
    return bool(mallopt(_M_MMAP_THRESHOLD, 32 << 20)) and bool(
        mallopt(_M_TRIM_THRESHOLD, (1 << 31) - 1))


#: CPython's C API for a bytes object: made with its contents unset, and
#: the address of its contents
_bytes_new = ctypes.pythonapi.PyBytes_FromStringAndSize
_bytes_new.restype, _bytes_new.argtypes = ctypes.py_object, (ctypes.c_void_p, ctypes.c_ssize_t)
_bytes_at = ctypes.pythonapi.PyBytes_AsString
_bytes_at.restype, _bytes_at.argtypes = ctypes.c_void_p, (ctypes.py_object,)
#: threads that fill rows_to_bytes's bytes, and the bytes under which one
#: thread, the caller's, fills them all
COPY_THREADS, COPY_ALONE_BYTES = 4, 1 << 20


@functools.cache
def _copy_pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(COPY_THREADS, thread_name_prefix="reverie-rows")


def rows_to_bytes(a: np.ndarray) -> List[bytes]:
    """Each row of a 2-D array as bytes, as [r.tobytes() for r in a], with
    the copies made in COPY_THREADS threads at once: each bytes object is
    made with its contents unset (PyBytes_FromStringAndSize with no source,
    as C code makes one) and filled by ctypes.memmove, which runs without
    the GIL, before any other code holds it.  tobytes copies under the GIL,
    as fast as one core copies: a z64 proof's openings are ~32 MB."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    n = a.shape[1]
    out = [_bytes_new(None, n) for _ in range(len(a))]
    if not n:
        return out
    jobs = [(_bytes_at(b), a.ctypes.data + i * n) for i, b in enumerate(out)]

    def fill(part):
        for dst, src in part:
            ctypes.memmove(dst, src, n)

    if a.nbytes < COPY_ALONE_BYTES:
        fill(jobs)
    else:
        list(_copy_pool().map(fill, [jobs[i::COPY_THREADS] for i in range(COPY_THREADS)]))
    return out


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


def wave_sizes(cc: CompiledCircuit, mode: int) -> dict:
    """The sizes of cc that one W2 call's work is counted from in role
    `mode` (roofline.wave_gf2_work and wave_z64_work): its GF(2) and z64
    gates by compiled kind ({kind: gates}; B2A_CORR and B2A_OUT among the
    z64 ones), its B2As, and the bytes a rep of the GF(2) and z64 input
    rows and of the four streams.  Sizes of the circuit, not of its wave
    table (no empty slot); {} for a circuit with no z64 gate (no W2)."""
    gates: Tuple[dict, dict] = ({}, {})
    for lvl in cc.levels:
        for key, cols in lvl.items():
            domain, kind = divmod(key, N_KINDS)
            gates[domain][kind] = gates[domain].get(kind, 0) + len(next(iter(cols.values())))
    if not gates[1]:
        return {}
    rows2 = {PROVER: cc.m2 + cc.n_wit2,
             VERIFY_ONL: cc.m2 + cc.n_inputs2 + cc.n_corrs2 + cc.n_recons2,
             VERIFY_PRE: cc.m2}[mode]
    bytesz = {PROVER: 64 * cc.mz + 8 * cc.n_witz,
              VERIFY_ONL: 64 * cc.mz + 8 * (cc.n_inputsz + cc.n_corrsz) + 64 * cc.n_reconsz,
              VERIFY_PRE: 64 * cc.mz}[mode]
    return {"role": mode, "gf2_gates": gates[0], "z64_gates": gates[1],
            "b2a": gates[1].get(B2A_CORR, 0), "gf2_input_bytes": rows2,
            "z64_input_bytes": bytesz, "onl2": cc.onl2, "pre2": cc.pre2, "onlz": cc.onlz,
            "prez": cc.prez}


def lower_footprint(counts, R: int) -> int:
    """A lower bound of device_footprint(cc, R) from the circuit's counters
    and depth alone (compile_native.analyze, no tables): the tapes and
    witness columns, and the four streams, which the levelized executor
    holds three times over (executor.prover_bytes) and the wave executor
    once (scan.prover_bytes)."""
    inputs = (counts.m2 + counts.n_wit2) * R + 8 * R * (8 * counts.mz + counts.n_witz)
    return inputs + (1 if counts.depth > SCAN_DEPTH_THRESHOLD else 3) * stream_bytes(counts, R)


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


def check_program(program) -> None:
    """Raise TypeError unless every op is one of the port's own circuit
    objects.  reverie_tpu's classes are distinct (IntEnum comparison would
    make them appear to work): a program built there crosses over as
    bincode, `circuit.load_program(reverie_tpu.circuit.dumps_program(p))`.
    Each distinct op object is checked once (compile_native.distinct_ops).
    An OpArrays is checked by its op objects where it was made from some
    (OpArrays.from_program); one read from a file
    (bincode.load_program_arrays) has none, and the reader has refused
    every unknown tag."""
    if isinstance(program, OpArrays):
        objects = program.objects or []
    else:
        objects = distinct_ops(program)[0]
    for op in objects:
        gate = getattr(op, "gate", None)
        if not (isinstance(op, CombineOp) and type(op.kind) is Kind
                and (gate is None or (isinstance(gate, Gate) and type(gate.op) is Op))):
            raise TypeError(
                f"TorchKKW takes reverie_tpu_torch.circuit ops, not {type(op).__module__}."
                f"{type(op).__name__}; carry the program over as bincode bytes "
                "(reverie_tpu_torch.circuit.load_program)")


class Lanes:
    """Where the lanes of a device stage run, and how their host buffers
    meet: on one device (`device`, by default the CUDA device, raising
    without one), or on the shards of a mesh (parallel.Mesh), each holding
    a contiguous slice of every stage's lanes (parallel.lane_slices).  A
    mesh that is not the port's raises TypeError."""

    def __init__(self, mesh=None, device: Optional[torch.device] = None):
        self.mesh = check_mesh(mesh)
        if mesh is None:
            self.devices = [default_device() if device is None else torch.device(device)]
        elif device is not None:
            raise ValueError("pass a mesh or a device, not both: the mesh names the devices")
        else:
            self.devices = mesh.local_devices()
            if not self.devices:
                raise ValueError("the mesh has no shard in this process")
        self.device = self.devices[0]

    def split(self, R: int) -> List[Tuple[torch.device, slice]]:
        """This process's shards at R lanes, (device, lanes) in lane order;
        a shard with no lanes is left out (it launches nothing and adds
        nothing to a gather).  Without a mesh: the one device, every lane."""
        if self.mesh is None:
            return [(self.device, slice(0, R))]
        me = process_index()
        return [(sh.device, sl) for sh, sl in zip(self.mesh.shards, lane_slices(R, self.mesh))
                if sh.process == me and sl.stop > sl.start]

    def gather(self, blocks: Sequence[np.ndarray], width: int) -> np.ndarray:
        """Every shard's (rows, width) host block, in lane order, on every
        process (parallel.gather_rows); on a mesh over several processes
        the gloo all-gather is the child span "allgather"."""
        if mesh_is_multiprocess(self.mesh):
            with span("allgather"):
                return gather_rows(self.mesh, blocks, width)
        return gather_rows(self.mesh, blocks, width)

    def seeds(self, seeds: Optional[np.ndarray], n: int, R: int) -> np.ndarray:
        """(n, R, 16) rep seeds (_seeds); fresh ones are process 0's on a
        mesh over several processes, so that every process proves the
        same proof."""
        fresh = seeds is None
        seeds = _seeds(seeds, n, R)
        if fresh and mesh_is_multiprocess(self.mesh):
            seeds = _allgather_rows(seeds.reshape(n, -1))[:n].reshape(n, R, KEY_SIZE)
        return seeds


def _lane_columns(cols: np.ndarray, lanes: slice, R: int, device) -> torch.Tensor:
    """Per-proof columns (n, N) over `lanes` of the proof-major N * R lane
    axis: only the shard's proofs' columns are uploaded, each repeated
    over its lanes on the device."""
    proof = np.arange(lanes.start, lanes.stop) // R
    ps, counts = np.unique(proof, return_counts=True)
    t = upload_array(cols[:, ps], device)
    return t.repeat_interleave(upload_array(counts, device), dim=1, output_size=len(proof))


def _lanes_of(arrays: dict, lanes: slice) -> dict:
    """The lanes (first axis) `lanes` of each host array or tensor: views,
    each a contiguous block of rows."""
    return {k: v[lanes] for k, v in arrays.items()}


def opened_rows(omit: np.ndarray, lanes: slice) -> slice:
    """The rows of the opened lanes (omit < 8, in lane order) that `lanes`
    holds."""
    before = np.cumsum(np.asarray(omit) < 8)
    lo = int(before[lanes.start - 1]) if lanes.start else 0
    return slice(lo, int(before[lanes.stop - 1]) if lanes.stop else 0)


#: the bytes a lane of a dispatch's pull holds: rep hash, ho2, hoz (32 each)
#: and the fail flag
HASH_ROW = 97


class TorchKKW:
    """Compile a circuit once; prove and verify on one device or a mesh.

    `program` is a list of the port's op objects or a program's OpArrays
    (circuit.bincode.load_program_arrays: a program file with no op
    objects).  The positional arguments are TpuKKW's, in its order;
    `device` is keyword-only.
    `device` defaults to the CUDA device (raising without one); the CPU
    device runs the kernels' plain PyTorch versions.  `mesh`
    (reverie_tpu_torch.parallel: make_mesh, global_mesh, local_mesh) shards
    every stage's lanes over its devices and processes instead: each shard
    runs this one-device work on its slice, and the rep hashes and opened
    records meet in host memory (Lanes); the proofs are the same bytes.
    `params` sets the repetitions (a proof's lanes are params.total_reps);
    `cc`, the program's compiled circuit where the caller has it already
    (make_system), is used as is; else the program is compiled, through the
    disk cache where `cache_key` names it (compile.compile_program).

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
    chunk or proof.  The phases: witness, expand_seeds, tape_gf2, tape_z64,
    execute, hash, challenge, extract_pull (prove); check, onl_inject,
    onl_tape, onl_exec, onl_hash, pre_tape, pre_exec, pre_hash, finish
    (verify).  A row (PhaseTimer.report): host_ms; device_ms, the stream
    time between two CUDA events (None off CUDA); launches; h2d_bytes and
    h2d_pinned_bytes, the host bytes `upload` handed to a device in the
    phase (onl_inject's: the online openings, pinned on CUDA); start_ns and
    end_ns on the profiler's clock (Unix ns); spans, its child spans
    [[name, start_ns, end_ns]]; wait_ms, the sum of its "wait" children.
    The children: each blocking wait on a pull, "wait"; "round_keys" (the
    host key schedule and its upload) in tape_gf2, tape_z64, onl_tape and
    pre_tape, after pre_tape's "expand_seeds"; challenge's "commit" (the
    commitments and challenges) and "extract" (the extraction's launches
    and its pull's enqueue); extract_pull's "gather" (the pulled buffer
    split, gathered and made bytes) and "assemble" (the Proof objects);
    onl_inject's "parse" (the openings' streams, rep-major, and keys) and
    "upload" (their host -> device copies, and the launches that unpack
    them to (record, rep)); finish's "check" (the
    commitment's); on a mesh over several processes each gloo gather,
    "allgather".  In a circuit with z64 events their share is a child of
    its own, beside the GF(2) one: "extract_z64" (the z64 extraction's
    launches and uploads) before each shard's "extract", "gather_z64" after
    "gather", "parse_z64" (the z64 streams and keys) after "parse".
    Counters (sizes, not timings): each row that makes the z64 tape
    (tape_z64, onl_tape, pre_tape) of a circuit with z64 masks holds
    "z64_tape_shares" (mz), and each executor row of a circuit on W2
    (execute, onl_exec, pre_exec) "w2_work" (wave_sizes in its role)."""

    def __init__(self, program, params: ProtocolParams = DEFAULT_PARAMS, mesh=None,
                 cc: Optional[CompiledCircuit] = None, cache_key: Optional[bytes] = None, *,
                 device: Optional[torch.device] = None):
        check_program(program)
        self.lanes = Lanes(mesh, device)
        self.mesh, self.device = self.lanes.mesh, self.lanes.device
        self.params = params
        self.cc = compile_program(program, cache_key=cache_key) if cc is None else cc
        self._executors: Dict[tuple, object] = {}
        self._wave_sizes: Dict[int, dict] = {}
        self.last_timings: Dict[str, dict] = {}

    @property
    def _z64_events(self) -> bool:
        """Whether the circuit's proofs open z64 records."""
        cc = self.cc
        return bool(cc.n_inputsz or cc.n_corrsz or cc.n_reconsz)

    def _count(self, timer: PhaseTimer, mode: Optional[int] = None) -> None:
        """The open phase's counters: z64_tape_shares in a z64 tape phase
        (mode None) of a circuit with z64 masks; w2_work in an executor
        phase of role `mode` of a circuit on W2."""
        if mode is None:
            if self.cc.mz:
                timer.count(z64_tape_shares=self.cc.mz)
            return
        if uses_waves(self.cc):
            if mode not in self._wave_sizes:
                self._wave_sizes[mode] = wave_sizes(self.cc, mode)
            if self._wave_sizes[mode]:
                timer.count(w2_work=self._wave_sizes[mode])

    def _executor(self, mode: int, R: int, device: Optional[torch.device] = None):
        """The executor of one role at R lanes on `device` (by default the
        first), built once: the wave executor (scan.ScanExecutor) for
        circuits deeper than SCAN_DEPTH_THRESHOLD levels, the levelized
        Executor otherwise (uses_waves).  Every entry point takes its
        executors here."""
        device = self.device if device is None else device
        key = (mode, R, device)
        if key not in self._executors:
            make = scan.ScanExecutor if uses_waves(self.cc) else Executor
            self._executors[key] = make(self.cc, mode, R, device)
        return self._executors[key]

    @staticmethod
    def _omit_tensor(omit: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
        if omit is None:
            return None
        return torch.as_tensor(np.asarray(omit).astype(np.uint8), device=device)

    def _gf2_tape(self, player_keys: np.ndarray, omit: Optional[np.ndarray] = None,
                  device: Optional[torch.device] = None) -> torch.Tensor:
        """(R, 8, 16) player keys -> (m2, R) uint8 mask tape on `device`
        (by default the first; the AES tape kernel on CUDA, whatever the
        size)."""
        device = self.device if device is None else device
        with span("round_keys"):
            rk = aes_tape.round_keys(player_keys, device)
        return aes_tape.aes_ctr_tape_gf2(rk, self.cc.m2, self._omit_tensor(omit, device))

    def _z64_tape(self, player_keys: np.ndarray, omit: Optional[np.ndarray] = None,
                  device: Optional[torch.device] = None) -> torch.Tensor:
        """(R, 8, 16) player keys -> (mz, 8, R) int64 z64 mask tape on
        `device` (by default the first; the z64 tape kernel on CUDA,
        whatever the size)."""
        device = self.device if device is None else device
        with span("round_keys"):
            rk = aes_tape.round_keys(player_keys, device)
        return aes_tape_z64.aes_ctr_tape_z64(rk, self.cc.mz, self._omit_tensor(omit, device))

    def _hash_fn(self, out: Dict[str, torch.Tensor],
                 comm2: Optional[torch.Tensor] = None,
                 commz: Optional[torch.Tensor] = None):
        """Per-rep combined hashes H(H(pre2 || onl2) || H(prez || onlz))
        of an executor's four streams (transcript/mod.rs:77-96 +
        combine.rs:104-118) -> (rep_h, ho2, hoz), each (R, 32).  With
        comm2/commz the online hashes are the committed values (preprocess
        verification, verifier/preprocess.rs:55-57).  On CUDA: K3 on each
        stream's whole chunks, then one launch of the tail kernel for the
        leg (blake3.hash_leg)."""
        def tail(name):
            return b3.stream_tail(out[name], getattr(self.cc, name))

        return b3.hash_leg(tail("pre2"), tail("onl2") if comm2 is None else comm2,
                           tail("prez"), tail("onlz") if commz is None else commz)

    # -- proving ------------------------------------------------------------
    def prove(self, wit_gf2, wit_z64, seeds: Optional[np.ndarray] = None) -> Proof:
        """`seeds` (total_reps, 16) makes the proof deterministic."""
        return self.prove_batch([(wit_gf2, wit_z64)], seeds)[0]

    @profiling.entry
    def prove_batch(self, witnesses, seeds: Optional[np.ndarray] = None) -> List[Proof]:
        """Prove N statements of this circuit in one device batch.
        `witnesses`: [(wit_gf2, wit_z64)] * N; `seeds`: (N, total_reps, 16)
        makes the proofs deterministic.  The N * 256 repetitions are one
        lane axis, proof-major (lane p * 256 + r is rep r of proof p): one
        tape per domain, one executor run and one hash of every stream; the
        challenges are per proof on the host, and one extraction gathers all
        N * 40 opened lanes.  On a mesh the lane axis is split as a whole (a
        shard may hold lanes of two proofs).  Peak device memory is about
        device_footprint(cc, N * 256)."""
        return self._prove_pipeline(witnesses, seeds, max(len(witnesses), 1))

    @profiling.entry
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

    @profiling.entry
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
        seeds = self.lanes.seeds(seeds, n, self.params.total_reps)
        bounds = [(lo, min(lo + width, n)) for lo in range(0, n, width)]
        k = len(bounds)
        timer = PhaseTimer(self.lanes.devices)
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
        seed expansion, then on every shard (each stage dispatched on all
        of them before the next) both tapes, the executor and the
        transcript hashes on its slice of the N * 256 lanes, then the
        asynchronous pull of its rep hashes and fail flags."""
        cc = self.cc
        N, R = len(witnesses), self.params.total_reps
        with timer.phase("witness" + tag):
            wit2 = np.zeros((cc.n_wit2, N), dtype=np.uint8)
            witz = np.zeros((cc.n_witz, N), dtype=np.int64)
            for p, (wit_gf2, wit_z64) in enumerate(witnesses):
                wit2[:, p], witz[:, p] = witness_columns(wit_gf2, wit_z64, cc.n_wit2,
                                                         cc.n_witz, first + p)
        shards = self.lanes.split(N * R)
        with timer.phase("expand_seeds" + tag):
            player_keys = expand_seeds(seeds.reshape(N * R, KEY_SIZE)).reshape(
                N * R, 8, KEY_SIZE)
        with timer.phase("tape_gf2" + tag):
            tapes = [self._gf2_tape(player_keys[sl], device=dev) for dev, sl in shards]
        with timer.phase("tape_z64" + tag):
            tapezs = [self._z64_tape(player_keys[sl], device=dev) for dev, sl in shards]
            self._count(timer)
        with timer.phase("execute" + tag):
            # one witness column uploaded per proof, repeated over its lanes
            # on the device; each shard's tapes go with its executor run
            outs = [self._executor(PROVER, sl.stop - sl.start, dev)(
                {"tape": tapes.pop(0), "tapez": tapezs.pop(0),
                 "wit2": _lane_columns(wit2, sl, R, dev), "witz": _lane_columns(witz, sl, R, dev)})
                for dev, sl in shards]
            self._count(timer, PROVER)
        with timer.phase("hash" + tag):
            pulls = [_Pull(torch.cat([*self._hash_fn(out), out["fail"].to(torch.uint8)[:, None]],
                                     dim=1)) for out in outs]
        return dict(N=N, first=first, seeds=seeds, player_keys=player_keys, shards=shards,
                    outs=outs, pulls=pulls, timer=timer, tag=tag)

    def _prove_challenge(self, st: dict) -> None:
        """Pipeline stage 2: wait for the hash pulls and gather them in lane
        order; per statement, the commitment and the Fiat-Shamir challenge
        on the host (raising before any extraction if a witness failed an
        AssertZero); then on every shard one extraction of the opened lanes
        it holds and its asynchronous pull."""
        N, R = st["N"], self.params.total_reps
        timer = st["timer"]
        with timer.phase("challenge" + st["tag"]):
            rows = self.lanes.gather([p.numpy() for p in st.pop("pulls")], HASH_ROW)
            with timer.span("commit"):
                rep_h = rows[:, :32].reshape(N, R, 32)
                st["ho2"] = rows[:, 32:64].reshape(N, R, 32)
                st["hoz"] = rows[:, 64:96].reshape(N, R, 32)
                failed = rows[:, 96].reshape(N, R).any(axis=1)
                if failed.any():
                    raise AssertionError(f"witness {st['first'] + int(np.argmax(failed))} "
                                         "is invalid (AssertZero failed)")
                comms = [blake3(rep_h[p].tobytes()) for p in range(N)]
                omits = np.stack([challenge_omits(c, self.params) for c in comms])
                omit = omits.reshape(N * R)
            st["xpulls"] = []
            # without z64 events one "extract" span holds every shard's (the
            # inner spans fold into it, as in gather and parse)
            with profiling.NOTHING if self._z64_events else timer.span("extract"):
                for (dev, sl), out in zip(st.pop("shards"), st.pop("outs")):
                    cols = np.nonzero(omit[sl] < 8)[0]
                    if not len(cols):
                        continue
                    with timer.span("extract_z64"):
                        # the columns and omits of both extractions, copied
                        # once without waiting for the next chunk's work
                        # queued on the stream
                        cols_t = upload_array(cols, dev)
                        omit_t = upload_array(omit[sl][cols], dev)
                        gz = extract_z64(self.cc, out["onlz"], out["prez"], cols_t, omit_t)
                    with timer.span("extract"):
                        g2 = extract_gf2(self.cc, out["onl2"], out["pre2"], cols_t, omit_t)
                        # one flat buffer a shard, pulled once: [gf2 openings | z64 openings]
                        st["xpulls"].append((_Pull(torch.cat([g2, gz])), g2.numel(), len(cols)))
        st.update(comms=comms, omits=omits)

    def _gf2_parts(self, buf: np.ndarray, K: int):
        """Pulled GF(2) extraction buffer of K lanes -> (recons, corrs,
        inputs), each (K, bytes a lane)."""
        cc = self.cc
        nb_r, nb_c, nb_i = (packed_len(n) for n in (cc.n_recons2, cc.n_corrs2, cc.n_inputs2))
        return (buf[: K * nb_r].reshape(K, nb_r), buf[K * nb_r : K * (nb_r + nb_c)].reshape(K, nb_c),
                buf[K * (nb_r + nb_c) :].reshape(K, nb_i))

    def _z64_parts(self, buf: np.ndarray, K: int):
        """Pulled z64 extraction buffer of K lanes -> (recons, corrs,
        inputs), each (K, 8 bytes an event)."""
        cc = self.cc
        nr, nc, ni = len(cc.recon_slotsz), len(cc.corr_slotsz), len(cc.input_slotsz)
        o1, o2 = K * nr * 8, K * (nr + nc) * 8
        return buf[:o1].reshape(K, nr * 8), buf[o1:o2].reshape(K, nc * 8), buf[o2:].reshape(K, ni * 8)

    def _opened(self, parts: list, widths: list) -> list:
        """Each shard's (recons, corrs, inputs) rows of one domain, gathered
        in lane order (rows of `widths` bytes) -> per opened lane its three
        streams' bytes."""
        return list(zip(*(rows_to_bytes(self.lanes.gather([p[i] for p in parts], w))
                          for i, w in enumerate(widths))))

    def _prove_assemble(self, st: dict) -> List[Proof]:
        """Pipeline stage 3: wait for the openings' pulls, gather them in
        lane order and assemble the N proofs; the opened lanes come in lane
        order, proof by proof."""
        R = self.params.total_reps
        cc = self.cc
        timer = st["timer"]
        z64 = self._z64_events
        with timer.phase("extract_pull" + st["tag"]):
            bufs = [(pull.numpy(), n_g2, K) for pull, n_g2, K in st.pop("xpulls")]
            with profiling.NOTHING if z64 else timer.span("gather"):
                with timer.span("gather"):
                    open2 = self._opened(
                        [self._gf2_parts(buf[:n_g2], K) for buf, n_g2, K in bufs],
                        [packed_len(n) for n in (cc.n_recons2, cc.n_corrs2, cc.n_inputs2)])
                with timer.span("gather_z64"):
                    openz = self._opened(
                        [self._z64_parts(buf[n_g2:], K) for buf, n_g2, K in bufs],
                        [8 * len(s) for s in (cc.recon_slotsz, cc.corr_slotsz, cc.input_slotsz)])
            with timer.span("assemble"):
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

    @profiling.entry
    def verify_many(self, proofs: Sequence[Proof],
                    strict_zero_check: bool = True) -> List[bool]:
        """Verify a stream of proofs, software-pipelined: proof i + 1's
        injection and uploads overlap proof i's device work and pulls.
        Returns the verdicts in order, each equal to `verify`'s; a
        malformed proof gives False in its place."""
        timer = PhaseTimer(self.lanes.devices)
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
        """Both re-executions (online, preprocessing) on every shard, their
        hashes and the asynchronous pulls of those; False for a malformed
        proof."""
        cc = self.cc
        with timer.phase("check" + tag):
            formed = check_formats(proof, self.params)
        if not formed:
            return False

        # ---- online re-execution (the opened reps as one batch) -----------
        Ro = self.params.online_reps
        shards = self.lanes.split(Ro)
        pin, z64 = self.device.type == "cuda", self._z64_events
        with timer.phase("onl_inject" + tag):
            with profiling.NOTHING if z64 else timer.span("parse"):
                with timer.span("parse"):
                    streams = online_streams(proof.gf2.online, proof.z64.online, cc, pin=pin,
                                             z64=False)
                    omit, omitz = streams["omit"], streams["omitz"]
                    player_keys = opened_keys(proof.gf2.online)
                with timer.span("parse_z64"):
                    streams.update(online_streams_z64(proof.z64.online, cc, pin=pin))
                    player_keysz = opened_keys(proof.z64.online)
            with timer.span("upload"):
                injs = [online_inputs(_lanes_of(streams, sl), cc, dev) for dev, sl in shards]
            del streams
        with timer.phase("onl_tape" + tag):
            for (dev, sl), inj in zip(shards, injs):
                inj.update(tape=self._gf2_tape(player_keys[sl], omit[sl], dev),
                           tapez=self._z64_tape(player_keysz[sl], omitz[sl], dev))
                if os.environ.get("REVERIE_DEBUG"):
                    _check_omitted_lanes(inj["tape"], inj["tapez"], omit[sl], omitz[sl])
            self._count(timer)
        with timer.phase("onl_exec" + tag):
            # each shard's inputs go with its executor run
            outs = [self._executor(VERIFY_ONL, sl.stop - sl.start, dev)(injs.pop(0))
                    for dev, sl in shards]
            self._count(timer, VERIFY_ONL)
        with timer.phase("onl_hash" + tag):
            # pulled under the preprocessing leg's device work
            pull_onl = [_Pull(torch.cat([self._hash_fn(out)[0],
                                         out["fail"].to(torch.uint8)[:, None]], dim=1))
                        for out in outs]
            del outs

        # ---- preprocessing re-execution -----------------------------------
        Rp = self.params.preprocessing_reps
        shards = self.lanes.split(Rp)
        with timer.phase("pre_tape" + tag):
            with timer.span("expand_seeds"):
                pk2 = expand_seeds(preprocessing_seeds(proof.gf2.preprocessing)).reshape(
                    Rp, 8, KEY_SIZE)
                pkz = expand_seeds(preprocessing_seeds(proof.z64.preprocessing)).reshape(
                    Rp, 8, KEY_SIZE)
            inps = [{"tape": self._gf2_tape(pk2[sl], device=dev),
                     "tapez": self._z64_tape(pkz[sl], device=dev)} for dev, sl in shards]
            self._count(timer)
        with timer.phase("pre_exec" + tag):
            outs = [self._executor(VERIFY_PRE, sl.stop - sl.start, dev)(inps.pop(0))
                    for dev, sl in shards]
            self._count(timer, VERIFY_PRE)
        with timer.phase("pre_hash" + tag):
            comm2 = committed_hashes(proof.gf2.preprocessing)
            commz = committed_hashes(proof.z64.preprocessing)
            pull_pre = [_Pull(self._hash_fn(out, torch.from_numpy(comm2[sl]).to(dev),
                                            torch.from_numpy(commz[sl]).to(dev))[0])
                        for (dev, sl), out in zip(shards, outs)]
        return dict(pull_onl=pull_onl, pull_pre=pull_pre, comm=proof.comm,
                    timer=timer, tag=tag)

    def _verify_finish(self, st: dict, strict_zero_check: bool = True) -> bool:
        """Wait for the hash pulls and gather them in lane order, reorder
        the rep hashes per the challenge and compare the commitment."""
        timer = st["timer"]
        with timer.phase("finish" + st["tag"]):
            onl = self.lanes.gather([p.numpy() for p in st["pull_onl"]], 33)
            hashes_pre = self.lanes.gather([p.numpy() for p in st["pull_pre"]], 32)
            with timer.span("check"):
                if strict_zero_check and onl[:, 32].any():
                    return False
                return commitment_ok(st["comm"], onl[:, :32], hashes_pre, self.params)
