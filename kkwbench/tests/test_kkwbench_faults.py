"""`correct` comes out false when the timed path is broken underneath a run
(the port on the CPU, the harness's look for a chip skipped), once for each
fault a cell can have, and when the control stands in the program's place;
a sound run is correct.  The port's verifier rejects each kind of tampered
proof that a verify mix's check sends it."""

from __future__ import annotations

import numpy as np
import pytest

from kkwbench import control, run, tamper

SEED = 2**31 + 2026


class _Flipped:
    """A proof whose bytes come out with one byte altered."""

    def __init__(self, proof):
        self.proof = proof

    def to_bytes(self) -> bytes:
        b = bytearray(self.proof.to_bytes())
        b[len(b) // 2] ^= 1
        return bytes(b)


class Faulty:
    """The port's system with one fault in the answers it returns.  `slots`
    is the mix's chunk: the fault "one_slot" alters the proofs of the last
    slot of each chunk alone."""

    def __init__(self, system, fault: str, timed: str, slots: int = 1):
        self.system, self.fault, self.timed, self.slots = system, fault, timed, slots

    def __getattr__(self, name):
        return getattr(self.system, name)

    def _proofs(self, proofs):
        if self.timed != "prove":  # a verify mix's pool is set-up, not the timed path
            return proofs
        if self.fault == "altered":
            return [_Flipped(p) for p in proofs]
        if self.fault == "one_slot":
            return [_Flipped(p) if k % self.slots == self.slots - 1 else p
                    for k, p in enumerate(proofs)]
        if self.fault == "half":
            return proofs[: len(proofs) // 2]
        if self.fault == "unchanged":  # every statement answered with the first's proof
            return [proofs[0]] * len(proofs)
        return proofs

    def prove_many(self, jobs, seeds):
        return self._proofs(self.system.prove_many(jobs, seeds))

    def prove_batch_chunked(self, jobs, seeds, chunk=64):
        return self._proofs(self.system.prove_batch_chunked(jobs, seeds, chunk=chunk))

    def verify_many(self, proofs):
        out = self.system.verify_many(proofs)
        if self.fault == "altered":
            return [not v for v in out]
        if self.fault == "half":
            return out[: len(out) // 2]
        if self.fault == "unchanged":  # every proof answered with the first's verdict
            return [out[0]] * len(out)
        if self.fault == "accept_all":
            return [True] * len(out)
        return out


def make_faulty(fault: str, timed: str, slots: int = 1, budget=1 << 40):
    """A `make` for kkwbench.run.run: the port's system with `fault` in the
    answers of a `timed` ("prove" or "verify") mix."""
    from reverie_tpu_torch import make_system

    def make(statement, ops, params, key, device, reference):
        return Faulty(make_system(ops, params, cache_key=key, device=device,
                                  hbm_budget_bytes=budget), fault, timed, slots)
    return make


#: each cell's faults: a prove mix's answers are proofs, a verify mix's verdicts
PROVE_FAULTS = ("altered", "one_slot", "half", "unchanged")
VERIFY_FAULTS = ("altered", "half", "unchanged", "accept_all")
CELLS = {"tiny.tiny_chunked": PROVE_FAULTS, "tiny.tiny_many": PROVE_FAULTS,
         "tiny.tiny_verify": VERIFY_FAULTS}
SLOTS = {"tiny.tiny_chunked": 2}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_root):
    result, lines = run.run(cell, SEED, 0.2, False, root=tiny_root, device="cpu")
    assert result["correct"] is True, lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert result["checks"]["proofs_compared"]["value"] >= 1


class _Stub:
    """A system that answers a prove call with (call, position) pairs."""

    def __init__(self):
        self.calls, self.last_timings = 0, {}

    def prove_batch_chunked(self, jobs, seeds, chunk=64):
        self.calls += 1
        return [(self.calls, k) for k in range(len(jobs))]


@pytest.mark.parametrize("chunk,sample", [(8, 2), (8, 8), (8, 12), (3, 1), (1, 5)])
def test_prove_sample_takes_every_slot(chunk, sample):
    """A chunked mix compares at least one proof of each slot of a chunk,
    ceil(sample / chunk) of each, the same ones for the same seed."""
    from kkwbench import driver
    from kkwbench.program import Statement

    st = Statement(None, lambda rng, n: np.zeros((n, 2), dtype=np.uint8))
    mix = {"entry": "prove_batch_chunked", "statements_per_call": 64, "chunk": chunk,
           "warmup_calls": 1}

    def sampled(seed):
        m = driver.Mix(_Stub(), st, mix, seed, sample, 256, 40)
        for i in range(30):
            m.call(i)
        return [proof for _, proof in m.compared()]

    got = sampled(SEED)
    per = -(-sample // chunk)
    assert len(got) == chunk * per
    assert sorted(k % chunk for _, k in got) == sorted(list(range(chunk)) * per)
    assert got == sampled(SEED) and got != sampled(SEED + 1)


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in CELLS.items() for f in fs])
def test_fault_is_not_correct(cell, fault, tiny_root):
    result, lines = run.run(cell, SEED, 0.2, False, root=tiny_root, device="cpu",
                            make=make_faulty(fault, "verify" if cell.endswith("verify")
                                             else "prove", SLOTS.get(cell, 1)))
    assert result["correct"] is False, lines


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny_root):
    result, lines = run.run(cell, SEED, 0.2, False, root=tiny_root, device="cpu",
                            make=control.make)
    assert result["correct"] is False, lines
    assert result["checks"]["mismatched_proofs"]["value"] >= 1
    if cell.endswith("verify"):  # its verifier accepts every proof
        assert result["checks"]["wrong_tampered_verdicts"]["value"] >= 1


@pytest.fixture(scope="module")
def tiny_proofs():
    """Two proofs of the tiny statement from the port on the CPU, and its
    system."""
    from reverie_tpu_torch import make_system
    from reverie_tpu_torch.circuit.bincode import load_program_arrays
    from reverie_tpu_torch.params import ProtocolParams

    from kkwbench import program
    from kkwbench.statements import mul_bench

    rng = np.random.default_rng(7)
    st = mul_bench.make({"n_mul": 16}, rng)
    system = make_system(load_program_arrays(program.to_bincode(st.program)),
                         ProtocolParams(players=8, online_reps=40, total_reps=256),
                         device="cpu", hbm_budget_bytes=1 << 40)
    wit = st.witnesses(rng, 2)
    seeds = rng.integers(0, 256, (2, 256, 16), dtype=np.uint8)
    return system, system.prove_many([(w, []) for w in wit], seeds)


@pytest.mark.parametrize("kind", tamper.KINDS)
def test_port_rejects_each_tampered_kind(kind, tiny_proofs):
    system, proofs = tiny_proofs
    data = proofs[1].to_bytes()
    bad = tamper.tamper(data, kind)
    assert len(bad) == len(data) and sum(a != b for a, b in zip(bad, data)) == 1
    again = type(proofs[1]).from_bytes(bad)
    assert system.verify_many([proofs[0], again, proofs[1]]) == [True, False, True]


def test_tampered_fields_follow_the_layout(tiny_proofs):
    _, proofs = tiny_proofs
    p = proofs[0]
    data = p.to_bytes()
    at = tamper.fields(data)
    o = p.gf2.online[0]
    key = (o.omit + 1) % 8
    assert data[at["player_key"]:at["player_key"] + 16] == o.seeds[16 * key:16 * key + 16]
    assert data[at["broadcast"]:at["broadcast"] + len(o.recons)] == o.recons
    pre = p.gf2.preprocessing[0]
    assert data[at["unopened_seed"]:at["unopened_seed"] + 16] == pre.seed
    assert data[at["unopened_hash"]:at["unopened_hash"] + 32] == pre.comm_online
