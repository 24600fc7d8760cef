"""Bristol-format circuit ingestion; the port's copy of
reverie_tpu/circuit/bristol.py.

The reference README advertises "statements specified in Bristol format"
(README.md:14-15); the actual parsing lives in the external mcircuit crate.
This module provides a native parser for "Bristol fashion" circuits
(https://nigelsmart.github.io/MPC-Circuits/ conventions):

    <ngates> <nwires>
    <n_input_vals> <in0_bits> <in1_bits> ...
    <n_output_vals> <out0_bits> ...
    <blank>
    <nin> <nout> <in...> <out...> <GATE>

Gate set: XOR, AND, INV/NOT, EQ (const), EQW (copy), MAND (multi-AND).
Output: a GF2 `CombineOp` program over the same wire numbering, with inputs
emitted as `Input` gates in wire order.
"""

from __future__ import annotations

from typing import List, Sequence, TextIO, Tuple

from .ir import CombineOp, Gate, Kind, Op


class BristolCircuit:
    def __init__(
        self,
        ngates: int,
        nwires: int,
        input_sizes: List[int],
        output_sizes: List[int],
        gates: List[Tuple[List[int], List[int], str]],
    ):
        self.ngates = ngates
        self.nwires = nwires
        self.input_sizes = input_sizes
        self.output_sizes = output_sizes
        self.gates = gates  # (inputs, outputs, kind)

    @property
    def n_input_bits(self) -> int:
        return sum(self.input_sizes)

    @property
    def n_output_bits(self) -> int:
        return sum(self.output_sizes)

    def output_wires(self) -> List[int]:
        """Bristol fashion: outputs occupy the last sum(output_sizes) wires."""
        n = self.n_output_bits
        return list(range(self.nwires - n, self.nwires))


def parse_bristol(text: str) -> BristolCircuit:
    lines = [ln.split() for ln in text.splitlines() if ln.strip()]
    ngates, nwires = int(lines[0][0]), int(lines[0][1])
    in_hdr = [int(x) for x in lines[1]]
    out_hdr = [int(x) for x in lines[2]]
    input_sizes = in_hdr[1 : 1 + in_hdr[0]]
    output_sizes = out_hdr[1 : 1 + out_hdr[0]]
    gates = []
    for parts in lines[3:]:
        nin, nout = int(parts[0]), int(parts[1])
        ins = [int(x) for x in parts[2 : 2 + nin]]
        outs = [int(x) for x in parts[2 + nin : 2 + nin + nout]]
        kind = parts[2 + nin + nout].upper()
        gates.append((ins, outs, kind))
    if len(gates) != ngates:
        raise ValueError(f"expected {ngates} gates, parsed {len(gates)}")
    return BristolCircuit(ngates, nwires, input_sizes, output_sizes, gates)


def bristol_to_program(circ: BristolCircuit) -> List[CombineOp]:
    """Lower a Bristol circuit to a GF2 program (inputs as Input gates)."""
    prog: List[CombineOp] = [CombineOp.size_hint(1, circ.nwires)]
    for w in range(circ.n_input_bits):
        prog.append(CombineOp.gf2(Gate(Op.INPUT, dst=w)))
    for ins, outs, kind in circ.gates:
        if kind == "XOR":
            prog.append(CombineOp.gf2(Gate(Op.ADD, dst=outs[0], src1=ins[0], src2=ins[1])))
        elif kind == "AND":
            prog.append(CombineOp.gf2(Gate(Op.MUL, dst=outs[0], src1=ins[0], src2=ins[1])))
        elif kind in ("INV", "NOT"):
            prog.append(CombineOp.gf2(Gate(Op.ADDC, dst=outs[0], src1=ins[0], const=1)))
        elif kind == "EQ":  # constant gate: input is a literal 0/1
            prog.append(CombineOp.gf2(Gate(Op.CONST, dst=outs[0], const=ins[0] & 1)))
        elif kind == "EQW":  # wire copy
            prog.append(CombineOp.gf2(Gate(Op.ADDC, dst=outs[0], src1=ins[0], const=0)))
        elif kind == "MAND":  # multi-AND: pairwise ins -> outs
            half = len(ins) // 2
            for k in range(len(outs)):
                prog.append(
                    CombineOp.gf2(Gate(Op.MUL, dst=outs[k], src1=ins[k], src2=ins[half + k]))
                )
        else:
            raise ValueError(f"unsupported Bristol gate kind {kind}")
    return prog


def bristol_with_output_assertion(
    circ: BristolCircuit, expected_bits: Sequence[int]
) -> List[CombineOp]:
    """Lower Bristol circuit and assert its outputs equal `expected_bits`.

    This is how a "prove knowledge of preimage" statement is formed: the
    circuit outputs are XORed with the public expected value and each
    resulting bit is asserted zero.
    """
    outs = circ.output_wires()
    if len(expected_bits) != len(outs):
        raise ValueError("expected_bits length mismatch")
    prog = bristol_to_program(circ)
    # scratch wires above the arena
    scratch = circ.nwires
    prog[0] = CombineOp.size_hint(1, circ.nwires + len(outs))
    for i, (w, bit) in enumerate(zip(outs, expected_bits)):
        s = scratch + i
        prog.append(CombineOp.gf2(Gate(Op.ADDC, dst=s, src1=w, const=bit & 1)))
        prog.append(CombineOp.gf2(Gate(Op.ASSERT_ZERO, src1=s)))
    return prog
