"""Each configuration's program file, written by the benchmark's own
writer, equals the one the port's builder writes."""

from __future__ import annotations

import hashlib

import numpy as np

from kkwbench import program, spec as specs
from kkwbench.statements import mul_bench, sha256_preimage


def test_gf2_mul_1M_program_file():
    from reverie_tpu_torch.circuit.bincode import dumps_program
    from reverie_tpu_torch.circuit.builders import mul_bench_circuit

    n = specs.config(specs.load(), "gf2_mul_1M")["args"]["n_mul"]
    st = mul_bench.make({"n_mul": n}, np.random.default_rng(0))
    assert program.to_bincode(st.program) == dumps_program(mul_bench_circuit(n)[0])


def test_sha256_preimage_program_file_and_witness():
    from reverie_tpu_torch.circuit.bincode import dumps_program
    from reverie_tpu_torch.circuit.sha256 import (block_to_witness_bits, sha256_pad_one_block,
                                                  sha256_preimage_statement)

    args = specs.config(specs.load(), "sha256_preimage")["args"]
    seed = 2**31 + 7
    st = sha256_preimage.make(args, np.random.default_rng([seed, 0]))
    key = np.random.default_rng([seed, 0]).bytes(args["key_bytes"])
    prog, _ = sha256_preimage_statement(hashlib.sha256(key).digest())
    assert program.to_bincode(st.program) == dumps_program(prog)
    wit = st.witnesses(np.random.default_rng(1), 3)
    assert wit.shape == (3, 512)
    assert (wit == np.array(block_to_witness_bits(sha256_pad_one_block(key)))).all()


def test_writer_takes_every_gate():
    from reverie_tpu_torch.circuit.bincode import dumps_program
    from reverie_tpu_torch.circuit.ir import CombineOp, Gate, Op

    rows, ops = [], []
    for i, op in enumerate(Op):
        g = Gate(op, dst=i + 1, src1=i, src2=2 * i, const=5 if op != Op.MUL else 0)
        g = Gate(op, dst=g.dst if op != Op.ASSERT_ZERO else 0, src1=g.src1,
                 src2=g.src2 if op in (Op.ADD, Op.SUB, Op.MUL) else 0,
                 const=g.const if op in (Op.ADDC, Op.SUBC, Op.MULC, Op.CONST) else 0)
        for kind, make in ((program.GF2, CombineOp.gf2), (program.Z64, CombineOp.z64)):
            c = g.const & 1 if kind == program.GF2 else g.const
            rows.append((kind, int(op), g.dst, g.src1, g.src2, c))
            ops.append(make(Gate(op, g.dst, g.src1, g.src2, c)))
    rows += [(program.B2A, 0, 3, 64, 0, 0), (program.SIZE_HINT, 0, 10, 200, 0, 0)]
    ops += [CombineOp.b2a(3, 64), CombineOp.size_hint(10, 200)]
    assert program.to_bincode(program.from_rows(rows)) == dumps_program(ops)
