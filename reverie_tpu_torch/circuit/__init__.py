from . import dsl, sha256
from .bincode import dump_program, dumps_program, load_program
from .bristol import (
    BristolCircuit,
    bristol_to_program,
    bristol_with_output_assertion,
    parse_bristol,
)
from .eval import evaluate_composite_program
from .ir import CombineOp, Gate, Kind, Op, Program, largest_wires
from .witness import format_witness_bits, parse_witness_bits, parse_witness_file

__all__ = [
    "CombineOp",
    "Gate",
    "Kind",
    "Op",
    "Program",
    "largest_wires",
    "evaluate_composite_program",
    "dump_program",
    "dumps_program",
    "load_program",
    "BristolCircuit",
    "bristol_to_program",
    "bristol_with_output_assertion",
    "parse_bristol",
    "format_witness_bits",
    "parse_witness_bits",
    "parse_witness_file",
    "dsl",
    "sha256",
]
