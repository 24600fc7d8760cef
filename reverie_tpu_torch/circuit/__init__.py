from . import dsl, sha256
from .bincode import dump_program, dumps_program, load_program
from .ir import CombineOp, Gate, Kind, Op, Program

__all__ = [
    "CombineOp",
    "Gate",
    "Kind",
    "Op",
    "Program",
    "dsl",
    "dump_program",
    "dumps_program",
    "load_program",
    "sha256",
]
