"""Stream shapes shared by the BLAKE3 tests on the CPU
(tests/test_torch_blake3.py, against reverie_tpu and the host C blake3)
and on the card (tests/test_torch_package.py, the kernels against their
plain versions).  Not a test module, and free of jax: the card's machine
has none."""


def absorb_blocks(T: int, block: int):
    """(start, stop) of the blocks of `block` bytes that make a stream of T
    bytes, the last one short."""
    return [(i, min(i + block, T)) for i in range(0, T, block)]


#: (T, absorb size, R, the hasher's bound in node CVs): T = 0, a partial
#: chunk, 2, 3 and 5 whole chunks, 5 chunks ragged, each absorbed in blocks
#: of 1, 1023, 1024 and 1025 bytes, at the three legs' R in turn; the bound
#: 2 or 3 nodes (the held CVs paired into the CV stack past it) or none
#: reached
HASHER_CASES = [(T, a, (256, 40, 216)[i % 3], (None, 2, 3)[i % 3 if T == 5120 else i % 2])
                for i, (T, a) in enumerate((T, a) for T in (0, 700, 2048, 3072, 5120, 4796)
                                           for a in (1, 1023, 1024, 1025))]

#: stream lengths of the tail's cases: empty; inside one chunk (1 byte, a
#: block and a byte, 1,023 bytes); 1, 2, 3 and 5 whole chunks; 2, 3 and 5
#: chunks ragged (a byte, a block, a block and a byte into the last)
TAIL_LENGTHS = (0, 1, 65, 1023, 1024, 2048, 3072, 5120, 1024 + 1, 2048 + 64, 4096 + 65)

#: the widths: the three legs' R, a batch of two proofs (2 x 256), the
#: mesh's shard widths (12 shards of 256, 40 and 216 lanes) and none
TAIL_WIDTHS = (256, 40, 216, 512, 3, 4, 18, 21, 22, 0)

#: the four streams (pre2, onl2, prez, onlz) of a hash leg's cases: ragged
#: and whole chunks, a GF(2) circuit's empty z64 streams, all empty, and
#: single chunks beside longer streams
LEG_LENGTHS = ((5120, 4096 + 65, 0, 1023), (2048 + 64, 1, 65, 3072), (3072, 5120, 0, 0),
               (0, 0, 0, 0), (1024, 1024 + 1, 2048, 700))
