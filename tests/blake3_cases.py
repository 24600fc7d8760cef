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

#: the chunk kernel's (csrc/blake3_chunks.cu) cases, (R, chunks, chunk base,
#: the buffer's bytes past a 16-byte boundary), on each route: the legs'
#: widths (rows at 256, span40, span216), a batch (2,048) and the SHA-256
#: chunk of 64 proofs (16,384 at 21 and 22 chunks) on rows, the mesh's shard
#: widths on span, a ragged rows tile (272), rows_shifted (300, and 16,384
#: and 272 on buffers 3 bytes past a 16-byte boundary); buffers
#: 1, 3, 5, 8 and 13 bytes past a boundary; one chunk; chunk bases whose
#: chunks cross 2^32
CHUNK_CASES = ((256, 3, 0, 0), (40, 2, 7, 0), (216, 1, 1, 0), (2048, 2, 5, 0),
               (16_384, 21, 0, 0), (16_384, 22, 0, 3), (3, 5, 0, 0), (4, 5, 0, 0),
               (18, 3, 0, 0), (21, 4, 0, 0), (22, 4, 0, 0), (272, 2, 0, 0), (300, 2, 0, 0),
               (300, 3, 9, 5), (256, 3, 0, 1), (40, 9, 0, 3), (216, 2, 0, 8), (21, 7, 2, 13),
               (256, 1, 0, 0), (40, 1, 0, 0), (1, 3, 0, 0), (256, 4, 2**32 - 2, 0),
               (40, 6, 2**32 - 3, 1), (272, 2, 0, 3))

#: the widths the chunk kernel's plan is checked at: the cases' and a batch
#: of verifies (8 x 40)
CHUNK_WIDTHS = (1, 3, 4, 18, 21, 22, 40, 216, 256, 272, 300, 320, 2048, 16_384)
