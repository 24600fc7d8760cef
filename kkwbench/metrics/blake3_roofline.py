"""blake3_roofline.prove / .verify: the transcript hash, K3 (the chunk
kernel, blake3_chunk_cvs_kernel) and the tail (blake3_tail_kernel), against
their bounds.  Each leg hashes its streams a rep: a prove and an online
verify the GF(2) and Z_2^64 online and preprocessing streams, a
preprocessing verify the two preprocessing ones (the online hashes are the
committed ones).  K3 takes a stream's chunks but its last, one launch a
stream of more than one chunk: its rows read once, its CVs written once, 16
compressions a chunk (tools/k3_times.py's case_bound).  The tail, one
launch a leg, reads each stream's held CVs and last chunk once and writes
its hash, compressing the tree's parents and the last chunk's blocks, then
the three pair hashes (roofline.blake3_tail_work, blake3_pairs_work)."""

from kkwbench.driver import VERIFY_PRE
from kkwbench.metrics._roofline import legs, share
from kkwbench.peaks import BLAKE3_COMPRESSION_INT_OPS, BLAKE3_NODE_INT_OPS

CHUNK = 1024


def chunks_work(n: int, R: int):
    """K3 on n whole chunks of R columns."""
    return n * CHUNK * R + 8 * n * R * 4, n * R * 16 * BLAKE3_COMPRESSION_INT_OPS


def tail_work(n_chunks: int, tail_len: int, R: int):
    """The tail of one stream of n_chunks chunks, the last of tail_len bytes."""
    blocks = max(1, -(-tail_len // 64))
    return ((n_chunks - 1) * 32 + tail_len + 32) * R, (n_chunks - 1 + blocks) * R * BLAKE3_NODE_INT_OPS


def pairs_work(R: int, pairs: int = 3):
    return (pairs + 2) * 32 * R, pairs * R * BLAKE3_NODE_INT_OPS


def leg_work(lengths, R: int):
    """[(bytes, ops)] of a leg's K3 launches and its tail launch, the leg
    hashing streams of these byte lengths a rep."""
    k3, tb, to = [], 0, 0
    for T in lengths:
        n = max(1, -(-T // CHUNK))
        if n > 1:
            k3.append(chunks_work(n - 1, R))
        b, o = tail_work(n, T - (n - 1) * CHUNK, R)
        tb, to = tb + b, to + o
    b, o = pairs_work(R)
    return k3 + [(tb + b, to + o)]


def read(window, part):
    s = window.shape
    bounds = []
    for role, R in legs(window, part):
        lengths = (s.n_pre, 0) if role == VERIFY_PRE else (s.n_pre, s.n_onl, 0, 0)
        bounds += leg_work(lengths, R)
    return share(window, "blake3_", bounds)
