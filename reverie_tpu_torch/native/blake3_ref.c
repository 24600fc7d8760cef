/* Portable BLAKE3 implementation (hashing + XOF + same-length batch API).
 *
 * Host-side counterpart of the reference's blake3 usage:
 *   - BufferedHasher/PackedHasher   (reference src/crypto/hash.rs:13-116)
 *   - RandomOracle XOF              (reference src/crypto/ro.rs:3-21)
 * Written from the BLAKE3 specification; no code taken from any
 * implementation.  Correctness is cross-checked in tests against an
 * independent pure-Python implementation and official test vectors.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define B3_BLOCK 64
#define B3_CHUNK 1024

#define CHUNK_START 1u
#define CHUNK_END 2u
#define PARENT 4u
#define ROOT 8u

static const uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

static const uint8_t MSG_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

static inline uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static inline void g(uint32_t *v, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
    v[a] = v[a] + v[b] + mx;
    v[d] = rotr32(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr32(v[b] ^ v[c], 12);
    v[a] = v[a] + v[b] + my;
    v[d] = rotr32(v[d] ^ v[a], 8);
    v[c] = v[c] + v[d];
    v[b] = rotr32(v[b] ^ v[c], 7);
}

/* Full 16-word compression output (for XOF); v_out holds 16 words. */
static void compress_full(const uint32_t cv[8], const uint32_t block[16], uint64_t counter,
                          uint32_t block_len, uint32_t flags, uint32_t v_out[16]) {
    uint32_t v[16];
    uint32_t m[16];
    memcpy(v, cv, 32);
    v[8] = IV[0];
    v[9] = IV[1];
    v[10] = IV[2];
    v[11] = IV[3];
    v[12] = (uint32_t)counter;
    v[13] = (uint32_t)(counter >> 32);
    v[14] = block_len;
    v[15] = flags;
    memcpy(m, block, 64);
    for (int round = 0; round < 7; round++) {
        g(v, 0, 4, 8, 12, m[0], m[1]);
        g(v, 1, 5, 9, 13, m[2], m[3]);
        g(v, 2, 6, 10, 14, m[4], m[5]);
        g(v, 3, 7, 11, 15, m[6], m[7]);
        g(v, 0, 5, 10, 15, m[8], m[9]);
        g(v, 1, 6, 11, 12, m[10], m[11]);
        g(v, 2, 7, 8, 13, m[12], m[13]);
        g(v, 3, 4, 9, 14, m[14], m[15]);
        if (round != 6) {
            uint32_t nm[16];
            for (int i = 0; i < 16; i++) nm[i] = m[MSG_PERM[i]];
            memcpy(m, nm, 64);
        }
    }
    for (int i = 0; i < 8; i++) {
        v_out[i] = v[i] ^ v[i + 8];
        v_out[i + 8] = v[i + 8] ^ cv[i];
    }
}

static void words_from_le(const uint8_t *bytes, size_t nbytes, uint32_t out[16]) {
    uint8_t buf[64];
    memset(buf, 0, 64);
    memcpy(buf, bytes, nbytes);
    for (int i = 0; i < 16; i++) {
        out[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8) |
                 ((uint32_t)buf[4 * i + 2] << 16) | ((uint32_t)buf[4 * i + 3] << 24);
    }
}

/* Hash one chunk (<= 1024 bytes) at chunk index `counter`; writes the 8-word
 * chaining value.  If `root_out16` is non-NULL and this chunk is the root,
 * behavior is handled by caller instead. */
static void chunk_cv(const uint8_t *data, size_t len, uint64_t counter, uint32_t cv_out[8]) {
    uint32_t cv[8];
    memcpy(cv, IV, 32);
    size_t nblocks = (len + B3_BLOCK - 1) / B3_BLOCK;
    if (nblocks == 0) nblocks = 1;
    for (size_t i = 0; i < nblocks; i++) {
        size_t off = i * B3_BLOCK;
        size_t blen = len - off < B3_BLOCK ? len - off : B3_BLOCK;
        uint32_t block[16];
        words_from_le(data + off, blen, block);
        uint32_t flags = 0;
        if (i == 0) flags |= CHUNK_START;
        if (i == nblocks - 1) flags |= CHUNK_END;
        uint32_t out[16];
        compress_full(cv, block, counter, (uint32_t)blen, flags, out);
        memcpy(cv, out, 32);
    }
    memcpy(cv_out, cv, 32);
}

/* Root output state: cv, final block, block_len, flags -- XOF generates
 * 64-byte blocks by re-compressing with increasing counter. */
typedef struct {
    uint32_t cv[8];
    uint32_t block[16];
    uint32_t block_len;
    uint32_t flags; /* includes ROOT */
} b3_root_state;

static uint64_t round_down_pow2(uint64_t n) {
    uint64_t p = 1;
    while (p * 2 <= n) p *= 2;
    return p;
}

/* Compute the root state for a full message. */
static void b3_root(const uint8_t *data, size_t len, b3_root_state *rs) {
    size_t nchunks = len / B3_CHUNK + ((len % B3_CHUNK) || len == 0 ? 1 : 0);
    if (nchunks == 1) {
        /* single chunk: root is the chunk's last block */
        uint32_t cv[8];
        memcpy(cv, IV, 32);
        size_t nblocks = (len + B3_BLOCK - 1) / B3_BLOCK;
        if (nblocks == 0) nblocks = 1;
        for (size_t i = 0; i + 1 < nblocks; i++) {
            uint32_t block[16], out[16];
            words_from_le(data + i * B3_BLOCK, B3_BLOCK, block);
            uint32_t flags = (i == 0) ? CHUNK_START : 0;
            compress_full(cv, block, 0, B3_BLOCK, flags, out);
            memcpy(cv, out, 32);
        }
        size_t off = (nblocks - 1) * B3_BLOCK;
        size_t blen = len - off;
        memcpy(rs->cv, cv, 32);
        words_from_le(data + off, blen, rs->block);
        rs->block_len = (uint32_t)blen;
        rs->flags = ((nblocks == 1) ? CHUNK_START : 0) | CHUNK_END | ROOT;
        return;
    }
    /* multi-chunk: recursively reduce to two child CVs, root is PARENT */
    /* iterative stack-based reduction matching the left-biased tree:
       left subtree = largest power of two strictly less than nchunks */
    /* We implement recursion directly. */
    {
        /* recursive helper via explicit function */
        uint32_t lcv[8], rcv[8];
        /* declare a nested recursion using a static function pointer trick is
           awkward in C; use an explicit recursive function below. */
        extern void b3_subtree_cv(const uint8_t *data, size_t len, uint64_t chunk0, uint32_t cv_out[8]);
        uint64_t left_chunks = round_down_pow2(nchunks - 1);
        size_t left_len = (size_t)left_chunks * B3_CHUNK;
        b3_subtree_cv(data, left_len, 0, lcv);
        b3_subtree_cv(data + left_len, len - left_len, left_chunks, rcv);
        memcpy(rs->cv, IV, 32);
        memcpy(rs->block, lcv, 32);
        memcpy(rs->block + 8, rcv, 32);
        rs->block_len = 64;
        rs->flags = PARENT | ROOT;
    }
}

/* CV of a subtree spanning whole chunks (len is a multiple of CHUNK except
 * possibly the right-most subtree). */
void b3_subtree_cv(const uint8_t *data, size_t len, uint64_t chunk0, uint32_t cv_out[8]) {
    size_t nchunks = len / B3_CHUNK + ((len % B3_CHUNK) ? 1 : 0);
    if (nchunks <= 1) {
        chunk_cv(data, len, chunk0, cv_out);
        return;
    }
    uint64_t left_chunks = round_down_pow2(nchunks - 1);
    size_t left_len = (size_t)left_chunks * B3_CHUNK;
    uint32_t lcv[8], rcv[8];
    b3_subtree_cv(data, left_len, chunk0, lcv);
    b3_subtree_cv(data + left_len, len - left_len, chunk0 + left_chunks, rcv);
    uint32_t block[16], out[16];
    memcpy(block, lcv, 32);
    memcpy(block + 8, rcv, 32);
    compress_full(IV, block, 0, 64, PARENT, out);
    memcpy(cv_out, out, 32);
}

static void store_le(const uint32_t *w, int nwords, uint8_t *out) {
    for (int i = 0; i < nwords; i++) {
        out[4 * i] = (uint8_t)w[i];
        out[4 * i + 1] = (uint8_t)(w[i] >> 8);
        out[4 * i + 2] = (uint8_t)(w[i] >> 16);
        out[4 * i + 3] = (uint8_t)(w[i] >> 24);
    }
}

/* ---- public API ------------------------------------------------------- */

void blake3_hash(const uint8_t *data, size_t len, uint8_t out[32]) {
    b3_root_state rs;
    b3_root(data, len, &rs);
    uint32_t v[16];
    compress_full(rs.cv, rs.block, 0, rs.block_len, rs.flags, v);
    store_le(v, 8, out);
}

/* XOF: fill `out` with `outlen` bytes of the extended output. */
void blake3_xof(const uint8_t *data, size_t len, uint8_t *out, size_t outlen) {
    b3_root_state rs;
    b3_root(data, len, &rs);
    uint64_t counter = 0;
    size_t pos = 0;
    while (pos < outlen) {
        uint32_t v[16];
        uint8_t blockout[64];
        compress_full(rs.cv, rs.block, counter, rs.block_len, rs.flags, v);
        store_le(v, 16, blockout);
        size_t take = outlen - pos < 64 ? outlen - pos : 64;
        memcpy(out + pos, blockout, take);
        pos += take;
        counter++;
    }
}

/* Batch: hash `n` independent equal-length messages. */
void blake3_hash_many(const uint8_t *data, size_t n, size_t len, uint8_t *out /* n*32 */) {
    for (size_t i = 0; i < n; i++) {
        blake3_hash(data + i * len, len, out + i * 32);
    }
}
