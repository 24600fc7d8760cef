/* AES-128-CTR keystream generation (the KKW random tape PRG).
 *
 * Matches the reference PRG exactly (reference src/crypto/prg.rs:13-38):
 * AES-128, zero IV, 128-bit big-endian counter (Ctr128BE), keystream =
 * E_k(counter) for counter = 0,1,2,...  `gen` produces raw keystream
 * (the reference zeroes the buffer then XORs the keystream in).
 *
 * AES-NI fast path with a portable bytewise fallback; runtime dispatch.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#include <wmmintrin.h>
#define HAVE_X86 1
#endif

/* ---------------- portable AES-128 ------------------------------------ */

static const uint8_t SBOX[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
};

static const uint8_t RCON[11] = {0x00, 0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b, 0x36};

static void key_expand_portable(const uint8_t key[16], uint8_t rk[176]) {
    memcpy(rk, key, 16);
    for (int i = 4; i < 44; i++) {
        uint8_t t[4];
        memcpy(t, rk + 4 * (i - 1), 4);
        if (i % 4 == 0) {
            uint8_t tmp = t[0];
            t[0] = SBOX[t[1]] ^ RCON[i / 4];
            t[1] = SBOX[t[2]];
            t[2] = SBOX[t[3]];
            t[3] = SBOX[tmp];
        }
        for (int j = 0; j < 4; j++) rk[4 * i + j] = rk[4 * (i - 4) + j] ^ t[j];
    }
}

static inline uint8_t xtime(uint8_t x) { return (uint8_t)((x << 1) ^ ((x >> 7) * 0x1b)); }

static void aes128_encrypt_portable(const uint8_t rk[176], const uint8_t in[16], uint8_t out[16]) {
    uint8_t s[16];
    for (int i = 0; i < 16; i++) s[i] = in[i] ^ rk[i];
    for (int round = 1; round <= 10; round++) {
        uint8_t t[16];
        /* SubBytes + ShiftRows */
        for (int c = 0; c < 4; c++) {
            t[4 * c + 0] = SBOX[s[(4 * c + 0) % 16]];
            t[4 * c + 1] = SBOX[s[(4 * (c + 1) + 1) % 16]];
            t[4 * c + 2] = SBOX[s[(4 * (c + 2) + 2) % 16]];
            t[4 * c + 3] = SBOX[s[(4 * (c + 3) + 3) % 16]];
        }
        if (round < 10) {
            /* MixColumns */
            for (int c = 0; c < 4; c++) {
                uint8_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2], a3 = t[4 * c + 3];
                uint8_t x = a0 ^ a1 ^ a2 ^ a3;
                s[4 * c + 0] = a0 ^ x ^ xtime(a0 ^ a1);
                s[4 * c + 1] = a1 ^ x ^ xtime(a1 ^ a2);
                s[4 * c + 2] = a2 ^ x ^ xtime(a2 ^ a3);
                s[4 * c + 3] = a3 ^ x ^ xtime(a3 ^ a0);
            }
        } else {
            memcpy(s, t, 16);
        }
        for (int i = 0; i < 16; i++) s[i] ^= rk[16 * round + i];
    }
    memcpy(out, s, 16);
}

/* ---------------- AES-NI path ------------------------------------------ */

#ifdef HAVE_X86
__attribute__((target("aes,sse2")))
static __m128i aes_keygen_assist(__m128i tmp, __m128i assist) {
    assist = _mm_shuffle_epi32(assist, 0xff);
    tmp = _mm_xor_si128(tmp, _mm_slli_si128(tmp, 4));
    tmp = _mm_xor_si128(tmp, _mm_slli_si128(tmp, 4));
    tmp = _mm_xor_si128(tmp, _mm_slli_si128(tmp, 4));
    return _mm_xor_si128(tmp, assist);
}

__attribute__((target("aes,sse2")))
static void key_expand_ni(const uint8_t key[16], __m128i rk[11]) {
    rk[0] = _mm_loadu_si128((const __m128i *)key);
#define EXP(i, rc) rk[i] = aes_keygen_assist(rk[i - 1], _mm_aeskeygenassist_si128(rk[i - 1], rc))
    EXP(1, 0x01); EXP(2, 0x02); EXP(3, 0x04); EXP(4, 0x08); EXP(5, 0x10);
    EXP(6, 0x20); EXP(7, 0x40); EXP(8, 0x80); EXP(9, 0x1b); EXP(10, 0x36);
#undef EXP
}

/* big-endian 128-bit counter as __m128i (byte-reversed increment) */
__attribute__((target("aes,sse2")))
static void ctr_keystream_ni(const uint8_t key[16], uint64_t start_block, uint8_t *out,
                             size_t nblocks) {
    __m128i rk[11];
    key_expand_ni(key, rk);
    for (size_t i = 0; i < nblocks; i += 8) {
        __m128i blocks[8];
        size_t n = nblocks - i < 8 ? nblocks - i : 8;
        for (size_t j = 0; j < n; j++) {
            uint64_t ctr = start_block + i + j;
            /* 128-bit big-endian counter: bytes 0..7 zero, bytes 8..15 BE64 */
            __m128i c = _mm_set_epi64x((long long)__builtin_bswap64(ctr), 0);
            blocks[j] = _mm_xor_si128(c, rk[0]);
        }
        for (int r = 1; r < 10; r++)
            for (size_t j = 0; j < n; j++) blocks[j] = _mm_aesenc_si128(blocks[j], rk[r]);
        for (size_t j = 0; j < n; j++) {
            blocks[j] = _mm_aesenclast_si128(blocks[j], rk[10]);
            _mm_storeu_si128((__m128i *)(out + (i + j) * 16), blocks[j]);
        }
    }
}

static int have_aesni(void) {
    static int cached = -1;
    if (cached < 0) cached = __builtin_cpu_supports("aes") && __builtin_cpu_supports("ssse3");
    return cached;
}
#endif

static void ctr_keystream_portable(const uint8_t key[16], uint64_t start_block, uint8_t *out,
                                   size_t nblocks) {
    uint8_t rk[176];
    key_expand_portable(key, rk);
    for (size_t i = 0; i < nblocks; i++) {
        uint8_t ctr[16] = {0};
        uint64_t c = start_block + i;
        /* 128-bit big-endian counter; we only ever need the low 64 bits */
        for (int j = 0; j < 8; j++) ctr[15 - j] = (uint8_t)(c >> (8 * j));
        aes128_encrypt_portable(rk, ctr, out + i * 16);
    }
}

/* ---- public API ------------------------------------------------------- */

/* Raw AES-128-CTR keystream: nbytes must be a multiple of 16. */
void aes128_ctr_keystream(const uint8_t key[16], uint64_t start_block, uint8_t *out,
                          size_t nbytes) {
    size_t nblocks = nbytes / 16;
#ifdef HAVE_X86
    if (have_aesni()) {
        ctr_keystream_ni(key, start_block, out, nblocks);
        return;
    }
#endif
    ctr_keystream_portable(key, start_block, out, nblocks);
}

/* Batched keystream: `n` keys, each generating `nbytes` of keystream. */
void aes128_ctr_keystream_batch(const uint8_t *keys /* n*16 */, uint64_t start_block,
                                uint8_t *out /* n*nbytes */, size_t n, size_t nbytes) {
    for (size_t i = 0; i < n; i++) {
        aes128_ctr_keystream(keys + 16 * i, start_block, out + nbytes * i, nbytes);
    }
}

/* Single-block AES-128 encrypt (for KATs). */
void aes128_encrypt_block(const uint8_t key[16], const uint8_t in[16], uint8_t out[16]) {
    uint8_t rk[176];
    key_expand_portable(key, rk);
    aes128_encrypt_portable(rk, in, out);
}

/* AES-128 round keys (11*16 bytes) -- used to feed the TPU Pallas kernel. */
void aes128_key_expand(const uint8_t key[16], uint8_t rk[176]) {
    key_expand_portable(key, rk);
}

void aes128_key_expand_batch(const uint8_t *keys, uint8_t *rks, size_t n) {
    for (size_t i = 0; i < n; i++) key_expand_portable(keys + 16 * i, rks + 176 * i);
}
