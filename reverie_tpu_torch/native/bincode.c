/* Program files (bincode `Vec<CombineOperation>`) to and from op arrays.
 *
 * circuit/bincode.py's load_program makes a CombineOp and a Gate in Python
 * for every op of a file, a few microseconds an op; these two passes read
 * and write the arrays of circuit/compile_native.py's OpArrays instead:
 *
 *   rb_read   one pass over the file bytes: each record decoded into the
 *             table of distinct ops (found by hashing the decoded record;
 *             a record equal to the one before it reuses its row), and per
 *             op its row in the table;
 *   rb_write  records [lo, hi) of a program from its table and codes, in
 *             dump_program's bytes.
 *
 * The format (bincode 1.3 defaults): the op count u64, then per op a u32
 * kind tag (GF2, Z64, B2A, SIZE_HINT); a gate's u32 opcode tag and its
 * fields, wires u64 and the constant one byte in GF2 and a u64 in Z64;
 * B2A and SIZE_HINT two u64.  All little-endian.  A table row holds the
 * decoded fields, zero where the record has none, and op -1 for B2A and
 * SIZE_HINT; a GF2 constant is the byte as read.  Wire ids are kept as
 * read (u64 stored in int64: the renumbering needs only their order-free
 * identity).  The Python reader stays as the plain twin, equal array for
 * array (tests/test_torch_bincode_arrays.py), and raises the errors.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum { K_GF2 = 0, K_Z64 = 1, K_B2A = 2, K_HINT = 3 };
enum { O_INPUT = 0, O_RANDOM, O_ADD, O_ADDC, O_SUB, O_SUBC, O_MUL, O_MULC, O_ASSERT, O_CONST,
       N_OPS };

/* per opcode, its fields in record order: d the destination wire, s a
 * source wire (src1, then src2), each a u64; c the constant */
static const char *const FIELDS[N_OPS] = {"d", "d", "dss", "dsc", "dss", "dsc", "dss", "dsc",
                                          "s", "dc"};

typedef struct {
    int8_t *kind, *op;                       /* (cap_rows,) the table */
    int64_t *dst, *src1, *src2, *a, *b;
    uint64_t *cst;
    int64_t cap_rows;
} table_t;

typedef struct {
    int8_t kind, op;
    int64_t dst, src1, src2, a, b;
    uint64_t cst;
} rec_t;

static inline uint64_t rd64(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v; /* little-endian hosts only, as the rest of the library */
}

static inline uint32_t rd32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

/* Decode the record at buf[pos]; returns its length, 0 if it is truncated
 * or has an unknown tag. */
static int64_t decode(const uint8_t *buf, int64_t len, int64_t pos, rec_t *r) {
    memset(r, 0, sizeof *r);
    int64_t p = pos;
    if (len - p < 4)
        return 0;
    uint32_t kind = rd32(buf + p);
    p += 4;
    if (kind > K_HINT)
        return 0;
    r->kind = (int8_t)kind;
    r->op = -1;
    if (kind == K_B2A || kind == K_HINT) {
        if (len - p < 16)
            return 0;
        r->a = (int64_t)rd64(buf + p);
        r->b = (int64_t)rd64(buf + p + 8);
        return p + 16 - pos;
    }
    if (len - p < 4)
        return 0;
    uint32_t op = rd32(buf + p);
    p += 4;
    if (op >= N_OPS)
        return 0;
    r->op = (int8_t)op;
    int wire = 0;
    for (const char *f = FIELDS[op]; *f; f++) {
        if (*f == 'c') {
            int w = kind == K_GF2 ? 1 : 8;
            if (len - p < w)
                return 0;
            r->cst = kind == K_GF2 ? buf[p] : rd64(buf + p);
            p += w;
            continue;
        }
        if (len - p < 8)
            return 0;
        int64_t v = (int64_t)rd64(buf + p);
        p += 8;
        if (*f == 'd') {
            r->dst = v;
            wire = 1;
        } else if (wire == 1) {
            r->src1 = v;
            wire = 2;
        } else if (op == O_ASSERT) {
            r->src1 = v;
        } else {
            r->src2 = v;
        }
    }
    return p - pos;
}

static inline uint64_t mix(uint64_t h, uint64_t v) {
    h ^= v + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    h *= 0xff51afd7ed558ccdull;
    return h ^ (h >> 33);
}

static uint64_t rec_hash(const rec_t *r) {
    uint64_t h = (uint64_t)(uint8_t)r->kind << 8 | (uint8_t)r->op;
    h = mix(h, (uint64_t)r->dst);
    h = mix(h, (uint64_t)r->src1);
    h = mix(h, (uint64_t)r->src2);
    h = mix(h, r->cst);
    h = mix(h, (uint64_t)r->a);
    return mix(h, (uint64_t)r->b);
}

static inline int row_equal(const table_t *t, int64_t u, const rec_t *r) {
    return t->kind[u] == r->kind && t->op[u] == r->op && t->dst[u] == r->dst &&
           t->src1[u] == r->src1 && t->src2[u] == r->src2 && t->cst[u] == r->cst &&
           t->a[u] == r->a && t->b[u] == r->b;
}

/* Read the `count` records after the 8-byte count of buf[0, len): per op
 * its row (code, (cap_ops,)), the table's rows (n_rows), the ops read
 * (n_ops) and pos, the offset after the last record read.  Returns 0 when
 * every record was read and pos == len; 1 when record n_ops at pos is
 * truncated or has an unknown tag, or a table is full; 2 when bytes
 * trail the last record (at pos); -1 when out of memory. */
int rb_read(const uint8_t *buf, int64_t len, int64_t count, int32_t *code, int64_t cap_ops,
            table_t *t, int64_t *n_rows, int64_t *n_ops, int64_t *pos) {
    int64_t slots = 1024, rows = 0, p = 8, i = 0;
    uint32_t *hash = calloc((size_t)slots, sizeof *hash); /* row + 1 per slot, 0 if free */
    int rc = 0;
    if (!hash)
        return -1;
    const uint8_t *prev = NULL;
    int64_t prev_len = 0;
    int32_t prev_code = 0;
    for (; i < count; i++) {
        rec_t r;
        int64_t n = decode(buf, len, p, &r);
        if (n == 0 || i >= cap_ops) {
            rc = 1;
            break;
        }
        if (prev && n == prev_len && memcmp(buf + p, prev, (size_t)n) == 0) {
            code[i] = prev_code; /* a run of one op: no hashing */
            prev = buf + p;
            p += n;
            continue;
        }
        uint64_t h = rec_hash(&r);
        int64_t s = (int64_t)(h & (uint64_t)(slots - 1));
        while (hash[s] && !row_equal(t, hash[s] - 1, &r))
            s = (s + 1) & (slots - 1);
        if (!hash[s]) {
            if (rows >= t->cap_rows) {
                rc = 1;
                break;
            }
            t->kind[rows] = r.kind;
            t->op[rows] = r.op;
            t->dst[rows] = r.dst;
            t->src1[rows] = r.src1;
            t->src2[rows] = r.src2;
            t->cst[rows] = r.cst;
            t->a[rows] = r.a;
            t->b[rows] = r.b;
            hash[s] = (uint32_t)++rows;
            if (rows * 2 > slots) { /* grow: rehash every row */
                uint32_t *grown = calloc((size_t)slots * 2, sizeof *grown);
                if (!grown) {
                    free(hash);
                    return -1;
                }
                slots *= 2;
                for (int64_t u = 0; u < rows; u++) {
                    rec_t q = {t->kind[u], t->op[u], t->dst[u], t->src1[u], t->src2[u],
                               t->a[u], t->b[u], t->cst[u]};
                    int64_t k = (int64_t)(rec_hash(&q) & (uint64_t)(slots - 1));
                    while (grown[k])
                        k = (k + 1) & (slots - 1);
                    grown[k] = (uint32_t)(u + 1);
                }
                free(hash);
                hash = grown;
                s = -1;
            }
        }
        prev_code = code[i] = (int32_t)(s >= 0 ? hash[s] - 1 : rows - 1);
        prev = buf + p;
        prev_len = n;
        p += n;
    }
    free(hash);
    *n_rows = rows;
    *n_ops = i;
    *pos = p;
    if (rc == 0 && p != len)
        rc = 2;
    return rc;
}

static inline uint8_t *put64(uint8_t *o, uint64_t v) {
    memcpy(o, &v, 8);
    return o + 8;
}

static inline uint8_t *put32(uint8_t *o, uint32_t v) {
    memcpy(o, &v, 4);
    return o + 4;
}

/* The record of table row u at o; returns the end. */
static uint8_t *encode(const table_t *t, int64_t u, uint8_t *o) {
    int kind = t->kind[u];
    o = put32(o, (uint32_t)kind);
    if (kind == K_B2A || kind == K_HINT) {
        o = put64(o, (uint64_t)t->a[u]);
        return put64(o, (uint64_t)t->b[u]);
    }
    int op = t->op[u];
    o = put32(o, (uint32_t)op);
    int wire = 0;
    for (const char *f = FIELDS[op]; *f; f++) {
        if (*f == 'c') {
            if (kind == K_GF2)
                *o++ = (uint8_t)(t->cst[u] & 1);
            else
                o = put64(o, t->cst[u]);
        } else if (*f == 'd') {
            o = put64(o, (uint64_t)t->dst[u]);
            wire = 1;
        } else if (wire == 1 || op == O_ASSERT) {
            o = put64(o, (uint64_t)t->src1[u]);
            wire = 2;
        } else {
            o = put64(o, (uint64_t)t->src2[u]);
        }
    }
    return o;
}

/* The records of ops [lo, hi) (rows code[lo..hi) of the table) into out,
 * which the caller sized; returns the bytes written. */
int64_t rb_write(const table_t *t, const int32_t *code, int64_t lo, int64_t hi, uint8_t *out) {
    uint8_t *o = out, *prev = NULL;
    int64_t prev_len = 0;
    for (int64_t i = lo; i < hi; i++) {
        if (prev && code[i] == code[i - 1]) {
            memcpy(o, prev, (size_t)prev_len);
            prev = o;
            o += prev_len;
            continue;
        }
        uint8_t *end = encode(t, code[i], o);
        prev = o;
        prev_len = end - o;
        o = end;
    }
    return o - out;
}
