/* The levelizing circuit compile over op arrays: one pass per segment, in C.
 *
 * circuit/compile.py's compile_program and compile_segments walk a list of
 * op objects in Python, a few microseconds an op; circuit/compile_native.py
 * lowers the program to arrays (a table of its distinct ops, and per op a
 * code into it) and these two passes do the per-op work:
 *
 *   rc_carry_scan  the carry pass of compile_segments over one segment:
 *                  per domain the segment that last wrote each wire; a read
 *                  of a wire an earlier segment wrote is a carry-in of this
 *                  segment (listed once) and a carry-out of that one (listed
 *                  once, with the value it had there at its end);
 *   rc_compile     compile_program over one segment: SSA values, levels,
 *                  the tape, stream, witness and record counters of each
 *                  domain and the B2A expansion, in program order, writing
 *                  one row per emitted gate; emit = 0 counts only (the
 *                  totals and the levels, no rows).
 *
 * Wire ids are the caller's dense renumbering of the program's wires, one
 * per domain, in the order of the wire ids (so sorting either sorts both).  A
 * wire's value map is stamped with the segment's epoch, so a segment
 * starts from an empty map without clearing it.  The Python compile stays
 * as the plain twin, equal field for field (tests/test_torch_compile.py).
 */

#include <stdint.h>
#include <stddef.h>

enum { K_GF2 = 0, K_Z64 = 1, K_B2A = 2 };
enum { O_INPUT = 0, O_RANDOM, O_ADD, O_ADDC, O_SUB, O_SUBC, O_MUL, O_MULC, O_ASSERT, O_CONST };
enum { G_INPUT = 0, G_ADD, G_ADDC, G_SUBC, G_MULC, G_MUL, G_ASSERT, G_RANDOM, G_CONST, Z_SUB,
       B2A_CORR, B2A_OUT };
#define N_KINDS 12

/* the columns of a row, (NCOL, cap) int32 column-major */
enum { C_LVL = 0, C_KEY, C_DST, C_A, C_B, C_TAPE, C_WIT, C_ONL, C_REC, C_PRE, C_CORR, C_ZR,
       C_BITS, NCOL };
/* the record slot lists, in out_t.slots */
enum { S_IN2 = 0, S_CO2, S_RE2, S_INZ, S_COZ, S_REZ, NSLOT };

typedef struct {
    const int32_t *code; /* (n,) the op's row in the table */
    const int8_t *kind;  /* the table: (U,) each */
    const int8_t *op;
    const int64_t *dst, *src1, *src2, *a, *b; /* B2A: a its z64 wire, b its row of bsrc */
    const uint64_t *cst;
    const int64_t *bsrc;                      /* (B2A ops, 64) the GF(2) wires each reads */
} ops_t;

typedef struct {
    int32_t *map;      /* (wires,) wire -> value, valid where stamp == epoch */
    int32_t *stamp;    /* (wires,) */
    int32_t *last;     /* (wires,) the value of each wire's last write */
    int32_t *vlevel;   /* (vcap,) each value's level */
    int64_t vcap;
    int64_t n_vals, tape, onl, pre, wit, n_inputs, n_corrs, n_recons;
} dom_t;

typedef struct {
    int emit;
    int64_t cap;           /* rows the column arrays hold */
    int32_t *col;          /* (NCOL, cap) */
    uint64_t *cst;         /* (cap,) */
    int32_t *bits;         /* (bits_cap, 64) */
    int64_t bits_cap;
    int64_t *slots[NSLOT]; /* each sized exactly by the caller */
    int64_t slot_cap[NSLOT];
    uint8_t *level_used;   /* (levels_cap,) */
    int64_t levels_cap;
    /* results */
    int64_t n_rows, n_bits, n_slots[NSLOT], overflow;
} out_t;

static inline int32_t rd(const dom_t *d, int64_t w, int32_t epoch) {
    return d->stamp[w] == epoch ? d->map[w] : 0;
}

static inline int32_t fresh(dom_t *d, int32_t level, out_t *o) {
    if (d->n_vals >= d->vcap) {
        o->overflow = 1;
        return 0;
    }
    d->vlevel[d->n_vals] = level;
    return (int32_t)d->n_vals++;
}

static inline int32_t wr(dom_t *d, int64_t w, int32_t level, int32_t epoch, out_t *o) {
    int32_t v = fresh(d, level, o);
    d->map[w] = v;
    d->stamp[w] = epoch;
    d->last[w] = v;
    return v;
}

/* the next row, at `level`: NULL when counting only (or out of room),
 * and then every SET on it is skipped */
static inline int32_t *row(out_t *o, int32_t level, int domain, int kind) {
    if (level >= o->levels_cap) {
        o->overflow = 1;
        return NULL;
    }
    o->level_used[level] = 1;
    if (!o->emit)
        return NULL;
    if (o->n_rows >= o->cap) {
        o->overflow = 1;
        return NULL;
    }
    int32_t *r = o->col + o->n_rows++;
    r[C_LVL * o->cap] = level;
    r[C_KEY * o->cap] = domain * N_KINDS + kind;
    return r;
}

#define SET(r, c, v) do { if (r) (r)[(int64_t)(c) * o->cap] = (int32_t)(v); } while (0)

static inline void set_cst(out_t *o, const int32_t *r, uint64_t c) {
    if (r)
        o->cst[r - o->col] = c;
}

static inline void slot(out_t *o, int which, int64_t v) {
    if (!o->emit)
        return;
    if (o->n_slots[which] >= o->slot_cap[which]) {
        o->overflow = 1;
        return;
    }
    o->slots[which][o->n_slots[which]++] = v;
}

/* the 64 value slots of a B2A row's 'bits' (a scratch row when r is NULL) */
static inline int32_t *bits_row(out_t *o, int32_t *r, int32_t *scratch) {
    if (!r)
        return scratch;
    if (o->n_bits >= o->bits_cap) {
        o->overflow = 1;
        return scratch;
    }
    SET(r, C_BITS, o->n_bits);
    return o->bits + 64 * o->n_bits++;
}

static inline int32_t lmax(int32_t x, int32_t y) { return x > y ? x : y; }

/* one gate of a domain (compile.py emit_gate); -1, or the bad opcode */
static int gate(dom_t *d, int domain, int op, int64_t dst, int64_t s1, int64_t s2, uint64_t c,
                int32_t epoch, out_t *o) {
    int ev_in = domain == K_GF2 ? 1 : 8, ev_sh = domain == K_GF2 ? 1 : 64;
    int si = domain == K_GF2 ? S_IN2 : S_INZ;
    int sc = domain == K_GF2 ? S_CO2 : S_COZ;
    int sr = domain == K_GF2 ? S_RE2 : S_REZ;
    int32_t a, b, v, lvl, *r;
    switch (op) {
    case O_INPUT:
        v = fresh(d, 0, o);
        r = row(o, 0, domain, G_INPUT);
        SET(r, C_DST, v);
        SET(r, C_TAPE, d->tape);
        SET(r, C_WIT, d->wit);
        SET(r, C_ONL, d->onl);
        SET(r, C_REC, d->n_inputs);
        d->tape++;
        d->wit++;
        slot(o, si, d->onl);
        d->onl += ev_in;
        d->n_inputs++;
        d->map[dst] = v;
        d->stamp[dst] = epoch;
        d->last[dst] = v;
        return -1;
    case O_ADD:
    case O_SUB:
        a = rd(d, s1, epoch);
        b = rd(d, s2, epoch);
        lvl = lmax(d->vlevel[a], d->vlevel[b]) + 1;
        v = wr(d, dst, lvl, epoch, o);
        r = row(o, lvl, domain, (op == O_ADD || domain == K_GF2) ? G_ADD : Z_SUB);
        SET(r, C_DST, v);
        SET(r, C_A, a);
        SET(r, C_B, b);
        return -1;
    case O_ADDC:
    case O_SUBC:
    case O_MULC:
        a = rd(d, s1, epoch);
        lvl = d->vlevel[a] + 1;
        v = wr(d, dst, lvl, epoch, o);
        r = row(o, lvl, domain, op == O_ADDC ? G_ADDC : op == O_SUBC ? G_SUBC : G_MULC);
        SET(r, C_DST, v);
        SET(r, C_A, a);
        set_cst(o, r, c);
        return -1;
    case O_MUL:
        a = rd(d, s1, epoch);
        b = rd(d, s2, epoch);
        lvl = lmax(d->vlevel[a], d->vlevel[b]) + 1;
        v = wr(d, dst, lvl, epoch, o);
        r = row(o, lvl, domain, G_MUL);
        SET(r, C_DST, v);
        SET(r, C_A, a);
        SET(r, C_B, b);
        SET(r, C_TAPE, d->tape);
        SET(r, C_ONL, d->onl);
        SET(r, C_PRE, d->pre);
        SET(r, C_REC, d->n_recons);
        SET(r, C_CORR, d->n_corrs);
        d->tape += 2;
        slot(o, sc, d->pre);
        slot(o, sr, d->onl);
        d->pre += ev_in;
        d->onl += ev_sh;
        d->n_corrs++;
        d->n_recons++;
        return -1;
    case O_ASSERT:
        a = rd(d, s1, epoch);
        lvl = d->vlevel[a] + 1;
        r = row(o, lvl, domain, G_ASSERT);
        SET(r, C_A, a);
        SET(r, C_ONL, d->onl);
        SET(r, C_REC, d->n_recons);
        slot(o, sr, d->onl);
        d->onl += ev_sh;
        d->n_recons++;
        return -1;
    case O_RANDOM:
        v = fresh(d, 0, o);
        r = row(o, 0, domain, G_RANDOM);
        SET(r, C_DST, v);
        SET(r, C_TAPE, d->tape);
        d->tape++;
        d->map[dst] = v;
        d->stamp[dst] = epoch;
        d->last[dst] = v;
        return -1;
    case O_CONST:
        v = fresh(d, 0, o);
        r = row(o, 0, domain, G_CONST);
        SET(r, C_DST, v);
        set_cst(o, r, c);
        d->map[dst] = v;
        d->stamp[dst] = epoch;
        d->last[dst] = v;
        return -1;
    default:
        return op;
    }
}

static int32_t gf2_mul(dom_t *d2, int32_t x, int32_t y, out_t *o) {
    int32_t lvl = lmax(d2->vlevel[x], d2->vlevel[y]) + 1;
    int32_t v = fresh(d2, lvl, o);
    int32_t *r = row(o, lvl, K_GF2, G_MUL);
    SET(r, C_DST, v);
    SET(r, C_A, x);
    SET(r, C_B, y);
    SET(r, C_TAPE, d2->tape);
    SET(r, C_ONL, d2->onl);
    SET(r, C_PRE, d2->pre);
    SET(r, C_REC, d2->n_recons);
    SET(r, C_CORR, d2->n_corrs);
    d2->tape += 2;
    slot(o, S_CO2, d2->pre);
    slot(o, S_RE2, d2->onl);
    d2->pre++;
    d2->onl++;
    d2->n_corrs++;
    d2->n_recons++;
    return v;
}

static int32_t gf2_add(dom_t *d2, int32_t x, int32_t y, out_t *o) {
    int32_t lvl = lmax(d2->vlevel[x], d2->vlevel[y]) + 1;
    int32_t v = fresh(d2, lvl, o);
    int32_t *r = row(o, lvl, K_GF2, G_ADD);
    SET(r, C_DST, v);
    SET(r, C_A, x);
    SET(r, C_B, y);
    return v;
}

/* B2A(dst_z64, src_gf2) (compile.py emit_b2a, combine.rs:132-219) */
static void b2a(dom_t *d2, dom_t *dz, int64_t dst, const int64_t *src, int32_t epoch,
                out_t *o) {
    int32_t fr[64], bw[64], res[64], scratch[64], *r, *bits;
    for (int i = 0; i < 64; i++) {
        fr[i] = fresh(d2, 0, o);
        r = row(o, 0, K_GF2, G_RANDOM);
        SET(r, C_DST, fr[i]);
        SET(r, C_TAPE, d2->tape);
        d2->tape++;
    }
    int32_t zr = fresh(dz, 1, o);
    r = row(o, 1, K_Z64, B2A_CORR);
    SET(r, C_DST, zr);
    SET(r, C_TAPE, dz->tape);
    SET(r, C_PRE, dz->pre);
    SET(r, C_CORR, dz->n_corrs);
    bits = bits_row(o, r, scratch);
    for (int i = 0; i < 64; i++)
        bits[i] = fr[i];
    dz->tape++;
    slot(o, S_COZ, dz->pre);
    dz->pre += 8;
    dz->n_corrs++;
    for (int i = 0; i < 64; i++)
        bw[i] = rd(d2, src[i], epoch);
    int32_t carry = gf2_mul(d2, fr[0], bw[0], o);
    res[0] = gf2_add(d2, fr[0], bw[0], o);
    for (int i = 1; i < 63; i++) {
        int32_t ac = gf2_add(d2, fr[i], carry, o);
        int32_t bc = gf2_add(d2, bw[i], carry, o);
        int32_t ac_bc = gf2_mul(d2, ac, bc, o);
        res[i] = gf2_add(d2, ac, bw[i], o);
        carry = gf2_add(d2, ac_bc, carry, o);
    }
    int32_t top = gf2_add(d2, fr[63], bw[63], o);
    res[63] = gf2_add(d2, carry, top, o);
    int32_t lvl = dz->vlevel[zr];
    for (int i = 0; i < 64; i++)
        lvl = lmax(lvl, d2->vlevel[res[i]]);
    lvl += 1;
    int32_t zv = wr(dz, dst, lvl, epoch, o);
    r = row(o, lvl, K_Z64, B2A_OUT);
    SET(r, C_DST, zv);
    SET(r, C_ZR, zr);
    SET(r, C_ONL, d2->onl);
    SET(r, C_REC, d2->n_recons);
    bits = bits_row(o, r, scratch);
    for (int i = 0; i < 64; i++)
        bits[i] = res[i];
    for (int i = 0; i < 64; i++) {
        slot(o, S_RE2, d2->onl);
        d2->onl++;
        d2->n_recons++;
    }
}

/* compile ops [lo, hi) as one (sub)program whose carried-in wires are
 * carry2[0..nc2) and carryz[0..ncz) (values 1..k of each domain, in that
 * order).  The domains' counters start from 0 and their value maps from
 * empty under `epoch`; each wire's `last` value is kept across calls.
 * Returns 0, 1 with res[0] = the bad opcode, or 2 if an array was too
 * small (a caller's sizing fault). */
int rc_compile(const ops_t *ops, int64_t lo, int64_t hi, int32_t epoch, const int64_t *carry2,
               int64_t nc2, const int64_t *carryz, int64_t ncz, dom_t *d2, dom_t *dz, out_t *o,
               int64_t *res) {
    dom_t *doms[2] = {d2, dz};
    for (int z = 0; z < 2; z++) {
        dom_t *d = doms[z];
        d->n_vals = 1;
        d->vlevel[0] = 0;
        d->tape = d->onl = d->pre = d->wit = d->n_inputs = d->n_corrs = d->n_recons = 0;
    }
    o->n_rows = o->n_bits = o->overflow = 0;
    for (int i = 0; i < NSLOT; i++)
        o->n_slots[i] = 0;
    for (int64_t i = 0; i < nc2; i++) {
        int32_t v = fresh(d2, 0, o);
        d2->map[carry2[i]] = v;
        d2->stamp[carry2[i]] = epoch;
    }
    for (int64_t i = 0; i < ncz; i++) {
        int32_t v = fresh(dz, 0, o);
        dz->map[carryz[i]] = v;
        dz->stamp[carryz[i]] = epoch;
    }
    for (int64_t i = lo; i < hi && !o->overflow; i++) {
        int32_t u = ops->code[i];
        int k = ops->kind[u];
        if (k == K_GF2 || k == K_Z64) {
            int bad = gate(doms[k], k, ops->op[u], ops->dst[u], ops->src1[u], ops->src2[u],
                           ops->cst[u], epoch, o);
            if (bad >= 0) {
                res[0] = bad;
                return 1;
            }
        } else if (k == K_B2A) {
            b2a(d2, dz, ops->a[u], ops->bsrc + 64 * ops->b[u], epoch, o);
        }
    }
    return o->overflow ? 2 : 0;
}

/* compile_segments' carry pass over ops [lo, hi), segment s.  writer:
 * the segment that last wrote each wire (-1: none); inmark / outmark: the
 * segment a wire was last listed as a carry-in of / a carry-out of.  Each
 * new carry-in is written to in_* (domain, wire, source segment), each new
 * carry-out to out_* (domain, wire, source segment, its value there).
 * Returns the entries written, -1 if cap was too small. */
typedef struct {
    int32_t *writer, *inmark, *outmark;
    const int32_t *last;
} cross_t;

typedef struct {
    int8_t *dom;
    int64_t *wire;
    int32_t *src, *val;
    int64_t n, cap;
} xlist_t;

static inline int xread(cross_t *x, int z, int64_t w, int32_t s, xlist_t *in, xlist_t *out) {
    int32_t src = x->writer[w];
    if (src < 0 || src == s)
        return 0;
    if (x->inmark[w] != s) {
        if (in->n >= in->cap)
            return -1;
        x->inmark[w] = s;
        in->dom[in->n] = (int8_t)z;
        in->wire[in->n] = w;
        in->src[in->n] = src;
        in->n++;
    }
    if (x->outmark[w] != src) {
        if (out->n >= out->cap)
            return -1;
        x->outmark[w] = src;
        out->dom[out->n] = (int8_t)z;
        out->wire[out->n] = w;
        out->src[out->n] = src;
        out->val[out->n] = x->last[w];
        out->n++;
    }
    return 0;
}

int rc_carry_scan(const ops_t *ops, int64_t lo, int64_t hi, int32_t s, cross_t *x2, cross_t *xz,
                  xlist_t *in, xlist_t *out) {
    in->n = out->n = 0;
    for (int64_t i = lo; i < hi; i++) {
        int32_t u = ops->code[i];
        int k = ops->kind[u];
        if (k == K_B2A) {
            for (int j = 0; j < 64; j++)
                if (xread(x2, 0, ops->bsrc[64 * ops->b[u] + j], s, in, out))
                    return -1;
            xz->writer[ops->a[u]] = s;
            continue;
        }
        if (k != K_GF2 && k != K_Z64)
            continue;
        cross_t *x = k == K_GF2 ? x2 : xz;
        int op = ops->op[u];
        if (op == O_ADD || op == O_SUB || op == O_MUL) {
            if (xread(x, k, ops->src1[u], s, in, out) || xread(x, k, ops->src2[u], s, in, out))
                return -1;
        } else if (op == O_ADDC || op == O_SUBC || op == O_MULC || op == O_ASSERT) {
            if (xread(x, k, ops->src1[u], s, in, out))
                return -1;
        }
        if (op != O_ASSERT)
            x->writer[ops->dst[u]] = s;
    }
    return 0;
}
