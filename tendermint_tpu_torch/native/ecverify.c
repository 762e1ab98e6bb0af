/* Native host verification lanes for the non-ed25519 key schemes
 * (reference crypto/secp256k1/secp256k1.go:195-213 Schnorr verify,
 * crypto/sr25519/pubkey.go:34-59 schnorrkel verify).
 *
 * The device lanes (ops/secp.py, ops/sr25519.py) serve these schemes on
 * the card; the host lane serves them on a CPU lane, in a chaos drill or
 * behind the secp256k1 rollback switch, where the pure-Python bignum
 * path costs ~5 ms/verify.  This C module implements the exact
 * same checks (mirroring crypto/secp256k1.py, crypto/sr25519.py,
 * crypto/_ristretto.py, crypto/_strobe.py — which are themselves
 * validated against published vectors) at ~100x the speed, batch entry
 * points over ragged message buffers like staging.c.
 *
 * Compiled together with staging.c into one shared object
 * (libs/native.py); calls staging.c's exported tm_mod_l for the 64-byte
 * wide-scalar reduction both schemes share.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint8_t u8;
typedef uint32_t u32;

/* from staging.c (same .so): (n x 64B LE) -> (n x 32B) scalars mod l */
void tm_mod_l(const u8 *digests, u8 *out, u64 n);

/* ------------------------------------------------------------- SHA-256 */

static const uint32_t SK[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t ror32(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

typedef struct { uint32_t h[8]; u8 buf[64]; u64 len; } sha256_ctx;

static void sha256_compress(uint32_t *h, const u8 *p) {
    uint32_t w[64], a, b, c, d, e, f, g, hh;
    int i;
    for (i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
               ((uint32_t)p[4 * i + 2] << 8) | p[4 * i + 3];
    for (i = 16; i < 64; i++) {
        uint32_t s0 = ror32(w[i - 15], 7) ^ ror32(w[i - 15], 18)
                      ^ (w[i - 15] >> 3);
        uint32_t s1 = ror32(w[i - 2], 17) ^ ror32(w[i - 2], 19)
                      ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    a = h[0]; b = h[1]; c = h[2]; d = h[3];
    e = h[4]; f = h[5]; g = h[6]; hh = h[7];
    for (i = 0; i < 64; i++) {
        uint32_t s1 = ror32(e, 6) ^ ror32(e, 11) ^ ror32(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = hh + s1 + ch + SK[i] + w[i];
        uint32_t s0 = ror32(a, 2) ^ ror32(a, 13) ^ ror32(a, 22);
        uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = s0 + mj;
        hh = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

static void sha256_init(sha256_ctx *c) {
    static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                   0xa54ff53a, 0x510e527f, 0x9b05688c,
                                   0x1f83d9ab, 0x5be0cd19};
    memcpy(c->h, H0, sizeof(H0));
    c->len = 0;
}

static void sha256_update(sha256_ctx *c, const u8 *d, u64 n) {
    u64 fill = c->len % 64;
    c->len += n;
    if (fill) {
        u64 take = 64 - fill < n ? 64 - fill : n;
        memcpy(c->buf + fill, d, take);
        d += take; n -= take; fill += take;
        if (fill == 64) sha256_compress(c->h, c->buf);
        else return;
    }
    while (n >= 64) { sha256_compress(c->h, d); d += 64; n -= 64; }
    if (n) memcpy(c->buf, d, n);
}

static void sha256_final(sha256_ctx *c, u8 *out) {
    u64 bits = c->len * 8;
    u8 pad = 0x80;
    u8 lenb[8];
    int i;
    sha256_update(c, &pad, 1);
    pad = 0;
    while (c->len % 64 != 56) sha256_update(c, &pad, 1);
    for (i = 0; i < 8; i++) lenb[i] = (u8)(bits >> (56 - 8 * i));
    sha256_update(c, lenb, 8);
    for (i = 0; i < 8; i++) {
        out[4 * i] = (u8)(c->h[i] >> 24);
        out[4 * i + 1] = (u8)(c->h[i] >> 16);
        out[4 * i + 2] = (u8)(c->h[i] >> 8);
        out[4 * i + 3] = (u8)(c->h[i]);
    }
}

/* -------------------------------------------- secp256k1 field (mod p) */
/* p = 2^256 - 2^32 - 977; 2^256 === K (mod p), K = 0x1000003D1 */

#define SECP_K 0x1000003D1ULL

static const u64 SECP_P[4] = {0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
                              0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL};
/* group order n */
static const u64 SECP_N[4] = {0xBFD25E8CD0364141ULL, 0xBAAEDCE6AF48A03BULL,
                              0xFFFFFFFFFFFFFFFEULL, 0xFFFFFFFFFFFFFFFFULL};

typedef struct { u64 v[4]; } fe256;

static int ge256(const u64 *a, const u64 *b) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1; /* equal */
}

static void sub256(u64 *a, const u64 *b) {
    u128 bor = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - bor;
        a[i] = (u64)d;
        bor = (d >> 64) & 1;
    }
}

static void fe_normalize(fe256 *a) {
    if (ge256(a->v, SECP_P)) sub256(a->v, SECP_P);
}

static void fe_from_be(fe256 *r, const u8 *b) {
    for (int i = 0; i < 4; i++) {
        r->v[i] = 0;
        for (int j = 0; j < 8; j++)
            r->v[i] = (r->v[i] << 8) | b[8 * (3 - i) + j];
    }
}

static void fe_fold512(fe256 *r, const u64 *d) {
    /* fold d[4..7] * 2^256 === d[4..7] * K */
    u64 t[5];
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)d[i] + (u128)d[i + 4] * SECP_K;
        t[i] = (u64)c;
        c >>= 64;
    }
    t[4] = (u64)c;
    /* fold t[4] * 2^256 === t[4] * K  (t[4] <= K) */
    c = (u128)t[0] + (u128)t[4] * SECP_K;
    r->v[0] = (u64)c; c >>= 64;
    for (int i = 1; i < 4; i++) {
        c += t[i];
        r->v[i] = (u64)c;
        c >>= 64;
    }
    if (c) { /* one more wrap: add K */
        c = (u128)r->v[0] + SECP_K;
        r->v[0] = (u64)c; c >>= 64;
        for (int i = 1; i < 4 && c; i++) {
            c += r->v[i];
            r->v[i] = (u64)c;
            c >>= 64;
        }
    }
    fe_normalize(r);
}

static void fe_mul(fe256 *r, const fe256 *a, const fe256 *b) {
    u64 d[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 t = (u128)a->v[i] * b->v[j] + d[i + j] + carry;
            d[i + j] = (u64)t;
            carry = t >> 64;
        }
        d[i + 4] += (u64)carry;
    }
    fe_fold512(r, d);
}

/* dedicated squaring: cross terms computed once and doubled (10 word
 * multiplies instead of 16) */
static void fe_sqr(fe256 *r, const fe256 *a) {
    u64 d[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = i + 1; j < 4; j++) {
            u128 t = (u128)a->v[i] * a->v[j] + d[i + j] + (u64)carry;
            d[i + j] = (u64)t;
            carry = t >> 64;
        }
        if (i < 3) d[i + 4] += (u64)carry;
    }
    u64 top = 0;
    for (int k = 0; k < 8; k++) {      /* double the cross terms */
        u64 nv = (d[k] << 1) | top;
        top = d[k] >> 63;
        d[k] = nv;
    }
    u128 c = 0;
    for (int i = 0; i < 4; i++) {      /* add the squares on the diagonal */
        u128 sq = (u128)a->v[i] * a->v[i];
        c += (u128)d[2 * i] + (u64)sq;
        d[2 * i] = (u64)c; c >>= 64;
        c += (u128)d[2 * i + 1] + (u64)(sq >> 64);
        d[2 * i + 1] = (u64)c; c >>= 64;
    }
    fe_fold512(r, d);
}

static void fe_add(fe256 *r, const fe256 *a, const fe256 *b) {
    u128 c = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        c += (u128)a->v[i] + b->v[i];
        t[i] = (u64)c;
        c >>= 64;
    }
    if (c) { /* wrapped past 2^256: add K */
        c = (u128)t[0] + SECP_K;
        t[0] = (u64)c; c >>= 64;
        for (int i = 1; i < 4 && c; i++) { c += t[i]; t[i] = (u64)c; c >>= 64; }
    }
    memcpy(r->v, t, sizeof(t));
    fe_normalize(r);
}

static void fe_sub(fe256 *r, const fe256 *a, const fe256 *b) {
    /* a - b = a + (p - b_normalized) */
    fe256 nb = *b;
    fe_normalize(&nb);
    u64 t[4];
    memcpy(t, SECP_P, sizeof(t));
    sub256(t, nb.v);
    fe256 pb;
    memcpy(pb.v, t, sizeof(t));
    fe_add(r, a, &pb);
}

static int fe_is_zero(const fe256 *a) {
    fe256 t = *a;
    fe_normalize(&t);
    return !(t.v[0] | t.v[1] | t.v[2] | t.v[3]);
}

static int fe_eq(const fe256 *a, const fe256 *b) {
    fe256 d;
    fe_sub(&d, a, b);
    return fe_is_zero(&d);
}

/* 4-bit fixed-window powering: 255 squarings + <=64 multiplies versus
 * ~500 multiplies for bit-at-a-time (the secp exponents are nearly
 * all-ones, so the conditional multiply almost always fired) */
static void fe_pow(fe256 *r, const fe256 *a, const u64 *e) {
    fe256 tbl[16];
    tbl[0] = (fe256){{1, 0, 0, 0}};
    tbl[1] = *a;
    for (int i = 2; i < 16; i++) fe_mul(&tbl[i], &tbl[i - 1], a);
    fe256 acc = tbl[(e[3] >> 60) & 15];
    for (int w = 62; w >= 0; w--) {
        fe_sqr(&acc, &acc); fe_sqr(&acc, &acc);
        fe_sqr(&acc, &acc); fe_sqr(&acc, &acc);
        int d = (int)((e[w / 16] >> (4 * (w % 16))) & 15);
        if (d) fe_mul(&acc, &acc, &tbl[d]);
    }
    *r = acc;
}

/* sqrt exponent (p+1)/4 */
static const u64 SECP_SQRT_E[4] = {0xFFFFFFFFBFFFFF0CULL,
                                   0xFFFFFFFFFFFFFFFFULL,
                                   0xFFFFFFFFFFFFFFFFULL,
                                   0x3FFFFFFFFFFFFFFFULL};
/* inverse exponent p-2 */
static const u64 SECP_INV_E[4] = {0xFFFFFFFEFFFFFC2DULL,
                                  0xFFFFFFFFFFFFFFFFULL,
                                  0xFFFFFFFFFFFFFFFFULL,
                                  0xFFFFFFFFFFFFFFFFULL};

/* ------------------------------------------- secp256k1 jacobian points */

typedef struct { fe256 x, y, z; int inf; } jpt;

static void jdbl(jpt *r, const jpt *a) {
    if (a->inf || fe_is_zero(&a->y)) { r->inf = 1; return; }
    fe256 ys, s, m, x3, y3, z3, t;
    fe_sqr(&ys, &a->y);
    fe_mul(&s, &a->x, &ys);
    fe_add(&s, &s, &s); fe_add(&s, &s, &s);           /* 4*x*y^2 */
    fe_sqr(&m, &a->x);
    fe_add(&t, &m, &m); fe_add(&m, &t, &m);           /* 3*x^2 */
    fe_sqr(&x3, &m);
    fe_add(&t, &s, &s);
    fe_sub(&x3, &x3, &t);                             /* m^2 - 2s */
    fe_sub(&t, &s, &x3);
    fe_mul(&y3, &m, &t);
    fe_sqr(&t, &ys);
    fe_add(&t, &t, &t); fe_add(&t, &t, &t); fe_add(&t, &t, &t); /* 8*y^4 */
    fe_sub(&y3, &y3, &t);
    fe_mul(&z3, &a->y, &a->z);
    fe_add(&z3, &z3, &z3);
    r->x = x3; r->y = y3; r->z = z3; r->inf = 0;
}

static void jadd(jpt *r, const jpt *a, const jpt *b) {
    if (a->inf) { *r = *b; return; }
    if (b->inf) { *r = *a; return; }
    fe256 z1z1, z2z2, u1, u2, s1, s2, t;
    fe_sqr(&z1z1, &a->z);
    fe_sqr(&z2z2, &b->z);
    fe_mul(&u1, &a->x, &z2z2);
    fe_mul(&u2, &b->x, &z1z1);
    fe_mul(&t, &b->z, &z2z2);
    fe_mul(&s1, &a->y, &t);
    fe_mul(&t, &a->z, &z1z1);
    fe_mul(&s2, &b->y, &t);
    if (fe_eq(&u1, &u2)) {
        if (!fe_eq(&s1, &s2)) { r->inf = 1; return; }
        jdbl(r, a);
        return;
    }
    fe256 h, hh, hhh, rr, v, x3, y3, z3;
    fe_sub(&h, &u2, &u1);
    fe_sqr(&hh, &h);
    fe_mul(&hhh, &h, &hh);
    fe_sub(&rr, &s2, &s1);
    fe_mul(&v, &u1, &hh);
    fe_sqr(&x3, &rr);
    fe_sub(&x3, &x3, &hhh);
    fe_add(&t, &v, &v);
    fe_sub(&x3, &x3, &t);
    fe_sub(&t, &v, &x3);
    fe_mul(&y3, &rr, &t);
    fe_mul(&t, &s1, &hhh);
    fe_sub(&y3, &y3, &t);
    fe_mul(&t, &a->z, &b->z);
    fe_mul(&z3, &h, &t);
    r->x = x3; r->y = y3; r->z = z3; r->inf = 0;
}

/* interleaved 4-bit-window double-scalar: r = k1*G + k2*P.
 * scalars as 32 BE bytes. */
static void jmul2(jpt *r, const u8 *k1, const jpt *G, const u8 *k2,
                  const jpt *P) {
    jpt tg[16], tp[16];
    tg[0].inf = 1; tp[0].inf = 1;
    tg[1] = *G; tp[1] = *P;
    for (int i = 2; i < 16; i++) {
        jadd(&tg[i], &tg[i - 1], G);
        jadd(&tp[i], &tp[i - 1], P);
    }
    jpt acc;
    acc.inf = 1;
    for (int i = 0; i < 64; i++) {
        if (!acc.inf) {
            jdbl(&acc, &acc); jdbl(&acc, &acc);
            jdbl(&acc, &acc); jdbl(&acc, &acc);
        }
        int byte = i >> 1;
        int n1 = (i & 1) ? (k1[byte] & 0xF) : (k1[byte] >> 4);
        int n2 = (i & 1) ? (k2[byte] & 0xF) : (k2[byte] >> 4);
        if (n1) jadd(&acc, &acc, &tg[n1]);
        if (n2) jadd(&acc, &acc, &tp[n2]);
    }
    *r = acc;
}

static const u64 SECP_GX[4] = {0x59F2815B16F81798ULL, 0x029BFCDB2DCE28D9ULL,
                               0x55A06295CE870B07ULL, 0x79BE667EF9DCBBACULL};
static const u64 SECP_GY[4] = {0x9C47D08FFB10D4B8ULL, 0xFD17B448A6855419ULL,
                               0x5DA4FBFC0E1108A8ULL, 0x483ADA7726A3C465ULL};

static void be_from_256(u8 *out, const u64 *v) {
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            out[8 * i + j] = (u8)(v[3 - i] >> (56 - 8 * j));
}

/* e mod n for a 256-bit BE value (e < 2n, so one conditional subtract) */
static void scalar_mod_n(u64 *v) {
    if (ge256(v, SECP_N)) sub256(v, SECP_N);
}

static void u256_from_be(u64 *v, const u8 *b) {
    for (int i = 0; i < 4; i++) {
        v[i] = 0;
        for (int j = 0; j < 8; j++) v[i] = (v[i] << 8) | b[8 * (3 - i) + j];
    }
}

/* tagged_hash("BIP0340/challenge", r||px||m32): th = sha256(tag);
 * sha256(th||th||data) */
static void bip340_challenge(u8 *e32, const u8 *r32, const u8 *px32,
                             const u8 *m32) {
    static u8 th[32];
    static int th_done = 0;
    if (!th_done) {
        sha256_ctx c;
        sha256_init(&c);
        sha256_update(&c, (const u8 *)"BIP0340/challenge", 17);
        sha256_final(&c, th);
        th_done = 1;
    }
    sha256_ctx c;
    sha256_init(&c);
    sha256_update(&c, th, 32);
    sha256_update(&c, th, 32);
    sha256_update(&c, r32, 32);
    sha256_update(&c, px32, 32);
    sha256_update(&c, m32, 32);
    sha256_final(&c, e32);
}

/* one BIP-340 verify: pub33 compressed, msg raw (sha256'd here), sig64 */
static int secp_verify_one(const u8 *pub33, const u8 *msg, u64 mlen,
                           const u8 *sig) {
    if (pub33[0] != 2 && pub33[0] != 3) return 0;
    fe256 x, y2, y, t;
    u64 xb[4];
    u256_from_be(xb, pub33 + 1);
    if (ge256(xb, SECP_P)) return 0;
    fe_from_be(&x, pub33 + 1);
    /* y^2 = x^3 + 7; sqrt must exist (decompress validity + lift_x) */
    fe_sqr(&y2, &x);
    fe_mul(&y2, &y2, &x);
    fe256 seven = {{7, 0, 0, 0}};
    fe_add(&y2, &y2, &seven);
    fe_pow(&y, &y2, SECP_SQRT_E);
    fe_sqr(&t, &y);
    if (!fe_eq(&t, &y2)) return 0;
    /* even-y lift */
    fe_normalize(&y);
    if (y.v[0] & 1) {
        u64 py[4];
        memcpy(py, SECP_P, sizeof(py));
        sub256(py, y.v);
        memcpy(y.v, py, sizeof(py));
    }
    /* r < p, s < n */
    u64 rb[4], sb[4];
    u256_from_be(rb, sig);
    u256_from_be(sb, sig + 32);
    if (ge256(rb, SECP_P)) return 0;
    if (ge256(sb, SECP_N)) return 0;
    /* e = tagged_hash(r||px||sha256(msg)) mod n; then N - e */
    u8 m32[32], e32[32], ne_be[32];
    sha256_ctx c;
    sha256_init(&c);
    sha256_update(&c, msg, mlen);
    sha256_final(&c, m32);
    bip340_challenge(e32, sig, pub33 + 1, m32);
    u64 eb[4];
    u256_from_be(eb, e32);
    scalar_mod_n(eb);
    u64 ne[4];
    memcpy(ne, SECP_N, sizeof(ne));
    if (eb[0] | eb[1] | eb[2] | eb[3]) sub256(ne, eb);
    else memset(ne, 0, sizeof(ne));
    be_from_256(ne_be, ne);
    /* R = s*G + (n-e)*P */
    jpt G, P, R;
    memcpy(G.x.v, SECP_GX, 32); memcpy(G.y.v, SECP_GY, 32);
    G.z.v[0] = 1; G.z.v[1] = G.z.v[2] = G.z.v[3] = 0; G.inf = 0;
    P.x = x; P.y = y;
    P.z = G.z; P.inf = 0;
    jmul2(&R, sig + 32, &G, ne_be, &P);
    if (R.inf) return 0;
    /* affine: zi = z^-2, check even y and x == r */
    fe256 zi, zi2, zi3, ax, ay;
    fe_pow(&zi, &R.z, SECP_INV_E);
    fe_sqr(&zi2, &zi);
    fe_mul(&zi3, &zi2, &zi);
    fe_mul(&ax, &R.x, &zi2);
    fe_mul(&ay, &R.y, &zi3);
    fe_normalize(&ay);
    if (ay.v[0] & 1) return 0;
    fe256 rfe;
    fe_from_be(&rfe, sig);
    return fe_eq(&ax, &rfe);
}

EXPORT void tm_secp_verify(const u8 *pubs33, const u8 *msgbuf,
                           const u64 *offsets, const u8 *sigs,
                           u8 *out, u64 n) {
    for (u64 i = 0; i < n; i++)
        out[i] = (u8)secp_verify_one(
            pubs33 + 33 * i, msgbuf + offsets[i],
            offsets[i + 1] - offsets[i], sigs + 64 * i);
}

/* ----------------------------------------- curve25519 field (5 x 51) */

typedef struct { u64 v[5]; } f25519;

#define M51 ((1ULL << 51) - 1)

static void f25519_from_le(f25519 *r, const u8 *b) {
    u64 w[4];
    for (int i = 0; i < 4; i++) {
        w[i] = 0;
        for (int j = 7; j >= 0; j--) w[i] = (w[i] << 8) | b[8 * i + j];
    }
    r->v[0] = w[0] & M51;
    r->v[1] = ((w[0] >> 51) | (w[1] << 13)) & M51;
    r->v[2] = ((w[1] >> 38) | (w[2] << 26)) & M51;
    r->v[3] = ((w[2] >> 25) | (w[3] << 39)) & M51;
    r->v[4] = (w[3] >> 12) & M51;
}

static void f25519_carry(f25519 *a) {
    for (int i = 0; i < 5; i++) {
        int j = (i + 1) % 5;
        u64 c = a->v[i] >> 51;
        a->v[i] &= M51;
        a->v[j] += (i == 4) ? c * 19 : c;
    }
    /* one more for the wrap into v[0] */
    u64 c = a->v[0] >> 51;
    a->v[0] &= M51;
    a->v[1] += c;
}

static void f25519_mul(f25519 *r, const f25519 *a, const f25519 *b) {
    u128 t[5] = {0};
    for (int i = 0; i < 5; i++) {
        for (int j = 0; j < 5; j++) {
            int k = i + j;
            u128 p = (u128)a->v[i] * b->v[j];
            if (k >= 5) { k -= 5; p *= 19; }
            t[k] += p;
        }
    }
    u64 c = 0;
    for (int i = 0; i < 5; i++) {
        t[i] += c;
        r->v[i] = (u64)(t[i] & M51);
        c = (u64)(t[i] >> 51);
    }
    r->v[0] += c * 19;
    f25519_carry(r);
}

/* dedicated squaring: 15 word multiplies instead of 25 */
static void f25519_sqr(f25519 *r, const f25519 *a) {
    u128 t[5] = {0};
    for (int i = 0; i < 5; i++) {
        for (int j = i; j < 5; j++) {
            u128 p = (u128)a->v[i] * a->v[j];
            if (i != j) p += p;
            int k = i + j;
            if (k >= 5) { k -= 5; p *= 19; }
            t[k] += p;
        }
    }
    u64 c = 0;
    for (int i = 0; i < 5; i++) {
        t[i] += c;
        r->v[i] = (u64)(t[i] & M51);
        c = (u64)(t[i] >> 51);
    }
    r->v[0] += c * 19;
    f25519_carry(r);
}

static void f25519_add(f25519 *r, const f25519 *a, const f25519 *b) {
    for (int i = 0; i < 5; i++) r->v[i] = a->v[i] + b->v[i];
    f25519_carry(r);
}

static void f25519_sub(f25519 *r, const f25519 *a, const f25519 *b) {
    /* add 4p limb-wise (redundant radix-51) to keep limbs positive:
     * b's limbs are < 2^52 after any carry, 4p's are ~2^53 */
    r->v[0] = a->v[0] + 0xFFFFFFFFFFFDAULL * 2 - b->v[0];
    for (int i = 1; i < 5; i++)
        r->v[i] = a->v[i] + 0xFFFFFFFFFFFFEULL * 2 - b->v[i];
    f25519_carry(r);
}

static void f25519_freeze(f25519 *a) {
    f25519_carry(a);
    f25519_carry(a);
    /* now limbs < 2^51 + eps; subtract p if >= p (twice for safety) */
    for (int pass = 0; pass < 2; pass++) {
        u64 t[5];
        t[0] = a->v[0] + 19;
        u64 c = t[0] >> 51; t[0] &= M51;
        for (int i = 1; i < 5; i++) {
            t[i] = a->v[i] + c;
            c = t[i] >> 51;
            t[i] &= M51;
        }
        /* c is 1 iff a + 19 >= 2^255, i.e. a >= p */
        if (c) {
            memcpy(a->v, t, sizeof(t));
        }
    }
}

static int f25519_is_neg(const f25519 *a) {
    f25519 t = *a;
    f25519_freeze(&t);
    return (int)(t.v[0] & 1);
}

static int f25519_eq(const f25519 *a, const f25519 *b) {
    f25519 x = *a, y = *b;
    f25519_freeze(&x);
    f25519_freeze(&y);
    for (int i = 0; i < 5; i++)
        if (x.v[i] != y.v[i]) return 0;
    return 1;
}

static void f25519_neg(f25519 *r, const f25519 *a) {
    f25519 zero = {{0}};
    f25519_sub(r, &zero, a);
}

static void f25519_pow2k(f25519 *r, const f25519 *a, int k) {
    *r = *a;
    while (k--) f25519_sqr(r, r);
}

/* x^(2^252 - 3): shared exponent chain (pow_p58 for sqrt_ratio) */
static void f25519_pow_p58(f25519 *r, const f25519 *x) {
    f25519 x2, x9, x11, x22, x_5_0, x_10_0, x_20_0, x_40_0, x_50_0,
        x_100_0, x_200_0, x_250_0, t;
    f25519_sqr(&x2, x);                          /* 2 */
    f25519_pow2k(&t, &x2, 2);                    /* 8 */
    f25519_mul(&x9, &t, x);                      /* 9 */
    f25519_mul(&x11, &x9, &x2);                  /* 11 */
    f25519_sqr(&x22, &x11);                      /* 22 */
    f25519_mul(&x_5_0, &x22, &x9);               /* 2^5 - 1 */
    f25519_pow2k(&t, &x_5_0, 5);
    f25519_mul(&x_10_0, &t, &x_5_0);
    f25519_pow2k(&t, &x_10_0, 10);
    f25519_mul(&x_20_0, &t, &x_10_0);
    f25519_pow2k(&t, &x_20_0, 20);
    f25519_mul(&x_40_0, &t, &x_20_0);
    f25519_pow2k(&t, &x_40_0, 10);
    f25519_mul(&x_50_0, &t, &x_10_0);
    f25519_pow2k(&t, &x_50_0, 50);
    f25519_mul(&x_100_0, &t, &x_50_0);
    f25519_pow2k(&t, &x_100_0, 100);
    f25519_mul(&x_200_0, &t, &x_100_0);
    f25519_pow2k(&t, &x_200_0, 50);
    f25519_mul(&x_250_0, &t, &x_50_0);
    f25519_pow2k(&t, &x_250_0, 2);
    f25519_mul(r, &t, x);                        /* 2^252 - 3 */
}

/* constants (little-endian byte encodings) */
static const u8 ED_D_BYTES[32] = {
    0xa3, 0x78, 0x59, 0x13, 0xca, 0x4d, 0xeb, 0x75, 0xab, 0xd8, 0x41,
    0x41, 0x4d, 0x0a, 0x70, 0x00, 0x98, 0xe8, 0x79, 0x77, 0x79, 0x40,
    0xc7, 0x8c, 0x73, 0xfe, 0x6f, 0x2b, 0xee, 0x6c, 0x03, 0x52};
static const u8 SQRT_M1_BYTES[32] = {
    0xb0, 0xa0, 0x0e, 0x4a, 0x27, 0x1b, 0xee, 0xc4, 0x78, 0xe4, 0x2f,
    0xad, 0x06, 0x18, 0x43, 0x2f, 0xa7, 0xd7, 0xfb, 0x3d, 0x99, 0x00,
    0x4d, 0x2b, 0x0b, 0xdf, 0xc1, 0x4f, 0x80, 0x24, 0x83, 0x2b};
/* ristretto basepoint (ed25519 basepoint), affine x/y LE */
static const u8 BX_BYTES[32] = {
    0x1a, 0xd5, 0x25, 0x8f, 0x60, 0x2d, 0x56, 0xc9, 0xb2, 0xa7, 0x25,
    0x95, 0x60, 0xc7, 0x2c, 0x69, 0x5c, 0xdc, 0xd6, 0xfd, 0x31, 0xe2,
    0xa4, 0xc0, 0xfe, 0x53, 0x6e, 0xcd, 0xd3, 0x36, 0x69, 0x21};
static const u8 BY_BYTES[32] = {
    0x58, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66};

typedef struct { f25519 x, y, z, t; } ept; /* extended edwards, a=-1 */

static void ept_identity(ept *r) {
    memset(r, 0, sizeof(*r));
    r->y.v[0] = 1;
    r->z.v[0] = 1;
}

/* the Edwards d coefficient as radix-2^51 limbs, a compile-time
 * constant (no lazy init: ctypes releases the GIL, so first calls can
 * race and a plain done-flag store may be reordered before the limb
 * writes).  Limbs verified against -121665/121666 mod p and
 * ED_D_BYTES in tests/test_native_ec.py. */
static const f25519 ED_D_LIMBS = {{
    0x34DCA135978A3ULL, 0x1A8283B156EBDULL, 0x5E7A26001C029ULL,
    0x739C663A03CBBULL, 0x52036CEE2B6FFULL}};

static const f25519 *ed_d(void) {
    return &ED_D_LIMBS;
}

static void ept_add(ept *r, const ept *p, const ept *q) {
    f25519 a, b, c, d, e, f, g, h, t1, t2;
    const f25519 dcoef = *ed_d();
    f25519_sub(&t1, &p->y, &p->x);
    f25519_sub(&t2, &q->y, &q->x);
    f25519_mul(&a, &t1, &t2);
    f25519_add(&t1, &p->y, &p->x);
    f25519_add(&t2, &q->y, &q->x);
    f25519_mul(&b, &t1, &t2);
    f25519_mul(&c, &p->t, &dcoef);
    f25519_mul(&c, &c, &q->t);
    f25519_add(&c, &c, &c);
    f25519_mul(&d, &p->z, &q->z);
    f25519_add(&d, &d, &d);
    f25519_sub(&e, &b, &a);
    f25519_sub(&f, &d, &c);
    f25519_add(&g, &d, &c);
    f25519_add(&h, &b, &a);
    f25519_mul(&r->x, &e, &f);
    f25519_mul(&r->y, &g, &h);
    f25519_mul(&r->z, &f, &g);
    f25519_mul(&r->t, &e, &h);
}

static void ept_dbl(ept *r, const ept *p) {
    f25519 a, b, c, h, e, g, f, t;
    f25519_sqr(&a, &p->x);
    f25519_sqr(&b, &p->y);
    f25519_sqr(&c, &p->z);
    f25519_add(&c, &c, &c);
    f25519_add(&h, &a, &b);
    f25519_add(&t, &p->x, &p->y);
    f25519_sqr(&t, &t);
    f25519_sub(&e, &h, &t);
    f25519_sub(&g, &a, &b);
    f25519_add(&f, &c, &g);
    f25519_mul(&r->x, &e, &f);
    f25519_mul(&r->y, &g, &h);
    f25519_mul(&r->z, &f, &g);
    f25519_mul(&r->t, &e, &h);
}

/* 4-bit-window double-scalar r = k1*B + k2*A; scalars 32 LE bytes */
static void ept_mul2(ept *r, const u8 *k1, const ept *B, const u8 *k2,
                     const ept *A) {
    ept tb[16], ta[16];
    ept_identity(&tb[0]);
    ept_identity(&ta[0]);
    tb[1] = *B; ta[1] = *A;
    for (int i = 2; i < 16; i++) {
        ept_add(&tb[i], &tb[i - 1], B);
        ept_add(&ta[i], &ta[i - 1], A);
    }
    ept acc;
    ept_identity(&acc);
    for (int i = 63; i >= 0; i--) {
        if (i != 63) {
            ept_dbl(&acc, &acc); ept_dbl(&acc, &acc);
            ept_dbl(&acc, &acc); ept_dbl(&acc, &acc);
        }
        int byte = i >> 1;
        int n1 = (i & 1) ? (k1[byte] >> 4) : (k1[byte] & 0xF);
        int n2 = (i & 1) ? (k2[byte] >> 4) : (k2[byte] & 0xF);
        if (n1) ept_add(&acc, &acc, &tb[n1]);
        if (n2) ept_add(&acc, &acc, &ta[n2]);
    }
    *r = acc;
}

/* sqrt_ratio_m1(1, v): was_square + r = 1/sqrt(v) (or i/sqrt flavor),
 * specialized to u = 1 (all call sites here use u = 1) */
static int invsqrt(f25519 *r, const f25519 *v) {
    f25519 v3, v7, p, t, check, sqrt_m1;
    f25519_from_le(&sqrt_m1, SQRT_M1_BYTES);
    f25519_sqr(&v3, v);
    f25519_mul(&v3, &v3, v);         /* v^3 */
    f25519_sqr(&v7, &v3);
    f25519_mul(&v7, &v7, v);         /* v^7 */
    f25519_pow_p58(&p, &v7);         /* (v^7)^((p-5)/8) */
    f25519_mul(&t, &v3, &p);         /* r = v^3 * (v^7)^((p-5)/8) */
    f25519_mul(&check, v, &t);
    f25519_mul(&check, &check, &t);  /* v * r^2 */
    f25519 one = {{1, 0, 0, 0, 0}}, neg_one, neg_i;
    f25519_neg(&neg_one, &one);
    f25519_mul(&neg_i, &neg_one, &sqrt_m1);
    int correct = f25519_eq(&check, &one);
    int flipped = f25519_eq(&check, &neg_one);
    int flipped_i = f25519_eq(&check, &neg_i);
    if (flipped || flipped_i) f25519_mul(&t, &t, &sqrt_m1);
    if (f25519_is_neg(&t)) f25519_neg(&t, &t);
    *r = t;
    return correct || flipped;
}

/* ristretto decode (RFC 9496 4.3.1); returns 0 on failure */
static int ristretto_decode(ept *r, const u8 *b) {
    /* s < p and non-negative (even) */
    u8 last = b[31];
    if (last & 0x80) return 0;
    if (b[0] & 1) {
        /* could still be valid only if s < p... negativity = odd -> fail */
        return 0;
    }
    /* check s < p: p = 2^255 - 19 */
    static const u8 PBYTES[32] = {
        0xed, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
        0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
        0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f};
    for (int i = 31; i >= 0; i--) {
        if (b[i] < PBYTES[i]) break;
        if (b[i] > PBYTES[i]) return 0;
        if (i == 0) return 0; /* equal to p */
    }
    f25519 s, ss, u1, u2, u2s, v, inv, den_x, den_y, x, y, t, one, d;
    f25519_from_le(&s, b);
    f25519_from_le(&d, ED_D_BYTES);
    memset(&one, 0, sizeof(one));
    one.v[0] = 1;
    f25519_sqr(&ss, &s);
    f25519_sub(&u1, &one, &ss);
    f25519_add(&u2, &one, &ss);
    f25519_sqr(&u2s, &u2);
    f25519_mul(&v, &d, &u1);
    f25519_mul(&v, &v, &u1);
    f25519_neg(&v, &v);
    f25519_sub(&v, &v, &u2s);       /* -(d*u1^2) - u2^2 */
    f25519 vu2s;
    f25519_mul(&vu2s, &v, &u2s);
    int ok = invsqrt(&inv, &vu2s);
    f25519_mul(&den_x, &inv, &u2);
    f25519_mul(&den_y, &inv, &den_x);
    f25519_mul(&den_y, &den_y, &v);
    f25519_add(&x, &s, &s);
    f25519_mul(&x, &x, &den_x);
    if (f25519_is_neg(&x)) f25519_neg(&x, &x);
    f25519_mul(&y, &u1, &den_y);
    f25519_mul(&t, &x, &y);
    if (!ok || f25519_is_neg(&t) || f25519_eq(&y, (f25519[]){{{0}}}))
        return 0;
    r->x = x; r->y = y; r->t = t;
    memset(&r->z, 0, sizeof(r->z));
    r->z.v[0] = 1;
    return 1;
}

/* ristretto equality: x1*y2 == y1*x2 or y1*y2 == x1*x2 */
static int ristretto_eq(const ept *a, const ept *b) {
    f25519 l, r;
    f25519_mul(&l, &a->x, &b->y);
    f25519_mul(&r, &a->y, &b->x);
    if (f25519_eq(&l, &r)) return 1;
    f25519_mul(&l, &a->y, &b->y);
    f25519_mul(&r, &a->x, &b->x);
    return f25519_eq(&l, &r);
}

/* ----------------------------------------- STROBE-128 / merlin (keccak) */

static const u64 KRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int KROT[5][5] = {{0, 36, 3, 41, 18},
                               {1, 44, 10, 45, 2},
                               {62, 6, 43, 15, 61},
                               {28, 55, 25, 21, 56},
                               {27, 20, 39, 8, 14}};

static inline u64 rol64(u64 v, int n) {
    return n ? (v << n) | (v >> (64 - n)) : v;
}

static void keccakf(u64 a[5][5]) {
    u64 b[5][5], c[5], d[5];
    for (int rnd = 0; rnd < 24; rnd++) {
        for (int x = 0; x < 5; x++)
            c[x] = a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rol64(c[(x + 1) % 5], 1);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) a[x][y] ^= d[x];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y][(2 * x + 3 * y) % 5] = rol64(a[x][y], KROT[x][y]);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                a[x][y] = b[x][y] ^ (~b[(x + 1) % 5][y]
                                     & b[(x + 2) % 5][y]);
        a[0][0] ^= KRC[rnd];
    }
}

#define STROBE_R 166

typedef struct {
    u8 st[200];
    int pos, pos_begin;
} strobe;

static void strobe_permute(strobe *s) {
    u64 lanes[5][5];
    for (int x = 0; x < 5; x++)
        for (int y = 0; y < 5; y++) {
            u64 v = 0;
            for (int j = 7; j >= 0; j--)
                v = (v << 8) | s->st[8 * (x + 5 * y) + j];
            lanes[x][y] = v;
        }
    keccakf(lanes);
    for (int x = 0; x < 5; x++)
        for (int y = 0; y < 5; y++)
            for (int j = 0; j < 8; j++)
                s->st[8 * (x + 5 * y) + j] = (u8)(lanes[x][y] >> (8 * j));
}

static void strobe_run_f(strobe *s) {
    s->st[s->pos] ^= (u8)s->pos_begin;
    s->st[s->pos + 1] ^= 0x04;
    s->st[STROBE_R + 1] ^= 0x80;
    strobe_permute(s);
    s->pos = 0;
    s->pos_begin = 0;
}

static void strobe_absorb(strobe *s, const u8 *d, u64 n) {
    for (u64 i = 0; i < n; i++) {
        s->st[s->pos] ^= d[i];
        if (++s->pos == STROBE_R) strobe_run_f(s);
    }
}

static void strobe_squeeze(strobe *s, u8 *out, u64 n) {
    for (u64 i = 0; i < n; i++) {
        out[i] = s->st[s->pos];
        s->st[s->pos] = 0;
        if (++s->pos == STROBE_R) strobe_run_f(s);
    }
}

/* flags */
#define SF_I 1
#define SF_A 2
#define SF_C 4
#define SF_M 16

static void strobe_begin_op(strobe *s, int flags) {
    u8 hdr[2];
    hdr[0] = (u8)s->pos_begin;
    hdr[1] = (u8)flags;
    int old_begin_unused = s->pos_begin;
    (void)old_begin_unused;
    s->pos_begin = s->pos + 1;
    strobe_absorb(s, hdr, 2);
    if ((flags & SF_C) && s->pos != 0) strobe_run_f(s);
}

static void strobe_init(strobe *s) {
    memset(s, 0, sizeof(*s));
    static const u8 seed[18] = {1, STROBE_R + 2, 1, 0, 1, 96,
                                'S', 'T', 'R', 'O', 'B', 'E',
                                'v', '1', '.', '0', '.', '2'};
    memcpy(s->st, seed, sizeof(seed));
    strobe_permute(s);
    /* meta_ad(protocol label "Merlin v1.0") */
    strobe_begin_op(s, SF_M | SF_A);
    strobe_absorb(s, (const u8 *)"Merlin v1.0", 11);
}

static void merlin_append(strobe *s, const u8 *label, u64 llen,
                          const u8 *msg, u64 mlen) {
    u8 le[4] = {(u8)mlen, (u8)(mlen >> 8), (u8)(mlen >> 16),
                (u8)(mlen >> 24)};
    strobe_begin_op(s, SF_M | SF_A);
    strobe_absorb(s, label, llen);
    strobe_absorb(s, le, 4);
    strobe_begin_op(s, SF_A);
    strobe_absorb(s, msg, mlen);
}

static void merlin_challenge(strobe *s, const u8 *label, u64 llen,
                             u8 *out, u64 n) {
    u8 le[4] = {(u8)n, (u8)(n >> 8), (u8)(n >> 16), (u8)(n >> 24)};
    strobe_begin_op(s, SF_M | SF_A);
    strobe_absorb(s, label, llen);
    strobe_absorb(s, le, 4);
    strobe_begin_op(s, SF_I | SF_A | SF_C);
    strobe_squeeze(s, out, n);
}

#define ML(x) (const u8 *)x, (sizeof(x) - 1)

/* schnorrkel verify challenge: k = transcript(...) -> 64 bytes */
static void sr25519_challenge(u8 *wide64, const u8 *pub32, const u8 *r32,
                              const u8 *msg, u64 mlen) {
    strobe s;
    strobe_init(&s);
    merlin_append(&s, ML("dom-sep"), ML("SigningContext"));
    merlin_append(&s, ML(""), (const u8 *)"", 0);
    merlin_append(&s, ML("sign-bytes"), msg, mlen);
    merlin_append(&s, ML("proto-name"), ML("Schnorr-sig"));
    merlin_append(&s, ML("sign:pk"), pub32, 32);
    merlin_append(&s, ML("sign:R"), r32, 32);
    merlin_challenge(&s, ML("sign:c"), wide64, 64);
}

/* group order l, little-endian bytes, for the s < l check */
static const u8 LBYTES[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58, 0xd6, 0x9c, 0xf7,
    0xa2, 0xde, 0xf9, 0xde, 0x14, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};

static int scalar_lt_l(const u8 *s) {
    for (int i = 31; i >= 0; i--) {
        if (s[i] < LBYTES[i]) return 1;
        if (s[i] > LBYTES[i]) return 0;
    }
    return 0;
}

/* Shared scalar staging for every sr25519 entry point: schnorrkel
 * marker bit, masked s with s < L screen, and the merlin transcript
 * challenge k = H(transcript) mod L. */
static int sr25519_stage_one(const u8 *pub32, const u8 *sig, const u8 *msg,
                             u64 mlen, u8 *k32, u8 *s_out) {
    if (!(sig[63] & 0x80)) return 0; /* schnorrkel marker */
    u8 s_bytes[32];
    memcpy(s_bytes, sig + 32, 32);
    s_bytes[31] &= 0x7F;
    if (!scalar_lt_l(s_bytes)) return 0;
    u8 wide[64];
    sr25519_challenge(wide, pub32, sig, msg, mlen);
    tm_mod_l(wide, k32, 1);
    memcpy(s_out, s_bytes, 32);
    return 1;
}

static int sr25519_verify_one(const u8 *pub32, const u8 *msg, u64 mlen,
                              const u8 *sig) {
    ept A, R, Rp, B, negA;
    u8 s_bytes[32], k32[32];
    if (!sr25519_stage_one(pub32, sig, msg, mlen, k32, s_bytes)) return 0;
    if (!ristretto_decode(&A, pub32)) return 0;
    if (!ristretto_decode(&R, sig)) return 0;
    /* R' = s*B + k*(-A) */
    f25519_from_le(&B.x, BX_BYTES);
    f25519_from_le(&B.y, BY_BYTES);
    memset(&B.z, 0, sizeof(B.z));
    B.z.v[0] = 1;
    f25519_mul(&B.t, &B.x, &B.y);
    negA = A;
    f25519_neg(&negA.x, &A.x);
    f25519_neg(&negA.t, &A.t);
    ept_mul2(&Rp, s_bytes, &B, k32, &negA);
    return ristretto_eq(&Rp, &R);
}

EXPORT void tm_sr25519_verify(const u8 *pubs32, const u8 *msgbuf,
                              const u64 *offsets, const u8 *sigs,
                              u8 *out, u64 n) {
    for (u64 i = 0; i < n; i++)
        out[i] = (u8)sr25519_verify_one(
            pubs32 + 32 * i, msgbuf + offsets[i],
            offsets[i + 1] - offsets[i], sigs + 64 * i);
}

/* ===================================================================== */
/* Batch verification: random linear combination + Pippenger MSM         */
/*                                                                       */
/* Per BIP-340's batch-verification spec and schnorrkel/dalek's          */
/* verify_batch: with z_i random 128-bit scalars (z_0 = 1),              */
/*                                                                       */
/*   secp:  (sum z_i s_i) G - sum z_i R_i - sum (z_i e_i) P_i == inf    */
/*   sr25519: (sum z_i s_i) B - sum z_i R_i - sum (z_i c_i) A_i in E[4] */
/*                                                                       */
/* implies every signature valid except with probability ~2^-128.  On    */
/* failure the set is bisected, so per-signature verdicts are EXACTLY    */
/* the single-verify verdicts (size-1 batches degenerate to the plain    */
/* equation; z != 0 mod group order since 0 < z < 2^128 < order).        */
/* The z_i derive from a caller-supplied 32-byte seed (os.urandom in     */
/* libs/native.py) via SHA-256(seed || le64(i)): an adversary commits    */
/* to the batch before the seed exists.                                  */
/*                                                                       */
/* The MSM is Pippenger's bucket method; all batch entry points are      */
/* affine (z=1), so bucket accumulation uses mixed addition.  128-bit    */
/* z_i scalars cost nothing extra: their high windows have digit 0.      */
/* ===================================================================== */

/* ---------------------------------------------- 256/512-bit helpers */

/* r[6] = z[2] * s[4] (full product) */
static void mul_128x256(u64 r[6], const u64 z[2], const u64 s[4]) {
    memset(r, 0, 6 * sizeof(u64));
    for (int i = 0; i < 2; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            u128 t = (u128)z[i] * s[j] + r[i + j] + (u64)c;
            r[i + j] = (u64)t;
            c = t >> 64;
        }
        r[i + 4] += (u64)c;
    }
}

/* acc[8] += p[6] (batch sums stay < 2^396 for n <= 2^12, no overflow) */
static void acc512_add(u64 acc[8], const u64 p[6]) {
    u128 c = 0;
    for (int i = 0; i < 8; i++) {
        c += (u128)acc[i] + (i < 6 ? p[i] : 0);
        acc[i] = (u64)c;
        c >>= 64;
    }
}

/* 2^256 mod n = 2^256 - n (n is the secp256k1 group order) */
static const u64 SECP_RN[3] = {0x402DA1732FC9BEBFULL, 0x4551231950B75FC4ULL,
                               0x0000000000000001ULL};

/* reduce a 512-bit value mod the secp group order n by repeated folding
 * of the high half through 2^256 === RN (mod n) */
static void mod_n_512(u64 out[4], const u64 t_in[8]) {
    u64 t[8];
    memcpy(t, t_in, sizeof(t));
    for (;;) {
        int high = 0;
        for (int i = 4; i < 8; i++) high |= (t[i] != 0);
        if (!high) break;
        u64 lo[8] = {t[0], t[1], t[2], t[3], 0, 0, 0, 0};
        u64 hi[4] = {t[4], t[5], t[6], t[7]};
        memset(t, 0, sizeof(t));
        memcpy(t, lo, 4 * sizeof(u64));
        u128 c;
        for (int i = 0; i < 4; i++) {      /* t += hi * RN */
            c = 0;
            for (int j = 0; j < 3; j++) {
                u128 v = (u128)hi[i] * SECP_RN[j] + t[i + j] + (u64)c;
                t[i + j] = (u64)v;
                c = v >> 64;
            }
            for (int k = i + 3; k < 8 && c; k++) {
                c += t[k];
                t[k] = (u64)c;
                c >>= 64;
            }
        }
    }
    memcpy(out, t, 4 * sizeof(u64));
    while (ge256(out, SECP_N)) sub256(out, SECP_N);
}

/* z_i = SHA-256(seed || le64(i))[0:16] as two LE limbs; z_0 = 1 */
static void derive_z(u64 z[4], const u8 *seed, u64 i) {
    z[2] = z[3] = 0;
    if (i == 0) { z[0] = 1; z[1] = 0; return; }
    u8 le[8], d[32];
    for (int j = 0; j < 8; j++) le[j] = (u8)(i >> (8 * j));
    sha256_ctx c;
    sha256_init(&c);
    sha256_update(&c, seed, 32);
    sha256_update(&c, le, 8);
    sha256_final(&c, d);
    z[0] = z[1] = 0;
    for (int j = 7; j >= 0; j--) z[0] = (z[0] << 8) | d[j];
    for (int j = 15; j >= 8; j--) z[1] = (z[1] << 8) | d[j];
    if (!(z[0] | z[1])) z[0] = 1;   /* z must be nonzero mod the order */
}

/* c-bit digit of LE-limb scalar at window w */
static inline int sc_digit(const u64 sc[4], int w, int c) {
    int bit = w * c;
    int limb = bit >> 6, off = bit & 63;
    u64 d = sc[limb] >> off;
    if (off + c > 64 && limb < 3) d |= sc[limb + 1] << (64 - off);
    return (int)(d & ((1u << c) - 1));
}

/* window width minimizing the modeled cost: per window, m bucket
 * accumulations (mixed/niels add) plus the 2*2^c bucket-sum additions
 * (full adds: the tot+=sum chain runs over every bucket).  The old
 * fixed table picked c=11 at m=2049, where the bucket-sum pass alone
 * (24 windows x 4096 full adds) cost ~2x the accumulation — measured
 * ~40% of the whole batch verify wasted. */
static int msm_window_bits(u64 m, int acc_cost, int full_cost) {
    int best = 3;
    double bestc = 1e300;
    for (int c = 3; c <= 13; c++) {
        int nw = (256 + c - 1) / c;
        double cost = (double)nw * ((double)m * acc_cost +
                                    (double)(2ull << c) * full_cost);
        if (cost < bestc) { bestc = cost; best = c; }
    }
    return best;
}

/* --------------------------------------------------- secp256k1 batch */

/* mixed add: b is affine (z == 1, not infinity); 8M + 3S vs 12M + 4S */
static void jadd_mixed(jpt *r, const jpt *a, const jpt *b) {
    if (a->inf) { *r = *b; return; }
    fe256 z1z1, u2, s2, t;
    fe_sqr(&z1z1, &a->z);
    fe_mul(&u2, &b->x, &z1z1);
    fe_mul(&t, &a->z, &z1z1);
    fe_mul(&s2, &b->y, &t);
    if (fe_eq(&a->x, &u2)) {
        if (!fe_eq(&a->y, &s2)) { r->inf = 1; return; }
        jdbl(r, a);
        return;
    }
    fe256 h, hh, hhh, rr, v, x3, y3, z3;
    fe_sub(&h, &u2, &a->x);
    fe_sqr(&hh, &h);
    fe_mul(&hhh, &h, &hh);
    fe_sub(&rr, &s2, &a->y);
    fe_mul(&v, &a->x, &hh);
    fe_sqr(&x3, &rr);
    fe_sub(&x3, &x3, &hhh);
    fe_add(&t, &v, &v);
    fe_sub(&x3, &x3, &t);
    fe_sub(&t, &v, &x3);
    fe_mul(&y3, &rr, &t);
    fe_mul(&t, &a->y, &hhh);
    fe_sub(&y3, &y3, &t);
    fe_mul(&z3, &a->z, &h);
    r->x = x3; r->y = y3; r->z = z3; r->inf = 0;
}

/* Pippenger multi-scalar multiplication; pts are affine (z=1).
 *
 * Bucket accumulation runs in AFFINE coordinates with Montgomery
 * batch inversion: each pass selects at most one pending addition per
 * bucket (affine adds into the same bucket are order-dependent),
 * batches all chord/tangent denominators, inverts the product once,
 * and completes every add with ~1S+2M plus a 3M inversion share —
 * versus 8M+3S for the mixed-Jacobian accumulate it replaces.  Equal-x
 * pairs are handled exactly: tangent doubling (den = 2y; y != 0 on
 * secp256k1 — no 2-torsion) or bucket annihilation (P + (-P) empties
 * the bucket). */
typedef struct { fe256 x, y; u8 ex; } apt;

static void secp_msm(jpt *out, const jpt *pts, const u64 (*scs)[4],
                     u64 m) {
    int c = msm_window_bits(m, 6, 16);  /* affine-batched acc ~6M */
    int nw = (256 + c - 1) / c;
    int nb = 1 << c;
    u64 nwnb = (u64)nw * nb;
    /* ALL windows' buckets accumulate simultaneously: digit streams of
     * different windows are independent, so one Montgomery pass batches
     * up to nw*nb additions behind a single inversion — per-window
     * passes only reached ~nb and the ~320M fe_pow ate the affine
     * savings (measured). */
    apt *buckets = malloc(nwnb * sizeof(apt));
    int *pend_b = malloc(nwnb * sizeof(int));
    const jpt **pend_p = malloc(nwnb * sizeof(jpt *));
    u8 *pend_dbl = malloc(nwnb);
    fe256 *den = malloc(nwnb * sizeof(fe256));
    fe256 *pref = malloc((nwnb + 1) * sizeof(fe256));
    u64 maxwork = (m ? m : 1) * (u64)nw;
    u32 *work = malloc(maxwork * sizeof(u32));
    u32 *defer = malloc(maxwork * sizeof(u32));
    u8 *busy = malloc(nwnb);
    for (u64 b = 0; b < nwnb; b++) buckets[b].ex = 0;
    /* worklist item = i * nw + w (point-major: a pass touches each
     * pts[i] for several windows back to back — cache-friendly) */
    u64 nwork = 0;
    for (u64 i = 0; i < m; i++)
        for (int w = 0; w < nw; w++)
            if (sc_digit(scs[i], w, c)) work[nwork++] = (u32)(i * nw + w);
    while (nwork) {
        memset(busy, 0, nwnb);
        u64 npend = 0, ndefer = 0;
        for (u64 t = 0; t < nwork; t++) {
            u32 item = work[t];
            u64 i = item / (u32)nw;
            int w = (int)(item % (u32)nw);
            int d = sc_digit(scs[i], w, c);
            u64 slot = (u64)w * nb + d;
            apt *bk = &buckets[slot];
            if (busy[slot]) { defer[ndefer++] = item; continue; }
            busy[slot] = 1;
            if (!bk->ex) {              /* first landing: plain copy-in */
                bk->x = pts[i].x;
                bk->y = pts[i].y;
                bk->ex = 1;
                continue;
            }
            if (fe_eq(&bk->x, &pts[i].x)) {
                if (fe_eq(&bk->y, &pts[i].y)) {
                    fe_add(&den[npend], &bk->y, &bk->y);  /* tangent: 2y */
                    pend_dbl[npend] = 1;
                } else {                /* P + (-P): bucket empties */
                    bk->ex = 0;
                    continue;
                }
            } else {
                fe_sub(&den[npend], &pts[i].x, &bk->x);
                pend_dbl[npend] = 0;
            }
            pend_b[npend] = (int)slot;
            pend_p[npend] = &pts[i];
            npend++;
        }
        if (npend) {                    /* one inversion for the pass */
            pref[0] = (fe256){{1, 0, 0, 0}};
            for (u64 k = 0; k < npend; k++)
                fe_mul(&pref[k + 1], &pref[k], &den[k]);
            fe256 inv_all;
            fe_pow(&inv_all, &pref[npend], SECP_INV_E);
            for (long long k = (long long)npend - 1; k >= 0; k--) {
                fe256 invk, lam, num, t2, x3, y3;
                fe_mul(&invk, &inv_all, &pref[k]);
                fe_mul(&inv_all, &inv_all, &den[k]);
                apt *bk = &buckets[pend_b[k]];
                const jpt *p = pend_p[k];
                if (pend_dbl[k]) {      /* tangent: num = 3x^2 */
                    fe_sqr(&num, &bk->x);
                    fe_add(&t2, &num, &num);
                    fe_add(&num, &t2, &num);
                } else {                /* chord: num = y2 - y1 */
                    fe_sub(&num, &p->y, &bk->y);
                }
                fe_mul(&lam, &num, &invk);
                fe_sqr(&x3, &lam);
                fe_sub(&x3, &x3, &bk->x);
                fe_sub(&x3, &x3, &p->x);  /* dbl: p->x == bk->x */
                fe_sub(&t2, &bk->x, &x3);
                fe_mul(&y3, &lam, &t2);
                fe_sub(&y3, &y3, &bk->y);
                bk->x = x3;
                bk->y = y3;
            }
        }
        memcpy(work, defer, ndefer * sizeof(u32));
        nwork = ndefer;
    }
    /* horner over windows: acc = sum_w 2^(cw) * window_sum(w) */
    jpt acc;
    acc.inf = 1;
    for (int w = nw - 1; w >= 0; w--) {
        if (!acc.inf)
            for (int k = 0; k < c; k++) jdbl(&acc, &acc);
        jpt sum, tot;
        sum.inf = 1; tot.inf = 1;
        for (int b = nb - 1; b >= 1; b--) {
            apt *bk = &buckets[(u64)w * nb + b];
            if (bk->ex) {
                jpt bj;
                bj.x = bk->x;
                bj.y = bk->y;
                bj.z = (fe256){{1, 0, 0, 0}};
                bj.inf = 0;
                jadd_mixed(&sum, &sum, &bj);
            }
            jadd(&tot, &tot, &sum);
        }
        jadd(&acc, &acc, &tot);
    }
    free(buckets); free(pend_b); free(pend_p); free(pend_dbl);
    free(den); free(pref); free(work); free(defer); free(busy);
    *out = acc;
}

typedef struct {
    jpt nR, nP;           /* even-y lifts of r and pubkey x, NEGATED */
    u64 e[4], s[4], z[4]; /* challenge mod n, s, random weight */
} secp_sig;

/* decode prechecks: identical to secp_verify_one's (pub prefix + on
 * curve, r < p with even-y lift, s < n); e = tagged challenge mod n */
static int secp_decode_one(secp_sig *o, const u8 *pub33, const u8 *msg,
                           u64 mlen, const u8 *sig) {
    if (pub33[0] != 2 && pub33[0] != 3) return 0;
    u64 xb[4];
    u256_from_be(xb, pub33 + 1);
    if (ge256(xb, SECP_P)) return 0;
    fe256 x, y2, y, t;
    fe_from_be(&x, pub33 + 1);
    fe_sqr(&y2, &x);
    fe_mul(&y2, &y2, &x);
    fe256 seven = {{7, 0, 0, 0}};
    fe_add(&y2, &y2, &seven);
    fe_pow(&y, &y2, SECP_SQRT_E);
    fe_sqr(&t, &y);
    if (!fe_eq(&t, &y2)) return 0;
    fe_normalize(&y);
    if (y.v[0] & 1) {           /* even-y lift, then negate for the MSM */
        /* odd y: lift is p - y, negation back to y — keep as is */
    } else {
        u64 py[4];
        memcpy(py, SECP_P, sizeof(py));
        sub256(py, y.v);
        memcpy(y.v, py, sizeof(py));
    }
    o->nP.x = x; o->nP.y = y;
    o->nP.z.v[0] = 1; o->nP.z.v[1] = o->nP.z.v[2] = o->nP.z.v[3] = 0;
    o->nP.inf = 0;
    /* r < p: even-y lift of the sig's R_x, negated */
    u64 rb[4], sb[4];
    u256_from_be(rb, sig);
    u256_from_be(sb, sig + 32);
    if (ge256(rb, SECP_P)) return 0;
    if (ge256(sb, SECP_N)) return 0;
    fe256 rx, ry2, ry;
    fe_from_be(&rx, sig);
    fe_sqr(&ry2, &rx);
    fe_mul(&ry2, &ry2, &rx);
    fe_add(&ry2, &ry2, &seven);
    fe_pow(&ry, &ry2, SECP_SQRT_E);
    fe_sqr(&t, &ry);
    if (!fe_eq(&t, &ry2)) return 0;   /* r not an x-coordinate */
    fe_normalize(&ry);
    if (!(ry.v[0] & 1)) {             /* even lift -> negate to odd */
        u64 py[4];
        memcpy(py, SECP_P, sizeof(py));
        sub256(py, ry.v);
        memcpy(ry.v, py, sizeof(py));
    }
    o->nR.x = rx; o->nR.y = ry;
    o->nR.z = o->nP.z; o->nR.inf = 0;
    memcpy(o->s, sb, sizeof(sb));
    /* challenge e = tagged_hash(r || px || sha256(msg)) mod n */
    u8 m32[32], e32[32];
    sha256_ctx hc;
    sha256_init(&hc);
    sha256_update(&hc, msg, mlen);
    sha256_final(&hc, m32);
    bip340_challenge(e32, sig, pub33 + 1, m32);
    u64 eb[4];
    u256_from_be(eb, e32);
    scalar_mod_n(eb);
    memcpy(o->e, eb, sizeof(eb));
    return 1;
}

/* batch equation over sigs[idx[0..m)]; scratch arrays hold >= 2m+1 */
static int secp_batch_check(const secp_sig *ss, const u64 *idx, u64 m,
                            jpt *pts, u64 (*scs)[4]) {
    u64 acc[8] = {0}, prod[6];
    for (u64 i = 0; i < m; i++) {
        mul_128x256(prod, ss[idx[i]].z, ss[idx[i]].s);
        acc512_add(acc, prod);
    }
    u64 S[4];
    mod_n_512(S, acc);
    u64 cnt = 0;
    pts[cnt].x.v[0] = 0;   /* G */
    memcpy(pts[cnt].x.v, SECP_GX, 32);
    memcpy(pts[cnt].y.v, SECP_GY, 32);
    pts[cnt].z.v[0] = 1;
    pts[cnt].z.v[1] = pts[cnt].z.v[2] = pts[cnt].z.v[3] = 0;
    pts[cnt].inf = 0;
    memcpy(scs[cnt], S, 32);
    cnt++;
    for (u64 i = 0; i < m; i++) {
        const secp_sig *g = &ss[idx[i]];
        pts[cnt] = g->nR;
        memcpy(scs[cnt], g->z, 32);
        cnt++;
        u64 t8[8] = {0}, ze[4];
        mul_128x256(t8, g->z, g->e);
        mod_n_512(ze, t8);
        pts[cnt] = g->nP;
        memcpy(scs[cnt], ze, 32);
        cnt++;
    }
    jpt T;
    secp_msm(&T, pts, (const u64(*)[4])scs, cnt);
    return T.inf;
}

static void secp_bisect(const secp_sig *ss, const u64 *idx, u64 m,
                        u8 *out, jpt *pts, u64 (*scs)[4]) {
    if (m == 0) return;
    if (secp_batch_check(ss, idx, m, pts, scs)) {
        for (u64 i = 0; i < m; i++) out[idx[i]] = 1;
        return;
    }
    if (m == 1) { out[idx[0]] = 0; return; }
    secp_bisect(ss, idx, m / 2, out, pts, scs);
    secp_bisect(ss, idx + m / 2, m - m / 2, out, pts, scs);
}

EXPORT void tm_secp_verify_batch(const u8 *pubs33, const u8 *msgbuf,
                                 const u64 *offsets, const u8 *sigs,
                                 const u8 *seed32, u8 *out, u64 n) {
    secp_sig *ss = malloc(n * sizeof(secp_sig));
    u64 *idx = malloc(n * sizeof(u64));
    u64 m = 0;
    for (u64 i = 0; i < n; i++) {
        out[i] = 0;
        if (secp_decode_one(&ss[i], pubs33 + 33 * i, msgbuf + offsets[i],
                            offsets[i + 1] - offsets[i], sigs + 64 * i)) {
            derive_z(ss[i].z, seed32, m);
            idx[m++] = i;
        }
    }
    if (m) {
        jpt *pts = malloc((2 * m + 1) * sizeof(jpt));
        u64 (*scs)[4] = malloc((2 * m + 1) * sizeof(*scs));
        secp_bisect(ss, idx, m, out, pts, scs);
        free(pts);
        free(scs);
    }
    free(ss);
    free(idx);
}

/* ---------------------------------------------------- sr25519 batch */

/* precomputed affine "niels" form for mixed Edwards addition (7M) */
typedef struct { f25519 yplusx, yminusx, t2d; } nept;

static void nept_from_ept(nept *r, const ept *p) {
    /* p must be affine (z == 1) */
    f25519_add(&r->yplusx, &p->y, &p->x);
    f25519_sub(&r->yminusx, &p->y, &p->x);
    f25519_mul(&r->t2d, &p->t, ed_d());
    f25519_add(&r->t2d, &r->t2d, &r->t2d);
}

static void ept_add_niels(ept *r, const ept *p, const nept *q) {
    f25519 a, b, c, d, e, f, g, h, t;
    f25519_sub(&t, &p->y, &p->x);
    f25519_mul(&a, &t, &q->yminusx);
    f25519_add(&t, &p->y, &p->x);
    f25519_mul(&b, &t, &q->yplusx);
    f25519_mul(&c, &p->t, &q->t2d);
    f25519_add(&d, &p->z, &p->z);
    f25519_sub(&e, &b, &a);
    f25519_sub(&f, &d, &c);
    f25519_add(&g, &d, &c);
    f25519_add(&h, &b, &a);
    f25519_mul(&r->x, &e, &f);
    f25519_mul(&r->y, &g, &h);
    f25519_mul(&r->z, &f, &g);
    f25519_mul(&r->t, &e, &h);
}

static void ept_msm(ept *out, const nept *pts, const u64 (*scs)[4],
                    u64 m) {
    int c = msm_window_bits(m, 8, 9);  /* niels add 8M, full add 9M */
    int nw = (256 + c - 1) / c;
    int nb = 1 << c;
    ept *buckets = malloc((u64)nb * sizeof(ept));
    u8 *used = malloc((u64)nb);
    ept acc;
    ept_identity(&acc);
    for (int w = nw - 1; w >= 0; w--) {
        for (int k = 0; k < c; k++) ept_dbl(&acc, &acc);
        memset(used, 0, (u64)nb);
        for (u64 i = 0; i < m; i++) {
            int d = sc_digit(scs[i], w, c);
            if (!d) continue;
            if (!used[d]) { ept_identity(&buckets[d]); used[d] = 1; }
            ept_add_niels(&buckets[d], &buckets[d], &pts[i]);
        }
        ept sum, tot;
        ept_identity(&sum);
        ept_identity(&tot);
        for (int b = nb - 1; b >= 1; b--) {
            if (used[b]) ept_add(&sum, &sum, &buckets[b]);
            ept_add(&tot, &tot, &sum);
        }
        ept_add(&acc, &acc, &tot);
    }
    free(buckets);
    free(used);
    *out = acc;
}

typedef struct {
    nept nR, nA;          /* decoded R and pubkey, NEGATED, niels form */
    u64 c[4], s[4], z[4]; /* challenge mod l, s, random weight */
} sr_sig;

static void le_load4(u64 v[4], const u8 *b) {
    for (int i = 0; i < 4; i++) {
        v[i] = 0;
        for (int j = 7; j >= 0; j--) v[i] = (v[i] << 8) | b[8 * i + j];
    }
}

/* 384-bit product z*c -> mod l via staging.c's wide reduction */
static void mod_l_prod(u64 out[4], const u64 z[2], const u64 c[4]) {
    u64 prod[6];
    mul_128x256(prod, z, c);
    u8 wide[64], r32[32];
    memset(wide, 0, sizeof(wide));
    for (int i = 0; i < 6; i++)
        for (int j = 0; j < 8; j++) wide[8 * i + j] = (u8)(prod[i] >> (8 * j));
    tm_mod_l(wide, r32, 1);
    le_load4(out, r32);
}

static void ept_negate(ept *p) {
    f25519_neg(&p->x, &p->x);
    f25519_neg(&p->t, &p->t);
}

static int sr_decode_one(sr_sig *o, const u8 *pub32, const u8 *msg,
                         u64 mlen, const u8 *sig) {
    u8 s_bytes[32], k32[32];
    if (!sr25519_stage_one(pub32, sig, msg, mlen, k32, s_bytes)) return 0;
    ept A, R;
    if (!ristretto_decode(&A, pub32)) return 0;
    if (!ristretto_decode(&R, sig)) return 0;
    le_load4(o->s, s_bytes);
    le_load4(o->c, k32);
    ept_negate(&A);
    ept_negate(&R);
    nept_from_ept(&o->nA, &A);
    nept_from_ept(&o->nR, &R);
    return 1;
}

/* T in E[4] <=> x(T) == 0 or y(T) == 0 (the ristretto identity class;
 * decoded representatives may carry 4-torsion, and z_i-weighted sums of
 * E[4] elements stay in E[4], so this is the exact batch analogue of
 * ristretto_eq(R', R)) */
static int ept_in_e4(const ept *t) {
    f25519 zero = {{0}};
    return f25519_eq(&t->x, &zero) || f25519_eq(&t->y, &zero);
}

static int sr_batch_check(const sr_sig *ss, const u64 *idx, u64 m,
                          nept *pts, u64 (*scs)[4]) {
    u64 acc[8] = {0}, prod[6];
    for (u64 i = 0; i < m; i++) {
        mul_128x256(prod, ss[idx[i]].z, ss[idx[i]].s);
        acc512_add(acc, prod);
    }
    u8 wide[64], r32[32];
    memset(wide, 0, sizeof(wide));
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) wide[8 * i + j] = (u8)(acc[i] >> (8 * j));
    tm_mod_l(wide, r32, 1);
    u64 S[4];
    le_load4(S, r32);
    u64 cnt = 0;
    ept B;
    f25519_from_le(&B.x, BX_BYTES);
    f25519_from_le(&B.y, BY_BYTES);
    memset(&B.z, 0, sizeof(B.z));
    B.z.v[0] = 1;
    f25519_mul(&B.t, &B.x, &B.y);
    nept_from_ept(&pts[cnt], &B);
    memcpy(scs[cnt], S, 32);
    cnt++;
    for (u64 i = 0; i < m; i++) {
        const sr_sig *g = &ss[idx[i]];
        pts[cnt] = g->nR;
        memcpy(scs[cnt], g->z, 32);
        cnt++;
        u64 zc[4];
        mod_l_prod(zc, g->z, g->c);
        pts[cnt] = g->nA;
        memcpy(scs[cnt], zc, 32);
        cnt++;
    }
    ept T;
    ept_msm(&T, pts, (const u64(*)[4])scs, cnt);
    return ept_in_e4(&T);
}

static void sr_bisect(const sr_sig *ss, const u64 *idx, u64 m, u8 *out,
                      nept *pts, u64 (*scs)[4]) {
    if (m == 0) return;
    if (sr_batch_check(ss, idx, m, pts, scs)) {
        for (u64 i = 0; i < m; i++) out[idx[i]] = 1;
        return;
    }
    if (m == 1) { out[idx[0]] = 0; return; }
    sr_bisect(ss, idx, m / 2, out, pts, scs);
    sr_bisect(ss, idx + m / 2, m - m / 2, out, pts, scs);
}

EXPORT void tm_sr25519_verify_batch(const u8 *pubs32, const u8 *msgbuf,
                                    const u64 *offsets, const u8 *sigs,
                                    const u8 *seed32, u8 *out, u64 n) {
    sr_sig *ss = malloc(n * sizeof(sr_sig));
    u64 *idx = malloc(n * sizeof(u64));
    u64 m = 0;
    for (u64 i = 0; i < n; i++) {
        out[i] = 0;
        if (sr_decode_one(&ss[i], pubs32 + 32 * i, msgbuf + offsets[i],
                          offsets[i + 1] - offsets[i], sigs + 64 * i)) {
            derive_z(ss[i].z, seed32, m);
            idx[m++] = i;
        }
    }
    if (m) {
        nept *pts = malloc((2 * m + 1) * sizeof(nept));
        u64 (*scs)[4] = malloc((2 * m + 1) * sizeof(*scs));
        sr_bisect(ss, idx, m, out, pts, scs);
        free(pts);
        free(scs);
    }
    free(ss);
    free(idx);
}

/* ------------------------------------------------ device-lane staging */

/* Host staging for the device sr25519 lane (ops/sr25519.py): the merlin
 * transcript challenge k = H(transcript) mod L and the unmasked scalar s,
 * leaving ristretto decode + the double-scalar ladder to the device.
 * out_ok = 0 marks signatures failing the HOST screens only (marker bit,
 * s < L); curve-level rejects surface from the device kernel. */
EXPORT void tm_sr25519_stage(const u8 *pubs32, const u8 *msgbuf,
                             const u64 *offsets, const u8 *sigs,
                             u8 *out_k, u8 *out_s, u8 *out_ok, u64 n) {
    for (u64 i = 0; i < n; i++) {
        const u8 *sig = sigs + 64 * i;
        memset(out_k + 32 * i, 0, 32);
        memset(out_s + 32 * i, 0, 32);
        out_ok[i] = (u8)sr25519_stage_one(
            pubs32 + 32 * i, sig, msgbuf + offsets[i],
            offsets[i + 1] - offsets[i], out_k + 32 * i, out_s + 32 * i);
    }
}
