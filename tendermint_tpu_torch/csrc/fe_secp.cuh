// GF(2^256 - 2^32 - 977), the secp256k1 base field, one element per thread,
// and the secp256k1 group law in Jacobian coordinates (kernel S1,
// csrc/secp256k1_verify.cu).
//
// Counterpart of tendermint_tpu/ops/field_secp.py and of the curve
// functions of tendermint_tpu/ops/secp.py.  The TPU keeps an element as 22
// int32 limbs of 12 bits because its vector unit has no wide multiply; a
// Hopper thread has a 32x32->64-bit integer multiply-add, so here an
// element is EIGHT uint32 limbs, little-endian, always CANONICAL (value in
// [0, p)).  Only the values are shared with the plain field: S1 is held
// against its plain version as verdict bitmaps, and this field as
// canonical values (fe_secp_selftest in secp256k1_verify.cu against
// ops/field_secp.py).
//
// Reduction.  p = 2^256 - C with C = 2^32 + 977, so 2^256 = C (mod p).
//   fs_mul   the 512-bit schoolbook product L + 2^256 H (64 products,
//            uint64 accumulation) folds once to L + C H < 2^289, the top
//            word t (< 2^33) folds again as t C, a last carry (then the
//            value is below 2^67) adds C once more, and one conditional
//            subtraction of p leaves [0, p).
//   fs_add   a + b < 2p: a carry out of 2^256 adds C (the sum is then
//            a + b - p < p), otherwise one conditional subtraction.
//   fs_sub   a - b: a borrow subtracts C (the result a - b + p >= 1).
//   a >= p exactly when a + C carries out of 2^256, which is how
//   fs_reduce_once decides; it takes any value below 2^256 to [0, p).
// Canonical values make zero tests, equality and parity plain word
// compares (the y-parity and x = r checks of BIP-340 need fully reduced
// values, and get them for free).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FS_DEV __device__ __forceinline__
#else
#define FS_DEV static inline
#endif

typedef uint32_t fs[8];

#define FS_C977 977u

FS_DEV void fs_copy(fs r, const fs a) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = a[i];
}

FS_DEV void fs_set_small(fs r, uint32_t v) {
  r[0] = v;
#pragma unroll
  for (int i = 1; i < 8; i++) r[i] = 0;
}

FS_DEV bool fs_iszero(const fs a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a[i];
  return acc == 0;
}

FS_DEV bool fs_eq(const fs a, const fs b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a[i] ^ b[i];
  return acc == 0;
}

// any value below 2^256 -> [0, p): subtract p iff a + C carries out
FS_DEV void fs_reduce_once(fs a) {
  fs t;
  uint64_t v = (uint64_t)a[0] + FS_C977;
  t[0] = (uint32_t)v;
  v = (uint64_t)a[1] + 1u + (v >> 32);
  t[1] = (uint32_t)v;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    v = (uint64_t)a[i] + (v >> 32);
    t[i] = (uint32_t)v;
  }
  bool ge = (v >> 32) != 0;
#pragma unroll
  for (int i = 0; i < 8; i++) a[i] = ge ? t[i] : a[i];
}

// r = a + k C (mod 2^256) for k < 2^34; returns the carry out of 2^256
FS_DEV uint32_t fs_add_kc(fs r, const fs a, uint64_t k) {
  uint64_t v = (uint64_t)a[0] + k * FS_C977;
  r[0] = (uint32_t)v;
  v = (uint64_t)a[1] + (k & 0xFFFFFFFFu) + (v >> 32);
  r[1] = (uint32_t)v;
  v = (uint64_t)a[2] + (k >> 32) + (v >> 32);
  r[2] = (uint32_t)v;
#pragma unroll
  for (int i = 3; i < 8; i++) {
    v = (uint64_t)a[i] + (v >> 32);
    r[i] = (uint32_t)v;
  }
  return (uint32_t)(v >> 32);
}

FS_DEV void fs_add(fs r, const fs a, const fs b) {
  fs s;
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    v = (uint64_t)a[i] + b[i] + (v >> 32);
    s[i] = (uint32_t)v;
  }
  fs_add_kc(r, s, v >> 32);   // carry: + C (then already below p)
  fs_reduce_once(r);
}

FS_DEV void fs_sub(fs r, const fs a, const fs b) {
  fs d;
  int64_t v = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    v = (int64_t)a[i] - b[i] + (v >> 32);
    d[i] = (uint32_t)v;
  }
  // borrow: d = a - b + 2^256, and a - b + p = d - C >= 1
  uint32_t bw = v < 0 ? 1u : 0u;
  uint32_t m0 = bw * FS_C977, m1 = bw;
  int64_t w = (int64_t)d[0] - m0;
  r[0] = (uint32_t)w;
  w = (int64_t)d[1] - m1 + (w >> 32);
  r[1] = (uint32_t)w;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    w = (int64_t)d[i] + (w >> 32);
    r[i] = (uint32_t)w;
  }
}

FS_DEV void fs_neg(fs r, const fs a) {
  fs z;
  fs_set_small(z, 0);
  fs_sub(r, z, a);
}

// r = a * b (canonical in, canonical out; r may alias a or b)
FS_DEV void fs_mul(fs r, const fs a, const fs b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t v = (uint64_t)a[i] * b[j] + t[i + j] + c;
      t[i + j] = (uint32_t)v;
      c = v >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  // L + C H: word i gets 977 H_i + H_{i-1} (the 2^32 part)
  fs w;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t v = (uint64_t)t[8 + i] * FS_C977 + t[i] + c +
                 (i > 0 ? t[7 + i] : 0u);
    w[i] = (uint32_t)v;
    c = v >> 32;
  }
  uint64_t top = c + t[15];           // weight 2^256, below 2^33
  uint32_t c2 = fs_add_kc(w, w, top);
  // a carry out leaves w below 2^67, so adding C once more cannot carry
  fs_add_kc(r, w, c2);
  fs_reduce_once(r);
}

FS_DEV void fs_sqr(fs r, const fs a) { fs_mul(r, a, a); }

// r = a^(2^n) by n squarings
FS_DEV void fs_sqrn(fs r, const fs a, int n) {
  fs_sqr(r, a);
#pragma unroll 1
  for (int i = 1; i < n; i++) fs_sqr(r, r);
}

// the shared prefix of the square-root and inversion chains (the
// addition chain of libsecp256k1's field code): x223 = a^(2^223 - 1),
// x22 = a^(2^22 - 1), x2 = a^3.  222 squarings and 11 multiplies.
FS_DEV void fs_chain223(fs x223, fs x22, fs x2, const fs a) {
  fs x3, t, x44;
  fs_sqr(x2, a);
  fs_mul(x2, x2, a);          // 2^2 - 1
  fs_sqr(x3, x2);
  fs_mul(x3, x3, a);          // 2^3 - 1
  fs_sqrn(t, x3, 3);
  fs_mul(t, t, x3);           // 2^6 - 1
  fs_sqrn(t, t, 3);
  fs_mul(t, t, x3);           // 2^9 - 1
  fs_sqrn(t, t, 2);
  fs_mul(t, t, x2);           // 2^11 - 1
  fs_sqrn(x22, t, 11);
  fs_mul(x22, x22, t);        // 2^22 - 1
  fs_sqrn(t, x22, 22);
  fs_mul(x44, t, x22);        // 2^44 - 1
  fs_sqrn(t, x44, 44);
  fs_mul(t, t, x44);          // 2^88 - 1
  fs_sqrn(x223, t, 88);
  fs_mul(x223, x223, t);      // 2^176 - 1
  fs_sqrn(x223, x223, 44);
  fs_mul(x223, x223, x44);    // 2^220 - 1
  fs_sqrn(x223, x223, 3);
  fs_mul(x223, x223, x3);     // 2^223 - 1
}

// a^((p+1)/4): a square root when a is a square (the caller checks).
// 253 squarings, 13 multiplies.
FS_DEV void fs_sqrt(fs r, const fs a) {
  fs x223, x22, x2;
  fs_chain223(x223, x22, x2, a);
  fs_sqrn(r, x223, 23);
  fs_mul(r, r, x22);
  fs_sqrn(r, r, 6);
  fs_mul(r, r, x2);
  fs_sqrn(r, r, 2);
}

// a^(p-2) (Fermat; 0 maps to 0).  255 squarings, 15 multiplies.
FS_DEV void fs_invert(fs r, const fs a) {
  fs x223, x22, x2;
  fs_chain223(x223, x22, x2, a);
  fs_sqrn(r, x223, 23);
  fs_mul(r, r, x22);
  fs_sqrn(r, r, 5);
  fs_mul(r, r, a);
  fs_sqrn(r, r, 3);
  fs_mul(r, r, x2);
  fs_sqrn(r, r, 2);
  fs_mul(r, r, a);
}

// ---------------------------------------------------------------------------
// the group law on y^2 = x^3 + 7, Jacobian (X : Y : Z), x = X/Z^2,
// y = Y/Z^3; Z = 0 is the point at infinity
// ---------------------------------------------------------------------------

struct jpt {
  fs X, Y, Z;
};

// dbl-2009-l (a = 0): 5 squarings, 2 multiplies.  No point of the curve
// has y = 0 (-7 is not a cube mod p), and Z = 0 maps to Z = 0.
FS_DEV void jac_dbl(jpt &r, const jpt &p) {
  fs a, b, c, d, e, f, t;
  fs_sqr(a, p.X);
  fs_sqr(b, p.Y);
  fs_sqr(c, b);
  fs_add(t, p.X, b);
  fs_sqr(d, t);
  fs_sub(d, d, a);
  fs_sub(d, d, c);
  fs_add(d, d, d);            // D = 2 ((X + B)^2 - A - C)
  fs_add(e, a, a);
  fs_add(e, e, a);            // E = 3 A
  fs_sqr(f, e);
  fs_mul(t, p.Y, p.Z);
  fs_add(r.Z, t, t);          // Z3 = 2 Y Z (p.Y, p.Z read before)
  fs_sub(f, f, d);
  fs_sub(r.X, f, d);          // X3 = F - 2 D
  fs_sub(t, d, r.X);
  fs_mul(t, e, t);
  fs_add(c, c, c);
  fs_add(c, c, c);
  fs_add(c, c, c);            // 8 C
  fs_sub(r.Y, t, c);          // Y3 = E (D - X3) - 8 C
}

FS_DEV void jac_set_inf(jpt &r) {
  fs_set_small(r.X, 1);
  fs_set_small(r.Y, 1);
  fs_set_small(r.Z, 0);
}

FS_DEV void jac_copy(jpt &r, const jpt &p) {
  fs_copy(r.X, p.X);
  fs_copy(r.Y, p.Y);
  fs_copy(r.Z, p.Z);
}

// The tail shared by both additions: from U1, S1 (of p), H = U2 - U1 and
// R = 2 (S2 - S1) and the Z3 factor zh, X3 = R^2 - J - 2V,
// Y3 = R (V - X3) - 2 S1 J, with I = (2H)^2, J = H I, V = U1 I.
FS_DEV void jac_add_tail(jpt &r, const fs u1, const fs s1, const fs h,
                         const fs rr, const fs z3) {
  fs i, j, v, t;
  fs_add(t, h, h);
  fs_sqr(i, t);
  fs_mul(j, h, i);
  fs_mul(v, u1, i);
  fs_sqr(t, rr);
  fs_sub(t, t, j);
  fs_sub(t, t, v);
  fs_sub(t, t, v);            // X3
  fs_sub(v, v, t);
  fs_mul(v, rr, v);           // R (V - X3)
  fs_mul(j, s1, j);
  fs_add(j, j, j);            // 2 S1 J
  fs_copy(r.X, t);
  fs_sub(r.Y, v, j);
  fs_copy(r.Z, z3);
}

// Complete addition r = p + q (r may alias p): add-2007-bl, 11 multiplies
// and 5 squarings, with branches for the degenerate cases the reference
// selects (ops/secp.py add): an infinity operand returns the other, P = Q
// doubles, P = -Q gives infinity.  The branches are taken only for those
// inputs, which an attacker can force but which cost one divergent path.
FS_DEV void jac_add(jpt &r, const jpt &p, const jpt &q) {
  if (fs_iszero(q.Z)) {
    if (&r != &p) jac_copy(r, p);
    return;
  }
  if (fs_iszero(p.Z)) {
    jac_copy(r, q);
    return;
  }
  fs z1z1, z2z2, u1, u2, s1, s2, h, rr, t;
  fs_sqr(z1z1, p.Z);
  fs_sqr(z2z2, q.Z);
  fs_mul(u1, p.X, z2z2);
  fs_mul(u2, q.X, z1z1);
  fs_mul(s1, p.Y, q.Z);
  fs_mul(s1, s1, z2z2);
  fs_mul(s2, q.Y, p.Z);
  fs_mul(s2, s2, z1z1);
  fs_sub(h, u2, u1);
  fs_sub(rr, s2, s1);
  if (fs_iszero(h)) {
    if (fs_iszero(rr)) {
      jpt d;
      jac_dbl(d, p);
      jac_copy(r, d);
    } else {
      jac_set_inf(r);
    }
    return;
  }
  fs_add(rr, rr, rr);
  fs_add(t, p.Z, q.Z);
  fs_sqr(t, t);
  fs_sub(t, t, z1z1);
  fs_sub(t, t, z2z2);
  fs_mul(t, t, h);            // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  jac_add_tail(r, u1, s1, h, rr, t);
}

// Complete mixed addition r = p + (x2, y2) for an affine point (Z2 = 1;
// r may alias p): madd-2007-bl, 7 multiplies and 4 squarings, with the
// same degenerate branches.
FS_DEV void jac_madd(jpt &r, const jpt &p, const fs x2, const fs y2) {
  if (fs_iszero(p.Z)) {
    fs_copy(r.X, x2);
    fs_copy(r.Y, y2);
    fs_set_small(r.Z, 1);
    return;
  }
  fs z1z1, u2, s2, h, rr, t;
  fs_sqr(z1z1, p.Z);
  fs_mul(u2, x2, z1z1);
  fs_mul(s2, y2, p.Z);
  fs_mul(s2, s2, z1z1);
  fs_sub(h, u2, p.X);
  fs_sub(rr, s2, p.Y);
  if (fs_iszero(h)) {
    if (fs_iszero(rr)) {
      jpt d;
      jac_dbl(d, p);
      jac_copy(r, d);
    } else {
      jac_set_inf(r);
    }
    return;
  }
  fs_add(rr, rr, rr);
  fs_add(t, p.Z, h);
  fs_sqr(t, t);
  fs_sub(t, t, z1z1);
  fs_sqr(s2, h);
  fs_sub(t, t, s2);           // Z3 = (Z1 + H)^2 - Z1Z1 - HH = 2 Z1 H
  fs u1, s1;
  fs_copy(u1, p.X);
  fs_copy(s1, p.Y);
  jac_add_tail(r, u1, s1, h, rr, t);
}

// ---------------------------------------------------------------------------
// one BIP-340 verdict: kernel S1's body (the kernel runs it one signature a
// thread; tests/test_torch_secp.py runs it under g++ on the host)
// ---------------------------------------------------------------------------

// nibble i, most significant first (i = 0..63), of a 256-bit value
FS_DEV int fs_nibble_msb(const fs w, int i) {
  int b = 63 - i;
  return (int)((w[b >> 3] >> ((b & 7) * 4)) & 15u);
}

// word w of table entry j lives at tab[(24 j + w) * stride]
FS_DEV void tab_store(uint32_t *tab, int stride, int j, const jpt &p) {
  uint32_t *e = tab + 24 * j * stride;
  for (int i = 0; i < 8; i++) {
    e[i * stride] = p.X[i];
    e[(8 + i) * stride] = p.Y[i];
    e[(16 + i) * stride] = p.Z[i];
  }
}

FS_DEV void tab_load(jpt &p, const uint32_t *tab, int stride, int j) {
  const uint32_t *e = tab + 24 * j * stride;
  for (int i = 0; i < 8; i++) {
    p.X[i] = e[i * stride];
    p.Y[i] = e[(8 + i) * stride];
    p.Z[i] = e[(16 + i) * stride];
  }
}

// The verdict of one signature.
//   load  a callable load(k, w) that fills the 8 little-endian words of
//         input k (0 px, 1 rx, 2 s, 3 e), each any value below 2^256; it
//         is called where the value is needed, so that nothing waits in a
//         register (rx only at the end)
//   g     jG, j = 0..15, affine x then y (16 x 16 words; entry 0 unused)
//   tab   the thread's table scratch (16 x 24 words at `stride`)
// lift_x(px) with even y (a non-square x^3 + 7 rejects); R' = [s]G +
// [e](-P), 64 steps of 4 doublings, a mixed add of G's entry and a
// complete add of -P's, a zero digit skipping its add; accept iff R' is
// finite, x(R') = rx mod p and y(R') is even.
template <class L>
FS_DEV bool secp_verify1(L load, const uint32_t *g, uint32_t *tab,
                         int stride) {
  jpt np;
  bool ok;
  {
    fs c, y, t;
    load(0, np.X);
    fs_reduce_once(np.X);
    fs_sqr(t, np.X);
    fs_mul(c, t, np.X);
    fs_set_small(t, 7);
    fs_add(c, c, t);
    fs_sqrt(y, c);
    fs_sqr(t, y);
    ok = fs_eq(t, c);
    if (y[0] & 1) fs_neg(y, y);
    fs_neg(np.Y, y);
    fs_set_small(np.Z, 1);
  }
  {
    jpt acc;
    tab_store(tab, stride, 1, np);
    jac_dbl(acc, np);
    tab_store(tab, stride, 2, acc);
#pragma unroll 1
    for (int j = 3; j < 16; j++) {
      tab_load(np, tab, stride, 1);
      jac_add(acc, acc, np);
      tab_store(tab, stride, j, acc);
    }
  }
  jpt acc;
  {
    fs sw, ew;
    load(2, sw);
    load(3, ew);
    jac_set_inf(acc);
#pragma unroll 1
    for (int i = 0; i < 64; i++) {
#pragma unroll 1
      for (int k = 0; k < 4; k++) jac_dbl(acc, acc);
      int ds = fs_nibble_msb(sw, i);
      if (ds) {
        fs gx, gy;
        for (int w = 0; w < 8; w++) {
          gx[w] = g[16 * ds + w];
          gy[w] = g[16 * ds + 8 + w];
        }
        jac_madd(acc, acc, gx, gy);
      }
      int de = fs_nibble_msb(ew, i);
      if (de) {
        jpt q;
        tab_load(q, tab, stride, de);
        jac_add(acc, acc, q);
      }
    }
  }
  bool fin = !fs_iszero(acc.Z);
  fs zi, zz, x, rx;
  fs_invert(zi, acc.Z);
  fs_sqr(zz, zi);
  fs_mul(x, acc.X, zz);
  fs_mul(zz, zz, zi);
  fs_mul(acc.Y, acc.Y, zz);
  load(1, rx);
  fs_reduce_once(rx);
  return ok && fin && fs_eq(x, rx) && !(acc.Y[0] & 1);
}
