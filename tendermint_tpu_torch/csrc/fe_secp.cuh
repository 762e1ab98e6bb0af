// GF(2^256 - 2^32 - 977), the secp256k1 base field, one element per thread
// (kernel S1, csrc/secp256k1_verify.cu; its group law is secp4.cuh).
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
//   fs_mul   the 512-bit schoolbook product L + 2^256 H (64 products in
//            carry chains; fs_sqr 36: the cross products once, doubled,
//            and the diagonal) folds once to L + C H < 2^289, the top
//            word t (< 2^33) folds again as t C, a last carry (then the
//            value is below 2^67) adds C once more, and one conditional
//            subtraction of p leaves [0, p) (fs_fold).
//   fs_add   a + b < 2p: s = a + b and t = s + C, and t when either
//            carries out of 2^256 (then t = a + b - p), else s.
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

// ---------------------------------------------------------------------------
// carry chains: each primitive is one chain of the card's carry flag
// (add.cc / addc / mad.lo.cc / madc.hi.cc in one asm block) on the card,
// and the same arithmetic with 64-bit sums on the host, so that the host
// rehearsal runs the field's every step but the instruction mapping
// ---------------------------------------------------------------------------

// r = a + b + cin (mod 2^256), cin 0 or 1; returns the carry out of 2^256
FS_DEV uint32_t fs_add8(uint32_t *r, const uint32_t *a, const uint32_t *b,
                        uint32_t cin) {
  uint32_t c;
#ifdef __CUDA_ARCH__
  uint32_t z;
  asm("add.cc.u32 %9, %26, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %0, %10, %18;\n\taddc.cc.u32 %1, %11, %19;\n\t"
      "addc.cc.u32 %2, %12, %20;\n\taddc.cc.u32 %3, %13, %21;\n\t"
      "addc.cc.u32 %4, %14, %22;\n\taddc.cc.u32 %5, %15, %23;\n\t"
      "addc.cc.u32 %6, %16, %24;\n\taddc.cc.u32 %7, %17, %25;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(c), "=r"(z)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(cin));
#else
  uint64_t v = (uint64_t)cin << 32;
  for (int i = 0; i < 8; i++) {
    v = (uint64_t)a[i] + b[i] + (v >> 32);
    r[i] = (uint32_t)v;
  }
  c = (uint32_t)(v >> 32);
#endif
  return c;
}

// r = a + (c0 + 2^32 c1) (mod 2^256); returns the carry out
FS_DEV uint32_t fs_add2(fs r, const fs a, uint32_t c0, uint32_t c1) {
  uint32_t c;
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %9, %17;\n\taddc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, 0;\n\taddc.cc.u32 %3, %12, 0;\n\t"
      "addc.cc.u32 %4, %13, 0;\n\taddc.cc.u32 %5, %14, 0;\n\t"
      "addc.cc.u32 %6, %15, 0;\n\taddc.cc.u32 %7, %16, 0;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(c0), "r"(c1));
#else
  uint64_t v = (uint64_t)a[0] + c0;
  r[0] = (uint32_t)v;
  v = (uint64_t)a[1] + c1 + (v >> 32);
  r[1] = (uint32_t)v;
  for (int i = 2; i < 8; i++) {
    v = (uint64_t)a[i] + (v >> 32);
    r[i] = (uint32_t)v;
  }
  c = (uint32_t)(v >> 32);
#endif
  return c;
}

// r = a - b (mod 2^256); returns the borrow (0 or 1)
FS_DEV uint32_t fs_sub8(fs r, const fs a, const fs b) {
  uint32_t c;
#ifdef __CUDA_ARCH__
  asm("sub.cc.u32 %0, %9, %17;\n\tsubc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\tsubc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\tsubc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\tsubc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  c &= 1u;
#else
  int64_t v = 0;
  for (int i = 0; i < 8; i++) {
    v = (int64_t)a[i] - b[i] + (v >> 32);
    r[i] = (uint32_t)v;
  }
  c = v < 0 ? 1u : 0u;
#endif
  return c;
}

// r = a - (c0 + 2^32 c1) (mod 2^256)
FS_DEV void fs_sub2(fs r, const fs a, uint32_t c0, uint32_t c1) {
#ifdef __CUDA_ARCH__
  asm("sub.cc.u32 %0, %8, %16;\n\tsubc.cc.u32 %1, %9, %17;\n\t"
      "subc.cc.u32 %2, %10, 0;\n\tsubc.cc.u32 %3, %11, 0;\n\t"
      "subc.cc.u32 %4, %12, 0;\n\tsubc.cc.u32 %5, %13, 0;\n\t"
      "subc.cc.u32 %6, %14, 0;\n\tsubc.u32 %7, %15, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(c0), "r"(c1));
#else
  int64_t v = (int64_t)a[0] - c0;
  r[0] = (uint32_t)v;
  v = (int64_t)a[1] - c1 + (v >> 32);
  r[1] = (uint32_t)v;
  for (int i = 2; i < 8; i++) {
    v = (int64_t)a[i] + (v >> 32);
    r[i] = (uint32_t)v;
  }
#endif
}

// w[0 .. 2N-1] = x b[0], x b[2], ..., x b[2N-2] as N 64-bit products on
// consecutive word pairs (disjoint, so no carries): the first row of an
// accumulator, which then needs no zeros
template <int N>
FS_DEV void fs_mulrow(uint32_t *w, uint32_t x, const uint32_t *b) {
#pragma unroll
  for (int k = 0; k < N; k++) {
#ifdef __CUDA_ARCH__
    w[2 * k] = x * b[2 * k];
    w[2 * k + 1] = __umulhi(x, b[2 * k]);
#else
    uint64_t p = (uint64_t)x * b[2 * k];
    w[2 * k] = (uint32_t)p;
    w[2 * k + 1] = (uint32_t)(p >> 32);
#endif
  }
}

// w[0 .. 2N-1] += x b[0], x b[2], ..., x b[2N-2] as N 64-bit products on
// consecutive word pairs (lo, hi), the carry added into w[2N], which the
// caller guarantees does not overflow (it holds at most a few carries)
template <int N>
FS_DEV void fs_madrow(uint32_t *w, uint32_t x, const uint32_t *b);

#ifdef __CUDA_ARCH__
template <>
FS_DEV void fs_madrow<1>(uint32_t *w, uint32_t x, const uint32_t *b) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\tmadc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2])
      : "r"(x), "r"(b[0]));
}
template <>
FS_DEV void fs_madrow<2>(uint32_t *w, uint32_t x, const uint32_t *b) {
  asm("mad.lo.cc.u32 %0, %5, %6, %0;\n\tmadc.hi.cc.u32 %1, %5, %6, %1;\n\t"
      "madc.lo.cc.u32 %2, %5, %7, %2;\n\tmadc.hi.cc.u32 %3, %5, %7, %3;\n\t"
      "addc.u32 %4, %4, 0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4])
      : "r"(x), "r"(b[0]), "r"(b[2]));
}
template <>
FS_DEV void fs_madrow<3>(uint32_t *w, uint32_t x, const uint32_t *b) {
  asm("mad.lo.cc.u32 %0, %7, %8, %0;\n\tmadc.hi.cc.u32 %1, %7, %8, %1;\n\t"
      "madc.lo.cc.u32 %2, %7, %9, %2;\n\tmadc.hi.cc.u32 %3, %7, %9, %3;\n\t"
      "madc.lo.cc.u32 %4, %7, %10, %4;\n\tmadc.hi.cc.u32 %5, %7, %10, %5;\n\t"
      "addc.u32 %6, %6, 0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
        "+r"(w[5]), "+r"(w[6])
      : "r"(x), "r"(b[0]), "r"(b[2]), "r"(b[4]));
}
template <>
FS_DEV void fs_madrow<4>(uint32_t *w, uint32_t x, const uint32_t *b) {
  asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\tmadc.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %11, %2;\n\tmadc.hi.cc.u32 %3, %9, %11, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %12, %4;\n\tmadc.hi.cc.u32 %5, %9, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %13, %6;\n\tmadc.hi.cc.u32 %7, %9, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
        "+r"(w[5]), "+r"(w[6]), "+r"(w[7]), "+r"(w[8])
      : "r"(x), "r"(b[0]), "r"(b[2]), "r"(b[4]), "r"(b[6]));
}
#else
template <int N>
FS_DEV void fs_madrow(uint32_t *w, uint32_t x, const uint32_t *b) {
  uint64_t c = 0;
  for (int k = 0; k < N; k++) {
    uint64_t p = (uint64_t)x * b[2 * k];
    uint64_t v = (uint64_t)w[2 * k] + (uint32_t)p + c;
    w[2 * k] = (uint32_t)v;
    v = (uint64_t)w[2 * k + 1] + (p >> 32) + (v >> 32);
    w[2 * k + 1] = (uint32_t)v;
    c = v >> 32;
  }
  w[2 * N] += (uint32_t)c;
}
#endif

// any value below 2^256 -> [0, p): subtract p iff a + C carries out
FS_DEV void fs_reduce_once(fs a) {
  fs t;
  bool ge = fs_add2(t, a, FS_C977, 1) != 0;
#pragma unroll
  for (int i = 0; i < 8; i++) a[i] = ge ? t[i] : a[i];
}

// r = L + 2^256 H mod p for the 512-bit value t = L + 2^256 H (16 words,
// little-endian): w = L + C H (< 2^289: the products 977 H_k, even k and
// odd k in two rows, and H shifted by a word), then the top t' = w / 2^256
// (< 2^33) folds as t' C, a last carry (then the value is below 2^67)
// adds C once more, and one conditional subtraction of p leaves [0, p)
FS_DEV void fs_fold(fs r, const uint32_t t[16]) {
  uint32_t w[10];
  const uint32_t *H = t + 8;
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = t[i];
  w[8] = 0;
  w[9] = 0;
  fs_madrow<4>(w, FS_C977, H);              // 977 H_k, k even
  fs_madrow<4>(w + 1, FS_C977, H + 1);      // 977 H_k, k odd
  w[9] += fs_add8(w + 1, w + 1, H, 0);     // 2^32 H
  // t' C = t' 977 + 2^32 t', t' = w8 + 2^32 w9: word 1 gets
  // hi(977 w8) + 977 w9 + w8 (below 2^33), word 2 w9 and that carry
#ifdef __CUDA_ARCH__
  uint64_t q1 = (uint64_t)__umulhi(w[8], FS_C977) + FS_C977 * w[9] + w[8];
#else
  uint64_t q1 = (((uint64_t)w[8] * FS_C977) >> 32) + FS_C977 * w[9] + w[8];
#endif
  uint32_t q[8] = {w[8] * FS_C977, (uint32_t)q1,
                   w[9] + (uint32_t)(q1 >> 32), 0, 0, 0, 0, 0};
  uint32_t c = fs_add8(r, w, q, 0);
  // a carry out leaves r below 2^67, so adding C once more cannot carry
  fs_add2(r, r, FS_C977 & (0u - c), c);
  fs_reduce_once(r);
}
// a + b < 2p: s = a + b, t = s + C; a + b >= p exactly when one of the
// two carries out of 2^256, and then t = a + b - p (mod 2^256)
FS_DEV void fs_add(fs r, const fs a, const fs b) {
  fs s, t;
  uint32_t c = fs_add8(s, a, b, 0);
  c |= fs_add2(t, s, FS_C977, 1);
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = c ? t[i] : s[i];
}

// a - b: a borrow subtracts C (d = a - b + 2^256, and a - b + p = d - C
// >= 1)
FS_DEV void fs_sub(fs r, const fs a, const fs b) {
  fs d;
  uint32_t bw = fs_sub8(d, a, b);
  fs_sub2(r, d, FS_C977 & (0u - bw), bw);
}

FS_DEV void fs_neg(fs r, const fs a) {
  fs z;
  fs_set_small(z, 0);
  fs_sub(r, z, a);
}

// r = a * b (canonical in, canonical out; r may alias a or b): the
// schoolbook product, 64 products, as two accumulators (the products
// a_i b_j with j even land on disjoint word pairs, so a row is one carry
// chain; the same for j odd), added, then the fold
FS_DEV void fs_mul(fs r, const fs a, const fs b) {
  uint32_t e[17], o[17], t[17];
  fs_mulrow<4>(e, a[0], b);
  fs_mulrow<4>(o + 1, a[0], b + 1);
#pragma unroll
  for (int i = 8; i < 17; i++) e[i] = 0;
#pragma unroll
  for (int i = 9; i < 17; i++) o[i] = 0;
#pragma unroll
  for (int i = 1; i < 8; i++) {
    fs_madrow<4>(e + i, a[i], b);
    fs_madrow<4>(o + i + 1, a[i], b + 1);
  }
  t[0] = e[0];
  uint32_t c = fs_add8(t + 1, e + 1, o + 1, 0);
  fs_add8(t + 9, e + 9, o + 9, c);         // t[16] = 0: a b < 2^512
  fs_fold(r, t);
}

// r = a^2 (r may alias a): the 28 cross products a_i a_j, i < j, once, in
// two accumulators by the parity of j - i (a row of each is one carry
// chain), doubled by a shift, plus the 8 diagonal products a_i^2, then
// the fold: 36 + 8 products where fs_mul(a, a) takes 64 + 8
FS_DEV void fs_sqr(fs r, const fs a) {
  uint32_t x[17], y[17], s[17], t[16];
  // row i: j - i odd into x at words 2i + 1 .., j - i even into y at 2i + 2 ..
  fs_mulrow<4>(x + 1, a[0], a + 1);
  fs_mulrow<3>(y + 2, a[0], a + 2);
  x[0] = y[0] = y[1] = 0;
#pragma unroll
  for (int i = 9; i < 17; i++) x[i] = 0;
#pragma unroll
  for (int i = 8; i < 17; i++) y[i] = 0;
  fs_madrow<3>(x + 3, a[1], a + 2);
  fs_madrow<3>(y + 4, a[1], a + 3);
  fs_madrow<3>(x + 5, a[2], a + 3);
  fs_madrow<2>(y + 6, a[2], a + 4);
  fs_madrow<2>(x + 7, a[3], a + 4);
  fs_madrow<2>(y + 8, a[3], a + 5);
  fs_madrow<2>(x + 9, a[4], a + 5);
  fs_madrow<1>(y + 10, a[4], a + 6);
  fs_madrow<1>(x + 11, a[5], a + 6);
  fs_madrow<1>(y + 12, a[5], a + 7);
  fs_madrow<1>(x + 13, a[6], a + 7);
  // s = the cross sum (words 1..15), below 2^511
  s[0] = 0;
  uint32_t c = fs_add8(s + 1, x + 1, y + 1, 0);
  fs_add8(s + 9, x + 9, y + 9, c);
  // t = the diagonal, then t += 2 s (s shifted left by one bit)
  uint32_t d[16];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t q = (uint64_t)a[i] * a[i];
    t[2 * i] = (uint32_t)q;
    t[2 * i + 1] = (uint32_t)(q >> 32);
  }
#pragma unroll
  for (int k = 0; k < 16; k++)
    d[k] = (s[k] << 1) | (k > 0 ? s[k - 1] >> 31 : 0u);
  c = fs_add8(t, t, d, 0);
  fs_add8(t + 8, t + 8, d + 8, c);
  fs_fold(r, t);
}

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

// r = c ? a : b, limb by limb (a select, not a branch)
FS_DEV void fs_sel(fs r, bool c, const fs a, const fs b) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = c ? a[i] : b[i];
}

// nibble i, most significant first (i = 0..63), of a 256-bit value
FS_DEV int fs_nibble_msb(const uint32_t w[8], int i) {
  int b = 63 - i;
  return (int)((w[b >> 3] >> ((b & 7) * 4)) & 15u);
}
