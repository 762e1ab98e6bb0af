// The group bodies of kernels C1 (the comb table build) and C2 (the comb
// verify), csrc/comb.cu, written as templates over the group's exchange and
// over the callables that read and write memory, so that a host program
// can run them on threads that meet at a barrier (tests/test_torch_comb.py
// does, against the plain versions).
//
// C1: one key on a group of four lanes, lane t holding coordinate t of
// (X, Y, Z, T), on K1's four-lane group law (verify4.cuh: dbl4, add4,
// to_cached4; the exchange is the group's get(), __shfl_sync of width 4 on
// the card).  Every product has the operands of the one-lane formulas (the
// carry argument of fe25519.cuh and verify4.cuh), so every entry is a
// multiply output (0.501-bounded, "carried") holding the plain version's
// field values.
//
// C2: one signature on G groups of four lanes (G = 1, 2, 4 or 8: one warp
// holds a signature's groups), on S2's steps and field (ristretto4.cuh
// sr_add and sr_to_cached, fe25519_2.cuh fe_mul2; the power chain
// fe25519.cuh's fe_invert on Fe2Ops): group g adds the windows g, g + G,
// ..., the groups' partial sums meet in a butterfly, and the block's
// first warp inverts the block's Zs (comb_verify4 below).
//
// Carry bounds of C2 (fe25519_2.cuh: fe_mul2 / fe_sq2 outputs are
// 0.503-bounded; CONTRACT g <= 1.68 on the folded side, f <= 16, F G <= 16;
// the addition's rounds as in ristretto4.cuh's note).
//   running point: every coordinate an fe_mul2 output (0.503), from the
//     identity (canonical 0 and 1).
//   addition, round 1: Y + X, Y - X (1.006) or Z, T (0.503) times q on the
//     folded side, where q is
//       an entry of -A's table: C1's fe_mul outputs (0.501; lane 3 may
//         negate 2dT, which keeps the bound; entry 0 is canonical), inside
//         the contract as they are, so no gathered entry is carried again;
//       an entry of B's comb: canonical limbs (1; lane 2's Z2 = 1);
//       the partner group's sr_to_cached output (0.503) in the butterfly;
//     so every G <= 1 < 1.68 and F G <= 1.006.
//   addition, round 2: E, H 1.006, F, G 1.509 (2 Z' + C) of round-1
//     outputs: widest L 1.509 < 1.68, widest F G = 2.28.
//   sr_to_cached: Y +- X (1.006), Z, T times 1 or 2d (canonical) on the
//     folded side.
//   inversion: fe_invert<Fe2Ops> of Z (0.503): every operand of the chain
//     is a chain output (0.503; fe25519_2.cuh's power-chain note).
//   x, y: X or Y (0.503) times Z^-1 (0.503, folded side).
//   compare: fe_isneg and fe_eq take any 16-bounded value.
// So every folded factor is at most 1.509 and every F G at most 2.28, > 7x
// inside the contract.
#pragma once

#include "fe25519.cuh"
#include "fe25519_2.cuh"
#include "ristretto4.cuh"
#include "verify4.cuh"

// Entries a window of a table holds: j P for j = 0..8
#define COMB_DIGITS 9
#define COMB_WINDOWS 64

// C1.  w: the 8 little-endian words of A's encoding (every lane decodes
// it, the one-lane decode of Go semantics: a non-canonical y accepted and
// reduced, a non-square and x = 0 with the sign bit rejected).
// put(win, j, c) stores lane t's coordinate c (10 limbs) of the cached
// entry [j 16^win](-A).  Per window, from g = 16^win (-A): entries 0..8
// of cached_window(g) (identity, g, 2g = dbl g, 3g = 2g + g, 4g = dbl 2g,
// 5g = 4g + g, 6g = dbl 3g, 7g = 6g + g, 8g = dbl 4g), then the next g =
// dbl 8g: the formulas and their operands are those of
// curve.cached_window and comb_table_scan, so every entry holds the same
// field values as the plain version's.  The multiples j = 2..8 run in one
// loop whose body holds one doubling, one addition, one conversion and
// one store (an odd j adds g to (j-1)g, an even j doubles (j/2)g, kept
// from earlier steps): a window written out straight would be ~16 group
// operations of code, more than the SM's instruction cache holds.
// Returns the decode verdict.
template <class X, class W>
FE_DEV bool comb_build4(X &x, const uint32_t w[8], W put) {
  const int t = x.lane();
  fe g, c1, s2, s3, s4, cur, e;
  bool ok = ge_decode(g, cur, w);  // x in g, y in cur
  // -A = (-x, y, 1, -x y): lane t's coordinate
  fe_neg(c1, g);
  fe_mul(e, c1, cur);
#pragma unroll
  for (int i = 0; i < 10; i++)
    g[i] = t == 0 ? c1[i] : t == 1 ? cur[i] : t == 2 ? (i == 0) : e[i];
#pragma unroll 1
  for (int win = 0; win < COMB_WINDOWS; win++) {
#pragma unroll
    for (int i = 0; i < 10; i++) e[i] = (t < 3 && i == 0) ? 1 : 0;
    put(win, 0, e);                  // the identity (1, 1, 1, 0)
    to_cached4(x, c1, g);
    put(win, 1, c1);
#pragma unroll 1
    for (int j = 2; j <= COMB_DIGITS - 1; j++) {
      if (j & 1) {
        add4(x, cur, c1);            // jg = (j-1)g + g
      } else {
#pragma unroll
        for (int i = 0; i < 10; i++)  // selects: the arrays stay registers
          cur[i] = j == 2 ? g[i] : j == 4 ? s2[i] : j == 6 ? s3[i] : s4[i];
        dbl4(x, cur);                // jg = 2 (j/2)g
      }
      to_cached4(x, e, cur);
      put(win, j, e);
      if (j == 2) fe_copy(s2, cur);
      if (j == 3) fe_copy(s3, cur);
      if (j == 4) fe_copy(s4, cur);
    }
    dbl4(x, cur);                    // 16g: the next window's base
    fe_copy(g, cur);
  }
  return ok;
}


// ---------------------------------------------------------------------------
// C2: a signature's windows split over G four-lane groups
// ---------------------------------------------------------------------------
// The exchange of C2's body (on the card C2Xch in comb.cu; on the host four
// G threads that meet at a barrier), for a class X:
//   int lane()                         this lane's index t in its group
//   int tid()                          this thread's index in the block
//   int threads()                      the block's threads
//   int32_t get(int32_t v, int src)    v as held by lane src of the group
//   int32_t xor_get(int32_t v, int d)  v as held by thread tid ^ d (d = 4,
//                                      8, 16: the same lane of another
//                                      group of the signature, in its warp)
//   void sync()                        a barrier of the whole block
//   uint32_t *words()                  the block's shared words,
//                                      C2_SIG_WORDS a signature
// Every thread of the block calls get, xor_get and sync the same number of
// times in the same order.
//
// A signature's row (COMB_ROW_WORDS little-endian words): R, s, k, then
// its table row (int32).  Its shared words: the digit words of s and k
// (s + 0x88..8, k + 0x88..8), then Z of P (Z^-1 after phase 2) and one
// word of padding: C2_SIG_WORDS is odd,
// so that the signatures of a warp read their digits from different banks.
#define COMB_ROW_WORDS 25
#define COMB_ROW_KEY 24        // the word that holds the table row
#define C2_DIGITS 0
#define C2_Z 16
#define C2_SIG_WORDS 27

// the signed radix-16 digit of window win, from the digit words dw of s or
// k (verify4.cuh digit_words): nibble win of s + 0x88..8, less 8
FE_DEV int comb_digit(const uint32_t *dw, int win) {
  return (int)((dw[win >> 3] >> ((win & 7) * 4)) & 15) - 8;
}

// The partial sum of group g of G: for each window win = g, g + G, ...,
// one niels addition of [s_win 16^win] B from B's comb and one cached
// addition of [k_win 16^win](-A) gathered from -A's table (a_entry(win, j):
// the 40 words of entry [win][j]), from the identity (a group whose digits
// are all zero holds it; the formulas are complete).  Then the G partial
// sums are added by a butterfly over the groups: each group converts its
// sum to the cached form, takes its partner's (xor_get at distance 4, 8,
// 16) and adds it, so that after log2 G levels every group holds P.  The
// partial sums are added in another order than the plain version's, so
// P's projective coordinates differ from its; the point does not.
template <class X, class E>
FE_DEV void comb_sum4(X &x, fe p, int G, int g, const uint32_t *dw,
                      E a_entry, const int32_t *__restrict__ base) {
  const int t = x.lane();
  fe a;
#pragma unroll
  for (int i = 0; i < 10; i++) p[i] = (i == 0 && (t == 1 || t == 2));
#pragma unroll 1
  for (int win = g; win < COMB_WINDOWS; win += G) {
#pragma unroll 1
    for (int h = 0; h < 2; h++) {
      const int dg = comb_digit(dw + 8 * h, win);
      const int j = dg < 0 ? -dg : dg;
      if (h == 0)
        niels_coord(a, t, base + 30 * (COMB_DIGITS * win + j), dg < 0);
      else
        cached_coord(a, t, a_entry(win, j), dg < 0);
      sr_add(x, p, a);
    }
  }
#pragma unroll 1
  for (int d = 4; d < 4 * G; d <<= 1) {
    sr_to_cached(x, a, p);
#pragma unroll
    for (int i = 0; i < 10; i++) a[i] = x.xor_get(a[i], d);
    sr_add(x, p, a);
  }
}

// Whether the encoding of the point whose affine coordinates are xy (x on
// lane 0, y on lane 1) is the 8 words r: lane 1 checks that r's low 255
// bits are canonical and equal y, lane 0 that r's bit 255 is the parity of
// x (the same verdict as encode-and-compare byte for byte).  On every
// lane of the group.
template <class X>
FE_DEV bool comb_compare4(X &x, const fe xy, const uint32_t r[8]) {
  const int t = x.lane();
  fe rr;
  fe_frombytes(rr, r);
  bool ok0 = fe_isneg(xy) == (bool)((r[7] >> 31) & 1);
  bool ok1 = fe_bytes_canonical(r) && fe_eq(xy, rr);
  int32_t bit = (t == 0 ? ok0 : ok1) ? 1 : 0;
  return (x.get(bit, 0) & x.get(bit, 1)) != 0;
}

// C2's body: the verdict encode([s]B + [k](-A)) == R of the signature whose
// row is `row`, on every lane of its groups (the caller ANDs the range of
// its table row and A's decode verdict).  A block of x.threads() threads
// serves threads() / 4G signatures; log_g = log2 G.
//   phase 0  lanes 0 and 1 of the signature's group 0 form the digit words
//            of s and k (as K1 does: csrc/ed25519_verify.cu) in the
//            signature's shared words
//   phase 1  comb_sum4; group 0's lane 2 puts Z of P in the shared words
//   phase 2  the block's first warp inverts the block's Zs, one a lane (one
//            instruction stream for them all, on the two-round-carry
//            field); the other warps wait at the barrier
//   phase 3  lane 0 forms x = X Z^-1, lane 1 y = Y Z^-1 (xy), and the
//            group compares the encoding with R
template <class X, class E>
FE_DEV bool comb_verify4(X &x, int log_g, const uint32_t *row, E a_entry,
                         const int32_t *__restrict__ base, fe xy) {
  const int t = x.lane(), tid = x.tid();
  const int g = (tid >> 2) & ((1 << log_g) - 1);
  uint32_t *sw = x.words() + C2_SIG_WORDS * (tid >> (2 + log_g));
  if (g == 0 && t < 2) {
    uint32_t w[8];
#pragma unroll
    for (int q = 0; q < 8; q++) w[q] = row[8 + 8 * t + q];
    digit_words(w, w);
#pragma unroll
    for (int q = 0; q < 8; q++) sw[C2_DIGITS + 8 * t + q] = w[q];
  }
  x.sync();
  fe p;
  comb_sum4(x, p, 1 << log_g, g, sw + C2_DIGITS, a_entry, base);
  if (g == 0 && t == 2) {
#pragma unroll
    for (int i = 0; i < 10; i++) sw[C2_Z + i] = p[i];
  }
  x.sync();
  if (tid < 32) {
    const int n = x.threads() >> (2 + log_g);
    uint32_t *zw = x.words() + C2_SIG_WORDS * tid + C2_Z;
    fe z;  // a lane past the block's signatures inverts 1
#pragma unroll
    for (int i = 0; i < 10; i++) z[i] = tid < n ? (int32_t)zw[i] : (i == 0);
    fe_invert<Fe2Ops>(z, z);
    if (tid < n) {
#pragma unroll
      for (int i = 0; i < 10; i++) zw[i] = z[i];
    }
  }
  x.sync();
  fe zi;
#pragma unroll
  for (int i = 0; i < 10; i++) zi[i] = sw[C2_Z + i];
  fe_mul2(xy, p, zi);
  uint32_t r[8];
#pragma unroll
  for (int q = 0; q < 8; q++) r[q] = row[q];
  return comb_compare4(x, xy, r);
}
