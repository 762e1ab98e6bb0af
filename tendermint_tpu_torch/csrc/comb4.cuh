// The group bodies of kernels C1 (the comb table build) and C2 (the comb
// verify), csrc/comb.cu: one key (C1) or one signature (C2) on a group of
// four lanes, lane t holding coordinate t of (X, Y, Z, T), on the four-lane
// group law of verify4.cuh (dbl4, add4, to_cached4; the exchange is the
// group's get(), __shfl_sync of width 4 on the card).  Written as templates
// over the group and over the callables that read and write memory, so a
// host program can run them on four threads that meet at a barrier
// (tests/test_torch_comb.py does, against the plain versions).
//
// Every product has the operands of the one-lane formulas (the carry
// argument of fe25519.cuh and verify4.cuh): the running point and every
// table entry are multiply outputs (carried); B's comb is canonical.
#pragma once

#include "fe25519.cuh"
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

// C2.  digit(win, h): the signed radix-16 digit of window win of s
// (h = 0) or of k (h = 1), in [-8, 7]; a_entry(win, j): the 40 words
// (4 coordinates x 10 limbs) of entry [win][j] of -A's table; base: B's
// comb, 64 x 9 niels entries of 3 x 10 limbs; r: the 8 words of R.
// P = sum over the windows of [s_win 16^win] B + [k_win 16^win](-A), from
// the identity: per window one niels and one cached addition, no
// doubling.  Then the encoding of P is compared with R: lane 1 checks
// that R's low 255 bits are canonical and equal y_P = Y/Z, lane 0 that
// R's bit 255 is the parity of x_P = X/Z (every lane inverts Z; the same
// verdict as encode-and-compare byte for byte).  The verdict is on every
// lane; the caller ANDs A's decode verdict.
template <class X, class D, class E>
FE_DEV bool comb_verify4(X &x, D digit, E a_entry,
                         const int32_t *__restrict__ base,
                         const uint32_t r[8]) {
  const int t = x.lane();
  fe p, a;
#pragma unroll
  for (int i = 0; i < 10; i++) p[i] = (i == 0 && (t == 1 || t == 2));
#pragma unroll 1
  for (int win = 0; win < COMB_WINDOWS; win++) {
#pragma unroll 1
    for (int h = 0; h < 2; h++) {
      int dg = digit(win, h);
      int j = dg < 0 ? -dg : dg;
      j = j > 8 ? 8 : j;
      if (h == 0)
        niels_coord(a, t, base + 30 * (COMB_DIGITS * win + j), dg < 0);
      else
        cached_coord(a, t, a_entry(win, j), dg < 0);
      add4(x, p, a);
    }
  }
  fe z, rr;
#pragma unroll
  for (int i = 0; i < 10; i++) z[i] = x.get(p[i], 2);
  fe_invert(z, z);
  fe_mul(a, p, z);                   // lane 0: x_P, lane 1: y_P
  fe_frombytes(rr, r);
  bool ok0 = fe_isneg(a) == (bool)((r[7] >> 31) & 1);
  bool ok1 = fe_bytes_canonical(r) && fe_eq(a, rr);
  int32_t bit = (t == 0 ? ok0 : ok1) ? 1 : 0;
  return (x.get(bit, 0) & x.get(bit, 1)) != 0;
}
