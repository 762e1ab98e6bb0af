// K4's per-thread chain: the point decompression of the RLC table
// (csrc/msm.cu k_decompress_niels, one point a thread).
//
// Replaces tendermint_tpu/ops/pallas_msm.py:106 decompress_niels_pallas
// (body _kernel_decompress_niels :57): a compressed point -> the niels row
// of the NEGATED point (y - x, y + x, -2dxy) and the decode verdict, with
// Go fe.SetBytes semantics (a non-canonical y accepted and reduced; a
// non-square, and x = 0 with the sign bit, rejected).
//
// What bounds it on the H100: integer multiply-adds.  The square root
// (u v^7)^((p-5)/8) is 251 squares and 11 multiplies in one dependent
// chain; with the rest of the decode 255 squares and 21 multiplies a
// point (the yardstick, cuda_msm.bound_ms_decompress).  153 bytes in and
// out a point: 40 MB at 262,144 points, 12 us of the card's memory rate.
// No operand is shared between points, so tensor cores and TMA have no
// work here.
//
// What held the first design (one thread a point on fe_sq, fe_mul and
// ge_decode of fe25519.cuh) back, and what this one does about it.
//   1. Every field op ended in fe_carry_wide: 12 dependent 64-bit
//      rounding carries, after ten 64-bit multiplies of the wrapped
//      columns by 19; a square of the chain was a 397-instruction loop
//      body.  Here the chain has its own square and multiply: the 19 (and
//      the 2 of odd-odd and cross products) is folded into 32-bit operands
//      before the products, as ref10 does, and each column starts at
//      U_k / 2, so the carry is two rounds of ten INDEPENDENT rounding
//      carries (fe_carry2), a dependent depth of 2 carries where it was
//      12.  A square is now 165 instructions (55 of them IMAD.WIDE).
//   2. 168 registers, 3 blocks of 128 threads an SM: 12 warps, 3 a
//      scheduler.  The kernel is now held to 128 registers (its spill
//      sits outside the square's loop body), so 16 warps fit an SM.  Computing u and v again after the power, or y and u v^3
//      too, cut the spill but added more work than it saved; two points
//      a thread with their chains interleaved spilled at 255 registers
//      and was slower; both were measured and dropped.
//   3. A tail wave: 2,048 blocks over 396 resident slots (the last wave
//      17% full), and small batches on few SMs (8,192 points in 64 blocks
//      on 64 of the 132 SMs).  Blocks are now one warp: at 262,144 points
//      8,192 warps fill 2,112 slots as they free, and 8,192 points reach
//      every SM.  A grid of only the resident blocks striding over the
//      points was slower, probably because its warps run the chain in
//      step (all in their squares, or all in their epilogues, at once).
// The rows it stores are carried by the existing full chain (fe_carry,
// fe_mul), as K5's ge_madd_niels needs (fe25519.cuh, "The MSM chains").
//
// ---------------------------------------------------------------------------
// Carry bounds of fe_sq2 / fe_mul2 (the fe25519.cuh argument, extended)
// ---------------------------------------------------------------------------
// CONTRACT: the operand that carries the folded 19 (g of fe_mul2, f of
// fe_sq2) is G-bounded with G <= 32/19 = 1.68, so that 19 g_j (38 g_j for
// an odd limb of a square) stays below 2^31 in an int32; f of fe_mul2 is
// at most 16-bounded (2 f_i of an odd limb below 2^31); and F * G <= 16
// as for fe_mul.  Every product is then an exact 32x32 -> 64 multiply-add
// and a column h_k is the fe_mul column, |h_k| <= 2^58.96 F G <= 2^62.96.
// Column k starts at U_k / 2, so s_k = h_k + U_k / 2 fits an int64.
//   round 1 (ten at once): c_k = s_k >> u_k (floor), m_k = s_k mod 2^u_k
//     in [0, U_k): |c_k| <= 2^37.96 + 1.
//   round 2 (ten at once): s'_k = m_k + c_{k-1} (s'_0 = m_0 + 19 c_9,
//     below 2^42.3), c'_k = s'_k >> u_k, m'_k = s'_k mod 2^u_k; the output
//     limb is m'_k - U_k / 2 + c'_{k-1} (limb 0: + 19 c'_9).
//   Each round is a rounding carry of the limbs the round before left
//   (r_k = m_k - U_k / 2 in [-U_k/2, U_k/2) plus the carry in), so the
//   value is unchanged mod p.  |c'_0| <= 2^16.21 + 1, |c'_k| <= 2^12.97 + 1
//   for k >= 1 (c'_9 <= 2^11.96 + 1), so an output limb exceeds U_k / 2
//   by at most 2^16.21 (limb 1), 19 (2^11.96 + 1) (limb 0) or 2^12.97:
//     every fe_sq2 / fe_mul2 output is 0.503-bounded;
//   on the chain's operands, which are such outputs (or u = y^2 - 1,
//   v = d y^2 + 1, -x, the canonical constants d and sqrt(-1)), at most
//   0.5005-bounded, F G <= 0.2505, |h_k| <= 2^56.96, |c'_0| <= 2^10.2:
//     every output inside the chain is 0.5001-bounded (carried, 0.501),
// so the chain never leaves the bound of the existing field ops, far
// inside G <= 1.68 and F G <= 16.  The stored rows: y - x and y + x
// through fe_carry, -2dxy = fe_mul(-xy, 2d): carried, so at most
// 1-bounded as K5 requires.  fe_eq, fe_iszero and fe_isneg freeze their
// (at most 1.002-bounded) arguments exactly.  tests/test_torch_k4.py runs
// this file on the host, at the limb extremes of the contract too.
#pragma once

#include "fe25519.cuh"

#define FE2_U(k) (((k) & 1) ? 25 : 26)
#define FE2_HALF(k) ((int64_t)1 << (FE2_U(k) - 1))

// two rounds of ten independent rounding carries: columns s_k = h_k +
// U_k / 2 (|h_k| <= 2^62.96) -> 0.503-bounded limbs
FE_DEV void fe_carry2(fe out, const int64_t s[10]) {
  int64_t c[10];
  uint32_t m[10];
#pragma unroll
  for (int k = 0; k < 10; k++) {
    c[k] = s[k] >> FE2_U(k);
    m[k] = (uint32_t)s[k] & ((1u << FE2_U(k)) - 1);
  }
  int32_t c2[10], r2[10];
#pragma unroll
  for (int k = 0; k < 10; k++) {
    int64_t t = (int64_t)m[k] + (k ? c[k - 1] : 19 * c[9]);
    c2[k] = (int32_t)(t >> FE2_U(k));
    r2[k] = (int32_t)((uint32_t)t & ((1u << FE2_U(k)) - 1)) -
            (int32_t)FE2_HALF(k);
  }
#pragma unroll
  for (int k = 0; k < 10; k++) out[k] = r2[k] + (k ? c2[k - 1] : 19 * c2[9]);
}

// f * g.  CONTRACT: g at most 1.68-bounded, f at most 16-bounded,
// F * G <= 16 (header note)
FE_DEV void fe_mul2(fe out, const fe f, const fe g) {
  int32_t f2[10], g19[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f[i];
    g19[i] = 19 * g[i];
  }
  int64_t s[10];
#pragma unroll
  for (int k = 0; k < 10; k++) s[k] = FE2_HALF(k);
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f[i];
      int32_t b = i + j >= 10 ? g19[j] : g[j];
      s[(i + j) % 10] += (int64_t)a * b;
    }
  }
  fe_carry2(out, s);
}

// f^2, the columns of fe_mul2(f, f) with each cross product taken once.
// CONTRACT: f at most 1.68-bounded
FE_DEV void fe_sq2(fe out, const fe f) {
  int32_t d[10], r[10];   // 2 f_i; 19 f_i (even i), 38 f_i (odd i)
#pragma unroll
  for (int i = 0; i < 10; i++) {
    d[i] = 2 * f[i];
    r[i] = ((i & 1) ? 38 : 19) * f[i];
  }
  int64_t s[10];
#pragma unroll
  for (int k = 0; k < 10; k++) s[k] = FE2_HALF(k);
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      // coefficient (i != j ? 2 : 1) (i, j odd ? 2 : 1) (i + j >= 10 ? 19 : 1)
      const bool odd2 = (i & 1) && (j & 1), wrap = i + j >= 10;
      int32_t a, b;
      if (i == j) {
        a = (!wrap && (i & 1)) ? d[i] : f[i];
        b = wrap ? r[i] : f[i];
      } else if (!wrap) {
        a = d[i];
        b = odd2 ? d[j] : f[j];
      } else {
        a = (!(j & 1) || odd2) ? d[i] : f[i];
        b = r[j];
      }
      s[(i + j) % 10] += (int64_t)a * b;
    }
  }
  fe_carry2(out, s);
}

// f^(2^n) by n fe_sq2 (the loop body is one square)
FE_DEV void fe_sqn2(fe h, const fe f, int n) {
  fe_sq2(h, f);
#pragma unroll 1
  for (int i = 1; i < n; i++) fe_sq2(h, h);
}

// z^((p - 5) / 8) = z^(2^252 - 3): fe_chain_250 and fe_pow22523's ladder
FE_DEV void fe_pow22523_2(fe out, const fe z) {
  fe t0, t1, t2, t3;
  fe_sq2(t0, z);             // 2
  fe_sq2(t1, t0);
  fe_sq2(t1, t1);            // 8
  fe_mul2(t1, z, t1);        // 9
  fe_mul2(t0, t0, t1);       // 11
  fe_sq2(t0, t0);            // 22
  fe_mul2(t1, t1, t0);       // 2^5 - 1
  fe_sqn2(t2, t1, 5);
  fe_mul2(t1, t2, t1);       // 2^10 - 1
  fe_sqn2(t2, t1, 10);
  fe_mul2(t2, t2, t1);       // 2^20 - 1
  fe_sqn2(t3, t2, 20);
  fe_mul2(t2, t3, t2);       // 2^40 - 1
  fe_sqn2(t2, t2, 10);
  fe_mul2(t1, t2, t1);       // 2^50 - 1
  fe_sqn2(t2, t1, 50);
  fe_mul2(t2, t2, t1);       // 2^100 - 1
  fe_sqn2(t3, t2, 100);
  fe_mul2(t2, t3, t2);       // 2^200 - 1
  fe_sqn2(t2, t2, 50);
  fe_mul2(t1, t2, t1);       // 2^250 - 1
  fe_sq2(t1, t1);
  fe_sq2(t1, t1);            // 2^252 - 4
  fe_mul2(out, t1, z);       // 2^252 - 3
}

// The niels row of -P for the encoding w (8 LE words): row = (y - x,
// y + x, -2dxy), 30 carried limbs; returns the decode verdict of
// ge_decode (lenient: a non-canonical y is reduced).  ge_decode's steps
// on fe_sq2 / fe_mul2, with the sqrt(-1) factor taken by a select.
FE_DEV bool decompress_niels_row(int32_t row[30], const uint32_t w[8]) {
  const fe d = FE_D, d2 = FE_D2, sqrtm1 = FE_SQRTM1;
  const bool sign = (w[7] >> 31) & 1;
  fe y, u, v, t, x;
  fe_frombytes(y, w);
  fe_carry(y);
  fe_sq2(u, y);
  fe_mul2(v, u, d);
  u[0] -= 1;                 // u = y^2 - 1
  v[0] += 1;                 // v = d y^2 + 1
  fe_sq2(t, v);
  fe_mul2(t, t, v);          // v^3
  fe_mul2(x, u, t);          // u v^3
  fe_sq2(t, t);
  fe_mul2(t, t, v);          // v^7
  fe_mul2(t, t, u);          // u v^7
  fe_pow22523_2(t, t);       // (u v^7)^((p-5)/8)
  fe_mul2(x, x, t);          // x = u v^3 (u v^7)^((p-5)/8)
  fe_sq2(t, x);
  fe_mul2(t, t, v);          // v x^2
  fe nu;
  fe_neg(nu, u);
  const bool ok_plus = fe_eq(t, u), ok_minus = fe_eq(t, nu);
  fe_mul2(t, x, sqrtm1);
  fe_cmov(x, t, ok_minus);
  const bool ok = (ok_plus || ok_minus) && !(fe_iszero(x) && sign);
  fe_neg(t, x);              // -P: X = -x of the requested sign
  fe_cmov(t, x, fe_isneg(x) != sign);
  fe ypx, ymx;
  fe_add(ypx, y, t);         // y - x
  fe_carry(ypx);
  fe_sub(ymx, y, t);         // y + x
  fe_carry(ymx);
  fe_mul2(t, t, y);          // T = X y = -xy
  fe_mul(x, t, d2);          // -2dxy
#pragma unroll
  for (int i = 0; i < 10; i++) {
    row[i] = ypx[i];
    row[10 + i] = ymx[i];
    row[20 + i] = x[i];
  }
  return ok;
}
