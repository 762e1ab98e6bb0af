// The two-round-carry field of GF(2^255 - 19): fe_sq2 and fe_mul2 on the
// ten-limb elements of fe25519.cuh, with a carry of two rounds of ten
// INDEPENDENT rounding carries (fe_carry2) where fe_carry_wide runs 12
// dependent ones.  The 19 (and the 2 of odd-odd and cross products) is
// folded into 32-bit operands before the products, as ref10 does, and
// each column starts at U_k / 2.  A square is 164 instructions (55 of
// them IMAD.WIDE), a multiply 211, against fe_sq's 221 and fe_mul's 261
// (tools/kernel_report.py).  Used by K4's chain (csrc/decompress.cuh) and
// by S2 (csrc/ristretto4.cuh); Fe2Ops runs the power chain of fe25519.cuh
// on them.
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
//   on operands that are such outputs (or u = y^2 - 1, v = d y^2 + 1,
//   -x, the canonical constants d and sqrt(-1)), at most 0.5005-bounded,
//   F G <= 0.2505, |h_k| <= 2^56.96, |c'_0| <= 2^10.2: every output
//   inside a power chain is 0.5001-bounded (carried, 0.501).
// tests/test_torch_k4.py and tests/test_torch_sr25519.py run these on the
// host at the limb extremes of the contract and at the operand bounds of
// every S2 product.
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

// The power chains of fe25519.cuh (fe_chain_250, fe_pow22523) on this
// square and multiply: every operand there is a chain output, so the
// contract holds with the bounds above.
struct Fe2Ops {
  static FE_MEMBER void sq(fe h, const fe f) { fe_sq2(h, f); }
  static FE_MEMBER void mul(fe h, const fe f, const fe g) { fe_mul2(h, f, g); }
};
