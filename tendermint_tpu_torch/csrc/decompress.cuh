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
//      body.  Here the chain runs on the two-round-carry square and
//      multiply (csrc/fe25519_2.cuh): the 19 (and
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
// The square and multiply (fe_sq2, fe_mul2, their carry bounds) are in
// csrc/fe25519_2.cuh, shared with S2; the square root's power is
// fe25519.cuh's fe_pow22523 on them (Fe2Ops).  On the chain's operands,
// which are such outputs (or u = y^2 - 1, v = d y^2 + 1, -x, the
// canonical constants d and sqrt(-1)), every output inside the chain is
// carried (0.501), so the chain never leaves the bound of the existing
// field ops, far inside G <= 1.68 and F G <= 16.  The stored rows: y - x
// and y + x through fe_carry, -2dxy = fe_mul(-xy, 2d): carried, so at
// most 1-bounded as K5 requires.  fe_eq, fe_iszero and fe_isneg freeze
// their (at most 1.002-bounded) arguments exactly.  tests/test_torch_k4.py
// runs this file on the host, at the limb extremes of the contract too.
#pragma once

#include "fe25519.cuh"
#include "fe25519_2.cuh"

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
  fe_pow22523<Fe2Ops>(t, t); // (u v^7)^((p-5)/8)
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
