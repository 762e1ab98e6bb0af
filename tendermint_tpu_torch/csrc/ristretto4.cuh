// The verify body of kernel S2 (csrc/sr25519_verify.cu): one schnorrkel
// (sr25519) signature on a group of four lanes, over the four-lane
// primitives of verify4.cuh (dbl4, add4, to_cached4, niels_coord,
// cached_coord, digit_words) and the field of fe25519.cuh.  Written as its
// own template beside verify4(), which it leaves untouched: only the
// decode (ristretto255 instead of RFC 8032) and the final check
// (ristretto equality instead of the affine compare) differ.  A host
// program runs the same body with four threads that meet at a barrier
// (tests/test_torch_sr25519.py does, against the JAX package).
//
// Counterpart of tendermint_tpu/ops/sr25519.py:44 _verify_core with
// ops/ristretto.py:46 decode and :72 eq (XLA functions, not Pallas).
//
// Carry bounds (the fe25519.cuh contract, F * G <= 16).  The decode's
// operands: s carried (0.501), 2s 1.002; u1 = 1 - s^2 and u2 = 1 + s^2 at
// most 0.502 + 1 limb unit; v = -(d u1^2) - u2^2 1.002; every other
// operand is a multiply output (carried) or a negation of one.  Widest
// product: 2s x den_x = 1.002 x 0.501.  The ladder is verify4's, with the
// same table and the same bounds; the check multiplies a ladder
// coordinate (carried) by x_R or y_R (carried).
#pragma once

#include "fe25519.cuh"
#include "verify4.cuh"

// RFC 9496 §4.3.1 decode of the encoding in w (8 LE words) to (x, y) with
// Z = 1 (T = x y is formed by the caller); returns the decode verdict:
// SQRT_RATIO_M1(1, v u2^2) square, t = x y nonnegative, y != 0.  The value
// decoded is the 256-bit encoding mod p (bit 255 counts 2^255 = 19), as the
// plain version reads it; that the encoding is canonical (below p) and
// even is screened on the host.
//
// Parking (the verify kernels): s waits out the square-root power at
// park() + 0 and the power's own values at + 80 and + 120 (fe_pow22523),
// so that none holds a register; u1, u2, v and the ratio's v u2^2 and its
// cube are computed again from s after the power.
template <class Park = NoPark>
FE_DEV bool rist_decode(fe x, fe y, const uint32_t w[8], Park pk = Park()) {
  constexpr bool PARK = Park::parks;
  const fe d = FE_D, sqrtm1 = FE_SQRTM1;
  fe s, u1, u2, v, vv, v3, t;
  fe_frombytes(s, w);
  s[0] += 19 * (int32_t)(w[7] >> 31);
  fe_carry(s);
  // u1 = 1 - s^2, u2 = 1 + s^2, v = -(d u1^2) - u2^2, vv = v u2^2,
  // v3 = vv^3 (the ratio's u = 1)
  auto prep = [&]() {
    fe ss, u2s;
    fe_sq(ss, s);
    fe_neg(u1, ss);
    u1[0] += 1;
    fe_copy(u2, ss);
    u2[0] += 1;
    fe_sq(u2s, u2);
    fe_sq(t, u1);
    fe_mul(t, t, d);
    fe_add(v, t, u2s);
    fe_neg(v, v);
    fe_mul(vv, v, u2s);
    fe_sq(v3, vv);
    fe_mul(v3, v3, vv);
  };
  prep();
  fe r;
  fe_sq(t, v3);
  fe_mul(t, t, vv);            // vv^7
  if constexpr (PARK) {
    fe_park(pk.park(), s);
    fe_pow22523(r, t, pk, 80);  // (vv^7)^((p-5)/8)
    fe_unpark(s, pk.park());
    prep();
  } else {
    fe_pow22523(r, t);
  }
  fe_mul(r, v3, r);            // r = vv^3 (vv^7)^((p-5)/8)
  fe_sq(t, r);
  fe_mul(t, t, vv);            // check = vv r^2
  fe one, m1, mi;
  fe_1(one);
  fe_neg(m1, one);
  fe_neg(mi, sqrtm1);
  bool correct = fe_eq(t, one);
  bool flipped = fe_eq(t, m1);
  bool flipped_i = fe_eq(t, mi);
  fe_mul(t, r, sqrtm1);
  fe_cmov(r, t, flipped || flipped_i);
  fe_neg(t, r);
  fe_cmov(r, t, fe_isneg(r));  // CT_ABS
  bool was_square = correct || flipped;
  fe den_x;
  fe_mul(den_x, r, u2);
  fe_mul(t, r, den_x);
  fe_mul(t, t, v);             // den_y
  fe_mul(y, u1, t);
  fe_add(s, s, s);
  fe_mul(x, s, den_x);
  fe_neg(t, x);
  fe_cmov(x, t, fe_isneg(x));  // CT_ABS
  fe_mul(t, x, y);
  return was_square && !fe_isneg(t) && !fe_iszero(y);
}

// The verdict of one sr25519 signature, on every lane of its group
// (verify4's contract for x, enc, scalars and base).  Lane 1 decodes R,
// lanes 0, 2 and 3 decode A; the group computes P = [s]B + [k](-A) with
// verify4's table and ladder and accepts iff A and R decode and P equals R
// as ristretto points: X_P y_R = Y_P x_R or Y_P y_R = X_P x_R (RFC 9496
// §4.5 on projective P; Z_P cancels).  Lane 0 forms X_P y_R, lane 1
// Y_P x_R, lane 2 Y_P y_R, lane 3 X_P x_R, and lanes 0 and 2 compare with
// their neighbours' canonical values.
template <class X, class S, class N>
FE_DEV bool verify_sr4(X &x, N enc, S scalars, const int32_t *base) {
  int32_t *tab;
  // phase 0: the digit words of s and k, to the scratch
  {
    const int t = x.lane();
    tab = x.scratch();
    uint32_t ts[8], tk[8];
    scalars(ts, tk);
    digit_words(ts, ts);
    digit_words(tk, tk);
    uint32_t *dw = (uint32_t *)(tab + V4_DIGITS);
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < 8; q++) dw[q] = ts[q];
    }
    if (t == 1) {
#pragma unroll
      for (int q = 0; q < 8; q++) dw[8 + q] = tk[q];
    }
  }

  // phase 1: lane 1 decodes R, the others A (ristretto255)
  fe p, rc;  // x and y, then R's coordinate of this lane
  bool ok;
  {
    uint32_t w[8];
    enc(w);
    ok = rist_decode(p, rc, w, LanePark<X>{x});
  }
  // -A = (-x, y, 1, -x y) on lane t's coordinate; x_R on lane 0 and y_R
  // on lane 1, kept for the final check
  const int t = x.lane();
  fe a, b;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int32_t xr = x.get(p[i], 1), yr = x.get(rc[i], 1);
    a[i] = -x.get(p[i], 0);
    b[i] = x.get(rc[i], 0);
    rc[i] = t == 0 ? xr : yr;
  }
  tab = x.scratch();
  if (t < 2) {
#pragma unroll
    for (int i = 0; i < 10; i++) tab[V4_RC + 10 * t + i] = rc[i];
  }
  fe_mul(p, a, b);
#pragma unroll
  for (int i = 0; i < 10; i++)
    p[i] = t == 0 ? a[i] : t == 1 ? b[i] : t == 2 ? (i == 0) : p[i];

  // phase 2: tab[j] = j(-A), j = 0..8; lane t writes coordinate t
  int32_t *own = tab + 10 * t;
#pragma unroll
  for (int i = 0; i < 10; i++) own[i] = (t < 3 && i == 0) ? 1 : 0;
#pragma unroll 1
  for (int j = 1; j <= 8; j++) {
    to_cached4(x, a, p);
#pragma unroll
    for (int i = 0; i < 10; i++) own[V4_ENTRY * j + i] = a[i];
    if (j < 8) {
      cached_coord(a, t, tab + V4_ENTRY, false);
      add4(x, p, a);
    }
  }
  x.sync();

  // phase 3: the joint signed-radix-16 ladder [s]B + [k](-A)
#pragma unroll
  for (int i = 0; i < 10; i++) p[i] = (i == 0 && (t == 1 || t == 2));
#pragma unroll 1
  for (int pos = 63; pos >= 0; pos--) {
#pragma unroll 1
    for (int i = 0; i < 4; i++) dbl4(x, p);
    tab = x.scratch();
    const uint32_t *dw = (const uint32_t *)(tab + V4_DIGITS);
#pragma unroll 1
    for (int h = 0; h < 2; h++) {
      int dg = (int)((dw[8 * h + (pos >> 3)] >> ((pos & 7) * 4)) & 15) - 8;
      int j = dg < 0 ? -dg : dg;
      if (h == 0)
        niels_coord(a, t, base + 30 * j, dg < 0);
      else
        cached_coord(a, t, tab + V4_ENTRY * j, dg < 0);
      add4(x, p, a);
    }
  }

  // phase 4: ristretto equality of P with R
  tab = x.scratch();
  const int src = (t == 0 || t == 3) ? 0 : 1;       // X_P or Y_P
#pragma unroll
  for (int i = 0; i < 10; i++) {
    a[i] = x.get(p[i], src);
    b[i] = tab[V4_RC + 10 * ((t & 1) ^ 1) + i];     // y_R or x_R
  }
  fe_mul(a, a, b);
  fe_freeze(b, a);
  int32_t diff = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) diff |= x.get(b[i], t ^ 1) ^ b[i];
  int32_t same = diff == 0 ? 1 : 0, good = ok ? 1 : 0;
  int32_t g0 = x.get(good, 0), g1 = x.get(good, 1);
  int32_t e0 = x.get(same, 0), e2 = x.get(same, 2);
  return (g0 & g1 & (e0 | e2)) != 0;
}
