// The verify body of kernel S2 (csrc/sr25519_verify.cu): one schnorrkel
// (sr25519) signature on a group of four lanes, on S2's own field and
// group steps.  It keeps K1's group layout (verify4.cuh: lane t holds
// coordinate t of the point, the scratch layout V4_*, the table and digit
// helpers, LanePark) and K1's phases, and differs from verify4() in five
// things:
//   - the field is the two-round-carry pair fe_sq2 / fe_mul2
//     (csrc/fe25519_2.cuh), and the decode's power is fe25519.cuh's
//     fe_pow22523 on it (Fe2Ops), parked as K1 parks its own;
//   - a doubling or an addition fetches what its first round reads by
//     ONE exchange (10 shuffles, not 20): each lane names its own source;
//   - the second round fetches the other three lanes' round-1 outputs by
//     three exchanges (30 shuffles, not 40: a lane's own value is not
//     fetched), each lane from sources of its own, and forms its two
//     factors from them with per-lane coefficients, packed one byte a
//     lane in constants (a column that is the same on all four lanes is
//     a compile-time constant, so a zero costs nothing and a +-1 is an
//     add);
//   - s is read in signed radix-256 digits (32 additions of B, not 64),
//     from a niels table of the 129 multiples jB, j = 0..128 (15.5 KB,
//     canonical limbs) that stays in device memory and is read through
//     L1; k keeps K1's signed radix-16 digits against the table of -A;
//   - the decode is ristretto255's (RFC 9496 §4.3.1) and the check the
//     ristretto equality.
// The layouts are chosen so that each lane's factor that carries
// fe_mul2's folded 19 is at most 1.68-bounded (below) and as many
// coefficient columns as possible are uniform: with a lane's own value in
// slot 0 and the others in any order, the doubling needs 5 per-lane
// multiply-adds a limb and the addition 6 (of the 8 that per-lane
// coefficients on fixed slots need; every layout was searched).  A
// butterfly (partner exchange, then partial forms across the pairs) also
// moves 30 limbs a round but needs the same 8 multiply-adds a limb and a
// dependent second exchange.
//
// Doubling (dbl-2008-hwcd; T of the input is not read).  Round 1: lane t
// squares (X + Y, Z, X, Y)[t] = (S, C', A, B) with C' = Z^2 (lane 0 takes
// Y, lanes 1, 2, 3 take Z, X, Y).  Round 2, with E = S - A - B, F = B - A
// - 2 C', G = B - A, H = -A - B, lane t multiplies (L, R) = (E, -F),
// (H, -G), (-G, F), (H, -E): the four products -(E F, G H, F G, E H), the
// point scaled by -1, which is the same projective point.
// Addition (add-2008-hwcd-3, q this lane's coordinate of the cached point
// (Y2+X2, Y2-X2, Z2, 2d T2)).  Round 1: lane t multiplies (Y + X, Y - X,
// Z, T)[t] by q (lanes 0 and 1 take each other's coordinate).  Round 2,
// with A', B', Z', C the round-1 outputs, E = A' - B', F = 2 Z' - C, G =
// 2 Z' + C, H = A' + B': (L, R) = (E, F), (-G, -H), (-F, -G), (-E, -H).
//
// Carry bounds (fe25519_2.cuh: outputs 0.503-bounded; CONTRACT g <= 1.68,
// f <= 16, F G <= 16; fe_mul2(out, R, L) puts the 19 on L).  Every point
// coordinate, table entry of -A, decoded x, y and ratio value is an
// fe_mul2 / fe_sq2 output (0.503) or its negation; s is fe_carry'd
// (0.501); the table of B holds canonical limbs (1).
//   decode: s^2 (0.501); u1 = 1 - s^2, u2 = 1 + s^2 0.5031; u2^2, u1^2;
//     u1^2 d (d canonical); v = -(d u1^2) - u2^2 1.006; v u2^2 (L = u2^2);
//     the power and its ratio products on outputs; r u2, r den_x, (r
//     den_x) v (L = v, 1.006); u1 den_y; 2s den_x (2s 1.002, L = den_x);
//     x y: widest F G = 1.006 x 0.503.
//   table: Y + X, Y - X 1.006 times 1 or 2d (L); -x times y.
//   doubling: round 1 squares X + Y (1.006) or a coordinate; round 2 L =
//     E (1.509), H, -G (1.006), R = -F (2.012), -G, F, -E: widest E F =
//     3.04, every L <= 1.509.
//   addition: round 1 Y +- X (1.006) or Z, T (0.503) times q (L, at most
//     1); round 2 E, H 1.006, F, G 1.509 (2 Z' + C): widest F G = 2.28.
//   check: X_P or Y_P times x_R or y_R, 0.503 x 0.503.
// So every L is at most 1.509 < 1.68 and every F G at most 3.04, > 5x
// inside the contract.  fe_eq, fe_iszero, fe_isneg and fe_freeze take
// any 16-bounded value.  tests/test_torch_sr25519.py runs fe_sq2 /
// fe_mul2 at these operand bounds and the steps on coordinates at the
// 0.503 bound, on the host.
//
// A host program runs this body with four threads that meet at a barrier
// in place of the shuffles (tests/test_torch_sr25519.py does, against
// the JAX package): the exchange's get(v, src) reads lane src & 3.
//
// Counterpart of tendermint_tpu/ops/sr25519.py:44 _verify_core with
// ops/ristretto.py:46 decode and :72 eq (XLA functions, not Pallas).
#pragma once

#include "fe25519.cuh"
#include "fe25519_2.cuh"
#include "verify4.cuh"

// a per-lane table of four small signed values, one byte a lane
#define SR_LANES(a, b, c, d)                                      \
  ((uint32_t)(uint8_t)(a) | (uint32_t)(uint8_t)(b) << 8 |         \
   (uint32_t)(uint8_t)(c) << 16 | (uint32_t)(uint8_t)(d) << 24)

// lane t's entry of the table K; a compile-time constant when all four
// entries are equal
template <uint32_t K>
FE_DEV int32_t sr_lane(int t) {
  if constexpr ((K & 0xFF) * 0x01010101u == K) {
    return (int32_t)(int8_t)(K & 0xFF);
  } else {
    return (int32_t)(K << (24 - 8 * t)) >> 24;
  }
}

// Round 2 of a doubling or an addition: m is this lane's round-1 output;
// slot 0 is m, slots 1-3 the outputs of lanes S1, S2, S3 (this lane's
// entries); the lane multiplies R = sum_k RK m_k by L = sum_k LK m_k,
// L on fe_mul2's folded side.
template <class Sch, class X>
FE_DEV void sr_round2(X &x, fe p, const fe m) {
  const int t = x.lane();
  const int s1 = sr_lane<Sch::S1>(t), s2 = sr_lane<Sch::S2>(t),
            s3 = sr_lane<Sch::S3>(t);
  const int32_t l0 = sr_lane<Sch::L0>(t), l1 = sr_lane<Sch::L1>(t),
                l2 = sr_lane<Sch::L2>(t), l3 = sr_lane<Sch::L3>(t);
  const int32_t r0 = sr_lane<Sch::R0>(t), r1 = sr_lane<Sch::R1>(t),
                r2 = sr_lane<Sch::R2>(t), r3 = sr_lane<Sch::R3>(t);
  fe l, r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int32_t v0 = m[i], v1 = x.get(m[i], s1), v2 = x.get(m[i], s2),
            v3 = x.get(m[i], s3);
    l[i] = l0 * v0 + l1 * v1 + l2 * v2 + l3 * v3;
    r[i] = r0 * v0 + r1 * v1 + r2 * v2 + r3 * v3;
  }
  fe_mul2(p, r, l);
}

// the doubling's round 2 on (S, C', A, B) (header note)
struct SrDblRound2 {
  static constexpr uint32_t S1 = SR_LANES(1, 0, 1, 0);
  static constexpr uint32_t S2 = SR_LANES(2, 2, 3, 2);
  static constexpr uint32_t S3 = SR_LANES(3, 3, 0, 1);
  static constexpr uint32_t L0 = SR_LANES(1, 0, 1, -1);
  static constexpr uint32_t L1 = SR_LANES(0, 0, 0, 0);
  static constexpr uint32_t L2 = SR_LANES(-1, -1, -1, -1);
  static constexpr uint32_t L3 = SR_LANES(-1, -1, 0, 0);
  static constexpr uint32_t R0 = SR_LANES(0, 0, -1, 1);
  static constexpr uint32_t R1 = SR_LANES(2, 0, -2, -1);
  static constexpr uint32_t R2 = SR_LANES(1, 1, 1, 1);
  static constexpr uint32_t R3 = SR_LANES(-1, -1, 0, 0);
};

// the addition's round 2 on (A', B', Z', C) (header note)
struct SrAddRound2 {
  static constexpr uint32_t S1 = SR_LANES(1, 2, 1, 2);
  static constexpr uint32_t S2 = SR_LANES(2, 3, 0, 1);
  static constexpr uint32_t S3 = SR_LANES(3, 0, 3, 0);
  static constexpr uint32_t L0 = SR_LANES(1, 0, -2, 0);
  static constexpr uint32_t L1 = SR_LANES(-1, -2, 0, 0);
  static constexpr uint32_t L2 = SR_LANES(0, -1, 0, 1);
  static constexpr uint32_t L3 = SR_LANES(0, 0, 1, -1);
  static constexpr uint32_t R0 = SR_LANES(0, -1, -2, 0);
  static constexpr uint32_t R1 = SR_LANES(0, 0, 0, 0);
  static constexpr uint32_t R2 = SR_LANES(2, 0, 0, -1);
  static constexpr uint32_t R3 = SR_LANES(-1, -1, -1, -1);
};

// p = 2 p (up to the factor -1, header note); T of p is not read
template <class X>
FE_DEV void sr_dbl(X &x, fe p) {
  const int t = x.lane();
  const int src = sr_lane<SR_LANES(1, 2, 0, 1)>(t);
  const int32_t own = sr_lane<SR_LANES(1, 0, 0, 0)>(t);
  fe s;
#pragma unroll
  for (int i = 0; i < 10; i++) s[i] = x.get(p[i], src) + own * p[i];
  fe_sq2(s, s);     // round 1: (S, C', A, B)
  sr_round2<SrDblRound2>(x, p, s);
}

// p = p + q; q is this lane's coordinate of the cached point (Y2+X2,
// Y2-X2, Z2, 2d T2), see cached_coord / niels_coord
template <class X>
FE_DEV void sr_add(X &x, fe p, const fe q) {
  const int t = x.lane();
  const int32_t c = sr_lane<SR_LANES(1, -1, 0, 0)>(t);
  fe s;
#pragma unroll
  for (int i = 0; i < 10; i++) s[i] = p[i] + c * x.get(p[i], t ^ 1);
  fe_mul2(s, s, q);  // round 1: (A', B', Z Z2, C)
  sr_round2<SrAddRound2>(x, p, s);
}

// c = this lane's coordinate of the cached form (Y+X, Y-X, Z, 2dT) of p,
// as one multiply on every lane (by 1 on lanes 0-2, by 2d on lane 3)
template <class X>
FE_DEV void sr_to_cached(X &x, fe c, const fe p) {
  const int t = x.lane();
  const int32_t cx = sr_lane<SR_LANES(1, -1, 0, 0)>(t);
  const fe d2 = FE_D2;
  fe k;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    c[i] = p[i] + cx * x.get(p[i], t ^ 1);
    k[i] = t == 3 ? d2[i] : (i == 0);
  }
  fe_mul2(c, c, k);
}

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
    fe_sq2(ss, s);
    fe_neg(u1, ss);
    u1[0] += 1;
    fe_copy(u2, ss);
    u2[0] += 1;
    fe_sq2(u2s, u2);
    fe_sq2(t, u1);
    fe_mul2(t, t, d);
    fe_add(v, t, u2s);
    fe_neg(v, v);
    fe_mul2(vv, v, u2s);
    fe_sq2(v3, vv);
    fe_mul2(v3, v3, vv);
  };
  prep();
  fe r;
  fe_sq2(t, v3);
  fe_mul2(t, t, vv);           // vv^7
  if constexpr (PARK) {
    fe_park(pk.park(), s);
    fe_pow22523<Fe2Ops>(r, t, pk, 80);  // (vv^7)^((p-5)/8)
    fe_unpark(s, pk.park());
    prep();
  } else {
    fe_pow22523<Fe2Ops>(r, t);
  }
  fe_mul2(r, v3, r);           // r = vv^3 (vv^7)^((p-5)/8)
  fe_sq2(t, r);
  fe_mul2(t, t, vv);           // check = vv r^2
  fe one, m1, mi;
  fe_1(one);
  fe_neg(m1, one);
  fe_neg(mi, sqrtm1);
  bool correct = fe_eq(t, one);
  bool flipped = fe_eq(t, m1);
  bool flipped_i = fe_eq(t, mi);
  fe_mul2(t, r, sqrtm1);
  fe_cmov(r, t, flipped || flipped_i);
  fe_neg(t, r);
  fe_cmov(r, t, fe_isneg(r));  // CT_ABS
  bool was_square = correct || flipped;
  fe den_x;
  fe_mul2(den_x, r, u2);
  fe_mul2(t, r, den_x);
  fe_mul2(t, t, v);            // den_y
  fe_mul2(y, u1, t);
  fe_add(s, s, s);
  fe_mul2(x, s, den_x);
  fe_neg(t, x);
  fe_cmov(x, t, fe_isneg(x));  // CT_ABS
  fe_mul2(t, x, y);
  return was_square && !fe_isneg(t) && !fe_iszero(y);
}

// t = s + 0x80..80 (32 bytes of 0x80); digit j = byte_j(t) - 128 in
// [-128, 127] (s < L < 2^253, so no carry leaves the top byte)
FE_DEV void digit_bytes(uint32_t t[8], const uint32_t s[8]) {
  uint64_t carry = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) {
    uint64_t v = (uint64_t)s[q] + 0x80808080u + carry;
    t[q] = (uint32_t)v;
    carry = v >> 32;
  }
}

// The verdict of one sr25519 signature, on every lane of its group
// (verify4's contract for x, enc and scalars; base is the niels table
// jB, j = 0..128, 129 x 3 x 10 limbs).  Lane 1 decodes R,
// lanes 0, 2 and 3 decode A; the group computes P = [s]B + [k](-A) with
// verify4's table layout and ladder on sr_dbl / sr_add and accepts iff A
// and R decode and P equals R as ristretto points: X_P y_R = Y_P x_R or
// Y_P y_R = X_P x_R (RFC 9496 §4.5 on projective P; Z_P cancels, and so
// does the factor -1 of a doubling).  Lane 0 forms X_P y_R, lane 1
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
    digit_bytes(ts, ts);
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
  fe_mul2(p, a, b);
#pragma unroll
  for (int i = 0; i < 10; i++)
    p[i] = t == 0 ? a[i] : t == 1 ? b[i] : t == 2 ? (i == 0) : p[i];

  // phase 2: tab[j] = j(-A), j = 0..8; lane t writes coordinate t
  int32_t *own = tab + 10 * t;
#pragma unroll
  for (int i = 0; i < 10; i++) own[i] = (t < 3 && i == 0) ? 1 : 0;
#pragma unroll 1
  for (int j = 1; j <= 8; j++) {
    sr_to_cached(x, a, p);
#pragma unroll
    for (int i = 0; i < 10; i++) own[V4_ENTRY * j + i] = a[i];
    if (j < 8) {
      cached_coord(a, t, tab + V4_ENTRY, false);
      sr_add(x, p, a);
    }
  }
  x.sync();

  // phase 3: the joint ladder [s]B + [k](-A), four doublings a nibble
#pragma unroll
  for (int i = 0; i < 10; i++) p[i] = (i == 0 && (t == 1 || t == 2));
#pragma unroll 1
  for (int pos = 63; pos >= 0; pos--) {
#pragma unroll 1
    for (int i = 0; i < 4; i++) sr_dbl(x, p);
    tab = x.scratch();
    const uint32_t *dw = (const uint32_t *)(tab + V4_DIGITS);
    // s's signed byte at an even position (radix 256), k's nibble at
    // every position (radix 16)
#pragma unroll 1
    for (int h = pos & 1; h < 2; h++) {
      int dg = h == 0
          ? (int)((dw[pos >> 3] >> ((pos & 6) * 4)) & 255) - 128
          : (int)((dw[8 + (pos >> 3)] >> ((pos & 7) * 4)) & 15) - 8;
      int j = dg < 0 ? -dg : dg;
      if (h == 0)
        niels_coord(a, t, base + 30 * j, dg < 0);
      else
        cached_coord(a, t, tab + V4_ENTRY * j, dg < 0);
      sr_add(x, p, a);
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
  fe_mul2(a, a, b);
  fe_freeze(b, a);
  int32_t diff = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) diff |= x.get(b[i], t ^ 1) ^ b[i];
  int32_t same = diff == 0 ? 1 : 0, good = ok ? 1 : 0;
  int32_t g0 = x.get(good, 0), g1 = x.get(good, 1);
  int32_t e0 = x.get(same, 0), e2 = x.get(same, 2);
  return (g0 & g1 & (e0 | e2)) != 0;
}
