// The verify body shared by K1, K2 and K3 (csrc/ed25519_verify.cu): one
// signature on a group of four lanes, written once as templates over the
// group's exchange primitive.  On the card the primitive is __shfl_sync
// within the 4-lane group (ShflXch in ed25519_verify.cu); a host program
// can run the same body with four threads that meet at a barrier
// (tests/test_torch_verify4.py does, against the JAX package).
//
// Group concept, for a class X:
//   int lane()                       this lane's index t in the group
//   int32_t get(int32_t v, int src)  v as held by lane src
//   void sync()                      order the group's shared-memory
//                                    writes before its later reads
//   int32_t *scratch()               the group's V4_SIG_WORDS words of
//                                    scratch (shared memory on the card;
//                                    asked for again in each phase)
// Every lane of a group calls each of them, in the same order, the same
// number of times.  Lanes never branch on t: every per-lane choice is a
// select or a per-lane coefficient, so the four lanes run one instruction
// stream.  Values move one limb at a time and are consumed as they
// arrive, so no lane holds its neighbours' whole elements: that keeps a
// thread within 128 registers.
//
// The point (X : Y : Z : T) is spread over the group: lane t holds
// coordinate t.  The formulas are those of ge_dbl, ge_add_cached and
// ge_madd_niels (fe25519.cuh), in the 4-way parallel schedule of Hisil,
// Wong, Carter and Dawson, "Twisted Edwards Curves Revisited" (ASIACRYPT
// 2008) §4, as curve25519-dalek's AVX2 backend lays them out over SIMD
// lanes:
//   doubling  round 1  lane t squares (X, Y, Z, X+Y)[t]
//             round 2  lane t multiplies (E F, G H, F G, E H)[t]
//   addition  round 1  lane t multiplies (Y+X, Y-X, Z, T)[t] by
//                      (Y2+X2, Y2-X2, Z2, 2d T2)[t]   (Z2 = 1 for niels)
//             round 2  as the doubling's round 2 on (E, F, G, H)
// Before each round the group exchanges what the round reads: X and Y
// before round 1, all four round-1 outputs before round 2.
//
// Carry bounds, round by round (the fe25519.cuh contract, F * G <= 16):
// every lane's coordinate is a multiply output (carried, 0.501-bounded).
//   doubling  round 1: X + Y is 1.002, its square 1.002^2; the others
//             square carried values.  Round 2: E = S - A - B 1.503,
//             G = B - A 1.002, F = G - 2 Z^2 2.004, H = -A - B 1.002:
//             widest E F = 3.02.
//   addition  round 1: Y +- X 1.002 times a table coordinate that is a
//             multiply output (the -A table) or canonical (the B table):
//             at most 1.002 x 1; Z x Z2 and T x 2dT2 carried x carried.
//             Round 2: E = A - B 1.002, F = D - C 1.503, G = D + C
//             1.503, H = A + B 1.002 with D = 2 Z Z2 1.002: widest F G
//             = 2.26.
// Every operand is the same sum of carried values as in the one-lane
// formulas, so the margin to the contract is the same (> 5x).
#pragma once

#include "fe25519.cuh"

// A group's scratch (shared memory on the card), in 32-bit words: the
// cached multiples j(-A), j = 0..8, entry by entry, coordinate by
// coordinate; the digit words of s and of k; x_R (lane 0's) and y_R
// (lane 1's) for the final check; one word of padding, so that the
// groups of a warp start on different banks.  Kept here, not in
// registers, so that a thread fits in 128 registers through the ladder.
#define V4_ENTRY 40                      // a cached entry: 4 coords x 10
#define V4_DIGITS (9 * V4_ENTRY)         // 8 words of s, then 8 of k
#define V4_RC (V4_DIGITS + 16)           // 10 limbs for lane 0, 1
#define V4_SIG_WORDS (V4_RC + 20 + 1)

// Round 2 of both formulas.  m is this lane's round-1 output; lane t
// multiplies L = sum_j cl[j] m_j by R = sum_j cr[j] m_j, where m_j is lane
// j's output and (cl, cr) select lane t's factors of (E F, G H, F G, E H).
template <class X>
FE_DEV void round2_4(X &x, fe p, const fe m, const int cl[4],
                     const int cr[4]) {
  fe l, r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int32_t v0 = x.get(m[i], 0), v1 = x.get(m[i], 1);
    int32_t v2 = x.get(m[i], 2), v3 = x.get(m[i], 3);
    l[i] = cl[0] * v0 + cl[1] * v1 + cl[2] * v2 + cl[3] * v3;
    r[i] = cr[0] * v0 + cr[1] * v1 + cr[2] * v2 + cr[3] * v3;
  }
  fe_mul(p, l, r);
}

// p = 2 p (dbl-2008-hwcd; T of the input is not read)
template <class X>
FE_DEV void dbl4(X &x, fe p) {
  const int t = x.lane();
  fe s;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int32_t xi = x.get(p[i], 0), yi = x.get(p[i], 1);
    s[i] = t == 3 ? xi + yi : p[i];
  }
  fe_sq(s, s);      // round 1: (A, B, Z^2, S) = (X^2, Y^2, Z^2, (X + Y)^2)
  // E = S - A - B, F = B - A - 2 Z^2, G = B - A, H = -A - B
  const int cl[4] = {-1, t == 0 || t == 3 ? -1 : 1, t == 2 ? -2 : 0,
                     t == 0 || t == 3 ? 1 : 0};
  const int cr[4] = {-1, t == 0 || t == 2 ? 1 : -1, t == 0 ? -2 : 0, 0};
  round2_4(x, p, s, cl, cr);
}

// p = p + q (add-2008-hwcd-3); q is this lane's coordinate of the cached
// point (Y2+X2, Y2-X2, Z2, 2d T2), see cached_coord / niels_coord
template <class X>
FE_DEV void add4(X &x, fe p, const fe q) {
  const int t = x.lane();
  fe s;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int32_t xi = x.get(p[i], 0), yi = x.get(p[i], 1);
    s[i] = t == 0 ? yi + xi : t == 1 ? yi - xi : p[i];
  }
  fe_mul(s, s, q);  // round 1: (A, B, Z Z2, C)
  // D = 2 Z Z2; E = A - B, F = D - C, G = D + C, H = A + B
  const int cl[4] = {t == 0 || t == 3 ? 1 : 0, t == 0 || t == 3 ? -1 : 0,
                     t == 0 || t == 3 ? 0 : 2, t == 1 ? 1 : t == 2 ? -1 : 0};
  const int cr[4] = {t & 1, t & 1, t & 1 ? 0 : 2, t == 0 ? -1 : t == 2 ? 1 : 0};
  round2_4(x, p, s, cl, cr);
}

// c = this lane's coordinate of the cached form (Y+X, Y-X, Z, 2dT) of p,
// as one multiply on every lane (by 1 on lanes 0-2, by 2d on lane 3)
template <class X>
FE_DEV void to_cached4(X &x, fe c, const fe p) {
  const int t = x.lane();
  const fe d2 = FE_D2;
  fe k;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int32_t xi = x.get(p[i], 0), yi = x.get(p[i], 1);
    c[i] = t == 0 ? yi + xi : t == 1 ? yi - xi : p[i];
    k[i] = t == 3 ? d2[i] : (i == 0);
  }
  fe_mul(c, c, k);
}

// lane t's coordinate of the cached entry `ent` (4 x 10 limbs), or of its
// negation: Y+X and Y-X trade places, 2dT changes sign on lane 3
FE_DEV void cached_coord(fe q, int t, const int32_t *ent, bool neg) {
  int c = (t < 2 && neg) ? 1 - t : t;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int32_t v = ent[10 * c + i];
    q[i] = (t == 3 && neg) ? -v : v;
  }
}

// the same for a niels entry (y+x, y-x, 2dxy; 3 x 10 limbs), Z = 1
FE_DEV void niels_coord(fe q, int t, const int32_t *ent, bool neg) {
  int c = t < 2 ? (neg ? 1 - t : t) : 2;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int32_t v = ent[10 * c + i];
    v = (t == 3 && neg) ? -v : v;
    q[i] = t == 2 ? (i == 0) : v;
  }
}

// t = s + 0x88..8 (64 eights); digit j = nibble_j(t) - 8 in [-8, 7]
FE_DEV void digit_words(uint32_t t[8], const uint32_t s[8]) {
  uint64_t carry = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) {
    uint64_t v = (uint64_t)s[q] + 0x88888888u + carry;
    t[q] = (uint32_t)v;
    carry = v >> 32;
  }
}

// Where lane t's decode parks its waiting values (ge_decode): its
// coordinate of the table entries 0-4, which phase 2 writes only later.
template <class X>
struct LanePark {
  static constexpr bool parks = true;
  X &x;
  FE_MEMBER int32_t *park() const { return x.scratch() + 10 * x.lane(); }
};

// The verdict of one signature, on every lane of its group.
//   enc      a callable enc(w) that fills the 8 little-endian words of
//            the encoding this lane decodes: R on lane 1, A on the others
//            (called after scalars, so that w is not live before)
//   scalars  a callable scalars(s, k) that fills the 8 little-endian
//            words of s and of the challenge k (< L); it is called first
//            and its digits go to the scratch, so that neither its inputs
//            (K3: a digest and its reduction) nor the digits are live
//            during the decode
//   base     the niels table j B, j = 0..8 (9 x 3 x 10 limbs)
// The group's scratch (x.scratch()) receives the cached multiples j(-A),
// the digits and R's coordinates.
// Cofactorless: [s]B + [k](-A) == R.  R is not encoded and compared:
// lane 1 decodes it strictly (y < p, a square, not x = 0 with the sign
// bit), and the group checks X_P = x_R Z_P and Y_P = y_R Z_P, which is
// exact (see the header of ed25519_verify.cu).
template <class X, class S, class N>
FE_DEV bool verify4(X &x, N enc, S scalars, const int32_t *base) {
  int32_t *tab;
  // phase 0: the digit words of s and k, to the scratch (first, so that
  // K3's reduction has the registers to itself)
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

  // phase 1: lane 0 decodes A, lane 1 R, strictly (lanes 2 and 3 repeat
  // A's); what waits out the decode's power waits in the scratch
  fe p, rc;  // x and y, then R's coordinate of this lane
  bool ok;
  {
    uint32_t w[8];
    enc(w);
    ok = ge_decode(p, rc, w, LanePark<X>{x}, x.lane() == 1);
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
    if (j < 8) {                    // (j + 1)(-A) = j(-A) + (-A)
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

  // phase 4: X_P = x_R Z_P on lane 0, Y_P = y_R Z_P on lane 1
  tab = x.scratch();
#pragma unroll
  for (int i = 0; i < 10; i++) {
    a[i] = x.get(p[i], 2);
    b[i] = tab[V4_RC + 10 * (t & 1) + i];
  }
  fe_mul(a, b, a);
  int32_t bit = (ok && fe_eq(p, a)) ? 1 : 0;
  return (x.get(bit, 0) & x.get(bit, 1)) != 0;
}
