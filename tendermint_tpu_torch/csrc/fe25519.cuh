// GF(2^255 - 19) and edwards25519 arithmetic, one field element per thread
// (the verify kernels spread a point over four threads: verify4.cuh).
//
// Counterpart of the field/curve layer inside the Pallas kernels of
// tendermint_tpu/ops/pallas_ed25519.py (_mul_school, _carry, _freeze,
// _dbl, _add_cached, _madd_niels, _pow_p58, _invert).  The TPU kernel
// keeps a field element as 22 int32 limbs of 12 bits because its vector
// unit has no wide multiply; a Hopper thread has a 32x32->64-bit integer
// multiply-add, so here an element is TEN signed int32 limbs in radix
// 2^25.5 (the ref10 layout): limb i holds bits [w_i, w_i + u_i) with
//
//     w = 0, 26, 51, 77, 102, 128, 153, 179, 204, 230
//     u = 26, 25, 26, 25, 26, 25, 26, 25, 26, 25      (even limbs 26 bits)
//
// so a product of two elements is 100 (square: 55) 32x32->64 products
// instead of 484.  Only the verdict contract is shared with the TPU
// kernel; the limbs are not.
//
// ---------------------------------------------------------------------------
// Carry bounds (the argument the int64 accumulators rest on)
// ---------------------------------------------------------------------------
// Write U_i = 2^u_i and call an element "F-bounded" when |f_i| <= F * U_i
// for every limb.
//
// fe_mul / fe_sq.  Limb products land at weight w_i + w_j, which is
// w_{i+j} when i or j is even and w_{i+j} + 1 when both are odd (factor
// 2); columns i + j >= 10 wrap with 2^255 = 19 (mod p).  With f F-bounded
// and g G-bounded, |f_i g_j| <= F G 2^(u_i + u_j), and the largest column
// is column 0:
//     f0 g0                      <=        2^52 FG
//     19 * (4 even*even pairs)   <= 19 * 4 * 2^52 FG
//     19 * (5 odd*odd pairs, x2) <= 19 * 5 * 2^51 FG
//     total                      <= 124.5 * 2^52 FG  = 2^58.96 FG.
// The 19 multiplies are applied to the int64 column sums, never to an
// int32 limb, so the only condition is that column 0 fits int64:
//     CONTRACT (mul/sq): F * G <= 16   ->  |column| <= 2^62.96 < 2^63.
// Every limb of such operands is below 4 * 2^26 = 2^28, so the products
// themselves are exact 32x32->64 multiply-adds.
//
// Output of the carry chain (ref10 order 0,4,1,5,2,6,3,7,4,8,9,0 with
// rounding carries c = (h + U/2) >> u): every limb ends in [-U/2, U/2]
// except limb 1 (last carry from limb 0: column 9 <= 5 * 2^52 * 16, so
// carry 9 <= 2^33.4 and 19 * carry9 / 2^26 <= 2^11.7) and limb 5 (second
// carry from limb 4, <= 2^8.1).  So
//     every mul/sq/carry output is 0.501-bounded ("carried").
// A sum or difference of k carried elements is (0.501 k)-bounded.  The
// curve formulas below never feed a product anything beyond 3 carried
// terms on one side and 2 on the other (X3 = E * F in the doubling: E =
// (X+Y)^2 - A - B, F = (B - A) - 2 Z^2, 1.503 x 2.004 = 3.02 <= 16), so no
// intermediate carry is needed and the margin to the contract is > 5x.
//
// fe_carry takes any 16-bounded element (limbs < 2^30, so h + U/2 does
// not overflow int32) to a carried one.  fe_freeze first carries, which
// leaves |value| <= 2^254.01 < p; an exact floor-carry chain then gives
// limbs in [0, U) and a top carry c9 in {-1, 0}; adding 19 * c9 (that is,
// + p when the value was negative) and one more floor chain yields the
// canonical representative in [0, p).  A non-canonical input such as
// y >= p (an encoding may carry it) comes out reduced.
//
// These bounds are exercised on edge values (0, 1, p - 1, p, p + 1,
// p + 18, 2^255 - 1) and on seeded values by fe_selftest
// (csrc/ed25519_verify.cu) against the plain PyTorch field of
// ops/field.py, exactly, in chip_smoke.py.
//
// The MSM chains (csrc/msm.cu).  K4 writes each niels row as
// YpX = carry(Y + X), YmX = carry(Y - X), T2d = fe_mul(T, 2d): all
// carried.  The table's two constant rows (identity, B) are canonical
// limbs, 1-bounded.  ge_madd_niels reads an accumulator whose fields are
// fe_mul outputs (carried) and a niels row that is at most 1-bounded: its
// widest products are (Y + X) * YpX = 1.002 x 1 and, in the tail,
// F * G = 1.503 x 1.503 = 2.26 <= 16; its four outputs are fe_mul outputs
// again.  So the bucket accumulator of K5 stays carried after every step,
// for any number of steps (T = 1,304 at a 131,072-lane batch).  The window
// aggregation (A1) chains ge_to_cached + ge_add_cached on carried points
// the same way: the cached Z is a carried copy, D = 2 Z1 Z2 is 1.002, and
// the tail products are again at most 2.26.
//
// The four-lane schedule (verify4.cuh, K1-K3).  dbl4 and add4 compute the
// formulas of ge_dbl and ge_add_cached / ge_madd_niels with the same
// operands, only split into two rounds of four independent products:
//   dbl4 round 1: X^2, Y^2, Z^2 of carried coordinates, (X + Y)^2 of a
//     1.002-bounded sum; round 2: E F, G H, F G, E H with E 1.503, F
//     2.004, G 1.002, H 1.002 (widest 3.02), exactly ge_dbl's operands.
//   add4 round 1: (Y + X) Y2pX2, (Y - X) Y2mX2 at 1.002 x 1 (the -A
//     table holds multiply outputs, the B table canonical limbs; a
//     negative digit only swaps them and negates 2dT), Z Z2 and T 2dT2
//     carried x carried (Z2 = 1 for a niels entry); round 2: E 1.002,
//     F 1.503, G 1.503, H 1.002 (widest F G = 2.26).
//   to_cached4: (Y +- X) x 1, Z x 1 and T x 2d: one multiply a lane, so
//     every table entry is a multiply output (carried).
// Each round's outputs are multiply outputs again, so the point stays
// carried after any number of steps and the F * G <= 16 contract holds
// with the one-lane margin (> 5x).  The exchanges (__shfl_sync) move
// limbs unchanged and do not enter the argument.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FE_DEV __device__ __forceinline__
#define FE_MEMBER __device__ __forceinline__
#else
#define FE_DEV static inline
#define FE_MEMBER inline
#endif

typedef int32_t fe[10];

struct ge_ext {        // extended (X : Y : Z : T), T = XY/Z
  fe X, Y, Z, T;
};
struct ge_cached {     // (Y+X, Y-X, Z, 2dT)
  fe YpX, YmX, Z, T2d;
};
struct ge_niels {      // (y+x, y-x, 2dxy), Z = 1
  fe YpX, YmX, T2d;
};

// ---------------------------------------------------------------------------
// constants (canonical limbs)
// ---------------------------------------------------------------------------

// d = -121665/121666, 2d, sqrt(-1)
#define FE_D    {-10913610, 13857413, -15372611, 6949391, 114729, \
                 -8787816, -6275908, -3247719, -18696448, -12055116}
#define FE_D2   {-21827239, -5839606, -30745221, 13898782, 229458, \
                 15978800, -12551817, -6495438, 29715968, 9444199}
#define FE_SQRTM1 {-32595792, -7943725, 9377950, 3500415, 12389472, \
                   -272473, -25146209, -2005654, 326686, 11406482}

// 32 bytes of one lane from a lane-major (rows, B) byte array -> 8 LE words
FE_DEV void load_lane32(uint32_t w[8], const uint8_t *__restrict__ rows,
                        int64_t stride, int64_t lane) {
#pragma unroll
  for (int q = 0; q < 8; q++) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; k++)
      v |= (uint32_t)rows[(int64_t)(4 * q + k) * stride + lane] << (8 * k);
    w[q] = v;
  }
}

FE_DEV void fe_0(fe h) {
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = 0;
}

FE_DEV void fe_1(fe h) {
  fe_0(h);
  h[0] = 1;
}

FE_DEV void fe_copy(fe h, const fe f) {
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = f[i];
}

FE_DEV void fe_add(fe h, const fe f, const fe g) {
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = f[i] + g[i];
}

FE_DEV void fe_sub(fe h, const fe f, const fe g) {
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = f[i] - g[i];
}

FE_DEV void fe_neg(fe h, const fe f) {
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = -f[i];
}

FE_DEV void fe_cmov(fe h, const fe f, bool c) {
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = c ? f[i] : h[i];
}

// rounding carry chain on int64 columns -> carried int32 limbs
FE_DEV void fe_carry_wide(fe out, int64_t h[10]) {
  int64_t c;
#define CARRY26(i) c = (h[i] + ((int64_t)1 << 25)) >> 26; \
                   h[i + 1] += c; h[i] -= c * ((int64_t)1 << 26);
#define CARRY25(i) c = (h[i] + ((int64_t)1 << 24)) >> 25; \
                   h[i + 1] += c; h[i] -= c * ((int64_t)1 << 25);
  CARRY26(0) CARRY26(4)
  CARRY25(1) CARRY25(5)
  CARRY26(2) CARRY26(6)
  CARRY25(3) CARRY25(7)
  CARRY26(4) CARRY26(8)
  c = (h[9] + ((int64_t)1 << 24)) >> 25;
  h[0] += c * 19; h[9] -= c * ((int64_t)1 << 25);
  CARRY26(0)
#undef CARRY26
#undef CARRY25
#pragma unroll
  for (int i = 0; i < 10; i++) out[i] = (int32_t)h[i];
}

// CONTRACT: F * G <= 16 (see the header note)
FE_DEV void fe_mul(fe out, const fe f, const fe g) {
  int64_t lo[10], hi[10];
#pragma unroll
  for (int k = 0; k < 10; k++) lo[k] = hi[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      int64_t p = (int64_t)f[i] * (int64_t)g[j];
      if ((i & 1) && (j & 1)) p += p;
      if (i + j < 10) lo[i + j] += p; else hi[i + j - 10] += p;
    }
  }
#pragma unroll
  for (int k = 0; k < 10; k++) lo[k] += 19 * hi[k];
  fe_carry_wide(out, lo);
}

// CONTRACT: F * F <= 16.  Same columns as fe_mul(f, f): each cross
// product f_i f_j (i < j) is taken once and doubled.
FE_DEV void fe_sq(fe out, const fe f) {
  int64_t lo[10], hi[10];
#pragma unroll
  for (int k = 0; k < 10; k++) lo[k] = hi[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      int64_t p = (int64_t)f[i] * (int64_t)f[j];
      if (i != j) p += p;
      if ((i & 1) && (j & 1)) p += p;
      if (i + j < 10) lo[i + j] += p; else hi[i + j - 10] += p;
    }
  }
#pragma unroll
  for (int k = 0; k < 10; k++) lo[k] += 19 * hi[k];
  fe_carry_wide(out, lo);
}

// any 16-bounded element -> carried
FE_DEV void fe_carry(fe h) {
  int64_t w[10];
#pragma unroll
  for (int i = 0; i < 10; i++) w[i] = h[i];
  fe_carry_wide(h, w);
}

// exact floor carry chain; returns the carry out of limb 9 (weight 2^255)
FE_DEV int32_t fe_floor_chain(fe h) {
  int32_t c;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    int s = (i & 1) ? 25 : 26;
    c = h[i] >> s;
    h[i + 1] += c;
    h[i] -= c * (1 << s);
  }
  c = h[9] >> 25;
  h[9] -= c * (1 << 25);
  return c;
}

// canonical limbs (each in [0, U_i), value in [0, p)) of a 16-bounded f
FE_DEV void fe_freeze(fe h, const fe f) {
  fe_copy(h, f);
  fe_carry(h);
  int32_t c9 = fe_floor_chain(h);   // c9 in {-1, 0}
  h[0] += 19 * c9;                  // value < 0: add p = 2^255 - 19
  fe_floor_chain(h);                // carry out is 0
}

// canonical 32-byte little-endian encoding (bit 255 clear)
FE_DEV void fe_tobytes(uint8_t s[32], const fe f) {
  fe h;
  fe_freeze(h, f);
  uint64_t acc = 0;
  int nbits = 0, k = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    acc |= (uint64_t)(uint32_t)h[i] << nbits;
    nbits += (i & 1) ? 25 : 26;
    while (nbits >= 8) {
      s[k++] = (uint8_t)acc;
      acc >>= 8;
      nbits -= 8;
    }
  }
  s[31] = (uint8_t)acc;  // bits 248..254 (nbits == 7 here)
}

// little-endian 32 bytes (given as 8 LE words) -> limbs of the low 255
// bits, each in [0, U_i) (1-bounded; the value may be >= p)
FE_DEV void fe_frombytes(fe h, const uint32_t w[8]) {
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int b = off[i], q = b >> 5, r = b & 31;
    uint64_t win = w[q];
    if (q < 7) win |= (uint64_t)w[q + 1] << 32;
    int width = (i & 1) ? 25 : 26;
    h[i] = (int32_t)((win >> r) & ((1u << width) - 1));
  }
}

FE_DEV bool fe_iszero(const fe f) {
  fe h;
  fe_freeze(h, f);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) acc |= h[i];
  return acc == 0;
}

FE_DEV bool fe_isneg(const fe f) {
  fe h;
  fe_freeze(h, f);
  return h[0] & 1;
}

FE_DEV bool fe_eq(const fe f, const fe g) {
  fe d;
  fe_sub(d, f, g);
  return fe_iszero(d);
}

// Park an element in memory and take it back.  Volatile, so that the
// compiler keeps no register copy while it waits: the verify kernels park
// values in shared memory across the decode's square-root power, which
// is what keeps a thread within 128 registers there.
FE_DEV void fe_park(int32_t *slot, const fe f) {
  volatile int32_t *v = slot;
#pragma unroll
  for (int i = 0; i < 10; i++) v[i] = f[i];
}

FE_DEV void fe_unpark(fe f, const int32_t *slot) {
  const volatile int32_t *v = slot;
#pragma unroll
  for (int i = 0; i < 10; i++) f[i] = v[i];
}

// Where the chains below park their waiting values: NoPark keeps them in
// registers.  A parking caller (the verify kernels) passes a callable
// whose park() returns its slots and `parks` true; it computes the
// address again at each call, so that no register holds it either.
struct NoPark {
  static constexpr bool parks = false;
  FE_MEMBER int32_t *park() const { return nullptr; }
};

// The field a power chain runs on: K1's square and multiply (fe_sq,
// fe_mul) here; K4, S2 and C2's inversion pass Fe2Ops
// (csrc/fe25519_2.cuh), the two-round-carry pair.
struct FeOps {
  static FE_MEMBER void sq(fe h, const fe f) { fe_sq(h, f); }
  static FE_MEMBER void mul(fe h, const fe f, const fe g) { fe_mul(h, f, g); }
};

// f^(2^n) by n squarings
template <class Fd = FeOps>
FE_DEV void fe_sqn(fe h, const fe f, int n) {
  Fd::sq(h, f);
#pragma unroll 1
  for (int i = 1; i < n; i++) Fd::sq(h, h);
}

// (f^(2^250 - 1), f^11): the shared prefix of the inversion and
// square-root exponent ladders (field._chain_250), on the field Fd.
// Parking: t1, the value that waits for a later multiply, waits in
// park() + off.
template <class Fd = FeOps, class Park = NoPark>
FE_DEV void fe_chain_250(fe z250, fe z11, const fe z, Park pk = Park(),
                         int off = 0) {
  constexpr bool PARK = Park::parks;
  fe t0, t1, t2, t3;
  Fd::sq(t0, z);             // 2
  fe_sqn<Fd>(t1, t0, 2);     // 8
  Fd::mul(t1, z, t1);        // 9
  Fd::mul(z11, t0, t1);      // 11
  Fd::sq(t2, z11);           // 22
  Fd::mul(t1, t1, t2);       // 2^5 - 1
  fe_sqn<Fd>(t2, t1, 5);
  Fd::mul(t1, t2, t1);       // 2^10 - 1
  if constexpr (PARK) fe_park(pk.park() + off, t1);
  fe_sqn<Fd>(t2, t1, 10);
  if constexpr (PARK) fe_unpark(t1, pk.park() + off);
  Fd::mul(t2, t2, t1);       // 2^20 - 1
  fe_sqn<Fd>(t3, t2, 20);
  Fd::mul(t2, t3, t2);       // 2^40 - 1
  fe_sqn<Fd>(t2, t2, 10);
  if constexpr (PARK) fe_unpark(t1, pk.park() + off);
  Fd::mul(t1, t2, t1);       // 2^50 - 1
  if constexpr (PARK) fe_park(pk.park() + off, t1);
  fe_sqn<Fd>(t2, t1, 50);
  if constexpr (PARK) fe_unpark(t1, pk.park() + off);
  Fd::mul(t2, t2, t1);       // 2^100 - 1
  fe_sqn<Fd>(t3, t2, 100);
  Fd::mul(t2, t3, t2);       // 2^200 - 1
  fe_sqn<Fd>(t2, t2, 50);
  if constexpr (PARK) fe_unpark(t1, pk.park() + off);
  Fd::mul(z250, t2, t1);     // 2^250 - 1
}

// z^(p - 2) = z^(2^255 - 21) on the field Fd; 0 maps to 0
template <class Fd = FeOps>
FE_DEV void fe_invert(fe out, const fe z) {
  fe z250, z11;
  fe_chain_250<Fd>(z250, z11, z);
  fe_sqn<Fd>(z250, z250, 5); // 2^255 - 32
  Fd::mul(out, z250, z11);   // 2^255 - 21
}

// z^((p - 5) / 8) = z^(2^252 - 3) on the field Fd
// (parking: z waits out the chain in park() + off, the chain's own value
// in park() + off + 40)
template <class Fd = FeOps, class Park = NoPark>
FE_DEV void fe_pow22523(fe out, const fe z, Park pk = Park(), int off = 0) {
  fe z250, z11;
  if constexpr (Park::parks) fe_park(pk.park() + off, z);
  fe_chain_250<Fd>(z250, z11, z, pk, off + 40);
  fe_sqn<Fd>(z250, z250, 2); // 2^252 - 4
  if constexpr (Park::parks) {
    fe zz;
    fe_unpark(zz, pk.park() + off);
    Fd::mul(out, z250, zz);  // 2^252 - 3
  } else {
    Fd::mul(out, z250, z);
  }
}

// ---------------------------------------------------------------------------
// group law (a = -1 twisted Edwards; complete formulas)
// ---------------------------------------------------------------------------

// dbl-2008-hwcd; ignores p's T.  with_t = false skips T3 = E*H, valid
// when the next operation is another doubling.
FE_DEV void ge_dbl(ge_ext &r, const ge_ext &p, bool with_t) {
  fe a, b, c, e, g, f, h;
  fe_sq(a, p.X);               // carried
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_add(c, c, c);             // C = 2 Z^2           1.002
  fe_add(e, p.X, p.Y);         // X + Y               1.002
  fe_sq(e, e);                 //                     carried
  fe_sub(e, e, a);
  fe_sub(e, e, b);             // E                   1.503
  fe_sub(g, b, a);             // G = B - A           1.002
  fe_sub(f, g, c);             // F = G - C           2.004
  fe_add(h, a, b);
  fe_neg(h, h);                // H = -A - B          1.002
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  if (with_t) fe_mul(r.T, e, h);
}

// add-2008-hwcd-3: r = p + q (q cached, its fields carried)
FE_DEV void ge_add_cached(ge_ext &r, const ge_ext &p, const ge_cached &q) {
  fe a, b, c, d, t;
  fe_add(t, p.Y, p.X);
  fe_mul(a, t, q.YpX);
  fe_sub(t, p.Y, p.X);
  fe_mul(b, t, q.YmX);
  fe_mul(c, p.T, q.T2d);
  fe_mul(d, p.Z, q.Z);
  fe_add(d, d, d);             // 2 Z1 Z2             1.002
  fe e, f, g, h;
  fe_sub(e, a, b);             //                     1.002
  fe_sub(f, d, c);             //                     1.503
  fe_add(g, d, c);             //                     1.503
  fe_add(h, a, b);             //                     1.002
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// r = p + q with q in niels form (Z2 = 1)
FE_DEV void ge_madd_niels(ge_ext &r, const ge_ext &p, const ge_niels &q) {
  fe a, b, c, d, t;
  fe_add(t, p.Y, p.X);
  fe_mul(a, t, q.YpX);
  fe_sub(t, p.Y, p.X);
  fe_mul(b, t, q.YmX);
  fe_mul(c, p.T, q.T2d);
  fe_add(d, p.Z, p.Z);
  fe e, f, g, h;
  fe_sub(e, a, b);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, a, b);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

FE_DEV void ge_to_cached(ge_cached &r, const ge_ext &p) {
  const fe d2 = FE_D2;
  fe_add(r.YpX, p.Y, p.X);
  fe_carry(r.YpX);
  fe_sub(r.YmX, p.Y, p.X);
  fe_carry(r.YmX);
  fe_copy(r.Z, p.Z);
  fe_mul(r.T2d, p.T, d2);
}

// -q for a negative digit: swap (Y+X, Y-X), negate 2dT
FE_DEV void ge_cached_cneg(ge_cached &q, bool neg) {
  if (neg) {
#pragma unroll
    for (int i = 0; i < 10; i++) {
      int32_t s = q.YpX[i];
      q.YpX[i] = q.YmX[i];
      q.YmX[i] = s;
      q.T2d[i] = -q.T2d[i];
    }
  }
}

FE_DEV void ge_niels_cneg(ge_niels &q, bool neg) {
  if (neg) {
#pragma unroll
    for (int i = 0; i < 10; i++) {
      int32_t s = q.YpX[i];
      q.YpX[i] = q.YmX[i];
      q.YmX[i] = s;
      q.T2d[i] = -q.T2d[i];
    }
  }
}

// y < p for the low 255 bits of a little-endian encoding (the strict
// form of the decode, for R: 2^255 - 19 <= y < 2^255 is non-canonical)
FE_DEV bool fe_bytes_canonical(const uint32_t w[8]) {
  uint32_t all = w[1] & w[2] & w[3] & w[4] & w[5] & w[6];
  bool top = (w[7] & 0x7FFFFFFFu) == 0x7FFFFFFFu;
  return !(top && all == 0xFFFFFFFFu && w[0] >= 0xFFFFFFEDu);
}

// RFC 8032 5.1.3 decompression with Go crypto/ed25519 semantics: (x, y)
// with x of the requested sign, both carried, and the decode verdict: a
// non-canonical y is accepted and reduced, a non-square is rejected, and
// x = 0 with the sign bit set is rejected.  strict also rejects y >= p
// (the decode of R in the verify kernels).
//
// Parking (the verify kernels, whose group decodes A on one lane and R on
// another in one instruction stream): every value that waits out the
// square-root power waits in memory, at park() + 0 (y), + 40 (u v^3),
// + 80 and + 120 (the power's) and + 160 (the sign bit and the strict
// check, one word), so that it holds no register; u and v are computed
// again from y after the power, and the sqrt(-1) factor is a select, not
// a branch.  Without parking it is the plain one-lane decode (K4 has its
// own, csrc/decompress.cuh).
template <class Park = NoPark>
FE_DEV bool ge_decode(fe x, fe y, const uint32_t w[8], Park pk = Park(),
                      bool strict = false) {
  constexpr bool PARK = Park::parks;
  const fe d = FE_D, sqrtm1 = FE_SQRTM1;
  bool sign = (w[7] >> 31) & 1;
  bool canon = !strict || fe_bytes_canonical(w);
  fe yy, u, v, v3, t, vxx;
  fe_frombytes(y, w);
  fe_carry(y);
  fe_sq(yy, y);
  fe_copy(u, yy);
  u[0] -= 1;                   // u = y^2 - 1
  fe_mul(v, yy, d);
  v[0] += 1;                   // v = d y^2 + 1
  fe_sq(v3, v);
  fe_mul(v3, v3, v);           // v^3
  fe_sq(t, v3);
  fe_mul(t, t, v);             // v^7
  fe_mul(t, t, u);             // u v^7
  fe_mul(x, u, v3);            // u v^3
  if constexpr (PARK) {
    volatile int32_t *flags = pk.park() + 160;
    *flags = (int32_t)sign | (int32_t)canon << 1;
    fe_park(pk.park(), y);
    fe_park(pk.park() + 40, x);
    fe_pow22523(t, t, pk, 80);  // (u v^7)^((p-5)/8)
    fe_unpark(x, pk.park() + 40);
    fe_unpark(y, pk.park());
  } else {
    fe_pow22523(t, t);
  }
  fe_mul(x, x, t);             // x = u v^3 (u v^7)^((p-5)/8)
  if constexpr (PARK) {
    fe_sq(yy, y);
    fe_copy(u, yy);
    u[0] -= 1;
    fe_mul(v, yy, d);
    v[0] += 1;
  }
  fe_sq(vxx, x);
  fe_mul(vxx, vxx, v);         // v x^2
  bool ok_plus = fe_eq(vxx, u);
  fe nu;
  fe_neg(nu, u);
  bool ok_minus = fe_eq(vxx, nu);
  if constexpr (PARK) {
    fe_mul(t, x, sqrtm1);
    fe_cmov(x, t, ok_minus);
    const volatile int32_t *flags = pk.park() + 160;
    int32_t f = *flags;
    sign = f & 1;
    canon = (f >> 1) & 1;
  } else if (ok_minus) {
    fe_mul(x, x, sqrtm1);
  }
  bool ok = (ok_plus || ok_minus) && canon;
  if (fe_iszero(x) && sign) ok = false;
  fe_neg(t, x);
  fe_cmov(x, t, fe_isneg(x) != sign);
  if constexpr (PARK) fe_unpark(y, pk.park());   // not live since y^2
  return ok;
}

