// The verify body of kernel S1 (csrc/secp256k1_verify.cu): one BIP-340
// signature on a group of four lanes, written once as templates over the
// group's exchange primitive.  On the card the primitive is __shfl_sync
// within the group (GroupXch in group4.cuh); a host program runs the same
// body on four threads that meet at a barrier (tests/test_torch_secp.py
// does, against the plain version and the JAX package).
//
// Group concept, for a class X:
//   int lane()                         this lane's index t in the group
//   void get8(out, v, src)             out = the element v as lane src
//                                      holds it (8 words)
//   void sync()                        order the group's shared-memory
//                                      writes before its later reads
//   uint32_t *scratch()                the group's S4_SIG_WORDS words
// Every lane of a group calls each of them, in the same order, the same
// number of times.  Lanes never branch on t: a per-lane choice is a
// select, so the four lanes run one instruction stream.  A branch on the
// data (a zero digit, a degenerate addition) is taken by the whole group,
// since all four lanes hold the same values.
//
// Every lane holds the whole accumulator (X : Y : Z), canonical, and
// computes the additions and subtractions of the formulas itself; the
// products of a round are spread over the lanes, one a lane, and the
// group exchanges what the next round reads (get8, 8 shuffles an
// element).  A round is all squares or all multiplies, so that no lane
// waits on another's longer operation.  The formulas and their rounds
// (secp256k1 has a = 0; the degenerate cases branch as in jac_add4):
//   jac_dbl4   dbl-2009-l, 3 rounds for 5 S + 2 M
//              1 (S)  lane 0 A = X^2, lane 1 B = Y^2
//              2 (S)  lane 0 F = (3A)^2, lane 1 C = B^2, lanes 2-3
//                     T = (X + B)^2
//              3 (M)  lane 0 E (D - X3), lane 1 Y Z
//   jac_madd4  madd-2007-bl with (x2, y2) affine, 5 rounds for 4 S + 7 M
//              1 (M)  lane 0 Z1Z1 = Z1^2, lane 1 y2 Z1
//              2 (M)  lane 0 U2 = x2 Z1Z1, lane 1 S2 = y2 Z1 Z1Z1
//              3 (S)  lane 0 HH = H^2, lane 1 r^2, lanes 2-3 (Z1 + H)^2
//              4 (M)  lane 0 J = H I, lane 1 V = X1 I   (I = 4 HH)
//              5 (M)  lane 0 r (V - X3), lane 1 Y1 J
//   jac_add4   add-2007-bl, 5 rounds for 5 S + 11 M
//              1 (M)  lanes 0-3 Z1^2, Z2^2, Y1 Z2, Y2 Z1
//              2 (M)  lanes 0-3 U1 = X1 Z2Z2, U2 = X2 Z1Z1,
//                     S1 = Y1 Z2 Z2Z2, S2 = Y2 Z1 Z1Z1
//              3 (S)  lane 0 I = (2H)^2, lane 1 r^2, lanes 2-3
//                     (Z1 + Z2)^2
//              4 (M)  lane 0 J = H I, lane 1 V = U1 I, lanes 2-3 Z3
//              5 (M)  lane 0 r (V - X3), lane 1 S1 J
// (the squares of jac_add4's round 1 are priced as multiplies: a round of
// two squares and two multiplies takes a multiply's time anyway).  The
// values are those of the one-lane formulas, so a result is the same
// Jacobian representative as the plain version's.
#pragma once

#include "fe_secp.cuh"

// A group's scratch, in 32-bit words: the table j(-P), j = 1..15, entry
// j at (j - 1) S4_ENTRY (X, Y, Z), then the 8 words of s and the 8 of e,
// then one word of padding, so that the eight groups of a warp start on
// eight different banks (377 = 25 mod 32).
#define S4_ENTRY 24
#define S4_DIGITS (15 * S4_ENTRY)
#define S4_SIG_WORDS (S4_DIGITS + 16 + 1)

struct jpt {
  fs X, Y, Z;
};

FS_DEV void jac_set_inf(jpt &r) {
  fs_set_small(r.X, 1);
  fs_set_small(r.Y, 1);
  fs_set_small(r.Z, 0);
}

FS_DEV void fs_load(fs r, const uint32_t *s) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = s[i];
}

// r = (t == 0 ? a : t == 1 ? b : c)
FS_DEV void fs_sel3(fs r, int t, const fs a, const fs b, const fs c) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = t == 0 ? a[i] : t == 1 ? b[i] : c[i];
}

// p = 2p (dbl-2009-l, a = 0).  No point of the curve has y = 0 (-7 is not
// a cube mod p), and Z = 0 maps to Z = 0.
template <class X>
FS_DEV void jac_dbl4(X &x, jpt &p) {
  const int t = x.lane();
  fs m, u, a, b;
  // round 1: lane 0 A = X^2, lane 1 B = Y^2 (lanes 2, 3 repeat them)
  fs_sel(u, t & 1, p.Y, p.X);
  fs_sqr(m, u);
  x.get8(a, m, 0);
  x.get8(b, m, 1);
  // round 2: lane 0 F = E^2 with E = 3A, lane 1 C = B^2, lanes 2, 3
  // T = (X + B)^2
  fs e, c;
  fs_add(e, a, a);
  fs_add(e, e, a);
  fs_add(u, p.X, b);
  fs_sel3(u, t, e, b, u);
  fs_sqr(m, u);
  x.get8(u, m, 2);
  x.get8(c, m, 1);
  fs_sub(u, u, a);
  fs_sub(u, u, c);
  fs_add(u, u, u);            // D = 2 ((X + B)^2 - A - C)
  x.get8(a, m, 0);            // F
  fs_sub(a, a, u);
  fs_sub(a, a, u);            // X3 = F - 2 D
  // round 3: lane 0 E (D - X3), lane 1 Y Z
  fs_sub(u, u, a);
  fs_sel(b, t == 0, e, p.Y);
  fs_sel(u, t == 0, u, p.Z);
  fs_mul(m, b, u);
  fs_copy(p.X, a);
  x.get8(a, m, 0);
  x.get8(b, m, 1);
  fs_add(c, c, c);
  fs_add(c, c, c);
  fs_add(c, c, c);            // 8 C
  fs_sub(p.Y, a, c);          // Y3 = E (D - X3) - 8 C
  fs_add(p.Z, b, b);          // Z3 = 2 Y Z
}

// Complete mixed addition p = p + (x2, y2) for an affine point (Z2 = 1):
// g holds x2 then y2 (8 words each).  The degenerate cases branch, for
// the whole group: an infinity p returns the point, P = Q doubles, P = -Q
// gives infinity (the reference's selects, ops/secp.py add).
template <class X>
FS_DEV void jac_madd4(X &x, jpt &p, const uint32_t *g) {
  if (fs_iszero(p.Z)) {
    fs_load(p.X, g);
    fs_load(p.Y, g + 8);
    fs_set_small(p.Z, 1);
    return;
  }
  const int t = x.lane();
  fs m, u, zz, h, rr;
  // round 1: lane 0 Z1Z1 = Z1^2, lane 1 y2 Z1
  fs_load(u, g + 8);
  fs_sel(u, t == 0, p.Z, u);
  fs_mul(m, u, p.Z);
  x.get8(zz, m, 0);
  x.get8(u, m, 1);
  // round 2: lane 0 U2 = x2 Z1Z1, lane 1 S2 = y2 Z1 Z1Z1
  fs_load(h, g);
  fs_sel(u, t == 0, h, u);
  fs_mul(m, u, zz);
  x.get8(h, m, 0);
  x.get8(rr, m, 1);
  fs_sub(h, h, p.X);          // H = U2 - X1
  fs_sub(rr, rr, p.Y);        // S2 - Y1
  if (fs_iszero(h)) {
    if (fs_iszero(rr))
      jac_dbl4(x, p);
    else
      jac_set_inf(p);
    return;
  }
  fs_add(rr, rr, rr);         // r = 2 (S2 - Y1)
  // round 3: lane 0 HH = H^2, lane 1 r^2, lanes 2, 3 (Z1 + H)^2
  fs_add(u, p.Z, h);
  fs_sel3(u, t, h, rr, u);
  fs_sqr(m, u);
  fs hh;
  x.get8(u, m, 2);
  x.get8(hh, m, 0);
  fs_sub(u, u, zz);
  fs_sub(p.Z, u, hh);         // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  x.get8(zz, m, 1);           // r^2
  fs_add(hh, hh, hh);
  fs_add(hh, hh, hh);         // I = 4 HH = (2H)^2
  // round 4: lane 0 J = H I, lane 1 V = X1 I
  fs_sel(u, t == 0, h, p.X);
  fs_mul(m, u, hh);
  x.get8(h, m, 0);            // J
  x.get8(hh, m, 1);           // V
  fs_sub(zz, zz, h);
  fs_sub(zz, zz, hh);
  fs_sub(zz, zz, hh);         // X3 = r^2 - J - 2 V
  // round 5: lane 0 r (V - X3), lane 1 Y1 J
  fs_sub(hh, hh, zz);
  fs_sel(u, t == 0, rr, p.Y);
  fs_sel(hh, t == 0, hh, h);
  fs_mul(m, u, hh);
  fs_copy(p.X, zz);
  x.get8(u, m, 0);
  x.get8(hh, m, 1);
  fs_add(hh, hh, hh);
  fs_sub(p.Y, u, hh);         // Y3 = r (V - X3) - 2 Y1 J
}

// Complete addition p = p + q, q a table entry (X2, Y2, Z2 at q, q + 8,
// q + 16; read where it is used): add-2007-bl with branches for the
// degenerate cases the reference selects (ops/secp.py add): an infinity
// operand returns the other, P = Q doubles, P = -Q gives infinity.
template <class X>
FS_DEV void jac_add4(X &x, jpt &p, const uint32_t *q) {
  fs m, u, v;
  fs_load(u, q + 16);
  if (fs_iszero(u)) return;
  if (fs_iszero(p.Z)) {
    fs_load(p.X, q);
    fs_load(p.Y, q + 8);
    fs_copy(p.Z, u);
    return;
  }
  const int t = x.lane();
  // round 1: lanes 0-3 Z1 Z1, Z2 Z2, Y1 Z2, Y2 Z1
  fs_load(v, q + 8);
  fs_sel(v, t == 2, p.Y, v);
  fs_sel3(v, t, p.Z, u, v);
  fs_sel(u, t == 1 || t == 2, u, p.Z);
  fs_mul(m, v, u);
  fs z1z1, z2z2;
  x.get8(z1z1, m, 0);
  x.get8(z2z2, m, 1);
  // round 2: lanes 0-3 U1 = X1 Z2Z2, U2 = X2 Z1Z1, S1 = Y1 Z2 Z2Z2,
  // S2 = Y2 Z1 Z1Z1
  fs_load(v, q);
  fs_sel3(v, t, p.X, v, m);
  fs_sel(u, t & 1, z1z1, z2z2);
  fs_mul(m, v, u);
  fs u1, s1, h, rr;
  x.get8(u1, m, 0);
  x.get8(h, m, 1);
  x.get8(s1, m, 2);
  x.get8(rr, m, 3);
  fs_sub(h, h, u1);           // H = U2 - U1
  fs_sub(rr, rr, s1);         // S2 - S1
  if (fs_iszero(h)) {
    if (fs_iszero(rr))
      jac_dbl4(x, p);
    else
      jac_set_inf(p);
    return;
  }
  fs_add(rr, rr, rr);         // r = 2 (S2 - S1)
  fs_add(z1z1, z1z1, z2z2);   // Z1Z1 + Z2Z2
  // round 3: lane 0 I = (2H)^2, lane 1 r^2, lanes 2, 3 (Z1 + Z2)^2
  fs_load(v, q + 16);
  fs_add(v, p.Z, v);
  fs_add(u, h, h);
  fs_sel3(u, t, u, rr, v);
  fs_sqr(m, u);
  x.get8(v, m, 2);
  fs_sub(v, v, z1z1);         // (Z1 + Z2)^2 - Z1Z1 - Z2Z2
  x.get8(z2z2, m, 0);         // I
  x.get8(z1z1, m, 1);         // r^2
  // round 4: lane 0 J = H I, lane 1 V = U1 I, lanes 2, 3 Z3 = (...) H
  fs_sel3(u, t, h, u1, v);
  fs_sel(v, t < 2, z2z2, h);
  fs_mul(m, u, v);
  x.get8(h, m, 0);            // J
  x.get8(u1, m, 1);           // V
  x.get8(p.Z, m, 2);
  fs_sub(z1z1, z1z1, h);
  fs_sub(z1z1, z1z1, u1);
  fs_sub(z1z1, z1z1, u1);     // X3 = r^2 - J - 2 V
  // round 5: lane 0 r (V - X3), lane 1 S1 J
  fs_sub(u1, u1, z1z1);
  fs_sel(u, t == 0, rr, s1);
  fs_sel(v, t == 0, u1, h);
  fs_mul(m, u, v);
  fs_copy(p.X, z1z1);
  x.get8(u, m, 0);
  x.get8(v, m, 1);
  fs_add(v, v, v);
  fs_sub(p.Y, u, v);          // Y3 = r (V - X3) - 2 S1 J
}

// lane t writes the words w = t mod 4 of table entry j (1..15)
FS_DEV void tab_store4(uint32_t *tab, int t, int j, const jpt &p) {
  uint32_t *e = tab + (j - 1) * S4_ENTRY;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    if ((i & 3) == t) {
      e[i] = p.X[i];
      e[8 + i] = p.Y[i];
      e[16 + i] = p.Z[i];
    }
  }
}

// The verdict of one signature, on every lane of its group.
//   load  a callable load(k, w) that fills the 8 little-endian words of
//         input k (0 px, 1 rx, 2 s, 3 e), each any value below 2^256; it
//         is called where the value is needed, so that nothing waits in a
//         register (rx only at the end)
//   g     jG, j = 0..15, affine x then y (16 x 16 words; entry 0 unused)
// The group's scratch (x.scratch()) receives the table j(-P) and the
// digit words.  lift_x(px) with even y (a non-square x^3 + 7 rejects);
// R' = [s]G + [e](-P), 64 steps of 4 doublings, a mixed add of G's entry
// and a complete add of -P's, a zero digit skipping its add; accept iff
// R' is finite, x(R') = rx mod p and y(R') is even.  The square root and
// the inversion are serial chains of one element: all four lanes run
// them alike.
template <class X, class L>
FS_DEV bool secp_verify4(X &x, L load, const uint32_t *g) {
  const int t = x.lane();
  // phase 0: the words of s (lane 0) and e (lane 1) to the scratch
  {
    fs w;
    load(2 + (t & 1), w);
    uint32_t *dw = x.scratch() + S4_DIGITS;
    if (t < 2) {
#pragma unroll
      for (int q = 0; q < 8; q++) dw[8 * t + q] = w[q];
    }
  }
  // phase 1: -P = (px, -y), y the even root of px^3 + 7
  jpt acc;
  bool ok;
  {
    fs c, y, u;
    load(0, acc.X);
    fs_reduce_once(acc.X);
    fs_sqr(u, acc.X);
    fs_mul(c, u, acc.X);
    fs_set_small(u, 7);
    fs_add(c, c, u);
    fs_sqrt(y, c);
    fs_sqr(u, y);
    ok = fs_eq(u, c);
    fs_neg(u, y);
    fs_sel(acc.Y, y[0] & 1, y, u);     // -y for the even root y
    fs_set_small(acc.Z, 1);
  }
  // phase 2: the table j(-P), j = 1..15: one doubling, 13 additions of
  // entry 1
  {
    uint32_t *tab = x.scratch();
    tab_store4(tab, t, 1, acc);
    x.sync();
    jac_dbl4(x, acc);
    tab_store4(tab, t, 2, acc);
#pragma unroll 1
    for (int j = 3; j < 16; j++) {
      jac_add4(x, acc, tab);
      tab_store4(tab, t, j, acc);
    }
    x.sync();
  }
  // phase 3: the ladder
  jac_set_inf(acc);
#pragma unroll 1
  for (int i = 0; i < 64; i++) {
#pragma unroll 1
    for (int k = 0; k < 4; k++) jac_dbl4(x, acc);
    const uint32_t *tab = x.scratch();
    int ds = fs_nibble_msb(tab + S4_DIGITS, i);
    if (ds) jac_madd4(x, acc, g + 16 * ds);
    int de = fs_nibble_msb(tab + S4_DIGITS + 8, i);
    if (de) jac_add4(x, acc, tab + (de - 1) * S4_ENTRY);
  }
  // phase 4: the affine check; x = X / Z^2 on lane 0, Z^-3 on lane 1,
  // then y = Y Z^-3 on every lane
  bool fin = !fs_iszero(acc.Z);
  fs zi, zz, m;
  fs_invert(zi, acc.Z);
  fs_sqr(zz, zi);
  fs_sel(m, t == 0, acc.X, zi);
  fs_mul(m, m, zz);
  x.get8(acc.X, m, 0);
  x.get8(zz, m, 1);
  fs_mul(acc.Y, acc.Y, zz);
  load(1, zz);
  fs_reduce_once(zz);
  return ok && fin && fs_eq(acc.X, zz) && !(acc.Y[0] & 1);
}
