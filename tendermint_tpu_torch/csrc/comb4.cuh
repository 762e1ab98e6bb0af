// The bodies of kernels C1 (the comb table build) and C2 (the comb verify),
// csrc/comb.cu, written as templates over the exchange and over the
// callables that read and write memory, so that a host program can run
// them on threads that meet at barriers (tests/test_torch_comb.py does,
// against the plain versions).
//
// C1: a block's C1_KEYS keys over four warps of distinct roles, each key
// on one four-lane group of each warp, lane t holding coordinate t of
// (X, Y, Z, T), on S2's four-lane steps and field (ristretto4.cuh sr_dbl,
// sr_add, sr_to_cached; fe25519_2.cuh fe_sq2, fe_mul2; the group's get()
// is __shfl_sync of width 4 on the card).  The chain warp decodes A and
// runs only the doublings of the window bases; three helper warps form the
// other multiples and the cached entries from the points the chain hands
// them through shared memory (comb_build4 below).  Every step computes
// the formula of the plain version with its operands, so every entry holds
// the plain version's field values (their limbs differ; the carry bounds
// are C1's note below).
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
//       an entry of -A's table: C1's fe_mul2 outputs (0.503; lane 3 may
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

// ---------------------------------------------------------------------------
// C1: a block's keys over four warps: the doubling chain and three helpers
// ---------------------------------------------------------------------------
// Per window i, from g = 16^i (-A), the entries 0..8 of cached_window(g)
// and the next window's base, with the formulas and operands of
// curve.cached_window and comb_table_scan: 2g = dbl g, 3g = 2g + g, 4g =
// dbl 2g, 5g = 4g + g, 6g = dbl 3g, 7g = 6g + g, 8g = dbl 4g, the next g =
// dbl 8g, entry j the cached form of jg (entry 0 the identity, entry 1 g's,
// the addend g of every addition).  Only g -> 2g -> 4g -> 8g -> 16g is a
// chain from window to window; the rest hangs off it.  So the roles, each
// a program of micro-operations (C1_PROG_*) of one window:
//   C1_CHAIN  decodes A (every lane of the group, c1_decode; the values
//             that wait out the square root parked in the staging area,
//             C1Park), then per window 4 doublings (8 rounds), handing g,
//             2g, 4g, 8g to a ring slot
//   C1_HELP1  g's cached form c, 3g = 2g + c, 6g = dbl 3g, 7g = 6g + c (7
//             rounds), handing 3g, 6g, 7g to the same slot
//   C1_HELP2  c again, 5g = 4g + c, the entries 1, 4, 5, 8 (6 rounds)
//   C1_HELP3  the entries 2, 3, 6, 7 (4 rounds) and the identity (0)
// Hand-offs: a ring of C1_RING window slots in shared memory, each slot
// the block's 7 points (C1_G..C1_A7), and named barriers, a FULL and an
// EMPTY a slot for each channel: A from the chain to the helpers (a FULL
// barrier for each helper, so that no helper waits on another's progress;
// one EMPTY), B from helper 1 to helper 3.  A producer waits on a slot's
// EMPTY barrier before it writes the slot (from the window C1_RING on) and
// arrives at its FULL barriers after; a consumer waits on its FULL before
// it reads and arrives at EMPTY once it has the points in registers (but
// in the last C1_RING windows, whose slots are not written again, so that
// every barrier completes).  The helpers take at most 7 rounds a window to
// the chain's 8, so two slots keep the chain from waiting on a helper.
// Entries: a warp writes entry j of its keys (each lane its coordinate's
// 10 limbs) to its staging area in shared memory and hands it to put(win,
// j), which stores the block's run of the table, keys key0.. contiguous
// (one bulk copy on the card).
// One loop runs every role (c1_run), so that the four warps share one
// copy of each step's code: with a copy of the steps inlined for each role
// the kernel was 37,528 SASS instructions, more than the SM's instruction
// cache holds, and a helper's round took ~5x the chain's.
//
// Carry bounds of C1 (fe25519_2.cuh: fe_sq2 / fe_mul2 outputs are
// 0.503-bounded; CONTRACT the folded factor <= 1.68, f <= 16, F G <= 16;
// the steps' rounds as in ristretto4.cuh's note, there on coordinates at
// the 0.503 bound, as every one here is).
//   decode: y through fe_carry (0.501); u = y^2 - 1, v = d y^2 + 1 (d on
//     the folded side) 0.5031; the power chain on outputs (fe25519_2.cuh's
//     power-chain note); u v^3, x t, x sqrt(-1) (folded), v x^2: outputs
//     times outputs.  x an output or its negation, 0.503.
//   -A = (-x, y, 1, -x y): -x y = fe_mul2(-x, y), 0.503.
//   doubling: sr_dbl of coordinates at 0.503 (widest L 1.509, F G 3.04),
//     its outputs negated back, 0.503.
//   addition: sr_add of a point at 0.503 and c, an sr_to_cached output
//     (0.503) on the folded side: widest L 1.509, F G 2.28.
//   conversion: sr_to_cached, Y +- X 1.006 times 1 or 2d (canonical,
//     folded side).
// So every folded factor is at most 1.509 < 1.68 and every F G at most
// 3.04, > 5x inside the contract; every entry is an fe_mul2 output
// (0.503; the identity's limbs canonical), and a hand-off moves limbs
// unchanged.
//
// The exchange of C1's body (C1Xch in comb.cu on the card; on the host 128
// threads of a block that meet at barriers), for a class X:
//   int lane()                       this lane's index t in its group
//   int group()                      the group's key in the block (0..7)
//   int32_t get(int32_t v, int src)  v as held by lane src of the group
//   int32_t *smem()                  the block's C1_SMEM_WORDS shared words
//   void arrive(int bar)             arrive at named barrier bar, no wait
//   void wait(int bar)               arrive at bar and wait for it
//   void stage_free<N>()             the warp's staging may be written:
//                                    every put() of the warp but the N
//                                    latest has read its staged entry
//   void put(int win, int j)         the warp's staged entry j of its
//                                    keys -> the table's run for (win, j)
// Every lane of a warp calls each of them the same number of times in the
// same order; each role is one warp.
#define C1_KEYS 8                  // keys a block: a group of each warp
#define C1_THREADS 128             // the four warps
#define C1_PT (C1_KEYS * 40)       // one point or entry of the block's keys
#define C1_RING 2                  // window slots between chain and helpers
#define C1_G 0                     // a slot's points: the chain's g, 2g,
#define C1_A2 1                    //   4g, 8g, helper 1's 3g, 6g, 7g
#define C1_A4 2
#define C1_A8 3
#define C1_A3 4
#define C1_A6 5
#define C1_A7 6
#define C1_SLOT (7 * C1_PT)
#define C1_STAGE (C1_RING * C1_SLOT)  // then the 9 staged entries
#define C1_SMEM_WORDS (C1_STAGE + COMB_DIGITS * C1_PT)
// named barriers (0 is __syncthreads'), one of each kind a ring slot:
// FULL of channel A for each helper h (the chain and helper h, 64
// threads: a helper never waits on another one's progress), EMPTY of
// channel A (the chain and the three helpers, 128), FULL and EMPTY of
// channel B (helper 1 and helper 3, 64)
#define C1_FULL_A(h) (1 + ((h) - 1) * C1_RING)
#define C1_EMPTY_A C1_FULL_A(4)
#define C1_FULL_B (C1_EMPTY_A + C1_RING)
#define C1_EMPTY_B (C1_FULL_B + C1_RING)
#define C1_BARS (C1_EMPTY_B + C1_RING)
#define C1_CHAIN 0
#define C1_HELP1 1
#define C1_HELP2 2
#define C1_HELP3 3

// the threads that meet at named barrier bar
FE_DEV int c1_bar_threads(int bar) {
  return bar >= C1_EMPTY_A && bar < C1_FULL_B ? 128 : 64;
}

// lane t's 10 words of point k of its group's key in ring slot s, and of
// its staged entry j
template <class X>
FE_DEV int32_t *c1_ring(X &x, int s, int k) {
  return x.smem() + s * C1_SLOT + k * C1_PT + 40 * x.group() + 10 * x.lane();
}
template <class X>
FE_DEV int32_t *c1_stage(X &x, int j) {
  return x.smem() + C1_STAGE + j * C1_PT + 40 * x.group() + 10 * x.lane();
}
FE_DEV void c1_write(int32_t *d, const fe p) {
#pragma unroll
  for (int i = 0; i < 10; i++) d[i] = p[i];
}
FE_DEV void c1_read(fe p, const int32_t *s) {
#pragma unroll
  for (int i = 0; i < 10; i++) p[i] = s[i];
}

// Where the chain's decode parks (c1_decode): the staging of entries 1-8,
// 200 words a group (lane t's values at 10 t + 0, 40, 80, 120 and its
// flags at 10 t + 160).  A helper stages there only after the chain's
// first FULL_A barrier, which completes after every chain lane's decode;
// the ring is no place for it, since a chain group may run ahead of the
// others of its warp wherever no shuffle holds them together.
template <class X>
struct C1Park {
  static constexpr bool parks = true;
  X &x;
  FE_MEMBER int32_t *park() const {
    return x.smem() + C1_STAGE + C1_PT + 200 * x.group() + 10 * x.lane();
  }
};

// The roles as programs: one byte a micro-operation (kind << 4 | arg),
// run by one loop (c1_run) that every warp executes, so that a block's
// four warps share one copy of each step's code.  Each role's program
// is one window's work, read again every window.  Registers: P (a
// point), C (g, then its cached form), E (an entry).
#define C1_END 0      // the window's program ends
#define C1_LOAD 1     // P = ring point arg
#define C1_LOADC 2    // C = ring point arg
#define C1_STORE 3    // ring point arg = P
#define C1_DBL 4      // P = 2 P (arg 1: not in the last window)
#define C1_ADD 5      // P = P + C (C in cached form)
#define C1_CONVC 6    // C = the cached form of C
#define C1_ENTRY 7    // entry arg = the cached form of P, staged and put
#define C1_STAGEC 8   // entry arg = C, staged and put
#define C1_PUT 9      // entry arg as staged (the identity)
#define C1_WAITF 10   // wait at this helper's FULL of channel arg (0 A, 1 B)
#define C1_WAITE 11   // wait at EMPTY of channel arg, from window C1_RING
#define C1_ARRF 12    // arrive at FULL of channel arg (A: every helper's)
#define C1_ARRE 13    // arrive at EMPTY of channel arg, but in the last
                      // C1_RING windows (no one waits there again)
#define C1_OP(kind, arg) ((uint64_t)((kind) << 4 | (arg)))

// a program of up to 16 operations, the first in the low byte
struct C1Prog {
  uint64_t lo, hi;
};
constexpr uint64_t c1_ops(uint64_t a, uint64_t b, uint64_t c, uint64_t d,
                          uint64_t e, uint64_t f, uint64_t g, uint64_t h) {
  return a | b << 8 | c << 16 | d << 24 | e << 32 | f << 40 | g << 48 |
         h << 56;
}

// the chain (8 rounds): g, 2g, 4g, 8g to the slot, then 16g
constexpr C1Prog C1_PROG_CHAIN = {
    c1_ops(C1_OP(C1_WAITE, 0), C1_OP(C1_STORE, C1_G), C1_OP(C1_DBL, 0),
           C1_OP(C1_STORE, C1_A2), C1_OP(C1_DBL, 0), C1_OP(C1_STORE, C1_A4),
           C1_OP(C1_DBL, 0), C1_OP(C1_STORE, C1_A8)),
    c1_ops(C1_OP(C1_ARRF, 0), C1_OP(C1_DBL, 1), C1_OP(C1_END, 0), 0, 0, 0, 0,
           0)};
// helper 1 (7 rounds): c = g's cached form; 3g = 2g + c, 6g = dbl 3g,
// 7g = 6g + c to the slot
constexpr C1Prog C1_PROG_HELP1 = {
    c1_ops(C1_OP(C1_WAITF, 0), C1_OP(C1_LOADC, C1_G), C1_OP(C1_LOAD, C1_A2),
           C1_OP(C1_ARRE, 0), C1_OP(C1_CONVC, 0), C1_OP(C1_ADD, 0),
           C1_OP(C1_WAITE, 1), C1_OP(C1_STORE, C1_A3)),
    c1_ops(C1_OP(C1_DBL, 0), C1_OP(C1_STORE, C1_A6), C1_OP(C1_ADD, 0),
           C1_OP(C1_STORE, C1_A7), C1_OP(C1_ARRF, 1), C1_OP(C1_END, 0), 0,
           0)};
// helper 2 (6 rounds): c again (entry 1); entry 4, 5g = 4g + c, entry 5,
// entry 8
constexpr C1Prog C1_PROG_HELP2 = {
    c1_ops(C1_OP(C1_WAITF, 0), C1_OP(C1_LOADC, C1_G), C1_OP(C1_LOAD, C1_A4),
           C1_OP(C1_CONVC, 0), C1_OP(C1_STAGEC, 1), C1_OP(C1_ENTRY, 4),
           C1_OP(C1_ADD, 0), C1_OP(C1_ENTRY, 5)),
    c1_ops(C1_OP(C1_LOAD, C1_A8), C1_OP(C1_ARRE, 0), C1_OP(C1_ENTRY, 8),
           C1_OP(C1_END, 0), 0, 0, 0, 0)};
// helper 3 (4 rounds): entry 2 (channel A), entries 3, 6, 7 (channel
// B), the identity
constexpr C1Prog C1_PROG_HELP3 = {
    c1_ops(C1_OP(C1_WAITF, 0), C1_OP(C1_LOAD, C1_A2), C1_OP(C1_ARRE, 0),
           C1_OP(C1_ENTRY, 2), C1_OP(C1_WAITF, 1), C1_OP(C1_LOAD, C1_A3),
           C1_OP(C1_ENTRY, 3), C1_OP(C1_LOAD, C1_A6)),
    c1_ops(C1_OP(C1_ENTRY, 6), C1_OP(C1_LOAD, C1_A7), C1_OP(C1_ARRE, 1),
           C1_OP(C1_ENTRY, 7), C1_OP(C1_PUT, 0), C1_OP(C1_END, 0), 0, 0)};

// The staging of an entry may be written again once the warp's put of the
// same entry a window ago has read it: every put but the warp's puts a
// window less one (helper 2: 1, 4, 5, 8; helper 3: 2, 3, 6, 7, 0)
template <class X>
FE_DEV void c1_stage_free(X &x, int role) {
  if (role == C1_HELP2) x.template stage_free<3>();
  else x.template stage_free<4>();
}

// The loop every warp runs: its role's program, once a window.  p: the
// chain's -A (the others load their points).  The steps are S2's
// (ristretto4.cuh), which hold the plain version's field values here:
// sr_add and sr_to_cached compute add-2008-hwcd-3 and the cached form
// with the operands of curve.add_cached and curve.to_cached, sr_dbl
// dbl-2008-hwcd's four products negated (-2P, every coordinate), so the
// chain negates each doubling's output back.
template <class X>
FE_DEV void c1_run(X &x, int role, fe p) {
  const C1Prog prog = role == C1_CHAIN   ? C1_PROG_CHAIN
                      : role == C1_HELP1 ? C1_PROG_HELP1
                      : role == C1_HELP2 ? C1_PROG_HELP2
                                         : C1_PROG_HELP3;
  fe c, e;
  const int t = x.lane();
#pragma unroll
  for (int i = 0; i < 10; i++) {
    c[i] = 0;
    e[i] = (t < 3 && i == 0) ? 1 : 0;   // the identity (1, 1, 1, 0)
  }
  if (role == C1_HELP3) c1_write(c1_stage(x, 0), e);   // staged once
#pragma unroll 1
  for (int win = 0; win < COMB_WINDOWS; win++) {
    const int s = win % C1_RING;
    uint64_t lo = prog.lo, hi = prog.hi;
#pragma unroll 1
    for (;;) {
      const int kind = (int)(lo >> 4) & 15, a = (int)lo & 15;
      lo = lo >> 8 | hi << 56;
      hi >>= 8;
      if (kind == C1_END) break;
      if (kind == C1_LOAD || kind == C1_LOADC) {
        fe q;
        c1_read(q, c1_ring(x, s, a));
#pragma unroll
        for (int i = 0; i < 10; i++) {
          p[i] = kind == C1_LOAD ? q[i] : p[i];
          c[i] = kind == C1_LOADC ? q[i] : c[i];
        }
      } else if (kind == C1_STORE) {
        c1_write(c1_ring(x, s, a), p);
      } else if (kind == C1_DBL) {
        if (a == 0 || win + 1 < COMB_WINDOWS) {
          sr_dbl(x, p);
          fe_neg(p, p);
        }
      } else if (kind == C1_ADD) {
        sr_add(x, p, c);
      } else if (kind == C1_CONVC || kind == C1_ENTRY) {
        fe q;
#pragma unroll
        for (int i = 0; i < 10; i++) q[i] = kind == C1_CONVC ? c[i] : p[i];
        sr_to_cached(x, e, q);
        if (kind == C1_CONVC) {
          fe_copy(c, e);
        } else {
          c1_stage_free(x, role);
          c1_write(c1_stage(x, a), e);
          x.put(win, a);
        }
      } else if (kind == C1_STAGEC) {
        c1_stage_free(x, role);
        c1_write(c1_stage(x, a), c);
        x.put(win, a);
      } else if (kind == C1_PUT) {
        x.put(win, a);
      } else if (kind == C1_ARRF && a == 0) {
#pragma unroll
        for (int h = C1_HELP1; h <= C1_HELP3; h++) x.arrive(C1_FULL_A(h) + s);
      } else if (kind == C1_ARRF) {
        x.arrive(C1_FULL_B + s);
      } else if (kind == C1_WAITF) {
        x.wait((a ? C1_FULL_B : C1_FULL_A(role)) + s);
      } else if (kind == C1_WAITE && win >= C1_RING) {
        x.wait((a ? C1_EMPTY_B : C1_EMPTY_A) + s);
      } else if (kind == C1_ARRE && win + C1_RING < COMB_WINDOWS) {
        x.arrive((a ? C1_EMPTY_B : C1_EMPTY_A) + s);
      }
    }
  }
}

// The one-lane decode of A (Go semantics: a non-canonical y accepted and
// reduced, a non-square and x = 0 with the sign bit rejected): ge_decode's
// steps on the two-round-carry field, its power chain fe_pow22523<Fe2Ops>;
// y, u v^3 and the chain's own values wait out the power in pk's slots,
// the sign bit in a word of its own.  x of the requested sign, y, and the
// verdict, the same field values as ge_decode's.
template <class Park>
FE_DEV bool c1_decode(fe x, fe y, const uint32_t w[8], Park pk) {
  const fe d = FE_D, sqrtm1 = FE_SQRTM1;
  volatile int32_t *flags = pk.park() + 160;
  *flags = (int32_t)((w[7] >> 31) & 1);
  fe u, v, t;
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
  fe_park(pk.park(), y);
  fe_park(pk.park() + 40, x);
  fe_pow22523<Fe2Ops>(t, t, pk, 80);  // (u v^7)^((p-5)/8)
  fe_unpark(x, pk.park() + 40);
  fe_unpark(y, pk.park());
  fe_mul2(x, x, t);          // x = u v^3 (u v^7)^((p-5)/8)
  fe_sq2(u, y);              // u and v again, from y
  fe_mul2(v, u, d);
  u[0] -= 1;
  v[0] += 1;
  fe_sq2(t, x);
  fe_mul2(t, t, v);          // v x^2
  fe nu;
  fe_neg(nu, u);
  const bool ok_plus = fe_eq(t, u), ok_minus = fe_eq(t, nu);
  fe_mul2(t, x, sqrtm1);
  fe_cmov(x, t, ok_minus);
  const bool sign = *flags & 1;
  const bool ok = (ok_plus || ok_minus) && !(fe_iszero(x) && sign);
  fe_neg(t, x);
  fe_cmov(x, t, fe_isneg(x) != sign);
  return ok;
}

// C1's body for one thread of role `role` (C1_CHAIN .. C1_HELP3); load(w)
// fills the 8 little-endian words of the group's key A (read by the
// chain's lanes only, each of which decodes it: the one-lane decode of Go
// semantics, a non-canonical y accepted and reduced, a non-square and
// x = 0 with the sign bit rejected).  Returns the decode verdict on the
// chain's lanes, true on the helpers'.
template <class X, class L>
FE_DEV bool comb_build4(X &x, int role, L load) {
  const int t = x.lane();
  fe p;
  bool ok = true;
  if (role == C1_CHAIN) {
    uint32_t w[8];
    load(w);
    fe y, e;
    ok = c1_decode(p, y, w, C1Park<X>{x});
    // -A = (-x, y, 1, -x y): lane t's coordinate
    fe_neg(e, p);
    fe_mul2(p, e, y);
#pragma unroll
    for (int i = 0; i < 10; i++)
      p[i] = t == 0 ? e[i] : t == 1 ? y[i] : t == 2 ? (i == 0) : p[i];
  } else {
    fe_0(p);
  }
  c1_run(x, role, p);
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
