// Batched ed25519 verification kernels for Hopper (sm_90a), one signature
// per group of four lanes, with a plain C interface for ctypes
// (ops/cuda_ed25519.py).
//
// Replaces (tendermint_tpu/ops/pallas_ed25519.py):
//   K1  verify_packed_pallas        (:826, body _kernel_packed :748)
//       -> tm_verify_packed: lane-major (128, B) uint8, rows A | R | s | k
//   K2  verify_packed_split_pallas  (:796, body _kernel_packed_split :770)
//       -> tm_verify_packed_split: resident (32, B) pubkey rows plus the
//          per-call (96, B) rows R | s | k
//   K3  verify_staged_pallas        (:853, body _kernel :720)
//       -> tm_verify_staged: (32, B) rows each of A, R and s plus the raw
//          (64, B) SHA-512 digest rows; k = digest mod L and its digits
//          are computed on the device (sc_reduce512 below, the
//          counterpart of _mod_l :488 and _digits_from_limbs :537)
// All three run verify4 (verify4.cuh), the counterpart of _verify_tile
// (:597) and of its verdict: decompress A (Go semantics: a non-canonical
// y accepted and reduced, a non-square rejected, x = 0 with the sign bit
// rejected), build the cached table j(-A), j = 0..8, run the 64-step
// joint signed-radix-16 Straus ladder P = [s]B + [k](-A) (4 doublings, a
// niels add from the constant table of B, a cached add from the table of
// -A), and accept iff P is the point R encodes.  Out: one uint8 verdict
// per signature.  s >= L is screened on the host; the kernel's bit for
// such a lane is masked there.
//
// What bounds it on the H100.  The work is integer multiply-adds: the
// reference's per-signature count (ops/cuda_ed25519.py) is 2004 field
// multiplies and 1549 squares, 571,190 32-bit multiply-add halves.  Input
// is 128 bytes and output 1 byte a signature, so device memory is never
// the limit.  But at the batch sizes of the main path (256 lanes for a
// 150-validator commit, 16,384 a chunk of a large one) the time is the
// length of one signature's dependency chain, not the amount of work: a
// field operation ends in a serial int64 carry chain, and a one-lane
// design gives each signature ~3,550 of them in a row while a launch of
// 16,384 lanes fills one warp per scheduler.
//
// What the design does about it.
// - Four lanes per signature (verify4.cuh): lane t holds coordinate t of
//   (X, Y, Z, T), and a doubling or an addition is two rounds of four
//   independent field operations (the parallel extended-coordinate
//   formulas of Hisil-Wong-Carter-Dawson §4), with the values exchanged
//   between rounds by __shfl_sync of width 4.  A ladder step is 12
//   rounds instead of ~46 dependent operations; a signature's chain is
//   ~1,070 rounds (decode 277, table 22, ladder 768, check 1).
// - Tables in shared memory: per signature the 9 cached multiples of -A,
//   the digit words of s and k and R's two coordinates (1,588 B with one
//   word of padding that staggers the signatures of a warp across
//   banks), and the niels table of B per block: 51,896 B of dynamic
//   shared memory for 32 signatures (each launch raises the kernel's
//   limit past the 48 KB default).  A negative digit reads the swapped
//   coordinate (Y+X <-> Y-X) and negates 2dT on lane 3: no shuffle.
//   __launch_bounds__(128, 4) holds a thread to 128 registers, so 4
//   blocks (16 warps) fit an SM.  The decode is the widest phase: it
//   parks the values that wait out its square-root power in the group's
//   scratch (fe_park), the digits and R's coordinates live there too,
//   and the encoding is loaded only after s and k.  What ptxas still
//   spills is a word or two of the thread's place (4-8 B, an offset kept
//   across the decode's first multiplies), not what bounds the time.
//   chip_smoke.py phase 1 prints ptxas's registers, spills and stack and
//   the blocks per SM of each kernel.
// - R is checked without inverting Z.  In the first, serial phase lane 0
//   decodes A while lane 1 decodes R in the same instruction stream (the
//   decode is written with selects, not branches), strictly: y < p, a
//   square, and not x = 0 with the sign bit.  At the end lane 0 tests
//   X_P = x_R Z_P and lane 1 Y_P = y_R Z_P (one multiply each, then a
//   freeze and compare in fe_eq).  That drops the ~265-operation
//   inversion from every signature's chain, and it is exact: encode(P) =
//   R byte for byte iff R is canonical, decodes, and decodes to P.
//   (=>) encode(P) has y < p in its low 255 bits and the parity of x_P
//   as its sign bit; decoding R then finds y = y_P, x^2 = x_P^2 (P is on
//   the curve, so a root exists) and takes the root with x_P's parity,
//   which is x_P (when x_P = 0 the sign bit is 0, so it is not rejected).
//   (<=) if R is canonical and decodes to (x_R, y_R) = P, then encode(P)
//   = y_R with the parity of x_R, which is R's sign bit (decode chose it),
//   or 0 when x_R = 0 (decode rejected a set sign bit then).  Z_P != 0 for
//   every point the ladder reaches from a valid A (complete formulas, d
//   not a square); an invalid A fails the verdict on its own.  Same
//   verdict as _verify_tile's encode-and-compare, no feature added.
// - The digits of s and k are formed in the kernel from their bytes (t =
//   s + 0x88..8, digit = nibble - 8, as _digits_from_limbs :537); all
//   inputs are public, so the TPU's 9-way select (_gather9) is a plain
//   indexed load from shared memory.
//
// K3 adds the reduction of a 512-bit digest mod L, on every lane of the
// group: three folds of 6 x 14 products of 24-bit limbs in int64 (252
// products), under 1% of the work, and 32 more input bytes a signature
// (160 in all).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "launch.cuh"
#include "verify4.cuh"

#define THREADS 128                 // 32 signatures a block
#define GROUPS (THREADS / 4)
#define MIN_BLOCKS 4                // -> at most 128 registers a thread

// k = digest mod L (K3).  The positive-offset fold of native/staging.c
// mod_l_one, whose constants these are: 2^252 = -C (mod L) with
// C = L - 2^252; each fold computes lo + M - C * hi with M a multiple of
// L large enough to keep the value nonnegative (M1 >= C * 2^260,
// M2 >= C * 2^135, M3 = L), so every carry is a plain floor carry; three
// folds take 512 bits below M3 + 2^252 < 5L, and conditional subtracts of
// L leave the canonical value.  Radix-2^24 limbs in int64.
__constant__ int64_t c_fold_m[3][24] = {
    {0x9c0f01, 0x11e344, 0x47a406, 0x688593, 0xe1ba7, 0xbe65d0, 0xd217f5,
     0xceec73, 0x309a3d, 0x411b7c, 0xd00399, 0xcf5d3e, 0x2631a5, 0xcd6581,
     0xea2f79, 0x4def9d, 0x1, 0, 0, 0, 0, 0, 0, 0},
    {0x5d3f9b, 0xa632a4, 0xd373fe, 0x4f874f, 0x75003c, 0xd9d, 0, 0, 0, 0,
     0xa7000, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0xf5d3ed, 0x631a5c, 0xd65812, 0xa2f79c, 0xdef9de, 0x14, 0, 0, 0, 0,
     0x1000, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
__constant__ int64_t c_fold_c[6] = {0xf5d3ed, 0x631a5c, 0xd65812,
                                    0xa2f79c, 0xdef9de, 0x14};
__constant__ int64_t c_l24[11] = {0xf5d3ed, 0x631a5c, 0xd65812, 0xa2f79c,
                                  0xdef9de, 0x14,     0,        0,
                                  0,        0,        0x1000};

__device__ void sc_reduce512(uint32_t k[8], const uint32_t d[16]) {
  int32_t limbs[24];   // 24-bit limbs; only the fold's columns need int64
#pragma unroll
  for (int i = 0; i < 24; i++) {
    int32_t v = 0;
#pragma unroll
    for (int j = 0; j < 3; j++) {
      int b = 3 * i + j;   // bytes 64.. are zero
      if (b < 64) v |= (int32_t)((d[b >> 2] >> (8 * (b & 3))) & 0xFF) << (8 * j);
    }
    limbs[i] = v;
  }
#pragma unroll 1
  for (int pass = 0; pass < 3; pass++) {
    // split at bit 252 (bit 12 of limb 10): value = lo + 2^252 * hi
    int32_t hi[14];
#pragma unroll
    for (int i = 0; i < 14; i++)
      hi[i] = (limbs[10 + i] >> 12) |
              (i < 13 ? (limbs[11 + i] & 0xFFF) << 12 : 0);
    int64_t acc[24];
#pragma unroll
    for (int i = 0; i < 24; i++)
      acc[i] = (i < 10 ? limbs[i] : i == 10 ? (limbs[10] & 0xFFF) : 0) +
               c_fold_m[pass][i];
#pragma unroll
    for (int i = 0; i < 6; i++)
#pragma unroll
      for (int j = 0; j < 14; j++) acc[i + j] -= c_fold_c[i] * hi[j];
    int64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 24; i++) {
      int64_t v = acc[i] + carry;
      limbs[i] = (int32_t)(v & 0xFFFFFF);
      carry = v >> 24;
    }
  }
  // value < M3 + 2^252 < 5L: conditional subtracts of L, each decided by
  // the sign of its borrow chain (no data-dependent branch or index)
#pragma unroll 1
  for (int r = 0; r < 5; r++) {
    int32_t d2[24], borrow = 0;
#pragma unroll
    for (int i = 0; i < 24; i++) {
      int32_t v = limbs[i] - (i < 11 ? (int32_t)c_l24[i] : 0) + borrow;
      d2[i] = v & 0xFFFFFF;
      borrow = v >> 24;
    }
#pragma unroll
    for (int i = 0; i < 24; i++) limbs[i] = borrow == 0 ? d2[i] : limbs[i];
  }
#pragma unroll
  for (int q = 0; q < 8; q++) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      int b = 4 * q + j;
      w |= (uint32_t)((limbs[b / 3] >> (8 * (b % 3))) & 0xFF) << (8 * j);
    }
    k[q] = w;
  }
}

// dynamic shared memory of a verify block: the table of B, then each
// group's V4_SIG_WORDS (51,896 B: above the 48 KB of static shared memory,
// so each launch raises the kernel's limit first)
extern __shared__ int32_t smem[];
#define VERIFY_SMEM_BYTES ((9 * 3 * 10 + GROUPS * V4_SIG_WORDS) * 4)

// threadIdx.x and blockIdx.x read again where they are used (the
// loads before the verify, the store after it), not kept through it
__device__ __forceinline__ unsigned tid_again() {
  unsigned v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ unsigned ctaid_again() {
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}

// The group primitives of verify4.cuh on the card: a shuffle within the
// 4-lane group, __syncwarp, and the group's slice of shared memory.
// The thread's place is one register, slot = the word offset in smem of
// its own coordinate of table entry 0 (where its decode parks, see
// LanePark); lane() and scratch() are derived from it.  Every lane of the
// warp reaches every call: the kernels never return early, and a ragged
// tail's lanes verify a repeated signature whose verdict is not stored.
struct ShflXch {
  int slot;
  __device__ __forceinline__ explicit ShflXch(unsigned tid)
      : slot(9 * 3 * 10 + (int)(tid >> 2) * V4_SIG_WORDS + 10 * (int)(tid & 3)) {}
  __device__ __forceinline__ int lane() const {
    return ((slot - 9 * 3 * 10) % V4_SIG_WORDS) / 10;
  }
  __device__ __forceinline__ int32_t get(int32_t v, int src) const {
    return __shfl_sync(0xFFFFFFFFu, v, src, 4);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ int32_t *scratch() const {
    return smem + slot - 10 * lane();
  }
};

// the 9 niels entries j*B (host-computed, 9 x 3 x 10 int32) -> shared;
// straight-line, not a loop, so that nothing waits in a spill slot
// across it
__device__ __forceinline__ void load_base(int32_t *s_base,
                                          const int32_t *__restrict__ tab) {
#pragma unroll
  for (int k = 0; k < (9 * 3 * 10 + THREADS - 1) / THREADS; k++) {
    int i = threadIdx.x + THREADS * k;
    if (i < 9 * 3 * 10) s_base[i] = tab[i];
  }
  __syncthreads();
}

// this thread's signature, clamped into [0, B) for the loads (a ragged
// tail's groups verify the last signature again), and the store of the
// verdict, which only lane 0 of a group within [0, B) makes.  Both read
// the thread's index again, so that no register keeps it.
__device__ __forceinline__ int64_t sig_index() {
  return ((int64_t)ctaid_again() * THREADS + tid_again()) >> 2;
}
__device__ __forceinline__ int64_t load_index(int64_t B) {
  int64_t sig = sig_index();
  return sig < B ? sig : B - 1;
}
__device__ __forceinline__ void store_verdict(uint8_t *out, int64_t B,
                                              bool v) {
  int64_t sig = sig_index();
  if (sig < B && (tid_again() & 3) == 0) out[sig] = v;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
k_verify_packed(const uint8_t *__restrict__ in, int64_t B,
                const int32_t *__restrict__ base_tab,
                uint8_t *__restrict__ out) {
  load_base(smem, base_tab);
  ShflXch x(tid_again());
  auto enc = [&](uint32_t w[8]) {
    load_lane32(w, in + (x.lane() == 1 ? 32 * B : 0), B, load_index(B));
  };
  auto scalars = [&](uint32_t s[8], uint32_t k[8]) {
    load_lane32(s, in + 64 * B, B, load_index(B));
    load_lane32(k, in + 96 * B, B, load_index(B));
  };
  store_verdict(out, B, verify4(x, enc, scalars, smem));
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
k_verify_packed_split(const uint8_t *__restrict__ pub_rows,
                      const uint8_t *__restrict__ rsk, int64_t B,
                      const int32_t *__restrict__ base_tab,
                      uint8_t *__restrict__ out) {
  load_base(smem, base_tab);
  ShflXch x(tid_again());
  auto enc = [&](uint32_t w[8]) {
    load_lane32(w, x.lane() == 1 ? rsk : pub_rows, B, load_index(B));
  };
  auto scalars = [&](uint32_t s[8], uint32_t k[8]) {
    load_lane32(s, rsk + 32 * B, B, load_index(B));
    load_lane32(k, rsk + 64 * B, B, load_index(B));
  };
  store_verdict(out, B, verify4(x, enc, scalars, smem));
}

// K3: every lane of the group reduces the digest itself (under 1% of the
// work), so k needs no exchange
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
k_verify_staged(const uint8_t *__restrict__ pub_rows,
                const uint8_t *__restrict__ r_rows,
                const uint8_t *__restrict__ s_rows,
                const uint8_t *__restrict__ dig_rows, int64_t B,
                const int32_t *__restrict__ base_tab,
                uint8_t *__restrict__ out) {
  load_base(smem, base_tab);
  ShflXch x(tid_again());
  auto enc = [&](uint32_t w[8]) {
    load_lane32(w, x.lane() == 1 ? r_rows : pub_rows, B, load_index(B));
  };
  auto scalars = [&](uint32_t s[8], uint32_t k[8]) {
    uint32_t dig[16];
    load_lane32(dig, dig_rows, B, load_index(B));
    load_lane32(dig + 8, dig_rows + 32 * B, B, load_index(B));
    sc_reduce512(k, dig);
    load_lane32(s, s_rows, B, load_index(B));
  };
  store_verdict(out, B, verify4(x, enc, scalars, smem));
}

// Field self-test: a, b are (n, 32) little-endian elements (bit 255 is
// ignored, values >= p allowed); out is (4, n, 32) canonical encodings of
// freeze(a), a*b, a^2 and a^(p-2).
__global__ void __launch_bounds__(THREADS)
k_fe_selftest(const uint8_t *__restrict__ a, const uint8_t *__restrict__ b,
              int64_t n, uint8_t *__restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t wa[8], wb[8];
  load_lane32(wa, a + 32 * i, 1, 0);
  load_lane32(wb, b + 32 * i, 1, 0);
  fe fa, fb, h;
  fe_frombytes(fa, wa);
  fe_frombytes(fb, wb);
  uint8_t enc[32];
  fe_tobytes(enc, fa);
  for (int j = 0; j < 32; j++) out[(0 * n + i) * 32 + j] = enc[j];
  fe_mul(h, fa, fb);
  fe_tobytes(enc, h);
  for (int j = 0; j < 32; j++) out[(1 * n + i) * 32 + j] = enc[j];
  fe_sq(h, fa);
  fe_tobytes(enc, h);
  for (int j = 0; j < 32; j++) out[(2 * n + i) * 32 + j] = enc[j];
  fe_invert(h, fa);
  fe_tobytes(enc, h);
  for (int j = 0; j < 32; j++) out[(3 * n + i) * 32 + j] = enc[j];
}

// a verify kernel may use VERIFY_SMEM_BYTES of dynamic shared memory
template <class K>
static cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute((const void *)kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              VERIFY_SMEM_BYTES);
}

extern "C" {

int tm_verify_packed(const void *packed, const void *base_tab, void *out,
                     long long B, int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B > 0 && (scope.err = allow_smem(k_verify_packed)) != cudaSuccess)
    return (int)scope.err;
  if (B > 0)
    k_verify_packed<<<blocks_for(4 * B, THREADS), THREADS, VERIFY_SMEM_BYTES,
                      (cudaStream_t)stream>>>(
        (const uint8_t *)packed, B, (const int32_t *)base_tab,
        (uint8_t *)out);
  return (int)cudaGetLastError();
}

int tm_verify_packed_split(const void *pub_rows, const void *rsk,
                           const void *base_tab, void *out, long long B,
                           int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B > 0 &&
      (scope.err = allow_smem(k_verify_packed_split)) != cudaSuccess)
    return (int)scope.err;
  if (B > 0)
    k_verify_packed_split<<<blocks_for(4 * B, THREADS), THREADS, VERIFY_SMEM_BYTES,
                            (cudaStream_t)stream>>>(
        (const uint8_t *)pub_rows, (const uint8_t *)rsk, B,
        (const int32_t *)base_tab, (uint8_t *)out);
  return (int)cudaGetLastError();
}

int tm_verify_staged(const void *pub_rows, const void *r_rows,
                     const void *s_rows, const void *dig_rows,
                     const void *base_tab, void *out, long long B,
                     int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B > 0 && (scope.err = allow_smem(k_verify_staged)) != cudaSuccess)
    return (int)scope.err;
  if (B > 0)
    k_verify_staged<<<blocks_for(4 * B, THREADS), THREADS, VERIFY_SMEM_BYTES,
                      (cudaStream_t)stream>>>(
        (const uint8_t *)pub_rows, (const uint8_t *)r_rows,
        (const uint8_t *)s_rows, (const uint8_t *)dig_rows, B,
        (const int32_t *)base_tab, (uint8_t *)out);
  return (int)cudaGetLastError();
}

int tm_fe_selftest(const void *a, const void *b, void *out, long long n,
                   int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (n > 0)
    k_fe_selftest<<<blocks_for(n, THREADS), THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t *)a, (const uint8_t *)b, n, (uint8_t *)out);
  return (int)cudaGetLastError();
}

// blocks of THREADS threads that fit on one SM for verify kernel `which`
// (0 K1, 1 K2, 2 K3), as the occupancy calculator of the runtime says
int tm_verify_occupancy(int which, int *blocks, int *threads) {
  const void *fn = which == 0   ? (const void *)k_verify_packed
                   : which == 1 ? (const void *)k_verify_packed_split
                                : (const void *)k_verify_staged;
  *threads = THREADS;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, VERIFY_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, THREADS, VERIFY_SMEM_BYTES);
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
