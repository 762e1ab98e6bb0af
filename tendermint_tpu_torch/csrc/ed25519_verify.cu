// Batched ed25519 verification kernels for Hopper (sm_90a), one signature
// per thread, with a plain C interface for ctypes (ops/cuda_ed25519.py).
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
// All three run verify_one, the counterpart of _verify_tile (:597): decompress
// A (reject a non-square, and x = 0 with the sign bit), build the cached
// table j*(-A) for j = 0..8, run the 64-step joint signed-radix-16 Straus
// ladder [s]B + [k](-A) (4 doublings, a niels add from the constant table
// of B, a cached add from the table of -A), invert Z, encode, and compare
// the 32 bytes with R.  Out: one uint8 verdict per lane.  s >= L is
// screened on the host; the kernel's bit for such a lane is masked there.
//
// What bounds it on the H100: integer multiply-adds.  A signature costs
// 2004 field multiplies and 1549 squares (ladder 64 x (16 sq + 30 mul),
// decompression and inversion ~255 sq each), i.e. 285,595 products
// 32x32 -> 64 (571,190 32-bit multiply-add halves).  Input is 128 bytes
// and output 1 byte per signature, so device memory is never the limit.
//
// What the design does about it: ten 25.5-bit limbs (fe25519.cuh) cut a
// product from the TPU layout's 484 limb products to 100 (55 for a
// square), and the bound argument there lets every curve formula run
// without intermediate carries.  The digits of s and k are formed in the
// kernel from their bytes (t = s + 0x88..8, digit = nibble - 8, as
// _digits_from_limbs :537).  All inputs are public, so the TPU's 9-way
// select (_gather9) becomes a plain indexed load: the table of B from
// shared memory, the per-thread table of -A from local memory (36 field
// elements do not fit in registers).  Loads coalesce: thread b reads
// byte b of each row.  Simple first; tuning is later work.
//
// K3 adds the reduction of a 512-bit digest mod L per lane: three folds of
// 6 x 14 products of 24-bit limbs in int64 (252 products), well under 1%
// of the ladder, and 32 more input bytes per signature (160 in all).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "launch.cuh"

#define THREADS 128

// t = s + 0x88..8 (64 eights); digit j = nibble_j(t) - 8 in [-8, 7]
__device__ __forceinline__ void digit_words(uint32_t t[8],
                                            const uint32_t s[8]) {
  uint64_t carry = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) {
    uint64_t v = (uint64_t)s[q] + 0x88888888u + carry;
    t[q] = (uint32_t)v;
    carry = v >> 32;
  }
}

__device__ __forceinline__ int digit_at(const uint32_t t[8], int pos) {
  return (int)((t[pos >> 3] >> ((pos & 7) * 4)) & 15) - 8;
}

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
  int64_t limbs[24];
#pragma unroll
  for (int i = 0; i < 24; i++) {
    int64_t v = 0;
#pragma unroll
    for (int j = 0; j < 3; j++) {
      int b = 3 * i + j;   // bytes 64.. are zero
      if (b < 64)
        v |= (int64_t)((d[b >> 2] >> (8 * (b & 3))) & 0xFF) << (8 * j);
    }
    limbs[i] = v;
  }
#pragma unroll 1
  for (int pass = 0; pass < 3; pass++) {
    // split at bit 252 (bit 12 of limb 10): value = lo + 2^252 * hi
    int64_t hi[14];
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
      limbs[i] = v & 0xFFFFFF;
      carry = v >> 24;
    }
  }
  // value < M3 + 2^252 < 5L: conditional subtracts
#pragma unroll 1
  for (int r = 0; r < 5; r++) {
    int ge = 1;   // equal -> subtract
    for (int i = 23; i >= 0; i--) {
      int64_t li = i < 11 ? c_l24[i] : 0;
      if (limbs[i] > li) { ge = 1; break; }
      if (limbs[i] < li) { ge = 0; break; }
    }
    if (ge) {
      int64_t carry = 0;
#pragma unroll
      for (int i = 0; i < 24; i++) {
        int64_t v = limbs[i] - (i < 11 ? c_l24[i] : 0) + carry;
        limbs[i] = v & 0xFFFFFF;
        carry = v >> 24;
      }
    }
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

__device__ bool verify_one(const uint32_t pub[8], const uint32_t r[8],
                           const uint32_t s[8], const uint32_t k[8],
                           const ge_niels *base) {
  ge_ext na;
  bool ok = ge_frombytes_neg(na, pub);

  // cached j*(-A), j = 0..8
  ge_cached tab[9];
  fe_1(tab[0].YpX);
  fe_1(tab[0].YmX);
  fe_1(tab[0].Z);
  fe_0(tab[0].T2d);
  ge_to_cached(tab[1], na);
  ge_ext t, u;
  ge_dbl(t, na, true);                 // 2
  ge_to_cached(tab[2], t);
  ge_add_cached(u, t, tab[1]);         // 3
  ge_to_cached(tab[3], u);
  ge_dbl(t, t, true);                  // 4
  ge_to_cached(tab[4], t);
  ge_add_cached(na, t, tab[1]);        // 5
  ge_to_cached(tab[5], na);
  ge_dbl(t, t, true);                  // 8
  ge_to_cached(tab[8], t);
  ge_dbl(u, u, true);                  // 6
  ge_to_cached(tab[6], u);
  ge_add_cached(u, u, tab[1]);         // 7
  ge_to_cached(tab[7], u);

  uint32_t ts[8], tk[8];
  digit_words(ts, s);
  digit_words(tk, k);

  ge_ext p;
  fe_0(p.X);
  fe_1(p.Y);
  fe_1(p.Z);
  fe_0(p.T);
#pragma unroll 1
  for (int pos = 63; pos >= 0; pos--) {
    ge_dbl(p, p, false);
    ge_dbl(p, p, false);
    ge_dbl(p, p, false);
    ge_dbl(p, p, true);
    int db = digit_at(ts, pos);
    ge_niels nb = base[db < 0 ? -db : db];
    ge_niels_cneg(nb, db < 0);
    ge_madd_niels(p, p, nb);
    int da = digit_at(tk, pos);
    ge_cached q = tab[da < 0 ? -da : da];
    ge_cached_cneg(q, da < 0);
    ge_add_cached(p, p, q);
  }

  fe zinv, x, y;
  fe_invert(zinv, p.Z);
  fe_mul(x, p.X, zinv);
  fe_mul(y, p.Y, zinv);
  uint8_t enc[32];
  fe_tobytes(enc, y);
  enc[31] |= (uint8_t)(fe_isneg(x) << 7);
  uint32_t diff = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) {
    uint32_t e = (uint32_t)enc[4 * q] | ((uint32_t)enc[4 * q + 1] << 8) |
                 ((uint32_t)enc[4 * q + 2] << 16) |
                 ((uint32_t)enc[4 * q + 3] << 24);
    diff |= e ^ r[q];
  }
  return ok && diff == 0;
}

// the 9 niels entries j*B (host-computed, 9 x 3 x 10 int32) -> shared
__device__ __forceinline__ void load_base(ge_niels *s_base,
                                          const int32_t *__restrict__ tab) {
  int32_t *dst = reinterpret_cast<int32_t *>(s_base);
  for (int i = threadIdx.x; i < 9 * 3 * 10; i += blockDim.x) dst[i] = tab[i];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
k_verify_packed(const uint8_t *__restrict__ in, int64_t B,
                const int32_t *__restrict__ base_tab,
                uint8_t *__restrict__ out) {
  __shared__ ge_niels s_base[9];
  load_base(s_base, base_tab);
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t pub[8], r[8], s[8], k[8];
  load_lane32(pub, in, B, lane);
  load_lane32(r, in + 32 * B, B, lane);
  load_lane32(s, in + 64 * B, B, lane);
  load_lane32(k, in + 96 * B, B, lane);
  out[lane] = verify_one(pub, r, s, k, s_base);
}

__global__ void __launch_bounds__(THREADS)
k_verify_packed_split(const uint8_t *__restrict__ pub_rows,
                      const uint8_t *__restrict__ rsk, int64_t B,
                      const int32_t *__restrict__ base_tab,
                      uint8_t *__restrict__ out) {
  __shared__ ge_niels s_base[9];
  load_base(s_base, base_tab);
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t pub[8], r[8], s[8], k[8];
  load_lane32(pub, pub_rows, B, lane);
  load_lane32(r, rsk, B, lane);
  load_lane32(s, rsk + 32 * B, B, lane);
  load_lane32(k, rsk + 64 * B, B, lane);
  out[lane] = verify_one(pub, r, s, k, s_base);
}

__global__ void __launch_bounds__(THREADS)
k_verify_staged(const uint8_t *__restrict__ pub_rows,
                const uint8_t *__restrict__ r_rows,
                const uint8_t *__restrict__ s_rows,
                const uint8_t *__restrict__ dig_rows, int64_t B,
                const int32_t *__restrict__ base_tab,
                uint8_t *__restrict__ out) {
  __shared__ ge_niels s_base[9];
  load_base(s_base, base_tab);
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t pub[8], r[8], s[8], dig[16], k[8];
  load_lane32(pub, pub_rows, B, lane);
  load_lane32(r, r_rows, B, lane);
  load_lane32(s, s_rows, B, lane);
  load_lane32(dig, dig_rows, B, lane);
  load_lane32(dig + 8, dig_rows + 32 * B, B, lane);
  sc_reduce512(k, dig);
  out[lane] = verify_one(pub, r, s, k, s_base);
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

extern "C" {

int tm_verify_packed(const void *packed, const void *base_tab, void *out,
                     long long B, int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B > 0)
    k_verify_packed<<<blocks_for(B, THREADS), THREADS, 0,
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
  if (B > 0)
    k_verify_packed_split<<<blocks_for(B, THREADS), THREADS, 0,
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
  if (B > 0)
    k_verify_staged<<<blocks_for(B, THREADS), THREADS, 0,
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

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
