// Kernels of the RLC multi-scalar multiplication (ops/msm.py) for Hopper
// (sm_90a), with a plain C interface for ctypes (ops/cuda_msm.py).
//
// Replaces (tendermint_tpu/ops/):
//   K4  pallas_msm.py:106 decompress_niels_pallas (body
//       _kernel_decompress_niels :57) -> tm_decompress_niels: lane-major
//       (32, m) compressed points -> (m, 3, 10) int32 niels rows of the
//       NEGATED points (y - x, y + x, -2dxy) and (m,) uint8 decode verdicts,
//       with Go fe.SetBytes semantics (non-canonical y accepted and
//       reduced; a non-square, and x = 0 with the sign bit, rejected).
//   K5  pallas_msm.py:188 _bucket_scan_call (body _kernel_bucket_scan :159)
//       -> tm_bucket_scan: the layered bucket fill.  Bucket lane k folds the
//       table rows layer_rows[0..T-1, k] into an extended accumulator by
//       ge_madd_niels -> (K, 4, 10) int32 bucket sums.
//   A1  not a TPU kernel: the XLA window aggregation msm.py:176 _aggregate
//       -> tm_aggregate: per window, sum_b b * S_b by a running suffix sum
//       from the top digit down -> (4, W, 32) canonical encodings of X, Y,
//       Z, T.
// The formulas are those of ops/curve.py (madd_niels, to_cached +
// add_cached), so every coordinate equals the JAX package's mod p, not
// merely the same projective point.
//
// What bounds them on the H100: integer multiply-adds, never bytes.
//   K4: 255 squares + 21 multiplies per point (the square root chain),
//       16,125 products 32x32 -> 64; 153 bytes in and out per point.
//   K5: 7 multiplies (700 products) per madd; the function needs one madd
//       per bucket member, but the layered scan runs K x T of them (the
//       idle steps add the identity row 0).  Bytes: the 120-byte table
//       rows and the 4-byte row indices.
//   A1: 2 x (2^c - 1) x (1 + 8) multiplies per window: tiny, but each
//       window is one dependent chain of ~4,600 multiplies.
//
// What the design does about it: one thread per point (K4), per bucket
// lane (K5) and per window (A1), in the ten 25.5-bit limbs of fe25519.cuh,
// with the carry argument there extended to the madd chain (every step's
// output is carried, so the operand bounds hold for any T).  The TPU's
// sequential t grid axis becomes a loop inside the thread, and the
// accumulator stays in registers for the whole loop.  K5 gathers each
// layer's row from the table itself: the (T, NLIMB, K) layers of the JAX
// layout (2.82 GB at a 131,072-lane batch) are never materialised, and
// the table (262,146 rows x 120 bytes = 31 MB) stays in the 50 MB L2.
// K5 runs in blocks of 32 threads so that its 8,192 (c = 8) or 1,024
// (c = 4) lanes spread over the SMs.  K5 and A1 are bound by one thread's
// latency through its chain, not by the card's throughput; splitting a
// chain across threads is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "launch.cuh"

#define THREADS 128
#define SCAN_THREADS 32
#define NIELS_WORDS 30
#define EXT_WORDS 40

FE_DEV void load_fe(fe h, const int32_t *__restrict__ src) {
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = src[i];
}

FE_DEV void store_fe(int32_t *__restrict__ dst, const fe h) {
#pragma unroll
  for (int i = 0; i < 10; i++) dst[i] = h[i];
}

// the canonical 32-byte encoding of f
FE_DEV void store_bytes(uint8_t *__restrict__ dst, const fe f) {
  uint8_t enc[32];
  fe_tobytes(enc, f);
#pragma unroll
  for (int q = 0; q < 32; q++) dst[q] = enc[q];
}

__global__ void __launch_bounds__(THREADS)
k_decompress_niels(const uint8_t *__restrict__ b_rows, int64_t m,
                   int32_t *__restrict__ niels, uint8_t *__restrict__ ok) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t w[8];
  load_lane32(w, b_rows, m, i);
  ge_ext np;                       // -P: X = -x, Y = y, Z = 1, T = -xy
  bool good = ge_frombytes_neg(np, w);
  const fe d2 = FE_D2;
  fe ypx, ymx, t2d;
  fe_add(ypx, np.Y, np.X);         // y - x
  fe_carry(ypx);
  fe_sub(ymx, np.Y, np.X);         // y + x
  fe_carry(ymx);
  fe_mul(t2d, np.T, d2);           // -2dxy
  int32_t *row = niels + i * NIELS_WORDS;
  store_fe(row, ypx);
  store_fe(row + 10, ymx);
  store_fe(row + 20, t2d);
  ok[i] = good;
}

__global__ void __launch_bounds__(SCAN_THREADS)
k_bucket_scan(const int32_t *__restrict__ table,
              const int32_t *__restrict__ layer_rows, int T, int64_t K,
              int32_t *__restrict__ buckets) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  ge_ext acc;
  fe_0(acc.X);
  fe_1(acc.Y);
  fe_1(acc.Z);
  fe_0(acc.T);
  int32_t row = T > 0 ? __ldg(layer_rows + k) : 0;
#pragma unroll 1
  for (int t = 0; t < T; t++) {
    const int32_t *src = table + (int64_t)row * NIELS_WORDS;
    ge_niels q;
    load_fe(q.YpX, src);
    load_fe(q.YmX, src + 10);
    load_fe(q.T2d, src + 20);
    if (t + 1 < T) row = __ldg(layer_rows + (int64_t)(t + 1) * K + k);
    ge_madd_niels(acc, acc, q);
  }
  int32_t *dst = buckets + k * EXT_WORDS;
  store_fe(dst, acc.X);
  store_fe(dst + 10, acc.Y);
  store_fe(dst + 20, acc.Z);
  store_fe(dst + 30, acc.T);
}

__global__ void __launch_bounds__(SCAN_THREADS)
k_aggregate(const int32_t *__restrict__ buckets, int W, int c,
            uint8_t *__restrict__ out) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  ge_ext suffix, total;
  fe_0(suffix.X);
  fe_1(suffix.Y);
  fe_1(suffix.Z);
  fe_0(suffix.T);
  total = suffix;
  int nb = 1 << c;
  // digit 0 has weight 0 and is skipped
#pragma unroll 1
  for (int b = nb - 1; b >= 1; b--) {
    const int32_t *src = buckets + ((int64_t)w * nb + b) * EXT_WORDS;
    ge_ext s;
    load_fe(s.X, src);
    load_fe(s.Y, src + 10);
    load_fe(s.Z, src + 20);
    load_fe(s.T, src + 30);
    ge_cached q;
    ge_to_cached(q, s);
    ge_add_cached(suffix, suffix, q);
    ge_to_cached(q, suffix);
    ge_add_cached(total, total, q);
  }
  store_bytes(out + (0 * (int64_t)W + w) * 32, total.X);
  store_bytes(out + (1 * (int64_t)W + w) * 32, total.Y);
  store_bytes(out + (2 * (int64_t)W + w) * 32, total.Z);
  store_bytes(out + (3 * (int64_t)W + w) * 32, total.T);
}

extern "C" {

int tm_decompress_niels(const void *b_rows, void *niels, void *ok,
                        long long m, int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (m > 0)
    k_decompress_niels<<<blocks_for(m, THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t *)b_rows, m, (int32_t *)niels, (uint8_t *)ok);
  return (int)cudaGetLastError();
}

int tm_bucket_scan(const void *table, const void *layer_rows, void *buckets,
                   int T, long long K, int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (K > 0)
    k_bucket_scan<<<blocks_for(K, SCAN_THREADS), SCAN_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const int32_t *)table, (const int32_t *)layer_rows, T, K,
        (int32_t *)buckets);
  return (int)cudaGetLastError();
}

int tm_aggregate(const void *buckets, void *out, int W, int c, int device,
                 void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (W > 0)
    k_aggregate<<<blocks_for(W, SCAN_THREADS), SCAN_THREADS, 0,
                  (cudaStream_t)stream>>>(
        (const int32_t *)buckets, W, c, (uint8_t *)out);
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
