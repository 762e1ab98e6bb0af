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
//       -> tm_bucket_scan: the layered bucket fill.  Bucket lane k sums
//       the table rows layer_rows[0 .. seg_len[k] - 1, k] -> (K, 4, 10)
//       int32 bucket sums.  The rows past seg_len[k] are the identity
//       (row 0) in the layered layout and are not read.
//   A1  not a TPU kernel: the XLA window aggregation msm.py:176 _aggregate
//       -> tm_aggregate: per window, sum_b b * S_b -> (4, W, 32) canonical
//       encodings of X, Y, Z, T.
// K4 uses the formulas of ops/curve.py in the same order, so its rows
// equal the JAX package's mod p coordinate by coordinate.  K5 and A1 add
// the same points in another order (below), so their outputs are the
// same POINTS as the JAX package's, in other projective coordinates;
// ops/msm.py's host combine reads only the point.
//
// What bounds them on the H100: integer multiply-adds, never bytes.
//   K4: 255 squares + 21 multiplies per point (the square root chain),
//       16,125 products 32x32 -> 64; 153 bytes in and out per point.
//   K5: 7 multiplies (700 products) per madd, one madd per bucket member
//       (at a 131,072-lane batch, c = 8: ~4.8 M members, 0.40 ms).  Bytes:
//       the 120-byte table rows (31 MB, held in the 50 MB L2) and the
//       4-byte row indices.
//   A1: (2^c - 1) x 2 x 9 multiplies per window, a few microseconds of
//       the card's work.  What sets its time is the dependent depth.
//
// What the design does about it.
//   K4: one thread per point, its square root chain on K4's own square
//       and multiply (two rounds of independent carries), 128 registers,
//       32-thread blocks: csrc/decompress.cuh, whose note gives the design.
//   K5: a direct port of the layered scan runs one thread per bucket lane
//       through all T layers (8,192 threads at c = 8, ~2 warps an SM,
//       every thread T = 1,304 dependent madds of which about half add
//       the identity).  Here each lane's members are cut into S segments
//       of G consecutive members, one thread each, and a segment stops at
//       the lane's own length (seg_len), so no identity row is added.  G =
//       ceil(m / S), m the longest lane of the warp: the lanes of a warp
//       step through the same layers, so a warp reads max(1, S / 8) runs
//       of consecutive layer_rows words at a time, and its time is set
//       by its longest lane (lanes of one window have similar lengths).
//       A block of 256 threads holds 256 / S lanes x S segments, lane
//       fastest.  The S partial sums of a lane are then added by a tree
//       in shared memory (log2 S rounds).  The caller picks S so that K x
//       S is about 65,536 threads, one wave at 2 blocks (16 warps) an SM:
//       S = 8 at c = 8 (~100 madds a thread in the low windows, which also
//       hold the R items) and S = 64 at c = 4 (~8 madds and 6 rounds).
//   A1: one thread per window would run 2 (2^c - 1) dependent additions
//       (32 threads on the card at c = 8).  Here one block per window and
//       one thread per digit: a Hillis-Steele scan in shared memory gives
//       the suffix sums U_b = sum_{b' >= b} S_b' in c rounds, and a tree
//       adds U_1 .. U_{2^c - 1} in c more, since sum_b b S_b =
//       sum_{b >= 1} U_b.  Depth 2c = 16 additions at c = 8.
// Every point stays carried through both (fe25519.cuh, "The MSM chains"):
// each step is a madd or a to_cached + add_cached of carried points.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decompress.cuh"
#include "fe25519.cuh"
#include "launch.cuh"
#include "msm_steps.cuh"

#define K4_THREADS 32
#define SCAN_THREADS 256
#define AGG_MAX_C 8
#define SLOT_BYTES (EXT_WORDS * 4)

// the canonical 32-byte encoding of f
FE_DEV void store_bytes(uint8_t *__restrict__ dst, const fe f) {
  uint8_t enc[32];
  fe_tobytes(enc, f);
#pragma unroll
  for (int q = 0; q < 32; q++) dst[q] = enc[q];
}

// K4 (csrc/decompress.cuh): one point a thread, 32-thread blocks held to
// 128 registers, so that 16 warps fit an SM
__global__ void __launch_bounds__(K4_THREADS, 16)
k_decompress_niels(const uint8_t *__restrict__ b_rows, int64_t m,
                   int32_t *__restrict__ niels, uint8_t *__restrict__ ok) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t w[8];
  load_lane32(w, b_rows, m, i);
  ok[i] = decompress_niels_row(niels + i * NIELS_WORDS, w);
}

// thread (lane kk, segment s) = threadIdx.x = s * (256 / S) + kk
__global__ void __launch_bounds__(SCAN_THREADS, 2)
k_bucket_scan(const int32_t *__restrict__ table,
              const int32_t *__restrict__ layer_rows,
              const int32_t *__restrict__ seg_len, int T, int64_t K, int S,
              int32_t *__restrict__ buckets) {
  extern __shared__ int32_t sm[];   // SCAN_THREADS slots, limb-major
  const int lanes = SCAN_THREADS / S;
  const int s = threadIdx.x / lanes;
  const int64_t k = (int64_t)blockIdx.x * lanes + threadIdx.x % lanes;
  const int len = k < K ? k5_clamp(MSM_LDG(seg_len + k), T) : 0;
  // the S threads of a lane find the same G: every warp that holds one
  // of this warp's lanes holds all of them (all the block's lanes when
  // there are at most 32, else 32 consecutive lanes of one segment)
  const int G = (__reduce_max_sync(0xffffffffu, len) + S - 1) / S;
  int lo, hi;
  k5_bounds(len, s, G, lo, hi);
  ge_ext acc;
  k5_segment(acc, table, layer_rows, K, k, lo, hi);
  slot_store(sm, SCAN_THREADS, threadIdx.x, acc);
  __syncthreads();
  // round h: segment s < h adds segment s + h's sum (slots >= h * lanes
  // are only read, slots below only written)
#pragma unroll 1
  for (int h = S >> 1; h > 0; h >>= 1) {
    if (s < h) {
      slot_add(acc, sm, SCAN_THREADS, threadIdx.x + h * lanes);
      slot_store(sm, SCAN_THREADS, threadIdx.x, acc);
    }
    __syncthreads();
  }
  if (s == 0 && k < K) store_ext(buckets + k * EXT_WORDS, acc);
}

// one block of 2^c threads per window; thread b holds digit b
__global__ void __launch_bounds__(1 << AGG_MAX_C)
k_aggregate(const int32_t *__restrict__ buckets, int W, int c,
            uint8_t *__restrict__ out) {
  extern __shared__ int32_t sm[];   // 2^c slots, limb-major
  const int nb = 1 << c, b = threadIdx.x;
  const int64_t w = blockIdx.x;
  ge_ext acc;
  load_ext(acc, buckets + (w * nb + b) * EXT_WORDS);
  slot_store(sm, nb, b, acc);
  __syncthreads();
  // suffix sums: after the round of distance d, thread b holds
  // S_b + ... + S_{b + 2d - 1}
#pragma unroll 1
  for (int d = 1; d < nb; d <<= 1) {
    if (b + d < nb) slot_add(acc, sm, nb, b + d);
    __syncthreads();
    slot_store(sm, nb, b, acc);
    __syncthreads();
  }
  // sum_{b >= 1} U_b by a tree: U_0, the only sum that holds S_0 (digit
  // 0, weight 0), is left out
  if (b == 0) ge_identity(acc);
#pragma unroll 1
  for (int h = nb >> 1; h > 0; h >>= 1) {
    if (b < h) {
      slot_add(acc, sm, nb, b + h);
      slot_store(sm, nb, b, acc);
    }
    __syncthreads();
  }
  if (b == 0) {
    store_bytes(out + (0 * (int64_t)W + w) * 32, acc.X);
    store_bytes(out + (1 * (int64_t)W + w) * 32, acc.Y);
    store_bytes(out + (2 * (int64_t)W + w) * 32, acc.Z);
    store_bytes(out + (3 * (int64_t)W + w) * 32, acc.T);
  }
}

extern "C" {

int tm_decompress_niels(const void *b_rows, void *niels, void *ok,
                        long long m, int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (m > 0)
    k_decompress_niels<<<blocks_for(m, K4_THREADS), K4_THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t *)b_rows, m, (int32_t *)niels, (uint8_t *)ok);
  return (int)cudaGetLastError();
}

// S: segments a bucket lane, a power of two dividing SCAN_THREADS
int tm_bucket_scan(const void *table, const void *layer_rows,
                   const void *seg_len, void *buckets, int T, long long K,
                   int S, int device, void *stream) {
  if (S < 1 || S > SCAN_THREADS || (S & (S - 1)))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (K > 0)
    k_bucket_scan<<<blocks_for(K, SCAN_THREADS / S), SCAN_THREADS,
                    SCAN_THREADS * SLOT_BYTES, (cudaStream_t)stream>>>(
        (const int32_t *)table, (const int32_t *)layer_rows,
        (const int32_t *)seg_len, T, K, S, (int32_t *)buckets);
  return (int)cudaGetLastError();
}

int tm_aggregate(const void *buckets, void *out, int W, int c, int device,
                 void *stream) {
  if (c < 1 || c > AGG_MAX_C) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (W > 0)
    k_aggregate<<<W, 1 << c, (1 << c) * SLOT_BYTES, (cudaStream_t)stream>>>(
        (const int32_t *)buckets, W, c, (uint8_t *)out);
  return (int)cudaGetLastError();
}

// blocks of how many threads fit on one SM (0 K4, 1 K5, 2 A1 at c = 8),
// as the occupancy calculator of the runtime says
int tm_msm_occupancy(int which, int *blocks, int *threads) {
  const void *fn = which == 0   ? (const void *)k_decompress_niels
                   : which == 1 ? (const void *)k_bucket_scan
                                : (const void *)k_aggregate;
  *threads = which == 0 ? K4_THREADS : which == 1 ? SCAN_THREADS
                                                  : 1 << AGG_MAX_C;
  size_t smem = which == 0 ? 0 : (size_t)*threads * SLOT_BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            *threads, smem);
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
