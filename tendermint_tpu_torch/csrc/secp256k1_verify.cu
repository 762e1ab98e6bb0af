// Kernel S1: batched secp256k1 BIP-340 Schnorr verification for Hopper
// (sm_90a), one signature per thread, with a plain C interface for ctypes
// (ops/cuda_secp.py).
//
// Replaces the XLA function tendermint_tpu/ops/secp.py:201 _verify_core
// (not a Pallas kernel: the JAX package left it to XLA).  In: lane-major
// (128, B) uint8 rows px | rx | s | e, each 32 bytes big-endian (the host
// stages the range screens x < p, r < p, s < N and the challenge
// e = H_tag(r || x || sha256(m)) mod N, ops/secp.py stage).  Out: one uint8
// verdict per signature, the reference's: lift_x(px) with even y (a
// non-square x^3 + 7 rejects), R' = [s]G + [e](-P) by a 64-step unsigned
// radix-16 Straus ladder, accept iff R' is finite, y(R') is even and
// x(R') = rx.  px and rx are reduced mod p on load, as the plain field
// reduces them, so the raw bitmaps of kernel and plain version agree on
// every lane, screened or not.
//
// What bounds it on the H100.  Integer multiply-adds.  With this file's
// formulas (fe_secp.cuh) a signature costs, in field squarings S and
// multiplies M,
//   lift_x        x^3, the root (253 S + 13 M), its check: 255 S + 14 M
//   table j(-P)   1 dbl (5 S + 2 M) + 13 complete adds (5 S + 11 M):
//                 70 S + 145 M
//   ladder        256 dbl (5 S + 2 M each) + one mixed add (4 S + 7 M)
//                 per nonzero digit of s + one complete add (5 S + 11 M)
//                 per nonzero digit of e: 1,280 S + 512 M
//                 + (4 S + 7 M) n_s + (5 S + 11 M) n_e  (n = 60 on average)
//   affine check  the inversion (255 S + 15 M), 1 S and 3 M: 256 S + 18 M
// = 1,861 S + 689 M + the digits' adds, about 2,400 S + 1,770 M (n = 60).
// A multiply needs 64 32x32->64-bit products plus 8 in the fold, a square
// 36 + 8 (8 diagonal and 28 cross products), each product two 32-bit
// multiply-add halves: 0.47 M halves a signature, 0.057 ms for 2,048
// signatures at 132 SMs x 64 per clock x 1.98 GHz; bound_ms in
// ops/cuda_secp.py counts n_s and n_e from the run's digits.  (fs_sqr is
// still fs_mul(a, a): the kernel spends 72 products on a square where the
// bound counts 44.)  Input is 128 bytes and output 1 byte
// a signature: device memory is never the limit.
//
// What the design does about it.  This first kernel is the simple one: one
// thread verifies one signature, every field element canonical in eight
// 32-bit limbs (a multiply is 64 products, not the TPU's 484).  The
// per-signature table j(-P), j = 1..15 (15 x 96 B), does not fit in
// registers: it lives in shared memory, interleaved by thread (word w of
// entry j of thread t at (24 j + w) * 32 + t, so a warp's reads hit 32
// banks), 48 KB for a block of 32 threads, beside the 1 KB table jG, j =
// 0..15, affine, which the wrapper passes in.  A block is one warp, so a
// 2,048-signature launch spreads over 64 SMs; shared memory then allows 4
// blocks (4 warps) an SM.  The time is one thread's dependency chain
// (~4,170 field multiplies and squarings, each a serial carry chain), not the card's
// multiply-add rate: several signatures per thread or a multi-lane field
// (as K1's four lanes a signature) is the lever for a later change.
// Digits of 0 skip their addition (adding infinity returns the
// accumulator, as the reference's select does); the degenerate additions
// (an infinity operand, P = Q, P = -Q) are branches, taken only for the
// inputs that need them.  chip_smoke.py phase 1 prints registers, spills
// and blocks per SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe_secp.cuh"
#include "launch.cuh"

#define S1_THREADS 32
#define S1_ENTRY 24                       // X, Y, Z of one table entry
#define S1_G_WORDS (16 * 16)              // jG, j = 0..15: x, y
#define S1_SMEM_BYTES ((S1_G_WORDS + 16 * S1_ENTRY * S1_THREADS) * 4)

extern __shared__ uint32_t s1_smem[];

// 32 big-endian bytes of `lane` from 32 lane-major rows -> 8 LE words
__device__ __forceinline__ void load_be32(fs w, const uint8_t *__restrict__ rows,
                                          int64_t B, int64_t lane) {
#pragma unroll
  for (int q = 0; q < 8; q++) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; k++)
      v |= (uint32_t)rows[(int64_t)(31 - 4 * q - k) * B + lane] << (8 * k);
    w[q] = v;
  }
}

__global__ void __launch_bounds__(S1_THREADS)
k_secp_verify(const uint8_t *__restrict__ in, int64_t B,
              const uint32_t *__restrict__ g_tab,
              uint8_t *__restrict__ out) {
  uint32_t *s_g = s1_smem;
  for (int i = threadIdx.x; i < S1_G_WORDS; i += S1_THREADS)
    s_g[i] = g_tab[i];
  __syncthreads();
  const int64_t sig = (int64_t)blockIdx.x * S1_THREADS + threadIdx.x;
  const int64_t lane = sig < B ? sig : B - 1;   // a ragged tail repeats
  auto load = [&](int k, fs w) { load_be32(w, in + 32 * k * B, B, lane); };
  bool ok = secp_verify1(load, s_g, s1_smem + S1_G_WORDS + threadIdx.x,
                         S1_THREADS);
  if (sig < B) out[sig] = ok ? 1 : 0;
}

// Field self-test: a, b are (n, 32) little-endian values below 2^256
// (reduced on load); out is (7, n, 32) little-endian canonical encodings
// of a mod p, a b, a^2, a + b, a - b, a^(p-2), a^((p+1)/4).
__global__ void __launch_bounds__(128)
k_fe_secp_selftest(const uint8_t *__restrict__ a, const uint8_t *__restrict__ b,
              int64_t n, uint8_t *__restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fs fa, fb, r[7];
#pragma unroll
  for (int q = 0; q < 8; q++) {
    uint32_t va = 0, vb = 0;
    for (int k = 0; k < 4; k++) {
      va |= (uint32_t)a[32 * i + 4 * q + k] << (8 * k);
      vb |= (uint32_t)b[32 * i + 4 * q + k] << (8 * k);
    }
    fa[q] = va;
    fb[q] = vb;
  }
  fs_reduce_once(fa);
  fs_reduce_once(fb);
  fs_copy(r[0], fa);
  fs_mul(r[1], fa, fb);
  fs_sqr(r[2], fa);
  fs_add(r[3], fa, fb);
  fs_sub(r[4], fa, fb);
  fs_invert(r[5], fa);
  fs_sqrt(r[6], fa);
  for (int k = 0; k < 7; k++)
    for (int q = 0; q < 32; q++)
      out[(k * n + i) * 32 + q] = (uint8_t)(r[k][q >> 2] >> (8 * (q & 3)));
}

extern "C" {

int tm_secp_verify(const void *rows, const void *g_tab, void *out,
                   long long B, int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      (const void *)k_secp_verify,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S1_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  k_secp_verify<<<blocks_for(B, S1_THREADS), S1_THREADS, S1_SMEM_BYTES,
                  (cudaStream_t)stream>>>(
      (const uint8_t *)rows, B, (const uint32_t *)g_tab, (uint8_t *)out);
  return (int)cudaGetLastError();
}

int tm_fe_secp_selftest(const void *a, const void *b, void *out, long long n,
                   int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (n > 0)
    k_fe_secp_selftest<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)a, (const uint8_t *)b, n, (uint8_t *)out);
  return (int)cudaGetLastError();
}

// blocks of S1_THREADS threads that fit on one SM (the runtime's occupancy
// calculator, with the kernel's dynamic shared memory)
int tm_secp_occupancy(int *blocks, int *threads) {
  *threads = S1_THREADS;
  cudaError_t err = cudaFuncSetAttribute(
      (const void *)k_secp_verify,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S1_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, (const void *)k_secp_verify, S1_THREADS, S1_SMEM_BYTES);
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
