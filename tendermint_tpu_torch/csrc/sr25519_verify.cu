// Kernel S2: batched sr25519 (schnorrkel) verification for Hopper (sm_90a),
// one signature per group of four lanes, with a plain C interface for
// ctypes (ops/cuda_sr25519.py).
//
// Replaces the XLA function tendermint_tpu/ops/sr25519.py:44 _verify_core
// with ops/ristretto.py:46 decode and :72 eq (not Pallas kernels: the JAX
// package left them to XLA).  In: K1's lane-major (128, B) uint8 row
// layout, rows A | R | s | k little-endian (the host stages the merlin
// challenge k mod L, s with the marker bit cleared, and screens the marker
// bit, s < L and canonical, even encodings: ops/sr25519.py stage).  Out:
// one uint8 verdict per signature, the reference's: A and R decode
// (RFC 9496 §4.3.1), and [s]B + [k](-A) equals R as ristretto points.
//
// What bounds it on the H100.  Integer multiply-adds: per signature two
// ristretto decodes (each ~255 squarings and ~25 multiplies, the square
// root's power dominating), the table of -A (K1's count of 16 squarings
// and 51 multiplies) and the 64-step ladder: 256 doublings and one
// addition of 7 multiplies for each nonzero digit, at most 32 of s
// (radix 256) and 64 of k (radix 16); the check is 4 multiplies.
// ops/cuda_sr25519.py counts it from these formulas the way
// ops/cuda_ed25519.py counts K1's, the additions from the run's own
// digits: about 1,800 multiplies and 1,554 squarings of 100 and 55
// 32x32->64-bit products, 0.53 M multiply-add halves a signature (the
// first design, with 128 additions, counted 0.58 M).  Input is 128 bytes
// and output 1 byte a signature, the table of B 15.5 KB a launch: device
// memory is never the limit.  At the main path's batch sizes (64 and 2,048 lanes: 8 and 256
// warps, at most one a scheduler) the time is one signature's dependency
// chain; at 65,536 lanes (16 warps an SM) the issue of the integer pipes.
// Both fall with the instructions a step.
//
// What the design does about it.  The body (ristretto4.cuh) keeps K1's
// four-lane group (lane t holds coordinate t; a doubling and an addition
// run as two rounds of one product a lane), K1's scratch layout in shared
// memory (each group's cached table j(-A), digits and R's coordinates,
// 50,816 B for 32 signatures) and K1's launch bounds (128 threads, at
// most 128 registers, 4 blocks an SM).
// What it changes, against the first design (K1's own primitives):
//   1. The field is the two-round carry of csrc/fe25519_2.cuh (fe_sq2
//      164 instructions, fe_mul2 211, against fe_sq 221 and fe_mul 261):
//      in the decode's ~250 squarings and every round of the ladder.  Each
//      lane puts fe_mul2's folded 19 on a factor that is at most
//      1.51-bounded, by its layout, with no select (ristretto4.cuh's
//      carry-bound note).
//   2. The decode's power is the one chain of fe25519.cuh (fe_pow22523,
//      templated over the field; K1 runs it on fe_sq/fe_mul, K4 and S2 on
//      Fe2Ops), parked as before.
//   3. A doubling or an addition exchanges 40 limbs, not 60: its first
//      round fetches one coordinate a lane (each lane names its source),
//      and its second round the other three lanes' outputs, never its
//      own, combining them with per-lane coefficients whose uniform
//      columns are compile-time constants.
//   4. s is read in signed radix-256 digits: 32 additions of B, not 64,
//      from the 129 niels multiples of B (15.5 KB), which stay in device
//      memory and are read through L1 (in shared memory they would cost
//      a block an SM); k keeps its radix-16 digits.
// The launch helpers are group4.cuh's, shared with S1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fe25519_2.cuh"
#include "group4.cuh"
#include "launch.cuh"
#include "ristretto4.cuh"
#include "verify4.cuh"

#define THREADS G4_THREADS          // 32 signatures a block
#define GROUPS G4_GROUPS
#define MIN_BLOCKS 4                // -> at most 128 registers a thread

// dynamic shared memory of a block (group4.cuh's smem): each group's
// V4_SIG_WORDS
#define VERIFY_SMEM_BYTES (GROUPS * V4_SIG_WORDS * 4)

// the group primitive of ristretto4.cuh on the card (group4.cuh)
typedef ShflXch<0, V4_SIG_WORDS, 10> Xch;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
k_sr25519_verify(const uint8_t *__restrict__ in, int64_t B,
                 const int32_t *__restrict__ base_tab,
                 uint8_t *__restrict__ out) {
  Xch x(tid_again());
  auto enc = [&](uint32_t w[8]) {
    load_lane32(w, in + (x.lane() == 1 ? 32 * B : 0), B, load_index(B));
  };
  auto scalars = [&](uint32_t s[8], uint32_t k[8]) {
    load_lane32(s, in + 64 * B, B, load_index(B));
    load_lane32(k, in + 96 * B, B, load_index(B));
  };
  bool v = verify_sr4(x, enc, scalars, base_tab);
  int64_t sig = sig_index();
  if (sig < B && (tid_again() & 3) == 0) out[sig] = v;
}

// Field self-test of S2's field: a, b are (n, 32) little-endian elements
// (bit 255 ignored, values >= p allowed, so 1-bounded limbs); out is
// (5, n, 32) canonical encodings of a, fe_mul2(a, b), fe_mul2(b, a),
// fe_sq2(a) and fe_pow22523<Fe2Ops>(a) = a^((p-5)/8).
__global__ void __launch_bounds__(THREADS)
k_fe2_selftest(const uint8_t *__restrict__ a, const uint8_t *__restrict__ b,
               int64_t n, uint8_t *__restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t wa[8], wb[8];
  load_lane32(wa, a + 32 * i, 1, 0);
  load_lane32(wb, b + 32 * i, 1, 0);
  fe fa, fb, h[5];
  fe_frombytes(fa, wa);
  fe_frombytes(fb, wb);
  fe_copy(h[0], fa);
  fe_mul2(h[1], fa, fb);
  fe_mul2(h[2], fb, fa);
  fe_sq2(h[3], fa);
  fe_pow22523<Fe2Ops>(h[4], fa);
  for (int k = 0; k < 5; k++) {
    uint8_t enc[32];
    fe_tobytes(enc, h[k]);
    for (int j = 0; j < 32; j++) out[(k * n + i) * 32 + j] = enc[j];
  }
}

extern "C" {

int tm_sr25519_verify(const void *packed, const void *base_tab, void *out,
                      long long B, int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      (const void *)k_sr25519_verify,
      cudaFuncAttributeMaxDynamicSharedMemorySize, VERIFY_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  k_sr25519_verify<<<blocks_for(4 * B, THREADS), THREADS, VERIFY_SMEM_BYTES,
                     (cudaStream_t)stream>>>(
      (const uint8_t *)packed, B, (const int32_t *)base_tab,
      (uint8_t *)out);
  return (int)cudaGetLastError();
}

int tm_fe2_selftest(const void *a, const void *b, void *out, long long n,
                    int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (n > 0)
    k_fe2_selftest<<<blocks_for(n, THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>(
        (const uint8_t *)a, (const uint8_t *)b, n, (uint8_t *)out);
  return (int)cudaGetLastError();
}

// blocks of THREADS threads that fit on one SM (the runtime's occupancy
// calculator, with the kernel's dynamic shared memory)
int tm_sr25519_occupancy(int *blocks, int *threads) {
  *threads = THREADS;
  cudaError_t err = cudaFuncSetAttribute(
      (const void *)k_sr25519_verify,
      cudaFuncAttributeMaxDynamicSharedMemorySize, VERIFY_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, (const void *)k_sr25519_verify, THREADS, VERIFY_SMEM_BYTES);
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
