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
// What bounds it on the H100.  Integer multiply-adds, as K1 (same field,
// same ladder): per signature two ristretto decodes (each ~255 squarings
// and ~25 multiplies, the square root's power dominating), the table of
// -A (3 doublings, 4 additions, 9 cached conversions) and the 64-step
// ladder (256 doublings, 128 additions); the check is 4 multiplies where
// K1's reference count has an inversion.  ops/cuda_sr25519.py counts it
// from these formulas the way ops/cuda_ed25519.py counts K1's: about
// 2,020 multiplies and 1,560 squarings of 100 and 55 32x32->64-bit
// products, 0.58 M multiply-add halves a signature.  Input is 128 bytes
// and output 1 byte a signature: device memory is never the limit.  As
// for K1, at the main path's batch sizes the time is one signature's
// dependency chain.
//
// What the design does about it: K1's.  The body (ristretto4.cuh) runs
// on K1's four-lane group with verify4.cuh's primitives, table layout and
// shared memory (the niels table of B per block, each group's cached
// table j(-A), digits and R's coordinates, 51,896 B for 32 signatures),
// and K1's launch bounds (128 threads, at most 128 registers, 4 blocks an
// SM).  The decode runs on all four lanes in one instruction stream: lane
// 1 decodes R while lanes 0, 2 and 3 decode A, each parking s across the
// square-root power.  The check needs no inversion: lanes 0-3 form the
// four cross products of the ristretto equality, one multiply each.  The
// group primitive and the launch helpers are K1's (ed25519_verify.cu),
// shared with S1 through group4.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "group4.cuh"
#include "launch.cuh"
#include "ristretto4.cuh"
#include "verify4.cuh"

#define THREADS G4_THREADS          // 32 signatures a block
#define GROUPS G4_GROUPS
#define MIN_BLOCKS 4                // -> at most 128 registers a thread

// dynamic shared memory of a block (group4.cuh's smem): the table of B,
// then each group's V4_SIG_WORDS
#define VERIFY_SMEM_BYTES ((9 * 3 * 10 + GROUPS * V4_SIG_WORDS) * 4)

// the group primitive of verify4.cuh on the card (K1's)
typedef ShflXch<9 * 3 * 10, V4_SIG_WORDS, 10> Xch;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
k_sr25519_verify(const uint8_t *__restrict__ in, int64_t B,
                 const int32_t *__restrict__ base_tab,
                 uint8_t *__restrict__ out) {
  load_base<9 * 3 * 10>(smem, base_tab);
  Xch x(tid_again());
  auto enc = [&](uint32_t w[8]) {
    load_lane32(w, in + (x.lane() == 1 ? 32 * B : 0), B, load_index(B));
  };
  auto scalars = [&](uint32_t s[8], uint32_t k[8]) {
    load_lane32(s, in + 64 * B, B, load_index(B));
    load_lane32(k, in + 96 * B, B, load_index(B));
  };
  bool v = verify_sr4(x, enc, scalars, smem);
  int64_t sig = sig_index();
  if (sig < B && (tid_again() & 3) == 0) out[sig] = v;
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
