// Kernel S1: batched secp256k1 BIP-340 Schnorr verification for Hopper
// (sm_90a), one signature per group of four lanes, with a plain C
// interface for ctypes (ops/cuda_secp.py).
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
// What bounds it on the H100.  Integer multiply-adds.  With the one-lane
// formulas of secp4.cuh (the rounds do the same products) a signature
// costs, in field squarings S and multiplies M,
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
// 36 + 8 (fs_sqr: 8 diagonal and 28 cross products), each product two
// 32-bit multiply-add halves: 0.47 M halves a signature, 0.057 ms for
// 2,048 signatures at 132 SMs x 64 per clock x 1.98 GHz; bound_ms in
// ops/cuda_secp.py counts n_s and n_e from the run's digits.  Input is
// 128 bytes and output 1 byte a signature: device memory is never the
// limit.  At the main path's batch sizes (64 lanes for a mixed
// 150-validator commit, 2,048 for BASELINE config 5) the card has fewer
// signatures than schedulers, so the time is the length of one
// signature's dependency chain, each field operation a serial carry chain.
//
// What the design does about it (it replaces a first kernel that ran one
// signature a thread, 48 KB of table for a 32-thread block: 4 warps an SM
// and a chain of ~4,170 field operations).
// - One signature on a group of four lanes (secp4.cuh): every lane holds
//   the accumulator, and each doubling or addition runs in rounds of up
//   to four independent products, one a lane, exchanged by __shfl_sync
//   within the group: a doubling is 3 rounds (5 S + 2 M), a mixed add 5
//   (4 S + 7 M), a complete add 5 (5 S + 11 M).  A ladder step is 22
//   rounds instead of 55 operations, and a signature's chain ~2,010
//   rounds: root 266, table 68, ladder ~1,410, inversion and check 273.
//   The square root and the inversion are chains of one element; the
//   four lanes run them alike, a quarter of the lanes' work wasted there
//   (about a quarter of the chain), as in the rounds with fewer than four
//   products (half the lanes idle in a doubling's rounds 1 and 3 and in
//   a mixed add's rounds 1, 2, 4, 5): the idle lanes are the price of the
//   shorter chain.
// - A real square (fs_sqr, 44 products against a multiply's 72): a round
//   is all squares or all multiplies, so two of a doubling's three rounds
//   and every step of the power chains take a square's time.
// - The table j(-P), j = 1..15 (15 Jacobian entries, 1,440 B), lives in
//   the group's shared memory with the words of s and e (1,508 B a
//   signature with one word of padding, so that the eight groups of a
//   warp start on eight banks), beside the 1 KB affine table jG of the
//   block: 49,280 B of dynamic shared memory for 32 signatures, so 4
//   blocks fit an SM; __launch_bounds__(128, 4) holds a thread to 128
//   registers.  That gives 16 warps an SM (4 before), which hides the
//   chain's latency once a launch has more than 132 x 4 x 8 = 4,224
//   signatures.  Nothing is read from device memory inside the ladder.
// - The field (fe_secp.cuh) runs in the card's carry chains (add.cc,
//   madc.hi.cc in asm): a multiply is two accumulators of 64-bit
//   products, a row of each one chain, then the fold; an addition two
//   chains and a select (fs_mul 260 SASS instructions, fs_sqr 172:
//   tools/kernel_report.py), where 64-bit sums in C spend an extra add
//   on every carry.
// - Digits of 0 skip their addition, and the degenerate additions (an
//   infinity operand, P = Q, P = -Q) are branches: every lane of a group
//   holds the same values, so a group takes them whole, and the group's
//   shuffles name only its four lanes (GroupXch), so the eight groups of
//   a warp may diverge.  (Selects in their place would let the
//   shuffles name the whole warp, but keep the input point and the
//   result live through every addition: more registers and selects.)
// What is left at 65,536 signatures is, by estimate from those SASS
// counts, the integer pipes' issue rate: a warp serves 8 signatures, and
// a signature costs about three times the one-lane design's instructions
// (the lanes a round leaves idle, the additions every lane repeats, the
// power chains run alike on four lanes).  chip_smoke.py phase 1 prints
// registers, spills and blocks per SM and fails below 16 warps an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe_secp.cuh"
#include "group4.cuh"
#include "launch.cuh"
#include "secp4.cuh"

#define S1_G_WORDS (16 * 16)              // jG, j = 0..15: x, y
#define S1_SMEM_BYTES ((S1_G_WORDS + G4_GROUPS * S4_SIG_WORDS) * 4)
#define S1_MIN_BLOCKS 4                   // -> at most 128 registers

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

__global__ void __launch_bounds__(G4_THREADS, S1_MIN_BLOCKS)
k_secp_verify(const uint8_t *__restrict__ in, int64_t B,
              const int32_t *__restrict__ g_tab,
              uint8_t *__restrict__ out) {
  load_base<S1_G_WORDS>(smem, g_tab);
  GroupXch<S1_G_WORDS, S4_SIG_WORDS> x(tid_again());
  auto load = [&](int k, fs w) {
    load_be32(w, in + 32 * k * B, B, load_index(B));
  };
  bool ok = secp_verify4(x, load, (const uint32_t *)smem);
  int64_t sig = sig_index();
  if (sig < B && x.lane() == 0) out[sig] = ok ? 1 : 0;
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
  k_secp_verify<<<blocks_for(4 * B, G4_THREADS), G4_THREADS, S1_SMEM_BYTES,
                  (cudaStream_t)stream>>>(
      (const uint8_t *)rows, B, (const int32_t *)g_tab, (uint8_t *)out);
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

// blocks of G4_THREADS threads that fit on one SM (the runtime's occupancy
// calculator, with the kernel's dynamic shared memory)
int tm_secp_occupancy(int *blocks, int *threads) {
  *threads = G4_THREADS;
  cudaError_t err = cudaFuncSetAttribute(
      (const void *)k_secp_verify,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S1_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, (const void *)k_secp_verify, G4_THREADS, S1_SMEM_BYTES);
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
