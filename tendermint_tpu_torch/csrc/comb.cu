// The fixed-base comb on Hopper (sm_90a): kernel C1 builds the window
// tables of -A for a validator set, kernel C2 verifies signatures against
// them with no doubling.  Plain C interface for ctypes (ops/cuda_comb.py).
//
// Replaces (both XLA functions of tendermint_tpu/ops/ed25519.py, not
// Pallas kernels):
//   C1  comb_build_kernel_impl (:495, with ops/curve.py cached_window
//       :213 and comb_table_scan :239) -> tm_comb_build: (K, 32) uint8
//       pubkeys -> the table [window][digit][key][coord][limb] int32
//       (64, 9, K, 4, 10), entry [i][j] = [j 16^i](-A) in cached form
//       (Y+X, Y-X, Z, 2dT), and the decode verdict per key (uint8)
//   C2  comb_verify_staged (:542, with _gather_comb_cached :511 and
//       _gather_base_comb :528) -> tm_comb_verify: one row of 100 bytes a
//       signature (R | s | k | its table row as a little-endian int32),
//       C1's table and verdicts, and B's comb (64, 9, 3, 10) int32 in
//       niels form -> one uint8 verdict per signature:
//       encode([s]B + [k](-A)) == R, AND A's decode verdict, AND the row
//       within [0, K); the signed radix-16 digits of s and k are formed
//       on the card, as K1 forms them
// The bodies are comb_build4 and comb_verify4 (comb4.cuh).
//
// What bounds them on the H100.  Both are integer multiply-adds, and at
// the main path's sizes the length of a dependency chain.
// - C1 per key: the decode (255 squares, ~20 multiplies on one lane) and
//   64 windows of 5 doublings, 3 additions and 8 cached conversions: 24
//   rounds of one product a lane a window when one group runs them all
//   (the first design: ~1,810 rounds a key, 254 registers, a 1,024-key set
//   in 32 blocks).  Only the window bases are a chain, g -> 2g -> 4g ->
//   8g -> 16g a window, 255 doublings of two rounds; every other multiple
//   and every entry hangs off it.  So a key's least latency is the decode
//   and ~510 rounds, ~790 in all, and the card's multiply rate is far
//   away (a 1,024-key set is 0.05 ms of it).  Its output is 92,160 B a
//   key (94 MB for 1,024 keys, more than the 50 MB L2), written once.
// - C2 per signature: 64 windows of two additions (128 additions of two
//   rounds), the inversion of Z (254 squares, 11 multiplies) and x, y.
//   It reads 64 gathered entries of -A's table (10,240 B), 64 entries of
//   B's comb and its 100-byte row.  At the per-block launch (256 lanes,
//   1,024 threads on one group a signature: under one warp a scheduler)
//   its time is one group's chain, ~530 rounds in the first design, half
//   of them the inversion; at 65,536 lanes (16 warps an SM) the issue of
//   the integer pipes, ~170k instructions a lane in the first design, a
//   third of them the inversion, repeated on every lane.
// What the design does about it.
// - C1: a block's 8 keys over four warps of distinct roles (comb4.cuh):
//   the chain warp decodes and then runs only the 4 doublings a window
//   (8 rounds); three helper warps form 3g, 5g, 6g, 7g and the 9 entries
//   from the points it hands them through a ring of two window slots in
//   shared memory (FULL and EMPTY named barriers a slot, bar.arrive /
//   bar.sync between the warps that share them, a FULL barrier for each
//   helper; no __syncthreads), each in at most 7 rounds a window, so the
//   chain does not wait on them.  A role is a whole warp, so no warp
//   diverges.  1,024 keys are 128 blocks.
// - C1's roles are programs of micro-operations run by one loop, so that
//   the four warps share one copy of each step's code (the roles' steps
//   inlined apart were 37,528 SASS instructions, and the helpers' rounds
//   ~5x the chain's: the instruction cache); the steps are S2's, on the
//   two-round-carry field (fe_sq2 164 instructions against fe_sq's 221),
//   and so is the decode's power chain; each gives the plain version's
//   field values (comb4.cuh's carry note).
// - C1's entries leave in bulk: a warp stages entry j of its 8 keys in
//   shared memory (1,280 B, one contiguous run of the table) and its lane
//   0 writes the run with one cp.async.bulk, where each lane stored 90
//   scalar words a window; a staging area is written again only after
//   cp.async.bulk.wait_group.read.
// - C1's roles hold three points each at most, within 128 registers (4
//   blocks an SM); the decode parks its waiting values in shared memory
//   (the staging area, before any entry is staged), as K1's does.
// - A signature's windows are split over G groups of four lanes in one
//   warp (G = 8 at small launches: a chain of 16 additions, then three
//   levels of a butterfly that adds the partial sums); the wrapper
//   chooses G from the launch's lanes (ops/cuda_comb.py groups_for), G = 1
//   where the card is full and the butterfly would only add work.
// - One inversion a block, not one a signature: each signature's Z goes to
//   shared memory, the block's first warp inverts them one a lane (one
//   instruction stream for up to 32 signatures, where the first design ran
//   one on every lane of every group), and each group reads its Z^-1
//   back; the compare reads the same field values x and y as before, so
//   the verdict is the same, with no product tree and no zero-Z case.
// - S2's addition (ristretto4.cuh sr_add: one exchange in round 1, three
//   in round 2, 40 shuffles where K1's add4 takes 60) on the two-round
//   carry field (fe_mul2, 211 instructions against fe_mul's 261), and the
//   inversion on fe_sq2 (164 against fe_sq's 221).
// - The digits come from s and k on the card (verify4.cuh digit_words),
//   so the host stages 100 bytes a signature in one buffer, not 165 in
//   four.
// - C1's layout lets C2's group read one entry as one 160-byte run
//   (lane t reads its coordinate's 40 B): table index
//   ((win * 9 + j) * K + key) * 40 + 10 * coord + limb.
// - B's comb (69,120 B) stays in device memory and is read through the
//   read-only path (const __restrict__), not copied into shared memory per
//   block: at 256 lanes the copy would cost each block more than the
//   reads it saves, and 69 KB of shared memory a block would hold an SM
//   to three blocks.  A window's 9 entries (1,080 B) are shared by every
//   signature of the launch, so they stay in L1/L2.
// - The running point, the entry being added and the round's products
//   live in registers (C2 within 128 registers, so 4 blocks of 128
//   threads fit an SM); shared memory holds only the digit words and the
//   Zs, 108 B a signature.
// - Ragged tails: every lane of a warp reaches every shuffle and every
//   thread every barrier; a group past the end works on the last key or
//   signature again and stores nothing (C1's last block copies the runs
//   of its keys below K only).  A table row index outside
//   [0, K) reads row 0 and fails.
#include <cuda_runtime.h>
#include <stdint.h>

#include "comb4.cuh"
#include "fe25519.cuh"
#include "launch.cuh"

#define THREADS 128                 // C2: 32 / G signatures a block
#define MIN_BLOCKS_C1 4             // -> at most 128 registers a thread
#define MIN_BLOCKS_C2 4

// C1's exchange (comb4.cuh) on the card: a shuffle within the 4-lane
// group, the block's shared words, the named barriers of the ring, and the
// table's runs written by bulk copies from shared memory (one a staged
// entry, issued by the warp's lane 0 in a bulk group of its own)
struct C1Xch {
  int32_t *sm;
  int32_t *tab;
  int64_t K, key0;
  uint32_t run_bytes;   // 160 B a key of the block within [0, K)
  __device__ __forceinline__ int lane() const { return threadIdx.x & 3; }
  __device__ __forceinline__ int group() const {
    return (threadIdx.x >> 2) & (C1_KEYS - 1);
  }
  __device__ __forceinline__ int32_t get(int32_t v, int src) const {
    return __shfl_sync(0xFFFFFFFFu, v, src, 4);
  }
  __device__ __forceinline__ int32_t *smem() const { return sm; }
  __device__ __forceinline__ void arrive(int bar) const {
    __threadfence_block();
    asm volatile("bar.arrive %0, %1;" ::"r"(bar), "r"(c1_bar_threads(bar))
                 : "memory");
  }
  __device__ __forceinline__ void wait(int bar) const {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(c1_bar_threads(bar))
                 : "memory");
  }
  template <int N>
  __device__ __forceinline__ void stage_free() const {
    if ((threadIdx.x & 31) == 0)
      asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
    __syncwarp();
  }
  __device__ __forceinline__ void put(int win, int j) const {
    // the lanes' staged words, seen by the bulk copy (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      int32_t *dst = tab + (((int64_t)win * COMB_DIGITS + j) * K + key0) * 40;
      uint32_t src =
          (uint32_t)__cvta_generic_to_shared(sm + C1_STAGE + j * C1_PT);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          ::"l"(dst), "r"(src), "r"(run_bytes) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  // the warp's bulk copies complete before its block's shared memory goes
  __device__ __forceinline__ void finish() const {
    if ((threadIdx.x & 31) == 0)
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
};

__device__ __forceinline__ void load_row32(uint32_t w[8],
                                           const uint8_t *__restrict__ row) {
  const uint32_t *r = (const uint32_t *)row;
#pragma unroll
  for (int q = 0; q < 8; q++) w[q] = r[q];
}

// A block: C1_KEYS keys, warp r of the block in role r (comb4.cuh C1_*)
__global__ void __launch_bounds__(C1_THREADS, MIN_BLOCKS_C1)
k_comb_build(const uint8_t *__restrict__ pub, int64_t K,
             int32_t *__restrict__ tab, uint8_t *__restrict__ dec_ok) {
  __shared__ __align__(16) int32_t sm[C1_SMEM_WORDS];
  const int64_t key0 = (int64_t)blockIdx.x * C1_KEYS;
  const int64_t n = K - key0 < C1_KEYS ? K - key0 : C1_KEYS;
  C1Xch x{sm, tab, K, key0, (uint32_t)(160 * n)};
  const int role = (int)(threadIdx.x >> 5);
  const int64_t key = key0 + x.group();
  bool ok = comb_build4(x, role, [&](uint32_t w[8]) {
    load_row32(w, pub + 32 * (key < K ? key : K - 1));
  });
  if (role == C1_CHAIN && key < K && x.lane() == 0) dec_ok[key] = ok;
  x.finish();
}

// C2's exchange (comb4.cuh): a shuffle within the 4-lane group, a
// shuffle at a lane distance within the warp, __syncthreads, and the
// block's shared words
struct C2Xch {
  uint32_t *w;
  __device__ __forceinline__ int lane() const { return threadIdx.x & 3; }
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int threads() const { return THREADS; }
  __device__ __forceinline__ int32_t get(int32_t v, int src) const {
    return __shfl_sync(0xFFFFFFFFu, v, src, 4);
  }
  __device__ __forceinline__ int32_t xor_get(int32_t v, int d) const {
    return __shfl_xor_sync(0xFFFFFFFFu, v, d);
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ uint32_t *words() const { return w; }
};

// rows: B rows of COMB_ROW_WORDS words; log_g: log2 of the groups a
// signature, so a block serves THREADS >> (2 + log_g) signatures
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_C2)
k_comb_verify(const uint32_t *__restrict__ rows, int64_t B, int log_g,
              const int32_t *__restrict__ tab,
              const uint8_t *__restrict__ dec_ok, int64_t K,
              const int32_t *__restrict__ base, uint8_t *__restrict__ out) {
  __shared__ uint32_t words[(THREADS / 4) * C2_SIG_WORDS];
  C2Xch x{words};
  const int64_t sig = (int64_t)blockIdx.x * (THREADS >> (2 + log_g)) +
                      (threadIdx.x >> (2 + log_g));
  const int64_t sl = sig < B ? sig : B - 1;
  const uint32_t *row = rows + COMB_ROW_WORDS * sl;
  int32_t v = (int32_t)row[COMB_ROW_KEY];
  const bool in_range = v >= 0 && v < K;
  v = in_range ? v : 0;
  auto a_entry = [&](int win, int j) -> const int32_t * {
    return tab + (((int64_t)win * COMB_DIGITS + j) * K + v) * 40;
  };
  fe xy;
  bool ok = comb_verify4(x, log_g, row, a_entry, base, xy);
  if (sig < B && (threadIdx.x & ((4 << log_g) - 1)) == 0)
    out[sig] = ok && in_range && dec_ok[v] != 0;
}

extern "C" {

int tm_comb_build(const void *pub, long long K, void *tab, void *dec_ok,
                  int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (K > 0)
    k_comb_build<<<blocks_for(K, C1_KEYS), C1_THREADS, 0,
                   (cudaStream_t)stream>>>(
        (const uint8_t *)pub, K, (int32_t *)tab, (uint8_t *)dec_ok);
  return (int)cudaGetLastError();
}

int tm_comb_verify(const void *rows, long long B, int log_g,
                   const void *tab, const void *dec_ok, long long K,
                   const void *base, void *out, int device, void *stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (log_g < 0 || log_g > 3) return (int)cudaErrorInvalidValue;
  if (B > 0)
    k_comb_verify<<<blocks_for(B << (2 + log_g), THREADS), THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const uint32_t *)rows, B, log_g, (const int32_t *)tab,
        (const uint8_t *)dec_ok, K, (const int32_t *)base, (uint8_t *)out);
  return (int)cudaGetLastError();
}

// blocks of the kernel's threads that fit on one SM for kernel `which`
// (0 C1, 1 C2), as the occupancy calculator of the runtime says
int tm_comb_occupancy(int which, int *blocks, int *threads) {
  const void *fn = which == 0 ? (const void *)k_comb_build
                              : (const void *)k_comb_verify;
  *threads = which == 0 ? C1_THREADS : THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            *threads, 0);
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
