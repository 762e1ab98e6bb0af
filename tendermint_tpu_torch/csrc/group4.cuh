// The launch scaffolding of the kernels that run one signature on a group
// of four lanes (S1, csrc/secp256k1_verify.cu; S2, csrc/sr25519_verify.cu):
// the block shape, the thread's index read again where it is used, the
// exchange within a group, the copy of a constant table into shared
// memory and the signature a thread serves.
//
// A block is G4_THREADS = 128 threads, 32 groups.  Its dynamic shared
// memory (`smem`) holds a constant table of BASE words first, then each
// group's SIG_WORDS of scratch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define G4_THREADS 128              // 32 signatures a block
#define G4_GROUPS (G4_THREADS / 4)

extern __shared__ int32_t smem[];

// threadIdx.x and blockIdx.x read again where they are used (the loads
// before the verify, the store after it), not kept through it
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

// The group primitive of verify4.cuh on the card: a shuffle within the
// 4-lane group, __syncwarp, and the group's slice of shared memory.  The
// thread's place is one register, slot = the word offset in smem of its
// own LANE_WORDS of the group's scratch; lane() and scratch() are derived
// from it.  The shuffles name the whole warp, so every lane of the warp
// reaches every call: the body never branches on its data.
template <int BASE, int SIG_WORDS, int LANE_WORDS>
struct ShflXch {
  int slot;
  __device__ __forceinline__ explicit ShflXch(unsigned tid)
      : slot(BASE + (int)(tid >> 2) * SIG_WORDS + LANE_WORDS * (int)(tid & 3)) {}
  __device__ __forceinline__ int lane() const {
    return ((slot - BASE) % SIG_WORDS) / LANE_WORDS;
  }
  __device__ __forceinline__ int32_t get(int32_t v, int src) const {
    return __shfl_sync(0xFFFFFFFFu, v, src, 4);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ int32_t *scratch() const {
    return smem + slot - LANE_WORDS * lane();
  }
};

// The same exchange for a body that branches per group (S1's degenerate
// additions and zero digits): the shuffles and the barrier name only the
// group's four lanes, so the eight groups of a warp may take different
// paths.  Whole field elements move at once (get8).
template <int BASE, int SIG_WORDS>
struct GroupXch {
  int t;            // lane in the group
  unsigned mask;    // the group's four lanes of the warp
  int base;         // word offset of the group's scratch in smem
  __device__ __forceinline__ explicit GroupXch(unsigned tid)
      : t((int)(tid & 3)), mask(0xFu << (tid & 28)),
        base(BASE + (int)(tid >> 2) * SIG_WORDS) {}
  __device__ __forceinline__ int lane() const { return t; }
  __device__ __forceinline__ void get8(uint32_t out[8], const uint32_t v[8],
                                       int src) const {
#pragma unroll
    for (int i = 0; i < 8; i++) out[i] = __shfl_sync(mask, v[i], src, 4);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  __device__ __forceinline__ uint32_t *scratch() const {
    return (uint32_t *)smem + base;
  }
};

// WORDS of a constant table (host-computed) -> shared, then a barrier;
// straight-line, not a loop, so that nothing waits in a spill slot
// across it
template <int WORDS>
__device__ __forceinline__ void load_base(int32_t *s_base,
                                          const int32_t *__restrict__ tab) {
#pragma unroll
  for (int k = 0; k < (WORDS + G4_THREADS - 1) / G4_THREADS; k++) {
    int i = threadIdx.x + G4_THREADS * k;
    if (i < WORDS) s_base[i] = tab[i];
  }
  __syncthreads();
}

// this thread's signature, and the same clamped into [0, B) for the loads
// (a ragged tail's groups verify the last signature again; only lane 0 of
// a group within [0, B) stores a verdict).  Both read the thread's index
// again, so that no register keeps it.
__device__ __forceinline__ int64_t sig_index() {
  return ((int64_t)ctaid_again() * G4_THREADS + tid_again()) >> 2;
}
__device__ __forceinline__ int64_t load_index(int64_t B) {
  int64_t sig = sig_index();
  return sig < B ? sig : B - 1;
}
