// The per-thread steps of K5 (the bucket fill) and A1 (the window
// aggregation) of csrc/msm.cu, over the field and group law of
// fe25519.cuh.  They hold no CUDA construct beyond MSM_LDG, so a host
// program runs them as plain C++ in the kernels' order, with a phase
// boundary where a kernel has __syncthreads (tests/test_torch_msm_points.py).
//
// A block keeps its points in shared memory limb-major: word j of slot i
// at sm[j * n + i] for n slots, so that neighbouring threads touch
// neighbouring banks.
#pragma once

#include <stdint.h>

#include "fe25519.cuh"

#ifdef __CUDACC__
#define MSM_LDG(p) __ldg(p)
#else
#define MSM_LDG(p) (*(p))
#endif

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

FE_DEV void ge_identity(ge_ext &p) {
  fe_0(p.X);
  fe_1(p.Y);
  fe_1(p.Z);
  fe_0(p.T);
}

// an extended point as 40 consecutive words (X, Y, Z, T)
FE_DEV void load_ext(ge_ext &p, const int32_t *__restrict__ src) {
  load_fe(p.X, src);
  load_fe(p.Y, src + 10);
  load_fe(p.Z, src + 20);
  load_fe(p.T, src + 30);
}

FE_DEV void store_ext(int32_t *__restrict__ dst, const ge_ext &p) {
  store_fe(dst, p.X);
  store_fe(dst + 10, p.Y);
  store_fe(dst + 20, p.Z);
  store_fe(dst + 30, p.T);
}

// slot i = p in cached form (Y + X, Y - X, Z, 2dT): the writer converts,
// so that a reader holds no extended copy of the point it adds
FE_DEV void slot_store(int32_t *sm, int n, int i, const ge_ext &p) {
  ge_cached c;
  ge_to_cached(c, p);
#pragma unroll
  for (int j = 0; j < 10; j++) {
    sm[j * n + i] = c.YpX[j];
    sm[(10 + j) * n + i] = c.YmX[j];
    sm[(20 + j) * n + i] = c.Z[j];
    sm[(30 + j) * n + i] = c.T2d[j];
  }
}

// acc += the point in slot i by add_cached (8 multiplies; with the
// writer's to_cached, 9).  Both points are multiply outputs (carried), so
// the sum is one again (fe25519.cuh, "The MSM chains").
FE_DEV void slot_add(ge_ext &acc, const int32_t *sm, int n, int i) {
  ge_cached c;
#pragma unroll
  for (int j = 0; j < 10; j++) {
    c.YpX[j] = sm[j * n + i];
    c.YmX[j] = sm[(10 + j) * n + i];
    c.Z[j] = sm[(20 + j) * n + i];
    c.T2d[j] = sm[(30 + j) * n + i];
  }
  ge_add_cached(acc, acc, c);
}

// ---------------------------------------------------------------------------
// K5: a bucket lane with len members (clamped to [0, T]: rows past T are
// not the lane's) is cut into segments of G consecutive members; segment
// s covers members [lo, hi), empty once s G >= len.  The kernel takes G
// = ceil(m / S) for S segments a lane, m the longest lane of the warp, so
// that the lanes of a warp read one layer row t at a time.
// ---------------------------------------------------------------------------

FE_DEV int k5_clamp(int len, int T) { return len < 0 ? 0 : len > T ? T : len; }

FE_DEV void k5_bounds(int len, int s, int G, int &lo, int &hi) {
  int64_t a = (int64_t)s * G, e = a + G;
  lo = a < len ? (int)a : len;
  hi = e < len ? (int)e : len;
}

// acc = the sum of the table rows layer_rows[lo .. hi - 1, k] by
// ge_madd_niels from the identity; the next row index is read before
// the current madd
FE_DEV void k5_segment(ge_ext &acc, const int32_t *__restrict__ table,
                       const int32_t *__restrict__ layer_rows, int64_t K,
                       int64_t k, int lo, int hi) {
  ge_identity(acc);
  int32_t row = lo < hi ? MSM_LDG(layer_rows + (int64_t)lo * K + k) : 0;
#pragma unroll 1
  for (int t = lo; t < hi; t++) {
    const int32_t *src = table + (int64_t)row * NIELS_WORDS;
    ge_niels q;
    load_fe(q.YpX, src);
    load_fe(q.YmX, src + 10);
    load_fe(q.T2d, src + 20);
    if (t + 1 < hi) row = MSM_LDG(layer_rows + (int64_t)(t + 1) * K + k);
    ge_madd_niels(acc, acc, q);
  }
}
