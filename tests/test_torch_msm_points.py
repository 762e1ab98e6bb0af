"""K5 and A1 of the RLC path (csrc/msm.cu) compared as points, on the CPU.

K5 (the bucket fill) and A1 (the window aggregation) add their points in
another order than the JAX package's `_bucket_scan_xla` and `_aggregate`,
so they give the same points in other projective coordinates.

(a) `cuda_msm.points_mismatch`, the comparison that holds them against
    their plain versions: the same point under another Z, the identity
    in several representatives, a different point, and tuples that are
    not valid extended points.
(b) The per-thread steps of the two kernels (csrc/msm_steps.cuh),
    compiled with the host's C++ compiler and run in the kernels' order
    (segments, partial combine; scan rounds, tree), with a phase boundary
    where a kernel has __syncthreads, against the JAX package's
    `_bucket_scan_xla` and `_aggregate` on seeded inputs: c = 4 and
    c = 8, an empty bucket, a bucket of exactly T members, one past T
    (clamped), lengths that are not a multiple of the segment length,
    torsion points in the table, and several segment counts.  Skipped
    only when no C++ compiler is found.
"""
import functools
import os
import random
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import _edref
from tendermint_tpu.ops import field as JF
from tendermint_tpu.ops import msm as jmsm

from tendermint_tpu_torch.ops import cuda_msm as cm

P = _edref.P
L = _edref.L
D = _edref.D
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    cm.__file__))), "csrc")


def _to_bytes(points):
    """[(X, Y, Z, T) ints] -> (4, N, 32) uint8 encodings of each value
    mod p."""
    return torch.from_numpy(np.array(
        [[list((v % P).to_bytes(32, "little")) for v in col]
         for col in zip(*points)], dtype=np.uint8))


def _affine(p):
    zi = pow(p[2], P - 2, P)
    return p[0] * zi % P, p[1] * zi % P


def _scaled(p, lam):
    x, y = _affine(p)
    return (x * lam % P, y * lam % P, lam, x * y % P * lam % P)


def _seeded_points(n, seed):
    rng = random.Random(seed)
    return [_edref._mul(rng.randrange(1, L), _edref.BASE) for _ in range(n)]


# ---------------------------------------------------------------------------
# (a) points_mismatch
# ---------------------------------------------------------------------------

def test_points_mismatch_same_point_other_z():
    rng = random.Random(1)
    pts = _seeded_points(6, 2)
    a = [_scaled(p, rng.randrange(1, P)) for p in pts]
    b = [_scaled(p, rng.randrange(1, P)) for p in pts]
    assert cm.points_mismatch(_to_bytes(a), _to_bytes(b)) == 0
    # the identity as (0, l, l, 0) for several l, and torsion points
    ident = [(0, lam, lam, 0) for lam in (1, 2, P - 1, 12345)]
    assert cm.points_mismatch(_to_bytes(ident), _to_bytes(ident[::-1])) == 0
    tors = [(0, P - 1, 1, 0), (_edref.SQRT_M1, 0, 1, 0)]
    a = [_scaled(p, 7) for p in tors]
    assert cm.points_mismatch(_to_bytes(a), _to_bytes(tors)) == 0


def test_points_mismatch_catches_a_different_point():
    pts = _seeded_points(5, 3)
    other = _seeded_points(1, 4)[0]
    b = [_scaled(p, 3) for p in pts]
    a = list(b)
    a[2] = _scaled(other, 3)
    assert cm.points_mismatch(_to_bytes(a), _to_bytes(b)) == 1
    # -P shares y and Z with P
    x, y, z, t = b[4]
    a[4] = (P - x, y, z, P - t)
    assert cm.points_mismatch(_to_bytes(a), _to_bytes(b)) == 2


def test_points_mismatch_catches_invalid_tuples():
    """Each tuple against itself, so that only the validity check of the
    first argument can count it."""
    b = [_scaled(p, 11) for p in _seeded_points(4, 5)]
    a = list(b)
    x, y, z, t = b[0]
    a[0] = (x, y, z, (t + 1) % P)                 # T Z != X Y
    a[1] = (0, 0, 0, 0)                           # Z = 0
    x, y, z, _ = b[2]                             # T Z = X Y, off the curve
    y2 = (y + 1) % P
    a[2] = (x, y2, z, x * y2 % P * pow(z, P - 2, P) % P)
    assert cm.points_mismatch(_to_bytes(a), _to_bytes(a)) == 3
    assert cm.points_mismatch(_to_bytes(b), _to_bytes(b)) == 0
    with pytest.raises(ValueError):
        cm.points_mismatch(_to_bytes(a)[:, :2], _to_bytes(b))


# ---------------------------------------------------------------------------
# (b) the kernels' steps on the host
# ---------------------------------------------------------------------------

# stdin, whitespace-separated; field values as 64 hex digits (little-endian
# bytes):
#   K5 <R> <T> <K> <S>, R x 3 niels values, T x K row indices, K lengths
#      -> K lines "X Y Z T"
#   A1 <W> <c>, W * 2^c x 4 extended values -> W lines "X Y Z T"
HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <iostream>
#include <string>
#include <vector>

#include "fe25519.cuh"
#include "msm_steps.cuh"

static void read_fe(int32_t *dst) {
  std::string h;
  std::cin >> h;
  uint32_t w[8];
  for (int q = 0; q < 8; q++) {
    uint32_t v = 0;
    for (int b = 0; b < 4; b++)
      v |= (uint32_t)std::stoul(h.substr(2 * (4 * q + b), 2), nullptr, 16)
           << (8 * b);
    w[q] = v;
  }
  fe f;
  fe_frombytes(f, w);
  fe_carry(f);
  store_fe(dst, f);
}

static void print_point(const ge_ext &p) {
  const int32_t *c[4] = {p.X, p.Y, p.Z, p.T};
  for (int j = 0; j < 4; j++) {
    uint8_t b[32];
    fe_tobytes(b, c[j]);
    for (int i = 0; i < 32; i++) printf("%02x", b[i]);
    printf(j < 3 ? " " : "\n");
  }
}

// k_bucket_scan: blocks of 256 threads, thread = s * (256 / S) + lane
static void k5(int R, int T, long long K, int S) {
  std::vector<int32_t> table((size_t)R * NIELS_WORDS), rows((size_t)T * K),
      seg(K);
  for (int r = 0; r < R; r++)
    for (int j = 0; j < 3; j++) read_fe(&table[(size_t)r * 30 + 10 * j]);
  for (auto &v : rows) std::cin >> v;
  for (auto &v : seg) std::cin >> v;
  const int n = 256, lanes = n / S;
  std::vector<int32_t> sm(EXT_WORDS * n);
  std::vector<ge_ext> acc(n);
  std::vector<int> len(n);
  for (long long blk = 0; blk * lanes < K; blk++) {
    auto lane = [&](int tid) { return blk * lanes + tid % lanes; };
    for (int tid = 0; tid < n; tid++)
      len[tid] = lane(tid) < K ? k5_clamp(seg[lane(tid)], T) : 0;
    for (int tid = 0; tid < n; tid++) {
      // __reduce_max_sync over the thread's warp
      int m = *std::max_element(len.begin() + tid / 32 * 32,
                                len.begin() + tid / 32 * 32 + 32);
      int G = (m + S - 1) / S, lo, hi;
      k5_bounds(len[tid], tid / lanes, G, lo, hi);
      k5_segment(acc[tid], table.data(), rows.data(), K, lane(tid), lo, hi);
      slot_store(sm.data(), n, tid, acc[tid]);
    }
    for (int h = S >> 1; h > 0; h >>= 1)   // __syncthreads after each
      for (int tid = 0; tid < n; tid++)
        if (tid / lanes < h) {
          slot_add(acc[tid], sm.data(), n, tid + h * lanes);
          slot_store(sm.data(), n, tid, acc[tid]);
        }
    for (int tid = 0; tid < lanes && lane(tid) < K; tid++)
      print_point(acc[tid]);
  }
}

// k_aggregate: one block of 2^c threads per window
static void a1(int W, int c) {
  const int nb = 1 << c;
  std::vector<int32_t> buckets((size_t)W * nb * EXT_WORDS);
  for (size_t i = 0; i < buckets.size(); i += 10) read_fe(&buckets[i]);
  std::vector<int32_t> sm(EXT_WORDS * nb);
  std::vector<ge_ext> acc(nb);
  for (int w = 0; w < W; w++) {
    for (int b = 0; b < nb; b++) {
      load_ext(acc[b], &buckets[((size_t)w * nb + b) * EXT_WORDS]);
      slot_store(sm.data(), nb, b, acc[b]);
    }
    for (int d = 1; d < nb; d <<= 1) {
      for (int b = 0; b < nb; b++)
        if (b + d < nb) slot_add(acc[b], sm.data(), nb, b + d);
      // __syncthreads
      for (int b = 0; b < nb; b++) slot_store(sm.data(), nb, b, acc[b]);
    }
    ge_identity(acc[0]);
    for (int h = nb >> 1; h > 0; h >>= 1)
      for (int b = 0; b < h; b++) {
        slot_add(acc[b], sm.data(), nb, b + h);
        slot_store(sm.data(), nb, b, acc[b]);
      }
    print_point(acc[0]);
  }
}

int main() {
  std::string op;
  while (std::cin >> op) {
    if (op == "K5") {
      int R, T, S;
      long long K;
      std::cin >> R >> T >> K >> S;
      k5(R, T, K, S);
    } else {
      int W, c;
      std::cin >> W >> c;
      a1(W, c);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found")
    d = tmp_path_factory.mktemp("msm_steps")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-I", CSRC, "-o", str(exe),
                        str(src)], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr

    def run(text):
        r = subprocess.run([str(exe)], input=text, capture_output=True,
                           text=True, timeout=600)
        assert r.returncode == 0, r.stderr
        lines = r.stdout.split("\n")[:-1]
        return torch.from_numpy(np.array(
            [[list(bytes.fromhex(h)) for h in ln.split()] for ln in lines],
            dtype=np.uint8).transpose(1, 0, 2).copy())
    return run


def _hex(v: int) -> str:
    return (v % P).to_bytes(32, "little").hex()


def _niels_table(n, seed):
    """[(y + x, y - x, 2dxy)]: the identity (row 0, as the MSM table),
    the order-2 and an order-4 point, then n seeded points."""
    pts = [(0, 1), (0, P - 1), (_edref.SQRT_M1, 0)]
    pts += [_affine(p) for p in _seeded_points(n, seed)]
    return [((y + x) % P, (y - x) % P, 2 * D * x * y % P) for x, y in pts]


def _jax_limbs(vals):
    return np.stack([JF.int_to_limbs(v) for v in vals], axis=1)


def _as_bytes22(limbs):
    """JAX limbs (coords, NLIMB, N) -> (coords, N, 32) canonical bytes."""
    return cm.to_bytes22(torch.from_numpy(
        np.asarray(limbs).astype(np.int64)))


def _layer_rows(T, K, R, rng):
    """(T, K) rows and (K,) lengths as the pipeline builds them (row 0
    past a lane's length), with the edge lengths: 0, T, T + 5 (an
    overflowed lane: clamped to T), 1, and lengths on either side of
    multiples of the segment lengths."""
    lens = rng.integers(0, T + 1, K)
    lens[:6] = [0, T, T + 5, 1, T - 1, T // 2 + 1]
    rows = rng.integers(1, R, (T, K)).astype(np.int32)
    rows[np.arange(T)[:, None] >= lens[None, :]] = 0
    return rows, lens.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_fns():
    return (jax.jit(jmsm._bucket_scan_xla, static_argnums=1),
            jax.jit(jmsm._aggregate, static_argnums=(1, 2)))


@pytest.mark.parametrize("c,T", [(4, 37), (8, 23)])
def test_kernel_steps_equal_jax_as_points(harness, c, T):
    """K5's segments and tree, for several segment counts, and A1's scan
    and tree, on the JAX package's bucket sums: the same points as
    `_bucket_scan_xla` and `_aggregate`, each a valid extended point."""
    W = 2
    K = W << c
    rng = np.random.default_rng(c)
    niels = _niels_table(40, c)
    R = len(niels)
    rows, lens = _layer_rows(T, K, R, rng)
    jtab = np.stack([_jax_limbs(col) for col in zip(*niels)])   # (3, N, R)
    layers = tuple(jnp.asarray(np.ascontiguousarray(
        tab[:, rows].transpose(1, 0, 2))) for tab in jtab)     # (T, N, K)
    scan, agg = _jax_fns()
    jacc = scan(layers, K)
    jws = agg(jacc, W, c)
    want_b = _as_bytes22(np.stack([np.asarray(v) for v in jacc]))
    want_w = _as_bytes22(np.stack([np.asarray(v) for v in jws]))

    table_txt = " ".join(_hex(v) for row in niels for v in row)
    body = " ".join(map(str, rows.reshape(-1))) + " " + " ".join(
        map(str, lens))
    segs = sorted({1, 8, cm.scan_segments(K), 256})
    text = "".join(f"K5 {R} {T} {K} {S} {table_txt} {body}\n" for S in segs)
    got = harness(text)
    for i, S in enumerate(segs):
        assert cm.points_mismatch(got[:, i * K:(i + 1) * K], want_b) == 0, S

    pts = want_b.permute(1, 0, 2).reshape(-1, 32)
    a1_txt = f"A1 {W} {c} " + " ".join(bytes(v.tolist()).hex() for v in pts)
    got_w = harness(a1_txt + "\n")
    assert got_w.shape == (4, W, 32)
    assert cm.points_mismatch(got_w, want_w) == 0
    # and the plain version of A1 (the JAX order) on the same sums
    plain = cm.aggregate_plain(cm.limbs22_from_bytes(want_b), W, c)
    assert torch.equal(plain, want_w)


def test_scan_segments_and_seg_len_checks():
    """K5's segment count for the path's shapes (one wave of 65,536
    threads), and the wrapper's checks of seg_len; on CPU tensors the
    plain version runs with or without it (it adds all T rows)."""
    assert (cm.scan_segments(8192), cm.scan_segments(1024)) == (8, 64)
    for K in (1, 32, 1000, 8192, 1 << 20):
        S = cm.scan_segments(K)
        assert S & (S - 1) == 0 and 1 <= S <= 64
        assert K * S <= 65536 or S == 1
    niels = _niels_table(3, 9)
    table = torch.from_numpy(np.stack(
        [_jax_limbs(col) for col in zip(*niels)]).astype(np.int64))
    rows, lens = _layer_rows(5, 16, len(niels), np.random.default_rng(1))
    rows, lens = torch.from_numpy(rows), torch.from_numpy(lens)
    want = cm.bucket_scan(table, rows)
    assert torch.equal(cm.bucket_scan(table, rows, lens), want)
    with pytest.raises(TypeError):
        cm.bucket_scan(table, rows, lens.to(torch.int64))
    with pytest.raises(ValueError):
        cm.bucket_scan(table, rows, lens[:8])
    assert cm.launches["bucket_scan"] == 0
