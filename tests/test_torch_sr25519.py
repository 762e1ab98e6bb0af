"""The port's sr25519 lane held against the JAX package: the ristretto
decode limb for limb (ops/ristretto.py against the JAX decode), the plain
S2 core against the JAX ops/sr25519.verify_batch_device on the tamper
classes of tests/test_sr25519_lane.py plus non-canonical, odd, high-bit and
non-square encodings of A and R, the host stager (native and pure-Python)
against the JAX package's, the port's native lane, the keys, and kernel
S2's body (csrc/ristretto4.cuh over verify4.cuh) compiled with g++ and run
by four host threads that meet at a barrier where the card's lanes
shuffle: its raw verdicts against the plain version's and its one-lane
decode against the plain decode.  The JAX functions run once each, over
all the inputs (module-scoped fixtures).  Kernel S2's own field
(fe_sq2, fe_mul2 of csrc/fe25519_2.cuh) runs at the operand bounds of
every product S2 forms, its four-lane doubling and addition against the
one-lane formulas on coordinates at the 0.503 bound and against the JAX
package's ops/curve.py on curve points, and the one power chain of
csrc/fe25519.cuh in each instantiation (K1's, K4's, S2's parked) against
the JAX package's ops/field.py.  Inputs are made from seeds; the
comparisons are exact."""
from __future__ import annotations

import ctypes
import os
import random
import shutil
import subprocess
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import _edref
from tendermint_tpu.crypto import _ristretto as rr
from tendermint_tpu.crypto import sr25519 as jkeys
from tendermint_tpu.libs import native as jnative
from tendermint_tpu.ops import curve as jC
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import field as jF
from tendermint_tpu.ops import ristretto as jrist
from tendermint_tpu.ops import sr25519 as jsr

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import sr25519 as tkeys
from tendermint_tpu_torch.libs import native as tnative
from tendermint_tpu_torch.ops import cuda_ed25519 as ck
from tendermint_tpu_torch.ops import cuda_sr25519 as cs
from tendermint_tpu_torch.ops import field as F
from tendermint_tpu_torch.ops import ristretto as trist
from tendermint_tpu_torch.ops import sr25519 as tsr

P = F.P
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    tsr.__file__))), "csrc")


@pytest.fixture(autouse=True)
def _cpu():
    T.set_default_device("cpu")
    yield
    T.set_default_device("cuda")


def _le(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _non_square_even():
    return next(_le(s) for s in range(2, 200, 2)
                if rr.Point.decode(_le(s)) is None)


def _encodings():
    """Valid encodings, and ones the decode or the host screens reject:
    non-square, odd, >= p, bit 255 set, zero."""
    rng = random.Random(11)
    enc = [rr.Point.base().mul(rng.randrange(1, rr.L)).encode()
           for _ in range(8)]
    enc += [_non_square_even(), _le(3), _le(P + 1), _le(P + 2),
            _le(2 + (1 << 255)), bytes(32)]
    enc += [bytes(rng.randrange(256) for _ in range(31)) + b"\x11"
            for _ in range(6)]
    return enc


@pytest.fixture(scope="module")
def decodes():
    enc = _encodings()
    rows = np.stack([np.frombuffer(e, np.uint8) for e in enc])
    jl, _ = jed.bytes256_to_limbs(jnp.asarray(rows))
    jpt, jok = jrist.decode(jl)
    tpt, tok = trist.decode(tsr._limbs256(torch.from_numpy(rows.T.copy())))
    return enc, rows, jpt, jok, tpt, tok


def test_ristretto_decode_limb_for_limb(decodes):
    enc, rows, jpt, jok, tpt, tok = decodes
    assert tok.numpy().tolist() == np.asarray(jok).tolist()
    assert np.asarray(jok)[:8].all() and not np.asarray(jok)[8]
    for w, g in zip(jpt, tpt):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    assert trist.bytes_canonical_nonneg(rows).tolist() == \
        jrist.bytes_canonical_nonneg(rows).tolist()


def test_ristretto_eq_limb_for_limb(decodes):
    _, _, jpt, _, tpt, _ = decodes
    perm = list(range(1, len(tpt.x[0]))) + [0]
    jq = jrist.C.Ext(*(v[:, perm] for v in jpt))
    tq = trist.C.Ext(*(v[:, perm] for v in tpt))
    assert trist.eq(tpt, tq).numpy().tolist() == \
        np.asarray(jrist.eq(jpt, jq)).tolist()
    assert trist.eq(tpt, tpt).all()


# ---------------------------------------------------------------------------
# the lane: tamper classes and encodings, the stager, the native lane
# ---------------------------------------------------------------------------

def _lane_inputs():
    n = 24
    minis = [(0xABC0 + i).to_bytes(32, "little") for i in range(n)]
    msgs = [b"sr lane %d" % i for i in range(n)]
    sigs = [bytearray(tkeys.sign(minis[i], msgs[i])) for i in range(n)]
    pubs = [tkeys.PrivKey(minis[i]).pub_key().bytes() for i in range(n)]
    sigs[3][2] ^= 1            # R tampered
    sigs[5][40] ^= 1           # s tampered
    sigs[7][63] &= 0x7F        # marker cleared
    sigs[9][63] = 0xFF         # s >= L after the mask
    msgs[11] = b"tampered"
    pubs[13] = pubs[14]        # wrong key
    enc = _encodings()
    # A and R replaced by the rejected encodings (non-square, odd, >= p,
    # bit 255), and a wrong-length row
    for j, e in enumerate(enc[8:12]):
        pubs[15 + j] = e
        sigs[19 + j][:32] = e
    sigs = [bytes(s) for s in sigs]
    sigs[23] = sigs[23][:63]
    return pubs, msgs, sigs


@pytest.fixture(scope="module")
def lane():
    pubs, msgs, sigs = _lane_inputs()
    want = [jkeys.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    jax_bits = jsr.verify_batch_device(pubs, msgs, sigs)
    torch_bits = tsr.verify_batch_device(pubs, msgs, sigs, device="cpu")
    return pubs, msgs, sigs, want, jax_bits, torch_bits


def test_plain_s2_matches_the_jax_lane(lane):
    _, _, _, want, jax_bits, torch_bits = lane
    assert any(want) and not all(want)
    assert torch_bits.tolist() == np.asarray(jax_bits).tolist() == want


def test_stager_matches_the_jax_package(lane):
    pubs, msgs, sigs, _, _, _ = lane
    ok = [i for i in range(len(pubs)) if len(sigs[i]) == 64]
    pubs, msgs, sigs = ([x[i] for i in ok] for x in (pubs, msgs, sigs))
    t_native = tsr._stage_host(pubs, msgs, sigs)
    j_native = jsr._stage_host(pubs, msgs, sigs)
    for a, b in zip(t_native, j_native):
        assert np.array_equal(a, b)
    # the pure-Python merlin fallback gives the same k and s where ok
    import tendermint_tpu_torch.libs.native as nat
    saved = nat.get_lib
    try:
        nat.get_lib = lambda: None
        k, s, okp = tsr._stage_host(pubs, msgs, sigs)
    finally:
        nat.get_lib = saved
    assert okp.tolist() == t_native[2].tolist()
    assert np.array_equal(k[okp], t_native[0][okp])
    assert np.array_equal(s[okp], t_native[1][okp])


def test_native_sr25519_lane_matches_the_jax_package(lane):
    pubs, msgs, sigs, want, _, _ = lane
    if tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("no C toolchain")
    ok = [i for i in range(len(pubs)) if len(sigs[i]) == 64
          and len(pubs[i]) == 32]
    pubs, msgs, sigs = ([x[i] for i in ok] for x in (pubs, msgs, sigs))
    got = tnative.sr25519_verify(pubs, msgs, sigs).tolist()
    assert got == jnative.sr25519_verify(pubs, msgs, sigs).tolist()
    assert got == [want[i] for i in ok]


def test_keys_sign_verify_address_match():
    for i in range(3):
        mini = (0x77 + i).to_bytes(32, "little")
        tk, jk = tkeys.PrivKey(mini), jkeys.PrivKey(mini)
        m = b"sr key %d" % i
        assert tk.pub_key().bytes() == jk.pub_key().bytes()
        assert tk.pub_key().address() == jk.pub_key().address()
        sig = tk.sign(m)
        assert sig == jk.sign(m)
        assert tk.pub_key().verify_signature(m, sig)
        assert not tk.pub_key().verify_signature(m + b"!", sig)
    from tendermint_tpu_torch import crypto
    assert crypto.pubkey_from_type_name("sr25519", tk.pub_key().bytes()) \
        == tk.pub_key()




# ---------------------------------------------------------------------------
# kernel S2 on the host: its body, decode, steps, field and power chain
# ---------------------------------------------------------------------------

HARNESS = r"""
#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

#include "fe25519.cuh"
#include "fe25519_2.cuh"
#include "verify4.cuh"
#include "ristretto4.cuh"

struct Barrier {
  std::atomic<int> count{0}, gen{0};
  void wait() {
    int g = gen.load();
    if (count.fetch_add(1) == 3) {
      count.store(0);
      gen.fetch_add(1);
    } else {
      while (gen.load() == g) std::this_thread::yield();
    }
  }
};

struct Group {
  Barrier bar;
  int32_t word[4];
  int32_t tab[V4_SIG_WORDS];
};

// the group primitives of ristretto4.cuh: a barrier in place of a shuffle
// (a lane reads lane src & 3, as a shuffle of width 4 does)
struct HostXch {
  int t;
  Group *g;
  int lane() const { return t; }
  int32_t get(int32_t v, int src) {
    g->word[t] = v;
    g->bar.wait();
    int32_t r = g->word[src & 3];
    g->bar.wait();
    return r;
  }
  void sync() { g->bar.wait(); }
  int32_t *scratch() { return g->tab; }
};

// parking slots of a one-lane chain
struct HostPark {
  static constexpr bool parks = true;
  int32_t *buf;
  int32_t *park() const { return buf; }
};

template <class F>
static void on_group(F body) {
  Group g;
  std::vector<std::thread> lanes;
  for (int t = 0; t < 4; t++)
    lanes.emplace_back([&, t] {
      HostXch x{t, &g};
      body(x, t);
    });
  for (auto &th : lanes) th.join();
}

extern "C" {
// rows (n, 128) row-major A | R | s | k little-endian; base 270 ints
void s2_verify(const uint8_t *rows, const int32_t *base, uint8_t *out,
               int n) {
  on_group([&](HostXch &x, int t) {
    for (int i = 0; i < n; i++) {
      const uint8_t *r = rows + 128 * i;
      auto enc = [&](uint32_t w[8]) { memcpy(w, r + (t == 1 ? 32 : 0), 32); };
      auto scalars = [&](uint32_t s[8], uint32_t k[8]) {
        memcpy(s, r + 64, 32);
        memcpy(k, r + 96, 32);
      };
      bool v = verify_sr4(x, enc, scalars, base);
      if (t == 0) out[i] = v;
    }
  });
}
// one-lane decode: ok, and x, y as canonical bytes
void s2_decode(const uint8_t *enc, uint8_t *ok, uint8_t *xo, uint8_t *yo,
               int n) {
  for (int i = 0; i < n; i++) {
    uint32_t w[8];
    memcpy(w, enc + 32 * i, 32);
    fe x, y;
    ok[i] = rist_decode(x, y, w);
    fe_tobytes(xo + 32 * i, x);
    fe_tobytes(yo + 32 * i, y);
  }
}
// op 0: fe_mul2(f, g), op 1: fe_sq2(f); (n, 10) limbs
void s2_field(int op, const int32_t *f, const int32_t *g, int32_t *h,
              int n) {
  for (int i = 0; i < n; i++) {
    if (op == 0)
      fe_mul2(h + 10 * i, f + 10 * i, g + 10 * i);
    else
      fe_sq2(h + 10 * i, f + 10 * i);
  }
}
// one group step on n points: kind 0 sr_dbl(p), 1 sr_add(p, q), 2
// sr_to_cached(p); p, q, out (n, 4, 10) limbs, lane t coordinate t
void s2_step(int kind, const int32_t *p, const int32_t *q, int32_t *out,
             int n) {
  on_group([&](HostXch &x, int t) {
    for (int i = 0; i < n; i++) {
      fe pt, qt, c;
      memcpy(pt, p + 40 * i + 10 * t, 40);
      memcpy(qt, q + 40 * i + 10 * t, 40);
      if (kind == 0) sr_dbl(x, pt);
      if (kind == 1) sr_add(x, pt, qt);
      if (kind == 2) {
        sr_to_cached(x, c, pt);
        memcpy(pt, c, 40);
      }
      memcpy(out + 40 * i + 10 * t, pt, 40);
    }
  });
}
// the power chains: which 0 fe_pow22523 (K1's field), 1 the same parked,
// 2 fe_pow22523<Fe2Ops> (K4's), 3 the same parked (S2's), 4 fe_invert,
// 5 fe_invert<Fe2Ops> (C2's)
void s2_chain(int which, const int32_t *in, int32_t *out, int n) {
  int32_t buf[200];
  HostPark pk{buf};
  for (int i = 0; i < n; i++) {
    const int32_t *z = in + 10 * i;
    int32_t *h = out + 10 * i;
    if (which == 0) fe_pow22523(h, z);
    if (which == 1) fe_pow22523(h, z, pk, 80);
    if (which == 2) fe_pow22523<Fe2Ops>(h, z);
    if (which == 3) fe_pow22523<Fe2Ops>(h, z, pk, 80);
    if (which == 4) fe_invert(h, z);
    if (which == 5) fe_invert<Fe2Ops>(h, z);
  }
}
}
"""

U = [1 << (26 - (k & 1)) for k in range(10)]
W10 = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230]
D_INT = (-121665 * pow(121666, P - 2, P)) % P


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found")
    d = tmp_path_factory.mktemp("s2")
    src, so = d / "s2.cpp", d / "s2.so"
    src.write_text(HARNESS)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-pthread", "-shared",
                        "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.s2_verify.argtypes = [vp, vp, vp, i]
    lib.s2_decode.argtypes = [vp, vp, vp, vp, i]
    lib.s2_field.argtypes = [i, vp, vp, vp, i]
    lib.s2_step.argtypes = [i, vp, vp, vp, i]
    lib.s2_chain.argtypes = [i, vp, vp, i]
    return lib


def _value(limbs) -> int:
    return sum(int(v) << w for v, w in zip(limbs, W10))


def _bounded(limbs, frac: float) -> bool:
    return all(abs(int(v)) <= frac * u for v, u in zip(limbs, U))


def _fe10(v: int):
    """canonical limbs of v mod p (each in [0, U_k))."""
    v %= P
    out = []
    for w, u in zip(W10, U):
        out.append((v >> w) & (u - 1))
    return out


def _fe10c(v: int):
    """limbs of v mod p centred in [-U_k/2, U_k/2) (limb 0 up to 19 more),
    the 0.503-bounded form S2 keeps a point in."""
    h = _fe10(v)
    for k in range(10):
        if h[k] >= U[k] // 2:
            h[k] -= U[k]
            if k < 9:
                h[k + 1] += 1
            else:
                h[0] += 19
    return h


def _arr(rows) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(rows, dtype=np.int32))


def _extreme(bound: float, signs):
    return [s * int(bound * u) for s, u in zip(signs, U)]


def _sign_sets(rng):
    return [[1] * 10, [-1] * 10, [(-1) ** k for k in range(10)],
            [(-1) ** (k + 1) for k in range(10)]] + \
        [[rng.choice((-1, 1)) for _ in range(10)] for _ in range(4)]


def _random_limbs(rng, bound: float):
    return [rng.randint(-int(bound * u), int(bound * u)) for u in U]


# The operand bounds of every product S2 forms (ristretto4.cuh's carry
# note), as (f bound, g bound) of fe_mul2(out, f, g), g the folded side,
# or (f bound, None) for fe_sq2; and the contract's own extremes.
S2_PRODUCTS = {
    "decode": [(0.501, None), (0.5031, None), (0.503, 0.503),
               (1.006, 0.503), (0.503, 1.006), (1.002, 0.503),
               (0.503, 0.5)],
    "doubling": [(1.006, None), (0.503, None), (2.012, 1.509),
                 (1.006, 1.006), (2.012, 1.006), (1.509, 1.006)],
    "addition": [(1.006, 1.0), (0.503, 1.0), (0.503, 0.503),
                 (1.509, 1.006), (1.509, 1.509), (1.006, 1.006)],
    "table-and-check": [(1.006, 1.0), (0.503, 0.503)],
    "contract": [(16 / (32 / 19), 32 / 19), (32 / 19, None)],
}


@pytest.mark.parametrize("where", sorted(S2_PRODUCTS))
def test_s2_field_at_its_operand_bounds(harness, where):
    """fe_mul2 / fe_sq2 (csrc/fe25519_2.cuh) at the operand bounds each S2
    product feeds them, at the limb extremes and on seeded limbs within
    them: the value mod p, and every output 0.503-bounded."""
    rng = random.Random(zlib.crc32(where.encode()))
    for fb, gb in S2_PRODUCTS[where]:
        fs, gs = [], []
        for signs in _sign_sets(rng):
            fs.append(_extreme(fb, signs))
            gs.append(_extreme(gb or 1.0, signs[::-1]))
        for _ in range(24):
            fs.append(_random_limbs(rng, fb))
            gs.append(_random_limbs(rng, gb or 1.0))
        f, g = _arr(fs), _arr(gs)
        h = np.zeros_like(f)
        harness.s2_field(0 if gb else 1, f.ctypes.data, g.ctypes.data,
                         h.ctypes.data, len(f))
        for fi, gi, hi in zip(fs, gs, h):
            want = _value(fi) * _value(gi if gb else fi) % P
            assert _value(hi) % P == want, (where, fb, gb, fi, gi)
            assert _bounded(hi, 0.503), (where, fb, gb, hi.tolist())


def _dbl_formula(p):
    x, y, z, _ = (_value(c) for c in p)
    a, b, c = x * x, y * y, z * z
    e = (x + y) ** 2 - a - b
    g = b - a
    f = g - 2 * c
    h = -a - b
    return [v % P for v in (e * f, g * h, f * g, e * h)]


def _add_formula(p, q):
    x, y, z, t = (_value(c) for c in p)
    q0, q1, q2, q3 = (_value(c) for c in q)
    a, b = (y + x) * q0, (y - x) * q1
    c, d = t * q3, 2 * z * q2
    e, f, g, h = a - b, d - c, d + c, a + b
    return [v % P for v in (e * f, g * h, f * g, e * h)]


def _bound_points(rng, n, bound):
    """n points (4 coordinates of 10 limbs), not on the curve: limbs at
    +-bound U_k in sign patterns, then seeded within the bound."""
    pts = []
    for signs in _sign_sets(rng):
        pts.append([_extreme(bound, signs[j:] + signs[:j]) for j in range(4)])
    while len(pts) < n:
        pts.append([_random_limbs(rng, bound) for _ in range(4)])
    return pts


@pytest.mark.parametrize("kind", ["dbl", "add-cached", "add-niels",
                                  "to-cached"])
def test_s2_steps_match_the_one_lane_formulas(harness, kind):
    """S2's four-lane doubling, addition and cached conversion
    (ristretto4.cuh) on coordinates at the 0.503 bound (and a table
    operand at its own: 0.503 for the cached table of -A, 1 for the
    canonical niels table of B, Z2 = 1): exactly the one-lane formulas of
    dbl-2008-hwcd (times -1, the doubling's documented scale) and
    add-2008-hwcd-3, mod p, and every output limb 0.503-bounded."""
    rng = random.Random(len(kind))
    n = 24
    ps = _bound_points(rng, n, 0.503)
    if kind == "add-niels":
        qs = [[[rng.randrange(u) for u in U] for _ in range(4)]
              for _ in range(n)]
        for q in qs:
            q[2] = [1] + [0] * 9
        for q in qs[:4]:
            q[0], q[1], q[3] = ([u - 1 for u in U] for _ in range(3))
    else:
        qs = _bound_points(rng, n, 0.503)
    out = np.zeros((n, 4, 10), np.int32)
    p_arr, q_arr = _arr(ps), _arr(qs)
    harness.s2_step({"dbl": 0, "to-cached": 2}.get(kind, 1),
                    p_arr.ctypes.data, q_arr.ctypes.data, out.ctypes.data,
                    n)
    for p, q, o in zip(ps, qs, out):
        got = [_value(c) % P for c in o]
        if kind == "dbl":
            want = [-v % P for v in _dbl_formula(p)]
        elif kind == "to-cached":
            x, y, z, t = (_value(c) for c in p)
            want = [(y + x) % P, (y - x) % P, z % P, 2 * D_INT * t % P]
        else:
            want = _add_formula(p, q)
        assert got == want, kind
        assert all(_bounded(c, 0.503) for c in o), (kind, o.tolist())


def _seeded_points(n, seed):
    """n points [r]B as extended (X, Y, Z, T) with a random Z, ints."""
    rng = random.Random(seed)
    pts = []
    for _ in range(n):
        x, y, z, _t = _edref._mul(rng.randrange(1, _edref.L), _edref.BASE)
        zi = pow(z, P - 2, P)
        x, y = x * zi % P, y * zi % P
        w = rng.randrange(1, P)
        pts.append((x * w % P, y * w % P, w, x * y % P * w % P))
    return pts


def test_s2_steps_match_the_jax_curve(harness):
    """On points of the curve: S2's doubling and its addition of a cached
    point and of a niels point, each sign, give the JAX package's
    ops/curve.py dbl / add_cached / madd_niels as points (X1 Z2 = X2 Z1,
    Y1 Z2 = Y2 Z1, T1 Z2 = T2 Z1)."""
    n = 6
    ps, qs = _seeded_points(n, 1), _seeded_points(n, 2)

    def jl(vals):
        return jnp.asarray(jF.batch_int_to_limbs([v % P for v in vals]))

    def ext(pts):
        return jC.Ext(*(jl([p[i] for p in pts]) for i in range(4)))

    def ints(e):
        return [[jF.limbs_to_int(np.asarray(c)[:, i]) % P for c in e]
                for i in range(n)]

    pe, qe = ext(ps), ext(qs)
    qc = jC.to_cached(qe)
    aff = []
    for x, y, z, _t in qs:
        zi = pow(z, P - 2, P)
        ax, ay = x * zi % P, y * zi % P
        aff.append(((ay + ax) % P, (ay - ax) % P, 2 * D_INT * ax * ay % P))
    qn = jC.Niels(*(jl([a[i] for a in aff]) for i in range(3)))
    # (step, points, table operands in the table's limb form, want): the
    # table of -A holds 0.503-bounded limbs, the niels table of B
    # canonical ones
    cases = [(0, ps, ps, _fe10c, ints(jC.dbl(pe)))]
    qc_i = ints(qc)
    for neg in (False, True):
        negs = jnp.full((n,), neg)
        qcn = [[c[1], c[0], c[2], -c[3] % P] if neg else c for c in qc_i]
        qnn = [[a[1], a[0], 1, -a[2] % P] if neg else [a[0], a[1], 1, a[2]]
               for a in aff]
        cases.append((1, ps, qcn, _fe10c,
                       ints(jC.add_cached(pe, jC.cond_neg_cached(qc, negs)))))
        cases.append((1, ps, qnn, _fe10,
                       ints(jC.madd_niels(pe, jC.cond_neg_niels(qn, negs)))))
    for kind, pin, qin, qform, want in cases:
        out = np.zeros((n, 4, 10), np.int32)
        p_arr = _arr([[_fe10c(v) for v in p] for p in pin])
        q_arr = _arr([[qform(v) for v in q] for q in qin])
        harness.s2_step(kind, p_arr.ctypes.data, q_arr.ctypes.data,
                        out.ctypes.data, n)
        for o, w in zip(out, want):
            g = [_value(c) % P for c in o]
            for j in (0, 1, 3):
                assert g[j] * w[2] % P == w[j] * g[2] % P, (kind, j)


@pytest.mark.parametrize("which,name", [
    (0, "K1 fe_sq/fe_mul"), (1, "K1 parked"), (2, "K4 Fe2Ops"),
    (3, "S2 Fe2Ops parked"), (4, "K1 fe_invert"),
    (5, "C2 fe_invert Fe2Ops")])
def test_power_chain_matches_the_jax_field(harness, which, name):
    """The one power chain of fe25519.cuh (fe_chain_250, fe_pow22523,
    templated over the field) in each instantiation the kernels use:
    z^((p-5)/8) (fe_invert, K1's and C2's: z^(p-2)) equals the JAX
    package's ops/field.py pow_p58 (invert) on edge and seeded elements,
    as values mod p, and stays 0.503-bounded."""
    rng = random.Random(which)
    vals = [0, 1, 2, P - 1, P + 1, 19, (1 << 255) - 20] + \
        [rng.randrange(P) for _ in range(25)]
    z = _arr([_fe10(v) for v in vals])
    out = np.zeros_like(z)
    harness.s2_chain(which, z.ctypes.data, out.ctypes.data, len(vals))
    fn = jF.invert if which >= 4 else jF.pow_p58
    jout = np.asarray(jax.jit(fn)(jnp.asarray(jF.batch_int_to_limbs(vals))))
    e = P - 2 if which >= 4 else (P - 5) // 8
    for i, v in enumerate(vals):
        got = _value(out[i]) % P
        assert got == jF.limbs_to_int(jout[:, i]) % P == pow(v, e, P), \
            (name, v)
        assert _bounded(out[i], 0.503 if which in (2, 3, 5) else 0.501)


def test_s2_decode_on_the_host_matches_plain(harness, decodes):
    enc, rows, _, _, tpt, tok = decodes
    n = len(enc)
    rows = np.ascontiguousarray(rows)
    ok = np.zeros(n, np.uint8)
    xo = np.zeros((n, 32), np.uint8)
    yo = np.zeros((n, 32), np.uint8)
    harness.s2_decode(rows.ctypes.data, ok.ctypes.data, xo.ctypes.data,
                      yo.ctypes.data, n)
    assert ok.astype(bool).tolist() == tok.numpy().tolist()
    assert np.array_equal(xo, F.to_bytes(tpt.x).t().numpy().astype(np.uint8))
    assert np.array_equal(yo, F.to_bytes(tpt.y).t().numpy().astype(np.uint8))


def test_s2_body_on_the_host_matches_plain(harness, lane):
    """S2's four-lane body gives the plain version's raw bitmap on every
    lane of the staged rows, screened or not."""
    pubs, msgs, sigs, _, _, _ = lane
    ok = [i for i in range(len(pubs)) if len(sigs[i]) == 64]
    rows, _ = tsr.stage(*([x[i] for i in ok] for x in (pubs, msgs, sigs)))
    plain = cs.verify_packed(torch.from_numpy(
        np.ascontiguousarray(rows.T))).numpy()
    rows = np.ascontiguousarray(rows)
    base = np.ascontiguousarray(cs.base_table_b().reshape(-1))
    out = np.zeros(rows.shape[0], np.uint8)
    harness.s2_verify(rows.ctypes.data, base.ctypes.data, out.ctypes.data,
                      rows.shape[0])
    assert out.astype(bool).tolist() == plain.tolist()
    assert plain.any() and not plain.all()


def test_fe2_selftest_plain_matches_the_host_field(harness):
    """chip_smoke.py holds S2's field on the card against
    cuda_sr25519.fe2_selftest_plain: on the CPU that yardstick equals the
    host build of fe_mul2 / fe_sq2 / the Fe2Ops power chain and Python's
    integers, on edge and seeded elements (bit 255 ignored)."""
    rng = random.Random(14)
    edge = [0, 1, P - 1, P, P + 1, P + 18, (1 << 255) - 1, 2, 19, P - 19]
    va = edge + [rng.randrange(1 << 256) for _ in range(22)]
    vb = [rng.randrange(1 << 256) for _ in va]

    def u8(xs):
        return torch.from_numpy(np.frombuffer(b"".join(
            x.to_bytes(32, "little") for x in xs), np.uint8).reshape(
                -1, 32).copy())
    got = cs.fe2_selftest(u8(va), u8(vb)).numpy()
    assert got.shape == (5, len(va), 32)
    m = (1 << 255) - 1
    fa = _arr([_fe10(a & m) for a in va])
    fb = _arr([_fe10(b & m) for b in vb])
    host = [np.zeros_like(fa) for _ in range(4)]
    harness.s2_field(0, fa.ctypes.data, fb.ctypes.data, host[0].ctypes.data,
                     len(va))
    harness.s2_field(0, fb.ctypes.data, fa.ctypes.data, host[1].ctypes.data,
                     len(va))
    harness.s2_field(1, fa.ctypes.data, fa.ctypes.data, host[2].ctypes.data,
                     len(va))
    harness.s2_chain(2, fa.ctypes.data, host[3].ctypes.data, len(va))
    for i, (a, b) in enumerate(zip(va, vb)):
        a, b = a & m, b & m
        want = [a % P, a * b % P, a * b % P, a * a % P,
                pow(a, (P - 5) // 8, P)]
        plain = [int.from_bytes(got[k, i].tobytes(), "little")
                 for k in range(5)]
        assert plain == want
        assert [_value(h[i]) % P for h in host] == want[1:]


def test_base_table_b_matches_the_jax_reference():
    """The 129 niels multiples jB that S2 reads for s's radix-256 digits
    are (y + x, y - x, 2dxy) of the JAX package's reference multiples, in
    canonical limbs; the first nine are K1's base_table10."""
    tab = cs.base_table_b()
    assert tab.shape == (129, 3, 10)
    assert np.array_equal(tab[:9], ck.base_table10())
    for j in list(range(12)) + [63, 64, 100, 127, 128]:
        x, y, z, _ = _edref._mul(j, _edref.BASE) if j else (0, 1, 1, 0)
        zi = pow(z, P - 2, P)
        x, y = x * zi % P, y * zi % P
        want = [(y + x) % P, (y - x) % P, 2 * D_INT * x * y % P]
        for f in range(3):
            assert tab[j, f].tolist() == _fe10(want[f]), (j, f)


def test_s2_body_on_digit_edges_matches_plain(harness):
    """S2's body on rows whose s has the extreme signed radix-256 digits
    (bytes 0x7F, 0x80, 0xFF, 0x00 in runs, digits -128 and 127) and k the
    extreme radix-16 ones, with R = [s]B - [k]A from the JAX package's
    ristretto reference (so valid) and with R off by B (invalid): the
    plain version's bitmap, which is the reference's."""
    rng = random.Random(256)
    patterns = [b"\x80" * 31, b"\x7f" * 31, b"\xff" * 31, b"\x00" * 31,
                b"\x80\x7f" * 15 + b"\x80", b"\xff\x00" * 15 + b"\xff"]
    rows = []
    for i, pat in enumerate(patterns * 2):
        s = int.from_bytes(pat + b"\x00", "little") % rr.L
        k = (int.from_bytes(bytes([0x88 if i % 2 else 0x77] * 31),
                            "little") + i) % rr.L
        a = rr.Point.base().mul(rng.randrange(1, rr.L))
        r = rr.Point.base().mul(s).add(a.mul(k).neg())
        if i >= len(patterns):
            r = r.add(rr.Point.base())
        rows.append(a.encode() + r.encode() + s.to_bytes(32, "little")
                    + k.to_bytes(32, "little"))
    rows = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, 128).copy()
    plain = cs.verify_packed(torch.from_numpy(
        np.ascontiguousarray(rows.T))).numpy()
    assert plain[:len(patterns)].all() and not plain[len(patterns):].any()
    base = np.ascontiguousarray(cs.base_table_b().reshape(-1))
    out = np.zeros(rows.shape[0], np.uint8)
    harness.s2_verify(rows.ctypes.data, base.ctypes.data, out.ctypes.data,
                      rows.shape[0])
    assert out.astype(bool).tolist() == plain.tolist()
