"""The port's secp256k1 lane held against the JAX package: the plain field
(ops/field_secp.py) limb for limb, the Jacobian dbl and complete add limb
for limb (the JAX functions run eager), the host staging, the keys, the
plain S1 core against the JAX package's host oracles (crypto/secp256k1 and
native.secp_verify) on the adversarial set, the port's native lane, and
kernel S1's four-lane body (csrc/secp4.cuh over csrc/fe_secp.cuh)
compiled with g++ and run on four host threads that meet at a barrier
where the card's lanes shuffle: its round-split doubling and additions
against the JAX group law, its verdicts against the plain version and
the JAX _verify_core (raw bitmaps, degenerate additions included), and
its field, the square included, against the JAX field's values.  Inputs
are made from seeds; the comparisons are exact.  The JAX _verify_core
costs an XLA compile of the 64-step complete-add ladder (tens of seconds
on a CPU), made once for the module; the plain core against it is marked
slow, as the JAX package's own lane test is."""
from __future__ import annotations

import ctypes
import hashlib
import os
import random
import shutil
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tendermint_tpu.crypto import secp256k1 as jkeys
from tendermint_tpu.libs import native as jnative
from tendermint_tpu.ops import field_secp as JF
from tendermint_tpu.ops import secp as jsecp

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import secp256k1 as tkeys
from tendermint_tpu_torch.libs import native as tnative
from tendermint_tpu_torch.ops import cuda_secp
from tendermint_tpu_torch.ops import field_secp as TF
from tendermint_tpu_torch.ops import secp as tsecp
from test_secp_lane import EDGE, _secp_adversarial_vectors

P = TF.P
N = tsecp.N
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    tsecp.__file__))), "csrc")


@pytest.fixture(autouse=True)
def _cpu():
    T.set_default_device("cpu")
    yield
    T.set_default_device("cuda")


def _rand(rng, n):
    return [rng.randrange(P) for _ in range(n)]


def _cols(xs):
    """ints -> ((NLIMB, B) int32 numpy limbs of x mod p)."""
    return np.stack([JF.int_to_limbs(x) for x in xs], axis=1)


# ---------------------------------------------------------------------------
# the plain field, limb for limb
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def field_pairs():
    rng = random.Random(20261017)
    xs = EDGE + _rand(rng, 24)
    ys = list(reversed(xs))
    return _cols(xs), _cols(ys)


@pytest.mark.parametrize("op", [
    "mul", "sqr", "carry", "carry_lazy", "freeze", "eq", "is_zero", "is_odd",
    "mul_small", "select", "invert", "sqrt", "fs_sqr"])
def test_field_ops_limb_for_limb(field_pairs, op, request):
    """The plain field against the JAX field limb for limb; "fs_sqr": S1's
    square (csrc/fe_secp.cuh under g++) against the JAX square's values and
    fs_mul(a, a)."""
    a, b = field_pairs
    if op == "fs_sqr":
        lib = request.getfixturevalue("harness")
        n = a.shape[1]
        vals = [JF.limbs_to_int(a[:, i]) for i in range(n)]
        enc = np.ascontiguousarray(np.stack([np.frombuffer(
            v.to_bytes(32, "little"), np.uint8) for v in vals]))
        out = np.zeros((8, n, 32), np.uint8)
        lib.s1_field(enc.ctypes.data, enc.ctypes.data, out.ctypes.data, n)
        want = np.asarray(JF.freeze(JF.sqr(jnp.asarray(a))))
        assert [int.from_bytes(out[2, i].tobytes(), "little")
                for i in range(n)] == [JF.limbs_to_int(want[:, i])
                                       for i in range(n)]
        assert np.array_equal(out[2], out[7])
        return
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a.astype(np.int64)), \
        torch.from_numpy(b.astype(np.int64))
    cond = np.arange(a.shape[1]) % 3 == 0
    calls = {
        "mul": (lambda m, x, y: m.mul(x, y)),
        "sqr": (lambda m, x, y: m.sqr(x)),
        "carry": (lambda m, x, y: m.carry(x * 37 - y * 5)),
        "carry_lazy": (lambda m, x, y: m.carry_lazy(x - y)),
        "freeze": (lambda m, x, y: m.freeze(x * 3 - y)),
        "eq": (lambda m, x, y: m.eq(x, y) & m.eq(m.mul(x, y), m.mul(y, x))),
        "is_zero": (lambda m, x, y: m.is_zero(m.sub(x, y))),
        "is_odd": (lambda m, x, y: m.is_odd(x)),
        "mul_small": (lambda m, x, y: m.mul_small(x, 977)),
        "invert": (lambda m, x, y: m.invert(x)),
        "sqrt": (lambda m, x, y: m.sqrt(x)),
    }
    if op == "select":
        want = np.asarray(JF.select(jnp.asarray(cond), ja, jb))
        got = TF.select(torch.from_numpy(cond), ta, tb).numpy()
    else:
        want = np.asarray(calls[op](JF, ja, jb))
        got = calls[op](TF, ta, tb).numpy()
    assert np.array_equal(got, want.astype(got.dtype))


# ---------------------------------------------------------------------------
# the Jacobian group law, limb for limb: generic, P = Q, P = -Q, infinity
# ---------------------------------------------------------------------------

def _jac_points(rng, n):
    """n Jacobian points kG with random z (ints), as (x, y, z) tuples."""
    g = tsecp.g_multiples()
    pts = []
    for i in range(n):
        x, y = g[1 + i % 15]
        z = rng.randrange(1, P)
        pts.append((x * z * z % P, y * z ** 3 % P, z))
    return pts


@pytest.fixture(scope="module")
def group_cases():
    rng = random.Random(99)
    ps = _jac_points(rng, 8)
    inf = (1, 1, 0)
    # the same point with another z (P = Q), its negation (P = -Q),
    # infinity on either side and on both, and generic pairs
    z2 = rng.randrange(2, P)
    same = [(x * z2 * z2 % P, y * z2 ** 3 % P, z * z2 % P)
            for x, y, z in ps]
    neg = [(x, (-y) % P, z) for x, y, z in ps]
    left = ps + ps + ps + [inf, inf] + ps[:4]
    right = same + neg + ps[::-1] + [ps[0], inf] + [inf] * 4
    lim = lambda pts, k: _cols([p[k] for p in pts])   # noqa: E731
    a = [lim(left, k) for k in range(3)]
    b = [lim(right, k) for k in range(3)]
    jac_j = lambda c: jsecp.Jac(*(jnp.asarray(v) for v in c))   # noqa: E731
    jac_t = lambda c: tsecp.Jac(  # noqa: E731
        *(torch.from_numpy(v.astype(np.int64)) for v in c))
    want_add = jsecp.add(jac_j(a), jac_j(b))
    want_dbl = jsecp.dbl(jac_j(a))
    got_add = tsecp.add(jac_t(a), jac_t(b))
    got_dbl = tsecp.dbl(jac_t(a))
    return want_add, got_add, want_dbl, got_dbl, left, right


def _jax_ints(pt):
    """A JAX Jac of (NLIMB, n) limbs -> per point, its (x, y, z) ints."""
    cols = [np.asarray(JF.freeze(c)) for c in pt]
    return [tuple(JF.limbs_to_int(c[:, i]) for c in cols)
            for i in range(cols[0].shape[1])]


def test_add_and_dbl_limb_for_limb(group_cases, harness):
    """The plain dbl and complete add limb for limb, and S1's round-split
    jac_dbl4 and jac_add4 on the host group (every lane) as canonical
    values, against the JAX functions: generic, P = Q, P = -Q, infinity."""
    want_add, got_add, want_dbl, got_dbl, left, right = group_cases
    for w, g in zip(want_add + want_dbl, got_add + got_dbl):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    for op, want in ((0, want_dbl), (1, want_add)):
        got = group4(harness, op, left, right)
        assert [lanes[0] for lanes in got] == _jax_ints(want)
        assert all(len(set(lanes)) == 1 for lanes in got)


def test_add_is_the_group_law(group_cases, harness):
    """The complete add on the degenerate pairs, plain and round-split:
    P + P = 2P, P + (-P) and infinity + infinity are infinity, P +
    infinity = P."""
    _, got, _, _, left, right = group_cases
    zs = [TF.limbs_to_int(TF.freeze(got.z)[:, i].numpy()) % P
          for i in range(len(left))]
    four = [lanes[0] for lanes in group4(harness, 1, left, right)]
    n = 8
    for z in (zs, [p[2] for p in four]):
        assert all(z[i] == 0 for i in range(n, 2 * n))       # P + (-P)
        assert z[3 * n + 1] == 0                             # inf + inf
        assert all(z[i] != 0 for i in range(n))              # P + P
    dbl = group4(harness, 0, left[:n], left[:n])
    assert four[:n] == [lanes[0] for lanes in dbl]           # P + P = 2P
    assert four[3 * n + 2:] == left[3 * n + 2:]              # P + inf = P


def test_group_madd_matches_the_jax_add(group_cases, harness):
    """S1's round-split mixed add jac_madd4 (Q affine) on the host group
    against the JAX complete add with Z2 = 1: generic, P = Q, P = -Q and
    an infinity P."""
    _, _, _, _, left, right = group_cases
    pairs = [(p, q) for p, q in zip(left, right) if q[2] % P]
    ps = [p for p, _ in pairs]
    qs = []
    for _, (x, y, z) in pairs:
        zi = pow(z, P - 2, P)
        qs.append((x * zi * zi % P, y * zi ** 3 % P, 1))
    lim = lambda pts, k: jnp.asarray(_cols([p[k] for p in pts]))  # noqa
    want = jsecp.add(jsecp.Jac(*(lim(ps, k) for k in range(3))),
                     jsecp.Jac(*(lim(qs, k) for k in range(3))))
    got = group4(harness, 2, ps, qs)
    assert [lanes[0] for lanes in got] == _jax_ints(want)
    assert all(len(set(lanes)) == 1 for lanes in got)
    assert any(p[2] == 0 for p in ps)


# ---------------------------------------------------------------------------
# host staging and the keys
# ---------------------------------------------------------------------------

def _sign_batch(n, seed, bad_every=5):
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        k = tkeys.PrivKey.gen_from_secret(b"%d-%d" % (seed, i))
        m = b"secp msg %d %d" % (seed, i)
        s = k.sign(m)
        if i % bad_every == bad_every - 1:
            s = s[:40] + bytes([s[40] ^ 4]) + s[41:]
        pubs.append(k.pub_key().bytes())
        msgs.append(m)
        sigs.append(s)
    return pubs, msgs, sigs


def test_staging_nibbles_limbs_and_challenge():
    pubs, msgs, sigs = _sign_batch(6, 1)
    rows, ok = tsecp.stage(pubs, msgs, sigs)
    assert ok.all()
    px = rows[:, :32]
    assert np.array_equal(tsecp._limbs_of_be(px), jsecp._limbs_of_be(px))
    assert np.array_equal(tsecp._nibbles_be(rows[:, 64:96]),
                          jsecp._nibbles_be(rows[:, 64:96]))
    for i, (p, m, s) in enumerate(zip(pubs, msgs, sigs)):
        e = int.from_bytes(jsecp._tagged_hash(
            "BIP0340/challenge", s[:32] + p[1:] + hashlib.sha256(m).digest()),
            "big") % N
        assert rows[i, 96:].tobytes() == e.to_bytes(32, "big")
        assert rows[i, :96].tobytes() == p[1:] + s


def test_keys_sign_verify_address_match():
    for i in range(4):
        secret = b"key %d" % i
        tk = tkeys.PrivKey.gen_from_secret(secret)
        jk = jkeys.PrivKey.gen_from_secret(secret)
        m = b"msg %d" % i
        assert tk.pub_key().bytes() == jk.pub_key().bytes()
        assert tk.pub_key().address() == jk.pub_key().address()
        sig = tk.sign(m)
        assert sig == jk.sign(m)
        assert tk.pub_key().verify_signature(m, sig)
        assert not tk.pub_key().verify_signature(m + b"x", sig)
    assert tkeys._ripemd160_py(b"abc") == jkeys._ripemd160_py(b"abc")
    from tendermint_tpu_torch import crypto
    pk = crypto.pubkey_from_type_name("secp256k1", tk.pub_key().bytes())
    assert pk == tk.pub_key()


# ---------------------------------------------------------------------------
# the plain S1 core against the host oracles; kernel S1's body on the host
# ---------------------------------------------------------------------------

def _raw_rows(pubs, msgs, sigs):
    """(n, 128) rows px | rx | s | e with no range screen (the kernel's and
    the plain version's raw inputs)."""
    out = []
    for p, m, s in zip(pubs, msgs, sigs):
        e = int.from_bytes(tsecp._tagged_hash(
            "BIP0340/challenge", s[:32] + p[1:] + hashlib.sha256(m).digest()),
            "big") % N
        out.append(np.frombuffer(p[1:] + s + e.to_bytes(32, "big"),
                                 np.uint8))
    return np.stack(out)


def _degenerate_rows(rng):
    """Rows whose ladder meets the complete add's degenerate cases: px =
    x(kG), so -P = -kG or kG, and the top digits of s and e chosen so
    that the first step adds a point to itself or to its negation."""
    g = tsecp.g_multiples()
    rows = []
    for k in (1, 2, 3):
        for de in (1, 2, 5):
            ds = (k * de) % 16 or 1
            s = (ds << 252) | rng.getrandbits(250)
            e = (de << 252) | rng.getrandbits(250)
            rows.append(np.frombuffer(
                g[k][0].to_bytes(32, "big") + rng.getrandbits(256).to_bytes(
                    32, "big") + s.to_bytes(32, "big") + e.to_bytes(32, "big"),
                np.uint8))
    # s = e with px = x(G): every step adds dG and then d(-G)
    s = rng.getrandbits(255)
    rows.append(np.frombuffer(g[1][0].to_bytes(32, "big") + bytes(32)
                              + s.to_bytes(32, "big") * 2, np.uint8))
    return np.stack(rows)


@pytest.fixture(scope="module")
def lane_cases():
    """The adversarial vectors, a corrupted sweep and the degenerate rows
    (62 lanes): one plain S1 launch over all of them."""
    cases = _secp_adversarial_vectors()
    pubs = [c[0] for c in cases]
    msgs = [c[1] for c in cases]
    sigs = [c[2] for c in cases]
    sp, sm, ss = _sign_batch(40, 7, bad_every=10)
    pubs, msgs, sigs = pubs + sp, msgs + sm, sigs + ss
    raw = np.concatenate([_raw_rows(pubs, msgs, sigs),
                          _degenerate_rows(random.Random(5))])
    plain = cuda_secp.verify_rows(torch.from_numpy(
        np.ascontiguousarray(raw.T))).numpy()
    return pubs, msgs, sigs, raw, plain


def test_plain_s1_matches_host_oracles(lane_cases):
    pubs, msgs, sigs, raw, plain = lane_cases
    want = [jkeys.PubKey(p).verify_signature(m, s)
            for p, m, s in zip(pubs, msgs, sigs)]
    assert any(want) and not all(want)
    _, host_ok = tsecp.stage(pubs, msgs, sigs)
    assert (plain[:len(pubs)] & host_ok).tolist() == want
    if jnative.get_lib() is not None:
        assert jnative.secp_verify(pubs, msgs, sigs).tolist() == want


def test_verify_batch_device_on_the_cpu(lane_cases):
    """The entry point (length guard, staging, bucket padding, plain
    S1) against the oracle, a malformed length included."""
    pubs, msgs, sigs, _, _ = lane_cases
    pubs, msgs, sigs = pubs[:12], msgs[:12], sigs[:12]
    sigs = sigs[:3] + [sigs[3][:63]] + sigs[4:]
    want = [jkeys.PubKey(p).verify_signature(m, s) if len(s) == 64
            else False for p, m, s in zip(pubs, msgs, sigs)]
    got = tsecp.verify_batch_device(pubs, msgs, sigs, device="cpu")
    assert got.tolist() == want


def test_native_secp_lane_matches_the_jax_package(lane_cases):
    pubs, msgs, sigs, _, _ = lane_cases
    if tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("no C toolchain")
    assert tnative.secp_verify(pubs, msgs, sigs).tolist() == \
        jnative.secp_verify(pubs, msgs, sigs).tolist()
    assert tnative.secp_verify(pubs[:2], msgs[:2], [b"x"] * 2) is None


HARNESS = r"""
#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

#include "fe_secp.cuh"
#include "secp4.cuh"

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
  uint32_t word[4][8];
  uint32_t tab[S4_SIG_WORDS];
};

// the group primitives of secp4.cuh: a barrier in place of the shuffles
struct HostXch {
  int t;
  Group *g;
  int lane() const { return t; }
  void get8(uint32_t out[8], const uint32_t v[8], int src) {
    memcpy(g->word[t], v, 32);
    g->bar.wait();
    memcpy(out, g->word[src], 32);
    g->bar.wait();
  }
  void sync() { g->bar.wait(); }
  uint32_t *scratch() { return g->tab; }
};

// f(x) on the four lanes of one group, each on its own thread
template <class F>
static void on_four(F f) {
  Group g;
  std::vector<std::thread> lanes;
  for (int t = 0; t < 4; t++)
    lanes.emplace_back([&, t] {
      HostXch x{t, &g};
      f(x);
    });
  for (auto &th : lanes) th.join();
}

extern "C" {
// rows (n, 128) row-major, px | rx | s | e big-endian; g: 256 words;
// out (n, 4): the verdict of each lane of the group
void s1_verify4(const uint8_t *rows, const uint32_t *g, uint8_t *out,
                int n) {
  on_four([&](HostXch &x) {
    for (int i = 0; i < n; i++) {
      const uint8_t *r = rows + 128 * i;
      auto load = [&](int k, fs w) {
        for (int q = 0; q < 8; q++) {
          uint32_t v = 0;
          for (int b = 0; b < 4; b++)
            v |= (uint32_t)r[32 * k + 31 - 4 * q - b] << (8 * b);
          w[q] = v;
        }
      };
      out[4 * i + x.t] = secp_verify4(x, load, g);
    }
  });
}
// one group operation: op 0 jac_dbl4, 1 jac_add4, 2 jac_madd4.  in (n, 6,
// 8) words: P's X, Y, Z, then Q's X, Y, Z (jac_madd4 reads Q's X and Y as
// an affine point); out (n, 4, 3, 8): each lane's X, Y, Z
void s1_group4(int op, const uint32_t *in, uint32_t *out, int n) {
  on_four([&](HostXch &x) {
    for (int i = 0; i < n; i++) {
      jpt p;
      fs_load(p.X, in + 48 * i);
      fs_load(p.Y, in + 48 * i + 8);
      fs_load(p.Z, in + 48 * i + 16);
      const uint32_t *q = in + 48 * i + 24;
      if (op == 0)
        jac_dbl4(x, p);
      else if (op == 1)
        jac_add4(x, p, q);
      else
        jac_madd4(x, p, q);
      uint32_t *o = out + 24 * (4 * i + x.t);
      memcpy(o, p.X, 32);
      memcpy(o + 8, p.Y, 32);
      memcpy(o + 16, p.Z, 32);
    }
  });
}
// the field ops of fe_secp_selftest (secp256k1_verify.cu), and an eighth:
// a a by fs_mul, which fs_sqr must equal
void s1_field(const uint8_t *a, const uint8_t *b, uint8_t *out, int n) {
  for (int i = 0; i < n; i++) {
    fs fa, fb, r[8];
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
    fs_mul(r[7], fa, fa);
    for (int k = 0; k < 8; k++)
      for (int q = 0; q < 32; q++)
        out[(k * n + i) * 32 + q] = (uint8_t)(r[k][q >> 2] >> (8 * (q & 3)));
  }
}
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found")
    d = tmp_path_factory.mktemp("s1")
    src, so = d / "s1.cpp", d / "s1.so"
    src.write_text(HARNESS)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-pthread", "-shared",
                        "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.s1_verify4.argtypes = [vp, vp, vp, ctypes.c_int]
    lib.s1_group4.argtypes = [ctypes.c_int, vp, vp, ctypes.c_int]
    lib.s1_field.argtypes = [vp, vp, vp, ctypes.c_int]
    return lib


def _words(vals):
    """ints below 2^256 -> (n, 8) uint32 little-endian words."""
    return np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint32)
                     for v in vals])


def group4(lib, op, ps, qs):
    """One jac_dbl4 (op 0), jac_add4 (1) or jac_madd4 (2) of each (p, q) of
    Python-int triples on the host group -> per pair, the (X, Y, Z) ints
    of the four lanes."""
    n = len(ps)
    inp = np.ascontiguousarray(np.concatenate(
        [_words([p[k] for p in ps]) for k in range(3)]
        + [_words([q[k] for q in qs]) for k in range(3)], axis=1))
    out = np.zeros((n, 4, 3, 8), np.uint32)
    lib.s1_group4(op, inp.ctypes.data, out.ctypes.data, n)
    return [[tuple(int.from_bytes(out[i, t, k].tobytes(), "little")
                   for k in range(3)) for t in range(4)] for i in range(n)]


def verify4(lib, raw):
    """S1's four-lane body on the host: (n, 128) raw rows -> (n, 4) uint8,
    each lane's verdict."""
    rows = np.ascontiguousarray(raw)
    g = np.ascontiguousarray(cuda_secp.g_table8().reshape(-1))
    out = np.zeros((rows.shape[0], 4), np.uint8)
    lib.s1_verify4(rows.ctypes.data, g.ctypes.data, out.ctypes.data,
                   rows.shape[0])
    return out


def test_s1_body_on_the_host_matches_plain(harness, lane_cases):
    """S1's body (secp_verify4 on four host threads) gives the plain
    version's raw bitmap on every lane, adversarial, sweep and degenerate
    rows, and every lane of the group the same verdict."""
    _, _, _, raw, plain = lane_cases
    out = verify4(harness, raw)
    assert (out == out[:, :1]).all()
    assert out[:, 0].astype(bool).tolist() == plain.tolist()


def test_s1_field_on_the_host_matches_the_jax_field(harness):
    """fe_secp.cuh's canonical results equal the JAX field's values, frozen,
    on EDGE and seeded values (values up to 2^256 - 1 come in reduced);
    fs_sqr equals fs_mul(a, a)."""
    rng = random.Random(3)
    vals = [v for v in EDGE if v < (1 << 256)] + \
        [rng.getrandbits(256) for _ in range(24)]
    a = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                  for v in vals])
    b = np.ascontiguousarray(a[::-1])
    n = len(vals)
    out = np.zeros((8, n, 32), np.uint8)
    harness.s1_field(a.ctypes.data, b.ctypes.data, out.ctypes.data, n)
    assert np.array_equal(out[2], out[7])
    ja = jnp.asarray(_cols(vals))
    jb = jnp.asarray(_cols(vals[::-1]))
    want = [JF.freeze(x) for x in (ja, JF.mul(ja, jb), JF.sqr(ja),
                                   JF.carry(ja + jb), JF.carry(ja - jb),
                                   JF.invert(ja), JF.sqrt(ja))]
    for k, w in enumerate(want):
        w = np.asarray(w)
        got = [int.from_bytes(out[k, i].tobytes(), "little")
               for i in range(n)]
        assert got == [JF.limbs_to_int(w[:, i]) for i in range(n)], k
    # and the wrapper's plain version agrees byte for byte
    plain = cuda_secp.fe_secp_selftest(torch.from_numpy(a),
                                       torch.from_numpy(b))
    assert np.array_equal(plain.numpy(), out[:7])


@pytest.fixture(scope="module")
def jax_core(lane_cases):
    """The JAX _verify_core's raw bitmap on lane_cases (an XLA compile of
    the whole ladder, ~100 s on a CPU)."""
    raw = lane_cases[3]
    want = jsecp._verify_core(jnp.asarray(jsecp._limbs_of_be(raw[:, :32])),
                              jnp.asarray(jsecp._limbs_of_be(raw[:, 32:64])),
                              jnp.asarray(jsecp._nibbles_be(raw[:, 64:96])),
                              jnp.asarray(jsecp._nibbles_be(raw[:, 96:])))
    return np.asarray(want).tolist()


def test_s1_body_on_the_host_matches_the_jax_core(harness, lane_cases,
                                                  jax_core):
    """S1's four-lane body on the host gives the JAX _verify_core's raw
    bitmap on every lane of lane_cases, degenerate-add rows included."""
    out = verify4(harness, lane_cases[3])
    assert out[:, 0].astype(bool).tolist() == jax_core
    assert any(jax_core) and not all(jax_core)


@pytest.mark.slow
def test_plain_s1_core_matches_the_jax_core(lane_cases, jax_core):
    """The plain core against the JAX _verify_core on the same raw rows
    (an XLA compile of the whole ladder)."""
    assert jax_core == lane_cases[4].tolist()
