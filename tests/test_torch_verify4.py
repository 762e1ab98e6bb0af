"""The four-lane verify body of K1, K2 and K3 (csrc/verify4.cuh) on the CPU,
and the R edge vectors that its projective R check must get right.

(a) R edge vectors on the port's plain path against the JAX package's
    verify_batch and the pure-Python oracle: a non-square R, R = (0, 1)
    with the sign bit, the order-2 R = (0, -1) with and without the sign
    bit, R with y = p (non-canonical, an order-4 point) and its canonical
    twin, R with y = 2^255 - 1.
(b) The group body compiled with g++ and run by four host threads that
    meet at a barrier where the card's lanes exchange values with
    __shfl_sync: its verdicts on these vectors and on those of
    test_torch_ed25519 equal the JAX package's and the oracle's, and one
    4-way doubling or addition equals ops/curve.py's as canonical bytes
    of every coordinate, on seeded points.  Skipped only when no C++
    compiler is found.
"""
import hashlib
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import _edref
from tendermint_tpu.ops import ed25519 as jed

import tendermint_tpu_torch as T
from tendermint_tpu_torch.ops import cuda_ed25519 as ck
from tendermint_tpu_torch.ops import curve as C
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import field as F
from test_torch_ed25519 import _vectors

P = _edref.P
L = _edref.L
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    ted.__file__))), "csrc")


@pytest.fixture(autouse=True)
def _cpu():
    T.set_default_device("cpu")
    yield
    T.set_default_device("cuda")


def _enc(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _k(r: bytes, a: bytes, m: bytes) -> int:
    return int.from_bytes(hashlib.sha512(r + a + m).digest(), "little") % L


def _msg_where(r: bytes, a: bytes, cond) -> bytes:
    """The first message b"r-edge <i>" whose challenge k satisfies cond."""
    for i in range(10_000):
        m = b"r-edge %d" % i
        if cond(_k(r, a, m)):
            return m
    raise AssertionError("no message found")


def _r_edges():
    """(pubs, msgs, sigs, expected verdicts) of the R edge vectors."""
    rng = random.Random(7)
    seed = bytes(rng.randrange(256) for _ in range(32))
    m0 = b"a message"
    p0 = _edref.pubkey_from_seed(seed)
    s0 = _edref.sign(seed, m0)
    y_ns = 2
    while _edref._recover_x(y_ns, 0) is not None:
        y_ns += 1
    zero_s = bytes(32)
    ident, a2, a4 = _enc(1), _enc(P - 1), _enc(0)
    odd = lambda k: k % 2 == 1          # noqa: E731
    three = lambda k: k % 4 == 3        # noqa: E731
    rows = [
        (p0, m0, _enc(y_ns) + s0[32:], False),          # R not a square
        # R = (0, 1) with the sign bit; P = [0]B - [k]O = O
        (ident, m0, _enc(1 | 1 << 255) + zero_s, False),
    ]
    # A = R = (0, -1), s = 0, k odd: P = -kA = A
    for r, want in ((a2, True), (_enc(P - 1 | 1 << 255), False)):
        rows.append((a2, _msg_where(r, a2, odd), r + zero_s, want))
    # A = the order-4 point with y = 0, s = 0, k = 3 mod 4: P = -3A = A;
    # R = y = p encodes it non-canonically, R = y = 0 canonically
    for r, want in ((_enc(P), False), (a4, True)):
        rows.append((a4, _msg_where(r, a4, three), r + zero_s, want))
    for r in (_enc((1 << 255) - 1), _enc((1 << 256) - 1)):   # y = 2^255 - 1
        rows.append((p0, m0, r + s0[32:], False))
    pubs, msgs, sigs, want = (list(c) for c in zip(*rows))
    return pubs, msgs, sigs, want


@pytest.fixture(scope="module")
def r_edges():
    pubs, msgs, sigs, want = _r_edges()
    oracle = [_edref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert oracle == want
    return pubs, msgs, sigs, want


def test_r_edges_plain_path(r_edges):
    """(a): the port's plain path = the JAX package = the oracle."""
    pubs, msgs, sigs, want = r_edges
    ref = np.asarray(jed.verify_batch(pubs, msgs, sigs))
    np.testing.assert_array_equal(ref, want)
    out = ted.verify_batch(pubs, msgs, sigs)
    np.testing.assert_array_equal(out, want)
    assert ted.last_launch()["path"] == "cuda"   # the kernel route, plain


def test_r_edges_kernel_wrappers(r_edges):
    """K1, K2 and K3 wrappers on CPU tensors (their plain versions) on the
    staged R edge vectors."""
    pubs, msgs, sigs, want = r_edges
    packed, ok = ted.prepare_batch_packed(pubs, sigs, msgs)
    k1 = ck.verify_packed(torch.from_numpy(packed.view(np.uint8))).numpy()
    np.testing.assert_array_equal(k1 & ok, want)
    pub_rows, rsk, ok2 = ted.prepare_batch_split(pubs, sigs, msgs)
    k2 = ck.verify_packed_split(torch.from_numpy(pub_rows),
                                torch.from_numpy(rsk.view(np.uint8))).numpy()
    np.testing.assert_array_equal(k2 & ok2, want)
    staged, ok3 = ted.prepare_batch_compact(pubs, sigs, msgs)
    k3 = ck.verify_staged(*(torch.from_numpy(staged[k].view(np.uint8))
                            for k in ("pub", "r", "s", "digest"))).numpy()
    np.testing.assert_array_equal(k3 & ok3, want)


# ---------------------------------------------------------------------------
# (b) the group body on four host threads
# ---------------------------------------------------------------------------

# Commands, one a line, 32-byte values as little-endian hex:
#   B <270 ints>                     the niels table of B (9 x 3 x 10 limbs)
#   V <enc A> <enc R> <s> <k>        -> verdict 0/1
#   D <X> <Y> <Z> <T>                -> 2P as four canonical values
#   C <X> <Y> <Z> <T> <q0..q3> <neg> -> P + (+-)q, q cached
#   N <X> <Y> <Z> <T> <q0..q2> <neg> -> P + (+-)q, q niels
#   E <enc>                          -> the one-lane decode (K4's, no
#                                       parking): "<ok> <ok strict> <x> <y>"
HARNESS = r"""
#include <atomic>
#include <cstdio>
#include <cstring>
#include <iostream>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include "fe25519.cuh"
#include "verify4.cuh"

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

// the group primitives of verify4.cuh: a barrier in place of a shuffle
struct HostXch {
  int t;
  Group *g;
  int lane() const { return t; }
  int32_t get(int32_t v, int src) {
    g->word[t] = v;
    g->bar.wait();
    int32_t r = g->word[src];
    g->bar.wait();
    return r;
  }
  void sync() { g->bar.wait(); }
  int32_t *scratch() { return g->tab; }
};

struct Cmd {
  char op;
  uint32_t w[9][8];
  int neg;
};

static void words(uint32_t w[8], const std::string &hex) {
  for (int q = 0; q < 8; q++) {
    uint32_t v = 0;
    for (int b = 0; b < 4; b++)
      v |= (uint32_t)std::stoul(hex.substr(2 * (4 * q + b), 2), nullptr, 16)
           << (8 * b);
    w[q] = v;
  }
}

static void to_fe(fe h, const uint32_t w[8]) {
  fe_frombytes(h, w);
  fe_carry(h);
}

static std::string hex(const fe f) {
  uint8_t b[32];
  fe_tobytes(b, f);
  char s[65];
  for (int i = 0; i < 32; i++) snprintf(s + 2 * i, 3, "%02x", b[i]);
  return std::string(s, 64);
}

int main() {
  int32_t base[270];
  std::vector<Cmd> cmds;
  std::string line;
  while (std::getline(std::cin, line)) {
    std::istringstream in(line);
    Cmd c{};
    if (!(in >> c.op)) continue;
    if (c.op == 'B') {
      for (int i = 0; i < 270; i++) in >> base[i];
      continue;
    }
    int n = c.op == 'E' ? 1 : c.op == 'V' || c.op == 'D' ? 4
            : c.op == 'C' ? 8 : 7;
    for (int i = 0; i < n; i++) {
      std::string h;
      in >> h;
      words(c.w[i], h);
    }
    if (c.op == 'C' || c.op == 'N') in >> c.neg;
    cmds.push_back(c);
  }
  std::vector<std::string> res(cmds.size() * 4);
  Group g;
  std::vector<std::thread> lanes;
  for (int t = 0; t < 4; t++)
    lanes.emplace_back([&, t] {
      HostXch x{t, &g};
      for (size_t i = 0; i < cmds.size(); i++) {
        const Cmd &c = cmds[i];
        if (c.op == 'E') continue;
        if (c.op == 'V') {
          auto scalars = [&](uint32_t s[8], uint32_t k[8]) {
            memcpy(s, c.w[2], 32);
            memcpy(k, c.w[3], 32);
          };
          auto enc = [&](uint32_t w[8]) { memcpy(w, c.w[t == 1], 32); };
          bool v = verify4(x, enc, scalars, base);
          res[4 * i + t] = v ? "1" : "0";
          continue;
        }
        fe p, q;
        to_fe(p, c.w[t]);
        if (c.op == 'D') {
          dbl4(x, p);
        } else {
          int32_t ent[40];
          int nq = c.op == 'C' ? 4 : 3;
          for (int j = 0; j < nq; j++) to_fe(ent + 10 * j, c.w[4 + j]);
          if (c.op == 'C')
            cached_coord(q, t, ent, c.neg);
          else
            niels_coord(q, t, ent, c.neg);
          add4(x, p, q);
        }
        res[4 * i + t] = hex(p);
      }
    });
  for (auto &th : lanes) th.join();
  for (size_t i = 0; i < cmds.size(); i++) {
    if (cmds[i].op != 'E') continue;
    fe x, y, xs, ys;
    bool ok = ge_decode(x, y, cmds[i].w[0]);
    bool strict = ge_decode(xs, ys, cmds[i].w[0], NoPark(), true);
    res[4 * i] = std::string(ok ? "1 " : "0 ") + (strict ? "1 " : "0 ") +
                 hex(x) + " " + hex(y);
  }
  for (size_t i = 0; i < cmds.size(); i++) {
    if (cmds[i].op == 'E')
      std::cout << res[4 * i] << "\n";
    else if (cmds[i].op == 'V')
      std::cout << res[4 * i] << res[4 * i + 1] << res[4 * i + 2]
                << res[4 * i + 3] << "\n";
    else
      std::cout << res[4 * i] << " " << res[4 * i + 1] << " "
                << res[4 * i + 2] << " " << res[4 * i + 3] << "\n";
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
    d = tmp_path_factory.mktemp("verify4")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-pthread", "-I", CSRC,
                        "-o", str(exe), str(src)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr

    def run(lines):
        base = " ".join(str(int(v)) for v in ck.base_table10().reshape(-1))
        r = subprocess.run([str(exe)], input="\n".join(["B " + base, *lines])
                           + "\n", capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr
        return r.stdout.split("\n")[:len(lines)]
    return run


def _verify_lines(pubs, msgs, sigs):
    return ["V " + " ".join(b.hex() for b in (
        p, s[:32], s[32:], _enc(_k(s[:32], p, m))))
        for p, m, s in zip(pubs, msgs, sigs)]


def test_group_body_verdicts(harness, r_edges):
    """(b): every lane of the group returns the same verdict, and it is the
    JAX package's and the oracle's (after the host's s < L screen)."""
    ep, em, es, want = r_edges
    vp, vm, vs = _vectors()
    pubs, msgs, sigs = vp + ep, vm + em, vs + es
    oracle = np.array([_edref.verify(p, m, s)
                       for p, m, s in zip(pubs, msgs, sigs)])
    ref = np.asarray(jed.verify_batch(pubs, msgs, sigs))
    np.testing.assert_array_equal(ref, oracle)
    out = harness(_verify_lines(pubs, msgs, sigs))
    assert all(o in ("0000", "1111") for o in out), out
    s_ok = np.array([int.from_bytes(s[32:], "little") < L for s in sigs])
    got = np.array([o == "1111" for o in out]) & s_ok
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got[len(vp):], want)


def _seeded_points(n, seed):
    """n points [r]B as extended (X, Y, Z, T) with a random Z, Python ints."""
    rng = random.Random(seed)
    pts = []
    for _ in range(n):
        x, y, z, _t = _edref._mul(rng.randrange(1, L), _edref.BASE)
        zi = pow(z, P - 2, P)
        x, y = x * zi % P, y * zi % P
        w = rng.randrange(1, P)
        pts.append((x * w % P, y * w % P, w, x * y % P * w % P))
    return pts


def _limbs(vals):
    """ints -> (NLIMB, n) limbs of the plain field."""
    return torch.from_numpy(np.stack([F.int_to_limbs(v % P) for v in vals],
                                     axis=1))


def _ext(pts):
    return C.Ext(*(_limbs([p[i] for p in pts]) for i in range(4)))


def _hex_rows(coords):
    """tuple of (NLIMB, n) limb tensors -> per point, the canonical hex of
    each coordinate."""
    cols = [F.to_bytes(c).t().to(torch.uint8).numpy() for c in coords]
    return [" ".join(bytes(c[i]).hex() for c in cols)
            for i in range(cols[0].shape[0])]


def _point_hex(p):
    return " ".join(_enc(v).hex() for v in p)


def test_group_dbl_add_match_curve(harness):
    """(b): one dbl4 / add4 (cached and niels, each sign) on the group =
    ops/curve.py dbl / add_cached / madd_niels, coordinate for coordinate
    as canonical bytes."""
    n = 6
    ps, qs = _seeded_points(n, 1), _seeded_points(n, 2)
    pe, qe = _ext(ps), _ext(qs)
    want = _hex_rows(C.dbl(pe, True))
    lines = ["D " + _point_hex(p) for p in ps]
    qc = C.to_cached(qe)
    aff = []
    for x, y, z, _t in qs:
        zi = pow(z, P - 2, P)
        ax, ay = x * zi % P, y * zi % P
        aff.append(((ay + ax) % P, (ay - ax) % P, 2 * C.D_INT * ax * ay % P))
    qn = C.Niels(*(_limbs([a[i] for a in aff]) for i in range(3)))
    qc_hex = _hex_rows(qc)
    qn_hex = [" ".join(_enc(v).hex() for v in a) for a in aff]
    for neg in (False, True):
        negs = torch.full((n,), neg)
        want += _hex_rows(C.add_cached(pe, C.cond_neg_cached(qc, negs)))
        want += _hex_rows(C.madd_niels(pe, C.cond_neg_niels(qn, negs)))
        for kind, qh in (("C", qc_hex), ("N", qn_hex)):
            lines += [f"{kind} {_point_hex(p)} {q} {int(neg)}"
                      for p, q in zip(ps, qh)]
    out = harness(lines)
    assert out == want


def test_one_lane_decode(harness):
    """(b): ge_decode without parking (K4's decode, which keeps its
    one-lane form) and its strict form, on edge and seeded encodings:
    the verdict is the oracle's decode (strict: and y < p), and x, y are
    the oracle's point."""
    rng = random.Random(11)
    y_ns = 2
    while _edref._recover_x(y_ns, 0) is not None:
        y_ns += 1
    ys = [0, 1, 2, P - 1, P, P + 1, P + 18, (1 << 255) - 1, y_ns]
    encs = [_enc(y | sign << 255) for y in ys for sign in (0, 1)]
    for _ in range(12):
        encs.append(_edref._encode(_edref._mul(rng.randrange(1, L),
                                               _edref.BASE)))
        encs.append(bytes(rng.randrange(256) for _ in range(32)))
    out = harness(["E " + e.hex() for e in encs])
    for e, o in zip(encs, out):
        ok, strict, x, y = o.split()
        pt = _edref._decode(e)
        canon = int.from_bytes(e, "little") % (1 << 255) < P
        assert (ok, strict) == (str(int(pt is not None)),
                                str(int(pt is not None and canon))), e.hex()
        if pt is not None:
            assert (x, y) == (_enc(pt[0]).hex(), _enc(pt[1]).hex()), e.hex()
