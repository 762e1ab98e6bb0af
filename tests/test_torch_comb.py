"""The fixed-base comb of the port (ops/ed25519.py's comb half, kernels C1
and C2 of ops/cuda_comb.py) against the JAX package's (ops/ed25519.py,
tests/test_comb.py), on the CPU.

(a) The plain versions against the JAX functions, computed once a module
    (the JAX jit of comb_build_kernel and comb_kernel takes tens of
    seconds): C1's tables limb for limb and its decode verdicts on eight
    keys (valid keys, a non-canonical y, negative zero, a non-square, an
    order-8 point, the identity), comb_table_scan at two windows, and
    C2's bitmap on 64 lanes (valid, wrong message, s >= L, non-canonical
    R, a flipped R bit, and the keys above, four of them accepted by the
    cofactorless check) against the JAX comb, both ladders and the
    pure-Python oracle; then the comb route end to end.
(b) The bodies of C1 and C2 (csrc/comb4.cuh) compiled with g++ and run
    by host threads that meet at barriers where the card's lanes exchange
    values and its warps hand points over (C1: a block's four roles on
    128 threads, the named barriers as counting barriers, on the eight
    keys and on a ragged set of 13; C2 on 4 G for G = 1, 2, 4, 8): C1's
    table as field values and its verdicts against the plain version and
    the JAX package's, C2's bitmap and P's affine coordinates against the
    plain versions; the digits C2 forms from s against
    scalars_to_digits.
(c) Routing and runtime through both packages with the kernels stubbed (as
    tests/test_comb.py stubs them; each package's ladder is stubbed by the
    bignum oracle on its staged scalars): build, hit, subset, mixed keys,
    disabled and declined, eviction, repointing, chunking, the chaos
    matrix at ops.ed25519.comb, a real RuntimeError, the skipped distinct
    key sort, the early decline, the knobs, prewarm; the route counters,
    table metrics, launch records and ledgers of the two packages are
    equal.  DeviceLRU in both packages.
"""
from __future__ import annotations

import hashlib
import shutil
import subprocess
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import _edref as jref
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import degrade as jdeg
from tendermint_tpu.crypto import devobs as jdevobs
from tendermint_tpu.crypto import ed25519 as jkeys
from tendermint_tpu.libs import fail as jfail
from tendermint_tpu.libs.metrics import Registry as JRegistry
from tendermint_tpu.ops import curve as JC
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.parallel import sharding as jsharding

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import _edref
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import degrade as tdeg
from tendermint_tpu_torch.crypto import devobs as tdevobs
from tendermint_tpu_torch.crypto import ed25519 as tkeys
from tendermint_tpu_torch.libs import fail as tfail
from tendermint_tpu_torch.libs.metrics import Registry as TRegistry
from tendermint_tpu_torch.ops import cuda_comb as cc
from tendermint_tpu_torch.ops import cuda_ed25519 as ck
from tendermint_tpu_torch.ops import curve as C
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import field as F

P, L = _edref.P, _edref.L
CSRC = str(ted.__file__).rsplit("/ops/", 1)[0] + "/csrc"

JAX = types.SimpleNamespace(name="jax", ed=jed, deg=jdeg, fail=jfail,
                            cb=jbatch, keys=jkeys, Registry=JRegistry,
                            devobs=jdevobs, ladder="xla")
PORT = types.SimpleNamespace(name="port", ed=ted, deg=tdeg, fail=tfail,
                             cb=tbatch, keys=tkeys, Registry=TRegistry,
                             devobs=tdevobs, ladder="cuda")
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is thousands of small tensor ops: with one intra-op
    thread per test process they do not contend with parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset_comb(pkg):
    pkg.ed.table_cache_clear()
    pkg.ed._comb_enabled_override = None
    pkg.ed._comb_min_override = None
    pkg.ed._table_budget_override = None
    pkg.fail.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """A clean comb world in both packages: empty table caches, no knob
    overrides, no armed chaos, the CPU device for the port."""
    T.set_default_device("cpu")
    monkeypatch.delenv("TM_TPU_FORCE_BATCH", raising=False)
    monkeypatch.delenv("TM_TPU_DISABLE_BATCH", raising=False)
    for pkg in PKGS:
        _reset_comb(pkg)
    yield
    for pkg in PKGS:
        _reset_comb(pkg)
        pkg.deg.reset()
    T.set_default_device("cuda")


def _both(fn):
    """fn(pkg) for both packages; the outcomes must be equal."""
    got = {pkg.name: fn(pkg) for pkg in PKGS}
    assert got["jax"] == got["port"], got
    return got["port"]


# ---------------------------------------------------------------------------
# keys and lanes
# ---------------------------------------------------------------------------

def _enc(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _order8():
    """An order-8 point: the torsion part [L] Q of some Q, of order 8."""
    y = 2
    while True:
        q = _edref._decode(_enc(y))
        if q is not None:
            t = _edref._mul(L, q)
            if _edref._encode(_edref._mul(4, t)) != _enc(1):
                return t
        y += 1


def _non_square_y() -> int:
    y = 2
    while _edref._recover_x(y, 0) is not None:
        y += 1
    return y


SEEDS = [(0x5100 + i).to_bytes(32, "little") for i in range(3)]
T8 = _order8()
# (encoding, decode verdict): three valid keys, y = p (non-canonical,
# reduced to the order-4 point y = 0), negative zero, a non-square, an
# order-8 point, the identity
KEYS = [(_edref.pubkey_from_seed(s), True) for s in SEEDS] + [
    (_enc(P), True), (_enc(1 | 1 << 255), False),
    (_enc(_non_square_y()), False), (_edref._encode(T8), True),
    (_enc(1), True)]


def _k(r: bytes, a: bytes, m: bytes) -> int:
    return int.from_bytes(hashlib.sha512(r + a + m).digest(), "little") % L


def _msg_where(r: bytes, a: bytes, cond) -> bytes:
    for i in range(10_000):
        m = b"comb edge %d" % i
        if cond(_k(r, a, m)):
            return m
    raise AssertionError("no message found")


def _lanes():
    """64 lanes over KEYS: (pubs, msgs, sigs, vidx, oracle verdicts)."""
    rows = []
    for i in range(40):                      # valid, then tamper classes
        j = i % 3
        m = b"comb lane %d" % i
        sig = _edref.sign(SEEDS[j], m)
        if i % 8 == 1:
            m += b"!"                        # wrong message
        elif i % 8 == 3:                     # s >= L
            s = int.from_bytes(sig[32:], "little") + L
            sig = sig[:32] + _enc(s)
        elif i % 8 == 5:                     # non-canonical R: y = p + 1
            sig = _enc(P + 1) + sig[32:]
        elif i % 8 == 7:                     # a flipped bit of R
            sig = bytes([sig[0] ^ 4]) + sig[1:]
        rows.append((j, m, sig))
    z32 = bytes(32)
    a_nc = KEYS[3][0]                        # y = p: the order-4 point
    for r in (_enc(0), _enc(P)):             # P = -3A = A when k = 3 mod 4
        rows.append((3, _msg_where(r, a_nc, lambda k: k % 4 == 3), r + z32))
    a8 = KEYS[6][0]                          # P = -kA = A when k = 7 mod 8
    rows.append((6, _msg_where(a8, a8, lambda k: k % 8 == 7), a8 + z32))
    rows.append((6, b"comb order 8", a8 + z32))
    for j in (4, 5):                         # rejected at the decode
        rows.append((j, b"comb bad key", _enc(1) + z32))
    while len(rows) < 64:                    # the identity: P = O
        rows.append((7, b"comb id %d" % len(rows), _enc(1) + z32))
    pubs = [KEYS[j][0] for j, _, _ in rows]
    msgs = [m for _, m, _ in rows]
    sigs = [s for _, _, s in rows]
    vidx = np.array([j for j, _, _ in rows], dtype=np.int32)
    want = np.array([_edref.verify(p, m, s) for p, m, s in
                     zip(pubs, msgs, sigs)])
    return pubs, msgs, sigs, vidx, want


@pytest.fixture(scope="module")
def ref():
    """The JAX package's and the port's plain C1 and C2 on KEYS and the
    64 lanes, computed once."""
    pub = np.frombuffer(b"".join(k for k, _ in KEYS),
                        dtype=np.uint8).reshape(-1, 32).copy()
    jtab, jok = jed.comb_build_kernel(jnp.asarray(pub))
    ttab, tok = cc.comb_build(torch.from_numpy(pub))
    pubs, msgs, sigs, vidx, want = _lanes()
    _, r_b, s_b, k, host_ok = ted._stage_rows(pubs, sigs, msgs)
    sd, kd = ted.scalars_to_digits(s_b), ted.scalars_to_digits(k)
    jbits = np.asarray(jed.comb_kernel(
        jnp.asarray(r_b), jnp.asarray(sd), jnp.asarray(kd),
        jnp.asarray(vidx), jtab.ypx, jtab.ymx, jtab.z, jtab.t2d, jok,
        *jed._base_comb()))
    rows = cc.pack_rows(r_b, s_b, k, vidx)
    # the plain C2 through the wrapper (its digits formed on the host),
    # keeping the point it encodes
    points = []
    real_encode = C.encode

    def encode(p):
        points.append(p)
        return real_encode(p)
    mp = pytest.MonkeyPatch()
    mp.setattr(C, "encode", encode)
    try:
        tbits = cc.comb_verify(torch.from_numpy(rows), ttab, tok).numpy()
    finally:
        mp.undo()
    (p,) = points
    zinv = F.invert(p.z)
    px, py = (F.to_bytes(F.mul(c, zinv)).t().to(torch.uint8).numpy()
              for c in (p.x, p.y))
    return dict(pub=pub, jtab=[np.asarray(t) for t in jtab],
                jok=np.asarray(jok), ttab=ttab, tok=tok.numpy(), pubs=pubs,
                msgs=msgs, sigs=sigs, vidx=vidx, want=want, r=r_b, sd=sd,
                kd=kd, rows=rows, host_ok=host_ok, jbits=jbits, tbits=tbits,
                px=[bytes(b).hex() for b in px],
                py=[bytes(b).hex() for b in py])


# ---------------------------------------------------------------------------
# (a) the plain versions against the JAX functions
# ---------------------------------------------------------------------------

def test_tables_match_jax_limb_for_limb(ref):
    """Plain C1 = the JAX comb_build_kernel: every limb of every field of
    the (64, 9, NLIMB, 8) tables, and the decode verdicts."""
    for got, want in zip(ref["ttab"], ref["jtab"]):
        assert got.shape == want.shape == (64, 9, F.NLIMB, len(KEYS))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(ref["tok"], ref["jok"])
    assert ref["tok"].tolist() == [ok for _, ok in KEYS]


def test_table_scan_two_windows_matches_jax():
    """curve.comb_table_scan at windows=2 = the JAX lax.scan, limb for
    limb, on decoded points (one of them the order-8 point)."""
    pub = np.frombuffer(b"".join(k for k, _ in KEYS[:3] + KEYS[6:7]),
                        dtype=np.uint8).reshape(-1, 32).copy()
    y, sign = F.bytes_to_limbs(torch.from_numpy(pub).t())
    p, ok = C.decompress(y, sign)
    assert ok.all()
    got = C.comb_table_scan(p, windows=2)
    want = JC.comb_table_scan(JC.Ext(*(jnp.asarray(t.numpy().astype(
        np.int32)) for t in p)), windows=2)
    for g, w in zip(got, want):
        assert g.shape == (2, 9, F.NLIMB, 4)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_comb_bitmaps_match_jax_and_both_ladders(ref, monkeypatch):
    """Plain C2's raw bitmap = the JAX comb_kernel's; behind the host s < L
    screen both = the oracle, the port's ladder (plain K1) and the JAX
    package's ladder, on every lane class."""
    np.testing.assert_array_equal(ref["tbits"], ref["jbits"])
    want = ref["want"]
    np.testing.assert_array_equal(ref["tbits"] & ref["host_ok"], want)
    assert want.sum() >= 20 and (~want).sum() >= 20
    assert want[40:44].tolist() == [True, False, True, False]
    assert not want[44:46].any() and want[46:].all()
    pubs, msgs, sigs = ref["pubs"], ref["msgs"], ref["sigs"]
    for pkg in PKGS:
        monkeypatch.setattr(pkg.ed, "_comb_enabled_override", False)
    monkeypatch.setattr(jsharding, "_PLANE", False)
    np.testing.assert_array_equal(ted.verify_batch(pubs, msgs, sigs), want)
    assert ted.last_launch()["path"] == "cuda"
    np.testing.assert_array_equal(
        np.asarray(jed.verify_batch(pubs, msgs, sigs)), want)


def test_comb_route_plain_end_to_end(ref):
    """The 64 lanes through verify_batch's comb route on the CPU: a build
    (cache_pubs, the build floor lowered), then a hit and a subset, each
    the oracle's bitmap; the launch records say comb, zero doublings."""
    pubs, msgs, sigs, want = ref["pubs"], ref["msgs"], ref["sigs"], \
        ref["want"]
    ted.set_comb_config(min_batch=1)
    out = ted.verify_batch(pubs, msgs, sigs, cache_pubs=True)
    ll = ted.last_launch()
    assert ll["path"] == "comb" and ll["table_build"]
    assert (ll["set_k"], ll["k_pad"], ll["nb"]) == (8, 8, 64)
    assert ll["group_ops"] == {"doublings": 0, "adds": 128}
    np.testing.assert_array_equal(out, want)
    out = ted.verify_batch(pubs[40:50], msgs[40:50], sigs[40:50])
    assert ted.last_launch()["path"] == "comb"
    assert not ted.last_launch()["table_build"]
    np.testing.assert_array_equal(out, want[40:50])


def test_group_op_inventory_counted():
    """The comb's and the ladder's group operations, counted by running
    the plain versions with counting curve operations: the constants in
    the launch records cannot drift, and they are the JAX package's."""
    counts = {"dbl": 0, "add": 0}
    real = {n: getattr(C, n) for n in ("dbl", "add_cached", "madd_niels")}

    def wrap(name, bucket):
        def inner(*a, **kw):
            counts[bucket] += 1
            return real[name](*a, **kw)
        return inner
    mp = pytest.MonkeyPatch()
    mp.setattr(C, "dbl", wrap("dbl", "dbl"))
    mp.setattr(C, "add_cached", wrap("add_cached", "add"))
    mp.setattr(C, "madd_niels", wrap("madd_niels", "add"))
    try:
        pub = torch.from_numpy(np.frombuffer(KEYS[0][0], np.uint8)
                               .reshape(1, 32).copy())
        tab, dec_ok = ted.comb_build_kernel_impl(pub)
        build = dict(counts)
        counts.update(dbl=0, add=0)
        z8 = torch.zeros((1, 64), dtype=torch.int8)
        ted.comb_verify_staged(torch.zeros((1, 32), dtype=torch.uint8), z8,
                               z8, torch.zeros(1, dtype=torch.int32), *tab,
                               dec_ok, *ted._base_comb(torch.device("cpu")))
        comb = dict(counts)
        counts.update(dbl=0, add=0)
        y, sign = F.bytes_to_limbs(pub.t())
        a, _ = C.decompress(y, sign)
        ted.straus_ladder(a, z8.t(), z8.t())
        ladder = dict(counts)
    finally:
        mp.undo()
    assert build == {"dbl": 64 * 5, "add": 64 * 3}
    assert {"doublings": comb["dbl"], "adds": comb["add"]} == \
        ted.COMB_GROUP_OPS == jed.COMB_GROUP_OPS
    assert {"doublings": ladder["dbl"], "adds": ladder["add"]} == \
        ted.LADDER_GROUP_OPS == jed.LADDER_GROUP_OPS


# ---------------------------------------------------------------------------
# (b) the group bodies on four host threads
# ---------------------------------------------------------------------------

# Commands, one a line:
#   B <17280 ints>                   B's comb (64 x 9 x 3 x 10 limbs)
#   K <m> <enc hex> x m              C1 on m keys, blocks of C1_KEYS keys
#                                    (the last ragged), each on 128 threads
#                                    in the kernel's four roles, into the
#                                    kernel's table layout -> "<ok> <2304
#                                    hex>" a key, all on one line (entries
#                                    [win][j][coord], canonical)
#   V <G> <key> <row hex>            C2 on 4 G threads (one block of one
#                                    signature) against key's table ->
#                                    "<0/1> <x hex> <y hex>" (the verdict
#                                    ANDed with the key's, P's affine x, y)
#   W <G> <m> (<key> <row hex>) x m  C2 on one full block of 128 threads:
#                                    32 / G signatures, signature i on row
#                                    min(i, m - 1) as a ragged tail of the
#                                    kernel works on its last row again ->
#                                    "<0/1> <x hex> <y hex>" a signature,
#                                    all on one line
#   D <s hex>                        the digits C2 forms from s -> 64 ints
HARNESS = r"""
#include <algorithm>
#include <array>
#include <atomic>
#include <cstdio>
#include <cstring>
#include <iostream>
#include <memory>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include "fe25519.cuh"
#include "comb4.cuh"

// a counting barrier: arrive() takes a ticket, wait() takes one and waits
// until its phase (ticket / n) is complete (bar.arrive / bar.sync)
struct Barrier {
  int n = 0;
  std::atomic<int> ticket{0}, done{0};
  int arrive() {
    int k = ticket.fetch_add(1);
    if (k % n == n - 1) done.fetch_add(1);
    return k / n;
  }
  void wait() {
    int phase = arrive();
    while (done.load() <= phase) std::this_thread::yield();
  }
};

#define BLOCK_THREADS 128   // csrc/comb.cu THREADS

struct Block {
  Barrier bar;
  int32_t word[BLOCK_THREADS];
  uint32_t words[(BLOCK_THREADS / 4) * C2_SIG_WORDS];
};

// C1's block (C1_THREADS threads, four warps of C1_KEYS groups): its
// shared words, the named barriers, __syncwarp, each group's exchange
// (two word sets used in turn, one barrier a get), and the table the
// block's runs go to
struct C1Block {
  int32_t smem[C1_SMEM_WORDS];
  Barrier bar[C1_BARS], warp[C1_THREADS / 32], grp[C1_THREADS / 4];
  int32_t word[C1_THREADS / 4][2][4];
  int32_t *tab;
  long K, key0;
  int n;   // keys of the block below K
  C1Block() {
    for (int i = 1; i < C1_BARS; i++) bar[i].n = c1_bar_threads(i);
    for (auto &w : warp) w.n = 32;
    for (auto &g : grp) g.n = 4;
  }
};

struct HostC1 {
  int tid;
  C1Block *b;
  int par = 0;
  int lane() const { return tid & 3; }
  int group() const { return (tid >> 2) & (C1_KEYS - 1); }
  int32_t get(int32_t v, int src) {
    int32_t *w = b->word[tid >> 2][par];
    w[tid & 3] = v;
    b->grp[tid >> 2].wait();
    par ^= 1;
    return w[src];
  }
  int32_t *smem() { return b->smem; }
  void arrive(int bar) { b->bar[bar].arrive(); }
  void wait(int bar) { b->bar[bar].wait(); }
  template <int N>
  void stage_free() {}
  // the bulk copy: lane 0 of the warp copies the staged run once every
  // lane has staged its words, and the warp waits for it
  void put(int win, int j) {
    b->warp[tid >> 5].wait();
    if ((tid & 31) == 0)
      std::memcpy(b->tab + ((long)(win * COMB_DIGITS + j) * b->K + b->key0) * 40,
                  b->smem + C1_STAGE + j * C1_PT, 160 * b->n);
    b->warp[tid >> 5].wait();
  }
};

// C2's block of n threads: a width-4 shuffle reads lane src & 3 of
// the thread's group, xor_get thread t ^ d, sync() is the barrier
struct HostC2 {
  int t, n;
  Block *b;
  int lane() const { return t & 3; }
  int tid() const { return t; }
  int threads() const { return n; }
  int32_t swap(int32_t v, int src) {
    b->word[t] = v;
    b->bar.wait();
    int32_t r = b->word[src];
    b->bar.wait();
    return r;
  }
  int32_t get(int32_t v, int src) { return swap(v, (t & ~3) + (src & 3)); }
  int32_t xor_get(int32_t v, int d) { return swap(v, t ^ d); }
  void sync() { b->bar.wait(); }
  uint32_t *words() { return b->words; }
};

static void words(uint32_t *w, const std::string &hex, int n) {
  for (int q = 0; q < n; q++) {
    uint32_t v = 0;
    for (int b = 0; b < 4; b++)
      v |= (uint32_t)std::stoul(hex.substr(2 * (4 * q + b), 2), nullptr, 16)
           << (8 * b);
    w[q] = v;
  }
}

static std::string hex(const fe f) {
  uint8_t b[32];
  fe_tobytes(b, f);
  char s[65];
  for (int i = 0; i < 32; i++) snprintf(s + 2 * i, 3, "%02x", b[i]);
  return std::string(s, 64);
}

#define ENTRY_WORDS (COMB_WINDOWS * COMB_DIGITS * 40)

int main() {
  std::vector<int32_t> base(COMB_WINDOWS * COMB_DIGITS * 30);
  std::vector<int32_t> tab;
  std::vector<int> key_ok;
  std::string line;
  while (std::getline(std::cin, line)) {
    std::istringstream in(line);
    char op;
    if (!(in >> op)) continue;
    std::string h;
    if (op == 'B') {
      for (auto &v : base) in >> v;
    } else if (op == 'K') {
      int m;
      in >> m;
      std::vector<std::array<uint32_t, 8>> enc(m);
      for (auto &e : enc) {
        in >> h;
        words(e.data(), h, 8);
      }
      // the kernel's table (64, 9, m, 4, 10), unwritten words a sentinel
      std::vector<int32_t> kt((size_t)ENTRY_WORDS * m, 0x55555555);
      std::vector<int> ok(m);
      for (int key0 = 0; key0 < m; key0 += C1_KEYS) {
        auto b = std::make_unique<C1Block>();
        b->tab = kt.data();
        b->K = m;
        b->key0 = key0;
        b->n = std::min(C1_KEYS, m - key0);
        std::vector<std::thread> lanes;
        for (int tid = 0; tid < C1_THREADS; tid++)
          lanes.emplace_back([&, tid] {
            HostC1 x{tid, b.get()};
            const int role = tid >> 5;   // as the kernel's
            const int key = key0 + x.group(), kl = key < m ? key : m - 1;
            bool r = comb_build4(x, role, [&](uint32_t w[8]) {
              std::memcpy(w, enc[kl].data(), 32);
            });
            if (role == C1_CHAIN && key < m && x.lane() == 0) ok[key] = r;
          });
        for (auto &th : lanes) th.join();
      }
      // each key's entries, and the key's table for V and W
      for (int key = 0; key < m; key++) {
        std::cout << (key ? " " : "") << ok[key];
        tab.resize(tab.size() + ENTRY_WORDS);
        int32_t *own = tab.data() + tab.size() - ENTRY_WORDS;
        for (int e = 0; e < COMB_WINDOWS * COMB_DIGITS; e++) {
          const int32_t *src = kt.data() + ((size_t)e * m + key) * 40;
          std::memcpy(own + 40 * e, src, 160);
          for (int c = 0; c < 4; c++) std::cout << " " << hex(src + 10 * c);
        }
        key_ok.push_back(ok[key]);
      }
      std::cout << "\n";
    } else if (op == 'V') {
      int G, key;
      in >> G >> key >> h;
      uint32_t row[COMB_ROW_WORDS];
      words(row, h, COMB_ROW_WORDS);
      const int32_t *kt = tab.data() + (size_t)key * ENTRY_WORDS;
      const int log_g = G == 1 ? 0 : G == 2 ? 1 : G == 4 ? 2 : 3;
      Block b;
      b.bar.n = 4 * G;
      int ok = 0;
      std::string xs, ys;
      std::vector<std::thread> lanes;
      for (int t = 0; t < 4 * G; t++)
        lanes.emplace_back([&, t] {
          HostC2 x{t, 4 * G, &b};
          auto a_entry = [&](int win, int j) {
            return kt + (win * COMB_DIGITS + j) * 40;
          };
          fe xy;
          bool r = comb_verify4(x, log_g, row, a_entry, base.data(), xy);
          if (t == 0) {
            ok = r;
            xs = hex(xy);
          }
          if (t == 1) ys = hex(xy);
        });
      for (auto &th : lanes) th.join();
      std::cout << (ok && key_ok[key]) << " " << xs << " " << ys << "\n";
    } else if (op == 'W') {
      int G, m;
      in >> G >> m;
      const int n = BLOCK_THREADS / (4 * G);
      const int log_g = G == 1 ? 0 : G == 2 ? 1 : G == 4 ? 2 : 3;
      std::vector<int> keys(m);
      std::vector<std::array<uint32_t, COMB_ROW_WORDS>> rows(m);
      for (int i = 0; i < m; i++) {
        in >> keys[i] >> h;
        words(rows[i].data(), h, COMB_ROW_WORDS);
      }
      Block b;
      b.bar.n = BLOCK_THREADS;
      std::vector<int> ok(n);
      std::vector<std::string> xs(n), ys(n);
      std::vector<std::thread> lanes;
      for (int t = 0; t < BLOCK_THREADS; t++)
        lanes.emplace_back([&, t] {
          const int sig = t / (4 * G), sl = sig < m ? sig : m - 1;
          const int32_t *kt = tab.data() + (size_t)keys[sl] * ENTRY_WORDS;
          HostC2 x{t, BLOCK_THREADS, &b};
          auto a_entry = [&](int win, int j) {
            return kt + (win * COMB_DIGITS + j) * 40;
          };
          fe xy;
          bool r = comb_verify4(x, log_g, rows[sl].data(), a_entry,
                                base.data(), xy);
          if (t % (4 * G) == 0) {
            ok[sig] = r && key_ok[keys[sl]];
            xs[sig] = hex(xy);
          }
          if (t % (4 * G) == 1) ys[sig] = hex(xy);
        });
      for (auto &th : lanes) th.join();
      for (int i = 0; i < n; i++)
        std::cout << (i ? " " : "") << ok[i] << " " << xs[i] << " " << ys[i];
      std::cout << "\n";
    } else if (op == 'D') {
      in >> h;
      uint32_t w[8];
      words(w, h, 8);
      digit_words(w, w);
      for (int win = 0; win < COMB_WINDOWS; win++)
        std::cout << (win ? " " : "") << comb_digit(w, win);
      std::cout << "\n";
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
    d = tmp_path_factory.mktemp("comb4")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-pthread", "-I", CSRC,
                        "-o", str(exe), str(src)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    base = " ".join(str(int(v)) for v in cc.base_comb10().reshape(-1))

    def run(lines):
        r = subprocess.run([str(exe)], input="\n".join(["B " + base, *lines])
                           + "\n", capture_output=True, text=True,
                           timeout=900)
        assert r.returncode == 0, r.stderr
        return r.stdout.split("\n")[:len(lines)]
    return run


def _canonical_hex(tab) -> list:
    """C1 tables (Cached fields (64, 9, NLIMB, K), the plain version's
    tensors or the JAX package's arrays) of key i -> [i][entry] canonical
    hex, entries in the harness's [win][j][coord] order."""
    cols = torch.stack([torch.as_tensor(np.asarray(f, dtype=np.int64))
                        for f in tab], dim=3)     # (64, 9, NLIMB, 4, K)
    K = cols.shape[-1]
    cols = cols.permute(4, 0, 1, 3, 2).reshape(-1, F.NLIMB).t()
    b = F.to_bytes(cols).t().to(torch.uint8).numpy()
    return [[bytes(row).hex() for row in b[i * 2304:(i + 1) * 2304]]
            for i in range(K)]


def _ragged_keys() -> list:
    """13 keys (two blocks of C1's 8, the second holding 5): nine valid
    keys and four random encodings, from a seed."""
    rng = np.random.default_rng(13)
    keys = [_edref.pubkey_from_seed(rng.bytes(32)) for _ in range(9)]
    keys += [rng.bytes(32) for _ in range(4)]
    return keys


@pytest.fixture(scope="module")
def build_refs(ref):
    """{key set: (keys, plain tables, plain verdicts, JAX tables, JAX
    verdicts)} for the adversarial KEYS and the ragged set; the JAX C1 runs
    on the ragged set in blocks of 8 keys (the shape it was compiled for
    in `ref`; a key's table does not depend on the others)."""
    keys = _ragged_keys()
    pub = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(-1, 32)
    ptab, pok = cc.comb_build(torch.from_numpy(pub.copy()))
    pad = np.concatenate([pub, np.repeat(pub[:1], 3, axis=0)])
    parts = [jed.comb_build_kernel(jnp.asarray(pad[i:i + 8]))
             for i in range(0, 16, 8)]
    jtab = [np.concatenate([np.asarray(p[0][f]) for p in parts],
                           axis=-1)[..., :13] for f in range(4)]
    jok = np.concatenate([np.asarray(p[1]) for p in parts])[:13]
    return {"adversarial": ([k for k, _ in KEYS], ref["ttab"], ref["tok"],
                            ref["jtab"], ref["jok"]),
            "ragged": (keys, ptab, pok.numpy(), jtab, jok)}


GROUPS = cc.GROUPS


# W blocks: (first lane, rows) over the 64 lanes at G = 1 and 8; the last
# at each G holds fewer rows than the block's signatures (a ragged tail)
FULL_BLOCKS = {1: [(0, 32), (32, 30)], 8: [(0, 4), (20, 4), (61, 3)]}


@pytest.fixture(scope="module")
def host_run(ref, build_refs, harness):
    """C1 on KEYS, then C2 on the 64 lanes at each G, then the full blocks
    of FULL_BLOCKS, then C1 on the ragged set: {("K", key set): [(verdict,
    2304 entries) a key], G: [64 lines], ("W", G): [a line a block]}."""
    def row(i):
        return "%d %s" % (ref["vidx"][i], bytes(ref["rows"][i]).hex())

    def build(keys):
        return "K %d %s" % (len(keys), " ".join(k.hex() for k in keys))
    lines = [build([k for k, _ in KEYS])]
    for g in GROUPS:
        lines += ["V %d %s" % (g, row(i)) for i in range(64)]
    for g, blocks in FULL_BLOCKS.items():
        lines += ["W %d %d %s" % (g, m, " ".join(row(i) for i in
                                                 range(a, a + m)))
                  for a, m in blocks]
    lines.append(build(build_refs["ragged"][0]))
    out = harness(lines)

    def keys_of(line):
        f = line.split()
        assert len(f) % 2305 == 0
        return [(int(f[i]), f[i + 1:i + 2305]) for i in range(0, len(f),
                                                              2305)]
    got = {("K", "adversarial"): keys_of(out[0]),
           ("K", "ragged"): keys_of(out[-1])}
    at = 1
    for g in GROUPS:
        got[g], at = out[at:at + 64], at + 64
    for g, blocks in FULL_BLOCKS.items():
        got[("W", g)], at = out[at:at + len(blocks)], at + len(blocks)
    return got


BUILD_SETS = ("adversarial", "ragged")


@pytest.mark.parametrize("keyset", BUILD_SETS)
def test_group_body_build_matches_plain(build_refs, host_run, keyset):
    """comb_build4 on 128 host threads a block of 8 keys, in the kernel's
    four roles (the chain warp's decode and doublings, the three helpers'
    multiples and entries, the ring's named barriers, each entry staged and
    copied as the block's run of the kernel's table; the ragged set's
    second block holds 5 keys): every entry of every key's table holds the
    plain C1's field values and the JAX comb_build_kernel's, as canonical
    bytes of each coordinate."""
    keys, ptab, _, jtab, _ = build_refs[keyset]
    got = host_run[("K", keyset)]
    want, want_jax = _canonical_hex(ptab), _canonical_hex(jtab)
    assert len(got) == len(want) == len(want_jax) == len(keys)
    assert want == want_jax
    for i, (_, entries) in enumerate(got):
        bad = [e for e in range(2304) if entries[e] != want[i][e]]
        assert not bad, (i, bad[:5])


@pytest.mark.parametrize("keyset", BUILD_SETS)
def test_group_body_build_decode_flags_match(build_refs, host_run, keyset):
    """The chain warp's decode verdicts on the host are the plain C1's and
    the JAX package's, key for key (the adversarial keys' as KEYS says;
    the ragged set holds both kinds)."""
    keys, _, pok, _, jok = build_refs[keyset]
    got = [ok for ok, _ in host_run[("K", keyset)]]
    assert got == [bool(v) for v in pok] == [bool(v) for v in jok]
    if keyset == "adversarial":
        assert got == [ok for _, ok in KEYS]
    else:
        assert 9 <= sum(got) < len(keys)


@pytest.mark.parametrize("groups", GROUPS)
def test_group_body_verify_matches_plain(ref, host_run, groups):
    """comb_verify4 on 4 G host threads (a block of one signature: the
    digits formed from s and k, G partial sums and their butterfly, the
    block's inversion), ANDed with the key's verdict as C2 does: the
    plain C2's raw bitmap on the 64 lanes, and P's affine x and y the
    plain version's on every lane whose key decodes (its projective
    coordinates differ: the partial sums are added in another order; a
    key that does not decode leaves the curve, where the sum depends on
    the order, and its lane fails either way)."""
    rows = [ln.split() for ln in host_run[groups]]
    got = np.array([int(r[0]) for r in rows], dtype=bool)
    np.testing.assert_array_equal(got, ref["tbits"])
    on_curve = [i for i in range(64) if KEYS[ref["vidx"][i]][1]]
    assert len(on_curve) == 62
    assert [rows[i][1] for i in on_curve] == [ref["px"][i] for i in on_curve]
    assert [rows[i][2] for i in on_curve] == [ref["py"][i] for i in on_curve]


@pytest.mark.parametrize("groups", sorted(FULL_BLOCKS))
def test_group_body_verify_full_block_matches_plain(ref, host_run, groups):
    """comb_verify4 on a full block of 128 host threads, 32 / G signatures
    of the 64 lanes: each signature's Z inverted by its own lane of the
    first warp at its C2_SIG_WORDS offset (lanes past the block's
    signatures invert 1), its digits and Z in its own shared words.  The
    raw bitmap is the plain C2's and P's affine x and y the plain
    version's on every lane whose key decodes; a ragged block's
    signatures past its rows repeat its last row's result."""
    n = 32 // groups
    for (a, m), line in zip(FULL_BLOCKS[groups], host_run[("W", groups)]):
        f = line.split()
        assert len(f) == 3 * n
        sigs = [f[3 * i:3 * i + 3] for i in range(n)]
        assert all(sg == sigs[m - 1] for sg in sigs[m:])
        got = np.array([int(sg[0]) for sg in sigs[:m]], dtype=bool)
        np.testing.assert_array_equal(got, ref["tbits"][a:a + m])
        for i in range(m):
            if KEYS[ref["vidx"][a + i]][1]:
                assert sigs[i][1:] == [ref["px"][a + i], ref["py"][a + i]], \
                    a + i


def test_group_body_digits_match_scalars_to_digits(harness):
    """The digits C2 forms on the card (digit_words, comb_digit) are
    scalars_to_digits's, for s = 0, L - 1, 2^252, all bytes 0x88 and
    2^256 - 1."""
    vals = [0, L - 1, 1 << 252, int.from_bytes(b"\x88" * 32, "little"),
            (1 << 256) - 1]
    got = harness(["D " + _enc(v).hex() for v in vals])
    want = ted.scalars_to_digits(np.frombuffer(
        b"".join(_enc(v) for v in vals), np.uint8).reshape(-1, 32))
    for v, line, w in zip(vals, got, want):
        assert [int(d) for d in line.split()] == w.tolist(), hex(v)
    assert sum(int(d) << (4 * i) for i, d in enumerate(want[1])) == L - 1


def test_fe10_conversion_holds_tables_as_values(ref):
    """tables_mismatch, the smoke's check of C1 on the card, finds no
    mismatch when 10-limb entries hold the plain tables' values (here
    every other one as the non-canonical v + p, limb by limb) and counts
    each entry that differs."""
    tab = ref["ttab"]
    K = len(KEYS)
    p10 = [(P >> ck._W10[i]) & ((1 << (ck._W10[i + 1] - ck._W10[i])) - 1)
           for i in range(10)]
    tab10 = torch.zeros((64, 9, K, 4, 10), dtype=torch.int32)
    for c, field in enumerate(tab):
        rows = field.permute(0, 1, 3, 2).reshape(-1, F.NLIMB).numpy()
        for n in range(rows.shape[0]):
            limbs = ck.fe10_limbs(F.limbs_to_int(rows[n]))
            if n % 2:
                limbs = [a + b for a, b in zip(limbs, p10)]
            w, rest = divmod(n, 9 * K)
            tab10[w, rest // K, rest % K, c] = torch.tensor(limbs)
    assert cc.tables_mismatch(tab10, tab) == 0
    tab10[3, 4, 2, 1, 0] += 1
    tab10[7, 0, 5, 3, 9] -= 1
    assert cc.tables_mismatch(tab10, tab) == 2


# ---------------------------------------------------------------------------
# (c) routing and runtime through both packages, kernels stubbed
# ---------------------------------------------------------------------------

def _digits_value(d) -> int:
    return sum(int(v) << (4 * i) for i, v in enumerate(d))


def _bignum(pub: bytes, r: bytes, s: int, k: int) -> bool:
    """The cofactorless verdict from the staged scalars (the ladder's
    arithmetic, in Python bignum)."""
    a = _edref._decode(pub)
    if a is None:
        return False
    neg_a = (P - a[0], a[1], 1, (P - a[0]) * a[1] % P)
    q = _edref._add(_edref._mul(s % L, _edref.BASE),
                    _edref._mul(k % L, neg_a))
    return _edref._encode(q) == r


def _stub(pkg, monkeypatch, rec, bits_for=None):
    """Both comb kernels as shape-checking stubs (bits_for(nb) gives the
    'device' bitmap, all true by default), and the package's ladder kernel
    as the bignum verdict on its staged rows."""
    if pkg is JAX:
        def build(pub):
            rec.setdefault("builds", []).append(pub.shape[0])
            return JC.Cached(None, None, None, None), \
                jnp.ones(pub.shape[0], dtype=bool)

        def kernel(r, sd, kd, vidx, ty, tm, tz, td, dok, by, bm, bt):
            nb = r.shape[0]
            assert sd.shape == (nb, 64) and kd.shape == (nb, 64)
            assert vidx.shape == (nb,)
            rec.setdefault("launches", []).append(nb)
            return jnp.asarray(bits_for(nb) if bits_for
                               else np.ones(nb, dtype=bool))

        def ladder(pub, r, s_digits, k_digits):
            pub, r = np.asarray(pub), np.asarray(r)
            sd, kd = np.asarray(s_digits), np.asarray(k_digits)
            return jnp.asarray(np.array([_bignum(
                pub[i].tobytes(), r[i].tobytes(), _digits_value(sd[i]),
                _digits_value(kd[i])) for i in range(pub.shape[0])]))
        monkeypatch.setattr(jed, "comb_build_kernel", build)
        monkeypatch.setattr(jed, "comb_kernel", kernel)
        monkeypatch.setattr(jed, "_base_comb", lambda: (None, None, None))
        monkeypatch.setattr(jed, "verify_kernel", ladder)
        monkeypatch.setattr(jsharding, "_PLANE", False)
        return

    def tbuild(pub):
        rec.setdefault("builds", []).append(pub.shape[0])
        return C.Cached(None, None, None, None), \
            torch.ones(pub.shape[0], dtype=torch.bool)

    def tkernel(rows, tables, dec_ok):
        nb = rows.shape[0]
        assert rows.shape == (nb, cc.ROW_BYTES) and rows.dtype == torch.uint8
        rec.setdefault("launches", []).append(nb)
        return torch.from_numpy(np.asarray(
            bits_for(nb) if bits_for else np.ones(nb, dtype=bool)))

    def tladder(packed):
        b = packed.numpy().view(np.uint8)
        return torch.from_numpy(np.array([_bignum(
            b[0:32, i].tobytes(), b[32:64, i].tobytes(),
            int.from_bytes(b[64:96, i].tobytes(), "little"),
            int.from_bytes(b[96:128, i].tobytes(), "little"))
            for i in range(b.shape[1])]))
    monkeypatch.setattr(cc, "comb_build", tbuild)
    monkeypatch.setattr(cc, "comb_verify", tkernel)
    monkeypatch.setattr(ck, "verify_packed", tladder)


def _batch(n, pool=6, tag=b"comb", base=0x7A00):
    seeds = [(base + i % pool).to_bytes(32, "little") for i in range(n)]
    msgs = [b"%s vote %d" % (tag, i) for i in range(n)]
    pubs = [_edref.pubkey_from_seed(s) for s in seeds]
    sigs = [_edref.sign(s, m) for s, m in zip(seeds, msgs)]
    return pubs, msgs, sigs


def _oracle(pubs, msgs, sigs):
    return np.array([_edref.verify(bytes(p), bytes(m), bytes(s))
                     for p, m, s in zip(pubs, msgs, sigs)])


def _launch(pkg) -> tuple:
    """The launch record's route keys, the ladder path named alike (its
    padding differs: the port's K1 launches at least TILE lanes)."""
    ll = pkg.ed.last_launch()
    ladder = ll["path"] == pkg.ladder
    return ("ladder" if ladder else ll["path"], ll["n"],
            None if ladder else ll["nb"], ll.get("table_build"),
            ll.get("set_k"), ll.get("k_pad"), ll.get("group_ops"))


def _route(rt, path="comb") -> tuple:
    m = rt.metrics
    return tuple(m.msm_route.value(path=path, outcome=o)
                 for o in ("executed", "declined", "error"))


def _tables(pkg, rt) -> tuple:
    m = rt.metrics
    ledger = pkg.devobs.ledger_report().get("table_cache", {}).get("bytes")
    return (m.table_hits.value(), m.table_evictions.value(),
            m.table_cache_bytes.value(), pkg.ed._table_cache.total_bytes,
            ledger)


def test_routing_build_hit_subset_mixed(monkeypatch):
    pubs, msgs, sigs = _batch(24)
    s2 = (0x9911).to_bytes(32, "little")
    mixed = (pubs[:3] + [_edref.pubkey_from_seed(s2)], msgs[:3] + [b"m"],
             sigs[:3] + [_edref.sign(s2, b"m")])

    def play(pkg):
        rt = pkg.deg.configure(registry=pkg.Registry("comb_route"))
        rec = {}
        _stub(pkg, monkeypatch, rec)
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 8)
        obs = []
        # below the build floor with nothing cached: no build
        assert pkg.ed._comb_try(pubs[:4], msgs[:4], sigs[:4], True,
                                None if pkg is JAX else
                                torch.device("cpu")) is None
        assert "builds" not in rec
        obs.append(pkg.ed.verify_batch(pubs, msgs, sigs,
                                       cache_pubs=True).tolist())
        obs += [_launch(pkg), list(rec["builds"])]
        obs.append(pkg.ed.verify_batch(pubs, msgs, sigs).tolist())
        obs += [_launch(pkg), _tables(pkg, rt)]
        obs.append(pkg.ed.verify_batch(pubs[:5], msgs[:5], sigs[:5])
                   .tolist())
        obs += [_launch(pkg), _tables(pkg, rt)]
        n0 = len(rec["launches"])
        obs.append(pkg.ed.verify_batch(*mixed).tolist())
        obs += [_launch(pkg), len(rec["launches"]) - n0, _route(rt)]
        return obs
    obs = _both(play)
    assert obs[1][:3] == ("comb", 24, 64) and obs[1][3] and obs[1][4] == 6
    assert obs[1][6] == {"doublings": 0, "adds": 128} and obs[2] == [8]
    assert obs[4][0] == "comb" and not obs[4][3]
    assert obs[5][0] == 1 and obs[5][2] == obs[5][3] == obs[5][4] == \
        8 * 202_752
    assert obs[7][0] == "comb" and obs[8][0] == 2
    assert obs[9] == [True] * 4 and obs[10][0] == "ladder" and obs[11] == 0
    assert obs[12] == (3, 0, 0)


def test_routing_reuses_ladder_lane_buckets(monkeypatch):
    def play(pkg):
        pkg.deg.configure(registry=pkg.Registry("comb_bkt"))
        rec = {}
        _stub(pkg, monkeypatch, rec)
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 1)
        out = []
        for n in (5, 24, 64, 90):
            pubs, msgs, sigs = _batch(n, pool=min(n, 6), tag=b"bkt%d" % n)
            assert pkg.ed.verify_batch(pubs, msgs, sigs,
                                       cache_pubs=True).shape == (n,)
            out.append(pkg.ed.last_launch()["nb"])
        return out, rec["launches"], rec["builds"]
    nbs, launches, builds = _both(play)
    assert nbs == launches == [ted.bucket_size(n) for n in (5, 24, 64, 90)]
    assert all(k >= 8 and k & (k - 1) == 0 for k in builds)


def test_routing_disabled_and_budget_declined(monkeypatch):
    pubs, msgs, sigs = _batch(12)

    def play(pkg):
        rt = pkg.deg.configure(registry=pkg.Registry("comb_cfg"))
        rec = {}
        _stub(pkg, monkeypatch, rec)
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 1)
        pkg.ed.set_comb_config(enabled=False)
        a = pkg.ed.verify_batch(pubs, msgs, sigs, cache_pubs=True).tolist()
        la = _launch(pkg)
        pkg.ed.set_comb_config(enabled=True, table_cache_mb=0)
        b = pkg.ed.verify_batch(pubs, msgs, sigs, cache_pubs=True).tolist()
        return a, la, b, _launch(pkg), "launches" in rec, _route(rt)
    a, la, b, lb, launched, route = _both(play)
    assert a == b == [True] * 12 and la[0] == lb[0] == "ladder"
    assert not launched and route == (0, 1, 0)


def test_routing_eviction_midstream_falls_back(monkeypatch):
    pa = _batch(12, tag=b"setA")
    pb = _batch(12, tag=b"setB", base=0x7F00)

    def play(pkg):
        rt = pkg.deg.configure(registry=pkg.Registry("comb_evict"))
        _stub(pkg, monkeypatch, {})
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 1)
        pkg.ed.set_comb_config(table_cache_mb=2)   # one k_pad=8 set fits
        obs = [pkg.ed.verify_batch(*pa, cache_pubs=True).all(),
               _launch(pkg)[0],
               pkg.ed.verify_batch(*pb, cache_pubs=True).all(),
               _tables(pkg, rt), len(pkg.ed._table_cache)]
        out = pkg.ed.verify_batch(*pa)
        obs += [_launch(pkg)[0], out.tolist() == _oracle(*pa).tolist()]
        with pkg.ed._table_key_lock:
            obs.append(len(pkg.ed._table_key_index))
        return obs
    obs = _both(play)
    assert obs[:3] == [True, "comb", True] and obs[3][1] == 1
    assert obs[4] == 1 and obs[5] == "ladder" and obs[6] and obs[7] == 6


def test_routing_eviction_of_overlapping_set_repoints_keys(monkeypatch):
    seeds_a = [(0x7A00 + i).to_bytes(32, "little") for i in range(6)]
    seeds_b = seeds_a[:4] + [(0x9A00 + i).to_bytes(32, "little")
                             for i in range(2)]
    seeds_c = [(0xBB00 + i).to_bytes(32, "little") for i in range(6)]

    def sigset(seeds, tag):
        msgs = [b"%s vote %d" % (tag, i) for i in range(len(seeds))]
        return ([_edref.pubkey_from_seed(s) for s in seeds], msgs,
                [_edref.sign(s, m) for s, m in zip(seeds, msgs)])

    def play(pkg):
        rt = pkg.deg.configure(registry=pkg.Registry("comb_repoint"))
        _stub(pkg, monkeypatch, {})
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 1)
        pkg.ed.set_comb_config(table_cache_mb=4)   # two k_pad=8 sets fit
        for seeds, tag in ((seeds_a, b"A"), (seeds_b, b"B")):
            assert pkg.ed.verify_batch(*sigset(seeds, tag),
                                       cache_pubs=True).all()
        n2 = len(pkg.ed._table_cache)
        assert pkg.ed.verify_batch(*sigset(seeds_a, b"A2")).all()
        assert pkg.ed.verify_batch(*sigset(seeds_c, b"C"),
                                   cache_pubs=True).all()
        assert pkg.ed.verify_batch(*sigset(seeds_a[:4], b"A3")).all()
        with pkg.ed._table_key_lock:
            nkeys = len(pkg.ed._table_key_index)
        return n2, len(pkg.ed._table_cache), _launch(pkg)[0], nkeys, \
            _tables(pkg, rt)
    n2, n3, path, nkeys, tables = _both(play)
    assert (n2, n3, path, nkeys) == (2, 2, "comb", 12) and tables[1] == 1


def test_routing_batch_over_max_chunk_is_chunked(monkeypatch):
    pubs, msgs, sigs = _batch(150)

    def play(pkg):
        pkg.deg.configure(registry=pkg.Registry("comb_chunk"))
        rec, state = {}, {"arm": False, "i": 0}

        def bits(nb):
            # armed: the third launch (the tail chunk) rejects lane 21
            state["i"] += 1
            v = np.ones(nb, dtype=bool)
            if state["arm"] and state["i"] % 3 == 0:
                v[21] = False
            return v
        _stub(pkg, monkeypatch, rec, bits_for=bits)
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 1)
        monkeypatch.setattr(pkg.ed, "MAX_CHUNK", 64)
        a = pkg.ed.verify_batch(pubs, msgs, sigs, cache_pubs=True)
        la = _launch(pkg)
        state["arm"] = True
        b = pkg.ed.verify_batch(pubs, msgs, sigs)
        return a.tolist(), rec["launches"], la, b.tolist()
    a, launches, la, b = _both(play)
    assert a == [True] * 150 and launches == [64] * 6
    assert la[:3] == ("comb", 150, 192)
    assert b == [True] * 149 + [False]


def _chaos_runtime(pkg):
    cfg = pkg.deg.DegradeConfig(
        failure_threshold=3, launch_timeout_s=120.0,
        backoff_base_s=10.0, backoff_max_s=100.0, backoff_jitter=0.0)
    return pkg.deg.configure(cfg, clock=lambda: 0.0,
                             registry=pkg.Registry("comb_chaos"))


@pytest.mark.parametrize("mode,reason", [
    ("corrupt-bitmap", "integrity"), ("raise", "raise")])
def test_chaos_at_comb_site_bitmap_exact(monkeypatch, mode, reason):
    """corrupt-bitmap at the comb site is caught by the runtime's host spot
    check, an injected raise degrades the lane; either way the caller's
    bitmap is the host path's, in both packages."""
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    seeds = [bytes([i + 1]) * 32 for i in range(16)]
    msgs = [b"comb chaos %d" % i for i in range(16)]
    sigs = [_edref.sign(s, m) for s, m in zip(seeds, msgs)]
    sigs[5] = bytes([sigs[5][0] ^ 1]) + sigs[5][1:]
    pubs = [_edref.pubkey_from_seed(s) for s in seeds]
    truth = _oracle(pubs, msgs, sigs)
    assert not truth[5] and truth.sum() == 15

    def play(pkg):
        rt = _chaos_runtime(pkg)
        _stub(pkg, monkeypatch, {},
              bits_for=lambda nb: np.pad(truth, (0, nb - len(truth))))
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 1)
        assert pkg.ed.verify_batch(pubs, msgs, sigs,
                                   cache_pubs=True).tolist() == \
            truth.tolist()
        assert _launch(pkg)[0] == "comb"
        pkg.fail.set_mode("ops.ed25519.comb", mode)
        bv = pkg.cb.BatchVerifier(tpu_threshold=4)
        for p, m, s in zip(pubs, msgs, sigs):
            bv.add(pkg.keys.PubKey(p), m, s)
        ok, bits = bv.verify()
        m_ = rt.metrics
        return (ok, bits.tolist(), pkg.fail.fired("ops.ed25519.comb",
                                                  mode) >= 1,
                m_.device_failures.value(site="batch.ed25519",
                                         reason=reason),
                m_.host_fallbacks.value(site="batch.ed25519",
                                        reason=reason))
    ok, bits, fired, fails, falls = _both(play)
    assert not ok and bits == truth.tolist() and fired
    assert fails == falls == 1


def test_real_device_fault_propagates_like_chaos(monkeypatch):
    """A RuntimeError out of C2 (the class a failed launch raises) reaches
    the caller, not routed as a comb bug and not re-run on the ladder; any
    other exception is routed comb/error and the ladder verifies."""
    pubs, msgs, sigs = _batch(16)

    def play(pkg):
        rt = pkg.deg.configure(registry=pkg.Registry("comb_fault"))
        _stub(pkg, monkeypatch, {})
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 8)
        assert pkg.ed.verify_batch(pubs, msgs, sigs, cache_pubs=True).all()
        mod, name = (jed, "comb_kernel") if pkg is JAX else \
            (cc, "comb_verify")

        def dying(*a, **kw):
            raise RuntimeError("device halted")
        monkeypatch.setattr(mod, name, dying)
        with pytest.raises(RuntimeError, match="device halted"):
            pkg.ed.verify_batch(pubs, msgs, sigs, cache_pubs=True)
        raised = _route(rt)

        def buggy(*a, **kw):
            raise IndexError("a comb bug")
        monkeypatch.setattr(mod, name, buggy)
        out = pkg.ed.verify_batch(pubs, msgs, sigs).tolist()
        return raised, out, _launch(pkg)[0], _route(rt)
    raised, out, path, route = _both(play)
    assert raised == (1, 0, 0) and out == [True] * 16
    assert path == "ladder" and route == (1, 0, 1)


def test_ladder_bound_batch_skips_distinct_key_sort(monkeypatch):
    pubs, msgs, sigs = _batch(16)
    other = _batch(12, tag=b"unknown", pool=12, base=0x8B00)

    def play(pkg):
        pkg.deg.configure(registry=pkg.Registry("comb_sort"))
        rec = {}
        _stub(pkg, monkeypatch, rec)
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 8)
        assert pkg.ed.verify_batch(pubs, msgs, sigs, cache_pubs=True).all()

        def boom(*a, **kw):
            raise AssertionError("np.unique on a ladder-bound batch")
        dev = None if pkg is JAX else torch.device("cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(np, "unique", boom)
            skipped = pkg.ed._comb_try(*other, False, dev) is None
        ok = pkg.ed.verify_batch(pubs[:6], msgs[:6], sigs[:6]).all()
        return rec["builds"], skipped, ok, _launch(pkg)[0]
    assert _both(play) == ([8], True, True, "comb")


def _lru_state(pkg) -> tuple:
    """The table cache's recency order (set hashes), hits and misses."""
    lru = pkg.ed._table_cache
    order = [k if pkg is JAX else k[0] for k in lru.keys()]
    return order, lru.hits, lru.misses


def _early_world(pkg, monkeypatch, name):
    """A runtime, stubbed kernels, and two resident 8-key sets: A (keys
    starting 00 00 .. 07 00, the smallest of any batch below) built
    before B, so that A is the least recent."""
    rt = pkg.deg.configure(registry=pkg.Registry(name))
    rec = {}
    _stub(pkg, monkeypatch, rec)
    monkeypatch.setattr(pkg.ed, "_comb_min_override", 1)
    monkeypatch.setattr(pkg.ed._table_cache, "hits", 0)
    monkeypatch.setattr(pkg.ed._table_cache, "misses", 0)
    for tag in (0, 1):
        uniq = np.zeros((8, 32), np.uint8)
        uniq[:, 0] = np.arange(8) if tag == 0 else 0xF0 + np.arange(8)
        uniq[:, 31] = 0x5A
        h = hashlib.sha256(uniq.tobytes()).digest()
        if pkg is JAX:
            pkg.ed._table_build(uniq, h)
        else:
            pkg.ed._table_build(uniq, h, torch.device("cpu"))
    return rt, rec


def _distinct_keys(n, seed=12):
    """n distinct random keys, none of them starting with 00 or F0-F7."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    keys[:, 0] = 8 + keys[:, 0] % 0xE8
    assert np.unique(keys, axis=0).shape[0] == n
    return keys


def test_early_decline_skips_the_distinct_key_sort(monkeypatch):
    """A buildable batch of 100,000 distinct keys (any batch of at least
    one key builds here), one of them in the
    resident set A, is over the 256 MiB budget: the port declines it
    from a lower bound on its distinct keys without the 2-D distinct-key
    sort, and its route counters, table metrics and the cache's recency
    and hit/miss counts are the JAX package's, which sorts."""
    keys = _distinct_keys(100_000)
    keys[7] = 0
    keys[7, 0], keys[7, 31] = 3, 0x5A           # A's key 3, the smallest
    z64 = np.zeros((len(keys), 64), np.uint8)

    def play(pkg):
        rt, rec = _early_world(pkg, monkeypatch, "comb_early")
        before = _lru_state(pkg)
        dev = None if pkg is JAX else torch.device("cpu")
        with pytest.MonkeyPatch.context() as mp:
            if pkg is PORT:
                real = np.unique

                def unique(a, *args, **kw):
                    if kw.get("axis") is not None or len(args) > 2:
                        raise AssertionError("the 2-D distinct-key sort")
                    return real(a, *args, **kw)
                mp.setattr(np, "unique", unique)
            out = pkg.ed._comb_try(keys, [b""] * len(keys), z64, True, dev)
        return (out, rec["builds"], _route(rt), _tables(pkg, rt), before,
                _lru_state(pkg), "launches" in rec)
    out, builds, route, tables, before, after, launched = _both(play)
    assert out is None and builds == [8, 8] and not launched
    assert route == (0, 1, 0) and tables[2] == 16 * 202_752
    # the exact lookup missed by set hash and touched A, the owner of the
    # batch's smallest key: A is now the most recent
    assert after[0] == before[0][::-1] and after[1:] == (1, 1)


def test_early_decline_leaves_colliding_prefixes_to_the_exact_path(
        monkeypatch):
    """2,048 distinct keys that share their first 8 bytes bound the
    distinct keys at 1, so the batch takes the exact path (the 2-D sort
    runs once) and the budget declines it there, as in the JAX
    package."""
    keys = _distinct_keys(2048, seed=13)
    keys[:, :8] = keys[0, :8]

    def play(pkg):
        rt, rec = _early_world(pkg, monkeypatch, "comb_collide")
        sorts = []
        real = np.unique

        def unique(a, *args, **kw):
            if kw.get("axis") == 0:
                sorts.append(a.shape)
            return real(a, *args, **kw)
        dev = None if pkg is JAX else torch.device("cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(np, "unique", unique)
            out = pkg.ed._comb_try(keys, [b""] * len(keys),
                                   np.zeros((len(keys), 64), np.uint8),
                                   True, dev)
        return out, sorts, _route(rt), _tables(pkg, rt), _lru_state(pkg)
    out, sorts, route, tables, lru = _both(play)
    assert out is None and sorts == [(2048, 32)] and route == (0, 1, 0)


def test_early_decline_leaves_a_resident_superset_to_the_exact_path(
        monkeypatch):
    """A 40-key set built before the budget fell to 4 MiB stays resident;
    a batch of 20 of its keys (over the new budget as a set of its own)
    is not declined early, since the set can resolve it: the comb runs,
    as in the JAX package."""
    pubs, msgs, sigs = _batch(40, pool=40, tag=b"superset", base=0x6A00)

    def play(pkg):
        rt = pkg.deg.configure(registry=pkg.Registry("comb_superset"))
        rec = {}
        _stub(pkg, monkeypatch, rec)
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 8)
        assert pkg.ed.verify_batch(pubs, msgs, sigs, cache_pubs=True).all()
        pkg.ed.set_comb_config(table_cache_mb=4)
        out = pkg.ed.verify_batch(pubs[:20], msgs[:20], sigs[:20],
                                  cache_pubs=True).tolist()
        return out, _launch(pkg), rec["builds"], _route(rt), _tables(pkg, rt)
    out, launch, builds, route, tables = _both(play)
    assert out == [True] * 20 and launch[0] == "comb" and not launch[3]
    assert builds == [64] and route == (2, 0, 0)


def test_set_comb_config_wins_over_env(monkeypatch):
    monkeypatch.setenv("TM_TPU_COMB", "0")
    monkeypatch.setenv("TM_TPU_TABLE_CACHE_MB", "1")
    monkeypatch.setenv("TM_TPU_COMB_MIN", "77")

    def play(pkg):
        out = [pkg.ed.comb_enabled(), pkg.ed.table_cache_budget_bytes(),
               pkg.ed.comb_min_batch()]
        pkg.ed.set_comb_config(enabled=True, table_cache_mb=512,
                               min_batch=9)
        out += [pkg.ed.comb_enabled(), pkg.ed.table_cache_budget_bytes(),
                pkg.ed.comb_min_batch()]
        return out
    assert _both(play) == [False, 1 << 20, 77, True, 512 << 20, 9]
    assert ted._TABLE_BYTES_PER_KEY == jed._TABLE_BYTES_PER_KEY == 202_752
    assert ted.comb_min_batch() == 9 and (ted.PUB_CACHE_MIN,
                                          ted.PREWARM_MIN_KEYS,
                                          ted.TABLE_CACHE_MB_DEFAULT) == \
        (jed.PUB_CACHE_MIN, jed.PREWARM_MIN_KEYS, jed.TABLE_CACHE_MB_DEFAULT)


def test_prewarm_builds_off_path(monkeypatch):
    """prewarm builds a set of at least PREWARM_MIN_KEYS keys and warms the
    (comb, 64) bucket; a later verify of the set records no first launch.
    Declines: the comb off, a set below the floor, a budget too small."""
    keys = [_edref.pubkey_from_seed((0x6600 + i).to_bytes(32, "little"))
            for i in range(40)]
    pubs, msgs, sigs = keys[:10], [b"pw %d" % i for i in range(10)], None
    sigs = [_edref.sign((0x6600 + i).to_bytes(32, "little"), m)
            for i, m in enumerate(msgs)]

    def play(pkg):
        rt = pkg.deg.configure(registry=pkg.Registry("comb_prewarm"))
        rec = {}
        _stub(pkg, monkeypatch, rec)
        pkg.ed.set_comb_config(enabled=False)
        out = [pkg.ed.prewarm(keys)]
        pkg.ed.set_comb_config(enabled=True)
        out += [pkg.ed.prewarm(keys[:31]), pkg.ed.prewarm(keys),
                list(rec["builds"]), list(rec["launches"]),
                pkg.ed.prewarm(keys), list(rec["builds"])]
        out.append(pkg.ed.verify_batch(pubs, msgs, sigs).tolist())
        ll = pkg.ed.last_launch()
        out += [ll["path"], ll["first_launch"], _tables(pkg, rt)]
        pkg.ed.table_cache_clear()
        pkg.ed.set_comb_config(table_cache_mb=1)
        out += [pkg.ed.prewarm(keys), _route(rt)]
        return out
    out = _both(play)
    assert out[:3] == [False, False, True] and out[3] == [64]
    assert out[4] == [64] and out[5] is True and out[6] == [64]
    assert out[7] == [True] * 10 and out[8:10] == ["comb", False]
    assert out[11] is False and out[12][1] == 1


def test_prewarm_async_runs_off_the_caller(monkeypatch):
    keys = [_edref.pubkey_from_seed((0x6700 + i).to_bytes(32, "little"))
            for i in range(32)]

    def play(pkg):
        pkg.deg.configure(registry=pkg.Registry("comb_prewarm_async"))
        rec = {}
        _stub(pkg, monkeypatch, rec)
        pkg.ed.prewarm_async(keys)
        end = time.monotonic() + 30
        while "launches" not in rec and time.monotonic() < end:
            time.sleep(0.01)   # the warm verify ends the prewarm
        return len(pkg.ed._table_cache), rec["builds"]
    assert _both(play) == (1, [32])


def test_port_tables_are_keyed_by_device(monkeypatch):
    """A set built on the CPU does not resolve for another device."""
    _stub(PORT, monkeypatch, {})
    keys = [_edref.pubkey_from_seed((0x6800 + i).to_bytes(32, "little"))
            for i in range(32)]
    assert ted.prewarm(keys, warm_kernel=False, device="cpu")
    uniq = np.unique(np.frombuffer(b"".join(keys), np.uint8)
                     .reshape(-1, 32), axis=0)
    assert ted._table_lookup(uniq, torch.device("cpu"))[0] is not None
    assert ted._table_lookup(uniq, torch.device("meta")) == (None, None)
    assert ted._table_lookup(uniq[:5], torch.device("meta")) == (None, None)
    (key,) = ted._table_cache.keys()
    assert key[1] == "cpu"


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_device_lru_bounds_and_recency(pkg):
    evicted = []
    lru = pkg.ed.DeviceLRU(max_entries=3,
                           on_evict=lambda k, v: evicted.append(k))
    for i in range(5):
        lru.put(i, f"v{i}")
    assert len(lru) == 3 and evicted == [0, 1]
    assert lru.get(2) == "v2"
    assert lru.peek(3) == "v3" and lru.hits == 1   # peek: no recency
    lru.put(9, "v9")
    assert 2 in lru and 3 not in lru
    assert lru.hits == 1 and lru.evictions == 3
    assert lru.pop(9) == "v9" and lru.pop(9) is None


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_device_lru_byte_bound_and_first_wins(pkg):
    lru = pkg.ed.DeviceLRU(max_bytes=100)
    lru.put("a", 1, nbytes=60)
    lru.put("b", 2, nbytes=60)
    assert "a" not in lru and lru.total_bytes == 60
    assert lru.put("b", 3, nbytes=60) == 2
    assert lru.total_bytes == 60
    lru2 = pkg.ed.DeviceLRU(max_bytes=10)
    lru2.put("big", 1, nbytes=50)
    assert "big" in lru2
    lru2.clear()
    assert len(lru2) == 0 and lru2.total_bytes == 0


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_device_lru_never_over_bound_under_concurrency(pkg):
    lru = pkg.ed.DeviceLRU(max_entries=4)
    stop = threading.Event()
    violations = []

    def hammer(tid):
        rng = np.random.default_rng(tid)
        while not stop.is_set():
            k = int(rng.integers(0, 12))
            if lru.get(k) is None:
                lru.put(k, k)

    def watch():
        while not stop.is_set():
            n = len(lru)
            if n > 4:
                violations.append(n)

    threads = [threading.Thread(target=hammer, args=(t,), daemon=True)
               for t in range(6)] + \
        [threading.Thread(target=watch, daemon=True)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert not violations and len(lru) <= 4


def test_pub_cache_keeps_its_bound():
    assert ted._pub_cache.max_entries == jed._pub_cache.max_entries == 4
    assert ted._pub_cache.max_bytes is None


def test_comb_through_the_scheduler(monkeypatch):
    """A VerifyScheduler window whose keys resolve to a cached set runs
    the comb on its sched.ed25519 lane: the exact bitmap, path comb."""
    from tendermint_tpu.crypto import scheduler as jvs
    from tendermint_tpu_torch.crypto import scheduler as tvs

    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    seeds = [bytes([0x41 + i]) * 32 for i in range(8)]
    pubs = [_edref.pubkey_from_seed(s) for s in seeds]
    msgs = [b"sched comb %d" % i for i in range(32)]
    sigs = [_edref.sign(seeds[i % 8], m) for i, m in enumerate(msgs)]
    sigs[7] = bytes([sigs[7][0] ^ 1]) + sigs[7][1:]
    lanes = [pubs[i % 8] for i in range(32)]
    truth = _oracle(lanes, msgs, sigs)

    def play(pkg):
        vs = jvs if pkg is JAX else tvs
        rt = pkg.deg.configure(registry=pkg.Registry("comb_sched"))
        rec = {}
        _stub(pkg, monkeypatch, rec, bits_for=lambda nb: np.pad(
            truth, (0, nb - len(truth))))
        monkeypatch.setattr(pkg.ed, "_comb_min_override", 1)
        assert pkg.ed.verify_batch(lanes, msgs, sigs,
                                   cache_pubs=True).tolist() == \
            truth.tolist()
        monkeypatch.setattr(pkg.cb, "verified_sigs", pkg.cb.SigCache())
        sched = vs.install(vs.VerifyScheduler(window_s=0.001,
                                              tpu_threshold=4))
        sched.start()
        try:
            items = [(pkg.keys.PubKey(lanes[i]), msgs[i], sigs[i])
                     for i in range(32)]
            bits = sched.submit(items, vs.Priority.CONSENSUS).result(
                timeout=60)
        finally:
            sched.stop()
            vs.uninstall(sched)
        return (bits.tolist(), _launch(pkg)[:3], len(rec["launches"]),
                rt.metrics.device_launches.value(site="sched.ed25519"))
    bits, launch, n, site = _both(play)
    assert bits == truth.tolist() and launch == ("comb", 32, 64)
    assert n == 2 and site == 1
