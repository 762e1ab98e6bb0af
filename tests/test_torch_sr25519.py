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
all the inputs (module-scoped fixtures).  Inputs are made from seeds; the
comparisons are exact."""
from __future__ import annotations

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tendermint_tpu.crypto import _ristretto as rr
from tendermint_tpu.crypto import sr25519 as jkeys
from tendermint_tpu.libs import native as jnative
from tendermint_tpu.ops import ed25519 as jed
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
# kernel S2's body on the host
# ---------------------------------------------------------------------------

HARNESS = r"""
#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

#include "fe25519.cuh"
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

extern "C" {
// rows (n, 128) row-major A | R | s | k little-endian; base 270 ints
void s2_verify(const uint8_t *rows, const int32_t *base, uint8_t *out,
               int n) {
  Group g;
  std::vector<std::thread> lanes;
  for (int t = 0; t < 4; t++)
    lanes.emplace_back([&, t] {
      HostXch x{t, &g};
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
  for (auto &th : lanes) th.join();
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
}
"""


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
    vp = ctypes.c_void_p
    lib.s2_verify.argtypes = [vp, vp, vp, ctypes.c_int]
    lib.s2_decode.argtypes = [vp, vp, vp, vp, ctypes.c_int]
    return lib


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
    base = np.ascontiguousarray(ck.base_table10().reshape(-1))
    out = np.zeros(rows.shape[0], np.uint8)
    harness.s2_verify(rows.ctypes.data, base.ctypes.data, out.ctypes.data,
                      rows.shape[0])
    assert out.astype(bool).tolist() == plain.tolist()
    assert plain.any() and not plain.all()
