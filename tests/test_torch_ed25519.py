"""Port verify_batch(device="cpu") — the kernels' plain versions behind the
packed, split and pipelined routes — against the JAX package's
verify_batch (its XLA route on the CPU) and the pure-Python oracle, on the
vectors of tests/test_ed25519.py plus a non-canonical y, x = 0 with the
sign bit and a non-canonical R."""
import random

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import _edref
from tendermint_tpu.ops import ed25519 as jed

import tendermint_tpu_torch as T
from tendermint_tpu_torch.ops import cuda_ed25519 as ck
from tendermint_tpu_torch.ops import ed25519 as ted

P = _edref.P
L = _edref.L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is thousands of small tensor ops: with one intra-op
    thread per test process they do not contend with parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    T.set_default_device("cpu")
    yield
    T.set_default_device("cuda")


def _vectors():
    """(pubs, msgs, sigs): valid triples, bit flips in sig / msg / pub,
    s + L, a non-square y, the identity and small-order keys, x = 0 with
    the sign bit, non-canonical y (accepted, reduced) and non-canonical R
    (rejected)."""
    rng = random.Random(42)
    n = 12
    seeds = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n)]
    msgs = [bytes(rng.randrange(256) for _ in range(64)) for _ in range(n)]
    pubs = [_edref.pubkey_from_seed(s) for s in seeds]
    sigs = [_edref.sign(s, m) for s, m in zip(seeds, msgs)]
    P_, M_, S_ = list(pubs), list(msgs), list(sigs)
    for i in range(n):
        p, m, s = pubs[i], msgs[i], sigs[i]
        if i % 3 == 0:
            b = bytearray(s)
            b[rng.randrange(64)] ^= 1 << rng.randrange(8)
            s = bytes(b)
        elif i % 3 == 1:
            b = bytearray(m)
            b[rng.randrange(len(b))] ^= 1
            m = bytes(b)
        else:
            b = bytearray(p)
            b[rng.randrange(32)] ^= 1 << rng.randrange(8)
            p = bytes(b)
        P_.append(p), M_.append(m), S_.append(s)
    p0, m0, s0 = pubs[0], msgs[0], sigs[0]
    s_plus_l = int.from_bytes(s0[32:], "little") + L
    y_ns = 2
    while _edref._recover_x(y_ns, 0) is not None:
        y_ns += 1
    ident = (1).to_bytes(32, "little")
    enc = lambda v: v.to_bytes(32, "little")  # noqa: E731
    edges = [
        (p0, m0, s0[:32] + s_plus_l.to_bytes(32, "little")),
        (enc(y_ns), m0, s0),
        (ident, m0, s0),
        (enc(P - 1), m0, s0),                  # order 2
        (enc(0), m0, s0),                      # order 4
        (enc(1 | (1 << 255)), m0, s0),         # x = 0 with the sign bit
        (enc(P + 1), m0, ident + bytes(32)),   # non-canonical y: accepted
        (ident, m0, ident + bytes(32)),        # [0]B + [k](-O) = R = O
        (ident, m0, enc(P + 1) + bytes(32)),   # non-canonical R: rejected
        (enc(P + 1), m0, s0),
    ]
    for p, m, s in edges:
        P_.append(p), M_.append(m), S_.append(s)
    return P_, M_, S_


@pytest.fixture(scope="module")
def vectors():
    pubs, msgs, sigs = _vectors()
    oracle = np.array([_edref.verify(p, m, s)
                       for p, m, s in zip(pubs, msgs, sigs)])
    ref = np.asarray(jed.verify_batch(pubs, msgs, sigs))
    np.testing.assert_array_equal(ref, oracle)
    # the vectors hold accepts and rejects of every kind
    assert oracle[:12].all() and not oracle[12:24].any()
    assert list(oracle[24:]) == [False] * 6 + [True, True, False, False]
    return pubs, msgs, sigs, ref


def test_packed_route(vectors):
    pubs, msgs, sigs, ref = vectors
    out = ted.verify_batch(pubs, msgs, sigs)
    np.testing.assert_array_equal(out, ref)
    rec = ted.last_launch()
    assert (rec["path"], rec["device"], rec["n"], rec["nb"],
            rec["chunks"]) == ("cuda", "cpu", len(pubs), 256, 1)


def test_split_route(vectors, monkeypatch):
    """cache_pubs with PUB_CACHE_MIN lowered (as test_pub_cache_routing
    does): the split layout through verify_packed_split's plain version,
    chunked, with the pubkey rows cached across calls."""
    pubs, msgs, sigs, ref = vectors
    monkeypatch.setattr(ted, "PUB_CACHE_MIN", 16)
    monkeypatch.setattr(ted, "SPLIT_CHUNK", 16)
    monkeypatch.setattr(ted, "TILE", 16)
    monkeypatch.setattr(ted, "_pub_cache",
                        ted.DeviceLRU(max_entries=ted._PUB_CACHE_MAX))
    # the comb would build tables for a cache_pubs batch this size
    monkeypatch.setattr(ted, "_comb_enabled_override", False)
    out = ted.verify_batch(pubs, msgs, sigs, cache_pubs=True)
    np.testing.assert_array_equal(out, ref)
    rec = ted.last_launch()
    n = len(pubs)
    assert rec["path"] == "cuda-split" and rec["nb"] == -(-n // 16) * 16
    assert rec["chunks"] == rec["nb"] // 16
    assert len(ted._pub_cache) == 1
    key, = ted._pub_cache.keys()
    chunks = ted._pub_cache.get(key)
    assert len(chunks) == rec["chunks"]
    assert all(c.shape == (32, 16) and c.dtype == torch.uint8
               for c in chunks)


def test_pipelined_route(vectors, monkeypatch):
    """Above MAX_CHUNK lanes the packed batch runs as equal chunks."""
    pubs, msgs, sigs, ref = vectors
    monkeypatch.setattr(ted, "MAX_CHUNK", 16)
    monkeypatch.setattr(ted, "TILE", 16)
    out = ted.verify_batch(pubs, msgs, sigs)
    np.testing.assert_array_equal(out, ref)
    rec = ted.last_launch()
    assert rec["path"] == "cuda" and rec["nb"] == 64 and rec["chunks"] == 4


def test_kernel_wrappers_plain(vectors):
    """K1 and K2 wrappers on CPU tensors (their plain versions) give the
    JAX bitmap once the host s < L screen is applied, on the same staged
    layouts the JAX Pallas kernels take."""
    pubs, msgs, sigs, ref = vectors
    packed, ok = jed.prepare_batch_packed(pubs, sigs, msgs)
    k1 = ck.verify_packed(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(k1 & ok, ref)
    pub_rows, rsk, ok2 = jed.prepare_batch_split(pubs, sigs, msgs)
    k2 = ck.verify_packed_split(torch.from_numpy(pub_rows),
                                torch.from_numpy(rsk)).numpy()
    np.testing.assert_array_equal(k2, k1)
    np.testing.assert_array_equal(ok2, ok)


def test_plain_digits_match_host_digits():
    rng = np.random.default_rng(9)
    s = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    s[:, 31] &= 0x1F
    dig = ck._digits(torch.from_numpy(s.T.copy())).numpy().T
    np.testing.assert_array_equal(dig, jed.scalars_to_digits(s))
