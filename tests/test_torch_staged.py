"""K3 in the port: the plain version of verify_staged (digests reduced mod
L and split into digits as the kernel does, then the K1 verify) against
the JAX package's pallas_ed25519 helpers (_bytes_to_limbs12, _mod_l,
_digits_from_limbs, called on jnp arrays outside the kernel), both
packages' native mod L, and the JAX package's oracle verdicts.

The JAX kernel itself (verify_staged_pallas) is not run here: its
interpret-mode compile takes over five minutes on a CPU, which is why the
JAX package's own test of it is marked slow.  Its body is _verify_tile
(held against the port through K1 in tests/test_torch_ed25519.py) after
exactly the three helpers compared below."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import _edref as jref
from tendermint_tpu.libs import native as jnative
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import pallas_ed25519 as pe

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import _edref
from tendermint_tpu_torch.libs import native
from tendermint_tpu_torch.ops import cuda_ed25519 as ck
from tendermint_tpu_torch.ops import ed25519 as E

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


def _digest_values():
    rng = np.random.default_rng(17)
    vals = [0, (1 << 512) - 1, L - 1, L, 4 * L + 3, L * L, 1 << 252,
            (1 << 256) - 1]
    return vals + [int.from_bytes(rng.bytes(64), "little")
                   for _ in range(56)]


def _rows(vals, nbytes):
    """Python ints -> (nbytes, B) lane-major uint8."""
    m = np.frombuffer(b"".join(v.to_bytes(nbytes, "little") for v in vals),
                      np.uint8).reshape(-1, nbytes)
    return np.ascontiguousarray(m.T)


def _ints(limbs):
    """(NLIMB, B) radix-2^12 limbs -> Python ints."""
    limbs = np.asarray(limbs)
    return [sum(int(limbs[i, b]) << (12 * i) for i in range(limbs.shape[0]))
            for b in range(limbs.shape[1])]


@pytest.mark.parametrize("nbytes,nlimbs", [(32, 22), (64, 43)])
def test_bytes_to_limbs12_equal(nbytes, nlimbs):
    rows = np.random.default_rng(nbytes).integers(0, 256, (nbytes, 24),
                                                  dtype=np.uint8)
    got = ck._bytes_to_limbs12(torch.from_numpy(rows).to(torch.int64),
                               nlimbs)
    want = pe._bytes_to_limbs12(jnp.asarray(rows.astype(np.int32)), nlimbs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mod_l_equals_jax_and_native():
    vals = _digest_values()
    rows = _rows(vals, 64)
    got = ck._mod_l(ck._bytes_to_limbs12(
        torch.from_numpy(rows).to(torch.int64), 43)).numpy()
    want = np.asarray(pe._mod_l(pe._bytes_to_limbs12(
        jnp.asarray(rows.astype(np.int32)), 43)))
    np.testing.assert_array_equal(got, want)
    assert _ints(got) == [v % L for v in vals]
    digests = np.ascontiguousarray(rows.T)
    for lib in (native, jnative):
        k = lib.mod_l(digests)
        assert [int.from_bytes(r.tobytes(), "little") for r in k] == \
            [v % L for v in vals]


def test_digits_equal():
    """Digits of reduced digests and of scalars up to 2^253 - 1."""
    rng = np.random.default_rng(23)
    scalars = [v % L for v in _digest_values()] + [(1 << 253) - 1, 0] + [
        int.from_bytes(rng.bytes(32), "little") >> 3 for _ in range(30)]
    limbs = ck._bytes_to_limbs12(
        torch.from_numpy(_rows(scalars, 32)).to(torch.int64), 22)
    got = ck._digits_from_limbs(limbs).numpy()
    want = np.asarray(pe._digits_from_limbs(jnp.asarray(
        limbs.numpy().astype(np.int32))))
    np.testing.assert_array_equal(got, want)
    for b, v in enumerate(scalars):
        assert sum(int(d) << (4 * j) for j, d in enumerate(got[:, b])) == v


def _vectors():
    """Valid triples, bit flips in sig / msg / pub, and the edge cases of
    tests/test_torch_ed25519.py: s + L, a non-square y, small-order keys,
    x = 0 with the sign bit, non-canonical y (accepted) and R (rejected)."""
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
    y_ns = 2
    while _edref._recover_x(y_ns, 0) is not None:
        y_ns += 1
    ident = (1).to_bytes(32, "little")
    enc = lambda v: v.to_bytes(32, "little")  # noqa: E731
    s_plus_l = int.from_bytes(s0[32:], "little") + L
    for p, m, s in [
        (p0, m0, s0[:32] + s_plus_l.to_bytes(32, "little")),
        (enc(y_ns), m0, s0), (ident, m0, s0), (enc(P - 1), m0, s0),
        (enc(0), m0, s0), (enc(1 | (1 << 255)), m0, s0),
        (enc(P + 1), m0, ident + bytes(32)),
        (ident, m0, ident + bytes(32)),
        (ident, m0, enc(P + 1) + bytes(32)),
    ]:
        P_.append(p), M_.append(m), S_.append(s)
    return P_, M_, S_


@pytest.fixture(scope="module")
def vectors():
    pubs, msgs, sigs = _vectors()
    oracle = np.array([jref.verify(p, m, s)
                       for p, m, s in zip(pubs, msgs, sigs)])
    assert oracle[:12].all() and not oracle[12:24].any()
    assert list(oracle[24:]) == [False] * 6 + [True, True, False]
    return pubs, msgs, sigs, oracle


def test_prepare_batch_compact_equal(vectors):
    pubs, msgs, sigs, _ = vectors
    got, ok = E.prepare_batch_compact(pubs, sigs, msgs)
    want, jok = jed.prepare_batch_compact(pubs, sigs, msgs)
    np.testing.assert_array_equal(ok, jok)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.int8
        np.testing.assert_array_equal(got[k], want[k])


def test_verify_staged_plain_vectors(vectors):
    """The K3 wrapper on CPU tensors (its plain version) gives the oracle
    verdict once the host s < L screen is applied, and the K1 plain
    verdict lane for lane on the same batch."""
    pubs, msgs, sigs, oracle = vectors
    staged, ok = E.prepare_batch_compact(pubs, sigs, msgs)
    rows = [torch.from_numpy(staged[k]) for k in ("pub", "r", "s",
                                                  "digest")]
    ck.reset_launches()
    k3 = ck.verify_staged(*rows).numpy()
    assert ck.launches["verify_staged"] == 0     # the plain version ran
    np.testing.assert_array_equal(k3 & ok, oracle)
    packed, _ = E.prepare_batch_packed(pubs, sigs, msgs)
    k1 = ck.verify_packed(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(k3, k1)


def test_verify_batch_staged_route(vectors):
    pubs, msgs, sigs, oracle = vectors
    out = E.verify_batch_staged(pubs, msgs, sigs, device="cpu")
    np.testing.assert_array_equal(out, oracle)
    rec = E.last_launch()
    assert (rec["path"], rec["device"], rec["n"], rec["nb"]) == \
        ("cuda-staged", "cpu", len(pubs), 256)


def test_verify_staged_checks_inputs():
    z = lambda r, b: torch.zeros((r, b), dtype=torch.uint8)  # noqa: E731
    with pytest.raises(ValueError):
        ck.verify_staged(z(32, 8), z(32, 8), z(32, 8), z(32, 8))
    with pytest.raises(ValueError):
        ck.verify_staged(z(32, 8), z(32, 8), z(32, 4), z(64, 8))
    with pytest.raises(TypeError):
        ck.verify_staged(z(32, 8).to(torch.int32), z(32, 8), z(32, 8),
                         z(64, 8))
