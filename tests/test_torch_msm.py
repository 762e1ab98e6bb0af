"""The port's RLC batch verification (tendermint_tpu_torch/ops/msm.py and
the plain versions of kernels K4, K5 and A1 in ops/cuda_msm.py) against
the JAX package's ops/msm.py, on the CPU.

Every comparison is exact: field elements are compared as canonical
bytes (equal mod p, coordinate by coordinate), verdicts and routes as
they are.  Inputs come from seeds; the RLC coefficients z are injected
into both packages, so both compute the same linear combination."""
import functools
import hashlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import _edref as jref
from tendermint_tpu.libs import native as jnative
from tendermint_tpu.ops import field as JF
from tendermint_tpu.ops import msm as jmsm

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import _edref
from tendermint_tpu_torch.libs import native
from tendermint_tpu_torch.ops import cuda_msm as cm
from tendermint_tpu_torch.ops import ed25519 as E
from tendermint_tpu_torch.ops import msm

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
def _cpu_and_rlc_default(monkeypatch):
    T.set_default_device("cpu")
    monkeypatch.delenv("TM_TPU_RLC", raising=False)
    monkeypatch.delenv("TM_TPU_RLC_MIN", raising=False)
    monkeypatch.setattr(msm, "_enabled_override", None)
    monkeypatch.setattr(jmsm, "_enabled_override", None)
    yield
    T.set_default_device("cuda")


@functools.lru_cache(maxsize=None)
def _signed(n, tag):
    seeds = [(9000 + i).to_bytes(32, "little") for i in range(n)]
    msgs = [b"msm vote %d " % i + tag for i in range(n)]
    pubs = [_edref.pubkey_from_seed(s) for s in seeds]
    sigs = [_edref.sign(s, m) for s, m in zip(seeds, msgs)]
    return tuple(pubs), tuple(msgs), tuple(sigs)


def _batch(n, tag=b""):
    """(pubs, msgs, sigs) lists of n valid triples, signed once per file."""
    return tuple(list(x) for x in _signed(n, tag))


def _z(n, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, 16),
                                                dtype=np.uint8)


def _as_bytes22(limbs):
    """JAX limbs (coords, NLIMB, N) -> (coords, N, 32) canonical bytes."""
    return cm.to_bytes22(torch.from_numpy(
        np.asarray(limbs).astype(np.int64)))


def _order8_point():
    """An order-8 point in extended coordinates: x^2 = (1 +- sqrt(1 + d))/d
    and y = +-sqrt(-1) x (tests/test_msm.py:_order8_point)."""
    def sqrt_mod(a):
        a %= P
        x = pow(a, (P + 3) // 8, P)
        if (x * x - a) % P:
            x = x * _edref.SQRT_M1 % P
        return None if (x * x - a) % P else x

    s1 = sqrt_mod(1 + _edref.D)
    d_inv = pow(_edref.D, P - 2, P)
    ident = _edref._encode(_edref.IDENT)
    for t in ((1 + s1) * d_inv % P, (1 - s1) * d_inv % P):
        x = sqrt_mod(t)
        if x is None:
            continue
        for xx in (x, P - x):
            for y in (xx * _edref.SQRT_M1 % P, P - xx * _edref.SQRT_M1 % P):
                if (-xx * xx + y * y - 1
                        - _edref.D * xx * xx % P * y * y) % P:
                    continue
                pt = (xx, y, 1, xx * y % P)
                if _edref._encode(_edref._mul(8, pt)) == ident and \
                        _edref._encode(_edref._mul(4, pt)) != ident:
                    return pt
    raise AssertionError("no order-8 point found")


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 1024, 4096, 16384, 131072])
def test_plan_and_window_width_equal(n):
    c = msm._pick_c(n)
    assert c == jmsm._pick_c(n)
    got, want = msm.Plan(n, c), jmsm.Plan(n, c)
    for key in ("n", "c", "W_A", "W_R", "K", "M", "T"):
        assert getattr(got, key) == getattr(want, key), key


def test_plan_shapes_of_the_path():
    """The shapes that chip_smoke.py drives."""
    p = msm.Plan(131072, 8)
    assert (p.W_A, p.W_R, p.K, p.M, p.T) == (32, 16, 8192, 6291488, 1304)
    p = msm.Plan(4096, 4)
    assert (p.W_A, p.W_R, p.K, p.M, p.T) == (64, 32, 1024, 393280, 712)


def test_host_scalars_equal():
    """_lift_zk, rlc_scalars and its Python fallback, the B encoding and
    the niels constants equal the JAX package's."""
    rng = np.random.default_rng(7)
    n = 96
    z = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    ks = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n)]
    ss = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n)]
    to_m = lambda vs: np.frombuffer(  # noqa: E731
        b"".join(v.to_bytes(32, "little") for v in vs),
        np.uint8).reshape(n, 32)
    k, s = to_m(ks), to_m(ss)
    zk, zs = native.rlc_scalars(z, k, s)
    jzk, jzs = jnative.rlc_scalars(z, k, s)
    hzk, hzs = msm._rlc_scalars_host(z, k, s)
    for a in (jzk, hzk, jmsm._rlc_scalars_host(z, k, s)[0]):
        np.testing.assert_array_equal(zk, a)
    for a in (jzs, hzs):
        np.testing.assert_array_equal(zs, a)
    u = rng.integers(0, 15, size=n)
    np.testing.assert_array_equal(msm._lift_zk(zk, u), jmsm._lift_zk(zk, u))
    np.testing.assert_array_equal(msm._B_ENC, jmsm._B_ENC)
    np.testing.assert_array_equal(msm._L_MULTS, jmsm._L_MULTS)
    assert msm._B_NIELS == jmsm._B_NIELS and msm._ID_NIELS == jmsm._ID_NIELS


def test_r_canonical_equal():
    rows = [P - 1, P, P + 5, (P - 1) | (1 << 255), 0, P + 18, (1 << 255) - 1]
    rng = np.random.default_rng(3)
    m = np.concatenate([
        np.frombuffer(b"".join(v.to_bytes(32, "little") for v in rows),
                      np.uint8).reshape(-1, 32),
        rng.integers(0, 256, (32, 32), dtype=np.uint8)])
    got = msm._r_canonical(m)
    np.testing.assert_array_equal(got, jmsm._r_canonical(m))
    assert got[:len(rows)].tolist() == [True, False, False, True, True,
                                        False, False]


@pytest.mark.parametrize("c,W,nb", [(4, 64, 32), (8, 32, 32), (4, 32, 16)])
def test_digits_equal(c, W, nb):
    b = np.random.default_rng(c * W).integers(0, 256, (40, nb),
                                               dtype=np.uint8)
    got = msm._digits(torch.from_numpy(b), c, W).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmsm._digits(
        jnp.asarray(b), c, W)))


def test_combine_windows_host_identity_and_point():
    """All-identity window sums combine to the identity; a lone [8]-free
    point does not."""
    W = 4
    ws = np.zeros((4, W, 32), dtype=np.uint8)
    ws[1, :, 0] = 1   # Y = 1
    ws[2, :, 0] = 1   # Z = 1
    assert msm._combine_windows_host(ws, 4) is True
    bx, by = _edref.BASE[0], _edref.BASE[1]
    for j, v in enumerate((bx, by, 1, bx * by % P)):
        ws[j, 2] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    assert msm._combine_windows_host(ws, 4) is False


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX pipeline's stages
# ---------------------------------------------------------------------------

def _special_points():
    """Compressed points with edge cases: a non-square y, x = 0 with the
    sign bit (both rejected), the identity, y >= p (accepted, reduced)."""
    y_ns = 2
    while _edref._recover_x(y_ns, 0) is not None:
        y_ns += 1
    enc = [y_ns, 1 | (1 << 255), 1, P + 1, P - 1, 0]
    return [v.to_bytes(32, "little") for v in enc]


@pytest.fixture(scope="module")
def jax_table():
    """The JAX package's _build_table on R and A rows that include the
    special points, and the JAX package's oracle decode verdict of each
    point (_build_table itself returns only their conjunction)."""
    pubs, _, sigs = _batch(24)
    special = _special_points()
    r_m = np.frombuffer(b"".join([s[:32] for s in sigs] + special),
                        np.uint8).reshape(-1, 32)
    a_m = np.frombuffer(b"".join(pubs + special[::-1]),
                        np.uint8).reshape(-1, 32)
    table, ok_all = jax.jit(jmsm._build_table)(jnp.asarray(r_m),
                                               jnp.asarray(a_m))
    ok = np.array([jref._decode(row.tobytes()) is not None
                   for row in np.concatenate([r_m, a_m])])
    return r_m, a_m, np.stack([np.asarray(t) for t in table]), \
        bool(ok_all), ok


def test_k4_plain_table_equals_build_table(jax_table):
    r_m, a_m, jtab, jok_all, jok = jax_table
    b_rows = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([r_m, a_m]).T))
    niels, ok = cm.decompress_niels(b_rows)     # CPU: the plain version
    table = msm.assemble_table(niels)
    assert table.shape == (3, 22, 2 * r_m.shape[0] + 2)
    assert torch.equal(cm.to_bytes22(table), _as_bytes22(jtab))
    np.testing.assert_array_equal(ok.numpy(), jok)
    assert bool(ok.all()) == jok_all is False
    # the special points: non-square and x = 0 with the sign bit rejected
    n = r_m.shape[0]
    assert ok[n - 6: n].tolist() == [False, False, True, True, True, True]


@pytest.fixture(scope="module")
def jax_scan(jax_table):
    """Layer rows over the JAX table (30% idle steps -> row 0), the JAX
    layered scan on the layers gathered from them, and the JAX
    aggregation of those bucket sums."""
    _, _, jtab, _, jok = jax_table
    R = jtab.shape[2]
    T_, W, c = 19, 8, 4
    K = W << c
    rng = np.random.default_rng(11)
    rows = rng.integers(1, R, (T_, K)).astype(np.int32)
    rows[rng.random((T_, K)) < 0.3] = 0
    idx = jnp.asarray(rows.reshape(-1))
    layers = tuple(jnp.take(jnp.asarray(tab), idx, axis=1)
                   .reshape(JF.NLIMB, T_, K).transpose(1, 0, 2)
                   for tab in jtab)
    acc = jax.jit(jmsm._bucket_scan_xla, static_argnums=1)(layers, K)
    wsum = jax.jit(jmsm._aggregate, static_argnums=(1, 2))(acc, W, c)
    return rows, np.stack([np.asarray(v) for v in acc]), \
        np.stack([np.asarray(v) for v in wsum]), W, c


def test_k5_plain_equals_bucket_scan_xla(jax_table, jax_scan):
    _, _, jtab, _, _ = jax_table
    rows, jacc, _, _, _ = jax_scan
    table = torch.from_numpy(jtab.astype(np.int64))
    got = cm.bucket_scan(table, torch.from_numpy(rows))
    assert got.shape == (4, 22, rows.shape[1])
    assert torch.equal(cm.to_bytes22(got), _as_bytes22(jacc))


def test_a1_plain_equals_aggregate(jax_scan):
    _, jacc, jws, W, c = jax_scan
    got = cm.aggregate(torch.from_numpy(jacc.astype(np.int64)), W, c)
    assert got.shape == (4, W, 32) and got.dtype == torch.uint8
    assert torch.equal(got, _as_bytes22(jws))


def test_layout_bytes_round_trip():
    """to_bytes10 of the kernels' layout and limbs22_from_bytes agree
    with Python integers on edge values."""
    vals = [0, 1, P - 1, P, P + 1, P + 18, (1 << 255) - 1, 2, 19]
    rng = np.random.default_rng(5)
    vals += [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(7)]
    w10 = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230, 255)
    limbs = [[(v >> w10[i]) & ((1 << (w10[i + 1] - w10[i])) - 1)
              for i in range(10)] for v in vals]
    x = torch.tensor(limbs, dtype=torch.int32)[:, None, :]   # (N, 1, 10)
    # other limbs of the same values: each limb borrows one unit of the
    # next, so limb 9 may go negative
    y = x.clone()
    y[:, 0, :9] += torch.tensor([1 << (w10[i + 1] - w10[i])
                                 for i in range(9)], dtype=torch.int32)
    y[:, 0, 1:] -= 1
    for t in (x, y):
        got = cm.to_bytes10(t)[0]
        want = [(v % P).to_bytes(32, "little") for v in vals]
        assert [bytes(r.tolist()) for r in got] == want
    back = cm.limbs22_from_bytes(cm.to_bytes10(x))
    assert torch.equal(cm.to_bytes22(back), cm.to_bytes10(x))


# ---------------------------------------------------------------------------
# the whole pipeline against msm._msm_core
# ---------------------------------------------------------------------------

def _staged(n, z, sigs_fn=None):
    pubs, msgs, sigs = _batch(n)
    if sigs_fn is not None:
        sigs = sigs_fn(sigs)
    pub_m = E._to_u8_matrix(pubs, 32)
    r_b, zk, z, zs = msm._stage_rlc(pub_m, msgs, sigs, z=z)
    return r_b, pub_m, zk, z, zs


@pytest.fixture(scope="module")
def msm_core_64():
    """msm._msm_core(..., c=4) at n = 64, compiled once, on an all-valid
    batch and on one with a tampered s."""
    z = _z(64)

    def tamper(sigs):
        b = bytearray(sigs[5])
        b[32] ^= 1
        return sigs[:5] + [bytes(b)] + sigs[6:]

    out = []
    for fn in (None, tamper):
        args = _staged(64, z, fn)
        ws, ok, ovf = jmsm._msm_core(*(jnp.asarray(a) for a in args), 4,
                                     use_pallas=False)
        out.append((args, np.asarray(ws), bool(ok), bool(ovf)))
    return out


@pytest.mark.parametrize("case", [0, 1], ids=["valid", "tampered-s"])
def test_window_sums_equal_msm_core(msm_core_64, case):
    args, jws, jok, jovf = msm_core_64[case]
    ws, ok, ovf = msm._msm_pipeline(
        *(torch.from_numpy(np.array(a)) for a in args), 4)
    assert (bool(ok), bool(ovf)) == (jok, jovf) == (True, False)
    assert torch.equal(ws, _as_bytes22(jws))
    assert msm._combine_windows_host(ws.numpy(), 4) is \
        jmsm._combine_windows_host(jws, 4) is (case == 0)


# ---------------------------------------------------------------------------
# verdicts: the port's verify_batch_rlc against the JAX package's
# ---------------------------------------------------------------------------

def _tamper_sig(pubs, msgs, sigs):
    b = bytearray(sigs[7])
    b[35] ^= 1
    return pubs, msgs, sigs[:7] + [bytes(b)] + sigs[8:]


def _tamper_msg(pubs, msgs, sigs):
    return pubs, [b"tampered"] + msgs[1:], sigs


def _tamper_pub(pubs, msgs, sigs):
    return pubs[:3] + [pubs[4]] + pubs[4:], msgs, sigs


def _swap(pubs, msgs, sigs):
    return pubs, msgs, [sigs[0], sigs[2], sigs[1]] + sigs[3:]


def _s_ge_l(pubs, msgs, sigs):
    b = bytearray(sigs[1])
    b[63] = 0xFF
    return pubs, msgs, sigs[:1] + [bytes(b)] + sigs[2:]


def _r_noncanonical(pubs, msgs, sigs):
    b = bytearray(sigs[2])
    b[:32] = P.to_bytes(32, "little")
    return pubs, msgs, sigs[:2] + [bytes(b)] + sigs[3:]


@pytest.mark.parametrize("case,want,outcome", [
    (None, True, "vouched"),
    (_tamper_sig, False, "rejected"),
    (_tamper_msg, False, "rejected"),
    (_tamper_pub, False, "rejected"),
    (_swap, False, "rejected"),
    (_s_ge_l, False, "ineligible"),
    (_r_noncanonical, False, "ineligible"),
], ids=["valid", "sig", "msg", "pub", "swapped", "s>=L", "R>=p"])
def test_verdict_matrix(case, want, outcome):
    pubs, msgs, sigs = _batch(50)
    if case is not None:
        pubs, msgs, sigs = case(pubs, msgs, sigs)
    z = _z(50, seed=2)
    got = msm.verify_batch_rlc(pubs, msgs, sigs, z=z, device="cpu")
    route = dict(msm.last_route())
    assert got is jmsm.verify_batch_rlc(pubs, msgs, sigs, z=z) is want
    jroute = dict(jmsm.last_route())
    for key in ("path", "n", "nb", "c", "outcome"):
        assert route.get(key) == jroute.get(key), key
    assert route["outcome"] == outcome
    if outcome != "ineligible":
        rec = E.last_launch()
        assert (rec["path"], rec["n"], rec["nb"], rec["c"],
                rec["outcome"]) == ("rlc-single", 50, 64, 4, outcome)


def test_overflow_falls_back(monkeypatch):
    """A bucket overflow (a Plan with T = 1) is detected and reported,
    never truncated: the JAX package's tests/test_msm.py case."""
    class TinyT(msm.Plan):
        def __init__(self, n, c):
            super().__init__(n, c)
            self.T = 1

    monkeypatch.setattr(msm, "Plan", TinyT)
    pubs, msgs, sigs = _batch(8)
    assert msm.verify_batch_rlc(pubs, msgs, sigs, device="cpu") is False
    assert msm.last_route()["outcome"] == "overflow"


def test_rlc_default_off_and_config_optin(monkeypatch):
    assert msm.use_rlc(1 << 20) is False
    monkeypatch.setenv("TM_TPU_RLC", "1")
    assert msm.use_rlc(1 << 20) is True
    msm.set_enabled(False)
    assert msm.use_rlc(1 << 20) is False
    msm.set_enabled(True)
    monkeypatch.delenv("TM_TPU_RLC")
    assert msm.use_rlc(1 << 20) is True
    assert msm.use_rlc(8) is False       # below TM_TPU_RLC_MIN
    monkeypatch.setenv("TM_TPU_RLC_MIN", "4")
    assert msm.use_rlc(8) is True
    msm.set_enabled(None)
    assert msm.use_rlc(8) is False


def test_torsion_divergence_vector_and_vouch_audit():
    """ADR-009's boundary: R' = [r]B + T8 with T8 of order 8 makes a
    signature that every cofactorless per-signature path rejects and the
    cofactored RLC check accepts, in the port as in the JAX package, and
    the vouch writes the audit line."""
    seed = (0xADC9).to_bytes(32, "little")
    pub = _edref.pubkey_from_seed(seed)
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    msg = b"adr-009 cofactor boundary"
    r_nonce = int.from_bytes(
        hashlib.sha512(b"torsion nonce").digest(), "little") % L
    r_enc = _edref._encode(_edref._add(_edref._mul(r_nonce, _edref.BASE),
                                       _order8_point()))
    k = int.from_bytes(
        hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
    sig = r_enc + ((r_nonce + k * a) % L).to_bytes(32, "little")
    assert _edref.verify(pub, msg, sig) is False
    assert jref.verify(pub, msg, sig) is False

    n = 20
    pubs, msgs, sigs = _batch(n, tag=b"torsion")
    pubs[4], msgs[4], sigs[4] = pub, msg, sig
    # the ladder (RLC off, its default) attributes exactly that lane
    out = E.verify_batch(pubs, msgs, sigs, device="cpu")
    want = np.ones(n, dtype=bool)
    want[4] = False
    np.testing.assert_array_equal(out, want)
    assert E.last_launch()["path"] == "cuda"

    records = []
    lg = logging.getLogger("tm.crypto")
    handler = logging.Handler()
    handler.emit = records.append
    level = lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    try:
        z = _z(n, seed=4)
        assert msm.verify_batch_rlc(pubs, msgs, sigs, z=z,
                                    device="cpu") is True
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)
    assert any("vouched" in r.getMessage() for r in records), records
    assert jmsm.verify_batch_rlc(pubs, msgs, sigs, z=z) is True


def test_verify_batch_seam(monkeypatch):
    """Through ops/ed25519.verify_batch with RLC enabled: an all-valid
    batch is vouched for (all ones, route rlc-single), a batch with one
    bad signature is rejected by the combination and falls through to the
    exact ladder, whose bitmap is the oracle's (the JAX package's ladder
    equals the oracle on these vectors, tests/test_torch_ed25519.py)."""
    monkeypatch.setenv("TM_TPU_RLC_MIN", "16")
    msm.set_enabled(True)
    pubs, msgs, sigs = _batch(50)
    calls = []
    orig = msm.verify_batch_rlc

    def spy(*a, **kw):
        calls.append(orig(*a, **kw))
        return calls[-1]

    monkeypatch.setattr(msm, "verify_batch_rlc", spy)
    out = E.verify_batch(pubs, msgs, sigs, device="cpu")
    assert out.all() and calls == [True]
    assert E.last_launch()["path"] == "rlc-single"
    _, _, bad = _tamper_sig(pubs, msgs, sigs)
    out = E.verify_batch(pubs, msgs, bad, device="cpu")
    assert calls == [True, False]
    assert msm.last_route()["outcome"] == "rejected"
    assert E.last_launch()["path"] == "cuda"
    want = np.array([jref.verify(p, m, s) for p, m, s in
                     zip(pubs, msgs, bad)])
    assert not want[7] and want.sum() == 49
    np.testing.assert_array_equal(out, want)
