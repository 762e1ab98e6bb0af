"""The port's host-lane pool (tendermint_tpu_torch/crypto/lanepool.py) held
against the JAX package's: every scenario of tests/test_lanepool.py runs
through both packages, the sharded native bitmaps are compared with each
other and with the pure-Python oracle, the pool's chaos site degrades to
the serial path with exact bitmaps in both, and the Merkle leaf layer that
rides map_sharded gives the same roots."""
from __future__ import annotations

import threading
import time
import types

import pytest

from tendermint_tpu.crypto import degrade as jdegrade
from tendermint_tpu.crypto import lanepool as jlanepool
from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.crypto import secp256k1 as jsecp
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.libs import fail as jfail
from tendermint_tpu.libs import native as jnative

from tendermint_tpu_torch.crypto import degrade as tdegrade
from tendermint_tpu_torch.crypto import lanepool as tlanepool
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.crypto import secp256k1 as tsecp
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.libs import fail as tfail
from tendermint_tpu_torch.libs import native as tnative

PKGS = {
    "jax": types.SimpleNamespace(lanepool=jlanepool, secp=jsecp, sr=jsr,
                                 fail=jfail, native=jnative,
                                 degrade=jdegrade, merkle=jmerkle),
    "torch": types.SimpleNamespace(lanepool=tlanepool, secp=tsecp, sr=tsr,
                                   fail=tfail, native=tnative,
                                   degrade=tdegrade, merkle=tmerkle),
}


def _reset():
    for p in PKGS.values():
        p.lanepool.set_workers(None)
        p.lanepool.close()
        p.fail.reset()
        p.degrade.reset()


@pytest.fixture(autouse=True)
def _fresh_pools():
    _reset()
    yield
    _reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


_SECP_KEYS: dict = {}


def _secp_batch(n, bad=()):
    """Signed with the port's signer (the same bytes as the JAX
    package's, held in test_torch_secp.py)."""
    privs = [tsecp.PrivKey.gen_from_secret(b"lp%d" % i) for i in range(n)]
    msgs = [b"lanepool msg %d" % i for i in range(n)]
    sigs = []
    for p, m in zip(privs, msgs):
        key = (p.secret, m)
        if key not in _SECP_KEYS:
            _SECP_KEYS[key] = p.sign(m)
        sigs.append(_SECP_KEYS[key])
    for i in bad:
        sigs[i] = bytes([sigs[i][0] ^ 1]) + sigs[i][1:]
    return [p.pub_key().bytes() for p in privs], msgs, sigs


def _sr_batch(n, bad=()):
    minis = [(0xA50 + i).to_bytes(32, "little") for i in range(n)]
    msgs = [b"sr lp %d" % i for i in range(n)]
    sigs = [tsr.sign(minis[i], msgs[i]) for i in range(n)]
    for i in bad:
        sigs[i] = bytes([sigs[i][0] ^ 1]) + sigs[i][1:]
    return [tsr.PrivKey(m).pub_key().bytes() for m in minis], msgs, sigs


def _oracle(scheme, pubs, msgs, sigs):
    mod = tsecp if scheme == "secp256k1" else tsr
    return [mod.PubKey(p).verify_signature(m, s)
            for p, m, s in zip(pubs, msgs, sigs)]


def _need_native(pkg):
    if pkg.native.get_lib() is None:
        pytest.skip("no C toolchain: native lane unavailable")


# ---------------------------------------------------------------------------
# HostLanePool mechanics, in both packages
# ---------------------------------------------------------------------------

def test_pool_threads_are_daemon_and_close_joins(pkg):
    p = pkg.lanepool.HostLanePool(3, name="lp-test")
    try:
        assert all(t.daemon for t in p._threads)
        assert p.try_submit(lambda: 7).result(timeout=5) == 7
    finally:
        p.close()
    assert all(not t.is_alive() for t in p._threads)


def test_try_submit_admits_only_idle_workers(pkg):
    p = pkg.lanepool.HostLanePool(2, name="lp-sat")
    gate = threading.Event()
    try:
        f1 = p.try_submit(gate.wait, 10)
        f2 = p.try_submit(gate.wait, 10)
        assert f1 is not None and f2 is not None
        deadline = time.monotonic() + 2.0
        while p.idle() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert p.try_submit(lambda: 1) is None
        assert p.depth() == 2
        gate.set()
        assert f1.result(timeout=5) and f2.result(timeout=5)
        deadline = time.monotonic() + 2.0
        while p.idle() < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert p.try_submit(lambda: 3).result(timeout=5) == 3
    finally:
        gate.set()
        p.close()


def test_run_lanes_order_and_saturation_fallback(pkg):
    gate = threading.Event()
    try:
        pkg.lanepool.set_workers(2)
        gp = pkg.lanepool.pool()
        assert gp is not None and gp.workers == 2
        b1 = gp.try_submit(gate.wait, 10)
        b2 = gp.try_submit(gate.wait, 10)
        deadline = time.monotonic() + 2.0
        while gp.idle() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        caller = threading.current_thread().ident
        ran_on = []

        def thunk(i):
            ran_on.append(threading.current_thread().ident)
            return i * 10

        out = pkg.lanepool.run_lanes(
            [lambda i=i: thunk(i) for i in range(4)])
        assert out == [0, 10, 20, 30]
        assert set(ran_on) == {caller}
        gate.set()
        assert b1.result(timeout=5) and b2.result(timeout=5)
    finally:
        gate.set()


def test_run_lanes_propagates_exception_after_settling(pkg):
    pkg.lanepool.set_workers(4)
    done = []

    def ok(i):
        done.append(i)
        return i

    with pytest.raises(ValueError, match="lane boom"):
        pkg.lanepool.run_lanes([
            lambda: (_ for _ in ()).throw(ValueError("lane boom")),
            lambda: ok(1), lambda: ok(2)])
    assert sorted(done) == [1, 2]


def test_pool_disabled_is_serial_in_caller(pkg):
    pkg.lanepool.set_workers(1)
    assert pkg.lanepool.pool() is None
    caller = threading.current_thread().ident
    ran_on = []
    out = pkg.lanepool.run_lanes(
        [lambda i=i: ran_on.append(threading.current_thread().ident) or i
         for i in range(3)])
    assert out == [0, 1, 2]
    assert set(ran_on) == {caller}


def test_set_workers_resizes_and_env_governs(pkg, monkeypatch):
    pkg.lanepool.set_workers(3)
    assert pkg.lanepool.pool().workers == 3
    pkg.lanepool.set_workers(2)
    assert pkg.lanepool.pool().workers == 2
    assert pkg.lanepool.workers() == 2
    pkg.lanepool.set_workers(None)
    monkeypatch.setenv("TM_TPU_HOST_POOL_WORKERS", "4")
    assert pkg.lanepool.pool().workers == 4
    monkeypatch.setenv("TM_TPU_HOST_POOL_WORKERS", "1")
    assert pkg.lanepool.pool() is None


# ---------------------------------------------------------------------------
# verify_sharded: exactness, order stability, fallbacks — and the two
# packages' bitmaps equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme,make,n,bad", [
    ("secp256k1", _secp_batch, 37, (0, 13, 36)),
    ("sr25519", _sr_batch, 21, (4,))], ids=["secp256k1", "sr25519"])
def test_verify_sharded_bitmap_identity(scheme, make, n, bad):
    for p in PKGS.values():
        _need_native(p)
        p.lanepool.set_workers(4)
    pubs, msgs, sigs = make(n, bad=bad)
    want = _oracle(scheme, pubs, msgs, sigs)
    got = {k: p.lanepool.verify_sharded(scheme, pubs, msgs, sigs)
           for k, p in PKGS.items()}
    assert got["jax"].tolist() == want
    assert got["torch"].tolist() == want


def test_verify_sharded_unknown_scheme_and_empty(pkg):
    assert pkg.lanepool.verify_sharded("ed25519", [], [], []) is None
    _need_native(pkg)
    out = pkg.lanepool.verify_sharded("secp256k1", [], [], [])
    assert out is not None and out.shape == (0,)


def test_verify_sharded_irregular_inputs_return_none(pkg):
    _need_native(pkg)
    pubs, msgs, sigs = _secp_batch(40)
    sigs[33] = sigs[33][:50]
    assert pkg.lanepool.verify_sharded("secp256k1", pubs, msgs, sigs) \
        is None


def test_verify_sharded_concurrency_hammer_order_stable(pkg):
    _need_native(pkg)
    pkg.lanepool.set_workers(4)
    batches = []
    for k, n in enumerate((3, 16, 17, 31, 48, 64)):
        bad = tuple(i for i in range(n) if i % 7 == k % 7)
        pubs, msgs, sigs = _secp_batch(n, bad=bad)
        batches.append((pubs, msgs, sigs,
                        _oracle("secp256k1", pubs, msgs, sigs)))
    errors = []

    def worker(k):
        pb, msgs, sigs, want = batches[k % len(batches)]
        try:
            for _ in range(4):
                got = pkg.lanepool.verify_sharded("secp256k1", pb, msgs,
                                                  sigs)
                assert got is not None and got.tolist() == want
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors


def test_verify_sharded_pool_disabled_still_exact(pkg):
    _need_native(pkg)
    pkg.lanepool.set_workers(1)
    pubs, msgs, sigs = _secp_batch(24, bad=(5,))
    got = pkg.lanepool.verify_sharded("secp256k1", pubs, msgs, sigs)
    assert got is not None
    assert got.tolist() == _oracle("secp256k1", pubs, msgs, sigs)


@pytest.mark.parametrize("mode", ["raise", "corrupt-bitmap"])
def test_lanepool_chaos_degrades_to_the_serial_path(mode):
    """A fault at lanepool.verify (an injected raise, or an inverted merged
    bitmap that the one-row spot check catches) re-verifies the list in
    the caller: exact bitmaps, and the same fallback count in both
    packages' crypto_host_pool_tasks_total{kind=chunk,outcome=fallback}."""
    pubs, msgs, sigs = _secp_batch(40, bad=(2, 17))
    want = _oracle("secp256k1", pubs, msgs, sigs)
    counts = {}
    for k, p in PKGS.items():
        _need_native(p)
        p.lanepool.set_workers(4)
        tasks = p.degrade.runtime().metrics.host_pool_tasks
        # the counters live in the process's default registry
        before = tasks.value(kind="chunk", outcome="fallback")
        p.fail.set_mode("lanepool.verify", mode)
        bits = [p.lanepool.verify_sharded("secp256k1", pubs, msgs, sigs)
                for _ in range(3)]
        p.fail.reset()
        assert all(b.tolist() == want for b in bits)
        counts[k] = tasks.value(kind="chunk", outcome="fallback") - before
    # corrupt-bitmap inverts the merged bitmap, so the one-row spot check
    # catches it on every call
    assert counts["jax"] == counts["torch"] == 3


def test_map_sharded_and_merkle_roots(pkg):
    """map_sharded merges chunk results in order (None below two chunks);
    the Merkle leaf layer that rides it gives the JAX package's roots,
    also with the pool off and with a raise at merkle.bulk_hash."""
    pkg.lanepool.set_workers(4)
    items = list(range(100))
    out = pkg.lanepool.map_sharded(lambda c: [x * 3 for x in c], items)
    assert out == [x * 3 for x in items]
    assert pkg.lanepool.map_sharded(lambda c: c, items[:10]) is None
    leaves = [b"leaf %d" % i * 600 for i in range(70)]   # >= 4 KB rows
    want = jmerkle.hash_from_byte_slices(leaves)
    assert pkg.merkle.hash_from_byte_slices(leaves) == want
    pkg.fail.set_mode("merkle.bulk_hash", "raise")
    assert pkg.merkle.hash_from_byte_slices(leaves) == want
    pkg.fail.reset()
    pkg.lanepool.set_workers(1)
    assert pkg.merkle.hash_from_byte_slices(leaves) == want
