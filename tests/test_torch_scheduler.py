"""The port's VerifyScheduler (tendermint_tpu_torch/crypto/scheduler.py)
against the JAX package's: each scenario of tests/test_scheduler.py is
played through both packages with device="cpu", the same seeded triples
and the same window_s / max_batch / max_pending, and the bitmaps,
exception types, stats() counts and CryptoMetrics counters are compared.

Where a scenario needs the device lane (TM_TPU_FORCE_BATCH=1), the JAX
package's kernel is stubbed by the host oracle behind its own
ops.ed25519.verify_batch seam (its XLA ladder costs about 30 s to compile
on the CPU; its chaos tests stub a kernel for the same reason), and so is
the port's, but for the three-consumer scenario, where the port runs its
real plain path once.  The port's own rules close the file: a card fault
outside a drill fails the launch's futures with DeviceLaneError, and any
other fault of a launch on the card with SchedulerExecError, never
reaching _resolve_by_host; a kernel build failure raises out of start(),
and a caller on another device takes its direct path.
"""
from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import degrade as jdeg
from tendermint_tpu.crypto import ed25519 as jkeys
from tendermint_tpu.crypto import scheduler as jvs
from tendermint_tpu.libs import fail as jfail
from tendermint_tpu.libs import trace as jtrace
from tendermint_tpu.libs.metrics import Registry as JRegistry

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import degrade as tdeg
from tendermint_tpu_torch.crypto import ed25519 as tkeys
from tendermint_tpu_torch.crypto import scheduler as tvs
from tendermint_tpu_torch.libs import fail as tfail
from tendermint_tpu_torch.libs import trace as ttrace
from tendermint_tpu_torch.libs.metrics import Registry as TRegistry
from tendermint_tpu_torch.ops import cuda_comb as ccomb
from tendermint_tpu_torch.ops import cuda_ed25519 as ck
from tendermint_tpu_torch.ops import cuda_secp as cs1
from tendermint_tpu_torch.ops import cuda_sr25519 as cs2
from tendermint_tpu_torch.ops import ed25519 as ted
from test_torch_validator_set import CHAIN as VS_CHAIN
from test_torch_validator_set import _export, _tbid, jax_state  # noqa: F401

JAX = types.SimpleNamespace(name="jax", vs=jvs, cb=jbatch, deg=jdeg,
                            keys=jkeys, fail=jfail, trace=jtrace,
                            Registry=JRegistry)
PORT = types.SimpleNamespace(name="port", vs=tvs, cb=tbatch, deg=tdeg,
                             keys=tkeys, fail=tfail, trace=ttrace,
                             Registry=TRegistry)
PKGS = (JAX, PORT)
CUDA0 = torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is thousands of small tensor ops: with one intra-op
    thread per test process they do not contend with parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """The CPU device for the port, a fresh SigCache each, and every
    scheduler stopped and uninstalled, with the runtimes reset, so the
    stager, executor and lane threads do not pile up across tests."""
    T.set_default_device("cpu")
    monkeypatch.delenv("TM_TPU_DISABLE_BATCH", raising=False)
    monkeypatch.delenv("TM_TPU_FORCE_BATCH", raising=False)
    for pkg in PKGS:
        pkg.fail.reset()
        monkeypatch.setattr(pkg.cb, "verified_sigs", pkg.cb.SigCache())
    yield
    for pkg in PKGS:
        pkg.fail.reset()
        pkg.vs.uninstall()
        pkg.deg.reset()
        pkg.trace.TRACER.disable()
        pkg.trace.TRACER.reset()
    T.set_default_device("cuda")


@pytest.fixture
def sched():
    """Factory: build + install + start a scheduler of one package;
    every one is stopped at teardown."""
    created = []

    def make(pkg, **kw):
        s = pkg.vs.VerifyScheduler(**kw)
        created.append(s)
        pkg.vs.install(s)
        s.start()
        return s

    yield make
    for s in created:
        s.stop()


def _oracle(pkg):
    """The device lane's kernel as the host oracle, behind the package's
    own ops.ed25519.verify_batch chaos seam (the port's also checks that
    the lane got the scheduler's torch.device)."""
    def ed_ops_verify(pubkeys, msgs, sigs, cache_pubs=False, device=None):
        if pkg is PORT:
            assert device == torch.device("cpu")
        pkg.fail.inject("ops.ed25519.verify_batch")
        return np.array([pkg.keys.PubKey(bytes(p)).verify_signature(
            bytes(m), bytes(s)) for p, m, s in zip(pubkeys, msgs, sigs)])
    return ed_ops_verify


@pytest.fixture
def device_lane(monkeypatch):
    """TM_TPU_FORCE_BATCH=1 with both kernels stubbed by the oracle."""
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    for pkg in PKGS:
        monkeypatch.setattr(pkg.cb, "ed_ops_verify", _oracle(pkg))


_KEYS: dict = {}


def _raw(n, tag, bad=()):
    """n seeded (pub bytes, msg, sig) triples, `bad` lanes with a flipped
    signature byte."""
    out = []
    for i in range(n):
        seed = bytes([(i * 7 + 3) % 255 + 1]) * 32
        if seed not in _KEYS:
            _KEYS[seed] = tkeys.PrivKey(seed)
        priv = _KEYS[seed]
        m = tag + b" item %d" % i
        s = priv.sign(m)
        if i in bad:
            s = bytes([s[0] ^ 1]) + s[1:]
        out.append((priv.pub_key().bytes(), m, s))
    return out


def _items(pkg, raw):
    return [(pkg.keys.PubKey(p), m, s) for p, m, s in raw]


def _direct_bits(pkg, items):
    bv = pkg.cb.BatchVerifier()
    for pub, m, s in items:
        bv.add(pub, m, s)
    return bv.verify()[1]


def _counts(st):
    return {k: st[k] for k in ("submissions", "items", "launches", "lanes",
                               "cache_hits", "dedup", "shed", "evicted",
                               "pending_items")}


def _final(s):
    """stats() once the scheduler is stopped: the executor counts a
    launch after it fires the launch's futures, so the counts are read
    after its thread has ended."""
    s.stop()
    return _counts(s.stats())


def _eventually(cond, timeout=2.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "condition not reached"
        time.sleep(0.005)


def _both(fn):
    """fn(pkg) for both packages; the outcomes must be equal."""
    got = {pkg.name: fn(pkg) for pkg in PKGS}
    assert got["jax"] == got["port"], got
    return got["port"]


# ---------------------------------------------------------------------------
# sync wrapper / fallback semantics
# ---------------------------------------------------------------------------

def test_sync_wrapper_bitmap_identity(sched):
    """verify_items through a running scheduler returns the direct path's
    exact (all_ok, bitmap), invalid and malformed-length lanes included."""
    raw = _raw(24, b"identity", bad=(2, 9, 17))
    p, m, s = raw[5]
    raw[5] = (p, m, s[:40])

    def play(pkg):
        items = _items(pkg, raw)
        expect = _direct_bits(pkg, items)
        sc = sched(pkg, window_s=0.0)
        ok, bits = pkg.vs.verify_items(items)
        assert bits.tolist() == expect.tolist()
        return ok, bits.tolist(), _final(sc)
    ok, bits, st = _both(play)
    assert ok is False and not bits[5] and st["launches"] == 1


def test_wrapper_and_bulk_fall_back_when_not_running():
    raw = _raw(8, b"fallback")

    def play(pkg):
        items = _items(pkg, raw)
        assert pkg.vs.running() is None
        out = [pkg.vs.verify_items(items)]
        s = pkg.vs.install(pkg.vs.VerifyScheduler(window_s=0.0))
        s.start()
        s.stop()  # stopped-but-installed: submit resolves with the error
        with pytest.raises(pkg.vs.SchedulerStoppedError):
            s.submit(items).result(timeout=1)
        out.append(pkg.vs.verify_items(items))   # silently direct
        out.append(pkg.cb.verify_sigs_bulk([it[0] for it in items],
                                           [it[1] for it in items],
                                           [it[2] for it in items]))
        return [(bool(o[0]), o[1].tolist()) if isinstance(o, tuple)
                else o.tolist() for o in out]
    out = _both(play)
    assert out[0] == (True, [True] * 8) and out[2] == [True] * 8


def test_bulk_routes_through_scheduler(sched):
    raw = _raw(9, b"bulk", bad=(4,))

    def play(pkg):
        s = sched(pkg, window_s=0.0)
        pubs = [pkg.keys.PubKey(p) for p, _, _ in raw]
        msgs = [m for _, m, _ in raw]
        sigs = [sg for _, _, sg in raw]
        bits = pkg.cb.verify_sigs_bulk(pubs, msgs, sigs)
        n1 = s.stats()["submissions"]
        # the (n, 32) raw-pubkey matrix keeps the direct route
        mat = np.frombuffer(b"".join(p for p, _, _ in raw),
                            dtype=np.uint8).reshape(-1, 32)
        bits2 = pkg.cb.verify_sigs_bulk(mat, msgs, sigs)
        return bits.tolist(), bits2.tolist(), n1, s.stats()["submissions"]
    bits, bits2, n1, n2 = _both(play)
    assert bits == bits2 == [True] * 4 + [False] + [True] * 4
    assert n1 == n2 == 1


@pytest.mark.parametrize("check", ["verify_commit", "verify_commit_light"])
def test_verify_commit_on_the_host_lanes_goes_through_the_scheduler(
        sched, jax_state, check):
    """The 64-validator commit of test_torch_validator_set (62 signatures)
    checked while a scheduler runs on the host lanes (the port on
    device="cpu", the JAX package on its CPU backend): the signatures
    reach the scheduler as one submission, and the SigCache stays empty
    (a scheduled bulk batch does not fill it), in both packages."""
    j_vset, j_commit = jax_state
    t_vset, t_commit = _export(j_vset, j_commit)

    def play(pkg):
        s = sched(pkg, window_s=0.0)
        if pkg is JAX:
            vset, commit, bid = j_vset, j_commit, j_commit.block_id
        else:
            vset, commit, bid = t_vset, t_commit, _tbid(t_commit)
        getattr(vset, check)(VS_CHAIN, bid, commit.height, commit)
        cache = pkg.cb.verified_sigs
        cached = sum(cache.hit(v.pub_key.bytes(),
                               commit.vote_sign_bytes(VS_CHAIN, i),
                               sg.signature)
                     for i, (v, sg) in enumerate(zip(vset.validators,
                                                     commit.signatures))
                     if not sg.is_absent())
        return _final(s), cached
    st, cached = _both(play)
    assert st["submissions"] == 1 and st["launches"] == 1
    assert cached == 0


# ---------------------------------------------------------------------------
# queueing policy
# ---------------------------------------------------------------------------

def test_priority_ordering_under_full_queue(sched):
    """With more pending than one launch can take, the drain is strictly
    by class: a CONSENSUS submission entering last rides the next launch
    while the newest MEMPOOL work waits."""
    def play(pkg):
        s = sched(pkg, window_s=30.0, max_batch=16)
        V = pkg.vs
        mp = [s.submit(_items(pkg, _raw(5, b"mp%d" % i)), V.Priority.MEMPOOL)
              for i in range(3)]
        hi = s.submit(_items(pkg, _raw(8, b"consensus")),
                      V.Priority.CONSENSUS)
        s.flush()
        out = [hi.result(timeout=30).tolist()]
        out.append([f.done() for f in mp[:2]] + [mp[-1].done()])
        out.append(s.stats()["pending_items"])
        deadline = time.monotonic() + 30
        while not all(f.done() for f in mp):
            s.flush()
            time.sleep(0.01)
            assert time.monotonic() < deadline
        out.append([f.result(timeout=1).tolist() for f in mp])
        out.append(_final(s))
        return out
    out = _both(play)
    assert out[1] == [True, True, False] and out[2] == 5
    assert out[4]["launches"] == 2 and out[4]["pending_items"] == 0


def test_shed_policy_accounting(sched):
    def play(pkg):
        pkg.deg.configure(registry=pkg.Registry("shed"))
        s = sched(pkg, window_s=30.0, max_pending=16)
        m = pkg.deg.runtime().metrics
        V = pkg.vs
        keep = s.submit(_items(pkg, _raw(10, b"keep")), V.Priority.MEMPOOL)
        shed = s.submit(_items(pkg, _raw(10, b"shed")), V.Priority.MEMPOOL)
        with pytest.raises(V.SchedulerShedError):
            shed.result(timeout=1)
        out = [m.sched_shed_total.value(priority="mempool")]
        hi = s.submit(_items(pkg, _raw(10, b"hi")), V.Priority.CONSENSUS)
        with pytest.raises(V.SchedulerShedError):
            keep.result(timeout=1)
        out.append(m.sched_shed_total.value(priority="mempool"))
        out.append(_counts(s.stats()))
        s.flush()
        out.append(hi.result(timeout=30).tolist())
        out.append(m.sched_queue_depth.value())
        return out
    out = _both(play)
    assert out[:2] == [1, 2]
    assert out[2]["shed"] == 2 and out[2]["evicted"] == 1
    assert out[3] == [True] * 10 and out[4] == 0


def test_deadline_flushes_before_window(sched):
    """A deadline closes a 30 s window early; the settled request is
    accounted (queue-wait and e2e histograms, no deadline miss counted
    when met, a miss counted when the deadline has already passed)."""
    def play(pkg):
        pkg.deg.configure(registry=pkg.Registry("deadline"))
        s = sched(pkg, window_s=30.0)
        m = pkg.deg.runtime().metrics
        V = pkg.vs
        fut = s.submit(_items(pkg, _raw(6, b"deadline")),
                       V.Priority.CONSENSUS,
                       deadline=time.monotonic() + 0.05)
        bits = fut.result(timeout=10).tolist()
        late = s.submit(_items(pkg, _raw(4, b"late")), V.Priority.CONSENSUS,
                        deadline=time.monotonic() - 1.0)
        bits_late = late.result(timeout=10).tolist()
        rep = V.last_latency_report()
        return (bits, bits_late,
                m.sched_queue_wait.count(priority="consensus"),
                m.verify_e2e_latency.count(priority="consensus",
                                           path="sched-host"),
                m.sched_deadline_miss.value(priority="consensus"),
                rep["path"], rep["items"], rep["requests"][0]["deadline_met"])
    out = _both(play)
    # a window that closes AT a deadline settles after it: both count
    assert out == ([True] * 6, [True] * 4, 2, 2, 2, "sched-host", 4, False)


def test_dedupe_of_concurrent_identical_triples(sched):
    raw = _raw(8, b"dup", bad=(3,))

    def play(pkg):
        s = sched(pkg, window_s=0.3)
        items = _items(pkg, raw)
        barrier = threading.Barrier(2)
        outs = [None, None]

        def worker(k):
            barrier.wait()
            outs[k] = s.submit(items, pkg.vs.Priority.BLOCKSYNC).result(
                timeout=30).tolist()

        ts = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        return outs, _final(s)
    outs, st = _both(play)
    assert outs[0] == outs[1] == [True] * 3 + [False] + [True] * 4
    assert st["launches"] == 1 and st["lanes"] == 8 and st["dedup"] == 8


def test_sigcache_hits_skip_lanes(sched):
    raw = _raw(8, b"cached")

    def play(pkg):
        s = sched(pkg, window_s=0.0)
        items = _items(pkg, raw)
        a = s.submit(items).result(timeout=30).tolist()
        b = s.submit(items).result(timeout=30).tolist()
        return a, b, pkg.vs.last_latency_report()["path"], _final(s)
    a, b, path, st = _both(play)
    assert a == b == [True] * 8 and path == "sched-cache"
    assert st["cache_hits"] == 8 and st["lanes"] == 8


def test_stager_survives_a_poisoned_window(sched, monkeypatch):
    """One staging exception fails THAT window's futures without killing
    the stager; the wrapper's retry falls back to the direct path."""
    raw = _raw(6, b"poison", bad=(1,))

    def play(pkg):
        s = sched(pkg, window_s=0.0)
        real_stage = s._stage
        boom = {"armed": True}

        def stage(subs):
            if boom.pop("armed", False):
                raise RuntimeError("injected staging fault")
            return real_stage(subs)

        monkeypatch.setattr(s, "_stage", stage)
        items = _items(pkg, raw)
        with pytest.raises(pkg.vs.SchedulerError, match="staging failed"):
            s.submit(items, pkg.vs.Priority.BLOCKSYNC).result(timeout=30)
        ok, bits = pkg.vs.verify_items(items, pkg.vs.Priority.BLOCKSYNC)
        assert bits.tolist() == _direct_bits(pkg, items).tolist()
        return bool(ok), bits.tolist(), _final(s)["launches"]
    assert _both(play) == (False, [True, False] + [True] * 4, 1)


def test_submit_malformed_pub_lands_on_future(sched):
    def play(pkg):
        s = sched(pkg, window_s=0.0)
        fut = s.submit([(b"\x01" * 31, b"msg", b"\x02" * 64)])
        assert fut.done()
        with pytest.raises(ValueError) as e:
            fut.result(timeout=1)
        return type(e.value).__name__
    assert _both(play) == "ValueError"


# ---------------------------------------------------------------------------
# chaos through the pipelined device path
# ---------------------------------------------------------------------------

def _chaos_runtime(pkg, clk, registry=None):
    cfg = pkg.deg.DegradeConfig(
        failure_threshold=2, launch_timeout_s=120.0,
        backoff_base_s=10.0, backoff_max_s=100.0, backoff_jitter=0.0)
    return pkg.deg.configure(cfg, clock=lambda: clk[0],
                             registry=registry or pkg.Registry("schedchaos"))


@pytest.mark.parametrize("mode,reason", [
    ("raise", "raise"),
    ("corrupt-bitmap", "integrity"),
])
def test_chaos_pipelined_path_preserves_bitmaps(sched, device_lane, mode,
                                                reason):
    """An injected fault at sched.ed25519 degrades through each package's
    runtime alike: exact bitmaps, the failure class counted, the breaker
    open after the threshold and the next launch refused the device."""
    raw = _raw(40, b"chaos " + mode.encode(), bad=(1, 13, 37))
    expect = [i not in (1, 13, 37) for i in range(40)]

    def play(pkg):
        clk = [0.0]
        rt = _chaos_runtime(pkg, clk)
        s = sched(pkg, window_s=0.0, tpu_threshold=4)
        items = _items(pkg, raw)
        pkg.fail.set_mode("sched.ed25519", mode)
        try:
            out = [s.submit(items, pkg.vs.Priority.BLOCKSYNC,
                            populate_cache=False).result(timeout=30).tolist()
                   for _ in range(3)]
        finally:
            pkg.fail.clear()
        m = rt.metrics
        return (out, rt.breaker.state,
                m.device_launches.value(site="sched.ed25519"),
                m.device_failures.value(site="sched.ed25519", reason=reason),
                m.host_fallbacks.value(site="sched.ed25519", reason=reason),
                m.host_fallbacks.value(site="sched.ed25519",
                                       reason="breaker_open"),
                m.verify_e2e_latency.count(priority="blocksync",
                                           path="sched-fallback"),
                pkg.fail.fired("sched.ed25519", mode),
                _final(s))
    out = _both(play)
    assert out[0] == [expect] * 3 and out[1] == "open"
    assert out[2:8] == (2, 2, 2, 1, 2, 2) and out[8]["launches"] == 3


# ---------------------------------------------------------------------------
# the acceptance scenario: three consumers, one coalesced launch
# ---------------------------------------------------------------------------

def test_three_consumers_one_coalesced_launch(sched, monkeypatch):
    """Vote pre-verify (CONSENSUS, verify_items with a deadline), a commit
    check (verify_sigs_bulk inside priority_context(COMMIT)) and a replay
    window (BLOCKSYNC, verify_items) submit concurrently and resolve from
    ONE coalesced device launch at site sched.ed25519 (the flight
    recorder's spans), each with its direct-path bitmap.  The port's
    launch runs its real plain K1 path (nb = 256 lanes, one launch
    record); the JAX package's kernel is stubbed."""
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    monkeypatch.setattr(jbatch, "ed_ops_verify", _oracle(JAX))
    votes = _raw(14, b"prevote", bad=(6,))
    commit = _raw(6, b"commit", bad=(2,))
    replay = _raw(24, b"replay", bad=(0, 23))

    def play(pkg):
        reg = pkg.Registry("coalesce")
        rt = pkg.deg.configure(registry=reg)
        V = pkg.vs
        expect = {k: _direct_bits(pkg, _items(pkg, r)).tolist()
                  for k, r in (("votes", votes), ("commit", commit),
                               ("replay", replay))}
        pkg.cb.verified_sigs = pkg.cb.SigCache()
        pkg.trace.TRACER.enable(capacity=1 << 12)
        seq0 = pkg.trace.TRACER.last_seq()
        launch_seq0 = ted.last_launch()["seq"]
        # a long window and a matching deadline: the three consumers
        # submit well inside it, even on a loaded test host
        s = sched(pkg, window_s=0.9)
        results, errors = {}, []
        barrier = threading.Barrier(3)

        def bulk_commit():
            items = _items(pkg, commit)
            with V.priority_context(V.Priority.COMMIT):
                return pkg.cb.verify_sigs_bulk(
                    [i[0] for i in items], [i[1] for i in items],
                    [i[2] for i in items]).tolist()

        def consumer(name, fn):
            def run():
                barrier.wait()
                try:
                    results[name] = fn()
                except Exception as e:  # noqa: BLE001 - surfaced below
                    errors.append((name, e))
            return threading.Thread(target=run, name=f"consumer-{name}")

        threads = [
            consumer("votes", lambda: V.verify_items(
                _items(pkg, votes), V.Priority.CONSENSUS,
                deadline=time.monotonic() + 0.9)[1].tolist()),
            consumer("commit", bulk_commit),
            consumer("replay", lambda: V.verify_items(
                _items(pkg, replay), V.Priority.BLOCKSYNC)[1].tolist()),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        pkg.trace.TRACER.disable()
        assert not errors, errors
        assert results == expect
        spans = pkg.trace.TRACER.snapshot(since=seq0)
        launches = [r["attrs"]["site"] for r in spans
                    if r["name"] == "device.launch"]
        sl = [r["attrs"] for r in spans if r["name"] == "sched.launch"]
        m = rt.metrics
        if pkg is PORT:
            rec = ted.last_launch()
            assert rec["seq"] == launch_seq0 + 1 and rec["nb"] == 256
            assert rec["n"] == 44 and rec["path"] == "cuda"
        return (launches, [(a["n"], a["dedup"], a["cache_hits"])
                           for a in sl],
                _final(s),
                m.device_launches.value(site="sched.ed25519"),
                m.sched_batch_size.count(),
                sorted(p for p in ("consensus", "commit", "blocksync")
                       if m.verify_e2e_latency.count(
                           priority=p, path="sched-device")),
                # the populate_cache contract: verify_items fills the
                # SigCache, the bulk branch does not
                [pkg.cb.verified_sigs.hit(p, mm, sg)
                 for p, mm, sg in (votes[0], commit[0], replay[1])])
    out = _both(play)
    assert out[0] == ["sched.ed25519"] and out[1] == [(44, 0, 0)]
    assert out[2]["launches"] == 1 and out[2]["submissions"] == 3
    assert out[3:] == (1, 1, ["blocksync", "commit", "consensus"],
                       [True, False, True])


def test_context_priority_labels_the_direct_path():
    """With no scheduler running, the direct path's e2e latency carries
    the caller's priority context (COMMIT when none is set)."""
    raw = _raw(4, b"label")

    def play(pkg):
        rt = pkg.deg.configure(registry=pkg.Registry("label"))
        out = []
        for prio in (None, pkg.vs.Priority.BLOCKSYNC):
            items = _items(pkg, raw)
            if prio is None:
                _direct_bits(pkg, items)
            else:
                with pkg.vs.priority_context(prio):
                    out.append(pkg.cb._context_priority_name())
                    _direct_bits(pkg, items)
        h = rt.metrics.verify_e2e_latency
        return out + [h.count(priority=p, path="direct")
                      for p in ("commit", "blocksync")]
    assert _both(play) == ["blocksync", 1, 1]


# ---------------------------------------------------------------------------
# the port's own rules: the card, the build, the device
# ---------------------------------------------------------------------------

def _on_card(monkeypatch, kernel_fn):
    """Make the port's scheduler and entry points take cuda:0 on this
    host: the device resolves to it, the build is a no-op, and the
    device lane's verifier is `kernel_fn`, which also checks the lane
    got the scheduler's device."""
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    for mod in (tvs, tbatch):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda device=None: CUDA0)
    for mod in (ck, ccomb, cs1, cs2):
        monkeypatch.setattr(mod, "kernels", lambda: None)

    def verifier(pubs, msgs, sigs, cache_pubs=False, device=None):
        assert device == CUDA0
        return kernel_fn(pubs, msgs, sigs)
    monkeypatch.setattr(tbatch, "verify_ed25519_batch", verifier)


def _port_cfg(**kw):
    base = dict(failure_threshold=3, launch_timeout_s=5.0,
                backoff_base_s=10.0, backoff_max_s=100.0, backoff_jitter=0.0)
    base.update(kw)
    return tdeg.DegradeConfig(**base)


@pytest.mark.parametrize("fault", ["raise", "breaker_open"])
def test_card_fault_fails_the_futures_outside_a_drill(sched, monkeypatch,
                                                      fault):
    """On the card, outside a drill, a launch that raises (or finds the
    breaker open) fails its waiters' futures with DeviceLaneError: the
    failure is counted, no host fallback is, _resolve_by_host never runs,
    and verify_items and verify_sigs_bulk raise it to the consumer.  The
    scheduler keeps running, and once the card serves again the next
    submission gets the exact bitmap from it."""
    raw = _raw(40, b"card", bad=(5, 31))
    expect = [i not in (5, 31) for i in range(40)]
    state = {"broken": True}

    def kernel(pubs, msgs, sigs):
        if state["broken"]:
            raise RuntimeError("cudaErrorLaunchFailure")
        return _oracle(PORT)(pubs, msgs, sigs, device=torch.device("cpu"))
    _on_card(monkeypatch, kernel)
    rt = tdeg.configure(_port_cfg(failure_threshold=1
                                  if fault == "breaker_open" else 5),
                        registry=TRegistry("card"))
    s = sched(PORT, window_s=0.0, device="cuda")
    assert s.device == CUDA0
    hosted = []
    monkeypatch.setattr(s, "_resolve_by_host",
                        lambda launch: hosted.append(launch))
    items = _items(PORT, raw)
    m = rt.metrics
    with pytest.raises(tdeg.DeviceLaneError, match="raise"):
        s.submit(items, tvs.Priority.BLOCKSYNC).result(timeout=30)
    want = "breaker_open" if fault == "breaker_open" else "raise"
    with pytest.raises(tdeg.DeviceLaneError, match=want):
        tvs.verify_items(items, tvs.Priority.BLOCKSYNC)
    with pytest.raises(tdeg.DeviceLaneError, match=want):
        tbatch.verify_sigs_bulk([i[0] for i in items], [i[1] for i in items],
                                [i[2] for i in items])
    assert m.device_failures.value(site="sched.ed25519", reason="raise") == \
        (1 if fault == "breaker_open" else 3)
    assert m.host_fallbacks.render() == [f"{m.host_fallbacks.name} 0"]
    _eventually(lambda: s.stats()["launches"] == 3)
    assert hosted == [] and s.is_running()
    state["broken"] = False
    if fault == "breaker_open":
        rt.breaker.record_success()   # the half-open trial closed it
    ok, bits = tvs.verify_items(items, tvs.Priority.BLOCKSYNC)
    assert bits.tolist() == expect and not ok and hosted == []
    assert _final(s)["launches"] == 4


def test_card_fault_falls_back_in_a_drill(sched, monkeypatch):
    """With a failpoint armed (a chaos drill) the same card fault settles
    on the host with the exact bitmap, as the JAX package's does."""
    raw = _raw(40, b"drill", bad=(7,))

    def kernel(pubs, msgs, sigs):
        raise RuntimeError("cudaErrorLaunchFailure")
    _on_card(monkeypatch, kernel)
    rt = tdeg.configure(_port_cfg(), registry=TRegistry("drill"))
    s = sched(PORT, window_s=0.0, device="cuda")
    tfail.register("drill.elsewhere")
    tfail.set_mode("drill.elsewhere", "raise")
    bits = s.submit(_items(PORT, raw)).result(timeout=30)
    assert bits.tolist() == [i != 7 for i in range(40)]
    assert rt.metrics.host_fallbacks.value(site="sched.ed25519",
                                           reason="raise") == 1


def _exec_faults(rt, outcome):
    return rt.metrics.registry.counter(
        "crypto", "sched_exec_fault_total", labels=("outcome",)).value(
            outcome=outcome)


@pytest.mark.parametrize("fault", ["execute_raises", "short_bitmap"])
def test_card_exec_fault_fails_the_futures_outside_a_drill(
        sched, monkeypatch, fault):
    """On the card, outside a drill, a launch that raises past the device
    lane (the scheduler's own host code raising, or a kernel answer of
    the wrong length that passed with the spot check off) never reaches
    _resolve_by_host: the waiters' futures fail with SchedulerExecError,
    the fault is counted, verify_items reruns the work on its direct card
    path with the exact bitmap, and the scheduler keeps running."""
    raw = _raw(40, b"exec", bad=(3, 17))
    expect = [i not in (3, 17) for i in range(40)]
    state = {"sched": False}
    launched = []      # per kernel call: launched from the scheduler?

    def kernel(pubs, msgs, sigs):
        bits = _oracle(PORT)(pubs, msgs, sigs, device=torch.device("cpu"))
        launched.append(state["sched"])
        return bits[:-1] if state["sched"] else bits
    _on_card(monkeypatch, kernel)
    rt = tdeg.configure(_port_cfg(spot_check=False),
                        registry=TRegistry("exec"))
    s = sched(PORT, window_s=0.0, device="cuda")
    hosted = []
    monkeypatch.setattr(s, "_resolve_by_host",
                        lambda launch: hosted.append(launch))
    execute = s._execute

    def in_sched(launch):
        if fault == "execute_raises":
            raise ValueError("settlement bug")
        state["sched"] = True
        try:
            return execute(launch)
        finally:
            state["sched"] = False
    monkeypatch.setattr(s, "_execute", in_sched)
    items = _items(PORT, raw)
    with pytest.raises(tvs.SchedulerExecError) as ei:
        s.submit(items, tvs.Priority.BLOCKSYNC).result(timeout=30)
    assert isinstance(ei.value.__cause__, ValueError)
    ok, bits = tvs.verify_items(items, tvs.Priority.BLOCKSYNC)
    assert bits.tolist() == expect and not ok
    # the scheduler's launches (none when _execute raises first), then
    # the direct rerun on the card
    assert launched == ([True, True, False] if fault == "short_bitmap"
                        else [False])
    _eventually(lambda: s.stats()["launches"] == 2)
    assert hosted == [] and s.is_running()
    assert _exec_faults(rt, "failed") == 2 and _exec_faults(rt, "host") == 0
    assert rt.metrics.host_fallbacks.render() == [
        f"{rt.metrics.host_fallbacks.name} 0"]
    s.stop()
    assert s.stats()["exec_faults"] == 2


@pytest.mark.parametrize("where", ["cpu", "drill"])
def test_exec_fault_settles_on_the_host_on_a_cpu_lane_or_in_a_drill(
        sched, monkeypatch, where):
    """The same fault on a CPU lane, or on the card in a chaos drill,
    settles the launch on the host with the exact bitmap, as the JAX
    package's executor does, and is counted as outcome="host"."""
    raw = _raw(40, b"exec host", bad=(9,))
    if where == "drill":
        _on_card(monkeypatch, _oracle(PORT))
        tfail.register("drill.elsewhere")
        tfail.set_mode("drill.elsewhere", "raise")
    rt = tdeg.configure(_port_cfg(), registry=TRegistry("exec host"))
    s = sched(PORT, window_s=0.0,
              device="cuda" if where == "drill" else "cpu")

    def broken(launch):
        raise ValueError("settlement bug")
    monkeypatch.setattr(s, "_execute", broken)
    bits = s.submit(_items(PORT, raw)).result(timeout=30)
    assert bits.tolist() == [i != 9 for i in range(40)]
    _eventually(lambda: s.stats()["launches"] == 1)
    assert _exec_faults(rt, "host") == 1 and _exec_faults(rt, "failed") == 0


def test_build_failure_raises_out_of_start(monkeypatch):
    """On "cuda" start() builds the kernels on the calling thread: an
    nvcc failure raises out of it, no worker thread is spawned, and the
    scheduler is not running."""
    for mod in (tvs, tbatch):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda device=None: CUDA0)

    def nvcc_failed():
        raise RuntimeError("nvcc: ed25519_verify.cu did not build")
    monkeypatch.setattr(ck, "kernels", nvcc_failed)
    s = tvs.VerifyScheduler(device="cuda")
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="did not build"):
        s.start()
    assert not s.is_running()
    assert {t.name for t in threading.enumerate()} - before == set()
    s.stop()


def test_caller_on_another_device_takes_the_direct_path(sched, monkeypatch):
    """A scheduler on the CPU serves a caller on "cpu"; a caller whose
    device resolves to cuda:0 takes its direct path, and with CUDA
    missing a caller that did not ask for the CPU raises, scheduler or
    not."""
    raw = _raw(8, b"devices", bad=(2,))
    s = sched(PORT, window_s=0.0, device="cpu")
    items = _items(PORT, raw)
    expect = [i != 2 for i in range(8)]
    assert tvs.verify_items(items, device="cpu")[1].tolist() == expect
    assert tbatch.verify_sigs_bulk([i[0] for i in items],
                                   [i[1] for i in items],
                                   [i[2] for i in items],
                                   device="cpu").tolist() == expect
    assert s.stats()["submissions"] == 2
    T.set_default_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvs.verify_items(items)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.verify_sigs_bulk([i[0] for i in items], [i[1] for i in items],
                                [i[2] for i in items])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvs.VerifyScheduler()
    for mod in (tvs, tbatch):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda device=None: CUDA0)
    assert tvs.verify_items(items)[1].tolist() == expect   # direct, 8 < 32
    assert s.stats()["submissions"] == 2


def test_concurrent_submitters_stress(sched, device_lane):
    """More submitting threads than cores, with a shortened thread switch
    interval: every bitmap exact, and the stats account every item once
    (lanes + dedup + cache_hits == items) — a lost update in the
    scheduler's shared state would break either."""
    import os
    import sys

    n_threads = max(8, 2 * (os.cpu_count() or 1))
    raws = [_raw(24, b"stress %d" % (k % 4), bad=(k % 24,))
            for k in range(n_threads)]
    s = sched(PORT, window_s=0.001, max_batch=64, tpu_threshold=4)
    outs, errors = [None] * n_threads, []
    barrier = threading.Barrier(n_threads)

    def worker(k):
        barrier.wait(10)
        try:
            outs[k] = [tvs.verify_items(_items(PORT, raws[k]),
                                        tvs.Priority(k % 4))[1].tolist()
                       for _ in range(3)]
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    sw = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(sw)
    assert not any(t.is_alive() for t in ts) and not errors, errors
    for k in range(n_threads):
        want = [i != k % 24 for i in range(24)]
        assert outs[k] == [want] * 3
    st = _final(s)
    assert st["items"] == 3 * 24 * n_threads and st["shed"] == 0
    assert st["lanes"] + st["dedup"] + st["cache_hits"] == st["items"]
    assert st["submissions"] == 3 * n_threads and st["pending_items"] == 0


def test_mixed_schemes_launch_at_the_secp256k1_and_sr25519_sites(
        sched, device_lane, monkeypatch):
    """One verify_items call of ed25519, secp256k1 and sr25519 triples
    through each package's scheduler: a launch at sched.ed25519,
    sched.secp256k1 and sched.sr25519 each (the port's secp256k1 and
    sr25519 lanes on their real plain kernels S1 and S2, the JAX
    package's stubbed by the oracle behind their chaos seams: their XLA
    ladders take minutes to compile), and the same exact bitmap."""
    from tendermint_tpu.crypto import secp256k1 as jsecp
    from tendermint_tpu.crypto import sr25519 as jsr
    from tendermint_tpu.ops import secp as jsecp_ops
    from tendermint_tpu.ops import sr25519 as jsr_ops
    from tendermint_tpu_torch.crypto import secp256k1 as tsecp
    from tendermint_tpu_torch.crypto import sr25519 as tsr

    def stub(mod, site):
        def lane(pubs, msgs, sigs):
            jfail.inject(site)
            return np.array([mod.PubKey(bytes(p)).verify_signature(m, s)
                             for p, m, s in zip(pubs, msgs, sigs)])
        return lane
    monkeypatch.setattr(jsecp_ops, "verify_batch_device",
                        stub(jsecp, "ops.secp.verify_batch"))
    monkeypatch.setattr(jsr_ops, "verify_batch_device",
                        stub(jsr, "ops.sr25519.verify_batch"))
    raw = [("ed", *t) for t in _raw(8, b"mixed", bad=(3,))]
    for i in range(8):
        k = tsecp.PrivKey.gen_from_secret(b"sched secp %d" % i)
        m = b"sched secp %d" % i
        s = k.sign(m)
        raw.append(("secp", k.pub_key().bytes(), m,
                    s if i != 6 else bytes([s[0] ^ 1]) + s[1:]))
        mini = (0x5C0 + i).to_bytes(32, "little")
        m = b"sched sr %d" % i
        s = tsr.sign(mini, m)
        raw.append(("sr", tsr.PrivKey(mini).pub_key().bytes(), m,
                    s if i != 1 else s[:40] + bytes([s[40] ^ 1]) + s[41:]))
    want = [not (t == "ed" and m.endswith(b" 3")
                 or t == "secp" and m.endswith(b" 6")
                 or t == "sr" and m.endswith(b" 1")) for t, _, m, _ in raw]
    got = {}
    for pkg in PKGS:
        mods = {"ed": pkg.keys,
                "secp": jsecp if pkg is JAX else tsecp,
                "sr": jsr if pkg is JAX else tsr}
        items = [(mods[t].PubKey(p), m, s) for t, p, m, s in raw]
        kw = {} if pkg is JAX else {"device": "cpu"}
        s = sched(pkg, window_s=0.05, tpu_threshold=4, **kw)
        rt = pkg.deg.runtime()
        sites = ("sched.ed25519", "sched.secp256k1", "sched.sr25519")
        # the counters live in the process's default registry
        before = [rt.metrics.device_launches.value(site=x) for x in sites]
        ok, bits = pkg.vs.verify_items(items, **kw)
        assert bits.tolist() == want and not ok
        for site, b in zip(sites, before):
            assert rt.metrics.device_launches.value(site=site) - b == 1, \
                site
        got[pkg.name] = _final(s)
    assert got["port"] == got["jax"]
