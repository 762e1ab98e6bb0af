"""The port's device observatory (tendermint_tpu_torch/crypto/devobs.py)
and service lifecycle (libs/service.py) against the JAX package's.

The devobs scenarios of tests/test_devobs.py that the port carries: both
packages' DevObs get the same record stream and their reports must be
equal (but for the monotonic stamps t_mono / first_seen_t), as must the
metrics publish_pending feeds and the [slo] device_launch stream.  Then
the port's own launches feed it: the pub_cache and staging pools, one
record per launch, and the devobs.record chaos seam, whose raise sheds
the record and whose latency is absorbed, with the bitmap exact.  The
disabled path is held to "no store, no lock" rather than to a
wall-clock threshold.

BaseService is played through both packages as tests/test_service.py
plays the JAX package's (the node case waits for the node's port).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import devobs as jdevobs
from tendermint_tpu.libs import fail as jfail
from tendermint_tpu.libs import metrics as jmetrics
from tendermint_tpu.libs import service as jservice
from tendermint_tpu.libs import slo as jslo

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import devobs as tdevobs
from tendermint_tpu_torch.crypto import ed25519 as tkeys
from tendermint_tpu_torch.libs import fail as tfail
from tendermint_tpu_torch.libs import metrics as tmetrics
from tendermint_tpu_torch.libs import service as tservice
from tendermint_tpu_torch.libs import slo as tslo
from tendermint_tpu_torch.ops import cuda_ed25519 as ck
from tendermint_tpu_torch.ops import ed25519 as ted

MODS = {"jax": (jdevobs, jfail, jmetrics, jslo),
        "port": (tdevobs, tfail, tmetrics, tslo)}
STAMPS = ("t_mono", "first_seen_t")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is thousands of small tensor ops: with one intra-op
    thread per test process they do not contend with parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    T.set_default_device("cpu")
    for d, f, _, _ in MODS.values():
        d.reset()
        d.enable()
        f.reset()
    yield
    for d, f, _, s in MODS.values():
        f.reset()
        d.reset()
        d.enable()
        s.disable()
        s.reset()
    T.set_default_device("cuda")


def _clean_stamps(obj):
    if isinstance(obj, dict):
        return {k: _clean_stamps(v) for k, v in obj.items()
                if k not in STAMPS}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clean_stamps(v) for v in obj)
    return obj


def _both(fn):
    """fn(devobs, fail, metrics, slo) for both packages; equal results."""
    got = {k: _clean_stamps(fn(*m)) for k, m in MODS.items()}
    assert got["jax"] == got["port"], got
    return got["port"]


# ---------------------------------------------------------------------------
# record mechanics: ring bounds, compile inventory, ledger
# ---------------------------------------------------------------------------

def test_ring_bounds_and_compile_inventory():
    def play(d, f, m, s):
        o = d.DevObs(capacity=4, enabled=True)
        assert o.record({"path": "cuda", "n": 48, "nb": 256, "shards": 1,
                         "first_launch": True, "wall_s": 2.0})
        for i in range(5):
            o.record({"path": "cuda", "n": 40 + i, "nb": 256, "shards": 1,
                      "first_launch": False, "wall_s": 0.01})
        o.record({"path": "cuda-split", "n": 100, "nb": 16384,
                  "first_launch": True, "wall_s": 1.5})
        return (o.report(last=8), o.rotated(), o.shed_counts(),
                [r["obs_seq"] for r in o.records()], o.last_seq())
    rep, rotated, shed, seqs, last = _both(play)
    assert seqs == [4, 5, 6, 7] and last == 7 and rotated == 3
    assert shed == {"chaos": 0, "evict": 0}
    inv = rep["compile_cache"]
    assert [(e["path"], e["nb"], e["shards"], e["compile_s"], e["hits"])
            for e in inv] == [("cuda", 256, 1, 2.0, 5),
                              ("cuda-split", 16384, 1, 1.5, 0)]


def test_pending_queue_overflow_is_a_real_shed():
    def play(d, f, m, s):
        o = d.DevObs(capacity=4, enabled=True)
        for _ in range(d._MAX_PENDING + 10):
            o.record({"path": "cuda", "n": 1, "nb": 256, "wall_s": 0.001})
        return len(o._pending), o.shed_counts(), o.rotated()
    n, shed, rotated = _both(play)
    assert n == tdevobs._MAX_PENDING == 4096 and shed["evict"] == 10


def test_device_block_totals_survive_ring_rotation():
    def play(d, f, m, s):
        o = d.DevObs(capacity=4, enabled=True)
        o._metrics = m.DevObsMetrics(m.Registry("devobs_totals"))
        cur0 = o.cursor()
        o.record({"path": "cuda", "n": 64, "nb": 256, "shards": 1,
                  "first_launch": True, "wall_s": 9.0})
        for _ in range(20):
            o.record({"path": "cuda", "n": 64, "nb": 256, "shards": 1,
                      "first_launch": False, "wall_s": 0.05,
                      "compute_s": 0.04})
        return o.device_block(), o.device_block(since=cur0), \
            o.device_block(since=o.cursor())
    blk, since, after = _both(play)
    for b in (blk, since):
        assert b["launches"] == 21 and b["compile_s"] == 9.0
        assert b["compile_frac"] == pytest.approx(0.9)
        assert b["window"]["launches"] == 4
        assert b["window"]["compute_s"] == pytest.approx(0.16)
    assert after["launches"] == 0


def test_ledger_levels_and_high_water():
    def play(d, f, m, s):
        o = d.DevObs(capacity=4, enabled=True)
        o.ledger_set("pub_cache", 1000)
        o.ledger_set("pub_cache", 400)
        o.ledger_add("staging", 300)
        o.ledger_add("staging", 200)
        o.ledger_add("staging", -500)
        o.ledger_add("staging", -50)               # clamped at zero
        o.ledger_set("exotic_pool", 7)
        return list(o.ledger_report().items())
    rep = dict(_both(play))
    assert rep["pub_cache"] == {"bytes": 400, "peak_bytes": 1000}
    assert rep["staging"] == {"bytes": 0, "peak_bytes": 500}
    assert list(rep) == ["pub_cache", "staging", "exotic_pool"]


def test_publish_pending_feeds_metrics_and_slo():
    def play(d, f, m, s):
        o = d.DevObs(capacity=8, enabled=True)
        o._metrics = m.DevObsMetrics(m.Registry("devobs_pub"))
        o.ledger_set("staging", 123)
        o.record({"path": "cuda", "n": 48, "nb": 256, "shards": 1,
                  "first_launch": False, "wall_s": 0.5, "stage_s": 0.1,
                  "h2d_s": 0.1, "compute_s": 0.2, "collect_s": 0.1,
                  "chunk_overlap": 0.75})
        o.record({"path": "cuda-split", "n": 100, "nb": 16384, "shards": 1,
                  "first_launch": False, "wall_s": 0.3, "h2d_s": 0.1,
                  "drain_s": 0.2})
        s.reset()
        s.enable(targets={"device_launch": 0.001})
        o.publish_pending()
        mm = o._metrics
        out = [mm.device_transfer.count(path="cuda"),
               mm.device_compute.total(path="cuda"),
               mm.device_stage.count(path="cuda"),
               mm.device_collect.count(path="cuda"),
               mm.device_drain.count(path="cuda-split"),
               mm.device_collect.count(path="cuda-split"),
               mm.chunk_overlap.value(), mm.chunk_overlap_seq.value(),
               mm.hbm_resident.value(pool="staging"),
               mm.hbm_peak.value(pool="staging"),
               mm.compile_cache_entries.value(),
               mm.devobs_shed.value(reason="chaos")]
        rep = s.stream_report("device_launch")
        o.publish_pending()   # nothing new: publishes nothing again
        out += [rep["n"], rep["burn_rate"], mm.device_transfer.count(
            path="cuda")]
        return out
    assert _both(play) == [1, 0.2, 1, 1, 1, 0, 0.75, 1.0, 123.0, 123.0,
                           2.0, 0.0, 2, 100.0, 1]


def test_devobs_metrics_families_match():
    """DevObsMetrics registers the JAX package's families with the same
    help, labels and buckets, the per-shard imbalance gauges of the
    sharded paths included."""
    def families(m):
        reg = m.Registry("x")
        m.DevObsMetrics(reg)
        return [(k, type(v).__name__, v.help, v.label_names,
                 getattr(v, "buckets", None))
                for k, v in sorted(reg._metrics.items())]
    ported = families(jmetrics)
    assert ported == families(tmetrics) and len(ported) == 13
    assert sum("_shard_" in f[0] for f in ported) == 2


def test_set_config_wins_both_ways_and_resizes():
    def play(d, f, m, s):
        o = d.DevObs(capacity=8, enabled=False)
        o.set_config(enabled=True)
        out = [o.is_enabled()]
        for i in range(6):
            o.record({"path": "cuda", "n": i, "nb": 256, "wall_s": 0.1})
        o.set_config(capacity=3)
        out += [o.capacity, len(o.records())]
        o.set_config(enabled=False)
        out.append(o.is_enabled())
        o.set_config(capacity=5)
        out += [o.is_enabled(), o.capacity, o.report()]
        return out
    out = _both(play)
    assert out[:6] == [True, 3, 3, False, False, 5]


class _NoLock:
    def __enter__(self):
        raise AssertionError("the disabled path took the lock")

    def __exit__(self, *exc):
        return False


def test_disabled_is_a_noop_without_store_or_lock(monkeypatch):
    """record() and the ledger are called on every launch: disabled, the
    module functions return before any store, and never take the lock."""
    seq0 = tdevobs.last_seq()   # reset() keeps the sequence
    tdevobs.disable()
    monkeypatch.setattr(tdevobs.OBS, "_lock", _NoLock())
    dummy = {"path": "cuda", "n": 1, "nb": 256, "wall_s": 0.1}
    assert tdevobs.record(dummy) is False
    assert tdevobs.OBS.record(dummy) is False
    tdevobs.ledger_add("staging", 100)
    tdevobs.ledger_set("pub_cache", 100)
    tdevobs.publish_pending()
    assert tdevobs.device_block() == {}
    monkeypatch.undo()
    assert tdevobs.records() == [] and tdevobs.ledger_report() == {}
    assert tdevobs.last_seq() == seq0 and not tdevobs.is_enabled()


def test_record_drain_concurrency():
    """Concurrent recorders and ledger writers while the main thread
    drains: every record is published once, nothing sheds, the staging
    level returns to zero — the same totals in both packages."""
    def play(d, f, m, s):
        o = d.DevObs(capacity=64, enabled=True)
        o._metrics = m.DevObsMetrics(m.Registry("devobs_conc"))

        def recorder():
            for i in range(500):
                o.record({"path": "cuda", "n": 48, "nb": 256, "shards": 1,
                          "first_launch": i == 0, "wall_s": 0.001,
                          "stage_s": 0.0005, "compute_s": 0.0005})
                o.ledger_add("staging", 64 if i % 2 == 0 else -64)

        threads = [threading.Thread(target=recorder) for _ in range(4)]
        for t in threads:
            t.start()
        for _ in range(50):
            o.publish_pending()
        for t in threads:
            t.join(timeout=10.0)
        o.publish_pending()
        return (o._metrics.device_compute.count(path="cuda"),
                o.shed_counts(), o.ledger_report()["staging"]["bytes"],
                o.cursor()["launches"], len(o.compile_inventory()))
    assert _both(play) == (2000, {"chaos": 0, "evict": 0}, 0, 2000, 1)


# ---------------------------------------------------------------------------
# the port's launches feed it
# ---------------------------------------------------------------------------

def _batch(n, bad=()):
    privs = [tkeys.PrivKey((0xDB00 + i).to_bytes(32, "big"))
             for i in range(n)]
    msgs = [b"devobs %6d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    for i in bad:
        s = bytearray(sigs[i])
        s[3] ^= 0x40
        sigs[i] = bytes(s)
    return [p.pub_key().bytes() for p in privs], msgs, sigs


def test_pub_cache_and_staging_pools_over_a_real_launch(monkeypatch):
    """A cache_pubs batch on the split route (PUB_CACHE_MIN lowered, as
    test_torch_ed25519 does): the pubkey rows' bytes land in the pub_cache
    pool equal to the DeviceLRU's total_bytes, the chunk feed's in-flight
    rows are charged to staging and released when the launch returns, and
    the launch is one record with its phases and its compile-inventory
    entry (keyed as _seen_buckets, without the device)."""
    monkeypatch.setattr(ted, "PUB_CACHE_MIN", 16)
    monkeypatch.setattr(ted, "_pub_cache",
                        ted.DeviceLRU(max_entries=ted._PUB_CACHE_MAX))
    # the comb would build tables for a cache_pubs batch this size
    monkeypatch.setattr(ted, "_comb_enabled_override", False)
    pubs, msgs, sigs = _batch(20, bad=(4,))
    cur = tdevobs.cursor()
    out = ted.verify_batch(pubs, msgs, sigs, cache_pubs=True, device="cpu")
    assert out.tolist() == [i != 4 for i in range(20)]
    rep = tdevobs.ledger_report()
    assert rep["pub_cache"]["bytes"] == ted._pub_cache.total_bytes \
        == 32 * 256
    assert rep["staging"] == {"bytes": 0, "peak_bytes": 96 * 256}
    recs = tdevobs.records(since_seq=cur["seq"])
    assert len(recs) == 1 and tdevobs.device_block(since=cur)["launches"] == 1
    rec = recs[0]
    assert rec["path"] == "cuda-split" and rec["nb"] == 256
    assert rec["seq"] == ted.last_launch()["seq"] and rec["shards"] == 1
    assert {"stage_s", "collect_s", "wall_s"} <= set(rec)
    inv = {(e["path"], e["nb"], e["shards"]) for e in
           tdevobs.compile_inventory()}
    assert ("cuda-split", 256, 1) in inv
    assert ("cuda-split", "cpu", 256) in ted._seen_buckets
    # an LRU eviction gives the pool its bytes back
    lru = ted.DeviceLRU(max_entries=1)
    lru.put("a", [0], nbytes=100)
    lru.put("b", [1], nbytes=30)
    assert lru.total_bytes == 30 and lru.evictions == 1


@pytest.fixture
def stub_k1(monkeypatch):
    """K1's wrapper as a stub that returns the expected verdicts (the
    observatory sits above the kernel); staging and records are real."""
    want = {}

    def verify_packed(packed):
        out = torch.zeros(packed.shape[1], dtype=torch.bool)
        out[:len(want["bits"])] = torch.from_numpy(want["bits"])
        return out
    monkeypatch.setattr(ck, "verify_packed", verify_packed)
    return want


def test_chaos_devobs_record_raise_sheds_bitmap_exact(stub_k1):
    pubs, msgs, sigs = _batch(24, bad=(3, 17))
    want = np.ones(24, dtype=bool)
    want[[3, 17]] = False
    stub_k1["bits"] = want
    assert (ted.verify_batch(pubs, msgs, sigs) == want).all()
    rec = dict(ted.last_launch())
    shed0 = tmetrics.DevObsMetrics().devobs_shed.value(reason="chaos")
    tdevobs.reset()
    tfail.set_mode("devobs.record", "raise")
    out = ted.verify_batch(pubs, msgs, sigs)
    assert (out == want).all()
    assert tfail.fired("devobs.record", "raise") == 1
    assert tdevobs.records() == []
    tfail.clear("devobs.record")
    tdevobs.publish_pending()
    assert tmetrics.DevObsMetrics().devobs_shed.value(reason="chaos") == \
        shed0 + 1

    # the JAX package's observatory sheds the same record the same way
    def play(d, f, m, s):
        o = d.DevObs(capacity=8, enabled=True)
        f.set_mode("devobs.record", "raise")
        try:
            stored = o.record(rec)
        finally:
            f.clear("devobs.record")
        return stored, o.report()
    stored, rep = _both(play)
    assert stored is False and rep["shed"] == {"chaos": 1, "evict": 0}
    assert rep["launches"] == [] and rep["compile_cache"] == []


def test_chaos_devobs_record_latency_swallowed_bitmap_exact(stub_k1):
    pubs, msgs, sigs = _batch(16, bad=(5,))
    want = np.ones(16, dtype=bool)
    want[5] = False
    stub_k1["bits"] = want
    tfail.set_mode("devobs.record", "latency:5")
    out = ted.verify_batch(pubs, msgs, sigs)
    tfail.clear("devobs.record")
    assert (out == want).all()
    assert tfail.fired("devobs.record", "latency:5") == 1
    recs = tdevobs.records()
    assert len(recs) == 1 and recs[0]["path"] == "cuda"
    assert tdevobs.OBS.shed_counts() == {"chaos": 0, "evict": 0}


def test_publication_runs_outside_the_launch_lock(stub_k1, monkeypatch):
    """The launch seam stores the record and publishes with ops'
    _launch_lock released."""
    pubs, msgs, sigs = _batch(8)
    stub_k1["bits"] = np.ones(8, dtype=bool)
    held = []
    real = tdevobs.OBS.publish_pending

    def publish():
        held.append(ted._launch_lock.locked())
        real()
    monkeypatch.setattr(tdevobs.OBS, "publish_pending", publish)
    ted.verify_batch(pubs, msgs, sigs)
    assert held == [False]


# ---------------------------------------------------------------------------
# BaseService (tests/test_service.py:28-100)
# ---------------------------------------------------------------------------

def _counter(svc_mod):
    class Counter(svc_mod.BaseService):
        def __init__(self):
            super().__init__("counter")
            self.ticks = 0
            self.stopped_hook = False

        def on_start(self):
            self.spawn(self._run)

        def on_stop(self):
            self.stopped_hook = True

        def _run(self):
            while not self.quitting.wait(0.01):
                self.ticks += 1
    return Counter()


SERVICES = [jservice, tservice]


@pytest.mark.parametrize("svc", SERVICES, ids=["jax", "port"])
def test_service_lifecycle_and_errors(svc):
    s = _counter(svc)
    assert not s.is_running()
    s.start()
    assert s.is_running()
    with pytest.raises(svc.AlreadyStartedError):
        s.start()
    s.stop()
    assert s.stopped_hook and not s.is_running()
    assert all(not t.is_alive() for t in s._threads)
    ticks = s.ticks
    time.sleep(0.03)
    assert s.ticks == ticks  # routine exited with the service
    with pytest.raises(svc.AlreadyStoppedError):
        s.start()
    s.stop()  # idempotent
    s.reset()
    s.start()
    assert s.is_running()
    s.stop()
    assert issubclass(svc.AlreadyStartedError, svc.ServiceError)
    assert issubclass(svc.AlreadyStoppedError, svc.ServiceError)


@pytest.mark.parametrize("svc", SERVICES, ids=["jax", "port"])
def test_service_reset_while_running_refused(svc):
    s = _counter(svc)
    s.start()
    with pytest.raises(svc.ServiceError, match="reset while running"):
        s.reset()
    s.stop()


@pytest.mark.parametrize("svc", SERVICES, ids=["jax", "port"])
def test_service_wait_unblocks_on_stop(svc):
    s = _counter(svc)
    s.start()
    assert not s.wait(0.02)
    s.stop()
    assert s.wait(1.0)
    never = _counter(svc)
    never.stop()           # stopped before it started: nothing to join
    assert not never.is_running() and not never.wait(0.0)
