"""The port's state sync (statesync/syncer.py, ledger.py, stateprovider.py,
reactor.py) against the JAX package's, on the CPU.

tests/test_statesync.py's standalone cases run through both packages as
`case_*` functions on the same seeded chain (tests/test_torch_blocksync.py's
`build_chain`, replayed into a kvstore that snapshots every 5 heights); each
case keeps its assertions and returns its outcome as a package-free value,
and the outcomes are compared across the packages exactly.  Two cases wait
for ROADMAP Queue 1 item 9: the [statesync] config round trip
(tests/test_statesync.py:726, `config.config`) and the NetHarness fresh-join
scenario (`networks/`).  Beside them: a snapshot served by one package's
StateSyncReactor over a Switch, restored by the other's Syncer through its
own reactor (the snapshot bytes are JSON and the wire is the statesync
proto, so both cross), both ways; and the port's departure, a card fault
(degrade.DeviceLaneError) in the light verification, which leaves sync_any
as itself with nothing offered, rejected, banned or cleared, and in a chaos
drill takes the JAX package's path.  Tolerance: exact equality everywhere.
"""
from __future__ import annotations

import functools
import hashlib
import importlib
import os
import subprocess
import sys
import threading
import time
import types

import pytest

from test_torch_blocksync import BY_NAME as CHAIN_PKG
from test_torch_blocksync import build_chain, make_genesis, wait_for
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_MODS = {
    "abci": "abci.types", "kvstore": "abci.kvstore", "kvdb": "libs.kvdb",
    "fail": "libs.fail", "slo": "libs.slo", "trace": "libs.trace",
    "replay": "blocksync.replay", "execution": "state.execution",
    "state": "state.state", "sstore": "state.store",
    "bstore": "store.block_store", "basic": "types.basic",
    "light_block": "types.light_block", "light": "light",
    "statesync": "statesync", "syncer": "statesync.syncer",
    "ledger": "statesync.ledger", "integrity": "statesync.integrity",
    "reactor": "statesync.reactor", "switch": "p2p.switch",
    "key": "p2p.key", "ed": "crypto.ed25519", "degrade": "crypto.degrade",
    "validator_set": "types.validator_set",
}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)
BY_NAME = {p.name: p for p in PKGS}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS:
        p.fail.clear()
    yield
    for p in PKGS:
        p.fail.clear()


def NOW(p):
    return p.basic.Timestamp(1700005000, 0)


def executor(p, app):
    kw = {"device": "cpu"} if p is PORT else {}
    return p.execution.BlockExecutor(p.sstore.StateStore(p.kvdb.MemDB()),
                                     app, **kw)


@functools.lru_cache(maxsize=None)
def _served_chain(name: str, n_heights=20, n_vals=4, snapshot_interval=5,
                  chunk_size=128):
    """tests/test_statesync.py's serving node through package `name`: the
    chain built by build_chain and replayed into a kvstore that snapshots
    every `snapshot_interval` heights in chunks of `chunk_size` bytes.
    Nothing below mutates it."""
    p, b = BY_NAME[name], CHAIN_PKG[name]
    gdoc, privs = make_genesis(b, n_vals)
    app = p.kvstore.KVStoreApplication()
    app.snapshot_interval = snapshot_interval
    app.snapshot_chunk_size = chunk_size
    ex = executor(p, app)
    blocks, commits, states = build_chain(
        b, gdoc, privs, n_heights, txs_fn=lambda h: [b"k%d=v%d" % (h, h)])
    store = p.bstore.BlockStore(p.kvdb.MemDB())
    state = p.state.state_from_genesis(gdoc)
    applied = 0
    while applied < n_heights:
        state, n = p.replay.replay_window(ex, store, state, blocks[applied:],
                                          commits[applied:], max_window=8)
        applied += n
    lbs = {b.header.height: p.light_block.LightBlock(
        p.light_block.SignedHeader(b.header, commits[i]),
        states[i].validators) for i, b in enumerate(blocks)}
    return gdoc, privs, app, blocks, commits, states, lbs


def light_sp(p, gdoc, lbs):
    kw = {"device": "cpu"} if p is PORT else {}
    lc = p.light.Client(gdoc.chain_id,
                        p.light.TrustOptions(1, lbs[1].hash(), 3600.0 * 24),
                        p.light.DictProvider(gdoc.chain_id, lbs), [],
                        p.light.LightStore(p.kvdb.MemDB()), **kw)
    return p.statesync.StateProvider(lc, NOW(p))


def chunk_of(app, snapshot, index):
    return app.load_snapshot_chunk(snapshot.height, snapshot.format, index)


def data_at(app, h):
    return {k: v for k, v in app.data.items() if int(k[1:]) <= h}


def recording_app(p):
    class _RecordingApp(p.kvstore.KVStoreApplication):
        def __init__(self):
            super().__init__()
            self.applied = []

        def apply_snapshot_chunk(self, index, chunk, sender):
            self.applied.append((index, bytes(chunk), sender))
            return super().apply_snapshot_chunk(index, chunk, sender)
    return _RecordingApp()


class FakePeer:
    def __init__(self, pid):
        self.id = pid
        self.sent = []
        self._lock = threading.Lock()

    def try_send(self, ch, msg):
        with self._lock:
            self.sent.append(msg)
        return True

    def responses(self):
        with self._lock:
            return list(self.sent)


def run_limited(fn, seconds):
    """fn() on a daemon thread; the test fails if it has not returned
    within `seconds` (a test that opens sockets has a time limit of its
    own).  Returns fn's result, or raises its exception."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e
    th = threading.Thread(target=run, daemon=True, name="time-limited")
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"over its {seconds} s time limit"
    if "err" in box:
        raise box["err"]
    return box.get("out")


# ---------------------------------------------------------------------------
# tests/test_statesync.py's standalone cases
# ---------------------------------------------------------------------------

def case_bootstrap_and_resume(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    snaps = serving.list_snapshots()
    assert snaps
    fresh = p.kvstore.KVStoreApplication()
    syncer = p.statesync.Syncer(fresh, light_sp(p, gdoc, lbs), lambda s, i,
                                peer: (chunk_of(serving, s, i), peer))
    for s in snaps:
        syncer.add_snapshot(s, "peer1")
    state, commit = syncer.sync_any()
    h = state.last_block_height
    assert h == 15 and fresh.height == h
    assert fresh.data == data_at(serving, h)
    assert state.app_hash == states[h - 1].app_hash and commit.height == h
    store = p.bstore.BlockStore(p.kvdb.MemDB())
    store.save_seen_commit(h, commit)
    ex = executor(p, fresh)
    applied, rest = 0, blocks[h:]
    while applied < len(rest):
        state, n = p.replay.replay_window(ex, store, state, rest[applied:],
                                          commits[h + applied:],
                                          max_window=8)
        applied += n
    assert state.last_block_height == len(blocks)
    assert state.app_hash == states[-1].app_hash
    return {"h": h, "data": fresh.data, "state": plain(state),
            "restore": syncer.last_restore["chunks"]}


def case_rejects_corrupt_snapshot(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    fresh = p.kvstore.KVStoreApplication()
    syncer = p.statesync.Syncer(
        fresh, light_sp(p, gdoc, lbs),
        lambda s, i, peer: (b"\x00" + chunk_of(serving, s, i)[1:], peer))
    for s in serving.list_snapshots():
        syncer.add_snapshot(s, "peer1")
    with pytest.raises(p.statesync.StateSyncError) as e:
        syncer.sync_any()
    return {"error": type(e.value).__name__, "height": fresh.height}


def case_statestore_bootstrap_persists_validator_sets(p):
    _, _, _, _, _, states, _ = _served_chain(p.name)
    st = states[10]
    h = st.last_block_height
    ss = p.sstore.StateStore(p.kvdb.MemDB())
    ss.bootstrap(st)
    assert ss.load().last_block_height == h
    for hh in (h, h + 1, h + 2):
        assert ss.load_validators(hh) is not None, hh
    assert ss.load_consensus_params(h + 1) is not None
    return {"vals": [plain(ss.load_validators(hh)) for hh in (h, h + 1,
                                                               h + 2)]}


def case_concurrent_fetchers_with_flaky_transport(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    snaps = serving.list_snapshots()
    fresh = p.kvstore.KVStoreApplication()
    seen_threads, fail_once = set(), set()
    lock = threading.Lock()

    def flaky(snapshot, index, peer):
        with lock:
            seen_threads.add(threading.current_thread().name)
            if index not in fail_once:
                fail_once.add(index)
                raise p.syncer.StateSyncError(f"transient fail {index}")
        time.sleep(0.05 * ((index * 7) % 3))
        return chunk_of(serving, snapshot, index), peer

    syncer = p.statesync.Syncer(fresh, light_sp(p, gdoc, lbs), flaky,
                                fetchers=4)
    for s in snaps:
        syncer.add_snapshot(s, "peer1")
    state, _ = syncer.sync_any()
    head = max(b.header.height for b in blocks)
    best_ok = max(s.height for s in snaps if s.height <= head - 2)
    assert state.last_block_height == best_ok
    info = fresh.info(p.abci.RequestInfo())
    assert info.last_block_height == state.last_block_height
    assert len(seen_threads) >= 2, seen_threads
    return {"h": best_ok, "app_hash": info.last_block_app_hash}


def case_gives_up_after_chunk_retry_limit(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)

    def dead(snapshot, index, peer):
        raise p.syncer.StateSyncError("peer gone")

    syncer = p.statesync.Syncer(p.kvstore.KVStoreApplication(),
                                light_sp(p, gdoc, lbs), dead, fetchers=3)
    for s in serving.list_snapshots():
        syncer.add_snapshot(s, "peer1")
    with pytest.raises(p.syncer.StateSyncError) as e:
        syncer.sync_any()
    return {"error": type(e.value).__name__}


def case_chunk_metadata_roundtrip_and_tamper(p):
    integ = p.integrity
    chunks = [b"a" * 10, b"b" * 10, b"tail"]
    meta = integ.make_chunk_metadata(chunks)
    digests = integ.parse_chunk_metadata(meta, 3)
    assert digests is not None and len(digests) == 3
    for i, c in enumerate(chunks):
        assert integ.verify_chunk(digests, i, c)
        assert not integ.verify_chunk(digests, i, c + b"x")
    assert integ.parse_chunk_metadata(b"", 3) is None
    assert integ.parse_chunk_metadata(b"junkmeta", 3) is None
    assert integ.parse_chunk_metadata(meta, 2) is None
    bad = bytearray(meta)
    bad[10] ^= 0xFF
    assert integ.parse_chunk_metadata(bytes(bad), 3) is None
    stored = {0: chunks[0], 1: b"rotten", 2: chunks[2]}
    assert integ.verify_chunks(digests, stored) == [0, 2]
    assert integ.verify_chunks(None, stored) == [0, 1, 2]
    return {"meta": meta, "digests": list(digests)}


def case_kvstore_snapshots_carry_chunk_digests(p):
    serving = _served_chain(p.name)[2]
    out = []
    for s in serving.list_snapshots():
        digests = p.integrity.parse_chunk_metadata(s.metadata, s.chunks)
        assert digests is not None
        for i in range(s.chunks):
            assert p.integrity.verify_chunk(digests, i,
                                            chunk_of(serving, s, i))
        out.append(plain(s))
    return out


def case_corrupt_chunk_detected_pre_app_and_banned(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    fresh = recording_app(p)
    banned = []
    m = p.syncer.metrics()
    base_corrupt = m.chunks_verified.value(outcome="corrupt")
    base_banned = m.peers_banned.value()

    def fetch(snapshot, index, peer):
        body = chunk_of(serving, snapshot, index)
        return (b"\x00" * len(body) if peer == "evil" else body), peer

    syncer = p.statesync.Syncer(fresh, light_sp(p, gdoc, lbs), fetch,
                                ban_peer=lambda q, r: banned.append((q, r)),
                                fetchers=3)
    for s in serving.list_snapshots():
        for peer in ("evil", "good1", "good2"):
            syncer.add_snapshot(s, peer)
    state, _ = syncer.sync_any()
    h = state.last_block_height
    assert fresh.height == h and fresh.data == data_at(serving, h)
    snaps = {(s.height, s.format): s for s in serving.list_snapshots()}
    for idx, chunk, sender in fresh.applied:
        assert hashlib.sha256(chunk).digest() == hashlib.sha256(
            chunk_of(serving, snaps[(h, 1)], idx)).digest()
    assert any(q == "evil" for q, _ in banned)
    assert not any(q.startswith("good") for q, _ in banned)
    assert m.chunks_verified.value(outcome="corrupt") > base_corrupt
    assert m.peers_banned.value() > base_banned
    assert m.time_to_synced.value() > 0
    return {"h": h, "banned": sorted({q for q, _ in banned}),
            "applied": sorted({i for i, _, _ in fresh.applied})}


def case_one_dead_peer_of_three_completes(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    fresh = p.kvstore.KVStoreApplication()
    banned, asked = [], []
    lock = threading.Lock()

    def fetch(snapshot, index, peer):
        with lock:
            asked.append(peer)
        if peer == "dead":
            raise p.syncer.StateSyncError("connection refused")
        return chunk_of(serving, snapshot, index), peer

    syncer = p.statesync.Syncer(fresh, light_sp(p, gdoc, lbs), fetch,
                                ban_peer=lambda q, r: banned.append(q),
                                fetchers=3, retries=2)
    for s in serving.list_snapshots():
        for peer in ("dead", "alive1", "alive2"):
            syncer.add_snapshot(s, peer)
    state, _ = syncer.sync_any()
    assert state.last_block_height == 15 and fresh.height == 15
    assert {"alive1", "alive2"} <= set(asked)
    assert "alive1" not in banned and "alive2" not in banned
    assert syncer.last_restore["chunks"] >= 1
    return {"h": 15, "chunks": syncer.last_restore["chunks"]}


def case_peer_book_budget_epochs_and_ban(p):
    banned = []
    book = p.syncer._PeerBook(["a", "b"], retries=2,
                              ban_cb=lambda q, r: banned.append((q, r)))
    t0 = time.monotonic()
    assert book.failure("a", t0, "x") is False
    for _ in range(3):
        assert book.failure("a", t0, "x") is False
    assert book.dead_peers() == []
    assert book.failure("a", time.monotonic(), "x") is False
    assert book.failure("a", time.monotonic(), "x") is True
    assert book.dead_peers() == ["a"]
    assert banned and banned[0][0] == "a"
    for _ in range(4):
        peer, _w = book.pick()
        if peer is not None:
            assert peer == "b"
    book.failure("b", time.monotonic(), "x")
    book.success("b")
    assert book.pick()[0] == "b"
    book.ban("b", "digest mismatch")
    assert book.all_dead() and ("b", "digest mismatch") in banned
    peer, wait_s = book.pick()
    assert peer is None and wait_s < 0
    return {"banned": banned, "dead": book.dead_peers()}


def case_busy_peer_backs_off_without_strike(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    banned, busy_hits = [], [0]

    def fetch(snapshot, index, peer):
        if peer == "loaded":
            busy_hits[0] += 1
            raise p.syncer.ChunkBusy("busy", retry_after_s=0.05)
        return chunk_of(serving, snapshot, index), peer

    syncer = p.statesync.Syncer(p.kvstore.KVStoreApplication(),
                                light_sp(p, gdoc, lbs), fetch,
                                ban_peer=lambda q, r: banned.append(q),
                                fetchers=2)
    for s in serving.list_snapshots():
        syncer.add_snapshot(s, "loaded")
        syncer.add_snapshot(s, "calm")
    state, _ = syncer.sync_any()
    assert state.last_block_height == 15 and busy_hits[0] >= 1
    assert banned == []
    return {"h": 15, "banned": banned}


def case_ledger_resume_skips_stored_chunks(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(
        p.name, chunk_size=32)
    ledger = p.ledger.RestoreLedger(p.kvdb.MemDB(), group_every=2)
    fetches = []
    lock = threading.Lock()
    armed = [True]

    def flaky(snapshot, index, peer):
        with lock:
            fetches.append(index)
            if len(fetches) > 3 and armed[0]:
                raise p.syncer.StateSyncError("transport died")
        return chunk_of(serving, snapshot, index), peer

    syncer = p.statesync.Syncer(p.kvstore.KVStoreApplication(),
                                light_sp(p, gdoc, lbs), flaky, fetchers=1,
                                retries=1, ledger=ledger)
    best = max(s.height for s in serving.list_snapshots() if s.height <= 18)
    target = [s for s in serving.list_snapshots() if s.height == best][0]
    syncer.add_snapshot(target, "peer1")
    with pytest.raises(p.syncer.StateSyncError):
        syncer.sync_any()
    stored_before = len(ledger.begin(target))
    assert 1 <= stored_before <= 3
    assert ledger.manifest()["height"] == target.height
    armed[0] = False
    first = len(fetches)
    fresh2 = p.kvstore.KVStoreApplication()
    syncer2 = p.statesync.Syncer(fresh2, light_sp(p, gdoc, lbs), flaky,
                                 fetchers=1, ledger=ledger)
    syncer2.add_snapshot(target, "peer1")
    state, _ = syncer2.sync_any()
    assert state.last_block_height == target.height == fresh2.height
    assert len(fetches) - first == target.chunks - stored_before
    assert syncer2.last_restore["resumed"] == stored_before
    assert ledger.manifest() is None
    return {"stored": stored_before, "h": target.height,
            "refetched": len(fetches) - first}


def case_ledger_clears_on_snapshot_rejection(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    ledger = p.ledger.RestoreLedger(p.kvdb.MemDB(), group_every=2)
    abci = p.abci

    class RejectingApp(p.kvstore.KVStoreApplication):
        def apply_snapshot_chunk(self, index, chunk, sender):
            r = super().apply_snapshot_chunk(index, chunk, sender)
            if self._restoring is None and r.result == \
                    abci.ResponseApplySnapshotChunk.ACCEPT:
                raise RuntimeError("app exploded after restore")
            return r

    syncer = p.statesync.Syncer(RejectingApp(), light_sp(p, gdoc, lbs),
                                lambda s, i, peer: (chunk_of(serving, s, i),
                                                    peer),
                                fetchers=2, ledger=ledger)
    for s in serving.list_snapshots():
        syncer.add_snapshot(s, "peer1")
    with pytest.raises(p.syncer.StateSyncError):
        syncer.sync_any()
    assert ledger.manifest() is None
    assert list(ledger.db.iterate_prefix(b"ss:")) == []
    return {"cleared": True}


def case_chaos_matrix(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    fail = p.fail

    def run_sync(app=None, **kw):
        syncer = p.statesync.Syncer(
            app or p.kvstore.KVStoreApplication(), light_sp(p, gdoc, lbs),
            lambda s, i, peer: (chunk_of(serving, s, i), peer), **kw)
        for s in serving.list_snapshots():
            syncer.add_snapshot(s, "p1")
            syncer.add_snapshot(s, "p2")
        return syncer.sync_any()

    out = {}
    m = p.syncer.metrics()
    for site, mode, kw, ok in (
            ("statesync.fetch", "raise", {"retries": 1}, False),
            ("statesync.fetch", "latency:30", {}, True),
            ("statesync.fetch", "corrupt-chunk", {"retries": 1}, False),
            ("statesync.verify", "raise", {"retries": 1}, False),
            ("statesync.apply", "raise", {}, False),
            ("statesync.apply", "latency:20", {}, True)):
        app = recording_app(p)
        corrupt0 = m.chunks_verified.value(outcome="corrupt")
        fail.set_mode(site, mode)
        try:
            if ok:
                state, _ = run_sync(app=app, **kw)
                assert state.last_block_height == 15
                got = "restored"
            else:
                with pytest.raises(p.syncer.StateSyncError) as e:
                    run_sync(app=app, **kw)
                got = ("REJECTED" in str(e.value), len(app.applied))
                if site in ("statesync.fetch", "statesync.verify"):
                    assert app.applied == []
            assert fail.fired(site, mode) >= 1
        finally:
            fail.clear()
        if mode == "corrupt-chunk":
            assert m.chunks_verified.value(outcome="corrupt") > corrupt0
        out[f"{site}={mode}"] = got
    assert out["statesync.apply=raise"][0]
    return out


def case_spans_and_slo_stream(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    syncer = p.statesync.Syncer(
        p.kvstore.KVStoreApplication(), light_sp(p, gdoc, lbs),
        lambda s, i, peer: (chunk_of(serving, s, i), peer), fetchers=2)
    for s in serving.list_snapshots():
        syncer.add_snapshot(s, "peer1")
    since = p.trace.last_seq()
    p.trace.enable(capacity=4096)
    p.slo.set_config(enabled=True, window=256)
    try:
        state, _ = syncer.sync_any()
    finally:
        spans = p.trace.snapshot(since=since)
        p.trace.disable()
        rep = p.slo.stream_report("statesync")
        p.slo.set_config(enabled=False)
    assert state.last_block_height == 15
    got = {s["name"] for s in spans}
    assert "statesync.fetch" in got and "statesync.apply" in got
    assert rep is not None and rep["n"] >= 1
    return {"names": sorted(n for n in got if n.startswith("statesync"))}


def case_serve_bounded_queue_ratelimit_and_chaos(p):
    serving = _served_chain(p.name)[2]
    snap = serving.list_snapshots()[0]
    R = p.reactor
    m = p.syncer.metrics()
    base_refused = sum(m.serve_refused.value(reason=r)
                       for r in ("busy", "ratelimit"))
    base_served = m.chunks_served.value()
    reactor = R.StateSyncReactor(serving, serve_rate_per_s=50.0,
                                 serve_burst=4, serve_queue=8)
    reactor.start()
    out = {}
    try:
        flooder = FakePeer("flooder")
        raw = R.encode_msg(R.ChunkRequest(snap.height, snap.format, 0))
        for _ in range(64):
            reactor.receive(R.CHUNK_CHANNEL, flooder, raw)
        wait_for(lambda: len(flooder.responses()) >= 64)
        rs = flooder.responses()
        refused = [r for r in rs if r.busy]
        served = [r for r in rs if not r.busy and not r.missing]
        assert refused and all(r.retry_after_ms > 0 for r in refused)
        assert served
        assert sum(m.serve_refused.value(reason=r)
                   for r in ("busy", "ratelimit")) > base_refused
        assert m.chunks_served.value() > base_served
        polite = FakePeer("polite")
        reactor.receive(R.CHUNK_CHANNEL, polite, raw)
        assert wait_for(lambda: polite.responses())
        assert not polite.responses()[0].busy
        out["polite"] = polite.responses()[0].chunk
        for mode, busy in (("raise", True), ("latency:30", False)):
            p.fail.set_mode("statesync.serve", mode)
            try:
                peer = FakePeer(f"chaos-{mode}")
                reactor.receive(R.CHUNK_CHANNEL, peer, raw)
                assert wait_for(lambda: peer.responses())
                assert p.fail.fired("statesync.serve", mode) >= 1
                assert peer.responses()[0].busy is busy
                out[mode] = peer.responses()[0].busy
            finally:
                p.fail.clear()
    finally:
        reactor.stop()
    return out


_RESUME_CHILD = r"""
import os, sys
sys.path.insert(0, @@REPO@@)
sys.path.insert(0, os.path.join(@@REPO@@, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["TM_TPU_DISABLE_BATCH"] = "1"
import tendermint_tpu_torch as T
T.set_default_device("cpu")
import test_torch_statesync as tss
p = tss.BY_NAME[sys.argv[3]]
home, kill_after = sys.argv[1], int(sys.argv[2])
gdoc, privs, serving, blocks, commits, states, lbs = tss._served_chain(
    p.name, chunk_size=32)
puts = {"n": 0}
orig = p.ledger.RestoreLedger.put_chunk
def dying(self, index, data):
    orig(self, index, data)
    puts["n"] += 1
    if puts["n"] == kill_after:
        os._exit(77)
p.ledger.RestoreLedger.put_chunk = dying
ledger = p.ledger.RestoreLedger(
    p.kvdb.SQLiteDB(os.path.join(home, "statesync.db")), group_every=2)
syncer = p.statesync.Syncer(
    p.kvstore.KVStoreApplication(), tss.light_sp(p, gdoc, lbs),
    lambda s, i, peer: (tss.chunk_of(serving, s, i), peer), fetchers=1,
    ledger=ledger)
syncer.add_snapshot([s for s in serving.list_snapshots()
                     if s.height == 15][0], "peer1")
syncer.sync_any()
sys.exit(3)
"""


def case_crash_resume_os_exit_mid_restore(p):
    home = tempfile_dir()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _RESUME_CHILD.replace("@@REPO@@", repr(REPO)),
         home, "4", p.name], env=env, capture_output=True, timeout=240)
    assert r.returncode == 77, r.stderr[-2000:].decode(errors="replace")
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(
        p.name, chunk_size=32)
    target = [s for s in serving.list_snapshots() if s.height == 15][0]
    ledger = p.ledger.RestoreLedger(
        p.kvdb.SQLiteDB(os.path.join(home, "statesync.db")), group_every=2)
    assert ledger.manifest()["height"] == 15
    stored = ledger.begin(target)
    assert 2 <= len(stored) <= 4
    digests = p.integrity.parse_chunk_metadata(target.metadata,
                                               target.chunks)
    assert sorted(stored) == p.integrity.verify_chunks(digests, stored)
    fetched = []

    def fetch(snapshot, index, peer):
        fetched.append(index)
        return chunk_of(serving, snapshot, index), peer

    fresh = p.kvstore.KVStoreApplication()
    syncer = p.statesync.Syncer(fresh, light_sp(p, gdoc, lbs), fetch,
                                fetchers=2, ledger=ledger)
    syncer.add_snapshot(target, "peer1")
    state, _ = syncer.sync_any()
    assert state.last_block_height == 15 and fresh.height == 15
    assert fresh.data == data_at(serving, 15)
    assert state.app_hash == states[14].app_hash
    assert len(set(fetched)) == target.chunks - len(stored)
    assert syncer.last_restore["resumed"] == len(stored)
    ledger.close()
    return {"stored": sorted(stored), "app_hash": state.app_hash}


def tempfile_dir():
    import tempfile
    return tempfile.mkdtemp(prefix="tm_ss_")


def case_poisoned_metadata_cannot_frame_honest_providers(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    target = [s for s in serving.list_snapshots() if s.height == 15][0]
    fake_meta = p.integrity.make_chunk_metadata(
        [b"garbage-%d" % i for i in range(target.chunks)])
    poisoned = p.abci.Snapshot(target.height, target.format, target.chunks,
                               target.hash, fake_meta)
    banned = []
    fresh = p.kvstore.KVStoreApplication()
    syncer = p.statesync.Syncer(
        fresh, light_sp(p, gdoc, lbs),
        lambda s, i, peer: (chunk_of(serving, s, i), peer),
        ban_peer=lambda q, r: banned.append(q), fetchers=2, retries=1)
    syncer.add_snapshot(poisoned, "evil")
    syncer.add_snapshot(target, "honest1")
    syncer.add_snapshot(target, "honest2")
    state, _ = syncer.sync_any()
    assert state.last_block_height == 15 == fresh.height
    assert "honest1" not in banned and "honest2" not in banned
    return {"h": 15, "honest_banned": [q for q in banned
                                       if q.startswith("honest")]}


def case_spoofed_chunk_response_cannot_satisfy_honest_request(p):
    serving = _served_chain(p.name)[2]
    snap = serving.list_snapshots()[0]
    body = chunk_of(serving, snap, 0)
    R = p.reactor
    honest, spoofer = FakePeer("honest"), FakePeer("spoofer")
    reactor = R.StateSyncReactor(serving, chunk_timeout_s=1.5)
    reactor.switch = types.SimpleNamespace(peers={"honest": honest,
                                                  "spoofer": spoofer})
    result = {}

    def fetchit():
        try:
            result["r"] = reactor._fetch_chunk(snap, 0, "honest")
        except Exception as e:  # noqa: BLE001 - asserted below
            result["err"] = e

    t = threading.Thread(target=fetchit, daemon=True)
    t.start()
    time.sleep(0.1)
    with reactor._chunks_cv:
        reactor._chunks[(snap.height, snap.format, 0, "spoofer")] = \
            R.ChunkResponse(snap.height, snap.format, 0, b"", missing=True)
        reactor._chunks_cv.notify_all()
    time.sleep(0.2)
    assert "err" not in result and "r" not in result
    with reactor._chunks_cv:
        reactor._chunks[(snap.height, snap.format, 0, "honest")] = \
            R.ChunkResponse(snap.height, snap.format, 0, body)
        reactor._chunks_cv.notify_all()
    t.join(timeout=3.0)
    assert result.get("r") == (body, "honest")
    return {"r": result["r"]}


def case_peer_book_slow_burst_is_one_epoch(p):
    book = p.syncer._PeerBook(["a"], retries=2)
    t0 = time.monotonic()
    for _ in range(5):
        book.slow("a", t0)
    assert book.dead_peers() == []
    book.slow("a", time.monotonic())
    book.slow("a", time.monotonic())
    assert book.dead_peers() == ["a"]
    return {"dead": book.dead_peers()}


def case_always_busy_provider_aborts_instead_of_hanging(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)

    def busy_fetch(snapshot, index, peer):
        raise p.syncer.ChunkBusy("permanently saturated",
                                 retry_after_s=0.005)

    syncer = p.statesync.Syncer(p.kvstore.KVStoreApplication(),
                                light_sp(p, gdoc, lbs), busy_fetch,
                                fetchers=2, retries=1)
    syncer.add_snapshot([s for s in serving.list_snapshots()
                         if s.height == 15][0], "loaded")
    t0 = time.monotonic()
    with pytest.raises(p.syncer.StateSyncError):
        syncer.sync_any()
    assert time.monotonic() - t0 < 60.0
    assert p.syncer._PeerBook.BUSY_STRIKES_AFTER >= 2
    return {"busy_strikes_after": p.syncer._PeerBook.BUSY_STRIKES_AFTER}


def case_stop_event_interrupts_inflight_restore(p):
    gdoc, privs, serving, blocks, commits, states, lbs = _served_chain(p.name)
    stop = threading.Event()

    def stalling(snapshot, index, peer):
        if index > 0:
            time.sleep(0.15)
        return chunk_of(serving, snapshot, index), peer

    syncer = p.statesync.Syncer(p.kvstore.KVStoreApplication(),
                                light_sp(p, gdoc, lbs), stalling,
                                fetchers=1, stop_event=stop)
    for s in serving.list_snapshots():
        syncer.add_snapshot(s, "peer1")
    threading.Timer(0.1, stop.set).start()
    t0 = time.monotonic()
    with pytest.raises(p.syncer.StateSyncError):
        syncer.sync_any()
    assert time.monotonic() - t0 < 5.0
    return {"stopped": True}


def case_unawaited_chunk_responses_are_dropped(p):
    serving = _served_chain(p.name)[2]
    snap = serving.list_snapshots()[0]
    R = p.reactor
    reactor = R.StateSyncReactor(serving)
    spammer = FakePeer("spammer")
    for i in range(200):
        reactor.receive(R.CHUNK_CHANNEL, spammer, R.encode_msg(
            R.ChunkResponse(snap.height, snap.format, i % 8, b"junk")))
    assert reactor._chunks == {}
    key = (snap.height, snap.format, 0, "spammer")
    with reactor._chunks_cv:
        reactor._awaited.add(key)
    reactor.receive(R.CHUNK_CHANNEL, spammer, R.encode_msg(
        R.ChunkResponse(snap.height, snap.format, 0, b"real")))
    assert key in reactor._chunks
    return {"kept": plain(reactor._chunks[key])}


CASES = {fn.__name__[len("case_"):]: fn for fn in (
    case_bootstrap_and_resume,
    case_rejects_corrupt_snapshot,
    case_statestore_bootstrap_persists_validator_sets,
    case_concurrent_fetchers_with_flaky_transport,
    case_gives_up_after_chunk_retry_limit,
    case_chunk_metadata_roundtrip_and_tamper,
    case_kvstore_snapshots_carry_chunk_digests,
    case_corrupt_chunk_detected_pre_app_and_banned,
    case_one_dead_peer_of_three_completes,
    case_peer_book_budget_epochs_and_ban,
    case_busy_peer_backs_off_without_strike,
    case_ledger_resume_skips_stored_chunks,
    case_ledger_clears_on_snapshot_rejection,
    case_chaos_matrix,
    case_spans_and_slo_stream,
    case_serve_bounded_queue_ratelimit_and_chaos,
    case_crash_resume_os_exit_mid_restore,
    case_poisoned_metadata_cannot_frame_honest_providers,
    case_spoofed_chunk_response_cannot_satisfy_honest_request,
    case_peer_book_slow_burst_is_one_epoch,
    case_always_busy_provider_aborts_instead_of_hanging,
    case_stop_event_interrupts_inflight_restore,
    case_unawaited_chunk_responses_are_dropped)}


@functools.lru_cache(maxsize=None)
def _outcome(case: str, name: str):
    return plain(CASES[case](BY_NAME[name]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_statesync_case(case, pkg):
    """The JAX test's case, its assertions, in each package."""
    assert _outcome(case, pkg.name) is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_statesync_case_equal(case):
    """The case's outcome is the same in both packages."""
    assert _outcome(case, "jax") == _outcome(case, "port")


def test_exports_match():
    assert sorted(PORT.statesync.__all__) == sorted(JAX.statesync.__all__)
    for name in JAX.statesync.__all__:
        assert hasattr(PORT.statesync, name)
    assert (PORT.reactor.SNAPSHOT_CHANNEL, PORT.reactor.CHUNK_CHANNEL) \
        == (JAX.reactor.SNAPSHOT_CHANNEL, JAX.reactor.CHUNK_CHANNEL) \
        == (0x60, 0x61)
    for attr in ("DEFAULT_FETCHERS", "DEFAULT_CHUNK_TIMEOUT_MS",
                 "DEFAULT_RETRIES", "MAX_SNAPSHOT_CHUNKS"):
        assert getattr(PORT.syncer, attr) == getattr(JAX.syncer, attr)


# ---------------------------------------------------------------------------
# a snapshot served by one package, restored by the other over Switches
# ---------------------------------------------------------------------------

def _node_key(p, tag: bytes):
    return p.key.NodeKey(p.ed.PrivKey(hashlib.sha256(tag).digest()))


@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")])
def test_snapshot_restored_across_packages(server, client):
    """The client package's StateSyncReactor, on its Switch dialled to the
    server package's, discovers the server's snapshots, fetches the
    chunks over the statesync channels through SecretConnection and
    MConnection, and restores height 15 with its own light client's
    trust: the app hash, the data and the bootstrapped State are those
    of the same chain built in the server's package."""
    ps, pc = BY_NAME[server], BY_NAME[client]
    serving = _served_chain(ps.name)[2]
    gdoc, _, _, _, _, states, lbs = _served_chain(pc.name)
    r_s = ps.reactor.StateSyncReactor(serving)
    sw_s = ps.switch.Switch(_node_key(ps, b"ss server"), "127.0.0.1:0",
                            gdoc.chain_id, moniker="ss-server")
    sw_s.add_reactor("STATESYNC", r_s)
    fresh = pc.kvstore.KVStoreApplication()
    r_c = pc.reactor.StateSyncReactor(fresh, light_sp(pc, gdoc, lbs),
                                      fetchers=2, chunk_timeout_s=10.0)
    sw_c = pc.switch.Switch(_node_key(pc, b"ss client"), "127.0.0.1:0",
                            gdoc.chain_id, moniker="ss-client")
    sw_c.add_reactor("STATESYNC", r_c)
    def run():
        sw_s.start()
        try:
            sw_c.start()
            try:
                assert sw_c.dial_peer(sw_s.actual_listen_addr()) is not None
                assert wait_for(lambda: len(r_c.syncer._snapshots) >= 3,
                                  timeout=30)
                return r_c.syncer.sync_any()
            finally:
                sw_c.stop()
        finally:
            sw_s.stop()
    state, commit = run_limited(run, 120)
    assert state.last_block_height == 15 == fresh.height
    assert fresh.data == data_at(_served_chain(pc.name)[2], 15)
    assert state.app_hash == states[14].app_hash
    assert state.validators.hash() == states[14].validators.hash()
    assert commit.height == 15
    assert r_c.syncer.last_restore["banned"] == []


# ---------------------------------------------------------------------------
# the port's departure: a card fault in the light verification
# ---------------------------------------------------------------------------

def _break_certificates(monkeypatch):
    VS = PORT.validator_set.ValidatorSet
    real = {n: getattr(VS, n) for n in ("verify_commit_light",
                                        "verify_commit_light_trusting")}
    calls = []

    def make(n):
        def broken(self, *a, **kw):
            calls.append(n)
            raise PORT.degrade.DeviceLaneError("launch failed on the card")
        return broken
    for n in real:
        monkeypatch.setattr(VS, n, make(n))
    return calls, lambda: [monkeypatch.setattr(VS, n, f)
                           for n, f in real.items()]


class _Offers:
    def __init__(self):
        self.app = PORT.kvstore.KVStoreApplication()
        self.offers = 0

    def __getattr__(self, name):
        return getattr(self.app, name)

    def offer_snapshot(self, snapshot, app_hash):
        self.offers += 1
        return self.app.offer_snapshot(snapshot, app_hash)


def _prefilled_ledger(serving, target, n):
    ledger = PORT.ledger.RestoreLedger(PORT.kvdb.MemDB(), group_every=2)
    ledger.begin(target)
    for i in range(n):
        ledger.put_chunk(i, chunk_of(serving, target, i))
    ledger.flush()
    return ledger


def test_card_fault_leaves_sync_any_as_itself(monkeypatch):
    """Outside a drill the DeviceLaneError of the light verification
    leaves sync_any itself: the app never offered the snapshot, no
    snapshot rejected, no peer banned, the ledger's chunks kept; a fresh
    Syncer over the same ledger and app then resumes from them."""
    gdoc, _, serving, _, _, states, lbs = _served_chain("port",
                                                        chunk_size=32)
    target = [s for s in serving.list_snapshots() if s.height == 15][0]
    ledger = _prefilled_ledger(serving, target, 3)
    app, banned, fetched = _Offers(), [], []

    def fetch(s, i, peer):
        fetched.append(i)
        return chunk_of(serving, s, i), peer

    sp = light_sp(PORT, gdoc, lbs)
    syncer = PORT.statesync.Syncer(app, sp, fetch,
                                   ban_peer=lambda q, r: banned.append(q),
                                   ledger=ledger)
    syncer.add_snapshot(target, "peer1")
    calls, restore = _break_certificates(monkeypatch)
    with pytest.raises(PORT.degrade.DeviceLaneError):
        syncer.sync_any()
    assert calls and app.offers == 0 and fetched == [] and banned == []
    assert syncer._rejected == set()
    assert ledger.manifest()["height"] == 15
    assert sorted(ledger.begin(target)) == [0, 1, 2]
    restore()
    fresh = PORT.statesync.Syncer(app, sp, fetch, ledger=ledger)
    fresh.add_snapshot(target, "peer1")
    state, _ = fresh.sync_any()
    assert state.app_hash == states[14].app_hash and app.offers == 1
    assert fresh.last_restore["resumed"] == 3
    assert sorted(set(fetched)) == list(range(3, target.chunks))


def test_card_fault_in_a_drill_takes_the_reference_path(monkeypatch):
    """In a chaos drill (a failpoint armed) the same fault is the JAX
    package's unverifiable snapshot: sync_any ends in StateSyncError, no
    snapshot rejected, the ledger kept; the JAX Syncer on the same
    chain and a verifier that raises ends the same way."""
    outcomes = {}
    for p in PKGS:
        gdoc, _, serving, _, _, _, lbs = _served_chain(p.name)
        target = [s for s in serving.list_snapshots() if s.height == 15][0]
        sp = light_sp(p, gdoc, lbs)
        VS = p.validator_set.ValidatorSet

        def broken(self, *a, **kw):
            raise PORT.degrade.DeviceLaneError("launch failed on the card")
        for n in ("verify_commit_light", "verify_commit_light_trusting"):
            monkeypatch.setattr(VS, n, broken)
        app = p.kvstore.KVStoreApplication()
        syncer = p.statesync.Syncer(
            app, sp, lambda s, i, peer: (chunk_of(serving, s, i), peer))
        syncer.add_snapshot(target, "peer1")
        p.fail.set_mode("statesync.serve", "raise")
        try:
            with pytest.raises(p.syncer.StateSyncError) as e:
                syncer.sync_any()
        finally:
            p.fail.clear()
        monkeypatch.undo()
        assert syncer._rejected == set() and app.height == 0
        outcomes[p.name] = (type(e.value).__name__,
                            "no viable snapshots" in str(e.value))
    assert outcomes["jax"] == outcomes["port"] == ("StateSyncError", True)


def test_card_fault_through_the_reactor_keeps_the_peer(monkeypatch):
    """The same fault under the port's StateSyncReactor over a Switch:
    the serving peer stays connected and unbanned, and the reactor's next
    sync_any (the card back) restores."""
    gdoc, _, serving, _, _, states, lbs = _served_chain("port")
    r_s = PORT.reactor.StateSyncReactor(serving)
    sw_s = PORT.switch.Switch(_node_key(PORT, b"cf server"), "127.0.0.1:0",
                              gdoc.chain_id, moniker="cf-server")
    sw_s.add_reactor("STATESYNC", r_s)
    app = _Offers()
    r_c = PORT.reactor.StateSyncReactor(app, light_sp(PORT, gdoc, lbs),
                                        fetchers=2, chunk_timeout_s=10.0)
    sw_c = PORT.switch.Switch(_node_key(PORT, b"cf client"), "127.0.0.1:0",
                              gdoc.chain_id, moniker="cf-client")
    sw_c.add_reactor("STATESYNC", r_c)
    def run():
        sw_s.start()
        try:
            sw_c.start()
            try:
                peer = sw_c.dial_peer(sw_s.actual_listen_addr())
                assert peer is not None
                assert wait_for(lambda: len(r_c.syncer._snapshots) >= 3,
                                  timeout=30)
                _, restore = _break_certificates(monkeypatch)
                with pytest.raises(PORT.degrade.DeviceLaneError):
                    r_c.syncer.sync_any()
                assert peer.id in sw_c.peers and app.offers == 0
                restore()
                return r_c.syncer.sync_any()
            finally:
                sw_c.stop()
        finally:
            sw_s.stop()
    state, _ = run_limited(run, 120)
    assert state.app_hash == states[14].app_hash
