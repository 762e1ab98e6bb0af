"""State sync syncer (reference statesync/syncer.go:141): discover
snapshots from peers, offer to the app, fetch + verify + apply chunks,
verify the restored app hash against a light-client-verified header,
and bootstrap consensus state at the snapshot height.

ADR-022 fast-join rework.  The fetch plane is a pipelined
fetch -> verify -> apply path:

  * N fetcher threads fill a chunk buffer while the calling thread
    applies chunks strictly in order — app apply of chunk k overlaps
    the fetch of k+1 (the BlockPipeline stage/commit discipline,
    ADR-017).
  * Chunk integrity is checked ON THE FETCH THREAD against the
    snapshot's chunk-digest metadata (statesync/integrity.py) BEFORE
    the app ever sees peer bytes: a corrupt chunk is charged to its
    sender (banned) and refetched elsewhere, costing one chunk
    instead of one restore.
  * Failure accounting is per PEER, not per chunk (_PeerBook):
    consecutive failures earn jittered capped backoff and eventually
    a ban, senders rotate across every peer that advertised the
    snapshot, and a fetch slower than the per-chunk deadline
    quarantines the slow peer.  The old per-chunk counters let a
    single dead ``sender_hint`` burn the whole retry budget.
  * Verified chunks land in the RestoreLedger (statesync/ledger.py,
    kvdb.GroupCommitDB group transactions) so a crash mid-restore
    reopens, re-verifies the stored prefix and resumes from the
    frontier instead of refetching from zero.

Chaos seams (libs/fail.py): ``statesync.fetch`` (per fetch attempt,
raise = transport fault charged to the peer; ``corrupt-chunk`` flips
the fetched bytes so the pre-app digest check must catch them),
``statesync.verify`` (raise = verification machinery fault, retried
like a transport error, the app never sees the chunk) and
``statesync.apply`` (raise = app-layer failure, the snapshot is
rejected — the reference behavior for an app blowing up on restore).

The port's departure from the JAX package's syncer: a launch that failed
on the card while the light client verified the snapshot's headers
(degrade.card_fault: a DeviceLaneError outside a chaos drill) is not an
unverifiable snapshot.  It leaves _sync_one and sync_any as itself,
before the app is offered the snapshot: no snapshot is marked rejected,
no peer is banned or struck, and the RestoreLedger keeps its chunks, so
a fresh Syncer over the same ledger and app resumes.  In a drill the JAX
package's behaviour holds (the snapshot counts as not yet verifiable).
"""
from __future__ import annotations

import collections
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto.degrade import card_fault
from tendermint_tpu_torch.libs import fail, slo, trace
from tendermint_tpu_torch.state.state import State

from .integrity import parse_chunk_metadata, verify_chunk, verify_chunks
from .ledger import RestoreLedger  # noqa: F401 - re-export (node wiring)
from .stateprovider import StateProvider

# defaults (reference config.go ChunkFetchers / chunk retry discipline);
# the [statesync] config section replaces the old hardcoded
# CHUNK_FETCHERS / CHUNK_RETRIES module constants
DEFAULT_FETCHERS = 4
DEFAULT_CHUNK_TIMEOUT_MS = 15000.0
DEFAULT_RETRIES = 3
# sanity cap on a peer-declared chunk count: 2^16 chunks x 64KB-ish
# chunks bounds any snapshot we would ever restore; without it a
# Byzantine SnapshotsResponse (chunks=2^60) would OOM the fetch queue
MAX_SNAPSHOT_CHUNKS = 1 << 16


class StateSyncError(Exception):
    pass


class SnapshotUnverifiable(StateSyncError):
    """The chain has not outgrown the snapshot yet (headers H+1/H+2
    missing) — retriable, unlike a rejection."""


class SnapshotRejected(StateSyncError):
    pass


class ChunkBusy(StateSyncError):
    """The serving peer refused with busy + Retry-After (its bounded
    chunk server is saturated or rate limiting us) — back off that
    peer and rotate, without a failure strike: a loaded server is not
    a dead one."""

    def __init__(self, msg: str, retry_after_s: float = 0.5):
        super().__init__(msg)
        self.retry_after_s = max(0.05, float(retry_after_s))


# ---------------------------------------------------------------------------
# [statesync] config resolution: explicit Syncer args (the node wires
# them from config, so config wins over env in BOTH directions) >
# module overrides (set_config, node-less tooling) > env > default
# ---------------------------------------------------------------------------

_cfg_lock = threading.Lock()
_cfg: Dict[str, float] = {}


def set_config(fetchers: Optional[int] = None,
               chunk_timeout_ms: Optional[float] = None,
               retries: Optional[int] = None):
    """Module-level overrides for node-less tooling (bench, tests).
    None clears a dimension back to env/default."""
    with _cfg_lock:
        for k, v in (("fetchers", fetchers),
                     ("chunk_timeout_ms", chunk_timeout_ms),
                     ("retries", retries)):
            if v is None:
                _cfg.pop(k, None)
            else:
                _cfg[k] = v


def _param(key: str, env: str, default, cast):
    with _cfg_lock:
        if key in _cfg:
            return cast(_cfg[key])
    v = os.environ.get(env)
    if v:
        try:
            return cast(v)
        except (TypeError, ValueError):
            pass
    return default


def default_fetchers() -> int:
    return max(1, _param("fetchers", "TM_TPU_SS_FETCHERS",
                         DEFAULT_FETCHERS, int))


def default_chunk_timeout_s() -> float:
    return max(0.001, _param("chunk_timeout_ms",
                             "TM_TPU_SS_CHUNK_TIMEOUT_MS",
                             DEFAULT_CHUNK_TIMEOUT_MS, float) / 1000.0)


def default_retries() -> int:
    return max(1, _param("retries", "TM_TPU_SS_RETRIES",
                         DEFAULT_RETRIES, int))


# ---------------------------------------------------------------------------
# metrics (one process-global bundle; the Registry dedupes)
# ---------------------------------------------------------------------------

_metrics_lock = threading.Lock()
_metrics_obj = None


def metrics():
    global _metrics_obj
    with _metrics_lock:
        if _metrics_obj is None:
            from tendermint_tpu_torch.libs.metrics import StateSyncMetrics
            _metrics_obj = StateSyncMetrics()
        return _metrics_obj


# ---------------------------------------------------------------------------
# per-peer failure accounting
# ---------------------------------------------------------------------------

class _PeerState:
    __slots__ = ("strikes", "until", "dead", "last_strike_t",
                 "busy_streak")

    def __init__(self):
        self.strikes = 0
        self.until = 0.0          # quarantined until (monotonic)
        self.dead = False
        self.last_strike_t = 0.0
        self.busy_streak = 0      # consecutive busy refusals


class _PeerBook:
    """Per-peer (not per-chunk) failure accounting for one snapshot's
    providers: jittered capped backoff on consecutive failures, slow-
    peer quarantine, immediate ban on proven misbehavior (corrupt
    chunk), round-robin sender rotation over the usable set.

    The strike counter is EPOCH-guarded: a fetch that started before
    the peer's last recorded strike belongs to the same failure burst
    (N concurrent fetchers all hitting a dead peer at once) and does
    not strike again — a peer earns one strike per backoff epoch, so
    ``retries`` bounds distinct failure rounds, not racing threads.
    """

    BACKOFF_BASE_S = 0.05
    BACKOFF_CAP_S = 2.0
    # a busy refusal costs no strike — but a peer that answers busy
    # FOREVER must not hang the restore forever either: every
    # BUSY_STRIKES_AFTER consecutive busies convert into one ordinary
    # strike, so a permanently-saturated (or Byzantine always-busy)
    # provider eventually exhausts its budget and the sync aborts
    # instead of looping (any real chunk resets the streak)
    BUSY_STRIKES_AFTER = 16

    def __init__(self, peers, retries: int,
                 ban_cb: Optional[Callable] = None):
        self._lock = threading.Lock()
        self._peers: Dict[str, _PeerState] = {}
        self._order: List[str] = []
        self._rr = 0
        self.retries = max(1, int(retries))
        self.ban_cb = ban_cb
        for p in peers:
            self.add(p)

    def add(self, peer_id: str):
        with self._lock:
            if peer_id not in self._peers:
                self._peers[peer_id] = _PeerState()
                self._order.append(peer_id)

    def _backoff_s(self, strikes: int) -> float:
        base = min(self.BACKOFF_CAP_S,
                   self.BACKOFF_BASE_S * (2 ** max(0, strikes - 1)))
        return base * random.uniform(0.5, 1.5)

    def pick(self) -> Tuple[Optional[str], float]:
        """Next sender, rotating round-robin across usable providers.
        Returns (peer, 0.0); or (None, wait_s) when every live peer is
        quarantined (wait_s = time to the earliest expiry); or
        (None, -1.0) when every provider is dead."""
        now = time.monotonic()
        with self._lock:
            n = len(self._order)
            live_until: List[float] = []
            for k in range(n):
                peer = self._order[(self._rr + k) % n]
                st = self._peers[peer]
                if st.dead:
                    continue
                if st.until > now:
                    live_until.append(st.until)
                    continue
                self._rr = (self._rr + k + 1) % n
                return peer, 0.0
            if live_until:
                return None, max(0.01, min(live_until) - now)
            return None, -1.0

    def failure(self, peer: str, started_at: float, reason: str) -> bool:
        """One failed fetch; returns True when the strike killed the
        peer.  Same-epoch concurrent failures don't re-strike."""
        ban = False
        with self._lock:
            st = self._peers.get(peer)
            if st is None or st.dead:
                return False
            if started_at < st.last_strike_t:
                return False        # same burst as the recorded strike
            st.strikes += 1
            st.last_strike_t = time.monotonic()
            st.until = st.last_strike_t + self._backoff_s(st.strikes)
            if st.strikes > self.retries:
                st.dead = True
                ban = True
        if ban and self.ban_cb is not None:
            self.ban_cb(peer, f"statesync: {self.retries} fetch "
                              f"failures exhausted ({reason})")
        return ban

    def busy(self, peer: str, retry_after_s: float):
        """Server said busy: honor its Retry-After, no strike — until
        BUSY_STRIKES_AFTER consecutive busies, which convert into one
        (the forever-busy liveness bound)."""
        strike = False
        with self._lock:
            st = self._peers.get(peer)
            if st is None or st.dead:
                return
            st.until = max(st.until, time.monotonic() + retry_after_s)
            st.busy_streak += 1
            if st.busy_streak >= self.BUSY_STRIKES_AFTER:
                st.busy_streak = 0
                strike = True
        if strike:
            self.failure(peer, time.monotonic(), "busy forever")

    def slow(self, peer: str, started_at: float):
        """Fetch exceeded the per-chunk deadline: quarantine so the
        rotation prefers faster providers, one strike per EPOCH (the
        same started_at guard as failure() — N concurrent fetches
        stalling together is one slow burst, not N)."""
        self.failure(peer, started_at, "slow fetch")

    def success(self, peer: str):
        with self._lock:
            st = self._peers.get(peer)
            if st is not None:
                st.strikes = 0
                st.until = 0.0
                st.busy_streak = 0

    def ban(self, peer: str, reason: str):
        """Proven misbehavior (corrupt chunk): dead immediately."""
        with self._lock:
            st = self._peers.get(peer)
            if st is None:
                st = self._peers[peer] = _PeerState()
                self._order.append(peer)
            already = st.dead
            st.dead = True
        if not already and self.ban_cb is not None:
            self.ban_cb(peer, reason)

    def all_dead(self) -> bool:
        with self._lock:
            return all(st.dead for st in self._peers.values())

    def dead_peers(self) -> List[str]:
        with self._lock:
            return [p for p, st in self._peers.items() if st.dead]


class Syncer:
    """chunk_fetcher(snapshot, index, sender) -> (bytes, sender_id);
    in the reactor this requests over p2p from exactly that sender, in
    tests it reads a serving app directly.  It may raise ChunkBusy to
    signal server backpressure (backoff, no strike)."""

    def __init__(self, app, state_provider: StateProvider,
                 chunk_fetcher: Callable, ban_peer: Optional[Callable] = None,
                 fetchers: Optional[int] = None,
                 chunk_timeout_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 ledger: Optional[RestoreLedger] = None,
                 stop_event: Optional[threading.Event] = None):
        self.app = app
        self.state_provider = state_provider
        self.chunk_fetcher = chunk_fetcher
        self.ban_peer = ban_peer            # ban_peer(peer_id, reason)
        self.fetchers = fetchers
        self.chunk_timeout_s = chunk_timeout_s
        self.retries = retries
        self.ledger = ledger
        # a set stop_event aborts an IN-FLIGHT restore promptly (the
        # reactor passes its quitting event, so Node.stop never waits
        # behind a wedged fetch plane); the ledger keeps its verified
        # chunks — the next process resumes from the frontier
        self.stop_event = stop_event or threading.Event()
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("statesync")
        # snapshot key -> (snapshot, ordered provider peer ids)
        self._snapshots: Dict[tuple, Tuple[abci.Snapshot, List[str]]] = {}
        self._rejected: set = set()
        self._lock = threading.Lock()
        self.last_restore: Optional[dict] = None  # stats of the last sync

    # -- resolved parameters ----------------------------------------------

    def _fetchers(self) -> int:
        return max(1, self.fetchers) if self.fetchers is not None \
            else default_fetchers()

    def _chunk_timeout_s(self) -> float:
        return self.chunk_timeout_s if self.chunk_timeout_s is not None \
            else default_chunk_timeout_s()

    def _retries(self) -> int:
        return max(1, self.retries) if self.retries is not None \
            else default_retries()

    # -- discovery ---------------------------------------------------------

    @staticmethod
    def _snap_key(snapshot: abci.Snapshot) -> tuple:
        """Snapshot identity INCLUDING the metadata hash: two
        advertisements that differ only in metadata are different
        snapshots.  Without this, a Byzantine first-advertiser could
        attach a self-consistent-but-wrong digest list to the real
        (height, format, hash) — every chunk from honest providers
        would then fail verification and frame THEM as corrupt."""
        import hashlib
        return (snapshot.height, snapshot.format, snapshot.hash,
                hashlib.sha256(bytes(snapshot.metadata or b"")).digest())

    def add_snapshot(self, snapshot: abci.Snapshot, peer_id: str) -> bool:
        """Record a snapshot advertisement.  Returns True the first
        time a snapshot is seen; later advertisements of the same
        snapshot still register their sender as a provider — the fetch
        plane rotates across ALL advertising peers."""
        if not 0 < snapshot.chunks <= MAX_SNAPSHOT_CHUNKS:
            return False
        key = self._snap_key(snapshot)
        with self._lock:
            if key in self._rejected:
                return False
            entry = self._snapshots.get(key)
            if entry is not None:
                if peer_id not in entry[1]:
                    entry[1].append(peer_id)
                return False
            self._snapshots[key] = (snapshot, [peer_id])
            return True

    def _best_snapshots(self) -> List[Tuple[abci.Snapshot, List[str]]]:
        with self._lock:
            # drop blacklisted entries so retries never re-download
            # known-bad snapshots (_rejected otherwise only gates
            # add_snapshot, not selection)
            for key in [k for k in self._snapshots if k in self._rejected]:
                del self._snapshots[key]
            return sorted(
                ((s, list(peers)) for s, peers in self._snapshots.values()),
                key=lambda sp: (-sp[0].height, -sp[0].format))

    # -- sync (reference syncer.go:141 SyncAny) ----------------------------

    def sync_any(self) -> Tuple[State, "object"]:
        """Try discovered snapshots best-first.  Returns (bootstrapped
        state, certifying commit for the snapshot height)."""
        reasons = []
        for snapshot, providers in self._best_snapshots():
            if self.stop_event.is_set():
                reasons.append("statesync stopping")
                break
            try:
                self.log.info("offering snapshot to app",
                              height=snapshot.height,
                              format=snapshot.format,
                              chunks=snapshot.chunks,
                              providers=len(providers))
                result = self._sync_one(snapshot, providers)
                self.log.info("snapshot restored",
                              height=snapshot.height)
                return result
            except SnapshotUnverifiable as e:
                # may verify on a later attempt; do not blacklist
                self.log.debug("snapshot not yet verifiable",
                               height=snapshot.height, err=str(e))
                reasons.append(f"h{snapshot.height}: {e}")
                continue
            except SnapshotRejected as e:
                self.log.error("snapshot rejected",
                               height=snapshot.height, err=str(e))
                reasons.append(f"h{snapshot.height}: REJECTED {e}")
                with self._lock:
                    self._rejected.add(self._snap_key(snapshot))
                continue
        raise StateSyncError(
            "no viable snapshots" + (": " + "; ".join(reasons[:3])
                                     if reasons else ""))

    def _sync_one(self, snapshot: abci.Snapshot, providers: List[str]):
        # trusted app hash for the snapshot height comes from the light
        # client (header H+1 carries the post-H app hash,
        # reference syncer.go:287 verifyApp).  Bootstrapping height H needs
        # verified headers up to H+2 — a snapshot taken at the chain head
        # is rejected until the chain outgrows it.  State/commit are
        # verified once here and reused after the restore.  The light
        # verification itself rides the VerifyScheduler at COMMIT
        # priority (light/verifier.py priority_context), i.e. through
        # the comb path when the validator-set tables are resident.
        t0 = time.monotonic()
        try:
            app_hash = self.state_provider.app_hash(snapshot.height)
            state = self.state_provider.state(snapshot.height)
            commit = self.state_provider.commit(snapshot.height)
        except Exception as e:
            if card_fault(e):
                raise   # the card failed, not the snapshot
            raise SnapshotUnverifiable(
                f"cannot verify snapshot height {snapshot.height} "
                f"(chain may not have outgrown it yet): {e}")
        try:
            try:
                resp = self.app.offer_snapshot(snapshot, app_hash)
                if resp.result != abci.ResponseOfferSnapshot.ACCEPT:
                    raise SnapshotRejected(f"offer result {resp.result}")
                stats = self._fetch_and_apply(snapshot, providers)
                # verify the restored app (syncer.go:544 verifyApp)
                info = self.app.info(abci.RequestInfo())
                if info.last_block_height != snapshot.height:
                    raise SnapshotRejected(
                        f"app restored to height "
                        f"{info.last_block_height}, "
                        f"wanted {snapshot.height}")
                if info.last_block_app_hash != app_hash:
                    raise SnapshotRejected("restored app hash mismatch")
            except SnapshotRejected:
                raise
            except StateSyncError as e:
                # transport-layer trouble (chunk timeout, momentary
                # zero-peer window, snapshot pruned server-side):
                # retriable — do NOT blacklist a snapshot for the
                # network's weather.  The ledger KEEPS its verified
                # chunks: the next attempt (or a restarted process)
                # resumes from the frontier.
                if self.ledger is not None:
                    self.ledger.flush()
                raise SnapshotUnverifiable(f"chunk fetch failed: {e}")
            except Exception as e:
                # app blew up on peer-shaped data: this snapshot is
                # bad, not the whole sync
                raise SnapshotRejected(f"restore failed: {e}")
        except SnapshotRejected:
            # the ONE cleanup site: a rejected snapshot's chunks must
            # not linger as resumable state
            if self.ledger is not None:
                self.ledger.clear()
            raise
        if self.ledger is not None:
            self.ledger.complete()
        wall = max(1e-9, time.monotonic() - t0)
        stats["time_to_synced_s"] = wall
        stats["bytes_per_s"] = stats.get("bytes", 0) / wall
        self.last_restore = stats
        m = metrics()
        m.time_to_synced.set(wall)
        m.restore_bytes_per_s.set(stats["bytes_per_s"])
        return state, commit

    # -- banning -----------------------------------------------------------

    def _ban(self, peer_id: str, reason: str):
        metrics().peers_banned.inc()
        self.log.info("banning statesync peer", peer=peer_id,
                      reason=reason)
        if self.ban_peer is not None and peer_id:
            self.ban_peer(peer_id, reason)

    # -- pipelined fetch -> verify -> apply (reference syncer.go:411) ------

    def _fetch_and_apply(self, snapshot: abci.Snapshot,
                         providers: List[str]) -> dict:
        """N fetcher threads fetch + digest-verify chunks and land them
        in the restore ledger; chunks apply strictly in order from the
        calling thread, overlapped with the fetch of later chunks.
        Per-peer retry/backoff/quarantine with sender rotation;
        app-requested refetch_chunks are re-enqueued and reject_senders
        banned (reference syncer.go:465-476)."""
        nchunks = snapshot.chunks
        if nchunks <= 0 or nchunks > MAX_SNAPSHOT_CHUNKS:
            raise SnapshotRejected(f"implausible chunk count {nchunks}")
        m = metrics()
        digests = parse_chunk_metadata(snapshot.metadata, nchunks)
        book = _PeerBook(providers, retries=self._retries(),
                         ban_cb=self._ban)
        timeout_s = self._chunk_timeout_s()
        ledger = self.ledger

        # fetched[idx] = (chunk, sender, fetch_start_monotonic|None)
        fetched: Dict[int, Tuple[bytes, str, Optional[float]]] = {}
        resumed = 0
        if ledger is not None:
            stored = ledger.begin(snapshot)
            good = set(verify_chunks(digests, stored))
            bad = [i for i in stored if i not in good]
            if bad:
                # stored bytes rotted (partial write, disk fault):
                # drop and refetch — never feed the app unverified data
                ledger.drop(bad)
                m.chunks_verified.inc(len(bad), outcome="corrupt")
            for i in good:
                fetched[i] = (stored[i], "", None)
            resumed = len(good)
            if resumed:
                self.log.info("resuming restore from ledger",
                              height=snapshot.height, resumed=resumed,
                              total=nchunks)

        pending = collections.deque(
            i for i in range(nchunks) if i not in fetched)
        inflight: set = set()
        cv = threading.Condition()
        done = threading.Event()
        fetch_err: List[Exception] = []
        bytes_fetched = [0]

        def abort(e: Exception):
            fetch_err.append(e)
            done.set()
            with cv:
                cv.notify_all()

        def requeue(idx: int):
            with cv:
                inflight.discard(idx)
                if idx not in pending and idx not in fetched:
                    pending.append(idx)
                cv.notify_all()

        stop = self.stop_event

        def fetcher():
            while not done.is_set():
                if stop.is_set():
                    abort(StateSyncError("statesync stopping"))
                    return
                with cv:
                    while not pending and not done.is_set():
                        cv.wait(0.2)
                    if done.is_set():
                        return
                    idx = pending.popleft()
                    inflight.add(idx)
                peer, wait_s = book.pick()
                if peer is None:
                    requeue(idx)
                    if wait_s < 0:
                        abort(StateSyncError(
                            "all snapshot providers failed "
                            f"({book.dead_peers()})"))
                        return
                    done.wait(min(wait_s, 0.25))
                    continue
                t_start = time.monotonic()
                try:
                    with trace.span("statesync.fetch", chunk=idx,
                                    peer=peer):
                        fail.inject("statesync.fetch")
                        chunk, sender = self.chunk_fetcher(snapshot, idx,
                                                           peer)
                        chunk = fail.corrupt_bytes("statesync.fetch",
                                                   chunk)
                except ChunkBusy as e:
                    m.chunks_fetched.inc(outcome="busy")
                    book.busy(peer, e.retry_after_s)
                    requeue(idx)
                    continue
                except Exception as e:  # noqa: BLE001 - transport error
                    m.chunks_fetched.inc(outcome="error")
                    book.failure(peer, t_start, str(e))
                    requeue(idx)
                    if book.all_dead():
                        abort(StateSyncError(
                            f"chunk {idx} fetch failed and no providers "
                            f"remain: {e}"))
                        return
                    continue
                dt = time.monotonic() - t_start
                sender = sender or peer
                book.add(sender)
                # integrity check on THIS thread, before the app ever
                # sees the bytes (the tentpole invariant)
                verify_fault = False
                try:
                    fail.inject("statesync.verify")
                    ok = digests is None or verify_chunk(digests, idx,
                                                         chunk)
                except fail.InjectedFault:
                    ok, verify_fault = False, True
                if not ok:
                    m.chunks_verified.inc(outcome="corrupt")
                    if verify_fault:
                        # machinery fault, not proven peer misbehavior
                        book.failure(peer, t_start, "verify fault")
                    else:
                        self.log.error("corrupt chunk detected pre-app",
                                       chunk=idx, sender=sender)
                        book.ban(sender, "statesync chunk digest "
                                         "mismatch")
                    requeue(idx)
                    if book.all_dead():
                        abort(StateSyncError(
                            f"chunk {idx} unverifiable and no providers "
                            "remain"))
                        return
                    continue
                if digests is not None:
                    m.chunks_verified.inc(outcome="ok")
                m.chunks_fetched.inc(outcome="ok")
                if dt > timeout_s:
                    book.slow(peer, t_start)  # slow-peer quarantine
                else:
                    book.success(peer)
                if ledger is not None:
                    ledger.put_chunk(idx, chunk)
                with cv:
                    inflight.discard(idx)
                    bytes_fetched[0] += len(chunk)
                    fetched[idx] = (chunk, sender, t_start)
                    cv.notify_all()

        # at least one fetcher even on a fully-resumed restore: the app
        # may still demand refetches (RETRY/refetch_chunks) and the
        # apply loop would otherwise wait on a queue nobody drains
        n_threads = min(self._fetchers(), max(1, len(pending)))
        threads = [threading.Thread(target=fetcher, daemon=True,
                                    name=f"chunk-fetcher-{i}")
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        refetched = 0
        bytes_applied = 0
        try:
            index = 0
            # RETRY budget resets whenever the apply cursor passes a new
            # high-water mark: a large restore may legitimately RETRY a
            # handful of times spread across many chunks (the reference's
            # chunks.Retry has no global cap, syncer.go:397), but an app
            # spinning at the SAME frontier still trips the cap — and the
            # high-water mark only ever rises, so reset cycles are bounded
            # by nchunks and cannot launder the count into an infinite loop
            retries = 0
            high_water = -1
            while index < nchunks:
                with cv:
                    while index not in fetched and not done.is_set():
                        if stop.is_set():
                            raise StateSyncError("statesync stopping")
                        cv.wait(0.2)
                    if index not in fetched:
                        raise StateSyncError(
                            f"chunk {index} fetch failed: "
                            f"{fetch_err[0] if fetch_err else 'aborted'}")
                    chunk, sender, t_fetch = fetched.pop(index)
                with trace.span("statesync.apply", chunk=index,
                                n=len(chunk)):
                    fail.inject("statesync.apply")
                    r = self.app.apply_snapshot_chunk(index, chunk,
                                                      sender)
                if t_fetch is not None:
                    slo.observe("statesync", time.monotonic() - t_fetch)
                m.restore_bytes.inc(len(chunk))
                bytes_applied += len(chunk)
                for pid in getattr(r, "reject_senders", ()) or ():
                    if pid:
                        book.ban(pid, "statesync chunk rejected by app")
                refetch = [i for i in (getattr(r, "refetch_chunks", ())
                                       or ()) if 0 <= i < nchunks]
                if r.result == abci.ResponseApplySnapshotChunk.ACCEPT:
                    nxt = index + 1
                    if index > high_water:
                        high_water = index
                        retries = 0
                elif r.result == abci.ResponseApplySnapshotChunk.RETRY:
                    retries += 1
                    if retries > self._retries():
                        raise SnapshotRejected("chunk retry limit")
                    if not refetch:
                        refetch = [index]
                    nxt = index
                else:
                    raise SnapshotRejected(f"apply result {r.result}")
                if refetch:
                    # the app discarded these (possibly already-applied)
                    # chunks: refetch them and rewind the apply cursor
                    # (reference syncer.go:465 enqueues them again).  An
                    # index already in flight is NOT re-enqueued — its
                    # fresh response is about to land in `fetched`, and a
                    # duplicate concurrent fetch of the same key would
                    # race on the reactor's response routing
                    if ledger is not None:
                        ledger.drop(refetch)
                    refetched += len(refetch)
                    with cv:
                        for i in refetch:
                            fetched.pop(i, None)
                            if i not in pending and i not in inflight:
                                pending.append(i)
                        cv.notify_all()
                    nxt = min(nxt, min(refetch))
                index = nxt
        finally:
            done.set()
            with cv:
                cv.notify_all()
            for t in threads:
                t.join(timeout=1.0)
        return {"chunks": nchunks, "resumed": resumed,
                "refetched": refetched, "bytes": bytes_applied,
                "fetched_bytes": bytes_fetched[0],
                "banned": book.dead_peers()}
