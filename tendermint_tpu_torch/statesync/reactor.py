"""State sync reactor (reference statesync/reactor.go): snapshot discovery
on channel 0x60, chunk transfer on 0x61; the serving side answers from its
app's snapshot store.

ADR-022: the serving side is a bounded, rate-limited, per-peer-fair
chunk server (the IngressGate admission pattern, ADR-018).  Chunk
requests enter a bounded queue drained by a worker thread; a full
queue or a peer over its token bucket gets an immediate busy response
carrying a Retry-After hint instead of silently wedging the receive
routine — one node feeding many joiners cannot be starved by a
flooding peer, and the refusal is explicit so honest joiners rotate.
The fetching side requests from exactly the sender the Syncer's
rotation picked (attribution: a failure is charged to the peer that
earned it, reference syncer.go:411 fetchChunks).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.libs import fail, trace
from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.p2p import wire
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.switch import Peer, Reactor

from .ledger import RestoreLedger
from .syncer import (ChunkBusy, StateSyncError, Syncer, default_chunk_timeout_s,
                     metrics, _param)

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

# serving-side defaults ([statesync] serve_rate_per_s / serve_burst /
# the bounded request queue)
DEFAULT_SERVE_RATE_PER_S = 100.0
DEFAULT_SERVE_BURST = 32
SERVE_QUEUE = 128


def default_serve_rate_per_s() -> float:
    return max(0.0, _param("serve_rate_per_s", "TM_TPU_SS_SERVE_RATE",
                           DEFAULT_SERVE_RATE_PER_S, float))


def default_serve_burst() -> int:
    return max(1, _param("serve_burst", "TM_TPU_SS_SERVE_BURST",
                         DEFAULT_SERVE_BURST, int))


@dataclass
class SnapshotsRequest:
    pass


@dataclass
class SnapshotsResponse:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes


@dataclass
class ChunkRequest:
    height: int
    format: int
    index: int


@dataclass
class ChunkResponse:
    height: int
    format: int
    index: int
    chunk: bytes
    missing: bool = False
    # ADR-022 serving-side backpressure: the server is refusing (queue
    # full / rate limited), come back in retry_after_ms.  Old peers
    # ignore the extra fields (unknown proto fields skip).
    busy: bool = False
    retry_after_ms: int = 0


# -- wire codec (proto/tendermint/statesync/types.proto Message oneof:
# snapshots_request=1, snapshots_response=2, chunk_request=3,
# chunk_response=4) -------------------------------------------------------

def encode_msg(msg) -> bytes:
    if isinstance(msg, SnapshotsRequest):
        return wire.oneof_encode(1, b"")
    if isinstance(msg, SnapshotsResponse):
        return wire.oneof_encode(2, (
            pe.varint_field(1, msg.height) + pe.varint_field(2, msg.format)
            + pe.varint_field(3, msg.chunks) + pe.bytes_field(4, msg.hash)
            + pe.bytes_field(5, msg.metadata)))
    if isinstance(msg, ChunkRequest):
        return wire.oneof_encode(3, (
            pe.varint_field(1, msg.height) + pe.varint_field(2, msg.format)
            + pe.varint_field(3, msg.index)))
    if isinstance(msg, ChunkResponse):
        return wire.oneof_encode(4, (
            pe.varint_field(1, msg.height) + pe.varint_field(2, msg.format)
            + pe.varint_field(3, msg.index) + pe.bytes_field(4, msg.chunk)
            + pe.varint_field(5, 1 if msg.missing else 0)
            + pe.varint_field(6, 1 if msg.busy else 0)
            + pe.varint_field(7, int(msg.retry_after_ms))))
    raise TypeError(f"unknown statesync message {type(msg).__name__}")


def _dec_snapshots_response(b: bytes) -> SnapshotsResponse:
    f = pd.parse(b)
    return SnapshotsResponse(
        height=pd.get_uint(f, 1), format=pd.get_uint(f, 2),
        chunks=pd.get_uint(f, 3), hash=pd.get_bytes(f, 4),
        metadata=pd.get_bytes(f, 5))


def _dec_chunk_response(b: bytes) -> ChunkResponse:
    f = pd.parse(b)
    return ChunkResponse(
        height=pd.get_uint(f, 1), format=pd.get_uint(f, 2),
        index=pd.get_uint(f, 3), chunk=pd.get_bytes(f, 4),
        missing=bool(pd.get_uint(f, 5)), busy=bool(pd.get_uint(f, 6)),
        retry_after_ms=pd.get_uint(f, 7))


def _dec_chunk_request(b: bytes) -> ChunkRequest:
    f = pd.parse(b)
    return ChunkRequest(height=pd.get_uint(f, 1), format=pd.get_uint(f, 2),
                        index=pd.get_uint(f, 3))


_HANDLERS = {
    1: lambda b: SnapshotsRequest(),
    2: _dec_snapshots_response,
    3: _dec_chunk_request,
    4: _dec_chunk_response,
}


def decode_msg(data: bytes):
    return wire.oneof_decode(data, _HANDLERS)


wire.register_codec(SNAPSHOT_CHANNEL, encode_msg, decode_msg)
wire.register_codec(CHUNK_CHANNEL, encode_msg, decode_msg)


class _TokenBucket:
    """Per-peer serve rate limiter; mutated under the server lock
    only (the IngressGate pattern, ADR-018)."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = now

    def allow(self, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


# bound on distinct per-peer buckets (peer ids are remote-controlled)
_MAX_BUCKETS = 1024


class StateSyncReactor(Reactor):
    """BaseService lifecycle via Reactor; started/stopped by the Switch
    (reference statesync/reactor.go: a p2p.BaseReactor)."""

    def __init__(self, app, state_provider=None,
                 ledger: Optional[RestoreLedger] = None,
                 fetchers: Optional[int] = None,
                 chunk_timeout_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 serve_rate_per_s: Optional[float] = None,
                 serve_burst: Optional[int] = None,
                 serve_queue: int = SERVE_QUEUE):
        super().__init__("STATESYNC")
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("statesync")
        self.app = app
        self.chunk_timeout_s = chunk_timeout_s
        self.syncer: Optional[Syncer] = None
        if state_provider is not None:
            self.syncer = Syncer(app, state_provider, self._fetch_chunk,
                                 ban_peer=self._ban_peer,
                                 fetchers=fetchers,
                                 chunk_timeout_s=chunk_timeout_s,
                                 retries=retries, ledger=ledger,
                                 stop_event=self.quitting)
        # received chunks keyed by (height, format, index, SENDER):
        # the syncer runs several concurrent fetchers, so responses
        # must route to the fetcher that asked — and only a response
        # from the peer that fetcher ASKED may satisfy it (a Byzantine
        # peer blind-spamming missing/busy responses must not be able
        # to charge its spoofs to an honest requested sender).  Only
        # AWAITED keys are stored at all: an unawaited response is
        # stale or spam either way, and dropping it bounds the map by
        # the fetcher count instead of by remote-controlled input
        self._chunks: dict = {}
        self._awaited: set = set()
        self._chunks_cv = threading.Condition()
        # -- serving side (bounded queue + per-peer token buckets) -----
        self.serve_rate_per_s = serve_rate_per_s \
            if serve_rate_per_s is not None else default_serve_rate_per_s()
        self.serve_burst = float(serve_burst) if serve_burst is not None \
            else float(default_serve_burst())
        self.serve_queue_size = max(1, int(serve_queue))
        # _serve_cv guards _serve_queue + _buckets only (bookkeeping);
        # the app and peer sends happen with it released
        self._serve_cv = threading.Condition()
        self._serve_queue: "deque" = deque()
        self._buckets: Dict[str, _TokenBucket] = {}

    def get_channels(self):
        return [
            ChannelDescriptor(SNAPSHOT_CHANNEL, priority=5,
                              send_queue_capacity=10),
            ChannelDescriptor(CHUNK_CHANNEL, priority=3,
                              send_queue_capacity=16),
        ]

    def on_start(self):
        self.spawn(self._serve_worker, name="statesync-chunk-server")

    def on_stop(self):
        with self._serve_cv:
            self._serve_queue.clear()
            self._serve_cv.notify_all()

    def add_peer(self, peer: Peer):
        if self.syncer is not None:
            peer.try_send(SNAPSHOT_CHANNEL, SnapshotsRequest())

    def request_snapshots(self):
        """Re-poll every peer for snapshots (the serving side may only
        take its first snapshot after we connected)."""
        if self.switch is not None:
            for peer in list(self.switch.peers.values()):
                peer.try_send(SNAPSHOT_CHANNEL, SnapshotsRequest())

    def receive(self, ch_id: int, peer: Peer, msg_bytes: bytes):
        msg = decode_msg(msg_bytes)
        if ch_id == SNAPSHOT_CHANNEL:
            if isinstance(msg, SnapshotsRequest):
                for s in (self.app.list_snapshots() or [])[-10:]:
                    peer.try_send(SNAPSHOT_CHANNEL, SnapshotsResponse(
                        s.height, s.format, s.chunks, s.hash, s.metadata))
            elif isinstance(msg, SnapshotsResponse) and self.syncer:
                self.log.debug("discovered snapshot", peer=peer.id,
                               height=msg.height, format=msg.format)
                self.syncer.add_snapshot(
                    abci.Snapshot(msg.height, msg.format, msg.chunks,
                                  msg.hash, msg.metadata), peer.id)
        elif ch_id == CHUNK_CHANNEL:
            if isinstance(msg, ChunkRequest):
                self._admit_chunk_request(msg, peer)
            elif isinstance(msg, ChunkResponse):
                key = (msg.height, msg.format, msg.index, peer.id)
                with self._chunks_cv:
                    if key in self._awaited:
                        self._chunks[key] = msg
                        self._chunks_cv.notify_all()

    # -- chunk serving (ADR-022: the IngressGate admission pattern) --------

    def serve_depth(self) -> int:
        with self._serve_cv:
            return len(self._serve_queue)

    def _retry_after_ms(self) -> int:
        """Crude Retry-After: a full queue at the configured rate."""
        rate = self.serve_rate_per_s or 100.0
        return int(min(5000.0, max(100.0,
                                   1000.0 * self.serve_depth() / rate)))

    def _refuse(self, msg: ChunkRequest, peer: Peer, reason: str):
        metrics().serve_refused.inc(reason=reason)
        peer.try_send(CHUNK_CHANNEL, ChunkResponse(
            msg.height, msg.format, msg.index, b"", busy=True,
            retry_after_ms=self._retry_after_ms()))

    def _admit_chunk_request(self, msg: ChunkRequest, peer: Peer):
        """Admission on the receive thread: token bucket + bounded
        queue; refusal is an immediate busy response, never a blocked
        channel read."""
        m = metrics()
        now = time.monotonic()
        with self._serve_cv:
            if self.serve_rate_per_s > 0:
                b = self._buckets.get(peer.id)
                if b is None:
                    if len(self._buckets) >= _MAX_BUCKETS:
                        idle = [k for k, v in self._buckets.items()
                                if v.tokens >= v.burst
                                or now - v.last > 300.0]
                        for k in idle:
                            del self._buckets[k]
                        if len(self._buckets) >= _MAX_BUCKETS:
                            self._buckets.clear()  # identity churn flood
                    b = self._buckets[peer.id] = _TokenBucket(
                        self.serve_rate_per_s, self.serve_burst, now)
                allowed = b.allow(now)
            else:
                allowed = True
            if allowed and len(self._serve_queue) < self.serve_queue_size:
                self._serve_queue.append((msg, peer))
                depth = len(self._serve_queue)
                self._serve_cv.notify()
                refuse_reason = None
            else:
                depth = len(self._serve_queue)
                refuse_reason = "ratelimit" if not allowed else "busy"
        m.serve_queue_depth.set(depth)
        if refuse_reason is not None:
            self._refuse(msg, peer, refuse_reason)

    def _serve_worker(self):
        m = metrics()
        while not self.quitting.is_set():
            with self._serve_cv:
                while not self._serve_queue and \
                        not self.quitting.is_set():
                    self._serve_cv.wait(0.1)
                if self.quitting.is_set():
                    return
                msg, peer = self._serve_queue.popleft()
                depth = len(self._serve_queue)
            m.serve_queue_depth.set(depth)
            with trace.span("statesync.serve", height=msg.height,
                            chunk=msg.index, peer=peer.id):
                try:
                    fail.inject("statesync.serve")
                    chunk = self.app.load_snapshot_chunk(
                        msg.height, msg.format, msg.index)
                except Exception as e:  # noqa: BLE001 - chaos/app fault:
                    # the serving side must stay up; the requester gets
                    # an explicit busy and retries elsewhere
                    self.log.error("chunk serve failed", chunk=msg.index,
                                   err=str(e))
                    self._refuse(msg, peer, "error")
                    continue
                if peer.try_send(CHUNK_CHANNEL, ChunkResponse(
                        msg.height, msg.format, msg.index, chunk or b"",
                        missing=not chunk)):
                    m.chunks_served.inc()
                else:
                    # channel backpressure: drop — the requester times
                    # out and rotates; blocking here would let one slow
                    # peer stall every other joiner's queue
                    m.serve_refused.inc(reason="backpressure")

    # -- chunk fetch over p2p (the Syncer's fetcher) -----------------------

    def _ban_peer(self, peer_id: str, reason: str):
        sw = self.switch
        if sw is None:
            return
        self.log.info("banning peer", peer=peer_id, reason=reason)
        peer = sw.peers.get(peer_id)
        if peer is not None:
            sw.stop_peer_for_error(peer, reason)

    def _fetch_chunk(self, snapshot: abci.Snapshot, index: int,
                     sender: str):
        """One chunk request/response from EXACTLY the requested
        sender; called concurrently by the syncer's fetcher pool, which
        owns rotation and failure attribution (a silent fallback to a
        different peer here would mis-charge its failures)."""
        sw = self.switch
        peer = sw.peers.get(sender) if sw else None
        if peer is None:
            raise StateSyncError(f"peer {sender} gone")
        key = (snapshot.height, snapshot.format, index, sender)
        with self._chunks_cv:
            self._chunks.pop(key, None)  # drop any stale response
            self._awaited.add(key)
        peer.try_send(CHUNK_CHANNEL, ChunkRequest(
            snapshot.height, snapshot.format, index))
        timeout_s = self.chunk_timeout_s \
            if self.chunk_timeout_s is not None \
            else default_chunk_timeout_s()
        deadline = time.monotonic() + timeout_s
        try:
            with self._chunks_cv:
                while key not in self._chunks:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise StateSyncError(f"chunk {index} timed out")
                    self._chunks_cv.wait(remaining)
                msg = self._chunks.pop(key)
        finally:
            with self._chunks_cv:
                self._awaited.discard(key)
                self._chunks.pop(key, None)
        if msg.busy:
            raise ChunkBusy(f"peer {sender} busy serving chunk {index}",
                            retry_after_s=msg.retry_after_ms / 1000.0)
        if msg.missing:
            raise StateSyncError(f"peer lacks chunk {index}")
        return msg.chunk, sender
