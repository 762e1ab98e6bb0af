"""Block pool: tracks peers' reported ranges and outstanding block requests
(reference blocksync/pool.go).

Differences from the reference: requesters are plain records scheduled by
one thread (no per-requester goroutine), and the consumer peeks a WINDOW of
contiguous ready blocks (peek_window) instead of exactly two — that window
is what feeds the coalesced verification on the card in replay.py.
Semantics kept: sequential heights from `height`, one in-flight peer per
height, redo on validation failure removes the peer and reassigns its
heights, peer timeout on slow delivery, IsCaughtUp needs max reported
height reached.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.types.block import Block

REQUEST_INTERVAL_S = 0.002           # reference pool.go:31
MAX_TOTAL_REQUESTERS = 600           # reference pool.go:32
MAX_PENDING_REQUESTS_PER_PEER = 20   # reference pool.go:34
PEER_TIMEOUT_S = 15.0                # reference pool.go:47
MAX_AHEAD_BEHIND = 100               # reference pool.go:44


@dataclass
class _Peer:
    peer_id: str
    base: int
    height: int
    num_pending: int = 0
    last_recv: float = field(default_factory=time.monotonic)
    did_timeout: bool = False


@dataclass
class _Requester:
    height: int
    peer_id: Optional[str] = None
    block: Optional[Block] = None
    sent_at: float = 0.0


class BlockPool:
    """request_fn(peer_id, height) sends a BlockRequest; error_fn(peer_id,
    reason) reports a misbehaving/slow peer to the switch."""

    def __init__(self, start_height: int,
                 request_fn: Callable[[str, int], None],
                 error_fn: Callable[[str, str], None]):
        self._mtx = threading.RLock()
        self.height = start_height
        self._requesters: Dict[int, _Requester] = {}
        self._peers: Dict[str, _Peer] = {}
        self.max_peer_height = 0
        self._request_fn = request_fn
        self._error_fn = error_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start_time = time.monotonic()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._start_time = time.monotonic()
        self._thread = threading.Thread(target=self._scheduler_routine,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    # -- peer management ---------------------------------------------------

    def set_peer_range(self, peer_id: str, base: int, height: int):
        """Peer self-reported [base, height] (reference pool.go:291)."""
        with self._mtx:
            p = self._peers.get(peer_id)
            if p is None:
                p = _Peer(peer_id, base, height)
                self._peers[peer_id] = p
            else:
                p.base, p.height = base, height
            self.max_peer_height = max(self.max_peer_height, height)

    def remove_peer(self, peer_id: str):
        with self._mtx:
            self._remove_peer(peer_id)

    def _remove_peer(self, peer_id: str):
        # reset ALL of the peer's requesters, including already-delivered
        # blocks — they are unvalidated data from a peer we just dropped
        # (reference pool.go:320 removePeer -> requester.redo)
        for r in self._requesters.values():
            if r.peer_id == peer_id:
                r.peer_id = None
                r.block = None
                r.sent_at = 0.0
        self._peers.pop(peer_id, None)

    def num_peers(self) -> int:
        with self._mtx:
            return len(self._peers)

    # -- block ingress -----------------------------------------------------

    def add_block(self, peer_id: str, block: Block) -> bool:
        """Reference pool.go:244 AddBlock: only accepted from the peer the
        height was requested from."""
        with self._mtx:
            r = self._requesters.get(block.header.height)
            if r is None:
                if abs(self.height - block.header.height) > MAX_AHEAD_BEHIND:
                    self._error_fn(peer_id, "unsolicited block far away")
                return False
            if r.peer_id != peer_id or r.block is not None:
                self._error_fn(peer_id, "block from wrong peer")
                return False
            r.block = block
            p = self._peers.get(peer_id)
            if p is not None:
                p.num_pending = max(0, p.num_pending - 1)
                p.last_recv = time.monotonic()
            return True

    def no_block(self, peer_id: str, height: int):
        """Peer explicitly has no such block: reassign."""
        with self._mtx:
            r = self._requesters.get(height)
            if r is not None and r.peer_id == peer_id and r.block is None:
                r.peer_id = None
                r.sent_at = 0.0
                p = self._peers.get(peer_id)
                if p is not None:
                    p.num_pending = max(0, p.num_pending - 1)

    # -- consumer API ------------------------------------------------------

    def peek_window(self, max_window: int) -> List[Block]:
        """Contiguous ready blocks starting at self.height.  Like the
        reference's PeekTwoBlocks (pool.go:192) generalized: the consumer
        can apply the first k-1 of a k-block run (each needs its
        successor's LastCommit)."""
        out = []
        with self._mtx:
            h = self.height
            while len(out) < max_window:
                r = self._requesters.get(h)
                if r is None or r.block is None:
                    break
                out.append(r.block)
                h += 1
        return out

    def pop_requests(self, n: int):
        """Advance past n applied blocks (reference pool.go:207 PopRequest)."""
        with self._mtx:
            for _ in range(n):
                self._requesters.pop(self.height, None)
                self.height += 1

    def redo_request(self, height: int) -> Optional[str]:
        """Invalidate the block at `height`; remove its peer and reassign
        all that peer's heights (reference pool.go:221)."""
        with self._mtx:
            r = self._requesters.get(height)
            if r is None:
                return None
            peer_id = r.peer_id
            r.block = None
            r.peer_id = None
            r.sent_at = 0.0
            if peer_id is not None:
                self._remove_peer(peer_id)
            return peer_id

    def is_caught_up(self) -> bool:
        """Reference pool.go:170."""
        with self._mtx:
            if not self._peers:
                return False
            received_or_waited = (
                self.height > 0
                and (self._requesters or
                     time.monotonic() - self._start_time > 5.0)
                or time.monotonic() - self._start_time > 5.0)
            longest = (self.max_peer_height == 0
                       or self.height >= self.max_peer_height - 1)
            return bool(received_or_waited and longest)

    def get_status(self):
        with self._mtx:
            pending = sum(1 for r in self._requesters.values()
                          if r.block is None)
            return self.height, pending, len(self._requesters)

    # -- scheduler ---------------------------------------------------------

    def _scheduler_routine(self):
        while not self._stop.is_set():
            self._schedule_once()
            time.sleep(REQUEST_INTERVAL_S)

    def _schedule_once(self):
        sends = []
        with self._mtx:
            now = time.monotonic()
            # peer timeouts (reference pool.go:132 removeTimedoutPeers,
            # wall-clock based instead of flowrate)
            for p in list(self._peers.values()):
                if p.num_pending > 0 and now - p.last_recv > PEER_TIMEOUT_S:
                    p.did_timeout = True
                    self._error_fn(p.peer_id, "blocksync peer timeout")
                    self._remove_peer(p.peer_id)
            # grow the requester frontier
            while (len(self._requesters) < MAX_TOTAL_REQUESTERS
                   and self.max_peer_height
                   >= self.height + len(self._requesters)):
                h = self.height + len(self._requesters)
                if h in self._requesters:
                    break
                self._requesters[h] = _Requester(h)
            # assign unassigned requesters to available peers
            for h in sorted(self._requesters):
                r = self._requesters[h]
                if r.peer_id is not None or r.block is not None:
                    continue
                peer = self._pick_peer(h)
                if peer is None:
                    continue
                r.peer_id = peer.peer_id
                r.sent_at = now
                peer.num_pending += 1
                sends.append((peer.peer_id, h))
        for peer_id, h in sends:
            self._request_fn(peer_id, h)

    def _pick_peer(self, height: int) -> Optional[_Peer]:
        best = None
        for p in self._peers.values():
            if p.did_timeout or not (p.base <= height <= p.height):
                continue
            if p.num_pending >= MAX_PENDING_REQUESTS_PER_PEER:
                continue
            if best is None or p.num_pending < best.num_pending:
                best = p
        return best
