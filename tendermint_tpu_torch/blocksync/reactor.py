"""Blocksync (fast sync) reactor — reference blocksync/reactor.go.

Channel 0x40.  Peers exchange Status{base,height} and Block request/response
messages; the sync routine drains the pool in coalesced windows through
replay.replay_window (ONE batched signature launch on the card per window
instead of the reference's two serial loops per block), then hands off to the
consensus reactor once caught up (reference reactor.go:316 SwitchToConsensus).

The port's departure from the JAX package's reactor: a launch that failed
on the card (replay's WindowDeviceError) is not a peer's fault.  try_sync
keeps the state of the blocks that did apply and re-raises it; it asks no
peer for a redo and stops no peer.  The sync routine then ends with the
error kept on the reactor (`device_error`) and logged; `resume_sync()`
starts it again, with the pool and its peers as they were.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.p2p import wire
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.switch import Peer, Reactor
from tendermint_tpu_torch.types.block import Block

from .pool import BlockPool
from .replay import WindowDeviceError, WindowSyncError, replay_window

BLOCKSYNC_CHANNEL = 0x40
TRY_SYNC_INTERVAL_S = 0.01          # reference reactor.go:38
STATUS_UPDATE_INTERVAL_S = 10.0     # reference reactor.go:41
SWITCH_TO_CONSENSUS_INTERVAL_S = 1.0  # reference reactor.go:44


@dataclass
class BlockRequest:
    height: int


@dataclass
class NoBlockResponse:
    height: int


@dataclass
class BlockResponse:
    block_proto: bytes


@dataclass
class StatusRequest:
    pass


@dataclass
class StatusResponse:
    base: int
    height: int


# -- wire codec (proto/tendermint/blocksync/types.proto Message oneof:
# block_request=1, no_block_response=2, block_response=3{block=1},
# status_request=4, status_response=5{height=1, base=2}) ------------------

def encode_msg(msg) -> bytes:
    if isinstance(msg, BlockRequest):
        return wire.oneof_encode(1, pe.varint_field(1, msg.height))
    if isinstance(msg, NoBlockResponse):
        return wire.oneof_encode(2, pe.varint_field(1, msg.height))
    if isinstance(msg, BlockResponse):
        return wire.oneof_encode(
            3, pe.message_field_always(1, msg.block_proto))
    if isinstance(msg, StatusRequest):
        return wire.oneof_encode(4, b"")
    if isinstance(msg, StatusResponse):
        return wire.oneof_encode(5, (pe.varint_field(1, msg.height)
                                     + pe.varint_field(2, msg.base)))
    raise TypeError(f"unknown blocksync message {type(msg).__name__}")


def _dec_status_response(body: bytes) -> StatusResponse:
    f = pd.parse(body)
    return StatusResponse(base=pd.get_int(f, 2), height=pd.get_int(f, 1))


def _dec_block_response(body: bytes) -> BlockResponse:
    f = pd.parse(body)
    b = pd.get_message(f, 1)
    if b is None:
        raise pd.ProtoError("BlockResponse: missing block")
    return BlockResponse(b)


_HANDLERS = {
    1: lambda b: BlockRequest(pd.get_int(pd.parse(b), 1)),
    2: lambda b: NoBlockResponse(pd.get_int(pd.parse(b), 1)),
    3: _dec_block_response,
    4: lambda b: StatusRequest(),
    5: _dec_status_response,
}


def decode_msg(data: bytes):
    return wire.oneof_decode(data, _HANDLERS)


wire.register_codec(BLOCKSYNC_CHANNEL, encode_msg, decode_msg)


class BlocksyncReactor(Reactor):
    """BaseService lifecycle via Reactor (reference blocksync/reactor.go)."""

    def __init__(self, executor, store, state, fast_sync: bool = True,
                 window: int = 32,
                 on_caught_up: Optional[Callable] = None):
        """on_caught_up(state) is invoked once when the pool reports caught
        up (the node wires this to ConsensusState start / SwitchToConsensus,
        reference reactor.go:322-330)."""
        super().__init__("BLOCKSYNC")
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("blocksync")
        self.executor = executor
        self.store = store
        self.state = state
        self.window = window
        self.fast_sync = fast_sync
        self.on_caught_up = on_caught_up
        self.blocks_synced = 0
        self.pool = BlockPool(state.last_block_height + 1,
                              self._send_request, self._peer_error)
        self._switched = False
        self._active = False
        # the card fault that ended the sync routine (None while it runs)
        self.device_error: Optional[WindowDeviceError] = None
        # self-reported sync rate, EMA logged every 100 blocks
        # (reference blocksync/reactor.go:416-421)
        self._rate_t0 = time.monotonic()
        self._rate_marked = 0
        self._rate_ema = 0.0

    # -- lifecycle ---------------------------------------------------------

    def on_start(self):
        """Started by the Switch with the other reactors; the sync
        routines only run when fast-syncing (reference reactor.go:103
        OnStart gates on fastSync)."""
        if self.fast_sync:
            self.activate()

    def activate(self):
        """Begin the sync routines — at start when fast_sync, or later
        when statesync hands off (node.go:993 startStateSync ->
        SwitchToBlockSync).  Idempotent: the handoff path calls it on a
        reactor the Switch already started with fast_sync unset."""
        if self._active:
            return
        self._active = True
        self.fast_sync = True
        self.pool.start()
        self.spawn(self._sync_routine, name="blocksync-sync")
        self.spawn(self._status_routine, name="blocksync-status")

    def resume_sync(self):
        """Start the sync routine again after a card fault ended it; the
        pool, its peers and the blocks it holds were kept."""
        if not self._active or self.device_error is None:
            return
        self.device_error = None
        self.spawn(self._sync_routine, name="blocksync-sync")

    def switch_to_blocksync(self, state):
        """Adopt a statesync-bootstrapped state and sync the tail from it
        (reference blocksync/reactor.go:110 SwitchToBlockSync: resets the
        pool to state.LastBlockHeight+1).  Must be called before
        activate()."""
        self.state = state
        self.fast_sync = True
        self.pool = BlockPool(state.last_block_height + 1,
                              self._send_request, self._peer_error)

    def on_stop(self):
        self.pool.stop()

    def get_channels(self):
        return [ChannelDescriptor(BLOCKSYNC_CHANNEL, priority=5,
                                  send_queue_capacity=1000)]

    # -- peer lifecycle ----------------------------------------------------

    def add_peer(self, peer: Peer):
        peer.send(BLOCKSYNC_CHANNEL,
                  StatusResponse(self.store.base(), self.store.height()))

    def remove_peer(self, peer: Peer, reason):
        self.pool.remove_peer(peer.id)

    # -- wire --------------------------------------------------------------

    def _send_request(self, peer_id: str, height: int):
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is not None:
            peer.try_send(BLOCKSYNC_CHANNEL, BlockRequest(height))

    def _peer_error(self, peer_id: str, reason: str):
        sw = self.switch
        if sw is None:
            return
        peer = sw.peers.get(peer_id)
        if peer is not None:
            sw.stop_peer_for_error(peer, reason)

    def receive(self, ch_id: int, peer: Peer, msg_bytes: bytes):
        msg = decode_msg(msg_bytes)
        if isinstance(msg, BlockRequest):
            block = self.store.load_block(msg.height)
            if block is not None:
                peer.try_send(BLOCKSYNC_CHANNEL, BlockResponse(block.proto()))
            else:
                peer.try_send(BLOCKSYNC_CHANNEL, NoBlockResponse(msg.height))
        elif isinstance(msg, BlockResponse):
            try:
                block = Block.from_proto(msg.block_proto)
            except Exception:
                self._peer_error(peer.id, "undecodable block")
                return
            self.pool.add_block(peer.id, block)
        elif isinstance(msg, NoBlockResponse):
            self.pool.no_block(peer.id, msg.height)
        elif isinstance(msg, StatusRequest):
            peer.try_send(BLOCKSYNC_CHANNEL,
                          StatusResponse(self.store.base(),
                                         self.store.height()))
        elif isinstance(msg, StatusResponse):
            self.pool.set_peer_range(peer.id, msg.base, msg.height)

    # -- sync loop (reference reactor.go:255 poolRoutine) ------------------

    def _status_routine(self):
        while not self.quitting.is_set():
            if self.switch is not None:
                self.switch.broadcast(BLOCKSYNC_CHANNEL, StatusRequest())
            self.quitting.wait(STATUS_UPDATE_INTERVAL_S)

    def _sync_routine(self):
        last_switch_check = 0.0
        while not self.quitting.is_set():
            now = time.monotonic()
            if now - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL_S:
                last_switch_check = now
                if self.pool.is_caught_up() and not self._switched:
                    self._switched = True
                    self.pool.stop()
                    # persistence barrier before the consensus handoff:
                    # every group-committed window must be durable
                    # before consensus starts writing per height again
                    # (ADR-017; group mode is window-scoped, so this is
                    # a cheap no-op unless a writer is mid-flush)
                    from tendermint_tpu_torch.state import pipeline as _bp
                    pipe = _bp.running()
                    if pipe is not None:
                        pipe.flush()
                    if self.on_caught_up is not None:
                        self.on_caught_up(self.state)
                    return
            try:
                progressed = self.try_sync()
            except WindowDeviceError as e:
                # the card failed, not a peer: keep the error, end the
                # routine (resume_sync restarts it)
                self.device_error = e
                self.log.error("blocksync stopped on a card fault",
                               height=e.height, applied=e.applied,
                               err=str(e))
                return
            except Exception:
                # the sync thread must survive anything a peer can trigger
                progressed = False
            if not progressed:
                self.quitting.wait(TRY_SYNC_INTERVAL_S)

    def try_sync(self) -> bool:
        """One window: verify+apply all ready blocks (minus the last, whose
        certifying commit hasn't arrived).  Returns True if progress."""
        ready = self.pool.peek_window(self.window + 1)
        if len(ready) < 2:
            return False
        blocks = ready[:-1]
        certifiers = [ready[i + 1].last_commit for i in range(len(blocks))]
        try:
            self.state, n = replay_window(self.executor, self.store,
                                          self.state, blocks, certifiers,
                                          max_window=self.window)
        except WindowSyncError as e:
            if e.state is not None and e.applied > 0:
                self.state = e.state
                self.pool.pop_requests(e.applied)
                self.blocks_synced += e.applied
            # redo the bad block and its certifier (reference reactor.go:381)
            for h in (e.height, e.height + 1):
                self.pool.redo_request(h)
            return e.applied > 0
        except WindowDeviceError as e:
            # keep what applied; no redo, no peer stopped
            if e.state is not None and e.applied > 0:
                self.state = e.state
                self.pool.pop_requests(e.applied)
                self.blocks_synced += e.applied
            raise
        self.pool.pop_requests(n)
        self.blocks_synced += n
        if self.blocks_synced - self._rate_marked >= 100:
            now = time.monotonic()
            dt = max(now - self._rate_t0, 1e-9)
            rate = (self.blocks_synced - self._rate_marked) / dt
            self._rate_ema = rate if self._rate_ema == 0.0 \
                else 0.9 * self._rate_ema + 0.1 * rate
            from tendermint_tpu_torch.state import pipeline as _bp
            pipe = _bp.running()
            # label by what actually ran, not by what is installed: a
            # pipeline whose every window declined (k<2, busy) is
            # "serial" to the operator, matching the
            # blocksync_blocks_applied_total{path=} metric
            pipelined = pipe is not None and pipe.windows_pipelined > 0
            self.log.info("fast sync rate",
                          height=self.state.last_block_height,
                          max_peer_height=self.pool.max_peer_height,
                          blocks_per_s=round(self._rate_ema, 1),
                          path="pipelined" if pipelined else "serial",
                          windows_pipelined=(pipe.windows_pipelined
                                             if pipe is not None else 0),
                          windows_degraded=(pipe.windows_degraded
                                            if pipe is not None else 0),
                          durable_height=(pipe.durable_height()
                                          if pipe is not None else None))
            self._rate_t0 = now
            self._rate_marked = self.blocks_synced
        return n > 0
