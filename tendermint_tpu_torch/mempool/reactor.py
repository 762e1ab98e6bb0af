"""Mempool reactor (reference mempool/v0/reactor.go): gossip admitted txs
to peers; the LRU cache dedups loops."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict

from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.p2p import wire
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.switch import Peer, Reactor

from .mempool import Mempool

MEMPOOL_CHANNEL = 0x30


@dataclass
class TxsMessage:
    txs: list


# -- wire codec (proto/tendermint/mempool/types.proto: Message oneof
# txs=1, Txs{repeated bytes txs=1}) ---------------------------------------

def encode_msg(msg) -> bytes:
    if isinstance(msg, TxsMessage):
        return wire.oneof_encode(
            1, pe.repeated_bytes_field(1, [bytes(t) for t in msg.txs]))
    raise TypeError(f"unknown mempool message {type(msg).__name__}")


def decode_msg(data: bytes):
    return wire.oneof_decode(data, {
        1: lambda b: TxsMessage(pd.get_messages(pd.parse(b), 1))})


wire.register_codec(MEMPOOL_CHANNEL, encode_msg, decode_msg)


class MempoolReactor(Reactor):
    """BaseService lifecycle via Reactor (reference mempool/reactor.go).

    With an IngressGate attached (ADR-018), received gossip txs route
    through the gate's bounded admission queue under a per-peer source
    id, and a saturated queue THROTTLES the channel: receive() parks
    for a bounded beat, which blocks this peer's recv loop and lets
    TCP backpressure propagate instead of buffering a flood in RAM."""

    # how long one receive() parks when the admission queue is full —
    # long enough to drain a batch, short enough to keep the peer's
    # other channels responsive
    THROTTLE_S = 0.05

    def __init__(self, mempool: Mempool, gate=None):
        super().__init__("MEMPOOL")
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("mempool")
        self.mempool = mempool
        self.gate = gate
        self._peer_sent: Dict[str, set] = {}  # peer -> sent tx hashes
        self._lock = threading.Lock()

    def on_start(self):
        """Reference mempool/reactor.go OnStart (broadcast routine);
        started by the owning Switch."""
        self.spawn(self._broadcast_routine, name="mempool-bcast")

    def get_channels(self):
        return [ChannelDescriptor(MEMPOOL_CHANNEL, priority=5,
                                  send_queue_capacity=100)]

    def add_peer(self, peer: Peer):
        self.log.debug("peer added", peer=peer.id)
        with self._lock:
            self._peer_sent[peer.id] = set()

    def remove_peer(self, peer: Peer, reason):
        self.log.debug("peer removed", peer=peer.id,
                       reason=str(reason) if reason else "")
        with self._lock:
            self._peer_sent.pop(peer.id, None)

    def receive(self, ch_id: int, peer: Peer, msg_bytes: bytes):
        msg = decode_msg(msg_bytes)
        if not isinstance(msg, TxsMessage):
            return
        gate = self.gate
        if gate is None or not gate.is_running():
            for tx in msg.txs:
                self.mempool.check_tx(bytes(tx))
            return
        source = f"p2p:{peer.id}"
        for tx in msg.txs:
            gate.submit(bytes(tx), source=source)
        if gate.saturated():
            # backpressure: stop reading the mempool channel for a
            # beat — gossip redelivers, and the dedup cache absorbs
            # the replays once the queue drains
            time.sleep(self.THROTTLE_S)

    def _broadcast_routine(self):
        """Per-peer broadcast of not-yet-sent txs (the clist walk in the
        reference, mempool/v0/reactor.go:189; here tracked by tx hash)."""
        from tendermint_tpu_torch.types.block import tx_hash
        while not self.quitting.is_set():
            time.sleep(0.05)
            if self.switch is None:
                continue
            pool = [(tx_hash(tx), tx) for tx in self.mempool.reap_max_txs(-1)]
            pool_keys = {k for k, _ in pool}
            with self._lock:
                peers_sent = {pid: set(s) for pid, s in self._peer_sent.items()}
            for pid, sent in peers_sent.items():
                peer = self.switch.peers.get(pid)
                if peer is None:
                    continue
                fresh = [tx for k, tx in pool if k not in sent]
                if fresh and peer.try_send(MEMPOOL_CHANNEL, TxsMessage(fresh)):
                    sent.update(k for k, _ in pool)
                sent &= pool_keys  # prune hashes no longer in the pool
                with self._lock:
                    if pid in self._peer_sent:
                        self._peer_sent[pid] = sent
