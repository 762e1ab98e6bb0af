"""Evidence reactor (reference evidence/reactor.go): broadcast pending
evidence to peers on channel 0x38; received evidence enters the pool (which
verifies it) and is re-broadcast if new.

The port's departure from the JAX package's reactor: a launch that failed
on the card while the pool verified a received item (degrade.card_fault)
is not the peer's fault and not an unprocessable item.  receive() stops no
peer and drops nothing silently: it keeps the error on the reactor
(`device_error`, the last card fault), logs it and leaves the rest of the
message unprocessed, none of it in the pool; an item enters the pool when it
is received again.  In a chaos drill the JAX package's behaviour holds."""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from tendermint_tpu_torch.crypto.degrade import DeviceLaneError, card_fault
from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.p2p import wire
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.switch import Peer, Reactor
from tendermint_tpu_torch.types.evidence import (EvidenceError,
                                           evidence_from_proto,
                                           evidence_proto)

from .pool import EvidencePool

EVIDENCE_CHANNEL = 0x38
BROADCAST_INTERVAL_S = 10.0


@dataclass
class EvidenceGossip:
    """One or more canonical Evidence proto encodings — the wire format is
    tendermint.types.EvidenceList {repeated Evidence evidence = 1}
    (reference evidence/reactor.go evidenceListToProto)."""
    evidence_protos: list


def encode_msg(msg) -> bytes:
    if isinstance(msg, EvidenceGossip):
        return pe.repeated_message_field(1, msg.evidence_protos)
    raise TypeError(f"unknown evidence message {type(msg).__name__}")


def decode_msg(data: bytes) -> EvidenceGossip:
    return EvidenceGossip(pd.get_messages(pd.parse(data), 1))


wire.register_codec(EVIDENCE_CHANNEL, encode_msg, decode_msg)


class EvidenceReactor(Reactor):
    """BaseService lifecycle via Reactor (reference evidence/reactor.go)."""

    def __init__(self, pool: EvidencePool):
        super().__init__("EVIDENCE")
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("evidence")
        self.pool = pool
        self._sent: dict = {}  # peer_id -> set of evidence hashes sent
        # the last launch that failed on the card while a received item
        # verified (see the module docstring)
        self.device_error: Optional[DeviceLaneError] = None
        # new pending evidence pushes to every peer immediately; the
        # timed rebroadcast remains the retry for dropped sends
        pool.on_new_evidence.append(lambda ev: self._push_all())

    def _push_all(self):
        sw = self.switch
        if sw is None or self.quitting.is_set():
            return
        for peer in list(sw.peers.values()):
            self._send_pending(peer)

    def on_start(self):
        """Reference evidence/reactor.go OnStart; started by the Switch."""
        self.spawn(self._broadcast_routine, name="evidence-bcast")

    def get_channels(self):
        return [ChannelDescriptor(EVIDENCE_CHANNEL, priority=6,
                                  send_queue_capacity=100)]

    def add_peer(self, peer: Peer):
        self.log.debug("peer added", peer=peer.id)
        self._sent[peer.id] = set()
        self._send_pending(peer)

    def remove_peer(self, peer: Peer, reason):
        self.log.debug("peer removed", peer=peer.id,
                       reason=str(reason) if reason else "")
        self._sent.pop(peer.id, None)

    def receive(self, ch_id: int, peer: Peer, msg_bytes: bytes):
        msg = decode_msg(msg_bytes)
        for ev_proto in msg.evidence_protos:
            try:
                ev = evidence_from_proto(ev_proto)
                self.pool.add_evidence(ev)
            except EvidenceError as e:
                # provably invalid evidence: punish the peer (reference
                # reactor.go); the remaining items die with the peer
                self.log.error("invalid evidence from peer",
                               peer=peer.id, err=str(e))
                sw = self.switch
                if sw is not None:
                    sw.stop_peer_for_error(peer, f"bad evidence: {e}")
                return
            except Exception as e:  # noqa: BLE001
                if card_fault(e):
                    # the card failed, not the peer or the item: keep
                    # the error and stop here
                    self.device_error = e
                    self.log.error("evidence verification stopped on a "
                                   "card fault", peer=peer.id, err=str(e))
                    return
                # undecodable/unverifiable item (e.g. missing state):
                # drop IT, keep processing the rest of the batch
                self.log.error("dropping unprocessable evidence item",
                               peer=peer.id, err=str(e))
                continue

    def _send_pending(self, peer: Peer):
        """Reference evidence/reactor.go:165-184 prepareEvidenceMessage:
        an item goes out only once the peer's consensus height (gossiped
        by the consensus reactor into peer.data["height"], the analogue
        of the reference's PeerStateKey) has reached the evidence height
        — a syncing peer cannot verify future-height evidence and would
        have to buffer or wrongly reject it.  A peer already past the
        age window is skipped for that item (the pool prunes expired
        evidence itself).  Held-back items stay unmarked and retry on
        the next broadcast tick."""
        sent = self._sent.get(peer.id, set())
        peer_h = peer.data.get("height")
        state = self.pool.state
        max_age = (state.consensus_params.evidence.max_age_num_blocks
                   if state is not None else None)
        fresh = []
        for ev in self.pool.pending_evidence():
            if ev.hash() in sent:
                continue
            if peer_h is None or peer_h < ev.height():
                continue  # peer behind: wait for it to catch up
            if max_age is not None and peer_h - ev.height() > max_age:
                continue  # peer far past the window
            fresh.append((ev.hash(), evidence_proto(ev)))
        if fresh and peer.try_send(
                EVIDENCE_CHANNEL, EvidenceGossip([p for _, p in fresh])):
            sent.update(h for h, _ in fresh)

    def _broadcast_routine(self):
        while not self.quitting.is_set():
            sw = self.switch
            if sw is not None:
                for peer in list(sw.peers.values()):
                    self._send_pending(peer)
            self.quitting.wait(BROADCAST_INTERVAL_S)
