"""Consensus reactor (reference consensus/reactor.go): gossips round
state, proposals/parts and votes over three channels (0x20-0x22).

Vote gossip is bit-array-targeted like the reference: every added vote is
announced with HasVote, each peer's have-bitmap is tracked per round, the
gossip loop sends a peer only votes it lacks, and observed 2/3 majorities
are announced with VoteSetMaj23 and answered with VoteSetBits (reference
consensus/reactor.go gossipVotesRoutine + queryMaj23Routine).  New
proposals/parts are broadcast; a per-peer catch-up thread serves
store-backed history to peers behind our height.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional

from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.switch import Peer, Reactor
from tendermint_tpu_torch.types.basic import SignedMsgType
from tendermint_tpu_torch.types.vote import Vote

from . import observatory as obsv
from .messages import (DATA_CHANNEL, STATE_CHANNEL, VOTE_CHANNEL,
                       VOTE_SET_BITS_CHANNEL,
                       BlockPartGossip, HasVoteMessage, NewRoundStepMessage,
                       ProposalGossip, VoteGossip, VoteSetBitsMessage,
                       VoteSetMaj23Message, decode_msg)
from .round_types import Step
from .state import ConsensusState


class _PeerState:
    """Per-peer view (reference consensus/types/peer_round_state.go):
    last reported round step + have-bitmaps for the current round."""

    def __init__(self, step_msg: NewRoundStepMessage):
        self.step = step_msg
        self.prevotes: Optional[object] = None    # BitArray
        self.precommits: Optional[object] = None

    def apply_step(self, msg: NewRoundStepMessage):
        if (msg.height, msg.round) != (self.step.height, self.step.round):
            self.prevotes = None
            self.precommits = None
        self.step = msg

    def _arr(self, type_: int, size: int):
        from tendermint_tpu_torch.libs.bits import BitArray
        name = "prevotes" if type_ == int(SignedMsgType.PREVOTE)             else "precommits"
        arr = getattr(self, name)
        if arr is None or arr.size() != size:
            arr = BitArray(size)
            setattr(self, name, arr)
        return arr

    def set_has_vote(self, height: int, round_: int, type_: int,
                     index: int, size: int):
        if (height, round_) != (self.step.height, self.step.round):
            return
        if 0 <= index < size:
            self._arr(type_, size).set_index(index, True)

    def apply_bits(self, height: int, round_: int, type_: int, bits):
        if (height, round_) != (self.step.height, self.step.round):
            return
        arr = self._arr(type_, bits.size())
        setattr(self, "prevotes" if type_ == int(SignedMsgType.PREVOTE)
                else "precommits", arr.or_(bits))


class ConsensusReactor(Reactor):
    """BaseService lifecycle via Reactor (reference consensus/reactor.go)."""

    def __init__(self, cs: ConsensusState):
        super().__init__("CONSENSUS")
        self.cs = cs
        self._peer_state: Dict[str, _PeerState] = {}
        self._catchup_sent: Dict[str, tuple] = {}  # peer -> (height, time)
        self._data_resend: Dict[str, tuple] = {}  # peer -> ((h, r), time)
        self._lock = threading.Lock()
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("consensus")

        cs.broadcast_vote.append(self._on_new_vote)
        cs.broadcast_proposal.append(self._on_new_proposal)
        cs.broadcast_block_part.append(self._on_new_part)
        if cs.event_bus is not None:
            self._sub = cs.event_bus.subscribe("NewRoundStep")
            # every vote the state machine ADDS (own or peer) is announced
            # so peers can subtract it from their gossip (reference
            # broadcastHasVoteMessage, consensus/state.go:2124)
            self._vote_sub = cs.event_bus.subscribe("Vote")

    def on_start(self):
        """Reference consensus/reactor.go:77 OnStart: the gossip
        routines; the Switch starts us with the other reactors."""
        if self.cs.event_bus is not None:
            self.spawn(self._step_broadcaster, name="cons-step-bcast")
            self.spawn(self._has_vote_broadcaster, name="cons-hasvote")
        self.spawn(self._catchup_routine, name="cons-catchup")

    def on_stop(self):
        bus = self.cs.event_bus
        if bus is not None:
            for attr in ("_sub", "_vote_sub"):
                sub = getattr(self, attr, None)
                if sub is not None:
                    bus.unsubscribe(sub)

    def get_channels(self):
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=6,
                              send_queue_capacity=100),
            ChannelDescriptor(DATA_CHANNEL, priority=10,
                              send_queue_capacity=100),
            ChannelDescriptor(VOTE_CHANNEL, priority=7,
                              send_queue_capacity=200),
            # reference reactor.go:145 gives VoteSetBits priority 1 with a
            # tiny queue: catchup bitmaps are droppable, steps are not
            ChannelDescriptor(VOTE_SET_BITS_CHANNEL, priority=1,
                              send_queue_capacity=4),
        ]

    # -- outbound ----------------------------------------------------------

    def _round_step_msg(self) -> NewRoundStepMessage:
        rs = self.cs.get_round_state()
        return NewRoundStepMessage(rs.height, rs.round, int(rs.step),
                                   rs.commit_round)

    def _on_new_vote(self, vote):
        if self.switch is not None:
            self.switch.broadcast(VOTE_CHANNEL, VoteGossip(vote))

    def _has_vote_broadcaster(self):
        while not self.quitting.is_set():
            try:
                ev = self._vote_sub.queue.get(timeout=0.2)
            except Exception:  # queue.Empty
                continue
            vote = (ev.data or {}).get("vote")
            if vote is None or self.switch is None:
                continue
            self.switch.broadcast(STATE_CHANNEL, HasVoteMessage(
                vote.height, vote.round, int(vote.type),
                vote.validator_index))

    def _on_new_proposal(self, proposal):
        if self.switch is not None:
            self.switch.broadcast(DATA_CHANNEL, ProposalGossip(proposal))

    def _on_new_part(self, height, round_, part):
        if self.switch is not None:
            self.switch.broadcast(DATA_CHANNEL,
                                  BlockPartGossip(height, round_, part))

    def _step_broadcaster(self):
        while not self.quitting.is_set():
            try:
                self._sub.queue.get(timeout=0.2)
            except Exception:  # queue.Empty
                continue
            if self.switch is not None:
                self.switch.broadcast(STATE_CHANNEL, self._round_step_msg())

    # -- peer lifecycle ----------------------------------------------------

    def add_peer(self, peer: Peer):
        self.log.debug("peer added", peer=peer.id)
        peer.send(STATE_CHANNEL, self._round_step_msg())

    def remove_peer(self, peer: Peer, reason):
        self.log.debug("peer removed", peer=peer.id,
                       reason=str(reason) if reason else "")
        with self._lock:
            self._peer_state.pop(peer.id, None)
            self._catchup_sent.pop(peer.id, None)
            self._data_resend.pop(peer.id, None)

    # -- inbound -----------------------------------------------------------

    def receive(self, ch_id: int, peer: Peer, msg_bytes: bytes):
        # proto decode: malformed peer bytes raise ProtoError and the
        # switch disconnects the peer (no pickle on the wire)
        msg = decode_msg(msg_bytes)
        if ch_id == STATE_CHANNEL:
            if isinstance(msg, NewRoundStepMessage):
                with self._lock:
                    ps = self._peer_state.get(peer.id)
                    if ps is None:
                        self._peer_state[peer.id] = _PeerState(msg)
                    else:
                        ps.apply_step(msg)
                # published for other reactors (the evidence reactor's
                # peer-height gate) — the analogue of the reference's
                # peer.Set(types.PeerStateKey, ...) consensus height
                peer.data["height"] = msg.height
            elif isinstance(msg, HasVoteMessage):
                size = self._vote_set_size(msg.height)
                with self._lock:
                    ps = self._peer_state.get(peer.id)
                    if ps is not None and size:
                        ps.set_has_vote(msg.height, msg.round, msg.type,
                                        msg.index, size)
            elif isinstance(msg, VoteSetMaj23Message):
                self._on_maj23(peer, msg)
        elif ch_id == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, VoteSetBitsMessage):
                from tendermint_tpu_torch.libs.bits import BitArray
                # peer-controlled size: must equal our validator-set size
                # for that height or the allocation is refused (a huge
                # bits_size would otherwise allocate bits_size/8 bytes)
                size = self._vote_set_size(msg.height)
                if size == 0 or msg.bits_size != size \
                        or len(msg.bits) != (size + 7) // 8:
                    return
                bits = BitArray.from_bytes(msg.bits_size, msg.bits)
                with self._lock:
                    ps = self._peer_state.get(peer.id)
                    if ps is not None:
                        ps.apply_bits(msg.height, msg.round, msg.type,
                                      bits)
        elif ch_id == DATA_CHANNEL:
            if isinstance(msg, ProposalGossip):
                self.cs.set_proposal(msg.proposal, peer_id=peer.id)
            elif isinstance(msg, BlockPartGossip):
                # receipt accounting at the wire seam (before the
                # receive queue, so queue wait is visible against the
                # state machine's own stamps): which peer delivered
                # which height's parts/votes (ADR-020).  The reference
                # block_parts{peer_id} counter increments in the state
                # machine, gated on the part actually being ADDED
                obsv.receipt(self.cs.name, msg.height, "part", peer.id)
                self.cs.add_block_part(msg.height, msg.round, msg.part,
                                       peer_id=peer.id)
        elif ch_id == VOTE_CHANNEL:
            if isinstance(msg, VoteGossip):
                obsv.receipt(self.cs.name, msg.vote.height, "vote",
                             peer.id)
                self.cs.add_vote(msg.vote, peer_id=peer.id)

    def _vote_set_size(self, height: int) -> int:
        with self.cs._mtx:
            rs = self.cs.rs
            if rs.height != height or rs.validators is None:
                return 0
            return rs.validators.size()

    def _on_maj23(self, peer: Peer, msg: "VoteSetMaj23Message"):
        """Record the peer's claimed majority and answer with our
        have-bitmap for that (height, round, type, block_id) (reference
        handling of VoteSetMaj23Message -> VoteSetBitsMessage)."""
        with self.cs._mtx:
            rs = self.cs.rs
            if rs.height != msg.height or rs.votes is None:
                return
            # bound the peer-supplied round: prevotes()/precommits()
            # create vote sets on demand, so an unbounded round would let
            # a peer allocate validator-sized sets for arbitrary rounds
            if not 0 <= msg.round <= rs.round:
                return
            vs = rs.votes.prevotes(msg.round) \
                if msg.type == int(SignedMsgType.PREVOTE) \
                else rs.votes.precommits(msg.round)
            try:
                vs.set_peer_maj23(peer.id, msg.block_id)
            except Exception:
                pass  # conflicting claims are the peer's problem
            bits = vs.bit_array_by_block_id(msg.block_id)
            if bits is None:
                bits = vs.bit_array()
        peer.try_send(VOTE_SET_BITS_CHANNEL, VoteSetBitsMessage(
            msg.height, msg.round, msg.type, msg.block_id,
            bits.size(), bits.to_bytes()))

    MAJ23_QUERY_INTERVAL_S = 2.0

    DATA_RESEND_S = 0.5  # per-peer proposal/part-set resend throttle

    # periodic NewRoundStep re-announcement.  Step broadcasts are
    # event-driven; a partition that swallows them leaves every peer's
    # view of us stale FOREVER once we park in a step with no timeout
    # armed (PREVOTE short of 2/3-any).  The peers then route our
    # gossip through the stale view — store-backed catch-up for a
    # height we are past — and the network wedges even though the
    # votes we need exist one hop away (found by the NetHarness
    # no-quorum partition scenario, ADR-019).  A 1 Hz re-announce
    # heals any stale view within a beat of the partition healing.
    STEP_ANNOUNCE_S = 1.0

    # -- store-backed catch-up for peers behind our height -----------------

    CATCHUP_HEIGHTS_PER_TICK = 8

    CATCHUP_RESEND_S = 1.0

    def _serve_catchup(self, peer: Peer, peer_height: int):
        """Send the peer everything it needs to commit heights
        [peer_height, peer_height + window): the certifying precommits
        (reconstructed from the stored Commit; signature order IS
        validator-set order at that height, so positional indices are
        valid on both ends) and the stored block parts.

        Throttled per peer: a window is re-sent only once the peer's
        reported height advances past the last window start, or after
        CATCHUP_RESEND_S (covers try_send drops) — otherwise the 0.1 s
        tick would re-read and re-queue megabytes per tick."""
        store = self.cs.block_store
        if store is None:
            return
        now = time.monotonic()
        with self._lock:  # vs remove_peer: don't resurrect a gone peer's slot
            last = self._catchup_sent.get(peer.id)
            if last is not None and peer_height <= last[0] \
                    and now - last[1] < self.CATCHUP_RESEND_S:
                return
            self._catchup_sent[peer.id] = (peer_height, now)
        base = store.base()
        top = store.height()
        for h in range(peer_height,
                       min(peer_height + self.CATCHUP_HEIGHTS_PER_TICK,
                           top + 1)):
            if h < base:
                return  # pruned away; blocksync from another peer
            commit = store.load_block_commit(h) or store.load_seen_commit(h)
            if commit is None:
                return
            for i, sig in enumerate(commit.signatures):
                if not sig.for_block():
                    continue
                v = Vote(type=SignedMsgType.PRECOMMIT, height=h,
                         round=commit.round, block_id=commit.block_id,
                         timestamp=sig.timestamp,
                         validator_address=sig.validator_address,
                         validator_index=i, signature=sig.signature)
                peer.try_send(VOTE_CHANNEL, VoteGossip(v))
            meta = store.load_block_meta(h)
            if meta is None:
                return
            for i in range(meta.block_id.part_set_header.total):
                part = store.load_block_part(h, i)
                if part is not None:
                    peer.try_send(DATA_CHANNEL,
                                  BlockPartGossip(h, commit.round, part))

    # -- catch-up gossip (simplified gossipVotesRoutine) -------------------

    def _catchup_routine(self):
        rng = random.Random()
        last_maj23 = 0.0
        last_step_announce = 0.0
        while not self.quitting.is_set():
            time.sleep(0.1)
            if self.switch is None:
                continue
            if time.monotonic() - last_step_announce \
                    >= self.STEP_ANNOUNCE_S:
                last_step_announce = time.monotonic()
                try:
                    self.switch.broadcast(STATE_CHANNEL,
                                          self._round_step_msg())
                except Exception:  # noqa: BLE001 - keep routine alive
                    pass
            with self._lock:
                peer_states = dict(self._peer_state)
            if not peer_states:
                continue
            with self.cs._mtx:
                rs = self.cs.rs
                height, round_ = rs.height, rs.round
                votes = rs.votes
                proposal = rs.proposal
                parts = rs.proposal_block_parts
                if votes is None:
                    continue
                pv_set = votes.prevotes(round_)
                pc_set = votes.precommits(round_)
                prevotes = list(pv_set.votes)
                precommits = list(pc_set.votes)
                pv_bits = pv_set.bit_array()
                pc_bits = pc_set.bit_array()
                pv_maj23 = pv_set.two_thirds_majority()
                pc_maj23 = pc_set.two_thirds_majority()

            # announce observed 2/3 majorities so peers can tell us which
            # of those votes they still lack (reference queryMaj23Routine)
            now = time.monotonic()
            announce_maj23 = now - last_maj23 >= self.MAJ23_QUERY_INTERVAL_S
            if announce_maj23:
                last_maj23 = now

            for pid, ps in peer_states.items():
                peer = self.switch.peers.get(pid)
                if peer is None:
                    continue
                step = ps.step
                if step.height < height:
                    # peer fell behind consensus while we're past its
                    # height: serve the decided block from the store —
                    # stored-commit precommits first (so the peer's
                    # enterCommit builds the PartSet from the commit's
                    # BlockID), then the parts (reference
                    # consensus/reactor.go gossipDataForCatchup + the
                    # LoadBlockCommit branch of gossipVotesRoutine).
                    try:
                        self._serve_catchup(peer, step.height)
                    except Exception:  # noqa: BLE001 - keep routine alive
                        pass
                    continue
                if step.height != height:
                    continue
                if announce_maj23:
                    for type_, (bid, ok) in (
                            (int(SignedMsgType.PREVOTE), pv_maj23),
                            (int(SignedMsgType.PRECOMMIT), pc_maj23)):
                        if ok and bid is not None:
                            peer.try_send(STATE_CHANNEL, VoteSetMaj23Message(
                                height, round_, type_, bid))
                # send ONE vote the peer provably lacks (its HasVote /
                # VoteSetBits bitmap subtracted from ours); fall back to a
                # random known vote only when we have no bitmap for it
                if (step.height, step.round) == (height, round_):
                    # targeted vote gossip for EVERY same-round peer — a
                    # peer sitting in PRECOMMIT_WAIT still needs the
                    # precommits it provably lacks (reference
                    # gossipVotesRoutine serves precommits through
                    # RoundStepPrecommitWait).  A missing bitmap means
                    # the peer reported nothing — treat as empty
                    # (everything missing), matching the reference's
                    # EnsureVoteBitArrays.
                    from tendermint_tpu_torch.libs.bits import BitArray
                    for type_, ours, vlist in (
                            (int(SignedMsgType.PREVOTE), pv_bits,
                             prevotes),
                            (int(SignedMsgType.PRECOMMIT), pc_bits,
                             precommits)):
                        theirs = ps.prevotes \
                            if type_ == int(SignedMsgType.PREVOTE) \
                            else ps.precommits
                        if theirs is None:
                            theirs = BitArray(ours.size())
                        missing = ours.sub(theirs)
                        idx, ok = missing.pick_random(rng)
                        if ok and vlist[idx] is not None:
                            peer.try_send(VOTE_CHANNEL,
                                          VoteGossip(vlist[idx]))
                            break
                elif step.round < round_:
                    # peer behind in round: its bitmaps describe its OLD
                    # round; send a random current-round vote so it can
                    # observe 2/3 and advance
                    candidates = [v for v in prevotes + precommits
                                  if v is not None]
                    if candidates:
                        peer.try_send(VOTE_CHANNEL,
                                      VoteGossip(rng.choice(candidates)))
                if proposal is not None and step.round == round_ \
                        and step.step < int(Step.PRECOMMIT):
                    # full proposal+parts resend, throttled per peer: an
                    # unthrottled 0.1 s tick would re-queue the whole
                    # block every tick and starve the DATA channel
                    with self._lock:
                        last = self._data_resend.get(pid)
                        due = last is None or \
                            last[0] != (height, round_) or \
                            time.monotonic() - last[1] \
                            >= self.DATA_RESEND_S
                        if due:
                            self._data_resend[pid] = ((height, round_),
                                                      time.monotonic())
                    if due:
                        peer.try_send(DATA_CHANNEL, ProposalGossip(proposal))
                        if parts is not None:
                            for i in range(parts.header().total):
                                part = parts.get_part(i)
                                if part is not None:
                                    peer.try_send(
                                        DATA_CHANNEL,
                                        BlockPartGossip(height, round_, part))
