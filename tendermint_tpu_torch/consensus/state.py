"""The BFT consensus state machine (reference consensus/state.go).

One serializing receive thread consumes peer/internal/timeout queues,
WAL-logs every input before processing, and drives the round state through
NewRound -> Propose -> Prevote(+Wait) -> Precommit(+Wait) -> Commit
(reference receiveRoutine :718, handleMsg :810, enter* :988-1615).

Differences from the reference are deliberate host-plane design choices,
not semantic changes:
  * Python threads + queue.Queue instead of goroutines/channels.
  * Gossip is a set of injected broadcast callbacks (the p2p reactor wires
    them; in-process tests wire nodes directly).
  * `decide_proposal` / `do_prevote` are overridable attributes for
    Byzantine tests, like the reference's function pointers
    (consensus/state.go:130-132).
Safety-critical semantics (locking rules, POL unlock bounds, WAL-then-act
ordering, fsync points, proposer selection) follow the reference exactly.

The port's departures from the JAX package's state machine:
  * the device follows the executor: ConsensusState(..., device=None)
    resolves `block_exec.device` (the package default when that is None)
    in the constructor, so with no CUDA and no device="cpu" it raises
    RuntimeError.  The vote pre-verify passes that device to
    scheduler.verify_items, which goes through the VerifyScheduler only
    when one is running on it and otherwise takes the direct path there.
    Below BATCH_MIN_VOTES, and below the batch verifier's host threshold,
    the JAX package's host policy stands.
  * a card fault is not a bad vote: a pre-verify launch that failed on
    the card (degrade.card_fault: a DeviceLaneError outside a chaos
    drill) leaves _preverify_votes, so no message of the batch is logged
    to the WAL or applied and no vote falls through to a host
    verify_signature.  Every other exception of the pre-verify is still
    swallowed, as the votes are peer-controlled.  The receive routine
    then ends through the consensus-failure path with the error kept on
    `device_error` and logged by name; a fresh ConsensusState over the
    same stores and WAL resumes.  A card fault in _finalize_commit's
    apply_block, or in on_start's WAL catch-up, ends the state machine
    the same way.  In a drill (libs.fail.armed()) the JAX package's
    behaviour holds.
  * a block whose part set completes is refused against the round's
    proposal only when the part set is the proposal's own.  The JAX
    package refuses any block that is not the proposal's; when +2/3
    prevotes for another block had replaced the part set, that refusal
    leaves a complete part set with no block, later copies of its parts
    are not added, and the node waits in COMMIT for good (found with 150
    nodes in one process; reference consensus/state.go
    addProposalBlockPart sets the block with no such check).
  * a stored WAL does not cross packages: its records are safe-codec
    pickles, which name their classes' modules.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from typing import Callable, List, Optional

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto.degrade import DeviceLaneError, card_fault
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.fail import fail_point
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import State as SMState
from tendermint_tpu_torch.types.basic import (
    BlockID, PartSetHeader, SignedMsgType, Timestamp)
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.commit import Commit
from tendermint_tpu_torch.types.part_set import Part, PartSet, make_block_parts
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import (
    ConflictingVoteError, VoteSet, VoteSetError)

from tendermint_tpu_torch.p2p import netobs

from . import observatory as obsv
from .config import ConsensusConfig
from .round_types import (
    BlockPartMessage, HeightVoteSet, ProposalMessage, RoundState, Step,
    TimeoutInfo, VoteMessage)
from tendermint_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES

from .ticker import TimeoutTicker
from .wal import WAL, EndHeightMessage, WALCorruptionError


class ConsensusState(BaseService):
    def __init__(self, config: ConsensusConfig, state: SMState,
                 block_exec: BlockExecutor, block_store, mempool=None,
                 evidence_pool=None, priv_validator=None, wal_path=None,
                 event_bus=None, name: str = "", metrics_registry=None,
                 device=None):
        super().__init__(name or "consensus")
        # the device the vote pre-verify launches on: the executor's
        # unless asked for another; resolved here, so with no CUDA and no
        # device="cpu" the state machine is not made
        self.device = resolve_device(block_exec.device if device is None
                                     else device)
        # the card fault that ended the receive routine (None while it runs)
        self.device_error: Optional[DeviceLaneError] = None
        from tendermint_tpu_torch.libs.metrics import ConsensusMetrics
        self.config = config
        self.metrics = ConsensusMetrics(metrics_registry)
        self._round_t0 = time.time()
        self._last_block_time = 0.0
        self.block_exec = block_exec
        self.block_store = block_store
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.priv_validator = priv_validator
        self.priv_pub_key = (priv_validator.get_pub_key()
                             if priv_validator else None)
        self.event_bus = event_bus
        self.name = name or "consensus"
        # the executor's apply stamps must land on the same observatory
        # node key this state machine stamps under (ADR-020)
        block_exec.obs_node = self.name
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("consensus").with_(node=name) if name \
            else tmlog.logger("consensus")

        self.rs = RoundState()
        self.state: Optional[SMState] = None

        self._peer_queue: "queue.Queue" = queue.Queue(maxsize=5000)
        self._internal_queue: "queue.Queue" = queue.Queue(maxsize=1000)
        # per-height memo of quorum stamps already taken (mutated only
        # under _mtx; cleared at every height transition) — post-quorum
        # vote storms skip the observatory entirely
        self._obs_stamped: set = set()
        # (height, monotonic proposal-accepted time) — the gossip SLO
        # latency anchor (ADR-025); None until the first proposal
        self._proposal_mono: Optional[tuple] = None
        self._ticker = TimeoutTicker(self._on_ticker_timeout)
        self._thread: Optional[threading.Thread] = None
        self._mtx = threading.RLock()

        self.wal = WAL(wal_path) if wal_path else None
        if self.wal is not None and os.path.getsize(self.wal.path) == 0:
            # fresh WAL: mark the height boundary we are starting from
            # (reference consensus/wal.go writes #ENDHEIGHT 0 on creation)
            self.wal.write_sync(EndHeightMessage(state.last_block_height))

        # broadcast hooks (wired by the reactor / test harness)
        self.broadcast_vote: List[Callable[[Vote], None]] = []
        self.broadcast_proposal: List[Callable[[Proposal], None]] = []
        self.broadcast_block_part: List[Callable[[int, int, Part], None]] = []
        self.on_committed: List[Callable[[Block], None]] = []

        # overridable for Byzantine tests (reference consensus/state.go:130)
        self.decide_proposal = self._default_decide_proposal
        self.do_prevote = self._default_do_prevote

        self._update_to_state(state)
        if state.last_block_height > 0:
            self._reconstruct_last_commit(state)

    def _reconstruct_last_commit(self, state: SMState):
        """Rebuild rs.last_commit as a VoteSet from the stored seen commit
        (reference consensus/state.go reconstructLastCommit +
        types/block.go:768 CommitToVoteSet) so a restarted node can propose
        at the next height."""
        seen = self.block_store.load_seen_commit(state.last_block_height)
        if seen is None or state.last_validators is None:
            return
        vs = VoteSet(state.chain_id, seen.height, seen.round,
                     SignedMsgType.PRECOMMIT, state.last_validators)
        for idx, cs_sig in enumerate(seen.signatures):
            if cs_sig.is_absent():
                continue
            vote = Vote(
                type=SignedMsgType.PRECOMMIT, height=seen.height,
                round=seen.round, block_id=cs_sig.block_id(seen.block_id),
                timestamp=cs_sig.timestamp,
                validator_address=cs_sig.validator_address,
                validator_index=idx, signature=cs_sig.signature)
            vs.add_vote(vote)
        if not vs.has_two_thirds_majority():
            raise RuntimeError("failed to reconstruct last commit")
        self.rs.last_commit = vs

    # ------------------------------------------------------------------ API

    def switch_to_consensus(self, state: SMState):
        """Adopt a blocksync-advanced state before starting (reference
        consensus/reactor.go:93 SwitchToConsensus -> updateToState)."""
        with self._mtx:
            self._update_to_state(state)
            if state.last_block_height > 0:
                self._reconstruct_last_commit(state)
        if self.wal is not None:
            self.wal.write_sync(EndHeightMessage(state.last_block_height))

    def on_start(self):
        if self.wal is not None:
            try:
                self._catchup_replay()
            except WALCorruptionError:
                raise  # repair/abort path: corrupted WAL is fatal
            except DeviceLaneError as e:
                if not card_fault(e):
                    raise
                # a launch failed on the card while a replayed block
                # applied: the card's fault, not the WAL's
                self._halt_on_card(e)
                raise
            except Exception as e:
                # reference consensus/state.go:330-332: non-corruption
                # catchup errors are logged and the state starts anyway
                # (e.g. a crash between block-save and the EndHeight
                # fsync leaves the WAL one marker behind the handshake-
                # recovered state; the handshake already applied the
                # block, so there is nothing left to replay)
                self.log.info("catchup replay error, proceeding to "
                              "start state anyway", err=str(e))
        # the receive-loop coalescer batch-verifies queued votes through
        # the device lane (_preverify_votes); observe breaker transitions
        # so the log shows when vote preverification degrades to the host
        # path and when the lane recovers (crypto/degrade.py)
        from tendermint_tpu_torch.crypto import degrade
        self._breaker_unsub = degrade.runtime().breaker.add_listener(
            self._on_breaker_transition)
        self._thread = self.spawn(self._receive_routine,
                                  name=f"consensus-{self.name}")
        self._schedule_round0()

    def _on_breaker_transition(self, old: str, new: str, reason: str):
        self.log.info("vote preverify device lane breaker transition",
                      **{"from": old}, to=new, reason=reason)

    def on_stop(self):
        if getattr(self, "_breaker_unsub", None) is not None:
            self._breaker_unsub()
            self._breaker_unsub = None
        self._ticker.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.wal is not None:
            self.wal.close()

    def add_vote(self, vote: Vote, peer_id: str = ""):
        """Thread-safe external entry (reactor/gossip)."""
        self._enqueue(VoteMessage(vote), peer_id)

    def set_proposal(self, proposal: Proposal, peer_id: str = ""):
        self._enqueue(ProposalMessage(proposal), peer_id)

    def add_block_part(self, height: int, round_: int, part: Part,
                       peer_id: str = ""):
        self._enqueue(BlockPartMessage(height, round_, part), peer_id)

    def get_round_state(self) -> RoundState:
        with self._mtx:
            return self.rs

    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _enqueue(self, msg, peer_id: str):
        if peer_id == "":
            self._internal_queue.put((msg, ""))
        else:
            try:
                self._peer_queue.put_nowait((msg, peer_id))
            except queue.Full:
                pass  # drop under backpressure (reference behavior)

    # --------------------------------------------------- receive routine

    # how many queued peer messages one loop iteration drains for the
    # coalescing window, and the minimum vote count worth a batch launch
    DRAIN_CAP = 2048
    BATCH_MIN_VOTES = 8

    def _receive_routine(self):
        while not self.quitting.is_set():
            try:
                batch = []  # [(msg, peer_id)] in arrival order
                # prioritize internal messages (own votes/proposals)
                try:
                    batch.append(self._internal_queue.get_nowait())
                except queue.Empty:
                    try:
                        batch.append(self._peer_queue.get(timeout=0.02))
                    except queue.Empty:
                        continue
                    # coalescing window (SURVEY §7 hard part 2): drain
                    # whatever ELSE is already waiting — zero added
                    # latency, natural batching under vote storms
                    while len(batch) < self.DRAIN_CAP:
                        try:
                            batch.append(self._peer_queue.get_nowait())
                        except queue.Empty:
                            break
                if len(batch) > 1:
                    self._preverify_votes(batch)
                with self._mtx:
                    for msg, peer_id in batch:
                        self._handle_msg(msg, peer_id)
                # observatory publication happens HERE, after the state
                # mutex releases: stamps taken while handling only
                # record (one leaf lock); histograms/SLO/gauges for
                # heights completed this iteration publish outside any
                # consensus-critical lock (the scheduler's PR 6
                # discipline, docs/adr/adr-020)
                obsv.publish_pending()
                # same hoist for the gossip observatory; the min
                # interval amortizes the registry walk across messages
                # (debug endpoints drain with 0 for a fresh read)
                netobs.publish_pending(min_interval_s=0.5)
            except DeviceLaneError as e:
                if not card_fault(e):
                    traceback.print_exc()
                else:
                    self._halt_on_card(e)
                self.quitting.set()
                return
            except Exception:  # noqa: BLE001 - consensus failure is fatal
                traceback.print_exc()
                # reference panics with "CONSENSUS FAILURE!!!"
                # (consensus/state.go:735): safety over availability.
                self.quitting.set()
                return

    def _halt_on_card(self, e: DeviceLaneError):
        """A launch failed on the card: keep the error and log it; the
        caller ends the receive routine (no vote of the batch counted
        invalid, no host re-verify)."""
        self.device_error = e
        self.log.error("consensus stopped on a card fault",
                       height=self.rs.height, err=str(e))

    def _preverify_votes(self, batch):
        """Verify every queued vote's signature in ONE batched launch and
        publish the valid ones to the signature cache, so the in-order
        apply below hits the cache instead of verifying serially
        (replaces the reference's per-vote verify at the consensus
        boundary, types/vote_set.go:121).  Attribution stays exact: an
        invalid vote simply misses the cache and fails the serial check."""
        votes = [m.vote for m, _ in batch if isinstance(m, VoteMessage)]
        if len(votes) < self.BATCH_MIN_VOTES:
            return
        with trace.span("consensus.preverify", queued=len(batch),
                        votes=len(votes)):
            self._preverify_votes_locked(votes)

    # how long a preverify submission may sit in the VerifyScheduler's
    # coalescing window before the deadline forces a flush: long enough
    # to coalesce with a concurrent light/blocksync batch, far below any
    # consensus timeout
    PREVERIFY_DEADLINE_S = 0.005

    def _preverify_votes_locked(self, votes):
        with self._mtx:
            state = self.state
            if state is None:
                return
            vals_now = state.validators
            vals_last = state.last_validators
            height = self.rs.height
            cur_votes = self.rs.votes
        items = []
        chain_id = state.chain_id
        seen = set()
        for v in votes:
            # every field here is peer-controlled and type-unchecked; a
            # malformed vote must fall through to the serial path's
            # rejection, never take down the receive loop
            try:
                # only votes the apply path will actually verify: current
                # height, or height-1 precommits entering last_commit
                if v.height == height:
                    vals = vals_now
                elif (v.height == height - 1
                        and v.type == SignedMsgType.PRECOMMIT):
                    vals = vals_last
                else:
                    continue
                if vals is None or not isinstance(v.validator_index, int) \
                        or not (0 <= v.validator_index < vals.size()):
                    continue
                _, val = vals.get_by_index(v.validator_index)
                if val is None or val.address != v.validator_address:
                    continue
                if not isinstance(v.round, int) or not 0 <= v.round < 4096:
                    continue
                # skip votes the set already holds (replay amplification)
                if (v.height == height and cur_votes is not None):
                    vs = (cur_votes.prevotes(v.round)
                          if v.type == SignedMsgType.PREVOTE
                          else cur_votes.precommits(v.round))
                    if vs is not None and vs.votes[v.validator_index] \
                            is not None:
                        continue
                key = (v.validator_index, v.signature)
                if key in seen:
                    continue
                seen.add(key)
                items.append((val.pub_key, v.sign_bytes(chain_id),
                              v.signature))
            except Exception:
                continue
        if items:
            try:
                # highest-priority class on the shared verify scheduler
                # (coalesces with concurrent light/blocksync batches in
                # one device launch); identical direct BatchVerifier
                # path on self.device when no scheduler runs there.  The
                # valid triples land in crypto.batch.verified_sigs and
                # the serial apply below hits the cache.
                from tendermint_tpu_torch.crypto import scheduler as vsched
                vsched.verify_items(
                    items, vsched.Priority.CONSENSUS,
                    deadline=time.monotonic() + self.PREVERIFY_DEADLINE_S,
                    device=self.device)
            except Exception as e:
                # any other failure: the votes take the serial path
                if card_fault(e):
                    raise  # the card's fault, not the votes'

    def _handle_msg(self, msg, peer_id: str):
        if self.wal is not None:
            if peer_id == "":
                self.wal.write_sync((msg, peer_id))  # :774 own msgs fsync
            else:
                self.wal.write((msg, peer_id))
        self._apply_msg(msg, peer_id)

    def _apply_msg(self, msg, peer_id: str):
        if isinstance(msg, VoteMessage):
            self._try_add_vote(msg.vote, peer_id)
        elif isinstance(msg, ProposalMessage):
            self._try_peer_msg(peer_id,
                               lambda: self._set_proposal(msg.proposal))
        elif isinstance(msg, BlockPartMessage):
            def _add_part_ignoring_stale_round():
                try:
                    self._add_proposal_block_part(msg, peer_id)
                except (VoteSetError, ValueError):
                    # A part from a different round than the current one can
                    # legitimately fail the proof check against the current
                    # round's part-set header (e.g. our own parts from round
                    # r queued behind a round change).  The reference
                    # squelches exactly this case (consensus/state.go:837-841
                    # "received block part from wrong round").
                    if msg.round != self.rs.round:
                        return
                    raise
            self._try_peer_msg(peer_id, _add_part_ignoring_stale_round)
        elif isinstance(msg, TimeoutInfo):
            self._handle_timeout(msg)
        else:
            raise ValueError(f"unknown msg type {type(msg)}")

    def _try_peer_msg(self, peer_id: str, fn):
        """Validation failures on peer-originated messages are the peer's
        fault, not an internal invariant violation: log and continue
        (reference handleMsg logs `err` and keeps running,
        consensus/state.go:810-860).  Internal messages re-raise — a bad
        own-proposal IS a consensus failure."""
        try:
            fn()
        except (VoteSetError, ValueError, TypeError, AttributeError,
                KeyError, IndexError, OverflowError) as e:
            # ProtoError subclasses ValueError; the extra types cover
            # type-confused fields in peer-supplied objects (the wire codec
            # guarantees wrapper classes, not field types).  RuntimeError is
            # deliberately NOT caught: internal invariant violations stay
            # fatal.
            if peer_id == "":
                raise
            # TODO: punish peer through the switch (reference StopPeerForError)
            self.log.error("bad message from peer", peer=peer_id,
                           err=str(e))

    def _on_ticker_timeout(self, ti: TimeoutInfo):
        self._internal_queue.put((ti, ""))

    def _schedule_timeout(self, duration: float, height: int, round_: int,
                          step: Step):
        self._ticker.schedule(TimeoutInfo(duration, height, round_, step))

    def _schedule_round0(self):
        sleep = max(self.rs.start_time - time.time(), 0.0)
        self._schedule_timeout(sleep, self.rs.height, 0, Step.NEW_HEIGHT)

    def _handle_timeout(self, ti: TimeoutInfo):
        rs = self.rs
        if (ti.height != rs.height or ti.round < rs.round
                or (ti.round == rs.round and ti.step < rs.step)):
            return  # stale timeout
        if ti.step == Step.NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == Step.NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif ti.step == Step.PROPOSE:
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == Step.PREVOTE_WAIT:
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == Step.PRECOMMIT_WAIT:
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)

    # --------------------------------------------------- state transitions

    def _update_to_state(self, state: SMState):
        """Prepare RoundState for the next height (reference
        updateToState :518-608)."""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height \
                and rs.height != state.last_block_height:
            raise RuntimeError(
                f"updateToState expected state height {rs.height}, got "
                f"{state.last_block_height}")

        # next desired block height
        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        last_precommits = None
        if rs.commit_round > -1 and rs.votes is not None:
            precommits = rs.votes.precommits(rs.commit_round)
            if not precommits.has_two_thirds_majority():
                raise RuntimeError("wanted to form a commit, but precommits "
                                   "lack majority")
            last_precommits = precommits

        validators = state.validators

        new_rs = RoundState()
        new_rs.height = height
        new_rs.round = 0
        new_rs.step = Step.NEW_HEIGHT
        if rs.commit_time:
            new_rs.start_time = rs.commit_time + self.config.commit()
        else:
            new_rs.start_time = time.time() + self.config.commit()
        new_rs.validators = validators
        new_rs.locked_round = -1
        new_rs.valid_round = -1
        new_rs.votes = HeightVoteSet(state.chain_id, height, validators)
        new_rs.commit_round = -1
        new_rs.last_commit = last_precommits
        self.rs = new_rs
        self.state = state
        # the height's lifecycle record opens here: everything from
        # this stamp to the commit stamp is the block interval the
        # observatory decomposes (consensus/observatory.py, ADR-020)
        self._obs_stamped.clear()
        obsv.stamp(self.name, height, "new_height")

    def _enter_new_round(self, height: int, round_: int):
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step != Step.NEW_HEIGHT)):
            return
        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round)
        self.metrics.height.set(height)
        self.metrics.rounds.set(round_)
        self.metrics.round_duration.observe(
            max(time.time() - self._round_t0, 0.0))
        self._round_t0 = time.time()
        self.log.debug("entering new round", height=height, round=round_)
        rs.round = round_
        rs.step = Step.NEW_ROUND
        rs.validators = validators
        if round_ != 0:
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)
        rs.triggered_timeout_precommit = False
        if self.event_bus is not None:
            self.event_bus.publish_new_round_step(height, round_, "NewRound")
        wait_for_txs = (self.config.wait_for_txs() and round_ == 0
                        and not self._need_proof_block(height))
        if wait_for_txs:
            if self.config.create_empty_blocks_interval > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval, height, round_,
                    Step.NEW_ROUND)
            self._maybe_wait_for_txs(height, round_)
        else:
            self._enter_propose(height, round_)

    def _maybe_wait_for_txs(self, height, round_):
        if self.mempool is not None and not self.mempool.is_empty():
            self._enter_propose(height, round_)

    def notify_txs_available(self):
        """Mempool callback: txs arrived while waiting (reference
        txNotifier)."""
        with self._mtx:
            rs = self.rs
            if rs.step == Step.NEW_ROUND:
                self._enter_propose(rs.height, rs.round)

    def _need_proof_block(self, height: int) -> bool:
        if height == self.state.initial_height:
            return True
        meta = self.block_store.load_block_meta(height - 1)
        return meta is None or self.state.app_hash != meta.header.app_hash

    def _enter_propose(self, height: int, round_: int):
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step >= Step.PROPOSE)):
            return
        rs.round = round_
        rs.step = Step.PROPOSE
        self._new_step()
        if obsv.is_enabled():
            obsv.stamp(self.name, height, "propose_start", round_=round_,
                       proposer=rs.validators.get_proposer().address.hex())
        self._schedule_timeout(self.config.propose(round_), height, round_,
                               Step.PROPOSE)
        if self.priv_validator is None or self.priv_pub_key is None:
            self._maybe_finish_propose(height, round_)
            return
        addr = self.priv_pub_key.address()
        if not rs.validators.has_address(addr):
            self._maybe_finish_propose(height, round_)
            return
        if rs.validators.get_proposer().address == addr:
            self.decide_proposal(height, round_)
        self._maybe_finish_propose(height, round_)

    def _maybe_finish_propose(self, height, round_):
        # If we already have a complete proposal, move on.
        if self._is_proposal_complete():
            self._enter_prevote(height, round_)

    def _default_decide_proposal(self, height: int, round_: int):
        """Reference defaultDecideProposal :1133, restructured as the
        proposer fast path (ADR-024): budgeted block creation
        (create_proposal_block), streaming part-set construction
        (types/part_set.py make_block_parts), and ONE per-part send
        loop — the proposal and part 0 reach gossip while later parts'
        merkle proofs are still unextracted."""
        rs = self.rs
        created = rs.valid_block is None
        if not created:
            block, parts = rs.valid_block, rs.valid_block_parts
        else:
            commit = self._commit_for_proposal(height)
            if commit is None:
                return
            c = self.config
            block = self.block_exec.create_proposal_block(
                height, self.state, commit, self.priv_pub_key.address(),
                reap_budget_s=(c.propose_reap_budget_ms / 1e3
                               if c.propose_reap_budget_ms else None),
                prepare_budget_s=(c.propose_prepare_budget_ms / 1e3
                                  if c.propose_prepare_budget_ms else None),
                max_bytes_cap=c.propose_max_bytes or None)
            parts = make_block_parts(block)
        block_id = BlockID(block.hash(), parts.header())
        proposal = Proposal(height=height, round=round_,
                            pol_round=rs.valid_round, block_id=block_id,
                            timestamp=Timestamp.now())
        try:
            # use the returned message: a remote signer (SignerClient)
            # hands back a signed COPY, not the mutated original
            proposal = self.priv_validator.sign_proposal(
                self.state.chain_id, proposal)
        except Exception:
            return
        # proposal first (internal + gossip: peers drop parts for an
        # unknown proposal), then parts ride one loop — internal queue
        # put and every broadcast hook per part, in index order — so
        # each part ships the moment its proof exists.  The seed code
        # iterated parts.get_part(i) once per destination and re-called
        # parts.header() per iteration.
        self._internal_queue.put((ProposalMessage(proposal), ""))
        for fn in self.broadcast_proposal:
            fn(proposal)
        total = parts.header().total
        streamed = not isinstance(parts, PartSet)
        t_split = time.perf_counter()
        with trace.span("propose.split", parts=total, height=height):
            first = True
            for part in parts.iter_parts():
                self._internal_queue.put(
                    (BlockPartMessage(height, round_, part), ""))
                for fn in self.broadcast_block_part:
                    fn(height, round_, part)
                if first:
                    first = False
                    obsv.stamp(self.name, height, "first_part_out",
                               round_=round_)
        split_s = time.perf_counter() - t_split
        m = self.block_exec.metrics
        m.proposal_create_seconds.observe(split_s, stage="split")
        m.parts_streamed_total.inc(
            total, path="streaming" if streamed else "serial")
        # the propose decomposition rides proposal_signed's info attrs
        # (reap/prepare/assemble from the executor's last create, split
        # measured here) — only for a block created THIS round; a
        # reproposed valid block has no create stages
        timings = dict(self.block_exec.last_propose_timings) if created \
            else {}
        timings["split_s"] = round(split_s, 6)
        obsv.stamp(self.name, height, "proposal_signed", round_=round_,
                   parts_total=total, **timings)

    def _commit_for_proposal(self, height: int) -> Optional[Commit]:
        if height == self.state.initial_height:
            return Commit(0, 0, BlockID(), [])
        if (self.rs.last_commit is not None
                and self.rs.last_commit.has_two_thirds_majority()):
            return self.rs.last_commit.make_commit()
        return None

    def _is_proposal_complete(self) -> bool:
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        return rs.votes.prevotes(rs.proposal.pol_round).has_two_thirds_any()

    # -- proposal handling (reference :1833-1998) --------------------------

    def _set_proposal(self, proposal: Proposal):
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (
                proposal.pol_round >= 0
                and proposal.pol_round >= proposal.round):
            raise VoteSetError("invalid proposal POLRound")
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify_signature(
                proposal.sign_bytes(self.state.chain_id), proposal.signature):
            raise VoteSetError("invalid proposal signature")
        # DoS bound: the part-set total a proposal commits to must fit the
        # consensus block-size limit (reference consensus/state.go:1862 via
        # PartSetHeader + addProposalBlockPart ByteSize check :1932) — else
        # a Byzantine proposer allocates total*64KB on every honest node.
        psh = proposal.block_id.part_set_header
        max_bytes = self.state.consensus_params.block.max_bytes
        max_parts = (max_bytes + BLOCK_PART_SIZE_BYTES - 1) \
            // BLOCK_PART_SIZE_BYTES
        if psh.total < 1 or psh.total > max_parts:
            raise VoteSetError(
                f"proposal part-set total {psh.total} outside [1, {max_parts}]")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(psh)
        # anchor for the [slo] gossip stream: useful part receipts for
        # THIS height measure their latency from proposal acceptance
        # (netobs.gossip_receipt below)
        self._proposal_mono = (rs.height, time.monotonic())
        ts = proposal.timestamp
        obsv.stamp(self.name, rs.height, "proposal", round_=rs.round,
                   proposal_ts=ts.seconds + ts.nanos * 1e-9,
                   proposal_round=rs.round)

    def _add_proposal_block_part(self, msg: BlockPartMessage, peer_id: str):
        rs = self.rs
        if msg.height != rs.height:
            return
        if rs.proposal_block_parts is None:
            return
        added = rs.proposal_block_parts.add_part(msg.part)
        if peer_id:
            # duplicate-waste accounting (ADR-025): the part-set's
            # verdict IS the useful/duplicate bit; useful receipts also
            # carry the proposal -> part latency into the [slo] gossip
            # stream and the first-useful attribution join
            lat = None
            if added and self._proposal_mono is not None \
                    and self._proposal_mono[0] == rs.height:
                lat = time.monotonic() - self._proposal_mono[1]
            netobs.gossip_receipt(self.name, peer_id, "part",
                                  useful=added, latency_s=lat)
            if added:
                obsv.useful_receipt(self.name, rs.height, "part",
                                    peer_id)
        if not added:
            return
        if peer_id:
            # reference consensus/metrics.go BlockParts: counted when
            # the part is actually ADDED, per delivering peer — a
            # replayed duplicate or wrong-height part moves nothing
            self.metrics.block_parts.inc(peer_id=peer_id)
        if ("first_part",) not in self._obs_stamped:
            # one-shot via the same memo the quorum stamps use: parts
            # 2..N of a block must not pay even the leaf lock
            self._obs_stamped.add(("first_part",))
            obsv.stamp(self.name, rs.height, "first_part",
                       round_=msg.round)
        if (rs.proposal_block_parts.byte_size
                > self.state.consensus_params.block.max_bytes):
            raise ValueError(
                f"total size of proposal block parts exceeds maximum "
                f"({self.state.consensus_params.block.max_bytes})")
        if rs.proposal_block_parts.is_complete():
            obsv.stamp(self.name, rs.height, "parts_complete",
                       round_=msg.round)
            data = rs.proposal_block_parts.assemble()
            block = Block.from_proto(data)
            # only the proposal's own part set answers to its block id; a
            # part set that +2/3 prevotes or precommits put in its place
            # answers to theirs, which the commit path checks
            if (rs.proposal is not None
                    and rs.proposal_block_parts.has_header(
                        rs.proposal.block_id.part_set_header)
                    and block.hash() != rs.proposal.block_id.hash):
                raise ValueError("proposal block hash mismatch")
            rs.proposal_block = block
            if self.event_bus is not None:
                self.event_bus.publish_complete_proposal(
                    rs.height, rs.round, rs.proposal.block_id
                    if rs.proposal else None)
            self._handle_complete_proposal(rs.height)

    def _handle_complete_proposal(self, height: int):
        """Reference handleCompleteProposal :1967."""
        rs = self.rs
        prevotes = rs.votes.prevotes(rs.round)
        block_id, has_maj = prevotes.two_thirds_majority()
        if (has_maj and not rs.proposal_block.hash() is None
                and rs.valid_round < rs.round
                and block_id is not None and not block_id.is_zero()
                and rs.proposal_block.hash() == block_id.hash):
            rs.valid_round = rs.round
            rs.valid_block = rs.proposal_block
            rs.valid_block_parts = rs.proposal_block_parts
        if rs.step <= Step.PROPOSE and self._is_proposal_complete():
            self._enter_prevote(height, rs.round)
            if has_maj:
                self._enter_precommit(height, rs.round)
        elif rs.step == Step.COMMIT:
            self._try_finalize_commit(height)

    # -- prevote (reference :1248-1346) ------------------------------------

    def _enter_prevote(self, height: int, round_: int):
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step >= Step.PREVOTE)):
            return
        self.do_prevote(height, round_)
        rs.round = round_
        rs.step = Step.PREVOTE
        self._new_step()

    def _default_do_prevote(self, height: int, round_: int):
        rs = self.rs
        if rs.locked_block is not None:
            self._sign_add_vote(SignedMsgType.PREVOTE,
                                rs.locked_block.hash(),
                                rs.locked_block_parts.header())
            return
        if rs.proposal_block is None:
            self._sign_add_vote(SignedMsgType.PREVOTE, b"", PartSetHeader())
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except Exception:
            self._sign_add_vote(SignedMsgType.PREVOTE, b"", PartSetHeader())
            return
        if not self.block_exec.process_proposal(rs.proposal_block, self.state):
            self._sign_add_vote(SignedMsgType.PREVOTE, b"", PartSetHeader())
            return
        self._sign_add_vote(SignedMsgType.PREVOTE, rs.proposal_block.hash(),
                            rs.proposal_block_parts.header())

    def _enter_prevote_wait(self, height: int, round_: int):
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step >= Step.PREVOTE_WAIT)):
            return
        if not rs.votes.prevotes(round_).has_two_thirds_any():
            raise RuntimeError("enter_prevote_wait without 2/3 any prevotes")
        rs.round = round_
        rs.step = Step.PREVOTE_WAIT
        self._new_step()
        self._schedule_timeout(self.config.prevote(round_), height, round_,
                               Step.PREVOTE_WAIT)

    # -- precommit (reference :1370-1530) ----------------------------------

    def _enter_precommit(self, height: int, round_: int):
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step >= Step.PRECOMMIT)):
            return

        block_id, has_maj = rs.votes.prevotes(round_).two_thirds_majority()

        def finish():
            rs.round = round_
            rs.step = Step.PRECOMMIT
            self._new_step()

        if not has_maj:
            self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
            finish()
            return

        # +2/3 prevoted nil: unlock and precommit nil
        if block_id.is_zero():
            if rs.locked_block is not None:
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
            self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
            finish()
            return

        # already locked on this block: relock
        if (rs.locked_block is not None
                and rs.locked_block.hash() == block_id.hash):
            rs.locked_round = round_
            self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id.hash,
                                block_id.part_set_header)
            finish()
            return

        # polka for our proposal block: lock and precommit
        if (rs.proposal_block is not None
                and rs.proposal_block.hash() == block_id.hash):
            self.block_exec.validate_block(self.state, rs.proposal_block)
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id.hash,
                                block_id.part_set_header)
            finish()
            return

        # polka for a block we don't have: unlock, fetch, precommit nil
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if (rs.proposal_block_parts is None or
                not rs.proposal_block_parts.has_header(
                    block_id.part_set_header)):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet(block_id.part_set_header)
        self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
        finish()

    def _enter_precommit_wait(self, height: int, round_: int):
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.triggered_timeout_precommit)):
            return
        if not rs.votes.precommits(round_).has_two_thirds_any():
            raise RuntimeError(
                "enter_precommit_wait without 2/3 any precommits")
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(self.config.precommit(round_), height, round_,
                               Step.PRECOMMIT_WAIT)

    # -- commit (reference :1524-1733) -------------------------------------

    def _enter_commit(self, height: int, commit_round: int):
        rs = self.rs
        if rs.height != height or rs.step >= Step.COMMIT:
            return
        block_id, has_maj = rs.votes.precommits(
            commit_round).two_thirds_majority()
        if not has_maj or block_id.is_zero():
            raise RuntimeError("enter_commit without +2/3 block precommits")
        rs.step = Step.COMMIT
        rs.commit_round = commit_round
        rs.commit_time = time.time()
        self._new_step()
        obsv.stamp(self.name, height, "commit", round_=commit_round)

        if rs.locked_block is not None \
                and rs.locked_block.hash() == block_id.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if (rs.proposal_block is None
                or rs.proposal_block.hash() != block_id.hash):
            if (rs.proposal_block_parts is None
                    or not rs.proposal_block_parts.has_header(
                        block_id.part_set_header)):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(block_id.part_set_header)
                return  # wait for parts
        self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int):
        rs = self.rs
        if rs.height != height:
            return
        block_id, has_maj = rs.votes.precommits(
            rs.commit_round).two_thirds_majority()
        if not has_maj or block_id is None or block_id.is_zero():
            return
        if (rs.proposal_block is None
                or rs.proposal_block.hash() != block_id.hash):
            return  # don't have the block yet
        self._finalize_commit(height)

    def _finalize_commit(self, height: int):
        rs = self.rs
        if rs.height != height or rs.step != Step.COMMIT:
            return
        with trace.span("consensus.finalize_commit", height=height,
                        round=rs.commit_round):
            self._finalize_commit_locked(height)

    def _finalize_commit_locked(self, height: int):
        rs = self.rs
        block_id, _ = rs.votes.precommits(rs.commit_round) \
            .two_thirds_majority()
        block, parts = rs.proposal_block, rs.proposal_block_parts
        self.block_exec.validate_block(self.state, block)
        fail_point(10)

        # save block with seen commit
        if self.block_store.height() < block.header.height:
            seen_commit = rs.votes.precommits(rs.commit_round).make_commit()
            self.block_store.save_block(block, parts, seen_commit)
        fail_point(11)

        if self.wal is not None:
            self.wal.write_sync(EndHeightMessage(height))  # :1683 fsync
        fail_point(12)

        state_copy = self.state.copy()
        new_state, _ = self.block_exec.apply_block(
            state_copy, block_id, block)
        from tendermint_tpu_torch.libs.log import Lazy
        self.log.info("finalized block", height=height,
                      round=rs.commit_round, txs=len(block.data.txs),
                      hash=Lazy(block.hash))  # lazy: reference state.go:1647

        m = self.metrics  # reference consensus/metrics.go recordMetrics
        m.num_txs.set(len(block.data.txs))
        m.total_txs.inc(len(block.data.txs))
        m.commit_round.set(rs.commit_round)
        m.validators.set(rs.validators.size())
        m.validators_power.set(rs.validators.total_voting_power())
        m.block_size_bytes.set(sum(len(t) for t in block.data.txs))
        bt = block.header.time.seconds + block.header.time.nanos * 1e-9
        if self._last_block_time:
            m.block_interval.observe(max(bt - self._last_block_time, 0.0))
        self._last_block_time = bt

        for fn in self.on_committed:
            fn(block)

        # next height
        self._update_to_state(new_state)
        self._schedule_round0()

    # -- votes (reference :2003-2293) --------------------------------------

    def _try_add_vote(self, vote: Vote, peer_id: str):
        # vote receipt: the causal start of the vote -> verify -> commit
        # timeline (the serial apply after the coalesced preverify; a
        # SigCache hit here means the batched launch already paid the
        # signature check)
        trace.instant("consensus.vote", height=vote.height,
                      round=vote.round, index=vote.validator_index,
                      peer=bool(peer_id))
        try:
            self._add_vote(vote, peer_id)
        except ConflictingVoteError as e:
            if self.evidence_pool is not None and peer_id != "":
                self.evidence_pool.report_conflicting_votes(e.vote_a, e.vote_b)
            if vote.height == self.rs.height:
                return  # evidence reported; carry on
            raise
        except (VoteSetError, ValueError):
            if peer_id == "":
                raise  # own vote must never fail
            # bad peer vote: ignore (reactor handles punishment)

    def _add_vote(self, vote: Vote, peer_id: str):
        rs = self.rs
        # late precommit from previous height while in NewHeight step
        if (vote.height + 1 == rs.height
                and vote.type == SignedMsgType.PRECOMMIT):
            if rs.step != Step.NEW_HEIGHT:
                return
            # last_commit tracks ONLY the round that committed; a late
            # precommit from another round of that height (e.g. our own
            # round-0 precommit still in the internal queue after a
            # round-1 commit) is legal consensus noise, not an error —
            # the reference's LastCommit.AddVote refuses it without
            # killing anything (consensus/state.go:2221, types/
            # vote_set.go AddVote round check)
            if (rs.last_commit is not None
                    and vote.round == rs.last_commit.round):
                added = rs.last_commit.add_vote(vote)
                if added and self.config.skip_timeout_commit \
                        and rs.last_commit.has_all():
                    self._enter_new_round(rs.height, 0)
            return
        if vote.height != rs.height:
            return

        added = rs.votes.add_vote(vote, peer_id)
        if peer_id:
            # duplicate-waste accounting (ADR-025): own votes
            # (peer_id="") are not gossip and stay out of the ledger
            netobs.gossip_receipt(self.name, peer_id, "vote",
                                  useful=added)
            if added:
                obsv.useful_receipt(self.name, vote.height, "vote",
                                    peer_id)
        if not added:
            return
        if self.event_bus is not None:
            self.event_bus.publish_vote(vote)

        height = rs.height
        # quorum stamps: stamp() is first-write-wins per stage, so the
        # vote that tips 2/3 records exactly once (with ITS wall
        # timestamp — the reference QuorumPrevoteDelay origin
        # semantics).  _obs_stamped memoizes per (kind, round) under
        # the state mutex so the storm of post-quorum votes skips even
        # the observatory's leaf lock
        obs_on = obsv.is_enabled()
        if vote.type == SignedMsgType.PREVOTE:
            prevotes = rs.votes.prevotes(vote.round)
            block_id, has_maj = prevotes.two_thirds_majority()
            if obs_on and ("pv_any", vote.round) not in \
                    self._obs_stamped and prevotes.has_two_thirds_any():
                self._obs_stamped.add(("pv_any", vote.round))
                obsv.stamp(self.name, height, "prevote_any",
                           round_=vote.round)
            if obs_on and has_maj and not block_id.is_zero() \
                    and ("pv_q", vote.round) not in self._obs_stamped:
                self._obs_stamped.add(("pv_q", vote.round))
                ts = vote.timestamp
                if obsv.stamp(self.name, height, "prevote_quorum",
                              round_=vote.round,
                              prevote_quorum_ts=ts.seconds
                              + ts.nanos * 1e-9,
                              prevote_quorum_round=vote.round):
                    trace.instant("consensus.quorum", type="prevote",
                                  height=height, round=vote.round)
            if has_maj:
                # POL unlock (reference :2130-2147)
                if (rs.locked_block is not None
                        and rs.locked_round < vote.round <= rs.round
                        and rs.locked_block.hash() != block_id.hash):
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                # update valid block (reference :2149-2177)
                if (not block_id.is_zero() and rs.valid_round < vote.round
                        and vote.round == rs.round):
                    if (rs.proposal_block is not None
                            and rs.proposal_block.hash() == block_id.hash):
                        rs.valid_round = vote.round
                        rs.valid_block = rs.proposal_block
                        rs.valid_block_parts = rs.proposal_block_parts
                    else:
                        rs.proposal_block = None
                    if (rs.proposal_block_parts is None
                            or not rs.proposal_block_parts.has_header(
                                block_id.part_set_header)):
                        rs.proposal_block_parts = PartSet(
                            block_id.part_set_header)
            if rs.round < vote.round and prevotes.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
            elif rs.round == vote.round and rs.step >= Step.PREVOTE:
                block_id, has_maj = prevotes.two_thirds_majority()
                if has_maj and (self._is_proposal_complete()
                                or block_id.is_zero()):
                    self._enter_precommit(height, vote.round)
                elif prevotes.has_two_thirds_any():
                    self._enter_prevote_wait(height, vote.round)
            elif (rs.proposal is not None
                  and 0 <= rs.proposal.pol_round == vote.round):
                if self._is_proposal_complete():
                    self._enter_prevote(height, rs.round)

        elif vote.type == SignedMsgType.PRECOMMIT:
            precommits = rs.votes.precommits(vote.round)
            block_id, has_maj = precommits.two_thirds_majority()
            if obs_on and has_maj and not block_id.is_zero() \
                    and ("pc_q", vote.round) not in self._obs_stamped:
                self._obs_stamped.add(("pc_q", vote.round))
                if obsv.stamp(self.name, height, "precommit_quorum",
                              round_=vote.round):
                    trace.instant("consensus.quorum", type="precommit",
                                  height=height, round=vote.round)
            if has_maj:
                self._enter_new_round(height, vote.round)
                self._enter_precommit(height, vote.round)
                if not block_id.is_zero():
                    self._enter_commit(height, vote.round)
                    if self.config.skip_timeout_commit \
                            and precommits.has_all():
                        self._enter_new_round(self.rs.height, 0)
                else:
                    self._enter_precommit_wait(height, vote.round)
            elif rs.round <= vote.round and precommits.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
                self._enter_precommit_wait(height, vote.round)
        else:
            raise ValueError(f"unexpected vote type {vote.type}")

    def _sign_add_vote(self, msg_type: SignedMsgType, hash_: bytes,
                       header: PartSetHeader):
        if self.priv_validator is None or self.priv_pub_key is None:
            return
        rs = self.rs
        addr = self.priv_pub_key.address()
        if not rs.validators.has_address(addr):
            return
        if self.wal is not None:
            self.wal.flush_and_sync()
        idx, _ = rs.validators.get_by_address(addr)
        vote = Vote(
            type=msg_type, height=rs.height, round=rs.round,
            block_id=BlockID(hash_, header),
            timestamp=self._vote_time(),
            validator_address=addr, validator_index=idx)
        try:
            vote = self.priv_validator.sign_vote(self.state.chain_id, vote)
        except Exception:
            return
        self._internal_queue.put((VoteMessage(vote), ""))
        for fn in self.broadcast_vote:
            fn(vote)

    def _vote_time(self) -> Timestamp:
        """Reference consensus/state.go voteTime: BFT-time monotonicity —
        a vote's timestamp must exceed the block time it votes on by at
        least ConsensusParams.Block.TimeIotaMs."""
        now = Timestamp.now()
        rs = self.rs
        iota_ms = max(self.state.consensus_params.block.time_iota_ms, 1)
        min_time = None
        if rs.locked_block is not None:
            min_time = rs.locked_block.header.time.add_ms(iota_ms)
        elif rs.proposal_block is not None:
            min_time = rs.proposal_block.header.time.add_ms(iota_ms)
        if min_time is not None and now < min_time:
            return min_time
        return now

    def _new_step(self):
        # flight-recorder marker for every consensus step transition —
        # the timeline's backbone: everything between two step markers
        # belongs to the earlier step (docs/adr/adr-011)
        trace.instant("consensus.step", step=self.rs.step.name,
                      height=self.rs.height, round=self.rs.round)
        if self.event_bus is not None:
            self.event_bus.publish_new_round_step(
                self.rs.height, self.rs.round, self.rs.step.name)

    # -- WAL replay (reference :299-368, catchupReplay) --------------------

    def _catchup_replay(self):
        height = self.rs.height
        if WAL.search_for_end_height(self.wal.path, height):
            # we already fully processed this height?! corrupted state
            raise RuntimeError(
                f"WAL should not contain EndHeight {height}")
        msgs, found = WAL.messages_after_end_height(self.wal.path, height - 1)
        if not found:
            raise RuntimeError(
                f"cannot replay height {height}: WAL does not contain "
                f"EndHeight for {height - 1}")
        for msg, peer_id in msgs:
            if isinstance(msg, TimeoutInfo):
                continue  # timeouts are not replayed (reference behavior)
            self._apply_msg(msg, peer_id or "replay")
