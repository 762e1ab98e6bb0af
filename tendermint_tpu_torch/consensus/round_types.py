"""Round state types (reference consensus/types/round_state.go,
height_vote_set.go)."""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tendermint_tpu_torch.types.basic import BlockID, SignedMsgType, Timestamp
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.part_set import Part, PartSet
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import VoteSet


class Step(enum.IntEnum):
    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


@dataclass
class TimeoutInfo:
    duration: float
    height: int
    round: int
    step: Step


@dataclass
class ProposalMessage:
    proposal: Proposal


@dataclass
class BlockPartMessage:
    height: int
    round: int
    part: Part


@dataclass
class VoteMessage:
    vote: Vote


class HeightVoteSet:
    """All rounds' prevote/precommit sets for one height (reference
    consensus/types/height_vote_set.go:41).  Tracks rounds 0..round+1 plus
    peer-triggered catchup rounds."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.round = 0
        self._prevotes: Dict[int, VoteSet] = {}
        self._precommits: Dict[int, VoteSet] = {}
        self._peer_catchup_rounds: Dict[str, List[int]] = {}
        self._lock = threading.RLock()
        self._add_round(0)
        self._add_round(1)

    def _add_round(self, round_: int):
        if round_ in self._prevotes:
            return
        self._prevotes[round_] = VoteSet(
            self.chain_id, self.height, round_, SignedMsgType.PREVOTE,
            self.val_set)
        self._precommits[round_] = VoteSet(
            self.chain_id, self.height, round_, SignedMsgType.PRECOMMIT,
            self.val_set)

    def set_round(self, round_: int):
        with self._lock:
            new_round = max(round_ - 1, 0)
            if self.round != 0 and round_ < self.round:
                raise ValueError("set_round must increment round")
            for r in range(new_round, round_ + 2):
                self._add_round(r)
            self.round = round_

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """Returns added; raises VoteSetError/ConflictingVoteError."""
        with self._lock:
            if not self._is_round_tracked(vote.round):
                if peer_id:
                    rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
                    if len(rounds) >= 2:
                        raise ValueError(
                            "peer has sent a vote for multiple extra rounds")
                    rounds.append(vote.round)
                    self._add_round(vote.round)
                else:
                    raise ValueError("unexpected round in own vote")
            vs = self._vote_set(vote.round, vote.type)
            return vs.add_vote(vote)

    def _is_round_tracked(self, round_: int) -> bool:
        return round_ in self._prevotes

    def _vote_set(self, round_: int, vtype: SignedMsgType) -> VoteSet:
        self._add_round(round_)
        return (self._prevotes if vtype == SignedMsgType.PREVOTE
                else self._precommits)[round_]

    def prevotes(self, round_: int) -> VoteSet:
        with self._lock:
            return self._vote_set(round_, SignedMsgType.PREVOTE)

    def precommits(self, round_: int) -> VoteSet:
        with self._lock:
            return self._vote_set(round_, SignedMsgType.PRECOMMIT)

    def pol_info(self):
        """(round, blockID) of the most recent polka, or (-1, None)."""
        with self._lock:
            for r in sorted(self._prevotes, reverse=True):
                bid, ok = self._prevotes[r].two_thirds_majority()
                if ok:
                    return r, bid
            return -1, None

    def set_peer_maj23(self, round_: int, vtype: SignedMsgType,
                       peer_id: str, block_id: BlockID):
        with self._lock:
            self._add_round(round_)
            self._vote_set(round_, vtype).set_peer_maj23(peer_id, block_id)


@dataclass
class RoundState:
    """Snapshot of consensus internal state (reference
    consensus/types/round_state.go:67)."""
    height: int = 0
    round: int = 0
    step: Step = Step.NEW_HEIGHT
    start_time: float = 0.0
    commit_time: float = 0.0
    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    triggered_timeout_precommit: bool = False
