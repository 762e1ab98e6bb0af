"""VoteSet (reference types/vote_set.go).

Accumulates one (height, round, type) of votes, 1:1 with the validator set;
detects 2/3 majorities and conflicting votes (equivocation evidence).

Live votes are latency-sensitive and arrive one at a time under the
consensus lock (reference types/vote_set.go:143), so single verification
happens at add time on the host; the card's batch plane handles whole-commit
and replay verification (types/validator_set.py, SURVEY.md §3.6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.libs.bits import BitArray

from .basic import BlockID, SignedMsgType
from .commit import Commit
from .validator_set import ValidatorSet
from .vote import Vote

MAX_VOTES_COUNT = 10000  # DoS cap (reference types/vote_set.go:18)


class VoteSetError(Exception):
    pass


class ConflictingVoteError(VoteSetError):
    """Equivocation: same validator, same (H,R,S), different block."""

    def __init__(self, existing: Vote, new: Vote):
        super().__init__(
            f"conflicting votes from validator "
            f"{new.validator_address.hex()}")
        self.vote_a = existing
        self.vote_b = new


@dataclass
class _BlockVotes:
    peer_maj23: bool
    bit_array: BitArray
    votes: List[Optional[Vote]]
    sum: int = 0

    @classmethod
    def new(cls, peer_maj23: bool, num_validators: int) -> "_BlockVotes":
        return cls(peer_maj23, BitArray(num_validators),
                   [None] * num_validators, 0)

    def add_verified_vote(self, vote: Vote, voting_power: int):
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int,
                 signed_msg_type: SignedMsgType, val_set: ValidatorSet):
        if height == 0:
            raise ValueError("cannot make VoteSet for height == 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.votes_bit_array = BitArray(val_set.size())
        self.votes: List[Optional[Vote]] = [None] * val_set.size()
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: Dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: Dict[str, BlockID] = {}

    def size(self) -> int:
        return self.val_set.size()

    # -- adding votes (reference :143-301) ---------------------------------

    def add_vote(self, vote: Optional[Vote]) -> bool:
        """Returns True if the vote was added; raises on invalid votes or
        equivocation (ConflictingVoteError carries both votes)."""
        if vote is None:
            raise VoteSetError("nil vote")
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0:
            raise VoteSetError("vote has negative validator index")
        if not val_addr:
            raise VoteSetError("vote has empty validator address")
        if (vote.height != self.height or vote.round != self.round
                or vote.type != self.signed_msg_type):
            raise VoteSetError(
                f"expected {self.height}/{self.round}/{self.signed_msg_type}, "
                f"got {vote.height}/{vote.round}/{vote.type}")

        # ensure the validator index matches the address
        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            raise VoteSetError(
                f"validator index {val_index} out of range")
        if lookup_addr != val_addr:
            raise VoteSetError(
                "validator address does not match index")

        # dedup: exact same vote already present?
        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False  # duplicate
            raise VoteSetError("duplicate vote with different signature")

        # verify signature (single-item host path)
        if not vote.verify(self.chain_id, val.pub_key):
            raise VoteSetError(
                f"invalid signature from {val_addr.hex()}")

        return self._add_verified_vote(vote, block_key, val.voting_power)

    def _get_vote(self, val_index: int, block_key: bytes) -> Optional[Vote]:
        v = self.votes[val_index]
        if v is not None and v.block_id.key() == block_key:
            return v
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def _add_verified_vote(self, vote: Vote, block_key: bytes,
                           voting_power: int) -> bool:
        val_index = vote.validator_index
        conflicting: Optional[Vote] = None

        existing = self.votes[val_index]
        if existing is None:
            # first vote from this validator
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += voting_power
        elif existing.block_id == vote.block_id:
            raise VoteSetError("duplicate vote (already handled)")
        else:
            conflicting = existing
            # replace the canonical vote only if the new one is for the
            # established 2/3-majority block (reference
            # types/vote_set.go:252-256)
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[val_index] = vote
                self.votes_bit_array.set_index(val_index, True)

        bv = self.votes_by_block.get(block_key)
        if bv is None:
            if conflicting is not None and not self._tracking(block_key):
                # nothing to do: conflict without peer claim is not tracked
                raise ConflictingVoteError(conflicting, vote)
            bv = _BlockVotes.new(False, self.size())
            self.votes_by_block[block_key] = bv
        elif conflicting is not None and not bv.peer_maj23:
            raise ConflictingVoteError(conflicting, vote)

        old_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, voting_power)

        # maj23 transition?
        if old_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            # promote this block's votes to canonical
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v

        if conflicting is not None:
            raise ConflictingVoteError(conflicting, vote)
        return True

    def _tracking(self, block_key: bytes) -> bool:
        for bid in self.peer_maj23s.values():
            if bid.key() == block_key:
                return True
        return False

    def set_peer_maj23(self, peer_id: str, block_id: BlockID):
        """A peer claims 2/3 for block_id: start tracking its votes
        (reference :309-347)."""
        block_key = block_id.key()
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing == block_id:
                return
            raise VoteSetError("setPeerMaj23: conflicting claims from peer")
        self.peer_maj23s[peer_id] = block_id
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self.votes_by_block[block_key] = _BlockVotes.new(True, self.size())

    # -- queries (reference :400-500) --------------------------------------

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]

    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        bv = self.votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv is not None else None

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def two_thirds_majority(self) -> Tuple[Optional[BlockID], bool]:
        if self.maj23 is not None:
            return self.maj23, True
        return None, False

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    # -- commit construction (reference :617-661) --------------------------

    def make_commit(self) -> Commit:
        from .commit import CommitSig
        if self.signed_msg_type != SignedMsgType.PRECOMMIT:
            raise VoteSetError("cannot MakeCommit() unless VoteSet.Type is "
                               "PRECOMMIT")
        if self.maj23 is None or self.maj23.is_zero():
            raise VoteSetError("cannot MakeCommit() unless a blockhash has "
                               "+2/3")
        sigs = []
        for i, v in enumerate(self.votes):
            # only include precommits for the winning block or nil
            if v is not None and (v.block_id == self.maj23 or v.is_nil()):
                sigs.append(v.commit_sig())
            else:
                sigs.append(CommitSig.absent())
        return Commit(self.height, self.round, self.maj23, sigs)
