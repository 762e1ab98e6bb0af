"""Evidence types (reference types/evidence.go).

Two kinds at v0.34 parity: DuplicateVoteEvidence (equivocation caught by
consensus) and LightClientAttackEvidence (conflicting header caught by the
light client's witness detector).  Hashing/merkle inclusion is over the
canonical proto encoding, so evidence identity is wire-stable across nodes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.crypto.merkle import hash_from_byte_slices
from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.libs.safe_codec import register

from .basic import Timestamp
from .light_block import LightBlock
from .validator import Validator
from .vote import Vote


class EvidenceError(Exception):
    pass


class Evidence:
    """Common interface (reference types/evidence.go:23-35)."""

    def height(self) -> int:
        raise NotImplementedError

    def abci(self) -> list:
        """This evidence as abci.Misbehavior records for BeginBlock
        (reference types/evidence.go ABCI())."""
        raise NotImplementedError

    def time(self) -> Timestamp:
        raise NotImplementedError

    def bytes(self) -> bytes:
        """Canonical encoding: the wrapped Evidence proto."""
        return evidence_proto(self)

    def hash(self) -> bytes:
        return tmhash.sum(self.bytes())

    def proto(self) -> bytes:
        return evidence_proto(self)

    def validate_basic(self) -> None:
        raise NotImplementedError


@register
@dataclass
class DuplicateVoteEvidence(Evidence):
    """Two conflicting votes by one validator at the same H/R/S
    (reference types/evidence.go:38-160).  vote_a sorts before vote_b by
    block ID key, as NewDuplicateVoteEvidence enforces."""
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp.zero)

    @classmethod
    def from_votes(cls, vote1: Vote, vote2: Vote, block_time: Timestamp,
                   val_set) -> "DuplicateVoteEvidence":
        """Reference types/evidence.go:50-79: orders the votes and fills
        power fields from the validator set at that height."""
        if vote1 is None or vote2 is None or val_set is None:
            raise EvidenceError("missing vote or validator set")
        _, val = val_set.get_by_address(vote1.validator_address)
        if val is None:
            raise EvidenceError(
                f"validator {vote1.validator_address.hex()} not in set")
        a, b = sorted((vote1, vote2), key=_vote_order_key)
        return cls(vote_a=a, vote_b=b,
                   total_voting_power=val_set.total_voting_power(),
                   validator_power=val.voting_power,
                   timestamp=block_time)

    def height(self) -> int:
        return self.vote_a.height

    def time(self) -> Timestamp:
        return self.timestamp

    def abci(self) -> list:
        from tendermint_tpu_torch.abci.types import Misbehavior
        return [Misbehavior(
            type=1, validator_address=self.vote_a.validator_address,
            validator_power=self.validator_power,
            height=self.height(),
            time_seconds=self.timestamp.seconds,
            time_nanos=self.timestamp.nanos,
            total_voting_power=self.total_voting_power)]

    def body_proto(self) -> bytes:
        return (pe.message_field_always(1, self.vote_a.proto())
                + pe.message_field_always(2, self.vote_b.proto())
                + pe.varint_field(3, self.total_voting_power)
                + pe.varint_field(4, self.validator_power)
                + pe.message_field_always(5, self.timestamp.proto()))

    @classmethod
    def from_body_proto(cls, body: bytes) -> "DuplicateVoteEvidence":
        f = pd.parse(body)
        va, vb = pd.get_message(f, 1), pd.get_message(f, 2)
        if va is None or vb is None:
            raise pd.ProtoError("DuplicateVoteEvidence: missing votes")
        ts = pd.get_message(f, 5)
        return cls(vote_a=Vote.from_proto(va), vote_b=Vote.from_proto(vb),
                   total_voting_power=pd.get_int(f, 3, 0),
                   validator_power=pd.get_int(f, 4, 0),
                   timestamp=(Timestamp.from_proto(ts) if ts is not None
                              else Timestamp.zero()))

    def validate_basic(self) -> None:
        """Reference types/evidence.go:126-146."""
        if self.vote_a is None or self.vote_b is None:
            raise EvidenceError("missing vote")
        if not self.vote_a.signature or not self.vote_b.signature:
            raise EvidenceError("missing signature")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if _vote_order_key(self.vote_a) >= _vote_order_key(self.vote_b):
            raise EvidenceError(
                "duplicate votes in invalid order (vote_a must sort first)")


def _vote_order_key(v: Vote) -> bytes:
    return v.block_id.hash + v.block_id.part_set_header.hash


@register
@dataclass
class LightClientAttackEvidence(Evidence):
    """A conflicting light block presented to a light client
    (reference types/evidence.go:163-290)."""
    conflicting_block: LightBlock
    common_height: int
    byzantine_validators: List[Validator] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp.zero)

    def height(self) -> int:
        return self.common_height

    def time(self) -> Timestamp:
        return self.timestamp

    def abci(self) -> list:
        from tendermint_tpu_torch.abci.types import Misbehavior
        return [Misbehavior(
            type=2, validator_address=v.address,
            validator_power=v.voting_power,
            height=self.height(),
            time_seconds=self.timestamp.seconds,
            time_nanos=self.timestamp.nanos,
            total_voting_power=self.total_voting_power)
            for v in self.byzantine_validators]

    def body_proto(self) -> bytes:
        return (pe.message_field_always(1, self.conflicting_block.proto())
                + pe.varint_field(2, self.common_height)
                + b"".join(pe.message_field_always(3, v.proto())
                           for v in self.byzantine_validators)
                + pe.varint_field(4, self.total_voting_power)
                + pe.message_field_always(5, self.timestamp.proto()))

    @classmethod
    def from_body_proto(cls, body: bytes) -> "LightClientAttackEvidence":
        f = pd.parse(body)
        cb = pd.get_message(f, 1)
        if cb is None:
            raise pd.ProtoError("LightClientAttackEvidence: missing block")
        ts = pd.get_message(f, 5)
        return cls(
            conflicting_block=LightBlock.from_proto(cb),
            common_height=pd.get_int(f, 2, 0),
            byzantine_validators=[Validator.from_proto(m)
                                  for m in pd.get_messages(f, 3)],
            total_voting_power=pd.get_int(f, 4, 0),
            timestamp=(Timestamp.from_proto(ts) if ts is not None
                       else Timestamp.zero()))

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """Reference types/evidence.go:206-218: in equivocation/amnesia the
        conflicting header derives the same non-vote fields."""
        ch = self.conflicting_block.signed_header.header
        return (ch.validators_hash != trusted_header.validators_hash
                or ch.next_validators_hash
                != trusted_header.next_validators_hash
                or ch.consensus_hash != trusted_header.consensus_hash
                or ch.app_hash != trusted_header.app_hash
                or ch.last_results_hash != trusted_header.last_results_hash)

    def validate_basic(self) -> None:
        """Reference types/evidence.go:252-272 (validates the embedded
        light block's internal bindings, chain-id-free)."""
        if self.conflicting_block is None:
            raise EvidenceError("conflicting block is nil")
        sh = self.conflicting_block.signed_header
        if sh is None or sh.header is None:
            raise EvidenceError("conflicting block missing header")
        if sh.commit is None:
            raise EvidenceError("conflicting block missing commit")
        if sh.commit.height != sh.header.height:
            raise EvidenceError(
                "conflicting block header/commit height mismatch")
        if sh.commit.block_id.hash != sh.header.hash():
            raise EvidenceError(
                "conflicting block commit does not sign its header")
        vals = self.conflicting_block.validators
        if vals is None or vals.is_nil_or_empty():
            raise EvidenceError("conflicting block missing validator set")
        if sh.header.validators_hash != vals.hash():
            raise EvidenceError(
                "conflicting block validator set hash mismatch")
        if self.total_voting_power <= 0:
            raise EvidenceError("negative or zero total voting power")
        if self.common_height <= 0:
            raise EvidenceError("negative or zero common height")
        if self.common_height > self.conflicting_block.height:
            raise EvidenceError(
                f"common height {self.common_height} above conflicting "
                f"block height {self.conflicting_block.height}")


# -- wrapper proto (tendermint.types.Evidence oneof) -----------------------

def evidence_proto(ev: Evidence) -> bytes:
    if isinstance(ev, DuplicateVoteEvidence):
        return pe.message_field_always(1, ev.body_proto())
    if isinstance(ev, LightClientAttackEvidence):
        return pe.message_field_always(2, ev.body_proto())
    raise EvidenceError(f"unknown evidence type {type(ev).__name__}")


def evidence_from_proto(body: bytes) -> Evidence:
    f = pd.parse(body)
    dve = pd.get_message(f, 1)
    if dve is not None:
        return DuplicateVoteEvidence.from_body_proto(dve)
    lca = pd.get_message(f, 2)
    if lca is not None:
        return LightClientAttackEvidence.from_body_proto(lca)
    raise pd.ProtoError("Evidence: no known oneof field set")


def evidence_list_hash(evs: List[Evidence]) -> bytes:
    """Merkle root over evidence encodings (reference types/evidence.go:299)."""
    return hash_from_byte_slices([e.bytes() for e in evs])
