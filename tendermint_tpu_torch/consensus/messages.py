"""Consensus reactor messages + canonical proto codec (reference
proto/tendermint/consensus/types.proto, consensus/msgs.go MsgFromProto).

All three consensus channels (0x20-0x22) carry the same
tendermint.consensus.Message oneof on the wire; decode accepts any
member and the reactor routes by type.  Field numbers match the
reference schema exactly so the byte layouts interoperate.
"""
from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.p2p import wire
from tendermint_tpu_torch.types.basic import BlockID
from tendermint_tpu_torch.types.part_set import Part
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
# dedicated catchup channel (reference consensus/reactor.go:30
# VoteSetBitsChannel 0x23): bitmap bursts ride their own low-priority
# queue so they can never contend with round-step announcements
VOTE_SET_BITS_CHANNEL = 0x23


@dataclass
class NewRoundStepMessage:
    height: int
    round: int
    step: int
    last_commit_round: int
    seconds_since_start_time: int = 0


@dataclass
class NewValidBlockMessage:
    """Peer completed a proposal block / committed (reference
    NewValidBlock): carries the part-set header and a have-bitmap of the
    parts.  Accepted for interop; our gossip resends whole part sets
    rather than tracking per-peer part bitmaps."""
    height: int
    round: int
    block_part_set_header: object  # PartSetHeader
    block_parts: object            # BitArray
    is_commit: bool = False


@dataclass
class ProposalPOLMessage:
    """Proposal proof-of-lock round bitmap (reference ProposalPOL).
    Accepted for interop; only meaningful to peers implementing POL-based
    catch-up."""
    height: int
    proposal_pol_round: int
    proposal_pol: object           # BitArray


@dataclass
class ProposalGossip:
    proposal: object


@dataclass
class BlockPartGossip:
    height: int
    round: int
    part: object


@dataclass
class VoteGossip:
    vote: object


@dataclass
class HasVoteMessage:
    """We hold this vote (reference consensus/reactor.go HasVoteMessage);
    peers use it to avoid re-sending votes we already have."""
    height: int
    round: int
    type: int       # SignedMsgType
    index: int      # validator index


@dataclass
class VoteSetMaj23Message:
    """We observed +2/3 on block_id (reference VoteSetMaj23Message); the
    peer answers with its have-bitmap for that vote set."""
    height: int
    round: int
    type: int
    block_id: object


@dataclass
class VoteSetBitsMessage:
    """Have-bitmap for (height, round, type, block_id) (reference
    VoteSetBitsMessage)."""
    height: int
    round: int
    type: int
    block_id: object
    bits_size: int
    bits: bytes


# -- proto codec ------------------------------------------------------------
# Message oneof field numbers (consensus/types.proto): new_round_step=1,
# new_valid_block=2, proposal=3, proposal_pol=4, block_part=5, vote=6,
# has_vote=7, vote_set_maj23=8, vote_set_bits=9.

def _enc_hrt(msg) -> bytes:
    return (pe.varint_field(1, msg.height) + pe.varint_field(2, msg.round)
            + pe.varint_field(3, msg.type))


def encode_msg(msg) -> bytes:
    if isinstance(msg, NewRoundStepMessage):
        return wire.oneof_encode(1, (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.round)
            + pe.varint_field(3, msg.step)
            + pe.varint_field(4, msg.seconds_since_start_time)
            + pe.varint_field(5, msg.last_commit_round)))
    if isinstance(msg, NewValidBlockMessage):
        return wire.oneof_encode(2, (
            pe.varint_field(1, msg.height) + pe.varint_field(2, msg.round)
            + pe.message_field_always(
                3, msg.block_part_set_header.proto())
            + pe.message_field_always(4, msg.block_parts.proto())
            + pe.varint_field(5, 1 if msg.is_commit else 0)))
    if isinstance(msg, ProposalPOLMessage):
        return wire.oneof_encode(4, (
            pe.varint_field(1, msg.height)
            + pe.varint_field(2, msg.proposal_pol_round)
            + pe.message_field_always(3, msg.proposal_pol.proto())))
    if isinstance(msg, ProposalGossip):
        return wire.oneof_encode(
            3, pe.message_field_always(1, msg.proposal.proto()))
    if isinstance(msg, BlockPartGossip):
        return wire.oneof_encode(5, (
            pe.varint_field(1, msg.height) + pe.varint_field(2, msg.round)
            + pe.message_field_always(3, msg.part.proto())))
    if isinstance(msg, VoteGossip):
        return wire.oneof_encode(
            6, pe.message_field_always(1, msg.vote.proto()))
    if isinstance(msg, HasVoteMessage):
        return wire.oneof_encode(
            7, _enc_hrt(msg) + pe.varint_field(4, msg.index))
    if isinstance(msg, VoteSetMaj23Message):
        return wire.oneof_encode(8, (
            _enc_hrt(msg)
            + pe.message_field_always(4, msg.block_id.proto())))
    if isinstance(msg, VoteSetBitsMessage):
        ba = BitArray.from_bytes(msg.bits_size, msg.bits)
        return wire.oneof_encode(9, (
            _enc_hrt(msg)
            + pe.message_field_always(4, msg.block_id.proto())
            + pe.message_field_always(5, ba.proto())))
    raise TypeError(f"unknown consensus message {type(msg).__name__}")


def _dec_new_round_step(body: bytes) -> NewRoundStepMessage:
    f = pd.parse(body)
    return NewRoundStepMessage(
        height=pd.get_int(f, 1), round=pd.get_int(f, 2),
        step=pd.get_int(f, 3), last_commit_round=pd.get_int(f, 5),
        seconds_since_start_time=pd.get_int(f, 4))


def _dec_new_valid_block(body: bytes) -> NewValidBlockMessage:
    from tendermint_tpu_torch.types.basic import PartSetHeader
    f = pd.parse(body)
    psh = pd.get_message(f, 3)
    bp = pd.get_message(f, 4)
    return NewValidBlockMessage(
        height=pd.get_int(f, 1), round=pd.get_int(f, 2),
        block_part_set_header=(PartSetHeader.from_proto(psh)
                               if psh is not None else PartSetHeader()),
        block_parts=(BitArray.from_proto(bp) if bp is not None
                     else BitArray(0)),
        is_commit=bool(pd.get_uint(f, 5)))


def _dec_proposal_pol(body: bytes) -> ProposalPOLMessage:
    f = pd.parse(body)
    pol = pd.get_message(f, 3)
    return ProposalPOLMessage(
        height=pd.get_int(f, 1), proposal_pol_round=pd.get_int(f, 2),
        proposal_pol=(BitArray.from_proto(pol) if pol is not None
                      else BitArray(0)))


def _dec_proposal(body: bytes) -> ProposalGossip:
    f = pd.parse(body)
    p = pd.get_message(f, 1)
    if p is None:
        raise pd.ProtoError("Proposal: missing proposal")
    return ProposalGossip(Proposal.from_proto(p))


def _dec_block_part(body: bytes) -> BlockPartGossip:
    f = pd.parse(body)
    p = pd.get_message(f, 3)
    if p is None:
        raise pd.ProtoError("BlockPart: missing part")
    return BlockPartGossip(height=pd.get_int(f, 1), round=pd.get_int(f, 2),
                           part=Part.from_proto(p))


def _dec_vote(body: bytes) -> VoteGossip:
    f = pd.parse(body)
    v = pd.get_message(f, 1)
    if v is None:
        raise pd.ProtoError("Vote: missing vote")
    return VoteGossip(Vote.from_proto(v))


def _dec_has_vote(body: bytes) -> HasVoteMessage:
    f = pd.parse(body)
    return HasVoteMessage(height=pd.get_int(f, 1), round=pd.get_int(f, 2),
                          type=pd.get_int(f, 3), index=pd.get_int(f, 4))


def _dec_block_id(f, num) -> BlockID:
    b = pd.get_message(f, num)
    return BlockID.from_proto(b) if b is not None else BlockID()


def _dec_maj23(body: bytes) -> VoteSetMaj23Message:
    f = pd.parse(body)
    return VoteSetMaj23Message(
        height=pd.get_int(f, 1), round=pd.get_int(f, 2),
        type=pd.get_int(f, 3), block_id=_dec_block_id(f, 4))


def _dec_vote_set_bits(body: bytes) -> VoteSetBitsMessage:
    f = pd.parse(body)
    votes = pd.get_message(f, 5)
    ba = BitArray.from_proto(votes) if votes is not None else BitArray(0)
    return VoteSetBitsMessage(
        height=pd.get_int(f, 1), round=pd.get_int(f, 2),
        type=pd.get_int(f, 3), block_id=_dec_block_id(f, 4),
        bits_size=ba.size(), bits=ba.to_bytes())


_HANDLERS = {
    1: _dec_new_round_step,
    2: _dec_new_valid_block,
    3: _dec_proposal,
    4: _dec_proposal_pol,
    5: _dec_block_part,
    6: _dec_vote,
    7: _dec_has_vote,
    8: _dec_maj23,
    9: _dec_vote_set_bits,
}


def decode_msg(data: bytes):
    return wire.oneof_decode(data, _HANDLERS)


for _ch in (STATE_CHANNEL, DATA_CHANNEL, VOTE_CHANNEL,
            VOTE_SET_BITS_CHANNEL):
    wire.register_codec(_ch, encode_msg, decode_msg)
