"""File-backed private validator (reference privval/file.go).

Double-sign prevention: refuse to sign a vote/proposal at a (height,
round, step) lower than the last signed one; at the SAME HRS, only re-sign
identical or timestamp-only-differing payloads, returning the previous
signature (reference privval/file.go:254-415, CheckHRS :92).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

from tendermint_tpu_torch.crypto import ed25519 as edkeys
from tendermint_tpu_torch.types.basic import SignedMsgType, Timestamp
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_STEP_OF = {
    SignedMsgType.PREVOTE: STEP_PREVOTE,
    SignedMsgType.PRECOMMIT: STEP_PRECOMMIT,
}


class DoubleSignError(Exception):
    pass


@dataclass
class _LastSignState:
    height: int = 0
    round: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """Returns True if HRS equals the last one exactly (a possible
        regeneration); raises on regression (reference privval/file.go:92)."""
        if self.height > height:
            raise DoubleSignError(f"height regression: {self.height} > {height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression at height {height}")
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at {height}/{round_}")
                if self.step == step:
                    if not self.sign_bytes:
                        raise DoubleSignError("no sign bytes at same HRS")
                    return True
        return False


class FilePV:
    """types.PrivValidator implementation (reference types/priv_validator.go
    interface: get_pub_key / sign_vote / sign_proposal)."""

    def __init__(self, priv_key: edkeys.PrivKey, key_path: Optional[str] = None,
                 state_path: Optional[str] = None):
        self.priv_key = priv_key
        self.key_path = key_path
        self.state_path = state_path
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("privval")
        self.last = _LastSignState()
        if state_path and os.path.exists(state_path):
            with open(state_path) as f:
                d = json.load(f)
            self.last = _LastSignState(
                height=int(d["height"]), round=int(d["round"]),
                step=int(d["step"]),
                signature=bytes.fromhex(d.get("signature", "")),
                sign_bytes=bytes.fromhex(d.get("sign_bytes", "")))

    # -- persistence -------------------------------------------------------

    @classmethod
    def generate(cls, key_path: Optional[str] = None,
                 state_path: Optional[str] = None) -> "FilePV":
        pv = cls(edkeys.PrivKey.generate(), key_path, state_path)
        if key_path:
            pv.save_key()
        return pv

    @classmethod
    def load_or_generate(cls, key_path: str, state_path: str) -> "FilePV":
        if os.path.exists(key_path):
            with open(key_path) as f:
                d = json.load(f)
            priv = edkeys.PrivKey(bytes.fromhex(d["priv_key"]))
            return cls(priv, key_path, state_path)
        return cls.generate(key_path, state_path)

    def save_key(self):
        os.makedirs(os.path.dirname(self.key_path) or ".", exist_ok=True)
        pub = self.priv_key.pub_key()
        with open(self.key_path, "w") as f:
            json.dump({
                "address": pub.address().hex().upper(),
                "pub_key": pub.bytes().hex(),
                "priv_key": self.priv_key.bytes().hex(),
            }, f, indent=2)

    def _save_state(self):
        if not self.state_path:
            return
        os.makedirs(os.path.dirname(self.state_path) or ".", exist_ok=True)
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "height": self.last.height, "round": self.last.round,
                "step": self.last.step,
                "signature": self.last.signature.hex(),
                "sign_bytes": self.last.sign_bytes.hex(),
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)

    # -- PrivValidator interface -------------------------------------------

    def get_pub_key(self) -> edkeys.PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        step = _STEP_OF[vote.type]
        same_hrs = self.last.check_hrs(vote.height, vote.round, step)
        sign_bytes = vote.sign_bytes(chain_id)
        if same_hrs:
            if sign_bytes == self.last.sign_bytes:
                vote.signature = self.last.signature
                return vote
            # timestamp-only difference: re-use previous signature+timestamp
            prev = self._timestamp_only_diff_vote(chain_id, vote)
            if prev is not None:
                vote.timestamp, vote.signature = prev
                return vote
            self.log.error("refusing to double-sign vote",
                           height=vote.height, round=vote.round)
            raise DoubleSignError("conflicting vote data at same HRS")
        sig = self.priv_key.sign(sign_bytes)
        self.last = _LastSignState(vote.height, vote.round, step, sig,
                                   sign_bytes)
        self._save_state()
        vote.signature = sig
        return vote

    def _timestamp_only_diff_vote(self, chain_id: str, vote: Vote):
        """If the new sign bytes differ from the last only in timestamp,
        return (last_timestamp, last_signature) (reference
        privval/file.go checkVotesOnlyDifferByTimestamp)."""
        import copy
        for ts_probe in self._probe_timestamps():
            v2 = copy.copy(vote)
            v2.timestamp = ts_probe
            if v2.sign_bytes(chain_id) == self.last.sign_bytes:
                return ts_probe, self.last.signature
        return None

    def _probe_timestamps(self):
        # the only unknown in the previous sign bytes is its timestamp; we
        # can't invert protobuf here cheaply, so keep the last timestamp in
        # the sign state via the signature payload: re-parse not needed —
        # try decoding from stored sign_bytes.
        ts = _extract_canonical_timestamp(self.last.sign_bytes)
        return [ts] if ts is not None else []

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        same_hrs = self.last.check_hrs(proposal.height, proposal.round,
                                       STEP_PROPOSE)
        sign_bytes = proposal.sign_bytes(chain_id)
        if same_hrs:
            if sign_bytes == self.last.sign_bytes:
                proposal.signature = self.last.signature
                return proposal
            self.log.error("refusing to double-sign proposal",
                           height=proposal.height, round=proposal.round)
            raise DoubleSignError("conflicting proposal data at same HRS")
        sig = self.priv_key.sign(sign_bytes)
        self.last = _LastSignState(proposal.height, proposal.round,
                                   STEP_PROPOSE, sig, sign_bytes)
        self._save_state()
        proposal.signature = sig
        return proposal


def _extract_canonical_timestamp(sign_bytes: bytes) -> Optional[Timestamp]:
    """Parse the Timestamp field out of canonical vote sign bytes (field 5,
    wire type 2)."""
    try:
        buf = sign_bytes
        # strip uvarint length prefix
        shift = 0
        n = 0
        i = 0
        while True:
            b = buf[i]
            n |= (b & 0x7F) << shift
            i += 1
            if not b & 0x80:
                break
            shift += 7
        body = buf[i:i + n]
        j = 0
        while j < len(body):
            tag = body[j]
            fnum, wt = tag >> 3, tag & 7
            j += 1
            if wt == 0:  # varint
                while body[j] & 0x80:
                    j += 1
                j += 1
            elif wt == 1:
                j += 8
            elif wt == 2:
                ln = 0
                shift = 0
                while True:
                    b = body[j]
                    ln |= (b & 0x7F) << shift
                    j += 1
                    if not b & 0x80:
                        break
                    shift += 7
                if fnum == 5:
                    return _parse_timestamp(body[j:j + ln])
                j += ln
            else:
                return None
        return None
    except (IndexError, ValueError):
        return None


def _parse_timestamp(body: bytes) -> Timestamp:
    seconds = nanos = 0
    j = 0
    while j < len(body):
        tag = body[j]
        fnum = tag >> 3
        j += 1
        v = 0
        shift = 0
        while True:
            b = body[j]
            v |= (b & 0x7F) << shift
            j += 1
            if not b & 0x80:
                break
            shift += 7
        if v >= 1 << 63:
            v -= 1 << 64
        if fnum == 1:
            seconds = v
        elif fnum == 2:
            nanos = v
    return Timestamp(seconds, nanos)
