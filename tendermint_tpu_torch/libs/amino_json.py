"""Amino-compatible JSON (reference libs/json: tmjson).

The reference's RPC surface speaks the legacy Amino JSON dialect:
64-bit integers are strings, []byte is base64, hashes/addresses are
uppercase hex, time.Time is RFC3339 with nanoseconds, and registered
interface types are wrapped as {"type": "<registered name>",
"value": ...} (reference libs/json/doc.go, types.go RegisterType calls
in crypto/ed25519/ed25519.go:38, types/evidence.go:529).  Without this
dialect no existing Tendermint tooling (clients, explorers, wallets)
can parse the node's /status, /validators or /block responses.

This module is the single source for those encodings; rpc/server.py
and the genesis doc use it.
"""
from __future__ import annotations

import base64
import datetime
import re
from typing import Tuple

from tendermint_tpu_torch.types.basic import Timestamp

# registered type names (reference crypto/*/: tmjson.RegisterType)
PUB_KEY_NAMES = {
    "ed25519": "tendermint/PubKeyEd25519",
    "secp256k1": "tendermint/PubKeySecp256k1",
    "sr25519": "tendermint/PubKeySr25519",
}
PUB_KEY_TYPES = {v: k for k, v in PUB_KEY_NAMES.items()}

DUPLICATE_VOTE = "tendermint/DuplicateVoteEvidence"
LIGHT_ATTACK = "tendermint/LightClientAttackEvidence"


def b64(b: bytes) -> str:
    return base64.b64encode(b or b"").decode()


def hexb(b: bytes) -> str:
    return (b or b"").hex().upper()


def ts_rfc3339(ts: Timestamp) -> str:
    """Go time.Time JSON: RFC3339 UTC, fractional seconds trimmed of
    trailing zeros, 'Z' suffix."""
    dt = datetime.datetime.fromtimestamp(ts.seconds,
                                         tz=datetime.timezone.utc)
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    if ts.nanos:
        frac = f"{ts.nanos:09d}".rstrip("0")
        base += f".{frac}"
    return base + "Z"


_RFC = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})T(\d{2}):(\d{2}):(\d{2})"
    r"(?:\.(\d{1,9}))?(?:Z|([+-])(\d{2}):(\d{2}))$")


def parse_rfc3339(s: str) -> Timestamp:
    """Any valid RFC3339 offset is accepted and normalized to UTC
    (Go tooling may write genesis_time with a non-UTC zone)."""
    m = _RFC.match(s)
    if not m:
        raise ValueError(f"bad RFC3339 timestamp {s!r}")
    y, mo, d, h, mi, sec = (int(x) for x in m.groups()[:6])
    dt = datetime.datetime(y, mo, d, h, mi, sec,
                           tzinfo=datetime.timezone.utc)
    if m.group(8):
        oh, om = int(m.group(9)), int(m.group(10))
        # a UTC offset like "+99:99" is not a timezone; silently applying
        # it would shift genesis_time by days (RFC3339: hh <= 23, mm <= 59)
        if oh > 23 or om > 59:
            raise ValueError(f"bad RFC3339 timezone offset in {s!r}")
        off = datetime.timedelta(hours=oh, minutes=om)
        dt = dt - off if m.group(8) == "+" else dt + off
    nanos = int((m.group(7) or "").ljust(9, "0") or 0)
    return Timestamp(int(dt.timestamp()), nanos)


def pub_key_json(type_name: str, key_bytes: bytes) -> dict:
    """{"type": "tendermint/PubKeyEd25519", "value": "<base64>"}."""
    return {"type": PUB_KEY_NAMES.get(type_name, type_name),
            "value": b64(key_bytes)}


def pub_key_from_json(d: dict) -> Tuple[str, bytes]:
    """Accepts amino-registered names and bare scheme names; base64 or
    hex values (older data dirs wrote hex)."""
    t = d.get("type", "")
    t = PUB_KEY_TYPES.get(t, t)
    v = d.get("value", "")
    try:
        raw = base64.b64decode(v, validate=True)
    except Exception:
        raw = bytes.fromhex(v)
    # 32-byte hex strings are also valid base64 for some inputs; prefer
    # the decoding that yields a plausible key length
    if len(raw) not in (32, 33) and len(v) in (64, 66):
        try:
            raw = bytes.fromhex(v)
        except ValueError:
            pass
    return t, raw


def block_id_json(bid) -> dict:
    return {"hash": hexb(bid.hash),
            "parts": {"total": bid.part_set_header.total,
                      "hash": hexb(bid.part_set_header.hash)}}


def vote_json(v) -> dict:
    """Reference types/vote.go JSON tags (height int64 -> string)."""
    return {
        "type": int(v.type),
        "height": str(v.height),
        "round": v.round,
        "block_id": block_id_json(v.block_id),
        "timestamp": ts_rfc3339(v.timestamp),
        "validator_address": hexb(v.validator_address),
        "validator_index": v.validator_index,
        "signature": b64(v.signature or b""),
    }


def validator_json(val) -> dict:
    """Reference types/validator.go JSON (int64s as strings)."""
    return {
        "address": hexb(val.address),
        "pub_key": pub_key_json(val.pub_key.type_name, val.pub_key.bytes()),
        "voting_power": str(val.voting_power),
        "proposer_priority": str(val.proposer_priority),
    }


def evidence_json(ev, header_json, commit_json, validator_set_json) -> dict:
    """Tagged evidence (reference types/evidence.go:529 RegisterType).
    The callers supply header/commit/valset serializers so the shapes
    stay single-sourced in rpc/server.py."""
    from tendermint_tpu_torch.types.evidence import (DuplicateVoteEvidence,
                                               LightClientAttackEvidence)
    if isinstance(ev, DuplicateVoteEvidence):
        # untagged Go fields marshal under their Go names
        # (evidence.go:35-43: only vote_a/vote_b carry json tags)
        return {"type": DUPLICATE_VOTE, "value": {
            "vote_a": vote_json(ev.vote_a),
            "vote_b": vote_json(ev.vote_b),
            "TotalVotingPower": str(ev.total_voting_power),
            "ValidatorPower": str(ev.validator_power),
            "Timestamp": ts_rfc3339(ev.timestamp),
        }}
    if isinstance(ev, LightClientAttackEvidence):
        lb = ev.conflicting_block
        return {"type": LIGHT_ATTACK, "value": {
            "ConflictingBlock": {
                "signed_header": {
                    "header": header_json(lb.signed_header.header),
                    "commit": commit_json(lb.signed_header.commit),
                },
                "validator_set": validator_set_json(lb.validators),
            },
            "CommonHeight": str(ev.common_height),
            "ByzantineValidators": [validator_json(v)
                                    for v in ev.byzantine_validators],
            "TotalVotingPower": str(ev.total_voting_power),
            "Timestamp": ts_rfc3339(ev.timestamp),
        }}
    raise TypeError(f"unregistered evidence type {type(ev).__name__}")
