"""sr25519 (schnorrkel) keys — reference crypto/sr25519/.

Schnorr over ristretto255 with merlin transcripts, wire-compatible with
go-schnorrkel as the reference consumes it (crypto/sr25519/pubkey.go:34-59,
privkey.go:24-41): signing context transcript `SigningContext` with empty
context bytes, labels proto-name/"Schnorr-sig", sign:pk, sign:R, sign:c;
64-byte signatures R||s with the schnorrkel marker bit (s[31] |= 0x80);
MiniSecretKey.ExpandEd25519 key derivation; address = SHA256[:20] of the
32-byte ristretto pubkey.

The group/transcript cores (_ristretto.py, _strobe.py) are validated
against RFC 9496 and merlin conformance vectors respectively, so this is
byte-compatible with substrate sr25519 verification.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import PrivKey as PrivKeyBase
from . import PubKey as PubKeyBase
from ._ristretto import L, Point, scalar_from_wide
from ._strobe import MerlinTranscript

KEY_TYPE = "sr25519"
SIGNATURE_SIZE = 64


def signing_context(ctx: bytes, msg: bytes) -> MerlinTranscript:
    """go-schnorrkel NewSigningContext (reference pubkey.go:50): context
    label then the message under "sign-bytes"."""
    t = MerlinTranscript(b"SigningContext")
    t.append_message(b"", ctx)
    t.append_message(b"sign-bytes", msg)
    return t


def _challenge_scalar(t: MerlinTranscript, label: bytes) -> int:
    return scalar_from_wide(t.challenge_bytes(label, 64))


def expand_ed25519(mini: bytes):
    """MiniSecretKey.ExpandEd25519 (go-schnorrkel privkey.go): SHA-512,
    ed25519 clamp, divide by cofactor; second half is the signing nonce."""
    h = hashlib.sha512(mini).digest()
    key = bytearray(h[:32])
    key[0] &= 248
    key[31] &= 63
    key[31] |= 64
    scalar = int.from_bytes(bytes(key), "little") >> 3
    return scalar, h[32:]


def verify(pub32: bytes, msg: bytes, sig: bytes,
           ctx: bytes = b"") -> bool:
    """schnorrkel PublicKey.Verify over NewSigningContext(ctx, msg)
    (reference pubkey.go:34-59)."""
    if len(sig) != SIGNATURE_SIZE or len(pub32) != 32:
        return False
    if not (sig[63] & 0x80):
        return False  # missing schnorrkel marker
    pubpt = Point.decode(pub32)
    if pubpt is None:
        return False
    r_pt = Point.decode(sig[:32])
    if r_pt is None:
        return False
    s_bytes = bytearray(sig[32:])
    s_bytes[31] &= 0x7F
    s = int.from_bytes(bytes(s_bytes), "little")
    if s >= L:
        return False
    t = signing_context(ctx, msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub32)
    t.append_message(b"sign:R", sig[:32])
    k = _challenge_scalar(t, b"sign:c")
    # R' = s*B - k*P ; valid iff R' == R
    rp = Point.base().mul(s).add(pubpt.mul(k).neg())
    return rp.equals(r_pt)


def sign(mini: bytes, msg: bytes, ctx: bytes = b"") -> bytes:
    """Deterministic schnorrkel signing (witness from the nonce half +
    message, standing in for go-schnorrkel's CSPRNG witness — any r yields
    an interoperable signature since R rides in it)."""
    scalar, nonce = expand_ed25519(mini)
    pub32 = Point.base().mul(scalar).encode()
    t = signing_context(ctx, msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub32)
    r = scalar_from_wide(hashlib.sha512(nonce + pub32 + msg).digest())
    r_enc = Point.base().mul(r).encode()
    t.append_message(b"sign:R", r_enc)
    k = _challenge_scalar(t, b"sign:c")
    s = (k * scalar + r) % L
    s_bytes = bytearray(s.to_bytes(32, "little"))
    s_bytes[31] |= 0x80
    return r_enc + bytes(s_bytes)


@dataclass(frozen=True)
class PubKey(PubKeyBase):
    data: bytes  # 32-byte ristretto point

    def bytes(self) -> bytes:
        return self.data

    @property
    def type_name(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return verify(self.data, msg, sig)

    def __hash__(self):
        return hash((KEY_TYPE, self.data))


@dataclass(frozen=True)
class PrivKey(PrivKeyBase):
    mini: bytes  # 32-byte MiniSecretKey

    def bytes(self) -> bytes:
        return self.mini

    @property
    def type_name(self) -> str:
        return KEY_TYPE

    def pub_key(self) -> PubKey:
        scalar, _ = expand_ed25519(self.mini)
        return PubKey(Point.base().mul(scalar).encode())

    def sign(self, msg: bytes) -> bytes:
        return sign(self.mini, msg)
