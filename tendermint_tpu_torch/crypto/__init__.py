"""Crypto layer: key interfaces, hashing, and the GPU batch verifier.

Mirrors the reference's `crypto` package surface (crypto/crypto.go:22-42):
`PubKey`/`PrivKey` interfaces with 20-byte addresses = first 20 bytes of
SHA-256(pubkey) — but verification routes through a batch data plane
(crypto/batch.py) instead of per-call serial verification.
"""
from __future__ import annotations

import abc
import hashlib


ADDRESS_SIZE = 20


def address_hash(data: bytes) -> bytes:
    """First 20 bytes of SHA-256 (reference crypto/crypto.go:18)."""
    return hashlib.sha256(data).digest()[:ADDRESS_SIZE]


class PubKey(abc.ABC):
    @abc.abstractmethod
    def bytes(self) -> bytes: ...

    @abc.abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @property
    @abc.abstractmethod
    def type_name(self) -> str: ...

    def address(self) -> bytes:
        return address_hash(self.bytes())

    def __eq__(self, other):
        return (isinstance(other, PubKey)
                and self.type_name == other.type_name
                and self.bytes() == other.bytes())

    def __hash__(self):
        return hash((self.type_name, self.bytes()))


def pubkey_from_type_name(type_name: str, data: bytes) -> "PubKey":
    """Key-scheme registry (the decode half of the PublicKey proto oneof,
    reference crypto/encoding/codec.go PubKeyFromProto)."""
    if type_name == "ed25519":
        from . import ed25519
        return ed25519.PubKey(data)
    if type_name == "secp256k1":
        from . import secp256k1
        return secp256k1.PubKey(data)
    if type_name == "sr25519":
        from . import sr25519
        return sr25519.PubKey(data)
    raise ValueError(f"unsupported key type {type_name}")


class PrivKey(abc.ABC):
    @abc.abstractmethod
    def bytes(self) -> bytes: ...

    @abc.abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abc.abstractmethod
    def pub_key(self) -> PubKey: ...

    @property
    @abc.abstractmethod
    def type_name(self) -> str: ...
