"""NaCl secretbox (XSalsa20 + Poly1305) — the reference's legacy
symmetric cipher (reference crypto/xsalsa20symmetric/symmetric.go,
golang.org/x/crypto/nacl/secretbox).

Layout (EncryptSymmetric): nonce(24) || poly1305 tag(16) || ciphertext;
the secret must be 32 bytes ("use something like Sha256(Bcrypt(pass))" —
the KDF is the caller's concern in the reference too).

Pure Python from the Salsa20/XSalsa20/Poly1305 specs: this runs at key
armor / import-export scale (bytes-to-KB, host-side, rare), where
interpreter speed is irrelevant.  Verified against the NaCl paper's
crypto_secretbox test vector and the RFC 8439 Poly1305 vector
(tests/test_xsalsa20.py).
"""
from __future__ import annotations

import os
import struct

NONCE_LEN = 24
SECRET_LEN = 32
TAG_LEN = 16


class SymmetricError(Exception):
    pass


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & 0xFFFFFFFF


def _quarterround(s, a, b, c, d):
    s[b] ^= _rotl((s[a] + s[d]) & 0xFFFFFFFF, 7)
    s[c] ^= _rotl((s[b] + s[a]) & 0xFFFFFFFF, 9)
    s[d] ^= _rotl((s[c] + s[b]) & 0xFFFFFFFF, 13)
    s[a] ^= _rotl((s[d] + s[c]) & 0xFFFFFFFF, 18)


def _doubleround(s):
    # column round
    _quarterround(s, 0, 4, 8, 12)
    _quarterround(s, 5, 9, 13, 1)
    _quarterround(s, 10, 14, 2, 6)
    _quarterround(s, 15, 3, 7, 11)
    # row round
    _quarterround(s, 0, 1, 2, 3)
    _quarterround(s, 5, 6, 7, 4)
    _quarterround(s, 10, 11, 8, 9)
    _quarterround(s, 15, 12, 13, 14)


_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"


def _salsa20_words(key_words, in_words) -> list:
    """The 16-word Salsa20 state for key/input words (pre-core)."""
    return [
        _SIGMA[0], key_words[0], key_words[1], key_words[2],
        key_words[3], _SIGMA[1], in_words[0], in_words[1],
        in_words[2], in_words[3], _SIGMA[2], key_words[4],
        key_words[5], key_words[6], key_words[7], _SIGMA[3],
    ]


def _salsa20_core(state) -> bytes:
    """Salsa20 core: x + doubleround^10(x), serialized little-endian."""
    s = list(state)
    for _ in range(10):
        _doubleround(s)
    return struct.pack(
        "<16I", *((s[i] + state[i]) & 0xFFFFFFFF for i in range(16)))


def hsalsa20(key: bytes, in16: bytes) -> bytes:
    """HSalsa20 (XSalsa20 spec): derive a 32-byte subkey from key and a
    16-byte input — the doubleround output's diagonal + input words,
    WITHOUT the feedforward addition."""
    kw = struct.unpack("<8I", key)
    iw = struct.unpack("<4I", in16)
    s = _salsa20_words(kw, iw)
    for _ in range(10):
        _doubleround(s)
    out = (s[0], s[5], s[10], s[15], s[6], s[7], s[8], s[9])
    return struct.pack("<8I", *out)


def _xsalsa20_stream(n_bytes: int, nonce24: bytes, key: bytes) -> bytes:
    """XSalsa20 keystream: subkey = HSalsa20(key, nonce[0:16]); then
    Salsa20 with an 8-byte nonce = nonce[16:24] and a 64-bit counter."""
    subkey = hsalsa20(key, nonce24[:16])
    kw = struct.unpack("<8I", subkey)
    n2 = struct.unpack("<2I", nonce24[16:24])
    out = bytearray()
    block = 0
    while len(out) < n_bytes:
        ctr = struct.unpack("<2I", struct.pack("<Q", block))
        state = _salsa20_words(kw, (n2[0], n2[1], ctr[0], ctr[1]))
        out += _salsa20_core(state)
        block += 1
    return bytes(out[:n_bytes])


_P1305 = (1 << 130) - 5


def poly1305(msg: bytes, key32: bytes) -> bytes:
    """Poly1305 one-time MAC (RFC 8439 §2.5)."""
    r = int.from_bytes(key32[:16], "little") \
        & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i:i + 16]
        n = int.from_bytes(chunk, "little") + (1 << (8 * len(chunk)))
        acc = ((acc + n) * r) % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def secretbox_seal(plaintext: bytes, nonce24: bytes, key: bytes) -> bytes:
    """NaCl crypto_secretbox: returns tag(16) || ciphertext.  Per the
    NaCl construction the Poly1305 key is the first 32 keystream bytes,
    and encryption starts at keystream offset 32 (the rest of block 0)."""
    stream = _xsalsa20_stream(32 + len(plaintext), nonce24, key)
    ct = bytes(p ^ k for p, k in zip(plaintext, stream[32:]))
    tag = poly1305(ct, stream[:32])
    return tag + ct


def secretbox_open(boxed: bytes, nonce24: bytes, key: bytes) -> bytes:
    if len(boxed) < TAG_LEN:
        raise SymmetricError("ciphertext too short")
    tag, ct = boxed[:TAG_LEN], boxed[TAG_LEN:]
    stream = _xsalsa20_stream(32 + len(ct), nonce24, key)
    want = poly1305(ct, stream[:32])
    import hmac
    if not hmac.compare_digest(tag, want):
        raise SymmetricError("ciphertext decryption failed")
    return bytes(c ^ k for c, k in zip(ct, stream[32:]))


def encrypt_symmetric(plaintext: bytes, secret: bytes) -> bytes:
    """Reference EncryptSymmetric (symmetric.go:19): nonce-prefixed
    secretbox with a random 24-byte nonce."""
    if len(secret) != SECRET_LEN:
        raise SymmetricError(f"secret must be {SECRET_LEN} bytes")
    nonce = os.urandom(NONCE_LEN)
    return nonce + secretbox_seal(plaintext, nonce, secret)


def decrypt_symmetric(ciphertext: bytes, secret: bytes) -> bytes:
    """Reference DecryptSymmetric (symmetric.go:36)."""
    if len(secret) != SECRET_LEN:
        raise SymmetricError(f"secret must be {SECRET_LEN} bytes")
    if len(ciphertext) <= NONCE_LEN + TAG_LEN:
        raise SymmetricError("ciphertext too short")
    nonce, boxed = ciphertext[:NONCE_LEN], ciphertext[NONCE_LEN:]
    return secretbox_open(boxed, nonce, secret)
