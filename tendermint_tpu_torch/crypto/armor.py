"""ASCII armor + passphrase encryption for private keys
(reference crypto/armor/armor.go, crypto/xsalsa20symmetric/symmetric.go,
and the keyring export format: OpenPGP-style armored blocks with a kdf
header).

Divergences from the reference, chosen for this image's stdlib/OpenSSL
surface and documented in the armor headers so artifacts are self-
describing:
  * KDF: scrypt (hashlib.scrypt; the reference uses bcrypt, which has no
    stdlib implementation) — header "kdf: scrypt".
  * AEAD: ChaCha20-Poly1305 (the reference's xsalsa20symmetric is NaCl
    secretbox; header "aead: chacha20poly1305").
Armor framing (BEGIN/END lines, key: value headers, base64 body, OpenPGP
CRC24 "=XXXX" trailer) matches the reference's armor encoding.
"""
from __future__ import annotations

import base64
import os
from typing import Dict, Tuple

_CRC24_INIT = 0xB704CE
_CRC24_POLY = 0x1864CFB


def _crc24(data: bytes) -> int:
    crc = _CRC24_INIT
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
    return crc & 0xFFFFFF


def encode_armor(block_type: str, headers: Dict[str, str],
                 data: bytes) -> str:
    lines = [f"-----BEGIN {block_type}-----"]
    for k in sorted(headers):
        lines.append(f"{k}: {headers[k]}")
    lines.append("")
    b64 = base64.b64encode(data).decode()
    lines.extend(b64[i:i + 64] for i in range(0, len(b64), 64))
    crc = base64.b64encode(_crc24(data).to_bytes(3, "big")).decode()
    lines.append(f"={crc}")
    lines.append(f"-----END {block_type}-----")
    return "\n".join(lines) + "\n"


class ArmorError(Exception):
    pass


def decode_armor(text: str) -> Tuple[str, Dict[str, str], bytes]:
    lines = [ln.strip() for ln in text.strip().splitlines()]
    if not lines or not lines[0].startswith("-----BEGIN ") \
            or not lines[0].endswith("-----"):
        raise ArmorError("missing BEGIN line")
    block_type = lines[0][len("-----BEGIN "):-len("-----")]
    if lines[-1] != f"-----END {block_type}-----":
        raise ArmorError("missing/mismatched END line")
    headers: Dict[str, str] = {}
    i = 1
    while i < len(lines) - 1 and lines[i]:
        if ":" not in lines[i]:
            break
        k, _, v = lines[i].partition(":")
        headers[k.strip()] = v.strip()
        i += 1
    body, crc = [], None
    for ln in lines[i:-1]:
        if not ln:
            continue
        if ln.startswith("="):
            crc = ln[1:]
        else:
            body.append(ln)
    try:
        data = base64.b64decode("".join(body), validate=True)
    except Exception as e:  # noqa: BLE001
        raise ArmorError(f"bad base64 body: {e}") from e
    if crc is not None:
        want = int.from_bytes(base64.b64decode(crc), "big")
        if _crc24(data) != want:
            raise ArmorError("CRC24 mismatch")
    return block_type, headers, data


# -- passphrase-encrypted private keys --------------------------------------

BLOCK_TYPE_PRIV_KEY = "TENDERMINT PRIVATE KEY"

_SCRYPT = dict(n=1 << 14, r=8, p=1, dklen=32,
               maxmem=64 * 1024 * 1024)


def _derive(passphrase: str, salt: bytes) -> bytes:
    import hashlib
    return hashlib.scrypt(passphrase.encode(), salt=salt, **_SCRYPT)


def encrypt_armor_priv_key(priv_bytes: bytes, passphrase: str,
                           key_type: str = "ed25519",
                           aead: str = "chacha20poly1305") -> str:
    """Reference crypto/armor EncryptArmorPrivKey: armored AEAD-encrypted
    key with kdf/salt headers.  aead selects "chacha20poly1305" (modern
    default) or "xsalsa20poly1305" (the reference's legacy NaCl
    secretbox, crypto/xsalsa20symmetric)."""
    salt = os.urandom(16)
    key = _derive(passphrase, salt)
    if aead == "chacha20poly1305":
        from cryptography.hazmat.primitives.ciphers.aead import (
            ChaCha20Poly1305)
        nonce = os.urandom(12)
        body = nonce + ChaCha20Poly1305(key).encrypt(nonce, priv_bytes,
                                                     None)
    elif aead == "xsalsa20poly1305":
        from .xsalsa20 import encrypt_symmetric
        body = encrypt_symmetric(priv_bytes, key)  # nonce(24)||tag||ct
    else:
        raise ArmorError(f"unrecognized AEAD {aead!r}")
    return encode_armor(BLOCK_TYPE_PRIV_KEY, {
        "kdf": "scrypt",
        "salt": salt.hex().upper(),
        "aead": aead,
        "type": key_type,
    }, body)


def unarmor_decrypt_priv_key(armor_text: str,
                             passphrase: str) -> Tuple[bytes, str]:
    """(priv_bytes, key_type); raises ArmorError on any mismatch
    (reference UnarmorDecryptPrivKey).  Accepts both the modern
    chacha20poly1305 armor and the xsalsa20poly1305 secretbox cipher —
    note the KDF is always scrypt here: reference-EXPORTED legacy armor
    (kdf: bcrypt) is still rejected because no bcrypt exists in this
    environment; the secretbox AEAD is interop-proven (NaCl vector) but
    end-to-end legacy import would additionally need bcrypt."""
    block_type, headers, data = decode_armor(armor_text)
    if block_type != BLOCK_TYPE_PRIV_KEY:
        raise ArmorError(f"unrecognized armor type {block_type!r}")
    if headers.get("kdf") != "scrypt":
        raise ArmorError(f"unrecognized KDF {headers.get('kdf')!r}")
    aead = headers.get("aead", "chacha20poly1305")
    # reject unknown AEADs from the headers alone — _derive is a
    # deliberately expensive scrypt, not something to spend on
    # untrusted armor that is rejectable for free
    if aead not in ("chacha20poly1305", "xsalsa20poly1305"):
        raise ArmorError(f"unrecognized AEAD {aead!r}")
    try:
        salt = bytes.fromhex(headers.get("salt", ""))
    except ValueError as e:
        raise ArmorError("bad salt header") from e
    key = _derive(passphrase, salt)
    if aead == "chacha20poly1305":
        from cryptography.exceptions import InvalidTag
        from cryptography.hazmat.primitives.ciphers.aead import (
            ChaCha20Poly1305)
        if len(data) < 12 + 16:
            raise ArmorError("ciphertext too short")
        try:
            pt = ChaCha20Poly1305(key).decrypt(data[:12], data[12:], None)
        except InvalidTag as e:
            raise ArmorError("invalid passphrase") from e
    else:  # xsalsa20poly1305 (validated above)
        from .xsalsa20 import SymmetricError, decrypt_symmetric
        try:
            pt = decrypt_symmetric(data, key)
        except SymmetricError as e:
            raise ArmorError("invalid passphrase") from e
    return pt, headers.get("type", "ed25519")
