"""Authenticated-encryption transport (reference
p2p/conn/secret_connection.go): X25519 ECDH -> HKDF-SHA256 -> two
ChaCha20-Poly1305 keys (one per direction), then a challenge signed by the
ed25519 node key proves identity (STS pattern).

Framing: each sealed frame is [4-byte BE ciphertext length][ciphertext];
plaintext chunks are at most DATA_MAX; nonces are little-endian counters,
per direction.  Both endpoints run this implementation, so byte-level
compatibility with the reference's protocol is not required — the
*security properties* (authenticated ephemeral ECDH, per-direction keys
and nonces, identity binding via challenge signature) are preserved.
"""
from __future__ import annotations

import hashlib
import os
import socket
import struct
import threading

# gated: this module sits on the import path of every reactor (via
# p2p/connection.py), so a missing `cryptography` package must degrade
# to a clear error at CONNECTION time, not take down node assembly /
# in-process harnesses that never open a wire connection
try:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey)
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
    from cryptography.hazmat.primitives import hashes
    _HAVE_CRYPTO = True
except ImportError:  # pragma: no cover - environment-dependent
    _HAVE_CRYPTO = False

from tendermint_tpu_torch.crypto import ed25519 as edkeys

DATA_MAX = 1024 * 64


class SecretConnectionError(Exception):
    pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf += chunk
    return buf


class SecretConnection:
    def __init__(self, sock: socket.socket, priv_key: edkeys.PrivKey):
        if not _HAVE_CRYPTO:
            raise SecretConnectionError(
                "cryptography package unavailable: secret connection "
                "needs X25519/HKDF/ChaCha20-Poly1305")
        self.sock = sock
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._send_nonce = 0
        self._recv_nonce = 0

        # 1. ephemeral key exchange (unauthenticated)
        eph_priv = X25519PrivateKey.generate()
        eph_pub = eph_priv.public_key().public_bytes_raw()
        sock.sendall(eph_pub)
        their_eph = _recv_exact(sock, 32)
        shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(their_eph))

        # 2. derive directional keys; key order decided by sorted ephemeral
        # pubkeys so both sides agree who is "low"
        low = eph_pub < their_eph
        okm = HKDF(algorithm=hashes.SHA256(), length=96, salt=None,
                   info=b"TENDERMINT_TPU_SECRET_CONNECTION_KEY_GEN").derive(
            shared + (eph_pub + their_eph if low else their_eph + eph_pub))
        k1, k2, challenge = okm[:32], okm[32:64], okm[64:]
        if low:
            self._send_aead = ChaCha20Poly1305(k1)
            self._recv_aead = ChaCha20Poly1305(k2)
        else:
            self._send_aead = ChaCha20Poly1305(k2)
            self._recv_aead = ChaCha20Poly1305(k1)

        # 3. exchange signed challenge over the now-encrypted channel
        sig = priv_key.sign(challenge)
        self.send_frame(priv_key.pub_key().bytes() + sig)
        auth = self.recv_frame()
        if len(auth) != 32 + 64:
            raise SecretConnectionError("bad auth message")
        their_pub = edkeys.PubKey(auth[:32])
        if not their_pub.verify_signature(challenge, auth[32:]):
            raise SecretConnectionError("challenge signature invalid")
        self.remote_pub_key = their_pub

    @property
    def remote_node_id(self) -> str:
        return self.remote_pub_key.address().hex()

    # -- sealed framing ----------------------------------------------------

    def send_frame(self, data: bytes):
        with self._send_lock:
            payload = struct.pack(">I", len(data)) + data
            for i in range(0, len(payload), DATA_MAX):
                chunk = payload[i:i + DATA_MAX]
                nonce = self._send_nonce.to_bytes(12, "little")
                self._send_nonce += 1
                ct = self._send_aead.encrypt(nonce, chunk, None)
                self.sock.sendall(struct.pack(">I", len(ct)) + ct)

    def recv_frame(self) -> bytes:
        with self._recv_lock:
            buf = self._recv_chunk()
            (total,) = struct.unpack(">I", buf[:4])
            if total > 64 * 1024 * 1024:
                raise SecretConnectionError("frame too large")
            data = buf[4:]
            while len(data) < total:
                data += self._recv_chunk()
            return data[:total]

    def _recv_chunk(self) -> bytes:
        (ct_len,) = struct.unpack(">I", _recv_exact(self.sock, 4))
        if ct_len > DATA_MAX + 16 + 4:
            raise SecretConnectionError("ciphertext too large")
        ct = _recv_exact(self.sock, ct_len)
        nonce = self._recv_nonce.to_bytes(12, "little")
        self._recv_nonce += 1
        try:
            return self._recv_aead.decrypt(nonce, ct, None)
        except Exception as e:
            raise SecretConnectionError(f"decryption failed: {e}") from e

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
