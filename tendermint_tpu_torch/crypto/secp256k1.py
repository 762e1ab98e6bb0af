"""secp256k1 keys (reference crypto/secp256k1/secp256k1.go).

This fork of the reference signs with BIP-340 Schnorr (btcec/v2/schnorr:
secp256k1.go:134-146 Sign, :195-213 VerifySignature) over SHA-256(msg),
64-byte R||S signatures, 33-byte compressed pubkeys, and Bitcoin-style
addresses RIPEMD160(SHA256(pubkey)) (secp256k1.go:161-173).

Host implementation (pure Python bignum): the single-item path, the
signer, and the spot check of the device lane.  Batches go through
crypto/batch.py: the device lane (ops/secp.py, kernel S1) on the card, the
native C lane (native/ecverify.c) on the host.
"""
from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from . import PrivKey as PrivKeyBase
from . import PubKey as PubKeyBase

KEY_TYPE = "secp256k1"

# curve: y^2 = x^3 + 7 over F_p
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _tagged_hash(tag: str, data: bytes) -> bytes:
    th = hashlib.sha256(tag.encode()).digest()
    return hashlib.sha256(th + th + data).digest()


# -- point arithmetic (jacobian) -------------------------------------------

def _jadd(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1, z1 = a
    x2, y2, z2 = b
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return None
        return _jdbl(a)
    h = u2 - u1
    hh = h * h % P
    hhh = h * hh % P
    r = s2 - s1
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    z3 = h * z1 * z2 % P
    return (x3, y3, z3)


def _jdbl(a):
    if a is None:
        return None
    x, y, z = a
    if y == 0:
        return None
    ys = y * y % P
    s = 4 * x * ys % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * ys * ys) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def _jmul(k: int, pt):
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = _jadd(acc, add)
        add = _jdbl(add)
        k >>= 1
    return acc


def _affine(a):
    if a is None:
        return None
    x, y, z = a
    zi = pow(z, P - 2, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi * zi2 % P)


_G = (GX, GY, 1)


def _lift_x(x: int):
    """Even-Y point with given x (BIP-340 lift_x)."""
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if y & 1:
        y = P - y
    return (x, y)


def _decompress(pub33: bytes):
    if len(pub33) != 33 or pub33[0] not in (2, 3):
        return None
    x = int.from_bytes(pub33[1:], "big")
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != (pub33[0] & 1):
        y = P - y
    return (x, y)


# -- BIP-340 schnorr --------------------------------------------------------

def schnorr_verify(pub_x: int, msg32: bytes, sig: bytes) -> bool:
    if len(sig) != 64:
        return False
    pt = _lift_x(pub_x)
    if pt is None:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if r >= P or s >= N:
        return False
    e = int.from_bytes(_tagged_hash(
        "BIP0340/challenge",
        sig[:32] + pub_x.to_bytes(32, "big") + msg32), "big") % N
    # R = s*G - e*P
    rp = _jadd(_jmul(s, _G), _jmul(N - e, (pt[0], pt[1], 1)))
    ra = _affine(rp)
    if ra is None:
        return False
    return (ra[1] & 1) == 0 and ra[0] == r


def schnorr_sign(d: int, msg32: bytes, aux: bytes = b"\x00" * 32) -> bytes:
    pt = _affine(_jmul(d, _G))
    if pt[1] & 1:
        d = N - d
    px = pt[0].to_bytes(32, "big")
    t = (d ^ int.from_bytes(_tagged_hash("BIP0340/aux", aux),
                            "big")).to_bytes(32, "big")
    k0 = int.from_bytes(
        _tagged_hash("BIP0340/nonce", t + px + msg32), "big") % N
    if k0 == 0:
        raise ValueError("nonce is zero")
    rpt = _affine(_jmul(k0, _G))
    k = N - k0 if rpt[1] & 1 else k0
    rx = rpt[0].to_bytes(32, "big")
    e = int.from_bytes(
        _tagged_hash("BIP0340/challenge", rx + px + msg32), "big") % N
    sig = rx + ((k + e * d) % N).to_bytes(32, "big")
    assert schnorr_verify(pt[0], msg32, sig)
    return sig


# -- tendermint key wrappers -----------------------------------------------

@dataclass(frozen=True)
class PubKey(PubKeyBase):
    data: bytes  # 33-byte compressed

    def bytes(self) -> bytes:
        return self.data

    @property
    def type_name(self) -> str:
        return KEY_TYPE

    def address(self) -> bytes:
        """RIPEMD160(SHA256(pubkey)) (reference secp256k1.go:161)."""
        sha = hashlib.sha256(self.data).digest()
        try:
            rip = hashlib.new("ripemd160")
            rip.update(sha)
            return rip.digest()
        except ValueError:
            return _ripemd160_py(sha)

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(self.data) != 33 or self.data[0] not in (2, 3):
            return False
        # btcec schnorr.Verify is x-only: the parity byte must parse but
        # does not influence verification (reference secp256k1.go:203-212)
        if _decompress(self.data) is None:
            return False
        msg32 = hashlib.sha256(msg).digest()
        return schnorr_verify(int.from_bytes(self.data[1:], "big"), msg32,
                              sig)

    def __hash__(self):
        return hash((KEY_TYPE, self.data))


@dataclass(frozen=True)
class PrivKey(PrivKeyBase):
    secret: bytes  # 32 bytes

    @classmethod
    def gen_from_secret(cls, secret: bytes) -> "PrivKey":
        """GenPrivKeySecp256k1 (reference secp256k1.go:107-125):
        k = (sha256(secret) mod (n-1)) + 1."""
        fe = int.from_bytes(hashlib.sha256(secret).digest(), "big")
        k = fe % (N - 1) + 1
        return cls(k.to_bytes(32, "big"))

    def bytes(self) -> bytes:
        return self.secret

    @property
    def type_name(self) -> str:
        return KEY_TYPE

    def _d(self) -> int:
        d = int.from_bytes(self.secret, "big")
        if not (1 <= d < N):
            raise ValueError("invalid secp256k1 private key")
        return d

    def pub_key(self) -> PubKey:
        x, y = _affine(_jmul(self._d(), _G))
        return PubKey(bytes([2 + (y & 1)]) + x.to_bytes(32, "big"))

    def sign(self, msg: bytes) -> bytes:
        """BIP-340 over SHA-256(msg) (reference secp256k1.go:134-146),
        deterministic (zero aux randomness)."""
        return schnorr_sign(self._d(), hashlib.sha256(msg).digest())


def _ripemd160_py(data: bytes) -> bytes:
    """Pure-Python RIPEMD-160 fallback (some OpenSSL 3 builds disable the
    legacy provider).  Standard implementation of the 1996 spec."""
    import struct

    def rol(x, n):
        return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF

    r1 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
          7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
          3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
          1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
          4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
    r2 = [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
          6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
          15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
          8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
          12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
    s1 = [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
          7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
          11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
          11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
          9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
    s2 = [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
          9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
          9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
          15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
          8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]
    K1 = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
    K2 = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]

    def f(j, x, y, z):
        if j < 16:
            return x ^ y ^ z
        if j < 32:
            return (x & y) | (~x & z)
        if j < 48:
            return (x | ~y) ^ z
        if j < 64:
            return (x & z) | (y & ~z)
        return x ^ (y | ~z)

    msg = bytearray(data)
    bitlen = len(data) * 8
    msg.append(0x80)
    while len(msg) % 64 != 56:
        msg.append(0)
    msg += struct.pack("<Q", bitlen)
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    for off in range(0, len(msg), 64):
        x = struct.unpack("<16I", msg[off:off + 64])
        a1, b1, c1, d1, e1 = h
        a2, b2, c2, d2, e2 = h
        for j in range(80):
            t = (rol((a1 + f(j, b1, c1, d1) + x[r1[j]] + K1[j // 16])
                     & 0xFFFFFFFF, s1[j]) + e1) & 0xFFFFFFFF
            a1, e1, d1, c1, b1 = e1, d1, rol(c1, 10), b1, t
            t = (rol((a2 + f(79 - j, b2, c2, d2) + x[r2[j]] + K2[j // 16])
                     & 0xFFFFFFFF, s2[j]) + e2) & 0xFFFFFFFF
            a2, e2, d2, c2, b2 = e2, d2, rol(c2, 10), b2, t
        t = (h[1] + c1 + d2) & 0xFFFFFFFF
        h = [t, (h[2] + d1 + e2) & 0xFFFFFFFF,
             (h[3] + e1 + a2) & 0xFFFFFFFF,
             (h[4] + a1 + b2) & 0xFFFFFFFF,
             (h[0] + b1 + c2) & 0xFFFFFFFF]
    return struct.pack("<5I", *h)
