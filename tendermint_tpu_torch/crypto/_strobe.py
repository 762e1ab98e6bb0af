"""Minimal STROBE-128 v1.0.2 — exactly the subset merlin transcripts use
(mirrors the behavior consumed by reference crypto/sr25519 via
go-schnorrkel -> merlin).

Operations: AD (meta_AD for framing), PRF, KEY.  Keccak-f[1600] permutation
implemented directly (hashlib's sha3 cannot expose the raw permutation).
"""
from __future__ import annotations

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]

_M64 = (1 << 64) - 1


def _rol(v, n):
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _M64 if n else v


def keccak_f1600(lanes):
    """In-place Keccak-f[1600] on a 5x5 list of 64-bit lanes [x][y]."""
    a = lanes
    for rnd in range(24):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y] & _M64)
                                     & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= _RC[rnd]
    return a


class Strobe128:
    """STROBE-128 duplex with 200-byte state, R = 166 (merlin's security
    level 128)."""

    R = 166  # rate in bytes for sec=128: 200 - (2*128)/8 - 2

    # flags
    F_I, F_A, F_C, F_T, F_M, F_K = 1, 2, 4, 8, 16, 32

    def __init__(self, protocol_label: bytes):
        # initial state: F([0x01, R+2, 0x01, 0x00, 0x01, 0x60] + "STROBEv1.0.2")
        st = bytearray(200)
        seed = bytes([1, self.R + 2, 1, 0, 1, 12 * 8]) + b"STROBEv1.0.2"
        st[:len(seed)] = seed
        self._state = st
        self._permute()
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- sponge internals --------------------------------------------------

    def _permute(self):
        lanes = [[int.from_bytes(self._state[8 * (x + 5 * y):
                                             8 * (x + 5 * y) + 8], "little")
                  for y in range(5)] for x in range(5)]
        keccak_f1600(lanes)
        for x in range(5):
            for y in range(5):
                self._state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8] = \
                    lanes[x][y].to_bytes(8, "little")

    def _run_f(self):
        self._state[self.pos] ^= self.pos_begin
        self._state[self.pos + 1] ^= 0x04
        self._state[self.R + 1] ^= 0x80
        self._permute()
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for b in data:
            self._state[self.pos] ^= b
            self.pos += 1
            if self.pos == self.R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self._state[self.pos])
            self._state[self.pos] = 0
            self.pos += 1
            if self.pos == self.R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert flags == self.cur_flags, "'more' must continue same op"
            return
        assert not (flags & self.F_T), "transport not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (self.F_C | self.F_K)) and self.pos != 0:
            self._run_f()

    # -- merlin's operation subset ----------------------------------------

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(self.F_M | self.F_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(self.F_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(self.F_I | self.F_A | self.F_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool = False):
        self._begin_op(self.F_A | self.F_C, more)
        # overwrite (duplex with C flag on absorb = cipher): set state byte
        for b in data:
            self._state[self.pos] = b
            self.pos += 1
            if self.pos == self.R:
                self._run_f()


class MerlinTranscript:
    """merlin transcript over Strobe128 (merlin.rs semantics, consumed via
    go-schnorrkel in reference crypto/sr25519/privkey.go:24-33)."""

    PROTO = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = Strobe128(self.PROTO)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label
                            + len(message).to_bytes(4, "little"), False)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, n: int):
        self.append_message(label, n.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label + n.to_bytes(4, "little"), False)
        return self.strobe.prf(n)

    def witness_bytes(self, label: bytes, nonce_seeds, n: int,
                      rng_bytes: bytes) -> bytes:
        """schnorrkel witness: fork the transcript, rekey with witness data
        + rng, squeeze."""
        s = self._clone()
        for seed in nonce_seeds:
            s.meta_ad(label + len(seed).to_bytes(4, "little"), False)
            s.key(seed)
        s.meta_ad(b"rng" + len(rng_bytes).to_bytes(4, "little"), False)
        s.key(rng_bytes)
        s.meta_ad(b"" + n.to_bytes(4, "little"), False)
        return s.prf(n)

    def _clone(self) -> Strobe128:
        import copy
        return copy.deepcopy(self.strobe)
