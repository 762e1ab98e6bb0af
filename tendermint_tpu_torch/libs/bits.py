"""BitArray — vote-presence bitmaps gossiped between peers (reference
libs/bits/bit_array.go)."""
from __future__ import annotations

import random
from typing import List, Optional


class BitArray:
    __slots__ = ("bits", "elems")

    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bits")
        self.bits = bits
        self.elems = bytearray((bits + 7) // 8)

    @classmethod
    def from_indices(cls, bits: int, indices) -> "BitArray":
        ba = cls(bits)
        for i in indices:
            ba.set_index(i, True)
        return ba

    def size(self) -> int:
        return self.bits

    def get_index(self, i: int) -> bool:
        if i >= self.bits or i < 0:
            return False
        return bool(self.elems[i // 8] & (1 << (i % 8)))

    def set_index(self, i: int, v: bool) -> bool:
        if i >= self.bits or i < 0:
            return False
        if v:
            self.elems[i // 8] |= 1 << (i % 8)
        else:
            self.elems[i // 8] &= ~(1 << (i % 8)) & 0xFF
        return True

    def copy(self) -> "BitArray":
        ba = BitArray(self.bits)
        ba.elems[:] = self.elems
        return ba

    def or_(self, other: "BitArray") -> "BitArray":
        ba = BitArray(max(self.bits, other.bits))
        for i, b in enumerate(self.elems):
            ba.elems[i] |= b
        for i, b in enumerate(other.elems):
            ba.elems[i] |= b
        return ba

    def and_(self, other: "BitArray") -> "BitArray":
        ba = BitArray(min(self.bits, other.bits))
        for i in range(len(ba.elems)):
            ba.elems[i] = self.elems[i] & other.elems[i]
        return ba

    def not_(self) -> "BitArray":
        ba = BitArray(self.bits)
        for i in range(len(ba.elems)):
            ba.elems[i] = ~self.elems[i] & 0xFF
        # mask tail bits beyond self.bits
        extra = len(ba.elems) * 8 - self.bits
        if extra:
            ba.elems[-1] &= 0xFF >> extra
        return ba

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (up to self.bits)."""
        ba = self.copy()
        n = min(len(self.elems), len(other.elems))
        for i in range(n):
            ba.elems[i] &= ~other.elems[i] & 0xFF
        return ba

    def is_empty(self) -> bool:
        return not any(self.elems)

    def is_full(self) -> bool:
        if self.bits == 0:
            return True
        full = all(b == 0xFF for b in self.elems[:-1])
        extra = len(self.elems) * 8 - self.bits
        last_mask = 0xFF >> extra
        return full and (self.elems[-1] & last_mask) == last_mask

    def pick_random(self, rng: Optional[random.Random] = None):
        """(index, True) of a random set bit, or (0, False) if empty
        (reference bit_array.go PickRandom)."""
        trues = self.get_true_indices()
        if not trues:
            return 0, False
        r = rng or random
        return r.choice(trues), True

    def get_true_indices(self) -> List[int]:
        return [i for i in range(self.bits) if self.get_index(i)]

    def num_true_bits(self) -> int:
        return sum(bin(b).count("1") for b in self.elems)

    def __eq__(self, other):
        return (isinstance(other, BitArray) and self.bits == other.bits
                and self.elems == other.elems)

    def __str__(self):
        return "".join("x" if self.get_index(i) else "_"
                       for i in range(self.bits))

    def to_bytes(self) -> bytes:
        return bytes(self.elems)

    @classmethod
    def from_bytes(cls, bits: int, data: bytes) -> "BitArray":
        ba = cls(bits)
        ba.elems[: len(data)] = data[: len(ba.elems)]
        return ba

    # -- proto codec (tendermint.libs.bits.BitArray) -----------------------
    # {int64 bits = 1; repeated uint64 elems = 2}: the reference stores
    # 64-bit words with bit i at word i/64, bit i%64 — identical overall
    # bit order to our little-endian byte layout.

    def proto(self) -> bytes:
        from tendermint_tpu_torch.libs import protoenc as pe

        nwords = (self.bits + 63) // 64
        padded = bytes(self.elems) + b"\0" * (nwords * 8 - len(self.elems))
        body = pe.varint_field(1, self.bits)
        if nwords:
            packed = b"".join(
                pe.uvarint(int.from_bytes(padded[8 * i:8 * i + 8], "little"))
                for i in range(nwords))
            body += pe.tag(2, pe.WT_BYTES) + pe.uvarint(len(packed)) + packed
        return body

    @classmethod
    def from_proto(cls, body: bytes) -> "BitArray":
        from tendermint_tpu_torch.libs import protodec as pd

        f = pd.parse(body)
        bits = pd.get_int(f, 1, 0)
        if bits < 0 or bits > 1 << 24:  # sanity cap on peer input
            raise pd.ProtoError(f"BitArray: bad size {bits}")
        words = pd.get_packed_uvarints(f, 2)
        ba = cls(bits)
        raw = b"".join(w.to_bytes(8, "little") for w in words)
        ba.elems[: len(raw)] = raw[: len(ba.elems)]
        return ba
