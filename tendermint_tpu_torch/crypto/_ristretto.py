"""ristretto255 group (RFC 9496) over edwards25519 — pure-Python host
implementation backing sr25519 (schnorrkel).  Checked against the RFC's
published encodings of the basepoint multiples."""
from __future__ import annotations

P = 2**255 - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# basepoint (same as ed25519)
BY = 4 * pow(5, P - 2, P) % P
BX_ = pow((BY * BY - 1) * pow(D * BY * BY + 1, P - 2, P), (P + 3) // 8, P)
if (BX_ * BX_ - (BY * BY - 1) * pow(D * BY * BY + 1, P - 2, P)) % P != 0:
    BX_ = BX_ * SQRT_M1 % P
BX = P - BX_ if BX_ & 1 else BX_   # even (positive) x


def _is_neg(x: int) -> bool:
    return bool(x & 1)


def sqrt_ratio_m1(u: int, v: int):
    """(was_square, sqrt(u/v) or sqrt(i*u/v)) per RFC 9496 §4.2."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u_neg = (P - u) % P
    correct = check == u % P
    flipped = check == u_neg
    flipped_i = check == u_neg * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    if _is_neg(r):
        r = P - r
    return (correct or flipped), r


INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)[1]


class Point:
    """Extended edwards coords (X, Y, Z, T), ristretto-encoded/decoded."""

    __slots__ = ("x", "y", "z", "t")

    def __init__(self, x, y, z, t):
        self.x, self.y, self.z, self.t = x, y, z, t

    @classmethod
    def identity(cls) -> "Point":
        return cls(0, 1, 1, 0)

    @classmethod
    def base(cls) -> "Point":
        return cls(BX, BY, 1, BX * BY % P)

    def add(self, q: "Point") -> "Point":
        # add-2008-hwcd-3 (a=-1)
        a = (self.y - self.x) * (q.y - q.x) % P
        b = (self.y + self.x) * (q.y + q.x) % P
        c = self.t * 2 * D % P * q.t % P
        dd = self.z * 2 * q.z % P
        e, f, g, h = b - a, dd - c, dd + c, b + a
        return Point(e * f % P, g * h % P, f * g % P, e * h % P)

    def dbl(self) -> "Point":
        a = self.x * self.x % P
        b = self.y * self.y % P
        c = 2 * self.z * self.z % P
        h = a + b
        e = h - (self.x + self.y) ** 2 % P
        g = a - b
        f = c + g
        return Point(e * f % P, g * h % P, f * g % P, e * h % P)

    def mul(self, k: int) -> "Point":
        k %= L
        acc = Point.identity()
        add = self
        while k:
            if k & 1:
                acc = acc.add(add)
            add = add.dbl()
            k >>= 1
        return acc

    def neg(self) -> "Point":
        return Point(P - self.x if self.x else 0, self.y, self.z,
                     P - self.t if self.t else 0)

    def equals(self, q: "Point") -> bool:
        """Ristretto equality (RFC 9496 §4.5, a = -1):
        x1*y2 == y1*x2 or y1*y2 == x1*x2."""
        return (self.x * q.y % P == self.y * q.x % P
                or self.y * q.y % P == self.x * q.x % P)

    # -- encoding (RFC 9496 §4.3.2) ---------------------------------------

    def encode(self) -> bytes:
        x0, y0, z0, t0 = self.x, self.y, self.z, self.t
        u1 = (z0 + y0) * (z0 - y0) % P
        u2 = x0 * y0 % P
        _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * t0 % P
        ix0 = x0 * SQRT_M1 % P
        iy0 = y0 * SQRT_M1 % P
        enchanted = den1 * INVSQRT_A_MINUS_D % P
        rotate = _is_neg(t0 * z_inv % P)
        if rotate:
            x, y, den_inv = iy0, ix0, enchanted
        else:
            x, y, den_inv = x0, y0, den2
        if _is_neg(x * z_inv % P):
            y = (P - y) % P
        s = den_inv * ((z0 - y) % P) % P
        if _is_neg(s):
            s = P - s
        return s.to_bytes(32, "little")

    @classmethod
    def decode(cls, data: bytes):
        """Returns a Point or None (RFC 9496 §4.3.1)."""
        if len(data) != 32:
            return None
        s = int.from_bytes(data, "little")
        if s >= P or _is_neg(s):
            return None
        ss = s * s % P
        u1 = (1 - ss) % P
        u2 = (1 + ss) % P
        u2_sqr = u2 * u2 % P
        v = (-(D * u1 % P * u1) - u2_sqr) % P
        ok, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
        den_x = invsqrt * u2 % P
        den_y = invsqrt * den_x % P * v % P
        x = 2 * s % P * den_x % P
        if _is_neg(x):
            x = P - x
        y = u1 * den_y % P
        t = x * y % P
        if not ok or _is_neg(t) or y == 0:
            return None
        return cls(x, y, 1, t)


def scalar_from_wide(b64: bytes) -> int:
    """64 uniform bytes -> scalar mod L (schnorrkel challenge scalars)."""
    return int.from_bytes(b64, "little") % L
