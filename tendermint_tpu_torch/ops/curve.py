"""Edwards25519 group operations on batched limb tensors — plain PyTorch.

The counterpart of tendermint_tpu/ops/curve.py: every coordinate is a
(NLIMB, *batch) int64 limb tensor (ops/field.py), so one `dbl` doubles B
points.  Representations (a = -1 twisted Edwards, Hisil-Wong-Carter-Dawson
2008):

  * extended  (X, Y, Z, T)       with x = X/Z, y = Y/Z, T = XY/Z
  * cached    (Y+X, Y-X, Z, 2dT) — precomputed form for general addition
  * niels     (y+x, y-x, 2dxy)   — cached with Z = 1, for fixed-base tables

The formulas and their carry placement are the JAX package's, so the
limbs of every result equal its limbs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import field as F

P = F.P

# d = -121665/121666 mod p
D_INT = (-121665 * pow(121666, P - 2, P)) % P
D2_INT = (2 * D_INT) % P
# sqrt(-1) = 2^((p-1)/4)
SQRT_M1_INT = pow(2, (P - 1) // 4, P)

# base point: y = 4/5, x chosen even (RFC 8032)
BY_INT = (4 * pow(5, P - 2, P)) % P


def _recover_x_int(y: int, sign: int) -> int:
    """Python bignum x-recovery (constant-table construction)."""
    xx = (y * y - 1) * pow(D_INT * y * y + 1, P - 2, P) % P
    x = pow(xx, (P + 3) // 8, P)
    if (x * x - xx) % P != 0:
        x = x * SQRT_M1_INT % P
    if (x * x - xx) % P != 0:
        raise ValueError("not a square")
    if x % 2 != sign:
        x = P - x
    return x


BX_INT = _recover_x_int(BY_INT, 0)


class Ext(NamedTuple):
    """Extended coordinates (X : Y : Z : T), T = XY/Z."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


class Cached(NamedTuple):
    """(Y+X, Y-X, Z, 2dT) — addition-ready form of an extended point."""
    ypx: torch.Tensor
    ymx: torch.Tensor
    z: torch.Tensor
    t2d: torch.Tensor


class Niels(NamedTuple):
    """(y+x, y-x, 2dxy) — affine cached form (Z = 1), for static tables."""
    ypx: torch.Tensor
    ymx: torch.Tensor
    t2d: torch.Tensor


def identity(batch=(), device=None) -> Ext:
    return Ext(F.zero(batch, device), F.one(batch, device),
               F.one(batch, device), F.zero(batch, device))


def to_cached(p: Ext) -> Cached:
    return Cached(F.carry_lazy(p.y + p.x), F.carry_lazy(p.y - p.x), p.z,
                  F.mul(p.t, F.const(D2_INT, p.t)))


# ---------------------------------------------------------------------------
# group law
# ---------------------------------------------------------------------------

def dbl(p: Ext, with_t: bool = True) -> Ext:
    """Point doubling (dbl-2008-hwcd, a = -1); ignores T of the input.
    Without with_t the T3 = E*H multiply is skipped and the input's T is
    passed through: valid when the next group op is another doubling.
    Independent products run as one batched product (F.mul_many)."""
    a, b, zsq, aa = F.mul_many([(p.x, p.x), (p.y, p.y), (p.z, p.z),
                                (p.x + p.y, p.x + p.y)])
    c = zsq + zsq
    e = aa - a - b
    g = b - a
    f = F.carry_lazy(g - c)
    h = -a - b
    if not with_t:
        return Ext(*F.mul_many([(e, f), (g, h), (f, g)]), p.t)
    return Ext(*F.mul_many([(e, f), (g, h), (f, g), (e, h)]))


def _add_tail(a, b, c, d2) -> Ext:
    e = a - b
    f = d2 - c
    g = F.carry_lazy(d2 + c)
    h = a + b
    return Ext(*F.mul_many([(e, f), (g, h), (f, g), (e, h)]))


def add_cached(p: Ext, q: Cached) -> Ext:
    """Unified addition p + q (add-2008-hwcd-3, a = -1); complete."""
    a, b, c, d = F.mul_many([(p.y + p.x, q.ypx), (p.y - p.x, q.ymx),
                             (p.t, q.t2d), (p.z, q.z)])
    return _add_tail(a, b, c, d + d)


def madd_niels(p: Ext, q: Niels) -> Ext:
    """p + q with q in niels form (Z2 = 1)."""
    a, b, c = F.mul_many([(p.y + p.x, q.ypx), (p.y - p.x, q.ymx),
                          (p.t, q.t2d)])
    return _add_tail(a, b, c, p.z + p.z)


def cond_neg_cached(q: Cached, neg: torch.Tensor) -> Cached:
    """Per lane: -q where `neg` (batch-shaped bool), else q."""
    return Cached(F.select(neg, q.ymx, q.ypx), F.select(neg, q.ypx, q.ymx),
                  q.z, F.select(neg, -q.t2d, q.t2d))


def cond_neg_niels(q: Niels, neg: torch.Tensor) -> Niels:
    return Niels(F.select(neg, q.ymx, q.ypx), F.select(neg, q.ypx, q.ymx),
                 F.select(neg, -q.t2d, q.t2d))


def cached_window(p: Ext):
    """Cached multiples j*p for j = 0..8 stacked on axis 0 (each field
    (9, NLIMB, *batch)), plus 8*p in extended form: 4 doublings + 3
    additions, identity at j = 0.  The signed-radix-16 window unit of the
    ladder's per-launch table and of the comb's table scan."""
    a1 = p
    a2 = dbl(a1)
    c1 = to_cached(a1)
    a3 = add_cached(a2, c1)
    a4 = dbl(a2)
    a5 = add_cached(a4, c1)
    a6 = dbl(a3)
    a7 = add_cached(a6, c1)
    a8 = dbl(a4)
    batch = p.x.shape[1:]
    dev = p.x.device
    ident = Cached(F.one(batch, dev), F.one(batch, dev), F.one(batch, dev),
                   F.zero(batch, dev))
    entries = [ident, c1] + [to_cached(q) for q in (a2, a3, a4, a5, a6, a7)]
    entries.append(to_cached(a8))
    return Cached(*(torch.stack([getattr(e, f) for e in entries])
                    for f in ("ypx", "ymx", "z", "t2d"))), a8


def comb_table_scan(p: Ext, windows: int = 64) -> Cached:
    """Fixed-base comb tables for a batch of base points: entry [i, j] =
    [j * 16^i] p in cached form, each field (windows, 9, NLIMB, *batch).
    The loop carries the running base [16^i] p: each window emits
    cached_window of it and advances it by one doubling of the 8x entry
    (16^{i+1} = 2 * 8 * 16^i).  The plain arithmetic of kernel C1 (the
    JAX package's lax.scan of the same steps)."""
    rows = []
    g = p
    for _ in range(windows):
        tab, a8 = cached_window(g)
        rows.append(tab)
        g = dbl(a8)
    return Cached(*(torch.stack([getattr(r, f) for r in rows])
                    for f in ("ypx", "ymx", "z", "t2d")))


# ---------------------------------------------------------------------------
# decompress / encode
# ---------------------------------------------------------------------------

def decompress(y_limbs: torch.Tensor, sign_bit: torch.Tensor):
    """RFC 8032 §5.1.3 point decompression, batched, with Go
    crypto/ed25519 semantics: a non-canonical y (y >= p) is accepted and
    reduced, x == 0 with sign = 1 is rejected, a non-square is rejected.

    y_limbs: (NLIMB, *batch) limbs of the y encoding, sign bit masked off;
    sign_bit: batch-shaped 0/1.  Returns (Ext point, ok: batch bool)."""
    sign_bit = sign_bit.bool()
    y = F.carry_lazy(y_limbs)
    yy = F.sqr(y)
    one = F.one(yy.shape[1:], yy.device)
    u = yy - one
    v = F.carry_lazy(F.mul(yy, F.const(D_INT, yy)) + one)
    v3 = F.mul(F.sqr(v), v)
    v7 = F.mul(F.sqr(v3), v)
    uv7 = F.mul(u, v7)
    x = F.mul(F.mul(u, v3), F.pow_p58(uv7))
    vxx = F.mul(v, F.sqr(x))
    ok_plus = F.eq(vxx, F.carry_lazy(u))
    ok_minus = F.eq(vxx, F.carry_lazy(-u))
    x = F.select(ok_minus, F.mul(x, F.const(SQRT_M1_INT, x)), x)
    ok = ok_plus | ok_minus
    ok = ok & ~(F.is_zero(x) & sign_bit)
    x = F.select(F.is_neg(x) != sign_bit, F.carry_lazy(-x), x)
    t = F.mul(x, y)
    return Ext(x, y, F.one(y.shape[1:], y.device), t), ok


def encode(p: Ext) -> torch.Tensor:
    """Canonical 32-byte little-endian encoding of an extended point as
    (32, *batch) int64 bytes: y with bit 255 = sign(x)."""
    zinv = F.invert(p.z)
    x = F.mul(p.x, zinv)
    y = F.mul(p.y, zinv)
    out = F.to_bytes(y)
    out[31] = out[31] | (F.is_neg(x).to(out.dtype) << 7)
    return out
