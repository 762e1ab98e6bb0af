"""Batched ristretto255 decoding and equality — plain PyTorch, over
ops/field.py.

The counterpart of tendermint_tpu/ops/ristretto.py (RFC 9496 §4.3.1
decode, §4.5 equality), the device half of the sr25519 lane: the arithmetic
of kernel S2's plain version (ops/cuda_sr25519.py).  The formulas and
their carry placement are the JAX package's, so the limbs of every result
equal its limbs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import curve as C
from . import field as F


def _sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor):
    """(was_square, r) with r = sqrt(u/v) (or sqrt(i u/v) when u/v is not a
    square), RFC 9496 §4.2; r is the nonnegative root."""
    sqrt_m1 = F.const(C.SQRT_M1_INT, u)
    v3 = F.mul(F.sqr(v), v)
    v7 = F.mul(F.sqr(v3), v)
    r = F.mul(F.mul(u, v3), F.pow_p58(F.mul(u, v7)))
    check = F.mul(v, F.sqr(r))
    neg_u = F.carry_lazy(-u)
    correct = F.eq(check, u)
    flipped = F.eq(check, neg_u)
    flipped_i = F.eq(check, F.mul(neg_u, sqrt_m1))
    r = F.select(flipped | flipped_i, F.mul(r, sqrt_m1), r)
    r = F.select(F.is_neg(r), F.carry_lazy(-r), r)      # CT_ABS
    return correct | flipped, r


def decode(s_limbs: torch.Tensor):
    """Batched ristretto255 decode from the (NLIMB, B) limbs of the
    encoding (the caller screens s < p and s even on the host).  Returns
    (Ext point, ok)."""
    batch = s_limbs.shape[1:]
    dev = s_limbs.device
    one = F.one(batch, dev)
    s = F.carry_lazy(s_limbs)
    ss = F.sqr(s)
    u1 = F.carry_lazy(one - ss)
    u2 = F.carry_lazy(one + ss)
    u2_sqr = F.sqr(u2)
    du1sq = F.mul(F.sqr(u1), F.const(C.D_INT, u1))
    v = F.carry_lazy(F.carry_lazy(-du1sq) - u2_sqr)
    was_square, invsqrt = _sqrt_ratio_m1(one, F.mul(v, u2_sqr))
    den_x = F.mul(invsqrt, u2)
    den_y = F.mul(F.mul(invsqrt, den_x), v)
    x = F.mul(s + s, den_x)
    x = F.select(F.is_neg(x), F.carry_lazy(-x), x)     # CT_ABS
    y = F.mul(u1, den_y)
    t = F.mul(x, y)
    ok = was_square & ~F.is_neg(t) & ~F.is_zero(y)
    return C.Ext(x, y, F.one(batch, dev), t), ok


def eq(p: C.Ext, q: C.Ext) -> torch.Tensor:
    """Ristretto equality (RFC 9496 §4.5, a = -1): x1 y2 == y1 x2 or
    y1 y2 == x1 x2."""
    a = F.eq(F.mul(p.x, q.y), F.mul(p.y, q.x))
    b = F.eq(F.mul(p.y, q.y), F.mul(p.x, q.x))
    return a | b


def bytes_canonical_nonneg(b: np.ndarray) -> np.ndarray:
    """Host screen for ristretto encodings: value < p and even (RFC 9496's
    IS_NEGATIVE on the canonical value).  b: (n, 32) uint8 -> (n,) bool."""
    w = np.ascontiguousarray(b).copy()
    high_ok = (w[:, 31] & 0x80) == 0      # bit 255 must be clear
    ww = w.view("<u8")
    top = np.uint64(0x7FFFFFFFFFFFFFFF)
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    lo = np.uint64(0xFFFFFFFFFFFFFFED)
    lt_p = ~((ww[:, 3] == top) & (ww[:, 2] == ones) & (ww[:, 1] == ones)
             & (ww[:, 0] >= lo)) & ((ww[:, 3] >> np.uint64(63)) == 0)
    even = (w[:, 0] & 1) == 0
    return high_ok & lt_p & even
