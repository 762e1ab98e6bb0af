"""GF(2^256 - 2^32 - 977) — the secp256k1 base field — on limb tensors,
plain PyTorch.

The counterpart of tendermint_tpu/ops/field_secp.py, with the same
representation so that every intermediate can be compared limb for limb:
NLIMB = 22 signed limbs in radix 2^12 along axis 0, the batch along the
trailing axes.  The JAX package holds the limbs in int32; here they are
int64 (as ops/field.py), so every value is the same integer.

This is the arithmetic of kernel S1's plain version (ops/secp.py); the
CUDA kernel keeps its own field (csrc/fe_secp.cuh: eight 32-bit limbs,
canonical values), held against this one as canonical values.

Reduction: 22 limbs * 12 bits = 264 bits and
    2^264 = 2^8 * 2^256 = 2^8 * (2^32 + 977) = 2^40 + 250112 (mod p)
so a coefficient of weight 2^264 folds back as 256 at limb 0, 61 at limb 1
(250112 = 61 * 2^12 + 256) and 16 at limb 3 (2^40 = 16 * 2^36); the
in-carry fold at 2^256 (bit 4 of limb 21) adds co * 977 at limb 0 and
co * 256 at limb 2 (2^32 = 256 * 2^24).
"""
from __future__ import annotations

import numpy as np
import torch

RADIX = 12
NLIMB = 22
MASK = (1 << RADIX) - 1
TOTAL_BITS = RADIX * NLIMB  # 264

P = (1 << 256) - (1 << 32) - 977

DTYPE = torch.int64

_TOP_BITS = 256 - RADIX * (NLIMB - 1)  # 4: bits of limb 21 below 2^256


# ---------------------------------------------------------------------------
# host <-> limb conversion
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> (NLIMB,) int64 limbs of x mod p."""
    x %= P
    out = np.zeros(NLIMB, dtype=np.int64)
    for i in range(NLIMB):
        out[i] = (x >> (RADIX * i)) & MASK
    return out


def limbs_to_int(limbs) -> int:
    """(NLIMB,) limbs -> Python int (not reduced)."""
    v = 0
    for i, limb in enumerate(np.asarray(limbs).tolist()):
        v += int(limb) << (RADIX * i)
    return v


# ---------------------------------------------------------------------------
# carries
# ---------------------------------------------------------------------------

def _carry_pass(v: torch.Tensor) -> torch.Tensor:
    """One vectorized carry-save pass with the 2^256 fold: carries shift
    up one limb; the top limb splits at 2^256 and that carry co folds back
    as co*977 at limb 0 and co*256 at limb 2 (signed 12-bit digit split)."""
    c = v >> RADIX
    r = v & MASK
    co = v[-1] >> _TOP_BITS
    r[-1] = v[-1] & ((1 << _TOP_BITS) - 1)
    r[1:] += c[:-1]
    co_hi = (co + (1 << (RADIX - 1))) >> RADIX
    co_lo = co - (co_hi << RADIX)
    r[0] += 977 * co_lo
    r[1] += 977 * co_hi
    r[2] += 256 * co_lo
    r[3] += 256 * co_hi
    return r


def _tail_pass(v: torch.Tensor) -> torch.Tensor:
    v = v.clone()
    c0 = v[0] >> RADIX
    v[0] = v[0] & MASK
    v[1] += c0
    return v


def carry(c: torch.Tensor) -> torch.Tensor:
    """Signed limbs -> loose-carried form: three passes and the tail, as
    the JAX package."""
    return _tail_pass(_carry_pass(_carry_pass(_carry_pass(c))))


def carry_lazy(c: torch.Tensor) -> torch.Tensor:
    """carry() for operands bounded by a few lazy adds: two passes and the
    tail."""
    return _tail_pass(_carry_pass(_carry_pass(c)))


# ---------------------------------------------------------------------------
# ring ops
# ---------------------------------------------------------------------------

def zero(batch=(), device=None) -> torch.Tensor:
    return torch.zeros((NLIMB,) + tuple(batch), dtype=DTYPE, device=device)


def one(batch=(), device=None) -> torch.Tensor:
    z = zero(batch, device)
    z[0] = 1
    return z


def _bcast(a: torch.Tensor, b: torch.Tensor):
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    return (a.expand((NLIMB,) + batch), b.expand((NLIMB,) + batch), batch)


_CONV_COL = (np.arange(NLIMB)[:, None] + np.arange(NLIMB)[None, :]).reshape(-1)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook convolution columns (2*NLIMB - 1, *batch); exact integer
    sums, so the same columns as the JAX package's padded partial sums."""
    a, b, batch = _bcast(a, b)
    prod = (a.reshape(NLIMB, 1, -1) * b.reshape(1, NLIMB, -1)).reshape(
        NLIMB * NLIMB, -1)
    col = torch.from_numpy(_CONV_COL).to(prod.device)
    c = torch.zeros((2 * NLIMB - 1, prod.shape[1]), dtype=DTYPE,
                    device=prod.device).index_add_(0, col, prod)
    return c.reshape((2 * NLIMB - 1,) + batch)


def _reduce_wide(c: torch.Tensor) -> torch.Tensor:
    """(2N-1, ...) convolution columns -> loose limbs (field_secp.
    _reduce_wide of the JAX package): each high column h at offset t is
    split into three signed 12-bit digits whose multiples 256, 61 and 16
    land at t, t+1 and t+3; the columns that land at limb 22 and beyond
    wrap once more with the same rule."""
    lo = c[:NLIMB].clone()
    hi = c[NLIMB:]  # 21 columns, t = 0..20
    h_hi = (hi + (1 << (RADIX - 1))) >> RADIX
    h0 = hi - (h_hi << RADIX)
    h2 = (h_hi + (1 << (RADIX - 1))) >> RADIX
    h1 = h_hi - (h2 << RADIX)
    ext = torch.zeros((NLIMB + 6,) + tuple(c.shape[1:]), dtype=DTYPE,
                      device=c.device)
    for mult, off in ((256, 0), (61, 1), (16, 3)):
        for dig, sh in ((h0, 0), (h1, 1), (h2, 2)):
            ext[off + sh:off + sh + 21] += mult * dig
    lo = lo + ext[:NLIMB]
    over = ext[NLIMB:]
    for mult, off in ((256, 0), (61, 1), (16, 3)):
        lo[off:off + 6] += mult * over
    return carry(lo)


def add(a, b):
    return a + b  # lazy


def sub(a, b):
    return a - b  # lazy


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply; loose-carried output."""
    return _reduce_wide(_conv(a, b))


def sqr(a: torch.Tensor) -> torch.Tensor:
    """Field square (the same column sums as the JAX package's
    doubled-cross-term square, so the same limbs)."""
    return _reduce_wide(_conv(a, a))


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    return carry(a * k)


# ---------------------------------------------------------------------------
# canonicalization / predicates
# ---------------------------------------------------------------------------

def _carry_chain(c: torch.Tensor, out_len: int):
    outs = []
    cy = torch.zeros_like(c[0])
    for i in range(c.shape[0]):
        v = c[i] + cy
        outs.append(v & MASK)
        cy = v >> RADIX
    while len(outs) < out_len:
        outs.append(cy & MASK)
        cy = cy >> RADIX
    return torch.stack(outs), cy


_TWO_P = np.array([(2 * P >> (RADIX * i)) & MASK for i in range(NLIMB)],
                  dtype=np.int64)


def _freeze_pass(a: torch.Tensor) -> torch.Tensor:
    """One quotient-estimate pass: q = floor((a + 2^32 + 977) / 2^256),
    then a - q p = a - q 2^256 + q (2^32 + 977)."""
    t_in = a.clone()
    t_in[0] += 977
    t_in[2] += 256
    t, co = _carry_chain(t_in, NLIMB)
    q = (t[NLIMB - 1] >> _TOP_BITS) + (co << (RADIX - _TOP_BITS))
    a = a.clone()
    a[0] += 977 * q
    a[2] += 256 * q
    a[NLIMB - 1] -= q << _TOP_BITS
    out, _ = _carry_chain(a, NLIMB)
    return out


def freeze(a: torch.Tensor) -> torch.Tensor:
    """Any-bounds limbs -> canonical representative in [0, p)."""
    v = carry(a)
    v = v + torch.from_numpy(_TWO_P).to(v.device).reshape(
        (NLIMB,) + (1,) * (v.dim() - 1))
    return _freeze_pass(_freeze_pass(v))


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b, _ = _bcast(a, b)
    return (freeze(a) == freeze(b)).all(0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (freeze(a) == 0).all(0)


def is_odd(a: torch.Tensor) -> torch.Tensor:
    return (freeze(a)[0] & 1).bool()


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per-element select over the batch: cond has the batch shape."""
    a, b, batch = _bcast(a, b)
    return torch.where(cond.expand(batch).unsqueeze(0), a, b)


# ---------------------------------------------------------------------------
# exponentiation
# ---------------------------------------------------------------------------

def _pow_fixed(a: torch.Tensor, e: int) -> torch.Tensor:
    """MSB-first square-and-multiply by a fixed public exponent: the JAX
    package's scan computes the multiply on every bit and selects it on
    the 1 bits; the exponent is public, so here the multiply runs only on
    those bits — the same limbs."""
    acc = a
    for bit in bin(e)[3:]:
        acc = sqr(acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


def invert(a: torch.Tensor) -> torch.Tensor:
    return _pow_fixed(a, P - 2)


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """p = 3 (mod 4): sqrt(a) = a^((p+1)/4) when a is a square; the caller
    checks sqr(result) == a."""
    return _pow_fixed(a, (P + 1) // 4)
