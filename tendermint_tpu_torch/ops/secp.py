"""Batched secp256k1 BIP-340 Schnorr verification on the GPU.

The counterpart of tendermint_tpu/ops/secp.py.  The host stages each
signature (range screens, the BIP-340 tagged-hash challenge) and kernel S1
(ops/cuda_secp.py, csrc/secp256k1_verify.cu) computes the verdicts, one
signature per group of four lanes: lift_x(P) with even y, R' = [s]G + [e](-P) by a
64-step unsigned radix-16 Straus ladder with complete Jacobian additions,
then R' finite, y(R') even and x(R') = r.

This module also holds the verdict's plain PyTorch version (_verify_core,
over ops/field_secp.py), the JAX package's formulas one for one: the
Jacobian dbl (dbl-2009-l) and the complete add (add-2007-bl with per-lane
selects for infinity operands, P = Q and P = -Q — an attacker controls
(s, P), so a formula breakdown would be attacker-steerable), the table
j(-P), j = 0..15, and the ladder.  S1's wrapper runs it for CPU tensors.
"""
from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from tendermint_tpu_torch import resolve_device
from . import field_secp as FS

# The device lane is on by default; set_lane_enabled(False) or
# TM_TPU_SECP_LANE=0 is the rollback switch to the host C lane
# (crypto/batch._device_verifier reads use_lane()).  The node's
# `[batch_verifier] secp_lane` config key attaches to set_lane_enabled()
# with node wiring.
_lane_override: "bool | None" = None


def set_lane_enabled(on: "bool | None"):
    """Override of the device-lane default (wins over the env, both
    directions).  None clears the override so TM_TPU_SECP_LANE governs
    again."""
    global _lane_override
    _lane_override = None if on is None else bool(on)


def use_lane() -> bool:
    if _lane_override is not None:
        return _lane_override
    # the rollback accepts the natural spellings, not just "0"
    return os.environ.get("TM_TPU_SECP_LANE", "1").strip().lower() \
        not in ("0", "false", "off", "no")


P = FS.P
# group order
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


class Jac(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def infinity(batch=(), device=None) -> Jac:
    return Jac(FS.one(batch, device), FS.one(batch, device),
               FS.zero(batch, device))


def dbl(p: Jac) -> Jac:
    """dbl-2009-l (a = 0).  Complete for every input but y = 0 points
    (none exist on x^3 + 7), and maps infinity (z = 0) to z = 0."""
    a = FS.sqr(p.x)
    b = FS.sqr(p.y)
    c = FS.sqr(b)
    d = FS.carry(2 * (FS.sqr(FS.carry(p.x + b)) - a - c))
    e = FS.carry(3 * a)
    f = FS.sqr(e)
    x3 = FS.carry(f - 2 * d)
    y3 = FS.carry(FS.mul(e, FS.carry(d - x3)) - FS.carry(8 * c))
    z3 = FS.carry(2 * FS.mul(p.y, p.z))
    return Jac(x3, y3, z3)


def _sel(cond, a: Jac, b: Jac) -> Jac:
    return Jac(FS.select(cond, a.x, b.x), FS.select(cond, a.y, b.y),
               FS.select(cond, a.z, b.z))


def add(p: Jac, q: Jac) -> Jac:
    """Complete addition: add-2007-bl with per-lane selects for the
    degenerate cases (infinity operands, P = Q -> dbl, P = -Q ->
    infinity)."""
    z1z1 = FS.sqr(p.z)
    z2z2 = FS.sqr(q.z)
    u1 = FS.mul(p.x, z2z2)
    u2 = FS.mul(q.x, z1z1)
    s1 = FS.mul(FS.mul(p.y, q.z), z2z2)
    s2 = FS.mul(FS.mul(q.y, p.z), z1z1)
    h = FS.carry(u2 - u1)
    i = FS.sqr(FS.carry(2 * h))
    j = FS.mul(h, i)
    r = FS.carry(2 * (s2 - s1))
    v = FS.mul(u1, i)
    x3 = FS.carry(FS.sqr(r) - j - 2 * v)
    y3 = FS.carry(FS.mul(r, FS.carry(v - x3)) - 2 * FS.mul(s1, j))
    z3 = FS.mul(FS.carry(FS.sqr(FS.carry(p.z + q.z)) - z1z1 - z2z2), h)
    generic = Jac(x3, y3, z3)

    inf1 = FS.is_zero(p.z)
    inf2 = FS.is_zero(q.z)
    same_x = FS.is_zero(h)
    same_y = FS.is_zero(r)
    ident = infinity(h.shape[1:], h.device)
    out = _sel(same_x & same_y, dbl(p), generic)               # P = Q
    out = _sel(same_x & ~same_y & ~inf1 & ~inf2, ident, out)   # P = -Q
    out = _sel(inf2, p, out)
    return _sel(inf1, q, out)


def _g_table_np():
    """Affine multiples j*G, j = 0..15, as Jacobian rows (z = 0 for j = 0,
    z = 1 otherwise): three (16, NLIMB) int64 arrays."""
    pts = g_multiples()
    xs = np.stack([FS.int_to_limbs(p[0] if p else 1) for p in pts])
    ys = np.stack([FS.int_to_limbs(p[1] if p else 1) for p in pts])
    zs = np.stack([FS.int_to_limbs(0 if p is None else 1) for p in pts])
    return xs, ys, zs


def g_multiples():
    """[None, G, 2G, ..., 15G] as affine (x, y) integer pairs."""
    def aff_add(a, b):
        (x1, y1), (x2, y2) = a, b
        if x1 == x2 and (y1 + y2) % P == 0:
            return None
        lam = ((3 * x1 * x1) * pow(2 * y1, P - 2, P)) % P if a == b \
            else ((y2 - y1) * pow(x2 - x1, P - 2, P)) % P
        x3 = (lam * lam - x1 - x2) % P
        return (x3, (lam * (x1 - x3) - y1) % P)

    pts = [None, (GX, GY)]
    for _ in range(14):
        pts.append(aff_add(pts[-1], (GX, GY)))
    return pts


_g_cache: dict = {}


def _g_table(dev: torch.device):
    key = str(dev)
    if key not in _g_cache:
        _g_cache[key] = tuple(torch.from_numpy(t).to(dev)
                              for t in _g_table_np())
    return _g_cache[key]


def _p_table(negp: Jac) -> Jac:
    """j(-P), j = 0..15, as stacked (16, NLIMB, B) coordinates: 1 dbl and
    13 complete adds."""
    batch = negp.x.shape[1:]
    d = dbl(negp)
    pts = [infinity(batch, negp.x.device), negp, d]
    acc = d
    for _ in range(13):
        acc = add(acc, negp)
        pts.append(acc)
    return Jac(*(torch.stack([getattr(p, f) for p in pts])
                 for f in ("x", "y", "z")))


def _gather16(digit: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Per-lane row digit (0..15) of a (16, NLIMB, B) stack."""
    idx = digit.reshape(1, 1, -1).expand(1, FS.NLIMB, digit.shape[0])
    return torch.gather(rows, 0, idx)[0]


def _verify_core(px_limbs, rx_limbs, s_digits, e_digits) -> torch.Tensor:
    """px/rx: (NLIMB, B) field limbs; s/e digits: (64, B) unsigned
    radix-16, most significant first.  Returns (B,) bool (the JAX
    package's _verify_core)."""
    batch = px_limbs.shape[1:]
    dev = px_limbs.device
    s_digits = s_digits.long()
    e_digits = e_digits.long()
    # lift_x: the even-y point with x = px (BIP-340)
    xx = FS.sqr(px_limbs)
    x3p7 = FS.carry(FS.mul(xx, px_limbs) + FS.one(batch, dev) * 7)
    y = FS.sqrt(x3p7)
    decode_ok = FS.eq(FS.sqr(y), x3p7)
    y = FS.select(FS.is_odd(y), FS.carry(-y), y)
    negp = Jac(px_limbs, FS.carry(-y), FS.one(batch, dev))
    ptab = _p_table(negp)
    gx, gy, gz = _g_table(dev)
    acc = infinity(batch, dev)
    for i in range(64):
        acc = dbl(dbl(dbl(dbl(acc))))
        ds = s_digits[i]
        acc = add(acc, Jac(gx[ds].t(), gy[ds].t(), gz[ds].t()))
        de = e_digits[i]
        acc = add(acc, Jac(_gather16(de, ptab.x), _gather16(de, ptab.y),
                           _gather16(de, ptab.z)))
    inf = FS.is_zero(acc.z)
    zi = FS.invert(acc.z)
    zi2 = FS.sqr(zi)
    x_aff = FS.mul(acc.x, zi2)
    y_aff = FS.mul(acc.y, FS.mul(zi2, zi))
    return decode_ok & ~inf & FS.eq(x_aff, rx_limbs) & ~FS.is_odd(y_aff)


# ---------------------------------------------------------------------------
# host staging
# ---------------------------------------------------------------------------

def _tagged_hash(tag: str, data: bytes) -> bytes:
    th = hashlib.sha256(tag.encode()).digest()
    return hashlib.sha256(th + th + data).digest()


def _nibbles_be(rows: np.ndarray) -> np.ndarray:
    """(B, 32) big-endian scalar bytes -> (64, B) int32 nibbles, most
    significant first."""
    out = np.empty((rows.shape[0], 64), dtype=np.int32)
    out[:, 0::2] = rows >> 4
    out[:, 1::2] = rows & 0x0F
    return np.ascontiguousarray(out.T)


def _limbs_of_be(rows: np.ndarray) -> np.ndarray:
    """(B, 32) big-endian field-element bytes -> (NLIMB, B) limbs of the
    full 256-bit value."""
    le = rows[:, ::-1].astype(np.int64)
    out = np.zeros((FS.NLIMB, rows.shape[0]), dtype=np.int32)
    for limb in range(FS.NLIMB):
        b0, sh = divmod(FS.RADIX * limb, 8)
        v = le[:, b0] >> sh
        if b0 + 1 < 32:
            v = v | (le[:, b0 + 1] << (8 - sh))
        out[limb] = v & FS.MASK
    return out


def stage(pubs, msgs, sigs):
    """Host staging of n well-formed triples (33-byte keys with a parity
    byte, 64-byte signatures): the BIP-340 range screens (x < p, r < p,
    s < N) and the challenge e = H_tag(r || x || sha256(msg)) mod N.
    Returns (rows (n, 128) uint8 — px | rx | s | e, big-endian, zero on a
    screened lane — and host_ok (n,) bool)."""
    n = len(pubs)
    rows = np.zeros((n, 128), dtype=np.uint8)
    host_ok = np.zeros(n, dtype=bool)
    for i in range(n):
        pub = bytes(pubs[i])
        sig = bytes(sigs[i])
        px_i = int.from_bytes(pub[1:], "big")
        r_i = int.from_bytes(sig[:32], "big")
        s_i = int.from_bytes(sig[32:], "big")
        if px_i >= P or r_i >= P or s_i >= N:
            continue  # BIP-340 range screens
        m32 = hashlib.sha256(bytes(msgs[i])).digest()
        e_i = int.from_bytes(
            _tagged_hash("BIP0340/challenge", sig[:32] + pub[1:] + m32),
            "big") % N
        rows[i] = np.frombuffer(pub[1:] + sig + e_i.to_bytes(32, "big"),
                                np.uint8)
        host_ok[i] = True
    return rows, host_ok


def verify_batch_device(pubs, msgs, sigs, device=None) -> np.ndarray:
    """Batched BIP-340 verify: host staging and kernel S1.  pubs: 33-byte
    compressed keys (x-only semantics; the parity byte must parse); sigs:
    64-byte (r, s) big-endian.  Malformed lengths are rejected host-side
    without poisoning the batch.  The lanes are padded to bucket_size(n)
    (as the JAX package pads them).  device: "cuda" (default) launches
    S1; "cpu" runs its plain version."""
    from tendermint_tpu_torch.libs import fail

    # chaos seam: fires at entry, before any staging or launch, so the
    # degradation runtime sees an injected fault as a device-lane fault
    fail.inject("ops.secp.verify_batch")
    dev = resolve_device(device)
    n = len(pubs)
    if n == 0:
        return np.zeros(0, dtype=bool)
    ok_len = np.array([
        len(pubs[i]) == 33 and bytes(pubs[i])[0] in (2, 3)
        and len(sigs[i]) == 64 for i in range(n)])
    if not ok_len.all():
        good = np.flatnonzero(ok_len)
        if good.size == 0:
            return ok_len
        out = np.zeros(n, dtype=bool)
        out[good] = verify_batch_device([pubs[i] for i in good],
                                        [msgs[i] for i in good],
                                        [sigs[i] for i in good], device=dev)
        return out
    rows, host_ok = stage(pubs, msgs, sigs)
    from . import cuda_secp
    from .ed25519 import bucket_size

    nb = bucket_size(n)
    packed = np.zeros((128, nb), dtype=np.uint8)   # lane-major
    packed[:, :n] = rows.T
    bits = cuda_secp.verify_rows(torch.from_numpy(packed).to(dev))
    return bits.cpu().numpy()[:n] & host_ok
