"""Batched sr25519 (schnorrkel) verification on the GPU.

The counterpart of tendermint_tpu/ops/sr25519.py.  sr25519 lives on the
same curve as ed25519 (ristretto-encoded), so the lane reuses the ed25519
stack and only the encoding differs:

  host    the merlin transcript challenge k (native C tm_sr25519_stage;
          the pure-Python crypto/_strobe.py fallback), s canonicity and
          the schnorrkel marker bit, the ristretto byte screens
  device  kernel S2 (ops/cuda_sr25519.py, csrc/sr25519_verify.cu):
          ristretto decode of A and R, the ladder [s]B + [k](-A),
          ristretto equality with R

Per-signature exact (no RLC): each lane reproduces schnorrkel's accept or
reject, so the bitmap names offenders, as the host C lane does
(native/ecverify.c tm_sr25519_verify).
"""
from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch import resolve_device
from . import curve as C
from . import field as F
from . import ristretto


def _limbs256(b: torch.Tensor) -> torch.Tensor:
    """(32, n) byte rows -> (NLIMB, n) limbs of the full 256-bit value
    (ops/ed25519.bytes256_to_limbs of the JAX package, unmasked)."""
    from .cuda_ed25519 import _bytes_to_limbs12
    return _bytes_to_limbs12(b.to(F.DTYPE) & 0xFF, F.NLIMB)


def _verify_core(pub_bytes, r_bytes, s_digits, k_digits) -> torch.Tensor:
    """pub/r: (n, 32) uint8 ristretto encodings; s/k digits: (n, 64) int8
    signed radix-16, least significant first.  Returns (n,) bool (the JAX
    package's _verify_core)."""
    from .ed25519 import straus_ladder
    a_pt, a_ok = ristretto.decode(_limbs256(pub_bytes.t()))
    r_pt, r_ok = ristretto.decode(_limbs256(r_bytes.t()))
    neg_a = C.Ext(F.carry_lazy(-a_pt.x), a_pt.y, a_pt.z,
                  F.carry_lazy(-a_pt.t))
    p = straus_ladder(neg_a, s_digits.long().t(), k_digits.long().t())
    return a_ok & r_ok & ristretto.eq(p, r_pt)


def _stage_host(pubs, msgs, sigs):
    """(k (n, 32), s (n, 32), ok (n,)) via the C stager, the pure-Python
    merlin transcript otherwise."""
    from tendermint_tpu_torch.libs import native

    res = native.sr25519_stage(pubs, msgs, sigs)
    if res is not None:
        return res
    from tendermint_tpu_torch.crypto import sr25519 as srpy

    n = len(pubs)
    k = np.zeros((n, 32), dtype=np.uint8)
    s = np.zeros((n, 32), dtype=np.uint8)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        sig, pub = bytes(sigs[i]), bytes(pubs[i])
        if len(sig) != 64 or len(pub) != 32 or not (sig[63] & 0x80):
            continue
        s_b = bytearray(sig[32:])
        s_b[31] &= 0x7F
        if int.from_bytes(bytes(s_b), "little") >= srpy.L:
            continue
        t = srpy.signing_context(b"", bytes(msgs[i]))
        t.append_message(b"proto-name", b"Schnorr-sig")
        t.append_message(b"sign:pk", pub)
        t.append_message(b"sign:R", sig[:32])
        ki = srpy._challenge_scalar(t, b"sign:c")
        k[i] = np.frombuffer(ki.to_bytes(32, "little"), dtype=np.uint8)
        s[i] = np.frombuffer(bytes(s_b), dtype=np.uint8)
        ok[i] = True
    return k, s, ok


def stage(pubs, msgs, sigs):
    """Host staging of n well-formed triples (32-byte keys, 64-byte
    signatures): rows (n, 128) uint8 A | R | s | k little-endian (K1's
    row layout, s with the marker bit cleared) and host_ok (n,) bool
    (the marker bit, s < L, and canonical, even encodings of A and R)."""
    from .ed25519 import _to_u8_matrix

    pub_m = _to_u8_matrix([bytes(p) for p in pubs], 32)
    sig_m = _to_u8_matrix([bytes(s) for s in sigs], 64)
    k, s, host_ok = _stage_host(pubs, msgs, sigs)
    r_bytes = np.ascontiguousarray(sig_m[:, :32])
    host_ok = host_ok & ristretto.bytes_canonical_nonneg(pub_m) \
        & ristretto.bytes_canonical_nonneg(r_bytes)
    return np.concatenate([pub_m, r_bytes, s, k], axis=1), host_ok


def verify_batch_device(pubs, msgs, sigs, device=None) -> np.ndarray:
    """End-to-end batched sr25519 verify: host staging and kernel S2.
    Returns a (n,) bool bitmap with per-signature exact semantics.
    Malformed lengths are rejected host-side without poisoning the batch.
    The lanes are padded to bucket_size(n) (as the JAX package pads
    them).  device: "cuda" (default) launches S2; "cpu" runs its plain
    version."""
    from tendermint_tpu_torch.libs import fail

    # chaos seam: the degradation runtime treats an injected fault here as
    # a device-lane fault
    fail.inject("ops.sr25519.verify_batch")
    dev = resolve_device(device)
    n = len(pubs)
    if n == 0:
        return np.zeros(0, dtype=bool)
    ok_len = np.array([
        len(pubs[i]) == 32 and len(sigs[i]) == 64 for i in range(n)])
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
    from . import cuda_sr25519
    from .ed25519 import bucket_size

    nb = bucket_size(n)
    packed = np.zeros((128, nb), dtype=np.uint8)   # lane-major
    packed[:, :n] = rows.T
    bits = cuda_sr25519.verify_packed(torch.from_numpy(packed).to(dev))
    return bits.cpu().numpy()[:n] & host_ok
