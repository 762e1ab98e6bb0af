"""Batched ed25519 signature verification on an NVIDIA GPU.

The counterpart of tendermint_tpu/ops/ed25519.py for one device: a whole
batch of (pubkey, msg, sig) triples is verified at once, one signature per
GPU thread (ops/cuda_ed25519.py, kernels K1 and K2).

Verification is the exact cofactorless RFC 8032 / Go-crypto check: decode
A and reject bad encodings, reject s >= L, compute k = SHA-512(R || A || M)
mod L, and accept iff encode([s]B + [k](-A)) == R byte for byte.  Every
lane is an independent exact verify, so the caller gets a bitmap.

Split of labor:
  host (native C / numpy): byte packing, SHA-512 challenge hashing and
    reduction mod L, s < L canonicity (`_stage_rows`).
  device: point decompression, the 64-step joint Straus ladder, encode and
    compare — all inside one kernel launch per chunk.

Routes (`last_launch()["path"]`): "cuda" — the packed (128, B) layout into
K1, in MAX_CHUNK-lane chunks pipelined against their host-to-device copies
above MAX_CHUNK; "cuda-split" — validator-set batches (cache_pubs, at
least PUB_CACHE_MIN signatures) with the pubkey rows resident on the
device, SPLIT_CHUNK lanes per K2 launch; "rlc-single" — the opt-in RLC
batch check of ops/msm.py (kernels K4, K5, A1), tried first when
msm.use_rlc(n), with a fall-through to the routes above unless it vouches
for the whole batch; "comb" — the fixed-base comb (kernels C1 and C2 of
ops/cuda_comb.py): a batch whose keys all resolve to one validator set
with device-resident window tables (built by `prewarm`, or by a
cache_pubs batch of at least comb_min_batch() signatures within the
table budget) verifies with zero doublings, tried after RLC and before
the ladder routes; "cuda-staged" — verify_batch_staged, K3 on raw
SHA-512 digests (no node path uses it).  On device="cpu" the same routes
run the kernels' plain PyTorch versions.

The data planes of parallel/sharding.py come first when the caller's
device type is theirs: the global plane (route "global-mesh", only inside
a lockstep() window of a multi-process runtime), then RLC through the
local plane ("rlc-sharded"), the comb with the plane ("mesh-comb",
"mesh-comb-sharded") and the plane's per-signature route ("mesh-cuda" on
cards, "mesh-xla" on a CPU plane), then the single-device routes above.
"""
from __future__ import annotations

import atexit
import collections
import hashlib
import os
import threading
import time
from types import MappingProxyType

import numpy as np
import torch

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.libs import fail
from tendermint_tpu_torch.libs import trace
from . import cuda_comb as cc
from . import cuda_ed25519 as ck
from . import curve as C
from . import field as F

# group order
L = (1 << 252) + 27742317777372353535851937790883648493

TILE = 256           # lane tile of the JAX kernel: padding floor per launch
MIN_BUCKET = 64
MAX_CHUNK = 1 << 16  # biggest single-launch lane count (verify_batch)
PUB_CACHE_MIN = 4096  # smallest cache_pubs batch that takes the split route
SPLIT_CHUNK = 16384  # chunk size of the staged split-path pipeline
_PUB_CACHE_MAX = 4


# ---------------------------------------------------------------------------
# static basepoint table: j*B for j = 0..8 in niels form
# ---------------------------------------------------------------------------

def _edwards_add_int(p, q):
    """Affine edwards addition in Python bignum (static tables only)."""
    x1, y1 = p
    x2, y2 = q
    den = C.D_INT * x1 * x2 % C.P * y1 % C.P * y2 % C.P
    x3 = (x1 * y2 + x2 * y1) * pow(1 + den, C.P - 2, C.P)
    y3 = (y1 * y2 + x1 * x2) * pow(1 - den, C.P - 2, C.P)
    return (x3 % C.P, y3 % C.P)


def _niels_rows(pts):
    """[(x, y)] -> ((len, NLIMB) ypx, ymx, t2d) numpy niels limb rows."""
    ypx = np.stack([F.int_to_limbs((y + x) % C.P) for x, y in pts])
    ymx = np.stack([F.int_to_limbs((y - x) % C.P) for x, y in pts])
    t2d = np.stack([F.int_to_limbs(C.D2_INT * x % C.P * y % C.P)
                    for x, y in pts])
    return ypx, ymx, t2d


def _window_pts(base):
    """[j * base] for j = 0..8."""
    pts = [(0, 1)]
    acc = (0, 1)
    for _ in range(8):
        acc = _edwards_add_int(acc, base)
        pts.append(acc)
    return pts


def _base_table_np():
    """(9, NLIMB) niels limb rows (ypx, ymx, t2d) of j*B, j = 0..8."""
    return _niels_rows(_window_pts((C.BX_INT, C.BY_INT)))


_base_cache: dict = {}


def _base_niels(dev: torch.device):
    """The niels table j*B, j = 0..8, as three (9, NLIMB) tensors."""
    key = str(dev)
    if key not in _base_cache:
        _base_cache[key] = tuple(torch.from_numpy(t).to(dev)
                                 for t in _base_table_np())
    return _base_cache[key]


def straus_ladder(neg_a: C.Ext, s_digits: torch.Tensor,
                  k_digits: torch.Tensor) -> C.Ext:
    """The 64-step joint signed-radix-16 Straus ladder [s]B + [k]neg_a of
    the plain verify versions (K1-K3 here, S2 in ops/sr25519.py), as the
    JAX package shares ops/ed25519.straus_ladder: per step 4 doublings, a
    niels add of B's entry and a cached add of neg_a's.  s_digits,
    k_digits: (64, B) signed digits in [-8, 7], least significant
    first."""
    dev = neg_a.x.device
    B = neg_a.x.shape[1]
    base = _base_niels(dev)
    tab, _ = C.cached_window(neg_a)                  # fields (9, NLIMB, B)
    p = C.identity((B,), dev)
    for pos in range(63, -1, -1):
        p = C.dbl(C.dbl(C.dbl(C.dbl(p, False), False), False), True)
        db = s_digits[pos].long()
        jb = db.abs()
        nb = C.Niels(*(t[jb].t() for t in base))
        p = C.madd_niels(p, C.cond_neg_niels(nb, db < 0))
        da = k_digits[pos].long()
        idx = da.abs().reshape(1, 1, B).expand(1, F.NLIMB, B)
        q = C.Cached(*(torch.gather(t, 0, idx)[0] for t in tab))
        p = C.add_cached(p, C.cond_neg_cached(q, da < 0))
    return p


# ---------------------------------------------------------------------------
# the fixed-base comb: with [j 16^i](-A) resident for every key of a
# validator set, [s]B + [k](-A) is 64 windows of one niels addition from
# B's static comb and one cached addition gathered from -A's table, and no
# doubling.  The static comb of B is built on first comb use (~512 bignum
# additions), so a process that only runs the ladder never pays for it.
# ---------------------------------------------------------------------------

COMB_WINDOWS = 64

_base_comb_lock = threading.Lock()
_base_comb_np_cache = None
_base_comb_cache: dict = {}


def _base_comb_np():
    """(64, 9, NLIMB) niels limb rows (ypx, ymx, t2d) of [j 16^i] B."""
    global _base_comb_np_cache
    with _base_comb_lock:
        if _base_comb_np_cache is not None:
            return _base_comb_np_cache
    ypx = np.zeros((COMB_WINDOWS, 9, F.NLIMB), dtype=np.int64)
    ymx = np.zeros_like(ypx)
    t2d = np.zeros_like(ypx)
    base = (C.BX_INT, C.BY_INT)
    for i in range(COMB_WINDOWS):
        pts = _window_pts(base)
        ypx[i], ymx[i], t2d[i] = _niels_rows(pts)
        # 16^{i+1} B = 2 * (8 * 16^i B)
        base = _edwards_add_int(pts[8], pts[8])
    with _base_comb_lock:
        if _base_comb_np_cache is None:
            _base_comb_np_cache = (ypx, ymx, t2d)
        return _base_comb_np_cache


def _base_comb(dev: torch.device):
    """B's static comb as the plain C2's three (64, 9, NLIMB) tensors on
    `dev` (C2 on the card reads its own 10-limb copy,
    cuda_comb.base_comb_dev).  The device observatory's base_comb pool is
    refreshed on every access."""
    key = str(dev)
    with _base_comb_lock:
        cache = _base_comb_cache.get(key)
    if cache is None:
        cache = tuple(torch.from_numpy(t).to(dev) for t in _base_comb_np())
        with _base_comb_lock:
            cache = _base_comb_cache.setdefault(key, cache)
    from tendermint_tpu_torch.crypto import devobs
    devobs.ledger_set("base_comb", sum(
        t.numel() * t.element_size() for t in cache))
    return cache


def comb_build_kernel_impl(pub: torch.Tensor):
    """Plain C1: (K, 32) uint8 pubkeys -> (Cached tables of -A, fields
    (64, 9, NLIMB, K); (K,) bool decode verdict).  Decode (Go semantics),
    negate, and scan out the 64 signed-radix-16 window tables
    (curve.comb_table_scan); the JAX package's comb_build_kernel_impl."""
    y_l, a_sign = F.bytes_to_limbs(pub.t())
    a, ok = C.decompress(y_l, a_sign)
    neg_a = C.Ext(F.carry_lazy(-a.x), a.y, a.z, F.carry_lazy(-a.t))
    return C.comb_table_scan(neg_a, windows=COMB_WINDOWS), ok


def _gather_comb_cached(tab: C.Cached, i: int, digit: torch.Tensor,
                        vidx: torch.Tensor) -> C.Cached:
    """Entry [i, |digit|, :, vidx] of the per-validator comb tables per
    lane, negated for a negative digit."""
    j = digit.abs()
    B = digit.shape[0]
    idx = j.reshape(1, 1, B).expand(1, F.NLIMB, B)

    def sel(t):
        lane = t[i][:, :, vidx]                      # (9, NLIMB, B)
        return torch.gather(lane, 0, idx)[0]

    q = C.Cached(sel(tab.ypx), sel(tab.ymx), sel(tab.z), sel(tab.t2d))
    return C.cond_neg_cached(q, digit < 0)


def _gather_base_comb(base, i: int, digit: torch.Tensor) -> C.Niels:
    """Entry [i, |digit|] of B's static comb per lane, negated for a
    negative digit."""
    j = digit.abs()
    return C.cond_neg_niels(C.Niels(*(t[i][j].t() for t in base)),
                            digit < 0)


def comb_verify_staged(r, s_digits, k_digits, vidx, tab_ypx, tab_ymx,
                       tab_z, tab_t2d, dec_ok, base_ypx, base_ymx,
                       base_t2d) -> torch.Tensor:
    """Plain C2, the JAX package's comb_verify_staged: the cofactorless
    verdict with zero doublings.  Batch-major inputs: r (B, 32) uint8,
    s_digits and k_digits (B, 64) int8 signed radix-16 digits, vidx (B,)
    int32 rows of the table axis, tab_* (64, 9, NLIMB, K) cached tables
    of -A, dec_ok (K,) bool, base_* (64, 9, NLIMB) B's comb.  A lane whose
    vidx lies outside [0, K) fails (C2 reads no table row for it).  Per
    window one niels addition of B's entry and one cached addition of
    -A's, from the identity; then encode and compare with R byte for
    byte.  Returns (B,) bool."""
    dev = r.device
    B = r.shape[0]
    K = dec_ok.shape[0]
    vidx = vidx.long()
    in_range = (vidx >= 0) & (vidx < K)
    vidx = torch.where(in_range, vidx, torch.zeros_like(vidx))
    sd = s_digits.long().clamp(-8, 8).t()
    kd = k_digits.long().clamp(-8, 8).t()
    tab = C.Cached(tab_ypx, tab_ymx, tab_z, tab_t2d)
    base = (base_ypx, base_ymx, base_t2d)
    p = C.identity((B,), dev)
    for i in range(COMB_WINDOWS):
        p = C.madd_niels(p, _gather_base_comb(base, i, sd[i]))
        p = C.add_cached(p, _gather_comb_cached(tab, i, kd[i], vidx))
    enc = C.encode(p)
    r_rows = r.t().to(F.DTYPE) & 0xFF
    return (enc == r_rows).all(0) & dec_ok[vidx].bool() & in_range


# ---------------------------------------------------------------------------
# host-side staging
# ---------------------------------------------------------------------------

def scalars_to_digits(s_bytes: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 little-endian scalars (< 2^253) -> (B, 64) int8 signed
    radix-16 digits in [-8, 7], least-significant first.

    Closed form: t = s + 0x88...8 with 256-bit arithmetic (four uint64
    words, vectorized carry), then digit_j = nibble_j(t) - 8."""
    s_bytes = np.ascontiguousarray(np.asarray(s_bytes, dtype=np.uint8))
    words = s_bytes.view("<u8")  # (B, 4)
    EIGHTS = np.uint64(0x8888888888888888)
    t = np.empty_like(words)
    carry = np.zeros(words.shape[0], dtype=np.uint64)
    for w in range(4):
        a = words[:, w]
        x = a + EIGHTS
        c1 = x < EIGHTS
        x = x + carry
        c2 = x < carry
        t[:, w] = x
        carry = (c1 | c2).astype(np.uint64)
    tb = t.view(np.uint8)
    dig = np.empty((s_bytes.shape[0], 64), dtype=np.int8)
    dig[:, 0::2] = (tb & 15).astype(np.int8) - 8
    dig[:, 1::2] = (tb >> 4).astype(np.int8) - 8
    return dig


def _to_u8_matrix(rows, width):
    if isinstance(rows, np.ndarray):
        return np.ascontiguousarray(rows, dtype=np.uint8)
    return np.frombuffer(b"".join(bytes(r) for r in rows),
                         dtype=np.uint8).reshape(-1, width)


def _s_canonical(s_bytes: np.ndarray) -> np.ndarray:
    """Vectorized s < L check (Go: scMinimal): compare the four
    little-endian uint64 words against L's, most-significant first."""
    from tendermint_tpu_torch.libs import native

    out = native.scalar_canonical(s_bytes)
    if out is not None:
        return out
    s_words = s_bytes.view("<u8")  # (B, 4)
    l_words = np.frombuffer(L.to_bytes(32, "little"), dtype="<u8")
    B = s_bytes.shape[0]
    ok = np.zeros(B, dtype=bool)
    decided = np.zeros(B, dtype=bool)
    for w in (3, 2, 1, 0):
        lt = ~decided & (s_words[:, w] < l_words[w])
        gt = ~decided & (s_words[:, w] > l_words[w])
        ok |= lt
        decided |= lt | gt
    return ok  # undecided = equal to L -> not ok


def _as_fixed_width(msgs, B):
    """Collapse a list of equal-length bytes into a (B, mlen) uint8 array
    (the C staging's fixed-width fast path); pass arrays/ragged through."""
    from tendermint_tpu_torch.libs.ragged import RaggedBytes

    if isinstance(msgs, np.ndarray) or B == 0:
        return msgs
    if isinstance(msgs, RaggedBytes):
        fw = msgs.fixed_width()
        return fw if fw is not None else msgs
    if len(msgs[0]) == len(msgs[-1]) and \
            all(len(m) == len(msgs[0]) for m in msgs):
        return np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(B, -1)
    return msgs


def _sha512_digests(r_bytes, pubkeys, msgs) -> np.ndarray:
    """(B, 64) uint8 SHA-512(R || A || M) digests: one native C call for
    the batch, hashlib where no C toolchain exists."""
    from tendermint_tpu_torch.libs import native

    B = r_bytes.shape[0]
    prefix = np.concatenate([r_bytes, pubkeys], axis=1)
    if native.get_lib() is not None:
        out = native.sha512_prefixed(prefix, _as_fixed_width(msgs, B))
        if out is not None:
            return out
    rp = prefix.tobytes()
    _sha = hashlib.sha512
    return np.frombuffer(b"".join(
        _sha(rp[64 * i: 64 * i + 64] + bytes(msgs[i])).digest()
        for i in range(B)), dtype=np.uint8).reshape(B, 64)


def _stage_rows(pubkeys, sigs, msgs):
    """Shared host staging for the packed/split layouts: byte coercion,
    R/s split, s-canonicity, and the challenge scalar
    k = SHA-512(R || A || M) mod L (native C, numpy fallback).  Returns
    (pubkeys (B,32), r_bytes, s_bytes, k, host_ok)."""
    from tendermint_tpu_torch.libs import native

    pubkeys = _to_u8_matrix(pubkeys, 32)
    sigs = _to_u8_matrix(sigs, 64)
    B = pubkeys.shape[0]
    if pubkeys.shape != (B, 32) or sigs.shape != (B, 64) or len(msgs) != B:
        raise ValueError("pubkeys (B, 32), sigs (B, 64) and B msgs expected")
    r_bytes = np.ascontiguousarray(sigs[:, :32])
    s_bytes = np.ascontiguousarray(sigs[:, 32:])
    host_ok = _s_canonical(s_bytes)
    prefix = np.concatenate([r_bytes, pubkeys], axis=1)
    k = None
    if native.get_lib() is not None:
        k = native.challenge_scalars(prefix, _as_fixed_width(msgs, B))
    if k is None:  # no C toolchain: hashlib + numpy fallback
        from . import sha512_np
        k = sha512_np.mod_l_batch(_sha512_digests(r_bytes, pubkeys, msgs))
    return pubkeys, r_bytes, s_bytes, k, host_ok


def prepare_batch_packed(pubkeys, sigs, msgs):
    """Stage a batch as ONE lane-major (128, B) int8 array: rows 0:32
    pubkey bytes, 32:64 R, 64:96 s, 96:128 k.  Returns (packed, host_ok)."""
    pubkeys, r_bytes, s_bytes, k, host_ok = _stage_rows(pubkeys, sigs, msgs)
    B = pubkeys.shape[0]
    packed = np.empty((128, B), dtype=np.uint8)
    packed[0:32] = pubkeys.T
    packed[32:64] = r_bytes.T
    packed[64:96] = s_bytes.T
    packed[96:128] = k.T
    return packed.view(np.int8), host_ok


def prepare_batch_split(pubkeys, sigs, msgs):
    """prepare_batch_packed with the pubkey rows separated from the
    per-call rows: returns (pub_rows (32, B) uint8, rsk (96, B) int8 —
    rows 0:32 R, 32:64 s, 64:96 k, host_ok)."""
    pubkeys, r_bytes, s_bytes, k, host_ok = _stage_rows(pubkeys, sigs, msgs)
    B = pubkeys.shape[0]
    rsk = np.empty((96, B), dtype=np.uint8)
    rsk[0:32] = r_bytes.T
    rsk[32:64] = s_bytes.T
    rsk[64:96] = k.T
    return np.ascontiguousarray(pubkeys.T), rsk.view(np.int8), host_ok


def prepare_batch_compact(pubkeys, sigs, msgs):
    """Stage a batch for K3: byte packing, the s < L screen and the raw
    SHA-512(R || A || M) digests; the reduction mod L and the digits run
    on the device.  Returns ({pub, r, s: (32, B), digest: (64, B)}
    lane-major int8, host_ok)."""
    pubkeys = _to_u8_matrix(pubkeys, 32)
    sigs = _to_u8_matrix(sigs, 64)
    B = pubkeys.shape[0]
    if pubkeys.shape != (B, 32) or sigs.shape != (B, 64) or len(msgs) != B:
        raise ValueError("pubkeys (B, 32), sigs (B, 64) and B msgs expected")
    r_bytes = np.ascontiguousarray(sigs[:, :32])
    s_bytes = np.ascontiguousarray(sigs[:, 32:])
    host_ok = _s_canonical(s_bytes)
    digests = _sha512_digests(r_bytes, pubkeys, msgs)
    rows = dict(pub=pubkeys, r=r_bytes, s=s_bytes, digest=digests)
    return ({k: np.ascontiguousarray(v.T).view(np.int8)
             for k, v in rows.items()}, host_ok)


def bucket_size(n: int) -> int:
    """Round a batch size up to the next power of two (>= MIN_BUCKET)."""
    return max(MIN_BUCKET, 1 << (n - 1).bit_length())


# ---------------------------------------------------------------------------
# launch records
# ---------------------------------------------------------------------------

_launch_lock = threading.Lock()
_seen_buckets: set = set()
_launch_seq = 0
_last_launch = MappingProxyType({"path": None, "seq": 0})


def last_launch():
    """Immutable snapshot of the most recent launch record: path / device
    / n / nb (padded lanes) / occupancy / first_launch / wall_s, plus the
    phase keys stage_s, h2d_s, compute_s (CUDA-event times on a GPU),
    collect_s or drain_s, and for chunked routes chunks / chunk_overlap.

    The record is process-global and written when a launch finishes.  A
    launch that the degradation runtime abandoned at its deadline keeps
    running on its quarantined lane thread and records itself when it
    ends, so after a timeout this can show the abandoned launch rather
    than the one that followed it; wait for the abandoned thread before
    reading it."""
    with _launch_lock:
        return _last_launch


def _set_last_launch(path: str, dev: torch.device, n: int, nb: int,
                     wall_s: float, phases: dict) -> bool:
    """Store a launch record; returns whether it was the first launch of
    its (path, device, nb) bucket.

    This is also THE funnel into the device observatory
    (crypto/devobs.py): every launch record — K1/K2 via _record_launch,
    K3, and the RLC route mirror from ops/msm._set_route — is stored
    into its ring here, and the deferred publication drains right
    after, with _launch_lock already released (devobs records under its
    own leaf lock and never publishes)."""
    global _last_launch, _launch_seq
    key = (path, str(dev), nb)
    with _launch_lock:
        first = key not in _seen_buckets
        _seen_buckets.add(key)
        _launch_seq += 1
        snap = {"shards": 1, **phases, "path": path, "device": str(dev),
                "n": n, "nb": nb, "occupancy": n / nb if nb else 1.0,
                "first_launch": first, "wall_s": wall_s, "seq": _launch_seq}
        _last_launch = MappingProxyType(snap)
    from tendermint_tpu_torch.crypto import devobs
    devobs.record(snap)
    devobs.publish_pending()
    return first


# group operations a lane of each route performs, in its launch record
# (group_ops): the ladder pays the per-launch window of -A (4 doublings,
# 3 additions) and 64 steps of 4 doublings and 2 additions; the comb 2
# additions a window and nothing else
LADDER_GROUP_OPS = {"doublings": 4 * 64 + 4, "adds": 2 * 64 + 3}
COMB_GROUP_OPS = {"doublings": 0, "adds": 2 * COMB_WINDOWS}
_GROUP_OPS_BY_PATH = {
    "cuda": LADDER_GROUP_OPS, "cuda-split": LADDER_GROUP_OPS,
    "cuda-staged": LADDER_GROUP_OPS, "comb": COMB_GROUP_OPS,
    "mesh-cuda": LADDER_GROUP_OPS, "mesh-xla": LADDER_GROUP_OPS,
    "global-mesh": LADDER_GROUP_OPS, "mesh-sharded": LADDER_GROUP_OPS,
    "mesh-comb": COMB_GROUP_OPS, "mesh-comb-sharded": COMB_GROUP_OPS,
}


def _record_launch(path: str, dev: torch.device, n: int, nb: int,
                   wall_s: float, phases: dict):
    """Store the launch record and publish the route: the
    crypto_msm_route_total{path, outcome="executed"} counter, the lane
    occupancy and (on a bucket's first launch) the compile split, and
    the route attrs on the innermost live span."""
    ops = _GROUP_OPS_BY_PATH.get(path)
    if ops is not None:
        phases = dict(phases, group_ops=dict(ops))
    first = _set_last_launch(path, dev, n, nb, wall_s, phases)
    from tendermint_tpu_torch.crypto import degrade
    degrade.publish_route(path, "executed", n=n, nb=nb,
                          compile_s=wall_s if first else None)
    trace.current().add(path=path, n=n, nb=nb,
                        occupancy=round(n / nb if nb else 1.0, 4),
                        shards=phases.get("shards", 1), first_launch=first)


def _overlap_phases(probe: dict) -> dict:
    """Normalize a mesh route's put probe (parallel/sharding) into launch
    record phase keys: h2d_s is the summed per-position put wall,
    chunk_overlap the fraction of that wall issued while an earlier
    chunk's kernels were in flight — the first chunk's puts have nothing
    to hide behind, every later one is issued between a launch and the
    final wait."""
    out = {}
    if probe.get("stage_s") is not None:
        out["stage_s"] = probe["stage_s"]
    dma = probe.get("dma_s")
    if dma is not None:
        out["h2d_s"] = dma
        first = probe.get("dma_first_s", 0.0)
        out["chunk_overlap"] = max(0.0, (dma - first) / dma) \
            if dma > 0 else 0.0
        out["chunks"] = probe.get("chunks")
    return out


def _overlap(h2d_s: float, compute_s: float, span_s: float) -> float:
    """Share of the host-to-device copy time hidden behind kernels: the
    device timeline (first copy start -> last kernel end) is shorter than
    the sum of its copies and kernels by exactly the overlapped time."""
    if h2d_s <= 0:
        return 0.0
    return min(1.0, max(0.0, (h2d_s + compute_s - span_s) / h2d_s))


class _ChunkFeed:
    """Double-buffered host-to-device feed for a chunked launch: chunk
    j+1's rows go from a pinned host buffer to the device on a side
    stream while chunk j's kernel runs on the current stream, ordered by
    events.  On a CPU device the rows are used as they are.

    "The current stream" is that of the thread that builds the feed: on
    the degradation runtime's lane worker, a thread of its own, it is
    the default stream of `dev` (the stream every caller of the package
    uses unless it entered a stream context of its own).

    Each slot's buffers are made at its first put, and the device bytes
    of the slots in use are charged to the device observatory's
    "staging" pool until close() (on the CPU, the chunk rows the kernel
    reads), so the ledger holds the in-flight window of the launch."""

    def __init__(self, dev: torch.device, rows: int, lanes: int):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.chunks = 0
        self.copy_ev = []   # (start, end) event pairs per chunk
        self.kern_ev = []
        self.slot_bytes = rows * lanes
        self.charged = 0
        self.shape = (rows, lanes)
        self.pinned = [None, None]
        self.bufs = [None, None]
        if not self.cuda:
            return
        self.main = torch.cuda.current_stream(dev)
        self.side = torch.cuda.Stream(dev)
        self.done = [None, None]   # kernel-finished event per slot
        self.copied = [None, None]  # copy-finished event per slot

    def _charge(self, slot: int):
        """Charge a slot to the staging pool at its first use."""
        if self.charged < (slot + 1) * self.slot_bytes:
            from tendermint_tpu_torch.crypto import devobs
            devobs.ledger_add("staging", self.slot_bytes)
            self.charged += self.slot_bytes

    def close(self):
        """Release the staging charge (the launch call is over)."""
        if self.charged:
            from tendermint_tpu_torch.crypto import devobs
            devobs.ledger_add("staging", -self.charged)
            self.charged = 0

    def put(self, j: int, rows_np: np.ndarray) -> torch.Tensor:
        """Start the transfer of chunk j; returns its device tensor."""
        src = torch.from_numpy(np.ascontiguousarray(rows_np).view(np.uint8))
        slot = j % 2
        self._charge(slot)
        if not self.cuda:
            return src
        if self.bufs[slot] is None:
            self.pinned[slot] = torch.empty(self.shape, dtype=torch.uint8,
                                            pin_memory=True)
            self.bufs[slot] = torch.empty(self.shape, dtype=torch.uint8,
                                          device=self.dev)
        if self.copied[slot] is not None:
            # the pinned slot is still the source of chunk j-2's copy
            self.copied[slot].synchronize()
        self.pinned[slot].copy_(src)
        with torch.cuda.stream(self.side):
            if self.done[slot] is not None:
                # chunk j-2's kernel still reads the device slot
                self.side.wait_event(self.done[slot])
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record(self.side)
            self.bufs[slot].copy_(self.pinned[slot], non_blocking=True)
            ev1.record(self.side)
        self.copied[slot] = ev1
        self.copy_ev.append((ev0, ev1))
        return self.bufs[slot]

    def launch(self, j: int, fn, *args) -> torch.Tensor:
        """Run fn(*args) for chunk j on the current stream after its copy."""
        self.chunks += 1
        if not self.cuda:
            return fn(*args)
        slot = j % 2
        self.main.wait_event(self.copied[slot])
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record(self.main)
        out = fn(*args)
        ev1.record(self.main)
        self.done[slot] = ev1
        self.kern_ev.append((ev0, ev1))
        return out

    def phases(self) -> dict:
        """Event-timed phases; call after the results were collected."""
        if not self.cuda or not self.kern_ev:
            return {"chunks": self.chunks}
        ms = lambda pair: pair[0].elapsed_time(pair[1])  # noqa: E731
        h2d = sum(ms(p) for p in self.copy_ev) / 1e3
        comp = sum(ms(p) for p in self.kern_ev) / 1e3
        span = self.copy_ev[0][0].elapsed_time(self.kern_ev[-1][1]) / 1e3
        return {"h2d_s": h2d, "compute_s": comp, "device_s": span,
                "chunks": self.chunks,
                "chunk_overlap": _overlap(h2d, comp, span)}


def verify_packed_pipelined(packed: np.ndarray, nsub: int,
                            feed: _ChunkFeed):
    """K1 over `nsub` equal sub-batches of the (128, B) staged array, each
    one's host-to-device copy overlapping the previous one's kernel.
    `feed` is a _ChunkFeed of (128, B/nsub) rows.  Returns the list of
    per-chunk (B/nsub,) bool device tensors (not yet synchronised)."""
    B = packed.shape[1]
    if B % nsub or (B // nsub) % TILE:
        raise ValueError(f"{B} lanes do not split into {nsub} tiled chunks")
    sub = B // nsub
    outs = []
    cur = feed.put(0, packed[:, :sub])
    for j in range(nsub):
        outs.append(feed.launch(j, ck.verify_packed, cur))
        if j + 1 < nsub:
            cur = feed.put(j + 1, packed[:, (j + 1) * sub:(j + 2) * sub])
    return outs


# ---------------------------------------------------------------------------
# device-resident pubkey cache
# ---------------------------------------------------------------------------

class DeviceLRU:
    """Bounded, thread-safe LRU of device-resident uploads.

    Bounds: `max_entries` (count) and/or `max_bytes` (sum of the nbytes
    passed to put), whichever is set; eviction is oldest-first and never
    evicts the entry just inserted (a single entry larger than the budget
    is kept rather than thrashed; callers check the budget before they
    build).  Every mutation enforces the bound inside the same critical
    section, so no observer sees it exceeded.  put() is first-wins: when
    two threads race the same key, the loser's upload is dropped and both
    use the winner's tensors, so a double upload cannot leave two
    resident copies.  `on_evict(key, value)` fires outside the lock."""

    def __init__(self, max_entries: int = None, max_bytes: int = None,
                 on_evict=None):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._on_evict = on_evict
        self._od: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        with self._lock:
            ent = self._od.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._od.move_to_end(key)
            self.hits += 1
            return ent[0]

    def put(self, key, value, nbytes: int = 0):
        """Insert `value` (charged `nbytes` in total_bytes)."""
        evicted = []
        with self._lock:
            ent = self._od.get(key)
            if ent is not None:  # racing upload lost: first wins
                self._od.move_to_end(key)
                return ent[0]
            self._od[key] = (value, nbytes)
            self._bytes += nbytes
            while len(self._od) > 1 and self._over_locked():
                k, (v, b) = self._od.popitem(last=False)
                self._bytes -= b
                self.evictions += 1
                evicted.append((k, v))
        if self._on_evict is not None:
            for k, v in evicted:
                self._on_evict(k, v)
        return value

    def _over_locked(self) -> bool:
        if self.max_entries is not None and \
                len(self._od) > self.max_entries:
            return True
        return self.max_bytes is not None and self._bytes > self.max_bytes

    def pop(self, key):
        with self._lock:
            ent = self._od.pop(key, None)
            if ent is None:
                return None
            self._bytes -= ent[1]
        return ent[0]

    def clear(self):
        with self._lock:
            self._od.clear()
            self._bytes = 0

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._od

    def peek(self, key):
        """get() without touching recency or the hit/miss counters, for
        bookkeeping scans that must not change the eviction order."""
        with self._lock:
            ent = self._od.get(key)
            return None if ent is None else ent[0]

    def keys(self):
        with self._lock:
            return list(self._od.keys())


# A chain's validator keys are fixed across blocks, so the (32, B) pubkey
# rows are uploaded once and every later VerifyCommit against the same
# set ships only the 96 B/sig of per-commit rows (R, s, k).
_pub_cache = DeviceLRU(max_entries=_PUB_CACHE_MAX)


def _pub_cache_get(pub_rows: np.ndarray, nsub: int, dev: torch.device):
    """pub_rows: (32, NB) uint8, already padded; nsub: chunk count.
    Returns a list of nsub (32, NB/nsub) uint8 tensors on `dev`, uploading
    on first sight (keyed by content hash, chunking and device)."""
    key = (hashlib.sha256(pub_rows.tobytes()).digest(), nsub, str(dev))
    chunks = _pub_cache.get(key)
    if chunks is not None:
        return chunks
    sub = pub_rows.shape[1] // nsub
    chunks = [torch.from_numpy(np.ascontiguousarray(
        pub_rows[:, j * sub:(j + 1) * sub])).to(dev) for j in range(nsub)]
    chunks = _pub_cache.put(key, chunks, nbytes=int(pub_rows.nbytes))
    from tendermint_tpu_torch.crypto import devobs
    devobs.ledger_set("pub_cache", _pub_cache.total_bytes)
    return chunks


# -- comb table cache: per-validator window tables of -A, device-resident,
# keyed by the content hash of the set's sorted distinct pubkey rows and by
# device (a CPU call never resolves to a card entry, nor the reverse).
# Bounded in bytes: a key is charged the JAX package's 22-limb row,
# 64 windows x 9 entries x 4 cached fields x NLIMB x 4 B = 202,752 B,
# whatever the device holds (C2's 10-limb table is 92,160 B a key), so
# builds, declines and evictions are the reference's; the 256 MiB default
# holds ~1.3k keys.  The table_cache gauge and ledger pool report these
# charged bytes.

PREWARM_MIN_KEYS = 32     # the device-lane batch floor (crypto/batch
# tpu_threshold): a smaller set never reaches the device, so prewarming it
# would build tables nothing uses; comb_min_batch() lowers the floor
_TABLE_BYTES_PER_KEY = COMB_WINDOWS * 9 * 4 * F.NLIMB * 4
TABLE_CACHE_MB_DEFAULT = 256

_comb_enabled_override = None   # set_comb_config wins over the env
_comb_min_override = None
_table_budget_override = None


def set_comb_config(enabled: bool = None, table_cache_mb: int = None,
                    min_batch: int = None):
    """Override the comb knobs (None leaves a knob on its env/default)."""
    global _comb_enabled_override, _comb_min_override, \
        _table_budget_override
    if enabled is not None:
        _comb_enabled_override = bool(enabled)
    if table_cache_mb is not None:
        _table_budget_override = int(table_cache_mb) << 20
    if min_batch is not None:
        _comb_min_override = int(min_batch)


def comb_enabled() -> bool:
    """TM_TPU_COMB (default 1)."""
    if _comb_enabled_override is not None:
        return _comb_enabled_override
    return os.environ.get("TM_TPU_COMB", "1") != "0"


def comb_min_batch() -> int:
    """Smallest batch that triggers a table BUILD (TM_TPU_COMB_MIN, default
    PUB_CACHE_MIN); a cache hit engages at any size."""
    if _comb_min_override is not None:
        return _comb_min_override
    return int(os.environ.get("TM_TPU_COMB_MIN", PUB_CACHE_MIN))


def table_cache_budget_bytes() -> int:
    """TM_TPU_TABLE_CACHE_MB (default 256) in bytes."""
    if _table_budget_override is not None:
        return _table_budget_override
    return int(os.environ.get("TM_TPU_TABLE_CACHE_MB",
                              TABLE_CACHE_MB_DEFAULT)) << 20


class CombTables:
    """One cached validator set: its comb tables on one device.  `tables`
    is C1's output: on a GPU one (64, 9, K_pad, 4, 10) int32 tensor, on
    the CPU the plain version's Cached fields (64, 9, NLIMB, K_pad)."""
    __slots__ = ("set_hash", "index", "tables", "dec_ok", "nbytes",
                 "k", "k_pad", "device", "mesh_repl", "mesh_shard")

    def __init__(self, set_hash, index, tables, dec_ok, nbytes, k, k_pad,
                 device):
        self.set_hash = set_hash
        self.index = index        # pubkey bytes -> table row
        self.tables = tables
        self.dec_ok = dec_ok      # (K_pad,) bool tensor
        self.nbytes = nbytes      # charged bytes (_TABLE_BYTES_PER_KEY)
        self.k = k
        self.k_pad = k_pad
        self.device = device      # str(torch.device)
        # the data plane's copies (parallel/sharding): (mesh, {position:
        # (tables, dec_ok)}, bytes charged to the mesh_tables pool)
        self.mesh_repl = None     # full copies a position
        self.mesh_shard = None    # a slice of the key axis a position


_table_key_lock = threading.Lock()
# (pubkey bytes, device) -> the cache key (set hash, device) of its owner
_table_key_index: dict = {}


def _table_evicted(key, entry):
    # release the data plane's copies with the build copy: the
    # mesh_tables pool must not keep charging bytes whose owner the LRU
    # let go (the device buffers free with the entry's last reference)
    freed = 0
    for slot in ("mesh_repl", "mesh_shard"):
        cached = getattr(entry, slot, None)
        if cached is not None:
            freed += cached[2]
            setattr(entry, slot, None)
    if freed:
        from tendermint_tpu_torch.crypto import devobs
        devobs.ledger_add("mesh_tables", -freed)
    with _table_key_lock:
        for kb in entry.index:
            ik = (kb, entry.device)
            if _table_key_index.get(ik) != key:
                continue
            # overlapping sets (a validator-set change keeps most keys):
            # repoint the key to a surviving resident owner instead of
            # dropping it, or the survivor's subset lookups, gated on this
            # index, would stop engaging the comb
            for owner in _table_cache.keys():
                surv = _table_cache.peek(owner)
                if surv is not None and surv.device == entry.device \
                        and kb in surv.index:
                    _table_key_index[ik] = owner
                    break
            else:
                del _table_key_index[ik]
    from tendermint_tpu_torch.crypto import degrade
    from tendermint_tpu_torch.crypto import devobs
    degrade.publish_table_cache(bytes_=_table_cache.total_bytes,
                                evicted=True)
    devobs.ledger_set("table_cache", _table_cache.total_bytes)


_table_cache = DeviceLRU(max_bytes=None, on_evict=_table_evicted)


def table_cache_clear():
    """Drop every cached set (tests, operator tooling)."""
    for h in _table_cache.keys():
        entry = _table_cache.pop(h)
        if entry is not None:
            _table_evicted(h, entry)


def _comb_k_pad(k: int) -> int:
    """Validator-axis bucket: a power of two, at least 8."""
    return max(8, 1 << (k - 1).bit_length())


def _set_hash(uniq: np.ndarray) -> bytes:
    return hashlib.sha256(uniq.tobytes()).digest()


def _table_build(uniq: np.ndarray, set_hash: bytes, dev: torch.device):
    """Build and cache the comb tables (C1) of a distinct-key matrix
    (K, 32) on `dev`.  Returns the CombTables entry, or None when the
    budget says no (route comb/declined: the ladder takes the batch)."""
    from tendermint_tpu_torch.crypto import degrade

    k = uniq.shape[0]
    k_pad = _comb_k_pad(k)
    nbytes = k_pad * _TABLE_BYTES_PER_KEY
    budget = table_cache_budget_bytes()
    if nbytes > budget:
        degrade.publish_route("comb", "declined")
        return None
    _table_cache.max_bytes = budget  # the config may have changed
    pub_pad = np.zeros((k_pad, 32), dtype=np.uint8)
    pub_pad[:k] = uniq
    t0 = time.perf_counter()
    with trace.span("table_build", k=k, k_pad=k_pad, bytes=nbytes) as sp:
        tab, dec_ok = cc.comb_build(torch.from_numpy(pub_pad).to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sp.add(wall_s=round(time.perf_counter() - t0, 4))
    index = {uniq[i].tobytes(): i for i in range(k)}
    entry = CombTables(set_hash, index, tab, dec_ok, nbytes, k, k_pad,
                       str(dev))
    key = (set_hash, str(dev))
    entry = _table_cache.put(key, entry, nbytes)
    with _table_key_lock:
        for kb in entry.index:
            _table_key_index[(kb, entry.device)] = key
    degrade.publish_table_cache(bytes_=_table_cache.total_bytes)
    from tendermint_tpu_torch.crypto import devobs
    devobs.ledger_set("table_cache", _table_cache.total_bytes)
    return entry


def _lookup_touch(set_hash, first_key: bytes, dev: torch.device):
    """The table cache's side of a lookup on `dev`: a get by set hash
    (None: a batch no resident set equals, a miss), then on a miss a get
    of the set that owns the batch's first (smallest) key.  Returns
    (entry, exact): the set of that hash, or its first key's owner, or
    None."""
    entry = _table_cache.get((set_hash, str(dev)))
    if entry is not None:
        return entry, True
    with _table_key_lock:
        owner = _table_key_index.get((first_key, str(dev)))
    if owner is None:
        return None, False
    return _table_cache.get(owner), False


def _table_lookup(uniq: np.ndarray, dev: torch.device):
    """Resolve a distinct-key matrix against the table cache on `dev`.
    Returns (entry, remap), remap mapping the uniq rows onto the entry's
    table rows, or (None, None).  A batch whose keys are a SUBSET of a
    cached set (a partial vote window, the VerifyScheduler's coalesced
    lanes) resolves through the key-level index; any unknown or
    cross-set key sends the whole batch to the ladder."""
    entry, exact = _lookup_touch(_set_hash(uniq), uniq[0].tobytes(), dev)
    if exact:
        return entry, np.arange(uniq.shape[0], dtype=np.int32)
    if entry is None:
        return None, None
    remap = np.empty(uniq.shape[0], dtype=np.int32)
    for i in range(uniq.shape[0]):
        row = entry.index.get(uniq[i].tobytes())
        if row is None:  # mixed known and unknown keys: the ladder
            return None, None
        remap[i] = row
    return entry, remap


def _msgs_slice(msgs, a: int, b: int):
    from tendermint_tpu_torch.libs.ragged import RaggedBytes

    if isinstance(msgs, RaggedBytes):
        return msgs.slice(a, b)
    return msgs[a:b]


def _split_chunk(n: int) -> int:
    return min(SPLIT_CHUNK, max(TILE, bucket_size(n)))


def split_chunked_launch(pubkeys, msgs, sigs, dev, feed: _ChunkFeed):
    """Cache-path launcher: the batch is padded to a multiple of the chunk
    (a 100k batch is 7 x 16,384 = 114,688 lanes), the pubkey rows come
    from the device-resident cache, and while K2 runs chunk j the host
    stages chunk j+1 (challenge hashing, packing) and its copy proceeds
    on the side stream.  Returns (outs, host_ok, n, nb, stage_s) with
    outs the per-chunk device verdicts, not yet synchronised.  `feed`
    is a _ChunkFeed of (96, _split_chunk(n)) rows."""
    n = len(pubkeys)
    chunk = _split_chunk(n)
    nb = -(-n // chunk) * chunk
    nsub = nb // chunk
    pub_m = _to_u8_matrix(pubkeys, 32)
    sig_m = _to_u8_matrix(sigs, 64)
    pub_rows = np.ascontiguousarray(pub_m.T)
    if nb != n:
        pub_rows = np.pad(pub_rows, [(0, 0), (0, nb - n)])
    pub_chunks = _pub_cache_get(pub_rows, nsub, dev)
    host_ok = np.zeros(nb, dtype=bool)
    stage_s = [0.0]

    def stage(j):
        t0 = time.perf_counter()
        a, b = j * chunk, min((j + 1) * chunk, n)
        rsk = np.zeros((96, chunk), dtype=np.uint8)
        if a < n:  # a pure padding chunk stays zero: it fails on device
            _, r_b, s_b, k, ok = _stage_rows(pub_m[a:b], sig_m[a:b],
                                             _msgs_slice(msgs, a, b))
            host_ok[a:b] = ok
            rsk[0:32, :b - a] = r_b.T
            rsk[32:64, :b - a] = s_b.T
            rsk[64:96, :b - a] = k.T
        stage_s[0] += time.perf_counter() - t0
        return rsk

    outs = []
    cur = feed.put(0, stage(0))
    for j in range(nsub):
        outs.append(feed.launch(j, ck.verify_packed_split, pub_chunks[j],
                                cur))
        if j + 1 < nsub:
            cur = feed.put(j + 1, stage(j + 1))
    return outs, host_ok[:n], n, nb, stage_s[0]


def prewarm(pubkeys, warm_kernel: bool = True, device=None) -> bool:
    """Build the comb tables of a validator set OFF the request path (a
    node calls it on every validator-set change), so that the first
    verify against the new set pays gathers, not a table build.

    `warm_kernel` also runs one tiny verify against the cached set, so
    the (comb, 64) launch bucket is seen and the first real request
    records first_launch=False.  Returns True when the tables are
    resident (already or newly built); False when the comb is disabled,
    the budget declined, or the set is below the device-lane floor (such
    batches never reach the device)."""
    dev = resolve_device(device)
    if not comb_enabled() or table_cache_budget_bytes() <= 0:
        return False
    keys = list(pubkeys)
    if not keys or len(keys) < min(PREWARM_MIN_KEYS, comb_min_batch()):
        return False
    pub_m = _to_u8_matrix(keys, 32)
    if pub_m.shape != (len(keys), 32):
        return False
    uniq = np.unique(pub_m, axis=0)
    entry, _ = _table_lookup(uniq, dev)
    if entry is None:
        entry = _table_build(uniq, _set_hash(uniq), dev)
        if entry is None:
            return False
    if warm_kernel:
        k = min(4, uniq.shape[0])
        try:
            verify_batch([uniq[i].tobytes() for i in range(k)],
                         [b"tm-tpu-prewarm"] * k, [b"\x01" * 64] * k,
                         device=dev)
        except Exception:  # noqa: BLE001 - the warm-up is best-effort;
            pass           # the tables above are resident already
    return True


def prewarm_async(pubkeys, device=None) -> None:
    """Run `prewarm` on a host-lane pool worker (or on a daemon thread of
    its own when host verification is serial, joined at exit): the
    off-path seam a validator-set change calls.  The device is resolved
    here, on the caller's thread."""
    keys = [bytes(k) for k in pubkeys]
    dev = resolve_device(device)

    def _run():
        try:
            prewarm(keys, device=dev)
        except Exception:  # noqa: BLE001 - the warm path never raises
            pass

    from tendermint_tpu_torch.crypto import lanepool
    p = lanepool.pool()
    if p is not None and p.try_submit(_run) is not None:
        return
    # joined at exit, so that interpreter teardown never freezes a thread
    # in the middle of a table build
    t = threading.Thread(target=_run, name="comb-prewarm", daemon=True)
    atexit.register(t.join)
    t.start()


def _declined_early(pub_m: np.ndarray, dev: torch.device) -> bool:
    """Whether the budget declines a buildable batch for certain, before
    its distinct keys are sorted.  The distinct first 8 bytes of its keys
    (a 1-D sort of one uint64 column) are a lower bound on its distinct
    keys; if a set of that many keys is over the budget and no set
    resident on `dev` holds that many keys, no lookup can succeed and the
    build would be declined.  The cache then sees what the exact path's
    lookup does to it (_lookup_touch: its set hash misses, and the
    owner of the batch's smallest key is touched)."""
    budget = table_cache_budget_bytes()
    if _comb_k_pad(pub_m.shape[0]) * _TABLE_BYTES_PER_KEY <= budget:
        return False      # even all keys distinct would fit
    prefix = np.ascontiguousarray(pub_m[:, :8]).view(">u8").reshape(-1)
    bound = np.unique(prefix).size
    if _comb_k_pad(bound) * _TABLE_BYTES_PER_KEY <= budget:
        return False
    for key in _table_cache.keys():
        entry = _table_cache.peek(key)
        if entry is not None and entry.device == str(dev) and \
                entry.k >= bound:
            return False
    # np.unique's first row is the smallest in byte order: the smallest
    # big-endian prefix, then the smallest of the rows that share it
    first = min(pub_m[i].tobytes()
                for i in np.flatnonzero(prefix == prefix.min()))
    _lookup_touch(None, first, dev)
    return True


def _comb_try(pubkeys, msgs, sigs, cache_pubs: bool, dev: torch.device,
              plane=None):
    """The comb route: engage iff every key resolves to one cached set on
    `dev` (building the set on a cache_pubs batch of at least
    comb_min_batch()).  Returns the bitmap, or None to fall through to
    the ladder routes.  It runs under the caller's degradation lane, so
    the breaker, the deadline, the host fallback of a drill and the
    integrity spot check apply unchanged (chaos site ops.ed25519.comb).
    With a data plane (parallel/sharding) and a batch worth sharding the
    plane runs C2 on its positions (routes mesh-comb, mesh-comb-sharded);
    a budget that declines both layouts, or a chaos fault at its seam,
    leaves the batch to the single-device comb."""
    from tendermint_tpu_torch.crypto import degrade
    from tendermint_tpu_torch.crypto import devobs

    n = len(pubkeys)
    if n == 0 or not comb_enabled():
        return None
    can_build = cache_pubs and n >= comb_min_batch()
    # with nothing cached and no build possible, skip the key matrix
    if len(_table_cache) == 0 and not can_build:
        return None
    pub_m = _to_u8_matrix(pubkeys, 32)
    if pub_m.shape != (n, 32):
        return None
    if not can_build:
        # a batch resolves only if EVERY key is in the key-level index, so
        # one probe on the first key gates the distinct-key sort below: a
        # large ladder-bound batch must not pay it because some other set
        # is cached
        with _table_key_lock:
            if (pub_m[0].tobytes(), str(dev)) not in _table_key_index:
                return None
    elif _declined_early(pub_m, dev):
        degrade.publish_route("comb", "declined")
        return None
    uniq, inverse = np.unique(pub_m, axis=0, return_inverse=True)
    inverse = np.asarray(inverse).reshape(-1)
    entry, remap = _table_lookup(uniq, dev)
    built = False
    if entry is None:
        if not can_build:
            return None
        entry = _table_build(uniq, _set_hash(uniq), dev)
        if entry is None:
            return None
        remap = np.arange(uniq.shape[0], dtype=np.int32)
        built = True
    else:
        degrade.publish_table_cache(hit=True)
    # chaos seam: a raise or latency armed here fails exactly the comb
    # dispatch; the degradation runtime owns the fallback
    fail.inject("ops.ed25519.comb")
    vidx = remap[inverse].astype(np.int32)
    t0 = time.perf_counter()
    _, r_b, s_b, kscal, host_ok = _stage_rows(
        pub_m, _to_u8_matrix(sigs, 64), msgs)
    stage_s = time.perf_counter() - t0
    res = None
    if plane is not None and plane.worth_sharding(n):
        # the plane takes the FULL batch: it owns the chunking and the
        # budget-aware table layout; the single-device comb below takes
        # what it declines (the tables are resident on the build device,
        # so declining to the ladder would throw the cached work away)
        probe = {}
        try:
            mesh_out = plane.verify_comb(r_b, s_b, kscal, vidx, entry,
                                         probe=probe)
        except fail.InjectedFault:
            degrade.publish_route("mesh-comb", "declined")
            mesh_out = None
        if mesh_out is not None:
            res, nb, shards, path = mesh_out
            phases = _overlap_phases({
                "stage_s": stage_s, "dma_s": probe.get("dma_s", 0.0),
                "dma_first_s": probe.get("dma_first_s", 0.0),
                "chunks": probe.get("chunks", 1)})
            if probe.get("shard_h2d_s"):
                phases["shard_h2d_s"] = probe["shard_h2d_s"]
            phases.update(devobs.shard_fields(n, nb, shards))
            phases["shards"] = shards
    if res is None:
        res, nb, phases = _comb_single(r_b, s_b, kscal, vidx, entry, dev,
                                       stage_s)
        path = "comb"
    _record_launch(path, dev, n, nb, time.perf_counter() - t0,
                   dict(phases, table_build=built, set_k=entry.k,
                        k_pad=entry.k_pad))
    res = fail.corrupt_bitmap("ops.ed25519.comb",
                              np.asarray(res[:n], dtype=bool))
    return res & host_ok


def _comb_single(r_b, s_b, kscal, vidx, entry, dev, stage_s: float):
    """The single-device comb: C2 in MAX_CHUNK-lane launches.  Returns
    (bitmap (n,), padded lanes, phases)."""
    from tendermint_tpu_torch.crypto import devobs

    n = r_b.shape[0]
    phases = {"stage_s": stage_s, "h2d_s": 0.0,
              "compute_s": 0.0, "collect_s": 0.0}
    # events on the stream the wrappers launch on (that of `dev`, which
    # need not be the calling thread's current device)
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    parts, nb, charged = [], 0, 0
    try:
        # MAX_CHUNK-lane launches at bucket_size(m) lanes, as every other
        # device route chunks
        for a in range(0, n, MAX_CHUNK):
            b = min(a + MAX_CHUNK, n)
            m = b - a
            cnb = bucket_size(m)
            t_pack = time.perf_counter()
            # one padded (cnb, 100) buffer: R | s | k | table row
            rows = cc.pack_rows(r_b[a:b], s_b[a:b], kscal[a:b], vidx[a:b],
                                cnb)
            phases["stage_s"] += time.perf_counter() - t_pack
            devobs.ledger_add("staging", rows.nbytes)
            charged += rows.nbytes
            t_put = time.perf_counter()
            if stream is not None:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record(stream)
            arg = torch.from_numpy(rows).to(dev)
            t_launch = time.perf_counter()
            if stream is not None:
                ev[1].record(stream)
            out = cc.comb_verify(arg, entry.tables, entry.dec_ok)
            if stream is not None:
                ev[2].record(stream)
            t_col = time.perf_counter()
            parts.append(out.cpu().numpy()[:m])   # synchronises
            phases["collect_s"] += time.perf_counter() - t_col
            if stream is not None:
                phases["h2d_s"] += ev[0].elapsed_time(ev[1]) / 1e3
                phases["compute_s"] += ev[1].elapsed_time(ev[2]) / 1e3
            else:
                phases["h2d_s"] += t_launch - t_put
                phases["compute_s"] += t_col - t_launch
            nb += cnb
    finally:
        if charged:
            devobs.ledger_add("staging", -charged)
    res = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return res, nb, dict(phases, chunks=len(parts))


def verify_batch(pubkeys, msgs, sigs, cache_pubs: bool = False,
                 device=None) -> np.ndarray:
    """End-to-end batched verify (host staging + device kernel).
    Returns a (B,) bool validity bitmap.

    cache_pubs: the caller asserts the pubkey set recurs across calls
    (validator-set paths, crypto/batch.verify_sigs_bulk): batches of at
    least PUB_CACHE_MIN take the split route with resident pubkey rows.
    With the RLC fast path enabled (msm.use_rlc) the batch is first
    checked as one random linear combination; only if that does not vouch
    for every signature does the exact per-signature route run.
    device: "cuda" (default, see tendermint_tpu_torch.resolve_device) or
    "cpu" for the kernels' plain PyTorch versions."""
    # chaos seam: the degradation runtime (crypto/degrade.py) wraps every
    # dispatch into this function, so an injected raise/latency here is
    # indistinguishable from a real device fault to the callers
    fail.inject("ops.ed25519.verify_batch")
    with trace.span("ops.ed25519.verify_batch", n=len(pubkeys)):
        return _verify_batch(pubkeys, msgs, sigs, cache_pubs,
                             resolve_device(device))


def _on_device(plane, dev: torch.device):
    """`plane` when its positions are of the caller's device type, else
    None: the device follows its owner, so a caller on the CPU never
    reaches a plane of cards (nor the reverse)."""
    if plane is None or plane.device_type != dev.type:
        return None
    return plane


def _verify_batch(pubkeys, msgs, sigs, cache_pubs: bool, dev):
    from tendermint_tpu_torch.crypto import degrade
    from tendermint_tpu_torch.parallel import sharding
    from . import msm

    n = len(pubkeys)
    sp = trace.current()
    # the GLOBAL plane outranks everything, but only answers inside a
    # lockstep() window on a multi-process runtime (ADR-027): blocksync
    # replay_window and the coordinated bulk verify, where every process
    # is known to walk the same batches in the same order.  A chaos fault
    # at its seam degrades this batch to the local routes below, on THIS
    # process only.  A collective or rendezvous fault latches the plane
    # off (the failure is deterministic) and the local routes verify the
    # batch exactly.  A card fault (degrade.card_fault) latches it off,
    # publishes the poison and is raised: the batch is never re-verified
    # on the local routes of a card that failed
    gplane = _on_device(sharding.global_plane(), dev)
    if gplane is not None and gplane.worth_sharding(n):
        try:
            return gplane.verify_batch(pubkeys, msgs, sigs)
        except fail.InjectedFault:
            degrade.publish_route("global-mesh", "declined")
            sp.add(global_mesh_fault=True)
        except Exception as e:  # noqa: BLE001 - see above
            sharding.disable_global_plane()
            if degrade.card_fault(e):
                raise
            degrade.publish_route("global-mesh", "declined")
            sp.add(global_mesh_fault=True,
                   global_mesh_err=type(e).__name__)
    # the local data plane is consulted FIRST, and the RLC fast path
    # dispatches THROUGH it (rlc-sharded: per-position partial MSMs)
    plane = _on_device(sharding.data_plane(), dev)
    if msm.use_rlc(n):
        if msm.verify_batch_rlc(pubkeys, msgs, sigs, plane=plane,
                                device=dev):
            return np.ones(n, dtype=bool)
        sp.add(rlc_fallback=True)
    # the fixed-base comb: engages when every key resolves to one resident
    # table set; unknown keys, mixed sets, evicted tables or a declined
    # budget fall through to the ladder.  A device fault (RuntimeError,
    # which a failed launch raises) or an injected one propagates to the
    # degradation runtime wrapping this dispatch; any other exception is
    # a comb bug: routed comb/error, and the ladder verifies the batch
    try:
        out = _comb_try(pubkeys, msgs, sigs, cache_pubs, dev, plane)
    except (fail.InjectedFault, RuntimeError):
        raise
    except Exception as e:  # noqa: BLE001 - see above
        degrade.publish_route("comb", "error")
        sp.add(comb_error=type(e).__name__)
        out = None
    if out is not None:
        return out
    if plane is not None and plane.worth_sharding(n):
        try:
            return plane.verify_batch(pubkeys, msgs, sigs)
        except fail.InjectedFault:
            # chaos at the mesh staging seam (sharding.mesh_stage):
            # degrade THIS batch to the single-device routes below,
            # bitmap identical.  A position's card fault (a
            # DeviceLaneError) propagates to the degradation runtime
            degrade.publish_route(plane.batch_path, "declined")
            sp.add(mesh_fault=True)
    t0 = time.perf_counter()
    phases = {}
    feed = None
    try:
        if cache_pubs and len(pubkeys) >= PUB_CACHE_MIN:
            feed = _ChunkFeed(dev, 96, _split_chunk(len(pubkeys)))
            outs, host_ok, n, nb, stage_s = split_chunked_launch(
                pubkeys, msgs, sigs, dev, feed=feed)
            phases["stage_s"] = stage_s
            path = "cuda-split"
        else:
            packed, host_ok = prepare_batch_packed(pubkeys, sigs, msgs)
            n = host_ok.shape[0]
            nb = max(TILE, bucket_size(n))
            if nb != n:  # pad the trailing (lane) axis
                packed = np.pad(packed, [(0, 0), (0, nb - n)])
            phases["stage_s"] = time.perf_counter() - t0
            nsub = max(1, nb // MAX_CHUNK)
            feed = _ChunkFeed(dev, 128, nb // nsub)
            outs = verify_packed_pipelined(packed, nsub, feed)
            path = "cuda"
        t_col = time.perf_counter()
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        res = out.cpu().numpy()  # synchronises: the wall includes execution
        phases["drain_s" if len(outs) > 1 else "collect_s"] = \
            time.perf_counter() - t_col
        phases.update(feed.phases())
    finally:
        if feed is not None:
            feed.close()
    _record_launch(path, dev, n, nb, time.perf_counter() - t0, phases)
    return res[:n] & host_ok


def verify_batch_staged(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """Batched verify through K3 (route "cuda-staged"): the host stages
    raw SHA-512 digests (prepare_batch_compact) and the kernel reduces
    them mod L.  One launch for the whole batch, padded to a power of
    two of at least TILE lanes.  Returns the (B,) bool bitmap."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    staged, host_ok = prepare_batch_compact(pubkeys, sigs, msgs)
    n = host_ok.shape[0]
    nb = max(TILE, bucket_size(n))
    padded = [torch.from_numpy(np.pad(staged[k].view(np.uint8),
                                      [(0, 0), (0, nb - n)]))
              for k in ("pub", "r", "s", "digest")]
    phases = {"stage_s": time.perf_counter() - t0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
        if dev.type == "cuda" else None
    if ev:
        ev[0].record()
    rows = [r.to(dev) for r in padded]
    if ev:
        ev[1].record()
    out = ck.verify_staged(*rows)
    if ev:
        ev[2].record()
    t_col = time.perf_counter()
    res = out.cpu().numpy()   # synchronises
    phases["collect_s"] = time.perf_counter() - t_col
    if ev:
        phases["h2d_s"] = ev[0].elapsed_time(ev[1]) / 1e3
        phases["compute_s"] = ev[1].elapsed_time(ev[2]) / 1e3
    _record_launch("cuda-staged", dev, n, nb, time.perf_counter() - t0,
                   phases)
    return res[:n] & host_ok
