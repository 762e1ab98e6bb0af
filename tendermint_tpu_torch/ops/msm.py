"""Random-linear-combination (RLC) batched ed25519 verification via a
bucketed Pippenger multi-scalar multiplication, on an NVIDIA GPU.

The counterpart of tendermint_tpu/ops/msm.py for one device (the route
"rlc-single").  A batch is valid iff

    [8] ( [sum_i z_i s_i] B  -  sum_i [z_i] R_i  -  sum_i [z_i k_i] A_i )
        == identity

for secret uniform 128-bit z_i and k_i = SHA-512(R_i || A_i || M_i) mod L.
If every signature satisfies the cofactored ed25519 equation the check
passes; if any does not, it fails except with probability about 2^-125
over z, and the caller re-runs the exact per-signature kernel for
check-all attribution.  The check is the *cofactored* one (ADR-009):
opt-in, off by default (`set_enabled`, TM_TPU_RLC=1), and it differs from
the cofactorless per-signature paths only on adversarial signatures with
a small-order residual.  s >= L and non-canonical R make a batch
ineligible on the host; a non-canonical A is accepted and reduced by
both paths, as Go's fe.SetBytes does.

The pipeline, as the JAX package's:

  host      staging (s < L, R canonical, k), z and zk = z*k mod L lifted by
            a random multiple of L (`_lift_zk`), zs = sum z*s mod L
  K4        decompress -R_i and -A_i into niels rows (ops/cuda_msm.py)
  device    c-bit window digits, ONE stable sort of every (window, digit)
            item key with its table row, the (T, K) matrix of layer rows
  K5        the layered bucket fill: bucket lane k sums its members, the
            rows layer_rows[t, k] for t < seg_len[k] (the kernel cuts
            them into segments across threads; the plain version adds
            the identity row at every step past seg_len[k])
  A1        per window sum_b b * S_b, frozen to canonical bytes
  host      Horner over the W_A window sums, the cofactor, the identity
            test (Python bignum)

With a data plane (parallel/sharding._DataPlane) and a shape its policy
accepts, the route is "rlc-sharded": each position runs K4, the sort, K5
and A1 on its rows and the partial window sums are added as points on the
host before the one identity test (plane.msm_window_sums).
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time
from types import MappingProxyType

import numpy as np
import torch

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.libs import trace
from . import cuda_msm as cm
from . import curve as C
from . import ed25519 as ed
from . import field as F

L = ed.L

# the audit logger: the JAX package logs through libs/log.logger("crypto"),
# which is the stdlib logger "tm.crypto"
_audit = logging.getLogger("tm.crypto")


# ---------------------------------------------------------------------------
# plan: static MSM geometry per (n, c)
# ---------------------------------------------------------------------------

class Plan:
    """Static shape plan for a batch of n signatures with c-bit windows.

    Items: every (scalar, window) pair contributes one bucket member:
      n * W_A for the [z_i k_i](-A_i) terms (zk lifted to 256 bits),
      n * W_R for the [z_i](-R_i) terms (128-bit z),
      W_A     for the [sum z_i s_i](B) term.
    Key space: window w owns buckets [w * 2^c, (w+1) * 2^c); R items use
    the low W_R windows.  T, the depth of the layered scan, is sized on
    the worst window's expected load (R items share the low windows, so
    ~2n/2^c members) plus a Poisson tail: P(overflow) < ~2^-30.  Overflow
    is detected on the device and the batch falls back.  (The JAX plan's
    K_pad, a 256-lane padding for the TPU's tiles, has no use here.)"""

    def __init__(self, n: int, c: int):
        self.n, self.c = n, c
        self.W_A = -(-256 // c)
        self.W_R = -(-128 // c)
        self.K = self.W_A << c
        self.M = n * (self.W_A + self.W_R) + self.W_A
        lg = math.log(self.K * (1 << 30))
        load = 2.0 * n / (1 << c)
        self.T = int(load + math.sqrt(2.0 * load * lg) + lg + 4)


def _pick_c(n: int) -> int:
    """Window width; only widths that divide 128, so every z window is
    full-width uniform.  c = 8's 8x bucket count beats c = 4's deeper
    scan from about 8k signatures."""
    return 8 if n >= 8192 else 4


# ---------------------------------------------------------------------------
# device pipeline (torch ops around the three kernels)
# ---------------------------------------------------------------------------

def _digits(b: torch.Tensor, c: int, W: int) -> torch.Tensor:
    """(m, NB) uint8 little-endian scalars -> (W, m) int32 c-bit digits;
    W * c covers the scalar (bits past NB * 8 are zero)."""
    m, NB = b.shape
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    bits = ((b.to(torch.int32)[:, :, None] >> shifts) & 1).reshape(m, NB * 8)
    need = W * c
    if need > NB * 8:
        bits = torch.cat([bits, bits.new_zeros((m, need - NB * 8))], 1)
    else:
        bits = bits[:, :need]
    w = 1 << torch.arange(c, dtype=torch.int32, device=b.device)
    return (bits.reshape(m, W, c) * w).sum(-1, dtype=torch.int32).t()


# the basepoint's niels row and the niels identity
def _niels_row_ints(x: int, y: int):
    t = x * y % C.P
    return ((y + x) % C.P, (y - x) % C.P, 2 * C.D_INT * t % C.P)


_B_NIELS = _niels_row_ints(C.BX_INT, C.BY_INT)
_ID_NIELS = (1, 1, 0)


def assemble_table(niels: torch.Tensor) -> torch.Tensor:
    """The MSM point table around the decompressed rows: row 0 = identity,
    rows 1..n = -R, rows n+1..2n = -A, row 2n+1 = B.  Kernel layout
    (2n, 3, 10) -> (2n + 2, 3, 10) on a GPU; plain layout (3, NLIMB, 2n)
    -> (3, NLIMB, 2n + 2) on the CPU."""
    dev = niels.device
    if dev.type == "cpu":
        cols = [torch.stack([torch.from_numpy(F.int_to_limbs(v))
                             for v in row])[:, :, None]
                for row in (_ID_NIELS, _B_NIELS)]
        return torch.cat([cols[0], niels, cols[1]], 2)
    return torch.cat([cm.niels10_const(_ID_NIELS).to(dev), niels,
                      cm.niels10_const(_B_NIELS).to(dev)])


class _Marks:
    """CUDA events at the pipeline's stage boundaries (nothing on the
    CPU); `phases()` after the results were collected."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.events = []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append((name, ev))

    def phases(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[f"{name}_s"] = a.elapsed_time(b) / 1e3
        if len(self.events) > 1:
            out["device_s"] = self.events[0][1].elapsed_time(
                self.events[-1][1]) / 1e3
        names = [name for name, _ in self.events]
        if "h2d" in names and names[-1] != "h2d":
            # the kernels' share: from the copies' end to the last stage
            out["compute_s"] = self.events[names.index("h2d")][1] \
                .elapsed_time(self.events[-1][1]) / 1e3
        return out


def _msm_pipeline(r_bytes, pub_bytes, zk, z, zs, c: int, marks=None):
    """The device pipeline.  Inputs are uint8 tensors on one device:
    r_bytes / pub_bytes / zk (n, 32), z (n, 16), zs (32,).  Returns
    (window sums (4, W_A, 32) canonical bytes of X, Y, Z, T, decode_ok_all
    and overflow as 0-dim bool tensors)."""
    n = r_bytes.shape[0]
    plan = Plan(n, c)
    W_A, W_R, K, M, T = plan.W_A, plan.W_R, plan.K, plan.M, plan.T
    dev = r_bytes.device
    marks = marks or _Marks(dev)

    b_rows = torch.cat([r_bytes, pub_bytes]).t().contiguous()   # (32, 2n)
    niels, ok = cm.decompress_niels(b_rows)
    table = assemble_table(niels)
    marks.mark("k4")

    dA = _digits(zk, c, W_A)                       # (W_A, n)
    dR = _digits(z, c, W_R)                        # (W_R, n)
    dB = _digits(zs[None, :], c, W_A)              # (W_A, 1)
    i32 = dict(dtype=torch.int32, device=dev)
    wA = torch.arange(W_A, **i32)[:, None]
    wR = torch.arange(W_R, **i32)[:, None]

    # digit-0 items have weight 0 and go to the trash key K, which sorts
    # past every real bucket and is never scanned (the top window's digit
    # is often 0, and padding rows are all-zero scalars)
    def key_of(w, d):
        return torch.where(d == 0, K, (w << c) + d)

    keys = torch.cat([key_of(wA, dA).reshape(-1), key_of(wR, dR).reshape(-1),
                      key_of(wA, dB).reshape(-1)])
    ar = torch.arange(n, **i32)[None, :]
    rows = torch.cat([
        (ar + n + 1).expand(W_A, n).reshape(-1),    # -A rows
        (ar + 1).expand(W_R, n).reshape(-1),        # -R rows
        torch.full((W_A,), 2 * n + 1, **i32),       # B row
    ])
    # stable, as jax.lax.sort: a bucket's members are added in item order,
    # so its sum is the JAX package's projective representative
    sk, order = torch.sort(keys, stable=True)
    srows = rows[order]
    starts = torch.searchsorted(sk, torch.arange(K + 1, **i32), right=False)
    seg_len = starts[1:] - starts[:-1]
    overflow = seg_len.max() > T
    t_idx = torch.arange(T, device=dev)[:, None]
    pos = (starts[:-1][None, :] + t_idx).clamp(0, M - 1)
    valid = t_idx < seg_len[None, :]
    layer_rows = torch.where(valid, srows[pos], 0).to(torch.int32)  # (T, K)
    marks.mark("sort")

    buckets = cm.bucket_scan(table, layer_rows, seg_len.to(torch.int32))
    marks.mark("k5")
    ws = cm.aggregate(buckets, W_A, c)
    marks.mark("a1")
    return ws, ok.all(), overflow


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

def _add_int(P, Q):
    """Unified extended-coords addition on Python ints (add-2008-hwcd-3,
    a = -1; the bignum mirror of curve.add_cached)."""
    p = C.P
    X1, Y1, Z1, T1 = P
    X2, Y2, Z2, T2 = Q
    a = (Y1 - X1) * (Y2 - X2) % p
    b = (Y1 + X1) * (Y2 + X2) % p
    cc = T1 * T2 % p * (2 * C.D_INT) % p
    d = 2 * Z1 * Z2 % p
    e, f, g, h = b - a, d - cc, d + cc, b + a
    return (e * f % p, g * h % p, f * g % p, e * h % p)


def _dbl_int(P):
    p = C.P
    X1, Y1, Z1, _ = P
    a = X1 * X1 % p
    b = Y1 * Y1 % p
    cc = 2 * Z1 * Z1 % p
    e = ((X1 + Y1) * (X1 + Y1) - a - b) % p
    g = b - a
    f = (g - cc) % p
    h = (-a - b) % p
    return (e * f % p, g * h % p, f * g % p, e * h % p)


def _combine_windows_host(ws: np.ndarray, c: int) -> bool:
    """ws: (4, W, 32) uint8 canonical window sums.  Horner-combine with
    window weight 2^(c*w), multiply by the cofactor, test for the
    identity."""
    W = ws.shape[1]
    pts = [tuple(int.from_bytes(ws[j, w].tobytes(), "little")
                 for j in range(4)) for w in range(W)]
    total = (0, 1, 1, 0)
    for w in reversed(range(W)):
        for _ in range(c):
            total = _dbl_int(total)
        total = _add_int(total, pts[w])
    for _ in range(3):                     # cofactor 8
        total = _dbl_int(total)
    X, Y, Z, _ = total
    return X % C.P == 0 and (Y - Z) % C.P == 0


def _r_canonical(r_bytes: np.ndarray) -> np.ndarray:
    """(n, 32) uint8: y(R) < p, vectorized (the per-signature path rejects
    a non-canonical R by its byte compare; the MSM would decode it, so
    such batches skip the fast path)."""
    w = np.ascontiguousarray(r_bytes).copy()
    w[:, 31] &= 0x7F
    ww = w.view("<u8")
    top = np.uint64(0x7FFFFFFFFFFFFFFF)
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    lo = np.uint64(0xFFFFFFFFFFFFFFED)
    return ~((ww[:, 3] == top) & (ww[:, 2] == ones) & (ww[:, 1] == ones)
             & (ww[:, 0] >= lo))


def _rlc_scalars_host(z: np.ndarray, k: np.ndarray, s: np.ndarray):
    """Pure-Python fallback for native.rlc_scalars."""
    n = z.shape[0]
    zk = np.empty((n, 32), dtype=np.uint8)
    acc = 0
    for i in range(n):
        zi = int.from_bytes(z[i].tobytes(), "little")
        ki = int.from_bytes(k[i].tobytes(), "little")
        si = int.from_bytes(s[i].tobytes(), "little")
        zk[i] = np.frombuffer(((zi * ki) % L).to_bytes(32, "little"),
                              dtype=np.uint8)
        acc = (acc + zi * si) % L
    return zk, np.frombuffer(acc.to_bytes(32, "little"), dtype=np.uint8)


# ---------------------------------------------------------------------------
# opt-in
# ---------------------------------------------------------------------------

def _rlc_min() -> int:
    return int(os.environ.get("TM_TPU_RLC_MIN", "1024"))


# explicit opt-in (config [batch_verifier] rlc, or TM_TPU_RLC=1); default
# OFF: the RLC check is cofactored while the reference Go verifier is
# cofactorless, so a mixed fleet could be split by an adversarial
# small-order-component signature (ADR-009)
_enabled_override: "bool | None" = None


def set_enabled(on: "bool | None"):
    """Config-driven override of the RLC opt-in (wins over the env).
    None clears the override (defer to TM_TPU_RLC)."""
    global _enabled_override
    _enabled_override = None if on is None else bool(on)


def use_rlc(n: int) -> bool:
    """Whether the RLC fast path should be attempted for an n-signature
    batch (below TM_TPU_RLC_MIN the per-signature kernel is cheaper)."""
    if _enabled_override is not None:
        enabled = _enabled_override
    else:
        enabled = os.environ.get("TM_TPU_RLC", "0") == "1"
    return enabled and n >= _rlc_min()


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

def _b_enc_bytes() -> np.ndarray:
    enc = (C.BY_INT | ((C.BX_INT & 1) << 255)).to_bytes(32, "little")
    return np.frombuffer(enc, dtype=np.uint8)


_B_ENC = _b_enc_bytes()

# u * L for u = 0..14 as little-endian rows: zk + 14L < 15L < 2^256
_L_MULTS = np.stack([
    np.frombuffer((u * L).to_bytes(32, "little"), dtype=np.uint8)
    for u in range(15)])


def _lift_zk(zk: np.ndarray, u: np.ndarray) -> np.ndarray:
    """zk + u * L per row (256-bit add over uint64 words).  zk < L ~ 2^252
    would pile the top window's digits onto a few buckets and overflow
    the layered scan; the lift spreads zk over [0, 15L) without changing
    the verdict, since [8][uL]A == O for every A."""
    a = np.ascontiguousarray(zk).view("<u8")              # (n, 4)
    b = np.ascontiguousarray(_L_MULTS[u]).view("<u8")     # (n, 4)
    out = np.empty_like(a)
    carry = np.zeros(a.shape[0], dtype=np.uint64)
    for w in range(4):
        s = a[:, w] + b[:, w]
        c1 = s < a[:, w]
        s = s + carry
        c2 = s < carry
        out[:, w] = s
        carry = (c1 | c2).astype(np.uint64)
    return out.view(np.uint8)


def _stage_rlc(pub_m, msgs, sigs, z=None):
    """Host staging: R/s split, canonicity screens, challenge scalars and
    the RLC coefficients.  Returns (r_bytes, zk, z, zs), or None when the
    batch is ineligible (s >= L or a non-canonical R).

    `z` is injectable so that tests can run the same combination through
    two implementations; it then also fixes the lift (u = z[:, 0] % 15).
    Without it z and u come from os.urandom."""
    from tendermint_tpu_torch.libs import native

    sig_m = ed._to_u8_matrix(sigs, 64)
    n = pub_m.shape[0]
    _, r_bytes, s_bytes, k, host_ok = ed._stage_rows(pub_m, sig_m, msgs)
    if not host_ok.all() or not _r_canonical(r_bytes).all():
        return None
    if z is None:
        z = np.frombuffer(os.urandom(16 * n), dtype=np.uint8).reshape(n, 16)
        u = np.frombuffer(os.urandom(n), dtype=np.uint8) % 15
    else:
        u = np.ascontiguousarray(z[:, 0]) % 15
    res = native.rlc_scalars(z, k, s_bytes)
    if res is None:
        res = _rlc_scalars_host(z, k, s_bytes)
    zk, zs = res
    zk = _lift_zk(zk, u.astype(np.int64))
    return r_bytes, zk, z, zs


def _pad_rows(r_bytes, pub_m, zk, z, nb: int):
    """Pad the batch to nb rows with zero-scalar basepoint items: digit 0
    everywhere (the trash bucket), and B decodes."""
    n = r_bytes.shape[0]
    if nb == n:
        return r_bytes, pub_m, zk, z
    pad = nb - n
    r_bytes = np.concatenate([r_bytes, np.broadcast_to(_B_ENC, (pad, 32))])
    pub_m = np.concatenate([pub_m, np.broadcast_to(_B_ENC, (pad, 32))])
    zk = np.concatenate([zk, np.zeros((pad, 32), np.uint8)])
    z = np.concatenate([z, np.zeros((pad, 16), np.uint8)])
    return r_bytes, pub_m, zk, z


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

_route_lock = threading.Lock()
_last_route = MappingProxyType({"path": None})


def last_route():
    """Immutable snapshot of the most recent route decision: path, n, nb,
    shards, c, outcome ("ineligible", "overflow", "decode-failed",
    "rejected" or "vouched")."""
    with _route_lock:
        return _last_route


def _set_route(route: dict, dev=None, wall_s: float = 0.0,
               phases=None) -> None:
    """Publish a route decision: swap the snapshot under the lock, count
    it into CryptoMetrics (crypto_msm_route_total{path, outcome}) at set
    time, and mark it on the flight recorder; when an MSM ran (nb set),
    mirror it into ops/ed25519's launch record with its phases."""
    global _last_route
    snap = MappingProxyType(dict(route))
    with _route_lock:
        _last_route = snap
    from tendermint_tpu_torch.crypto import degrade
    degrade.publish_route(route.get("path"), route.get("outcome"),
                          n=route.get("n"), nb=route.get("nb"))
    nb = route.get("nb")
    if nb:
        extra = dict(phases or {}, c=route["c"], shards=route["shards"],
                     outcome=route["outcome"])
        ed._set_last_launch(route["path"], dev, route["n"], nb, wall_s,
                            extra)
    trace.instant("msm.route", **route)
    trace.current().add(path=route.get("path"),
                        outcome=route.get("outcome"))


def verify_batch_rlc(pubkeys, msgs, sigs, z=None, device=None,
                     plane=None) -> bool:
    """All-or-nothing RLC batch verification.  True: every signature
    passes (cofactored semantics); False: at least one fails, or the
    batch is ineligible (non-canonical encodings), fails to decode or
    overflows a bucket — the caller must then use the per-signature path
    for exact attribution.  device: "cuda" (default) or "cpu" for the
    kernels' plain versions.

    With `plane` (parallel/sharding._DataPlane) and a shape that passes
    plane.worth_sharding_msm, the MSM runs as per-position partial MSMs
    (route "rlc-sharded"), reduced on the host before the single
    cofactored identity test.  The partition never changes the combined
    group element, and the RLC scalars are staged once on the host in
    row order, so the sharded verdict is the single-device one."""
    dev = resolve_device(device)
    pub_m = ed._to_u8_matrix(pubkeys, 32)
    n = pub_m.shape[0]
    if n == 0:
        return True
    t0 = time.perf_counter()
    staged = _stage_rlc(pub_m, msgs, sigs, z=z)
    if staged is None:
        _set_route({"path": "rlc-ineligible", "n": n, "shards": 0,
                    "outcome": "ineligible"})
        return False
    r_bytes, zk, z, zs = staged
    if plane is not None and plane.worth_sharding_msm(n):
        from tendermint_tpu_torch.crypto import devobs

        nb = plane.msm_bucket(n)
        c = _pick_c(nb // plane.nshard)
        r_bytes, pub_m, zk, z = _pad_rows(r_bytes, pub_m, zk, z, nb)
        phases = {"stage_s": time.perf_counter() - t0}
        probe = {} if devobs.is_enabled() else None
        ws, ok_all, overflow = plane.msm_window_sums(
            r_bytes, pub_m, zk, z, zs, c, probe=probe)
        if probe:
            # per-position put walls ride the route into last_launch
            phases.update(probe)
        dev = plane.mesh.devices[0]
        route = {"path": "rlc-sharded", "n": n, "nb": nb,
                 "shards": plane.nshard, "c": c}
    else:
        nb = ed.bucket_size(n)
        c = _pick_c(nb)
        r_bytes, pub_m, zk, z = _pad_rows(r_bytes, pub_m, zk, z, nb)
        phases = {"stage_s": time.perf_counter() - t0}
        marks = _Marks(dev)
        marks.mark("start")
        args = [torch.from_numpy(np.require(a, requirements=("C", "W")))
                .to(dev) for a in (r_bytes, pub_m, zk, z, zs)]
        marks.mark("h2d")
        ws, ok_all, overflow = _msm_pipeline(*args, c, marks=marks)
        t_col = time.perf_counter()
        ws = ws.cpu().numpy()       # synchronises
        ok_all, overflow = bool(ok_all), bool(overflow)
        phases["collect_s"] = time.perf_counter() - t_col
        phases.update(marks.phases())
        route = {"path": "rlc-single", "n": n, "nb": nb, "shards": 1,
                 "c": c}
    if not ok_all or overflow:
        route["outcome"] = "overflow" if overflow else "decode-failed"
        _set_route(route, dev, time.perf_counter() - t0, phases)
        return False
    t_comb = time.perf_counter()
    vouched = _combine_windows_host(ws, c)
    phases["combine_s"] = time.perf_counter() - t_comb
    route["outcome"] = "vouched" if vouched else "rejected"
    _set_route(route, dev, time.perf_counter() - t0, phases)
    if vouched:
        # audit line for mixed fleets: the cofactored check stood in for n
        # exact cofactorless verifies (ADR-009)
        _audit.info("rlc cofactored batch check vouched sigs=%d shards=%d",
                    n, route["shards"])
    return vouched
