"""BatchVerifier — the GPU signature-verification data plane.

The counterpart of tendermint_tpu/crypto/batch.py for one device: call
sites enqueue (pubkey, msg, sig) triples and get back an exact per-triple
validity bitmap, computed in one batched kernel launch per chunk (see
ops/ed25519.py).

Routing (as the JAX package): batches below `tpu_threshold` stay on the
host (SigCache first, then OpenSSL for ed25519 and the native C lanes of
crypto/lanepool.py for secp256k1 and sr25519); per-scheme batches of at
least `tpu_threshold` go to the device — ed25519 to K1-K3 (ops/ed25519.py),
secp256k1 to S1 (ops/secp.py; set_lane_enabled(False) or
TM_TPU_SECP_LANE=0 is the rollback switch to the host C lane), sr25519 to
S2 (ops/sr25519.py) — through the
degradation runtime (crypto/degrade.py), which bounds each launch by a
deadline, spot-checks its bitmap on the host, counts failures against a
circuit breaker and re-verifies a failed launch on the host, so the
caller's bitmap is exact whatever the device did.  On the card that
re-verify happens only in a chaos drill (a failpoint armed); outside one
a failed launch raises degrade.DeviceLaneError to the caller.

Device rule (_use_device): TM_TPU_DISABLE_BATCH=1 keeps every batch on
the host lanes (an explicit opt-out); TM_TPU_FORCE_BATCH=1 takes the
device lane on whatever device the caller names ("cpu" runs the kernels'
plain PyTorch versions); otherwise `device` decides — "cpu" asked for
explicitly takes the host lanes, "cuda" the device lane, and CUDA
missing without a request for the CPU raises RuntimeError.

Consumers that run concurrently coalesce through the VerifyScheduler
(crypto/scheduler.py): verify_sigs_bulk's list branch routes there when
it runs on the caller's device.  A mixed batch's host lanes run side by
side on the host-lane pool (crypto/lanepool.py).
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.libs import trace
from . import PubKey
from . import degrade
from . import ed25519 as ed
from . import lanepool


def _use_device(device=None) -> bool:
    """Whether an eligible batch takes the device lane (see the module
    docstring).  Never returns False because CUDA is missing: that
    raises, unless the caller asked for the CPU or opted out."""
    if os.environ.get("TM_TPU_DISABLE_BATCH", "") == "1":
        return False
    if os.environ.get("TM_TPU_FORCE_BATCH", "") == "1":
        return True
    if resolve_device(device).type == "cpu":
        return False
    if not degrade.runtime().backend_available():
        raise RuntimeError(
            "tendermint_tpu_torch: the CUDA backend failed to initialise")
    return True


def _load_kernels(device, n: int, schemes=(ed.KEY_TYPE,)):
    """The torch.device a device lane launches on, resolved HERE on the
    caller's thread (the lane worker must not resolve it: its current
    CUDA device is 0), with the kernels that the lanes of `schemes` will
    launch built and loaded here too: K1-K3 (the comb's C1 and C2 while
    the comb is on, the RLC kernels when msm.use_rlc(n)) for ed25519, S1
    for secp256k1 while its lane is on,
    S2 for sr25519.  An nvcc build takes tens of seconds to minutes:
    inside the lane worker it would run under the launch deadline, time
    out and fall back to the host with the kernel never run.  Called
    before the breaker is asked, so a build failure raises to the caller
    and is never counted as a device failure."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from tendermint_tpu_torch.ops import (cuda_comb, cuda_ed25519,
                                              cuda_msm, cuda_secp,
                                              cuda_sr25519, msm, secp)
        from tendermint_tpu_torch.ops import ed25519 as edops
        if ed.KEY_TYPE in schemes:
            cuda_ed25519.kernels()
            if edops.comb_enabled():
                cuda_comb.kernels()
            if msm.use_rlc(n):
                cuda_msm.kernels()
        if "secp256k1" in schemes and secp.use_lane():
            cuda_secp.kernels()
        if "sr25519" in schemes:
            cuda_sr25519.kernels()
    return dev


class _SpotCheck:
    """Integrity guard of a device lane: re-verify ONE random triple on
    the host and require the device's bit to agree — one host verify per
    launch, and a device returning garbage bitmaps (chaos mode
    "corrupt-bitmap", a real silent-corruption class) is degraded
    instead of trusted.  `triple_at(j) -> (pub, msg, sig)` with pub a
    PubKey object.  The runtime calls prepare() after the submit and
    before it waits for the launch, so the host verify is not left until
    the bitmap is back; the call with the bitmap compares one bit.  The
    verify (OpenSSL through `cryptography`) holds the GIL, so the lane
    worker starts its launch once it is done."""

    def __init__(self, n: int, triple_at):
        self.n = n
        self._triple_at = triple_at
        self._verdict = None  # (j, host bit) once prepared

    def prepare(self):
        if self._verdict is not None or self.n == 0:
            return
        j = random.randrange(self.n)
        try:
            pub, msg, sig = self._triple_at(j)
            host = pub.verify_signature(msg, sig)
        except Exception:  # noqa: BLE001 - malformed input = invalid
            host = False
        self._verdict = (j, bool(host))

    def __call__(self, bits: np.ndarray) -> bool:
        if self.n == 0 or len(bits) != self.n:
            return len(bits) == self.n
        self.prepare()
        j, host = self._verdict
        return bool(bits[j]) == host


def _spot_check_items(items):
    return _SpotCheck(len(items),
                      lambda j: (items[j].pub, items[j].msg, items[j].sig))


@dataclass
class _Item:
    pub: PubKey
    msg: bytes
    sig: bytes


class SigCache:
    """Bounded LRU cache of signatures that ALREADY verified valid.

    Only valid triples are ever inserted, so a hit is exactly as strong as
    a fresh verification.  add/hit are lock-guarded, and eviction is true
    LRU (a hit refreshes recency)."""

    def __init__(self, capacity: int = 1 << 16):
        import collections
        import threading
        self.capacity = capacity
        self._set: "collections.OrderedDict[bytes, None]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(pub_bytes: bytes, msg: bytes, sig: bytes) -> bytes:
        import hashlib
        h = hashlib.sha256()
        h.update(pub_bytes)
        h.update(sig)
        h.update(msg)
        return h.digest()

    def add(self, pub_bytes: bytes, msg: bytes, sig: bytes) -> None:
        self.add_key(self.key(pub_bytes, msg, sig))

    def add_key(self, k: bytes) -> None:
        with self._lock:
            self._set[k] = None
            self._set.move_to_end(k)  # re-insert refreshes recency too
            while len(self._set) > self.capacity:
                self._set.popitem(last=False)

    def hit(self, pub_bytes: bytes, msg: bytes, sig: bytes) -> bool:
        return self.hit_key(self.key(pub_bytes, msg, sig))

    def hit_key(self, k: bytes) -> bool:
        with self._lock:
            ok = k in self._set
            if ok:
                self._set.move_to_end(k)  # LRU: a hit is a use
                self.hits += 1
            else:
                self.misses += 1
            return ok

    def __len__(self) -> int:
        with self._lock:
            return len(self._set)


verified_sigs = SigCache()


class BatchVerifier:
    """Collect (pubkey, msg, sig) triples; verify them in one batch.

    Every triple is verified exactly and independently — no early exit,
    no probabilistic batch equation — so the returned bitmap identifies
    offenders directly (the reference's check-all commit semantics)."""

    def __init__(self, tpu_threshold: int = 32, device=None):
        self._items: List[_Item] = []
        self.tpu_threshold = tpu_threshold
        self.device = device

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub: PubKey, msg: bytes, sig: bytes) -> None:
        self._items.append(_Item(pub, bytes(msg), bytes(sig)))

    def verify(self) -> Tuple[bool, np.ndarray]:
        """Returns (all_valid, per-item bool bitmap, in insertion order)."""
        n = len(self._items)
        if n == 0:
            return True, np.zeros(0, dtype=bool)
        # verify() entry is this request's "submit": the e2e bracket lands
        # in the verify_e2e_latency histogram, labeled path="direct"
        t_submit = time.monotonic()
        # flight-recorder root of the batch: the lane spans (device.launch
        # on the worker, device.collect, the verdict) link under it
        with trace.span("batch.verify", n=n,
                        threshold=self.tpu_threshold) as sp:
            ok, bits = self._verify(n, sp, t_submit)
        degrade.publish_request_latency(
            _context_priority_name(), "direct",
            time.monotonic() - t_submit)
        return ok, bits

    def _verify(self, n: int, sp,
                t_submit: Optional[float] = None) -> Tuple[bool, np.ndarray]:
        out = np.zeros(n, dtype=bool)
        by_type: dict = {}
        for i, it in enumerate(self._items):
            by_type.setdefault(it.pub.type_name, []).append(i)
        # tiny-batch hot path (a consensus vote window): below the
        # threshold no lane can reach the device, so the runtime (whose
        # breaker lock is shared across callers) is never touched
        rt = degrade.runtime() if n >= self.tpu_threshold else None
        # [(tname, idxs, items, future, t0, done_at, on_card)]
        device_lanes = []
        host_lanes = []
        for tname, idxs in by_type.items():
            items = [self._items[i] for i in idxs]
            verifier = _device_verifier(tname) if rt is not None else None
            if (verifier is not None and len(items) >= self.tpu_threshold
                    and _use_device(self.device)):
                dev = _load_kernels(self.device, len(items), (tname,))
                if rt.try_acquire():
                    t0 = time.monotonic()
                    fut = rt.submit(
                        f"batch.{tname}", partial(verifier, device=dev),
                        [it.pub.bytes() for it in items],
                        [it.msg for it in items],
                        [it.sig for it in items])
                    done_at = _lane_done_stamp(fut)
                    device_lanes.append((tname, idxs, items, fut, t0,
                                         done_at, dev.type == "cuda"))
                    continue
                # breaker open: this lane WOULD have gone to the device
                rt.allow_fallback(f"batch.{tname}", "breaker_open",
                                  dev.type == "cuda")
            host_lanes.append((tname, idxs, items))
        if trace.is_enabled():
            sp.add(schemes=",".join(f"{t}:{len(ix)}"
                                    for t, ix in by_type.items()),
                   device_lanes=len(device_lanes),
                   host_lanes=len(host_lanes),
                   device_eligible=rt is not None)
        lane_times: List[Tuple[str, str, float, float]] = []
        try:
            _run_host_lanes(host_lanes, out, "batch.host_lane",
                            sp.span_id, lane_times=lane_times,
                            t_submit=t_submit)
        finally:
            # always settle EVERY device lane: a host-lane exception must
            # not abandon an in-flight launch or leave the breaker's
            # acquire unbalanced.  A launch that times out, raises, or
            # fails the host spot check is counted against the breaker
            # and the lane re-verifies on the host, preserving the exact
            # per-triple bitmap — on the card only in a chaos drill;
            # otherwise collect() raises DeviceLaneError, which is raised
            # once every other lane of the batch is settled too.
            card_fault = None
            for tname, idxs, items, fut, t0, done_at, on_card in \
                    device_lanes:
                try:
                    out[np.asarray(idxs)] = rt.collect(
                        f"batch.{tname}", fut,
                        host_fn=partial(_host_verify_items, tname, items),
                        spot_check=_spot_check_items(items),
                        on_card=on_card)
                except degrade.DeviceLaneError as e:
                    card_fault = card_fault or e
                    continue
                lane_times.append((tname, "device", t0,
                                   done_at[0] if done_at
                                   else time.monotonic()))
            if card_fault is not None:
                raise card_fault
        _publish_lane_report(lane_times, sp, rt is not None)
        # remember the valid ones so later serial re-checks are cache hits
        with trace.span("batch.verdict") as vsp:
            for i, it in enumerate(self._items):
                if out[i]:
                    verified_sigs.add(it.pub.bytes(), it.msg, it.sig)
            if trace.is_enabled():
                vsp.add(valid=int(out.sum()), n=n)
        return bool(out.all()), out


def _run_host_lanes(host_lanes, out: np.ndarray, span_name: str, parent,
                    assume_miss: bool = False, lane_times=None,
                    t_submit: Optional[float] = None):
    """Run the per-scheme host lanes concurrently through the host-lane
    pool (crypto/lanepool.run_lanes), so the host side of a mixed batch
    costs the max over its lanes instead of their sum; lanes the pool
    does not admit (disabled or saturated) run serially in the caller.
    `parent` is the caller's span id, linking each lane span under the
    batch span across the pool's threads; `assume_miss` is passed to
    _host_verify_items; `lane_times` (when given) collects (scheme, kind,
    t0, t1) wall brackets for the lane report; `t_submit` is the
    request's lifecycle origin, recorded on each lane span."""
    if not host_lanes:
        return

    def lane(tname, items):
        t0 = time.monotonic()
        with trace.span(span_name, parent=parent, scheme=tname,
                        n=len(items)) as lsp:
            if t_submit is not None and trace.is_enabled():
                lsp.add(since_submit_s=round(t0 - t_submit, 6))
            bits = _host_verify_items(tname, items, assume_miss=assume_miss,
                                      t_submit=t_submit)
        if lane_times is not None:
            lane_times.append((tname, "host", t0, time.monotonic()))
        return bits

    # lane-level pooling needs at least MIN_CHUNK items across the lanes:
    # a tiny mixed vote window must not construct the pool or pay future
    # handoffs on the consensus hot path
    if len(host_lanes) > 1 and \
            sum(len(items) for _, _, items in host_lanes) \
            >= lanepool.MIN_CHUNK:
        results = lanepool.run_lanes(
            [partial(lane, tname, items)
             for tname, _idxs, items in host_lanes])
    else:
        results = [lane(tname, items)
                   for tname, _idxs, items in host_lanes]
    for (tname, idxs, items), bits in zip(host_lanes, results):
        out[np.asarray(idxs)] = bits


def _lane_done_stamp(fut) -> list:
    """Timestamp box filled when a device-lane future completes: the
    lane's wall bracket ends when the DEVICE finished, not when the
    caller got around to collect().  A launch that never completes
    (timeout/quarantine) leaves the box empty and the bracket falls back
    to collect-return, which then includes the host re-verify."""
    done_at: list = []

    def _stamp(_f):
        done_at.append(time.monotonic())
    fut.add_done_callback(_stamp)
    return done_at


_last_lanes: dict = {}


def last_lane_report() -> dict:
    """Wall-time decomposition of the most recent verify with lanes:
    {"lanes": [{"scheme", "kind", "wall_s"}, ...], "wall_s", "sum_s",
    "overlap_ratio"} — overlap_ratio = 1 - wall/sum is 0 for serial
    lanes and (k-1)/k for k perfectly overlapped ones."""
    return _last_lanes


def _publish_lane_report(lane_times, sp, publish_metrics: bool):
    """Fold per-lane wall brackets into the lane report + the
    crypto_lane_overlap_ratio gauge (skipped for tiny batches, which
    never touch degrade.runtime()).  Returns THIS call's report dict
    (None when there were no lanes)."""
    global _last_lanes
    if not lane_times:
        return None
    wall = max(t1 for _, _, _, t1 in lane_times) - \
        min(t0 for _, _, t0, _ in lane_times)
    total = sum(t1 - t0 for _, _, t0, t1 in lane_times)
    overlap = 0.0
    if len(lane_times) > 1 and total > 0 and wall > 0:
        overlap = max(0.0, 1.0 - wall / total)
    report = {
        "lanes": [{"scheme": s, "kind": k, "wall_s": round(t1 - t0, 6)}
                  for s, k, t0, t1 in lane_times],
        "wall_s": round(wall, 6),
        "sum_s": round(total, 6),
        "overlap_ratio": round(overlap, 4),
    }
    _last_lanes = report
    if len(lane_times) > 1:
        if trace.is_enabled():
            sp.add(lane_overlap=round(overlap, 4))
        if publish_metrics:
            degrade.publish_lane_overlap(overlap)
    return report


def _context_priority_name() -> str:
    """Priority label for the direct path's e2e latency: the caller's
    scheduler priority context when one is set (scheduler.
    priority_context), COMMIT otherwise.  Lazy import — the scheduler
    imports this module at load."""
    try:
        from tendermint_tpu_torch.crypto import scheduler as vsched
        return vsched.context_priority(
            vsched.Priority.COMMIT)[0].name.lower()
    except Exception:  # noqa: BLE001 - a label must never break verify
        return "commit"


def _device_verifier(tname: str):
    """The device lane for a key scheme, or None if that scheme stays on
    the host.  ed25519: K1-K3 (ops/ed25519.py); sr25519: S2
    (ops/sr25519.py); secp256k1: S1 (ops/secp.py) unless the rollback
    switch is thrown (secp.use_lane()).  Each is called with (pubs, msgs,
    sigs, device=)."""
    if tname == ed.KEY_TYPE:
        return verify_ed25519_batch
    if tname == "sr25519":
        return _verify_sr25519
    if tname == "secp256k1":
        from tendermint_tpu_torch.ops import secp as secp_ops
        if secp_ops.use_lane():
            return _verify_secp256k1
    return None


def _verify_sr25519(pubs, msgs, sigs, device=None) -> np.ndarray:
    from tendermint_tpu_torch.ops import sr25519 as srlane
    return srlane.verify_batch_device(pubs, msgs, sigs, device=device)


def _verify_secp256k1(pubs, msgs, sigs, device=None) -> np.ndarray:
    from tendermint_tpu_torch.ops import secp as secp_ops
    return secp_ops.verify_batch_device(pubs, msgs, sigs, device=device)


def _host_verify_items(tname: str, items, assume_miss: bool = False,
                       t_submit: Optional[float] = None) -> np.ndarray:
    """Host lane of scheme `tname`: SigCache hits first; the misses of
    secp256k1 and sr25519 batch through their native C verifiers
    (native/ecverify.c), sharded across the host pool's cores by
    lanepool.verify_sharded; ed25519 misses, and every miss where no C
    toolchain exists or a length is malformed, verify one by one
    (verify_signature).  `assume_miss` skips the cache pre-pass when the
    caller already filtered hits (the scheduler's stager hashed every
    triple once and resolved hits without lanes).  `t_submit`, the
    request's lifecycle origin, is recorded on the lanepool.verify
    span."""
    n = len(items)
    bits = np.zeros(n, dtype=bool)
    if assume_miss:
        miss = list(range(n))
    else:
        miss = []
        for i, it in enumerate(items):
            if verified_sigs.hit(it.pub.bytes(), it.msg, it.sig):
                bits[i] = True
            else:
                miss.append(i)
    if not miss:
        return bits
    sub = lanepool.verify_sharded(
        tname,
        [items[i].pub.bytes() for i in miss],
        [items[i].msg for i in miss],
        [items[i].sig for i in miss],
        t_submit=t_submit)
    if sub is None:
        sub = [items[i].pub.verify_signature(items[i].msg, items[i].sig)
               for i in miss]
    bits[np.asarray(miss)] = sub
    return bits


def verify_sigs_bulk(pubs: Sequence[PubKey], msgs, sigs: Sequence[bytes],
                     tpu_threshold: int = 32, device=None,
                     coordinated: bool = False) -> np.ndarray:
    """Bitmap for n (pub, msg, sig) triples without per-item _Item objects
    — the whole-commit path (types/validator_set.py), where n can be 100k+.
    `msgs` may be a RaggedBytes (the batched sign-bytes assembler's output)
    or any sequence of bytes; `pubs` a list of PubKeys or the (n, 32)
    uint8 raw ed25519 pubkey matrix of the validator-set fast path.

    Routing matches BatchVerifier: big all-ed25519 batches go to the
    device through the degradation runtime (site "bulk.ed25519"), with
    the pubkey rows kept device-resident (cache_pubs: a validator set's
    keys recur every block) and the host re-verify as its fallback;
    every other batch goes through BatchVerifier, which fills the
    SigCache.

    When the process-global VerifyScheduler is running on the caller's
    device, list-input batches up to its max_batch route through it
    instead (at the caller's priority context, default COMMIT, without
    filling the SigCache) so concurrent consumers coalesce into shared
    launches.  Batches above max_batch and the (n, 32) raw-pubkey-matrix
    input (the validator-set per-block path with its device-resident
    key cache) keep the direct path.  Only SchedulerError and
    TimeoutError send a scheduled batch to the direct path: a launch
    that failed on the card raises DeviceLaneError here, as it does on
    the direct path.

    coordinated=True: the caller asserts every process of a
    multi-process runtime performs this exact bulk verify in the same
    order (a coordinated catch-up / audit sweep, ADR-027): the call runs
    inside a sharding.lockstep() window so the batch may enter the
    global plane's collective, and the scheduler is skipped (its
    coalescing with process-local traffic would break cross-process
    shape agreement)."""
    from contextlib import ExitStack
    with ExitStack() as stack:
        if coordinated:
            from tendermint_tpu_torch.parallel import sharding
            if sharding.global_mesh_ready():
                stack.enter_context(sharding.lockstep())
            else:
                coordinated = False
        return _verify_sigs_bulk(pubs, msgs, sigs, tpu_threshold, device,
                                 coordinated)


def _verify_sigs_bulk(pubs, msgs, sigs, tpu_threshold: int, device,
                      coordinated: bool) -> np.ndarray:
    n = len(pubs)
    if n and not coordinated and not isinstance(pubs, np.ndarray):
        from tendermint_tpu_torch.crypto import scheduler as vsched
        sch = vsched.running_on(resolve_device(device))
        if sch is not None and n <= sch.max_batch:
            try:
                items = [(pubs[i], msgs[i], sigs[i]) for i in range(n)]
                prio, deadline = vsched.context_priority(
                    vsched.Priority.COMMIT)
                return sch.submit(items, prio, deadline=deadline,
                                  populate_cache=False).result(
                                      timeout=sch.sync_timeout())
            except (vsched.SchedulerError, TimeoutError):
                pass  # fall through to the direct path below
    rt = degrade.runtime()
    if isinstance(pubs, np.ndarray):
        # (n, 32) raw ed25519 pubkey matrix — the validator-set fast
        # path (types/validator_set._pub_matrix): no per-key objects
        if n >= tpu_threshold and _use_device(device):
            dev = _load_kernels(device, n)
            return rt.run(
                "bulk.ed25519",
                partial(verify_ed25519_batch, pubs, msgs, sigs,
                        cache_pubs=True, device=dev),
                host_fn=partial(_host_bulk_ed25519, pubs, msgs, sigs),
                spot_check=_spot_check_bulk(pubs, msgs, sigs),
                on_card=dev.type == "cuda")
        pubs = [ed.PubKey(bytes(p)) for p in pubs]
    if (n >= tpu_threshold and all(p.type_name == ed.KEY_TYPE for p in pubs)
            and _use_device(device)):
        dev = _load_kernels(device, n)
        return rt.run(
            "bulk.ed25519",
            partial(verify_ed25519_batch, [p.bytes() for p in pubs],
                    msgs, sigs, cache_pubs=True, device=dev),
            host_fn=partial(_host_bulk_ed25519, pubs, msgs, sigs),
            spot_check=_spot_check_bulk(pubs, msgs, sigs),
            on_card=dev.type == "cuda")
    bv = BatchVerifier(tpu_threshold=tpu_threshold, device=device)
    for i in range(n):
        bv.add(pubs[i], msgs[i], sigs[i])
    _, bits = bv.verify()
    return bits


def _as_ed_pub(p) -> PubKey:
    return p if isinstance(p, PubKey) else ed.PubKey(bytes(p))


def _host_bulk_ed25519(pubs, msgs, sigs) -> np.ndarray:
    """Host re-verification of a whole-commit batch — the degradation
    target when the device lane times out, raises, or the breaker is
    open.  Same per-triple semantics as the device path: malformed
    inputs are simply invalid, never exceptions."""
    n = len(pubs)
    bits = np.zeros(n, dtype=bool)
    for i in range(n):
        try:
            bits[i] = _as_ed_pub(pubs[i]).verify_signature(
                bytes(msgs[i]), bytes(sigs[i]))
        except Exception:  # noqa: BLE001 - malformed input = invalid
            bits[i] = False
    return bits


def _spot_check_bulk(pubs, msgs, sigs):
    return _SpotCheck(
        len(pubs),
        lambda j: (_as_ed_pub(pubs[j]), bytes(msgs[j]), bytes(sigs[j])))


def verify_ed25519_batch(pubkeys: Sequence[bytes], msgs: Sequence[bytes],
                         sigs: Sequence[bytes], cache_pubs: bool = False,
                         device=None) -> np.ndarray:
    """Raw-bytes ed25519 batch verify on the device (malformed lengths are
    rejected host-side without poisoning the batch)."""
    n = len(pubkeys)
    if isinstance(pubkeys, np.ndarray):   # (n, 32): shape-guaranteed
        ok_len = np.fromiter((len(sigs[i]) == 64 for i in range(n)),
                             dtype=bool, count=n)
    else:
        ok_len = np.array([
            len(pubkeys[i]) == 32 and len(sigs[i]) == 64 for i in range(n)],
            dtype=bool)
    if not ok_len.all():
        good = np.flatnonzero(ok_len)
        if good.size == 0:
            return ok_len
        sub = verify_ed25519_batch([pubkeys[i] for i in good],
                                   [msgs[i] for i in good],
                                   [sigs[i] for i in good],
                                   cache_pubs=cache_pubs, device=device)
        out = np.zeros(n, dtype=bool)
        out[good] = sub
        return out
    return ed_ops_verify(pubkeys, msgs, sigs, cache_pubs=cache_pubs,
                         device=device)


def ed_ops_verify(pubkeys, msgs, sigs, cache_pubs: bool = False,
                  device=None) -> np.ndarray:
    from tendermint_tpu_torch.ops import ed25519 as edops
    return edops.verify_batch(pubkeys, msgs, sigs, cache_pubs=cache_pubs,
                              device=device)
