"""IngressGate: overload-safe mempool admission (ADR-018).

The reference admits transactions synchronously: every RPC handler
thread, every p2p gossip receive, and the committing consensus thread
call CheckTx in-line (mempool/v0/clist_mempool.go:201), and the
reproduction additionally ran the app round trip while holding the one
mempool lock — under a tx flood the whole node serialized on a
blocking app call.  The gate turns admission into a bounded, batched
pipeline with explicit overload policy:

  * ``submit(tx, source)`` never blocks: txs enter a bounded queue
    with per-source accounting ("rpc", "p2p:<peer-id>", "internal").
    Queue full ⇒ an immediate ``mempool is busy`` rejection carrying a
    Retry-After hint (RPC surfaces it as a 429-style error; the
    mempool reactor throttles its channel).  A per-source token bucket
    keeps one flooding peer from monopolizing the queue.
  * Worker(s) drain the queue in batches: dedup + TxCache probe first
    (``Mempool.precheck``), then batched signature pre-verification
    through the VerifyScheduler at ``Priority.MEMPOOL`` — the shed
    class: when consensus traffic owns the verify path, mempool
    pre-verifies are shed and the txs bounce with a retryable ``busy``
    instead of queueing behind CONSENSUS work — then the app CheckTx
    with NO mempool lock held and limits re-validated on insert
    (``Mempool.app_check`` / ``finish_check``: the same staged methods
    the synchronous path composes, so results are identical by
    construction).
  * Post-block recheck moves off the consensus commit path: ``update``
    schedules it here and the worker walks bounded slices per wakeup,
    so ``update()`` returns in O(committed txs).

Degrade ladder (chaos sites registered in libs/fail.py):

  ingress.admit    raise ⇒ submit falls back to synchronous in-caller
                   admission (``Mempool.check_tx``), identical results
  ingress.checktx  raise ⇒ the worker degrades the batch to per-tx
                   synchronous admission, identical results
  ingress.recheck  raise ⇒ the recheck runs synchronously inside
                   ``update()``, exactly the pre-gate behavior

Gate disabled (``[mempool] ingress_enable = false`` / TM_TPU_INGRESS=0,
config wins over env both ways) ⇒ the node never constructs a gate and
every path is byte-identical to today's.

The port's departures from the JAX package's gate:

  * IngressGate takes `device` (None: the package default, "cuda"),
    resolved when the gate is made, so with no CUDA and no device="cpu"
    the constructor raises RuntimeError.  The pre-verify submits only to
    a VerifyScheduler running on that device (scheduler.running_on); with
    none there it is skipped and the app sees every tx, which is the
    JAX package's policy for an absent scheduler, not a device fallback.
  * a pre-verify launch that failed on the card (degrade.card_fault: a
    DeviceLaneError outside a chaos drill) is not a bad signature: the
    future of every SIGTX tx of that launch raises the error
    (IngressFuture.result), its TxCache claim is released so the same tx
    is admitted once the card is back, no ``sig`` rejection and no
    failed tx is counted; the batch's txs that carry no envelope go on
    to the app; the worker keeps running.  The gate keeps the error on
    ``device_error`` (logged) and counts the txs it failed in
    ``stats()["device_error"]``.  ``check_tx`` lets the DeviceLaneError
    out (it is not ``busy``), and the mempool reactor, which never waits
    on a future, stops no peer for it.  In a chaos drill the runtime
    re-verifies on the host and the gate sees a bitmap, as in the JAX
    package.
  * a tx bounced because the scheduler shed its pre-verify keeps its
    Retry-After hint: the JAX package sets the hint and then settles the
    future, which clears it (``IngressFuture._set``), so its verify-shed
    busy responses carry none.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto.degrade import DeviceLaneError, card_fault
from tendermint_tpu_torch.libs import fail, slo, trace
from tendermint_tpu_torch.libs.service import BaseService

SOURCE_RPC = "rpc"
SOURCE_INTERNAL = "internal"

# deterministic, tx-independent envelope for signature-carrying txs:
# magic + ed25519 pub (32) + sig over (magic|pub|payload) (64) + payload.
# Apps are free to use any tx format — the gate pre-verifies only txs
# that parse as this envelope and passes everything else straight to
# CheckTx, so arbitrary-app behavior is unchanged.
SIGTX_MAGIC = b"SGTX1\x00"
_SIGTX_HDR = len(SIGTX_MAGIC) + 32 + 64


def make_signed_tx(priv, payload: bytes) -> bytes:
    """Build a SIGTX envelope with an in-repo ed25519 PrivKey."""
    pub = priv.pub_key().bytes()
    sig = priv.sign(SIGTX_MAGIC + pub + payload)
    return SIGTX_MAGIC + pub + sig + payload


def parse_signed_tx(tx: bytes) -> Optional[Tuple[bytes, bytes, bytes]]:
    """(pub, msg, sig) of a SIGTX envelope, or None for any other
    format (never raises — the gate must not die on hostile bytes)."""
    if len(tx) < _SIGTX_HDR or not tx.startswith(SIGTX_MAGIC):
        return None
    pub = tx[len(SIGTX_MAGIC):len(SIGTX_MAGIC) + 32]
    sig = tx[len(SIGTX_MAGIC) + 32:_SIGTX_HDR]
    return pub, SIGTX_MAGIC + pub + tx[_SIGTX_HDR:], sig


# ---------------------------------------------------------------------------
# config-wins-both-ways enable switch (the node calls set_enabled from
# [mempool] ingress_enable; TM_TPU_INGRESS drives node-less tooling)
# ---------------------------------------------------------------------------

_cfg_enabled: Optional[bool] = None


def set_enabled(v: Optional[bool]):
    """Config override: True/False wins over the env; None re-defers."""
    global _cfg_enabled
    _cfg_enabled = v


def enabled() -> bool:
    if _cfg_enabled is not None:
        return _cfg_enabled
    return os.environ.get("TM_TPU_INGRESS", "1") != "0"


# bound on distinct rate-limiter buckets (sources are partly
# remote-controlled: p2p peer ids); past it, idle buckets are evicted
_MAX_BUCKETS = 4096


class _TokenBucket:
    """Per-source admission rate limiter.  Mutated under the gate's
    _rl_lock only."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = now

    def allow(self, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class IngressFuture:
    """Resolves to the tx's ResponseCheckTx.  ``retry_after_s`` is set
    on overload rejections (busy/ratelimit) — the hint RPC surfaces as
    a 429-style error and the reactor turns into channel throttling.
    A tx whose pre-verify failed on the card settles with the
    DeviceLaneError instead, which ``result()`` raises."""

    __slots__ = ("_ev", "_res", "_exc", "retry_after_s", "latency_s")

    def __init__(self):
        self._ev = threading.Event()
        self._res: Optional[abci.ResponseCheckTx] = None
        self._exc: Optional[BaseException] = None
        self.retry_after_s: Optional[float] = None
        self.latency_s: Optional[float] = None

    def _set_exception(self, exc: BaseException):
        if not self._ev.is_set():
            self._exc = exc
            self._ev.set()

    def _set(self, res: abci.ResponseCheckTx,
             retry_after_s: Optional[float] = None):
        if not self._ev.is_set():
            self._res = res
            self.retry_after_s = retry_after_s
            self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) \
            -> abci.ResponseCheckTx:
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"ingress admission not settled within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._res


class _Pending:
    __slots__ = ("tx", "source", "enq_t", "future")

    def __init__(self, tx: bytes, source: str):
        self.tx = tx
        self.source = source
        self.enq_t = time.monotonic()
        self.future = IngressFuture()


def _busy_response(log: str = "mempool is busy") -> abci.ResponseCheckTx:
    return abci.ResponseCheckTx(code=1, codespace="ingress", log=log)


class IngressGate(BaseService):
    """See the module docstring.  One gate per node, fronting that
    node's mempool (v0 or v1 — both expose the staged admission API);
    its pre-verify runs on `device`."""

    def __init__(self, mempool, queue_size: int = 8192,
                 batch: int = 256, workers: int = 1,
                 rate_per_s: float = 0.0, burst: int = 0,
                 recheck_slice: int = 256,
                 preverify_deadline_s: float = 0.05,
                 sig_extractor: Optional[Callable] = parse_signed_tx,
                 name: str = "mempool-ingress", device=None):
        # resolved here: with no CUDA and no device="cpu" the gate is not
        # made
        self.device = resolve_device(device)
        super().__init__(name=name)
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("mempool")
        self.mempool = mempool
        self.metrics = mempool.metrics
        self.queue_size = max(1, int(queue_size))
        self.batch = max(1, int(batch))
        self.workers = max(1, int(workers))
        self.rate_per_s = max(0.0, float(rate_per_s))
        self.burst = float(burst) if burst > 0 else max(1.0, self.rate_per_s)
        self.recheck_slice = max(1, int(recheck_slice))
        self.preverify_deadline_s = preverify_deadline_s
        self.sig_extractor = sig_extractor
        # _cond guards _queue and _recheck_pending ONLY (bookkeeping;
        # rank 17 in devtools/lockorder.py) — the mempool, scheduler,
        # metrics and app are all called with it released
        self._cond = threading.Condition()
        self._queue: "deque[_Pending]" = deque()
        self._recheck_pending: "deque[bytes]" = deque()
        self._rl_lock = threading.Lock()
        self._buckets: Dict[str, _TokenBucket] = {}
        self._stats_lock = threading.Lock()
        self._stats = {"submitted": 0, "admitted": 0, "rejected": 0,
                       "busy": 0, "ratelimited": 0, "preverify_shed": 0,
                       "sig_rejected": 0, "fallback_batches": 0,
                       "rechecked": 0, "device_error": 0}
        # the last pre-verify launch that failed on the card
        self.device_error: Optional[DeviceLaneError] = None

    # -- live reconfiguration (ADR-023) ------------------------------------

    def set_rate(self, rate_per_s: Optional[float] = None,
                 burst: Optional[float] = None):
        """Thread-safe live admission-rate change (the adaptive control
        plane's seam, ADR-023).  Buckets snapshot rate/burst at
        construction, so every LIVE per-source bucket is re-clamped
        here too — a rate cut takes effect immediately for sources
        already being limited, not only for new ones.  None leaves a
        dimension untouched; rate 0 disables limiting (the static
        "unlimited" default)."""
        with self._rl_lock:
            if rate_per_s is not None:
                self.rate_per_s = max(0.0, float(rate_per_s))
            if burst is not None:
                self.burst = (float(burst) if burst > 0
                              else max(1.0, self.rate_per_s))
            for b in self._buckets.values():
                b.rate = self.rate_per_s
                b.burst = self.burst
                # never GRANT tokens on a clamp-down: a flooding
                # source's saved-up allowance must shrink with the
                # burst, not persist past it
                b.tokens = min(b.tokens, self.burst)

    # -- lifecycle ---------------------------------------------------------

    def attach(self):
        """Install the recheck offload hook on the fronted mempool."""
        self.mempool.recheck_offload = self._schedule_recheck
        return self

    def detach(self):
        if getattr(self.mempool, "recheck_offload", None) is \
                self._schedule_recheck:
            self.mempool.recheck_offload = None

    def on_start(self):
        for i in range(self.workers):
            self.spawn(self._worker, name=f"ingress-worker-{i}")

    def on_stop(self):
        self.detach()
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            self._recheck_pending.clear()
            self._cond.notify_all()
        # settle stranded submissions so no caller waits forever; a
        # stopping node is busy by definition
        for it in pending:
            it.future._set(_busy_response("mempool ingress stopping"),
                           retry_after_s=1.0)
        self._publish_depth()

    # -- submission --------------------------------------------------------

    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def saturated(self) -> bool:
        """Queue at (or past) capacity — reactors stop reading their
        mempool channel while this holds."""
        with self._cond:
            return len(self._queue) >= self.queue_size

    def retry_after_s(self) -> float:
        """Crude Retry-After hint: a full queue drained in batches of
        `batch` needs roughly depth/batch wakeups; clamp to [0.1, 5]."""
        return min(5.0, max(0.1, self.depth() / (self.batch * 20.0)))

    def _publish_depth(self):
        try:
            self.metrics.ingress_queue_depth.set(self.depth())
        except Exception:  # noqa: BLE001 - observability must not break
            pass

    def submit(self, tx: bytes, source: str = SOURCE_RPC) -> IngressFuture:
        """Queue a tx for admission; never blocks.  Overload rejections
        (queue full / rate limited) settle the future immediately with
        a retryable busy response + Retry-After hint."""
        tx = bytes(tx)
        with self._stats_lock:
            self._stats["submitted"] += 1
        try:
            fail.inject("ingress.admit")
        except fail.InjectedFault:
            # chaos: degrade to the synchronous in-caller path — the
            # exact admission the node ran before the gate existed
            fut = IngressFuture()
            fut._set(self.mempool.check_tx(tx))
            return fut
        if not self.is_running():
            fut = IngressFuture()
            fut._set(self.mempool.check_tx(tx))
            return fut
        if self.rate_per_s > 0:
            now = time.monotonic()
            with self._rl_lock:
                b = self._buckets.get(source)
                if b is None:
                    if len(self._buckets) >= _MAX_BUCKETS:
                        # peer ids are remote-controlled input: drop
                        # idle (fully-refilled, stale) buckets instead
                        # of growing forever under identity churn
                        idle = [k for k, v in self._buckets.items()
                                if v.tokens >= v.burst
                                or now - v.last > 300.0]
                        for k in idle:
                            del self._buckets[k]
                        if len(self._buckets) >= _MAX_BUCKETS:
                            self._buckets.clear()  # churn flood: reset
                    b = self._buckets[source] = _TokenBucket(
                        self.rate_per_s, self.burst, now)
                allowed = b.allow(now)
            if not allowed:
                with self._stats_lock:
                    self._stats["ratelimited"] += 1
                    self._stats["rejected"] += 1
                self.metrics.rejected_txs.inc(reason="ratelimit")
                fut = IngressFuture()
                fut._set(_busy_response(
                    f"rate limited ({source}): mempool is busy"),
                    retry_after_s=1.0 / self.rate_per_s)
                return fut
        it = _Pending(tx, source)
        stopped = False
        with self._cond:
            # re-check under _cond: stop() may have drained the queue
            # between the is_running() check above and this append —
            # an item enqueued now would strand its future forever
            if not self.is_running():
                stopped = True
                overflow = False
            elif len(self._queue) >= self.queue_size:
                overflow = True
            else:
                overflow = False
                self._queue.append(it)
                self._cond.notify()
        if stopped:
            it.future._set(self.mempool.check_tx(tx))
            return it.future
        if overflow:
            with self._stats_lock:
                self._stats["busy"] += 1
                self._stats["rejected"] += 1
            self.metrics.rejected_txs.inc(reason="busy")
            it.future._set(_busy_response(),
                           retry_after_s=self.retry_after_s())
            return it.future
        self._publish_depth()
        trace.instant("ingress.admit", source=source, n=1)
        return it.future

    def check_tx(self, tx: bytes, source: str = SOURCE_RPC,
                 timeout: float = 10.0) -> abci.ResponseCheckTx:
        """Synchronous helper: submit + wait.  A timeout (the queue is
        moving but not fast enough for this caller) maps to the same
        retryable busy response as a full queue.  A pre-verify that
        failed on the card raises its DeviceLaneError here."""
        fut = self.submit(tx, source)
        try:
            return fut.result(timeout=timeout)
        except TimeoutError:
            fut.retry_after_s = self.retry_after_s()
            return _busy_response("mempool is busy (admission timed out)")

    # -- worker ------------------------------------------------------------

    def _worker(self):
        while not self.quitting.is_set():
            with self._cond:
                while (not self._queue and not self._recheck_pending
                        and not self.quitting.is_set()):
                    self._cond.wait(0.1)
                if self.quitting.is_set():
                    return
                items = []
                while self._queue and len(items) < self.batch:
                    items.append(self._queue.popleft())
                recheck = []
                while self._recheck_pending and \
                        len(recheck) < self.recheck_slice:
                    recheck.append(self._recheck_pending.popleft())
            if items:
                self._publish_depth()
                self._process_batch(items)
            if recheck:
                self._process_recheck(recheck)

    def _settle(self, it: _Pending, res: abci.ResponseCheckTx,
                admitted: bool, retry_after_s: Optional[float] = None):
        dt = time.monotonic() - it.enq_t
        it.future.latency_s = dt
        try:
            self.metrics.admission_latency.observe(dt)
        except Exception:  # noqa: BLE001
            pass
        slo.observe("mempool", dt)
        with self._stats_lock:
            self._stats["admitted" if admitted else "rejected"] += 1
        it.future._set(res, retry_after_s=retry_after_s)

    def _process_batch(self, items: List[_Pending]):
        with trace.span("ingress.batch", n=len(items)):
            try:
                fail.inject("ingress.checktx")
            except fail.InjectedFault:
                # chaos: the batched stage is broken — degrade every tx
                # to the synchronous per-tx composition (identical
                # ResponseCheckTx by construction)
                with self._stats_lock:
                    self._stats["fallback_batches"] += 1
                for it in items:
                    res = self.mempool.check_tx(it.tx)
                    self._settle(it, res, admitted=res.is_ok())
                return
            mp = self.mempool
            # stage 1: static prechecks (size cap, dedup cache probe,
            # full pre-check).  Duplicates WITHIN the batch fall out
            # here too: the first claims the cache, the rest see it.
            survivors: List[_Pending] = []
            for it in items:
                rej = mp.precheck(it.tx)
                if rej is not None:
                    self._settle(it, rej, admitted=False)
                else:
                    survivors.append(it)
            # stage 2: batched signature pre-verification through the
            # VerifyScheduler's shed class
            survivors = self._preverify(survivors)
            # stage 3: app CheckTx with no mempool lock held, insert
            # re-validated under it — the same staged methods the
            # synchronous path composes
            with trace.span("ingress.checktx", n=len(survivors)):
                for it in survivors:
                    res = mp.finish_check(it.tx, mp.app_check(it.tx))
                    self._settle(it, res, admitted=res.is_ok())

    def _preverify(self, items: List[_Pending]) -> List[_Pending]:
        """Batched MEMPOOL-class signature pre-verification.  Returns
        the txs that may proceed to the app.  Policy under pressure:

          * scheduler shed ⇒ the flood is outrunning the verify path —
            bounce these txs with a retryable ``busy`` (cache claim
            released) instead of letting unverified work queue behind
            CONSENSUS-class traffic;
          * scheduler absent (none running on the gate's device) /
            error / timeout ⇒ skip pre-verification (the app still sees
            every tx — exactly the synchronous path's behavior);
          * launch failed on the card ⇒ the envelope txs' futures raise
            the DeviceLaneError (_fail_on_card);
          * refuted signature ⇒ reject without burning an app call.
        """
        if self.sig_extractor is None or not items:
            return items
        triples, idx = [], []
        for i, it in enumerate(items):
            try:
                t = self.sig_extractor(it.tx)
            except Exception:  # noqa: BLE001 - hostile bytes skip
                t = None
            if t is not None:
                triples.append(t)
                idx.append(i)
        if not triples:
            return items
        from tendermint_tpu_torch.crypto import scheduler as vsched
        s = vsched.running_on(self.device)
        if s is None:
            return items
        try:
            fut = s.submit(triples, vsched.Priority.MEMPOOL,
                           deadline=time.monotonic()
                           + self.preverify_deadline_s)
            bits = fut.result(timeout=max(1.0,
                                          self.preverify_deadline_s * 40))
        except vsched.SchedulerShedError:
            with self._stats_lock:
                self._stats["preverify_shed"] += len(idx)
            shed = set(idx)
            out = []
            for i, it in enumerate(items):
                if i in shed:
                    self.mempool.cache.remove(it.tx)
                    self.metrics.rejected_txs.inc(reason="busy")
                    with self._stats_lock:
                        self._stats["busy"] += 1
                    res = _busy_response("mempool is busy (verify shed)")
                    self._settle(it, res, admitted=False,
                                 retry_after_s=self.retry_after_s())
                else:
                    out.append(it)
            return out
        except (vsched.SchedulerError, TimeoutError):
            return items
        except DeviceLaneError as e:
            if not card_fault(e):
                raise
            return self._fail_on_card(items, idx, e)
        bad = {idx[k] for k in range(len(idx)) if not bits[k]}
        if not bad:
            return items
        out = []
        for i, it in enumerate(items):
            if i in bad:
                with self._stats_lock:
                    self._stats["sig_rejected"] += 1
                if not self.mempool.keep_invalid_txs_in_cache:
                    self.mempool.cache.remove(it.tx)
                self.metrics.rejected_txs.inc(reason="sig")
                self.metrics.failed_txs.inc()
                self._settle(it, abci.ResponseCheckTx(
                    code=1, codespace="ingress",
                    log="invalid signature"), admitted=False)
            else:
                out.append(it)
        return out

    def _fail_on_card(self, items: List[_Pending], idx: List[int],
                      e: DeviceLaneError) -> List[_Pending]:
        """The pre-verify launch failed on the card: the envelope txs
        settle with the error and release their cache claims (nothing is
        counted against them); the others go on to the app."""
        self.device_error = e
        self.log.error("mempool pre-verify failed on the card",
                       txs=len(idx), err=str(e))
        with self._stats_lock:
            self._stats["device_error"] += len(idx)
        failed = set(idx)
        out = []
        for i, it in enumerate(items):
            if i in failed:
                self.mempool.cache.remove(it.tx)
                it.future.latency_s = time.monotonic() - it.enq_t
                it.future._set_exception(e)
            else:
                out.append(it)
        return out

    # -- post-block recheck offload ----------------------------------------

    def _schedule_recheck(self, height: int) -> bool:
        """The mempool's recheck_offload hook — called from update()
        on the consensus commit path (the caller holds the mempool
        lock; this only snapshots keys and signals the worker).  A
        False/raise falls back to the synchronous in-caller recheck."""
        fail.inject("ingress.recheck")
        if not self.is_running():
            return False
        keys = self.mempool.recheck_keys()
        with self._cond:
            # a fresh commit supersedes any half-done older recheck:
            # the new snapshot covers every still-resident tx
            self._recheck_pending.clear()
            self._recheck_pending.extend(keys)
            if keys:
                self._cond.notify()
        return True

    def _process_recheck(self, keys: List[bytes]):
        with trace.span("ingress.recheck", n=len(keys)):
            for key in keys:
                if self.quitting.is_set():
                    return
                self.mempool.recheck_one(key)
            with self._stats_lock:
                self._stats["rechecked"] += len(keys)

    def recheck_idle(self) -> bool:
        """True when no offloaded recheck work is pending (tests)."""
        with self._cond:
            return not self._recheck_pending

    def stats(self) -> dict:
        with self._stats_lock:
            return dict(self._stats)
