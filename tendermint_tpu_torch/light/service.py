"""LightServe: light-client-as-a-service (ADR-026).

One process-global serving plane fronts many concurrent light clients
driving ``verify_adjacent`` / ``verify_non_adjacent`` /
``verify_commit_light_trusting`` against large validator sets.  The
design composes four proven pieces:

  * Front door = the IngressGate pattern (ADR-018): ``submit`` never
    blocks — requests enter a bounded queue with per-client token
    buckets; queue full or rate limited means an immediate busy
    verdict carrying a Retry-After hint (RPC surfaces it 429-style).
  * Verify plane = cross-client coalescing: every request decomposes
    into cheap per-request header/time checks (each client keeps its
    own ``now``) plus one or two CERTIFICATE verifications keyed by
    (chain_id, validator-set hash, height, block id, trust level).
    Concurrent requests sharing a key run ONE shared verification;
    distinct certificates in a drained batch run concurrently
    (lanepool lanes) at COMMIT priority, so certificates that reach
    the VerifyScheduler share its launches (on the card: C2 for a
    prewarmed set, else K1/K2).
  * Warm path = comb-table prewarm on validator-set change: the
    service subscribes to ValidatorSetUpdates and calls
    ``ops.ed25519.prewarm_async`` so the first post-change request
    pays gathers, not a table build.
  * Follow path = bounded per-client cursors over the block store
    (``subscribe``/``poll``): clients follow the chain instead of
    polling full blocks; under pressure the least-recently-polled
    cursor is evicted so live followers survive.

Degrade ladder (chaos sites registered in libs/fail.py):

  light.serve     raise ⇒ submit falls back to synchronous in-caller
                  verification (the exact direct path), identical
                  verdicts
  light.coalesce  raise ⇒ the worker degrades the batch to per-request
                  direct certificate verification (no dedupe),
                  identical verdicts

Service disabled (``[light_serve] enable = false`` /
TM_TPU_LIGHT_SERVE=0, config wins over env both ways) ⇒ the node never
constructs the service and the light RPC routes answer
service-disabled; the full node's own verify paths are untouched.

The port's departures from the JAX package's service:

  * LightServe takes `device` (None: the package default, "cuda";
    resolved when the service is made, so with no CUDA and no
    device="cpu" the constructor raises RuntimeError): every
    certificate verifies on it (ValidatorSet.verify_commit_light*, which
    reach a VerifyScheduler only when it runs on that device) and the
    prewarm builds its tables there (ops.ed25519.prewarm_async);
  * a launch that failed on the card (degrade.card_fault) is not a
    refused request: the future of every request that needed the
    certificate raises the DeviceLaneError (LightFuture.result), no
    verdict is settled and light_requests_total does not count it; the
    direct path raises it the same way.  In a chaos drill the JAX
    package's behaviour holds.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto import scheduler as vsched
from tendermint_tpu_torch.crypto.degrade import DeviceLaneError, card_fault
from tendermint_tpu_torch.libs import fail, slo, trace
from tendermint_tpu_torch.libs.metrics import LightMetrics
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.types.light_block import LightBlock, SignedHeader

from . import verifier

# ---------------------------------------------------------------------------
# config-wins-both-ways enable switch (the node calls set_enabled from
# [light_serve] enable; TM_TPU_LIGHT_SERVE drives node-less tooling)
# ---------------------------------------------------------------------------

_cfg_enabled: Optional[bool] = None


def set_enabled(v: Optional[bool]):
    """Config override: True/False wins over the env; None re-defers."""
    global _cfg_enabled
    _cfg_enabled = v


def enabled() -> bool:
    if _cfg_enabled is not None:
        return _cfg_enabled
    return os.environ.get("TM_TPU_LIGHT_SERVE", "1") != "0"


# the process-global service, for the debug surface (GET /debug/light)
_installed: Optional["LightServe"] = None


def install(s: Optional["LightServe"]):
    global _installed
    _installed = s


def installed() -> Optional["LightServe"]:
    return _installed


def report() -> dict:
    """Module-level debug report (GET /debug/light, debug-light CLI)."""
    s = _installed
    if s is None:
        return {"enabled": enabled(), "running": False}
    return s.report()


# bound on distinct rate-limiter buckets (client ids are
# caller-controlled input); past it, idle buckets are evicted
_MAX_BUCKETS = 65536


class _TokenBucket:
    """Per-client admission rate limiter.  Mutated under _rl_lock only."""

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


class LightVerdict:
    """The settled answer for one verify request.  ``ok`` is the
    verification verdict; ``error`` carries the refusal class or the
    verifier's message.  ``retry_after_s`` is set on overload
    refusals (busy/ratelimit) — 429 semantics."""

    __slots__ = ("ok", "error", "retry_after_s")

    def __init__(self, ok: bool, error: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        self.ok = ok
        self.error = error
        self.retry_after_s = retry_after_s


class LightFuture:
    """Resolves to the request's LightVerdict, or raises the card fault
    that kept its certificate from a verdict; never blocks submit."""

    __slots__ = ("_ev", "_res", "_exc", "latency_s")

    def __init__(self):
        self._ev = threading.Event()
        self._res: Optional[LightVerdict] = None
        self._exc: Optional[BaseException] = None
        self.latency_s: Optional[float] = None

    def _set(self, res: LightVerdict):
        if not self._ev.is_set():
            self._res = res
            self._ev.set()

    def _fail(self, exc: BaseException):
        if not self._ev.is_set():
            self._exc = exc
            self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> LightVerdict:
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"light verification not settled within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._res


class LightRequest:
    """One client verification request.  ``kind`` selects the verifier
    composition; every kind's per-request header/time checks use the
    CLIENT's ``now`` while the certificate checks coalesce."""

    __slots__ = ("kind", "chain_id", "trusted", "trusted_vals",
                 "untrusted", "untrusted_vals", "now", "trust_level",
                 "trusting_period_s", "max_clock_drift_s")

    def __init__(self, kind: str, chain_id: str,
                 trusted: Optional[SignedHeader] = None,
                 trusted_vals=None,
                 untrusted: Optional[SignedHeader] = None,
                 untrusted_vals=None, now=None,
                 trust_level: Fraction = verifier.DEFAULT_TRUST_LEVEL,
                 trusting_period_s: float = 14 * 24 * 3600.0,
                 max_clock_drift_s: float = 10.0):
        if kind not in ("adjacent", "non_adjacent", "trusting"):
            raise ValueError(f"unknown light request kind {kind!r}")
        self.kind = kind
        self.chain_id = chain_id
        self.trusted = trusted
        self.trusted_vals = trusted_vals
        self.untrusted = untrusted
        self.untrusted_vals = untrusted_vals
        self.now = now
        self.trust_level = trust_level
        self.trusting_period_s = trusting_period_s
        self.max_clock_drift_s = max_clock_drift_s


class _Pending:
    __slots__ = ("req", "client", "enq_t", "future")

    def __init__(self, req: LightRequest, client: str):
        self.req = req
        self.client = client
        self.enq_t = time.monotonic()
        self.future = LightFuture()


class _CertGroup:
    """One in-flight shared certificate verification (cross-worker
    dedupe).  ``err`` is None on success, the verifier's exception
    otherwise."""

    __slots__ = ("ev", "err")

    def __init__(self):
        self.ev = threading.Event()
        self.err: Optional[BaseException] = None


class _Cursor:
    __slots__ = ("client", "next_height", "stamp")

    def __init__(self, client: str, next_height: int, stamp: int):
        self.client = client
        self.next_height = next_height
        self.stamp = stamp


def _busy_verdict(log: str, retry_after_s: float) -> LightVerdict:
    return LightVerdict(False, log, retry_after_s=retry_after_s)


class LightServe(BaseService):
    """See the module docstring.  One service per node, over that
    node's block/state stores."""

    def __init__(self, block_store, state_store, chain_id: str,
                 queue_size: int = 4096, batch: int = 256,
                 workers: int = 1, rate_per_s: float = 0.0,
                 burst: int = 0, max_cursors_per_client: int = 4,
                 max_cursors: int = 1024, cursor_batch: int = 64,
                 prewarm: bool = True, event_bus=None,
                 name: str = "light-serve", device=None):
        super().__init__(name=name)
        # resolved here, as VerifyScheduler does: with no CUDA and no
        # device="cpu" the service is not made
        self.device = resolve_device(device)
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("light")
        self.block_store = block_store
        self.state_store = state_store
        self.chain_id = chain_id
        self.queue_size = max(1, int(queue_size))
        self.batch = max(1, int(batch))
        self.workers = max(1, int(workers))
        self.rate_per_s = max(0.0, float(rate_per_s))
        self.burst = float(burst) if burst > 0 else max(1.0, self.rate_per_s)
        self.max_cursors_per_client = max(1, int(max_cursors_per_client))
        self.max_cursors = max(1, int(max_cursors))
        self.cursor_batch = max(1, int(cursor_batch))
        self.prewarm_enabled = bool(prewarm)
        self.event_bus = event_bus
        self.metrics = LightMetrics()
        # _cond guards _queue and _inflight ONLY (bookkeeping; rank 21
        # in devtools/lockorder.py) — the verifier, scheduler, stores
        # and metrics are all called with it released
        self._cond = threading.Condition()
        self._queue: "deque[_Pending]" = deque()
        self._inflight: Dict[tuple, _CertGroup] = {}
        self._rl_lock = threading.Lock()
        self._buckets: Dict[str, _TokenBucket] = {}
        self._cur_lock = threading.Lock()
        self._cursors: Dict[str, _Cursor] = {}
        self._cursor_seq = 0
        self._stats_lock = threading.Lock()
        self._stats = {"submitted": 0, "verified": 0, "refuted": 0,
                       "busy": 0, "ratelimited": 0, "invalid": 0,
                       "coalesce_lead": 0, "coalesce_hit": 0,
                       "coalesce_direct": 0, "direct_path": 0,
                       "cursors_evicted": 0, "polled": 0,
                       "prewarms": 0}
        self._lat: Dict[str, deque] = {}

    # -- live reconfiguration ----------------------------------------------

    def set_rate(self, rate_per_s: Optional[float] = None,
                 burst: Optional[float] = None):
        """Thread-safe live admission-rate change (same contract as
        IngressGate.set_rate: live buckets re-clamp immediately, a
        clamp-down never grants saved-up tokens)."""
        with self._rl_lock:
            if rate_per_s is not None:
                self.rate_per_s = max(0.0, float(rate_per_s))
            if burst is not None:
                self.burst = (float(burst) if burst > 0
                              else max(1.0, self.rate_per_s))
            for b in self._buckets.values():
                b.rate = self.rate_per_s
                b.burst = self.burst
                b.tokens = min(b.tokens, self.burst)

    # -- lifecycle ---------------------------------------------------------

    def on_start(self):
        for i in range(self.workers):
            self.spawn(self._worker, name=f"light-serve-{i}")
        if self.prewarm_enabled and self.event_bus is not None:
            from tendermint_tpu_torch.types.event_bus import \
                EVENT_VALIDATOR_SET_UPDATES
            self._valset_sub = self.event_bus.subscribe(
                EVENT_VALIDATOR_SET_UPDATES)
            self.spawn(self._valset_watcher, name="light-prewarm")
            # warm the CURRENT set too: the first client must not pay
            # the build just because no valset change happened yet
            self._prewarm_latest()

    def on_stop(self):
        sub = getattr(self, "_valset_sub", None)
        if sub is not None and self.event_bus is not None:
            self.event_bus.unsubscribe(sub)
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        # settle stranded submissions so no caller waits forever; a
        # stopping node is busy by definition
        for it in pending:
            it.future._set(_busy_verdict("light serve stopping", 1.0))
        self._publish_depth()

    # -- warm path ---------------------------------------------------------

    def _valset_watcher(self):
        """Drain the ValidatorSetUpdates subscription; every transition
        prewarms the comb tables for the post-change set off-path."""
        import queue as _q
        sub = self._valset_sub
        while not self.quitting.is_set():
            try:
                sub.queue.get(timeout=0.2)
            except _q.Empty:
                continue
            self._prewarm_latest()

    def _prewarm_latest(self):
        """Prewarm the newest known validator set (the set that signs
        the NEXT heights — load_validators already has it by the time
        the update event fires)."""
        if not self.prewarm_enabled:
            return
        h = self.block_store.height()
        vals = None
        for hh in (h + 1, h):
            if hh < 1:
                continue
            try:
                vals = self.state_store.load_validators(hh)
            except Exception:  # noqa: BLE001 - warm path is best-effort
                vals = None
            if vals is not None:
                break
        if vals is None or vals.is_nil_or_empty():
            return
        from tendermint_tpu_torch.ops import ed25519 as edops
        edops.prewarm_async([v.pub_key.bytes() for v in vals.validators],
                            device=self.device)
        with self._stats_lock:
            self._stats["prewarms"] += 1

    # -- submission (the front door) ---------------------------------------

    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def retry_after_s(self) -> float:
        """Crude Retry-After hint: a full queue drained in batches of
        `batch` needs roughly depth/batch wakeups; clamp to [0.1, 5]."""
        return min(5.0, max(0.1, self.depth() / (self.batch * 20.0)))

    def _publish_depth(self):
        try:
            self.metrics.queue_depth.set(self.depth())
        except Exception:  # noqa: BLE001 - observability must not break
            pass

    def submit(self, req: LightRequest,
               client: str = "anon") -> LightFuture:
        """Queue a verify request; never blocks.  Overload refusals
        (queue full / rate limited) settle the future immediately with
        a busy verdict + Retry-After hint."""
        with self._stats_lock:
            self._stats["submitted"] += 1
        try:
            fail.inject("light.serve")
        except fail.InjectedFault:
            # chaos: degrade to the synchronous in-caller path — the
            # exact verification the caller would run without the
            # service, identical verdicts
            with self._stats_lock:
                self._stats["direct_path"] += 1
            return self._direct_future(req)
        if not self.is_running():
            with self._stats_lock:
                self._stats["direct_path"] += 1
            return self._direct_future(req)
        if self.rate_per_s > 0:
            now = time.monotonic()
            with self._rl_lock:
                b = self._buckets.get(client)
                if b is None:
                    if len(self._buckets) >= _MAX_BUCKETS:
                        # client ids are caller-controlled input: drop
                        # idle (fully-refilled, stale) buckets instead
                        # of growing forever under identity churn
                        idle = [k for k, v in self._buckets.items()
                                if v.tokens >= v.burst
                                or now - v.last > 300.0]
                        for k in idle:
                            del self._buckets[k]
                        if len(self._buckets) >= _MAX_BUCKETS:
                            self._buckets.clear()  # churn flood: reset
                    b = self._buckets[client] = _TokenBucket(
                        self.rate_per_s, self.burst, now)
                allowed = b.allow(now)
            if not allowed:
                with self._stats_lock:
                    self._stats["ratelimited"] += 1
                self.metrics.shed.inc(reason="ratelimit")
                fut = LightFuture()
                fut._set(_busy_verdict(
                    f"rate limited ({client}): light serve is busy",
                    1.0 / self.rate_per_s))
                return fut
        it = _Pending(req, client)
        stopped = False
        with self._cond:
            # re-check under _cond: stop() may have drained the queue
            # between the is_running() check above and this append
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
            with self._stats_lock:
                self._stats["direct_path"] += 1
            return self._direct_future(req)
        if overflow:
            with self._stats_lock:
                self._stats["busy"] += 1
            self.metrics.shed.inc(reason="busy")
            it.future._set(_busy_verdict("light serve is busy",
                                         self.retry_after_s()))
            return it.future
        self._publish_depth()
        return it.future

    def verify(self, req: LightRequest, client: str = "anon",
               timeout: float = 30.0) -> LightVerdict:
        """Synchronous helper: submit + wait.  A timeout maps to the
        same retryable busy verdict as a full queue."""
        fut = self.submit(req, client)
        try:
            return fut.result(timeout=timeout)
        except TimeoutError:
            return _busy_verdict("light serve is busy (timed out)",
                                 self.retry_after_s())

    # -- verification plane ------------------------------------------------

    def _header_checks(self, req: LightRequest) -> Optional[str]:
        """The per-request host-side checks (each client's own ``now``):
        heights, expiry, drift, valset-hash linkage.  Returns the
        refusal message, or None when the certificate checks decide."""
        try:
            if req.kind == "trusting":
                if req.trusted_vals is None or req.untrusted is None:
                    return "trusting request needs trusted_vals + header"
                return None
            t, u = req.trusted, req.untrusted
            if t is None or u is None or req.untrusted_vals is None:
                return "request needs trusted + untrusted headers + vals"
            if req.kind == "adjacent":
                if u.height != t.height + 1:
                    return "headers must be adjacent in height"
            elif u.height == t.height + 1:
                return "headers must be non adjacent in height"
            now = req.now
            if now is None:
                from tendermint_tpu_torch.types.basic import Timestamp
                now = Timestamp.now()
            if verifier.header_expired(t, req.trusting_period_s, now):
                return "old header has expired"
            verifier._verify_new_header_and_vals(
                u, req.untrusted_vals, t, now, req.max_clock_drift_s)
            if req.kind == "adjacent" and \
                    u.header.validators_hash != \
                    t.header.next_validators_hash:
                return ("expected old header next validators to match "
                        "those from new header")
            return None
        except verifier.LightError as e:
            return str(e)

    def _cert_tasks(self, req: LightRequest) -> List[Tuple[tuple, object]]:
        """Decompose a request into its certificate verifications:
        (key, thunk) pairs.  The key is the cross-client coalescing
        identity — (class, chain_id, valset hash, height, round,
        block id, trust level)."""
        out = []
        cid = req.chain_id

        def light_cert(vals, sh):
            com = sh.commit
            key = ("light", cid, vals.hash(), com.height, com.round,
                   com.block_id.hash)

            def run():
                with vsched.priority_context(vsched.Priority.COMMIT):
                    vals.verify_commit_light(cid, com.block_id,
                                             com.height, com,
                                             device=self.device)
            return key, run

        def trusting_cert(vals, sh, lvl):
            com = sh.commit
            key = ("trusting", cid, vals.hash(), com.height, com.round,
                   com.block_id.hash, lvl)

            def run():
                with vsched.priority_context(vsched.Priority.COMMIT):
                    vals.verify_commit_light_trusting(cid, com, lvl,
                                                      device=self.device)
            return key, run

        if req.kind == "adjacent":
            out.append(light_cert(req.untrusted_vals, req.untrusted))
        elif req.kind == "non_adjacent":
            out.append(trusting_cert(req.trusted_vals, req.untrusted,
                                     req.trust_level))
            out.append(light_cert(req.untrusted_vals, req.untrusted))
        else:  # trusting: the raw certificate check
            out.append(trusting_cert(req.trusted_vals, req.untrusted,
                                     req.trust_level))
        return out

    def _cert_verify(self, key: tuple, run,
                     waiters: int) -> Optional[BaseException]:
        """ONE shared execution per in-flight certificate key (cross-
        worker dedupe on top of the within-batch grouping).  Returns
        the verifier's exception, or None on success."""
        with self._cond:
            g = self._inflight.get(key)
            if g is None:
                g = _CertGroup()
                self._inflight[key] = g
                lead = True
            else:
                lead = False
        if not lead:
            with self._stats_lock:
                self._stats["coalesce_hit"] += waiters
            self.metrics.coalesce.inc(result="hit")
            g.ev.wait(60.0)
            return g.err
        with self._stats_lock:
            self._stats["coalesce_lead"] += 1
            self._stats["coalesce_hit"] += waiters - 1
        self.metrics.coalesce.inc(result="lead")
        if waiters > 1:
            self.metrics.coalesce.inc(result="hit")
        with trace.span("light.coalesce", cls=key[0], height=key[3],
                        waiters=waiters):
            try:
                run()
            except Exception as e:  # noqa: BLE001 - verdict, not crash
                g.err = e
            finally:
                with self._cond:
                    self._inflight.pop(key, None)
                g.ev.set()
        return g.err

    def _verify_direct(self, req: LightRequest) -> LightVerdict:
        """The degrade path: in-caller verification, no queue and no
        coalesce map — identical verdicts by construction."""
        err = self._header_checks(req)
        if err is not None:
            return LightVerdict(False, err)
        for _key, run in self._cert_tasks(req):
            try:
                run()
            except Exception as e:  # noqa: BLE001 - verdict, not crash
                if card_fault(e):
                    raise   # the card failed: no verdict
                return LightVerdict(False, str(e))
        return LightVerdict(True)

    def _direct_future(self, req: LightRequest) -> LightFuture:
        """A future settled in the caller by the direct path (or failed
        with its card fault)."""
        fut = LightFuture()
        try:
            fut._set(self._verify_direct(req))
        except DeviceLaneError as e:   # raised only for a card fault
            fut._fail(e)
        return fut

    # -- worker ------------------------------------------------------------

    def _worker(self):
        while not self.quitting.is_set():
            with self._cond:
                while not self._queue and not self.quitting.is_set():
                    self._cond.wait(0.1)
                if self.quitting.is_set():
                    return
                items: List[_Pending] = []
                while self._queue and len(items) < self.batch:
                    items.append(self._queue.popleft())
            if items:
                self._publish_depth()
                self._process_batch(items)

    def _settle(self, it: _Pending, res: LightVerdict):
        dt = time.monotonic() - it.enq_t
        it.future.latency_s = dt
        try:
            self.metrics.request_latency.observe(dt)
        except Exception:  # noqa: BLE001 - observability must not break
            pass
        slo.observe("light", dt)
        with self._stats_lock:
            if res.ok:
                self._stats["verified"] += 1
            elif res.retry_after_s is not None:
                pass  # refusal classes counted at the refusal site
            else:
                self._stats["refuted"] += 1
            lat = self._lat.get(it.client)
            if lat is None:
                lat = self._lat[it.client] = deque(maxlen=512)
                if len(self._lat) > _MAX_BUCKETS:
                    self._lat.clear()
                    lat = self._lat[it.client] = deque(maxlen=512)
            lat.append(dt)
        self.metrics.requests.inc(
            outcome="ok" if res.ok else "refused")
        it.future._set(res)

    def _process_batch(self, items: List[_Pending]):
        with trace.span("light.serve", n=len(items)):
            # stage 1: per-request header/time checks (client's `now`)
            survivors: List[_Pending] = []
            for it in items:
                err = self._header_checks(it.req)
                if err is not None:
                    with self._stats_lock:
                        self._stats["invalid"] += 1
                    self._settle(it, LightVerdict(False, err))
                else:
                    survivors.append(it)
            if not survivors:
                return
            try:
                fail.inject("light.coalesce")
            except fail.InjectedFault:
                # chaos: the coalesce plane is broken — degrade every
                # request to its own direct certificate verification
                # (no dedupe), identical verdicts by construction
                with self._stats_lock:
                    self._stats["coalesce_direct"] += len(survivors)
                self.metrics.coalesce.inc(result="direct")
                for it in survivors:
                    self._settle(it, self._verify_direct(it.req))
                return
            # stage 2: group certificate verifications by identity —
            # concurrent requests over the same (chain_id, valset
            # hash, height) run ONE shared verification
            groups: Dict[tuple, list] = {}
            per_item: Dict[int, List[tuple]] = {}
            for it in survivors:
                keys = []
                for key, run in self._cert_tasks(it.req):
                    if key not in groups:
                        groups[key] = [run, 0]
                    groups[key][1] += 1
                    keys.append(key)
                per_item[id(it)] = keys
            # stage 3: distinct certificates run concurrently (lane
            # pool) so their COMMIT-class submissions land in the same
            # scheduler window and share one padded comb launch
            results: Dict[tuple, Optional[BaseException]] = {}

            def mk(key):
                run, waiters = groups[key]
                return lambda: (key, self._cert_verify(key, run, waiters))

            from tendermint_tpu_torch.crypto import lanepool
            for key, err in lanepool.run_lanes(
                    [mk(k) for k in groups]):
                results[key] = err
            # stage 4: settle — a request passes iff every certificate
            # it decomposed into verified; a card fault settles no verdict
            for it in survivors:
                err = None
                for key in per_item[id(it)]:
                    e = results.get(key)
                    if e is not None:
                        err = e
                        break
                if err is not None and card_fault(err):
                    self.log.error("light request stopped on a card fault",
                                   client=it.client, err=str(err))
                    it.future.latency_s = time.monotonic() - it.enq_t
                    it.future._fail(err)
                    continue
                self._settle(it, LightVerdict(
                    err is None, None if err is None else str(err)))

    # -- follow path (header-range subscriptions) --------------------------

    def subscribe(self, client: str, from_height: int = 0) -> str:
        """Open a bounded follow cursor for `client` starting at
        `from_height` (0 = the store base).  Under pressure (per-client
        or global cursor bound) the least-recently-polled cursor is
        evicted — live followers survive, stalled ones re-subscribe."""
        start = max(1, int(from_height) or self.block_store.base())
        evicted = 0
        with self._cur_lock:
            self._cursor_seq += 1
            mine = [cid for cid, c in self._cursors.items()
                    if c.client == client]
            if len(mine) >= self.max_cursors_per_client:
                stalest = min(mine,
                              key=lambda cid: self._cursors[cid].stamp)
                del self._cursors[stalest]
                evicted += 1
            if len(self._cursors) >= self.max_cursors:
                stalest = min(self._cursors,
                              key=lambda cid: self._cursors[cid].stamp)
                del self._cursors[stalest]
                evicted += 1
            cid = f"{client}:{self._cursor_seq}"
            self._cursors[cid] = _Cursor(client, start, self._cursor_seq)
            depth = len(self._cursors)
        if evicted:
            with self._stats_lock:
                self._stats["cursors_evicted"] += evicted
            self.metrics.cursors_evicted.inc(evicted)
        self.metrics.cursors.set(depth)
        return cid

    def unsubscribe(self, cursor_id: str):
        with self._cur_lock:
            self._cursors.pop(cursor_id, None)
            depth = len(self._cursors)
        self.metrics.cursors.set(depth)

    def poll(self, cursor_id: str,
             max_items: Optional[int] = None) -> Optional[List[LightBlock]]:
        """Advance a follow cursor: returns the next (bounded) run of
        light blocks from the store, or None when the cursor was
        evicted (the client re-subscribes).  Store reads run with the
        cursor table unlocked."""
        limit = min(int(max_items), self.cursor_batch) \
            if max_items else self.cursor_batch
        with self._cur_lock:
            cur = self._cursors.get(cursor_id)
            if cur is None:
                return None
            self._cursor_seq += 1
            cur.stamp = self._cursor_seq
            start = cur.next_height
        out: List[LightBlock] = []
        h = start
        top = self.block_store.height()
        while h <= top and len(out) < limit:
            lb = self._light_block(h)
            if lb is None:
                break
            out.append(lb)
            h += 1
        with self._cur_lock:
            cur = self._cursors.get(cursor_id)
            if cur is not None:
                cur.next_height = max(cur.next_height, h)
        with self._stats_lock:
            self._stats["polled"] += len(out)
        return out

    def _light_block(self, h: int) -> Optional[LightBlock]:
        store = self.block_store
        meta = store.load_block_meta(h)
        vals = self.state_store.load_validators(h)
        if meta is None or vals is None:
            return None
        com = store.load_block_commit(h) if h < store.height() \
            else store.load_seen_commit(h)
        if com is None:
            return None
        return LightBlock(SignedHeader(meta.header, com), vals)

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            return dict(self._stats)

    def _per_client_p99_ms(self) -> dict:
        with self._stats_lock:
            snap = {c: list(d) for c, d in self._lat.items()}
        out = {}
        for c, vals in snap.items():
            if not vals:
                continue
            vals.sort()
            idx = max(0, int(len(vals) * 0.99 + 0.5) - 1)
            out[c] = round(vals[idx] * 1000.0, 3)
        return out

    def report(self) -> dict:
        """The GET /debug/light body: stats, coalesce ratio, cursor
        table and per-client p99 latency."""
        st = self.stats()
        leads = st["coalesce_lead"]
        hits = st["coalesce_hit"]
        with self._cur_lock:
            by_client: Dict[str, int] = {}
            for c in self._cursors.values():
                by_client[c.client] = by_client.get(c.client, 0) + 1
        return {
            "enabled": enabled(),
            "running": self.is_running(),
            "chain_id": self.chain_id,
            "depth": self.depth(),
            "stats": st,
            "coalesce_ratio": round(hits / (leads + hits), 4)
            if (leads + hits) else 0.0,
            "cursors": {"total": sum(by_client.values()),
                        "by_client": by_client},
            "per_client_p99_ms": self._per_client_p99_ms(),
            "slo": slo.stream_report("light"),
            "config": {"queue": self.queue_size, "batch": self.batch,
                       "workers": self.workers,
                       "rate_per_s": self.rate_per_s,
                       "burst": self.burst,
                       "max_cursors": self.max_cursors,
                       "max_cursors_per_client":
                           self.max_cursors_per_client,
                       "cursor_batch": self.cursor_batch,
                       "prewarm": self.prewarm_enabled},
        }
