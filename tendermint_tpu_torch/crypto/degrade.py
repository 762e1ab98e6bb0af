"""Device-lane degradation runtime: the resilience layer between the
batch verifier's routing policy (crypto/batch.py) and the GPU.

The counterpart of tendermint_tpu/crypto/degrade.py.  The GPU lane is
the consensus hot path's fast plane, but the device is the least
reliable component in the node: the backend may fail to initialize, a
launch may wedge or raise, and a flaky device must never stall or kill
consensus.  This module implements the degradation ladder

    device -> [launch timeout / raise -> host re-verify, failure counted]
           -> breaker OPEN (everything host-side)
           -> half-open probe with exponential backoff + jitter
           -> re-close on a successful launch

with three guarantees the callers rely on:

  1. exact bitmap semantics: every fallback re-verifies the SAME triples
     on the host OpenSSL path, so callers observe the identical
     per-triple bitmap whether the device worked, timed out, raised, or
     the breaker was open.
  2. bounded wall clock: a launch that misses its deadline is abandoned
     (its worker is quarantined; a fresh lane thread takes over) and the
     batch is re-verified host-side immediately.
  3. no cached doom: a transient backend init failure is re-probed
     with exponential backoff instead of being cached forever.

The port's device rule holds under the runtime: it never degrades to the
host because it finds no GPU.  crypto/batch._use_device raises when CUDA
is asked for and missing; the runtime only degrades launches that were
dispatched to a device and failed there.  On the card (collect/run with
on_card=True) it does not even do that outside a chaos drill: a failed
launch, a missed deadline, a spot-check mismatch or an open breaker is
counted and raised to the caller as DeviceLaneError unless a failpoint
is armed (libs/fail.armed), so a broken kernel never turns quietly into
the host path.  Guarantee 1 below then holds for injected faults, and
for the plain PyTorch lane on the CPU as in the JAX package.  Kernels
are built on the caller's thread before the first submit
(crypto/batch._load_kernels), so an nvcc build never runs under the
launch deadline.

Observability: breaker transitions fire listener callbacks and every
launch/failure/fallback/probe increments libs/metrics counters.  Chaos
tests force each failure class deterministically through libs/fail.py
injection sites.
"""
from __future__ import annotations

import concurrent.futures as _cf
import os
import queue as _queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from tendermint_tpu_torch.libs import fail
from tendermint_tpu_torch.libs import slo
from tendermint_tpu_torch.libs import trace

# breaker states (rendered into the tendermint_crypto_breaker_state
# gauge as 0 / 0.5 / 1)
CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}


class DeviceLaneError(RuntimeError):
    """A device launch failed (raise, timeout, or integrity mismatch)."""


def card_fault(e: BaseException) -> bool:
    """True for a launch that failed on the card outside a chaos drill:
    the card's fault, never a peer's, a header's or a piece of
    evidence's, so a caller's catch-all lets it through.  In a drill (a
    failpoint armed) the runtime re-verifies on the host, and a
    DeviceLaneError that still escapes takes the JAX package's path."""
    return isinstance(e, DeviceLaneError) and not fail.armed()


@dataclass
class DegradeConfig:
    """Knobs for the resilience runtime.  Env-overridable so operators
    can tune a deployed node without code changes."""
    failure_threshold: int = 3     # consecutive failures that open
    launch_timeout_s: float = 60.0  # per-launch wall clock (the kernels
    #                                 are built before the launch starts)
    backoff_base_s: float = 1.0    # first re-probe delay after opening
    backoff_max_s: float = 120.0
    backoff_jitter: float = 0.2    # +/- fraction applied to each delay
    spot_check: bool = True        # host-re-verify one lane per launch

    @classmethod
    def from_env(cls) -> "DegradeConfig":
        c = cls()
        env = os.environ.get
        c.failure_threshold = int(env("TM_TPU_BREAKER_THRESHOLD",
                                      c.failure_threshold))
        c.launch_timeout_s = float(env("TM_TPU_DEVICE_TIMEOUT_S",
                                       c.launch_timeout_s))
        c.backoff_base_s = float(env("TM_TPU_BREAKER_BACKOFF_S",
                                     c.backoff_base_s))
        c.backoff_max_s = float(env("TM_TPU_BREAKER_BACKOFF_MAX_S",
                                    c.backoff_max_s))
        c.spot_check = env("TM_TPU_SPOT_CHECK", "1") != "0"
        return c


class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probing.

    CLOSED: launches flow.  After `failure_threshold` consecutive
    failures the breaker OPENs: try_acquire() denies everything until
    the backoff deadline, then grants exactly ONE caller a HALF_OPEN
    trial.  A successful trial re-closes (and resets the backoff); a
    failed trial re-opens with the delay doubled (capped, jittered).

    Thread-safe.  `clock` is injectable so tests drive the backoff
    schedule deterministically."""

    def __init__(self, cfg: Optional[DegradeConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None):
        self.cfg = cfg or DegradeConfig.from_env()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._backoff = self.cfg.backoff_base_s
        self._probe_at = 0.0
        self._listeners: List[Callable[[str, str, str], None]] = []
        self._metrics = metrics
        self.opened_total = 0

    # -- observation -------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def add_listener(self, fn: Callable[[str, str, str], None]):
        """fn(old_state, new_state, reason) on every transition; returns
        an unsubscribe callable (listeners are process-global, so every
        subscriber — node, consensus loop, tests — must detach on
        stop)."""
        with self._lock:
            self._listeners.append(fn)

        def _unsub():
            with self._lock:
                if fn in self._listeners:
                    self._listeners.remove(fn)
        return _unsub

    def _transition(self, new: str, reason: str):
        # lock held by caller: mutate state only.  Metrics, the trace
        # instant AND the listener callbacks all run in the returned
        # closure, which every caller invokes AFTER releasing _lock —
        # publishing takes the metric/trace leaf locks and listener
        # callbacks are arbitrary subscriber code (node logging), none
        # of which belongs under the breaker lock (tmlint TM201/TM202
        # discipline; callers invoke the closure before returning, so
        # the gauge is current by the time any caller observes the
        # transition).
        old, self._state = self._state, new
        if new == OPEN:
            self.opened_total += 1
        listeners = list(self._listeners)

        def _notify():
            if self._metrics is not None:
                # gauge publishes the CURRENT state, not this
                # transition's: two racing transitions may run their
                # closures out of order (A: ->OPEN preempted, B:
                # ->HALF_OPEN publishes, A resumes) and a stale `new`
                # would leave the gauge wrong until the next
                # transition.  The counter is commutative, so labeling
                # it with this transition's target is exact regardless
                # of closure order.
                self._metrics.breaker_state.set(
                    _STATE_GAUGE[self.state])
                self._metrics.breaker_transitions.inc(to=new)
            trace.instant("breaker.transition", to=new, reason=reason,
                          **{"from": old})
            for fn in listeners:
                fn(old, new, reason)
        return _notify

    # -- the gate ----------------------------------------------------------

    def try_acquire(self) -> bool:
        """May this launch go to the device?  Every grant MUST be settled
        by exactly one record_success/record_failure."""
        notify = None
        try:
            with self._lock:
                if self._state == CLOSED:
                    return True
                if self._state == OPEN and \
                        self._clock() >= self._probe_at:
                    notify = self._transition(HALF_OPEN, "probe due")
                    return True
                return False  # OPEN before deadline, or trial in flight
        finally:
            if notify is not None:
                notify()

    def record_success(self):
        notify = None
        with self._lock:
            self._consecutive = 0
            if self._state != CLOSED:
                self._backoff = self.cfg.backoff_base_s
                notify = self._transition(CLOSED, "device launch ok")
        if notify is not None:
            notify()

    def record_failure(self, reason: str):
        notify = None
        with self._lock:
            self._consecutive += 1
            reopen = self._state == HALF_OPEN
            if reopen or (self._state == CLOSED and
                          self._consecutive >= self.cfg.failure_threshold):
                if reopen:  # failed probe: back off harder
                    self._backoff = min(self._backoff * 2,
                                        self.cfg.backoff_max_s)
                delay = self._backoff
                if self.cfg.backoff_jitter:
                    delay *= 1 + self.cfg.backoff_jitter * \
                        random.uniform(-1.0, 1.0)
                self._probe_at = self._clock() + delay
                notify = self._transition(OPEN, reason)
        if notify is not None:
            notify()


class _LaneWorker:
    """Single-thread task runner for device launches — the
    ThreadPoolExecutor(max_workers=1) shape, but with a DAEMON thread.
    Python 3.9+ executor threads are non-daemon and an idle lane worker
    would outlive every test (and show up in the conftest thread-leak
    guard) and block interpreter shutdown behind a wedged device call;
    the lane worker must never keep the process alive."""

    def __init__(self, name: str = "batch-device-lane"):
        self._q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, fn: Callable) -> _cf.Future:
        if self._closed:
            raise RuntimeError("lane worker is shut down")
        f: _cf.Future = _cf.Future()
        self._q.put((fn, f))
        return f

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, f = item
            if not f.set_running_or_notify_cancel():
                continue
            try:
                f.set_result(fn())
            except BaseException as e:  # noqa: BLE001 - future carries it
                f.set_exception(e)

    def shutdown(self, wait: bool = False):
        """Same contract as executor.shutdown(wait=False): stop accepting
        work, wake the worker.  A wedged in-flight call keeps its (daemon)
        thread; quarantine relies on exactly that — abandon, don't join."""
        self._closed = True
        self._q.put(None)
        if wait:
            self._thread.join(timeout=2.0)


class DeviceLaneRuntime:
    """Owns the device-lane worker pool, the circuit breaker, and the
    backend probe.  crypto/batch.py routes every device dispatch through
    submit()/collect() (overlapped lanes) or run() (synchronous)."""

    def __init__(self, cfg: Optional[DegradeConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        from tendermint_tpu_torch.libs.metrics import CryptoMetrics

        self.cfg = cfg or DegradeConfig.from_env()
        self.metrics = CryptoMetrics(registry)
        self.breaker = CircuitBreaker(self.cfg, clock=clock,
                                      metrics=self.metrics)
        self._clock = clock
        self._pool_lock = threading.Lock()
        self._pool: Optional[_LaneWorker] = None
        # backend probe state: None = never probed, True = accelerator,
        # False-stable = plain-CPU backend (a fixed property of the
        # process), False-transient = init raised, re-probe after backoff
        self._backend_lock = threading.Lock()
        self._backend: Optional[bool] = None
        self._backend_stable = False
        self._backend_next_probe = 0.0
        self._backend_backoff = self.cfg.backoff_base_s

    # -- worker pool -------------------------------------------------------

    def _get_pool(self) -> _LaneWorker:
        with self._pool_lock:
            if self._pool is None:
                self._pool = _LaneWorker()
            return self._pool

    def _quarantine_pool(self):
        """A launch missed its deadline: the worker may be wedged on the
        device, so later launches must not queue behind it.  Abandon the
        executor (its thread finishes or wedges on its own) and lazily
        build a fresh one."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def close(self):
        """Shut down the lane worker (configure()/reset() call this on
        the runtime they replace so tests don't accumulate idle lane
        threads)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- backend probing (replaces batch.py's one-shot _backend_ok) --------

    def backend_available(self) -> bool:
        """True once torch reports a usable CUDA device.  An init FAILURE
        is treated as transient: re-probed after an exponential backoff
        instead of being cached forever.  A False here never sends a
        batch to the host quietly: crypto/batch._use_device raises."""
        with self._backend_lock:
            if self._backend is not None and \
                    (self._backend or self._backend_stable):
                return self._backend
            if self._backend is not None and \
                    self._clock() < self._backend_next_probe:
                return False
        try:
            import torch
            ok = torch.cuda.is_available()
            if ok:
                torch.cuda.init()
            with self._backend_lock:
                self._backend = ok
                self._backend_stable = True   # a live backend is fixed
                self._backend_backoff = self.cfg.backoff_base_s
            self.metrics.backend_probes.inc(
                result="accelerator" if ok else "cpu")
            # a successful probe is the one moment the device topology
            # can have changed under a latched mesh plane (the backend
            # came up after the plane's first look): let the plane
            # rebuild itself against the live device list (ADR-027)
            try:
                from tendermint_tpu_torch.parallel import sharding
                sharding.invalidate_on_topology_change()
            except Exception:  # noqa: BLE001 - plane upkeep must not
                pass            # fail a backend probe
            return ok
        except Exception:
            with self._backend_lock:
                self._backend = False
                self._backend_stable = False
                self._backend_next_probe = \
                    self._clock() + self._backend_backoff
                self._backend_backoff = min(
                    self._backend_backoff * 2, self.cfg.backoff_max_s)
            self.metrics.backend_probes.inc(result="error")
            return False

    # -- launch plumbing ---------------------------------------------------

    def try_acquire(self) -> bool:
        return self.breaker.try_acquire()

    def submit(self, site: str, fn: Callable, *args) -> _cf.Future:
        """Dispatch a device launch on the lane worker.  The fail-point
        injection runs INSIDE the worker so `latency:` modes are subject
        to the launch deadline exactly like real device stalls.  Caller
        must settle via collect() — submit itself never raises (a
        dispatch failure comes back as a failed future), so an acquired
        breaker grant can always be settled."""
        self.metrics.device_launches.inc(site=site)
        # the launch runs on the lane worker thread: capture the caller's
        # span id HERE so the worker's span links into the caller's tree
        # (the thread-local stack doesn't cross the pool boundary).
        # The lockstep mark (parallel/sharding, ADR-027) is thread-local
        # for the same reason and crosses the boundary the same way —
        # without re-arming it on the worker, a coordinated caller's
        # batch would lose its global-mesh eligibility here
        parent = trace.current_id()
        from tendermint_tpu_torch.parallel import sharding
        locked = sharding.in_lockstep()

        def _launch():
            with trace.span("device.launch", parent=parent, site=site):
                fail.inject(site)
                if locked:
                    with sharding.lockstep():
                        return fn(*args)
                return fn(*args)
        try:
            f = self._get_pool().submit(_launch)
        except Exception as e:  # noqa: BLE001 - e.g. pool at shutdown
            f = _cf.Future()
            f.set_exception(e)
        # collect() reads this on a wedge: a lockstep launch that times
        # out is the global collective's signature hang (a peer never
        # entered), and the latch must trip on the FIRST one
        f.tm_lockstep = locked
        return f

    def collect(self, site: str, fut: _cf.Future,
                host_fn: Callable[[], np.ndarray],
                spot_check: Optional[Callable[[np.ndarray], bool]] = None,
                on_card: bool = False) -> np.ndarray:
        """Settle a launch: bounded wait, integrity check, breaker
        bookkeeping — and on ANY device failure re-verify the batch
        through host_fn so the caller's bitmap is exact regardless
        (on_card: only in a chaos drill, see allow_fallback).  A
        spot_check with a prepare() method takes its host verdict
        there, before the wait."""
        with trace.span("device.collect", site=site) as sp:
            # launch-seconds bracket via the Histogram.time helper;
            # observed manually (success only — a degraded launch's
            # wall belongs to the failure counters, not this histogram)
            launch_timer = self.metrics.device_launch_seconds.time(
                clock=self._clock, site=site)
            if not self.cfg.spot_check:
                spot_check = None
            prepare = getattr(spot_check, "prepare", None)
            if prepare is not None:
                prepare()
            reason = err = None
            try:
                out = fut.result(timeout=self.cfg.launch_timeout_s)
                out = fail.corrupt_bitmap(site, out)
                if spot_check is not None \
                        and not spot_check(np.asarray(out)):
                    raise DeviceLaneError(
                        f"{site}: device bitmap disagrees with host "
                        f"spot check")
            except (_cf.TimeoutError, TimeoutError) as e:
                err = e
                # on 3.11+ futures.TimeoutError IS builtin TimeoutError,
                # so a TimeoutError raised by the device fn itself lands
                # here too: only a
                # future that is genuinely still running means the WAIT
                # timed out and the worker may be wedged — anything else
                # is a device raise
                if fut.done():
                    reason = "raise"
                else:
                    reason = "timeout"
                    self._quarantine_pool()
                    fut.cancel()
                    from tendermint_tpu_torch.parallel import sharding
                    if getattr(fut, "tm_lockstep", False) and \
                            sharding.global_mesh_ready():
                        # a coordinated launch wedged past the deadline
                        # on a multi-process runtime means a collective
                        # a peer never entered: latch the global plane
                        # off NOW (and poison it job-wide) rather than
                        # burning one launch deadline per later batch
                        sharding.disable_global_plane()
            except Exception as e:  # noqa: BLE001 - any fault degrades
                err = e
                reason = "integrity" if isinstance(e, DeviceLaneError) \
                    else "raise"
            if reason is None:
                launch_timer.observe()
                self.breaker.record_success()
                sp.add(outcome="ok")
                return np.asarray(out)
            self.metrics.device_failures.inc(site=site, reason=reason)
            self.breaker.record_failure(f"{site}: {reason}")
            sp.add(outcome=reason)
            return self.host_fallback(site, reason, host_fn, on_card, err)

    def allow_fallback(self, site: str, reason: str, on_card: bool,
                       cause: Optional[BaseException] = None):
        """Count a host fallback at `site` — or, for a lane on the card
        outside a chaos drill (no failpoint armed), raise
        DeviceLaneError instead: the port never answers on the host for
        a card whose launch failed, timed out, returned a bitmap the
        spot check refutes, or whose breaker is open."""
        if on_card and not fail.armed():
            raise DeviceLaneError(
                f"{site}: device lane failed on the card ({reason}); no "
                f"host re-verify outside a chaos drill") from cause
        self.metrics.host_fallbacks.inc(site=site, reason=reason)

    def host_fallback(self, site: str, reason: str,
                      host_fn: Callable[[], np.ndarray],
                      on_card: bool = False,
                      cause: Optional[BaseException] = None) -> np.ndarray:
        self.allow_fallback(site, reason, on_card, cause)
        with trace.span("device.host_fallback", site=site, reason=reason):
            return host_fn()

    def run(self, site: str, device_fn: Callable[[], np.ndarray],
            host_fn: Callable[[], np.ndarray],
            spot_check: Optional[Callable[[np.ndarray], bool]] = None,
            on_card: bool = False) -> np.ndarray:
        """Synchronous wrapper: breaker gate + launch + settle.  The
        whole-commit path (crypto/batch.verify_sigs_bulk) uses this; the
        mixed-batch path uses submit()/collect() to overlap the device
        lane with its host lanes."""
        if not self.try_acquire():
            return self.host_fallback(site, "breaker_open", host_fn,
                                      on_card)
        return self.collect(site, self.submit(site, device_fn), host_fn,
                            spot_check=spot_check, on_card=on_card)


# ---------------------------------------------------------------------------
# process-global runtime (one device per process); tests swap it out
# via configure()/reset()
# ---------------------------------------------------------------------------

_runtime: Optional[DeviceLaneRuntime] = None
_runtime_lock = threading.Lock()


def runtime() -> DeviceLaneRuntime:
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            _runtime = DeviceLaneRuntime()
        return _runtime


def runtime_if_installed() -> Optional[DeviceLaneRuntime]:
    """The runtime IF one already exists — never constructs.  The
    best-effort metric bridges below use this so publishing from a
    sub-threshold path (which BatchVerifier deliberately keeps
    runtime-free: the breaker lock is shared across reactor threads)
    can never build the runtime just for a gauge."""
    with _runtime_lock:
        return _runtime


def configure(cfg: Optional[DegradeConfig] = None,
              clock: Callable[[], float] = time.monotonic,
              registry=None) -> DeviceLaneRuntime:
    """Install a fresh runtime (tests: deterministic clock / private
    metrics registry; node assembly: config-derived thresholds)."""
    global _runtime
    new = DeviceLaneRuntime(cfg, clock=clock, registry=registry)
    with _runtime_lock:
        old, _runtime = _runtime, new
    if old is not None:
        old.close()
    # return the runtime THIS call installed — re-reading the global
    # here could hand back None (concurrent reset) or another call's
    # runtime (concurrent configure)
    return new


def reset():
    """Drop the global runtime (next access rebuilds from env)."""
    global _runtime
    with _runtime_lock:
        old, _runtime = _runtime, None
    if old is not None:
        old.close()


def publish_route(path, outcome, n=None, nb=None, compile_s=None):
    """The ONE bridge from a dispatch-route decision (ops/ed25519
    _record_launch, ops/msm _set_route) into CryptoMetrics: route
    counter at set time (labeled by outcome, so a bounced RLC attempt
    is never mistaken for the fast path engaging), lane occupancy, and
    the first-launch compile split.  Swallows everything —
    observability must never break verification."""
    try:
        m = runtime().metrics
        m.msm_route.inc(path=str(path), outcome=str(outcome))
        if nb and n is not None:  # never fabricate a perfect ratio
            m.batch_occupancy.set(n / nb)
        if compile_s is not None:
            m.device_compile_seconds.observe(compile_s, site=str(path))
    except Exception:  # noqa: BLE001 - metrics are best-effort here
        pass


def publish_table_cache(bytes_=None, hit=None, evicted=None):
    """Bridge from the comb table cache (ops/ed25519) into CryptoMetrics:
    the resident-bytes gauge (the bytes the cache charges) and the
    hit/eviction counters.  Comb launches publish through publish_route
    (path comb) like every other route.  Swallows everything, as
    publish_route."""
    try:
        m = runtime().metrics
        if bytes_ is not None:
            m.table_cache_bytes.set(float(bytes_))
        if hit:
            m.table_hits.inc()
        if evicted:
            m.table_evictions.inc()
    except Exception:  # noqa: BLE001 - metrics are best-effort here
        pass


def publish_host_pool(depth=None, tasks=None):
    """Bridge from the host-lane pool (crypto/lanepool.py) into
    CryptoMetrics: the admitted-task depth gauge and per-kind task
    counters — ``tasks`` is an iterable of (kind, outcome, count).
    Swallows everything, as publish_route: the pool must keep verifying
    even when metrics are broken.  No-op until a runtime exists
    (runtime_if_installed): the pool also serves sub-threshold batches
    that must never construct one."""
    try:
        rt = runtime_if_installed()
        if rt is None:
            return
        m = rt.metrics
        if depth is not None:
            m.host_pool_depth.set(float(depth))
        for kind, outcome, count in tasks or ():
            if count:
                m.host_pool_tasks.inc(count, kind=kind, outcome=outcome)
    except Exception:  # noqa: BLE001 - metrics are best-effort here
        pass


def publish_lane_overlap(ratio):
    """Bridge for the per-batch lane-overlap ratio (crypto/batch.py
    publishes it after a multi-lane window settles: 1 - wall/sum(lane
    walls); 0 = fully serial lanes).  Swallows everything, and it is a
    no-op until a runtime exists (runtime_if_installed), because
    sub-threshold batches must never construct one."""
    try:
        rt = runtime_if_installed()
        if rt is not None:
            rt.metrics.lane_overlap.set(float(ratio))
    except Exception:  # noqa: BLE001 - metrics are best-effort here
        pass


def publish_request_latency(priority: str, path: str, e2e_s: float):
    """Bridge for the direct verify path's end-to-end latency
    (crypto/batch.BatchVerifier.verify stamps entry and publishes at
    return).  Swallowing, and it reads the runtime global WITHOUT the
    install lock: the tiny-batch direct path is the consensus
    vote-window hot path, deliberately runtime-free, and publishing one
    histogram must not serialize every caller on the install lock (a
    plain global read is atomic in CPython).  The SLO estimator is fed
    regardless — its disabled path is a no-op."""
    try:
        slo.observe(priority, e2e_s)
        rt = _runtime
        if rt is not None:
            rt.metrics.verify_e2e_latency.observe(
                e2e_s, priority=priority, path=path)
    except Exception:  # noqa: BLE001 - metrics are best-effort here
        pass
