"""VerifyScheduler — the process-global signature-verification service.

The counterpart of tendermint_tpu/crypto/scheduler.py
(docs/adr/adr-012-verify-scheduler.md).  Without it every consumer of
the verify plane owns a private crypto.batch.BatchVerifier and blocks on
verify(): under concurrent load those consumers launch small fragmented
device batches back to back, and the device idles while each caller's
host thread stages its own next batch.  This module gives the verify
plane the inference-serving shape:

  * one process-global scheduler with a futures API —
    ``submit(items, priority, deadline) -> VerifyFuture`` resolving to
    the exact per-triple validity bitmap, plus ``verify_items`` as a
    drop-in synchronous wrapper with BatchVerifier's (all_ok, bitmap)
    contract;
  * continuous coalescing: submissions from all consumers merge into
    shared launches under a time/size window.  The launch path is the
    SAME per-scheme lane machinery BatchVerifier uses (host lanes + the
    device kernel K1 via crypto/degrade.py, site "sched.ed25519");
  * a double-buffered pipeline: a stager thread hashes/dedupes/groups
    batch N+1 while the executor thread has batch N in flight on the
    device lane;
  * dedupe: identical (pub, msg, sig) triples submitted into one window
    collapse into one lane, and triples already proven by SigCache
    resolve without any lane at all;
  * priority classes (consensus votes > commit/light > blocksync replay
    > mempool pre-check) with a bounded queue: the lowest class is shed
    when the queue is full, and queued lowest-class work is evicted to
    admit higher classes;
  * deadline flush: a submission may carry a monotonic deadline and the
    window closes early to honor it;
  * per-request lifecycle stamps: every submission is stamped
    submit -> window-close -> stage -> launch -> settle, feeding the
    queue-wait/e2e latency histograms, deadline-miss accounting, the
    sliding-window SLO estimator (libs/slo.py), and
    last_latency_report().

The port's rules under the scheduler:

  * a scheduler launches on ONE torch.device, resolved at construction
    on the caller's thread; on "cuda" start() builds the kernels there,
    so a build failure raises out of start().  The stager and executor
    are handed the device and never ask torch for one;
  * degradation goes through crypto/degrade.py: on a CPU lane, and on
    the card in a chaos drill, a device raise, timeout, corrupt bitmap
    or open breaker re-verifies the SAME lanes on the host; on the card
    outside a drill the runtime raises degrade.DeviceLaneError, and the
    executor fails that launch's futures with it — no host re-verify
    hides a card fault.  The loop survives, and the next window
    launches on the card;
  * any other fault of a launch (the scheduler's own host code, or a
    wrapper's malformed answer) settles the launch on the host only on
    a CPU lane or in a drill; on the card outside a drill it fails the
    launch's futures with SchedulerExecError, so the sync wrappers rerun
    the work on their direct card path.  Either way it is counted in
    crypto_sched_exec_fault_total{outcome};
  * verify_items and verify_sigs_bulk route here only when the caller's
    resolved device is the scheduler's; they fall back to their direct
    path on SchedulerError or TimeoutError only (the sync timeout reruns
    the work directly while the launch may still run — the reference's
    contract), so a DeviceLaneError reaches the consumer.

When the scheduler is not installed/running, every call site takes its
direct BatchVerifier path — the scheduler is an accelerant, never a
dependency.  A coordinated call (verify_items(coordinated=True), from
inside a sharding.lockstep() window) skips the scheduler.
"""
from __future__ import annotations

import enum
import queue as _queue
import threading
import time
from contextlib import contextmanager
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.libs import fail
from tendermint_tpu_torch.libs import slo
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.service import BaseService
from . import PubKey
from . import batch as _batch
from . import degrade
from . import ed25519 as _ed


class Priority(enum.IntEnum):
    """Lower value = more urgent.  MEMPOOL is the shed class."""
    CONSENSUS = 0   # live vote preverify: blocks the consensus loop
    COMMIT = 1      # commit / light-client checks (finalize, verifier)
    BLOCKSYNC = 2   # replay windows: throughput-bound, deadline-free
    MEMPOOL = 3     # pre-checks: best-effort, shed under pressure


class SchedulerError(RuntimeError):
    """Base class: the sync wrapper treats any of these as 'use the
    direct BatchVerifier path instead'."""


class SchedulerShedError(SchedulerError):
    """The submission was load-shed (queue full, lowest class)."""


class SchedulerStoppedError(SchedulerError):
    """The scheduler stopped before the submission resolved."""


class SchedulerExecError(SchedulerError):
    """A launch on the card failed outside the device lane (a fault of
    the scheduler's own host code, or a malformed kernel answer); the
    cause is chained.  No host re-verify settles it: the sync wrappers
    rerun the work on their direct path, on the same card."""


class VerifyFuture:
    """Resolves to the per-item bool bitmap, in submission order, or
    raises: the scheduler's errors (shed, stopped, a failed staging), a
    malformed pub, or degrade.DeviceLaneError when the launch failed on
    the card outside a chaos drill.  First resolution wins — a late
    executor settling after stop() can never clobber the stop error the
    waiter already observed (or vice versa)."""

    def __init__(self, n: int):
        self._n = n
        self._ev = threading.Event()
        self._bits: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None

    def _set(self, bits: np.ndarray):
        if not self._ev.is_set():
            self._bits = bits
            self._ev.set()

    def _set_exception(self, exc: BaseException):
        if not self._ev.is_set():
            self._exc = exc
            self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"verify future ({self._n} items) not resolved "
                f"within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._bits


class _Submission:
    __slots__ = ("items", "prio", "deadline", "populate_cache", "future",
                 "bits", "remaining", "enq_t", "n",
                 # lifecycle stamps (ADR-016): monotonic, 0.0 = not yet
                 "submit_t", "wclose_t", "settle_t", "deadline_missed",
                 "path")

    def __init__(self, items, prio, deadline, populate_cache):
        self.items = items          # List[_batch._Item]
        self.prio = prio
        self.deadline = deadline    # monotonic or None
        self.populate_cache = populate_cache
        self.n = len(items)
        self.future = VerifyFuture(self.n)
        self.bits = np.zeros(self.n, dtype=bool)
        self.remaining = self.n
        self.enq_t = 0.0
        self.submit_t = 0.0         # submit() entry
        self.wclose_t = 0.0         # the coalescing window closed
        self.settle_t = 0.0         # future resolved
        self.deadline_missed = False
        self.path = "sched-cache"   # what settled it (see _execute)


class _Launch:
    __slots__ = ("lanes", "keys", "waiters", "by_scheme", "subs",
                 "parent_span", "cache_hits", "dedup",
                 "wclose_t", "staged_t")

    def __init__(self, lanes, keys, waiters, by_scheme, subs, parent_span,
                 cache_hits, dedup):
        self.lanes = lanes          # List[_batch._Item], one per lane
        self.keys = keys            # SigCache digests, lane-aligned
        self.waiters = waiters      # lane -> [(submission, item_idx)]
        self.by_scheme = by_scheme  # type_name -> [lane idx]
        self.subs = subs
        self.parent_span = parent_span
        self.cache_hits = cache_hits
        self.dedup = dedup
        self.wclose_t = 0.0
        self.staged_t = 0.0


def _as_item(triple) -> _batch._Item:
    """Normalize a (pub, msg, sig) triple: pub may be a PubKey or raw
    32-byte ed25519 key bytes (the validator-set matrix rows)."""
    pub, msg, sig = triple
    if not isinstance(pub, PubKey):
        pub = _ed.PubKey(bytes(pub))
    return _batch._Item(pub, bytes(msg), bytes(sig))


def _mark_fallback(box: List[str], tag: str, fn):
    """Wrap a degrade host_fn so the window knows its device lane fell
    back — degrade only INVOKES host_fn on a fallback, so the append
    is exactly the signal (the e2e path label must say sched-fallback,
    not claim device latency for a host re-verify)."""
    def run():
        box.append(tag)
        return fn()
    return run


# ---------------------------------------------------------------------------
# the latency report (ADR-016): per-request lifecycle decomposition of
# the most recently settled window, alongside batch.last_lane_report()
# ---------------------------------------------------------------------------

_MAX_REPORT_REQUESTS = 32

_last_latency: dict = {}


def last_latency_report() -> dict:
    """Lifecycle decomposition of the most recent VerifyScheduler
    window: submit -> window-close (queue_wait) -> stage -> launch
    (exec_wait/execute, with the per-lane wall breakdown) -> settle,
    plus one row per request with its e2e latency and whether its
    deadline was met.  (GET /debug/latency and the `debug-latency` CLI
    wait for the node's ports.)"""
    return _last_latency


def _set_latency_report(report: dict):
    global _last_latency
    _last_latency = report


def _build_report(subs, path: str, lanes_n: int, stage_s: float,
                  exec_wait_s: float, execute_s: float, settle_s: float,
                  lane_report: Optional[dict] = None) -> dict:
    e2es = [s.settle_t - s.submit_t for s in subs if s.settle_t]
    qws = [s.wclose_t - s.submit_t for s in subs if s.wclose_t]
    reqs = [{
        "priority": s.prio.name.lower(),
        "n": s.n,
        "queue_wait_s": round(s.wclose_t - s.submit_t, 6)
        if s.wclose_t else None,
        "e2e_s": round(s.settle_t - s.submit_t, 6) if s.settle_t else None,
        "deadline_met": (None if s.deadline is None
                         else not s.deadline_missed),
    } for s in subs[:_MAX_REPORT_REQUESTS]]
    return {
        "path": path,
        "submissions": len(subs),
        "items": sum(s.n for s in subs),
        "lanes": lanes_n,
        "queue_wait_max_s": round(max(qws), 6) if qws else None,
        "stage_s": round(stage_s, 6),
        "exec_wait_s": round(exec_wait_s, 6),
        "execute_s": round(execute_s, 6),
        "settle_s": round(settle_s, 6),
        "e2e_max_s": round(max(e2es), 6) if e2es else None,
        "lane_report": lane_report,
        "requests": reqs,
    }


class VerifyScheduler(BaseService):
    """See the module docstring.  One instance per process (install());
    tests may run private instances."""

    def __init__(self, window_s: float = 0.002, max_batch: int = 8192,
                 max_pending: int = 65536,
                 tpu_threshold: Optional[int] = None,
                 name: str = "verify-scheduler", device=None):
        super().__init__(name=name)
        # the torch.device every launch of this scheduler runs on,
        # resolved HERE on the constructing thread: no CUDA and no
        # request for the CPU raises now, and the stager and executor
        # threads never ask torch for a current device
        self.device = resolve_device(device)
        self.window_s = max(0.0, float(window_s))
        self.max_batch = max(1, int(max_batch))
        self.max_pending = max(1, int(max_pending))
        self.tpu_threshold = (tpu_threshold if tpu_threshold is not None
                              else _batch.BatchVerifier().tpu_threshold)
        self._cond = threading.Condition()
        self._queues: Dict[int, List[_Submission]] = \
            {int(p): [] for p in Priority}
        self._pending_items = 0
        self._flush_req = False
        # maxsize=1 IS the double buffer: one launch executing, one
        # staged, the stager blocked on a third until a slot frees
        self._staged: "_queue.Queue[_Launch]" = _queue.Queue(maxsize=1)
        self._res_lock = threading.Lock()
        # pipeline-overlap accounting (all under _stats_lock)
        self._stats_lock = threading.Lock()
        self._stats = {
            "submissions": 0, "items": 0, "launches": 0, "lanes": 0,
            "cache_hits": 0, "dedup": 0, "shed": 0, "evicted": 0,
            "stage_s": 0.0, "stage_overlap_s": 0.0, "exec_busy_s": 0.0,
            "exec_faults": 0,
        }
        self._exec_since: Optional[float] = None

    # -- live reconfiguration (ADR-023) ------------------------------------

    def set_window(self, window_s: float):
        """Thread-safe live coalescing-window change (the adaptive
        control plane's seam).  The collector re-reads window_s on
        every wait iteration, so a plain clamped store takes effect on
        the NEXT window close; the wake lets a widened window re-arm
        without waiting out the old deadline."""
        self.window_s = max(0.0, float(window_s))
        with self._cond:
            self._cond.notify_all()

    # -- metrics -----------------------------------------------------------

    @staticmethod
    def _metrics():
        """The CryptoMetrics bundle of the CURRENT degradation runtime —
        resolved per use so a test that reconfigures degrade mid-life
        sees scheduler metrics land in its private registry too."""
        return degrade.runtime().metrics

    def _publish_depth(self):
        """Publish the queue-depth gauge.  NEVER call this holding
        _cond: resolving the metrics bundle goes through
        degrade.runtime() (rank 5, the global install lock, possibly
        CONSTRUCTING the runtime) and the metric's own leaf lock —
        tmlint TM201 found exactly this inversion under _cond (rank
        20).  The gauge reads the CURRENT _pending_items (one atomic
        int read) rather than a value captured inside the lock: two
        publishers racing out-of-lock with captured snapshots could
        land the older value last and leave the gauge stale until the
        next event (same reasoning as the breaker_state fix in
        degrade._transition)."""
        try:
            self._metrics().sched_queue_depth.set(self._pending_items)
        except Exception:  # noqa: BLE001 - observability must not break
            pass

    # -- submission --------------------------------------------------------

    def submit(self, items: Sequence, prio: Priority = Priority.COMMIT,
               deadline: Optional[float] = None,
               populate_cache: bool = True) -> VerifyFuture:
        """Queue (pub, msg, sig) triples; the future resolves to their
        bool bitmap in submission order.  `deadline` is a monotonic
        timestamp: the coalescing window closes early to meet it.
        Raises nothing — shed/stopped/malformed land on the future.

        max_pending is a hard bound only for the MEMPOOL shed class;
        higher classes are always admitted (dropping consensus-critical
        work would change semantics, and every in-repo consumer blocks
        on the future through the sync wrapper, so each consumer thread
        holds at most one submission in flight — the queue is naturally
        bounded by consumer count x batch size)."""
        try:
            norm = [_as_item(t) for t in items]
        except Exception as exc:  # noqa: BLE001 - malformed pub bytes
            f = VerifyFuture(0)
            f._set_exception(exc)
            return f
        sub = _Submission(norm, Priority(prio), deadline, populate_cache)
        sub.submit_t = time.monotonic()  # lifecycle origin (ADR-016)
        if sub.n == 0:
            sub.future._set(sub.bits)
            return sub.future
        # under _cond: queue manipulation ONLY.  Shed/evict settlement
        # (metrics, trace, future exceptions) and the depth gauge are
        # deferred past the release — the metrics bundle resolves
        # through degrade.runtime()'s install lock (rank 5), which must
        # never be taken while holding _cond (rank 20); tmlint TM201.
        shed: List[Tuple[_Submission, str, int]] = []
        stopped = False
        admitted = False
        depth = 0
        with self._cond:
            if not self.is_running():
                stopped = True
            elif self._pending_items + sub.n > self.max_pending and \
                    sub.prio == Priority.MEMPOOL:
                shed.append((sub, "queue_full", self._pending_items))
            else:
                if self._pending_items + sub.n > self.max_pending:
                    # admit the higher class by evicting queued
                    # shed-class work, newest first (oldest mempool work
                    # is closest to its launch; the newest waited least)
                    shed.extend(self._evict_mempool_locked(sub.n))
                sub.enq_t = time.monotonic()
                self._queues[int(sub.prio)].append(sub)
                self._pending_items += sub.n
                admitted = True
                depth = self._pending_items
                self._cond.notify_all()
        if stopped:
            sub.future._set_exception(SchedulerStoppedError(
                f"{self.name} is not running"))
            return sub.future
        for victim, reason, pending in shed:
            self._settle_shed(victim, reason, pending)
        if not admitted:
            return sub.future
        with self._stats_lock:
            self._stats["submissions"] += 1
            self._stats["items"] += sub.n
        self._publish_depth()
        trace.instant("sched.submit", priority=sub.prio.name.lower(),
                      n=sub.n, queue_depth=depth)
        return sub.future

    def _settle_shed(self, sub: _Submission, reason: str, pending: int):
        """Account + fail a shed submission.  Runs with NO scheduler
        lock held (see submit)."""
        with self._stats_lock:
            self._stats["shed"] += 1
            if reason == "evicted_for_higher_class":
                self._stats["evicted"] += 1
        try:
            self._metrics().sched_shed_total.inc(
                priority=sub.prio.name.lower())
        except Exception:  # noqa: BLE001
            pass
        trace.instant("sched.shed", priority=sub.prio.name.lower(),
                      n=sub.n, reason=reason)
        sub.future._set_exception(SchedulerShedError(
            f"queue full ({pending} items pending): "
            f"{sub.prio.name} submission of {sub.n} shed"))

    def _evict_mempool_locked(self, needed: int):
        """Pop newest-first mempool victims until `needed` fits; the
        caller settles them AFTER releasing _cond."""
        victims: List[Tuple[_Submission, str, int]] = []
        q = self._queues[int(Priority.MEMPOOL)]
        while q and self._pending_items + needed > self.max_pending:
            victim = q.pop()  # newest first
            self._pending_items -= victim.n
            victims.append((victim, "evicted_for_higher_class",
                            self._pending_items))
        return victims

    def flush(self):
        """Close the current window immediately (tests, shutdown paths)."""
        with self._cond:
            self._flush_req = True
            self._cond.notify_all()

    # -- service lifecycle -------------------------------------------------

    def on_start(self):
        # the kernels are built here, on the thread that calls start():
        # an nvcc build failure raises out of start() (and the started
        # flag is rolled back), instead of reaching the executor's rescue
        # on the first window
        try:
            _batch._load_kernels(self.device, self.max_batch,
                                 ("ed25519", "secp256k1", "sr25519"))
        except BaseException:
            with self._mtx:
                self._started = False
            raise
        self.spawn(self._stage_loop, name=f"{self.name}-stage")
        self.spawn(self._exec_loop, name=f"{self.name}-exec")

    def stop(self):
        BaseService.stop(self)   # sets quitting, joins the two workers
        self._fail_outstanding(SchedulerStoppedError(
            f"{self.name} stopped"))

    def on_stop(self):
        with self._cond:
            self._cond.notify_all()

    def _fail_outstanding(self, exc: SchedulerError):
        subs: List[_Submission] = []
        with self._cond:
            for q in self._queues.values():
                subs.extend(q)
                q.clear()
            self._pending_items = 0
        self._publish_depth()
        for sub in subs:
            sub.future._set_exception(exc)
        self._drain_staged(exc)

    def _drain_staged(self, exc: SchedulerError):
        while True:
            try:
                launch = self._staged.get_nowait()
            except _queue.Empty:
                return
            for sub in launch.subs:
                sub.future._set_exception(exc)

    # -- stage side of the pipeline ---------------------------------------

    def _stage_loop(self):
        while not self.quitting.is_set():
            subs = self._collect_window()
            if not subs:
                continue
            try:
                launch = self._stage(subs)
            except Exception as exc:  # noqa: BLE001 - the loop must
                # survive (like _exec_loop): one poisoned window must not
                # kill the stager while running() keeps routing consumers
                # here.  Failing the futures sends sync wrappers to their
                # direct BatchVerifier path.
                for sub in subs:
                    sub.future._set_exception(SchedulerError(
                        f"staging failed: {exc!r}"))
                continue
            if launch is None:
                continue  # everything resolved from cache
            # blocking put = the third batch waits for a buffer slot
            while not self.quitting.is_set():
                try:
                    self._staged.put(launch, timeout=0.1)
                    break
                except _queue.Full:
                    continue
            else:
                for sub in launch.subs:
                    sub.future._set_exception(SchedulerStoppedError(
                        f"{self.name} stopped while staging"))
                continue
            if self.quitting.is_set():
                # stop() may have drained _staged (_fail_outstanding)
                # before our put landed; the exec loop is gone, so drain
                # again ourselves — double-settling is safe (first
                # resolution wins on the future)
                self._drain_staged(SchedulerStoppedError(
                    f"{self.name} stopped while staging"))

    def _collect_window(self) -> List[_Submission]:
        """Block until the window closes (time/size/deadline/flush),
        then drain submissions in priority order up to max_batch items
        (whole submissions; always at least one)."""
        out: List[_Submission] = []
        drained = False
        with self._cond:
            while not self.quitting.is_set():
                if self._pending_items == 0:
                    self._flush_req = False
                    self._cond.wait(0.1)
                    continue
                now = time.monotonic()
                close_at = self._oldest_enq_locked() + self.window_s
                dl = self._min_deadline_locked()
                if dl is not None:
                    close_at = min(close_at, dl)
                if (self._flush_req or now >= close_at
                        or self._pending_items >= self.max_batch):
                    self._flush_req = False
                    out = self._drain_locked()
                    drained = True
                    break
                self._cond.wait(min(max(close_at - now, 0.0005), 0.05))
        if drained:  # gauge published outside _cond (TM201)
            self._publish_depth()
            wc = time.monotonic()
            for sub in out:
                sub.wclose_t = wc
        return out

    def _oldest_enq_locked(self) -> float:
        return min(q[0].enq_t for q in self._queues.values() if q)

    def _min_deadline_locked(self) -> Optional[float]:
        dls = [s.deadline for q in self._queues.values() for s in q
               if s.deadline is not None]
        return min(dls) if dls else None

    def _drain_locked(self) -> List[_Submission]:
        out: List[_Submission] = []
        taken = 0
        for p in sorted(self._queues):
            q = self._queues[p]
            while q and (taken < self.max_batch or not out):
                sub = q.pop(0)
                out.append(sub)
                taken += sub.n
            if taken >= self.max_batch and out:
                break
        self._pending_items -= taken
        return out

    def _stage(self, subs: List[_Submission]) -> Optional[_Launch]:
        """Host staging: hash every triple once, dedupe within the
        launch, resolve SigCache hits immediately, group survivors per
        key scheme.  Runs on the stager thread — overlapped with the
        executor's in-flight launch (the double buffer)."""
        t0 = time.monotonic()
        overlap0 = self._exec_since is not None
        lanes: List[_batch._Item] = []
        keys: List[bytes] = []
        waiters: List[List[Tuple[_Submission, int]]] = []
        lane_of: Dict[bytes, int] = {}
        cache_hits = dedup = 0
        settled: List[_Submission] = []  # fully cache-resolved subs
        with trace.span("sched.coalesce", submissions=len(subs),
                        items=sum(s.n for s in subs)) as sp:
            for sub in subs:
                for i, it in enumerate(sub.items):
                    k = _batch.SigCache.key(it.pub.bytes(), it.msg, it.sig)
                    j = lane_of.get(k)
                    if j is not None:
                        dedup += 1
                        waiters[j].append((sub, i))
                        continue
                    if _batch.verified_sigs.hit_key(k):
                        cache_hits += 1
                        self._resolve(sub, i, True, None,
                                      settled=settled)
                        continue
                    lane_of[k] = len(lanes)
                    lanes.append(it)
                    keys.append(k)
                    waiters.append([(sub, i)])
            by_scheme: Dict[str, List[int]] = {}
            for j, it in enumerate(lanes):
                by_scheme.setdefault(it.pub.type_name, []).append(j)
            if trace.is_enabled():
                sp.add(lanes=len(lanes), dedup=dedup,
                       cache_hits=cache_hits,
                       priorities=",".join(sorted(
                           {s.prio.name.lower() for s in subs})))
            parent = sp.span_id
        dt = time.monotonic() - t0
        overlap1 = self._exec_since is not None
        with self._stats_lock:
            self._stats["cache_hits"] += cache_hits
            self._stats["dedup"] += dedup
            self._stats["stage_s"] += dt
            # endpoint sampling: both ends busy -> fully overlapped, one
            # end -> half; a gauge, not an invoice
            self._stats["stage_overlap_s"] += \
                dt * (0.5 * (overlap0 + overlap1))
        # publish BEFORE firing the settled futures: a waiter returning
        # from result() must already find its request on every surface
        for sub in settled:
            self._account_latency(sub)
        if not lanes:
            # the whole window resolved from SigCache at staging: this
            # IS the window's latency report — there will be no execute
            _set_latency_report(_build_report(
                subs, "sched-cache", 0, stage_s=dt, exec_wait_s=0.0,
                execute_s=0.0, settle_s=0.0))
            self._publish_slo({s.prio.name.lower() for s in subs})
            for sub in settled:
                self._fire(sub)
            return None
        for sub in settled:  # fully-cached subs need not wait for the
            self._fire(sub)  # window's lanes; their report rows come
        #                      from launch.subs in _execute
        launch = _Launch(lanes, keys, waiters, by_scheme, subs, parent,
                         cache_hits, dedup)
        launch.wclose_t = min(s.wclose_t for s in subs)
        launch.staged_t = time.monotonic()
        return launch

    # -- execute side of the pipeline -------------------------------------

    def _exec_loop(self):
        while not self.quitting.is_set():
            try:
                launch = self._staged.get(timeout=0.1)
            except _queue.Empty:
                continue
            t0 = time.monotonic()
            self._exec_since = t0
            try:
                self._execute(launch)
            except degrade.DeviceLaneError as exc:
                # the launch failed on the card outside a chaos drill:
                # its waiters get the error, as a direct caller does —
                # never a host-settled bitmap.  The loop survives and the
                # next window launches on the card again
                self._fail_launch(launch, exc)
            except Exception as exc:  # noqa: BLE001 - loop survives
                # any other fault (the scheduler's own host code, a
                # malformed bitmap): the host settles it only where the
                # runtime would (a CPU lane, a chaos drill); on the card
                # the waiters get the error, and the sync wrappers rerun
                # the work on their direct card path
                if self.device.type != "cuda" or fail.armed():
                    self._count_exec_fault("host")
                    self._resolve_by_host(launch)
                else:
                    self._count_exec_fault("failed")
                    err = SchedulerExecError(
                        f"launch of {len(launch.lanes)} lanes failed on "
                        f"{self.device}: {exc!r}")
                    err.__cause__ = exc
                    self._fail_launch(launch, err)
            finally:
                self._exec_since = None
                dt = time.monotonic() - t0
                with self._stats_lock:
                    self._stats["exec_busy_s"] += dt
                    self._stats["launches"] += 1
                    self._stats["lanes"] += len(launch.lanes)
                self._publish_overlap()

    def _count_exec_fault(self, outcome: str):
        """crypto_sched_exec_fault_total{outcome}: a launch that raised
        past the device lane, settled on the host ("host") or failed to
        its waiters ("failed").  Registered on first use, beside the
        CryptoMetrics families the JAX package also has."""
        with self._stats_lock:
            self._stats["exec_faults"] += 1
        try:
            self._metrics().registry.counter(
                "crypto", "sched_exec_fault_total",
                "VerifyScheduler launches that raised outside the device "
                "lane: outcome=host settled on the host (a CPU lane or a "
                "chaos drill), outcome=failed failed to the waiters (the "
                "card).", labels=("outcome",)).inc(outcome=outcome)
        except Exception:  # noqa: BLE001 - observability must not break
            pass

    def _publish_overlap(self):
        with self._stats_lock:
            staged = self._stats["stage_s"]
            ratio = (self._stats["stage_overlap_s"] / staged) if staged \
                else 0.0
        try:
            self._metrics().sched_overlap_ratio.set(min(ratio, 1.0))
        except Exception:  # noqa: BLE001
            pass

    def _execute(self, launch: _Launch):
        """One coalesced launch through the SAME lane machinery as
        BatchVerifier._verify: host lanes inline, device lanes via the
        degradation runtime (site "sched.<scheme>") on self.device.  A
        CPU lane, or a card lane in a chaos drill, settles every device
        fault on the host with the exact bitmap; a card lane outside a
        drill raises degrade.DeviceLaneError (see _exec_loop)."""
        lanes, by_scheme = launch.lanes, launch.by_scheme
        dev = self.device
        on_card = dev.type == "cuda"
        n = len(lanes)
        out = np.zeros(n, dtype=bool)
        t_exec0 = time.monotonic()
        t_submit0 = min(s.submit_t for s in launch.subs)
        fell_back: List[str] = []  # schemes whose device lane degraded
        with trace.span("sched.launch", parent=launch.parent_span, n=n,
                        schemes=",".join(f"{t}:{len(ix)}"
                                         for t, ix in by_scheme.items()),
                        dedup=launch.dedup,
                        cache_hits=launch.cache_hits) as sp:
            rt = degrade.runtime() \
                if n >= self.tpu_threshold else None
            # latch the flag once: trace.enable() mid-launch must not
            # make the post-collect bracket dereference an unbound seq0
            tracing = trace.is_enabled()
            if tracing:
                # last_launch() is process-global: a launch the runtime
                # abandoned at its deadline on a quarantined lane thread
                # (of this or any verifier) can still record itself inside
                # this bracket.  Beside this window's own record it moves
                # seq by one more and the route attr below is left off;
                # a degraded window (its own launch unrecorded) is never
                # annotated
                from tendermint_tpu_torch.ops import ed25519 as _edops
                seq0 = _edops.last_launch().get("seq", 0)
            device_lanes = []
            host_lanes = []
            for tname, idxs in by_scheme.items():
                items = [lanes[j] for j in idxs]
                verifier = (_batch._device_verifier(tname)
                            if rt is not None else None)
                if (verifier is not None
                        and len(items) >= self.tpu_threshold
                        and _batch._use_device(dev)):
                    if on_card:
                        # built in on_start; a no-op unless RLC was turned
                        # on since (then its kernels build here)
                        try:
                            _batch._load_kernels(dev, len(items),
                                                 (tname,))
                        except Exception as exc:  # noqa: BLE001
                            raise degrade.DeviceLaneError(
                                f"sched.{tname}: kernel build failed: "
                                f"{exc}") from exc
                    if rt.try_acquire():
                        t0 = time.monotonic()
                        fut = rt.submit(
                            f"sched.{tname}", partial(verifier, device=dev),
                            [it.pub.bytes() for it in items],
                            [it.msg for it in items],
                            [it.sig for it in items])
                        done_at = _batch._lane_done_stamp(fut)
                        device_lanes.append((tname, idxs, items, fut,
                                             t0, done_at))
                        continue
                    # breaker open: on the card outside a drill this
                    # raises DeviceLaneError instead of counting a fallback
                    rt.allow_fallback(f"sched.{tname}", "breaker_open",
                                      on_card)
                host_lanes.append((tname, idxs, items))
            if tracing:
                sp.add(device_lanes=len(device_lanes),
                       host_lanes=len(host_lanes))
            lane_times: List[Tuple[str, str, float, float]] = []
            try:
                # assume_miss: the stager already hashed every lane and
                # resolved all SigCache hits without lanes, so the host
                # path's cache pre-pass could only re-prove misses.
                # Host lanes run in this thread, overlapped with the
                # in-flight device lanes (the host-lane pool waits for
                # the schemes that have native host lanes)
                _batch._run_host_lanes(host_lanes, out, "sched.host_lane",
                                       sp.span_id, assume_miss=True,
                                       lane_times=lane_times,
                                       t_submit=t_submit0)
            finally:
                # settle EVERY device lane (same contract as
                # BatchVerifier): any failure re-verifies through host_fn
                # with the exact bitmap — on the card only in a chaos
                # drill, otherwise collect() raises DeviceLaneError (the
                # _mark_fallback wrapper records that this window
                # degraded, so the e2e latency is labeled
                # path="sched-fallback", not mistaken for device speed);
                # a DeviceLaneError is raised once every lane is settled
                card_fault = None
                for tname, idxs, items, fut, t0, done_at in device_lanes:
                    try:
                        out[np.asarray(idxs)] = rt.collect(
                            f"sched.{tname}", fut,
                            host_fn=_mark_fallback(
                                fell_back, tname,
                                partial(_batch._host_verify_items,
                                        tname, items, assume_miss=True)),
                            spot_check=_batch._spot_check_items(items),
                            on_card=on_card)
                    except degrade.DeviceLaneError as e:
                        card_fault = card_fault or e
                        continue
                    lane_times.append((tname, "device", t0,
                                       done_at[0] if done_at
                                       else time.monotonic()))
                if card_fault is not None:
                    raise card_fault
            lane_rep = _batch._publish_lane_report(lane_times, sp,
                                                   rt is not None)
            if tracing and len(device_lanes) == 1 and not fell_back:
                # which route the window's device lane actually took
                # (cuda, or rlc-single when RLC is on).  last_launch() is
                # process-global, so only annotate when exactly OUR
                # launch landed since the bracket started (seq advanced
                # by 1) — a concurrent verifier's record must not
                # mislabel this window.  A degraded lane recorded no
                # launch of its own, so it is never annotated: an
                # abandoned launch finishing on a quarantined thread
                # would move seq by one for it
                rec = _edops.last_launch()
                if rec.get("seq", 0) == seq0 + 1:
                    sp.add(route=rec.get("path"))
        t_exec1 = time.monotonic()
        try:
            self._metrics().sched_batch_size.observe(float(n))
        except Exception:  # noqa: BLE001
            pass
        if fell_back:
            path = "sched-fallback"
        elif device_lanes:
            path = "sched-device"
        else:
            path = "sched-host"
        settled: List[_Submission] = []
        try:
            for j in range(n):
                bit = bool(out[j])
                key = launch.keys[j] if bit else None
                for sub, i in launch.waiters[j]:
                    self._resolve(sub, i, bit, key, path,
                                  settled=settled)
            t_settle = time.monotonic()
            # publication order matters: histograms + report + SLO
            # gauges land BEFORE the futures fire, so a waiter
            # returning from result() (and anything it immediately
            # polls — /debug/latency, /metrics) already reflects its
            # own request.  lane_rep is THIS window's decomposition,
            # not a re-read of the process-global last_lane_report()
            # (a concurrent direct batch could have replaced it).
            for sub in settled:
                self._account_latency(sub)
            _set_latency_report(_build_report(
                launch.subs, path, n,
                stage_s=launch.staged_t - launch.wclose_t,
                exec_wait_s=max(t_exec0 - launch.staged_t, 0.0),
                execute_s=t_exec1 - t_exec0,
                settle_s=t_settle - t_exec1,
                lane_report=lane_rep))
            self._publish_slo({s.prio.name.lower() for s in launch.subs})
        finally:
            # completed submissions fire even if resolution or
            # publication raised mid-way — a raise past this point
            # reaches _exec_loop's rescue (_resolve_by_host on a CPU
            # lane or in a drill, _fail_launch on the card), and a sub
            # whose future never fired would otherwise hang its waiter
            # forever (the re-resolve drives `remaining` negative, so
            # `done` can never trigger again)
            for sub in settled:
                self._fire(sub)

    @staticmethod
    def _fail_launch(launch: _Launch, exc: BaseException):
        """Fail every waiter of a launch whose device lane failed on the
        card: each submission with a triple in it raises `exc` (its
        cache-resolved items are moot, as in a direct call that raised)."""
        for sub in launch.subs:
            sub.future._set_exception(exc)

    def _resolve_by_host(self, launch: _Launch):
        """Last-ditch settlement when _execute itself raised on a CPU
        lane or in a chaos drill: per-item host verification, identical
        semantics (malformed = invalid).  Never on the card outside a
        drill (see _exec_loop)."""
        for j, it in enumerate(launch.lanes):
            try:
                bit = bool(it.pub.verify_signature(it.msg, it.sig))
            except Exception:  # noqa: BLE001 - malformed input = invalid
                bit = False
            for sub, i in launch.waiters[j]:
                self._resolve(sub, i, bit,
                              launch.keys[j] if bit else None,
                              "sched-fallback")
        # a sub that already completed inside the failed _execute has
        # remaining <= 0 now (the re-resolve above decremented past
        # zero), so _resolve's `done` can never fire for it again —
        # force-settle every future.  First resolution wins: for
        # futures _execute or the loop above already fired this is a
        # no-op; for a stranded one, bits are fully populated by the
        # host re-verify above, so no waiter can hang.
        for sub in launch.subs:
            sub.future._set(sub.bits)

    def _resolve(self, sub: _Submission, i: int, bit: bool,
                 key: Optional[bytes], path: str = "sched-cache",
                 settled: Optional[List[_Submission]] = None):
        """Apply one item's verdict.  When the submission completes it
        is stamped and either finished immediately or — when `settled`
        is given — handed back to the caller, which publishes the
        window's latency surfaces BEFORE firing the futures: a waiter
        returning from fut.result() must already find its request in
        the histograms and last_latency_report() (the surfaces would
        otherwise race the woken thread)."""
        if bit and sub.populate_cache and key is not None:
            _batch.verified_sigs.add_key(key)
        with self._res_lock:
            sub.bits[i] = bit
            sub.remaining -= 1
            done = sub.remaining == 0
        if not done:
            return
        # stamp AFTER _res_lock releases; publication never holds a
        # scheduler lock (_account_latency resolves the metrics bundle
        # through degrade.runtime()'s rank-5 install lock — TM201)
        sub.settle_t = time.monotonic()
        sub.path = path
        if settled is not None:
            settled.append(sub)
        else:
            self._account_latency(sub)
            self._fire(sub)

    @staticmethod
    def _fire(sub: _Submission):
        trace.instant("sched.resolve", priority=sub.prio.name.lower(),
                      n=sub.n, valid=int(sub.bits.sum()))
        sub.future._set(sub.bits)

    def _account_latency(self, sub: _Submission):
        """Publish the settled request's lifecycle (ADR-016):
        queue-wait + e2e histograms, deadline-met accounting, SLO
        stream feed.  Runs with NO scheduler lock held."""
        prio = sub.prio.name.lower()
        e2e = sub.settle_t - sub.submit_t
        missed = sub.deadline is not None and sub.settle_t > sub.deadline
        sub.deadline_missed = missed
        slo.observe(prio, e2e)  # no-op unless [slo]/TM_TPU_SLO enabled
        try:
            m = self._metrics()
            if sub.wclose_t:
                m.sched_queue_wait.observe(sub.wclose_t - sub.submit_t,
                                           priority=prio)
            m.verify_e2e_latency.observe(e2e, priority=prio,
                                         path=sub.path)
            if missed:
                m.sched_deadline_miss.inc(priority=prio)
        except Exception:  # noqa: BLE001 - observability must not break
            pass
        if missed:
            trace.instant("sched.deadline_miss", priority=prio, n=sub.n,
                          late_s=round(sub.settle_t - sub.deadline, 6))

    def _publish_slo(self, streams):
        """Refresh the windowed SLO gauges for the priority streams the
        settled window touched.  One read-side pass per launch — the
        per-observation hot path stays a ring store."""
        if not slo.is_enabled():
            return
        try:
            m = self._metrics()
            for s in streams:
                rep = slo.stream_report(s)
                if rep is None:
                    continue
                m.slo_p50.set(rep["p50_s"], stream=s)
                m.slo_p99.set(rep["p99_s"], stream=s)
                if "burn_rate" in rep:
                    m.slo_burn_rate.set(rep["burn_rate"], stream=s)
        except Exception:  # noqa: BLE001 - observability must not break
            pass

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        s["pending_items"] = self._pending_items
        s["mean_batch"] = (s["lanes"] / s["launches"]) if s["launches"] \
            else 0.0
        s["overlap_ratio"] = (s["stage_overlap_s"] / s["stage_s"]) \
            if s["stage_s"] else 0.0
        return s

    def sync_timeout(self) -> float:
        """Bound for sync wrappers: worst case is a full window plus a
        device launch that times out and re-verifies on the host."""
        return 2 * degrade.runtime().cfg.launch_timeout_s + \
            self.window_s + 30.0


# ---------------------------------------------------------------------------
# process-global instance + the consumer-facing convenience API
# ---------------------------------------------------------------------------

_global: Optional[VerifyScheduler] = None
_global_lock = threading.Lock()
_prio_ctx = threading.local()


def install(s: VerifyScheduler) -> VerifyScheduler:
    """Install `s` as the process-global scheduler (node assembly /
    tests).  Returns it for chaining."""
    global _global
    with _global_lock:
        _global = s
        return s


def uninstall(s: Optional[VerifyScheduler] = None):
    """Remove the global scheduler (only if it is `s`, when given)."""
    global _global
    with _global_lock:
        if s is None or _global is s:
            _global = None


def installed() -> Optional[VerifyScheduler]:
    with _global_lock:
        return _global


def running() -> Optional[VerifyScheduler]:
    """The global scheduler iff it is started — call sites route through
    it exactly when this is non-None."""
    s = installed()
    return s if s is not None and s.is_running() else None


@contextmanager
def priority_context(prio: Priority, deadline: Optional[float] = None):
    """Tag verify work issued on this thread (deep call stacks —
    light/verifier -> validator_set -> verify_sigs_bulk — where passing
    a priority argument through would ripple every signature)."""
    prev = getattr(_prio_ctx, "val", None)
    _prio_ctx.val = (Priority(prio), deadline)
    try:
        yield
    finally:
        _prio_ctx.val = prev


def context_priority(default: Priority) -> Tuple[Priority, Optional[float]]:
    val = getattr(_prio_ctx, "val", None)
    return val if val is not None else (Priority(default), None)


def running_on(device) -> Optional[VerifyScheduler]:
    """The running global scheduler iff it launches on `device` (a
    resolved torch.device) — a caller on another device takes its direct
    path."""
    s = running()
    return s if s is not None and s.device == device else None


def verify_items(items: Sequence, prio: Priority = Priority.COMMIT,
                 deadline: Optional[float] = None,
                 populate_cache: bool = True,
                 device=None,
                 coordinated: bool = False) -> Tuple[bool, np.ndarray]:
    """Drop-in synchronous wrapper with BatchVerifier.verify()'s exact
    (all_valid, bitmap) contract.  Routes through the global scheduler
    when it is running on the caller's device; otherwise — or if the
    scheduler sheds, stops, or times out mid-flight — verifies directly
    through a private BatchVerifier, so callers never observe a behavior
    change.  The device is resolved first: no CUDA and no request for
    the CPU raises RuntimeError, scheduler or not.  A launch that failed
    on the card raises degrade.DeviceLaneError here, as the direct path
    does.

    coordinated=True: the caller is inside a sharding.lockstep() window
    (every process of a multi-process runtime walks this exact call,
    ADR-027) — SKIP the scheduler, whose coalescing would merge
    process-local traffic into the batch and break the cross-process
    shape agreement the global plane's collective requires."""
    dev = resolve_device(device)
    s = None if coordinated else running_on(dev)
    if s is not None:
        try:
            fut = s.submit(items, prio, deadline=deadline,
                           populate_cache=populate_cache)
            bits = fut.result(timeout=s.sync_timeout())
            return bool(bits.all()), bits
        except (SchedulerError, TimeoutError):
            pass
    bv = _batch.BatchVerifier(device=device)
    for pub, msg, sig in items:
        if not isinstance(pub, PubKey):
            pub = _ed.PubKey(bytes(pub))
        bv.add(pub, msg, sig)
    return bv.verify()
