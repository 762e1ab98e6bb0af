"""Flight recorder: low-overhead span tracing for the verify hot path.

The counterpart of tendermint_tpu/libs/trace.py: a process-global tracer
holding a bounded ring buffer of spans (monotonic-clock start + duration,
parent linkage, key=value attrs), exported in the Chrome-trace /
Perfetto JSON event format so any trace viewer renders the timeline.
It answers "where did THIS batch spend its time, and which path did it
take" beside the counters of libs/metrics.py.

Design constraints, in order:

  1. Disabled is a guaranteed no-op.  Tracing is OFF by default; every
     call site goes through ``span()`` / ``instant()`` unconditionally,
     so the disabled path is one enabled check and one singleton return
     (no allocation beyond the kwargs dict, no locks, no clock reads).
  2. Bounded memory.  A ring buffer (default 8192 finished spans)
     overwrites the oldest records; a forgotten enable can never run
     the process out of memory.
  3. Causal linkage across threads.  Spans nest per-thread via a
     thread-local stack; cross-thread handoffs (the device-lane worker,
     crypto/degrade.py) pass the parent span id explicitly, so the
     batch -> launch -> verdict chain is one connected tree even though
     it crosses the lane-worker boundary.

Enable programmatically (``trace.enable()``), via ``TM_TPU_TRACE=1`` in
the environment (capacity override: ``TM_TPU_TRACE_CAPACITY``), or not
at all.  Read it back with ``snapshot()``, ``chrome_trace()`` or
``export_file()``.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


_UNSET = object()  # sentinel: "inherit parent from the thread's stack"

# ---------------------------------------------------------------------------
# the span-name registry.  Every literal name passed to trace.span() /
# trace.instant() in the package appears here: trace consumers key on
# these strings, so an unregistered name is either a typo or an
# undocumented contract.  Grouped by module.
# ---------------------------------------------------------------------------

KNOWN_SPANS = frozenset({
    # crypto/batch.py — the BatchVerifier coalesce window
    "batch.host_lane", "batch.verdict", "batch.verify",
    # crypto/degrade.py — breaker + device lane lifecycle
    "breaker.transition", "device.collect", "device.host_fallback",
    "device.launch",
    # ops/ — kernel routing
    "msm.route", "ops.ed25519.verify_batch",
})


class _NoopSpan:
    """The disabled path: one shared instance, every method a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **attrs):
        return self

    span_id = None


_NOOP = _NoopSpan()


class _Span:
    """A live span.  Created only while the tracer is enabled; records
    itself into the ring on __exit__ (even if the tracer was disabled
    mid-span — the span was paid for, keep it)."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id",
                 "_t0", "_tid", "_tname")

    def __init__(self, tracer: "Tracer", name: str, parent, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.parent_id = parent
        self.span_id = None

    def add(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tr = self._tracer
        self.span_id = next(tr._ids)
        t = threading.current_thread()
        self._tid = t.ident
        self._tname = t.name
        stack = tr._stack()
        if self.parent_id is _UNSET:
            self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, etype, evalue, tb):
        dur = time.monotonic_ns() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # mis-nested exit: drop up to and incl. self
            del stack[stack.index(self):]
        if etype is not None:
            self.attrs["error"] = etype.__name__
        self._tracer._record(self.name, "X", self._t0, dur, self._tid,
                             self._tname, self.span_id, self.parent_id,
                             self.attrs)
        return False


class Tracer:
    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("TM_TPU_TRACE", "") == "1"
        if capacity is None:  # env tunes the DEFAULT only — an explicit
            # constructor argument (private test tracers) always wins.
            # A malformed value falls back: the module is imported by
            # every hot-path module, so a bad env var must never keep
            # the node from starting
            try:
                capacity = int(os.environ.get("TM_TPU_TRACE_CAPACITY",
                                              8192))
            except (ValueError, TypeError):
                capacity = 8192
        capacity = max(1, capacity)
        self._enabled = enabled
        self._lock = threading.Lock()
        self._buf: "collections.deque" = collections.deque(maxlen=capacity)
        self._seq = 0
        self._dropped = 0          # spans lost to ring wraparound
        self._drop_counter = None  # lazy TraceMetrics handle
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # -- state -------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: Optional[int] = None):
        with self._lock:
            if capacity is not None and capacity != self._buf.maxlen:
                self._buf = collections.deque(self._buf, maxlen=capacity)
        self._enabled = True

    def disable(self):
        self._enabled = False

    def reset(self):
        """Drop buffered spans.  seq stays monotonic so `since` cursors
        held by pollers remain valid across a reset."""
        with self._lock:
            self._buf.clear()

    # -- recording ---------------------------------------------------------

    def _stack(self) -> List[_Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, parent=_UNSET, **attrs):
        """Context manager for a timed span.  `parent` overrides the
        thread-local nesting (pass a span id for cross-thread linkage;
        None for an explicit root)."""
        if not self._enabled:
            return _NOOP
        return _Span(self, name, parent, attrs)

    def instant(self, name: str, **attrs):
        """A zero-duration marker event (Chrome-trace ph="i")."""
        if not self._enabled:
            return
        t = threading.current_thread()
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        self._record(name, "i", time.monotonic_ns(), 0, t.ident, t.name,
                     next(self._ids), parent, attrs)

    def current(self):
        """The innermost live span on this thread (no-op span when
        tracing is disabled or no span is open) — call sites deeper in
        the stack attach attrs to it (e.g. the device route picked
        inside ops/)."""
        if not self._enabled:
            return _NOOP
        stack = self._stack()
        return stack[-1] if stack else _NOOP

    def current_id(self) -> Optional[int]:
        """Span id to hand a worker thread as explicit parent."""
        if not self._enabled:
            return None
        stack = self._stack()
        return stack[-1].span_id if stack else None

    def _record(self, name, ph, t0_ns, dur_ns, tid, tname, span_id,
                parent_id, attrs):
        with self._lock:
            self._seq += 1
            wrapped = len(self._buf) == self._buf.maxlen
            if wrapped:
                self._dropped += 1
            self._buf.append({
                "seq": self._seq, "name": name, "ph": ph, "ts_ns": t0_ns,
                "dur_ns": dur_ns, "tid": tid, "tname": tname,
                "id": span_id, "parent": parent_id, "attrs": attrs,
            })
        if wrapped:
            # counter inc AFTER releasing: publishing takes the metric's
            # own lock, which must never nest inside the tracer lock
            self._publish_drop()

    def _publish_drop(self):
        c = self._drop_counter
        if c is None:
            try:
                from tendermint_tpu_torch.libs.metrics import TraceMetrics
                c = TraceMetrics().dropped_spans
            except Exception:  # noqa: BLE001 - observability of the
                c = False       # observer must never take down a span
            self._drop_counter = c
        if c is not False:
            try:
                c.inc()
            except Exception:  # noqa: BLE001
                pass

    def dropped(self) -> int:
        """Spans lost to ring wraparound since construction (a wrapped
        ring can no longer masquerade as a quiet system)."""
        with self._lock:
            return self._dropped

    # -- export ------------------------------------------------------------

    def snapshot(self, since: int = 0) -> List[Dict[str, Any]]:
        """Finished records with seq > since, oldest first (copies — the
        ring keeps mutating underneath)."""
        return self._snapshot(since)[0]

    def _snapshot(self, since: int):
        """(records, seq) read in ONE critical section: a poller's next
        `since` cursor must equal the seq of the newest record it was
        actually handed, or spans recorded between two separate lock
        acquisitions would be skipped forever."""
        with self._lock:
            return ([dict(r, attrs=dict(r["attrs"]))
                     for r in self._buf if r["seq"] > since], self._seq)

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def chrome_trace(self, since: int = 0) -> Dict[str, Any]:
        """The buffer as a Chrome-trace / Perfetto JSON object
        (chrome://tracing, ui.perfetto.dev).  `last_seq` lets pollers
        fetch incrementally via ?since=."""
        pid = os.getpid()
        records, last = self._snapshot(since)
        events = []
        for r in records:
            args = dict(r["attrs"])
            args["id"] = r["id"]
            if r["parent"] is not None:
                args["parent"] = r["parent"]
            args["seq"] = r["seq"]
            if r["tname"]:
                args["thread"] = r["tname"]
            ev = {"name": r["name"], "ph": r["ph"], "pid": pid,
                  "tid": r["tid"], "ts": r["ts_ns"] / 1000.0, "args": args}
            if r["ph"] == "X":
                ev["dur"] = r["dur_ns"] / 1000.0
            else:
                ev["s"] = "t"
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "last_seq": last, "dropped_spans": self.dropped()}

    def export_file(self, path: str, since: int = 0) -> str:
        """Write the Chrome-trace JSON to `path`; returns `path`.
        Attr values are stringified when not JSON-native, so a span that
        stashed an odd object can never make the artifact unwritable."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(since), f, default=str)
        return path


# ---------------------------------------------------------------------------
# the process-global tracer (one per process, same convention as
# libs/metrics.DEFAULT); tests may build private Tracer instances
# ---------------------------------------------------------------------------

TRACER = Tracer()


def span(name: str, parent=_UNSET, **attrs):
    t = TRACER
    if not t._enabled:
        return _NOOP
    return _Span(t, name, parent, attrs)


def instant(name: str, **attrs):
    if TRACER._enabled:
        TRACER.instant(name, **attrs)


def is_enabled() -> bool:
    return TRACER._enabled


def enable(capacity: Optional[int] = None):
    TRACER.enable(capacity)


def disable():
    TRACER.disable()


def reset():
    TRACER.reset()


def current():
    return TRACER.current()


def current_id() -> Optional[int]:
    return TRACER.current_id()


def snapshot(since: int = 0):
    return TRACER.snapshot(since)


def last_seq() -> int:
    return TRACER.last_seq()


def dropped() -> int:
    return TRACER.dropped()


def chrome_trace(since: int = 0):
    return TRACER.chrome_trace(since)


def export_file(path: str, since: int = 0) -> str:
    return TRACER.export_file(path, since)
