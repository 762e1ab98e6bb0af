"""Sliding-window latency quantiles + SLO burn rates for the verify
path (the counterpart of tendermint_tpu/libs/slo.py).

The metrics histograms (libs/metrics.py) answer "what is the lifetime
latency distribution" — cumulative buckets that never forget.  The SLO
questions the mempool-ingress and light-client-service workloads are
specified against are *windowed*: what is p99 over the last N requests,
and how fast is the error budget burning RIGHT NOW.  This module is
that estimator: one bounded ring of float seconds per stream (a stream
is a priority class: "consensus", "commit", "blocksync", "mempool"),
with quantiles and burn rates computed from the ring contents on
demand.

Design constraints, in trace.py's order:

  1. Disabled is a guaranteed no-op.  SLO tracking is OFF by default;
     the scheduler and the direct verify path call ``observe()``
     unconditionally, so the disabled path must cost less than a
     microsecond (one enabled check, one return — no locks, no clock
     reads, no allocation).  Enable with ``TM_TPU_SLO=1``, the node's
     ``[slo]`` config section, or ``slo.enable()``.
  2. Bounded memory, no numpy on the hot path.  Each stream is a
     preallocated Python-float ring (default 1024 entries,
     ``TM_TPU_SLO_WINDOW``); ``observe()`` is one lock, one store, one
     index increment.  Sorting happens only at report time.
  3. Exact over the window.  Quantiles are nearest-rank over the ring's
     current contents — identical to a sorted-array oracle of the last
     ``window`` observations, wraparound included.

Burn rate: a per-stream p99 target (seconds) turns the ring into an
error-budget gauge — ``burn_rate = (fraction of windowed observations
over target) / budget``, where ``budget`` defaults to the p99
convention (0.01: 1% of requests may exceed the target) and is
per-stream configurable via ``[slo] <stream>_budget_pct``.  1.0 means
the stream is spending its budget exactly as fast as the SLO allows;
10 means a page.  The targets themselves are published as the
``tendermint_crypto_slo_target_seconds{stream}`` gauge so consumers
(the adaptive control plane, dashboards) read them from metrics, not
magic constants.

Read it back via ``slo.report()``.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional

_DEFAULT_WINDOW = 1024

# the default error budget the burn rate is computed against: a p99
# target budgets 1% of requests over it.  Per-stream overrides come
# from the [slo] <stream>_budget_pct config fields (as fractions here)
_P99_BUDGET = 0.01


class _Stream:
    """One bounded ring of observed seconds.  Mutated only under the
    estimator lock."""

    __slots__ = ("buf", "idx", "count")

    def __init__(self, window: int):
        self.buf: List[float] = [0.0] * window
        self.idx = 0
        self.count = 0  # lifetime observations (>= window once wrapped)


def _nearest_rank(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile: the smallest value with at least q*n of
    the window at or below it (the sorted-array oracle definition the
    property test uses)."""
    n = len(sorted_vals)
    k = max(1, math.ceil(q * n))
    return sorted_vals[min(k, n) - 1]


class SloEstimator:
    """See the module docstring.  One process-global instance (the
    module-level functions); tests may build private instances."""

    def __init__(self, window: Optional[int] = None,
                 targets: Optional[Dict[str, float]] = None,
                 enabled: Optional[bool] = None,
                 budgets: Optional[Dict[str, float]] = None):
        if enabled is None:
            enabled = os.environ.get("TM_TPU_SLO", "") == "1"
        if window is None:
            # malformed env falls back: this module is imported by the
            # verify hot path, a bad env var must never stop the node
            try:
                window = int(os.environ.get("TM_TPU_SLO_WINDOW",
                                            _DEFAULT_WINDOW))
            except (ValueError, TypeError):
                window = _DEFAULT_WINDOW
        self.window = max(1, int(window))
        # stream -> p99 target in SECONDS (config carries ms; the node
        # wiring converts)
        self.targets: Dict[str, float] = dict(targets or {})
        # stream -> error-budget FRACTION (config carries percent; the
        # node wiring divides by 100).  Missing streams fall back to
        # the p99 convention (_P99_BUDGET)
        self.budgets: Dict[str, float] = dict(budgets or {})
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._streams: Dict[str, _Stream] = {}

    # -- state -------------------------------------------------------------

    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self, window: Optional[int] = None,
               targets: Optional[Dict[str, float]] = None,
               budgets: Optional[Dict[str, float]] = None):
        with self._lock:
            if window is not None and int(window) != self.window:
                self.window = max(1, int(window))
                self._streams.clear()  # rings are sized at creation
            if targets is not None:
                self.targets = dict(targets)
            if budgets is not None:
                self.budgets = dict(budgets)
        self._enabled = True

    def disable(self):
        self._enabled = False

    def set_config(self, enabled: Optional[bool] = None,
                   window: Optional[int] = None,
                   targets: Optional[Dict[str, float]] = None,
                   budgets: Optional[Dict[str, float]] = None):
        """Apply config without touching the enabled flag unless asked
        (enable() unconditionally arms; this must not — see the
        module-level set_config)."""
        with self._lock:
            if window is not None and int(window) != self.window:
                self.window = max(1, int(window))
                self._streams.clear()  # rings are sized at creation
            if targets is not None:
                self.targets = dict(targets)
            if budgets is not None:
                self.budgets = dict(budgets)
        if enabled is not None:
            self._enabled = bool(enabled)

    def reset(self):
        with self._lock:
            self._streams.clear()

    # -- the hot path ------------------------------------------------------

    def observe(self, stream: str, seconds: float):
        """Record one latency sample.  Guaranteed no-op when disabled
        (the enabled check is the FIRST statement)."""
        if not self._enabled:
            return
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                st = self._streams[stream] = _Stream(self.window)
            st.buf[st.idx] = float(seconds)
            st.idx = (st.idx + 1) % self.window
            st.count += 1

    # -- read-side (report time, never the verify path) --------------------

    def window_values(self, stream: str) -> List[float]:
        """Copy of the stream's current window contents (unordered)."""
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                return []
            if st.count >= self.window:
                return list(st.buf)
            return st.buf[:st.idx]

    def quantile(self, stream: str, q: float) -> Optional[float]:
        vals = sorted(self.window_values(stream))
        if not vals:
            return None
        return _nearest_rank(vals, q)

    def stream_report(self, stream: str) -> Optional[dict]:
        vals = sorted(self.window_values(stream))
        if not vals:
            return None
        n = len(vals)
        out = {
            "n": n,
            "window": self.window,
            "p50_s": _nearest_rank(vals, 0.50),
            "p90_s": _nearest_rank(vals, 0.90),
            "p99_s": _nearest_rank(vals, 0.99),
            "max_s": vals[-1],
            "mean_s": sum(vals) / n,
        }
        target = self.targets.get(stream)
        if target is not None and target > 0:
            budget = self.budgets.get(stream, _P99_BUDGET)
            if not (budget > 0):
                budget = _P99_BUDGET
            over = sum(1 for v in vals if v > target)
            out["target_p99_s"] = target
            out["budget"] = budget
            out["over_target_frac"] = over / n
            out["burn_rate"] = (over / n) / budget
        return out

    def report(self) -> dict:
        with self._lock:
            streams = list(self._streams)
        return {
            "enabled": self._enabled,
            "window": self.window,
            "targets_s": dict(self.targets),
            "budgets": dict(self.budgets),
            "streams": {s: self.stream_report(s) for s in sorted(streams)},
        }


# ---------------------------------------------------------------------------
# the process-global estimator (one node per process, same convention
# as libs/metrics.DEFAULT and libs/trace.TRACER)
# ---------------------------------------------------------------------------

EST = SloEstimator()


def observe(stream: str, seconds: float):
    est = EST
    if not est._enabled:  # the sub-microsecond disabled path
        return
    est.observe(stream, seconds)


def is_enabled() -> bool:
    return EST._enabled


def _publish_targets():
    """Publish the GLOBAL estimator's per-stream targets as the
    crypto_slo_target_seconds{stream} gauge (report-time only, never
    the observe() hot path).  Consumers — the adaptive control plane
    dashboards — read targets from metrics, not from this
    module's internals."""
    targets = dict(EST.targets)
    if not targets:
        return
    from tendermint_tpu_torch.libs.metrics import CryptoMetrics
    m = CryptoMetrics()
    for stream, target in targets.items():
        m.slo_target.set(float(target), stream=stream)


def enable(window: Optional[int] = None,
           targets: Optional[Dict[str, float]] = None,
           budgets: Optional[Dict[str, float]] = None):
    EST.enable(window=window, targets=targets, budgets=budgets)
    _publish_targets()


def disable():
    EST.disable()


def reset():
    EST.reset()


def quantile(stream: str, q: float) -> Optional[float]:
    return EST.quantile(stream, q)


def stream_report(stream: str) -> Optional[dict]:
    return EST.stream_report(stream)


def report() -> dict:
    return EST.report()


def set_config(enabled: Optional[bool] = None,
               window: Optional[int] = None,
               targets: Optional[Dict[str, float]] = None,
               budgets: Optional[Dict[str, float]] = None):
    """Node wiring ([slo] config section): the operator's config wins
    over a stale env var in BOTH directions (mirrors
    ops/secp.set_lane_enabled and edops.set_comb_config).  None leaves
    a dimension untouched.  Never routes through enable(): configuring
    a DISABLED estimator must not open even a transient window where a
    concurrent observe() records into it."""
    EST.set_config(enabled=enabled, window=window, targets=targets,
                   budgets=budgets)
    _publish_targets()
