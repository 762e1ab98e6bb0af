"""EWMA peer trust metric (reference p2p/trust/metric.go).

Tracks good/bad events per peer over fixed intervals and produces a trust
value in [0, 1] as the reference does: R = a*P + b*I + c*D with
proportional (current-interval ratio), integral (history average), and a
derivative term that only penalizes downward movement
(metric.go calcTrustValue: weights a=0.4, b=0.6, derivative weight
d in [0, 1] scaled by the proportional drop).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

INTERVAL_S = 30.0          # metric.go default interval
MAX_HISTORY = 16           # history slots aggregated into I


class TrustMetric:
    def __init__(self, interval_s: float = INTERVAL_S,
                 max_history: int = MAX_HISTORY):
        self.interval_s = interval_s
        self.max_history = max_history
        self._lock = threading.Lock()
        self._good = 0.0
        self._bad = 0.0
        self._history: List[float] = []
        self._interval_start = time.monotonic()
        self._last_value = 1.0

    def good_events(self, n: float = 1.0):
        with self._lock:
            self._maybe_roll()
            self._good += n

    def bad_events(self, n: float = 1.0):
        with self._lock:
            self._maybe_roll()
            self._bad += n

    def _maybe_roll(self):
        now = time.monotonic()
        while now - self._interval_start >= self.interval_s:
            p = self._proportional()
            self._history.append(p)
            if len(self._history) > self.max_history:
                self._history.pop(0)
            # derivative anchor: previous interval's closing ratio (NOT
            # mutated on reads — value() must be a pure observation)
            self._last_value = p
            self._good = 0.0
            self._bad = 0.0
            self._interval_start += self.interval_s

    def _proportional(self) -> float:
        total = self._good + self._bad
        return self._good / total if total > 0 else 1.0

    def _integral(self) -> float:
        if not self._history:
            return 1.0
        # reference weights recent history more (faded memory); simple
        # linearly-weighted average, newest heaviest
        weights = range(1, len(self._history) + 1)
        return (sum(w * v for w, v in zip(weights, self._history))
                / sum(weights))

    def value(self) -> float:
        """Trust in [0, 1] (reference calcTrustValue).  Pure read: the
        derivative compares the current interval's ratio against the
        PREVIOUS interval's closing ratio (updated only on interval
        roll), so repeated reads are stable."""
        with self._lock:
            self._maybe_roll()
            p = self._proportional()
            i = self._integral()
            d = p - self._last_value
            deriv = 0.0 if d >= 0 else d  # only punish decline
            return max(0.0, min(1.0, 0.4 * p + 0.6 * i + 0.2 * deriv))


class TrustMetricStore:
    """Per-peer metric registry (reference p2p/trust/store.go); PEX asks
    it when ranking addresses and the switch feeds it on peer errors.
    Bounded: least-recently-touched metrics are evicted past max_size (a
    churning PEX address space must not leak one metric per id ever
    seen)."""

    MAX_SIZE = 4096

    def __init__(self, interval_s: float = INTERVAL_S,
                 max_size: int = MAX_SIZE):
        from collections import OrderedDict
        self.interval_s = interval_s
        self.max_size = max_size
        self._metrics: "OrderedDict[str, TrustMetric]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, peer_id: str) -> TrustMetric:
        with self._lock:
            m = self._metrics.get(peer_id)
            if m is None:
                m = TrustMetric(self.interval_s)
                self._metrics[peer_id] = m
                while len(self._metrics) > self.max_size:
                    self._metrics.popitem(last=False)
            else:
                self._metrics.move_to_end(peer_id)
            return m

    def peer_trust(self, peer_id: str) -> float:
        with self._lock:
            m = self._metrics.get(peer_id)
        return m.value() if m is not None else 1.0

    def size(self) -> int:
        with self._lock:
            return len(self._metrics)
