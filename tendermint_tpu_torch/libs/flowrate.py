"""Flow-rate measurement + token-bucket throttling
(reference libs/flowrate/flowrate.go, used by MConnection's send/recv
routines at p2p/conn/connection.go:43-44 with 500 KB/s defaults).
"""
from __future__ import annotations

import threading
import time


class Monitor:
    """Measures transfer rate (EMA) and optionally enforces a byte/s limit
    by sleeping the caller (reference flowrate.Monitor + Limit)."""

    def __init__(self, limit_bytes_per_s: int = 0, ema_alpha: float = 0.2):
        self.limit = limit_bytes_per_s
        self._alpha = ema_alpha
        self._lock = threading.Lock()
        self._total = 0
        self._rate = 0.0
        self._window_start = time.monotonic()
        self._window_bytes = 0
        self._bucket = float(limit_bytes_per_s)  # burst = 1s of tokens
        self._bucket_t = time.monotonic()

    def update(self, n: int) -> float:
        """Record n transferred bytes; blocks to enforce the limit.
        Returns the seconds slept so callers can account throttle
        stall (p2p/netobs.py) — 0.0 when the bucket had tokens."""
        sleep_for = 0.0
        with self._lock:
            self._total += n
            self._window_bytes += n
            now = time.monotonic()
            dt = now - self._window_start
            if dt >= 0.1:
                inst = self._window_bytes / dt
                self._rate = (self._alpha * inst
                              + (1 - self._alpha) * self._rate)
                self._window_start = now
                self._window_bytes = 0
            if self.limit > 0:
                self._bucket = min(
                    float(self.limit),
                    self._bucket + (now - self._bucket_t) * self.limit)
                self._bucket_t = now
                self._bucket -= n
                if self._bucket < 0:
                    sleep_for = -self._bucket / self.limit
        if sleep_for > 0:
            # sleep the FULL deficit: capping here would let oversized
            # updates (e.g. 32 MB frames vs a 5 MB/s limit) stream faster
            # than the configured rate while the debt grows unboundedly
            time.sleep(sleep_for)
        return sleep_for

    def rate(self) -> float:
        with self._lock:
            return self._rate

    def total(self) -> int:
        with self._lock:
            return self._total
