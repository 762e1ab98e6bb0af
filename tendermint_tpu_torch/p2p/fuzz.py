"""Fuzzed connection wrapper for network chaos testing
(reference p2p/fuzz.go FuzzedConnection: probabilistically drop or delay
traffic on a live connection, config-driven, activating after a start
delay).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass


@dataclass
class FuzzConnConfig:
    """Reference config/config.go FuzzConnConfig defaults."""
    mode_drop: bool = True         # drop whole frames
    mode_delay: bool = True        # sleep before delivery
    max_delay_s: float = 3.0
    prob_drop_rw: float = 0.2
    prob_sleep: float = 0.0
    start_after_s: float = 0.0     # fuzz only after this much uptime


class FuzzedConnection:
    """Wraps any object with send_frame/recv_frame/close (SecretConnection
    or a plain framed socket adapter); same interface out."""

    def __init__(self, conn, config: FuzzConnConfig | None = None,
                 rng: random.Random | None = None):
        self.conn = conn
        self.config = config or FuzzConnConfig()
        self._rng = rng or random.Random()
        self._born = time.monotonic()
        self._lock = threading.Lock()
        self.dropped_frames = 0

    def _active(self) -> bool:
        return (time.monotonic() - self._born) >= self.config.start_after_s

    def _fuzz(self) -> bool:
        """Returns True if the frame should be DROPPED."""
        if not self._active():
            return False
        c = self.config
        if c.mode_delay and c.prob_sleep > 0 \
                and self._rng.random() < c.prob_sleep:
            time.sleep(self._rng.uniform(0, c.max_delay_s))
        if c.mode_drop and self._rng.random() < c.prob_drop_rw:
            with self._lock:
                self.dropped_frames += 1
            return True
        return False

    def send_frame(self, data: bytes) -> None:
        if self._fuzz():
            return  # silently dropped
        self.conn.send_frame(data)

    def recv_frame(self) -> bytes:
        while True:
            frame = self.conn.recv_frame()
            if not self._fuzz():
                return frame
            # dropped: read the next frame

    def close(self):
        self.conn.close()

    def __getattr__(self, name):
        return getattr(self.conn, name)
