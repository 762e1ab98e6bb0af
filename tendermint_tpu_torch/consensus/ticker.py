"""Timeout ticker (reference consensus/ticker.go): schedules one pending
timeout at a time; a newer schedule replaces the old one (the state machine
only ever waits for its current (H,R,S)).

Replacement is generation-gated: threading.Timer.cancel() cannot stop a
timer whose callback already started, so without the generation check a
stale timer racing a replacement could still deliver its old TimeoutInfo
AFTER the newer schedule — the state machine would process a timeout for
an (H,R,S) it already left.  _fire only delivers when its generation is
still current, so the newest schedule always wins and a stale fire is
dropped (the harness's proposer-kill scenarios lean on this ordering).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from .round_types import Step, TimeoutInfo


class TimeoutTicker:
    def __init__(self, on_timeout: Callable[[TimeoutInfo], None]):
        self._on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self._stopped = False
        self._gen = 0

    def schedule(self, ti: TimeoutInfo):
        with self._lock:
            if self._stopped:
                return
            if self._timer is not None:
                self._timer.cancel()
            self._gen += 1
            self._timer = threading.Timer(
                ti.duration, self._fire, args=(ti, self._gen))
            self._timer.daemon = True
            self._timer.start()

    def _fire(self, ti: TimeoutInfo, gen: int):
        with self._lock:
            if self._stopped or gen != self._gen:
                return  # replaced (or stopped) while we were queued
        self._on_timeout(ti)

    def stop(self):
        with self._lock:
            self._stopped = True
            self._gen += 1  # any in-flight fire is now stale
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
