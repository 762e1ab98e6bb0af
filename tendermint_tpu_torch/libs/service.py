"""Service lifecycle (reference libs/service/service.go BaseService).

The counterpart of tendermint_tpu/libs/service.py.  A BaseService owns
the start/stop state machine — idempotence, the started/stopped error
cases, the quit event — so concrete services only implement
on_start/on_stop.  `spawn` tracks daemon routine threads that exit with
the service.

    class Ticker(BaseService):
        def on_start(self):
            self.spawn(self._run, name="ticker")
        def _run(self):
            while not self.quitting.wait(1.0):
                ...

The port's user is crypto/scheduler.VerifyScheduler (its stager and
executor threads); the node's components wait for their ports.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional


class ServiceError(Exception):
    pass


class AlreadyStartedError(ServiceError):
    """Reference service.go ErrAlreadyStarted."""


class AlreadyStoppedError(ServiceError):
    """Reference service.go ErrAlreadyStopped."""


class BaseService:
    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__
        self.quitting = threading.Event()   # the reference's Quit channel
        self._started = False
        self._stopped = False
        self._mtx = threading.Lock()
        self._threads: List[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Reference service.go:141 Start: error when already started or
        already stopped (a stopped service must be reset, not restarted)."""
        with self._mtx:
            if self._stopped:
                raise AlreadyStoppedError(
                    f"{self.name}: already stopped (reset to restart)")
            if self._started:
                raise AlreadyStartedError(f"{self.name}: already started")
            self._started = True
        self.on_start()

    def stop(self) -> None:
        """Reference service.go:171 Stop: idempotent from the caller's
        view once started; signals quitting and joins spawned routines."""
        with self._mtx:
            if self._stopped or not self._started:
                self._stopped = True
                return
            self._stopped = True
        self.quitting.set()
        self.on_stop()
        for t in self._threads:
            t.join(timeout=2.0)

    def reset(self) -> None:
        """Reference service.go:205 Reset: back to startable."""
        with self._mtx:
            if self._started and not self._stopped:
                raise ServiceError(f"{self.name}: reset while running")
            self._started = False
            self._stopped = False
        self.quitting = threading.Event()
        self._threads = []

    def is_running(self) -> bool:
        with self._mtx:
            return self._started and not self._stopped

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the service quits (reference Wait)."""
        return self.quitting.wait(timeout)

    # -- hooks -------------------------------------------------------------

    def on_start(self) -> None:  # pragma: no cover - trivial default
        pass

    def on_stop(self) -> None:  # pragma: no cover - trivial default
        pass

    def spawn(self, fn: Callable, *args, name: str = "") -> threading.Thread:
        """Run fn(*args) on a daemon thread tracked by stop()."""
        t = threading.Thread(target=fn, args=args, daemon=True,
                             name=name or f"{self.name}-routine")
        self._threads.append(t)
        t.start()
        return t
