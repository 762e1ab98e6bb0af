"""Structured leveled logging (reference libs/log/tm_logger.go).

The reference logs key-value pairs through a leveled, module-tagged
logger with lazy evaluation on hot paths (reference
consensus/state.go:1647 uses log.NewLazyBlockHash so the hash is only
computed if the debug level is on).  This module is the same shape on
Python's stdlib logging backbone:

    log = tmlog.logger("consensus")
    log.info("entering new round", height=h, round=r)
    log.debug("block hash", hash=tmlog.Lazy(block.hash))  # not computed
                                                          # unless enabled

Lines render as `LEVEL ts module: message key=value ...` — stable,
grep-able output the e2e runner asserts on.  `setup()` configures the
root level/stream once per process (the CLI calls it from config);
library code only ever calls `logger()`.
"""
from __future__ import annotations

import logging
import sys
import threading
import time
from typing import Callable

_ROOT = "tm"
_setup_done = False
_lock = threading.Lock()

LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
          "error": logging.ERROR, "none": logging.CRITICAL + 10}


class Lazy:
    """Defer a value's computation until the line is actually emitted
    (reference libs/log lazy values): log.debug("x", h=Lazy(block.hash))
    never calls block.hash() unless debug is enabled."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], object]):
        self.fn = fn

    def __str__(self):
        try:
            v = self.fn()
        except Exception as e:  # noqa: BLE001 - logging must not raise
            return f"<lazy error: {e}>"
        return _render(v)


def _render(v) -> str:
    if isinstance(v, (bytes, bytearray)):
        return v.hex()
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


class _Formatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        ms = int(record.msecs)
        kv = getattr(record, "tm_kv", None)
        pairs = ""
        if kv:
            pairs = " " + " ".join(f"{k}={_render(v)}"
                                   for k, v in kv.items())
        mod = record.name[len(_ROOT) + 1:] or "main"
        return (f"{record.levelname[0]}[{ts}.{ms:03d}] {mod}: "
                f"{record.getMessage()}{pairs}")


class Logger:
    """Module-tagged leveled logger with key-value pairs.

    with_(k=v) returns a child carrying bound context pairs (reference
    log.With), prepended to every line."""

    __slots__ = ("_log", "_bound")

    def __init__(self, log: logging.Logger, bound: dict | None = None):
        self._log = log
        self._bound = bound or {}

    def with_(self, **kv) -> "Logger":
        return Logger(self._log, {**self._bound, **kv})

    def _emit(self, level: int, msg: str, kv: dict):
        if not self._log.isEnabledFor(level):
            return  # Lazy values never computed
        if self._bound:
            kv = {**self._bound, **kv}
        self._log.log(level, msg, extra={"tm_kv": kv})

    def debug(self, msg: str, **kv):
        self._emit(logging.DEBUG, msg, kv)

    def info(self, msg: str, **kv):
        self._emit(logging.INFO, msg, kv)

    def error(self, msg: str, **kv):
        self._emit(logging.ERROR, msg, kv)

    def is_debug(self) -> bool:
        return self._log.isEnabledFor(logging.DEBUG)


def setup(level: str = "info", stream=None, module_levels: str = ""):
    """Configure the process's log output once (CLI / node startup).

    level: debug|info|error|none.  module_levels: the reference's
    `log_level` module syntax, e.g. "consensus:debug,p2p:error" overrides
    per module."""
    global _setup_done
    with _lock:
        root = logging.getLogger(_ROOT)
        for h in list(root.handlers):
            root.removeHandler(h)
        h = logging.StreamHandler(stream if stream is not None
                                  else sys.stdout)
        h.setFormatter(_Formatter())
        root.addHandler(h)
        root.propagate = False
        root.setLevel(LEVELS.get(level, logging.INFO))
        for part in (module_levels or "").split(","):
            part = part.strip()
            if not part or ":" not in part:
                continue
            mod, _, lvl = part.partition(":")
            logging.getLogger(f"{_ROOT}.{mod}").setLevel(
                LEVELS.get(lvl, logging.INFO))
        _setup_done = True


def logger(module: str) -> Logger:
    """A module-tagged logger; safe before setup() (defaults applied on
    first use)."""
    global _setup_done
    if not _setup_done:
        setup()
    return Logger(logging.getLogger(f"{_ROOT}.{module}"))
