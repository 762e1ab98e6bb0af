"""Key-value database abstraction (the reference uses tm-db/goleveldb;
here: in-memory for tests, SQLite for durable single-file storage).

Interface: get/set/delete/has, atomic write batches, sorted prefix
iteration — the subset the block/state stores and indexers need.

Two write-coalescing layers live here (ADR-017):

  * SQLiteDB can defer the COMMIT of single-op set/delete calls into
    a bounded autocommit window (``commit_every``, opt-in — the node
    enables it for the state store only, whose hot path issues 4 sets
    per height and whose recovery path can rebuild a rolled-back
    window).  ``write_batch`` always commits immediately — and
    committing it also makes every deferred single-op before it
    durable, so cross-store ordering arguments built on write_batch
    boundaries keep holding.
  * GroupCommitDB wraps any KVDB and, while *group mode* is on,
    buffers every write in memory; a group becomes durable as ONE
    inner ``write_batch`` (on SQLite: one transaction, one fsync).
    Outside group mode it is a transparent pass-through, so wrapping
    the node's stores changes nothing for consensus-path writes.
"""
from __future__ import annotations

import os
import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from tendermint_tpu_torch.libs import fail


class KVDB:
    def compact(self):
        """Reclaim storage (reference cmd compact.go / goleveldb
        CompactRange); no-op unless the backend supports it."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes):
        raise NotImplementedError

    def delete(self, key: bytes):
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def write_batch(self, sets: List[Tuple[bytes, bytes]],
                    deletes: List[bytes] = ()):
        """Atomic multi-write."""
        raise NotImplementedError

    def iterate_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """Sorted ascending iteration over keys with the given prefix."""
        raise NotImplementedError

    def flush(self):
        """Make every accepted write durable (no-op for backends that
        commit per call)."""

    def close(self):
        pass


class MemDB(KVDB):
    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes):
        with self._lock:
            self._data[bytes(key)] = bytes(value)

    def delete(self, key: bytes):
        with self._lock:
            self._data.pop(key, None)

    def write_batch(self, sets, deletes=()):
        with self._lock:
            for k, v in sets:
                self._data[bytes(k)] = bytes(v)
            for k in deletes:
                self._data.pop(k, None)

    def iterate_prefix(self, prefix: bytes):
        with self._lock:
            keys = sorted(k for k in self._data if k.startswith(prefix))
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v


def prefix_upper_bound(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every key starting with
    ``prefix``: strip trailing 0xff bytes, then increment the last
    remaining byte.  None means no finite bound exists (empty or
    all-0xff prefix) and the scan must run to the end of the keyspace.

    The old bound ``prefix + b"\\xff" * 8`` silently DROPPED any key
    more than 8 bytes longer than the prefix — e.g. the block store's
    ``P:<height>:<idx>`` part keys once heights grow past 7 digits.
    """
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return None
    p[-1] += 1
    return bytes(p)


_SYNCHRONOUS_MODES = ("OFF", "NORMAL", "FULL")


class SQLiteDB(KVDB):
    """Durable single-file store; WAL mode for crash consistency.

    ``commit_every`` bounds the deferred-commit window for single-op
    set/delete calls: the Nth uncommitted single write commits the
    whole window.  Reads on this connection always see deferred writes
    (same-connection visibility); a process crash rolls the open
    window back as a unit.  write_batch, flush(), compact() and
    close() commit immediately — and a write_batch commit lands every
    deferred single-op before it, so ordering arguments built on batch
    boundaries keep holding.

    The default is 1 (commit per call, the pre-ADR-017 behavior):
    deferral is OPT-IN, only for stores whose recovery path can
    rebuild a rolled-back window — the node opts in its state store
    (handshake replays the gap from stored blocks); the tx index,
    evidence and light stores have no such backfill and stay at
    per-call commit.

    ``synchronous`` selects the SQLite durability pragma; the bench
    uses FULL to measure real per-commit fsync cost (the reference's
    WriteSync/SetSync semantics), the node default stays NORMAL.
    """

    def compact(self):
        with self._lock:
            self._commit_locked()
            self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            self._conn.execute("VACUUM")
            self._conn.commit()

    def __init__(self, path: str, commit_every: int = 1,
                 synchronous: str = "NORMAL"):
        if synchronous.upper() not in _SYNCHRONOUS_MODES:
            raise ValueError(f"bad synchronous mode {synchronous!r}")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._commit_every = max(int(commit_every), 1)
        self._dirty = 0
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(f"PRAGMA synchronous={synchronous.upper()}")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)")
            self._conn.commit()

    def _commit_locked(self):
        self._conn.commit()
        self._dirty = 0

    def _note_write_locked(self):
        self._dirty += 1
        if self._dirty >= self._commit_every:
            self._commit_locked()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return bytes(row[0]) if row else None

    def set(self, key: bytes, value: bytes):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                (key, value))
            self._note_write_locked()

    def delete(self, key: bytes):
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._note_write_locked()

    def write_batch(self, sets, deletes=()):
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                [(bytes(k), bytes(v)) for k, v in sets])
            if deletes:
                self._conn.executemany(
                    "DELETE FROM kv WHERE k = ?", [(bytes(k),) for k in deletes])
            self._commit_locked()

    def iterate_prefix(self, prefix: bytes):
        hi = prefix_upper_bound(prefix)
        with self._lock:
            if hi is None:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? ORDER BY k",
                    (prefix,)).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                    (prefix, hi)).fetchall()
        for k, v in rows:
            k = bytes(k)
            if k.startswith(prefix):
                yield k, bytes(v)

    def flush(self):
        with self._lock:
            if self._dirty:
                self._commit_locked()

    def close(self):
        with self._lock:
            self._conn.commit()
            self._conn.close()

    def __del__(self):
        # safety net for dropped handles: an open deferred window would
        # otherwise roll back on GC (and hold the file's write lock
        # until then).  No lock: __del__ only runs with no live refs.
        try:
            self._conn.commit()
            self._conn.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


# ---------------------------------------------------------------------------
# group commit (ADR-017)
# ---------------------------------------------------------------------------

class _Tombstone:
    __slots__ = ()

    def __repr__(self):  # pragma: no cover - debugging aid
        return "<deleted>"


_TOMBSTONE = _Tombstone()
_MISS = object()


class GroupCommitDB(KVDB):
    """Write-coalescing wrapper around any KVDB (ADR-017).

    Pass-through by default: every call delegates straight to the
    inner DB, so wrapping a store is free until a block pipeline turns
    group mode on.  In group mode, writes buffer in an insertion-
    ordered dict; ``take_group()`` hands the buffered generation to
    the async storage writer, and ``commit_group()`` makes it durable
    as ONE inner ``write_batch`` — on SQLite, one transaction and one
    fsync per group of heights instead of one per height.

    Readers always see buffered data (read-your-writes across pending
    AND in-flight groups), so the process view is identical either
    way; only the durability boundary moves.  Taken-but-uncommitted
    groups stay tracked in order until they land, and ``flush()``
    drains them oldest-first — double-committing a group is idempotent
    but committing out of order is not, so the single writer thread
    and the recovery path are serialized by the pipeline.
    """

    def __init__(self, inner: KVDB):
        self._inner = inner
        self._lock = threading.Lock()
        # serializes whole group commits: the async writer and the
        # synchronous flush() fallback may race for the same groups (a
        # writer stalled inside the chaos seam can wake after a drain
        # gave up waiting); the mutex + the in-flight identity check in
        # _commit_one make "commit each group exactly once, in order"
        # hold no matter who wins
        self._commit_mutex = threading.Lock()
        self._grouping = False
        self._pending: Dict[bytes, object] = {}
        self._inflight: List[Dict[bytes, object]] = []

    @property
    def inner(self) -> KVDB:
        return self._inner

    # -- mode --------------------------------------------------------------

    def begin_group_mode(self):
        with self._lock:
            self._grouping = True

    def end_group_mode(self):
        """Leave group mode; everything still buffered becomes durable
        synchronously (recovery path — no fault injection)."""
        self.flush()
        with self._lock:
            self._grouping = False

    def group_mode(self) -> bool:
        with self._lock:
            return self._grouping

    def pending_ops(self) -> int:
        with self._lock:
            return len(self._pending) + sum(
                len(g) for g in self._inflight)

    # -- KVDB --------------------------------------------------------------

    def _buffered_get(self, key: bytes):
        """Buffered value for key: bytes, _TOMBSTONE, or _MISS."""
        v = self._pending.get(key, _MISS)
        if v is not _MISS:
            return v
        for g in reversed(self._inflight):
            v = g.get(key, _MISS)
            if v is not _MISS:
                return v
        return _MISS

    def get(self, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        with self._lock:
            v = self._buffered_get(key)
        if v is _MISS:
            return self._inner.get(key)
        return None if v is _TOMBSTONE else v

    def set(self, key: bytes, value: bytes):
        with self._lock:
            if self._grouping:
                self._pending[bytes(key)] = bytes(value)
                return
        self._inner.set(key, value)

    def delete(self, key: bytes):
        with self._lock:
            if self._grouping:
                self._pending[bytes(key)] = _TOMBSTONE
                return
        self._inner.delete(key)

    def write_batch(self, sets, deletes=()):
        with self._lock:
            if self._grouping:
                for k, v in sets:
                    self._pending[bytes(k)] = bytes(v)
                for k in deletes:
                    self._pending[bytes(k)] = _TOMBSTONE
                return
        self._inner.write_batch(sets, deletes)

    def iterate_prefix(self, prefix: bytes):
        with self._lock:
            over: Dict[bytes, object] = {}
            for g in self._inflight:
                for k, v in g.items():
                    if k.startswith(prefix):
                        over[k] = v
            for k, v in self._pending.items():
                if k.startswith(prefix):
                    over[k] = v
        if not over:
            yield from self._inner.iterate_prefix(prefix)
            return
        merged = dict(self._inner.iterate_prefix(prefix))
        merged.update(over)
        for k in sorted(merged):
            v = merged[k]
            if v is not _TOMBSTONE:
                yield k, v

    def compact(self):
        self.flush()
        self._inner.compact()

    def flush(self):
        """Synchronously drain every buffered write, oldest group
        first, then the pending generation, then the inner DB's own
        deferred window — the recovery/shutdown barrier (chaos at
        kvdb.group_commit does not fire here; this IS the fallback the
        chaos degrades to)."""
        while True:
            with self._lock:
                if self._inflight:
                    g = self._inflight[0]
                elif self._pending:
                    g = self._pending
                    self._pending = {}
                    self._inflight.append(g)
                else:
                    break
            self._commit_one(g)
        self._inner.flush()

    def close(self):
        self.flush()
        self._inner.close()

    # -- group machinery (the pipeline's async storage writer) -------------

    def take_group(self) -> Optional[Dict[bytes, object]]:
        """Detach the pending generation for async commit; it stays
        visible to readers (in-flight) until commit_group lands it."""
        with self._lock:
            if not self._pending:
                return None
            g = self._pending
            self._pending = {}
            self._inflight.append(g)
            return g

    def commit_group(self, group: Dict[bytes, object]):
        """Make one taken group durable as a single inner write_batch.
        The chaos seam of the group-commit path: fail.inject fires
        BEFORE the write, so "raise" leaves the group tracked in-flight
        for the synchronous flush() fallback to recover."""
        fail.inject("kvdb.group_commit")
        self._commit_one(group)

    def _commit_one(self, group: Dict[bytes, object]):
        with self._commit_mutex:
            with self._lock:
                # identity check (not ==): a group the other committer
                # already landed must not be re-written — re-landing an
                # old group after a newer one would durably regress
                # keys both touched (store state, the State itself)
                if not any(g is group for g in self._inflight):
                    return
            sets = [(k, v) for k, v in group.items()
                    if v is not _TOMBSTONE]
            dels = [k for k, v in group.items() if v is _TOMBSTONE]
            self._inner.write_batch(sets, dels)
            with self._lock:
                self._inflight = [g for g in self._inflight
                                  if g is not group]
