"""RestoreLedger: crash-resumable snapshot restore state (ADR-022).

A statesync restore used to live entirely in memory: a kill anywhere
between the first chunk and the final app-hash check threw the whole
download away.  The ledger persists a restore *manifest* (the snapshot
key plus the applied-chunk high-water mark) and every verified chunk
body, so a restarted node reopens the ledger, re-verifies the stored
prefix against the snapshot's chunk digests (statesync/integrity.py,
one vectorized hashlib pass), and resumes fetching from the frontier
instead of from zero.

Durability rides kvdb.GroupCommitDB exactly like the block pipeline
(ADR-017): chunk writes buffer in group mode and land as ONE inner
write_batch every ``group_every`` chunks — on SQLite one transaction
and one fsync per group, with the chaos seam ``kvdb.group_commit``
firing before each commit and the synchronous ``flush()`` fallback
recovering a failed async commit.  A crash between group commits
loses at most the open group; everything behind it is durable and
resumable.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

from tendermint_tpu_torch.libs.kvdb import KVDB, GroupCommitDB

_MANIFEST_KEY = b"ss:manifest"
_CHUNK_PREFIX = b"ss:chunk:"


def _chunk_key(index: int) -> bytes:
    return _CHUNK_PREFIX + b"%08d" % index


class RestoreLedger:
    """One restore-in-progress per node (the node points it at
    ``data/statesync.db``; tests and in-memory nodes use MemDB).  All
    mutation under one leaf lock — the fetch plane's threads write
    concurrently."""

    def __init__(self, db: KVDB, group_every: int = 8):
        self.db = db if isinstance(db, GroupCommitDB) else GroupCommitDB(db)
        self.group_every = max(1, int(group_every))
        self._lock = threading.Lock()
        # serializes take_group+commit_group as ONE unit: several
        # fetcher threads reach the commit trigger concurrently, and
        # GroupCommitDB's contract demands groups land in take order
        # (a stalled older group committing after a newer one would
        # durably regress keys both touched — e.g. a drop()'s delete
        # re-landing over the refetched chunk)
        self._commit_lock = threading.Lock()
        self._since_commit = 0
        self._manifest: Optional[dict] = None

    # -- manifest ----------------------------------------------------------

    @staticmethod
    def _key_of(snapshot) -> dict:
        return {"height": int(snapshot.height),
                "format": int(snapshot.format),
                "hash": bytes(snapshot.hash).hex(),
                "chunks": int(snapshot.chunks)}

    def manifest(self) -> Optional[dict]:
        raw = self.db.get(_MANIFEST_KEY)
        if raw is None:
            return None
        try:
            m = json.loads(raw)
        except ValueError:
            return None
        return m if isinstance(m, dict) else None

    def begin(self, snapshot) -> Dict[int, bytes]:
        """Open (or resume) a restore of this snapshot.  A stored
        manifest for a DIFFERENT snapshot is cleared — its chunks
        belong to bytes we are no longer restoring.  Returns the
        stored chunk bodies (unverified; the syncer re-checks them
        against the digest list before trusting any)."""
        key = self._key_of(snapshot)
        with self._lock:
            m = self.manifest()
            if m is None or any(m.get(k) != v for k, v in key.items()):
                self._clear_locked()
                m = dict(key, high_water=-1)
                self.db.set(_MANIFEST_KEY,
                            json.dumps(m, sort_keys=True).encode())
            self._manifest = m
            self.db.begin_group_mode()
            stored: Dict[int, bytes] = {}
            for k, v in self.db.iterate_prefix(_CHUNK_PREFIX):
                try:
                    stored[int(k[len(_CHUNK_PREFIX):])] = v
                except ValueError:
                    continue
            return stored

    # -- chunk writes (fetch-plane threads) --------------------------------

    def put_chunk(self, index: int, data: bytes):
        """Buffer one verified chunk; every ``group_every`` puts the
        open group lands as one inner write_batch.  The async-commit
        chaos seam lives inside commit_group; a failed group commit
        degrades to the synchronous flush() fallback (which skips the
        seam — it IS the fallback), so a chaos raise costs latency,
        never chunks.  ``high_water`` (highest persisted index) is
        informational — resume correctness rests on the begin() rescan
        + digest re-verification, never on the mark."""
        commit = False
        with self._lock:
            self.db.set(_chunk_key(index), bytes(data))
            m = self._manifest
            if m is not None and index > int(m.get("high_water", -1)):
                m["high_water"] = index
                self.db.set(_MANIFEST_KEY,
                            json.dumps(m, sort_keys=True).encode())
            self._since_commit += 1
            if self._since_commit >= self.group_every:
                self._since_commit = 0
                commit = True
        if commit:
            with self._commit_lock:
                group = self.db.take_group()
                if group is None:
                    return
                try:
                    self.db.commit_group(group)
                except Exception:  # noqa: BLE001 - chaos/IO: sync fallback
                    try:
                        self.db.flush()
                    except Exception:  # noqa: BLE001 - durability is
                        # opportunistic: a dead disk (or a DB closed by
                        # a racing node shutdown) must not kill the
                        # in-memory restore, it only loses resume-ability
                        pass

    def chunk(self, index: int) -> Optional[bytes]:
        return self.db.get(_chunk_key(index))

    def drop(self, indices: List[int]):
        """Forget chunks the app refused (refetch_chunks) or that
        failed the resume re-verification."""
        with self._lock:
            for i in indices:
                self.db.delete(_chunk_key(i))
            m = self._manifest
            if m is not None and indices:
                m["high_water"] = min(int(m.get("high_water", -1)),
                                      min(indices) - 1)
                self.db.set(_MANIFEST_KEY,
                            json.dumps(m, sort_keys=True).encode())

    # -- lifecycle ---------------------------------------------------------

    def _clear_locked(self):
        dels = [k for k, _ in self.db.iterate_prefix(b"ss:")]
        if dels:
            self.db.write_batch([], dels)
        self._manifest = None
        self._since_commit = 0

    def clear(self):
        """Drop everything (snapshot rejected: its bytes are bad)."""
        with self._lock:
            self._clear_locked()

    def complete(self):
        """Restore verified end-to-end: nothing left to resume."""
        self.db.end_group_mode()
        self.clear()

    def flush(self):
        self.db.flush()

    def close(self):
        self.db.close()
