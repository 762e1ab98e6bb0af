"""Event sinks (reference state/indexer/sink/{kv,null,psql}).

The kv indexers (state/indexer.py) remain the query-serving store.  This
module adds:

- Null indexers: satisfy the TxIndexer/BlockIndexer interfaces and drop
  everything (config `[tx_index] indexer = "null"`, reference
  state/txindex/null).
- SQLEventSink: write-only normalized event rows over DB-API, the analog
  of the reference's PostgreSQL sink (state/indexer/sink/psql/psql.go —
  also write-only; `tx_search` stays on kv).  A `sqlite://path` DSN keeps
  it fully testable in this image; `postgresql://...` uses psycopg2 when
  installed and degrades with a clear error when not.
"""
from __future__ import annotations

import threading
from typing import List, Optional


class NullTxIndexer:
    """Reference state/txindex/null: indexing disabled."""

    def index_block_txs(self, height, txs, results) -> None:
        pass

    def get(self, th: bytes) -> Optional[dict]:
        return None

    def search(self, query: str, page: int = 1, per_page: int = 30) -> dict:
        raise RuntimeError("tx indexing is disabled (indexer = \"null\")")


class NullBlockIndexer:
    def index(self, height, begin_events, end_events) -> None:
        pass

    def search(self, query: str, page: int = 1, per_page: int = 30) -> dict:
        raise RuntimeError("block indexing is disabled (indexer = \"null\")")


_SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
    height BIGINT NOT NULL,
    chain_id TEXT NOT NULL,
    created_at TEXT NOT NULL,
    UNIQUE (height, chain_id));
CREATE TABLE IF NOT EXISTS tx_results (
    height BIGINT NOT NULL,
    tx_index INTEGER NOT NULL,
    tx_hash TEXT NOT NULL,
    code INTEGER NOT NULL,
    log TEXT,
    UNIQUE (height, tx_index));
CREATE TABLE IF NOT EXISTS events (
    height BIGINT NOT NULL,
    tx_hash TEXT,
    scope TEXT NOT NULL,
    type TEXT NOT NULL,
    key TEXT NOT NULL,
    value TEXT NOT NULL);
"""


class SQLEventSink:
    """Normalized event rows over DB-API (reference psql sink schema
    blocks/tx_results/events+attributes, flattened)."""

    def __init__(self, dsn: str, chain_id: str):
        self.dsn = dsn
        self.chain_id = chain_id
        self._lock = threading.Lock()
        if dsn.startswith("sqlite://"):
            import sqlite3
            self._conn = sqlite3.connect(dsn[len("sqlite://"):],
                                         check_same_thread=False)
            self._ph = "?"
        elif dsn.startswith(("postgresql://", "postgres://")):
            try:
                import psycopg2  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "postgresql event sink requires psycopg2, which is "
                    "not installed in this environment") from e
            import psycopg2
            self._conn = psycopg2.connect(dsn)
            self._ph = "%s"
        else:
            raise ValueError(f"unsupported event sink dsn {dsn!r} "
                             f"(sqlite://path or postgresql://...)")
        with self._lock:
            cur = self._conn.cursor()
            for stmt in _SCHEMA.strip().split(";"):
                if stmt.strip():
                    cur.execute(stmt)
            self._conn.commit()

    def index_block(self, height: int, time_iso: str, begin_events,
                    end_events) -> None:
        ph = self._ph
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(
                f"INSERT OR REPLACE INTO blocks (height, chain_id, "
                f"created_at) VALUES ({ph}, {ph}, {ph})"
                if ph == "?" else
                f"INSERT INTO blocks (height, chain_id, created_at) "
                f"VALUES ({ph}, {ph}, {ph}) ON CONFLICT DO NOTHING",
                (height, self.chain_id, time_iso))
            for scope, events in (("begin_block", begin_events or []),
                                  ("end_block", end_events or [])):
                for ev in events:
                    for k, v in (getattr(ev, "attributes", None)
                                 or {}).items():
                        cur.execute(
                            f"INSERT INTO events (height, tx_hash, scope, "
                            f"type, key, value) VALUES "
                            f"({ph}, NULL, {ph}, {ph}, {ph}, {ph})",
                            (height, scope, getattr(ev, "type", ""),
                             str(k), str(v)))
            self._conn.commit()

    def index_txs(self, height: int, txs, results) -> None:
        import hashlib
        ph = self._ph
        with self._lock:
            cur = self._conn.cursor()
            for i, (tx, res) in enumerate(zip(txs, results)):
                th = hashlib.sha256(tx).hexdigest().upper()
                cur.execute(
                    f"INSERT OR REPLACE INTO tx_results (height, tx_index, "
                    f"tx_hash, code, log) VALUES ({ph},{ph},{ph},{ph},{ph})"
                    if ph == "?" else
                    f"INSERT INTO tx_results (height, tx_index, tx_hash, "
                    f"code, log) VALUES ({ph},{ph},{ph},{ph},{ph}) "
                    f"ON CONFLICT DO NOTHING",
                    (height, i, th, getattr(res, "code", 0),
                     getattr(res, "log", "")))
                for ev in (getattr(res, "events", None) or []):
                    for k, v in (getattr(ev, "attributes", None)
                                 or {}).items():
                        cur.execute(
                            f"INSERT INTO events (height, tx_hash, scope, "
                            f"type, key, value) VALUES "
                            f"({ph}, {ph}, 'tx', {ph}, {ph}, {ph})",
                            (height, th, getattr(ev, "type", ""),
                             str(k), str(v)))
            self._conn.commit()

    def close(self):
        with self._lock:
            self._conn.close()
