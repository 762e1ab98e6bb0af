"""The port's indexers, event sinks and pubsub query against the JAX
package's, on the CPU.

tests/test_indexer.py's four cases and tests/test_sinks.py's two
standalone cases run through both packages (the `pkg` parameter); the same
blocks fed to each package's TxIndexer/BlockIndexer, IndexerService and an
sqlite:// SQLEventSink give the same keys, search results and rows.  Every
comparison is exact.  IndexerService threads are stopped at teardown, and
every wait for them has a timeout.
"""
from __future__ import annotations

import importlib
import os
import shutil
import sqlite3
import tempfile
import time
import types

import pytest

from test_torch_types import plain

_MODS = {
    "abci": "abci.types", "kvdb": "libs.kvdb", "query": "libs.pubsub_query",
    "indexer": "state.indexer", "sinks": "state.sinks",
    "block": "types.block", "basic": "types.basic", "bus": "types.event_bus",
    "kvstore": "abci.kvstore", "execution": "state.execution",
}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture
def tmp_dir():
    d = tempfile.mkdtemp(prefix="tmi")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# tests/test_indexer.py through both packages
# ---------------------------------------------------------------------------

def test_query_parse_and_match(pkg):
    Query = pkg.query.Query
    q = Query("tm.event = 'Tx' AND tx.height > 5")
    assert q.matches({"tm.event": ["Tx"], "tx.height": ["7"]})
    assert not q.matches({"tm.event": ["Tx"], "tx.height": ["3"]})
    assert not q.matches({"tx.height": ["7"]})
    q = Query("account.owner CONTAINS 'ivan'")
    assert q.matches({"account.owner": ["ivan the great"]})
    assert not q.matches({"account.owner": ["peter"]})
    q = Query("fee.amount EXISTS")
    assert q.matches({"fee.amount": ["100"]})
    assert not q.matches({"other": ["1"]})
    q = Query("tx.height >= 3 AND tx.height <= 5")
    assert q.matches({"tx.height": ["4"]})
    assert not q.matches({"tx.height": ["6"]})


def test_query_parse_errors(pkg):
    for bad in ("", "AND", "tx.height >", "tx.height 5",
                "a = 'x' OR b = 'y'", "a CONTAINS 5"):
        with pytest.raises(pkg.query.QueryError):
            pkg.query.Query(bad)


def _mk_result(p, code=0, events=None):
    return p.abci.ResponseDeliverTx(code=code, events=events or [])


def test_tx_indexer_get_and_search(pkg):
    Event, tx_hash = pkg.abci.Event, pkg.block.tx_hash
    ix = pkg.indexer.TxIndexer(pkg.kvdb.MemDB())
    txs = [b"tx-a", b"tx-b", b"tx-c"]
    results = [
        _mk_result(pkg, events=[Event("transfer", {"sender": "alice",
                                                   "amount": "10"})]),
        _mk_result(pkg, events=[Event("transfer", {"sender": "bob",
                                                   "amount": "5"})]),
        _mk_result(pkg, code=1),
    ]
    ix.index_block_txs(7, txs, results)
    ix.index_block_txs(8, [b"tx-d"], [
        _mk_result(pkg, events=[Event("transfer", {"sender": "alice",
                                                   "amount": "3"})])])
    got = ix.get(tx_hash(b"tx-b"))
    assert got["height"] == 7 and got["index"] == 1
    r = ix.search("transfer.sender = 'alice'")
    assert r["total_count"] == 2
    assert [t["height"] for t in r["txs"]] == [7, 8]
    r = ix.search("transfer.sender = 'alice' AND transfer.amount > 5")
    assert r["total_count"] == 1 and r["txs"][0]["height"] == 7
    r = ix.search("tx.height = '8'")
    assert r["total_count"] == 1
    r = ix.search(f"tx.hash = '{tx_hash(b'tx-c').hex().upper()}'")
    assert r["total_count"] == 1 and r["txs"][0]["tx_result"]["code"] == 1


def test_block_indexer_search(pkg):
    bx = pkg.indexer.BlockIndexer(pkg.kvdb.MemDB())
    for h in range(1, 6):
        bx.index(h, [pkg.abci.Event("rollup", {"batch": str(h * 10)})], [])
    assert bx.search("rollup.batch >= 30")["blocks"] == [3, 4, 5]
    assert bx.search("block.height = '2'")["blocks"] == [2]


# ---------------------------------------------------------------------------
# tests/test_sinks.py's standalone cases through both packages
# ---------------------------------------------------------------------------

def test_null_indexers(pkg):
    tx = pkg.sinks.NullTxIndexer()
    tx.index_block_txs(1, [b"a"], [object()])
    assert tx.get(b"\x00" * 32) is None
    with pytest.raises(RuntimeError, match="disabled"):
        tx.search("tx.height=1")
    bl = pkg.sinks.NullBlockIndexer()
    bl.index(1, [], [])
    with pytest.raises(RuntimeError, match="disabled"):
        bl.search("block.height=1")


def test_sql_event_sink_rejects_unknown_dsn(pkg):
    with pytest.raises(ValueError, match="unsupported"):
        pkg.sinks.SQLEventSink("mysql://nope", "c")


def test_sql_event_sink_postgres_needs_psycopg2(pkg):
    """Without psycopg2 a postgresql:// sink refuses with a clear error."""
    try:
        import psycopg2  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="psycopg2"):
            pkg.sinks.SQLEventSink("postgresql://localhost/none", "c")
    else:
        pytest.skip("psycopg2 is installed: the clear error cannot show")


# ---------------------------------------------------------------------------
# the same blocks through both packages
# ---------------------------------------------------------------------------

def _blocks(p, n_blocks=4, n_txs=6):
    """Seeded kvstore blocks' txs, responses and begin/end events, in
    package p's types."""
    app = p.kvstore.KVStoreApplication()
    out = []
    for h in range(1, n_blocks + 1):
        txs = [b"k%d_%d=v%d" % (h, i, i * h) for i in range(n_txs)] + [
            b"val:###!%d" % h]
        res = [app.deliver_tx(tx) for tx in txs]
        begin = [p.abci.Event("begin", {"h": str(h), "kind": "rollup"})]
        end = [p.abci.Event("end", {"batch": str(h * 10)})] if h % 2 else []
        out.append((h, txs, res, begin, end))
    return out


QUERIES = ["tx.height = '2'", "tx.height = 3", "tx.height > 2",
           "app.creator = 'kvstore'", "app.key = 'k3_4'",
           "app.key CONTAINS '_5' AND tx.height <= 2", "app.key EXISTS"]


def test_indexers_equal_across_packages():
    """The same blocks: equal key sets and equal decoded values in the
    index DB, equal tx_search/block_search results and equal get()."""
    got = {}
    for p in PKGS:
        db = p.kvdb.MemDB()
        tx_ix, blk_ix = p.indexer.TxIndexer(db), p.indexer.BlockIndexer(db)
        for h, txs, res, begin, end in _blocks(p):
            blk_ix.index(h, begin, end)
            tx_ix.index_block_txs(h, txs, res)
        codec = importlib.import_module(f"{p.root}.libs.safe_codec")
        rows = []
        for k, v in db.iterate_prefix(b""):
            try:
                rows.append((k, plain(codec.loads(v))))
            except Exception:  # noqa: BLE001 - raw values (tx hashes)
                rows.append((k, v))
        got[p.name] = {
            "rows": rows,
            "tx": [tx_ix.search(q, per_page=100) for q in QUERIES],
            "blk": [blk_ix.search(q) for q in (
                "begin.kind = 'rollup'", "end.batch >= 30",
                "block.height = '4'")],
            "get": tx_ix.get(p.block.tx_hash(b"k2_3=v6"))}
    assert got["jax"] == got["port"]
    assert got["port"]["tx"][0]["total_count"] == 7
    assert got["port"]["blk"][1]["blocks"] == [3]


def _run_service(p, db_dir, sink):
    """An IndexerService (and an sqlite SQLEventSink) on an EventBus fed
    the blocks as BlockExecutor._fire_events publishes them; waits (with a
    timeout) until both indexers hold the last block."""
    bus = p.bus.EventBus()
    db = p.kvdb.SQLiteDB(os.path.join(db_dir, f"{p.name}-ix.db"))
    tx_ix, blk_ix = p.indexer.TxIndexer(db), p.indexer.BlockIndexer(db)
    sinks = [p.sinks.SQLEventSink(f"sqlite://{sink}", "chain")]
    svc = p.indexer.IndexerService(tx_ix, blk_ix, bus, sinks=sinks)
    svc.start()
    try:
        blocks = _blocks(p)
        for h, txs, res, begin, end in blocks:
            block = p.block.Block(
                header=p.block.Header(chain_id="chain", height=h,
                                      time=p.basic.Timestamp(1700000000 + h,
                                                             7)),
                data=p.block.Data(txs=txs))
            resp = p.execution.ABCIResponses(
                deliver_txs=res,
                begin_block=p.abci.ResponseBeginBlock(events=begin),
                end_block=p.abci.ResponseEndBlock(events=end))
            bus.publish_new_block(block, p.basic.BlockID(), resp)
        last = blocks[-1][1][-1]
        end_t = time.monotonic() + 30
        while tx_ix.get(p.block.tx_hash(last)) is None or not \
                blk_ix.search(f"block.height = '{len(blocks)}'")["blocks"]:
            assert time.monotonic() < end_t, "the indexer did not drain"
            time.sleep(0.01)
        return ([tx_ix.search(q, per_page=100) for q in QUERIES],
                blk_ix.search("begin.kind = 'rollup'"))
    finally:
        svc.stop()
        for s in sinks:
            s.close()
        db.close()


def test_indexer_service_and_sql_sink_equal_across_packages(tmp_dir):
    """Each package's IndexerService indexes the published blocks into
    SQLite, and its SQLEventSink writes the same blocks, tx_results and
    events rows."""
    got = {}
    for p in PKGS:
        sink = os.path.join(tmp_dir, f"{p.name}-events.db")
        searches = _run_service(p, tmp_dir, sink)
        conn = sqlite3.connect(sink)
        try:
            tables = {t: conn.execute(
                f"select * from {t} order by rowid").fetchall()
                for t in ("blocks", "tx_results", "events")}
        finally:
            conn.close()
        got[p.name] = (searches, tables)
    assert got["jax"] == got["port"]
    searches, tables = got["port"]
    assert len(tables["blocks"]) == 4 and len(tables["tx_results"]) == 28
    assert ("begin_block", "begin", "kind", "rollup") in [
        r[2:] for r in tables["events"]]
    assert searches[0][1]["total_count"] == 7
