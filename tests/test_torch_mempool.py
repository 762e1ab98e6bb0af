"""The port's mempools (mempool/mempool.py, mempool/priority_mempool.py) and
the mempool reactor's codec against the JAX package's, on the CPU.

tests/test_priority_mempool.py's five standalone cases and
tests/test_propose_fastpath.py's reap-deadline case (both mempools) run
through both packages as `case_*` functions; each returns its outcome as a
package-free value (ResponseCheckTx fields through `plain`, reaped txs in
order, sizes, metrics) and the outcomes are compared across the packages
exactly.  Beside them: the v0 pool's staged admission, update and recheck
on the same seeded tx stream, a BlockExecutor reaping each package's pool,
and the reactor's TxsMessage bytes decoded by the other package.
"""
from __future__ import annotations

import functools
import importlib
import random
import time
import types

import pytest

from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_MODS = {
    "abci": "abci.types", "kvstore": "abci.kvstore",
    "metrics": "libs.metrics", "mempool": "mempool.mempool",
    "pmempool": "mempool.priority_mempool", "reactor": "mempool.reactor",
}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)
BY_NAME = {p.name: p for p in PKGS}


def prio_app(p):
    """tests/test_priority_mempool.py's PrioApp: CheckTx priority = first
    byte of the tx; sender = byte 1 (if the tx is >= 2 bytes and byte 1 is
    nonzero)."""
    abci = p.abci

    class PrioApp:
        def check_tx(self, req):
            tx = req.tx
            if not tx:
                return abci.ResponseCheckTx(code=1, log="empty")
            sender = ""
            if len(tx) >= 2 and tx[1]:
                sender = f"s{tx[1]}"
            return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK,
                                        priority=tx[0], gas_wanted=1,
                                        sender=sender)
    return PrioApp


def tx(priority, sender=0, tag=b""):
    return bytes([priority, sender]) + tag


def _pmp(p, **kw):
    return p.pmempool.PriorityMempool(prio_app(p)(),
                                      registry=p.metrics.Registry(), **kw)


def _metrics(mp) -> dict:
    m = mp.metrics
    return {"rejected": {r: m.rejected_txs.value(reason=r) for r in (
        "full", "cache", "app_err", "toolarge")},
        "failed": m.failed_txs.value(), "recheck": m.recheck_times.value(),
        "size": m.size.value()}


# ---------------------------------------------------------------------------
# tests/test_priority_mempool.py's standalone cases
# ---------------------------------------------------------------------------

def case_reap_orders_by_priority_then_fifo(p):
    mp = _pmp(p)
    res = [mp.check_tx(tx(5, tag=b"a")), mp.check_tx(tx(9, tag=b"b")),
           mp.check_tx(tx(5, tag=b"c")), mp.check_tx(tx(7, tag=b"d"))]
    reaped = mp.reap_max_bytes_max_gas(-1, -1)
    assert [t[0] for t in reaped] == [9, 7, 5, 5]
    assert reaped[2][2:] == b"a" and reaped[3][2:] == b"c"
    return {"res": res, "reaped": reaped, "metrics": _metrics(mp)}


def case_eviction_of_lower_priority_when_full(p):
    mp = _pmp(p, size_limit=3)
    res = [mp.check_tx(tx(1, tag=b"low1")), mp.check_tx(tx(2, tag=b"low2")),
           mp.check_tx(tx(8, tag=b"high"))]
    assert mp.size() == 3
    mid = mp.check_tx(tx(5, tag=b"mid"))
    assert mid.is_ok() and mp.size() == 3
    prios = sorted(t[0] for t in mp.reap_max_txs(-1))
    assert prios == [2, 5, 8]
    low = mp.check_tx(tx(1, tag=b"lower"))
    assert not low.is_ok() and mp.size() == 3
    return {"res": res + [mid, low], "reaped": mp.reap_max_txs(-1),
            "metrics": _metrics(mp)}


def case_sender_exclusivity(p):
    mp = _pmp(p)
    first = mp.check_tx(tx(5, sender=7, tag=b"x"))
    assert first.is_ok()
    second = mp.check_tx(tx(6, sender=7, tag=b"y"))
    assert not second.is_ok() and "sender" in second.log
    mp.lock()
    try:
        mp.update(1, [tx(5, sender=7, tag=b"x")])
    finally:
        mp.unlock()
    third = mp.check_tx(tx(6, sender=7, tag=b"y"))
    assert third.is_ok()
    return {"res": [first, second, third], "metrics": _metrics(mp)}


def case_update_removes_committed_and_rechecks(p):
    abci = p.abci
    base = prio_app(p)

    class DropAfterHeight(base):
        def __init__(self):
            self.drop = False

        def check_tx(self, req):
            if self.drop and req.type == abci.CheckTxType.RECHECK:
                return abci.ResponseCheckTx(code=1, log="stale")
            return super().check_tx(req)

    app = DropAfterHeight()
    mp = p.pmempool.PriorityMempool(app, registry=p.metrics.Registry())
    mp.check_tx(tx(3, tag=b"keep"))
    mp.check_tx(tx(4, tag=b"gone"))
    app.drop = True
    mp.lock()
    try:
        mp.update(2, [tx(3, tag=b"keep")])
    finally:
        mp.unlock()
    assert mp.size() == 0
    return {"size": mp.size(), "metrics": _metrics(mp)}


def case_reap_respects_byte_and_gas_caps(p):
    mp = _pmp(p)
    for i in range(10):
        mp.check_tx(tx(10 - i, tag=bytes(8)))
    by_bytes = mp.reap_max_bytes_max_gas(95, -1)
    assert len(by_bytes) == 3 and [t[0] for t in by_bytes] == [10, 9, 8]
    by_gas = mp.reap_max_bytes_max_gas(-1, 4)
    assert len(by_gas) == 4
    return {"bytes": by_bytes, "gas": by_gas}


# ---------------------------------------------------------------------------
# tests/test_propose_fastpath.py::test_mempool_reap_deadline, both pools
# ---------------------------------------------------------------------------

def _reap_deadline(p, mk):
    mp = mk(p.kvstore.KVStoreApplication())
    for i in range(500):
        mp.check_tx(b"d%03d=v" % i)
    full = mp.reap_max_bytes_max_gas(-1, -1)
    assert len(full) == 500
    short = mp.reap_max_bytes_max_gas(-1, -1,
                                      deadline=time.monotonic() - 1.0)
    assert len(short) <= 64
    later = mp.reap_max_bytes_max_gas(-1, -1,
                                      deadline=time.monotonic() + 60.0)
    assert len(later) == 500
    return {"full": full, "short": short, "later": later}


def case_mempool_reap_deadline_fifo(p):
    return _reap_deadline(p, lambda app: p.mempool.Mempool(
        app, registry=p.metrics.Registry()))


def case_mempool_reap_deadline_priority(p):
    return _reap_deadline(p, lambda app: p.pmempool.PriorityMempool(
        app, registry=p.metrics.Registry()))


# ---------------------------------------------------------------------------
# the v0 pool on a seeded stream: staged admission, update, recheck
# ---------------------------------------------------------------------------

def case_v0_seeded_stream(p):
    """A seeded stream of kvstore txs with duplicates, oversize and bad
    ones into a pool of 40 (max_tx_bytes 64): every response, the content,
    then two commits with the synchronous recheck, and txs_after."""
    rng = random.Random(18)
    abci = p.abci

    class App:
        def __init__(self):
            self.kv = p.kvstore.KVStoreApplication()
            self.dead = set()

        def check_tx(self, req):
            if req.type == abci.CheckTxType.RECHECK and req.tx in self.dead:
                return abci.ResponseCheckTx(code=3, log="went stale")
            return self.kv.check_tx(req)

    app = App()
    mp = p.mempool.Mempool(app, registry=p.metrics.Registry(),
                           size_limit=40, max_tx_bytes=64, cache_size=50)
    stream = []
    for i in range(80):
        r = rng.random()
        if r < 0.1 and stream:
            stream.append(rng.choice(stream))
        elif r < 0.15:
            stream.append(b"k%d=" % i + b"x" * 70)
        else:
            stream.append(b"k%d=v%d" % (i, rng.randrange(1000)))
    res = [mp.check_tx(t) for t in stream]
    held = mp.reap_max_txs(-1)
    app.dead = set(held[5:9])
    mp.lock()
    try:
        mp.update(1, held[:3])
    finally:
        mp.unlock()
    after1 = mp.reap_max_txs(-1)
    again = [mp.check_tx(t) for t in held[:4]]
    mp.lock()
    try:
        mp.update(2, held[3:6])
    finally:
        mp.unlock()
    return {"res": res, "held": held, "after1": after1, "again": again,
            "after2": mp.reap_max_txs(-1), "tail": mp.txs_after(30),
            "bytes": mp.total_bytes(),
            "reap_bytes": mp.reap_max_bytes_max_gas(300, -1),
            "metrics": _metrics(mp)}


CASES = {f.__name__[len("case_"):]: f for f in (
    case_reap_orders_by_priority_then_fifo,
    case_eviction_of_lower_priority_when_full,
    case_sender_exclusivity,
    case_update_removes_committed_and_rechecks,
    case_reap_respects_byte_and_gas_caps,
    case_mempool_reap_deadline_fifo,
    case_mempool_reap_deadline_priority,
    case_v0_seeded_stream)}


@functools.lru_cache(maxsize=None)
def _outcome(case: str, name: str):
    return plain(CASES[case](BY_NAME[name]))


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.mark.parametrize("case", sorted(CASES))
def test_mempool_case(case, pkg):
    """The JAX test's case, its assertions, in each package."""
    assert _outcome(case, pkg.name) is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_mempool_case_equal(case):
    """The case's outcome is the same in both packages."""
    assert _outcome(case, "jax") == _outcome(case, "port")


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_reactor_txs_message_crosses(src, dst):
    """channel 0x30's TxsMessage encoded by one package decodes in the
    other to the same txs, and re-encodes to the same bytes."""
    txs = [b"", b"k=v", bytes(range(256)), b"x" * 1000]
    wire = src.reactor.encode_msg(src.reactor.TxsMessage(txs))
    msg = dst.reactor.decode_msg(wire)
    assert isinstance(msg, dst.reactor.TxsMessage)
    assert [bytes(t) for t in msg.txs] == txs
    assert dst.reactor.encode_msg(msg) == wire
    assert src.reactor.MEMPOOL_CHANNEL == dst.reactor.MEMPOOL_CHANNEL == 0x30


def test_executor_reaps_the_pool():
    """A BlockExecutor over each package's v0 pool: the proposal block
    reaps the pool in arrival order; after the block applies, the pool
    holds the rest and refuses the committed txs as cached."""
    from test_torch_blocksync import BY_NAME as BS, executor, make_genesis

    got = {}
    for name in ("jax", "port"):
        bp = BS[name]
        p = BY_NAME[name]
        gdoc, privs = make_genesis(bp, 4)
        app = bp.kvstore.KVStoreApplication()
        mp = p.mempool.Mempool(app, registry=p.metrics.Registry())
        for i in range(30):
            assert mp.check_tx(b"r%02d=" % i + b"v" * 200).is_ok()
        ex = executor(bp, bp.sstore.StateStore(bp.kvdb.MemDB()), app,
                      mempool=mp)
        state = bp.state.state_from_genesis(gdoc)
        bp.sstore.StateStore(bp.kvdb.MemDB()).save(state)
        prop = state.validators.get_proposer().address
        block = ex.create_proposal_block(
            1, state, bp.commit.Commit(0, 0, bp.basic.BlockID(), []), prop,
            max_bytes_cap=4096)
        bid, _ = bp.replay.block_id_of(block)
        state2, _ = ex.apply_block(state, bid, block)
        got[name] = {"txs": list(block.data.txs), "left": mp.reap_max_txs(-1),
                     "again": plain(mp.check_tx(block.data.txs[0])),
                     "app_hash": state2.app_hash}
        assert 0 < len(block.data.txs) < 30
        assert len(got[name]["left"]) == 30 - len(block.data.txs)
    assert got["jax"] == got["port"]
