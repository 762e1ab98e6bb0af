"""The port's RPC server (rpc/server.py, rpc/light.py) against the JAX
package's, on the CPU.

Both packages' servers run over stand-in nodes holding the same seeded
chain (tests/test_torch_blocksync.py's `build_chain`, replayed into each
package's stores), and every route's JSON over HTTP is compared between
them: POST and GET, results and error answers alike.  Beside that, the
RPC cases of tests/test_amino_json.py:137 (the amino-JSON shapes),
tests/test_fuzz.py:125 (garbage bodies against a live server),
tests/test_ingress.py:537 (the gate's overload as RPC_BUSY_CODE) and
tests/test_metrics.py:164 (GET /metrics parsed strictly), each through both
packages; the port's HTTPProvider against both servers; the listener's
backlog (the port's one departure here); and the two card-fault answers:
a pre-verify launch that failed on the card under broadcast_tx_sync, and a
LightServe certificate's under light_verify, each answered -32603 "internal
error" (never a CheckTx code, never busy, never a refused verdict), with a
chaos drill taking the JAX package's path.  Tolerance: exact equality.
"""
from __future__ import annotations

import base64
import http.client
import importlib
import json
import types
import urllib.request

import numpy as np
import pytest

from test_metrics import NASTY, _parse_exposition
from test_torch_blocksync import BY_NAME as CHAIN_PKG
from test_torch_blocksync import build_chain, make_genesis
from test_torch_ingress import JAX as ING_JAX, PORT as ING_PORT
from test_torch_ingress import Gates, EchoApp, _sigtx, card_kernel  # noqa: F401
from test_torch_statesync import run_limited
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401

_MODS = {
    "abci": "abci.types", "kvstore": "abci.kvstore", "kvdb": "libs.kvdb",
    "fail": "libs.fail", "metrics": "libs.metrics",
    "replay": "blocksync.replay", "execution": "state.execution",
    "state": "state.state", "sstore": "state.store",
    "bstore": "store.block_store", "indexer": "state.indexer",
    "mempool": "mempool.mempool", "ing": "mempool.ingress",
    "bus": "types.event_bus", "rpc": "rpc", "server": "rpc.server",
    "rpc_light": "rpc.light", "lserve": "light.service",
    "lprovider": "light.provider", "light_block": "types.light_block",
    "validator_set": "types.validator_set", "degrade": "crypto.degrade",
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


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS:
        p.fail.clear()
    yield
    for p in PKGS:
        p.fail.clear()


def _kw(p):
    return {"device": "cpu"} if p is PORT else {}


def chain_stores(p, n_vals=4, heights=4):
    """The seeded chain replayed into package p's stores: (genesis, blocks,
    commits, states, block store, state store, app)."""
    b = CHAIN_PKG[p.name]
    gdoc, privs = make_genesis(b, n_vals)
    blocks, commits, states = build_chain(
        b, gdoc, privs, heights, txs_fn=lambda h: [b"k%d=v%d" % (h, h)])
    app = p.kvstore.KVStoreApplication()
    ss = p.sstore.StateStore(p.kvdb.MemDB())
    bs = p.bstore.BlockStore(p.kvdb.MemDB())
    state = p.state.state_from_genesis(gdoc)
    ss.save(state)
    ex = p.execution.BlockExecutor(ss, app, **_kw(p))
    state, n = p.replay.replay_window(ex, bs, state, blocks, commits,
                                      max_window=16)
    assert n == heights
    return gdoc, blocks, commits, states, bs, ss, app


class _RoundState:
    height, round, step = 5, 0, 1


def stand_in_node(p, **over):
    """The attributes the routes read of a node (the node itself comes
    with ROADMAP Queue 1 item 9), over the seeded chain."""
    gdoc, blocks, commits, states, bs, ss, app = chain_stores(p)
    db = p.kvdb.MemDB()
    tx_ix, blk_ix = p.indexer.TxIndexer(db), p.indexer.BlockIndexer(db)
    for b in blocks:
        h = b.header.height
        resp = ss.load_abci_responses(h)
        tx_ix.index_block_txs(h, b.data.txs, resp.deliver_txs)
        blk_ix.index(h, [], [])
    mp = p.mempool.Mempool(p.kvstore.KVStoreApplication(),
                           registry=p.metrics.Registry())
    mp.check_tx(b"pending=1")
    node = types.SimpleNamespace(
        block_store=bs, state_store=ss, state=states[-1], app=app,
        mempool=mp, ingress_gate=None, light_serve=None,
        event_bus=p.bus.EventBus(), genesis=gdoc, tx_indexer=tx_ix,
        block_indexer=blk_ix, config=None, evidence_pool=None,
        consensus=types.SimpleNamespace(get_round_state=_RoundState),
        switch=types.SimpleNamespace(
            peers={}, actual_listen_addr=lambda: "127.0.0.1:26656"),
        status=lambda: {"node_info": {"network": gdoc.chain_id},
                        "sync_info": {"latest_block_height": bs.height()}})
    vars(node).update(over)
    return node, blocks


def post(port, method, params=None, rid=1):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("POST", "/", json.dumps({
            "jsonrpc": "2.0", "id": rid, "method": method,
            "params": params or {}}), {"Content-Type": "application/json"})
        return json.loads(c.getresponse().read())
    finally:
        c.close()


def get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def served(p, node):
    srv = p.server.RPCServer(node, "127.0.0.1:0")
    srv.start()
    return srv


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def route_calls(blocks):
    """Every route of both servers, with the params a client sends."""
    b2 = blocks[1]
    tx = b2.data.txs[0]
    from tendermint_tpu_torch.types.block import tx_hash
    return [
        ("health", {}), ("status", {}), ("net_info", {}), ("genesis", {}),
        ("blockchain", {"minHeight": 1, "maxHeight": 3}),
        ("block", {"height": 2}), ("block", {"height": 99}),
        ("block_by_hash", {"hash": b2.hash().hex()}),
        ("block_results", {"height": 2}), ("commit", {"height": 2}),
        ("commit", {}), ("validators", {"height": 2}),
        ("validators", {"height": 2, "page": 1, "per_page": 2}),
        ("consensus_params", {"height": 2}), ("consensus_state", {}),
        ("unconfirmed_txs", {}), ("num_unconfirmed_txs", {}),
        ("check_tx", {"tx": _b64(b"x=1")}),
        ("broadcast_tx_sync", {"tx": _b64(b"y=2")}),
        ("broadcast_tx_sync", {"tx": "%%%not-base64%%%"}),
        ("broadcast_tx_commit", {"tx": _b64(b"z=3"), "timeout": 0.2}),
        ("abci_info", {}),
        ("abci_query", {"data": b"k2".hex()}),
        ("abci_query", {"data": b"k2".hex(), "prove": True}),
        ("broadcast_evidence", {"evidence": "AAAA"}),
        ("tx", {"hash": tx_hash(tx).hex()}), ("tx", {"hash": "00" * 32}),
        ("tx_search", {"query": "tx.height = 2"}),
        ("block_search", {"query": "block.height = 2"}),
        ("light_block", {"height": 2}), ("light_block", {}),
        ("block_proto", {"height": 3}), ("dump_consensus_state", {}),
        ("genesis_chunked", {"chunk": 0}), ("genesis_chunked", {"chunk": 5}),
        ("light_status", {}), ("light_verify", {"kind": "adjacent"}),
        ("no_such_route", {}), ("block", {"height": 2, "bogus": 1}),
    ]


@pytest.fixture(scope="module")
def servers():
    made = {}
    for p in PKGS:
        node, blocks = stand_in_node(p)
        made[p.name] = (served(p, node), node, blocks)
    yield made
    for srv, _, _ in made.values():
        srv.stop()


def test_every_route_answers_the_same_json(servers):
    """POST of every route: the JAX and the port servers answer the same
    JSON (results and errors)."""
    blocks = servers["port"][2]
    for method, params in route_calls(blocks):
        got = {name: post(srv.port, method, params)
               for name, (srv, _, _) in servers.items()}
        assert got["jax"] == got["port"], method


@pytest.mark.parametrize("path", [
    "/", "/health", "/block?height=2", "/validators?height=3",
    "/light_block?height=1", "/blockchain?minHeight=1&maxHeight=2",
    "/commit?height=%5Bbad", "/abci_query?data=6b32&prove=true"])
def test_get_routes_answer_the_same(servers, path):
    got = {name: get(srv.port, path) for name, (srv, _, _) in
           servers.items()}
    assert got["jax"] == got["port"]
    assert got["port"][0] == 200


def test_route_tables_equal(servers):
    r_j = post(servers["jax"][0].port, "")
    assert sorted(servers["jax"][0].routes) == sorted(
        servers["port"][0].routes)
    assert r_j["error"]["code"] == -32601


def test_body_cap_and_parse_errors_equal(servers):
    out = {}
    for name, (srv, _, _) in servers.items():
        rows = []
        # the cap is read from Content-Length: the server answers before
        # any body byte is sent
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        try:
            c.putrequest("POST", "/")
            c.putheader("Content-Length", str(srv.max_body_bytes + 1))
            c.endheaders()
            rows.append(json.loads(c.getresponse().read()))
        finally:
            c.close()
        for body in (b"{not json", b"[1, 2]", b"\xff\xfe"):
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            try:
                c.request("POST", "/", body,
                          {"Content-Type": "application/json"})
                rows.append(json.loads(c.getresponse().read()))
            finally:
                c.close()
        out[name] = rows
    assert out["jax"] == out["port"]
    assert [r["error"]["code"] for r in out["port"]] == [
        -32600, -32700, -32700, -32700]


def test_http_provider_against_both_servers(servers):
    """The port's HTTPProvider reads a light block of either server; each
    is the chain's own header and set."""
    for name, (srv, node, blocks) in servers.items():
        prov = PORT.lprovider.HTTPProvider(
            node.genesis.chain_id, srv.laddr)
        for h in (1, 2, 3):
            lb = prov.light_block(h)
            assert lb.signed_header.header.hash() == blocks[h - 1].hash()
            assert lb.validators.hash() == blocks[h - 1].header \
                .validators_hash
        with pytest.raises(PORT.lprovider.LightBlockNotFound):
            prov.light_block(99)


def test_exports_match():
    assert sorted(PORT.rpc.__all__) == sorted(JAX.rpc.__all__)
    assert PORT.server.RPC_BUSY_CODE == JAX.server.RPC_BUSY_CODE == -32011
    assert PORT.rpc_light.RPC_LIGHT_OFF_CODE == \
        JAX.rpc_light.RPC_LIGHT_OFF_CODE
    assert PORT.server.MAX_BODY_BYTES == JAX.server.MAX_BODY_BYTES


def test_listener_backlog_is_gos():
    """The port's departure: the HTTP listener's backlog is Go's (4,096),
    so a client with 64 connections opening at once is served without a
    dropped handshake (socketserver's 5 costs each a retransmission)."""
    node, _ = stand_in_node(PORT)
    srv = served(PORT, node)
    try:
        assert srv._httpd.request_queue_size == 4096
        conns = []
        for _ in range(64):
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            c.request("POST", "/", json.dumps({"method": "health",
                                               "id": 1}))
            conns.append(c)
        assert all(json.loads(c.getresponse().read())["result"] == {}
                   for c in conns)
        for c in conns:
            c.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# tests/test_amino_json.py:137, test_fuzz.py:125, test_ingress.py:537,
# test_metrics.py:164, through both packages
# ---------------------------------------------------------------------------

def _amino_shapes(p):
    node, _ = stand_in_node(p)
    srv = p.server.RPCServer(node, "127.0.0.1:0")
    blk = srv.block(2)
    hdr = blk["block"]["header"]
    assert hdr["height"] == "2"
    assert isinstance(hdr["time"], str) and hdr["time"].endswith("Z")
    assert isinstance(hdr["version"]["block"], str)
    lc = blk["block"]["last_commit"]
    assert lc["height"] == "1" and isinstance(lc["round"], int)
    assert lc["signatures"][0]["timestamp"].endswith("Z")
    vr = srv.validators(height=2)
    assert vr["block_height"] == "2"
    v0 = vr["validators"][0]
    assert v0["pub_key"]["type"] == "tendermint/PubKeyEd25519"
    assert isinstance(v0["voting_power"], str)
    assert isinstance(v0["proposer_priority"], str)
    return blk, vr


def test_rpc_block_and_validators_amino_shapes():
    assert _amino_shapes(JAX) == _amino_shapes(PORT)


def _fuzz_bodies(p):
    node = types.SimpleNamespace(
        app=p.kvstore.KVStoreApplication(),
        block_store=p.bstore.BlockStore(p.kvdb.MemDB()),
        state_store=p.sstore.StateStore(p.kvdb.MemDB()))
    srv = served(p, node)
    rng = np.random.default_rng(0xF0220)
    out = []
    try:
        for i in range(60):
            kind = i % 4
            if kind == 0:
                body = bytes(rng.integers(0, 256, int(rng.integers(0, 300)),
                                          dtype=np.uint8))
            elif kind == 1:
                body = json.dumps({"method": "block", "params": {
                    "height": rng.choice(
                        ["-1", "999999999999999999999", "NaN", "[]",
                         "1e309"])}, "id": 1}).encode()
            elif kind == 2:
                body = json.dumps({"method": "".join(
                    chr(int(x)) for x in rng.integers(32, 127, 12)),
                    "id": 1}).encode()
            else:
                body = b'{"method": "broadcast_tx_sync", "params": ' \
                       b'{"tx": "%%%not-base64%%%"}, "id": 1}'
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
            try:
                c.request("POST", "/", body=body,
                          headers={"Content-Type": "application/json"})
                r = c.getresponse()
                assert r.status == 200
                payload = json.loads(r.read())
                assert "error" in payload or "result" in payload
                out.append(payload)
            finally:
                c.close()
        status, _ = get(srv.port, "/health")
        assert status == 200
    finally:
        srv.stop()
    return out


def test_fuzz_rpc_http_bodies():
    assert _fuzz_bodies(JAX) == _fuzz_bodies(PORT)


def _busy(p, gs):
    p.fail.set_mode("ingress.checktx", "latency:150")
    try:
        g, mp = gs.gate(queue_size=1, batch=1)
        node = types.SimpleNamespace(mempool=mp, ingress_gate=g,
                                     event_bus=None)
        srv = p.server.RPCServer.__new__(p.server.RPCServer)
        srv.node = node
        g.submit(b"rpc-fill-0")
        g.submit(b"rpc-fill-1")
        arg = _b64(b"rpc-overflow")
        out = []
        for call in (srv.broadcast_tx_sync, srv.broadcast_tx_async,
                     srv.broadcast_tx_commit):
            with pytest.raises(p.server.RPCError) as ei:
                call(tx=arg)
            assert ei.value.code == p.server.RPC_BUSY_CODE
            assert "retry after" in str(ei.value)
            out.append(ei.value.code)
        return out
    finally:
        p.fail.clear()


def test_rpc_surfaces_429_style_busy():
    out = {}
    for p in PKGS:
        gs = Gates(ING_PORT if p is PORT else ING_JAX)
        try:
            out[p.name] = _busy(p, gs)
        finally:
            gs.close()
    assert out["jax"] == out["port"]


def _scrape(p):
    DEFAULT = p.metrics.DEFAULT
    c = DEFAULT.counter("conformance", "nasty_total",
                        "Scrape conformance probe.", labels=("v",))
    c.inc(7, v=NASTY)
    h = DEFAULT.histogram("conformance", "nasty_seconds",
                          "Histogram with labeled series.",
                          labels=("site",), buckets=[0.1, 1])
    h.observe(0.5, site='weird "site"\n')
    srv = served(p, types.SimpleNamespace(config=None))
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=5) as r:
            body = r.read().decode()
            ctype = r.headers["Content-Type"]
    finally:
        srv.stop()
        with DEFAULT._lock:
            DEFAULT._metrics.pop(c.name, None)
            DEFAULT._metrics.pop(h.name, None)
    parsed = _parse_exposition(body)
    assert parsed[("tendermint_conformance_nasty_total",
                   (("v", NASTY),))] == 7.0
    assert parsed[("tendermint_conformance_nasty_seconds_bucket",
                   (("site", 'weird "site"\n'), ("le", "1")))] == 1.0
    return ctype, {k: v for k, v in parsed.items() if "conformance" in k[0]}


def test_metrics_endpoint_scrape_and_parse_conformance():
    assert _scrape(JAX) == _scrape(PORT)


def test_statesync_metrics_bundle_equal():
    names = {}
    for p in PKGS:
        reg = p.metrics.Registry()
        m = p.metrics.StateSyncMetrics(reg)
        names[p.name] = sorted((k, type(v).__name__,
                                getattr(v, "help", ""),
                                tuple(getattr(v, "label_names", ())))
                               for k, v in vars(m).items())
    assert names["jax"] == names["port"]


# ---------------------------------------------------------------------------
# the card-fault answers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drill", [False, True], ids=["card", "drill"])
def test_card_fault_under_broadcast_tx_sync(card_kernel, drill):
    """A pre-verify launch that failed on the card: outside a drill the
    signed tx is answered -32603 "internal error" naming the card's
    failure (never a CheckTx code, never RPC_BUSY_CODE) and the gate
    keeps the DeviceLaneError; in a drill the runtime re-verifies on the
    host and the tx is admitted, as in the JAX package."""
    gs = Gates(ING_PORT)
    try:
        gs.sched(tpu_threshold=1, window_s=0.001)
        g, mp = gs.gate(app=EchoApp(ING_PORT), device="cpu",
                        preverify_deadline_s=1.0)
        if drill:
            PORT.fail.set_mode("pipeline.commit", "latency:1")
        node = types.SimpleNamespace(mempool=mp, ingress_gate=g,
                                     event_bus=None)
        srv = served(PORT, node)
        try:
            r = post(srv.port, "broadcast_tx_sync",
                     {"tx": _b64(_sigtx(ING_PORT, 3, tag=b"rpc-card"))})
            plain_r = post(srv.port, "broadcast_tx_sync",
                           {"tx": _b64(b"plain=1")})
        finally:
            srv.stop()
        assert plain_r["result"]["code"] == 0
        if drill:
            assert r["result"]["code"] == 0 and g.device_error is None
            return
        assert r["error"]["code"] == -32603
        assert r["error"]["message"].startswith("internal error: ")
        assert "device lane failed on the card" in r["error"]["message"]
        assert isinstance(g.device_error, PORT.degrade.DeviceLaneError)
        assert g.stats()["busy"] == 0 and g.stats()["sig_rejected"] == 0
    finally:
        gs.close()


def _light_verify_under_fault(p, monkeypatch, drill):
    node, blocks = stand_in_node(p)
    svc = p.lserve.LightServe(node.block_store, node.state_store,
                              node.genesis.chain_id, prewarm=False, **_kw(p))
    svc.start()
    node.light_serve = svc
    VS = p.validator_set.ValidatorSet

    def broken(self, *a, **kw):
        raise PORT.degrade.DeviceLaneError("launch failed on the card")
    monkeypatch.setattr(VS, "verify_commit_light", broken)
    if drill:
        p.fail.set_mode("pipeline.commit", "latency:1")
    srv = served(p, node)
    try:
        sh = {h: _b64(p.light_block.SignedHeader(
            blocks[h - 1].header, blocks[h].last_commit).proto())
            for h in (2, 3)}
        vals = _b64(node.state_store.load_validators(3).proto())
        return post(srv.port, "light_verify", {
            "kind": "adjacent", "trusted": sh[2], "untrusted": sh[3],
            "untrusted_vals": vals, "now": 1700005000.0,
            "trusting_period_s": 3600.0 * 24})
    finally:
        srv.stop()
        svc.stop()
        monkeypatch.undo()
        p.fail.clear()


@pytest.mark.parametrize("drill", [False, True], ids=["card", "drill"])
def test_card_fault_under_light_verify(monkeypatch, drill):
    """A LightServe certificate that failed on the card: outside a drill
    light_verify is answered -32603 (never {"ok": false}); in a drill the
    port answers what the JAX server answers to the same fault."""
    got = _light_verify_under_fault(PORT, monkeypatch, drill)
    if not drill:
        assert got["error"]["code"] == -32603, got
        assert "launch failed on the card" in got["error"]["message"]
        return
    want = _light_verify_under_fault(JAX, monkeypatch, drill)
    assert got == want and got["result"]["ok"] is False


def test_light_verify_through_the_rpc_equal():
    """With the card well, light_verify of both servers gives the same
    verdicts (adjacent, non-adjacent, a tampered commit)."""
    out = {}
    for p in PKGS:
        node, blocks = stand_in_node(p)
        svc = p.lserve.LightServe(node.block_store, node.state_store,
                                  node.genesis.chain_id, prewarm=False,
                                  **_kw(p))
        svc.start()
        node.light_serve = svc
        srv = served(p, node)
        try:
            def sh(h, com=None):
                return _b64(p.light_block.SignedHeader(
                    blocks[h - 1].header,
                    com or blocks[h].last_commit).proto())

            def vals(h):
                return _b64(node.state_store.load_validators(h).proto())
            base = {"now": 1700005000.0, "trusting_period_s": 86400.0}
            rows = [post(srv.port, "light_verify", {
                "kind": "adjacent", "trusted": sh(2), "untrusted": sh(3),
                "untrusted_vals": vals(3), **base}),
                post(srv.port, "light_verify", {
                    "kind": "non_adjacent", "trusted": sh(1),
                    "trusted_vals": vals(1), "untrusted": sh(3),
                    "untrusted_vals": vals(3), **base})]
            com = blocks[3].last_commit
            sigs = list(com.signatures)
            s0 = sigs[0]
            sigs[0] = type(s0)(s0.block_id_flag, s0.validator_address,
                               s0.timestamp,
                               bytes([s0.signature[0] ^ 1])
                               + s0.signature[1:])
            bad = type(com)(com.height, com.round, com.block_id, sigs)
            rows.append(post(srv.port, "light_verify", {
                "kind": "adjacent", "trusted": sh(2),
                "untrusted": sh(3, bad), "untrusted_vals": vals(3),
                **base}))
            cur = post(srv.port, "light_subscribe",
                       {"client": "follower", "from_height": 1})
            cid = cur["result"]["cursor"]
            rows.append(post(srv.port, "light_poll",
                             {"cursor": cid, "max_items": 2}))
            rows.append(post(srv.port, "light_unsubscribe",
                             {"cursor": cid}))
            rows.append(post(srv.port, "light_poll", {"cursor": cid}))
            rows.append(post(srv.port, "light_poll", {}))
            rows.append(post(srv.port, "light_status", {})["result"]
                        .get("running"))
        finally:
            srv.stop()
            svc.stop()
        out[p.name] = rows
    assert out["jax"] == out["port"]
    assert out["port"][0]["result"] == {"ok": True, "error": None}
    assert out["port"][1]["result"]["ok"] is True
    assert out["port"][2]["result"]["ok"] is False
    assert len(out["port"][3]["result"]["blocks"]) == 2
    assert out["port"][5]["result"] == {"evicted": True, "blocks": []}


# ---------------------------------------------------------------------------
# the RPC over real Nodes (device="cpu")
# ---------------------------------------------------------------------------

def real_node(p, base, node_key_file):
    """A Node of package p over a home whose SQLite stores hold the seeded
    chain (4 validators, 4 heights, a tx each; applied by a BlockExecutor
    that trusts its own commits) and a kvstore at its tip: a non-validator
    with block sync off, so consensus starts and commits nothing new.  The
    node key is the given file's, so both packages' nodes have one id."""
    import os
    import shutil

    cfgm = importlib.import_module(f"{p.root}.config.config")
    node_m = importlib.import_module(f"{p.root}.node")
    parts = importlib.import_module(f"{p.root}.types.part_set")
    b = CHAIN_PKG[p.name]
    gdoc, privs = make_genesis(b, 4)
    blocks, commits, _states = build_chain(
        b, gdoc, privs, 4, txs_fn=lambda h: [b"k%d=v%d" % (h, h)])
    cfg = cfgm.Config(home=os.path.join(str(base), p.name), moniker="rpc")
    cfg.ensure_dirs()
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.rpc.laddr = "127.0.0.1:0"
    cfg.block_sync.enable = False
    cfg.light_serve.prewarm = False
    with open(cfg.genesis_file(), "w") as f:
        f.write(gdoc.to_json())
    shutil.copy(node_key_file, cfg.node_key_file())
    app = p.kvstore.KVStoreApplication()
    app.init_chain(p.abci.RequestInitChain(
        chain_id=gdoc.chain_id, validators=[
            p.abci.ValidatorUpdate("ed25519", v.pub_key_bytes, v.power)
            for v in gdoc.validators]))
    ss = p.sstore.StateStore(p.kvdb.SQLiteDB(cfg.state_db_file()))
    bs = p.bstore.BlockStore(p.kvdb.SQLiteDB(cfg.block_db_file()))
    ex = p.execution.BlockExecutor(ss, app, **_kw(p))
    st = p.state.state_from_genesis(gdoc)
    ss.save(st)
    for h in range(1, len(blocks) + 1):
        if h > 1:
            ex.mark_commit_verified(h - 1, commits[h - 2])
        st, _ = ex.apply_block(st, commits[h - 1].block_id, blocks[h - 1])
        bs.save_block(blocks[h - 1], parts.make_block_parts(blocks[h - 1]),
                      commits[h - 1])
    for s in (ss, bs):
        s.db.flush()
        s.db.close()
    node = node_m.Node(cfg, app, **_kw(p))
    node.start()
    return node, blocks


def _node_servers(base):
    from tendermint_tpu_torch.p2p.key import NodeKey

    key = str(base / "node_key.json")
    NodeKey.load_or_generate(key)
    return {p.name: real_node(p, base, key) for p in PKGS}


NODE_CALLS = [
    ("health", {}), ("genesis", {}),
    ("blockchain", {"minHeight": 1, "maxHeight": 4}),
    ("block", {"height": 2}), ("block", {"height": 99}),
    ("block_results", {"height": 2}), ("commit", {"height": 2}),
    ("commit", {"height": 4}), ("validators", {"height": 2}),
    ("consensus_params", {"height": 2}), ("abci_info", {}),
    ("abci_query", {"data": b"k2".hex()}),
    ("abci_query", {"data": b"k2".hex(), "prove": True}),
    ("check_tx", {"tx": _b64(b"x=1")}),
    ("broadcast_tx_sync", {"tx": _b64(b"y=2")}),
    ("num_unconfirmed_txs", {}), ("unconfirmed_txs", {}),
    ("light_block", {"height": 2}), ("block_proto", {"height": 3}),
    ("genesis_chunked", {"chunk": 0}), ("no_such_route", {}),
]


def test_routes_over_real_nodes_answer_the_same(tmp_path):
    """Every chain, app and mempool route of both packages' RPCServers,
    each over its own package's real Node (the port's on device="cpu")
    holding the same seeded chain: the same JSON; the status the same but
    the listen address; the block route by hash too."""
    def run():
        made = _node_servers(tmp_path)
        try:
            out = {}
            for name, (node, blocks) in made.items():
                port = node.rpc_server.port
                rows = [post(port, m, prm) for m, prm in NODE_CALLS]
                rows.append(post(port, "block_by_hash",
                                 {"hash": blocks[1].hash().hex()}))
                st = post(port, "status")["result"]
                st["node_info"].pop("listen_addr")
                rows.append(st)
                rows.append(node.status()["sync_info"]["latest_block_height"])
                out[name] = rows
            return out
        finally:
            for node, _ in made.values():
                node.stop()
    got = run_limited(run, 120)
    for i, (m, _) in enumerate(NODE_CALLS):
        assert got["jax"][i] == got["port"][i], m
    assert got["jax"][len(NODE_CALLS):] == got["port"][len(NODE_CALLS):]
    assert got["port"][-1] == "4"
    assert got["port"][NODE_CALLS.index(("broadcast_tx_sync", {
        "tx": _b64(b"y=2")}))]["result"]["code"] == 0


def test_node_status_route_is_the_nodes(tmp_path):
    """The status route of the port's RPCServer answers its real Node's
    status(): the node id is the home's key, the chain's tip height and
    app hash those of the seeded chain, catching_up false (consensus
    started), no validator info for a non-validator."""
    def run():
        made = _node_servers(tmp_path)
        try:
            node, _ = made["port"]
            return (post(node.rpc_server.port, "status")["result"],
                    node.node_key.node_id,
                    node.state.app_hash.hex().upper())
        finally:
            for n, _ in made.values():
                n.stop()
    st, nid, app_hash = run_limited(run, 120)
    assert st["node_info"]["id"] == nid
    assert st["sync_info"]["latest_block_height"] == "4"
    assert st["sync_info"]["latest_app_hash"] == app_hash
    assert st["sync_info"]["catching_up"] is False
    assert st["validator_info"]["address"] == ""
    assert st["validator_info"]["voting_power"] == "0"
