"""The port's gRPC transports (abci/grpc.py over libs/grpc_util.py, and
rpc/grpc_api.py) against the JAX package's, on the CPU.

tests/test_abci_grpc.py's four standalone cases and tests/test_rpc_grpc.py's
three run through both packages, each package's client also against the
other's server (the payloads are the bare Request*/Response* protos, so
they cross).  The two node-backed cases (tests/test_abci_grpc.py:110 and
tests/test_rpc_grpc.py:77) wait for the port's node (ROADMAP Queue 1 item
9).  grpcio is optional everywhere, as in the JAX package's tests.
Tolerance: exact equality.
"""
from __future__ import annotations

import importlib
import types

import pytest

pytest.importorskip("grpc")

from test_torch_types import _cpu, _one_torch_thread  # noqa: F401,E402
from test_torch_types import plain  # noqa: E402

_MODS = {"abci": "abci.types", "kvstore": "abci.kvstore",
         "agrpc": "abci.grpc", "wire": "abci.wire", "client": "abci.client",
         "grpc_api": "rpc.grpc_api", "grpc_util": "libs.grpc_util"}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
BY_NAME = {p.name: p for p in (JAX, PORT)}
PAIRS = [("jax", "jax"), ("port", "port"), ("jax", "port"), ("port", "jax")]


def _pair(server, client):
    ps, pc = BY_NAME[server], BY_NAME[client]
    srv = ps.agrpc.GRPCServer(ps.kvstore.KVStoreApplication(), "127.0.0.1:0")
    srv.start()
    return ps, pc, srv, pc.agrpc.GRPCClient(srv.addr)


def _roundtrip(server, client):
    ps, pc, srv, cli = _pair(server, client)
    abci = pc.abci
    try:
        assert cli.echo("hello") == "hello"
        cli.flush()
        out = [cli.info(abci.RequestInfo()).last_block_height]
        assert out[0] == 0
        assert cli.check_tx(abci.RequestCheckTx(tx=b"a=1")).is_ok()
        cli.begin_block(abci.RequestBeginBlock(hash=b"\x01" * 32))
        dr = cli.deliver_tx(b"a=1")
        assert dr.code == abci.CODE_TYPE_OK
        cli.end_block(1)
        c = cli.commit()
        assert c.data
        q = cli.query(abci.RequestQuery(data=b"a"))
        assert q.value == b"1"
        return out + [plain(dr), c.data, q.value]
    finally:
        cli.close()
        srv.stop()


@pytest.mark.parametrize("server,client", PAIRS)
def test_grpc_roundtrip(server, client):
    """Every method crosses the wire and comes back typed; the same
    answers whichever package serves or calls."""
    assert _roundtrip(server, client) == _roundtrip("jax", "jax")


@pytest.mark.parametrize("server,client", PAIRS)
def test_grpc_snapshot_methods(server, client):
    ps, pc, srv, cli = _pair(server, client)
    try:
        assert cli.list_snapshots() == []
        resp = cli.offer_snapshot(
            pc.abci.Snapshot(height=1, format=1, chunks=1, hash=b"h"),
            b"apph")
        assert resp is not None
    finally:
        cli.close()
        srv.stop()


@pytest.mark.parametrize("server,client", PAIRS)
def test_grpc_app_exception_maps_to_client_error(server, client):
    ps, pc, srv, cli = _pair(server, client)
    try:
        def boom(_req):
            raise RuntimeError("kvstore exploded")
        srv.app.query = boom
        with pytest.raises(pc.client.ABCIClientError,
                           match="kvstore exploded"):
            cli.query(pc.abci.RequestQuery(data=b"a"))
    finally:
        cli.close()
        srv.stop()


def _bare(p):
    abci, g = p.abci, p.agrpc
    out = []
    for method, req in (("echo", "hi"), ("flush", None),
                        ("info", abci.RequestInfo(version="v1")),
                        ("deliver_tx", b"k=v"), ("end_block", 7),
                        ("commit", None), ("list_snapshots", None)):
        bare = g.encode_request_bare(method, req)
        env = p.wire.encode_request(method, req)
        assert bare in env and len(bare) <= len(env)
        got = g.decode_request_bare(method, bare)
        assert p.wire.encode_request(method, got) == env
        out.append(bare)
    for method, resp in (("echo", "hi"),
                         ("info", abci.ResponseInfo(last_block_height=3)),
                         ("deliver_tx",
                          abci.ResponseDeliverTx(code=0, data=b"x")),
                         ("commit", abci.ResponseCommit(data=b"h"))):
        bare = g.encode_response_bare(method, resp)
        env = p.wire.encode_response(method, resp)
        assert bare in env
        assert p.wire.encode_response(
            method, g.decode_response_bare(method, bare)) == env
        out.append(bare)
    return out


def test_bare_codec_roundtrip_all_methods():
    """The bare codecs round-trip the method matrix, byte for byte the same
    in both packages."""
    assert _bare(JAX) == _bare(PORT)


# ---------------------------------------------------------------------------
# tests/test_rpc_grpc.py
# ---------------------------------------------------------------------------

def test_broadcast_response_codec_roundtrip():
    got = {}
    for p in (JAX, PORT):
        ct = p.abci.ResponseCheckTx(code=0, log="ok")
        dt = p.abci.ResponseDeliverTx(code=3, log="bad key")
        data = p.grpc_api._enc_broadcast_response(ct, dt)
        ct2, dt2 = p.grpc_api._dec_broadcast_response(data)
        assert ct2.code == 0 and ct2.log == "ok"
        assert dt2.code == 3 and dt2.log == "bad key"
        got[p.name] = data
    assert got["jax"] == got["port"]


class _FakeRPC:
    """Stands in for rpc/server.RPCServer's handler surface."""

    def __init__(self, p):
        self.p = p
        self.seen = []

    def broadcast_tx_commit_raw(self, raw, timeout=30.0):
        self.seen.append(raw)
        abci = self.p.abci
        return (abci.ResponseCheckTx(code=0, data=b"cd", gas_wanted=7),
                abci.ResponseDeliverTx(code=0, log="committed",
                                       gas_used=21, codespace="app"), 5)


@pytest.mark.parametrize("server,client", PAIRS)
def test_grpc_broadcast_server_client(server, client):
    ps, pc = BY_NAME[server], BY_NAME[client]
    rpc = _FakeRPC(ps)
    srv = ps.grpc_api.GRPCBroadcastServer(rpc, "127.0.0.1:0")
    srv.start()
    try:
        cli = pc.grpc_api.GRPCBroadcastClient(srv.addr)
        cli.ping()
        ct, dt = cli.broadcast_tx(b"k=v")
        assert ct.code == 0 and ct.data == b"cd" and ct.gas_wanted == 7
        assert dt.code == 0 and dt.log == "committed"
        assert dt.gas_used == 21 and dt.codespace == "app"
        assert rpc.seen == [b"k=v"]
        cli.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("server,client", PAIRS)
def test_grpc_broadcast_error_maps_to_status(server, client):
    import grpc as _grpc

    ps, pc = BY_NAME[server], BY_NAME[client]

    class Boom:
        def broadcast_tx_commit_raw(self, raw, timeout=30.0):
            raise RuntimeError("mempool is full")

    srv = ps.grpc_api.GRPCBroadcastServer(Boom(), "127.0.0.1:0")
    srv.start()
    try:
        cli = pc.grpc_api.GRPCBroadcastClient(srv.addr)
        with pytest.raises(_grpc.RpcError, match="mempool is full"):
            cli.broadcast_tx(b"x")
        cli.close()
    finally:
        srv.stop()


def test_require_grpc_names_the_dependency(monkeypatch):
    """Without grpcio the port's constructors raise the JAX package's
    RuntimeError naming it."""
    for p in (JAX, PORT):
        monkeypatch.setattr(p.grpc_util, "grpc", None)
        with pytest.raises(RuntimeError, match="grpcio is not installed"):
            p.grpc_util.require_grpc()
        monkeypatch.undo()
