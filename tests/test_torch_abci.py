"""The port's ABCI (wire codec, socket server and client, kvstore, proxy)
against the JAX package's, on the CPU.

tests/test_abci_golden.py's and tests/test_abci_wire.py's cases run through
both packages (the `pkg` parameter); every request and response encodes to
the same bytes in both packages, and each decodes the other's; a port
SocketClient drives a JAX ABCIServer over a unix socket, and the other way
round; the kvstore's app hash, queries, validator updates and snapshot
chunk metadata are equal after the same txs.  Every comparison is exact.
Sockets live in short directories under /tmp (a unix socket path holds
~107 bytes); every server is stopped and every client closed at teardown,
and every socket read has a timeout.
"""
from __future__ import annotations

import base64
import importlib
import json
import os
import random
import shutil
import socket
import tempfile
import types

import pytest

from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_MODS = {
    "abci": "abci.types", "wire": "abci.wire", "server": "abci.server",
    "client": "abci.client", "kvstore": "abci.kvstore", "proxy": "proxy",
    "pd": "libs.protodec", "basic": "types.basic", "block": "types.block",
    "integrity": "statesync.integrity",
}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "abci_golden.json")
with open(FIXTURES) as f:
    GOLDEN = json.load(f)


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture
def sock_dir():
    d = tempfile.mkdtemp(prefix="tma", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _golden_internal(p, kind: str, method: str):
    """tests/test_abci_golden.py's internal object for each golden case,
    built in package p."""
    abci, B = p.abci, p.basic
    H = p.block.Header(
        version=p.block.Consensus(block=11, app=1), chain_id="golden-chain",
        height=42, time=B.Timestamp(1700000100, 500),
        last_block_id=B.BlockID(b"\x11" * 32,
                                B.PartSetHeader(2, b"\x22" * 32)),
        last_commit_hash=b"\x33" * 32, data_hash=b"\x44" * 32,
        validators_hash=b"\x55" * 32, next_validators_hash=b"\x66" * 32,
        consensus_hash=b"\x77" * 32, app_hash=b"\x88" * 32,
        last_results_hash=b"\x99" * 32, evidence_hash=b"\xAA" * 32,
        proposer_address=b"\xBB" * 20)
    snap = abci.Snapshot(height=20, format=1, chunks=3, hash=b"\xF0" * 32,
                         metadata=b"meta")
    ev = abci.Event("app", {"key": "k1", "creator": "kvstore"})
    mis = abci.Misbehavior(type=1, validator_address=b"\xCC" * 20,
                           validator_power=10, height=40,
                           time_seconds=1700000050, time_nanos=25,
                           total_voting_power=30)

    class _V:
        def __init__(self, address, voting_power):
            self.address = address
            self.voting_power = voting_power

    reqs = {
        "echo": "hello-golden",
        "flush": None,
        "info": abci.RequestInfo("0.34.20", 11, 8),
        "init_chain": abci.RequestInitChain(
            time_seconds=1700000100, chain_id="golden-chain",
            consensus_params=abci.ConsensusParamsUpdate(22020096, -1),
            validators=[abci.ValidatorUpdate("ed25519", b"\x01" * 32, 10),
                        abci.ValidatorUpdate("secp256k1", b"\x02" * 33, 5)],
            app_state_bytes=b'{"k":"v"}', initial_height=1),
        "query": abci.RequestQuery(b"key1", "/store", 7, True),
        "begin_block": abci.RequestBeginBlock(
            hash=H.hash(), header_proto=H.proto(),
            last_commit_votes=[(_V(b"\xDD" * 20, 10), True),
                               (_V(b"\xEE" * 20, 20), False)],
            byzantine_validators=[mis]),
        "check_tx": abci.RequestCheckTx(b"tx-bytes",
                                        abci.CheckTxType.RECHECK),
        "deliver_tx": b"deliver-me",
        "end_block": 42,
        "commit": None,
        "list_snapshots": None,
        "offer_snapshot": (snap, b"\xF1" * 32),
        "load_snapshot_chunk": (9, 1, 2),
        "apply_snapshot_chunk": (2, b"chunkdata", "peer-1"),
        "prepare_proposal": abci.RequestPrepareProposal(
            block_data=[b"a", b"bb"], block_data_size=1000),
        "process_proposal": abci.RequestProcessProposal(
            txs=[b"t1", b"t22"], header_proto=H.proto()),
    }
    rsps = {
        "exception": "boom",
        "echo": "hello-golden",
        "flush": None,
        "info": abci.ResponseInfo("{\"size\":1}", "0.1.0", 1, 99,
                                  b"\xAB" * 32),
        "init_chain": abci.ResponseInitChain(
            consensus_params=abci.ConsensusParamsUpdate(2048, 100000),
            validators=[abci.ValidatorUpdate("ed25519", b"\x04" * 32, 7)],
            app_hash=b"\x05" * 32),
        "query": abci.ResponseQuery(
            code=1, log="nope", info="", index=2, key=b"key1",
            value=b"val1", height=7, codespace="app",
            proof_ops=[("ics23:iavl", b"key1", b"\x0A\x01")]),
        "begin_block": abci.ResponseBeginBlock(events=[ev]),
        "check_tx": abci.ResponseCheckTx(
            code=3, data=b"d", log="l", gas_wanted=10, gas_used=5,
            priority=77, sender="s", codespace="cs"),
        "deliver_tx": abci.ResponseDeliverTx(
            code=0, data=b"res", log="ok", gas_wanted=2, gas_used=1,
            events=[ev], codespace=""),
        "end_block": abci.ResponseEndBlock(
            validator_updates=[
                abci.ValidatorUpdate("ed25519", b"\x06" * 32, 0)],
            consensus_param_updates=abci.ConsensusParamsUpdate(4096, -1),
            events=[ev]),
        "commit": abci.ResponseCommit(data=b"\x0C" * 32, retain_height=50),
        "list_snapshots": [snap],
        "offer_snapshot": abci.ResponseOfferSnapshot(
            result=abci.ResponseOfferSnapshot.REJECT_FORMAT),
        "load_snapshot_chunk": b"chunk-bytes",
        "apply_snapshot_chunk": abci.ResponseApplySnapshotChunk(
            result=abci.ResponseApplySnapshotChunk.RETRY,
            refetch_chunks=[1, 3, 5], reject_senders=["bad1", "bad2"]),
        "prepare_proposal": abci.ResponsePrepareProposal(block_data=[b"x"]),
        "process_proposal": abci.ResponseProcessProposal(accept=True),
    }
    return (reqs if kind == "request" else rsps)[method]


def _encode(p, kind, method, obj):
    return (p.wire.encode_request(method, obj) if kind == "request"
            else p.wire.encode_response(method, obj))


def _decode(p, kind, data):
    return (p.wire.decode_request(data) if kind == "request"
            else p.wire.decode_response(data))


# ---------------------------------------------------------------------------
# tests/test_abci_golden.py through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_encode_matches_reference_bytes(pkg, name):
    case = GOLDEN[name]
    internal = _golden_internal(pkg, case["kind"], case["method"])
    assert _encode(pkg, case["kind"], case["method"], internal) == \
        bytes.fromhex(case["hex"]), name


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_decode_roundtrips_reference_bytes(pkg, name):
    case = GOLDEN[name]
    golden = bytes.fromhex(case["hex"])
    method, obj = _decode(pkg, case["kind"], golden)
    assert method == case["method"]
    assert _encode(pkg, case["kind"], method, obj) == golden, name


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_decodes_equal_across_packages(name):
    """Each package decodes the reference bytes to the same fields, and
    re-encodes the other package's decoded object to the same bytes."""
    case = GOLDEN[name]
    golden = bytes.fromhex(case["hex"])
    (jm, jobj), (tm, tobj) = (_decode(p, case["kind"], golden)
                              for p in PKGS)
    assert jm == tm == case["method"]
    if case["method"] == "exception":
        assert str(jobj) == str(tobj)
    else:
        assert plain(jobj) == plain(tobj)
    assert _encode(PORT, case["kind"], tm, tobj) == \
        _encode(JAX, case["kind"], jm, jobj) == golden


# ---------------------------------------------------------------------------
# tests/test_abci_wire.py through both packages
# ---------------------------------------------------------------------------

def test_request_golden_bytes(pkg):
    wire = pkg.wire
    assert wire.encode_request("deliver_tx", b"ab") == b"\x4a\x04\x0a\x02ab"
    m, req = wire.decode_request(b"\x4a\x04\x0a\x02ab")
    assert (m, req) == ("deliver_tx", b"ab")
    assert wire.encode_request("end_block", 7) == b"\x52\x02\x08\x07"
    assert wire.encode_request("echo", "hi") == b"\x0a\x04\x0a\x02hi"
    assert wire.encode_request("flush", None) == b"\x12\x00"


def test_response_golden_bytes(pkg):
    abci, wire, pd = pkg.abci, pkg.wire, pkg.pd
    r = abci.ResponseCommit(data=b"h", retain_height=0)
    assert wire.encode_response("commit", r) == b"\x62\x03\x12\x01h"
    enc = wire.encode_response(
        "offer_snapshot",
        abci.ResponseOfferSnapshot(abci.ResponseOfferSnapshot.ACCEPT))
    body = pd.get_message(pd.parse(enc), 14)
    assert pd.get_uint(pd.parse(body), 1) == 1
    m, resp = wire.decode_response(enc)
    assert resp.result == abci.ResponseOfferSnapshot.ACCEPT


def _request_cases(p):
    abci = p.abci
    return [
        ("echo", "x"),
        ("flush", None),
        ("info", abci.RequestInfo("v1", 11, 8)),
        ("init_chain", abci.RequestInitChain(
            time_seconds=1700000000, chain_id="c",
            consensus_params=abci.ConsensusParamsUpdate(1 << 20, -1),
            validators=[abci.ValidatorUpdate("ed25519", b"\x01" * 32, 10)],
            app_state_bytes=b"{}", initial_height=3)),
        ("query", abci.RequestQuery(b"k", "/store", 9, True)),
        ("check_tx", abci.RequestCheckTx(b"tx", abci.CheckTxType.RECHECK)),
        ("deliver_tx", b"raw"),
        ("end_block", 42),
        ("commit", None),
        ("list_snapshots", None),
        ("offer_snapshot", (abci.Snapshot(9, 1, 4, b"h" * 32, b"m"),
                            b"a" * 32)),
        ("load_snapshot_chunk", (9, 1, 2)),
        ("apply_snapshot_chunk", (2, b"chunk", "peer1")),
        ("prepare_proposal", abci.RequestPrepareProposal(
            block_data=[b"t1", b"t2"], block_data_size=100)),
        ("begin_block", abci.RequestBeginBlock(
            hash=b"\x01" * 32, header_proto=b"",
            last_commit_votes=[
                (abci.ValidatorInfo(b"\x07" * 20, 10), True),
                (abci.ValidatorInfo(b"\x08" * 20, 10), False)],
            byzantine_validators=[abci.Misbehavior(
                type=1, validator_address=b"\x09" * 20, validator_power=10,
                height=5, time_seconds=1700000000,
                total_voting_power=40)])),
    ]


def _response_cases(p):
    abci = p.abci
    return [
        ("info", abci.ResponseInfo("d", "v", 1, 5, b"hash")),
        ("init_chain", abci.ResponseInitChain(
            validators=[abci.ValidatorUpdate("ed25519", b"\x02" * 32, 7)],
            app_hash=b"h")),
        ("query", abci.ResponseQuery(
            code=0, key=b"k", value=b"v", height=5,
            proof_ops=[("ics23:iavl", b"k", b"proofdata")])),
        ("begin_block", abci.ResponseBeginBlock(
            events=[abci.Event("tx", {"k": "v"})])),
        ("check_tx", abci.ResponseCheckTx(code=1, log="bad", priority=9,
                                          sender="s")),
        ("deliver_tx", abci.ResponseDeliverTx(
            code=0, data=b"r", events=[abci.Event("e", {"a": "b"})])),
        ("end_block", abci.ResponseEndBlock(
            validator_updates=[abci.ValidatorUpdate("ed25519",
                                                    b"\x03" * 32, 0)])),
        ("commit", abci.ResponseCommit(b"apphash", 4)),
        ("list_snapshots", [abci.Snapshot(9, 1, 4, b"h", b"m")]),
        ("load_snapshot_chunk", b"chunkbytes"),
        ("apply_snapshot_chunk", abci.ResponseApplySnapshotChunk(
            result=abci.ResponseApplySnapshotChunk.RETRY,
            refetch_chunks=[1, 3], reject_senders=["p1"])),
        ("prepare_proposal", abci.ResponsePrepareProposal([b"t1"])),
        ("process_proposal", abci.ResponseProcessProposal(accept=False)),
        ("exception", "boom"),
    ]


def test_all_methods_roundtrip(pkg):
    wire = pkg.wire
    for method, req in _request_cases(pkg):
        data = wire.encode_request(method, req)
        m, out = wire.decode_request(data)
        assert m == method
        assert wire.encode_request(m, out) == data, method
    for method, resp in _response_cases(pkg):
        data = wire.encode_response(method, resp)
        m, out = wire.decode_response(data)
        assert m == method
        if method != "exception":
            assert wire.encode_response(m, out) == data, method
        else:
            assert out == "boom"


def test_begin_block_misbehavior_conversion(pkg):
    abci, wire = pkg.abci, pkg.wire
    req = dict(_request_cases(pkg))["begin_block"]
    m, out = wire.decode_request(wire.encode_request("begin_block", req))
    assert m == "begin_block"
    assert [(v.address, v.voting_power, s)
            for v, s in out.last_commit_votes] == \
        [(b"\x07" * 20, 10, True), (b"\x08" * 20, 10, False)]
    assert out.byzantine_validators == req.byzantine_validators
    assert isinstance(out.byzantine_validators[0], abci.Misbehavior)


def test_framing_roundtrip_over_socketpair(pkg):
    wire = pkg.wire
    a, b = socket.socketpair()
    b.settimeout(10)
    try:
        payload = wire.encode_request("deliver_tx", b"x" * 300)
        wire.write_frame(a, payload)
        wire.write_frame(a, wire.encode_request("flush", None))
        assert wire.read_frame(b) == payload
        assert wire.decode_request(wire.read_frame(b))[0] == "flush"
        a.close()
        assert wire.read_frame(b) is None  # clean EOF
    finally:
        b.close()


def test_decoders_reject_garbage_alike():
    """Random bytes: each decoder raises ValueError or decodes, and both
    packages do the same thing with the same bytes."""
    rng = random.Random(99)
    for n in (1, 5, 40, 200):
        for _ in range(50):
            blob = bytes(rng.randrange(256) for _ in range(n))
            for dec in ("decode_request", "decode_response"):
                got = []
                for p in PKGS:
                    try:
                        m, obj = getattr(p.wire, dec)(blob)
                        got.append(("ok", m, plain(obj)
                                    if m != "exception" else str(obj)))
                    except ValueError as e:
                        got.append(("ValueError", str(e)))
                assert got[0] == got[1], (dec, blob.hex())


# ---------------------------------------------------------------------------
# every method's encoding across the packages
# ---------------------------------------------------------------------------

_N_REQ, _N_RSP = len(_request_cases(PORT)), len(_response_cases(PORT))


@pytest.mark.parametrize("i", range(_N_REQ))
def test_request_encoding_equal_across_packages(i):
    jm, jreq = _request_cases(JAX)[i]
    tm, treq = _request_cases(PORT)[i]
    jb, tb = (JAX.wire.encode_request(jm, jreq),
              PORT.wire.encode_request(tm, treq))
    assert jb == tb, jm
    jm2, j_from_t = JAX.wire.decode_request(tb)
    tm2, t_from_j = PORT.wire.decode_request(jb)
    assert jm2 == tm2 == jm
    assert plain(j_from_t) == plain(t_from_j)
    assert PORT.wire.encode_request(tm2, t_from_j) == jb


@pytest.mark.parametrize("i", range(_N_RSP))
def test_response_encoding_equal_across_packages(i):
    jm, jr = _response_cases(JAX)[i]
    tm, tr = _response_cases(PORT)[i]
    jb, tb = (JAX.wire.encode_response(jm, jr),
              PORT.wire.encode_response(tm, tr))
    assert jb == tb, jm
    jm2, j_from_t = JAX.wire.decode_response(tb)
    tm2, t_from_j = PORT.wire.decode_response(jb)
    assert jm2 == tm2 == jm
    if jm == "exception":
        assert str(j_from_t) == str(t_from_j)
    else:
        assert plain(j_from_t) == plain(t_from_j)
        assert PORT.wire.encode_response(tm2, t_from_j) == jb


# ---------------------------------------------------------------------------
# the socket transport: tests/test_abci_socket.py through both packages, and
# each package's client against the other's server
# ---------------------------------------------------------------------------

def test_socket_roundtrip_in_thread(pkg, sock_dir):
    """Server in-thread: every method crosses the wire and comes back
    typed."""
    abci = pkg.abci
    addr = f"unix://{os.path.join(sock_dir, 'abci.sock')}"
    srv = pkg.server.ABCIServer(pkg.kvstore.KVStoreApplication(), addr)
    srv.start()
    try:
        cli = pkg.client.SocketClient(addr)
        try:
            assert cli.echo("hello") == "hello"
            cli.flush()
            info = cli.info(abci.RequestInfo())
            assert info.last_block_height == 0
            r = cli.check_tx(abci.RequestCheckTx(tx=b"a=1"))
            assert r.is_ok()
            cli.begin_block(abci.RequestBeginBlock(hash=b"\x01" * 32))
            dr = cli.deliver_tx(b"a=1")
            assert dr.code == abci.CODE_TYPE_OK
            cli.end_block(1)
            c = cli.commit()
            assert c.data  # app hash
            q = cli.query(abci.RequestQuery(data=b"a"))
            assert q.value == b"1"
        finally:
            cli.close()
    finally:
        srv.stop()


def test_proxy_four_connections(pkg, sock_dir):
    abci = pkg.abci
    addr = f"unix://{os.path.join(sock_dir, 'abci.sock')}"
    srv = pkg.server.ABCIServer(pkg.kvstore.KVStoreApplication(), addr)
    srv.start()
    try:
        conns = pkg.proxy.AppConns(pkg.proxy.ClientCreator.remote(addr))
        try:
            assert conns.consensus is not conns.mempool
            assert conns.query.info(
                abci.RequestInfo()).last_block_height == 0
            r = conns.mempool.check_tx(abci.RequestCheckTx(tx=b"x=y"))
            assert r.is_ok()
        finally:
            conns.stop()
    finally:
        srv.stop()


def _session(p, cli):
    """Every method of a kvstore session through client `cli`, built from
    package p's types; returns the responses as package-free values."""
    abci = p.abci
    pub = bytes(range(32))
    out = [cli.echo("hello"), cli.flush(),
           cli.info(abci.RequestInfo("0.34.20", 11, 8)),
           cli.init_chain(abci.RequestInitChain(
               chain_id="x", validators=[
                   abci.ValidatorUpdate("ed25519", pub, 10)])),
           cli.check_tx(abci.RequestCheckTx(tx=b"")),
           cli.check_tx(abci.RequestCheckTx(tx=b"a=1")),
           cli.begin_block(abci.RequestBeginBlock(
               hash=b"\x01" * 32, byzantine_validators=[abci.Misbehavior(
                   type=1, validator_address=b"\x09" * 20,
                   validator_power=10, height=5, time_seconds=1700000000,
                   total_voting_power=40)])),
           cli.deliver_tx(b"a=1"), cli.deliver_tx(b"plain"),
           cli.deliver_tx(b"val:" + base64.b64encode(pub)
                          + b"!7"),
           cli.deliver_tx(b"val:bad"),
           cli.end_block(1), cli.commit(),
           cli.query(abci.RequestQuery(data=b"a")),
           cli.query(abci.RequestQuery(data=b"missing")),
           cli.list_snapshots(),
           cli.prepare_proposal(abci.RequestPrepareProposal(
               block_data=[b"t1", b"t2"], block_data_size=100)),
           cli.process_proposal(abci.RequestProcessProposal(
               txs=[b"t1"], header_proto=b"")),
           cli.offer_snapshot(abci.Snapshot(9, 2, 1, b"h" * 32, b""),
                              b"a" * 32),
           cli.load_snapshot_chunk(9, 1, 0),
           cli.apply_snapshot_chunk(0, b"x", "peer")]
    return plain(out)


@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, JAX), (JAX, PORT)],
                         ids=["port-client-jax-server",
                              "jax-client-port-server"])
def test_client_drives_the_other_packages_server(client_pkg, server_pkg,
                                                 sock_dir):
    """A session through one package's SocketClient against the other's
    ABCIServer answers exactly as the same session within one package."""
    got = {}
    for name, cp, sp in (("cross", client_pkg, server_pkg),
                         ("own", server_pkg, server_pkg)):
        addr = f"unix://{os.path.join(sock_dir, name + '.sock')}"
        srv = sp.server.ABCIServer(sp.kvstore.KVStoreApplication(), addr)
        srv.start()
        try:
            cli = cp.client.SocketClient(addr)
            try:
                got[name] = _session(cp, cli)
            finally:
                cli.close()
        finally:
            srv.stop()
    assert got["cross"] == got["own"]


def test_grpc_address_raises_until_the_transport_is_ported():
    """The gRPC transport is ported (abci/grpc.py): a grpc:// address now
    takes the JAX package's branch, a creator whose clients are the port's
    GRPCClient on that target, connected when made.  Without grpcio,
    making one raises the reference's RuntimeError naming grpcio."""
    creator = PORT.proxy.ClientCreator.remote("grpc://127.0.0.1:1")
    assert isinstance(creator, PORT.proxy.ClientCreator)
    grpc_mod = importlib.import_module("tendermint_tpu_torch.abci.grpc")
    if grpc_mod.grpc is None:
        with pytest.raises(RuntimeError, match="grpcio"):
            creator.new_client()
        return
    srv = grpc_mod.GRPCServer(PORT.kvstore.KVStoreApplication(),
                              "127.0.0.1:0")
    srv.start()
    try:
        conns = PORT.proxy.AppConns(
            PORT.proxy.ClientCreator.remote(f"grpc://{srv.addr}"))
        try:
            assert isinstance(conns.query, grpc_mod.GRPCClient)
            assert conns.query.echo("ported") == "ported"
        finally:
            conns.stop()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the kvstore
# ---------------------------------------------------------------------------

def _kv_run(p, provable: bool):
    """The same txs, validator updates, misbehavior and snapshots through
    package p's kvstore; every response and query as package-free
    values."""
    abci = p.abci
    app = (p.kvstore.ProvableKVStoreApplication() if provable
           else p.kvstore.KVStoreApplication())
    app.snapshot_interval = 2
    app.snapshot_chunk_size = 256
    rng = random.Random(7)
    pubs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(4)]
    out = [plain(app.init_chain(abci.RequestInitChain(validators=[
        abci.ValidatorUpdate("ed25519", k, 10) for k in pubs])))]
    for h in range(1, 6):
        out.append(plain(app.begin_block(abci.RequestBeginBlock(
            hash=bytes([h]) * 32, byzantine_validators=[abci.Misbehavior(
                type=h % 2 + 1, validator_address=bytes([h]) * 20,
                validator_power=10, height=h, time_seconds=1700000000,
                total_voting_power=40)] if h == 3 else []))))
        txs = [b"k%d_%d=%s" % (h, i, rng.randbytes(8).hex().encode())
               for i in range(20)] + [b"just-a-key-%d" % h]
        if h in (2, 4):
            txs.append(b"val:" + base64.b64encode(
                pubs[h % 4]) + b"!%d" % (h * 3))
        txs.append(b"val:###!x")
        out.append([plain(app.deliver_tx(tx)) for tx in txs])
        out.append(plain(app.end_block(h)))
        out.append(plain(app.commit()))
        for key in (b"k%d_3" % h, b"just-a-key-%d" % h, b"missing"):
            out.append(plain(app.query(abci.RequestQuery(
                data=key, prove=True))))
    snaps = app.list_snapshots()
    out.append(plain(snaps))
    for s in snaps:
        digests = p.integrity.parse_chunk_metadata(s.metadata, s.chunks)
        chunks = [app.load_snapshot_chunk(s.height, s.format, i)
                  for i in range(s.chunks)]
        out.append((s.height, s.chunks, digests, chunks,
                    [p.integrity.verify_chunk(digests, i, c)
                     for i, c in enumerate(chunks)]))
    out.append(plain(app.info(abci.RequestInfo())))
    return out, app.app_hash


@pytest.mark.parametrize("provable", [False, True],
                         ids=["kvstore", "provable"])
def test_kvstore_equal_across_packages(provable):
    """App hashes, every response, queries, validator updates and the
    snapshots with their per-chunk digests (statesync/integrity) equal
    after the same txs."""
    (jout, jhash), (tout, thash) = (_kv_run(p, provable) for p in PKGS)
    assert jhash == thash
    assert jout == tout


def test_kvstore_snapshot_restores_across_packages():
    """A snapshot taken by one package's kvstore restores into the
    other's, chunk by chunk, to the same app hash and data."""
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        a = src.kvstore.KVStoreApplication()
        a.snapshot_interval, a.snapshot_chunk_size = 1, 64
        for i in range(30):
            a.deliver_tx(b"key%d=value%d" % (i, i))
        a.commit()
        s = a.list_snapshots()[-1]
        b = dst.kvstore.KVStoreApplication()
        snap = dst.abci.Snapshot(s.height, s.format, s.chunks, s.hash,
                                 s.metadata)
        assert b.offer_snapshot(snap, a.app_hash).result == \
            dst.abci.ResponseOfferSnapshot.ACCEPT
        for i in range(s.chunks):
            r = b.apply_snapshot_chunk(
                i, a.load_snapshot_chunk(s.height, s.format, i), "peer")
            assert r.result == dst.abci.ResponseApplySnapshotChunk.ACCEPT
        assert (b.app_hash, b.height, b.data) == (a.app_hash, a.height,
                                                   a.data)
