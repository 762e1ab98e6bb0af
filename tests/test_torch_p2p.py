"""The port's P2P transport core (flowrate, the wire codecs, NodeKey,
SecretConnection, the gossip observatory, MConnection, the Switch)
against the JAX package's, on the CPU.

Covered: the two flowrate cases of tests/test_p2p_aux.py with both
Monitors on one injected clock (the module's time.monotonic and
time.sleep), the blocksync golden bytes and NodeInfo cases of
tests/test_p2p_wire.py with every encoding carried across both ways, the
SecretConnection garbage-handshake case of tests/test_fuzz.py, the
tests/test_netobs.py cases that use neither VirtualNetwork nor NetHarness
(those wait for the port's networks/), a SecretConnection between the
two packages, and a Switch of one package syncing a chain from the
other's over TCP on 127.0.0.1 through SecretConnection, MConnection and
the BlocksyncReactor, both ways.  Since the state-sync, RPC and PEX
slice: tests/test_p2p_wire.py's other twelve cases (the mempool, statesync,
PEX and consensus golden bytes, the bit array's layout, the round trips,
the channel registry, the decoder fuzz, truncations) through both packages
with every encoding compared across them; tests/test_p2p_aux.py's fuzzed
connection and trust metric cases on one injected clock; and
tests/test_fuzz.py's proto decoding and mempool cases, each outcome compared
across the packages.  Node keys are seeded.  X25519's
ephemeral keys are random, so what is compared is what is delivered,
never the ciphertext.  Tolerance: exact equality everywhere.
"""
from __future__ import annotations

import importlib
import pickle
import queue
import random
import socket
import threading
import time
import types

import numpy as np
import pytest

from test_torch_blocksync import (BY_NAME, JAX, PKGS, PORT,  # noqa: F401
                                  _clean, build_chain, fresh_node,
                                  make_genesis, pkg, stored_hashes, wait_for)
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_EXTRA = {"flowrate": "libs.flowrate", "netobs": "p2p.netobs",
          "mconn": "p2p.connection", "switch": "p2p.switch",
          "key": "p2p.key", "secret": "p2p.secret_connection",
          "protodec": "libs.protodec", "observatory": "consensus.observatory",
          "cm": "consensus.messages", "evr": "evidence.reactor",
          "mpr": "mempool.reactor", "pex": "p2p.pex",
          "ssr": "statesync.reactor", "bits": "libs.bits",
          "protoenc": "libs.protoenc", "proposal": "types.proposal",
          "vote": "types.vote", "part_set": "types.part_set",
          "trust": "p2p.trust", "fuzz": "p2p.fuzz",
          "pmempool": "mempool.priority_mempool",
          "mempool": "mempool.mempool", "block": "types.block",
          "light_block": "types.light_block"}
for _p in PKGS:
    for _a, _m in _EXTRA.items():
        setattr(_p, _a, importlib.import_module(f"{_p.root}.{_m}"))

CH = 0x7C


@pytest.fixture(autouse=True)
def _fresh_netobs():
    for p in PKGS:
        p.netobs.reset()
        p.netobs.enable()
    yield
    for p in PKGS:
        p.netobs.reset()
        p.fail.clear()


# ---------------------------------------------------------------------------
# flowrate on an injected clock
# ---------------------------------------------------------------------------

class _Clock:
    """time.monotonic and time.sleep of one fake clock: sleep advances it
    and is recorded."""

    def __init__(self, t=100.0):
        self.t = t
        self.sleeps = []

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _on_clock(monkeypatch, p, clk):
    monkeypatch.setattr(p.flowrate, "time", types.SimpleNamespace(
        monotonic=clk.monotonic, sleep=clk.sleep))


def test_flowrate_limits_throughput(monkeypatch):
    """100 KB through a 50 KB/s Monitor: the first 50 KB ride the burst
    credit and the rest is slept off (>= 0.8 s on the clock); the same
    sleeps, totals and rate in both packages."""
    got = {}
    for p in PKGS:
        clk = _Clock()
        _on_clock(monkeypatch, p, clk)
        m = p.flowrate.Monitor(limit_bytes_per_s=50_000)
        t0 = clk.t
        for _ in range(10):
            m.update(10_000)
        assert clk.t - t0 >= 0.8, clk.t - t0
        assert m.total() == 100_000
        got[p.name] = (clk.sleeps, clk.t - t0, m.rate(), m.total())
    assert got["jax"] == got["port"]
    assert len(got["port"][0]) == 5


def test_flowrate_unlimited_is_fast(monkeypatch):
    """limit 0: no sleep at all, in both packages."""
    got = {}
    for p in PKGS:
        clk = _Clock()
        _on_clock(monkeypatch, p, clk)
        m = p.flowrate.Monitor(limit_bytes_per_s=0)
        for _ in range(100):
            assert m.update(1 << 20) == 0.0
        got[p.name] = (clk.sleeps, m.total())
    assert got["jax"] == got["port"] == ([], 100 << 20)


# ---------------------------------------------------------------------------
# wire golden bytes, carried across
# ---------------------------------------------------------------------------

def test_blocksync_golden_bytes(pkg):
    bsr = pkg.reactor
    assert bsr.encode_msg(bsr.BlockRequest(7)) == b"\x0a\x02\x08\x07"
    assert bsr.decode_msg(b"\x0a\x02\x08\x07") == bsr.BlockRequest(7)
    want = b"\x2a\x04\x08\x64\x10\x05"
    assert bsr.encode_msg(bsr.StatusResponse(base=5, height=100)) == want
    got = bsr.decode_msg(want)
    assert (got.base, got.height) == (5, 100)
    assert bsr.encode_msg(bsr.StatusRequest()) == b"\x22\x00"


def _blocksync_msgs(p):
    bsr = p.reactor
    gdoc, privs = make_genesis(p, 4)
    blocks, _, _ = build_chain(p, gdoc, privs, 2)
    return [bsr.BlockRequest(7), bsr.NoBlockResponse(3),
            bsr.BlockResponse(blocks[1].proto()), bsr.StatusRequest(),
            bsr.StatusResponse(base=1, height=2 ** 40)]


def test_blocksync_encodings_cross_both_ways():
    """Every blocksync message through the channel registry
    (wire.encode/decode on 0x40): the bytes are equal and each package
    decodes the other's."""
    enc = {}
    for p in PKGS:
        enc[p.name] = [p.wire.encode(p.reactor.BLOCKSYNC_CHANNEL, m)
                       for m in _blocksync_msgs(p)]
    assert enc["jax"] == enc["port"]
    for p, other in ((PORT, "jax"), (JAX, "port")):
        for data in enc[other]:
            msg = p.wire.decode(p.reactor.BLOCKSYNC_CHANNEL, data)
            assert p.wire.encode(p.reactor.BLOCKSYNC_CHANNEL, msg) == data


def test_node_info_proto_and_compat(pkg):
    NodeInfo = pkg.switch.NodeInfo
    a = NodeInfo(node_id="aa" * 20, listen_addr="1.2.3.4:26656",
                 network="chain-x", version="0.34.20",
                 channels=bytes([0x20, 0x21, 0x22, 0x40]), moniker="a",
                 rpc_address="tcp://0.0.0.0:26657")
    rt = NodeInfo.from_bytes(a.to_bytes())
    assert rt == a
    b = NodeInfo.from_bytes(a.to_bytes())
    assert a.compatible_with(b) is None
    b.protocol_block += 1
    assert "Block version" in a.compatible_with(b)
    b = NodeInfo.from_bytes(a.to_bytes())
    b.network = "other-net"
    assert "different network" in a.compatible_with(b)
    b = NodeInfo.from_bytes(a.to_bytes())
    b.channels = bytes([0x77])
    assert "no common channels" in a.compatible_with(b)
    pd = pkg.protodec
    f = pd.parse(a.to_bytes())
    assert pd.get_string(f, 2) == "aa" * 20
    pv = pd.parse(pd.get_message(f, 1))
    assert pd.get_uint(pv, 2) == 11


def test_node_info_crosses_both_ways():
    kw = dict(node_id="bb" * 20, listen_addr="127.0.0.1:26656",
              network="chain-y", version="0.34.20",
              channels=bytes([0x40]), moniker="m",
              rpc_address="tcp://127.0.0.1:26657")
    jb = JAX.switch.NodeInfo(**kw).to_bytes()
    tb = PORT.switch.NodeInfo(**kw).to_bytes()
    assert jb == tb
    assert PORT.switch.NodeInfo.from_bytes(jb) == PORT.switch.NodeInfo(**kw)
    assert JAX.switch.NodeInfo.from_bytes(tb) == JAX.switch.NodeInfo(**kw)


def _node_key(p, i):
    return p.key.NodeKey(p.ed.PrivKey((0xC0DE + i).to_bytes(32, "big")))


def test_node_ids_equal():
    """The node ID derives from the seeded key alike."""
    for i in range(3):
        assert _node_key(JAX, i).node_id == _node_key(PORT, i).node_id
    assert len(_node_key(PORT, 0).node_id) == 40


# ---------------------------------------------------------------------------
# SecretConnection
# ---------------------------------------------------------------------------

def test_fuzz_secret_connection_handshake_garbage(pkg):
    rng = np.random.default_rng(0xF0220)
    for i in range(12):
        a, b = socket.socketpair()
        errs = []

        def accept():
            try:
                pkg.secret.SecretConnection(a, pkg.ed.PrivKey.generate())
            except Exception as e:  # noqa: BLE001 - the rejection
                errs.append(e)

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        try:
            b.sendall(bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
            b.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        t.join(timeout=10)
        assert not t.is_alive(), "handshake hung on garbage"
        assert errs, "garbage handshake unexpectedly succeeded"
        a.close()
        b.close()


@pytest.mark.parametrize("initiator", ["jax", "port"])
def test_secret_connection_across_packages(initiator):
    """A SecretConnection between the two packages: each side learns the
    other's node ID and frames cross intact both ways."""
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    one = JAX if initiator == "jax" else PORT
    two = PORT if one is JAX else JAX
    box = {}

    def other_side():
        try:
            box["conn"] = two.secret.SecretConnection(
                b, _node_key(two, 1).priv_key)
        except Exception as e:  # noqa: BLE001 - reported below
            box["err"] = e

    t = threading.Thread(target=other_side, daemon=True)
    t.start()
    try:
        c1 = one.secret.SecretConnection(a, _node_key(one, 0).priv_key)
        t.join(timeout=10)
        assert "err" not in box and "conn" in box
        c2 = box["conn"]
        assert c1.remote_node_id == _node_key(PORT, 1).node_id
        assert c2.remote_node_id == _node_key(JAX, 0).node_id
        frames = [b"", b"x", bytes(range(256)) * 40]
        for f in frames:
            c1.send_frame(f)
        assert [c2.recv_frame() for _ in frames] == frames
        c2.send_frame(b"back")
        assert c1.recv_frame() == b"back"
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the gossip observatory (tests/test_netobs.py's cases without a vnet)
# ---------------------------------------------------------------------------

def test_gossip_receipt_accounting_and_flow_rate(pkg):
    netobs = pkg.netobs
    netobs.gossip_receipt("n", "p1", "part", useful=True, latency_s=0.01)
    netobs.gossip_receipt("n", "p2", "part", useful=False)
    netobs.gossip_receipt("n", "p1", "vote", useful=True)
    netobs.flow_rate("n", "p1", send_bps=5.0, recv_bps=7.0)
    flow = netobs.flow_table("n")["n"]
    assert flow["p1"]["useful_parts"] == 1
    assert flow["p1"]["useful_votes"] == 1
    assert flow["p2"]["dup_parts"] == 1
    assert flow["p1"]["rate_send_bps"] == 5.0
    assert flow["p1"]["rate_recv_bps"] == 7.0
    rep = netobs.report("n")
    assert rep["totals"]["useful_receipts"] == 2
    assert rep["totals"]["duplicate_receipts"] == 1
    assert rep["totals"]["duplicate_ratio"] == round(1 / 3, 4)


def test_netobs_tables_equal():
    """The same recordings give the same flow table and report (less the
    wall-clock fields) in both packages."""
    got = {}
    for p in PKGS:
        p.netobs.gossip_receipt("n", "p1", "part", useful=True,
                                latency_s=0.01)
        p.netobs.gossip_receipt("n", "p2", "vote", useful=False)
        p.netobs.sent("n", "p1", CH, 100, queue_wait_s=0.002, depth=2)
        p.netobs.recv("n", "p2", CH, 300)
        p.netobs.rtt("n", "p1", 0.025)
        p.netobs.flow_rate("n", "p1", send_bps=1.0, recv_bps=2.0)
        got[p.name] = p.netobs.flow_table("n")
    assert got["jax"] == got["port"]


def test_observatory_first_useful_delivery_attribution(pkg):
    o = pkg.observatory.Observatory(enabled=True)
    o.stamp("n", 5, "new_height")
    o.useful_receipt("n", 5, "part", "peerX")
    o.useful_receipt("n", 5, "part", "peerY")
    o.useful_receipt("n", 5, "vote", "peerY")
    rec = o.records("n")[0]
    assert rec["first_useful"] == {"part": "peerX", "vote": "peerY"}
    assert rec["useful_from"] == {"part": {"peerX": 1, "peerY": 1},
                                  "vote": {"peerY": 1}}
    o.useful_receipt("n", 99, "part", "peerZ")
    assert [r["height"] for r in o.records("n")] == [5]


def _scrape_value(text: str, needle: str) -> float:
    for ln in text.splitlines():
        if ln.startswith(needle):
            return float(ln.rsplit(" ", 1)[1])
    return 0.0


def test_metrics_scrape_byte_counters_move(pkg):
    netobs, metrics = pkg.netobs, pkg.metrics
    send_k = 'tendermint_p2p_message_send_bytes_total{ch_id="0x7c"}'
    recv_k = 'tendermint_p2p_message_receive_bytes_total{ch_id="0x7c"}'
    before_s = _scrape_value(metrics.DEFAULT.render_text(), send_k)
    before_r = _scrape_value(metrics.DEFAULT.render_text(), recv_k)
    netobs.sent("m1", "p", CH, 111, queue_wait_s=0.001, depth=3)
    netobs.recv("m1", "p", CH, 222)
    netobs.publish_pending()
    text = metrics.DEFAULT.render_text()
    assert _scrape_value(text, send_k) == before_s + 111
    assert _scrape_value(text, recv_k) == before_r + 222
    assert 'tendermint_p2p_channel_queue_depth{ch_id="0x7c"} 3' in text
    netobs.publish_pending()
    assert _scrape_value(metrics.DEFAULT.render_text(),
                         send_k) == before_s + 111


def test_chaos_netobs_record_sheds(pkg):
    """netobs.record=raise: the samples shed and the caller goes on."""
    pkg.fail.set_mode("netobs.record", "raise")
    pkg.netobs.sent("c", "p", CH, 50)
    pkg.netobs.recv("c", "p", CH, 60)
    assert pkg.fail.fired("netobs.record", "raise") >= 2
    pkg.fail.clear()
    flow = pkg.netobs.flow_table("c").get("c", {}).get("p", {})
    assert flow.get("sent_bytes", 0) == 0 and flow.get("recv_bytes", 0) == 0


class _FakeSecret:
    """Duck-typed SecretConnection: scripted inbound frames, captured
    outbound frames."""

    def __init__(self):
        self.sent = []
        self._inbox: "queue.Queue" = queue.Queue()
        self.closed = False

    def send_frame(self, frame):
        self.sent.append(bytes(frame))

    def feed(self, frame: bytes):
        self._inbox.put(frame)

    def recv_frame(self) -> bytes:
        f = self._inbox.get(timeout=30)
        if f is None:
            raise OSError("closed")
        return f

    def close(self):
        self.closed = True
        self._inbox.put(None)


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _chans(p, cap=100):
    return [p.mconn.ChannelDescriptor(CH, priority=1,
                                      send_queue_capacity=cap)]


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def test_mconn_default_clock_is_monotonic(pkg):
    fs = _FakeSecret()
    mc = pkg.mconn.MConnection(fs, _chans(pkg), lambda c, m: None,
                               lambda e: None)
    assert mc._clock is time.monotonic
    mc.stop()


def test_mconn_rtt_and_flow_recorded_on_injected_clock(pkg):
    netobs, mconn = pkg.netobs, pkg.mconn
    clk = _FakeClock(1000.0)
    fs = _FakeSecret()
    got, errs = [], []
    mc = mconn.MConnection(fs, _chans(pkg), lambda c, m: got.append(m),
                           errs.append, obs_node="nodeA", obs_peer="peerB",
                           clock=clk)
    mc.start()
    try:
        assert mc.send(CH, b"hello")
        assert _wait(lambda: any(f[0] == 0x01 for f in fs.sent))
        assert _wait(lambda: netobs.flow_table().get("nodeA", {})
                     .get("peerB", {}).get("sent_bytes", 0) == 7)
        mc._ping_sent_t = clk.t
        clk.t += 0.035
        fs.feed(bytes([mconn._PONG]))
        assert _wait(lambda: mc._ping_sent_t is None)
        assert mc._last_pong == clk.t
        rtt = netobs.flow_table()["nodeA"]["peerB"]["rtt"]
        assert rtt["last_s"] == pytest.approx(0.035)
        fs.feed(bytes([0x01, CH]) + b"payload")
        assert _wait(lambda: got == [b"payload"])
        assert _wait(lambda: netobs.flow_table()
                     ["nodeA"]["peerB"]["recv_bytes"] == 9)
        assert errs == []
    finally:
        mc.stop()
    # the frames on the wire: the data frame, then nothing but keepalive
    assert fs.sent[0] == bytes([0x01, CH]) + b"hello"


def test_mconn_pong_timeout_fires_on_monotonic_clock(monkeypatch, pkg):
    mconn = pkg.mconn
    monkeypatch.setattr(mconn, "PING_INTERVAL", 0.01)
    clk = _FakeClock(1000.0)
    fs = _FakeSecret()
    errs = []
    mc = mconn.MConnection(fs, _chans(pkg), lambda c, m: None, errs.append,
                           clock=clk)
    mc.start()
    try:
        clk.t += mconn.PONG_TIMEOUT + 1.0
        assert _wait(lambda: len(errs) == 1)
        assert isinstance(errs[0], TimeoutError)
        assert fs.closed
    finally:
        mc.stop()


# ---------------------------------------------------------------------------
# a Switch syncing from the other package's over TCP loopback
# ---------------------------------------------------------------------------

def _node(p, i, gdoc, chain=None, window=8):
    """A Switch on 127.0.0.1 (port 0) with a BlocksyncReactor: a server
    holding `chain` (blocks, commits), or an empty client."""
    ex, store, state = fresh_node(p, gdoc)
    if chain is not None:
        for b, c in zip(*chain):
            _bid, parts = p.replay.block_id_of(b)
            store.save_block(b, parts, c)
    reactor = p.reactor.BlocksyncReactor(ex, store, state,
                                         fast_sync=chain is None,
                                         window=window)
    sw = p.switch.Switch(_node_key(p, i), "127.0.0.1:0", gdoc.chain_id,
                         moniker=f"{p.name}{i}")
    sw.add_reactor("BLOCKSYNC", reactor)
    return sw, reactor, store


@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")])
def test_switch_syncs_across_packages(server, client):
    """The client's Switch dials the server's over TCP (SecretConnection,
    NodeInfo, MConnection) and its BlocksyncReactor catches up to height
    24 of a 25-block chain; its stored blocks and state equal the
    server's chain; the netobs byte ledgers moved on both sides."""
    ps, pc = (JAX, PORT) if server == "jax" else (PORT, JAX)
    gdoc_s, privs_s = make_genesis(ps, 4)
    chain_s = build_chain(ps, gdoc_s, privs_s, 25)
    gdoc_c, _ = make_genesis(pc, 4)
    sw_s, r_s, store_s = _node(ps, 0, gdoc_s, chain=chain_s[:2])
    sw_c, r_c, store_c = _node(pc, 1, gdoc_c)
    sw_s.start()
    try:
        sw_c.start()
        try:
            peer = sw_c.dial_peer(sw_s.actual_listen_addr())
            assert peer is not None and peer.id == sw_s.node_key.node_id
            assert wait_for(lambda: r_c.state.last_block_height >= 24,
                            timeout=60)
            assert wait_for(lambda: sw_s.num_peers() == 1)
        finally:
            sw_c.stop()
    finally:
        sw_s.stop()
    assert stored_hashes(store_c)[:24] == [b.hash() for b in chain_s[0][:24]]
    assert r_c.state.app_hash == chain_s[2][23].app_hash
    flow_c = pc.netobs.flow_table().get(f"{pc.name}1", {})
    flow_s = ps.netobs.flow_table().get(f"{ps.name}0", {})
    sent_s = sum(f.get("sent_bytes", 0) for f in flow_s.values())
    recv_c = sum(f.get("recv_bytes", 0) for f in flow_c.values())
    assert sent_s > 25 * 100 and recv_c > 25 * 100



# ---------------------------------------------------------------------------
# tests/test_p2p_wire.py's other cases, through both packages, every
# encoding compared across them
# ---------------------------------------------------------------------------

def _bid(p):
    B = p.basic
    return B.BlockID(b"\x11" * 32, B.PartSetHeader(3, b"\x22" * 32))


def _wire_vote(p):
    B = p.basic
    return p.vote.Vote(type=B.SignedMsgType.PRECOMMIT, height=5, round=1,
                       block_id=_bid(p), timestamp=B.Timestamp(1700000123,
                                                               456),
                       validator_address=b"\x33" * 20, validator_index=2,
                       signature=b"\x44" * 64)


def wire_mempool_golden(p):
    inner = b"\x0a\x02ab\x0a\x00"
    want = b"\x0a" + bytes([len(inner)]) + inner
    assert p.mpr.encode_msg(p.mpr.TxsMessage([b"ab", b""])) == want
    assert p.mpr.decode_msg(want).txs == [b"ab", b""]
    return want


def wire_statesync_golden(p):
    inner = b"\x08\x09\x10\x01\x18\x02"
    want = b"\x1a" + bytes([len(inner)]) + inner
    assert p.ssr.encode_msg(p.ssr.ChunkRequest(9, 1, 2)) == want
    m = p.ssr.decode_msg(want)
    assert (m.height, m.format, m.index) == (9, 1, 2)
    return want


def wire_pex_golden(p):
    na = (b"\x0a\x02ab" + b"\x12\x071.2.3.4"
          + b"\x18" + p.protoenc.uvarint(26656))
    inner = b"\x0a" + bytes([len(na)]) + na
    want = b"\x12" + bytes([len(inner)]) + inner
    assert p.pex.encode_msg(p.pex.PexAddrs([("ab", "1.2.3.4:26656")])) \
        == want
    assert p.pex.decode_msg(want).addrs == [("ab", "1.2.3.4:26656")]
    return want


def wire_consensus_has_vote_golden(p):
    inner = b"\x08\x03\x10\x01\x18\x01\x20\x02"
    want = b"\x3a" + bytes([len(inner)]) + inner
    m = p.cm.HasVoteMessage(3, 1, int(p.basic.SignedMsgType.PREVOTE), 2)
    assert p.cm.encode_msg(m) == want
    got = p.cm.decode_msg(want)
    assert (got.height, got.round, got.type, got.index) == (3, 1, 1, 2)
    return want


def wire_bitarray_layout(p):
    pd, pe = p.protodec, p.protoenc
    ba = p.bits.BitArray.from_indices(10, [0, 8, 9])
    body = ba.proto()
    f = pd.parse(body)
    assert pd.get_int(f, 1) == 10
    assert pd.get_packed_uvarints(f, 2) == [0b1100000001]
    assert p.bits.BitArray.from_proto(body) == ba
    unpacked = pe.varint_field(1, 10) + pe.tag(2, pe.WT_VARINT) \
        + pe.uvarint(0b1100000001)
    assert p.bits.BitArray.from_proto(unpacked) == ba
    return body


def wire_consensus_roundtrips(p):
    cm, B = p.cm, p.basic
    ps = p.part_set.PartSet.from_data(b"x" * 300, part_size=128)
    bid = _bid(p)
    msgs = [
        cm.NewRoundStepMessage(9, 2, 3, -1),
        cm.ProposalGossip(p.proposal.Proposal(
            height=9, round=2, pol_round=-1, block_id=bid,
            timestamp=B.Timestamp(1700000000, 1), signature=b"\x55" * 64)),
        cm.BlockPartGossip(9, 2, ps.get_part(0)),
        cm.VoteGossip(_wire_vote(p)),
        cm.HasVoteMessage(9, 2, int(B.SignedMsgType.PRECOMMIT), 7),
        cm.VoteSetMaj23Message(9, 2, int(B.SignedMsgType.PREVOTE), bid),
        cm.VoteSetBitsMessage(9, 2, int(B.SignedMsgType.PREVOTE), bid, 10,
                              p.bits.BitArray.from_indices(10, [1, 9])
                              .to_bytes()),
    ]
    out = []
    for m in msgs:
        data = cm.encode_msg(m)
        back = cm.decode_msg(data)
        assert type(back) is type(m) and cm.encode_msg(back) == data
        out.append(data)
    m = cm.VoteSetMaj23Message(9, 2, int(B.SignedMsgType.PREVOTE),
                               B.BlockID())
    assert cm.decode_msg(cm.encode_msg(m)).block_id == B.BlockID()
    return out


def wire_blocksync_statesync_evidence_roundtrips(p):
    bsr, ssr, evr = p.reactor, p.ssr, p.evr
    out = []
    for m in (bsr.BlockRequest(4), bsr.NoBlockResponse(5),
              bsr.BlockResponse(b"\x0a\x00"), bsr.StatusRequest(),
              bsr.StatusResponse(2, 9)):
        assert bsr.decode_msg(bsr.encode_msg(m)) == m
        out.append(bsr.encode_msg(m))
    for m in (ssr.SnapshotsRequest(),
              ssr.SnapshotsResponse(7, 1, 4, b"h" * 32, b"meta"),
              ssr.ChunkRequest(7, 1, 2),
              ssr.ChunkResponse(7, 1, 2, b"chunk", False),
              ssr.ChunkResponse(7, 1, 3, b"", True)):
        assert ssr.decode_msg(ssr.encode_msg(m)) == m
        out.append(ssr.encode_msg(m))
    ev = evr.EvidenceGossip([b"\x0a\x00", b"\x12\x00"])
    assert evr.decode_msg(evr.encode_msg(ev)) == ev
    return out + [evr.encode_msg(ev)]


def wire_channel_registry(p):
    for ch in (0x00, 0x20, 0x21, 0x22, 0x30, 0x38, 0x40, 0x60, 0x61):
        assert ch in p.wire._CODECS, f"channel {ch:#x} has no codec"
    with pytest.raises(KeyError):
        p.wire.encode(0x7F, object())
    return sorted(p.wire._CODECS)


def wire_decoders_reject_garbage_and_pickle(p):
    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    decoders = [p.cm.decode_msg, p.reactor.decode_msg, p.mpr.decode_msg,
                p.ssr.decode_msg, p.evr.decode_msg, p.pex.decode_msg]
    rng = random.Random(1234)
    payloads = [pickle.dumps(Evil()), b"\x80\x04."]
    payloads += [bytes(rng.randrange(256) for _ in range(n))
                 for n in (1, 3, 17, 64, 300) for _ in range(40)]
    rejected = []
    for dec in decoders:
        n = 0
        for data in payloads:
            try:
                dec(data)
            except ValueError:
                n += 1
        rejected.append(n)
    return rejected


def wire_truncated_valid_messages_raise(p):
    data = p.cm.encode_msg(p.cm.VoteGossip(_wire_vote(p)))
    raised = []
    for cut in range(1, len(data)):
        try:
            p.cm.decode_msg(data[:cut])
        except ValueError:
            raised.append(cut)
    return raised


def wire_consensus_new_valid_block_and_pol(p):
    cm, B = p.cm, p.basic
    m = cm.NewValidBlockMessage(
        height=9, round=1,
        block_part_set_header=B.PartSetHeader(4, b"\x0b" * 32),
        block_parts=p.bits.BitArray.from_indices(4, [0, 2]), is_commit=True)
    out = cm.decode_msg(cm.encode_msg(m))
    assert (out.height, out.round, out.is_commit) == (9, 1, True)
    assert out.block_part_set_header == m.block_part_set_header
    assert out.block_parts == m.block_parts
    pol = cm.ProposalPOLMessage(
        height=9, proposal_pol_round=0,
        proposal_pol=p.bits.BitArray.from_indices(6, [5]))
    assert cm.decode_msg(cm.encode_msg(pol)).proposal_pol == pol.proposal_pol
    return [cm.encode_msg(m), cm.encode_msg(pol)]


def wire_vote_set_bits_channel_codec_registered(p):
    cm = p.cm
    msg = cm.VoteSetBitsMessage(
        9, 2, int(p.basic.SignedMsgType.PREVOTE), _bid(p), 10,
        p.bits.BitArray.from_indices(10, [1, 9]).to_bytes())
    data = p.wire.encode(cm.VOTE_SET_BITS_CHANNEL, msg)
    assert type(p.wire.decode(cm.VOTE_SET_BITS_CHANNEL, data)) is type(msg)
    return data


WIRE = {fn.__name__[len("wire_"):]: fn for fn in (
    wire_mempool_golden, wire_statesync_golden, wire_pex_golden,
    wire_consensus_has_vote_golden, wire_bitarray_layout,
    wire_consensus_roundtrips, wire_blocksync_statesync_evidence_roundtrips,
    wire_channel_registry, wire_decoders_reject_garbage_and_pickle,
    wire_truncated_valid_messages_raise,
    wire_consensus_new_valid_block_and_pol,
    wire_vote_set_bits_channel_codec_registered)}


@pytest.mark.parametrize("case", sorted(WIRE))
def test_p2p_wire_case(case):
    """The JAX test's case, its assertions, in each package; the encodings
    and counts it yields are the same in both."""
    assert WIRE[case](JAX) == WIRE[case](PORT)


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_pex_and_statesync_messages_cross(src, dst):
    """PEX (0x00) and statesync (0x60, 0x61) messages encoded by one package
    decode in the other to the same values and re-encode to the same
    bytes."""
    ps, pd_ = BY_NAME[src], BY_NAME[dst]
    for m_s, codec in (
            (ps.pex.PexRequest(), "pex"),
            (ps.pex.PexAddrs([("ab" * 20, "10.0.0.1:26656"),
                              ("cd" * 20, "10.0.0.2:1")]), "pex"),
            (ps.ssr.SnapshotsResponse(100, 1, 205, b"h" * 32, b"m"), "ssr"),
            (ps.ssr.ChunkResponse(100, 1, 7, b"c" * 100, busy=True,
                                  retry_after_ms=250), "ssr")):
        data = getattr(ps, codec).encode_msg(m_s)
        m_d = getattr(pd_, codec).decode_msg(data)
        assert getattr(pd_, codec).encode_msg(m_d) == data
        assert plain(m_d) == plain(m_s)
        assert ps.wire.decode(0x00 if codec == "pex" else 0x61,
                              data) == m_s


# ---------------------------------------------------------------------------
# tests/test_p2p_aux.py's fuzz and trust cases, tests/test_fuzz.py's proto
# decoding and mempool cases
# ---------------------------------------------------------------------------

class _PipeConn:
    def __init__(self):
        self.sent = []
        self.inbox = []

    def send_frame(self, data):
        self.sent.append(data)

    def recv_frame(self):
        return self.inbox.pop(0)

    def close(self):
        pass


def test_fuzzed_connection_drops_frames():
    got = {}
    for p in PKGS:
        inner = _PipeConn()
        fz = p.fuzz.FuzzedConnection(inner, p.fuzz.FuzzConnConfig(
            prob_drop_rw=0.5, prob_sleep=0.0), rng=random.Random(42))
        for i in range(200):
            fz.send_frame(b"x%d" % i)
        assert 0 < len(inner.sent) < 200
        assert fz.dropped_frames == 200 - len(inner.sent)
        inner.inbox = [b"a", b"b", b"c", b"d", b"e", b"f"]
        first = fz.recv_frame()
        assert first in (b"a", b"b", b"c", b"d", b"e", b"f")
        got[p.name] = (inner.sent, fz.dropped_frames, first)
    assert got["jax"] == got["port"]


def test_fuzz_start_after_grace():
    got = {}
    for p in PKGS:
        inner = _PipeConn()
        fz = p.fuzz.FuzzedConnection(inner, p.fuzz.FuzzConnConfig(
            prob_drop_rw=1.0, start_after_s=60.0), rng=random.Random(1))
        fz.send_frame(b"hello")
        assert inner.sent == [b"hello"]
        got[p.name] = inner.sent
    assert got["jax"] == got["port"]


def _trust_clock(monkeypatch, p, clk):
    monkeypatch.setattr(p.trust, "time", types.SimpleNamespace(
        monotonic=clk.monotonic))


def test_trust_metric_declines_on_bad_events(monkeypatch):
    """tests/test_p2p_aux.py:89 with its sleeps on one injected clock: the
    same trust values in both packages."""
    got = {}
    for p in PKGS:
        clk = _Clock()
        _trust_clock(monkeypatch, p, clk)
        tm = p.trust.TrustMetric(interval_s=0.05, max_history=4)
        vals = [tm.value()]
        assert vals[0] == pytest.approx(1.0)
        tm.bad_events(10)
        vals.append(tm.value())
        assert vals[-1] < 1.0
        clk.sleep(0.06)
        tm.bad_events(10)
        vals.append(tm.value())
        assert vals[-1] < 0.9
        for _ in range(6):
            clk.sleep(0.06)
            tm.good_events(20)
        vals.append(tm.value())
        assert vals[-1] > vals[2]
        got[p.name] = vals
    assert got["jax"] == got["port"]


def test_trust_store(monkeypatch):
    got = {}
    for p in PKGS:
        clk = _Clock()
        _trust_clock(monkeypatch, p, clk)
        st = p.trust.TrustMetricStore()
        assert st.peer_trust("unknown") == 1.0
        st.get("p1").bad_events(5)
        assert st.peer_trust("p1") < 1.0
        assert st.size() == 1
        small = p.trust.TrustMetricStore(max_size=2)
        for i in range(5):
            small.get(f"q{i}")
        got[p.name] = (st.peer_trust("p1"), small.size())
    assert got["jax"] == got["port"] == (got["port"][0], 2)


def _fuzz_rng():
    return np.random.default_rng(0xF0220)


def _mutations(rng, valid: bytes):
    yield bytes(rng.integers(0, 256, int(rng.integers(0, 200)),
                             dtype=np.uint8))
    if valid:
        n = len(valid)
        yield valid[: int(rng.integers(0, n))]
        b = bytearray(valid)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, n))] ^= int(rng.integers(1, 256))
        yield bytes(b)


def test_fuzz_proto_decoding_block_vote_commit():
    """tests/test_fuzz.py:35 through both packages on the same chain and
    mutations: every decode either raises (never SystemExit or
    MemoryError) or yields an object whose hash works, and the two
    packages agree decode for decode."""
    got = {}
    for p in PKGS:
        gdoc, privs = make_genesis(p, 2)
        blocks, commits, _ = build_chain(p, gdoc, privs, 2)
        valids = [(p.block.Block, blocks[-1].proto()),
                  (p.commit.Commit, commits[-1].proto()),
                  (p.vote.Vote, b""),
                  (p.light_block.SignedHeader, b"")]
        rng = _fuzz_rng()
        rows = []
        for _ in range(100):
            for cls, valid in valids:
                for data in _mutations(rng, valid):
                    try:
                        obj = cls.from_proto(data)
                        rows.append(obj.hash() if hasattr(obj, "hash")
                                    else "ok")
                    except Exception as e:  # noqa: BLE001 - the outcome
                        assert not isinstance(e, (SystemExit, MemoryError))
                        rows.append(type(e).__name__)
                    try:
                        p.protodec.parse(data)
                    except p.protodec.ProtoError:
                        pass
        got[p.name] = rows
    assert got["jax"] == got["port"]


def test_fuzz_mempool_check_tx():
    """tests/test_fuzz.py:70 through both packages: the same random txs
    through both mempool versions, the same responses and sizes."""
    got = {}
    for p in PKGS:
        rng = _fuzz_rng()
        rows = []
        for cls in (p.mempool.Mempool, p.pmempool.PriorityMempool):
            mp = cls(p.kvstore.KVStoreApplication(), size_limit=50)
            for _ in range(300):
                tx = bytes(rng.integers(0, 256, int(rng.integers(0, 80)),
                                        dtype=np.uint8))
                try:
                    r = mp.check_tx(tx)
                    rows.append((r.code, r.log))
                except Exception as e:  # noqa: BLE001 - the outcome
                    assert "mempool" in type(e).__name__.lower() or \
                        isinstance(e, ValueError), e
                    rows.append(type(e).__name__)
            assert mp.size() <= 50
            rows.append(mp.size())
        got[p.name] = rows
    assert got["jax"] == got["port"]
