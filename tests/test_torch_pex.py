"""The port's PEX (p2p/pex.py: AddrBook, PexReactor) and trust metric store
against the JAX package's, on the CPU.

tests/test_pex.py's five cases run through both packages: the address
book's bookkeeping, selection, ban and persistence (each outcome compared
across the packages: the sizes, memberships and the file a book saves,
read back by the other package), and the socket-level discovery and flood
guard over Switches on 127.0.0.1.  Beside them, a JAX PexReactor and a
port one exchanging addresses over two Switches, both ways.  Node keys are
seeded; the book's random picks are compared by what they must satisfy.
Every case that opens sockets runs under a time limit of its own.
Tolerance: exact equality.
"""
from __future__ import annotations

import hashlib
import importlib
import json
import os
import tempfile
import time
import types

import pytest

from test_torch_blocksync import wait_for
from test_torch_statesync import run_limited
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401

_MODS = {"pex": "p2p.pex", "switch": "p2p.switch", "key": "p2p.key",
         "ed": "crypto.ed25519", "trust": "p2p.trust", "fail": "libs.fail"}


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


def _nid(i: int) -> str:
    return f"{i:040x}"


# ---------------------------------------------------------------------------
# tests/test_pex.py's address-book cases
# ---------------------------------------------------------------------------

def case_addrbook_add_pick_good_bad(p):
    book = p.pex.AddrBook()
    assert book.is_empty()
    for i in range(100):
        assert book.add_address(_nid(i), f"10.0.{i}.1:26656",
                                src_id=_nid(1000 + i % 3))
    assert book.size() == 100
    ka = book.pick_address(new_bias_pct=100)
    assert ka is not None and not ka.is_old()
    book.mark_good(_nid(7))
    assert book._addrs[_nid(7)].is_old()
    assert book.pick_address(new_bias_pct=0).is_old()
    for _ in range(4):
        book.mark_attempt(_nid(8))
    assert not book.has(_nid(8))
    for _ in range(4):
        book.mark_attempt(_nid(7))
    assert book.has(_nid(7))
    book.add_our_id(_nid(42))
    assert not book.has(_nid(42))
    assert not book.add_address(_nid(42), "1.2.3.4:1")
    return {"size": book.size(), "old": sorted(
        n for n, ka in book._addrs.items() if ka.is_old())}


def case_addrbook_selection_and_ban(p):
    book = p.pex.AddrBook()
    for i in range(500):
        book.add_address(_nid(i), f"{10 + i % 100}.{i % 250}.0.1:26656")
    assert book.size() == 500
    sel = book.get_selection()
    assert 32 <= len(sel) <= p.pex.MAX_GET_SELECTION
    assert len(sel) == 115 and len({nid for nid, _ in sel}) == len(sel)
    flood = p.pex.AddrBook()
    for i in range(500):
        flood.add_address(_nid(1000 + i), f"10.0.{i % 250}.1:26656")
    assert flood.size() < 200
    book.mark_bad(_nid(3))
    assert not book.has(_nid(3)) and book.is_banned(_nid(3))
    return {"selection": len(sel), "flood": flood.size(),
            "size": book.size()}


def case_addrbook_persistence_roundtrip(p):
    tmp = os.path.join(tempfile.mkdtemp(prefix="tm_pex_"), "addrbook.json")
    book = p.pex.AddrBook(tmp)
    for i in range(40):
        book.add_address(_nid(i), f"10.0.{i}.1:26656")
    book.mark_good(_nid(5))
    book.save()
    book2 = p.pex.AddrBook(tmp)
    assert book2.size() == 40 and book2._addrs[_nid(5)].is_old()
    assert any(_nid(5) in b for b in book2._old)
    with open(tmp) as f:
        saved = json.load(f)
    return {"path": tmp, "size": book2.size(),
            "keys": sorted(saved) if isinstance(saved, dict) else None}


CASES = {fn.__name__[len("case_"):]: fn for fn in (
    case_addrbook_add_pick_good_bad, case_addrbook_selection_and_ban,
    case_addrbook_persistence_roundtrip)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_addrbook_case_equal(case):
    """The JAX test's case, its assertions, in each package; the outcomes
    are the same (a saved book's file path aside)."""
    got = {p.name: CASES[case](p) for p in PKGS}
    for g in got.values():
        g.pop("path", None)
    assert got["jax"] == got["port"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_saved_book_read_by_the_other_package(writer, reader):
    """A book saved by one package loads in the other with the same
    addresses, old entries and buckets."""
    pw, pr = BY_NAME[writer], BY_NAME[reader]
    tmp = os.path.join(tempfile.mkdtemp(prefix="tm_pex_"), "addrbook.json")
    book = pw.pex.AddrBook(tmp)
    for i in range(40):
        book.add_address(_nid(i), f"10.{i}.0.1:26656", src_id=_nid(999))
    for i in (3, 5, 9):
        book.mark_good(_nid(i))
    book.save()
    back = pr.pex.AddrBook(tmp)
    assert back.size() == 40
    assert sorted(n for n, ka in back._addrs.items() if ka.is_old()) == \
        [_nid(3), _nid(5), _nid(9)]
    assert {n: ka.addr for n, ka in back._addrs.items()} == \
        {n: ka.addr for n, ka in book._addrs.items()}
    assert [sorted(b) for b in back._old] == [sorted(b) for b in book._old]


# ---------------------------------------------------------------------------
# tests/test_pex.py's socket cases
# ---------------------------------------------------------------------------

def _node_key(p, tag: str):
    return p.key.NodeKey(p.ed.PrivKey(hashlib.sha256(
        b"pex " + tag.encode()).digest()))


def _mk_switch(p, tag, reactor):
    sw = p.switch.Switch(_node_key(p, tag), "127.0.0.1:0",
                         network="pex-chain", moniker=tag)
    sw.add_reactor("PEX", reactor)
    reactor.book.add_our_id(sw.node_key.node_id)
    sw.start()
    assert reactor.is_running()
    return sw


def _discovery(pa, pb, pc):
    """A (package pa) knows only B (pb); C (pc) is connected to B.  A must
    learn C's address through a PEX exchange with B and dial it."""
    ps = (pa, pb, pc)
    books = [p.pex.AddrBook() for p in ps]
    reactors = [p.pex.PexReactor(books[i], ensure_period_s=0.5,
                                 target_out_peers=4)
                for i, p in enumerate(ps)]
    switches = [_mk_switch(p, f"{p.name}{i}", reactors[i])
                for i, p in enumerate(ps)]
    try:
        addr = [sw.actual_listen_addr() for sw in switches]
        nid = [sw.node_key.node_id for sw in switches]
        assert switches[2].dial_peer(f"{nid[1]}@{addr[1]}") is not None
        books[1].add_address(nid[2], addr[2], src_id=nid[2])
        assert switches[0].dial_peer(f"{nid[1]}@{addr[1]}") is not None
        assert wait_for(lambda: nid[2] in switches[0].peers, 15)
        assert books[0].has(nid[2]), "A never learned C's address"
        return {"a_learned": books[0].has(nid[2]),
                "a_dialed": nid[2] in switches[0].peers}
    finally:
        for sw in switches:
            sw.stop()


def test_pex_discovery_over_sockets(pkg):
    assert run_limited(lambda: _discovery(pkg, pkg, pkg), 60) == {
        "a_learned": True, "a_dialed": True}


@pytest.mark.parametrize("a,b", [("port", "jax"), ("jax", "port")])
def test_pex_exchange_across_packages(a, b):
    """A of package `a` learns C's address from B of package `b` over the
    PEX channel (the PexRequest/PexAddrs proto crosses) and dials C."""
    pa, pb = BY_NAME[a], BY_NAME[b]
    assert run_limited(lambda: _discovery(pa, pb, pb), 60) == {
        "a_learned": True, "a_dialed": True}


def _flood(pa, pb, slow_accept_s=0.0):
    """The flooding peer (of package pa) dials the guard (of pb) and sends
    PexRequests past the guard's one an ensure period.  The dialer's
    dial_peer returns once its own side of the handshake is done; the
    guard may add the inbound peer later (under load, or slow_accept_s
    later here), so the wait is for the ban and the dropped peer both: a
    wait for "no peer" alone passes at once while the guard has not added
    the peer yet, and the ban is then not there to see."""
    books = [pa.pex.AddrBook(), pb.pex.AddrBook()]
    reactors = [pa.pex.PexReactor(books[0], ensure_period_s=30.0),
                pb.pex.PexReactor(books[1], ensure_period_s=30.0)]
    if slow_accept_s:
        add = reactors[1].add_peer

        def slow_add(peer):
            time.sleep(slow_accept_s)
            add(peer)
        reactors[1].add_peer = slow_add
    switches = [_mk_switch(pa, f"flood-{pa.name}", reactors[0]),
                _mk_switch(pb, f"guard-{pb.name}", reactors[1])]
    try:
        addr1 = switches[1].actual_listen_addr()
        nid1 = switches[1].node_key.node_id
        nid0 = switches[0].node_key.node_id
        peer = switches[0].dial_peer(f"{nid1}@{addr1}")
        assert peer is not None
        peer.send(pa.pex.PEX_CHANNEL, pa.pex.PexRequest())
        peer.send(pa.pex.PEX_CHANNEL, pa.pex.PexRequest())
        assert wait_for(lambda: books[1].is_banned(nid0)
                        and switches[1].num_peers() == 0, 10)
        return True
    finally:
        for sw in switches:
            sw.stop()


@pytest.mark.parametrize("a,b", [("jax", "jax"), ("port", "port"),
                                 ("jax", "port"), ("port", "jax")])
def test_pex_request_flood_disconnects(a, b):
    """More than one PexRequest an ensure period: the guard (of package
    b) drops and bans the flooding peer (of package a)."""
    assert run_limited(lambda: _flood(BY_NAME[a], BY_NAME[b]), 60)


@pytest.mark.parametrize("b", ["jax", "port"])
def test_pex_flood_guard_holds_a_slow_accept(b):
    """The guard's side of the connection added half a second after the
    dialer's (as a loaded host does): the flooding peer is still banned
    and dropped, and the wait sees it."""
    assert run_limited(lambda: _flood(BY_NAME["port"], BY_NAME[b],
                                      slow_accept_s=0.5), 60)


def test_trust_store_feeds_the_reactor():
    """The reactor's trust store is the port's TrustMetricStore: a peer
    removed for an error loses trust as in the JAX package."""
    got = {}
    for p in PKGS:
        r = p.pex.PexReactor(p.pex.AddrBook())
        assert isinstance(r.trust, p.trust.TrustMetricStore)
        r.trust.get("x").bad_events()
        got[p.name] = r.trust.peer_trust("x") < 1.0
    assert got == {"jax": True, "port": True}


def test_pex_channel_registered():
    for p in PKGS:
        assert p.pex.PEX_CHANNEL == 0x00
        from importlib import import_module
        wire = import_module(f"{p.root}.p2p.wire")
        assert 0x00 in wire._CODECS
