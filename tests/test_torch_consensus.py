"""The port's consensus (the state machine, its reactor, the wire messages,
the ticker, the WAL generator) against the JAX package's, on the CPU.

tests/test_consensus.py's twelve cases, tests/test_vote_batching.py's two
and the six helpers.Node cases of tests/test_propose_fastpath.py run
through both packages (the `pkg` parameter; the port on device="cpu").
The port side gets its own `Node` and `wire` builders here, copies of
tests/helpers.py's that take the package.  Then what only crosses the
packages can show:

  * a deterministic replay: the JAX package's generate_wal writes a WAL;
    its proposals, parts and votes are carried across as the bytes of
    the matching gossip message (messages.encode_msg, decoded by the
    port's decode_msg) and applied to a JAX and a port ConsensusState over
    the same genesis (the ticker stopped, no priv validator): the same
    block hash, app hash and RoundState (height, round, step, vote
    bitmaps) after every message;
  * encode_msg bytes equal across the packages for every message type,
    each package's decode_msg reading the other's bytes;
  * a mixed localnet: two JAX and two port nodes on Switches over
    127.0.0.1 commit the same chain;
  * a ConsensusState whose priv validator is a SignerClient served by a
    SignerServer commits blocks;
  * the port's departures: the device follows the executor; with no CUDA
    and no device="cpu" the constructor raises; a pre-verify launch that
    failed on the card ends the receive routine with `device_error`,
    applies and logs no vote of its batch and calls no host
    verify_signature, and a fresh state over the same stores and WAL
    resumes; in a chaos drill the JAX package's outcome holds; any other
    exception of the pre-verify is still swallowed; a card fault in the
    WAL catch-up or in apply_block ends the state machine the same way;
  * a fault of the JAX package that the port repairs: a block whose part
    set +2/3 votes put in place of a later round's proposal is assembled
    and committed (the JAX package waits in COMMIT for good).

Tolerance: exact equality everywhere.
"""
from __future__ import annotations

import copy
import importlib
import os
import shutil
import tempfile
import time
import types

import pytest
import torch

import tendermint_tpu_torch as T
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_MODS = {
    "kvstore": "abci.kvstore", "kvdb": "libs.kvdb", "fail": "libs.fail",
    "bits": "libs.bits", "sstore": "state.store",
    "bstore": "store.block_store", "execution": "state.execution",
    "state": "state.state", "obsv": "consensus.observatory",
    "basic": "types.basic", "genesis": "types.genesis",
    "vote": "types.vote", "proposal": "types.proposal",
    "part_set": "types.part_set", "event_bus": "types.event_bus",
    "ed": "crypto.ed25519", "merkle": "crypto.merkle",
    "batch": "crypto.batch", "scheduler": "crypto.scheduler",
    "degrade": "crypto.degrade", "lanepool": "crypto.lanepool",
    "evidence": "evidence", "mempool": "mempool.mempool",
    "file_pv": "privval.file_pv", "signer": "privval.signer",
    "config": "consensus.config", "cstate": "consensus.state",
    "rt": "consensus.round_types", "ticker": "consensus.ticker",
    "wal": "consensus.wal", "messages": "consensus.messages",
    "reactor": "consensus.reactor", "walgen": "consensus.wal_generator",
    "switch": "p2p.switch", "key": "p2p.key", "metrics": "libs.metrics",
}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)
CHAIN_ID = "test-chain-tpu"


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No scheduler, failpoint, lane pool, observatory record or verified
    signature crosses a test, in either package: the seeded keys sign the
    same votes in many tests, and a SigCache hit would hide a verify."""
    for p in PKGS:
        monkeypatch.setattr(p.batch, "verified_sigs", p.batch.SigCache())
        p.obsv.reset()
        p.lanepool.set_workers(None)
        p.lanepool.close()
    yield
    for p in PKGS:
        p.fail.reset()
        s = p.scheduler.installed()
        if s is not None:
            if s.is_running():
                s.stop()
            p.scheduler.uninstall(s)
        p.obsv.reset()
        p.lanepool.set_workers(None)
        p.lanepool.close()


# ---------------------------------------------------------------------------
# tests/helpers.py's builders, for either package
# ---------------------------------------------------------------------------

def make_genesis(p, n_validators: int, power: int = 10,
                 chain_id: str = CHAIN_ID):
    privs = [p.ed.PrivKey((0xBEE + i).to_bytes(32, "big"))
             for i in range(n_validators)]
    G = p.genesis
    gdoc = G.GenesisDoc(
        chain_id=chain_id, genesis_time=p.basic.Timestamp(1700000000, 0),
        validators=[G.GenesisValidator(
            address=k.pub_key().address(), pub_key_type="ed25519",
            pub_key_bytes=k.pub_key().bytes(), power=power) for k in privs])
    return gdoc, privs


def _dev(p):
    """The port's constructors on device="cpu"; the JAX package's take
    none."""
    return {"device": "cpu"} if p is PORT else {}


class Node:
    """tests/helpers.py's Node (one in-process consensus node over its own
    kvstore app) through package `p`; `pv` replaces the FilePV of `priv`
    (a remote signer's client)."""

    def __init__(self, p, gdoc, priv, name: str = "", wal_path=None,
                 config=None, pv=None):
        self.p = p
        self.app = p.kvstore.KVStoreApplication()
        self.mempool = p.mempool.Mempool(self.app)
        self.state_store = p.sstore.StateStore(p.kvdb.MemDB())
        self.block_store = p.bstore.BlockStore(p.kvdb.MemDB())
        self.event_bus = p.event_bus.EventBus()
        state = p.state.state_from_genesis(gdoc)
        self.state_store.save(state)  # before EvidencePool: it caches state
        self.evidence_pool = p.evidence.EvidencePool(
            p.kvdb.MemDB(), self.state_store, self.block_store, **_dev(p))
        self.exec = p.execution.BlockExecutor(
            self.state_store, self.app, mempool=self.mempool,
            evidence_pool=self.evidence_pool, event_bus=self.event_bus,
            **_dev(p))
        self.pv = pv if pv is not None else (
            p.file_pv.FilePV(priv) if priv is not None else None)
        self.cs = p.cstate.ConsensusState(
            config or p.config.test_config(), state, self.exec,
            self.block_store, mempool=self.mempool, priv_validator=self.pv,
            wal_path=wal_path, event_bus=self.event_bus, name=name,
            evidence_pool=self.evidence_pool)
        self.mempool.on_new_tx(self.cs.notify_txs_available)

    def start(self):
        self.cs.start()

    def stop(self):
        self.cs.stop()


def wire(nodes):
    """Full-mesh gossip: every node's broadcasts feed every other node's
    queues (tests/helpers.py's wire)."""
    for i, a in enumerate(nodes):
        peers = [b for j, b in enumerate(nodes) if j != i]
        pid = f"node{i}"

        def on_vote(vote, peers=peers, pid=pid):
            for b in peers:
                b.cs.add_vote(vote, peer_id=pid)

        def on_proposal(pr, peers=peers, pid=pid):
            for b in peers:
                b.cs.set_proposal(pr, peer_id=pid)

        def on_part(h, r, part, peers=peers, pid=pid):
            for b in peers:
                b.cs.add_block_part(h, r, part, peer_id=pid)
        a.cs.broadcast_vote.append(on_vote)
        a.cs.broadcast_proposal.append(on_proposal)
        a.cs.broadcast_block_part.append(on_part)


def wait_for_height(nodes, height: int, timeout: float = 30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(n.block_store.height() >= height for n in nodes):
            return True
        if any(not n.cs.is_running() for n in nodes):
            raise RuntimeError("a consensus state machine died")
        time.sleep(0.05)
    raise TimeoutError(
        f"heights: {[n.block_store.height() for n in nodes]}, wanted "
        f"{height}")


def wait_for(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


# ---------------------------------------------------------------------------
# tests/test_consensus.py
# ---------------------------------------------------------------------------

def test_single_validator_produces_blocks(pkg):
    gdoc, privs = make_genesis(pkg, 1)
    node = Node(pkg, gdoc, privs[0], "solo")
    node.start()
    try:
        wait_for_height([node], 3, timeout=30)
        b1 = node.block_store.load_block(1)
        b2 = node.block_store.load_block(2)
        assert b1 is not None and b2 is not None
        assert b2.last_commit is not None
        assert b2.header.last_block_id.hash == b1.hash()
        sc = node.block_store.load_seen_commit(1)
        assert sc is not None and sc.height == 1
    finally:
        node.stop()


def test_four_validators_commit_same_chain(pkg):
    gdoc, privs = make_genesis(pkg, 4)
    nodes = [Node(pkg, gdoc, k, f"v{i}") for i, k in enumerate(privs)]
    wire(nodes)
    for n in nodes:
        n.start()
    try:
        wait_for_height(nodes, 3, timeout=45)
        h1 = {n.block_store.load_block(1).hash() for n in nodes}
        h2 = {n.block_store.load_block(2).hash() for n in nodes}
        assert len(h1) == 1 and len(h2) == 1, "nodes disagree on chain"
    finally:
        for n in nodes:
            n.stop()


def test_tx_inclusion_and_app_state(pkg):
    gdoc, privs = make_genesis(pkg, 1)
    node = Node(pkg, gdoc, privs[0], "solo-tx")
    node.start()
    try:
        assert node.mempool.check_tx(b"alice=1000").is_ok()
        assert wait_for(lambda: node.app.data.get(b"alice") == b"1000")
        assert node.mempool.size() == 0  # removed after commit
    finally:
        node.stop()


def test_three_of_four_liveness(pkg):
    """Consensus proceeds with one validator down (2/3+ alive)."""
    gdoc, privs = make_genesis(pkg, 4)
    nodes = [Node(pkg, gdoc, k, f"l{i}") for i, k in enumerate(privs[:3])]
    wire(nodes)
    for n in nodes:
        n.start()
    try:
        wait_for_height(nodes, 2, timeout=60)
    finally:
        for n in nodes:
            n.stop()


def test_wal_written_and_replayable(pkg, tmp_path):
    wal_path = str(tmp_path / "cs.wal")
    gdoc, privs = make_genesis(pkg, 1)
    node = Node(pkg, gdoc, privs[0], "walnode", wal_path=wal_path)
    node.start()
    try:
        wait_for_height([node], 2, timeout=30)
    finally:
        node.stop()
    msgs = list(pkg.wal.WAL.iter_messages(wal_path))
    assert msgs, "WAL empty"
    ends = [m for m in msgs if isinstance(m, pkg.wal.EndHeightMessage)]
    assert any(m.height == 1 for m in ends)
    # torn tail tolerance: truncate mid-frame, iteration still works
    with open(wal_path, "ab") as f:
        f.write(b"\x00\x01\x02")
    assert len(list(pkg.wal.WAL.iter_messages(wal_path))) == len(msgs)


def _restart(p, node, wal_path, name):
    """A fresh ConsensusState over node's stores, mempool and WAL, with a
    fresh app (test_consensus.py's handshake-free restart)."""
    st = node.state_store.load()
    ex = p.execution.BlockExecutor(node.state_store,
                                   p.kvstore.KVStoreApplication(),
                                   mempool=node.mempool, **_dev(p))
    return p.cstate.ConsensusState(
        p.config.test_config(), st, ex, node.block_store,
        mempool=node.mempool, priv_validator=node.pv, wal_path=wal_path,
        name=name)


def test_crash_recovery_resumes_chain(pkg, tmp_path):
    """Stop a node mid-chain; a fresh node over the same stores+WAL resumes
    from the persisted height (handshake-free restart path)."""
    wal_path = str(tmp_path / "cs2.wal")
    gdoc, privs = make_genesis(pkg, 1)
    node = Node(pkg, gdoc, privs[0], "crash1", wal_path=wal_path)
    node.start()
    try:
        wait_for_height([node], 2, timeout=30)
    finally:
        node.stop()
    committed = node.block_store.height()
    assert committed >= 2
    st = node.state_store.load()
    assert st is not None and st.last_block_height == committed
    cs2 = _restart(pkg, node, wal_path, "crash2")
    cs2.start()
    try:
        assert wait_for(lambda: node.block_store.height() >= committed + 2)
    finally:
        cs2.stop()


def test_byzantine_peer_messages_do_not_kill_node(pkg):
    """Malformed peer proposals/parts are dropped, not escalated to a
    consensus failure; a part-set total above max_bytes is refused."""
    B = pkg.basic
    gdoc, privs = make_genesis(pkg, 1)
    node = Node(pkg, gdoc, privs[0], name="victim")
    node.start()
    try:
        evil_psh = B.PartSetHeader(total=1 << 30, hash=b"\xEE" * 32)
        evil = pkg.proposal.Proposal(
            height=1, round=0, pol_round=-1,
            block_id=B.BlockID(b"\xEE" * 32, evil_psh),
            timestamp=B.Timestamp.now(), signature=b"\x01" * 64)
        node.cs.set_proposal(evil, peer_id="attacker")
        bad_part = pkg.part_set.Part(
            index=0, bytes_=b"\xFF" * 100,
            proof=pkg.merkle.Proof(total=1, index=0,
                                   leaf_hash=b"\x00" * 32, aunts=[]))
        node.cs.add_block_part(1, 0, bad_part, peer_id="attacker")
        wait_for_height([node], 2, timeout=30)
        assert node.cs.is_running()
    finally:
        node.stop()


def test_stale_round_own_part_not_fatal(pkg):
    """An internal part for a round the node is not in is a stale-message
    drop, not an invariant violation."""
    gdoc, privs = make_genesis(pkg, 1)
    node = Node(pkg, gdoc, privs[0], name="stale")
    node.start()
    try:
        wait_for_height([node], 2, timeout=30)
        stale = pkg.part_set.Part(
            index=0, bytes_=b"\xAB" * 64,
            proof=pkg.merkle.Proof(total=1, index=0,
                                   leaf_hash=b"\x11" * 32, aunts=[]))
        h = node.cs.rs.height
        node.cs.add_block_part(h, 99, stale, peer_id="")
        wait_for_height([node], h + 1, timeout=30)
        assert node.cs.is_running()
    finally:
        node.stop()


def test_late_own_precommit_from_earlier_round_not_fatal(pkg):
    """An own precommit of the previous height at a round last_commit does
    not track is dropped, not raised through the receive routine."""
    gdoc, privs = make_genesis(pkg, 1)
    node = Node(pkg, gdoc, privs[0], name="lateown")
    node.start()
    try:
        wait_for_height([node], 3, timeout=30)
        cs = node.cs
        with cs._mtx:
            rs = cs.rs
            assert rs.last_commit is not None
            prev_h = rs.height - 1
            tmpl = next(copy.copy(v) for v in rs.last_commit.votes
                        if v is not None)
            tmpl.round = rs.last_commit.round + 1
        cs._internal_queue.put((pkg.rt.VoteMessage(tmpl), ""))
        wait_for_height([node], rs.height + 1, timeout=30)
        assert cs.is_running()
        assert tmpl.height == prev_h
        assert tmpl.type == pkg.basic.SignedMsgType.PRECOMMIT
    finally:
        node.stop()


def _ti(p, duration, height=1, round_=0):
    return p.rt.TimeoutInfo(duration=duration, height=height, round=round_,
                            step=p.rt.Step.PROPOSE)


def test_ticker_newer_schedule_replaces_older(pkg):
    fired = []
    t = pkg.ticker.TimeoutTicker(fired.append)
    try:
        t.schedule(_ti(pkg, 0.3, height=1))
        t.schedule(_ti(pkg, 0.05, height=2))
        assert wait_for(lambda: fired, timeout=5)
        time.sleep(0.4)
        assert [ti.height for ti in fired] == [2], fired
    finally:
        t.stop()


def test_ticker_stale_fire_is_dropped(pkg):
    fired = []
    t = pkg.ticker.TimeoutTicker(fired.append)
    try:
        t.schedule(_ti(pkg, 60.0, height=1))
        stale_gen = t._gen
        t.schedule(_ti(pkg, 60.0, height=2))
        t._fire(_ti(pkg, 60.0, height=1), stale_gen)
        assert fired == []
        t._fire(_ti(pkg, 60.0, height=2), t._gen)
        assert [ti.height for ti in fired] == [2]
    finally:
        t.stop()


def test_ticker_stop_while_armed(pkg):
    fired = []
    t = pkg.ticker.TimeoutTicker(fired.append)
    t.schedule(_ti(pkg, 0.05, height=1))
    armed_gen = t._gen
    t.stop()
    time.sleep(0.2)
    assert fired == []
    t._fire(_ti(pkg, 0.05, height=1), armed_gen)
    assert fired == []
    t.schedule(_ti(pkg, 0.01, height=3))
    time.sleep(0.1)
    assert fired == [] and t._timer is None


# ---------------------------------------------------------------------------
# tests/test_vote_batching.py
# ---------------------------------------------------------------------------

def signed_prevotes(p, gdoc, privs, state, height, round_=0):
    B = p.basic
    bid = B.BlockID(hash=bytes([5] * 32),
                    part_set_header=B.PartSetHeader(1, bytes([6] * 32)))
    by_addr = {k.pub_key().address(): k for k in privs}
    votes = []
    vals = state.validators
    for idx in range(vals.size()):
        addr, _val = vals.get_by_index(idx)
        v = p.vote.Vote(type=B.SignedMsgType.PREVOTE, height=height,
                        round=round_, block_id=bid,
                        timestamp=B.Timestamp(1700000100, idx),
                        validator_address=addr, validator_index=idx)
        v.signature = by_addr[addr].sign(v.sign_bytes(gdoc.chain_id))
        votes.append(v)
    return votes


def test_vote_storm_rides_the_batch_path(pkg):
    n_vals = 150
    gdoc, privs = make_genesis(pkg, n_vals)
    node = Node(pkg, gdoc, privs[0])
    cs = node.cs
    votes = signed_prevotes(pkg, gdoc, privs, cs.state, cs.rs.height)
    batch = [(pkg.rt.VoteMessage(v), f"peer{i}") for i, v in enumerate(votes)]
    h0 = pkg.batch.verified_sigs.hits
    cs._preverify_votes(batch)
    with cs._mtx:
        for msg, peer_id in batch:
            cs._apply_msg(msg, peer_id)
    prevotes = cs.rs.votes.prevotes(cs.rs.round)
    assert prevotes.has_two_thirds_majority()
    assert sum(1 for v in prevotes.votes if v is not None) == n_vals
    assert pkg.batch.verified_sigs.hits - h0 >= 0.9 * n_vals


def test_invalid_vote_in_storm_still_rejected(pkg):
    gdoc, privs = make_genesis(pkg, 8)
    node = Node(pkg, gdoc, privs[0])
    cs = node.cs
    votes = signed_prevotes(pkg, gdoc, privs, cs.state, cs.rs.height)
    bad = votes[3]
    bad.signature = bytes([bad.signature[0] ^ 1]) + bad.signature[1:]
    batch = [(pkg.rt.VoteMessage(v), "p") for v in votes]
    cs._preverify_votes(batch)
    with cs._mtx:
        for msg, peer_id in batch:
            try:
                cs._apply_msg(msg, peer_id)
            except Exception:  # noqa: BLE001 - the bad vote is dropped
                pass
    prevotes = cs.rs.votes.prevotes(cs.rs.round)
    present = [i for i, v in enumerate(prevotes.votes) if v is not None]
    assert 3 not in present and len(present) == 7


# ---------------------------------------------------------------------------
# tests/test_propose_fastpath.py's helpers.Node cases
# ---------------------------------------------------------------------------

def _deterministic(size: int, seed: int = 7) -> bytes:
    out = bytearray()
    x = seed
    while len(out) < size:
        x = (x * 1103515245 + 12345) & 0xFFFFFFFF
        out += x.to_bytes(4, "little")
    return bytes(out[:size])


def _solo(p):
    gdoc, privs = make_genesis(p, 1)
    node = Node(p, gdoc, privs[0], name="p0")
    return node, node.pv.priv_key.pub_key().address()


def _create(node, addr, **kw):
    return node.exec.create_proposal_block(
        1, node.exec.state_store.load(), None, addr, **kw)


def test_chaos_propose_reap_raise_empty_block(pkg):
    node, addr = _solo(pkg)
    for i in range(5):
        node.mempool.check_tx(b"k%d=v" % i)
    assert node.mempool.size() == 5
    pkg.fail.set_mode("propose.reap", "raise")
    block = _create(node, addr)
    assert pkg.fail.fired("propose.reap", "raise") >= 1
    assert block.data.txs == []
    assert node.exec.last_propose_timings["reap_degraded"] is True
    pkg.fail.clear("propose.reap")
    block = _create(node, addr)
    assert len(block.data.txs) == 5
    assert node.exec.last_propose_timings["reap_degraded"] is False


def test_chaos_propose_reap_latency_consumes_budget(pkg):
    node, addr = _solo(pkg)
    for i in range(200):
        node.mempool.check_tx(b"tx%d=v" % i)
    pkg.fail.set_mode("propose.reap", "latency:80")
    block = _create(node, addr, reap_budget_s=0.02)
    assert pkg.fail.fired("propose.reap", "latency:80") >= 1
    assert len(block.data.txs) < 200
    assert node.exec.last_propose_timings["reap_degraded"] is False


def test_chaos_propose_parts_serial_fallback_identical(pkg):
    PS = pkg.part_set
    gdoc, privs = make_genesis(pkg, 1)
    state = pkg.state.state_from_genesis(gdoc)
    block = state.make_block(
        1, [_deterministic(9000, seed=i) for i in range(30)], None, [],
        privs[0].pub_key().address())
    streamed = PS.make_block_parts(block)
    assert isinstance(streamed, PS.StreamingPartSet)
    pkg.fail.set_mode("propose.parts", "raise")
    serial = PS.make_block_parts(block)
    assert pkg.fail.fired("propose.parts", "raise") >= 1
    assert isinstance(serial, PS.PartSet) and serial.is_complete()
    assert serial.header() == streamed.header()
    for a, b in zip(serial.iter_parts(), streamed.iter_parts()):
        assert a.bytes_ == b.bytes_ and a.proof.aunts == b.proof.aunts


def test_prepare_budget_slow_app_degrades_to_raw_txs(pkg):
    node, addr = _solo(pkg)
    for i in range(3):
        node.mempool.check_tx(b"s%d=v" % i)
    orig = node.app.prepare_proposal

    def slow(req):
        time.sleep(0.5)
        return orig(req)

    node.app.prepare_proposal = slow
    t0 = time.monotonic()
    block = _create(node, addr, prepare_budget_s=0.05)
    assert time.monotonic() - t0 < 0.45
    assert len(block.data.txs) == 3
    assert node.exec.last_propose_timings["prepare_degraded"] is True


def test_prepare_app_exception_degrades_to_raw_txs(pkg):
    node, addr = _solo(pkg)
    for i in range(2):
        node.mempool.check_tx(b"e%d=v" % i)

    def boom(req):
        raise RuntimeError("app broke")

    node.app.prepare_proposal = boom
    for budget in (None, 0.2):
        block = _create(node, addr, prepare_budget_s=budget)
        assert len(block.data.txs) == 2
        assert node.exec.last_propose_timings["prepare_degraded"] is True


def test_propose_max_bytes_cap(pkg):
    node, addr = _solo(pkg)
    for i in range(50):
        node.mempool.check_tx(b"c%03d=" % i + b"x" * 400)
    capped = _create(node, addr, max_bytes_cap=4096)
    free = _create(node, addr)
    assert 0 < len(capped.data.txs) < len(free.data.txs) == 50


# ---------------------------------------------------------------------------
# the wire messages: bytes equal across the packages, each way
# ---------------------------------------------------------------------------

def _messages(p):
    """One of each of the nine consensus messages, from the same fields."""
    B, M = p.basic, p.messages
    bid = B.BlockID(b"\x21" * 32, B.PartSetHeader(3, b"\x22" * 32))
    vote = p.vote.Vote(type=B.SignedMsgType.PRECOMMIT, height=7, round=2,
                       block_id=bid, timestamp=B.Timestamp(1700000123, 45),
                       validator_address=b"\x33" * 20, validator_index=5,
                       signature=b"\x44" * 64)
    prop = p.proposal.Proposal(height=7, round=2, pol_round=1, block_id=bid,
                               timestamp=B.Timestamp(1700000120, 9),
                               signature=b"\x55" * 64)
    part = p.part_set.Part(index=1, bytes_=b"\x66" * 100, proof=p.merkle.Proof(
        total=3, index=1, leaf_hash=b"\x77" * 32, aunts=[b"\x88" * 32]))
    bits = p.bits.BitArray.from_indices(10, [0, 3, 9])
    return {
        "new_round_step": M.NewRoundStepMessage(7, 2, 4, 1, 12),
        "new_valid_block": M.NewValidBlockMessage(
            7, 2, B.PartSetHeader(3, b"\x22" * 32), bits, True),
        "proposal": M.ProposalGossip(prop),
        "proposal_pol": M.ProposalPOLMessage(7, 1, bits),
        "block_part": M.BlockPartGossip(7, 2, part),
        "vote": M.VoteGossip(vote),
        "has_vote": M.HasVoteMessage(7, 2, 2, 5),
        "vote_set_maj23": M.VoteSetMaj23Message(7, 2, 1, bid),
        "vote_set_bits": M.VoteSetBitsMessage(7, 2, 1, bid, bits.size(),
                                              bits.to_bytes()),
    }


MSG_KINDS = sorted(_messages(JAX))


@pytest.mark.parametrize("kind", MSG_KINDS)
def test_encode_msg_bytes_equal_and_cross(kind):
    """encode_msg gives the same bytes in both packages, and each package's
    decode_msg reads the other's bytes to the same fields."""
    mj, mp = _messages(JAX)[kind], _messages(PORT)[kind]
    bj = JAX.messages.encode_msg(mj)
    bp = PORT.messages.encode_msg(mp)
    assert bj == bp and len(bj) > 2
    from_j = PORT.messages.decode_msg(bj)
    from_p = JAX.messages.decode_msg(bp)
    assert type(from_j).__name__ == type(mp).__name__
    assert plain(from_j) == plain(JAX.messages.decode_msg(bj))
    assert plain(from_p) == plain(PORT.messages.decode_msg(bp))
    assert PORT.messages.encode_msg(from_j) == bj
    assert JAX.messages.encode_msg(from_p) == bp


def test_decode_msg_refuses_garbage_alike():
    """Malformed bytes raise the same ProtoError class and message in both
    packages (the switch stops the peer on it)."""
    for data in (b"", b"\x0a", b"\x32\x05\x0a\x03\xff\xff\xff",
                 b"\xfa\x01\x00"):
        out = []
        for p in PKGS:
            try:
                out.append(("ok", plain(p.messages.decode_msg(data))))
            except Exception as e:  # noqa: BLE001 - compared below
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], (data, out)


# ---------------------------------------------------------------------------
# the cross-package replay of a JAX-generated WAL
# ---------------------------------------------------------------------------

def _walgen_genesis(p):
    """generate_wal's genesis (its fixed key, chain and time)."""
    priv = p.ed.PrivKey((0xA11CE).to_bytes(32, "big"))
    G = p.genesis
    return G.GenesisDoc(
        chain_id="wal-gen-chain",
        genesis_time=p.basic.Timestamp(1700000000, 0),
        validators=[G.GenesisValidator(
            address=priv.pub_key().address(), pub_key_type="ed25519",
            pub_key_bytes=priv.pub_key().bytes(), power=10)])


def _observer(p, gdoc):
    """A ConsensusState with no priv validator over fresh MemDB stores, its
    ticker stopped (schedules are no-ops)."""
    app = p.kvstore.KVStoreApplication()
    ss = p.sstore.StateStore(p.kvdb.MemDB())
    bs = p.bstore.BlockStore(p.kvdb.MemDB())
    state = p.state.state_from_genesis(gdoc)
    ss.save(state)
    ex = p.execution.BlockExecutor(ss, app, block_store=bs, **_dev(p))
    cs = p.cstate.ConsensusState(p.config.test_config(), state, ex, bs,
                                 name=f"replay-{p.name}")
    cs._ticker.stop()
    return cs, bs


def _round_state(cs):
    rs = cs.rs
    pv = rs.votes.prevotes(rs.round)
    pc = rs.votes.precommits(rs.round)
    lc = rs.last_commit
    return (rs.height, rs.round, int(rs.step), rs.locked_round,
            rs.valid_round, plain(pv.bit_array()), plain(pc.bit_array()),
            None if lc is None else plain(lc.bit_array()),
            None if rs.proposal_block is None else rs.proposal_block.hash())


def _as_gossip(p, msg):
    """The gossip message carrying a round_types message."""
    M, R = p.messages, p.rt
    if isinstance(msg, R.ProposalMessage):
        return M.ProposalGossip(msg.proposal)
    if isinstance(msg, R.BlockPartMessage):
        return M.BlockPartGossip(msg.height, msg.round, msg.part)
    return M.VoteGossip(msg.vote)


def _from_gossip(p, g):
    M, R = p.messages, p.rt
    if isinstance(g, M.ProposalGossip):
        return R.ProposalMessage(g.proposal)
    if isinstance(g, M.BlockPartGossip):
        return R.BlockPartMessage(g.height, g.round, g.part)
    return R.VoteMessage(g.vote)


def test_cross_package_replay_of_a_jax_wal(tmp_path):
    """The JAX package's generate_wal runs a real single-validator
    consensus for 4 blocks; every proposal, part and vote of its WAL goes
    through the JAX encode_msg into bytes, and those bytes through each
    package's decode_msg into a JAX and a port observer, applied in WAL
    order (timeouts skipped, as the catch-up replay skips them).  After
    every message both observers hold the same RoundState; at every
    #ENDHEIGHT the same block hash and app hash."""
    path = str(tmp_path / "gen" / "wal")
    JAX.walgen.generate_wal(path, num_blocks=4)
    records = list(JAX.wal.WAL.iter_messages(path))
    obs = {p.name: _observer(p, _walgen_genesis(p)) for p in PKGS}
    R = JAX.rt
    applied = ends = 0
    for rec in records:
        if isinstance(rec, JAX.wal.EndHeightMessage):
            h = rec.height
            if h == 0:
                continue
            got = {}
            for p in PKGS:
                cs, bs = obs[p.name]
                got[p.name] = (bs.load_block(h).hash(),
                               cs.state.app_hash, cs.state.last_block_height)
            assert got["jax"] == got["port"], (h, got)
            assert got["port"][2] == h
            ends += 1
            continue
        msg, peer_id = rec
        if isinstance(msg, R.TimeoutInfo):
            continue
        data = JAX.messages.encode_msg(_as_gossip(JAX, msg))
        states = []
        for p in PKGS:
            cs, _ = obs[p.name]
            m = _from_gossip(p, p.messages.decode_msg(data))
            with cs._mtx:
                cs._apply_msg(m, peer_id or "replay")
            states.append(_round_state(cs))
        assert states[0] == states[1], (applied, states)
        applied += 1
    assert ends >= 4 and applied >= 16
    assert obs["port"][0].state.last_block_height >= 4


# ---------------------------------------------------------------------------
# a mixed localnet: two JAX and two port nodes over TCP
# ---------------------------------------------------------------------------

def _node_key(p, i):
    return p.key.NodeKey(p.ed.PrivKey((0xC0DE + i).to_bytes(32, "big")))


def test_mixed_localnet_commits_one_chain():
    """Four validators, two of each package, each on its own Switch on
    127.0.0.1 with a ConsensusReactor, dialled full mesh: all four commit
    the same blocks, and a tx submitted at a port node is committed."""
    gdocs = {p.name: make_genesis(p, 4) for p in PKGS}
    nodes, switches = [], []
    for i, p in enumerate((JAX, PORT, JAX, PORT)):
        gdoc, privs = gdocs[p.name]
        n = Node(p, gdoc, privs[i], name=f"mixed{i}")
        sw = p.switch.Switch(_node_key(p, i), "127.0.0.1:0", gdoc.chain_id,
                             moniker=f"{p.name}{i}")
        sw.add_reactor("CONSENSUS", p.reactor.ConsensusReactor(n.cs))
        nodes.append(n)
        switches.append(sw)
    try:
        for sw in switches:
            sw.start()
        for i, sw in enumerate(switches):
            for other in switches[i + 1:]:
                assert sw.dial_peer(other.actual_listen_addr()) is not None
        assert wait_for(lambda: all(sw.num_peers() == 3
                                    for sw in switches), timeout=20)
        for n in nodes:
            n.start()
        nodes[1].mempool.check_tx(b"mixed=1")
        wait_for_height(nodes, 4, timeout=90)
        for h in range(1, 5):
            assert len({n.block_store.load_block(h).hash()
                        for n in nodes}) == 1, h
        # the tx reaches the chain once node 1 proposes (round robin)
        assert wait_for(lambda: nodes[1].app.data.get(b"mixed") == b"1",
                        timeout=60)
        top = min(n.block_store.height() for n in nodes)
        assert len({n.block_store.load_block(top).hash()
                    for n in nodes}) == 1
    finally:
        for n in nodes:
            n.stop()
        for sw in switches:
            sw.stop()


# ---------------------------------------------------------------------------
# a remote signer in place of the FilePV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server", PKGS, ids=lambda p: f"server-{p.name}")
def test_remote_signer_commits_blocks(server):
    """A port ConsensusState whose priv validator is a port SignerClient,
    served by a SignerServer of either package around the validator's
    FilePV, proposes and commits blocks (the stand-in for
    tests/test_remote_signer.py's node case, which needs the node)."""
    d = tempfile.mkdtemp(prefix="tmcs", dir="/tmp")
    gdoc, privs = make_genesis(PORT, 1)
    addr = f"unix://{os.path.join(d, 'pv.sock')}"
    client = PORT.signer.SignerClient(addr, timeout_s=5.0,
                                      accept_timeout_s=20.0)
    key = server.ed.PrivKey(privs[0].bytes())
    srv = server.signer.SignerServer(server.file_pv.FilePV(key), addr)
    srv.start()
    node = None
    try:
        node = Node(PORT, gdoc, None, name="remote", pv=client)
        assert node.cs.priv_pub_key.bytes() == privs[0].pub_key().bytes()
        node.start()
        wait_for_height([node], 3, timeout=60)
        b2 = node.block_store.load_block(2)
        assert b2.header.proposer_address == privs[0].pub_key().address()
    finally:
        if node is not None:
            node.stop()
        srv.stop()
        client.close()
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# the port's departures
# ---------------------------------------------------------------------------

def test_device_follows_the_executor(monkeypatch):
    """device=None takes the executor's device, resolved in the
    constructor; an explicit device wins; the pre-verify passes it to
    verify_items."""
    gdoc, privs = make_genesis(PORT, 8)
    node = Node(PORT, gdoc, None)
    assert node.exec.device == "cpu"
    assert node.cs.device == torch.device("cpu")
    ex = PORT.execution.BlockExecutor(node.state_store, node.app)
    assert ex.device is None  # the package default, cpu in these tests
    cs = PORT.cstate.ConsensusState(PORT.config.test_config(),
                                    node.cs.state, ex, node.block_store)
    assert cs.device == torch.device("cpu")
    cs2 = PORT.cstate.ConsensusState(PORT.config.test_config(),
                                     node.cs.state, ex, node.block_store,
                                     device="cpu")
    assert cs2.device == torch.device("cpu")
    seen = []

    def capture(items, *a, **kw):
        seen.append((len(items), kw.get("device")))
        return True, None
    monkeypatch.setattr(PORT.scheduler, "verify_items", capture)
    votes = signed_prevotes(PORT, gdoc, privs, node.cs.state, 1)
    node.cs._preverify_votes([(PORT.rt.VoteMessage(v), "p") for v in votes])
    assert seen == [(8, torch.device("cpu"))]


def test_constructor_without_cuda_raises(monkeypatch):
    """With no CUDA and no device="cpu" (the executor's None and the
    package default "cuda") the state machine is not made."""
    gdoc, _ = make_genesis(PORT, 1)
    node = Node(PORT, gdoc, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    ex = PORT.execution.BlockExecutor(node.state_store, node.app)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT.cstate.ConsensusState(PORT.config.test_config(),
                                   node.cs.state, ex, node.block_store)
    cs = PORT.cstate.ConsensusState(PORT.config.test_config(),
                                    node.cs.state, ex, node.block_store,
                                    device="cpu")
    assert cs.device == torch.device("cpu")


@pytest.fixture
def card_kernel(monkeypatch):
    """A VerifyScheduler on device="cpu" with tpu_threshold 1 (so a storm
    of 8 votes takes its ed25519 lane on the runtime), the runtime treating
    that lane as on the card with no spot check, and K1's plain version
    raising as a failed launch does.  Yields a function that restores K1
    (the card is back)."""
    from tendermint_tpu_torch.ops import cuda_ed25519 as ck

    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    real = PORT.degrade.DeviceLaneRuntime.allow_fallback
    monkeypatch.setattr(
        PORT.degrade.DeviceLaneRuntime, "allow_fallback",
        lambda self, site, reason, on_card, cause=None: real(
            self, site, reason, True, cause))

    def launch_failed(*a, **k):
        raise RuntimeError("cudaErrorLaunchFailure (test)")
    real_plain = ck.verify_packed_plain
    monkeypatch.setattr(ck, "verify_packed_plain", launch_failed)
    # the runtime's spot check (one host verify a launch, its integrity
    # check) off, so that a host verify counted is a vote's own
    PORT.degrade.configure(PORT.degrade.DegradeConfig(spot_check=False),
                           registry=PORT.metrics.Registry("cs_card"))
    sched = PORT.scheduler.VerifyScheduler(
        window_s=0.001, tpu_threshold=1, device="cpu")
    PORT.scheduler.install(sched)
    sched.start()
    yield lambda: monkeypatch.setattr(ck, "verify_packed_plain", real_plain)
    PORT.degrade.configure(PORT.degrade.DegradeConfig(),
                           registry=PORT.metrics.Registry("cs_card2"))


def _count_host_verifies(monkeypatch, p):
    calls = [0]
    real = p.ed.PubKey.verify_signature

    def counted(self, msg, sig):
        calls[0] += 1
        return real(self, msg, sig)
    monkeypatch.setattr(p.ed.PubKey, "verify_signature", counted)
    return calls


def _storm_node(p, tmp_path, name="storm"):
    """A started non-validator node of an 8-validator set with a WAL, the
    storm of its 8 height-1 prevotes queued before the start so that the
    receive routine drains them as one batch."""
    gdoc, privs = make_genesis(p, 8)
    wal_path = str(tmp_path / f"{name}.wal")
    node = Node(p, gdoc, None, name=name, wal_path=wal_path)
    votes = signed_prevotes(p, gdoc, privs, node.cs.state, 1)
    for i, v in enumerate(votes):
        node.cs.add_vote(v, peer_id=f"peer{i}")
    return node, votes, wal_path


def _prevotes_present(cs):
    with cs._mtx:
        return [i for i, v in enumerate(cs.rs.votes.prevotes(0).votes)
                if v is not None]


def _wal_votes(p, wal_path):
    return [m for m in p.wal.WAL.iter_messages(wal_path)
            if isinstance(m, tuple) and isinstance(m[0], p.rt.VoteMessage)]


def test_card_fault_in_the_preverify_halts_and_resumes(card_kernel,
                                                       monkeypatch,
                                                       tmp_path):
    """Outside a drill, a storm whose pre-verify launch fails on the card:
    the receive routine ends with the DeviceLaneError on `device_error`,
    no vote of the batch is in the VoteSet or the WAL, and no host
    verify_signature ran.  With the card back, a fresh ConsensusState over
    the same stores and WAL, fed the same storm, reaches +2/3 prevotes."""
    calls = _count_host_verifies(monkeypatch, PORT)
    node, votes, wal_path = _storm_node(PORT, tmp_path)
    node.start()
    try:
        assert wait_for(lambda: not node.cs.is_running(), timeout=30)
        assert isinstance(node.cs.device_error,
                          PORT.degrade.DeviceLaneError)
        assert _prevotes_present(node.cs) == []
        assert calls[0] == 0
    finally:
        node.stop()
    assert _wal_votes(PORT, wal_path) == []
    card_kernel()
    cs2 = _restart(PORT, node, wal_path, "storm2")
    for i, v in enumerate(votes):
        cs2.add_vote(v, peer_id=f"peer{i}")
    cs2.start()
    try:
        assert wait_for(
            lambda: cs2.rs.votes.prevotes(0).has_two_thirds_majority(),
            timeout=60)
        assert cs2.is_running() and cs2.device_error is None
        assert _prevotes_present(cs2) == list(range(8))
        assert calls[0] == 0  # every vote hit the SigCache
    finally:
        cs2.stop()
    assert len(_wal_votes(PORT, wal_path)) == 8


def test_card_fault_in_a_drill_takes_the_reference_path(card_kernel,
                                                        tmp_path):
    """With a failpoint armed (a chaos drill), the scheduler's lane
    re-verifies on the host and every vote is applied, as in the JAX
    package with no fault at all."""
    PORT.fail.set_mode("sched.ed25519", "raise")
    out = {}
    for p in PKGS:
        node, _votes, _ = _storm_node(p, tmp_path, name=f"drill-{p.name}")
        node.start()
        try:
            assert wait_for(lambda: len(_prevotes_present(node.cs)) == 8,
                            timeout=60)
            assert node.cs.is_running()
            out[p.name] = _prevotes_present(node.cs)
        finally:
            node.stop()
    assert out["jax"] == out["port"] == list(range(8))
    assert PORT.fail.fired("sched.ed25519", "raise") >= 1
    assert getattr(node.cs, "device_error", None) is None


@pytest.mark.parametrize("exc", [ValueError, TimeoutError, RuntimeError])
def test_other_preverify_errors_are_still_swallowed(monkeypatch, tmp_path,
                                                    exc):
    """Any exception of the pre-verify but a card fault is swallowed, as in
    the JAX package: the votes take the serial path (a host verify each)
    and all land; the routine runs on."""
    calls = _count_host_verifies(monkeypatch, PORT)

    def broken(*a, **k):
        raise exc("not the card")
    monkeypatch.setattr(PORT.scheduler, "verify_items", broken)
    node, _votes, _ = _storm_node(PORT, tmp_path)
    node.start()
    try:
        assert wait_for(lambda: len(_prevotes_present(node.cs)) == 8,
                        timeout=30)
        assert node.cs.is_running() and node.cs.device_error is None
        assert calls[0] == 8
    finally:
        node.stop()


def test_card_fault_in_apply_block_halts(monkeypatch, tmp_path):
    """A card fault while _finalize_commit applies the block ends the
    state machine the same way: `device_error` set, the block and its
    #ENDHEIGHT already on disk (resuming from there needs the handshake's
    block replay)."""
    gdoc, privs = make_genesis(PORT, 1)
    wal_path = str(tmp_path / "apply.wal")
    node = Node(PORT, gdoc, privs[0], name="apply", wal_path=wal_path)
    real = node.exec.apply_block

    def apply_block(state, bid, block, *a, **k):
        if block.header.height == 2:
            raise PORT.degrade.DeviceLaneError("launch failed on the card")
        return real(state, bid, block, *a, **k)
    monkeypatch.setattr(node.exec, "apply_block", apply_block)
    node.start()
    try:
        assert wait_for(lambda: not node.cs.is_running(), timeout=30)
        assert isinstance(node.cs.device_error,
                          PORT.degrade.DeviceLaneError)
        assert node.block_store.height() == 2
        assert node.state_store.load().last_block_height == 1
    finally:
        node.stop()
    assert PORT.wal.WAL.search_for_end_height(wal_path, 2)


@pytest.mark.parametrize("card", [True, False], ids=["card", "other"])
def test_card_fault_in_the_wal_catchup(monkeypatch, tmp_path, card):
    """A card fault while the WAL catch-up replays ends the start with
    `device_error` set and no receive routine; any other catch-up error is
    logged and the state machine starts anyway, as in the JAX package."""
    gdoc, privs = make_genesis(PORT, 1)
    node = Node(PORT, gdoc, privs[0], name="catchup",
                wal_path=str(tmp_path / "catchup.wal"))
    err = (PORT.degrade.DeviceLaneError("launch failed on the card")
           if card else ValueError("replay of a bad record"))

    def replay():
        raise err
    monkeypatch.setattr(node.cs, "_catchup_replay", replay)
    try:
        if card:
            with pytest.raises(PORT.degrade.DeviceLaneError):
                node.start()
            assert node.cs.device_error is err
            assert not node.cs.is_running()
        else:
            node.start()
            assert node.cs.is_running() and node.cs.device_error is None
            wait_for_height([node], 1, timeout=30)
    finally:
        node.stop()


# ---------------------------------------------------------------------------
# a complete part set from a polka, refused against a later round's proposal
# ---------------------------------------------------------------------------

def _polka_then_commit(p):
    """An observer of a 4-validator set at height 1 enters round 1, takes
    that round's proposal (block B1), then sees +2/3 prevotes of round 1
    for another block B0 (its part set replaced by B0's), receives B0's
    parts, then +2/3 precommits for B0 and B0's parts again.  Returns the
    observer's (block store height, step name) at the end."""
    B = p.basic
    gdoc, privs = make_genesis(p, 4)
    by_addr = {k.pub_key().address(): k for k in privs}
    node = Node(p, gdoc, None, name=f"polka-{p.name}")
    cs = node.cs
    cs._ticker.stop()
    state = cs.state
    blocks = {}
    for tag, txs in (("b0", [b"polka=0"]), ("b1", [b"polka=1"])):
        blk = state.make_block(1, txs, p.cstate.Commit(0, 0, B.BlockID(), []),
                               [], state.validators.get_proposer().address)
        parts = list(p.part_set.make_block_parts(blk).iter_parts())
        psh = p.part_set.make_block_parts(blk).header()
        blocks[tag] = (blk, parts, B.BlockID(blk.hash(), psh))
    vals1 = state.validators.copy()
    vals1.increment_proposer_priority(1)
    bid1 = blocks["b1"][2]
    prop = p.proposal.Proposal(height=1, round=1, pol_round=-1,
                               block_id=bid1,
                               timestamp=B.Timestamp(1700000001, 0))
    prop.signature = by_addr[vals1.get_proposer().address].sign(
        prop.sign_bytes(gdoc.chain_id))

    def votes(vtype, bid):
        out = []
        for idx in range(3):
            addr, _ = state.validators.get_by_index(idx)
            v = p.vote.Vote(type=vtype, height=1, round=1, block_id=bid,
                            timestamp=B.Timestamp(1700000002, idx),
                            validator_address=addr, validator_index=idx)
            v.signature = by_addr[addr].sign(v.sign_bytes(gdoc.chain_id))
            out.append(v)
        return out
    _, parts0, bid0 = blocks["b0"]
    R = p.rt
    with cs._mtx:
        cs._enter_new_round(1, 1)
        cs._apply_msg(R.ProposalMessage(prop), "peer")
        for v in votes(B.SignedMsgType.PREVOTE, bid0):
            cs._apply_msg(R.VoteMessage(v), "peer")
        for part in parts0:
            cs._apply_msg(R.BlockPartMessage(1, 0, part), "peer")
        for v in votes(B.SignedMsgType.PRECOMMIT, bid0):
            cs._apply_msg(R.VoteMessage(v), "peer")
        for part in parts0:
            cs._apply_msg(R.BlockPartMessage(1, 1, part), "peer")
    return node.block_store.height(), cs.rs.step.name


def test_a_polka_block_completes_after_a_later_proposal():
    """The JAX package refuses B0 when its part set completes, because the
    round's proposal names B1 ("proposal block hash mismatch", swallowed as
    a stale round's part), and then waits in COMMIT for parts it already
    holds: a duplicate part is not added, so the block is never assembled.
    The port checks an assembled block against the proposal only when the
    part set is the proposal's own; one that came from +2/3 votes is
    judged by the commit path, and the observer commits B0."""
    assert _polka_then_commit(JAX) == (0, "COMMIT")
    assert _polka_then_commit(PORT) == (1, "NEW_HEIGHT")
