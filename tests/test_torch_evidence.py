"""The port's evidence package (verification, the pool, the reactor) against
the JAX package's, on the CPU.

tests/test_evidence.py's nine cases run through both packages, on chains
that test_torch_blocksync's `build_chain` makes from the same seeded keys
in each package; each case returns its outcome as a package-free value
(evidence hashes, pool sizes and pending hashes, gossiped evidence protos,
exception classes with their messages), and the outcomes are compared
across the packages exactly.  Then the port's departures: `device=` routes
the two duplicate-vote lanes through a VerifyScheduler only when it runs
on that device; with no CUDA and no device="cpu" the entry points raise
RuntimeError; and a launch that failed on the card (degrade.DeviceLaneError)
leaves the pool, BlockExecutor.validate_block and the reactor's receive as
it is (no EvidenceError, no stopped peer, the error on
reactor.device_error), while in a chaos drill the JAX package's behaviour
holds.  The port runs on device="cpu" throughout (the `_cpu` fixture).
"""
from __future__ import annotations

import copy
import functools
import importlib

import pytest
import torch

import tendermint_tpu_torch as T
from test_torch_blocksync import (BY_NAME, PKGS, PORT, _clean,  # noqa: F401
                                  build_chain, executor, make_genesis)
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_EXTRA = {
    "evidence": "evidence", "ev_pool": "evidence.pool",
    "ev_verify": "evidence.verify", "ev_reactor": "evidence.reactor",
    "ev_types": "types.evidence", "light_block": "types.light_block",
    "vote": "types.vote", "block": "types.block",
}
for _p in PKGS:
    for _attr, _mod in _EXTRA.items():
        setattr(_p, _attr, importlib.import_module(f"{_p.root}.{_mod}"))

CHAIN = "test-chain-tpu"


def pool_of(p, state_store, block_store, **kw):
    """An EvidencePool; the port's on device="cpu"."""
    if p is PORT:
        kw.setdefault("device", "cpu")
    return p.ev_pool.EvidencePool(p.kvdb.MemDB(), state_store, block_store,
                                  **kw)


def dup_votes(p, priv, height=5, round_=0):
    B = p.basic

    def vote(h):
        bid = B.BlockID(hash=h, part_set_header=B.PartSetHeader(1, h))
        v = p.vote.Vote(type=B.SignedMsgType.PRECOMMIT, height=height,
                        round=round_, block_id=bid,
                        timestamp=B.Timestamp(1700000005, 0),
                        validator_address=priv.pub_key().address(),
                        validator_index=0)
        v.signature = priv.sign(v.sign_bytes(CHAIN))
        return v
    return vote(b"\xAA" * 32), vote(b"\xBB" * 32)


def synced_node(p, gdoc, blocks, commits):
    """tests/test_evidence.py's _synced_node: the chain replayed into fresh
    stores."""
    state_store = p.sstore.StateStore(p.kvdb.MemDB())
    block_store = p.bstore.BlockStore(p.kvdb.MemDB())
    ex = executor(p, state_store, p.kvstore.KVStoreApplication())
    state = p.state.state_from_genesis(gdoc)
    state_store.save(state)
    applied = 0
    while applied < len(blocks):
        state, n = p.replay.replay_window(ex, block_store, state,
                                          blocks[applied:],
                                          commits[applied:], max_window=16)
        applied += n
    return ex, state_store, block_store, state


def raised(fn):
    """The exception fn() raises, as (class name, message)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return (type(e).__name__, str(e))
    return None


def verify_dup(p, ev, vals):
    kw = {"device": "cpu"} if p is PORT else {}
    return p.ev_verify.verify_duplicate_vote(ev, CHAIN, vals, **kw)


def attack_evidence(p, n_heights=10, height=7):
    """tests/test_evidence.py's equivocation-style fork at `height`: the
    block's data forged, re-signed by every validator."""
    B = p.basic
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, states = build_chain(p, gdoc, privs, n_heights)
    ex, state_store, block_store, state = synced_node(p, gdoc, blocks,
                                                     commits)
    evil = copy.deepcopy(blocks[height - 1])
    evil.data.txs = [b"forged-tx"]
    evil.header.data_hash = evil.data.hash()
    bid, _ = p.replay.block_id_of(evil)
    by_addr = {k.pub_key().address(): k for k in privs}
    vals = state_store.load_validators(height)
    ts = B.Timestamp(1700000007, 500)
    sigs = []
    for val in vals.validators:
        sb = p.canonical.canonical_vote_bytes(
            gdoc.chain_id, B.SignedMsgType.PRECOMMIT, height, 0, bid, ts)
        sigs.append(p.commit.CommitSig(B.BlockIDFlag.COMMIT, val.address, ts,
                                       by_addr[val.address].sign(sb)))
    lb = p.light_block.LightBlock(p.light_block.SignedHeader(
        evil.header, p.commit.Commit(height, 0, bid, sigs)), vals)
    ev = p.ev_types.LightClientAttackEvidence(
        conflicting_block=lb, common_height=height,
        total_voting_power=vals.total_voting_power(),
        timestamp=block_store.load_block_meta(height).header.time)
    common = p.light_block.SignedHeader(
        block_store.load_block_meta(height).header,
        block_store.load_block_commit(height))
    return ev, common, vals, (ex, state_store, block_store, state)


# ---------------------------------------------------------------------------
# tests/test_evidence.py's cases, each returning its package-free outcome
# ---------------------------------------------------------------------------

def case_duplicate_vote_roundtrip_and_verify(p):
    gdoc, privs = make_genesis(p, 4)
    vals = p.state.state_from_genesis(gdoc).validators
    v1, v2 = dup_votes(p, privs[0])
    ev = p.ev_types.DuplicateVoteEvidence.from_votes(
        v1, v2, p.basic.Timestamp(1700000005, 0), vals)
    ev.validate_basic()
    ev2 = p.ev_types.evidence_from_proto(ev.proto())
    assert ev2.hash() == ev.hash()
    verify_dup(p, ev, vals)
    out = [ev.hash(), ev.proto()]
    ev_same = copy.deepcopy(ev)
    ev_same.vote_b = ev.vote_a
    ev_pow = copy.deepcopy(ev)
    ev_pow.total_voting_power += 1
    ev_sig = copy.deepcopy(ev)
    ev_sig.vote_a.signature = bytes(64)
    for bad in (ev_same, ev_pow, ev_sig):
        with pytest.raises(p.ev_types.EvidenceError):
            verify_dup(p, bad, vals)
        out.append(raised(lambda bad=bad: verify_dup(p, bad, vals)))
    return out


def case_evidence_list_hash_stable(p):
    gdoc, privs = make_genesis(p, 4)
    state = p.state.state_from_genesis(gdoc)
    v1, v2 = dup_votes(p, privs[0])
    ev = p.ev_types.DuplicateVoteEvidence.from_votes(
        v1, v2, p.basic.Timestamp(1700000005, 0), state.validators)
    h1 = p.ev_types.evidence_list_hash([ev])
    h2 = p.ev_types.evidence_list_hash(
        [p.ev_types.evidence_from_proto(ev.proto())])
    assert h1 == h2 and len(h1) == 32
    return h1


def case_pool_accepts_and_gossips_duplicate_vote(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 8)
    ex, state_store, block_store, state = synced_node(p, gdoc, blocks,
                                                     commits)
    pool = pool_of(p, state_store, block_store)
    bt = block_store.load_block_meta(5).header.time
    v1, v2 = dup_votes(p, privs[1])
    ev = p.ev_types.DuplicateVoteEvidence.from_votes(
        v1, v2, bt, state_store.load_validators(5))
    pool.add_evidence(ev)
    sizes = [pool.size()]
    pending = pool.pending_evidence()
    assert pending[0].hash() == ev.hash()
    pool.update(state, [ev])
    sizes.append(pool.size())
    pool.add_evidence(ev)
    sizes.append(pool.size())
    assert sizes == [1, 0, 0]
    return {"sizes": sizes, "pending": [e.hash() for e in pending],
            "db": list(pool.db.iterate_prefix(b""))}


def case_pool_consensus_buffer_produces_evidence(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 8)
    ex, state_store, block_store, state = synced_node(p, gdoc, blocks,
                                                     commits)
    pool = pool_of(p, state_store, block_store)
    v1, v2 = dup_votes(p, privs[2], height=6)
    pool.report_conflicting_votes(v1, v2)
    pool.update(state, [])
    assert pool.size() == 1
    return [e.hash() for e in pool.pending_evidence()]


def case_pool_rejects_expired_and_unknown_height(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 8)
    ex, state_store, block_store, state = synced_node(p, gdoc, blocks,
                                                     commits)
    pool = pool_of(p, state_store, block_store)
    v1, v2 = dup_votes(p, privs[0], height=100)
    ev = p.ev_types.DuplicateVoteEvidence.from_votes(
        v1, v2, p.basic.Timestamp(1700000100, 0), state.validators)
    with pytest.raises(p.ev_types.EvidenceError):
        pool.add_evidence(ev)
    return raised(lambda: pool.add_evidence(ev))


def case_light_client_attack_evidence_verifies(p):
    ev, common, vals, (ex, state_store, block_store, state) = \
        attack_evidence(p)
    ev.validate_basic()
    kw = {"device": "cpu"} if p is PORT else {}
    p.ev_verify.verify_light_client_attack(ev, common, common, vals, **kw)
    pool = pool_of(p, state_store, block_store)
    pool.add_evidence(ev)
    assert pool.size() == 1
    return {"hash": ev.hash(), "proto": ev.proto(),
            "pending": [e.hash() for e in pool.pending_evidence()]}


def case_light_attack_evidence_validate_basic(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, states = build_chain(p, gdoc, privs, 6)
    lb = p.light_block.LightBlock(
        p.light_block.SignedHeader(blocks[4].header, commits[4]),
        states[4].validators)
    ev = p.ev_types.LightClientAttackEvidence(
        conflicting_block=lb, common_height=3,
        total_voting_power=states[4].validators.total_voting_power(),
        timestamp=blocks[2].header.time)
    ev.validate_basic()
    ev2 = p.ev_types.evidence_from_proto(ev.proto())
    assert ev2.hash() == ev.hash()
    bad = copy.deepcopy(ev)
    bad.common_height = 9
    with pytest.raises(p.ev_types.EvidenceError):
        bad.validate_basic()
    return [ev.hash(), raised(bad.validate_basic)]


class FakePeer:
    def __init__(self, pid):
        self.id = pid
        self.data = {}
        self.got = []

    def try_send(self, ch, msg):
        self.got.append(msg)
        return True


def case_reactor_gates_evidence_on_peer_height(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 8)
    ex, state_store, block_store, state = synced_node(p, gdoc, blocks,
                                                     commits)
    pool = pool_of(p, state_store, block_store)
    bt = block_store.load_block_meta(5).header.time
    v1, v2 = dup_votes(p, privs[1])
    pool.add_evidence(p.ev_types.DuplicateVoteEvidence.from_votes(
        v1, v2, bt, state_store.load_validators(5)))
    reactor = p.ev_reactor.EvidenceReactor(pool)
    peer = FakePeer("behind")
    reactor.add_peer(peer)
    seen = [len(peer.got)]
    peer.data["height"] = 3
    reactor._send_pending(peer)
    seen.append(len(peer.got))
    peer.data["height"] = 6
    reactor._send_pending(peer)
    seen.append(len(peer.got))
    reactor._send_pending(peer)
    seen.append(len(peer.got))
    far = FakePeer("far-ahead")
    far.data["height"] = (5 + 1 +
                          state.consensus_params.evidence.max_age_num_blocks)
    reactor._send_pending(far)
    assert seen == [0, 0, 1, 1] and not far.got
    assert len(peer.got[0].evidence_protos) == 1
    return {"seen": seen, "sent": [p.ev_reactor.encode_msg(m)
                                   for m in peer.got]}


def case_duplicate_vote_verify_scheduler_parity(p):
    gdoc, privs = make_genesis(p, 4)
    vals = p.state.state_from_genesis(gdoc).validators
    v1, v2 = dup_votes(p, privs[0])

    def outcomes():
        out = []
        ev = p.ev_types.DuplicateVoteEvidence.from_votes(
            v1, v2, p.basic.Timestamp(1700000005, 0), vals)
        verify_dup(p, ev, vals)
        out.append("ok")
        for tamper, expect in (("vote_a", "VoteA"), ("vote_b", "VoteB")):
            bad = copy.deepcopy(ev)
            getattr(bad, tamper).signature = bytes(64)
            with pytest.raises(p.ev_types.EvidenceError) as ei:
                verify_dup(p, bad, vals)
            assert expect in str(ei.value)
            out.append(str(ei.value))
        return out

    assert p.scheduler.running() is None
    direct = outcomes()
    kw = {"device": "cpu"} if p is PORT else {}
    sched = p.scheduler.install(p.scheduler.VerifyScheduler(window_s=0.002,
                                                            **kw))
    sched.start()
    try:
        via_sched = outcomes()
    finally:
        sched.stop()
        p.scheduler.uninstall(sched)
    assert via_sched == direct
    return {"direct": direct, "sched": via_sched,
            "submissions": sched.stats()["submissions"]}


CASES = {f.__name__[len("case_"):]: f for f in (
    case_duplicate_vote_roundtrip_and_verify, case_evidence_list_hash_stable,
    case_pool_accepts_and_gossips_duplicate_vote,
    case_pool_consensus_buffer_produces_evidence,
    case_pool_rejects_expired_and_unknown_height,
    case_light_client_attack_evidence_verifies,
    case_light_attack_evidence_validate_basic,
    case_reactor_gates_evidence_on_peer_height,
    case_duplicate_vote_verify_scheduler_parity)}


@functools.lru_cache(maxsize=None)
def _outcome(case: str, name: str):
    return plain(CASES[case](BY_NAME[name]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_evidence_case(case, pkg):
    """tests/test_evidence.py's case, its assertions, in each package."""
    assert _outcome(case, pkg.name) is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_evidence_case_equal(case):
    """The case's outcome is the same in both packages."""
    assert _outcome(case, "jax") == _outcome(case, "port")


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


def test_pool_store_keys_and_values_across():
    """The pool's stored keys are equal byte for byte; the values (safe
    codec pickles, which name their classes' modules) decode to the same
    fields, and the port's codec admits the port's evidence classes."""
    got = {}
    for p in PKGS:
        ev, _common, _vals, (_ex, state_store, block_store, _state) = \
            attack_evidence(p)
        pool = pool_of(p, state_store, block_store)
        pool.add_evidence(ev)
        items = list(pool.db.iterate_prefix(b""))
        got[p.name] = [(k, plain(p.codec.loads(v))) for k, v in items]
    assert got["jax"] == got["port"] and len(got["port"]) == 1


# ---------------------------------------------------------------------------
# the departures: device=, no CUDA, card faults
# ---------------------------------------------------------------------------

def _card_error():
    return PORT.degrade.DeviceLaneError("launch failed on the card")


def test_duplicate_vote_rides_a_scheduler_only_on_its_device():
    """The two lanes join a running VerifyScheduler's window only when it
    runs on the evidence's device; a scheduler on another device is
    passed by (the direct host lanes), with the same verdicts."""
    gdoc, privs = make_genesis(PORT, 4)
    vals = PORT.state.state_from_genesis(gdoc).validators
    v1, v2 = dup_votes(PORT, privs[0])
    ev = PORT.ev_types.DuplicateVoteEvidence.from_votes(
        v1, v2, PORT.basic.Timestamp(1700000005, 0), vals)
    sched = PORT.scheduler.install(PORT.scheduler.VerifyScheduler(
        window_s=0.002, device="cpu"))
    sched.start()
    try:
        PORT.ev_verify.verify_duplicate_vote(ev, CHAIN, vals, device="cpu")
        on = sched.stats()["submissions"]
        sched.device = torch.device("cuda", 0)   # another device's
        PORT.ev_verify.verify_duplicate_vote(ev, CHAIN, vals, device="cpu")
        off = sched.stats()["submissions"] - on
        sched.device = torch.device("cpu")
    finally:
        sched.stop()
        PORT.scheduler.uninstall(sched)
    assert (on, off) == (1, 0)


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no CUDA and no device="cpu", the evidence entry points raise
    RuntimeError instead of running on the CPU (a 40-validator conflicting
    commit: certificates of 32 signatures and more)."""
    gdoc, privs = make_genesis(PORT, 4)
    vals = PORT.state.state_from_genesis(gdoc).validators
    v1, v2 = dup_votes(PORT, privs[0])
    ev = PORT.ev_types.DuplicateVoteEvidence.from_votes(
        v1, v2, PORT.basic.Timestamp(1700000005, 0), vals)
    gdoc40, privs40 = make_genesis(PORT, 40)
    blocks, commits, states = build_chain(PORT, gdoc40, privs40, 3)
    lb = PORT.light_block.LightBlock(PORT.light_block.SignedHeader(
        blocks[1].header, commits[1]), states[1].validators)
    lca = PORT.ev_types.LightClientAttackEvidence(
        conflicting_block=lb, common_height=1,
        total_voting_power=states[1].validators.total_voting_power(),
        timestamp=blocks[0].header.time)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT.ev_verify.verify_duplicate_vote(ev, CHAIN, vals)
    common = PORT.light_block.SignedHeader(blocks[0].header, commits[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT.ev_verify.verify_light_client_attack(
            lca, common, common, states[0].validators)
    # on the CPU, asked for, the certificates verify and the checks after
    # them decide (this honest block is no attack)
    PORT.ev_verify.verify_duplicate_vote(ev, CHAIN, vals, device="cpu")
    with pytest.raises(PORT.ev_types.EvidenceError,
                       match="monotonically increasing time"):
        PORT.ev_verify.verify_light_client_attack(
            lca, common, common, states[0].validators, device="cpu")


def _broken_verify(monkeypatch):
    """Every verify_items call raises a card fault."""
    calls = []

    def broken(items, *a, **kw):
        calls.append(len(items))
        raise _card_error()
    monkeypatch.setattr(PORT.scheduler, "verify_items", broken)
    return calls


@pytest.mark.parametrize("drill", [False, True], ids=["card", "drill"])
def test_card_fault_in_the_pool_and_validate_block(monkeypatch, drill):
    """add_evidence and check_evidence raise the DeviceLaneError itself,
    not EvidenceError, and nothing enters the pool; BlockExecutor's
    validate_block lets it out too, not as an invalid block.  In a drill
    the runtime would have re-verified on the host: the error, if one
    still escapes, is the same class either way here (no catch in the
    pool turns it into EvidenceError)."""
    gdoc, privs = make_genesis(PORT, 4)
    blocks, commits, _ = build_chain(PORT, gdoc, privs, 8)
    ex, state_store, block_store, state = synced_node(PORT, gdoc, blocks,
                                                     commits)
    pool = pool_of(PORT, state_store, block_store)
    bt = block_store.load_block_meta(5).header.time
    v1, v2 = dup_votes(PORT, privs[1])
    ev = PORT.ev_types.DuplicateVoteEvidence.from_votes(
        v1, v2, bt, state_store.load_validators(5))
    if drill:
        PORT.fail.set_mode("pipeline.commit", "latency:1")
    calls = _broken_verify(monkeypatch)
    with pytest.raises(PORT.degrade.DeviceLaneError):
        pool.add_evidence(ev)
    assert pool.size() == 0
    with pytest.raises(PORT.degrade.DeviceLaneError):
        pool.check_evidence([ev])
    ex.evidence_pool = pool
    block = state.make_block(9, [], commits[-1], [ev],
                             state.validators.get_proposer().address)
    with pytest.raises(PORT.degrade.DeviceLaneError) as ei:
        ex.validate_block(state, block)
    assert not isinstance(ei.value, PORT.execution.BlockExecutionError)
    assert calls == [2, 2, 2]


class _Switch:
    def __init__(self):
        self.peers = {}
        self.stopped = []

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append(reason)


@pytest.mark.parametrize("drill", [False, True], ids=["card", "drill"])
def test_card_fault_in_the_reactor(monkeypatch, drill):
    """Evidence gossiped while the card fails: outside a drill the reactor
    stops no peer, keeps the error on device_error and leaves the rest of
    the message; received again once the card works, the items enter the
    pool.  In a drill the JAX package's path holds: each item is dropped
    as unprocessable and the rest of the message processed, no peer
    stopped, nothing kept."""
    gdoc, privs = make_genesis(PORT, 4)
    blocks, commits, _ = build_chain(PORT, gdoc, privs, 8)
    ex, state_store, block_store, state = synced_node(PORT, gdoc, blocks,
                                                     commits)
    pool = pool_of(PORT, state_store, block_store)
    evs = []
    for i, h in ((1, 5), (2, 6)):
        bt = block_store.load_block_meta(h).header.time
        v1, v2 = dup_votes(PORT, privs[i], height=h)
        evs.append(PORT.ev_types.DuplicateVoteEvidence.from_votes(
            v1, v2, bt, state_store.load_validators(h)))
    reactor = PORT.ev_reactor.EvidenceReactor(pool)
    reactor.switch = sw = _Switch()
    msg = PORT.ev_reactor.encode_msg(PORT.ev_reactor.EvidenceGossip(
        [PORT.ev_types.evidence_proto(e) for e in evs]))
    if drill:
        PORT.fail.set_mode("pipeline.commit", "latency:1")
    real = PORT.scheduler.verify_items
    calls = _broken_verify(monkeypatch)
    reactor.receive(PORT.ev_reactor.EVIDENCE_CHANNEL, FakePeer("p1"), msg)
    assert sw.stopped == [] and pool.size() == 0
    if drill:
        assert reactor.device_error is None and calls == [2, 2]
    else:
        assert isinstance(reactor.device_error, PORT.degrade.DeviceLaneError)
        assert calls == [2]
    monkeypatch.setattr(PORT.scheduler, "verify_items", real)
    reactor.receive(PORT.ev_reactor.EVIDENCE_CHANNEL, FakePeer("p1"), msg)
    assert sw.stopped == [] and pool.size() == 2
    assert sorted(e.hash() for e in pool.pending_evidence()) == \
        sorted(e.hash() for e in evs)
