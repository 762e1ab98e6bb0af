"""The port's VoteSet against the JAX package's, on the CPU.

The nine cases of tests/test_vote_set.py run through both packages.  Then
the path the chip smoke drives on the card ("votes to a commit"), at 64
validators: a genesis doc, a block at height 2 and its parts, a signed
precommit from every validator carried through the wire encoding, two
corrupted signatures and one conflicting precommit; the consensus
pre-verify of every triple through a running VerifyScheduler (the port's
real plain K1; the JAX package's kernel stubbed by the host oracle, whose
XLA ladder takes about 30 s to compile on the CPU); the VoteSet, where
every valid vote is a cache hit and only the corrupted ones reach a host
verify; make_commit, the light block, verify_commit and the next block.
Every comparison across the packages is exact.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

from test_torch_types import (CHAIN, JAX, PKGS, PORT, both, genesis_doc,
                              plain)
from test_torch_types import _cpu, _one_torch_thread, pkg  # noqa: F401
from tendermint_tpu_torch.ops import ed25519 as ted


def make_fixture(p, n=4, power=10):
    pairs = []
    for i in range(n):
        priv = p.ed.PrivKey((1000 + i).to_bytes(32, "big"))
        pairs.append((priv, p.validator.Validator.new(priv.pub_key(), power)))
    vs = p.validator_set.ValidatorSet([v for _, v in pairs])
    by_addr = {v.address: k for k, v in pairs}
    return vs, [by_addr[v.address] for v in vs.validators]


def mkvote(p, priv, idx, vs, block_id, height=1, round_=0, vtype=None,
           ts=None):
    B = p.basic
    v = p.vote.Vote(
        type=B.SignedMsgType.PRECOMMIT if vtype is None else vtype,
        height=height, round=round_, block_id=block_id,
        timestamp=ts or B.Timestamp(1700000000 + idx, 0),
        validator_address=vs.validators[idx].address,
        validator_index=idx)
    v.signature = priv.sign(v.sign_bytes(CHAIN))
    return v


def bid(p, a=1, b=2):
    return p.basic.BlockID(bytes([a] * 32), p.basic.PartSetHeader(
        2, bytes([b] * 32)))


def vote_set(p, vs, vtype=None, height=1):
    return p.vote_set.VoteSet(
        CHAIN, height, 0,
        p.basic.SignedMsgType.PRECOMMIT if vtype is None else vtype, vs)


# ---------------------------------------------------------------------------
# tests/test_vote_set.py, through both packages
# ---------------------------------------------------------------------------

def test_add_votes_to_majority(pkg):
    vs, privs = make_fixture(pkg)
    vset = vote_set(pkg, vs)
    assert not vset.has_two_thirds_majority()
    for i in range(3):
        assert vset.add_vote(mkvote(pkg, privs[i], i, vs, bid(pkg)))
        if i < 2:
            assert not vset.has_two_thirds_majority(), i
    got, ok = vset.two_thirds_majority()
    assert ok and got == bid(pkg)
    assert vset.has_two_thirds_any()


def test_duplicate_vote_not_added(pkg):
    vs, privs = make_fixture(pkg)
    vset = vote_set(pkg, vs)
    v = mkvote(pkg, privs[0], 0, vs, bid(pkg))
    assert vset.add_vote(v)
    assert vset.add_vote(v) is False


def test_wrong_height_round_type_rejected(pkg):
    vs, privs = make_fixture(pkg)
    vset = vote_set(pkg, vs)
    for kw in ({"height": 2}, {"round_": 1},
               {"vtype": pkg.basic.SignedMsgType.PREVOTE}):
        with pytest.raises(pkg.vote_set.VoteSetError):
            vset.add_vote(mkvote(pkg, privs[0], 0, vs, bid(pkg), **kw))


def test_bad_signature_rejected(pkg):
    vs, privs = make_fixture(pkg)
    vset = vote_set(pkg, vs)
    v = mkvote(pkg, privs[0], 0, vs, bid(pkg))
    v.signature = bytes([v.signature[0] ^ 1]) + v.signature[1:]
    with pytest.raises(pkg.vote_set.VoteSetError, match="invalid signature"):
        vset.add_vote(v)


def test_conflicting_votes_raise_evidence(pkg):
    vs, privs = make_fixture(pkg)
    vset = vote_set(pkg, vs)
    assert vset.add_vote(mkvote(pkg, privs[0], 0, vs, bid(pkg)))
    other = bid(pkg, 9, 9)
    with pytest.raises(pkg.vote_set.ConflictingVoteError) as ei:
        vset.add_vote(mkvote(pkg, privs[0], 0, vs, other))
    assert ei.value.vote_a.block_id == bid(pkg)
    assert ei.value.vote_b.block_id == other


def test_nil_votes_count_toward_any_but_not_block(pkg):
    vs, privs = make_fixture(pkg)
    vset = vote_set(pkg, vs)
    for i in range(3):
        vset.add_vote(mkvote(pkg, privs[i], i, vs, pkg.basic.BlockID()))
    assert vset.has_two_thirds_any()
    got, ok = vset.two_thirds_majority()
    assert ok and got == pkg.basic.BlockID()


def test_make_commit(pkg):
    vs, privs = make_fixture(pkg)
    vset = vote_set(pkg, vs)
    for i in range(3):
        vset.add_vote(mkvote(pkg, privs[i], i, vs, bid(pkg)))
    vset.add_vote(mkvote(pkg, privs[3], 3, vs, pkg.basic.BlockID()))
    commit = vset.make_commit()
    assert commit.height == 1 and commit.block_id == bid(pkg)
    assert len(commit.signatures) == 4
    flags = [s.block_id_flag for s in commit.signatures]
    assert flags.count(pkg.basic.BlockIDFlag.COMMIT) == 3
    assert flags.count(pkg.basic.BlockIDFlag.NIL) == 1
    vs.verify_commit(CHAIN, bid(pkg), 1, commit)


def test_peer_maj23_tracking(pkg):
    vs, privs = make_fixture(pkg)
    prevote = pkg.basic.SignedMsgType.PREVOTE
    vset = vote_set(pkg, vs, prevote)
    other = bid(pkg, 9, 9)
    vset.set_peer_maj23("peer1", other)
    assert vset.add_vote(mkvote(pkg, privs[0], 0, vs, bid(pkg),
                                vtype=prevote))
    with pytest.raises(pkg.vote_set.ConflictingVoteError):
        vset.add_vote(mkvote(pkg, privs[0], 0, vs, other, vtype=prevote))
    ba = vset.bit_array_by_block_id(other)
    assert ba is not None and ba.get_index(0)


def test_bitarray(pkg):
    BA = pkg.bits.BitArray
    ba = BA(10)
    assert ba.is_empty() and not ba.is_full()
    for i in (0, 3, 9):
        ba.set_index(i, True)
    assert ba.get_true_indices() == [0, 3, 9]
    assert ba.num_true_bits() == 3
    assert ba.not_().get_true_indices() == [1, 2, 4, 5, 6, 7, 8]
    assert BA.from_indices(4, range(4)).is_full()
    assert BA.from_bytes(10, ba.to_bytes()) == ba


def test_vote_set_replayed_across():
    """The same votes replayed into both packages' VoteSets, every kind of
    outcome among them, leave the same state behind."""
    def run(p):
        vs, privs = make_fixture(p, 7)
        prevote = p.basic.SignedMsgType.PREVOTE
        vset = vote_set(p, vs, prevote, height=3)
        vset.set_peer_maj23("peer", bid(p, 5, 5))
        out = []
        plan = [(0, bid(p)), (1, bid(p)), (1, bid(p)), (2, bid(p, 5, 5)),
                (2, bid(p)), (3, p.basic.BlockID()), (4, bid(p)),
                (5, bid(p)), (6, bid(p, 7, 7)), (6, bid(p)), (0, bid(p, 5, 5))]
        for idx, b in plan:
            v = mkvote(p, privs[idx], idx, vs, b, height=3, vtype=prevote)
            try:
                out.append(vset.add_vote(v))
            except p.vote_set.VoteSetError as e:
                out.append((type(e).__name__, str(e)))
        bad = mkvote(p, privs[1], 2, vs, bid(p), height=3, vtype=prevote)
        for v in (None, bad):
            try:
                vset.add_vote(v)
            except p.vote_set.VoteSetError as e:
                out.append((type(e).__name__, str(e)))
        out += [vset.two_thirds_majority(), vset.has_two_thirds_any(),
                vset.has_all(), vset.bit_array(),
                vset.bit_array_by_block_id(bid(p)),
                vset.bit_array_by_block_id(bid(p, 5, 5)),
                [vset.get_by_index(i) for i in range(7)], vset.sum]
        try:
            vset.make_commit()
        except p.vote_set.VoteSetError as e:
            out.append(str(e))
        return out
    assert both(run)[0] == "ok"


# ---------------------------------------------------------------------------
# the path of the smoke's "votes to a commit" phase, at 64 validators
# ---------------------------------------------------------------------------

N = 64
BAD = (5, 40)          # 1 in 1,000, at least 2
CONFLICT = 7           # signs a second precommit for another block


@pytest.fixture
def _schedulers(monkeypatch):
    """A fresh SigCache and degradation runtime a package, and every
    scheduler stopped and uninstalled at the end."""
    for p in PKGS:
        monkeypatch.setattr(p.batch, "verified_sigs", p.batch.SigCache())
    started = []
    yield started
    for s in started:
        s.stop()
    for p in PKGS:
        p.sched.uninstall()
        p.degrade.reset()


def _oracle_kernel(p):
    """The JAX package's device lane, stubbed by the host oracle behind
    its own ops.ed25519.verify_batch seam."""
    def verify(pubkeys, msgs, sigs, cache_pubs=False, device=None):
        p.fail.inject("ops.ed25519.verify_batch")
        return np.array([p.ed.PubKey(bytes(k)).verify_signature(
            bytes(m), bytes(s)) for k, m, s in zip(pubkeys, msgs, sigs)])
    return verify


def _chain(p):
    """Genesis (through its JSON), the set, its keys in the set's order,
    and the block at height 2 with its parts."""
    B = p.basic
    doc = p.genesis.GenesisDoc.from_json(
        genesis_doc(p, N, seed=41).to_json())
    vs = doc.validator_set()
    privs_by_addr = {k.pub_key().address(): k for k in (
        p.ed.PrivKey(s) for s in _seeds())}
    privs = [privs_by_addr[v.address] for v in vs.validators]
    # the height-1 commit the block carries
    bid1 = B.BlockID(b"\x11" * 32, B.PartSetHeader(1, b"\x12" * 32))
    sigs = []
    for i, v in enumerate(vs.validators):
        ts = B.Timestamp(1700000001, i)
        sb = p.canonical.canonical_vote_bytes(
            CHAIN, B.SignedMsgType.PRECOMMIT, 1, 0, bid1, ts)
        sigs.append(p.commit.CommitSig(B.BlockIDFlag.COMMIT, v.address, ts,
                                       privs[i].sign(sb)))
    last = p.commit.Commit(1, 0, bid1, sigs)
    rng = np.random.default_rng(42)
    txs = [bytes(rng.integers(0, 256, int(rng.integers(16, 200)),
                              dtype=np.uint8)) for _ in range(300)]
    block = _block(p, vs, 2, txs, bid1, last)
    parts = p.part_set.make_block_parts(block)
    return doc, vs, privs, block, parts


def _seeds():
    rng = np.random.default_rng(41)
    return [bytes(r) for r in rng.integers(0, 256, (N, 32), dtype=np.uint8)]


def _block(p, vs, height, txs, last_bid, last_commit):
    B = p.basic
    block = p.block.Block(
        header=p.block.Header(
            chain_id=CHAIN, height=height,
            time=B.Timestamp(1700000000 + height, 1),
            last_block_id=last_bid, validators_hash=vs.hash(),
            next_validators_hash=vs.hash(),
            consensus_hash=p.params.ConsensusParams().hash(),
            app_hash=b"\x00" * 8,
            proposer_address=vs.get_proposer().address),
        data=p.block.Data(txs=txs), last_commit=last_commit)
    block.fill_header()
    return block


def _votes(p, vs, privs, block_id):
    """A precommit for block_id from every validator (distinct
    timestamps), each carried through its wire encoding; BAD's signatures
    corrupted; CONFLICT's second precommit for another block last."""
    B = p.basic
    votes = []
    for i, v in enumerate(vs.validators):
        vote = p.vote.Vote(B.SignedMsgType.PRECOMMIT, 2, 0, block_id,
                           B.Timestamp(1700000002, 1000 + 7 * i), v.address,
                           i)
        vote.signature = privs[i].sign(vote.sign_bytes(CHAIN))
        if i in BAD:
            s = bytearray(vote.signature)
            s[3] ^= 0x10
            vote.signature = bytes(s)
        votes.append(p.vote.Vote.from_proto(vote.proto()))
    other = B.BlockID(b"\xee" * 32, B.PartSetHeader(1, b"\xef" * 32))
    conflict = p.vote.Vote(B.SignedMsgType.PRECOMMIT, 2, 0, other,
                           B.Timestamp(1700000002, 5), vs.validators[
                               CONFLICT].address, CONFLICT)
    conflict.signature = privs[CONFLICT].sign(conflict.sign_bytes(CHAIN))
    votes.append(p.vote.Vote.from_proto(conflict.proto()))
    return votes


def test_votes_to_commit_path(monkeypatch, _schedulers):
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    monkeypatch.setattr(JAX.batch, "ed_ops_verify", _oracle_kernel(JAX))
    out = {}
    for p in PKGS:
        B = p.basic
        doc, vs, privs, block, parts = _chain(p)
        block_id = B.BlockID(block.hash(), parts.header())
        votes = _votes(p, vs, privs, block_id)
        oracle = [vs.validators[v.validator_index].pub_key.verify_signature(
            v.sign_bytes(CHAIN), v.signature) for v in votes]
        # the consensus pre-verify of the burst, one coalesced launch
        launch0 = ted.last_launch()["seq"]
        s = p.sched.install(p.sched.VerifyScheduler(
            window_s=0.002, max_batch=8192, max_pending=65536,
            tpu_threshold=32))
        _schedulers.append(s)
        s.start()
        items = [(vs.validators[v.validator_index].pub_key,
                  v.sign_bytes(CHAIN), v.signature) for v in votes]
        all_ok, bits = p.sched.verify_items(
            items, p.sched.Priority.CONSENSUS,
            deadline=time.monotonic() + 0.005)
        s.stop()
        st = s.stats()
        assert bits.tolist() == oracle and not all_ok
        assert (st["launches"], st["lanes"]) == (1, N + 1)
        if p is PORT:
            rec = ted.last_launch()
            assert rec["seq"] == launch0 + 1 and rec["path"] == "cuda"
            assert rec["n"] == N + 1
        # the VoteSet: a host verify only where the cache has no entry
        calls = []
        real = type(vs.validators[0].pub_key).verify_signature
        vset = p.vote_set.VoteSet(CHAIN, 2, 0, B.SignedMsgType.PRECOMMIT, vs)
        results, conflict = [], None
        with monkeypatch.context() as m:
            m.setattr(type(vs.validators[0].pub_key), "verify_signature",
                      lambda k, m, g: calls.append(1) or real(k, m, g))
            for v in votes:
                try:
                    results.append(vset.add_vote(v))
                except p.vote_set.ConflictingVoteError as e:
                    conflict = e
                    results.append((type(e).__name__, str(e)))
                except p.vote_set.VoteSetError as e:
                    results.append((type(e).__name__, str(e)))
        assert len(calls) == len(BAD)
        assert [i for i, r in enumerate(results) if r is not True] == \
            [*BAD, N]
        ev = p.evidence.DuplicateVoteEvidence.from_votes(
            conflict.vote_a, conflict.vote_b, block.header.time, vs)
        ev.validate_basic()
        ev2 = p.evidence.evidence_from_proto(p.evidence.evidence_proto(ev))
        assert ev2.hash() == ev.hash()
        got, ok = vset.two_thirds_majority()
        assert ok and got == block_id
        commit = vset.make_commit()
        light = p.light.LightBlock(p.light.SignedHeader(block.header,
                                                        commit), vs)
        light.validate_basic(CHAIN)
        with monkeypatch.context() as m:
            m.delenv("TM_TPU_FORCE_BATCH")
            vs.verify_commit(CHAIN, block_id, 2, commit)
        # the next block carries the commit; its parts reassemble
        nxt = _block(p, vs, 3, [b"k=v"], block_id, commit)
        nparts = p.part_set.make_block_parts(nxt)
        peer = p.part_set.PartSet(nparts.header())
        for part in nparts.iter_parts():
            assert peer.add_part(p.part_set.Part.from_proto(part.proto()))
        back = p.block.Block.from_proto(peer.assemble())
        assert back.hash() == nxt.hash()
        bus = p.event_bus.EventBus()
        sub = bus.subscribe()
        for v in votes:
            if vset.get_by_index(v.validator_index) is v:
                bus.publish_vote(v)
        bus.publish_new_block(nxt, p.basic.BlockID(nxt.hash(),
                                                   nparts.header()),
                              type("R", (), {"deliver_txs": []})())
        kinds = [sub.queue.get_nowait().type for _ in range(sub.queue.qsize())]
        assert kinds == ["Vote"] * (N - len(BAD)) + ["NewBlock", "Tx"]
        out[p.name] = dict(
            genesis=doc.to_json(), block=block.proto(),
            parts=[pt.proto() for pt in parts.iter_parts()],
            bits=bits.tolist(), results=plain(results),
            evidence=p.evidence.evidence_proto(ev), commit=commit.proto(),
            light=light.proto(), next=nxt.proto())
    assert out["jax"] == out["port"]
