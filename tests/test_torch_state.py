"""The port's storage and block execution (kvdb, the state and block
stores, BlockExecutor, rollback) against the JAX package's, on the CPU.

The same seeded keys build the same chain in both packages through a
build_chain-like helper (the block ID from the block's part set): kvstore
blocks made by State.make_block, saved in a BlockStore, applied by
BlockExecutor.apply_block.  Compared exactly at every height: block
hashes, app hashes, last_results_hash, validator-set hashes, proposers and
the RequestBeginBlock byzantine validators; then each corrupted header
field's error, the tampered commit, mark_commit_verified, the stores' key
sets (byte for byte) and values (decoded and compared field by field
through `plain`: the stored pickles carry each package's module path, so
the bytes never cross), rollback, and kvdb's three stores.  The JAX
package's commits verify on its host lanes; the port's on device="cpu",
on the host lanes or, with TM_TPU_FORCE_BATCH=1, through the plain K1.
"""
from __future__ import annotations

import base64
import importlib
import os
import shutil
import tempfile
import types

import pytest
import torch

import tendermint_tpu_torch as T
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import CHAIN, outcome, plain, seeds, signed_vote

_MODS = {
    "abci": "abci.types", "kvstore": "abci.kvstore", "kvdb": "libs.kvdb",
    "fail": "libs.fail", "codec": "libs.safe_codec",
    "sstore": "state.store", "bstore": "store.block_store",
    "execution": "state.execution", "state": "state.state",
    "rollback": "state.rollback", "obsv": "consensus.observatory",
    "basic": "types.basic", "block": "types.block", "commit": "types.commit",
    "part_set": "types.part_set", "canonical": "types.canonical",
    "genesis": "types.genesis", "evidence": "types.evidence",
    "vote": "types.vote", "validator_set": "types.validator_set",
    "ed": "crypto.ed25519",
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


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS:
        p.obsv.reset()
        p.fail.reset()
    yield
    for p in PKGS:
        p.obsv.reset()
        p.fail.reset()


def genesis(p, n, seed=21, power=10):
    """A GenesisDoc of n seeded ed25519 keys, and the private keys."""
    G, B = p.genesis, p.basic
    privs = [p.ed.PrivKey(s) for s in seeds(n, seed)]
    doc = G.GenesisDoc(
        chain_id=CHAIN, genesis_time=B.Timestamp(1700000000, 0),
        validators=[G.GenesisValidator(
            address=b"", pub_key_type="ed25519",
            pub_key_bytes=k.pub_key().bytes(), power=power, name=f"v{i}")
            for i, k in enumerate(privs)],
        app_hash=b"\x0a" * 4)
    doc.validate_and_complete()
    return doc, privs


def sign_commit(p, vset, privs, h, bid, absent=()):
    """Every validator's precommit for bid at height h, in the set's
    order."""
    B = p.basic
    by_addr = {k.pub_key().address(): k for k in privs}
    sigs = []
    for i, v in enumerate(vset.validators):
        if i in absent:
            sigs.append(p.commit.CommitSig.absent())
            continue
        ts = B.Timestamp(1700000000 + h, 500 + i)
        sb = p.canonical.canonical_vote_bytes(
            CHAIN, B.SignedMsgType.PRECOMMIT, h, 0, bid, ts)
        sigs.append(p.commit.CommitSig(B.BlockIDFlag.COMMIT, v.address, ts,
                                       by_addr[v.address].sign(sb)))
    return p.commit.Commit(h, 0, bid, sigs)


def val_tx(pub: bytes, power: int) -> bytes:
    return b"val:" + base64.b64encode(pub) + b"!%d" % power


class Chain:
    """One package's kvstore chain: MemDB stores, a BlockExecutor, and the
    begin_block requests the app saw."""

    def __init__(self, p, gdoc, privs, device=None, db=None):
        self.p, self.privs = p, privs
        self.app = p.kvstore.KVStoreApplication()
        self.begin = []
        real = self.app.begin_block

        def begin_block(req):
            self.begin.append(req)
            return real(req)
        self.app.begin_block = begin_block
        self.state_db = (db or p.kvdb.MemDB)()
        self.block_db = (db or p.kvdb.MemDB)()
        self.state_store = p.sstore.StateStore(self.state_db)
        self.block_store = p.bstore.BlockStore(self.block_db)
        kw = {"device": device} if p is PORT else {}
        self.ex = p.execution.BlockExecutor(
            self.state_store, self.app, block_store=self.block_store, **kw)
        self.state = p.state.state_from_genesis(gdoc)
        self.state_store.save(self.state)
        self.last = p.commit.Commit(0, 0, p.basic.BlockID(), [])
        self.blocks, self.commits, self.rows = [], [], []

    def make(self, h, txs, evidence=(), last=None):
        p, B = self.p, self.p.basic
        block = self.state.make_block(
            h, txs, self.last if last is None else last, list(evidence),
            self.state.validators.get_proposer().address,
            block_time=B.Timestamp(1700000000 + h, 0))
        parts = p.part_set.make_block_parts(block)
        return block, parts, B.BlockID(block.hash(), parts.header())

    def step(self, h, txs, evidence=()):
        block, parts, bid = self.make(h, txs, evidence)
        commit = sign_commit(self.p, self.state.validators, self.privs, h,
                             bid)
        self.block_store.save_block(block, parts, commit)
        proposer = self.state.validators.get_proposer().address
        self.state, resp = self.ex.apply_block(self.state, bid, block)
        self.rows.append({
            "height": h, "block_hash": block.hash(),
            "app_hash": self.state.app_hash,
            "last_results_hash": self.state.last_results_hash,
            "validators_hash": self.state.validators.hash(),
            "next_validators_hash": self.state.next_validators.hash(),
            "proposer": proposer,
            "byzantine": plain(self.begin[-1].byzantine_validators),
            "responses": plain(resp)})
        self.blocks.append((block, parts, bid))
        self.commits.append(commit)
        self.last = commit
        return block


def dup_vote_evidence(p, vset, privs, height):
    """A DuplicateVoteEvidence of validator 1 at `height`, against `vset`
    (the set at that height)."""
    B = p.basic
    by_addr = {k.pub_key().address(): k for k in privs}
    priv = by_addr[vset.validators[1].address]
    va = signed_vote(p, priv, vset, 1, B.BlockID(
        b"\xaa" * 32, B.PartSetHeader(1, b"\xab" * 32)), height=height)
    vb = signed_vote(p, priv, vset, 1, B.BlockID(
        b"\xbb" * 32, B.PartSetHeader(1, b"\xbc" * 32)), height=height)
    return p.evidence.DuplicateVoteEvidence.from_votes(
        va, vb, B.Timestamp(1700000000 + height, 0), vset)


def txs_at(h, n=5):
    return [b"k%d_%d=%064x" % (h, i, h * 1000 + i) for i in range(n)]


def build(p, heights=12, n=4, device="cpu"):
    """4 validators over 12 heights: txs, a val: power change at height 4
    (the commits from height 6 are signed by the reordered set), and a
    DuplicateVoteEvidence in block 8."""
    gdoc, privs = genesis(p, n)
    c = Chain(p, gdoc, privs, device=device)
    sets = {}
    for h in range(1, heights + 1):
        sets[h] = c.state.validators.copy()
        txs = txs_at(h)
        if h == 4:
            txs.append(val_tx(c.state.validators.validators[2].pub_key
                              .bytes(), 25))
        ev = [dup_vote_evidence(p, sets[6], privs, 6)] if h == 8 else []
        c.step(h, txs, ev)
    return c


@pytest.fixture(scope="module")
def chains():
    T.set_default_device("cpu")
    try:
        return {p.name: build(p) for p in PKGS}
    finally:
        T.set_default_device("cuda")


@pytest.mark.parametrize("field", [
    "block_hash", "app_hash", "last_results_hash", "validators_hash",
    "next_validators_hash", "proposer", "byzantine", "responses"])
def test_chain_equal_at_every_height(chains, field):
    j, t = chains["jax"].rows, chains["port"].rows
    assert len(j) == len(t) == 12
    assert [r[field] for r in j] == [r[field] for r in t]


def test_chain_cases_took_effect(chains):
    """The val: change reordered the set and the evidence reached the app
    as one Misbehavior (the kvstore records it)."""
    rows = chains["port"].rows
    assert len({r["validators_hash"] for r in rows}) == 2
    assert [len(r["byzantine"]) for r in rows].count(1) == 1
    assert rows[7]["byzantine"][0][1]["height"] == 6
    app = chains["port"].app
    assert any(k.startswith(b"misbehavior/6/") for k in app.data)
    assert app.height == 12


def test_state_equal(chains):
    assert plain(chains["jax"].state) == plain(chains["port"].state)


def _decoded(p, db):
    out = {}
    for k, v in db.iterate_prefix(b""):
        try:
            out[k] = plain(p.codec.loads(v))
        except Exception:  # noqa: BLE001 - raw values (the hash index)
            out[k] = v
    return out


@pytest.mark.parametrize("store", ["state_db", "block_db"])
def test_store_keys_and_values_equal(chains, store):
    """The key sets are equal byte for byte; each value decodes to the same
    fields.  The pickled bytes differ (module paths), so they are never
    compared across the packages."""
    j, t = chains["jax"], chains["port"]
    jdb, tdb = getattr(j, store), getattr(t, store)
    jkeys = [k for k, _ in jdb.iterate_prefix(b"")]
    assert jkeys == [k for k, _ in tdb.iterate_prefix(b"")]
    assert len(jkeys) > 12
    assert _decoded(JAX, jdb) == _decoded(PORT, tdb)


def test_block_store_loads_equal(chains):
    j, t = chains["jax"].block_store, chains["port"].block_store
    assert j.height() == t.height() == 12 and j.base() == t.base() == 1
    for h in range(1, 13):
        for name in ("load_block", "load_block_meta", "load_block_commit",
                     "load_seen_commit"):
            assert plain(getattr(j, name)(h)) == plain(getattr(t, name)(h))
        assert t.load_block(h).hash() == t.load_block_meta(h).block_id.hash


def test_state_store_loads_equal(chains):
    j, t = chains["jax"].state_store, chains["port"].state_store
    assert plain(j.load()) == plain(t.load())
    for h in range(1, 15):
        assert plain(j.load_validators(h)) == plain(t.load_validators(h))
        assert plain(j.load_consensus_params(h)) == \
            plain(t.load_consensus_params(h))
        assert plain(j.load_abci_responses(h)) == \
            plain(t.load_abci_responses(h))


def test_rollback_equal():
    """rollback on each package's stores: the same height and app hash
    (block 6's header's), and the same rolled-back State."""
    got = {}
    for p in PKGS:
        c = build(p, heights=6)
        got[p.name] = (p.rollback.rollback(c.block_store, c.state_store),
                       plain(c.state_store.load()))
        assert got[p.name][0] == (5, c.blocks[5][0].header.app_hash)
        with pytest.raises(p.rollback.RollbackError):
            p.rollback.rollback(p.bstore.BlockStore(p.kvdb.MemDB()),
                                c.state_store)
    assert got["jax"] == got["port"]


# ---------------------------------------------------------------------------
# validate_block: each header field, the last commit, the proposer
# ---------------------------------------------------------------------------

def _corrupt(field):
    def fn(p, c, block):
        B, h = p.basic, block.header
        if field == "version":
            h.version = p.block.Consensus(block=10, app=0)
        elif field == "app_version":
            h.version = p.block.Consensus(block=11, app=3)
        elif field == "chain_id":
            h.chain_id = "other-chain"
        elif field == "height":
            h.height = 5
        elif field == "last_block_id":
            h.last_block_id = B.BlockID(b"\x01" * 32,
                                        B.PartSetHeader(1, b"\x02" * 32))
        elif field in ("app_hash", "validators_hash",
                       "next_validators_hash", "consensus_hash",
                       "last_results_hash"):
            setattr(h, field, b"\x33" * 32)
        elif field == "proposer_address":
            h.proposer_address = b"\x44" * 20
        elif field == "nil_last_commit":
            block.last_commit = None
        elif field == "short_last_commit":
            lc = block.last_commit
            block.last_commit = p.commit.Commit(
                lc.height, lc.round, lc.block_id, lc.signatures[:-1])
            h.last_commit_hash = block.last_commit.hash()
        return block
    return fn


FIELDS = ["version", "app_version", "chain_id", "height", "last_block_id",
          "app_hash", "validators_hash", "next_validators_hash",
          "consensus_hash", "last_results_hash", "proposer_address",
          "nil_last_commit", "short_last_commit"]


@pytest.mark.parametrize("field", FIELDS)
def test_validate_block_errors_equal(field):
    """A block at height 3 with one header field (or its last commit)
    corrupted: the same exception class and message in both packages, and
    the uncorrupted block validates."""
    got = {}
    for p in PKGS:
        gdoc, privs = genesis(p, 4)
        c = Chain(p, gdoc, privs, device="cpu")
        for h in (1, 2):
            c.step(h, txs_at(h))
        block, _, _ = c.make(3, txs_at(3))
        c.ex.validate_block(c.state, block)
        bad = _corrupt(field)(p, c, block)
        got[p.name] = outcome(lambda: c.ex.validate_block(c.state, bad))
        assert got[p.name][0] != "ok"
    assert got["jax"] == got["port"]


def test_initial_block_with_last_commit_signatures_refused():
    got = {}
    for p in PKGS:
        gdoc, privs = genesis(p, 4)
        c = Chain(p, gdoc, privs, device="cpu")
        b1, _, bid = c.make(1, [])
        lc = sign_commit(p, c.state.validators, privs, 1, bid)
        block, _, _ = c.make(1, [], last=lc)
        got[p.name] = outcome(lambda: c.ex.validate_block(c.state, block))
    assert got["jax"] == got["port"]
    assert "initial block" in got["port"][1]


def test_tampered_last_commit_refused_alike():
    """One flipped signature in block 3's last commit: CommitVerifyError
    with the same message, and neither the state, the stores nor the app
    move; the untampered block then applies."""
    got = {}
    for p in PKGS:
        gdoc, privs = genesis(p, 4)
        c = Chain(p, gdoc, privs, device="cpu")
        for h in (1, 2):
            c.step(h, txs_at(h))
        lc = c.last
        s0 = lc.signatures[0]
        flipped = p.commit.Commit(lc.height, lc.round, lc.block_id, [
            p.commit.CommitSig(s0.block_id_flag, s0.validator_address,
                               s0.timestamp, bytes([s0.signature[0] ^ 1])
                               + s0.signature[1:])] + lc.signatures[1:])
        block, _, bid = c.make(3, txs_at(3), last=flipped)
        state0 = c.state
        got[p.name] = outcome(lambda: c.ex.apply_block(c.state, bid, block))
        assert c.state is state0
        assert c.state_store.load().last_block_height == 2
        assert c.app.info(p.abci.RequestInfo()).last_block_height == 2
        assert c.state_store.load_abci_responses(3) is None
        c.step(3, txs_at(3))
        assert c.state.last_block_height == 3
    assert got["jax"] == got["port"]
    assert got["port"][0] == "CommitVerifyError"


def test_mark_commit_verified_skips_signatures_not_power(monkeypatch):
    """A last commit marked as verified is not re-verified (a zeroed
    signature passes), while the power tally still refuses a commit short
    of 2/3; a commit of any other content misses the mark and verifies."""
    got = {}
    for p in PKGS:
        gdoc, privs = genesis(p, 4)
        c = Chain(p, gdoc, privs, device="cpu")
        for h in (1, 2):
            c.step(h, txs_at(h))
        calls = []
        VS = p.validator_set.ValidatorSet
        real = VS.verify_commit

        def counted(self, *a, **k):
            calls.append(1)
            return real(self, *a, **k)
        monkeypatch.setattr(VS, "verify_commit", counted)
        lc = c.last

        def with_sigs(sigs):
            return p.commit.Commit(lc.height, lc.round, lc.block_id, sigs)

        def zeroed(i):
            s = lc.signatures[i]
            return p.commit.CommitSig(s.block_id_flag, s.validator_address,
                                      s.timestamp, bytes(64))
        short = with_sigs([p.commit.CommitSig.absent()] * 2
                          + lc.signatures[2:])
        bad0 = with_sigs([zeroed(0)] + lc.signatures[1:])
        bad1 = with_sigs(lc.signatures[:1] + [zeroed(1)] + lc.signatures[2:])
        res = []
        for commit, mark in ((short, short), (bad0, bad0), (bad1, lc)):
            block, _, bid = c.make(3, txs_at(3), last=commit)
            c.ex.mark_commit_verified(2, mark)
            res.append(outcome(lambda: c.ex.validate_block(c.state, block)))
            res.append(len(calls))
        got[p.name] = res
        monkeypatch.undo()
    assert got["jax"] == got["port"]
    r = got["port"]
    assert r[0][0] == "NotEnoughVotingPowerError" and r[1] == 0
    assert r[2] == ("ok", None) and r[3] == 0
    assert r[4][0] == "CommitVerifyError" and r[5] == 1


# ---------------------------------------------------------------------------
# the device path: 64 validators through the port's plain K1
# ---------------------------------------------------------------------------

def test_64_validators_through_the_plain_k1(monkeypatch):
    """A 64-validator chain of 3 heights: the JAX package on its host
    lanes, the port on device="cpu" with TM_TPU_FORCE_BATCH=1, so both last
    commits go through the plain K1 (verify_packed_plain, counted); every
    hash equal."""
    from tendermint_tpu_torch.ops import cuda_ed25519 as ck

    rows = {}
    for p in PKGS:
        if p is PORT:
            monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
            launched = []
            real = ck.verify_packed_plain
            monkeypatch.setattr(ck, "verify_packed_plain", lambda packed: (
                launched.append(packed.shape[1]), real(packed))[1])
        gdoc, privs = genesis(p, 64, seed=23)
        c = Chain(p, gdoc, privs, device="cpu")
        for h in (1, 2, 3):
            c.step(h, txs_at(h, 3))
        rows[p.name] = c.rows
    assert rows["jax"] == rows["port"]
    # one launch a last commit, its 64 lanes padded to the launch bucket
    assert len(launched) == 2 and all(n >= 64 for n in launched)


def test_cuda_missing_raises_on_a_device_sized_last_commit(monkeypatch):
    """With no CUDA and no device="cpu", apply_block of a block whose last
    commit has at least 32 signatures raises RuntimeError before the app
    sees the block; device="cpu" applies it."""
    gdoc, privs = genesis(PORT, 32, seed=25)
    c = Chain(PORT, gdoc, privs, device="cpu")
    c.step(1, txs_at(1))
    block, _, bid = c.make(2, txs_at(2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    for ex in (PORT.execution.BlockExecutor(c.state_store, c.app),
               PORT.execution.BlockExecutor(c.state_store, c.app,
                                            device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ex.apply_block(c.state, bid, block)
    assert c.app.info(PORT.abci.RequestInfo()).last_block_height == 1
    state, _ = c.ex.apply_block(c.state, bid, block)
    assert state.last_block_height == 2


def test_observatory_stamps_each_apply(pkg):
    """apply_block stamps apply_start and apply_done under the executor's
    obs_node: one apply stage a height."""
    gdoc, privs = genesis(pkg, 4)
    c = Chain(pkg, gdoc, privs, device="cpu")
    c.ex.obs_node = "exec"
    for h in (1, 2, 3):
        c.step(h, txs_at(h))
    pkg.obsv.publish_pending()
    recs = pkg.obsv.records("exec")
    assert [r["height"] for r in recs] == [1, 2, 3]
    assert all(r["stages"]["apply"] is not None for r in recs)


def test_propose_reap_raise_gives_an_empty_block(pkg):
    """propose.reap=raise: create_proposal_block degrades to an empty
    block, never a stalled round."""
    class Mempool:
        def reap_max_bytes_max_gas(self, max_bytes, max_gas):
            return [b"a=1", b"b=2"]

    gdoc, privs = genesis(pkg, 4)
    c = Chain(pkg, gdoc, privs, device="cpu")
    c.ex.mempool = Mempool()
    proposer = c.state.validators.get_proposer().address
    block = c.ex.create_proposal_block(1, c.state, c.last, proposer)
    assert block.data.txs == [b"a=1", b"b=2"]
    pkg.fail.set_mode("propose.reap", "raise")
    block = c.ex.create_proposal_block(1, c.state, c.last, proposer)
    assert block.data.txs == [] and pkg.fail.fired("propose.reap",
                                                   "raise") == 1
    assert c.ex.last_propose_timings["reap_degraded"] is True


def test_update_state_and_helpers_equal():
    """max_data_bytes and validator_updates_to_validators (and its refusal
    of a non-ed25519 key) agree."""
    for args in ((22020096, 0, 4), (2048, 3, 100), (-1, 0, 1)):
        assert JAX.execution.max_data_bytes(*args) == \
            PORT.execution.max_data_bytes(*args)
    got = {}
    for p in PKGS:
        ups = [p.abci.ValidatorUpdate("ed25519", bytes(range(32)), 5),
               p.abci.ValidatorUpdate("ed25519", bytes(range(1, 33)), 0)]
        bad = [p.abci.ValidatorUpdate("secp256k1", b"\x02" * 33, 5)]
        got[p.name] = (
            outcome(lambda: p.execution.validator_updates_to_validators(ups)),
            outcome(lambda: p.execution.validator_updates_to_validators(bad)))
    assert got["jax"] == got["port"]
    assert got["port"][1][0] == "BlockExecutionError"


# ---------------------------------------------------------------------------
# kvdb: the three stores under one operation sequence, and group commit
# ---------------------------------------------------------------------------

def _ops(db):
    """A fixed sequence of writes and reads; the reads as a list."""
    out = []
    db.set(b"a", b"1")
    db.set(b"b\xff", b"2")
    db.set(b"b\xff\xff\x00", b"3")
    db.set(b"c", b"4")
    db.write_batch([(b"d1", b"5"), (b"d2", b"6"), (b"a", b"7")], [b"c"])
    db.delete(b"missing")
    for k in (b"a", b"c", b"d2", b"b\xff", b"zz"):
        out.append((db.get(k), db.has(k)))
    for prefix in (b"", b"b", b"b\xff", b"d", b"\xff", b"q"):
        out.append(list(db.iterate_prefix(prefix)))
    db.write_batch([], [b"d1", b"a"])
    out.append(list(db.iterate_prefix(b"")))
    db.flush()
    return out


@pytest.fixture
def db_dir():
    d = tempfile.mkdtemp(prefix="tmk")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("kind", ["mem", "sqlite", "sqlite_deferred",
                                  "group_mem", "group_sqlite"])
def test_kvdb_stores_equal(kind, db_dir):
    """Each store, in each package, answers the operation sequence as the
    port's MemDB does."""
    def make(p, tag):
        K = p.kvdb
        path = os.path.join(db_dir, f"{p.name}-{tag}.db")
        return {"mem": K.MemDB, "sqlite": lambda: K.SQLiteDB(path),
                "sqlite_deferred": lambda: K.SQLiteDB(path, commit_every=3),
                "group_mem": lambda: K.GroupCommitDB(K.MemDB()),
                "group_sqlite": lambda: K.GroupCommitDB(K.SQLiteDB(path))}[
                    kind]()
    want = _ops(PORT.kvdb.MemDB())
    for p in PKGS:
        db = make(p, "a")
        assert _ops(db) == want, p.name
        if kind.startswith("group"):
            # in group mode a write is buffered, visible, and lands on flush
            db.begin_group_mode()
            db.set(b"g", b"1")
            got = (db.pending_ops(), db.inner.get(b"g"), db.get(b"g"))
            db.flush()
            assert got + (db.inner.get(b"g"),) == (1, None, b"1", b"1")
            db.end_group_mode()
        db.close()
    assert PORT.kvdb.prefix_upper_bound(b"a\xff\xff") == b"b"
    assert PORT.kvdb.prefix_upper_bound(b"\xff") is None


def test_sqlite_reopens_what_it_committed(db_dir):
    for p in PKGS:
        path = os.path.join(db_dir, f"{p.name}.db")
        db = p.kvdb.SQLiteDB(path, commit_every=64)
        db.set(b"k", b"v")
        db.write_batch([(b"k2", b"v2")])
        db.close()
        db = p.kvdb.SQLiteDB(path)
        assert list(db.iterate_prefix(b"k")) == [(b"k", b"v"), (b"k2", b"v2")]
        db.close()


def test_group_commit_chaos_alike():
    """kvdb.group_commit=raise: commit_group raises before its write, the
    taken group stays visible in flight, and flush() lands it; the same in
    both packages, and the inner store ends equal."""
    got = {}
    for p in PKGS:
        p.fail.reset()
        inner = p.kvdb.MemDB()
        db = p.kvdb.GroupCommitDB(inner)
        db.begin_group_mode()
        db.set(b"x", b"1")
        db.set(b"y", b"2")
        db.delete(b"x")
        g = db.take_group()
        p.fail.set_mode("kvdb.group_commit", "raise")
        r = [outcome(lambda: db.commit_group(g)),
             p.fail.fired("kvdb.group_commit", "raise"),
             db.get(b"y"), db.get(b"x"), inner.get(b"y")]
        p.fail.reset()
        db.flush()
        r += [inner.get(b"y"), inner.get(b"x"), db.pending_ops()]
        db.set(b"z", b"3")
        g2 = db.take_group()
        db.commit_group(g2)
        db.commit_group(g2)      # a landed group is not re-written
        r.append(list(inner.iterate_prefix(b"")))
        got[p.name] = r
    assert got["jax"] == got["port"]
    assert got["port"][1] == 1 and got["port"][4] is None
    assert got["port"][5] == b"2"
