"""The port's types (bits, params, vote, proposal, part_set, block,
light_block, evidence, genesis) against the JAX package's, on the CPU.

Every case of tests/test_wire.py and tests/test_types.py runs through both
packages (the `pkg` parameter).  The cross-package cases build the same
seeded inputs in both packages and compare exactly: encodings, hashes,
JSON text and exceptions with their messages.  State crosses between the
packages by the types' own encodings (proto / from_proto, GenesisDoc
to_json / from_json), each way; decoded objects are compared field by
field through `plain`, since the two packages' classes never compare
equal to each other.  Pickles are never compared across the packages:
they carry the module path.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import importlib
import json
import random
import types
from fractions import Fraction

import numpy as np
import pytest
import torch

import tendermint_tpu_torch as T

_MODS = {
    "bits": "libs.bits", "pd": "libs.protodec", "pe": "libs.protoenc",
    "fail": "libs.fail",
    "native": "libs.native", "aj": "libs.amino_json",
    "codec": "libs.safe_codec", "log": "libs.log", "abci": "abci.types",
    "basic": "types.basic", "canonical": "types.canonical",
    "commit": "types.commit", "params": "types.params",
    "vote": "types.vote", "proposal": "types.proposal",
    "part_set": "types.part_set", "block": "types.block",
    "validator": "types.validator", "validator_set": "types.validator_set",
    "vote_set": "types.vote_set", "light": "types.light_block",
    "evidence": "types.evidence", "genesis": "types.genesis",
    "event_bus": "types.event_bus", "ed": "crypto.ed25519",
    "merkle": "crypto.merkle", "batch": "crypto.batch",
    "sched": "crypto.scheduler", "degrade": "crypto.degrade",
}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)
CHAIN = "test-chain"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port on the CPU, both packages' host lanes (no batch override)
    and no failpoint armed."""
    T.set_default_device("cpu")
    monkeypatch.delenv("TM_TPU_DISABLE_BATCH", raising=False)
    monkeypatch.delenv("TM_TPU_FORCE_BATCH", raising=False)
    for p in PKGS:
        p.fail.reset()
    yield
    for p in PKGS:
        p.fail.reset()
    T.set_default_device("cuda")


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


def plain(x):
    """A package-free view of a value: dataclasses as (class name, fields),
    enums as ints, keys as (type, bytes), bit arrays and validator sets by
    their contents."""
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    name = type(x).__name__
    if name == "BitArray":
        return (name, x.bits, bytes(x.elems))
    if name == "ValidatorSet":
        return (name, plain(x.validators), plain(x.proposer),
                x.total_voting_power())
    if hasattr(x, "type_name") and hasattr(x, "bytes"):
        return ("PubKey", x.type_name, x.bytes())
    return x


def outcome(fn):
    """fn()'s result as a package-free value, or its exception's class
    name and message."""
    try:
        return ("ok", plain(fn()))
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return (type(e).__name__, str(e))


def both(fn):
    """fn(pkg) for both packages; the outcomes must be equal."""
    got = {p.name: outcome(lambda p=p: fn(p)) for p in PKGS}
    assert got["jax"] == got["port"], got
    return got["port"]


def across(get_cls, jobj, tobj, enc="proto", dec="from_proto"):
    """The two packages' encodings of the same object are equal, and each
    decodes the other's to the same fields as it decodes its own (the
    object's own fields, for the proto encodings)."""
    jb, tb = getattr(jobj, enc)(), getattr(tobj, enc)()
    assert jb == tb
    j_from_t = getattr(get_cls(JAX), dec)(tb)
    t_from_j = getattr(get_cls(PORT), dec)(jb)
    j_own = getattr(get_cls(JAX), dec)(jb)
    assert plain(j_from_t) == plain(j_own) == plain(t_from_j)
    if enc == "proto":
        assert plain(j_own) == plain(jobj) == plain(tobj)
    assert getattr(j_from_t, enc)() == getattr(t_from_j, enc)()
    return t_from_j


# ---------------------------------------------------------------------------
# seeded inputs, built the same way in both packages
# ---------------------------------------------------------------------------

def seeds(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [bytes(r) for r in rng.integers(0, 256, (n, 32), dtype=np.uint8)]


def vals_and_privs(p, n: int, seed: int = 1, power=lambda i: 10):
    """A ValidatorSet of n ed25519 keys from a numpy seed, and the private
    keys in the set's order."""
    privs = [p.ed.PrivKey(s) for s in seeds(n, seed)]
    vs = p.validator_set.ValidatorSet(
        [p.validator.Validator.new(k.pub_key(), power(i))
         for i, k in enumerate(privs)])
    by_addr = {k.pub_key().address(): k for k in privs}
    return vs, [by_addr[v.address] for v in vs.validators]


def signed_commit(p, vs, privs, height, round_, bid, absent=(), nil=()):
    B = p.basic
    sigs = []
    for i, v in enumerate(vs.validators):
        if i in absent:
            sigs.append(p.commit.CommitSig.absent())
            continue
        voted = B.BlockID() if i in nil else bid
        ts = B.Timestamp(1700000000 + height, 1000 * i + 1)
        sb = p.canonical.canonical_vote_bytes(
            CHAIN, B.SignedMsgType.PRECOMMIT, height, round_, voted, ts)
        sigs.append(p.commit.CommitSig(
            B.BlockIDFlag.NIL if i in nil else B.BlockIDFlag.COMMIT,
            v.address, ts, privs[i].sign(sb)))
    return p.commit.Commit(height, round_, bid, sigs)


def header_for(p, vs, height, last_bid=None):
    B = p.basic
    return p.block.Header(
        version=p.block.Consensus(block=11, app=1), chain_id=CHAIN,
        height=height, time=B.Timestamp(1700000000 + height, 5),
        last_block_id=last_bid or B.BlockID(
            b"\x01" * 32, B.PartSetHeader(1, b"\x02" * 32)),
        validators_hash=vs.hash(), next_validators_hash=vs.hash(),
        consensus_hash=p.params.ConsensusParams().hash(),
        app_hash=b"\x42" * 8, last_results_hash=hashlib.sha256().digest(),
        proposer_address=vs.validators[0].address)


def light_block(p, n=4, height=5, seed=2):
    """A LightBlock whose commit signs its header, signed by every key."""
    vs, privs = vals_and_privs(p, n, seed)
    hdr = header_for(p, vs, height)
    hdr.data_hash = hashlib.sha256(b"data").digest()
    bid = p.basic.BlockID(hdr.hash(),
                          p.basic.PartSetHeader(1, b"\x03" * 32))
    commit = signed_commit(p, vs, privs, height, 0, bid)
    return p.light.LightBlock(p.light.SignedHeader(hdr, commit), vs), privs


def signed_vote(p, priv, vs, idx, bid, height=3, round_=0,
                vtype=None, ts=None):
    B = p.basic
    v = p.vote.Vote(
        type=vtype if vtype is not None else B.SignedMsgType.PRECOMMIT,
        height=height, round=round_, block_id=bid,
        timestamp=ts or B.Timestamp(1700000100 + idx, 77 * idx),
        validator_address=vs.validators[idx].address, validator_index=idx)
    v.signature = priv.sign(v.sign_bytes(CHAIN))
    return v


def dup_evidence(p, seed=3):
    vs, privs = vals_and_privs(p, 4, seed)
    B = p.basic
    va = signed_vote(p, privs[1], vs, 1,
                     B.BlockID(b"\xaa" * 32, B.PartSetHeader(1, b"\xab" * 32)))
    vb = signed_vote(p, privs[1], vs, 1,
                     B.BlockID(b"\xbb" * 32, B.PartSetHeader(1, b"\xbc" * 32)))
    return p.evidence.DuplicateVoteEvidence.from_votes(
        vb, va, B.Timestamp(1700000200, 9), vs), vs


def attack_evidence(p):
    lb, _ = light_block(p, n=3, height=6, seed=4)
    return p.evidence.LightClientAttackEvidence(
        conflicting_block=lb, common_height=4,
        byzantine_validators=[v.copy() for v in lb.validators.validators[:2]],
        total_voting_power=lb.validators.total_voting_power(),
        timestamp=p.basic.Timestamp(1700000300, 1))


def sample_block(p):
    """tests/test_wire.py's sample block, in package p."""
    B = p.basic
    commit = p.commit.Commit(
        height=6, round=1,
        block_id=B.BlockID(b"\x11" * 32, B.PartSetHeader(2, b"\x22" * 32)),
        signatures=[
            p.commit.CommitSig(B.BlockIDFlag.COMMIT, b"\x01" * 20,
                               B.Timestamp(1234567890, 999), b"\x55" * 64),
            p.commit.CommitSig.absent(),
            p.commit.CommitSig(B.BlockIDFlag.NIL, b"\x02" * 20,
                               B.Timestamp(1234567891, 1), b"\x66" * 64),
        ])
    block = p.block.Block(
        header=p.block.Header(
            version=p.block.Consensus(block=11, app=3),
            chain_id="test-chain", height=7,
            time=B.Timestamp(1700000000, 123456789),
            last_block_id=B.BlockID(b"\x11" * 32,
                                    B.PartSetHeader(2, b"\x22" * 32)),
            validators_hash=b"\x33" * 32,
            next_validators_hash=b"\x34" * 32,
            consensus_hash=b"\x35" * 32,
            app_hash=b"\x42" * 8,
            proposer_address=b"\x01" * 20,
        ),
        data=p.block.Data(txs=[b"tx-1", b"", b"tx-3" * 100]),
        last_commit=commit)
    block.fill_header()
    return block


def big_block(p, n_txs=300, tx_len=700, seed=5):
    """A block of seeded txs (several 64 KiB parts) carrying both kinds of
    evidence."""
    rng = np.random.default_rng(seed)
    txs = [bytes(rng.integers(0, 256, tx_len, dtype=np.uint8))
           for _ in range(n_txs)]
    block = sample_block(p)
    block.data = p.block.Data(txs=txs)
    block.evidence = [dup_evidence(p)[0], attack_evidence(p)]
    block.header.data_hash = b""
    block.header.evidence_hash = b""
    block.fill_header()
    return block


# ---------------------------------------------------------------------------
# tests/test_wire.py, through both packages
# ---------------------------------------------------------------------------

def test_block_proto_roundtrip(pkg):
    block = sample_block(pkg)
    data = block.proto()
    got = pkg.block.Block.from_proto(data)
    assert got.hash() == block.hash()
    assert got.proto() == data
    assert got.data.txs == block.data.txs
    assert got.last_commit.hash() == block.last_commit.hash()
    assert got.header == block.header


def test_vote_proto_roundtrip(pkg):
    B = pkg.basic
    vote = pkg.vote.Vote(
        type=B.SignedMsgType.PRECOMMIT, height=5, round=2,
        block_id=B.BlockID(b"\x0a" * 32, B.PartSetHeader(1, b"\x0b" * 32)),
        timestamp=B.Timestamp(1700000001, 42),
        validator_address=b"\x07" * 20, validator_index=3,
        signature=b"\x09" * 64)
    assert pkg.vote.Vote.from_proto(vote.proto()) == vote
    nil_vote = pkg.vote.Vote(
        type=B.SignedMsgType.PREVOTE, height=1, round=0,
        block_id=B.BlockID(), timestamp=B.Timestamp.now(),
        validator_address=b"\x01" * 20, validator_index=0,
        signature=b"\x01")
    assert pkg.vote.Vote.from_proto(nil_vote.proto()) == nil_vote


def test_proposal_proto_roundtrip_negative_polround(pkg):
    B = pkg.basic
    prop = pkg.proposal.Proposal(
        height=4, round=1, pol_round=-1,
        block_id=B.BlockID(b"\x01" * 32, B.PartSetHeader(1, b"\x02" * 32)),
        timestamp=B.Timestamp(1700000002, 7), signature=b"\x03" * 64)
    got = pkg.proposal.Proposal.from_proto(prop.proto())
    assert got == prop
    assert got.pol_round == -1


def test_partset_roundtrip_through_parts(pkg):
    block = sample_block(pkg)
    ps = pkg.part_set.PartSet.from_data(block.proto(), part_size=64)
    ps2 = pkg.part_set.PartSet(ps.header())
    for i in range(ps.header().total):
        decoded = pkg.part_set.Part.from_proto(ps.get_part(i).proto())
        assert ps2.add_part(decoded)
    assert pkg.block.Block.from_proto(ps2.assemble()).hash() == block.hash()


def test_garbage_bytes_raise_proto_error(pkg):
    for garbage in (b"\xff" * 40, b"\x00", b"\x0a\xff", b"\x08"):
        with pytest.raises(pkg.pd.ProtoError):
            pkg.pd.parse(garbage) and pkg.block.Block.from_proto(garbage)


def test_block_validate_basic_unconditional_binding(pkg):
    sample_block(pkg).validate_basic()
    evil = sample_block(pkg)
    evil.header.data_hash = b""
    evil.data = pkg.block.Data(txs=[b"arbitrary injected tx"])
    with pytest.raises(ValueError, match="DataHash"):
        evil.validate_basic()
    evil2 = sample_block(pkg)
    evil2.header.last_commit_hash = b""
    with pytest.raises(ValueError, match="LastCommitHash"):
        evil2.validate_basic()
    evil3 = sample_block(pkg)
    evil3.last_commit = None
    with pytest.raises(ValueError, match="LastCommit"):
        evil3.validate_basic()


# ---------------------------------------------------------------------------
# tests/test_types.py, through both packages
# ---------------------------------------------------------------------------

ZERO_TS_BYTES = bytes([0xb, 0x8, 0x80, 0x92, 0xb8, 0xc3, 0x98, 0xfe,
                       0xff, 0xff, 0xff, 0x1])
_PREFIX_11 = bytes([0x11, 0x1, 0, 0, 0, 0, 0, 0, 0,
                    0x19, 0x1, 0, 0, 0, 0, 0, 0, 0, 0x2a])


@pytest.mark.parametrize("case", [
    ("", "UNKNOWN", 0, 0, bytes([0xd, 0x2a]) + ZERO_TS_BYTES),
    ("", "PRECOMMIT", 1, 1,
     bytes([0x21, 0x8, 0x2]) + _PREFIX_11 + ZERO_TS_BYTES),
    ("", "PREVOTE", 1, 1,
     bytes([0x21, 0x8, 0x1]) + _PREFIX_11 + ZERO_TS_BYTES),
    ("", "UNKNOWN", 1, 1, bytes([0x1f]) + _PREFIX_11 + ZERO_TS_BYTES),
    ("test_chain_id", "UNKNOWN", 1, 1,
     bytes([0x2e]) + _PREFIX_11 + ZERO_TS_BYTES + bytes([0x32, 0xd])
     + b"test_chain_id"),
], ids=["vector_0", "precommit", "prevote", "no_type", "chain_id"])
def test_vote_sign_bytes_vectors(pkg, case):
    chain, vtype, h, r, want = case
    B = pkg.basic
    got = pkg.canonical.canonical_vote_bytes(
        chain, B.SignedMsgType[vtype], h, r, B.BlockID(), B.Timestamp.zero())
    assert got == want
    # the same bytes through a Vote of this slice
    v = pkg.vote.Vote(B.SignedMsgType[vtype], h, r, B.BlockID(),
                      B.Timestamp.zero(), b"\x01" * 20, 0)
    assert v.sign_bytes(chain) == want


def test_proposal_vs_vote_sign_bytes_differ(pkg):
    B, C = pkg.basic, pkg.canonical
    v = C.canonical_vote_bytes("", B.SignedMsgType.UNKNOWN, 1, 1, B.BlockID(),
                               B.Timestamp.zero())
    p = C.canonical_proposal_bytes("", 1, 1, 0, B.BlockID(),
                                   B.Timestamp.zero())
    assert v != p
    prop = pkg.proposal.Proposal(1, 1, 0, B.BlockID(), B.Timestamp.zero())
    assert prop.sign_bytes("") == p


def test_sign_bytes_with_block_id_roundtrip_sig(pkg):
    B = pkg.basic
    priv = pkg.ed.PrivKey(bytes(range(32)))
    bid = B.BlockID(hash=bytes(32), part_set_header=B.PartSetHeader(1,
                                                                   bytes(32)))
    sb = pkg.canonical.canonical_vote_bytes(
        "chain", B.SignedMsgType.PRECOMMIT, 5, 2, bid,
        B.Timestamp(1700000000, 123456789))
    sig = priv.sign(sb)
    assert priv.pub_key().verify_signature(sb, sig)


def test_merkle_empty_and_single(pkg):
    M = pkg.merkle
    assert M.hash_from_byte_slices([]) == hashlib.sha256(b"").digest()
    assert (M.hash_from_byte_slices([b"hello"])
            == hashlib.sha256(b"\x00hello").digest())


def test_merkle_inner_structure(pkg):
    l0 = hashlib.sha256(b"\x00a").digest()
    l1 = hashlib.sha256(b"\x00b").digest()
    l2 = hashlib.sha256(b"\x00c").digest()
    left = hashlib.sha256(b"\x01" + l0 + l1).digest()
    want = hashlib.sha256(b"\x01" + left + l2).digest()
    assert pkg.merkle.hash_from_byte_slices([b"a", b"b", b"c"]) == want


def test_merkle_proofs(pkg):
    items = [f"item{i}".encode() for i in range(11)]
    root, proofs = pkg.merkle.proofs_from_byte_slices(items)
    assert root == pkg.merkle.hash_from_byte_slices(items)
    for i, p in enumerate(proofs):
        assert p.verify(root, items[i]), i
        assert not p.verify(root, items[(i + 1) % len(items)])


def _mkvals(p, n, power=lambda i: 10):
    out = []
    for i in range(n):
        priv = p.ed.PrivKey(i.to_bytes(32, "big"))
        out.append((priv, p.validator.Validator.new(priv.pub_key(),
                                                    power(i))))
    return out


def test_valset_sorted_and_total_power(pkg):
    pairs = _mkvals(pkg, 7, power=lambda i: (i + 1) * 5)
    vs = pkg.validator_set.ValidatorSet([v for _, v in pairs])
    assert vs.total_voting_power() == sum((i + 1) * 5 for i in range(7))
    powers = [v.voting_power for v in vs.validators]
    assert powers == sorted(powers, reverse=True)


def test_proposer_rotation_weighted(pkg):
    pairs = _mkvals(pkg, 3, power=lambda i: [1, 2, 3][i])
    vs = pkg.validator_set.ValidatorSet([v for _, v in pairs])
    counts = {}
    for _ in range(60):
        prop = vs.get_proposer()
        counts[prop.address] = counts.get(prop.address, 0) + 1
        vs.increment_proposer_priority(1)
    assert sorted(counts.values()) == [10, 20, 30], counts


def test_valset_update_and_remove(pkg):
    pairs = _mkvals(pkg, 4, power=lambda i: 10)
    vs = pkg.validator_set.ValidatorSet([v for _, v in pairs])
    target = pairs[0][1]
    vs.update_with_change_set(
        [pkg.validator.Validator.new(pairs[0][0].pub_key(), 100)])
    assert vs.total_voting_power() == 130
    vs.update_with_change_set(
        [pkg.validator.Validator.new(pairs[0][0].pub_key(), 0)])
    assert vs.total_voting_power() == 30
    assert not vs.has_address(target.address)


def test_valset_hash_changes_with_membership(pkg):
    pairs = _mkvals(pkg, 4)
    vs = pkg.validator_set.ValidatorSet([v for _, v in pairs])
    h1 = vs.hash()
    vs.update_with_change_set([pkg.validator.Validator.new(
        pairs[0][0].pub_key(), 99)])
    assert vs.hash() != h1


def _make_commit(p, pairs, height=3, round_=0, absent=(), nil=(), bad=()):
    B = p.basic
    bid = B.BlockID(hash=bytes([7] * 32),
                    part_set_header=B.PartSetHeader(1, bytes([8] * 32)))
    vs = p.validator_set.ValidatorSet([v for _, v in pairs])
    by_addr = {v.address: priv for priv, v in pairs}
    sigs = []
    for idx, val in enumerate(vs.validators):
        if idx in absent:
            sigs.append(p.commit.CommitSig.absent())
            continue
        flag = B.BlockIDFlag.NIL if idx in nil else B.BlockIDFlag.COMMIT
        voted = B.BlockID() if idx in nil else bid
        ts = B.Timestamp(1700000000 + idx, idx)
        sb = p.canonical.canonical_vote_bytes(
            CHAIN, B.SignedMsgType.PRECOMMIT, height, round_, voted, ts)
        sig = by_addr[val.address].sign(sb)
        if idx in bad:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        sigs.append(p.commit.CommitSig(flag, val.address, ts, sig))
    return vs, bid, p.commit.Commit(height, round_, bid, sigs)


def test_verify_commit_all_good(pkg):
    vs, bid, commit = _make_commit(pkg, _mkvals(pkg, 6))
    vs.verify_commit(CHAIN, bid, 3, commit)
    vs.verify_commit_light(CHAIN, bid, 3, commit)
    vs.verify_commit_light_trusting(CHAIN, commit, Fraction(1, 3))


def test_verify_commit_with_absent_and_nil(pkg):
    vs, bid, commit = _make_commit(pkg, _mkvals(pkg, 7), absent={2}, nil={4})
    vs.verify_commit(CHAIN, bid, 3, commit)


def test_verify_commit_bad_sig_identified(pkg):
    vs, bid, commit = _make_commit(pkg, _mkvals(pkg, 6), bad={3})
    with pytest.raises(pkg.validator_set.CommitVerifyError,
                       match=r"wrong signature \(#3\)"):
        vs.verify_commit(CHAIN, bid, 3, commit)


def test_verify_commit_insufficient_power(pkg):
    vs, bid, commit = _make_commit(pkg, _mkvals(pkg, 6), absent={0, 1, 2, 3})
    with pytest.raises(pkg.validator_set.NotEnoughVotingPowerError):
        vs.verify_commit(CHAIN, bid, 3, commit)


def test_verify_commit_light_ignores_bad_sig_after_twothirds(pkg):
    vs, bid, commit = _make_commit(pkg, _mkvals(pkg, 6), bad={5})
    with pytest.raises(pkg.validator_set.CommitVerifyError):
        vs.verify_commit(CHAIN, bid, 3, commit)
    vs.verify_commit_light(CHAIN, bid, 3, commit)


def test_verify_commit_wrong_height_and_blockid(pkg):
    vs, bid, commit = _make_commit(pkg, _mkvals(pkg, 4))
    with pytest.raises(pkg.validator_set.CommitVerifyError,
                       match="wrong height"):
        vs.verify_commit(CHAIN, bid, 4, commit)
    other = pkg.basic.BlockID(
        hash=bytes([9] * 32),
        part_set_header=pkg.basic.PartSetHeader(1, bytes([8] * 32)))
    with pytest.raises(pkg.validator_set.CommitVerifyError,
                       match="wrong block ID"):
        vs.verify_commit(CHAIN, other, 3, commit)


def test_light_trusting_different_valset(pkg):
    pairs = _mkvals(pkg, 6)
    vs, bid, commit = _make_commit(pkg, pairs)
    sub = pkg.validator_set.ValidatorSet([v for _, v in pairs[:4]])
    sub.verify_commit_light_trusting(CHAIN, commit, Fraction(1, 3))


def test_commit_hash_covers_signatures(pkg):
    pairs = _mkvals(pkg, 4)
    _, _, c1 = _make_commit(pkg, pairs)
    _, _, c2 = _make_commit(pkg, pairs, nil={1})
    assert c1.hash() != c2.hash()
    assert len(c1.hash()) == 32


def test_commit_sign_bytes_batch_byte_exact(pkg, monkeypatch):
    vs, bid, commit = _make_commit(pkg, _mkvals(pkg, 9), nil={1, 5})
    commit.signatures[2].__dict__["timestamp"] = pkg.basic.Timestamp(
        1700000000, 0)
    commit.signatures[5].__dict__["timestamp"] = pkg.basic.Timestamp.zero()
    idxs = list(range(len(commit.signatures)))
    want = [commit.vote_sign_bytes(CHAIN, i) for i in idxs]
    batch = pkg.canonical.commit_sign_bytes_batch
    got = batch(CHAIN, commit, idxs)
    assert [got[i] for i in idxs] == want
    if pkg.native.get_lib() is not None:
        monkeypatch.setattr(pkg.native, "vote_sign_bytes",
                            lambda *a, **k: None)
        fb = batch(CHAIN, commit, idxs)
        assert [fb[i] for i in idxs] == want
        monkeypatch.undo()
    sub = batch(CHAIN, commit, [7, 0, 7])
    assert [sub[0], sub[1], sub[2]] == [want[7], want[0], want[7]]


# ---------------------------------------------------------------------------
# the slice's modules across the packages
# ---------------------------------------------------------------------------

def _random_bits(p, n, rng):
    return p.bits.BitArray.from_indices(
        n, [i for i in range(n) if rng.random() < 0.4])


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 65, 130])
def test_bits_across(n):
    """Seeded bit arrays: the proto encoding carried both ways, and every
    operation's result the same in both packages."""
    def run(p):
        rng = np.random.default_rng(n)
        x, y = _random_bits(p, n, rng), _random_bits(p, n + 3, rng)
        return [x, x.or_(y), x.and_(y), x.not_(), x.sub(y), y.sub(x),
                x.is_empty(), x.is_full(), x.not_().is_full(),
                x.get_true_indices(), x.num_true_bits(), str(x),
                x.to_bytes(), p.bits.BitArray.from_bytes(n, x.to_bytes()),
                x.pick_random(random.Random(7)), x.get_index(n),
                x.set_index(-1, True)]
    got = both(run)[1]
    ja = _random_bits(JAX, n, np.random.default_rng(n))
    ta = _random_bits(PORT, n, np.random.default_rng(n))
    assert across(lambda p: p.bits.BitArray, ja, ta) == ta
    assert plain(ta) == got[0]
    # a peer's oversized or negative size is refused with the same error
    for bad in (-1, (1 << 24) + 1):
        assert both(lambda p, bad=bad: p.bits.BitArray.from_proto(
            p.pe.varint_field(1, bad)))[0] == "ProtoError"


def test_params_across():
    def variants(p):
        P = p.params
        out = [P.ConsensusParams()]
        for blk, ev, val in (((0, -1), 1, ["ed25519"]),
                             ((P.MAX_BLOCK_SIZE_BYTES + 1, -1), 1,
                              ["ed25519"]),
                             ((1024, -2), 1, ["ed25519"]),
                             ((1024, 10), 0, ["ed25519"]),
                             ((1024, 10), 5, []),
                             ((4096, 100), 7, ["ed25519", "sr25519"])):
            cp = P.ConsensusParams()
            cp.block = P.BlockParams(max_bytes=blk[0], max_gas=blk[1])
            cp.evidence = P.EvidenceParams(max_age_num_blocks=ev)
            cp.validator = P.ValidatorParams(pub_key_types=list(val))
            out.append(cp)
        return out

    def run(p):
        res = []
        for cp in variants(p):
            res.append((cp.hash(), outcome(cp.validate_basic)))
            for upd in (None, p.abci.ConsensusParamsUpdate(),
                        p.abci.ConsensusParamsUpdate(block_max_bytes=77,
                                                     block_max_gas=5)):
                res.append(plain(cp.update(upd)))
        return res
    assert both(run)[0] == "ok"


def _vote_variants(p, rng):
    B = p.basic
    out = []
    for i in range(12):
        bid = (B.BlockID() if i % 4 == 0 else
               B.BlockID(bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
                         B.PartSetHeader(int(rng.integers(1, 9)),
                                         bytes(rng.integers(
                                             0, 256, 32, dtype=np.uint8)))))
        out.append(p.vote.Vote(
            type=B.SignedMsgType.PREVOTE if i % 2 else
            B.SignedMsgType.PRECOMMIT,
            height=int(rng.integers(0, 1 << 40)), round=int(rng.integers(0,
                                                                      9)),
            block_id=bid,
            timestamp=B.Timestamp(int(rng.integers(-1 << 30, 1 << 33)),
                                  int(rng.integers(0, 10 ** 9))),
            validator_address=bytes(rng.integers(0, 256, 20 + (i == 5),
                                                 dtype=np.uint8)),
            validator_index=int(rng.integers(-1 if i == 7 else 0, 1000)),
            signature=bytes(rng.integers(0, 256, [64, 0, 65, 64][i % 4],
                                         dtype=np.uint8))))
    return out


def test_vote_across():
    jv = _vote_variants(JAX, np.random.default_rng(11))
    tv = _vote_variants(PORT, np.random.default_rng(11))
    for a, b in zip(jv, tv):
        across(lambda p: p.vote.Vote, a, b)
        assert a.sign_bytes(CHAIN) == b.sign_bytes(CHAIN)
        assert outcome(a.validate_basic) == outcome(b.validate_basic)
        assert plain(a.commit_sig()) == plain(b.commit_sig())
        assert a.is_nil() == b.is_nil()
    # a bad type is refused with the same error
    both(lambda p: p.vote.Vote.from_proto(bytes([0x08, 0x07])))


def test_vote_verify_reads_the_verified_cache(monkeypatch):
    """Vote.verify is a cache lookup when the triple is in verified_sigs,
    and a host check otherwise, in both packages."""
    def run(p):
        vs, privs = vals_and_privs(p, 2, 6)
        v = signed_vote(p, privs[0], vs, 0, p.basic.BlockID())
        pub = vs.validators[0].pub_key
        calls = []
        real = type(pub).verify_signature
        monkeypatch.setattr(type(pub), "verify_signature",
                            lambda s, m, g: calls.append(1) or real(s, m, g))
        monkeypatch.setattr(p.batch, "verified_sigs", p.batch.SigCache())
        first = v.verify(CHAIN, pub)
        p.batch.verified_sigs.add(pub.bytes(), v.sign_bytes(CHAIN),
                                  v.signature)
        second = v.verify(CHAIN, pub)
        bad = signed_vote(p, privs[1], vs, 0, p.basic.BlockID())
        return first, second, bad.verify(CHAIN, pub), len(calls)
    assert both(run) == ("ok", [True, True, False, 2])


def test_proposal_across():
    def props(p):
        B = p.basic
        rng = np.random.default_rng(12)
        out = []
        for i in range(8):
            out.append(p.proposal.Proposal(
                height=int(rng.integers(0, 1 << 40)), round=i,
                pol_round=[-1, 0, i - 1, -2, i, 3, -1, 0][i],
                block_id=B.BlockID() if i == 4 else B.BlockID(
                    bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
                    B.PartSetHeader(2, bytes(rng.integers(
                        0, 256, 32, dtype=np.uint8)))),
                timestamp=B.Timestamp(1700000000 + i, i),
                signature=b"\x05" * [64, 64, 0, 64, 64, 65, 64, 64][i]))
        return out
    for a, b in zip(props(JAX), props(PORT)):
        across(lambda p: p.proposal.Proposal, a, b)
        assert a.sign_bytes(CHAIN) == b.sign_bytes(CHAIN)
        assert outcome(a.validate_basic) == outcome(b.validate_basic)
    both(lambda p: p.proposal.Proposal.from_proto(
        p.vote.Vote(p.basic.SignedMsgType.PREVOTE, 1, 0, p.basic.BlockID(),
                    p.basic.Timestamp.zero(), b"", 0).proto()))


@pytest.mark.parametrize("size,part_size", [
    (0, 65536), (1, 65536), (65536, 65536), (65537, 65536),
    (200_000, 65536), (1000, 64)])
def test_part_set_across(size, part_size):
    data = bytes(np.random.default_rng(size).integers(0, 256, size,
                                                      dtype=np.uint8))
    sets = {p.name: p.part_set.PartSet.from_data(data, part_size)
            for p in PKGS}
    streams = {p.name: p.part_set.PartSet.from_data_streaming(
        [data[:size // 3], data[size // 3:]], part_size) for p in PKGS}
    hdr = plain(sets["jax"].header())
    assert hdr == plain(sets["port"].header()) == \
        plain(streams["jax"].header()) == plain(streams["port"].header())
    total = sets["port"].header().total
    for i in range(total):
        parts = [s.get_part(i) for s in (*sets.values(), *streams.values())]
        assert len({pt.proto() for pt in parts}) == 1
        assert len({json.dumps(plain(pt), default=bytes.hex)
                    for pt in parts}) == 1
    # each package reassembles the other's parts, as a peer does
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        ps = dst.part_set.PartSet(dst.part_set.PartSet.from_data(
            data, part_size).header())
        for i in range(total):
            wire = sets[src.name].get_part(i).proto()
            assert ps.add_part(dst.part_set.Part.from_proto(wire))
            assert not ps.add_part(dst.part_set.Part.from_proto(wire))
        assert ps.is_complete() and ps.assemble() == data
        assert plain(ps.bit_array()) == plain(sets[src.name].bit_array())
    # a part that does not belong is refused with the same error
    for bad in ("index", "proof", "total"):
        def run(p, bad=bad):
            ps = p.part_set.PartSet.from_data(data, part_size)
            dst = p.part_set.PartSet(ps.header())
            part = ps.get_part(0)
            if bad == "index":
                part = p.part_set.Part(total, part.bytes_, part.proof)
            elif bad == "proof":
                part = p.part_set.Part(0, part.bytes_ + b"x", part.proof)
            else:
                part.proof.total += 1
            return dst.add_part(part)
        both(run)


def test_block_across():
    jb, tb = big_block(JAX), big_block(PORT)
    t = across(lambda p: p.block.Block, jb, tb)
    assert jb.hash() == tb.hash() == t.hash()
    assert b"".join(jb.proto_regions()) == b"".join(tb.proto_regions()) \
        == tb.proto()
    assert outcome(jb.validate_basic) == outcome(tb.validate_basic)
    assert JAX.block.tx_hash(b"tx") == PORT.block.tx_hash(b"tx")
    mj = JAX.part_set.make_block_parts(jb)
    mt = PORT.part_set.make_block_parts(tb)
    assert type(mj).__name__ == type(mt).__name__ == "StreamingPartSet"
    assert plain(mj.header()) == plain(mt.header())
    assert mj.header().total > 2
    assert all(a.proto() == b.proto()
               for a, b in zip(mj.iter_parts(), mt.iter_parts()))
    assert plain(mt.part_set().header()) == plain(mt.header())
    meta = lambda p, b, ps: p.block.BlockMeta(  # noqa: E731
        p.basic.BlockID(b.hash(), ps.header()), len(b.proto()), b.header,
        len(b.data.txs))
    assert plain(meta(JAX, jb, mj)) == plain(meta(PORT, tb, mt))
    # header decode across, and a header with no validators has no hash
    across(lambda p: p.block.Header, jb.header, tb.header)
    both(lambda p: p.block.Header().hash())
    # evidence the peer cannot decode is a ProtoError in both
    both(lambda p: p.block.Block.from_proto(
        sample_block(p).proto() + bytes([0x1a, 0x03, 0x0a, 0x01, 0x00])))


@pytest.mark.parametrize("edit", [
    None, "chain_id", "height", "hash", "vals_hash", "no_commit",
    "header_field", "empty_vals"])
def test_light_block_across(edit):
    def run(p):
        lb, _ = light_block(p)
        sh = lb.signed_header
        if edit == "chain_id":
            sh.header.chain_id = "other"
        elif edit == "height":
            sh.commit.height += 1
        elif edit == "hash":
            sh.header.app_hash = b"\x43" * 8
        elif edit == "vals_hash":
            lb.validators = vals_and_privs(p, 3, 9)[0]
        elif edit == "no_commit":
            sh.commit = None
        elif edit == "header_field":
            sh.header.data_hash = b"\x01" * 5
        elif edit == "empty_vals":
            lb.validators = p.validator_set.ValidatorSet()
        return (outcome(lambda: lb.validate_basic(CHAIN)),
                outcome(lambda: sh.validate_basic(CHAIN)), lb.height,
                plain(lb.time), outcome(lb.hash))
    both(run)
    if edit is None:
        lj, lt = light_block(JAX)[0], light_block(PORT)[0]
        across(lambda p: p.light.LightBlock, lj, lt)
        across(lambda p: p.light.SignedHeader, lj.signed_header,
               lt.signed_header)
        both(lambda p: p.light.LightBlock.from_proto(b""))


def test_evidence_across():
    dj, dt = dup_evidence(JAX)[0], dup_evidence(PORT)[0]
    aj_, at = attack_evidence(JAX), attack_evidence(PORT)
    for a, b in ((dj, dt), (aj_, at)):
        across(lambda p: types.SimpleNamespace(
            from_proto=p.evidence.evidence_from_proto), a, b)
        assert a.hash() == b.hash() and a.bytes() == b.bytes()
        assert plain(a.abci()) == plain(b.abci())
        assert (a.height(), plain(a.time())) == (b.height(), plain(b.time()))
        assert outcome(a.validate_basic) == outcome(b.validate_basic)
    assert JAX.evidence.evidence_list_hash([dj, aj_]) == \
        PORT.evidence.evidence_list_hash([dt, at])
    hdr_j = light_block(JAX, seed=8)[0].signed_header.header
    hdr_t = light_block(PORT, seed=8)[0].signed_header.header
    assert aj_.conflicting_header_is_invalid(hdr_j) == \
        at.conflicting_header_is_invalid(hdr_t) is True
    assert at.conflicting_header_is_invalid(
        at.conflicting_block.signed_header.header) is False


@pytest.mark.parametrize("edit", [
    "order", "no_sig", "bad_vote", "missing_set", "unknown_validator",
    "lca_power", "lca_height", "lca_above", "lca_unsigned", "lca_vals",
    "unknown_kind"])
def test_evidence_errors_across(edit):
    def run(p):
        E, B = p.evidence, p.basic
        ev, vs = dup_evidence(p)
        lca = attack_evidence(p)
        if edit == "order":
            ev.vote_a, ev.vote_b = ev.vote_b, ev.vote_a
            return ev.validate_basic()
        if edit == "no_sig":
            ev.vote_b.signature = b""
            return ev.validate_basic()
        if edit == "bad_vote":
            ev.vote_a.round = -1
            return ev.validate_basic()
        if edit == "missing_set":
            return E.DuplicateVoteEvidence.from_votes(ev.vote_a, ev.vote_b,
                                                      B.Timestamp.zero(),
                                                      None)
        if edit == "unknown_validator":
            other = vals_and_privs(p, 2, 10)[0]
            return E.DuplicateVoteEvidence.from_votes(ev.vote_a, ev.vote_b,
                                                      B.Timestamp.zero(),
                                                      other)
        if edit == "lca_power":
            lca.total_voting_power = 0
        elif edit == "lca_height":
            lca.common_height = 0
        elif edit == "lca_above":
            lca.common_height = 99
        elif edit == "lca_unsigned":
            lca.conflicting_block.signed_header.header.app_hash = b"\x01"
        elif edit == "lca_vals":
            lca.conflicting_block.validators = vals_and_privs(p, 2, 10)[0]
        elif edit == "unknown_kind":
            return E.evidence_proto(E.Evidence())
        return lca.validate_basic()
    got = both(run)
    assert got[0] != "ok" or edit is None


@pytest.mark.parametrize("edit", [None, "no_chain", "long_chain",
                                  "neg_height", "zero_power", "bad_address",
                                  "params", "zero_height"])
def test_genesis_across(edit, tmp_path):
    def run(p):
        doc = genesis_doc(p, 5)
        if edit == "no_chain":
            doc.chain_id = ""
        elif edit == "long_chain":
            doc.chain_id = "c" * 51
        elif edit == "neg_height":
            doc.initial_height = -1
        elif edit == "zero_power":
            doc.validators[2].power = 0
        elif edit == "bad_address":
            doc.validators[1].address = b"\x01" * 20
        elif edit == "params":
            doc.consensus_params.block.max_bytes = 0
        elif edit == "zero_height":
            doc.initial_height = 0
        doc.validate_and_complete()
        return doc.to_json(), doc.initial_height
    got = both(run)
    if edit is not None:
        return
    jd, td = genesis_doc(JAX, 5), genesis_doc(PORT, 5)
    t = across(lambda p: p.genesis.GenesisDoc, jd, td, enc="to_json",
               dec="from_json")
    assert t.validator_set().hash() == jd.validator_set().hash()
    assert plain(t.validator_set()) == plain(jd.validator_set())
    path = tmp_path / "config" / "genesis.json"
    jd.save_as(str(path))
    assert plain(PORT.genesis.GenesisDoc.from_file(str(path))) == \
        plain(JAX.genesis.GenesisDoc.from_file(str(path)))
    assert got[1][0] == td.to_json()


def genesis_doc(p, n, seed=13, chain=CHAIN):
    """A GenesisDoc of n seeded ed25519 validators (powers 10, 11, ...)."""
    G, B = p.genesis, p.basic
    privs = [p.ed.PrivKey(s) for s in seeds(n, seed)]
    doc = G.GenesisDoc(
        chain_id=chain, genesis_time=B.Timestamp(1700000000, 250000000),
        validators=[G.GenesisValidator(
            address=b"", pub_key_type="ed25519",
            pub_key_bytes=k.pub_key().bytes(), power=10 + i, name=f"v{i}")
            for i, k in enumerate(privs)],
        app_hash=b"\x0a" * 4, app_state=b'{"k": 1}')
    doc.validate_and_complete()
    return doc


def test_propose_parts_raise_gives_serial_identical_parts(pkg):
    """propose.parts=raise: make_block_parts degrades to the serial
    PartSet.from_data with byte-identical parts."""
    block = big_block(pkg)
    streamed = pkg.part_set.make_block_parts(block)
    assert isinstance(streamed, pkg.part_set.StreamingPartSet)
    pkg.fail.set_mode("propose.parts", "raise")
    serial = pkg.part_set.make_block_parts(block)
    assert pkg.fail.fired("propose.parts", "raise") >= 1
    assert isinstance(serial, pkg.part_set.PartSet) and serial.is_complete()
    assert serial.header() == streamed.header()
    for a, b in zip(serial.iter_parts(), streamed.iter_parts()):
        assert a.bytes_ == b.bytes_ and a.proof.aunts == b.proof.aunts
    assert serial.assemble() == streamed.assemble() == block.proto()


def test_propose_parts_raise_same_in_both():
    out = {}
    for p in PKGS:
        p.fail.set_mode("propose.parts", "raise")
        ps = p.part_set.make_block_parts(big_block(p))
        out[p.name] = (type(ps).__name__, [pt.proto()
                                           for pt in ps.iter_parts()])
        p.fail.reset()
    assert out["jax"] == out["port"]
    assert out["port"][0] == "PartSet"
