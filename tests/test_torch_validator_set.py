"""A JAX-package ValidatorSet and Commit carried into the port as arrays
(tendermint_tpu_torch/convert.py): identical sign bytes, and
verify_commit / verify_commit_light / verify_commit_light_trusting pass,
or raise the same error naming the same index, on both sides."""
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519 as jkeys
from tendermint_tpu.types import canonical as jcan
from tendermint_tpu.types.basic import (BlockID, BlockIDFlag, PartSetHeader,
                                        Timestamp)
from tendermint_tpu.types.commit import Commit, CommitSig
from tendermint_tpu.types.validator import Validator
from tendermint_tpu.types.validator_set import ValidatorSet

import tendermint_tpu_torch as T
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import canonical as tcan

CHAIN = "port-chain"
N = 64
ABSENT = (5, 30)
NIL = (8, 50)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is thousands of small tensor ops: with one intra-op
    thread per test process they do not contend with parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    T.set_default_device("cpu")
    yield
    T.set_default_device("cuda")


@pytest.fixture(scope="module")
def jax_state():
    privs = [jkeys.PrivKey((0xC000 + i).to_bytes(32, "big"))
             for i in range(N)]
    vset = ValidatorSet([Validator.new(p.pub_key(), 10 + (i % 3))
                         for i, p in enumerate(privs)])
    bid = BlockID(b"\x31" * 32, PartSetHeader(2, b"\x32" * 32))
    by_addr = {p.pub_key().address(): p for p in privs}
    sigs = []
    for i, v in enumerate(vset.validators):
        if i in ABSENT:
            sigs.append(CommitSig.absent())
            continue
        flag = BlockIDFlag.NIL if i in NIL else BlockIDFlag.COMMIT
        sigs.append(CommitSig(block_id_flag=flag, validator_address=v.address,
                              timestamp=Timestamp(1700000000 + i,
                                                  (i * 7919) % 10**9)))
    commit = Commit(height=12, round=1, block_id=bid, signatures=sigs)
    for i, v in enumerate(vset.validators):
        if i not in ABSENT:
            sigs[i].signature = by_addr[v.address].sign(
                commit.vote_sign_bytes(CHAIN, i))
    return vset, commit


def _export(vset, commit):
    vals = vset.validators
    pub = np.frombuffer(b"".join(v.pub_key.bytes() for v in vals),
                        np.uint8).reshape(-1, 32)
    powers = np.array([v.voting_power for v in vals], np.int64)
    prios = np.array([v.proposer_priority for v in vals], np.int64)
    n = len(commit.signatures)
    flags = np.array([int(s.block_id_flag) for s in commit.signatures],
                     np.uint8)
    addrs = np.zeros((n, 20), np.uint8)
    ts = np.zeros((n, 2), np.int64)
    sg = np.zeros((n, 64), np.uint8)
    for i, s in enumerate(commit.signatures):
        if not s.is_absent():
            addrs[i] = np.frombuffer(s.validator_address, np.uint8)
            sg[i] = np.frombuffer(s.signature, np.uint8)
        ts[i] = (s.timestamp.seconds, s.timestamp.nanos)
    bid = commit.block_id
    t_vset = convert.validator_set_from_arrays(pub, powers, prios)
    t_commit = convert.commit_from_arrays(
        commit.height, commit.round, bid.hash, bid.part_set_header.total,
        bid.part_set_header.hash, flags, addrs, ts, sg)
    return t_vset, t_commit


def _tbid(commit):
    psh = commit.block_id.part_set_header
    return tbasic.BlockID(commit.block_id.hash,
                          tbasic.PartSetHeader(psh.total, psh.hash))


def _outcome(fn, force_batch=False):
    """fn's exception as (type name, message), or None.  force_batch: run
    it with TM_TPU_FORCE_BATCH=1, so that the port's batches of at least
    32 signatures take its device lane (on device="cpu" the kernels'
    plain versions) instead of the host lanes a CPU device selects."""
    saved = os.environ.get("TM_TPU_FORCE_BATCH")
    if force_batch:
        os.environ["TM_TPU_FORCE_BATCH"] = "1"
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)
    finally:
        if saved is None:
            os.environ.pop("TM_TPU_FORCE_BATCH", None)
        else:
            os.environ["TM_TPU_FORCE_BATCH"] = saved
    return None


def _all_outcomes(j_vset, j_commit, t_vset, t_commit):
    jb, tb = j_commit.block_id, _tbid(t_commit)
    h = j_commit.height
    return [
        (_outcome(lambda: j_vset.verify_commit(CHAIN, jb, h, j_commit)),
         _outcome(lambda: t_vset.verify_commit(CHAIN, tb, h, t_commit),
                  True)),
        (_outcome(lambda: j_vset.verify_commit_light(CHAIN, jb, h,
                                                     j_commit)),
         _outcome(lambda: t_vset.verify_commit_light(CHAIN, tb, h,
                                                     t_commit), True)),
        (_outcome(lambda: j_vset.verify_commit_light_trusting(
            CHAIN, j_commit, Fraction(1, 3))),
         _outcome(lambda: t_vset.verify_commit_light_trusting(
             CHAIN, t_commit, Fraction(1, 3)), True)),
    ]


def test_state_carried_across(jax_state):
    j_vset, j_commit = jax_state
    t_vset, t_commit = _export(j_vset, j_commit)
    assert t_vset.hash() == j_vset.hash()
    assert t_commit.hash() == j_commit.hash()
    assert t_vset.total_voting_power() == j_vset.total_voting_power()
    assert [(v.address, v.proposer_priority) for v in t_vset.validators] \
        == [(v.address, v.proposer_priority) for v in j_vset.validators]
    idx = [i for i in range(N) if i not in ABSENT]
    jm = jcan.commit_sign_bytes_batch(CHAIN, j_commit, idx)
    tm = tcan.commit_sign_bytes_batch(CHAIN, t_commit, idx)
    np.testing.assert_array_equal(jm.offsets, tm.offsets)
    np.testing.assert_array_equal(jm.buf[:int(jm.offsets[-1])],
                                  tm.buf[:int(tm.offsets[-1])])
    assert tm[3] == t_commit.vote_sign_bytes(CHAIN, 3)


@pytest.mark.parametrize("bad", [None, 10, 60], ids=["valid", "early",
                                                      "late"])
def test_verify_commit_outcomes(jax_state, bad):
    """A bad signature before the light prefix fails all three checks;
    one after it fails only the check-all verify_commit."""
    j_vset, j_commit = jax_state
    orig = j_commit.signatures[bad].signature if bad is not None else None
    if bad is not None:
        j_commit.signatures[bad].signature = bytes(64)
    try:
        t_vset, t_commit = _export(j_vset, j_commit)
        outcomes = _all_outcomes(j_vset, j_commit, t_vset, t_commit)
    finally:
        if bad is not None:
            j_commit.signatures[bad].signature = orig
    for want, got in outcomes:
        assert want == got
    if bad is None:
        assert outcomes == [(None, None)] * 3
    else:
        assert outcomes[0][1][0] == "CommitVerifyError"
        assert f"(#{bad})" in outcomes[0][1][1]
        assert (outcomes[1][1] is None) == (bad == 60)


def test_not_enough_power(jax_state):
    j_vset, j_commit = jax_state
    saved = list(j_commit.signatures)
    j_commit.signatures[:] = [CommitSig.absent() if i < 30 else s
                              for i, s in enumerate(saved)]
    try:
        t_vset, t_commit = _export(j_vset, j_commit)
        outcomes = _all_outcomes(j_vset, j_commit, t_vset, t_commit)
    finally:
        j_commit.signatures[:] = saved
    for want, got in outcomes[:2]:
        assert want == got and want[0] == "NotEnoughVotingPowerError"
    assert outcomes[2][0] == outcomes[2][1]


@pytest.mark.parametrize("bad", [None, "ed25519", "secp256k1", "sr25519"])
def test_mixed_key_set_verify_commit(bad):
    """A validator set holding ed25519, secp256k1 and sr25519 keys: the
    keys round-trip through the PublicKey oneof, the set hashes alike,
    and verify_commit passes, or names the same bad index, in both
    packages (its list branch: the set is not all ed25519)."""
    from importlib import import_module
    out = {}
    for root in ("tendermint_tpu", "tendermint_tpu_torch"):
        def m(name):
            return import_module(f"{root}.{name}")
        pubs, signers = [], {}
        for j in range(6):
            scheme = ("ed25519", "secp256k1", "sr25519")[j % 3]
            seed = bytes([0x60 + j]) * 32
            keys = m(f"crypto.{scheme}")
            priv = (keys.PrivKey.gen_from_secret(seed)
                    if scheme == "secp256k1" else keys.PrivKey(seed))
            pub = priv.pub_key()
            proto = m("types.validator").pubkey_proto(pub)
            assert m("types.validator").pubkey_from_proto(proto) == pub
            pubs.append(pub)
            signers[pub.bytes()] = priv.sign
        vset = m("types.validator_set").ValidatorSet(
            [m("types.validator").Validator.new(p, 10) for p in pubs])
        b = m("types.basic")
        bid = b.BlockID(b"\x41" * 32, b.PartSetHeader(1, b"\x42" * 32))
        cm = m("types.commit")
        sigs = [cm.CommitSig(block_id_flag=b.BlockIDFlag.COMMIT,
                             validator_address=v.address,
                             timestamp=b.Timestamp(1700000900, 17 * i))
                for i, v in enumerate(vset.validators)]
        commit = cm.Commit(height=9, round=0, block_id=bid, signatures=sigs)
        msgs = m("types.canonical").commit_sign_bytes_batch(
            CHAIN, commit, list(range(6)))
        todo = bad   # the first signature of that scheme goes bad
        for i, v in enumerate(vset.validators):
            sigs[i].signature = signers[v.pub_key.bytes()](bytes(msgs[i]))
            if v.pub_key.type_name == todo:
                s = sigs[i].signature
                sigs[i].signature = bytes([s[0] ^ 1]) + s[1:]
                todo = None
        try:
            vset.verify_commit(CHAIN, bid, 9, commit)
            res = None
        except Exception as e:  # noqa: BLE001 - compared below
            res = (type(e).__name__, str(e))
        out[root] = (vset.hash(), res,
                     [v.pub_key.type_name for v in vset.validators])
    assert out["tendermint_tpu"] == out["tendermint_tpu_torch"]
    assert (out["tendermint_tpu"][1] is None) == (bad is None)
