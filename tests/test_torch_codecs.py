"""The port's codecs and host services against the JAX package's, on the
CPU: the restricted pickle codec (libs/safe_codec.py), the Amino JSON
dialect (libs/amino_json.py), the structured log (libs/log.py) and the
event bus (types/event_bus.py).

The cases of tests/test_wire.py (the pickle payload), cases 1-5 of
tests/test_amino_json.py and the five cases of tests/test_log.py run
through both packages.  Both packages log under the same `logging` root
("tm"), and each one's setup() removes the other's handler, so every
half sets up its own package just before it logs.
"""
from __future__ import annotations

import base64
import io
import json
import os
import pickle
import re
import subprocess
import sys
import threading

import pytest

from test_torch_types import (JAX, PKGS, PORT, both, dup_evidence,
                              genesis_doc, light_block, plain, signed_vote,
                              vals_and_privs)
from test_torch_types import _cpu, _one_torch_thread, pkg  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# safe_codec
# ---------------------------------------------------------------------------

def test_malicious_pickle_payload_is_inert(pkg):
    """A part set assembling to a pickle bomb raises ProtoError, never
    unpickles (tests/test_wire.py); the safe codec refuses it too."""
    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    payload = pickle.dumps(Evil())
    with pytest.raises(ValueError):
        pkg.block.Block.from_proto(payload)
    with pytest.raises(pickle.UnpicklingError,
                       match="builtins.print is not allowed"):
        pkg.codec.loads(payload)


# the classes the JAX package's allow-list names that wait for a port
# module still to come: none since the consensus modules (round_types, wal)
WAITING: set = set()


def test_allow_list_is_the_reference_less_waiting_classes():
    """The port's default allow-list is the JAX package's with the package
    name mapped, less exactly the classes of the modules still to come
    (none: WAITING is empty), read in a fresh interpreter, where only the
    defaults are registered."""
    code = (
        "import json, tendermint_tpu.libs.safe_codec as j, "
        "tendermint_tpu_torch.libs.safe_codec as t\n"
        "j._register_defaults(); t._register_defaults()\n"
        "print(json.dumps([sorted(j._ALLOWED), sorted(t._ALLOWED)]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    ref, port = json.loads(r.stdout.splitlines()[-1])
    mapped = {(m.replace("tendermint_tpu.", "tendermint_tpu_torch.", 1), n)
              for m, n in ref}
    assert not WAITING
    assert ("tendermint_tpu_torch.consensus.wal", "EndHeightMessage") in mapped
    assert {tuple(x) for x in port} == mapped


def test_safe_codec_round_trip_across(pkg):
    """Each package's codec loads its own graph of the slice's types and
    refuses the other package's classes (a pickle carries its module
    path); decoded objects equal the other package's by their fields."""
    other = JAX if pkg is PORT else PORT
    lb, _ = light_block(pkg)
    ev, vs = dup_evidence(pkg)
    obj = {"light": lb, "evidence": [ev], "vals": vs,
           "params": pkg.params.ConsensusParams(),
           "abci": pkg.abci.ResponseDeliverTx(code=1, data=b"x")}
    back = pkg.codec.loads(pkg.codec.dumps(obj))
    assert plain(back) == plain(obj)
    lb_o, _ = light_block(other)
    ev_o, vs_o = dup_evidence(other)
    assert plain(back["light"]) == plain(lb_o)
    assert plain(back["evidence"]) == plain([ev_o])
    with pytest.raises(pickle.UnpicklingError, match="is not allowed"):
        pkg.codec.loads(other.codec.dumps(lb_o))


# ---------------------------------------------------------------------------
# amino_json: cases 1-5 of tests/test_amino_json.py
# ---------------------------------------------------------------------------

def test_pub_key_tagging_reference_shapes(pkg):
    aj = pkg.aj
    d = aj.pub_key_json("ed25519", b"\x01" * 32)
    assert d == {"type": "tendermint/PubKeyEd25519",
                 "value": base64.b64encode(b"\x01" * 32).decode()}
    assert aj.pub_key_json("secp256k1", b"\x02" * 33)["type"] == \
        "tendermint/PubKeySecp256k1"
    assert aj.pub_key_json("sr25519", b"\x03" * 32)["type"] == \
        "tendermint/PubKeySr25519"
    assert aj.pub_key_from_json(d) == ("ed25519", b"\x01" * 32)
    assert aj.pub_key_from_json({"type": "ed25519", "value": "01" * 32}) == \
        ("ed25519", b"\x01" * 32)


def test_rfc3339_time_reference_shapes(pkg):
    aj, TS = pkg.aj, pkg.basic.Timestamp
    assert aj.ts_rfc3339(TS(1700000100, 0)) == "2023-11-14T22:15:00Z"
    assert aj.ts_rfc3339(TS(1700000100, 500000000)) == \
        "2023-11-14T22:15:00.5Z"
    assert aj.ts_rfc3339(TS(1700000100, 25)) == \
        "2023-11-14T22:15:00.000000025Z"
    for ts in (TS(1700000100, 0), TS(123456, 789)):
        assert aj.parse_rfc3339(aj.ts_rfc3339(ts)) == ts
    assert aj.parse_rfc3339("2023-11-15T00:15:00+02:00") == TS(1700000100, 0)
    assert aj.parse_rfc3339("2023-11-14T17:45:00.25-04:30") == \
        TS(1700000100, 250000000)
    assert aj.parse_rfc3339("2023-11-14T22:15:00+00:00") == TS(1700000100, 0)
    for bad in ("2023-11-14T22:15:00+99:99", "2023-11-14T22:15:00-24:00",
                "2023-11-14T22:15:00+00:60"):
        with pytest.raises(ValueError):
            aj.parse_rfc3339(bad)
    assert aj.parse_rfc3339("2023-11-15T22:14:00+23:59") == \
        TS(1700000100, 0)


def test_vote_json_reference_shape(pkg):
    B = pkg.basic
    v = pkg.vote.Vote(
        type=B.SignedMsgType.PRECOMMIT, height=42, round=1,
        block_id=B.BlockID(b"\xAA" * 32, B.PartSetHeader(1, b"\xBB" * 32)),
        timestamp=B.Timestamp(1700000100, 0),
        validator_address=b"\xCC" * 20, validator_index=3)
    v.signature = b"\xDD" * 64
    d = pkg.aj.vote_json(v)
    assert d["height"] == "42" and d["round"] == 1
    assert d["validator_index"] == 3
    assert d["validator_address"] == "CC" * 20
    assert d["block_id"]["hash"] == "AA" * 32
    assert d["block_id"]["parts"]["total"] == 1
    assert d["signature"] == base64.b64encode(b"\xDD" * 64).decode()
    assert d["timestamp"].endswith("Z")


def test_genesis_doc_amino_shape_and_legacy_load(pkg):
    gdoc = genesis_doc(pkg, 2)
    d = json.loads(gdoc.to_json())
    assert isinstance(d["genesis_time"], str)
    for v in d["validators"]:
        assert v["pub_key"]["type"] == "tendermint/PubKeyEd25519"
        base64.b64decode(v["pub_key"]["value"], validate=True)
        assert isinstance(v["power"], str)
    back = pkg.genesis.GenesisDoc.from_json(gdoc.to_json())
    assert back.chain_id == gdoc.chain_id
    assert back.validators[0].pub_key_bytes == \
        gdoc.validators[0].pub_key_bytes
    d["genesis_time"] = {"seconds": 1700000000, "nanos": 0}
    for v in d["validators"]:
        v["pub_key"] = {"type": "ed25519",
                        "value": base64.b64decode(
                            v["pub_key"]["value"]).hex()}
    legacy = pkg.genesis.GenesisDoc.from_json(json.dumps(d))
    assert legacy.validators[0].pub_key_bytes == \
        gdoc.validators[0].pub_key_bytes


def test_duplicate_vote_evidence_json_reference_shape(pkg):
    B = pkg.basic
    vals, privs = vals_and_privs(pkg, 4, 21)
    idx = 2

    def mkvote(mark):
        return signed_vote(pkg, privs[idx], vals, idx,
                           B.BlockID(mark * 32, B.PartSetHeader(1,
                                                                mark * 32)),
                           ts=B.Timestamp(1700000100, 0))

    ev = pkg.evidence.DuplicateVoteEvidence.from_votes(
        mkvote(b"\xAA"), mkvote(b"\xBB"), B.Timestamp(1700000100, 0), vals)
    d = pkg.aj.evidence_json(ev, None, None, None)
    assert d["type"] == "tendermint/DuplicateVoteEvidence"
    val = d["value"]
    assert set(val) == {"vote_a", "vote_b", "TotalVotingPower",
                        "ValidatorPower", "Timestamp"}
    assert val["TotalVotingPower"] == str(vals.total_voting_power())
    assert val["ValidatorPower"] == "10"
    assert val["vote_a"]["height"] == "3"


def test_amino_json_text_across():
    """The dialect's JSON text is the same in both packages: keys, votes,
    validators, both kinds of evidence (the callers' header, commit and
    validator-set emitters stubbed alike) and the genesis doc."""
    def run(p):
        aj = p.aj
        ev, vs = dup_evidence(p)
        lb, _ = light_block(p)
        lca = p.evidence.LightClientAttackEvidence(
            conflicting_block=lb, common_height=3,
            byzantine_validators=lb.validators.validators[:1],
            total_voting_power=40, timestamp=p.basic.Timestamp(5, 6))
        emit = lambda x: {"hash": aj.hexb(x.hash())}  # noqa: E731
        out = [aj.vote_json(ev.vote_a),
               [aj.validator_json(v) for v in vs.validators],
               aj.evidence_json(ev, None, None, None),
               aj.evidence_json(lca, emit, emit, emit),
               aj.block_id_json(ev.vote_b.block_id),
               aj.b64(b""), aj.hexb(None),
               json.loads(genesis_doc(p, 3).to_json())]
        aj.evidence_json(object(), emit, emit, emit)
        return json.dumps(out)
    got = both(run)
    assert got[0] == "TypeError" and "unregistered evidence" in got[1]
    assert both(lambda p: [p.aj.pub_key_from_json(
        {"type": "tendermint/PubKeySecp256k1",
         "value": base64.b64encode(b"\x02" * 33).decode()}),
        p.aj.parse_rfc3339("2024-02-29T23:59:59.999999999Z")])[0] == "ok"
    assert both(lambda p: p.aj.parse_rfc3339("yesterday"))[0] == \
        "ValueError"


# ---------------------------------------------------------------------------
# log: the five cases of tests/test_log.py
# ---------------------------------------------------------------------------

def _fresh(p, level="info", modules=""):
    buf = io.StringIO()
    p.log.setup(level=level, stream=buf, module_levels=modules)
    return buf


@pytest.fixture
def logs():
    """Each case leaves the "tm" root as the package's default setup
    leaves it (stdout, info) when it ends."""
    yield
    for p in PKGS:
        p.log.setup()


def test_line_shape_and_levels(pkg, logs):
    buf = _fresh(pkg, "info")
    log = pkg.log.logger("consensus")
    log.info("entering new round", height=5, round=0)
    log.debug("invisible", x=1)
    log.error("boom", err="nope")
    lines = buf.getvalue().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("I[") and " consensus: " in lines[0]
    assert lines[0].endswith("entering new round height=5 round=0")
    assert lines[1].startswith("E[") and lines[1].endswith("boom err=nope")


def test_lazy_values_not_computed_below_level(pkg, logs):
    buf = _fresh(pkg, "info")
    calls = []

    def expensive():
        calls.append(1)
        return "h" * 8

    log = pkg.log.logger("consensus")
    log.debug("block", hash=pkg.log.Lazy(expensive))
    assert calls == []
    log.info("block", hash=pkg.log.Lazy(expensive))
    assert calls == [1]
    assert "hash=hhhhhhhh" in buf.getvalue()


def test_module_level_overrides(pkg, logs):
    buf = _fresh(pkg, "error", modules="p2p:debug")
    pkg.log.logger("consensus").info("hidden")
    pkg.log.logger("p2p").debug("visible", peer="ab")
    out = buf.getvalue()
    assert "hidden" not in out
    assert "visible peer=ab" in out


def test_bound_context_and_bytes_render(pkg, logs):
    buf = _fresh(pkg, "info")
    log = pkg.log.logger("node").with_(moniker="n0")
    log.info("saved block", hash=b"\xab\xcd")
    assert "moniker=n0" in buf.getvalue()
    assert "hash=abcd" in buf.getvalue()


def test_logging_never_raises(pkg, logs):
    buf = _fresh(pkg, "info")

    def broken():
        raise RuntimeError("nope")

    pkg.log.logger("x").info("ok", v=pkg.log.Lazy(broken))
    assert "lazy error" in buf.getvalue()


def test_log_lines_across(logs):
    """The same calls give the same lines in both packages, the clock
    field masked; each half sets up its own package just before it
    logs."""
    def half(p):
        buf = _fresh(p, "info", modules="p2p:debug,mempool:none,bad")
        log = p.log.logger("consensus").with_(height=7)
        log.info("enter", round=0, hash=b"\x01\xff", f=0.1234567,
                 lazy=p.log.Lazy(lambda: b"\xaa"))
        log.debug("hidden", x=1)
        p.log.logger("p2p").debug("dial", peer="ab", n=None)
        p.log.logger("mempool").error("never")
        p.log.logger("").error("root line")
        return (re.sub(r"\[\d\d:\d\d:\d\d\.\d{3}\]", "[ts]", buf.getvalue()),
                log.is_debug(), p.log.logger("p2p").is_debug())
    j = half(JAX)
    t = half(PORT)
    assert j == t
    assert t[0].count("\n") == 3 and "I[ts] consensus: enter height=7 " \
        "round=0 hash=01ff f=0.123457 lazy=aa" in t[0]


# ---------------------------------------------------------------------------
# event_bus
# ---------------------------------------------------------------------------

class _Responses:
    def __init__(self, p, n):
        self.deliver_txs = [p.abci.ResponseDeliverTx(code=i % 2,
                                                     data=bytes([i]))
                            for i in range(n)]


def _bus_run(p):
    """Subscribers of each shape on one bus: the typed publishers, the
    attribute filter, unsubscribe and a slow subscriber's drops."""
    EB = p.event_bus
    bus = EB.EventBus()
    subs = {"all": bus.subscribe(),
            "block": bus.subscribe(EB.EVENT_NEW_BLOCK),
            "tx_h5": bus.subscribe(EB.EVENT_TX, {"height": "5"}),
            "vote": bus.subscribe(EB.EVENT_VOTE),
            "gone": bus.subscribe(EB.EVENT_VOTE)}
    bus.unsubscribe(subs.pop("gone"))
    bus.unsubscribe(subs["vote"].__class__(None))   # never subscribed
    for height, n_res in ((4, 2), (5, 3)):
        hdr = light_block(p, height=height)[0].signed_header.header
        blk = p.block.Block(hdr, p.block.Data([b"a", b"b", b"c"]))
        bus.publish_new_block(blk, p.basic.BlockID(), _Responses(p, n_res))
    vs, privs = vals_and_privs(p, 2, 31)
    for i in range(2):
        bus.publish_vote(signed_vote(p, privs[i], vs, i, p.basic.BlockID()))
    bus.publish_new_round_step(5, 1, "RoundStepPrevote")
    bus.publish_validator_set_updates([p.abci.ValidatorUpdate("ed25519",
                                                              b"k", 3)])
    bus.publish_complete_proposal(5, 1, p.basic.BlockID())
    out = {}
    for name, sub in subs.items():
        evs = []
        while not sub.queue.empty():
            ev = sub.queue.get_nowait()
            data = ev.data
            if isinstance(data, dict):
                data = {k: (v.hash() if k == "block" else
                            v.deliver_txs if k == "responses" else v)
                        for k, v in data.items()}
            evs.append((ev.type, plain(data), ev.attributes))
        out[name] = evs
    slow = EB.Subscription(None, maxlen=2)
    for i in range(5):
        slow.deliver(EB.Event("x", i))
    out["slow"] = slow.queue.qsize()
    return out


def test_event_bus_across():
    got = both(_bus_run)[1]
    assert len(got["block"]) == 2 and len(got["vote"]) == 2
    assert [e[2] for e in got["tx_h5"]] == [{"height": "5"}] * 3
    assert got["tx_h5"][2][1]["result"] is not None
    assert got["all"][3][1]["result"] is None   # height 4: 2 results
    assert got["slow"] == 2
    assert len(got["all"]) == 2 + 6 + 2 + 3


def test_event_bus_threads(pkg):
    """Publishers on several threads: every matching subscriber gets every
    event once."""
    EB = pkg.event_bus
    bus = EB.EventBus()
    votes = bus.subscribe(EB.EVENT_VOTE)
    steps = bus.subscribe(EB.EVENT_NEW_ROUND_STEP)

    def pub(k):
        for i in range(100):
            bus.publish_new_round_step(k, i, "s")
            bus.publish(EB.Event(EB.EVENT_VOTE, data=(k, i)))
    ths = [threading.Thread(target=pub, args=(k,)) for k in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    got = sorted(votes.queue.get_nowait().data for _ in range(400))
    assert got == [(k, i) for k in range(4) for i in range(100)]
    assert votes.queue.empty() and steps.queue.qsize() == 400
