"""The port's validator signer (privval/file_pv.py, privval/signer.py,
privval/harness.py) and its ciphers (crypto/xsalsa20.py, crypto/armor.py)
against the JAX package's, on the CPU.

tests/test_remote_signer.py's socket cases (:42 the remote sign and its
double-sign guard, :111 the redial after a dropped connection),
tests/test_signer_harness.py's two cases, tests/test_xsalsa20.py's seven
and tests/test_p2p_aux.py's three armor cases run through both packages
as `case_*` functions; each returns its outcome as a package-free value
(signatures, public keys, error classes and messages, harness results,
ciphertexts where they are deterministic) and the outcomes are compared
across the packages exactly.  The votes and proposals carry fixed
timestamps and the keys are fixed, so the signatures are comparable.
Then what crosses: a JAX SignerServer serving a port SignerClient and the
reverse, over TCP and unix sockets; FilePV key and state files written by
one package and signed from by the other, the double-sign guard held
across the swap; sealed boxes and armored keys opened by the other
package.  Sockets live in short directories under /tmp (a unix socket
path holds at most 108 bytes).
"""
from __future__ import annotations

import functools
import importlib
import os
import shutil
import tempfile
import time
import types

import pytest

from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_MODS = {
    "ed": "crypto.ed25519", "basic": "types.basic",
    "proposal": "types.proposal", "vote": "types.vote",
    "file_pv": "privval.file_pv", "signer": "privval.signer",
    "harness": "privval.harness", "xs": "crypto.xsalsa20",
    "armor": "crypto.armor",
}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)
BY_NAME = {p.name: p for p in PKGS}
CHAIN = "signer-chain"


def _has_cryptography() -> bool:
    try:
        import cryptography  # noqa: F401
    except ImportError:
        return False
    return True


requires_cryptography = pytest.mark.skipif(
    not _has_cryptography(),
    reason="cryptography package unavailable "
           "(armor ChaCha20-Poly1305 AEAD needs it)")


@pytest.fixture
def sockdir():
    d = tempfile.mkdtemp(prefix="tmpv", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _key(p, seed: int = 0xFACE):
    return p.ed.PrivKey(seed.to_bytes(32, "big"))


def _mk_vote(p, h, r, blk=b"\x11" * 32, ts=1700000000, typ=None):
    B = p.basic
    return p.vote.Vote(
        type=typ if typ is not None else B.SignedMsgType.PREVOTE,
        height=h, round=r,
        block_id=B.BlockID(hash=blk, part_set_header=B.PartSetHeader(
            1, b"\x22" * 32)),
        timestamp=B.Timestamp(ts, 0), validator_address=b"\x00" * 20,
        validator_index=0)


def _mk_proposal(p, h=4, ts=1700000100):
    B = p.basic
    return p.proposal.Proposal(
        height=h, round=0, pol_round=-1,
        block_id=B.BlockID(hash=b"\x33" * 32,
                           part_set_header=B.PartSetHeader(1, b"\x44" * 32)),
        timestamp=B.Timestamp(ts, 0))


def _pair(client_pkg, server_pkg, addr, pv=None):
    """A client of one package listening at addr, a server of the other
    dialling it around a FilePV of the server's package."""
    pv = pv or server_pkg.file_pv.FilePV(_key(server_pkg))
    client = client_pkg.signer.SignerClient(addr, timeout_s=5.0,
                                            accept_timeout_s=20.0)
    if addr.startswith("tcp://") and addr.endswith(":0"):
        addr = f"tcp://127.0.0.1:{client._listener.getsockname()[1]}"
    server = server_pkg.signer.SignerServer(pv, addr)
    server.start()
    return pv, client, server


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - returned and compared
        return (type(e).__name__, str(e))
    return None


# ---------------------------------------------------------------------------
# tests/test_remote_signer.py's socket cases
# ---------------------------------------------------------------------------

def case_remote_sign_and_double_sign_guard(p, d):
    pv, client, server = _pair(p, p, f"unix://{os.path.join(d, 'pv.sock')}")
    try:
        assert client.ping()
        pub = client.get_pub_key()
        assert pub == pv.get_pub_key()
        signed = client.sign_vote(CHAIN, _mk_vote(p, 3, 0))
        assert signed.signature and pv.get_pub_key().verify_signature(
            signed.sign_bytes(CHAIN), signed.signature)
        refused = _err(lambda: client.sign_vote(
            CHAIN, _mk_vote(p, 3, 0, blk=b"\x99" * 32)))
        assert refused[0] == "RemoteSignerError"
        sp = client.sign_proposal(CHAIN, _mk_proposal(p))
        assert sp.signature
    finally:
        client.close()
        server.stop()
    return {"pub": pub.bytes(), "vote": signed, "refused": refused,
            "proposal": sp}


def case_signer_redials_after_drop(p, d):
    pv, client, server = _pair(p, p, f"unix://{os.path.join(d, 'pv.sock')}")
    try:
        assert client.ping()
        client._drop()
        deadline = time.time() + 10
        ok = False
        while time.time() < deadline and not ok:
            try:
                ok = client.ping()
            except p.signer.RemoteSignerError:
                time.sleep(0.1)
        assert ok, "signer did not redial"
        signed = client.sign_vote(CHAIN, _mk_vote(p, 9, 1))
        assert signed.signature
    finally:
        client.close()
        server.stop()
    return {"vote": signed}


# ---------------------------------------------------------------------------
# tests/test_signer_harness.py's cases
# ---------------------------------------------------------------------------

def _harness(p, pv):
    _, client, srv = _pair(p, p, "tcp://127.0.0.1:0", pv=pv)
    try:
        return p.harness.run_harness(client)
    finally:
        client.close()
        srv.stop()


def case_harness_passes_for_conforming_signer(p, d):
    res = _harness(p, p.file_pv.FilePV(_key(p)))
    assert res.ok, res.failed
    assert set(res.passed) == {"pubkey", "sign_proposal", "sign_prevote",
                               "sign_precommit", "double_sign_refusal",
                               "same_block_resign"}
    return {"passed": res.passed, "failed": res.failed}


def case_harness_catches_double_signer(p, d):
    cls = p.file_pv._LastSignState
    real = cls.check_hrs
    cls.check_hrs = lambda self, h, r, s: False
    try:
        res = _harness(p, p.file_pv.FilePV(_key(p)))
    finally:
        cls.check_hrs = real
    assert not res.ok
    assert any("double_sign_refusal" in f for f in res.failed), res.failed
    return {"passed": res.passed, "failed": res.failed}


# ---------------------------------------------------------------------------
# tests/test_xsalsa20.py's cases
# ---------------------------------------------------------------------------

def case_salsa20_core_zero_fixed_point(p, d):
    out = p.xs._salsa20_core([0] * 16)
    assert out == b"\x00" * 64
    return {"core": out, "core1": p.xs._salsa20_core(list(range(16)))}


def case_poly1305_rfc8439_vector(p, d):
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a8"
                        "0103808afb0db2fd4abff6af4149f51b")
    tag = p.xs.poly1305(b"Cryptographic Forum Research Group", key)
    assert tag.hex() == "a8061dc1305136c6c22b8baf0c0127a9"
    return {"tag": tag}


def case_secretbox_nacl_paper_vector_prefix(p, d):
    key = bytes.fromhex("1b27556473e985d462cd51197a9a46c7"
                        "6009549eac6474f206c4ee0844f68389")
    nonce = bytes.fromhex("69696ee955b62b73cd62bda875fc73d6"
                          "8219e0036b7a0b37")
    m48 = bytes.fromhex(
        "be075fc53c81f2d5cf141316ebeb0c7b5228c52a4c62cbd44b66849b64244ffc"
        "e5ecbaaf33bd751a1ac728d45e6c6129")
    boxed = p.xs.secretbox_seal(m48, nonce, key)
    assert boxed[16:].hex() == (
        "8e993b9f48681273c29650ba32fc76ce48332ea7164d96a4476fb8c531a1186a"
        "c0dfc17c98dce87b4da7f011ec48c972")
    return {"boxed": boxed}


def case_hsalsa20_subkey_shape(p, d):
    out = p.xs.hsalsa20(b"\x01" * 32, b"\x02" * 16)
    assert len(out) == 32 and out != b"\x00" * 32
    return {"subkey": out}


def case_encrypt_decrypt_roundtrip(p, d):
    secret = b"somesecretoflengththirtytwo===32"
    lens = []
    for pt in (b"a", b"sometext", b"x" * 1000):
        ct = p.xs.encrypt_symmetric(pt, secret)
        assert len(ct) == 24 + 16 + len(pt)
        assert p.xs.decrypt_symmetric(ct, secret) == pt
        assert p.xs.encrypt_symmetric(pt, secret) != ct
        lens.append(len(ct))
    err = _err(lambda: p.xs.decrypt_symmetric(
        p.xs.encrypt_symmetric(b"", secret), secret))
    assert err[0] == "SymmetricError"
    return {"lens": lens, "empty": err}


def case_tamper_and_wrong_key_rejected(p, d):
    secret = b"somesecretoflengththirtytwo===32"
    ct = bytearray(p.xs.encrypt_symmetric(b"armored private key", secret))
    errs = []
    for pos in (0, 24, 40, len(ct) - 1):
        bad = bytearray(ct)
        bad[pos] ^= 1
        errs.append(_err(lambda: p.xs.decrypt_symmetric(bytes(bad), secret)))
    errs.append(_err(lambda: p.xs.decrypt_symmetric(bytes(ct), b"B" * 32)))
    errs.append(_err(lambda: p.xs.decrypt_symmetric(b"short", secret)))
    errs.append(_err(lambda: p.xs.encrypt_symmetric(b"x", b"shortkey")))
    assert all(e is not None and e[0] == "SymmetricError" for e in errs)
    return {"errors": errs}


def case_secretbox_open_matches_seal(p, d):
    key, nonce = b"\x07" * 32, b"\x09" * 24
    boxed = p.xs.secretbox_seal(b"hello world", nonce, key)
    assert p.xs.secretbox_open(boxed, nonce, key) == b"hello world"
    return {"boxed": boxed}


# ---------------------------------------------------------------------------
# tests/test_p2p_aux.py's armor cases
# ---------------------------------------------------------------------------

def case_armor_round_trip_and_crc(p, d):
    text = p.armor.encode_armor("TEST BLOCK", {"k": "v"},
                                b"\x00\x01\xFFdata" * 40)
    bt, headers, data = p.armor.decode_armor(text)
    assert bt == "TEST BLOCK" and headers == {"k": "v"}
    assert data == b"\x00\x01\xFFdata" * 40
    lines = text.splitlines()
    for i, ln in enumerate(lines):
        if ln and not ln.startswith(("-", "=", "k")):
            lines[i] = ("B" if ln[0] != "B" else "C") + ln[1:]
            break
    err = _err(lambda: p.armor.decode_armor("\n".join(lines)))
    assert err[0] == "ArmorError"
    return {"text": text, "crc_error": err}


def case_encrypt_armor_priv_key(p, d):
    priv = bytes(range(32))
    armored = p.armor.encrypt_armor_priv_key(priv, "hunter2",
                                             key_type="ed25519")
    assert "TENDERMINT PRIVATE KEY" in armored
    assert "kdf: scrypt" in armored
    out, kt = p.armor.unarmor_decrypt_priv_key(armored, "hunter2")
    assert out == priv and kt == "ed25519"
    err = _err(lambda: p.armor.unarmor_decrypt_priv_key(armored,
                                                        "wrong-pass"))
    assert err[0] == "ArmorError"
    bt, headers, _ = p.armor.decode_armor(armored)
    return {"out": (out, kt), "wrong": err, "type": bt,
            "headers": sorted(headers)}


def case_armor_xsalsa20_legacy_aead(p, d):
    A = p.armor
    priv = bytes(range(32))
    a = A.encrypt_armor_priv_key(priv, "hunter2", aead="xsalsa20poly1305")
    btype, headers, body = A.decode_armor(a)
    assert headers["aead"] == "xsalsa20poly1305"
    pt, ktype = A.unarmor_decrypt_priv_key(a, "hunter2")
    assert pt == priv and ktype == "ed25519"
    errs = [_err(lambda: A.unarmor_decrypt_priv_key(a, "wrong"))]
    relabeled = A.encode_armor(btype, {**headers,
                                       "aead": "chacha20poly1305"}, body)
    errs.append(_err(lambda: A.unarmor_decrypt_priv_key(relabeled,
                                                        "hunter2")))
    bogus = A.encode_armor(btype, {**headers, "aead": "bogus"}, body)
    errs.append(_err(lambda: A.unarmor_decrypt_priv_key(bogus, "hunter2")))
    assert all(e[0] == "ArmorError" for e in errs) and "AEAD" in errs[2][1]
    return {"out": (pt, ktype), "errors": errs}


CASES = {f.__name__[len("case_"):]: f for f in (
    case_remote_sign_and_double_sign_guard,
    case_signer_redials_after_drop,
    case_harness_passes_for_conforming_signer,
    case_harness_catches_double_signer,
    case_salsa20_core_zero_fixed_point,
    case_poly1305_rfc8439_vector,
    case_secretbox_nacl_paper_vector_prefix,
    case_hsalsa20_subkey_shape,
    case_encrypt_decrypt_roundtrip,
    case_tamper_and_wrong_key_rejected,
    case_secretbox_open_matches_seal,
    case_armor_round_trip_and_crc)}
CRYPTO_CASES = {f.__name__[len("case_"):]: f for f in (
    case_encrypt_armor_priv_key, case_armor_xsalsa20_legacy_aead)}


@functools.lru_cache(maxsize=None)
def _outcome(case: str, name: str):
    fn = {**CASES, **CRYPTO_CASES}[case]
    d = tempfile.mkdtemp(prefix="tmpv", dir="/tmp")
    try:
        return plain(fn(BY_NAME[name], d))
    finally:
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.mark.parametrize("case", sorted(CASES))
def test_privval_case(case, pkg):
    """The JAX test's case, its assertions, in each package."""
    assert _outcome(case, pkg.name) is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_privval_case_equal(case):
    """The case's outcome is the same in both packages."""
    assert _outcome(case, "jax") == _outcome(case, "port")


@requires_cryptography
@pytest.mark.parametrize("case", sorted(CRYPTO_CASES))
def test_armor_case(case, pkg):
    """tests/test_p2p_aux.py's armor case that needs the cryptography
    package, in each package."""
    assert _outcome(case, pkg.name) is not None


@requires_cryptography
@pytest.mark.parametrize("case", sorted(CRYPTO_CASES))
def test_armor_case_equal(case):
    assert _outcome(case, "jax") == _outcome(case, "port")


# ---------------------------------------------------------------------------
# what crosses the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["tcp", "unix"])
@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, JAX), (JAX, PORT)],
                         ids=["jax-server-port-client",
                              "port-server-jax-client"])
def test_signer_serves_the_other_package(client_pkg, server_pkg, transport,
                                         sockdir):
    """The framed tendermint.privval.Message is canonical proto: a signer
    of one package serves a client of the other.  Pubkey, votes of both
    steps, a proposal, the remote double-sign refusal (its message) and
    the harness are those of a same-package pair."""
    addr = ("tcp://127.0.0.1:0" if transport == "tcp"
            else f"unix://{os.path.join(sockdir, 'x.sock')}")
    pv, client, server = _pair(client_pkg, server_pkg, addr)
    C = client_pkg
    try:
        assert client.ping()
        pub = client.get_pub_key()
        assert pub.bytes() == pv.get_pub_key().bytes()
        pre = client.sign_vote(CHAIN, _mk_vote(C, 5, 0))
        pc = client.sign_vote(CHAIN, _mk_vote(
            C, 5, 0, typ=C.basic.SignedMsgType.PRECOMMIT))
        refused = _err(lambda: client.sign_vote(
            CHAIN, _mk_vote(C, 5, 0, blk=b"\x99" * 32,
                            typ=C.basic.SignedMsgType.PRECOMMIT)))
        prop = client.sign_proposal(CHAIN, _mk_proposal(C, h=6))
    finally:
        client.close()
        server.stop()
    # the same requests signed by a FilePV of the client's package
    local = C.file_pv.FilePV(_key(C))
    want_pre = local.sign_vote(CHAIN, _mk_vote(C, 5, 0))
    want_pc = local.sign_vote(CHAIN, _mk_vote(
        C, 5, 0, typ=C.basic.SignedMsgType.PRECOMMIT))
    want_ref = _err(lambda: local.sign_vote(CHAIN, _mk_vote(
        C, 5, 0, blk=b"\x99" * 32, typ=C.basic.SignedMsgType.PRECOMMIT)))
    want_prop = local.sign_proposal(CHAIN, _mk_proposal(C, h=6))
    assert plain([pre, pc, prop]) == plain([want_pre, want_pc, want_prop])
    assert refused == ("RemoteSignerError", want_ref[1])
    res = _harness_cross(client_pkg, server_pkg)
    assert res.ok, res.failed


def _harness_cross(client_pkg, server_pkg):
    _, client, srv = _pair(client_pkg, server_pkg, "tcp://127.0.0.1:0")
    try:
        return client_pkg.harness.run_harness(client)
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_file_pv_files_cross_with_the_guard(writer, reader, tmp_path):
    """Key and state files written by one package's FilePV load in the
    other's: the same key, and the double-sign guard holds across the
    swap (a conflicting block at the same height/round/step raises
    DoubleSignError and leaves the state file as it was; a re-sign that
    differs only in its timestamp returns the first signature and
    timestamp; a height regression is refused)."""
    kp, sp = str(tmp_path / "key.json"), str(tmp_path / "state.json")
    w = writer.file_pv.FilePV.load_or_generate(kp, sp)
    first = w.sign_vote(CHAIN, _mk_vote(writer, 7, 1, ts=1700000070))
    r = reader.file_pv.FilePV.load_or_generate(kp, sp)
    assert r.get_pub_key().bytes() == w.get_pub_key().bytes()
    assert r.priv_key.bytes() == w.priv_key.bytes()
    before = open(sp, "rb").read()
    with pytest.raises(reader.file_pv.DoubleSignError):
        r.sign_vote(CHAIN, _mk_vote(reader, 7, 1, blk=b"\x98" * 32,
                                    ts=1700000071))
    assert open(sp, "rb").read() == before
    again = r.sign_vote(CHAIN, _mk_vote(reader, 7, 1, ts=1700000099))
    assert again.signature == first.signature
    assert (again.timestamp.seconds, again.timestamp.nanos) == \
        (1700000070, 0)
    with pytest.raises(reader.file_pv.DoubleSignError):
        r.sign_vote(CHAIN, _mk_vote(reader, 6, 0))
    # a later height signs, and the writer reloaded from the reader's
    # state refuses to go back to height 7
    nxt = r.sign_vote(CHAIN, _mk_vote(reader, 8, 0))
    w2 = writer.file_pv.FilePV.load_or_generate(kp, sp)
    assert w2.last.height == 8 and w2.last.signature == nxt.signature
    with pytest.raises(writer.file_pv.DoubleSignError):
        w2.sign_vote(CHAIN, _mk_vote(writer, 7, 1, ts=1700000070))
    # the files are byte-identical to what the reader's own package writes
    other = tmp_path / "other"
    kp2, sp2 = str(other / "key.json"), str(other / "state.json")
    mine = reader.file_pv.FilePV(r.priv_key, kp2, sp2)
    mine.save_key()
    mine.sign_vote(CHAIN, _mk_vote(reader, 8, 0))
    assert open(kp2).read() == open(kp).read()
    assert open(sp2).read() == open(sp).read()


def test_sealed_boxes_and_armor_cross():
    """A box sealed by one package opens in the other; an armored key
    made by one (legacy secretbox AEAD, so no cryptography package is
    needed) decrypts in the other."""
    key, nonce = bytes(range(32)), bytes(range(24))
    for a, b in ((JAX, PORT), (PORT, JAX)):
        boxed = a.xs.secretbox_seal(b"cross package", nonce, key)
        assert b.xs.secretbox_open(boxed, nonce, key) == b"cross package"
        ct = a.xs.encrypt_symmetric(b"payload", key)
        assert b.xs.decrypt_symmetric(ct, key) == b"payload"
        text = a.armor.encode_armor("T", {"h": "1"}, b"\x00body")
        assert b.armor.decode_armor(text) == ("T", {"h": "1"}, b"\x00body")


@requires_cryptography
def test_armored_key_crosses():
    priv = bytes(range(32))
    for a, b in ((JAX, PORT), (PORT, JAX)):
        for aead in ("xsalsa20poly1305", "chacha20poly1305"):
            armored = a.armor.encrypt_armor_priv_key(priv, "pw", aead=aead)
            assert b.armor.unarmor_decrypt_priv_key(armored, "pw") == \
                (priv, "ed25519")
