"""Remote signer: the validator key lives in a separate process
(reference privval/signer_client.go:94, signer_server.go,
signer_listener_endpoint.go, signer_dialer_endpoint.go).

Topology matches the reference: the NODE listens on
`priv_validator_laddr`; the SIGNER process dials in and then serves
signing requests over the single connection.

  node side:   SignerListener (accepts) + SignerClient (PrivValidator
               interface: get_pub_key / sign_vote / sign_proposal)
  signer side: SignerServer (dials, loops: read request -> ask the
               wrapped FilePV -> respond)

Framing: uvarint length-delimited canonical proto
tendermint.privval.Message (reference privval/types.proto,
signer_endpoint.go protoio readers) — a Go remote signer (tmkms-style)
interoperates.  Double-sign protection stays with the key: the remote
FilePV enforces its HRS monotonicity and the refusal travels back as a
RemoteSignerError.
"""
from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass
from typing import Optional

from tendermint_tpu_torch.abci import wire as abci_wire
from tendermint_tpu_torch.abci.server import parse_addr
from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.p2p.wire import oneof_decode, oneof_encode


@dataclass
class PingRequest:
    pass


@dataclass
class PingResponse:
    pass


@dataclass
class PubKeyRequest:
    chain_id: str = ""


@dataclass
class PubKeyResponse:
    key_type: str = ""
    key_bytes: bytes = b""
    error: str = ""


@dataclass
class SignVoteRequest:
    chain_id: str
    vote: object


@dataclass
class SignedVoteResponse:
    vote: object = None
    error: str = ""


@dataclass
class SignProposalRequest:
    chain_id: str
    proposal: object


@dataclass
class SignedProposalResponse:
    proposal: object = None
    error: str = ""


class RemoteSignerError(Exception):
    pass


# -- proto codec (privval/types.proto Message oneof: pub_key_request=1,
# pub_key_response=2, sign_vote_request=3, signed_vote_response=4,
# sign_proposal_request=5, signed_proposal_response=6, ping_request=7,
# ping_response=8) ----------------------------------------------------------

def _enc_err(error: str) -> bytes:
    if not error:
        return b""
    return pe.message_field_always(
        2, pe.varint_field(1, 1) + pe.string_field(2, error))


def _dec_err(f) -> str:
    e = pd.get_message(f, 2)
    if e is None:
        return ""
    return pd.get_string(pd.parse(e), 2) or "remote signer error"


def encode_msg(msg) -> bytes:
    if isinstance(msg, PubKeyRequest):
        return oneof_encode(1, pe.string_field(1, msg.chain_id))
    if isinstance(msg, PubKeyResponse):
        pub = abci_wire.enc_public_key(msg.key_type, msg.key_bytes) \
            if msg.key_bytes else b""
        return oneof_encode(2, pe.message_field_always(1, pub)
                            + _enc_err(msg.error))
    if isinstance(msg, SignVoteRequest):
        return oneof_encode(3, pe.message_field_always(1, msg.vote.proto())
                            + pe.string_field(2, msg.chain_id))
    if isinstance(msg, SignedVoteResponse):
        body = (pe.message_field_always(1, msg.vote.proto())
                if msg.vote is not None else b"")
        return oneof_encode(4, body + _enc_err(msg.error))
    if isinstance(msg, SignProposalRequest):
        return oneof_encode(
            5, pe.message_field_always(1, msg.proposal.proto())
            + pe.string_field(2, msg.chain_id))
    if isinstance(msg, SignedProposalResponse):
        body = (pe.message_field_always(1, msg.proposal.proto())
                if msg.proposal is not None else b"")
        return oneof_encode(6, body + _enc_err(msg.error))
    if isinstance(msg, PingRequest):
        return oneof_encode(7, b"")
    if isinstance(msg, PingResponse):
        return oneof_encode(8, b"")
    raise TypeError(f"unknown privval message {type(msg).__name__}")


def _dec_pub_key_response(body: bytes) -> PubKeyResponse:
    f = pd.parse(body)
    ktype, kbytes = "", b""
    pub = pd.get_message(f, 1)
    if pub is not None:
        ktype, kbytes = abci_wire.dec_public_key(pub, default_type="")
    return PubKeyResponse(key_type=ktype, key_bytes=kbytes,
                          error=_dec_err(f))


def _dec_sign_vote_request(body: bytes) -> SignVoteRequest:
    from tendermint_tpu_torch.types.vote import Vote
    f = pd.parse(body)
    v = pd.get_message(f, 1)
    if v is None:
        raise pd.ProtoError("SignVoteRequest: missing vote")
    return SignVoteRequest(chain_id=pd.get_string(f, 2),
                           vote=Vote.from_proto(v))


def _dec_signed_vote_response(body: bytes) -> SignedVoteResponse:
    from tendermint_tpu_torch.types.vote import Vote
    f = pd.parse(body)
    v = pd.get_message(f, 1)
    return SignedVoteResponse(
        vote=Vote.from_proto(v) if v else None, error=_dec_err(f))


def _dec_sign_proposal_request(body: bytes) -> SignProposalRequest:
    from tendermint_tpu_torch.types.proposal import Proposal
    f = pd.parse(body)
    p = pd.get_message(f, 1)
    if p is None:
        raise pd.ProtoError("SignProposalRequest: missing proposal")
    return SignProposalRequest(chain_id=pd.get_string(f, 2),
                               proposal=Proposal.from_proto(p))


def _dec_signed_proposal_response(body: bytes) -> SignedProposalResponse:
    from tendermint_tpu_torch.types.proposal import Proposal
    f = pd.parse(body)
    p = pd.get_message(f, 1)
    return SignedProposalResponse(
        proposal=Proposal.from_proto(p) if p else None, error=_dec_err(f))


_HANDLERS = {
    1: lambda b: PubKeyRequest(pd.get_string(pd.parse(b), 1)),
    2: _dec_pub_key_response,
    3: _dec_sign_vote_request,
    4: _dec_signed_vote_response,
    5: _dec_sign_proposal_request,
    6: _dec_signed_proposal_response,
    7: lambda b: PingRequest(),
    8: lambda b: PingResponse(),
}


def decode_msg(data: bytes):
    return oneof_decode(data, _HANDLERS)


def _read_frame(sock: socket.socket):
    data = abci_wire.read_frame(sock)
    if data is None:
        return None
    return decode_msg(data)


def _write_frame(sock: socket.socket, obj):
    abci_wire.write_frame(sock, encode_msg(obj))


# ---------------------------------------------------------------------------
# node side
# ---------------------------------------------------------------------------

class SignerClient:
    """PrivValidator backed by a remote signer connection (reference
    privval/signer_client.go).  Blocks on start until the signer dials
    in; requests are serialized over the one connection."""

    def __init__(self, laddr: str, timeout_s: float = 5.0,
                 accept_timeout_s: float = 30.0):
        self.laddr = laddr
        self.timeout_s = timeout_s
        kind, target = parse_addr(laddr)
        if kind == "unix":
            import os
            try:
                os.unlink(target)
            except OSError:
                pass
            self._listener = socket.socket(socket.AF_UNIX)
            self._listener.bind(target)
        else:
            self._listener = socket.create_server(target)
        self._listener.listen(1)
        self._listener.settimeout(accept_timeout_s)
        self._sock: Optional[socket.socket] = None
        self._mtx = threading.Lock()
        self._closed = False

    # -- connection management (signer_listener_endpoint.go) ---------------

    def _ensure_conn(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        sock, _ = self._listener.accept()
        sock.settimeout(self.timeout_s)
        self._sock = sock
        return sock

    def _call(self, req):
        with self._mtx:
            if self._closed:
                raise RemoteSignerError("signer client closed")
            try:
                sock = self._ensure_conn()
                _write_frame(sock, req)
                resp = _read_frame(sock)
            except (OSError, ConnectionError, socket.timeout,
                    ValueError) as e:
                # ValueError covers ProtoError: an undecodable frame is
                # as broken as a dead socket — drop the connection (the
                # signer will redial) and keep the error contract
                self._drop()
                raise RemoteSignerError(f"remote signer io: {e}") from e
            if resp is None:
                self._drop()
                raise RemoteSignerError("remote signer closed connection")
            return resp

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        """Deliberately does NOT take _mtx: a _call may be blocked up to
        accept_timeout_s in listener.accept(); closing the sockets from
        here makes that accept/recv raise OSError immediately, so both
        close() and the blocked call return promptly."""
        self._closed = True
        self._listener.close()
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- PrivValidator interface -------------------------------------------

    def ping(self) -> bool:
        return isinstance(self._call(PingRequest()), PingResponse)

    def get_pub_key(self):
        resp = self._call(PubKeyRequest())
        if not isinstance(resp, PubKeyResponse) or resp.error:
            raise RemoteSignerError(getattr(resp, "error", "bad response"))
        from tendermint_tpu_torch.crypto import pubkey_from_type_name
        return pubkey_from_type_name(resp.key_type, resp.key_bytes)

    def sign_vote(self, chain_id: str, vote):
        resp = self._call(SignVoteRequest(chain_id, vote))
        if not isinstance(resp, SignedVoteResponse):
            raise RemoteSignerError("bad sign_vote response")
        if resp.error:
            raise RemoteSignerError(resp.error)
        return resp.vote

    def sign_proposal(self, chain_id: str, proposal):
        resp = self._call(SignProposalRequest(chain_id, proposal))
        if not isinstance(resp, SignedProposalResponse):
            raise RemoteSignerError("bad sign_proposal response")
        if resp.error:
            raise RemoteSignerError(resp.error)
        return resp.proposal


# ---------------------------------------------------------------------------
# signer side
# ---------------------------------------------------------------------------

class SignerServer:
    """Wraps a local PrivValidator (FilePV) and serves it to a node
    (reference privval/signer_server.go + signer_dialer_endpoint.go:
    dial the node's listener, serve, redial with backoff on error)."""

    def __init__(self, pv, node_addr: str, retry_wait_s: float = 0.2,
                 max_dial_retries: int = 100):
        self.pv = pv
        self.node_addr = node_addr
        self.retry_wait_s = retry_wait_s
        self.max_dial_retries = max_dial_retries
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="signer-server")
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _dial(self) -> Optional[socket.socket]:
        kind, target = parse_addr(self.node_addr)
        for _ in range(self.max_dial_retries):
            if self._stop.is_set():
                return None
            try:
                if kind == "unix":
                    s = socket.socket(socket.AF_UNIX)
                    s.connect(target)
                else:
                    s = socket.create_connection(target, timeout=5)
                s.settimeout(None)
                return s
            except OSError:
                time.sleep(self.retry_wait_s)
        return None

    def _run(self):
        while not self._stop.is_set():
            sock = self._dial()
            if sock is None:
                return
            try:
                self._serve(sock)
            except (OSError, ConnectionError, ValueError):
                # ValueError covers ProtoError from an undecodable frame:
                # drop the connection and redial rather than killing the
                # serve loop (the validator would silently stop signing)
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass

    def _serve(self, sock: socket.socket):
        while not self._stop.is_set():
            req = _read_frame(sock)
            if req is None:
                return
            _write_frame(sock, self._handle(req))

    def _handle(self, req):
        """Reference privval/signer_server.go:?? HandleRequest: double-sign
        refusals travel back as error strings, not connection failures."""
        try:
            if isinstance(req, PingRequest):
                return PingResponse()
            if isinstance(req, PubKeyRequest):
                pub = self.pv.get_pub_key()
                return PubKeyResponse(key_type=pub.type_name,
                                      key_bytes=pub.bytes())
            if isinstance(req, SignVoteRequest):
                return SignedVoteResponse(
                    vote=self.pv.sign_vote(req.chain_id, req.vote))
            if isinstance(req, SignProposalRequest):
                return SignedProposalResponse(
                    proposal=self.pv.sign_proposal(req.chain_id,
                                                   req.proposal))
            return PubKeyResponse(error=f"unknown request {type(req).__name__}")
        except Exception as e:  # noqa: BLE001 - refusal -> error response
            if isinstance(req, SignVoteRequest):
                return SignedVoteResponse(error=str(e))
            if isinstance(req, SignProposalRequest):
                return SignedProposalResponse(error=str(e))
            return PubKeyResponse(error=str(e))
