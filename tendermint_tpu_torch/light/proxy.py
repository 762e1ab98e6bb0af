"""Light-client-backed RPC proxy (reference light/proxy/proxy.go +
light/rpc/client.go).

Serves a JSON-RPC surface on which every piece of chain data is verified
against light-client-verified headers before it is returned:

- `commit` / `validators` / `header` come from the light client's verified
  store (signature verification rides the batched card verifier through
  VerifyCommitLight / VerifyCommitLightTrusting).
- `block` is fetched from the primary as canonical proto bytes and only
  served if its hash equals the verified header's hash
  (reference light/rpc/client.go Block -> header cross-check).
- `abci_query` responses carrying merkle proof operators are verified
  against the verified app hash (reference light/rpc/client.go:ABCIQuery
  with ProofOpsVerifier); proof-less responses are marked unverified.
- `broadcast_tx_*` / `status` / `health` forward to the primary (they are
  either node-local or carry their own consensus-level guarantees).

The proxy takes no device of its own (as in the JAX package): its light
client verifies on the device it was made with (`Client(device=)`).
"""
from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl, urlparse

from tendermint_tpu_torch.light.client import Client, LightClientError
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
from tendermint_tpu_torch.types.basic import Timestamp


class ProxyError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


class LightProxy:
    """JSON-RPC server proxying a primary node through a light client."""

    def __init__(self, client: Client, primary_addr: str, laddr: str,
                 timeout: float = 10.0):
        self.client = client
        self.primary = HTTPClient(primary_addr, timeout=timeout)
        host, _, port = laddr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self.routes = {
            "health": self.health,
            "status": self.status,
            "commit": self.commit,
            "header": self.header,
            "validators": self.validators,
            "block": self.block,
            "abci_query": self.abci_query,
            "broadcast_tx_sync": self._forward("broadcast_tx_sync"),
            "broadcast_tx_async": self._forward("broadcast_tx_async"),
            "broadcast_tx_commit": self._forward("broadcast_tx_commit"),
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("request must be an object")
                except (json.JSONDecodeError, UnicodeDecodeError,
                        ValueError):
                    self._reply(proxy._err(None, -32700, "parse error"))
                    return
                self._reply(proxy.dispatch(req.get("method", ""),
                                           req.get("params") or {},
                                           req.get("id", -1)))

            def do_GET(self):
                u = urlparse(self.path)
                params = dict(parse_qsl(u.query))
                method = u.path.strip("/")
                if method == "":
                    self._reply({"jsonrpc": "2.0", "id": -1, "result": {
                        "routes": sorted(proxy.routes)}})
                    return
                self._reply(proxy.dispatch(method, params, -1))

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    @property
    def laddr(self) -> str:
        return f"{self.host}:{self.port}"

    # -- dispatch ----------------------------------------------------------

    def _err(self, rid, code, message):
        return {"jsonrpc": "2.0", "id": rid,
                "error": {"code": code, "message": message}}

    def dispatch(self, method: str, params: dict, rid):
        fn = self.routes.get(method)
        if fn is None:
            return self._err(rid, -32601, f"unknown method {method!r}")
        try:
            result = fn(**params)
        except ProxyError as e:
            return self._err(rid, e.code, str(e))
        except (LightClientError, RPCClientError) as e:
            return self._err(rid, -32603, str(e))
        except TypeError as e:
            return self._err(rid, -32602, f"invalid params: {e}")
        except Exception as e:  # pragma: no cover - defensive
            return self._err(rid, -32603, f"internal error: {e}")
        return {"jsonrpc": "2.0", "id": rid, "result": result}

    def _forward(self, method):
        def fn(**params):
            return self.primary.call(method, **params)
        return fn

    # -- verified handlers -------------------------------------------------

    def _verified(self, height, wait_s: float = 10.0) -> "object":
        h = int(height) if height else 0
        if h <= 0:
            lb = self.client.update(Timestamp.now())
            if lb is None:
                lb = self.client.trusted_light_block(
                    self.client.last_trusted_height())
            if lb is None:
                raise ProxyError(-32603, "no verified light block")
            return lb
        # an explicitly requested height may be at the primary's head and
        # not committed yet; block briefly like the reference's
        # updateLightClientIfNeededTo (light/rpc/client.go:606).  Only
        # not-yet-available heights are worth retrying — verification
        # failures and unreachable primaries are permanent for this call.
        import time as _time

        from tendermint_tpu_torch.light.provider import (
            HeightTooHigh, LightBlockNotFound)

        deadline = _time.monotonic() + wait_s
        while True:
            try:
                return self.client.verify_light_block_at_height(
                    h, Timestamp.now())
            except (HeightTooHigh, LightBlockNotFound) as e:
                if _time.monotonic() >= deadline:
                    raise ProxyError(
                        -32603, f"no verified light block at {h}: {e}")
                _time.sleep(0.1)

    def health(self):
        return self.primary.call("health")

    def status(self):
        st = self.primary.call("status")
        lh = self.client.last_trusted_height()
        st["light_client"] = {
            "last_trusted_height": lh,
            "trusted_hash": (self.client.trusted_light_block(lh)
                             .hash().hex().upper() if lh else "")}
        return st

    def header(self, height=None):
        lb = self._verified(height)
        h = lb.signed_header.header
        return {"height": lb.height, "hash": lb.hash().hex().upper(),
                "chain_id": h.chain_id, "app_hash": h.app_hash.hex().upper(),
                "validators_hash": h.validators_hash.hex().upper(),
                "time": {"seconds": h.time.seconds, "nanos": h.time.nanos},
                "proposer_address": h.proposer_address.hex().upper()}

    def commit(self, height=None):
        lb = self._verified(height)
        return {"height": lb.height,
                "signed_header": _b64(lb.signed_header.proto()),
                "verified": True}

    def validators(self, height=None):
        lb = self._verified(height)
        return {"block_height": lb.height,
                "validator_set": _b64(lb.validators.proto()),
                "verified": True}

    def block(self, height=None):
        """Fetch the full block from the primary, verify its hash against
        the light-client-verified header (light/rpc/client.go Block)."""
        from tendermint_tpu_torch.types.block import Block

        lb = self._verified(height)
        r = self.primary.call("block_proto", height=lb.height)
        block = Block.from_proto(base64.b64decode(r["block"]))
        if block.hash() != lb.hash():
            raise ProxyError(
                -32603,
                f"primary served block {block.hash().hex()} but verified "
                f"header is {lb.hash().hex()} at height {lb.height}")
        return {"height": lb.height, "block": r["block"], "verified": True}

    def abci_query(self, path="", data="", height=None, prove=True):
        """Query through the primary; verify merkle proofs against the
        verified app hash when the response carries proof operators.

        NOTE the header lag: app_hash at height h commits the state after
        block h-1 (reference light/rpc/client.go:ABCIQuery uses
        res.Height+1)."""
        from tendermint_tpu_torch.crypto.merkle import (
            ProofOp, default_proof_runtime)

        r = self.primary.call("abci_query", path=path, data=data,
                              height=height or 0, prove=True)
        resp = r["response"]
        pops = resp.get("proof_ops") or []
        if not pops:
            # the client asked for proof; a proof-less answer (including an
            # empty-value "does not exist") must not pass silently, or a
            # malicious primary could deny any key by stripping the proof
            # (reference light/rpc/client.go ABCIQueryWithOptions errors on
            # an empty proof)
            if prove:
                raise ProxyError(
                    -32603,
                    "primary returned no proof_ops for an abci_query with "
                    "prove=true (cannot verify the response, including "
                    "absence claims)")
            resp["verified"] = False
            return {"response": resp}
        res_height = int(resp.get("height") or 0)
        lb = self._verified(res_height + 1 if res_height else 0)
        wire = [ProofOp(p["type"], base64.b64decode(p["key"]),
                        base64.b64decode(p["data"])) for p in pops]
        key = base64.b64decode(resp.get("key") or "")
        # the proof must be about the key the CLIENT asked for, not
        # whatever key the primary chose to return: a malicious primary
        # could otherwise serve a genuine proof for a different pair
        want = bytes.fromhex(data) if data else b""
        if want and key != want:
            raise ProxyError(
                -32603,
                f"primary answered for key {key.hex()} instead of the "
                f"requested {want.hex()}")
        value = base64.b64decode(resp.get("value") or "")
        keypath = "/x:" + key.hex()
        try:
            default_proof_runtime().verify_value(
                wire, lb.signed_header.header.app_hash, keypath, value)
        except Exception as e:
            raise ProxyError(-32603, f"query proof verification failed: {e}")
        resp["verified"] = True
        return {"response": resp}
