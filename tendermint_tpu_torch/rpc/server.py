"""JSON-RPC 2.0 server over HTTP (reference rpc/jsonrpc/server +
rpc/core/routes.go:10-49).

Supports POST (JSON-RPC body) and GET (/method?arg=val) like the
reference.  Handlers close over the Node.

The port's departure from the JAX package's server: the HTTP listener's
backlog is 4,096 (_HTTPServer), as Go's net.Listen takes it, where the
JAX package keeps socketserver's 5.  Every route answers the same JSON.
A launch that failed on the card under broadcast_tx_* or light_verify
(a DeviceLaneError outside a chaos drill) reaches dispatch's catch-all
and is answered -32603 "internal error", never as a CheckTx code and
never as RPC_BUSY_CODE: no code of its own is needed for that.
"""
from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl, urlparse

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.types.block import Block


class RPCError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


# 429-style overload rejection (ADR-018): the IngressGate's bounded
# admission queue is full or the caller is rate limited — the message
# carries a Retry-After hint in seconds.  Distinct from -32603 internal
# errors so load balancers / clients can back off instead of failing.
RPC_BUSY_CODE = -32011


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _parse_tx(arg) -> bytes:
    if isinstance(arg, str):
        return base64.b64decode(arg)
    raise RPCError(-32602, "tx must be base64 string")


# request-size cap (reference rpc/jsonrpc/server/http_server.go
# maxBodyBytes = 1000000)
MAX_BODY_BYTES = 1_000_000


def _int_arg(v, default=None):
    if v is None:
        return default
    return int(v)


class _HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with the listen backlog Go's net.Listen takes
    (the system's somaxconn, 4096 by default): socketserver's 5 overflows
    as soon as a client opens a few connections at once, and each dropped
    handshake ACK costs the client a retransmission timeout (>= 200 ms)."""

    request_queue_size = 4096


class RPCServer(BaseService):
    def __init__(self, node, laddr: str,
                 max_body_bytes: int = MAX_BODY_BYTES):
        super().__init__("rpc")
        self.max_body_bytes = max_body_bytes
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("rpc")
        self.node = node
        host, _, port = laddr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self.routes = {
            "health": self.health,
            "status": self.status,
            "net_info": self.net_info,
            "genesis": self.genesis,
            "blockchain": self.blockchain,
            "block": self.block,
            "block_by_hash": self.block_by_hash,
            "block_results": self.block_results,
            "commit": self.commit,
            "validators": self.validators,
            "consensus_params": self.consensus_params,
            "consensus_state": self.consensus_state,
            "unconfirmed_txs": self.unconfirmed_txs,
            "num_unconfirmed_txs": self.num_unconfirmed_txs,
            "check_tx": self.check_tx,
            "broadcast_tx_sync": self.broadcast_tx_sync,
            "broadcast_tx_async": self.broadcast_tx_async,
            "broadcast_tx_commit": self.broadcast_tx_commit,
            "abci_info": self.abci_info,
            "abci_query": self.abci_query,
            "broadcast_evidence": self.broadcast_evidence,
            "tx": self.tx,
            "tx_search": self.tx_search,
            "block_search": self.block_search,
            "light_block": self.light_block,
            "block_proto": self.block_proto,
            "dump_consensus_state": self.dump_consensus_state,
            "genesis_chunked": self.genesis_chunked,
        }
        if getattr(getattr(node, "config", None), "rpc", None) is not None \
                and getattr(node.config.rpc, "unsafe", False):
            # reference rpc/core/routes.go AddUnsafeRoutes (--rpc.unsafe)
            self.routes["dial_seeds"] = self.dial_seeds
            self.routes["dial_peers"] = self.dial_peers
        # light-client serving plane (light/service.py, ADR-026):
        # thin parse/encode shims over the node's LightServe; overload
        # maps to the same RPC_BUSY_CODE class as mempool admission
        from tendermint_tpu_torch.rpc import light as light_rpc
        light_rpc.register(self)

    # -- lifecycle ---------------------------------------------------------

    def on_start(self):
        server = self

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
                # request-size cap (reference rpc/jsonrpc/server
                # http_server.go maxBodyBytes = 1MB)
                if n > server.max_body_bytes:
                    self._reply(server._err(
                        None, -32600,
                        f"request body too large (> {server.max_body_bytes})"))
                    return
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("request must be an object")
                except (json.JSONDecodeError, UnicodeDecodeError,
                        ValueError):
                    self._reply(server._err(None, -32700, "parse error"))
                    return
                self._reply(server.dispatch(req.get("method", ""),
                                            req.get("params") or {},
                                            req.get("id", -1)))

            def do_GET(self):
                u = urlparse(self.path)
                method = u.path.strip("/")
                if method == "websocket" and \
                        "websocket" in (self.headers.get("Upgrade", "")
                                        .lower()):
                    server._serve_websocket(self)
                    return
                if method == "metrics":
                    # Prometheus text exposition (reference serves this on
                    # a dedicated Instrumentation listener,
                    # node/node.go:959-962)
                    from tendermint_tpu_torch.libs.metrics import DEFAULT
                    body = DEFAULT.render_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                params = {}
                for k, v in parse_qsl(u.query):
                    if v in ("true", "false"):
                        params[k] = v == "true"
                    elif v and v[0] in '["{':
                        try:
                            params[k] = json.loads(v)
                        except json.JSONDecodeError:
                            self._reply(server._err(
                                -1, -32602, f"malformed param {k}={v!r}"))
                            return
                    else:
                        params[k] = v
                if method == "":
                    self._reply({"jsonrpc": "2.0", "id": -1, "result": {
                        "routes": sorted(server.routes)}})
                    return
                self._reply(server.dispatch(method, params, -1))

        self._httpd = _HTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port  # resolve port 0
        self.spawn(self._httpd.serve_forever, name="rpc-http")
        self.log.info("RPC server listening", laddr=self.laddr)

    def on_stop(self):
        self.log.info("RPC server stopping")
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    @property
    def laddr(self) -> str:
        return f"{self.host}:{self.port}"

    # -- websocket subscriptions (reference rpc/jsonrpc/server/ws_handler
    # + rpc/core/events.go Subscribe/Unsubscribe) --------------------------

    def _serve_websocket(self, handler):
        import base64 as _b64
        import hashlib
        import struct

        sock = handler.connection
        key = handler.headers.get("Sec-WebSocket-Key", "")
        accept = _b64.b64encode(hashlib.sha1(
            (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode())
            .digest()).decode()
        handler.wfile.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: " + accept.encode() + b"\r\n\r\n")
        handler.wfile.flush()

        send_lock = threading.Lock()

        def send_text(text: str):
            payload = text.encode()
            n = len(payload)
            if n < 126:
                hdr = struct.pack("!BB", 0x81, n)
            elif n < 1 << 16:
                hdr = struct.pack("!BBH", 0x81, 126, n)
            else:
                hdr = struct.pack("!BBQ", 0x81, 127, n)
            with send_lock:
                sock.sendall(hdr + payload)

        def recv_exact(n):
            # handler.rfile is buffered: frame bytes pipelined with the
            # upgrade request may already sit in its buffer, so a raw
            # sock.recv would hang forever waiting for them
            buf = handler.rfile.read(n)
            if buf is None or len(buf) < n:
                raise ConnectionError("ws closed")
            return buf

        def recv_frame():
            b1, b2 = recv_exact(2)
            opcode = b1 & 0x0F
            masked = b2 & 0x80
            ln = b2 & 0x7F
            if ln == 126:
                (ln,) = struct.unpack("!H", recv_exact(2))
            elif ln == 127:
                (ln,) = struct.unpack("!Q", recv_exact(8))
            if opcode >= 8 and ln > 125:
                raise ConnectionError("ws control frame too large")
            if ln > 1 << 20:
                raise ConnectionError("ws frame too large")
            mask = recv_exact(4) if masked else b"\x00" * 4
            data = bytearray(recv_exact(ln))
            for i in range(ln):
                data[i] ^= mask[i % 4]
            return opcode, bytes(data)

        # per-connection subscriptions: query string -> (Query, bus sub)
        from tendermint_tpu_torch.libs.pubsub_query import Query, QueryError
        subs = {}
        stop = threading.Event()

        def pump():
            """Deliver matching events as JSON-RPC notifications shaped
            like the reference's #event responses."""
            import queue as _q
            while not stop.is_set():
                delivered = False
                for qstr, (query, sub) in list(subs.items()):
                    try:
                        ev = sub.queue.get_nowait()
                    except _q.Empty:
                        continue
                    if not query.matches(self._event_terms(ev)):
                        continue
                    delivered = True
                    try:
                        send_text(json.dumps({
                            "jsonrpc": "2.0", "id": "0#event",
                            "result": {
                                "query": qstr,
                                "data": {
                                    "type": f"tendermint/event/{ev.type}",
                                    "value": self._event_json(ev)}}}))
                    except OSError:
                        stop.set()
                        return
                if not delivered:
                    stop.wait(0.05)

        pump_thread = threading.Thread(target=pump, daemon=True)
        pump_thread.start()
        try:
            while not stop.is_set():
                opcode, data = recv_frame()
                if opcode == 8:  # close
                    break
                if opcode == 9:  # ping -> pong
                    with send_lock:
                        sock.sendall(b"\x8a" + bytes([len(data)]) + data)
                    continue
                if opcode != 1:
                    continue
                try:
                    req = json.loads(data)
                except (json.JSONDecodeError, UnicodeDecodeError):
                    send_text(json.dumps(self._err(None, -32700,
                                                   "parse error")))
                    continue
                rid = req.get("id", -1)
                method = req.get("method", "")
                params = req.get("params") or {}
                if method == "subscribe":
                    qstr = params.get("query", "")
                    try:
                        query = Query(qstr)
                    except QueryError as e:
                        send_text(json.dumps(self._err(rid, -32602,
                                                       str(e))))
                        continue
                    stale = subs.pop(qstr, None)
                    if stale is not None:  # re-subscribe: drop the old sub
                        self.node.event_bus.unsubscribe(stale[1])
                    sub = self.node.event_bus.subscribe()
                    subs[qstr] = (query, sub)
                    send_text(json.dumps({"jsonrpc": "2.0", "id": rid,
                                          "result": {}}))
                elif method == "unsubscribe":
                    qstr = params.get("query", "")
                    entry = subs.pop(qstr, None)
                    if entry is not None:
                        self.node.event_bus.unsubscribe(entry[1])
                    send_text(json.dumps({"jsonrpc": "2.0", "id": rid,
                                          "result": {}}))
                elif method == "unsubscribe_all":
                    for _, sub in subs.values():
                        self.node.event_bus.unsubscribe(sub)
                    subs.clear()
                    send_text(json.dumps({"jsonrpc": "2.0", "id": rid,
                                          "result": {}}))
                else:
                    send_text(json.dumps(self.dispatch(method, params,
                                                       rid)))
        except (ConnectionError, OSError):
            pass
        finally:
            stop.set()
            for _, sub in subs.values():
                self.node.event_bus.unsubscribe(sub)
            handler.close_connection = True

    def _event_terms(self, ev) -> dict:
        """Composite query terms for an event: tm.event plus attributes,
        plus app event attributes for Tx results (reference
        libs/pubsub/query semantics, e.g. tx.height / app.creator)."""
        terms = {"tm.event": [ev.type]}
        for k, v in (ev.attributes or {}).items():
            terms.setdefault(f"tm.{k}", []).append(str(v))
        data = ev.data or {}
        if isinstance(data, dict):
            if "height" in (ev.attributes or {}):
                terms.setdefault("tx.height" if ev.type == "Tx"
                                 else "block.height",
                                 []).append(ev.attributes["height"])
            res = data.get("result")
            for app_ev in (getattr(res, "events", None) or []):
                for k, v in (getattr(app_ev, "attributes", None)
                             or {}).items():
                    terms.setdefault(
                        f"{getattr(app_ev, 'type', '')}.{k}",
                        []).append(str(v))
        return terms

    def _event_json(self, ev) -> dict:
        """Shallow JSON projection of event data."""
        data = ev.data or {}
        if not isinstance(data, dict):
            return {"repr": str(data)}
        out = {}
        for k, v in data.items():
            if isinstance(v, (int, str, bool, float)) or v is None:
                out[k] = v
            elif isinstance(v, bytes):
                out[k] = _b64(v)
            elif k == "block":
                out["height"] = v.header.height
                out["hash"] = v.hash().hex().upper()
                out["num_txs"] = len(v.data.txs)
            elif k == "result":
                out["code"] = getattr(v, "code", 0)
                out["log"] = getattr(v, "log", "")
            else:
                out[k] = str(v)
        return out

    # -- dispatch ----------------------------------------------------------

    def _err(self, rid, code, message):
        return {"jsonrpc": "2.0", "id": rid,
                "error": {"code": code, "message": message}}

    def dispatch(self, method: str, params: dict, rid):
        fn = self.routes.get(method)
        if fn is None:
            return self._err(rid, -32601, f"unknown method {method!r}")
        try:
            result = fn(**params) if isinstance(params, dict) else fn(*params)
            return {"jsonrpc": "2.0", "id": rid, "result": result}
        except RPCError as e:
            return self._err(rid, e.code, str(e))
        except TypeError as e:
            return self._err(rid, -32602, f"invalid params: {e}")
        except Exception as e:
            return self._err(rid, -32603, f"internal error: {e}")

    # -- handlers (reference rpc/core/*.go) --------------------------------

    def health(self):
        return {}

    def status(self):
        return self.node.status()

    def net_info(self):
        sw = self.node.switch
        peers = [{
            "node_info": {"id": p.node_info.node_id,
                          "listen_addr": p.node_info.listen_addr,
                          "moniker": p.node_info.moniker},
            "is_outbound": p.outbound,
        } for p in sw.peers.values()]
        return {"listening": True, "listeners": [sw.actual_listen_addr()],
                "n_peers": len(peers), "peers": peers}

    def genesis(self):
        return {"genesis": json.loads(self.node.genesis.to_json())}

    def blockchain(self, minHeight=None, maxHeight=None):
        """Reference rpc/core/blocks.go BlockchainInfo: metas for a height
        range, newest first, max 20."""
        store = self.node.block_store
        max_h = min(_int_arg(maxHeight, store.height()) or store.height(),
                    store.height())
        min_h = max(_int_arg(minHeight, 1) or 1, store.base())
        min_h = max(min_h, max_h - 19)
        metas = []
        for h in range(max_h, min_h - 1, -1):
            m = store.load_block_meta(h)
            if m is not None:
                metas.append(self._meta_json(m))
        return {"last_height": store.height(), "block_metas": metas}

    def block(self, height=None):
        h = _int_arg(height, self.node.block_store.height())
        block = self.node.block_store.load_block(h)
        if block is None:
            raise RPCError(-32603, f"no block at height {h}")
        meta = self.node.block_store.load_block_meta(h)
        return {"block_id": self._bid_json(meta.block_id),
                "block": self._block_json(block)}

    def block_by_hash(self, hash=None):
        want = bytes.fromhex(hash) if hash else b""
        h = self.node.block_store.height_by_hash(want)
        if h is None:
            raise RPCError(-32603, "block not found")
        return self.block(h)

    def block_results(self, height=None):
        h = _int_arg(height, self.node.block_store.height())
        resp = self.node.state_store.load_abci_responses(h)
        if resp is None:
            raise RPCError(-32603, f"no results for height {h}")
        return {
            "height": h,
            "txs_results": [{"code": r.code, "data": _b64(r.data or b""),
                             "log": r.log,
                             "gas_used": getattr(r, "gas_used", 0)}
                            for r in (resp.deliver_txs or [])],
            "validator_updates": [
                {"pub_key_type": u.pub_key_type,
                 "pub_key": _b64(u.pub_key_bytes), "power": u.power}
                for u in (resp.end_block.validator_updates
                          if resp.end_block else [])],
        }

    def commit(self, height=None):
        store = self.node.block_store
        h = _int_arg(height, store.height())
        meta = store.load_block_meta(h)
        if meta is None:
            raise RPCError(-32603, f"no commit for height {h}")
        canonical = h < store.height()
        com = store.load_block_commit(h) if canonical \
            else store.load_seen_commit(h)
        return {"signed_header": {
            "header": self._header_json(meta.header),
            "commit": self._commit_json(com)},
            "canonical": canonical}

    def validators(self, height=None, page=None, per_page=None):
        h = _int_arg(height, self.node.block_store.height())
        vals = self.node.state_store.load_validators(h)
        if vals is None:
            raise RPCError(-32603, f"no validators for height {h}")
        per = min(_int_arg(per_page, 30) or 30, 100)
        pg = max(_int_arg(page, 1) or 1, 1)
        chunk = vals.validators[(pg - 1) * per: pg * per]
        return {"block_height": str(h),
                "validators": [self._val_json(v) for v in chunk],
                "count": str(len(chunk)), "total": str(vals.size())}

    def consensus_params(self, height=None):
        h = _int_arg(height, self.node.block_store.height())
        p = self.node.state.consensus_params
        return {"block_height": h, "consensus_params": {
            "block": {"max_bytes": p.block.max_bytes,
                      "max_gas": p.block.max_gas},
            "evidence": {
                "max_age_num_blocks": p.evidence.max_age_num_blocks,
                "max_age_duration":
                    p.evidence.max_age_duration_seconds * 10**9,
                "max_bytes": p.evidence.max_bytes},
            "validator": {"pub_key_types": p.validator.pub_key_types},
        }}

    def consensus_state(self):
        rs = self.node.consensus.get_round_state()
        return {"round_state": {
            "height": rs.height, "round": rs.round, "step": int(rs.step),
        }}

    def dump_consensus_state(self):
        """Full round state + per-peer round states (reference
        rpc/core/consensus.go DumpConsensusState)."""
        cs = self.node.consensus
        with cs._mtx:
            rs = cs.rs
            votes = rs.votes
            out_rs = {
                "height": rs.height, "round": rs.round,
                "step": int(rs.step),
                "proposal": rs.proposal is not None,
                "proposal_block_hash": (
                    rs.proposal_block.hash().hex().upper()
                    if rs.proposal_block is not None else ""),
                "locked_round": rs.locked_round,
                "locked_block_hash": (
                    rs.locked_block.hash().hex().upper()
                    if rs.locked_block is not None else ""),
                "valid_round": rs.valid_round,
                "commit_round": rs.commit_round,
                "validators": {
                    "total_voting_power":
                        rs.validators.total_voting_power()
                        if rs.validators else 0,
                    "count": rs.validators.size() if rs.validators else 0,
                },
            }
            if votes is not None:
                out_rs["votes"] = [{
                    "round": r,
                    "prevotes": str(votes.prevotes(r).bit_array()),
                    "precommits": str(votes.precommits(r).bit_array()),
                } for r in range(rs.round + 1)]
        peers = []
        reactor = getattr(self.node, "consensus_reactor", None)
        if reactor is not None:
            with reactor._lock:
                for pid, ps in reactor._peer_state.items():
                    peers.append({
                        "node_address": pid,
                        "peer_state": {
                            "height": ps.step.height,
                            "round": ps.step.round,
                            "step": ps.step.step,
                            "prevotes": (str(ps.prevotes)
                                         if ps.prevotes else ""),
                            "precommits": (str(ps.precommits)
                                           if ps.precommits else ""),
                        }})
        return {"round_state": out_rs, "peers": peers}

    GENESIS_CHUNK_SIZE = 16 * 1024 * 1024  # reference rpc/core/net.go
    _genesis_bytes = None  # serialized once (the doc is immutable)

    def genesis_chunked(self, chunk=None):
        """Reference rpc/core/net.go GenesisChunked: base64 16MB chunks
        for genesis docs too large for one response (serialized once —
        the route exists for LARGE docs, so per-request re-serialization
        would be O(size) per chunk)."""
        if self._genesis_bytes is None:
            self._genesis_bytes = self.node.genesis.to_json().encode()
        data = self._genesis_bytes
        nchunks = max(1, -(-len(data) // self.GENESIS_CHUNK_SIZE))
        i = _int_arg(chunk, 0) or 0
        if not 0 <= i < nchunks:
            raise RPCError(
                -32603,
                f"there are {nchunks} chunks, you asked for {i}")
        part = data[i * self.GENESIS_CHUNK_SIZE:
                    (i + 1) * self.GENESIS_CHUNK_SIZE]
        return {"chunk": i, "total": nchunks, "data": _b64(part)}

    def dial_seeds(self, seeds=None):
        """UNSAFE (rpc.unsafe config): crawl the given seeds
        (reference rpc/core/net.go UnsafeDialSeeds)."""
        if not seeds:
            raise RPCError(-32602, "no seeds provided")
        pex = getattr(self.node, "pex_reactor", None)
        if pex is None:
            raise RPCError(-32603, "pex reactor is not running")
        pex.seeds.extend(s for s in seeds if s not in pex.seeds)

        def dial():
            for s in seeds:
                peer = self.node.switch.dial_peer(s)
                if peer is not None:
                    pex._request_addrs(peer)
        # async: each dead address costs a ~10s connect timeout, which
        # would hold the HTTP request open (reference DialSeeds is async)
        threading.Thread(target=dial, daemon=True,
                         name="rpc-dial-seeds").start()
        return {"log": f"dialing seeds: {seeds}"}

    def dial_peers(self, peers=None, persistent=None, unconditional=None,
                   private=None):
        """UNSAFE (rpc.unsafe config): dial the given peers (reference
        rpc/core/net.go UnsafeDialPeers)."""
        if not peers:
            raise RPCError(-32602, "no peers provided")

        def dial():
            for p in peers:
                self.node.switch.dial_peer(p, persistent=bool(persistent))
        threading.Thread(target=dial, daemon=True,
                         name="rpc-dial-peers").start()
        return {"log": f"dialing peers: {peers}"}

    def unconfirmed_txs(self, limit=None):
        n = _int_arg(limit, 30) or 30
        txs = self.node.mempool.reap_max_txs(n)
        return {"n_txs": len(txs), "total": self.node.mempool.size(),
                "txs": [_b64(t) for t in txs]}

    def num_unconfirmed_txs(self):
        return {"n_txs": self.node.mempool.size(),
                "total": self.node.mempool.size()}

    def check_tx(self, tx=None):
        """App-only check without admitting to the mempool
        (reference rpc/core/abci.go CheckTx)."""
        from tendermint_tpu_torch.abci.types import RequestCheckTx
        r = self.node.app.check_tx(RequestCheckTx(tx=_parse_tx(tx)))
        return {"code": r.code, "data": _b64(r.data or b""), "log": r.log}

    def _gate(self):
        """The node's IngressGate, iff running (ADR-018)."""
        g = getattr(self.node, "ingress_gate", None)
        return g if g is not None and g.is_running() else None

    @staticmethod
    def _busy_error(retry_after_s) -> RPCError:
        ms = int(max(0.0, retry_after_s or 1.0) * 1000)
        return RPCError(RPC_BUSY_CODE,
                        f"mempool is busy: retry after {ms} ms")

    def _admit_tx(self, raw: bytes):
        """Admission through the IngressGate when present: overload
        (queue full / rate limited / verify shed) surfaces as a
        429-style RPCError with a Retry-After hint instead of holding
        the HTTP thread on a blocking app call.  Without a gate this
        is exactly the old synchronous mempool.check_tx."""
        g = self._gate()
        if g is None:
            return self.node.mempool.check_tx(raw)
        fut = g.submit(raw, source="rpc")
        try:
            r = fut.result(timeout=10.0)
        except TimeoutError:
            # queue is moving but not fast enough for this caller:
            # same retryable overload class as a full queue
            raise self._busy_error(g.retry_after_s())
        if fut.retry_after_s is not None:
            raise self._busy_error(fut.retry_after_s)
        return r

    def broadcast_tx_async(self, tx=None):
        raw = _parse_tx(tx)
        from tendermint_tpu_torch.types.block import tx_hash
        g = self._gate()
        if g is None:
            threading.Thread(target=self._add_tx, args=(raw,),
                             daemon=True).start()
        else:
            fut = g.submit(raw, source="rpc")
            # fire-and-forget EXCEPT overload: an immediately-settled
            # busy/ratelimit rejection means the tx was never queued —
            # silently returning a hash would lie to the client
            if fut.done() and fut.retry_after_s is not None:
                raise self._busy_error(fut.retry_after_s)
        return {"code": 0, "data": "", "log": "",
                "hash": tx_hash(raw).hex().upper()}

    def broadcast_tx_sync(self, tx=None):
        raw = _parse_tx(tx)
        from tendermint_tpu_torch.types.block import tx_hash
        r = self._admit_tx(raw)
        return {"code": r.code, "data": _b64(r.data or b""), "log": r.log,
                "hash": tx_hash(raw).hex().upper()}

    def broadcast_tx_commit_raw(self, raw: bytes, timeout=30.0):
        """Reference rpc/core/mempool.go:52: add to mempool, wait for the
        tx to land in a committed block via the event bus.  Returns the
        full ABCI response objects (check_tx, deliver_tx, height) so both
        the JSON route and the gRPC BroadcastAPI can surface every field
        (data, gas, events, codespace) the reference returns."""
        from tendermint_tpu_torch.abci.types import ResponseDeliverTx
        sub = self.node.event_bus.subscribe("Tx") \
            if self.node.event_bus else None
        try:
            r = self._admit_tx(raw)
            if not r.is_ok():
                return r, None, 0
            import queue as _q
            import time as _t
            deadline = _t.monotonic() + float(timeout)
            while sub is not None and _t.monotonic() < deadline:
                try:
                    ev = sub.queue.get(timeout=0.25)
                except _q.Empty:
                    continue
                data = ev.data or {}
                if data.get("tx") == raw:
                    res = data.get("result") or ResponseDeliverTx()
                    return r, res, data.get("height", 0)
            raise RPCError(-32603,
                           "timed out waiting for tx to be committed")
        finally:
            if sub is not None:
                self.node.event_bus.unsubscribe(sub)

    @staticmethod
    def _tx_result_json(res) -> dict:
        """Full ResponseCheckTx/ResponseDeliverTx projection (reference
        rpc/core/types ResultBroadcastTxCommit JSON shape)."""
        if res is None:
            return {}
        return {
            "code": res.code,
            "data": _b64(res.data or b""),
            "log": res.log,
            "gas_wanted": str(getattr(res, "gas_wanted", 0)),
            "gas_used": str(getattr(res, "gas_used", 0)),
            "events": [{"type": getattr(e, "type", ""),
                        "attributes": dict(getattr(e, "attributes", None)
                                           or {})}
                       for e in (getattr(res, "events", None) or [])],
            "codespace": getattr(res, "codespace", ""),
        }

    def broadcast_tx_commit(self, tx=None, timeout=30.0):
        raw = _parse_tx(tx)
        from tendermint_tpu_torch.types.block import tx_hash
        th = tx_hash(raw)
        ct, dt, height = self.broadcast_tx_commit_raw(raw, timeout)
        return {"check_tx": self._tx_result_json(ct),
                "deliver_tx": self._tx_result_json(dt),
                "hash": th.hex().upper(), "height": height}

    def abci_info(self):
        from tendermint_tpu_torch.abci.types import RequestInfo
        r = self.node.app.info(RequestInfo())
        return {"response": {
            "data": getattr(r, "data", ""),
            "last_block_height": getattr(r, "last_block_height", 0),
            "last_block_app_hash":
                _b64(getattr(r, "last_block_app_hash", b"") or b"")}}

    def abci_query(self, path="", data="", height=None, prove=False):
        from tendermint_tpu_torch.abci.types import RequestQuery
        raw = bytes.fromhex(data) if data else b""
        r = self.node.app.query(RequestQuery(
            data=raw, path=path, height=_int_arg(height, 0) or 0,
            prove=bool(prove)))
        return {"response": {
            "code": r.code, "log": r.log, "key": _b64(r.key or b""),
            "value": _b64(r.value or b""), "height": r.height,
            "proof_ops": [{"type": t, "key": _b64(k), "data": _b64(d)}
                          for (t, k, d) in
                          (getattr(r, "proof_ops", None) or [])]}}

    def light_block(self, height=None):
        """Canonical-proto light block for light-client providers
        (reference light/provider/http fetches signed header + validator
        set over RPC; here both ride one call as canonical bytes so the
        provider verifies exactly what consensus signed)."""
        from tendermint_tpu_torch.types.light_block import SignedHeader

        store = self.node.block_store
        h = _int_arg(height, store.height())
        meta = store.load_block_meta(h)
        vals = self.node.state_store.load_validators(h)
        if meta is None or vals is None:
            raise RPCError(-32603, f"no light block at height {h}")
        canonical = h < store.height()
        com = store.load_block_commit(h) if canonical \
            else store.load_seen_commit(h)
        if com is None:
            raise RPCError(-32603, f"no commit at height {h}")
        sh = SignedHeader(meta.header, com)
        return {"height": h,
                "signed_header": _b64(sh.proto()),
                "validator_set": _b64(vals.proto())}

    def block_proto(self, height=None):
        """Canonical-proto block bytes (hash-verifiable against a light
        client's verified header)."""
        h = _int_arg(height, self.node.block_store.height())
        block = self.node.block_store.load_block(h)
        if block is None:
            raise RPCError(-32603, f"no block at height {h}")
        return {"height": h, "block": _b64(block.proto())}

    def broadcast_evidence(self, evidence=None):
        from tendermint_tpu_torch.types.evidence import evidence_from_proto
        ev = evidence_from_proto(base64.b64decode(evidence))
        self.node.evidence_pool.add_evidence(ev)
        return {"hash": ev.hash().hex().upper()}

    def tx(self, hash=None, prove=False):
        indexer = getattr(self.node, "tx_indexer", None)
        if indexer is None:
            raise RPCError(-32603, "tx indexing is disabled")
        res = indexer.get(bytes.fromhex(hash))
        if res is None:
            raise RPCError(-32603, f"tx {hash} not found")
        return res

    def tx_search(self, query="", prove=False, page=None, per_page=None,
                  order_by=""):
        indexer = getattr(self.node, "tx_indexer", None)
        if indexer is None:
            raise RPCError(-32603, "tx indexing is disabled")
        return indexer.search(query, _int_arg(page, 1) or 1,
                              _int_arg(per_page, 30) or 30)

    def block_search(self, query="", page=None, per_page=None, order_by=""):
        indexer = getattr(self.node, "block_indexer", None)
        if indexer is None:
            raise RPCError(-32603, "block indexing is disabled")
        return indexer.search(query, _int_arg(page, 1) or 1,
                              _int_arg(per_page, 30) or 30)

    # -- json shaping ------------------------------------------------------

    def _add_tx(self, raw):
        try:
            self.node.mempool.check_tx(raw)
        except Exception:
            pass

    def _bid_json(self, bid):
        return {"hash": bid.hash.hex().upper(),
                "parts": {"total": bid.part_set_header.total,
                          "hash": bid.part_set_header.hash.hex().upper()}}

    def _header_json(self, h):
        # amino-JSON dialect (libs/amino_json): int64 -> string, time ->
        # RFC3339, so reference clients parse the response unchanged
        from tendermint_tpu_torch.libs import amino_json as aj
        return {
            "version": {"block": str(h.version.block),
                        "app": str(h.version.app)},
            "chain_id": h.chain_id, "height": str(h.height),
            "time": aj.ts_rfc3339(h.time),
            "last_block_id": self._bid_json(h.last_block_id),
            "last_commit_hash": h.last_commit_hash.hex().upper(),
            "data_hash": h.data_hash.hex().upper(),
            "validators_hash": h.validators_hash.hex().upper(),
            "next_validators_hash": h.next_validators_hash.hex().upper(),
            "consensus_hash": h.consensus_hash.hex().upper(),
            "app_hash": h.app_hash.hex().upper(),
            "last_results_hash": h.last_results_hash.hex().upper(),
            "evidence_hash": h.evidence_hash.hex().upper(),
            "proposer_address": h.proposer_address.hex().upper(),
        }

    def _commit_json(self, c):
        from tendermint_tpu_torch.libs import amino_json as aj
        if c is None:
            return None
        return {
            "height": str(c.height), "round": c.round,
            "block_id": self._bid_json(c.block_id),
            "signatures": [{
                "block_id_flag": int(s.block_id_flag),
                "validator_address": s.validator_address.hex().upper(),
                "timestamp": aj.ts_rfc3339(s.timestamp),
                "signature": _b64(s.signature or b""),
            } for s in c.signatures],
        }

    def _vset_json(self, vs):
        from tendermint_tpu_torch.libs import amino_json as aj
        prop = vs.get_proposer()
        return {"validators": [aj.validator_json(v)
                               for v in vs.validators],
                "proposer": aj.validator_json(prop) if prop else None}

    def _block_json(self, b: Block):
        from tendermint_tpu_torch.libs import amino_json as aj
        return {"header": self._header_json(b.header),
                "data": {"txs": [_b64(t) for t in b.data.txs]},
                # tagged amino-JSON evidence (reference
                # types/evidence.go:529 RegisterType)
                "evidence": {"evidence": [
                    aj.evidence_json(ev, self._header_json,
                                     self._commit_json, self._vset_json)
                    for ev in b.evidence]},
                "last_commit": self._commit_json(b.last_commit)}

    def _meta_json(self, m):
        return {"block_id": self._bid_json(m.block_id),
                "block_size": m.block_size,
                "header": self._header_json(m.header),
                "num_txs": m.num_txs}

    def _val_json(self, v):
        from tendermint_tpu_torch.libs import amino_json as aj
        return aj.validator_json(v)
