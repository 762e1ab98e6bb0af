"""HTTP + WebSocket JSON-RPC clients (reference rpc/client/http/http.go)
— the operator / light-client transport to a node's RPC server."""
from __future__ import annotations

import base64
import json
import os
import queue
import socket
import struct
import threading
import urllib.request
from typing import Optional


class RPCClientError(Exception):
    pass


class HTTPClient:
    def __init__(self, addr: str, timeout: float = 10.0):
        # accept host:port or full URL
        if not addr.startswith("http"):
            addr = "http://" + addr
        self.base = addr.rstrip("/")
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, **params):
        self._id += 1
        body = json.dumps({
            "jsonrpc": "2.0", "id": self._id, "method": method,
            "params": params}).encode()
        req = urllib.request.Request(
            self.base, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            payload = json.loads(resp.read())
        if "error" in payload:
            e = payload["error"]
            raise RPCClientError(f"{e.get('code')}: {e.get('message')}")
        return payload["result"]

    # -- typed helpers (reference rpc/client/http methods) ----------------

    def status(self):
        return self.call("status")

    def health(self):
        return self.call("health")

    def net_info(self):
        return self.call("net_info")

    def genesis(self):
        return self.call("genesis")

    def block(self, height: Optional[int] = None):
        return self.call("block", **({} if height is None
                                     else {"height": height}))

    def block_results(self, height: Optional[int] = None):
        return self.call("block_results", **({} if height is None
                                             else {"height": height}))

    def commit(self, height: Optional[int] = None):
        return self.call("commit", **({} if height is None
                                      else {"height": height}))

    def validators(self, height: Optional[int] = None, page: int = 1,
                   per_page: int = 100):
        kw = {"page": page, "per_page": per_page}
        if height is not None:
            kw["height"] = height
        return self.call("validators", **kw)

    def broadcast_tx_sync(self, tx: bytes):
        return self.call("broadcast_tx_sync",
                         tx=base64.b64encode(tx).decode())

    def broadcast_tx_async(self, tx: bytes):
        return self.call("broadcast_tx_async",
                         tx=base64.b64encode(tx).decode())

    def broadcast_tx_commit(self, tx: bytes, timeout: float = 30.0):
        return self.call("broadcast_tx_commit",
                         tx=base64.b64encode(tx).decode(), timeout=timeout)

    def abci_info(self):
        return self.call("abci_info")

    def abci_query(self, path: str = "", data: bytes = b""):
        return self.call("abci_query", path=path, data=data.hex())

    def tx(self, tx_hash: bytes):
        return self.call("tx", hash=tx_hash.hex())

    def tx_search(self, query: str, page: int = 1, per_page: int = 30):
        return self.call("tx_search", query=query, page=page,
                         per_page=per_page)


class WSClient:
    """WebSocket JSON-RPC client with event subscriptions (reference
    rpc/client/http/http.go:764 WSEvents + rpc/jsonrpc/client/ws_client):

        ws = WSClient("127.0.0.1:26657")
        sub = ws.subscribe("tm.event = 'NewBlock'")
        ev = sub.get(timeout=10)   # JSON-RPC notification params
        ws.unsubscribe("tm.event = 'NewBlock'")
        ws.close()

    RPC calls (ws.call) multiplex over the same connection.  A reader
    thread demuxes responses (by id) from event notifications (routed to
    the matching subscription's queue)."""

    def __init__(self, addr: str, timeout: float = 10.0):
        if addr.startswith("http"):
            addr = addr.split("://", 1)[1]
        host, _, port = addr.rstrip("/").rpartition(":")
        self.timeout = timeout
        self._sock = socket.create_connection((host or "127.0.0.1",
                                               int(port)), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self._sock.sendall(
            f"GET /websocket HTTP/1.1\r\nHost: {host}\r\n"
            f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise RPCClientError("websocket handshake failed: closed")
            resp += chunk
        if b"101" not in resp.split(b"\r\n", 1)[0]:
            raise RPCClientError(
                f"websocket handshake refused: {resp[:120]!r}")
        # the connect timeout must not linger: a quiet subscription (>10s
        # between events) would time out recv in the reader thread and
        # kill the client (same pattern as p2p/switch.py post-handshake)
        self._sock.settimeout(None)
        self._id = 0
        self._send_lock = threading.Lock()
        self._pending: dict = {}      # id -> Queue for the response
        self._subs: dict = {}         # query string -> Queue of events
        self._closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True, name="ws-rpc-reader")
        self._reader.start()

    # -- framing (RFC 6455; client frames are masked) ----------------------

    def _send_json(self, obj):
        payload = json.dumps(obj).encode()
        mask = os.urandom(4)
        n = len(payload)
        if n < 126:
            hdr = struct.pack("!BB", 0x81, 0x80 | n)
        elif n < 1 << 16:
            hdr = struct.pack("!BBH", 0x81, 0x80 | 126, n)
        else:
            hdr = struct.pack("!BBQ", 0x81, 0x80 | 127, n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        with self._send_lock:
            self._sock.sendall(hdr + mask + masked)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            c = self._sock.recv(n - len(buf))
            if not c:
                raise ConnectionError("websocket closed")
            buf += c
        return buf

    def _read_loop(self):
        try:
            while not self._closed.is_set():
                b1, b2 = self._recv_exact(2)
                ln = b2 & 0x7F
                if ln == 126:
                    (ln,) = struct.unpack("!H", self._recv_exact(2))
                elif ln == 127:
                    (ln,) = struct.unpack("!Q", self._recv_exact(8))
                data = self._recv_exact(ln)
                op = b1 & 0x0F
                if op == 8:       # close
                    break
                if op == 9:       # ping -> pong
                    with self._send_lock:
                        self._sock.sendall(b"\x8a\x80" + os.urandom(4))
                    continue
                if op != 1:
                    continue
                try:
                    msg = json.loads(data)
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
                self._route(msg)
        except (ConnectionError, OSError):
            pass
        finally:
            self._closed.set()
            for q in list(self._pending.values()):
                q.put(RPCClientError("websocket closed"))

    def _route(self, msg: dict):
        rid = msg.get("id")
        if rid in self._pending:
            self._pending.pop(rid).put(msg)
            return
        # event notification: route by the subscription's query
        result = msg.get("result") or {}
        qstr = result.get("query", "")
        q = self._subs.get(qstr)
        if q is not None:
            q.put(result)

    # -- API ---------------------------------------------------------------

    def call(self, method: str, **params):
        if self._closed.is_set():
            raise RPCClientError("websocket closed")
        waiter: "queue.Queue" = queue.Queue(maxsize=1)
        with self._send_lock:  # id allocation + registration are atomic
            self._id += 1
            rid = self._id
            self._pending[rid] = waiter
        self._send_json({"jsonrpc": "2.0", "id": rid, "method": method,
                         "params": params})
        try:
            msg = waiter.get(timeout=self.timeout)
        except queue.Empty:
            self._pending.pop(rid, None)
            raise RPCClientError(f"{method}: timed out")
        if isinstance(msg, Exception):
            raise msg
        if "error" in msg:
            e = msg["error"]
            raise RPCClientError(f"{e.get('code')}: {e.get('message')}")
        return msg.get("result")

    def subscribe(self, query: str) -> "queue.Queue":
        """Subscribe to a pubsub query; returns the Queue its event
        notifications land on."""
        q: "queue.Queue" = queue.Queue()
        self._subs[query] = q
        self.call("subscribe", query=query)
        return q

    def unsubscribe(self, query: str) -> None:
        self._subs.pop(query, None)
        if not self._closed.is_set():
            self.call("unsubscribe", query=query)

    def close(self):
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
