"""ABCI socket client (reference abci/client/socket_client.go): connect a
node to an external Application process, presenting the same in-process
`Application` interface so BlockExecutor/Mempool don't care where the app
lives.  Synchronous request/response per call, one lock per connection —
calls on one client are strictly ordered (the guarantee consensus needs,
reference socket_client.go:153)."""
from __future__ import annotations

import socket
import threading
import time

from . import types as abci
from . import wire
from .server import parse_addr


class ABCIClientError(Exception):
    pass


class SocketClient(abci.Application):
    def __init__(self, addr: str, connect_timeout: float = 10.0):
        self.addr = addr
        self._lock = threading.Lock()
        self._sock = self._connect(connect_timeout)

    def _connect(self, timeout: float) -> socket.socket:
        kind, target = parse_addr(self.addr)
        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            try:
                if kind == "unix":
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.connect(target)
                else:
                    s = socket.create_connection(target, timeout=timeout)
                s.settimeout(60.0)
                return s
            except OSError as e:
                last = e
                time.sleep(0.05)
        raise ABCIClientError(f"cannot connect to app at {self.addr}: {last}")

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def _call(self, method: str, req):
        with self._lock:
            try:
                wire.write_frame(self._sock,
                                 wire.encode_request(method, req))
                frame = wire.read_frame(self._sock)
            except OSError as e:
                raise ABCIClientError(f"app connection broken: {e}")
        if frame is None:
            raise ABCIClientError("app closed the connection")
        try:
            rmethod, resp = wire.decode_response(frame)
        except ValueError as e:
            raise ABCIClientError(f"undecodable app response: {e}")
        if rmethod == "exception":
            raise ABCIClientError(str(resp))
        if rmethod != method:
            raise ABCIClientError(
                f"out-of-order response: sent {method}, got {rmethod}")
        return resp

    def echo(self, msg: str) -> str:
        return self._call("echo", msg)

    def flush(self) -> None:
        self._call("flush", None)

    # -- Application interface --------------------------------------------

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return self._call("info", req)

    def init_chain(self, req): return self._call("init_chain", req)

    def query(self, req): return self._call("query", req)

    def check_tx(self, req): return self._call("check_tx", req)

    def begin_block(self, req): return self._call("begin_block", req)

    def deliver_tx(self, tx: bytes): return self._call("deliver_tx", tx)

    def end_block(self, height: int): return self._call("end_block", height)

    def commit(self): return self._call("commit", None)

    def list_snapshots(self):
        return self._call("list_snapshots", None)

    def offer_snapshot(self, snapshot, app_hash):
        return self._call("offer_snapshot", (snapshot, app_hash))

    def load_snapshot_chunk(self, height, format_, index):
        return self._call("load_snapshot_chunk", (height, format_, index))

    def apply_snapshot_chunk(self, index, chunk, sender):
        return self._call("apply_snapshot_chunk", (index, chunk, sender))

    def prepare_proposal(self, req):
        return self._call("prepare_proposal", req)

    def process_proposal(self, req):
        return self._call("process_proposal", req)
