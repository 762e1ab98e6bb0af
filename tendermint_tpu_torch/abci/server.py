"""ABCI socket server (reference abci/server/socket_server.go): serve an
Application to an external node process over unix/tcp sockets.

Framing: uvarint length-delimited canonical proto Request/Response
(abci/wire.py; reference abci/types/messages.go WriteMessage) — the same
bytes a Go node or Go app would put on this socket, so non-Python
applications interoperate.

Requests on one connection are handled strictly in order (the reference's
per-connection ordering guarantee that consensus relies on).
"""
from __future__ import annotations

import os
import socket
import threading
from typing import Optional, Tuple

from . import types as abci
from . import wire


def parse_addr(addr: str) -> Tuple[str, object]:
    """'unix:///path' or 'tcp://host:port' (reference server.go
    NewServer)."""
    if addr.startswith("unix://"):
        return "unix", addr[len("unix://"):]
    if addr.startswith("tcp://"):
        hostport = addr[len("tcp://"):]
        host, _, port = hostport.rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    raise ValueError(f"unsupported ABCI address {addr!r}")


class ABCIServer:
    def __init__(self, app: abci.Application, addr: str):
        self.app = app
        self.addr = addr
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        # one lock across connections: the 4 AppConns multiplex one app,
        # and in-process apps are not assumed re-entrant
        self._app_lock = threading.Lock()

    def start(self):
        kind, target = parse_addr(self.addr)
        if kind == "unix":
            if os.path.exists(target):
                os.unlink(target)
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(target)
        else:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind(target)
            if target[1] == 0:
                host = target[0]
                self.addr = f"tcp://{host}:{ls.getsockname()[1]}"
        ls.listen(16)
        ls.settimeout(0.5)
        self._listener = ls
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def stop(self):
        self._stop.set()
        if self._listener is not None:
            self._listener.close()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                frame = wire.read_frame(conn)
                if frame is None:
                    return
                try:
                    method, req = wire.decode_request(frame)
                except ValueError as e:
                    wire.write_frame(conn,
                                     wire.encode_response("exception", e))
                    continue
                try:
                    with self._app_lock:
                        resp = dispatch_request(self.app, method, req)
                except Exception as e:  # noqa: BLE001 - app bug -> exception
                    wire.write_frame(conn,
                                     wire.encode_response("exception", e))
                    continue
                wire.write_frame(conn, wire.encode_response(method, resp))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()


def dispatch_request(app: abci.Application, method: str, req):
    """Apply one decoded request to the application — the per-method
    argument shapes shared by the socket and gRPC transports."""
    if method == "echo":
        return req
    if method == "flush":
        return None
    if method == "deliver_tx":
        return app.deliver_tx(req)
    if method == "end_block":
        return app.end_block(req)
    if method in ("commit", "list_snapshots"):
        return getattr(app, method)()
    if method in ("offer_snapshot", "load_snapshot_chunk",
                  "apply_snapshot_chunk"):
        return getattr(app, method)(*req)
    return getattr(app, method)(req)
