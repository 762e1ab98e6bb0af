"""Peer, Reactor, Switch and transport (reference p2p/switch.go:158,
p2p/peer.go, p2p/transport.go, p2p/base_reactor.go).

The Switch owns the listener/dialer, authenticates peers over
SecretConnection, exchanges NodeInfo, wires each peer's MConnection
channels to the registered reactors, and handles reconnection to
persistent peers with exponential backoff.
"""
from __future__ import annotations

import random
import socket
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from . import wire
from .connection import ChannelDescriptor, MConnection
from .key import NodeKey
from .secret_connection import SecretConnection
from tendermint_tpu_torch.libs.service import BaseService


# protocol versions (reference version/version.go:18-24)
P2P_PROTOCOL = 8
BLOCK_PROTOCOL = 11


@dataclass
class NodeInfo:
    node_id: str
    listen_addr: str
    network: str           # chain id
    version: str
    channels: bytes        # supported channel ids
    moniker: str = ""
    protocol_p2p: int = P2P_PROTOCOL
    protocol_block: int = BLOCK_PROTOCOL
    protocol_app: int = 0
    tx_index: str = "on"
    rpc_address: str = ""

    def to_bytes(self) -> bytes:
        """tendermint.p2p.DefaultNodeInfo proto body (p2p/types.proto):
        protocol_version=1{p2p=1,block=2,app=3}, default_node_id=2,
        listen_addr=3, network=4, version=5, channels=6, moniker=7,
        other=8{tx_index=1, rpc_address=2}."""
        from tendermint_tpu_torch.libs import protoenc as pe
        pv = (pe.varint_field(1, self.protocol_p2p)
              + pe.varint_field(2, self.protocol_block)
              + pe.varint_field(3, self.protocol_app))
        other = (pe.string_field(1, self.tx_index)
                 + pe.string_field(2, self.rpc_address))
        return (pe.message_field_always(1, pv)
                + pe.string_field(2, self.node_id)
                + pe.string_field(3, self.listen_addr)
                + pe.string_field(4, self.network)
                + pe.string_field(5, self.version)
                + pe.bytes_field(6, self.channels)
                + pe.string_field(7, self.moniker)
                + pe.message_field_always(8, other))

    @classmethod
    def from_bytes(cls, data: bytes) -> "NodeInfo":
        from tendermint_tpu_torch.libs import protodec as pd
        f = pd.parse(data)
        pv = pd.parse(pd.get_message(f, 1) or b"")
        other = pd.parse(pd.get_message(f, 8) or b"")
        return cls(node_id=pd.get_string(f, 2),
                   listen_addr=pd.get_string(f, 3),
                   network=pd.get_string(f, 4),
                   version=pd.get_string(f, 5),
                   channels=pd.get_bytes(f, 6),
                   moniker=pd.get_string(f, 7),
                   protocol_p2p=pd.get_uint(pv, 1),
                   protocol_block=pd.get_uint(pv, 2),
                   protocol_app=pd.get_uint(pv, 3),
                   tx_index=pd.get_string(other, 1),
                   rpc_address=pd.get_string(other, 2))

    def compatible_with(self, other: "NodeInfo") -> Optional[str]:
        """None when compatible, else the reason (reference
        p2p/node_info.go:179 CompatibleWith): same block protocol, same
        network, and at least one common channel."""
        if self.protocol_block != other.protocol_block:
            return (f"peer is on a different Block version: "
                    f"{other.protocol_block} != {self.protocol_block}")
        if self.network != other.network:
            return (f"peer is on a different network: "
                    f"{other.network!r} != {self.network!r}")
        if not self.channels:
            return None  # no channels = just testing
        if not set(self.channels) & set(other.channels):
            return (f"no common channels: ours "
                    f"{self.channels.hex()}, theirs "
                    f"{other.channels.hex()}")
        return None


class Reactor(BaseService):
    """Base reactor (reference p2p/base_reactor.go BaseReactor: embeds
    BaseService).  Subclasses register channels and react to peer
    lifecycle + messages; long-lived routines go in on_start via spawn
    and watch self.quitting.  The owning Switch starts/stops reactors
    (reference p2p/switch.go:226-239 OnStart / OnStop)."""

    def __init__(self, name: str):
        super().__init__(name)
        self.switch: Optional["Switch"] = None

    def get_channels(self) -> List[ChannelDescriptor]:
        return []

    def add_peer(self, peer: "Peer"):
        pass

    def remove_peer(self, peer: "Peer", reason):
        pass

    def receive(self, ch_id: int, peer: "Peer", msg_bytes: bytes):
        pass


class Peer:
    def __init__(self, node_info: NodeInfo, mconn: MConnection,
                 outbound: bool, persistent: bool = False):
        self.node_info = node_info
        self.mconn = mconn
        self.outbound = outbound
        self.persistent = persistent
        self.data: Dict[str, object] = {}

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def send(self, ch_id: int, msg) -> bool:
        return self.mconn.send(ch_id, wire.encode(ch_id, msg))

    def try_send(self, ch_id: int, msg) -> bool:
        return self.mconn.try_send(ch_id, wire.encode(ch_id, msg))

    def stop(self):
        self.mconn.stop()


class Switch(BaseService):
    # persistent-peer reconnect schedule: exponential backoff from BASE
    # to MAX with multiplicative jitter in [0.5, 1.5) so a whole mesh
    # restarting never re-dials in lockstep (reference p2p/switch.go
    # reconnectToPeer's randomized backoff)
    RECONNECT_BASE_S = 1.0
    RECONNECT_MAX_S = 60.0

    def __init__(self, node_key: NodeKey, listen_addr: str, network: str,
                 moniker: str = "", version: str = "0.1.0",
                 metrics_registry=None, p2p_config=None, transport=None):
        super().__init__("switch")
        # in-memory transport seam (the JAX package's networks/vnet.py,
        # ADR-019; the port has no implementation of it yet): when
        # set, the switch never touches sockets — listen registers with
        # the virtual network and dials route through transport.dial,
        # which lands back in _register_peer like a TCP handshake
        self._transport = transport
        # operator knobs (reference config/config.go P2PConfig); None
        # keeps the defaults for direct construction in tests
        self._send_rate = getattr(p2p_config, "send_rate", 5_120_000)
        self._recv_rate = getattr(p2p_config, "recv_rate", 5_120_000)
        self._dial_timeout = getattr(p2p_config, "dial_timeout_s", 10.0)
        self._handshake_timeout = getattr(p2p_config,
                                          "handshake_timeout_s", 10.0)
        from tendermint_tpu_torch.libs import log as tmlog
        from tendermint_tpu_torch.libs.metrics import P2PMetrics
        self.log = tmlog.logger("p2p").with_(moniker=moniker) if moniker \
            else tmlog.logger("p2p")
        self._metrics = P2PMetrics(metrics_registry)
        self.node_key = node_key
        self.listen_addr = listen_addr
        self.network = network
        self.moniker = moniker
        self.version = version
        self.reactors: Dict[str, Reactor] = {}
        self._chan_to_reactor: Dict[int, Reactor] = {}
        self._descriptors: List[ChannelDescriptor] = []
        self.peers: Dict[str, Peer] = {}
        self._lock = threading.RLock()
        self._listener: Optional[socket.socket] = None
        self._reconnecting: set = set()
        self.max_peers = getattr(p2p_config, 'max_num_peers', 50)

    # -- reactor registry (reference p2p/switch.go AddReactor) -------------

    def add_reactor(self, name: str, reactor: Reactor):
        for ch in reactor.get_channels():
            if ch.id in self._chan_to_reactor:
                raise ValueError(f"channel {ch.id:#x} already registered")
            self._chan_to_reactor[ch.id] = reactor
            self._descriptors.append(ch)
        self.reactors[name] = reactor
        reactor.switch = self

    def node_info(self) -> NodeInfo:
        return NodeInfo(
            node_id=self.node_key.node_id, listen_addr=self.listen_addr,
            network=self.network, version=self.version,
            channels=bytes(sorted(self._chan_to_reactor)),
            moniker=self.moniker)

    # -- lifecycle ---------------------------------------------------------

    def on_start(self):
        """Reference p2p/switch.go:226 OnStart: start every registered
        reactor, then listen.  The listener is bound FIRST so a bind
        failure (port in use) leaves no reactor threads running and the
        switch can be cleanly retried.  A reactor already started by its
        owner keeps running (start here would be an AlreadyStarted
        error)."""
        if self._transport is None:
            host, port = self.listen_addr.rsplit(":", 1)
            self._listener = socket.create_server((host, int(port)))
            self._listener.settimeout(0.5)
        started = []
        try:
            for r in self.reactors.values():
                if not r.is_running():
                    r.start()
                    started.append(r)
        except Exception:
            for r in started:
                r.stop()
            if self._listener is not None:
                self._listener.close()
                self._listener = None
            raise
        if self._transport is not None:
            # bind LAST: an inbound virtual dial must find every
            # reactor running, mirroring the TCP bind-then-accept order
            self._transport.listen(self)
        else:
            self.spawn(self._accept_routine, name="switch-accept")

    def actual_listen_addr(self) -> str:
        if self._transport is not None:
            return self._transport.addr
        host, port = self._listener.getsockname()[:2]
        return f"{host}:{port}"

    def on_stop(self):
        """Reference p2p/switch.go:234 OnStop: stop peers, then reactors."""
        if self._transport is not None:
            self._transport.close()
        if self._listener is not None:
            self._listener.close()
        with self._lock:
            peers = list(self.peers.values())
        for p in peers:
            self.stop_peer_for_error(p, "switch stopping")
        for r in self.reactors.values():
            r.stop()

    def _accept_routine(self):
        while not self.quitting.is_set():
            try:
                sock, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handshake_inbound, args=(sock,),
                             daemon=True).start()

    # -- dialing (reference p2p/switch.go DialPeerWithAddress) -------------

    def dial_peer(self, addr: str, persistent: bool = False) -> Optional[Peer]:
        """addr: "host:port" or "nodeid@host:port"."""
        expected_id = None
        if "@" in addr:
            expected_id, addr = addr.split("@", 1)
        try:
            peer = self._dial_once(addr, persistent=persistent)
        except Exception:  # noqa: BLE001
            if persistent:
                self._schedule_reconnect(addr, expected_id)
            return None
        if peer is not None and expected_id is not None \
                and peer.id != expected_id:
            self.stop_peer_for_error(peer, "node id mismatch")
            return None
        if peer is not None:
            peer.data["dial_addr"] = addr
        return peer

    def _dial_once(self, addr: str, persistent: bool = False) \
            -> Optional[Peer]:
        """One dial attempt over the active transport (raises on
        failure): virtual network when injected, TCP otherwise."""
        if self._transport is not None:
            return self._transport.dial(self, addr, persistent=persistent)
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=self._dial_timeout)
        return self._handshake(sock, outbound=True, persistent=persistent)

    def _schedule_reconnect(self, addr: str, expected_id):
        key = f"{expected_id}@{addr}" if expected_id else addr
        with self._lock:
            if key in self._reconnecting:
                return
            self._reconnecting.add(key)

        def routine():
            rng = random.Random()
            backoff = self.RECONNECT_BASE_S
            try:
                while not self.quitting.is_set():
                    # jittered sleep, capped: a flapping link must not
                    # converge a whole mesh onto one re-dial beat, and
                    # backoff must never grow past RECONNECT_MAX_S
                    if self.quitting.wait(backoff * (0.5 + rng.random())):
                        return
                    backoff = min(backoff * 2, self.RECONNECT_MAX_S)
                    # the peer may have reconnected INBOUND while this
                    # routine slept: dialing again would only bounce off
                    # the duplicate-peer check forever (a leaked entry
                    # that re-dials every backoff) — observe and retire
                    if expected_id is not None:
                        with self._lock:
                            if expected_id in self.peers:
                                return
                    try:
                        peer = self._dial_once(addr, persistent=True)
                    except Exception:  # noqa: BLE001
                        continue
                    if peer is not None:
                        return
            finally:
                with self._lock:
                    self._reconnecting.discard(key)
        threading.Thread(target=routine, daemon=True,
                         name="switch-reconnect").start()

    def _handshake_inbound(self, sock: socket.socket):
        try:
            self._handshake(sock, outbound=False)
        except Exception:  # noqa: BLE001
            try:
                sock.close()
            except OSError:
                pass

    def _handshake(self, sock: socket.socket, outbound: bool,
                   persistent: bool = False) -> Optional[Peer]:
        sock.settimeout(self._handshake_timeout)
        sconn = SecretConnection(sock, self.node_key.priv_key)
        # NodeInfo exchange
        sconn.send_frame(self.node_info().to_bytes())
        their_info = NodeInfo.from_bytes(sconn.recv_frame())
        sock.settimeout(None)
        if their_info.node_id != sconn.remote_node_id:
            raise ValueError("node id does not match secret-connection key")

        def make_conn(on_receive, on_error):
            # gossip-observatory identity: the local moniker names the
            # node (multi-node in-process harnesses share the module
            # global), the remote node id names the peer (ADR-025)
            return MConnection(sconn, self._descriptors, on_receive,
                               on_error, send_rate=self._send_rate,
                               recv_rate=self._recv_rate,
                               obs_node=self.moniker or self.node_key.node_id,
                               obs_peer=their_info.node_id)
        return self._register_peer(their_info, make_conn, outbound,
                                   persistent)

    def _register_peer(self, their_info: NodeInfo, make_conn,
                       outbound: bool, persistent: bool) -> Peer:
        """The post-handshake half of peer admission, shared by the TCP
        path and in-memory transports (networks/vnet.py): compatibility
        and identity checks, connection construction via `make_conn
        (on_receive, on_error)`, peer-table insert (dup/max re-checked
        under the lock AT insert, so two racing handshakes with the same
        peer cannot both land), reactor introductions, then start."""
        incompat = self.node_info().compatible_with(their_info)
        if incompat is not None:
            raise ValueError(f"incompatible peer: {incompat}")
        if their_info.node_id == self.node_key.node_id:
            raise ValueError("self connection")

        peer_box: List[Optional[Peer]] = [None]

        def on_receive(ch_id: int, msg: bytes):
            reactor = self._chan_to_reactor.get(ch_id)
            peer = peer_box[0]
            if reactor is not None and peer is not None:
                try:
                    reactor.receive(ch_id, peer, msg)
                except Exception as e:  # noqa: BLE001
                    self.log.error("reactor receive failed",
                                   channel=f"{ch_id:#x}", peer=peer.id,
                                   err=traceback.format_exc(limit=6))
                    self.stop_peer_for_error(peer, e)

        def on_error(e: Exception):
            peer = peer_box[0]
            if peer is not None:
                self.stop_peer_for_error(peer, e)

        mconn = make_conn(on_receive, on_error)
        peer = Peer(their_info, mconn, outbound, persistent)
        peer_box[0] = peer
        with self._lock:
            dup = peer.id in self.peers
            full = not dup and len(self.peers) >= self.max_peers
            if not dup and not full:
                self.peers[peer.id] = peer
                self._metrics.peers.set(len(self.peers))
        if dup or full:
            # outside the lock: closing the connection may reach into
            # the transport engine (vnet) or block on a socket close
            mconn.stop()
            raise ValueError("duplicate peer" if dup else "too many peers")
        self.log.info("added peer", peer=peer.id,
                      addr=their_info.listen_addr, outbound=outbound)
        # introduce the peer to every reactor BEFORE the recv thread can
        # dispatch its messages (sends queue until mconn.start drains
        # them), so no reactor ever receives from an unknown peer
        for reactor in self.reactors.values():
            reactor.add_peer(peer)
        mconn.start()
        return peer

    # -- peer management ---------------------------------------------------

    def stop_peer_for_error(self, peer: Peer, reason):
        with self._lock:
            existing = self.peers.pop(peer.id, None)
            self._metrics.peers.set(len(self.peers))
        if existing is None:
            return
        self.log.info("stopping peer", peer=peer.id, reason=str(reason))
        peer.stop()
        for reactor in self.reactors.values():
            try:
                reactor.remove_peer(peer, reason)
            except Exception:  # noqa: BLE001
                self.log.error("remove_peer hook failed", peer=peer.id,
                               err=traceback.format_exc(limit=6))
        if peer.persistent and not self.quitting.is_set():
            addr = peer.data.get("dial_addr") or peer.node_info.listen_addr
            self._schedule_reconnect(addr, peer.id)

    def broadcast(self, ch_id: int, msg) -> None:
        """Queue msg to all peers (reference p2p/switch.go:264)."""
        data = wire.encode(ch_id, msg)
        with self._lock:
            peers = list(self.peers.values())
        for p in peers:
            p.mconn.try_send(ch_id, data)

    def num_peers(self) -> int:
        with self._lock:
            return len(self.peers)
