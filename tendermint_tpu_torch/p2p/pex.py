"""Peer exchange: address book + PEX reactor (reference
p2p/pex/addrbook.go, p2p/pex/pex_reactor.go, p2p/pex/known_address.go).

The AddrBook keeps two tiers of buckets, mirroring the reference's
bitcoin-derived design:
  * new buckets  — addresses we've heard about but never connected to;
    the bucket index is keyed on (source group, address group) so one
    gossiping peer cannot fill the whole table,
  * old buckets  — addresses that have proven good (MarkGood after a
    successful handshake); keyed on address group alone.
An address is "bad" after too many failed dial attempts and gets evicted.
Persistence is a JSON file, dumped periodically and on stop.

The PexReactor (channel 0x00) answers one address request per peer per
ensure-peers period, sends a request to each new peer when the book is
low, and runs an ensure-peers routine that dials book addresses (biased
toward new addresses while young) whenever the switch is below its
dial target.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe

from . import wire
from .connection import ChannelDescriptor
from .switch import Peer, Reactor

PEX_CHANNEL = 0x00

# book geometry (reference p2p/pex/params.go)
NEW_BUCKET_COUNT = 256
NEW_BUCKET_SIZE = 64
OLD_BUCKET_COUNT = 64
OLD_BUCKET_SIZE = 64
NEW_BUCKETS_PER_GROUP = 32
OLD_BUCKETS_PER_GROUP = 4
MAX_NEW_BUCKETS_PER_ADDRESS = 4
NUM_RETRIES = 3            # failures with no success -> bad (if old enough)
MAX_FAILURES = 10
GET_SELECTION_PERCENT = 23
MIN_GET_SELECTION = 32
MAX_GET_SELECTION = 250
NEED_ADDRESS_THRESHOLD = 1000


def valid_addr(addr: str) -> bool:
    """A dialable host:port with a numeric, non-zero port.  Everything a
    peer hands us goes through this before entering the book — a junk
    string must not be able to poison the dial loop."""
    if not isinstance(addr, str) or ":" not in addr or len(addr) > 256:
        return False
    host, port = addr.rsplit(":", 1)
    return bool(host) and port.isdigit() and 0 < int(port) < 65536


def _group(addr: str) -> str:
    """Group key for bucket spreading.  The reference groups by routable
    IP prefix (/16 for IPv4); for host:port strings we group on the host
    part, which gives the same 'one source can't own the table' property
    on a localnet/testnet."""
    host = addr.rsplit(":", 1)[0]
    parts = host.split(".")
    if len(parts) == 4 and all(p.isdigit() for p in parts):
        return ".".join(parts[:2])
    return host


def _hash_mod(data: str, mod: int) -> int:
    return int.from_bytes(hashlib.sha256(data.encode()).digest()[:8],
                          "big") % mod


@dataclass
class KnownAddress:
    """Reference p2p/pex/known_address.go."""
    node_id: str
    addr: str                      # host:port
    src_id: str = ""
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    bucket_type: str = "new"       # "new" | "old"
    buckets: List[int] = field(default_factory=list)

    def is_old(self) -> bool:
        return self.bucket_type == "old"

    def is_bad(self, now: float) -> bool:
        """Reference known_address.go isBad (terminally bad; evict)."""
        if self.last_attempt == 0.0:
            return False
        if self.attempts >= NUM_RETRIES and self.last_success == 0.0:
            return True
        return self.attempts >= MAX_FAILURES

    def to_dict(self) -> dict:
        return {"node_id": self.node_id, "addr": self.addr,
                "src_id": self.src_id, "attempts": self.attempts,
                "last_attempt": self.last_attempt,
                "last_success": self.last_success,
                "bucket_type": self.bucket_type, "buckets": self.buckets}

    @classmethod
    def from_dict(cls, d: dict) -> "KnownAddress":
        return cls(node_id=d["node_id"], addr=d["addr"],
                   src_id=d.get("src_id", ""),
                   attempts=d.get("attempts", 0),
                   last_attempt=d.get("last_attempt", 0.0),
                   last_success=d.get("last_success", 0.0),
                   bucket_type=d.get("bucket_type", "new"),
                   buckets=list(d.get("buckets", [])))


class AddrBook:
    """Reference p2p/pex/addrbook.go (addrBook)."""

    def __init__(self, file_path: Optional[str] = None,
                 our_ids: Tuple[str, ...] = ()):
        self.file_path = file_path
        self.our_ids = set(our_ids)
        self._addrs: Dict[str, KnownAddress] = {}   # node_id -> ka
        self._bans: Dict[str, float] = {}           # node_id -> until
        self._new: List[Dict[str, KnownAddress]] = [
            {} for _ in range(NEW_BUCKET_COUNT)]
        self._old: List[Dict[str, KnownAddress]] = [
            {} for _ in range(OLD_BUCKET_COUNT)]
        self._mtx = threading.RLock()
        self._rng = random.Random()
        if file_path and os.path.exists(file_path):
            self._load()

    # -- size / views --------------------------------------------------------

    def size(self) -> int:
        with self._mtx:
            return len(self._addrs)

    def is_empty(self) -> bool:
        return self.size() == 0

    def need_more_addrs(self) -> bool:
        return self.size() < NEED_ADDRESS_THRESHOLD

    def has(self, node_id: str) -> bool:
        with self._mtx:
            return node_id in self._addrs

    # -- mutation (reference addrbook.go AddAddress/Mark*) -------------------

    def add_our_id(self, node_id: str):
        with self._mtx:
            self.our_ids.add(node_id)
            self._remove(node_id)

    def add_address(self, node_id: str, addr: str, src_id: str = "") -> bool:
        """Hear about node_id@addr from src_id.  Returns True if added or
        refreshed (a frequently-heard new address may occupy up to 4 new
        buckets, reference addrbook.go:676-697)."""
        if not node_id or node_id in self.our_ids \
                or self.is_banned(node_id) or not valid_addr(addr):
            return False
        with self._mtx:
            ka = self._addrs.get(node_id)
            if ka is not None:
                if ka.is_old():
                    return True
                # refresh a stale/unroutable address before any early
                # return (an id heard with a better addr must keep it)
                if addr and addr != ka.addr:
                    ka.addr = addr
                    ka.attempts = 0
                if len(ka.buckets) >= MAX_NEW_BUCKETS_PER_ADDRESS:
                    return True
                # probabilistically add to one more new bucket
                if self._rng.random() > 0.5 ** len(ka.buckets):
                    return True
            else:
                ka = KnownAddress(node_id=node_id, addr=addr, src_id=src_id)
                self._addrs[node_id] = ka
            b = _hash_mod(
                f"{_group(ka.addr)}|{_group(src_id or ka.addr)}"
                f"|{len(ka.buckets)}", NEW_BUCKET_COUNT)
            if b not in ka.buckets:
                ka.buckets.append(b)
                self._new[b][node_id] = ka
                if len(self._new[b]) > NEW_BUCKET_SIZE:
                    self._evict_new(b)
            return True

    def mark_attempt(self, node_id: str):
        with self._mtx:
            ka = self._addrs.get(node_id)
            if ka is None:
                return
            ka.attempts += 1
            ka.last_attempt = time.time()
            if not ka.is_bad(time.time()):
                return
            if ka.is_old():
                # proven-good once, but now persistently unreachable:
                # demote to a new bucket so it must re-prove itself and
                # stops hogging the old tier (reference moveToOld inverse)
                if ka.attempts <= MAX_FAILURES:
                    return
                for b in ka.buckets:
                    self._old[b].pop(node_id, None)
                ka.bucket_type = "new"
                # still bad-ish; evicts next fail.  last_success must be
                # cleared or is_bad's NUM_RETRIES branch never fires for a
                # once-good address and eviction needs MAX_FAILURES more
                # dead dials.
                ka.attempts = NUM_RETRIES
                ka.last_success = 0.0
                nb = _hash_mod(f"{_group(ka.addr)}|{_group(ka.addr)}|0",
                               NEW_BUCKET_COUNT)
                ka.buckets = [nb]
                self._new[nb][node_id] = ka
            else:
                self._remove(node_id)

    def mark_good(self, node_id: str):
        """Successful handshake: promote new -> old
        (reference addrbook.go:322 + moveToOld)."""
        with self._mtx:
            ka = self._addrs.get(node_id)
            if ka is None:
                return
            ka.attempts = 0
            ka.last_success = time.time()
            if ka.is_old():
                return
            for b in ka.buckets:
                self._new[b].pop(node_id, None)
            ka.buckets = []
            ka.bucket_type = "old"
            ob = _hash_mod(_group(ka.addr), OLD_BUCKET_COUNT)
            ka.buckets = [ob]
            self._old[ob][node_id] = ka
            if len(self._old[ob]) > OLD_BUCKET_SIZE:
                self._evict_old(ob)

    def mark_bad(self, node_id: str, ban_s: float = 24 * 3600.0):
        """Ban (reference addrbook.go:352): remove and refuse re-add.
        Works even for ids not (yet) in the book."""
        with self._mtx:
            self._bans[node_id] = time.time() + ban_s
            self._remove(node_id)

    def _remove(self, node_id: str):
        ka = self._addrs.pop(node_id, None)
        if ka is None:
            return
        table = self._old if ka.is_old() else self._new
        for b in ka.buckets:
            table[b].pop(node_id, None)

    def is_banned(self, node_id: str) -> bool:
        with self._mtx:
            until = self._bans.get(node_id, 0.0)
            if until and until < time.time():
                del self._bans[node_id]
                return False
            return bool(until)

    def _evict_new(self, b: int):
        """Drop the worst (bad, else oldest-attempted) from a full bucket."""
        bucket = self._new[b]
        now = time.time()
        victim = None
        for ka in bucket.values():
            if ka.is_bad(now):
                victim = ka
                break
        if victim is None:
            victim = min(bucket.values(),
                         key=lambda k: (k.last_success, -k.attempts))
        victim.buckets.remove(b)
        bucket.pop(victim.node_id, None)
        if not victim.buckets:
            self._addrs.pop(victim.node_id, None)

    def _evict_old(self, b: int):
        """Demote the oldest old address back to a new bucket
        (reference addrbook.go:773-794)."""
        bucket = self._old[b]
        victim = min(bucket.values(), key=lambda k: k.last_success)
        bucket.pop(victim.node_id, None)
        victim.bucket_type = "new"
        nb = _hash_mod(f"{_group(victim.addr)}|{_group(victim.addr)}|0",
                       NEW_BUCKET_COUNT)
        victim.buckets = [nb]
        self._new[nb][victim.node_id] = victim

    # -- selection (reference addrbook.go PickAddress/GetSelection) ----------

    def pick_address(self, new_bias_pct: int = 50) -> Optional[KnownAddress]:
        """Random address, biased toward new buckets by new_bias_pct
        (reference addrbook.go:272)."""
        with self._mtx:
            if not self._addrs:
                return None
            new_bias_pct = max(0, min(100, new_bias_pct))
            n_new = sum(len(b) for b in self._new)
            n_old = sum(len(b) for b in self._old)
            pick_old = (n_old > 0 and
                        (n_new == 0 or
                         self._rng.random() * 100 >= new_bias_pct))
            table = self._old if pick_old else self._new
            entries = [ka for b in table for ka in b.values()]
            if not entries:
                entries = list(self._addrs.values())
            return self._rng.choice(entries)

    def get_selection(self) -> List[Tuple[str, str]]:
        """Random (node_id, addr) sample for a PEX response
        (reference addrbook.go GetSelection: 23% of book, in [32, 250])."""
        with self._mtx:
            all_kas = list(self._addrs.values())
            n = len(all_kas)
            if n == 0:
                return []
            num = max(MIN_GET_SELECTION, n * GET_SELECTION_PERCENT // 100)
            num = min(num, MAX_GET_SELECTION, n)
            sample = self._rng.sample(all_kas, num)
            return [(ka.node_id, ka.addr) for ka in sample]

    # -- persistence (reference p2p/pex/file.go) ------------------------------

    def save(self):
        if not self.file_path:
            return
        now = time.time()
        with self._mtx:
            data = {"addrs": [ka.to_dict() for ka in self._addrs.values()],
                    "bans": {nid: until
                             for nid, until in self._bans.items()
                             if until > now}}
        tmp = self.file_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.file_path)

    def _load(self):
        # A corrupt or version-skewed book must never prevent node startup
        # (the reference logs and continues with an empty book) — guard the
        # whole decode, not just the JSON parse.
        try:
            with open(self.file_path) as f:
                data = json.load(f)
            self._bans = {nid: float(until)
                          for nid, until in data.get("bans", {}).items()}
            for d in data.get("addrs", []):
                ka = KnownAddress.from_dict(d)
                if ka.node_id in self.our_ids:
                    continue
                self._addrs[ka.node_id] = ka
                table = self._old if ka.is_old() else self._new
                count = (OLD_BUCKET_COUNT if ka.is_old()
                         else NEW_BUCKET_COUNT)
                ka.buckets = [b for b in ka.buckets if 0 <= b < count] or [
                    _hash_mod(_group(ka.addr), count)]
                for b in ka.buckets:
                    table[b][ka.node_id] = ka
        except (OSError, ValueError, TypeError, KeyError):
            self._bans = {}
            self._addrs = {}
            self._new = [dict() for _ in range(NEW_BUCKET_COUNT)]
            self._old = [dict() for _ in range(OLD_BUCKET_COUNT)]
            return


# ---------------------------------------------------------------------------
# reactor
# ---------------------------------------------------------------------------

@dataclass
class PexRequest:
    pass


@dataclass
class PexAddrs:
    addrs: list          # [(node_id, "host:port"), ...]


# -- wire codec (proto/tendermint/p2p/pex.proto Message oneof:
# pex_request=1, pex_addrs=2{repeated NetAddress addrs=1};
# NetAddress{id=1, ip=2, port=3}) -----------------------------------------

def _enc_net_address(node_id: str, addr: str) -> bytes:
    host, _, port = addr.rpartition(":")
    try:
        port_n = int(port)
    except ValueError:
        port_n = 0
    return (pe.string_field(1, node_id) + pe.string_field(2, host)
            + pe.varint_field(3, port_n))


def encode_msg(msg) -> bytes:
    if isinstance(msg, PexRequest):
        return wire.oneof_encode(1, b"")
    if isinstance(msg, PexAddrs):
        body = pe.repeated_message_field(
            1, [_enc_net_address(nid, a) for nid, a in msg.addrs])
        return wire.oneof_encode(2, body)
    raise TypeError(f"unknown pex message {type(msg).__name__}")


def _dec_addrs(body: bytes) -> PexAddrs:
    out = []
    for m in pd.get_messages(pd.parse(body), 1):
        f = pd.parse(m)
        nid = pd.get_string(f, 1)
        ip = pd.get_string(f, 2)
        port = pd.get_uint(f, 3)
        if nid and ip and 0 < port < 65536:
            out.append((nid, f"{ip}:{port}"))
    return PexAddrs(out)


def decode_msg(data: bytes):
    return wire.oneof_decode(data, {1: lambda b: PexRequest(),
                                    2: _dec_addrs})


wire.register_codec(PEX_CHANNEL, encode_msg, decode_msg)


class PexReactor(Reactor):
    """Reference p2p/pex/pex_reactor.go (BaseService lifecycle via
    Reactor; the Switch starts/stops it)."""

    def __init__(self, book: AddrBook, ensure_period_s: float = 30.0,
                 target_out_peers: int = 10, seeds: str = "",
                 trust_store=None):
        super().__init__("PEX")
        from tendermint_tpu_torch.p2p.trust import TrustMetricStore
        self.book = book
        self.trust = trust_store or TrustMetricStore()
        self.ensure_period_s = ensure_period_s
        self.target_out_peers = target_out_peers
        self.seeds = [s.strip() for s in seeds.split(",") if s.strip()]
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("pex")
        self._last_request: Dict[str, float] = {}   # peer -> last req FROM it
        self._sent_request: Dict[str, float] = {}   # peer -> last req TO it
        self._requested: Dict[str, float] = {}      # open requests we sent
        self._mtx = threading.Lock()

    def get_channels(self):
        return [ChannelDescriptor(PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10)]

    def remove_peer(self, peer: Peer, reason):
        """Switch error-path feedback into the trust metric (reference
        trust store usage in p2p)."""
        if reason is not None:
            self.trust.get(peer.id).bad_events()

    def on_start(self):
        """Reference pex_reactor.go:117 OnStart; started by the Switch."""
        self.log.info("pex started", seeds=len(self.seeds),
                      book_size=self.book.size())
        self.spawn(self._ensure_peers_routine, name="pex-ensure")

    def on_stop(self):
        self.book.save()

    # -- peer lifecycle ------------------------------------------------------

    def add_peer(self, peer: Peer):
        # an inbound peer's self-reported listen addr enters the book with
        # the peer as source; outbound peers were dialed so are proven
        # good.  Port-0 addrs (auto-assign listeners) are unroutable junk.
        addr = peer.node_info.listen_addr
        if addr and not addr.endswith(":0"):
            self.book.add_address(peer.id, addr, src_id=peer.id)
        if peer.outbound:
            self.book.mark_good(peer.id)
        if self.book.need_more_addrs():
            self._request_addrs(peer)

    def remove_peer(self, peer: Peer, reason):
        with self._mtx:
            self._requested.pop(peer.id, None)
            self._last_request.pop(peer.id, None)
            self._sent_request.pop(peer.id, None)

    # -- wire ----------------------------------------------------------------

    def _request_addrs(self, peer: Peer):
        # pace ourselves to the same period the responder's flood guard
        # enforces, or it will (correctly) ban us
        now = time.time()
        with self._mtx:
            if now - self._sent_request.get(peer.id, 0.0) \
                    < self.ensure_period_s:
                return
            self._sent_request[peer.id] = now
            self._requested[peer.id] = now
        peer.try_send(PEX_CHANNEL, PexRequest())

    def receive(self, ch_id: int, peer: Peer, msg_bytes: bytes):
        msg = decode_msg(msg_bytes)
        if isinstance(msg, PexRequest):
            # rate-limit: one request per peer per ensure period
            # (reference pex_reactor.go:83 receiveRequest).  NOTE: the
            # punish calls run outside _mtx — stop_peer_for_error fans out
            # to remove_peer hooks that re-take it.
            now = time.time()
            with self._mtx:
                last = self._last_request.get(peer.id, 0.0)
                flood = now - last < self.ensure_period_s * 0.9
                if not flood:
                    self._last_request[peer.id] = now
            if flood:
                self.log.info("disconnecting pex-flooding peer",
                              peer=peer.id)
                self.book.mark_bad(peer.id)
                if self.switch is not None:
                    self.switch.stop_peer_for_error(peer,
                                                    "pex request flood")
                return
            peer.try_send(PEX_CHANNEL, PexAddrs(self.book.get_selection()))
        elif isinstance(msg, PexAddrs):
            # unsolicited addrs -> disconnect (pex_reactor.go:272)
            with self._mtx:
                unsolicited = peer.id not in self._requested
                if not unsolicited:
                    self._requested.pop(peer.id, None)
            if unsolicited:
                self.log.info("disconnecting peer for unsolicited addrs",
                              peer=peer.id)
                if self.switch is not None:
                    self.switch.stop_peer_for_error(
                        peer, "unsolicited pex addrs")
                return
            for entry in msg.addrs[:MAX_GET_SELECTION]:
                try:
                    node_id, addr = entry
                except (TypeError, ValueError):
                    continue
                if isinstance(node_id, str) and isinstance(addr, str) \
                        and not self.book.is_banned(node_id):
                    self.book.add_address(node_id, addr, src_id=peer.id)

    # -- ensure peers (reference pex_reactor.go:388 ensurePeers) -------------

    BOOK_DUMP_INTERVAL_S = 120.0   # reference params.go dumpAddressInterval

    def _ensure_peers_routine(self):
        # jittered first run so a fleet doesn't thunder
        self.quitting.wait(self.ensure_period_s * random.random() * 0.1)
        last_save = time.monotonic()
        while not self.quitting.is_set():
            try:
                self._ensure_peers()
            except Exception as e:  # noqa: BLE001 - keep the routine alive
                self.log.error("ensure-peers iteration failed", err=str(e))
            if time.monotonic() - last_save > self.BOOK_DUMP_INTERVAL_S:
                last_save = time.monotonic()
                try:
                    self.book.save()
                except OSError as e:
                    self.log.error("addr book save failed", err=str(e))
            self.quitting.wait(self.ensure_period_s)

    def _ensure_peers(self):
        sw = self.switch
        if sw is None:
            return
        with sw._lock:  # snapshot: accept/dial threads mutate sw.peers
            peer_list = list(sw.peers.values())
        out = sum(1 for p in peer_list if p.outbound)
        need = self.target_out_peers - out
        if need <= 0:
            return
        # bias new addresses while we have few peers (reactor.go:406-416)
        bias = max(30, min(100, 60 - out * 3 + 40))
        tried = 0
        while need > 0 and tried < need * 3:
            tried += 1
            ka = self.book.pick_address(bias)
            if ka is None:
                break
            if ka.node_id in sw.peers or ka.is_bad(time.time()):
                continue
            # distrusted peers (EWMA of dial failures/disconnect errors,
            # reference p2p/trust + pex ranking) are skipped until their
            # metric recovers
            if self.trust.peer_trust(ka.node_id) < 0.2:
                continue
            self.book.mark_attempt(ka.node_id)
            peer = sw.dial_peer(f"{ka.node_id}@{ka.addr}")
            if peer is not None:
                self.book.mark_good(peer.id)
                self.trust.get(peer.id).good_events()
                need -= 1
            else:
                self.log.debug("dial failed", addr=ka.addr)
                self.trust.get(ka.node_id).bad_events()
        with sw._lock:
            peers = list(sw.peers.values())
        if not peers and self.seeds:
            # isolated (empty book OR a book full of dead addresses):
            # crawl a random seed (reactor.go dialSeeds)
            seed = random.choice(self.seeds)
            peer = sw.dial_peer(seed)
            if peer is not None:
                self._request_addrs(peer)
        elif peers and self.book.need_more_addrs():
            # ask a connected peer for more addresses
            self._request_addrs(random.choice(peers))
