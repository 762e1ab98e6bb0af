"""In-process kvstore application — the standard test fixture (reference
abci/example/kvstore/kvstore.go and persistent_kvstore.go).

Tx format: "key=value" sets key; any other tx sets tx as both key and value.
Validator-update txs: "val:<pubkey_b64>!<power>" (reference
persistent_kvstore.go:53 uses "val:pubkey!power").
AppHash: big-endian 8-byte tx count (reference kvstore.go:83-90 uses the
size as the deterministic state digest).
"""
from __future__ import annotations

import base64
import struct
from typing import Dict, List, Optional

from . import types as abci

VALIDATOR_TX_PREFIX = b"val:"


class KVStoreApplication(abci.Application):
    def __init__(self):
        self.data: Dict[bytes, bytes] = {}
        self.size = 0
        self.height = 0
        self.app_hash = b""
        self.val_updates: List[abci.ValidatorUpdate] = []
        self.validators: Dict[bytes, int] = {}  # pubkey -> power
        self._staged: Optional[Dict[bytes, bytes]] = None

    # -- info/query --------------------------------------------------------

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=f"{{\"size\":{self.size}}}",
            version="0.1.0",
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        value = self.data.get(req.data, b"")
        return abci.ResponseQuery(
            code=abci.CODE_TYPE_OK, key=req.data, value=value,
            log="exists" if value else "does not exist",
            height=self.height)

    # -- mempool -----------------------------------------------------------

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        if len(req.tx) == 0:
            return abci.ResponseCheckTx(code=1, log="empty tx")
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, gas_wanted=1)

    # -- consensus ---------------------------------------------------------

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        for vu in req.validators:
            self.validators[vu.pub_key_bytes] = vu.power
        return abci.ResponseInitChain()

    def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        self.val_updates = []
        # record misbehavior into app state (reference e2e app does the
        # same so tests can assert evidence reached the app); the write
        # is derived from the committed block, so it is deterministic
        # across nodes and safe to fold into app_hash
        for m in req.byzantine_validators:
            addr = getattr(m, "validator_address", b"") or b""
            # the type is part of the key: a duplicate-vote and a
            # light-attack record against the same (height, validator)
            # must not overwrite each other
            key = b"misbehavior/%d/%d/%s" % (getattr(m, "height", 0),
                                             getattr(m, "type", 0),
                                             addr.hex().encode())
            self.data[key] = b"%d" % getattr(m, "type", 0)
        return abci.ResponseBeginBlock()

    def deliver_tx(self, tx: bytes) -> abci.ResponseDeliverTx:
        if tx.startswith(VALIDATOR_TX_PREFIX):
            return self._deliver_validator_tx(tx)
        if b"=" in tx:
            key, value = tx.split(b"=", 1)
        else:
            key, value = tx, tx
        self.data[key] = value
        self.size += 1
        return abci.ResponseDeliverTx(
            code=abci.CODE_TYPE_OK,
            events=[abci.Event("app", {"key": key.decode("utf-8", "replace"),
                                       "creator": "kvstore"})])

    def _deliver_validator_tx(self, tx: bytes) -> abci.ResponseDeliverTx:
        body = tx[len(VALIDATOR_TX_PREFIX):]
        try:
            pubkey_b64, power_s = body.split(b"!", 1)
            pubkey = base64.b64decode(pubkey_b64)
            power = int(power_s)
            if len(pubkey) != 32 or power < 0:
                raise ValueError
        except (ValueError, TypeError):
            return abci.ResponseDeliverTx(
                code=1, log="invalid validator tx format, want "
                            "val:<pubkey_b64>!<power>")
        self.validators[pubkey] = power
        self.val_updates.append(
            abci.ValidatorUpdate("ed25519", pubkey, power))
        return abci.ResponseDeliverTx(code=abci.CODE_TYPE_OK)

    def end_block(self, height: int) -> abci.ResponseEndBlock:
        return abci.ResponseEndBlock(validator_updates=self.val_updates)

    def _compute_app_hash(self) -> bytes:
        """Hook for subclasses that derive the app hash differently
        (ProvableKVStoreApplication uses the kv merkle root)."""
        return struct.pack(">Q", self.size)

    def _on_committed(self):
        """Hook called once self.height/app_hash reflect the committed
        state (after commit and after snapshot restore)."""

    def commit(self) -> abci.ResponseCommit:
        self.app_hash = self._compute_app_hash()
        self.height += 1
        self._on_committed()
        if self.snapshot_interval and self.height % self.snapshot_interval \
                == 0:
            self._take_snapshot()
        return abci.ResponseCommit(data=self.app_hash)

    # -- state sync snapshots (reference persistent_kvstore + snapshots/)

    snapshot_interval = 0  # heights between snapshots; 0 disables
    snapshot_chunk_size = 65536  # bytes per chunk (format 1)
    _SNAPSHOT_KEEP = 3

    def _take_snapshot(self):
        import hashlib
        import json
        body = json.dumps({
            "size": self.size,
            "height": self.height,
            "data": {k.hex(): v.hex() for k, v in sorted(self.data.items())},
            "validators": {k.hex(): p
                           for k, p in sorted(self.validators.items())},
        }, sort_keys=True).encode()
        cs = max(1, int(self.snapshot_chunk_size))
        nchunks = max(1, -(-len(body) // cs))
        # per-chunk digest metadata (statesync/integrity.py, ADR-022):
        # lets the fetch plane verify each chunk BEFORE the app sees
        # it and attribute a corrupt one to its sender; the whole-body
        # hash below stays the app-level end-to-end check
        from tendermint_tpu_torch.statesync.integrity import make_chunk_metadata
        meta = make_chunk_metadata(
            [body[i * cs:(i + 1) * cs] for i in range(nchunks)])
        snap = abci.Snapshot(height=self.height, format=1, chunks=nchunks,
                             hash=hashlib.sha256(body).digest(),
                             metadata=meta)
        self._snapshots = getattr(self, "_snapshots", [])
        self._snapshots.append((snap, body))
        self._snapshots = self._snapshots[-self._SNAPSHOT_KEEP:]

    def list_snapshots(self):
        return [s for s, _ in getattr(self, "_snapshots", [])]

    def offer_snapshot(self, snapshot: abci.Snapshot,
                       app_hash: bytes) -> abci.ResponseOfferSnapshot:
        if snapshot.format != 1 or snapshot.chunks < 1:
            return abci.ResponseOfferSnapshot(
                result=abci.ResponseOfferSnapshot.REJECT_FORMAT)
        # chunks accumulate until the last one arrives; the whole-body
        # hash is verified at the end (the snapshot hash covers the
        # concatenation, not individual chunks)
        self._restoring = (snapshot, app_hash, {})
        return abci.ResponseOfferSnapshot(
            result=abci.ResponseOfferSnapshot.ACCEPT)

    def load_snapshot_chunk(self, height: int, format_: int,
                            index: int) -> bytes:
        cs = max(1, int(self.snapshot_chunk_size))
        for s, body in getattr(self, "_snapshots", []):
            if s.height == height and s.format == format_ \
                    and 0 <= index < s.chunks:
                return body[index * cs:(index + 1) * cs]
        return b""

    def apply_snapshot_chunk(self, index: int, chunk: bytes,
                             sender: str) -> abci.ResponseApplySnapshotChunk:
        import hashlib
        import json
        restoring = getattr(self, "_restoring", None)
        if restoring is None:
            return abci.ResponseApplySnapshotChunk(
                result=abci.ResponseApplySnapshotChunk.ABORT)
        snap, app_hash, got = restoring
        got[index] = chunk
        if len(got) < snap.chunks:
            return abci.ResponseApplySnapshotChunk(
                result=abci.ResponseApplySnapshotChunk.ACCEPT)
        body = b"".join(got[i] for i in range(snap.chunks))
        if hashlib.sha256(body).digest() != snap.hash:
            # whole-body mismatch: some chunk was bad; refetch everything
            # from someone else (reference kvstore rejects the sender)
            self._restoring = (snap, app_hash, {})
            return abci.ResponseApplySnapshotChunk(
                result=abci.ResponseApplySnapshotChunk.RETRY,
                refetch_chunks=list(range(snap.chunks)),
                reject_senders=[sender])
        try:
            st = json.loads(body)
            size = int(st["size"])
            height = int(st["height"])
            data = {bytes.fromhex(k): bytes.fromhex(v)
                    for k, v in st["data"].items()}
            validators = {bytes.fromhex(k): int(p)
                          for k, p in st["validators"].items()}
        except Exception:
            # peer-shaped bytes that hash-matched the peer's own claim but
            # don't parse: the snapshot itself is garbage
            self._restoring = None
            return abci.ResponseApplySnapshotChunk(
                result=abci.ResponseApplySnapshotChunk.REJECT_SNAPSHOT,
                reject_senders=[sender])
        self.size, self.height = size, height
        self.data, self.validators = data, validators
        self.app_hash = self._compute_app_hash()
        self._on_committed()
        self._restoring = None
        return abci.ResponseApplySnapshotChunk(
            result=abci.ResponseApplySnapshotChunk.ACCEPT)


class ProvableKVStoreApplication(KVStoreApplication):
    """kvstore whose app hash is the merkle root of its kv map and whose
    Query(prove=True) serves ValueOp merkle proofs.

    The reference kvstore hashes only its size (kvstore.go) and proves
    nothing; this variant exists so the light rpc proxy's proof
    verification path (reference light/rpc/client.go ABCIQuery +
    crypto/merkle ProofOperators) runs against a real application."""

    _committed = None  # (height, committed-data snapshot, root, proofs)
    _pending = None

    def _compute_app_hash(self) -> bytes:
        from tendermint_tpu_torch.crypto.merkle import proofs_from_kv_map
        # snapshot the committed state: queries must answer and prove
        # against what consensus committed, never the live map a
        # concurrent deliver_tx is mutating (and the O(n log n) tree
        # build runs once per block, not per query)
        data = dict(self.data)
        root, proofs = proofs_from_kv_map(data)
        self._pending = (data, root, proofs)
        return root

    def _on_committed(self):
        # self.height is final here, for both commit and snapshot restore
        data, root, proofs = self._pending
        self._committed = (self.height, data, root, proofs)

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        snap = self._committed
        if snap is None:
            return super().query(req)
        height, data, _root, proofs = snap
        value = data.get(req.data, b"")
        resp = abci.ResponseQuery(
            code=abci.CODE_TYPE_OK, key=req.data, value=value,
            log="exists" if value else "does not exist",
            height=height)
        if getattr(req, "prove", False) and value:
            op = proofs.get(req.data)
            if op is not None:
                pop = op.proof_op()
                resp.proof_ops = [(pop.type, pop.key, pop.data)]
        # resp.height is the committed height h; the proof anchors to the
        # app hash in header h+1 (verifier lag, reference
        # light/rpc/client.go res.Height+1)
        return resp
