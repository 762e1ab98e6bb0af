"""Deterministic WAL fabrication for tests and the replay console
(reference consensus/wal_generator.go: run a real single-validator
consensus over a kvstore app until N blocks commit, capturing the WAL).
"""
from __future__ import annotations

import os
import time
from typing import Optional

from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.consensus.config import test_config
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.crypto import ed25519 as edkeys
from tendermint_tpu_torch.libs.kvdb import MemDB
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.privval.file_pv import FilePV
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import state_from_genesis
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.store.block_store import BlockStore
from tendermint_tpu_torch.types.basic import Timestamp
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator


def generate_wal(wal_path: str, num_blocks: int,
                 chain_id: str = "wal-gen-chain",
                 timeout_s: float = 60.0,
                 head_size_limit: Optional[int] = None) -> None:
    """Run a real single-validator consensus until `num_blocks` commit,
    writing its WAL to `wal_path` (reference wal_generator.go:36
    WALGenerateNBlocks).  Deterministic key (fixed seed); wall-clock
    timestamps vary run to run, as in the reference."""
    priv = edkeys.PrivKey((0xA11CE).to_bytes(32, "big"))
    gdoc = GenesisDoc(
        chain_id=chain_id,
        genesis_time=Timestamp(1700000000, 0),
        validators=[GenesisValidator(
            address=priv.pub_key().address(), pub_key_type="ed25519",
            pub_key_bytes=priv.pub_key().bytes(), power=10)])

    app = KVStoreApplication()
    mempool = Mempool(app)
    state_store = StateStore(MemDB())
    block_store = BlockStore(MemDB())
    state = state_from_genesis(gdoc)
    state_store.save(state)
    executor = BlockExecutor(state_store, app, mempool=mempool,
                             block_store=block_store)
    cs = ConsensusState(test_config(), state, executor, block_store,
                        mempool=mempool, priv_validator=FilePV(priv),
                        wal_path=wal_path, name="wal-gen")
    if head_size_limit is not None:
        # rebuild the WAL with a small head limit to exercise rotation
        cs.wal.close()
        from tendermint_tpu_torch.consensus.wal import WAL
        cs.wal = WAL(wal_path, head_size_limit=head_size_limit)
    cs.start()
    try:
        deadline = time.time() + timeout_s
        while cs.rs.height <= num_blocks:
            if time.time() > deadline:
                raise TimeoutError(
                    f"wal generator stuck at height {cs.rs.height}")
            time.sleep(0.02)
    finally:
        cs.stop()
