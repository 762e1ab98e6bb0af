"""Blocksync (fast sync) — reference blocksync/: catch up to the network by
downloading committed blocks in parallel and replaying them with coalesced
batch signature verification on the card (BASELINE config 4)."""
from .pool import BlockPool
from .reactor import BlocksyncReactor, BLOCKSYNC_CHANNEL
from .replay import WindowSyncError, replay_window, block_id_of

__all__ = ["BlockPool", "BlocksyncReactor", "BLOCKSYNC_CHANNEL",
           "WindowSyncError", "replay_window", "block_id_of"]
