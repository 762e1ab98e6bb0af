"""State sync (reference statesync/): bootstrap a fresh node from an
application snapshot discovered over p2p, verified against light-client
headers, instead of replaying the whole chain."""
from .reactor import (CHUNK_CHANNEL, SNAPSHOT_CHANNEL, StateSyncReactor)
from .stateprovider import StateProvider
from .syncer import SnapshotRejected, StateSyncError, Syncer

__all__ = ["Syncer", "StateSyncError", "SnapshotRejected", "StateProvider",
           "StateSyncReactor", "SNAPSHOT_CHANNEL", "CHUNK_CHANNEL"]
