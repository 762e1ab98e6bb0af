"""Consensus write-ahead log (reference consensus/wal.go).

Every message the consensus state machine processes is logged BEFORE it is
processed (WAL-then-act discipline); on crash, replay from the last height
boundary reproduces the exact state.  Framing: 4-byte CRC32c | 4-byte
length | safe_codec(msg), matching the reference's crc/length framing
(consensus/wal.go:288-355); EndHeightMessage marks height boundaries.

Storage is a rotating autofile Group (reference libs/autofile/group.go via
consensus/wal.go:91 NewWAL): the head file rotates into numbered chunks at
height boundaries once it exceeds the head size limit, bounding any single
file; readers see one logical stream across chunks + head.

fsync policy mirrors the reference: WriteSync on own votes/timeouts and on
EndHeight (consensus/state.go:765,774,1683).
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional

from tendermint_tpu_torch.libs import safe_codec
from tendermint_tpu_torch.libs.autofile import Group, list_group_paths

MAX_MSG_SIZE = 1 << 20  # 1MB (reference consensus/wal.go:25)


@dataclass(frozen=True)
class EndHeightMessage:
    """Marks that all messages for `height` have been processed (reference
    consensus/wal.go:42)."""
    height: int


class WALCorruptionError(Exception):
    pass


class WAL:
    def __init__(self, path: str, head_size_limit: int = 10 * 1024 * 1024):
        self.path = path
        self._group = Group(path, head_size_limit=head_size_limit)
        self._lock = threading.Lock()

    def write(self, msg) -> None:
        data = safe_codec.dumps(msg)
        if len(data) > MAX_MSG_SIZE:
            raise ValueError(f"WAL msg too big: {len(data)}")
        frame = (struct.pack(">I", zlib.crc32(data))
                 + struct.pack(">I", len(data)) + data)
        with self._lock:
            self._group.write(frame)
        # rotation only at height boundaries: a frame never spans files
        # (reference consensus/wal.go writes #ENDHEIGHT then the group
        # rotates on its own ticker; rotating on the boundary keeps replay
        # chunk-local)
        if isinstance(msg, EndHeightMessage):
            with self._lock:
                self._group.maybe_rotate()

    def write_sync(self, msg) -> None:
        self.write(msg)
        self.flush_and_sync()

    def flush_and_sync(self):
        with self._lock:
            self._group.flush_and_sync()

    def close(self):
        with self._lock:
            self._group.close()

    # -- replay ------------------------------------------------------------

    @staticmethod
    def _iter_file(path: str, allow_corruption_tail: bool = True):
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return
                crc, length = struct.unpack(">II", hdr)
                if length > MAX_MSG_SIZE:
                    if allow_corruption_tail:
                        return
                    raise WALCorruptionError("frame length out of range")
                data = f.read(length)
                if len(data) < length:
                    return  # torn write
                if zlib.crc32(data) != crc:
                    if allow_corruption_tail:
                        return
                    raise WALCorruptionError("crc mismatch")
                try:
                    yield safe_codec.loads(data)
                except Exception:
                    if allow_corruption_tail:
                        return
                    raise

    @staticmethod
    def iter_messages(path: str, allow_corruption_tail: bool = True):
        """Yield messages across rotated chunks + head, oldest first; a
        torn/corrupt tail (crash mid-write) stops iteration cleanly when
        allow_corruption_tail (reference repairWalFile
        consensus/state.go:330-366).  Only the FINAL file can legitimately
        have a torn tail — corruption in an earlier rotated chunk would
        silently hole the replay stream, so it raises regardless."""
        paths = list_group_paths(path)
        for i, p in enumerate(paths):
            is_last = i == len(paths) - 1
            yield from WAL._iter_file(
                p, allow_corruption_tail and is_last)

    @staticmethod
    def search_for_end_height(path: str, height: int) -> bool:
        """True if an EndHeightMessage(height) exists (reference
        consensus/wal.go:221)."""
        for msg in WAL.iter_messages(path):
            if isinstance(msg, EndHeightMessage) and msg.height == height:
                return True
        return False

    @staticmethod
    def messages_after_end_height(path: str, height: int):
        """(messages, found): all messages after EndHeightMessage(height) —
        the replay set for resuming height+1.  found=False when the marker
        is absent (callers must fail loudly, reference consensus/replay.go
        'WAL does not contain #ENDHEIGHT')."""
        out: List = []
        seen = False
        for msg in WAL.iter_messages(path):
            if isinstance(msg, EndHeightMessage):
                if msg.height == height:
                    seen = True
                    out = []
                continue
            if seen:
                out.append(msg)
        return out, seen
