"""Rotating file group (reference libs/autofile/group.go).

A Group writes to a head file and rotates it into numbered chunks
(`path.000`, `path.001`, ...) once the head exceeds head_size_limit
(reference group.go:301 RotateFile); when the group's total size exceeds
total_size_limit the oldest chunks are deleted (checkTotalSizeLimit).
Readers iterate chunks oldest-first then the head, giving a single
logical byte stream — the consensus WAL's substrate.
"""
from __future__ import annotations

import os
import re
import threading
from typing import List, Optional

DEFAULT_HEAD_SIZE_LIMIT = 10 * 1024 * 1024     # group.go:26
DEFAULT_TOTAL_SIZE_LIMIT = 1024 * 1024 * 1024  # group.go:27


def list_group_paths(head_path: str) -> List[str]:
    """Chunks oldest-first then the head, WITHOUT opening/creating any
    file (read-side helper)."""
    d = os.path.dirname(head_path) or "."
    base = os.path.basename(head_path)
    pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
    found = []
    if os.path.isdir(d):
        for name in os.listdir(d):
            m = pat.match(name)
            if m:
                found.append((int(m.group(1)), os.path.join(d, name)))
    return [p for _, p in sorted(found)] + [head_path]


class Group:
    def __init__(self, head_path: str,
                 head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT,
                 total_size_limit: int = DEFAULT_TOTAL_SIZE_LIMIT):
        os.makedirs(os.path.dirname(head_path) or ".", exist_ok=True)
        self.head_path = head_path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self._lock = threading.RLock()
        self._head = open(head_path, "ab")

    # -- chunk bookkeeping ---------------------------------------------------

    def chunk_paths(self) -> List[str]:
        """Rotated chunk paths, oldest first."""
        return list_group_paths(self.head_path)[:-1]

    def all_paths(self) -> List[str]:
        """Chunks oldest-first, then the head — the logical stream order."""
        return list_group_paths(self.head_path)

    def total_size(self) -> int:
        return sum(os.path.getsize(p) for p in self.all_paths()
                   if os.path.exists(p))

    # -- writing -------------------------------------------------------------

    def write(self, data: bytes):
        with self._lock:
            self._head.write(data)

    def flush_and_sync(self):
        with self._lock:
            self._head.flush()
            os.fsync(self._head.fileno())

    def maybe_rotate(self):
        """Rotate the head into a numbered chunk if it exceeds the head
        size limit, then enforce the total size limit (reference
        group.go:241-330 processTicks/RotateFile)."""
        with self._lock:
            if self._head.tell() < self.head_size_limit:
                return
            self._head.flush()
            os.fsync(self._head.fileno())
            self._head.close()
            chunks = self.chunk_paths()
            next_idx = 0
            if chunks:
                next_idx = int(chunks[-1].rsplit(".", 1)[1]) + 1
            os.replace(self.head_path, f"{self.head_path}.{next_idx:03d}")
            self._head = open(self.head_path, "ab")
            self._enforce_total_size()

    def _enforce_total_size(self):
        while self.total_size() > self.total_size_limit:
            chunks = self.chunk_paths()
            if not chunks:
                return
            os.remove(chunks[0])

    def close(self):
        with self._lock:
            self._head.flush()
            self._head.close()
