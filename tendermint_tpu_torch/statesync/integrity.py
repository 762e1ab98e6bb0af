"""Per-chunk snapshot integrity (ADR-022).

The reference snapshot protocol (statesync/chunks.go) hands every
fetched chunk to the app and only finds out a peer lied when the
restore's final app-hash check fails — one corrupt chunk costs the
whole download and cannot be attributed to its sender.  This module
gives a snapshot self-describing chunk integrity: the serving side
packs the SHA-256 digest of every chunk into the snapshot's free-form
``metadata`` field together with the RFC-6962 merkle root over those
digests (crypto/merkle's iterative, host-vectorized reduction), and
the fetch plane verifies each chunk against its digest ON THE FETCH
THREAD, before the app ever sees peer bytes.

Trust model: the digests come from the advertising peer and are
self-consistent (the embedded root must re-derive from the digest
list, so a malformed advertisement is refused at discovery), but the
ROOT of trust stays the light-client-verified app hash checked after
the restore — a Byzantine advertiser can still lie coherently, and
then the final check rejects the snapshot exactly as before.  What
the digests buy is attribution and locality: a bad chunk is detected
at fetch time, charged to its sender (ban + refetch elsewhere), and
costs one chunk instead of one restore.

Snapshots without this metadata (other apps, older peers) verify
nothing per chunk and keep the reference end-to-end behavior.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

from tendermint_tpu_torch.crypto.merkle import hash_from_byte_slices

# magic + root(32) + chunks * digest(32)
CHUNK_META_MAGIC = b"CKH1"
_DIGEST_LEN = 32


def make_chunk_metadata(chunks: List[bytes]) -> bytes:
    """Serving side: digest every chunk and bind the list under one
    merkle root (the iterative host reduction — one hashlib pass per
    level, no recursion)."""
    digests = [hashlib.sha256(c).digest() for c in chunks]
    root = hash_from_byte_slices(digests)
    return CHUNK_META_MAGIC + root + b"".join(digests)


def parse_chunk_metadata(metadata: bytes,
                         nchunks: int) -> Optional[List[bytes]]:
    """Digest list carried in a snapshot's metadata, or None when the
    snapshot doesn't carry one (legacy format — per-chunk verification
    is skipped and the app's end-to-end check is the only guard).
    A PRESENT-but-inconsistent header (bad length, root mismatch,
    wrong chunk count) also returns None: treat a malformed
    advertisement like an unverifiable one rather than trusting half
    a header."""
    if not metadata or not metadata.startswith(CHUNK_META_MAGIC):
        return None
    body = metadata[len(CHUNK_META_MAGIC):]
    if len(body) < _DIGEST_LEN:
        return None
    root, rest = body[:_DIGEST_LEN], body[_DIGEST_LEN:]
    if len(rest) % _DIGEST_LEN != 0:
        return None
    digests = [rest[i:i + _DIGEST_LEN]
               for i in range(0, len(rest), _DIGEST_LEN)]
    if len(digests) != nchunks:
        return None
    if hash_from_byte_slices(digests) != root:
        return None
    return digests


def verify_chunk(digests: List[bytes], index: int, chunk: bytes) -> bool:
    """One chunk against its advertised digest (the fetch-thread
    check)."""
    if not 0 <= index < len(digests):
        return False
    return hashlib.sha256(chunk).digest() == digests[index]


def verify_chunks(digests: Optional[List[bytes]],
                  stored: dict) -> List[int]:
    """Host-vectorized prefix re-verification for crash resume: hash
    every stored chunk in one pass and return the indices whose bytes
    still match their digest (hashlib releases the GIL on large
    buffers, so this is one tight C loop over the restore ledger's
    contents).  With no digest list every stored chunk is returned —
    the app's end-to-end hash check remains the guard, exactly as for
    a live legacy fetch."""
    if digests is None:
        return sorted(stored)
    return sorted(i for i, c in stored.items()
                  if verify_chunk(digests, i, c))
