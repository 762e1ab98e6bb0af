"""Mesh sharding for the verification data plane: reduced to the staging
chunk knob.

The JAX package's parallel/sharding.py shards a verification batch
across a device mesh (the data planes, the lockstep windows, the sharded
verifiers).  Those wait for ROADMAP Queue 1 item 11 and are not here.
This module keeps only the staging chunk knob (`mesh_chunk_raw`,
`mesh_chunk_lanes`, `_static_chunk_lanes`, `set_mesh_chunk`, copied with
the package path mapped), which the node's control plane registers as
its `mesh_chunk_lanes` knob (node/node.py `_register_knobs`).  On one
card no plane reads it yet.
"""
from __future__ import annotations

import os

from tendermint_tpu_torch.ops import ed25519 as edops

# ---------------------------------------------------------------------------
# staging chunk knob (ADR-027).  The overlapped mesh paths stage the
# batch as double-buffered chunks of nshard * mesh_chunk_lanes() rows:
# smaller chunks hide more H2D behind compute (higher chunk_overlap)
# at the cost of more dispatches.  The control plane steers the RAW
# value (KnobSpec "mesh_chunk_lanes", signal chunk_overlap); the
# EFFECTIVE chunk is the raw value's power-of-two floor.
#
# The knob governs the LOCAL plane only.  A cross-process plane must pin
# its chunk size to the code-constant default (_static_chunk_lanes),
# identical on every process by construction.
# ---------------------------------------------------------------------------

MESH_CHUNK_DEFAULT = edops.SPLIT_CHUNK  # per-shard lanes per H2D chunk
_MESH_CHUNK_MIN = 256
_mesh_chunk_override = None


def mesh_chunk_raw() -> int:
    """The raw (unrounded) chunk knob value — the coordinate the
    control plane reads and writes."""
    v = _mesh_chunk_override
    if v is None:
        try:
            v = int(os.environ.get("TM_TPU_MESH_CHUNK",
                                   MESH_CHUNK_DEFAULT))
        except (TypeError, ValueError):
            v = MESH_CHUNK_DEFAULT
    return int(v)


def mesh_chunk_lanes() -> int:
    """Effective per-shard lanes of one staging chunk: the raw knob
    clamped into [_MESH_CHUNK_MIN, MAX_CHUNK] and floored to a power
    of two."""
    v = max(_MESH_CHUNK_MIN, min(mesh_chunk_raw(), edops.MAX_CHUNK))
    return 1 << (v.bit_length() - 1)


def _static_chunk_lanes() -> int:
    """The chunk size with every per-process input excluded — no env
    var, no override, no governed knob, just the code-constant default
    clamped and floored exactly like mesh_chunk_lanes().  This is the
    only chunk value safe to bake into a cross-process collective's
    shape: identical on every process running the same build."""
    v = max(_MESH_CHUNK_MIN, min(MESH_CHUNK_DEFAULT, edops.MAX_CHUNK))
    return 1 << (v.bit_length() - 1)


def set_mesh_chunk(lanes=None):
    """Node-config / control-plane seam for the staging chunk.  None
    reverts to the env/default (TM_TPU_MESH_CHUNK, same contract as
    edops.set_comb_config)."""
    global _mesh_chunk_override
    _mesh_chunk_override = None if lanes is None else int(lanes)
