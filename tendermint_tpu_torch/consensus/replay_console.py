"""WAL replay console (reference consensus/replay_file.go): step through a
consensus WAL message by message — `tendermint_tpu replay` (all at once)
and `replay-console` (interactive).

The console decodes and pretty-prints the WAL frame stream (message type,
height/round, origin) with single-stepping and run-to-boundary controls; it
does not re-execute the state machine — crash-recovery semantics are
exercised by the WAL catchup replay itself (consensus/state.py
_catchup_replay, tests/test_consensus.py).
"""
from __future__ import annotations

import sys
from typing import List, Optional

from tendermint_tpu_torch.consensus.round_types import (
    BlockPartMessage, ProposalMessage, TimeoutInfo, VoteMessage)
from tendermint_tpu_torch.consensus.wal import WAL, EndHeightMessage


def _describe(msg) -> str:
    if isinstance(msg, EndHeightMessage):
        return f"ENDHEIGHT {msg.height}"
    if isinstance(msg, tuple) and len(msg) == 2:
        inner, peer = msg
        src = f" from={peer}" if peer else " (internal)"
        if isinstance(inner, VoteMessage):
            v = inner.vote
            return (f"Vote {v.type.name} h={v.height} r={v.round} "
                    f"val={v.validator_index}{src}")
        if isinstance(inner, ProposalMessage):
            pr = inner.proposal
            return f"Proposal h={pr.height} r={pr.round}{src}"
        if isinstance(inner, BlockPartMessage):
            return (f"BlockPart h={inner.height} r={inner.round} "
                    f"i={inner.part.index}{src}")
        if isinstance(inner, TimeoutInfo):
            return (f"Timeout h={inner.height} r={inner.round} "
                    f"step={inner.step.name}")
        return f"{type(inner).__name__}{src}"
    return type(msg).__name__


def replay_messages(wal_path: str,
                    console: bool = False,
                    out=sys.stdout,
                    input_fn=input) -> int:
    """Print (and optionally single-step) the WAL stream.  Returns the
    number of messages shown.  Commands in console mode: n[ext] (default),
    r[un] to the end, l[ocate] the next ENDHEIGHT, q[uit]."""
    shown = 0
    run_to_end = False
    run_to_boundary = False
    for i, msg in enumerate(WAL.iter_messages(wal_path)):
        line = f"[{i:6d}] {_describe(msg)}"
        print(line, file=out)
        shown += 1
        boundary = isinstance(msg, EndHeightMessage)
        if run_to_boundary and boundary:
            run_to_boundary = False
        if not console or run_to_end or run_to_boundary:
            continue
        while True:
            try:
                cmd = (input_fn("(walrepl) ") or "n").strip().lower()
            except EOFError:
                return shown
            if cmd in ("n", "next", ""):
                break
            if cmd in ("r", "run"):
                run_to_end = True
                break
            if cmd in ("l", "locate"):
                run_to_boundary = True
                break
            if cmd in ("q", "quit", "exit"):
                return shown
            print("commands: n(ext) | r(un) | l(ocate next ENDHEIGHT) "
                  "| q(uit)", file=out)
    return shown
