"""The port's consensus WAL (libs/autofile's Group, consensus/wal,
consensus/wal_generator, consensus/replay_console) against the JAX
package's, on the CPU.

tests/test_wal_group.py's five cases run through both packages (the `pkg`
parameter; the port's generator on device="cpu").  Then the records: the
same messages, built in each package from the same fields, are written
to a WAL of each package and read back equal field by field (through
`plain`); the framing is the same (a CRC32 and a length ahead of each
record, rotation at height boundaries only).  A stored WAL does not cross
the packages: its records are safe-codec pickles, which name their
classes' module, so each package's strict reader refuses the other's
file.
Tolerance: exact equality everywhere.
"""
from __future__ import annotations

import importlib
import io
import os
import pickle
import struct
import types
import zlib

import pytest

from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_MODS = {
    "autofile": "libs.autofile", "wal": "consensus.wal",
    "walgen": "consensus.wal_generator", "console": "consensus.replay_console",
    "rt": "consensus.round_types", "basic": "types.basic",
    "vote": "types.vote", "proposal": "types.proposal",
    "part_set": "types.part_set", "merkle": "crypto.merkle",
    "codec": "libs.safe_codec",
}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


# ---------------------------------------------------------------------------
# tests/test_wal_group.py
# ---------------------------------------------------------------------------

def test_group_rotation_and_pruning(pkg, tmp_path):
    A = pkg.autofile
    head = str(tmp_path / "g" / "wal")
    g = A.Group(head, head_size_limit=100, total_size_limit=450)
    for _ in range(20):
        g.write(b"x" * 60)
        g.maybe_rotate()
    g.close()
    chunks = A.list_group_paths(head)[:-1]
    assert chunks, "no rotation happened"
    total = sum(os.path.getsize(p) for p in A.list_group_paths(head))
    assert total <= 450 + 120
    assert not os.path.exists(head + ".000")


def _write_heights(p, path, heights, per_height=4, tag="msg"):
    w = p.wal.WAL(path, head_size_limit=200)  # tiny: rotate every height
    for h in heights:
        for i in range(per_height):
            w.write((f"{tag}-{h}-{i}", ""))
        w.write_sync(p.wal.EndHeightMessage(h))
    w.close()


def test_wal_replay_spans_rotated_chunks(pkg, tmp_path):
    W = pkg.wal
    path = str(tmp_path / "wal")
    _write_heights(pkg, path, range(1, 8))
    assert pkg.autofile.list_group_paths(path)[:-1], "expected chunks"
    msgs = list(W.WAL.iter_messages(path))
    assert sum(1 for m in msgs if isinstance(m, W.EndHeightMessage)) == 7
    after, found = W.WAL.messages_after_end_height(path, 5)
    assert found
    assert [m for m in after if not isinstance(m, W.EndHeightMessage)] == [
        (f"msg-{h}-{i}", "") for h in (6, 7) for i in range(4)]
    assert W.WAL.search_for_end_height(path, 7)
    assert not W.WAL.search_for_end_height(path, 99)


def test_wal_generator_produces_replayable_wal(pkg, tmp_path):
    W = pkg.wal
    path = str(tmp_path / "genwal" / "wal")
    pkg.walgen.generate_wal(path, num_blocks=3)
    heights = [m.height for m in W.WAL.iter_messages(path)
               if isinstance(m, W.EndHeightMessage)]
    assert heights[:4] == [0, 1, 2, 3]
    after, found = W.WAL.messages_after_end_height(path, 2)
    assert found and after


def test_replay_console_streams_and_steps(pkg, tmp_path):
    path = str(tmp_path / "rc" / "wal")
    pkg.walgen.generate_wal(path, num_blocks=2)
    out = io.StringIO()
    total = pkg.console.replay_messages(path, console=False, out=out)
    assert total > 4
    assert "ENDHEIGHT 2" in out.getvalue()
    cmds = iter(["l", "q"])
    out2 = io.StringIO()
    shown = pkg.console.replay_messages(path, console=True, out=out2,
                                        input_fn=lambda _: next(cmds))
    assert 0 < shown < total


def test_corrupt_rotated_chunk_raises(pkg, tmp_path):
    W = pkg.wal
    path = str(tmp_path / "cw" / "wal")
    _write_heights(pkg, path, range(1, 6), tag="m")
    chunks = pkg.autofile.list_group_paths(path)[:-1]
    assert chunks
    with open(chunks[0], "r+b") as f:
        f.seek(30)
        b = f.read(1)
        f.seek(30)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(W.WALCorruptionError):
        list(W.WAL.iter_messages(path))
    with open(path, "ab") as f:
        f.write(b"\x00\x01\x02")  # a torn tail in the head is tolerated
    with open(chunks[0], "r+b") as f:
        f.seek(30)
        f.write(b)
    msgs = list(W.WAL.iter_messages(path))
    assert sum(1 for m in msgs if isinstance(m, W.EndHeightMessage)) == 5


# ---------------------------------------------------------------------------
# the records, field by field
# ---------------------------------------------------------------------------

def _records(p):
    """One of each record the state machine logs, from the same fields:
    (message, peer id) pairs for a proposal, a block part, a vote and a
    timeout, then a height boundary."""
    B, R = p.basic, p.rt
    bid = B.BlockID(b"\x21" * 32, B.PartSetHeader(2, b"\x22" * 32))
    vote = p.vote.Vote(type=B.SignedMsgType.PREVOTE, height=3, round=1,
                       block_id=bid, timestamp=B.Timestamp(1700000003, 7),
                       validator_address=b"\x33" * 20, validator_index=2,
                       signature=b"\x44" * 64)
    prop = p.proposal.Proposal(height=3, round=1, pol_round=0, block_id=bid,
                               timestamp=B.Timestamp(1700000002, 1),
                               signature=b"\x55" * 64)
    part = p.part_set.Part(index=0, bytes_=b"\x66" * 80, proof=p.merkle.Proof(
        total=2, index=0, leaf_hash=b"\x77" * 32, aunts=[b"\x88" * 32]))
    return [
        (R.ProposalMessage(prop), "peerA"),
        (R.BlockPartMessage(3, 1, part), "peerA"),
        (R.VoteMessage(vote), ""),
        (R.TimeoutInfo(0.25, 3, 1, R.Step.PREVOTE_WAIT), ""),
        p.wal.EndHeightMessage(3),
    ]


def _frames(path):
    """(crc, length, payload) of every frame of a WAL file."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        crc, n = struct.unpack(">II", data[off:off + 8])
        out.append((crc, n, data[off + 8:off + 8 + n]))
        off += 8 + n
    return out


def test_records_equal_field_by_field(tmp_path):
    """The same records written by each package read back to the same
    fields; each frame is a CRC32 of its payload, its length, and the
    payload, which the package's own safe codec loads."""
    got = {}
    for p in PKGS:
        path = str(tmp_path / p.name / "wal")
        w = p.wal.WAL(path)
        for r in _records(p):
            w.write(r)
        w.flush_and_sync()
        w.close()
        back = list(p.wal.WAL.iter_messages(path,
                                            allow_corruption_tail=False))
        got[p.name] = plain(back)
        frames = _frames(path)
        assert len(frames) == len(back) == 5
        for crc, n, payload in frames:
            assert len(payload) == n and zlib.crc32(payload) == crc
            assert plain(p.codec.loads(payload)) is not None
    assert got["jax"] == got["port"]
    assert got["port"][-1] == ("EndHeightMessage", {"height": 3})
    assert got["port"][3][0] == ("TimeoutInfo", {
        "duration": 0.25, "height": 3, "round": 1, "step": 5})


def test_rotation_points_equal(tmp_path):
    """With a head limit of one byte both packages rotate at every height
    boundary and never inside a height: the chunks hold the same records.
    (At a byte limit the points may differ: a record's pickle names its
    package, and the port's name is six bytes longer.)"""
    layout = {}
    for p in PKGS:
        path = str(tmp_path / p.name / "wal")
        w = p.wal.WAL(path, head_size_limit=1)
        for h in range(1, 9):
            for i in range(3):
                w.write((f"msg-{h}-{i}", ""))
            w.write_sync(p.wal.EndHeightMessage(h))
        w.close()
        paths = p.autofile.list_group_paths(path)
        layout[p.name] = [
            plain(list(p.wal.WAL._iter_file(q, allow_corruption_tail=False)))
            for q in paths]
    assert len(layout["port"]) == 9  # eight chunks and an empty head
    assert layout["jax"] == layout["port"]


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_stored_wal_does_not_cross_packages(tmp_path, writer, reader):
    """A WAL written by one package is refused by the other's strict
    reader: its records name the writer's modules, which the reader's safe
    codec does not allow.  The tolerant reader stops at the first record,
    as at a torn tail."""
    path = str(tmp_path / "x" / "wal")
    w = writer.wal.WAL(path)
    for r in _records(writer):
        w.write(r)
    w.close()
    with pytest.raises(pickle.UnpicklingError, match="is not allowed"):
        list(reader.wal.WAL.iter_messages(path, allow_corruption_tail=False))
    assert list(reader.wal.WAL.iter_messages(path)) == []
    assert len(list(writer.wal.WAL.iter_messages(path))) == 5
