"""Mesh sharding for the verification data plane: a batch split over
several GPU positions, the lockstep-gated global plane over
torch.distributed, and the sharded RLC, comb and ladder routes.

The counterpart of tendermint_tpu/parallel/sharding.py, copied with the
package path mapped.  The JAX package shards a batch over a
jax.sharding.Mesh and lets XLA insert the collectives (an all-gather of
the per-lane bitmap, a psum of the all-valid bit).  Here each mesh
position is a torch.device that runs the ported kernel on its rows of the
batch, and the reduction is explicit:

  route              per position                    reduction
  mesh-cuda          K1 on its lanes of the packed   bitmap concatenated
  (_verify_packed)   (128, nb) rows                  in position order
  mesh-xla, global-  K3 on its lanes of the compact  bitmap gathered;
  mesh, mesh-sharded (prepare_batch_compact) rows    all-valid = AND over
  (_verify_compact,                                  the live lanes
  make_sharded_verifier)
  mesh-comb          C2 with its own table copy      bitmap in lane order
  mesh-comb-sharded  C2 with its slice of the tables (inverse permutation)
  rlc-sharded        K4, the sort, K5 and A1 on its  window sums added as
  (msm_window_sums)  rows; zs on position 0 only     points on the host;
                                                     decode-ok AND,
                                                     overflow OR

The route names are the JAX package's ("mesh-xla" is its name for the
staged-ladder route, which K3 runs here), but for "mesh-cuda", the
counterpart of its "mesh-pallas".  A CUDA plane takes mesh-cuda for a
verify_batch, a CPU plane the compact route, as the JAX package takes its
Pallas route only on a TPU.  On a CPU position the kernels' plain versions
run.

The port's departures:

  * a Mesh is a list of torch.devices, one per position, and a device may
    repeat: the CPU tests run 8 positions on the CPU and the card's smoke
    4 on one card.  make_mesh(None) means every local CUDA card.  Each
    position gets its own copy of what it reads (the comb tables but for
    the build copy, its rows of the batch);
  * on a local plane the reduction runs without a process group: the
    positions' outputs are read back to the host and reduced there, the
    window sums of the sharded MSM by ops/msm's integer point addition;
  * the global plane's positions are every rank's local devices, rank
    major, each rank staging and launching only its own.  The bitmaps are
    all-gathered and the all-valid bit all-reduced with torch.distributed
    on the backend the process group was created with: with NCCL the
    outputs stay on the card, with gloo they are copied to host tensors
    first (the kernels still run on the card).  The plane never changes
    the backend.  The coordination service is the process group's c10d
    store: the poison keys are read with its non-blocking check, and the
    barrier is a set of keys waited for under the reference's timeout;
  * the packed route injects at sharding.mesh_stage as the compact one
    does;
  * a CUDA position whose kernel raises raises degrade.DeviceLaneError:
    no position and no batch falls back to a plain version.

The staging chunk knob (`mesh_chunk_raw`, `mesh_chunk_lanes`,
`_static_chunk_lanes`, `set_mesh_chunk`) is the node's control-plane
knob `mesh_chunk_lanes` (node/node.py `_register_knobs`).
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager, nullcontext
from datetime import timedelta

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519 as edops

BATCH_AXIS = "batch"


class Mesh:
    """The positions of a plane: `devices`, one torch.device a position
    (a device may repeat), on the axis `axis`.  `ranks` names the process
    that owns each position (a global plane's); None means this process
    owns them all."""

    def __init__(self, devices, axis: str = BATCH_AXIS, ranks=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one position")
        types = {d.type for d in self.devices}
        if len(types) != 1:
            raise ValueError(f"a mesh holds one device type, got {types}")
        self.device_type = types.pop()
        self.axis = axis
        self.nshard = len(self.devices)
        self.ranks = None if ranks is None else [int(r) for r in ranks]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def _cuda_devices() -> list:
    """Every local CUDA card; [] without CUDA (never raises)."""
    try:
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    except Exception:  # noqa: BLE001 - a broken driver reads as no card
        return []


def _local_devices() -> list:
    """This process's devices: its CUDA cards, or the CPU alone."""
    return _cuda_devices() or [torch.device("cpu")]


def make_mesh(devices=None, axis: str = BATCH_AXIS) -> Mesh:
    """A mesh over `devices` (torch.devices or their names; a device may
    repeat).  None means every local CUDA card, and raises RuntimeError
    when CUDA is missing."""
    if devices is None:
        devices = _cuda_devices()
        if not devices:
            raise RuntimeError(
                "tendermint_tpu_torch: CUDA is not available; pass the "
                "mesh's devices (e.g. make_mesh(['cpu'] * 8))")
    return Mesh(list(devices), axis)


# ---------------------------------------------------------------------------
# staging chunk knob (ADR-027).  The overlapped mesh paths stage the
# batch as double-buffered chunks of nshard * mesh_chunk_lanes() rows:
# smaller chunks hide more H2D behind compute (higher chunk_overlap)
# at the cost of more dispatches.  The control plane steers the RAW
# value (KnobSpec "mesh_chunk_lanes", signal chunk_overlap); the
# EFFECTIVE chunk is the raw value's power-of-two floor.
#
# The knob governs the LOCAL plane only.  The global plane's chunk
# count is part of a cross-process collective's shape: every process
# must launch the same chunks in the same order, and the knob is
# steered per-process, so two peers whose knobs drift across a
# power-of-two boundary would enter mismatched collectives — a
# deadlock.  _GlobalDataPlane therefore pins its chunk size to the
# code-constant default (_static_chunk_lanes), identical on every
# process by construction.
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


_PLANE = None
_PLANE_KEY = None      # local-topology fingerprint the plane latched on
_GLOBAL_PLANE = None
_PLANE_LOCK = threading.Lock()


def _topology_key():
    """The local cards as (index, name, UUID); () without CUDA, None when
    the driver cannot be read.  Never raises."""
    try:
        out = []
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            out.append((i, p.name, str(getattr(p, "uuid", ""))))
        return tuple(out)
    except Exception:  # noqa: BLE001 - backend down reads as "no devices"
        return None


def data_plane():
    """The process-wide mesh data plane over every local card, or None on
    a host with fewer than two.

    ops/ed25519.verify_batch consults it on every call, so every verifier
    of the node shards across all LOCAL cards; the global multi-process
    plane lives behind global_plane() and is reachable only from
    coordinated lockstep() call sites (ADR-027).  Thread-safe.
    TM_TPU_NO_MESH=1 forces one device.  The latch is topology-keyed:
    degrade's backend re-probe calls invalidate_on_topology_change() so a
    backend that comes up after the first probe gets its mesh."""
    global _PLANE, _PLANE_KEY
    if _PLANE is None:
        with _PLANE_LOCK:
            if _PLANE is None:
                _PLANE_KEY = _topology_key()
                if os.environ.get("TM_TPU_NO_MESH") == "1":
                    _PLANE = False
                else:
                    devs = _local_devices()
                    _PLANE = _DataPlane(make_mesh(devs)) \
                        if len(devs) > 1 else False
    return _PLANE or None


def invalidate_on_topology_change() -> bool:
    """Drop a latched plane when the local device list no longer matches
    the one it latched on.  Called from degrade.backend_available() on
    every successful probe; rebuilding happens lazily on the next
    data_plane() call.  Returns True when a stale plane was dropped."""
    global _PLANE, _PLANE_KEY, _GLOBAL_PLANE
    with _PLANE_LOCK:
        if _PLANE is None:
            return False
        key = _topology_key()
        if key == _PLANE_KEY:
            return False
        _PLANE = None
        _PLANE_KEY = None
        _GLOBAL_PLANE = None
    _clear_poison()
    return True


# ---------------------------------------------------------------------------
# the global (multi-process) plane, gated to lockstep call sites
# (ADR-027).  A collective requires EVERY process to enter the same
# computation in the same order; reactor-driven traffic cannot guarantee
# that, so global_plane() only answers inside a lockstep() window —
# blocksync replay_window and the coordinated bulk verify.
# ---------------------------------------------------------------------------

_lockstep_tls = threading.local()


@contextmanager
def lockstep():
    """Mark the calling thread as inside a COORDINATED verify window:
    every participating process is entering the same verification calls
    in the same order.  Only such windows may reach the global plane —
    a collective one process skips deadlocks the rest (ADR-027)."""
    prev = getattr(_lockstep_tls, "depth", 0)
    _lockstep_tls.depth = prev + 1
    try:
        yield
    finally:
        _lockstep_tls.depth = prev


def in_lockstep() -> bool:
    return getattr(_lockstep_tls, "depth", 0) > 0


def _dist():
    """torch.distributed when a process group is initialised, else None."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist
    except Exception:  # noqa: BLE001 - a build without distributed
        pass
    return None


def _world_size() -> int:
    """The process group's size; 1 without one.  Never raises."""
    d = _dist()
    try:
        return int(d.get_world_size()) if d is not None else 1
    except Exception:  # noqa: BLE001 - a group being torn down
        return 1


def _rank() -> int:
    """This process's rank; 0 without a process group.  Never raises."""
    d = _dist()
    try:
        return int(d.get_rank()) if d is not None else 0
    except Exception:  # noqa: BLE001 - a group being torn down
        return 0


def global_mesh_ready() -> bool:
    """True when torch.distributed is initialised with more than one
    process and the mesh is not disabled — the precondition for the
    global plane.  Never raises (callers probe it on hot paths)."""
    if os.environ.get("TM_TPU_NO_MESH") == "1" or \
            os.environ.get("TM_TPU_NO_GLOBAL_MESH") == "1":
        return False
    return _world_size() > 1


def global_plane():
    """The cross-process plane over every rank's local devices, or None.
    Only returned INSIDE a lockstep() window on a multi-process runtime —
    everywhere else callers get None and stay on the local plane.  A
    peer's latch-off poisons a store key; the throttled check here
    latches THIS process too, so one faulted participant costs the job
    at most the in-flight batch (ADR-027).  Every rank is taken to hold
    as many local devices as this one."""
    global _GLOBAL_PLANE
    if not in_lockstep() or not global_mesh_ready():
        return None
    if _GLOBAL_PLANE is None:
        with _PLANE_LOCK:
            if _GLOBAL_PLANE is None:
                try:
                    world = _world_size()
                    local = _local_devices()
                except Exception:  # noqa: BLE001 - backend down
                    return None
                devs = [d for _ in range(world) for d in local]
                ranks = [r for r in range(world) for _ in local]
                _GLOBAL_PLANE = _GlobalDataPlane(
                    Mesh(devs, ranks=ranks)) if len(devs) > 1 else False
    if _GLOBAL_PLANE and _peer_latched_off():
        with _PLANE_LOCK:
            _GLOBAL_PLANE = False
    return _GLOBAL_PLANE or None


def _coord_client():
    """The process group's c10d store, or None when there is no process
    group or the store cannot be reached."""
    if _dist() is None:
        return None
    try:
        from torch.distributed import distributed_c10d as c10d
        return c10d._get_default_store()
    except Exception:  # noqa: BLE001 - a build without the store
        return None


# every process that latches the global plane off writes a key under
# this directory; peers check it (throttled, non-blocking) so a
# persistent per-process latch converges across the job instead of
# draining one degrade timeout per peer per batch
_GMESH_POISON_DIR = "tm_tpu_gmesh_disabled"
_POISON_CHECK_EVERY_S = 2.0
_poison_next_check = 0.0
_poison_seen = False
_barrier_gen: dict = {}


def disable_global_plane():
    """Latch the global plane OFF for this process (ops/ed25519 calls
    this when a collective or a card faults under it; degrade's settle
    calls it when a lockstep launch wedges past the launch deadline).
    The latch holds until a topology change re-probe clears it.  The
    latch is also published to the store (best-effort) so healthy peers
    stop routing lockstep batches into a collective this process will
    never enter again (see global_plane)."""
    global _GLOBAL_PLANE
    with _PLANE_LOCK:
        _GLOBAL_PLANE = False
    client = _coord_client()
    if client is None:
        return
    try:
        client.set(f"{_GMESH_POISON_DIR}/{_rank()}", "1")
    except Exception:  # noqa: BLE001 - poison publication is advisory;
        pass            # peers still converge on their own timeouts


def _peer_latched_off() -> bool:
    """True when any process of the job has published a global-plane
    latch-off.  Non-blocking (the store's check) and throttled to one
    round of checks per _POISON_CHECK_EVERY_S; never raises."""
    global _poison_next_check, _poison_seen
    if _poison_seen:
        return True
    client = _coord_client()
    if client is None:
        return False
    now = time.monotonic()
    if now < _poison_next_check:
        return False
    _poison_next_check = now + _POISON_CHECK_EVERY_S
    try:
        seen = any(client.check([f"{_GMESH_POISON_DIR}/{r}"])
                   for r in range(_world_size()))
    except Exception:  # noqa: BLE001 - store unreachable: the
        return False    # per-process latches still converge
    _poison_seen = bool(seen)
    return _poison_seen


def _clear_poison():
    """Topology re-probe cleared the local latch: drop the published
    poison keys too (best-effort — a re-probe is the one event that
    declares the collective worth retrying, ADR-027)."""
    global _poison_next_check, _poison_seen
    _poison_seen = False
    _poison_next_check = 0.0
    client = _coord_client()
    if client is None:
        return
    try:
        for r in range(_world_size()):
            client.delete_key(f"{_GMESH_POISON_DIR}/{r}")
    except Exception:  # noqa: BLE001 - stale poison then re-latches
        pass            # via _peer_latched_off, never crashes a probe


def _barrier(name: str, timeout_ms: int = 240_000):
    """Cross-process rendezvous on the store (no-op without a process
    group): the global plane barriers after each kernel build so no
    process enters a collective a peer is still building for.  Each
    process sets `<name>/<gen>/<rank>` and waits for every rank's key.  A
    REAL rendezvous failure (timeout, missing peer) propagates:
    verify_batch's handler turns it into a latched local fallback."""
    client = _coord_client()
    if client is None:
        return
    gen = _barrier_gen[name] = _barrier_gen.get(name, 0) + 1
    base = f"{name}/{gen}"
    client.set(f"{base}/{_rank()}", "1")
    client.wait([f"{base}/{r}" for r in range(_world_size())],
                timedelta(milliseconds=timeout_ms))


# ---------------------------------------------------------------------------
# helpers of the per-position launches
# ---------------------------------------------------------------------------

def _device_ctx(dev: torch.device):
    """The CUDA device context of a position (nothing on the CPU), so that
    events and streams of its launches are its card's."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _card_error(pos: int, dev: torch.device, e: BaseException):
    """The DeviceLaneError a CUDA position raises for a kernel fault."""
    from tendermint_tpu_torch.crypto import degrade
    if isinstance(e, degrade.DeviceLaneError):
        return e
    return degrade.DeviceLaneError(
        f"mesh position {pos} on {dev}: {type(e).__name__}: {e}")


def _compact_rows(staged: dict, nb: int) -> np.ndarray:
    """ops/ed25519.prepare_batch_compact's lane-major rows as one (160, nb)
    uint8 array, pub | r | s | digest, the lanes past the batch zero."""
    n = staged["pub"].shape[1]
    rows = np.zeros((160, nb), dtype=np.uint8)
    for a, key in ((0, "pub"), (32, "r"), (64, "s"), (96, "digest")):
        src = np.asarray(staged[key]).view(np.uint8)
        rows[a:a + src.shape[0], :n] = src
    return rows


def _k3_rows(t: torch.Tensor) -> torch.Tensor:
    """K3 on a position's (160, lanes) compact rows."""
    from tendermint_tpu_torch.ops import cuda_ed25519 as ck
    return ck.verify_staged(t[0:32], t[32:64], t[64:96], t[96:160])


def _tables_slice(tables, a: int, b: int):
    """Keys [a, b) of comb_build's tables: C1's (64, 9, K, 4, 10) tensor
    or the plain version's Cached fields (64, 9, NLIMB, K)."""
    if isinstance(tables, torch.Tensor):
        return tables[:, :, a:b]
    return type(tables)(*(t[..., a:b] for t in tables))


def _tables_to(tables, dev: torch.device):
    """A contiguous copy of comb tables on `dev` (never an alias)."""
    def cp(t):
        return t.to(dev, copy=True).contiguous()
    if isinstance(tables, torch.Tensor):
        return cp(tables)
    return type(tables)(*(cp(t) for t in tables))


class _DataPlane:
    """Sharded verifiers over one mesh of local positions.

    Batch sizes are bucketed (pow2, rounded to a per-shard multiple of the
    kernel tile) as on one device."""

    MSM_MIN_PER_SHARD = 32
    MESH_PATH = "mesh-xla"      # the compact (K3) route
    PACKED_PATH = "mesh-cuda"   # the packed (K1) route
    FAIL_SITE = "sharding.mesh_stage"

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.nshard = mesh.nshard
        self.device_type = mesh.device_type
        self._fns = {}          # sealed chunk shapes
        self._lock = threading.Lock()

    @property
    def batch_path(self) -> str:
        """The route verify_batch takes on this plane."""
        return self.PACKED_PATH if self.device_type == "cuda" \
            else self.MESH_PATH

    def _chunk_lanes(self) -> int:
        """Per-shard lanes of one staging chunk.  The local plane reads
        the live governed knob; the global plane overrides with the
        static code constant — its chunk count is collective shape and
        must match on every process (module comment above)."""
        return mesh_chunk_lanes()

    def _local_positions(self):
        """(position, device) of every position this process launches."""
        return list(enumerate(self.mesh.devices))

    def worth_sharding(self, n: int) -> bool:
        """Small hot-path batches (a consensus vote window) stay on one
        device: below one kernel tile per shard on a CUDA plane the
        per-position launches and the gather cost more than they
        parallelize (the JAX package's Pallas rule; its other backends,
        like a CPU plane here, shard from one lane a position)."""
        if self.device_type == "cuda":
            return n >= self.nshard * edops.TILE
        return n >= self.nshard

    # -- RLC / Pippenger MSM over the mesh ---------------------------------

    def worth_sharding_msm(self, n: int) -> bool:
        """MSM sharding policy: bucket memory / scan depth, NOT lane
        count.  Sharding splits the M items nshard ways while keeping a
        full bucket table per shard, so it only wins while the per-shard
        mean bucket load still dominates the Poisson tail margin baked
        into T.  Shard when the per-shard scan work (T_s * K_pad_s
        lane-steps) models at least a ~1.5x speedup."""
        from tendermint_tpu_torch.ops import msm as msmops

        if self.nshard < 2:
            return False
        # minimum REAL rows per shard (pad rows are dead weight)
        if -(-n // self.nshard) < self.MSM_MIN_PER_SHARD:
            return False
        n_s = self.msm_bucket(n) // self.nshard
        nb1 = edops.bucket_size(n)
        shard_plan = msmops.Plan(n_s, msmops._pick_c(n_s))
        single_plan = msmops.Plan(nb1, msmops._pick_c(nb1))
        # (the JAX plan's K_pad rounds K to 256 lanes; every K here is a
        # multiple of 256 already)
        return 3 * shard_plan.T * shard_plan.K <= \
            2 * single_plan.T * single_plan.K

    def msm_bucket(self, n: int) -> int:
        """Padded batch size for a sharded MSM: the usual power-of-two
        bucket, rounded up so every shard gets an equal row count
        (remainder rows become zero-scalar basepoint pad rows —
        msm._pad_rows)."""
        nb = max(edops.bucket_size(n), self.nshard)
        return -(-nb // self.nshard) * self.nshard

    def msm_window_sums(self, r_bytes, pub_m, zk, z, zs, c: int,
                        probe: dict = None):
        """Sharded equivalent of one device's msm._msm_pipeline: each
        position runs K4, the device sort, K5 and A1 on its rows and
        returns PARTIAL window sums; only position 0 carries the real
        [sum z_i s_i]B scalar (the others' zeros land in the trash
        bucket).  The partials are read back and added as points on the
        host (nshard - 1 additions a window, Python integers); the
        decode-ok flags AND, the overflow flags OR.  Inputs are the
        padded staged arrays (rows divisible by nshard); `probe` (devobs)
        receives the summed put wall and the per-position ones.  Returns
        (window sums (4, W_A, 32) uint8 canonical bytes, decode_ok_all,
        overflow)."""
        from tendermint_tpu_torch.ops import msm as msmops

        nb = r_bytes.shape[0]
        assert nb % self.nshard == 0, (nb, self.nshard)
        zs_rows = np.zeros((self.nshard, 32), dtype=np.uint8)
        zs_rows[0] = zs
        walls = []
        staged = self._put_sharded(
            (np.asarray(r_bytes), np.asarray(pub_m), np.asarray(zk),
             np.asarray(z), zs_rows), walls=walls)
        outs = []
        for pos, dev in self._local_positions():
            r, p, k, zz, zsr = staged[pos]
            outs.append((pos, dev, self._launch(
                pos, dev, msmops._msm_pipeline, r, p, k, zz, zsr[0], c)))
        total, ok_all, overflow = None, True, False
        for pos, dev, (ws, ok, ovf) in outs:
            ws, ok, ovf = self._collect(
                pos, dev, lambda: (ws.cpu().numpy(), bool(ok), bool(ovf)))
            ok_all &= ok
            overflow |= ovf
            pts = _window_points(ws)
            total = pts if total is None else [
                msmops._add_int(a, b) for a, b in zip(total, pts)]
        if probe is not None and walls:
            probe["h2d_s"] = round(sum(walls), 6)
            probe["shard_h2d_s"] = [round(w, 6) for w in walls]
        return _window_bytes(total), ok_all, overflow

    # -- explicit per-shard staging (ADR-027) ------------------------------

    def _put_sharded(self, arrays, walls=None, axis: int = 0):
        """Stage a tuple of operands position by position: slice each
        operand's rows (on `axis`) for every position this process
        launches and copy the slices onto that position's device.  Returns
        {position: tuple of tensors}.  Appends one put wall a position to
        `walls` (the devobs per-shard H2D decomposition)."""
        out = {}
        for pos, dev in self._local_positions():
            t_put = time.perf_counter()
            parts = []
            for a in arrays:
                per = a.shape[axis] // self.nshard
                sl = a[pos * per:(pos + 1) * per] if axis == 0 \
                    else a[:, pos * per:(pos + 1) * per]
                src = np.ascontiguousarray(sl)
                if src.dtype == np.int8:
                    src = src.view(np.uint8)
                parts.append(torch.from_numpy(src).to(dev))
            out[pos] = tuple(parts)
            if walls is not None:
                walls.append(time.perf_counter() - t_put)
        return out

    @staticmethod
    def _launch(pos: int, dev: torch.device, fn, *args):
        """Run one position's kernel on its device.  On a CUDA position a
        raise is the card's: it leaves as degrade.DeviceLaneError, and no
        plain version runs in its place."""
        with _device_ctx(dev):
            if dev.type != "cuda":
                return fn(*args)
            try:
                return fn(*args)
            except Exception as e:  # noqa: BLE001 - see above
                raise _card_error(pos, dev, e) from e

    @staticmethod
    def _collect(pos: int, dev: torch.device, read):
        """Read a position's outputs back (`read()`); a CUDA fault that
        surfaces at the readback is the position's card fault too."""
        if dev.type != "cuda":
            return read()
        try:
            return read()
        except Exception as e:  # noqa: BLE001 - an asynchronous fault
            raise _card_error(pos, dev, e) from e

    def _gather(self, outs, live):
        """Reduce one chunk: `outs` [(position, device, bitmap tensor)] in
        position order, `live` the chunk's (lanes,) live mask.  Returns
        the chunk's bitmap (numpy bool, position order) and its all-valid
        bit (pad lanes read as valid).  The local plane reads the
        positions back and reduces on the host."""
        bm = np.concatenate([
            self._collect(pos, dev, lambda t=t: t.cpu().numpy())
            for pos, dev, t in outs]).astype(bool)
        return bm, bool((bm | ~live).all())

    # -- fixed-base comb over the mesh (ADR-013) ---------------------------

    def comb_mesh_mode(self, entry):
        """Budget-aware replication decision (ADR-027): 'repl' while a
        full table copy fits NEXT TO the build copy the table cache
        already charges, 'shard' when only a 1/nshard slice does (lanes
        grouped by table-owning shard so every gather stays local), None
        when even the slice blows the budget — the caller then runs the
        single-device comb (the tables are already resident there), NOT
        the ladder."""
        tbytes = entry.k_pad * edops._TABLE_BYTES_PER_KEY
        budget = edops.table_cache_budget_bytes()
        if 2 * tbytes <= budget:
            return "repl"
        if entry.k_pad % self.nshard == 0 and \
                tbytes + tbytes // self.nshard <= budget:
            return "shard"
        return None

    def verify_comb(self, r_b, s_b, k_b, vidx, entry, probe: dict = None):
        """Sharded comb launch over the FULL batch: the bitmap of the
        single-device comb, batch rows split across positions in chunks
        (_run_comb_chunks).  r_b, s_b and k_b are (n, 32) uint8 (R, s and
        the challenge scalar k; C2 forms the digits on the card), vidx
        the (n,) table rows.  Table placement is budget-aware
        (comb_mesh_mode).  Returns (bitmap[:n], nb, shards, path) or None
        when the budget declines both mesh layouts (the caller falls back
        to the single-device comb, not the ladder)."""
        from tendermint_tpu_torch.crypto import degrade
        from tendermint_tpu_torch.libs import fail

        n = r_b.shape[0]
        mode = self.comb_mesh_mode(entry)
        if mode is None:
            degrade.publish_route("mesh-comb", "declined")
            return None
        # chaos seam: a raise here degrades this batch to the
        # single-device comb in ops/ed25519._comb_try (exact bitmap)
        fail.inject("sharding.mesh_comb")
        if mode == "shard":
            out = self._verify_comb_sharded(r_b, s_b, k_b, vidx, entry,
                                            probe)
            if out is None:
                degrade.publish_route("mesh-comb", "declined")
                return None
            bitmap, nb = out
            return bitmap[:n], nb, self.nshard, "mesh-comb-sharded"
        table_ops = self._comb_repl_operands(entry)
        bitmap, nb = self._run_comb_chunks(table_ops, r_b, s_b, k_b, vidx,
                                           probe)
        return bitmap[:n], nb, self.nshard, "mesh-comb"

    def _comb_repl_operands(self, entry):
        """The tables and decode verdicts of every position, made ONCE per
        entry and reused on every launch: the first position on the build
        device reads the build copy, every other position (a repeated
        device too) gets a copy of its own.  The nshard - 1 copies beyond
        the build copy charge the mesh_tables ledger pool; the build copy
        stays on table_cache's books.  Returns {position: (tables,
        dec_ok)}."""
        from tendermint_tpu_torch.crypto import devobs

        cached = entry.mesh_repl
        if cached is None or cached[0] is not self.mesh:
            ops, build_used = {}, False
            build = getattr(entry, "device", None)
            for pos, dev in self._local_positions():
                if not build_used and str(dev) == build:
                    ops[pos] = (entry.tables, entry.dec_ok)
                    build_used = True
                else:
                    ops[pos] = (_tables_to(entry.tables, dev),
                                entry.dec_ok.to(dev, copy=True))
            tbytes = (self.nshard - 1) * entry.k_pad * \
                edops._TABLE_BYTES_PER_KEY
            # the check-and-set plus the ledger charge are one atomic
            # unit: two racing first launches both copy (benign — the
            # loser's copy is garbage once its launch retires) but only
            # the winner commits and charges
            with self._lock:
                cur = entry.mesh_repl
                if cur is not None and cur[0] is self.mesh:
                    return cur[1]
                prev = cur[2] if cur is not None else 0
                cached = (self.mesh, ops, tbytes)
                entry.mesh_repl = cached
                devobs.ledger_add("mesh_tables", tbytes - prev)
        return cached[1]

    def _chunking(self, n: int, lanes: int):
        """(nb, chunk_max, starts): n padded to the pow2 bucket rounded to
        a shard multiple, split into chunks of nshard * lanes rows when
        that divides it (else one chunk)."""
        nshard = self.nshard
        nb = max(-(-edops.bucket_size(n) // nshard) * nshard, nshard)
        chunk_max = nshard * lanes
        if not (chunk_max < nb and nb % chunk_max == 0):
            chunk_max = nb
        return nb, chunk_max, list(range(0, nb, chunk_max))

    def _run_comb_chunks(self, table_ops, r_b, s_b, k_b, vidx, probe):
        """Chunk driver for the replicated mesh comb: C2's rows
        (cuda_comb.pack_rows) padded to the bucket, split into chunks of
        nshard * _chunk_lanes() rows, chunk j+1's per-position puts issued
        right after chunk j's launches, each position running C2 on its
        rows with its table copy.  Returns (bitmap (nb,), nb)."""
        from tendermint_tpu_torch.crypto import devobs
        from tendermint_tpu_torch.ops import cuda_comb as cc

        n = r_b.shape[0]
        lanes = min(self._chunk_lanes(),
                    max(1, edops.MAX_CHUNK // self.nshard))
        nb, chunk_max, starts = self._chunking(n, lanes)
        rows = cc.pack_rows(r_b, s_b, k_b, vidx, nb)
        chunk_walls = []

        def stage(a):
            w = []
            args = self._put_sharded((rows[a:a + chunk_max],), walls=w)
            chunk_walls.append(w)
            return args

        inflight = min(nb, 2 * chunk_max) * cc.ROW_BYTES
        devobs.ledger_add("staging", inflight)
        outs = []
        try:
            nxt = stage(0)
            for ci, _s in enumerate(starts):
                cur = nxt
                outs.append([
                    (pos, dev, self._launch(pos, dev, cc.comb_verify,
                                            cur[pos][0], *table_ops[pos]))
                    for pos, dev in self._local_positions()])
                if ci + 1 < len(starts):
                    nxt = stage(starts[ci + 1])
            res = np.concatenate([
                self._gather(o, np.ones(chunk_max, dtype=bool))[0]
                for o in outs])
        finally:
            devobs.ledger_add("staging", -inflight)
        self._merge_probe(probe, chunk_walls, len(starts))
        return res, nb

    @staticmethod
    def _merge_probe(probe, chunk_walls, chunks):
        """Fold one launch's per-chunk/per-position put walls into a
        devobs probe dict (accumulating)."""
        if probe is None or not chunk_walls:
            return
        sums = [sum(w) for w in chunk_walls]
        probe["dma_s"] = probe.get("dma_s", 0.0) + sum(sums)
        probe.setdefault("dma_first_s", sums[0])
        probe["chunks"] = probe.get("chunks", 0) + chunks
        nloc = max(len(w) for w in chunk_walls)
        sh = [round(sum(w[i] for w in chunk_walls if i < len(w)), 6)
              for i in range(nloc)]
        prev = probe.get("shard_h2d_s")
        probe["shard_h2d_s"] = [round(a + b, 6)
                                for a, b in zip(prev, sh)] \
            if prev and len(prev) == len(sh) else sh

    # -- sharded-table comb (budget fallback, ADR-027) ---------------------

    def _comb_shard_operands(self, entry):
        """Each position's slice of the tables and decode verdicts (keys
        [pos * k_per, (pos + 1) * k_per)), made once per entry.  Charges
        ONE extra table in total (nshard slices) to mesh_tables.  Returns
        {position: (tables, dec_ok)}."""
        from tendermint_tpu_torch.crypto import devobs

        cached = entry.mesh_shard
        if cached is None or cached[0] is not self.mesh:
            k_per = entry.k_pad // self.nshard
            ops = {}
            for pos, dev in self._local_positions():
                a, b = pos * k_per, (pos + 1) * k_per
                ops[pos] = (_tables_to(_tables_slice(entry.tables, a, b),
                                       dev),
                            entry.dec_ok[a:b].to(dev, copy=True)
                            .contiguous())
            tbytes = entry.k_pad * edops._TABLE_BYTES_PER_KEY
            # atomic check-and-set + charge, as _comb_repl_operands
            with self._lock:
                cur = entry.mesh_shard
                if cur is not None and cur[0] is self.mesh:
                    return cur[1]
                prev = cur[2] if cur is not None else 0
                cached = (self.mesh, ops, tbytes)
                entry.mesh_shard = cached
                devobs.ledger_add("mesh_tables", tbytes - prev)
        return cached[1]

    def _verify_comb_sharded(self, r_b, s_b, k_b, vidx, entry, probe):
        """The sharded-table comb: group lanes by table-owning position
        (owner = vidx // (k_pad/nshard)), pad every owner group to the
        bucket of the LARGEST group, scatter rows into their owner's slot
        range, verify with local rows (vidx % k_per), and inverse-permute
        the bitmap back to lane order.  One put set, no chunk loop.
        Returns (bitmap (n,), nb) or None when the skewed per-position
        bucket would exceed MAX_CHUNK lanes."""
        from tendermint_tpu_torch.crypto import devobs
        from tendermint_tpu_torch.ops import cuda_comb as cc

        nshard = self.nshard
        n = r_b.shape[0]
        k_per = entry.k_pad // nshard
        own = (vidx // k_per).astype(np.int64)
        counts = np.bincount(own, minlength=nshard)
        per = int(edops.bucket_size(max(int(counts.max()), 1)))
        if per > edops.MAX_CHUNK:
            return None
        nb = nshard * per
        order = np.argsort(own, kind="stable")
        group_starts = np.zeros(nshard + 1, dtype=np.int64)
        np.cumsum(counts, out=group_starts[1:])
        slot_sorted = (np.arange(n, dtype=np.int64)
                       - group_starts[own[order]] + own[order] * per)
        slots = np.empty(n, dtype=np.int64)
        slots[order] = slot_sorted
        rows = np.zeros((nb, cc.ROW_BYTES), dtype=np.uint8)
        rows[slots] = cc.pack_rows(r_b, s_b, k_b,
                                   (vidx % k_per).astype(np.int32))
        table_ops = self._comb_shard_operands(entry)
        walls = []
        devobs.ledger_add("staging", rows.nbytes)
        try:
            args = self._put_sharded((rows,), walls=walls)
            outs = [(pos, dev, self._launch(pos, dev, cc.comb_verify,
                                            args[pos][0], *table_ops[pos]))
                    for pos, dev in self._local_positions()]
            out, _ = self._gather(outs, np.ones(nb, dtype=bool))
        finally:
            devobs.ledger_add("staging", -rows.nbytes)
        self._merge_probe(probe, [walls], 1)
        return out[slots], nb

    # -- the per-signature routes ------------------------------------------

    def _verify_packed(self, pubkeys, msgs, sigs):
        """The packed route (the JAX package's Pallas one): K1 on each
        position's lanes of the (128, nb) rows, nb a multiple of
        nshard * TILE, in chunks of at most MAX_CHUNK lanes a position,
        chunk j+1's puts issued right after chunk j's launches."""
        from tendermint_tpu_torch.crypto import devobs
        from tendermint_tpu_torch.libs import fail
        from tendermint_tpu_torch.ops import cuda_ed25519 as ck

        t0 = time.perf_counter()
        fail.inject(self.FAIL_SITE)
        packed, host_ok = edops.prepare_batch_packed(pubkeys, sigs, msgs)
        n = host_ok.shape[0]
        unit = self.nshard * edops.TILE
        chunk_max = self.nshard * edops.MAX_CHUNK
        nb = -(-max(edops.bucket_size(n), unit) // unit) * unit
        if nb != n:
            packed = np.pad(packed, [(0, 0), (0, nb - n)])
        extra = {"stage_s": time.perf_counter() - t0}
        starts = list(range(0, nb, chunk_max))
        chunk_walls = []

        def stage(a):
            w = []
            args = self._put_sharded(
                (packed[:, a:min(a + chunk_max, nb)],), walls=w, axis=1)
            chunk_walls.append(w)
            return args

        # at most two chunks in flight (cur + nxt)
        inflight = min(int(packed.nbytes), 2 * 128 * min(chunk_max, nb))
        devobs.ledger_add("staging", inflight)
        outs = []
        try:
            nxt = stage(0)
            for ci, _s in enumerate(starts):
                cur = nxt
                outs.append([
                    (pos, dev, self._launch(pos, dev, ck.verify_packed,
                                            cur[pos][0]))
                    for pos, dev in self._local_positions()])
                if ci + 1 < len(starts):
                    nxt = stage(starts[ci + 1])
            t_col = time.perf_counter()
            res = np.concatenate([
                self._gather(o, np.ones(min(chunk_max, nb - s),
                                        dtype=bool))[0]
                for o, s in zip(outs, starts)])
        finally:
            devobs.ledger_add("staging", -inflight)
        probe = {}
        self._merge_probe(probe, chunk_walls, len(starts))
        extra.update(edops._overlap_phases({
            "dma_s": probe["dma_s"], "dma_first_s": probe["dma_first_s"],
            "chunks": len(starts)}))
        extra["shard_h2d_s"] = probe["shard_h2d_s"]
        extra["drain_s"] = time.perf_counter() - t_col
        extra.update(_shard_fields(n, nb, self.nshard))
        edops._record_launch(self.PACKED_PATH, self.mesh.devices[0], n, nb,
                             time.perf_counter() - t0,
                             dict(extra, shards=self.nshard))
        return res[:n] & host_ok

    def _seal(self, chunk: int):
        """Ready the kernels for one chunk shape.  Local plane: the
        kernels build on first use (no peers to coordinate with).  The
        global plane overrides with a build + barrier."""

    def _sealed(self, chunk: int):
        key = ("step", chunk)
        with self._lock:
            if key in self._fns:
                return
        self._seal(chunk)
        with self._lock:
            self._fns[key] = True

    def _verify_compact(self, staged, host_ok):
        """The compact route (the portable one: CPU planes, the global
        plane): pad the prepare_batch_compact rows to the pow2 bucket
        rounded to a shard multiple, then launch chunks of
        nshard * _chunk_lanes() lanes — chunk j+1's per-position puts
        issued right after chunk j's launches — each position running K3
        on its lanes.  The all-valid bit is the AND over live lanes,
        recorded even with devobs off (the global plane's cross-process
        verdict).  Bitmap identical to one device's."""
        from tendermint_tpu_torch.crypto import devobs
        from tendermint_tpu_torch.libs import fail

        t0 = time.perf_counter()
        # chaos seam: a raise here degrades this batch to the
        # single-device routes in ops/ed25519.verify_batch
        fail.inject(self.FAIL_SITE)
        obs_on = devobs.is_enabled()
        n = host_ok.shape[0]
        nb, chunk_max, starts = self._chunking(n, self._chunk_lanes())
        rows = _compact_rows(staged, nb)
        live = np.zeros(nb, dtype=bool)
        live[:n] = True
        stage_s = time.perf_counter() - t0
        self._sealed(chunk_max)
        chunk_walls = []

        def stage(a):
            w = []
            args = self._put_sharded((rows[:, a:a + chunk_max],), walls=w,
                                     axis=1)
            chunk_walls.append(w)
            return args

        inflight = min(nb, 2 * chunk_max) * 161
        devobs.ledger_add("staging", inflight)
        outs, flags = [], []
        try:
            nxt = stage(0)
            for ci, a in enumerate(starts):
                cur = nxt
                launched = [(pos, dev, self._launch(pos, dev, _k3_rows,
                                                    cur[pos][0]))
                            for pos, dev in self._local_positions()]
                if ci + 1 < len(starts):
                    nxt = stage(starts[ci + 1])
                t_col = time.perf_counter()
                bm, av = self._gather(launched, live[a:a + chunk_max])
                outs.append(bm)
                flags.append(av)
        finally:
            devobs.ledger_add("staging", -inflight)
        res = np.concatenate(outs) if len(outs) > 1 else outs[0]
        all_valid = all(flags)
        drain_s = time.perf_counter() - t_col
        extra = {"all_valid": all_valid, "shards": self.nshard}
        if obs_on:
            probe = {"stage_s": stage_s}
            self._merge_probe(probe, chunk_walls, len(starts))
            extra.update(edops._overlap_phases({
                "stage_s": probe["stage_s"],
                "dma_s": probe.get("dma_s", 0.0),
                "dma_first_s": probe.get("dma_first_s", 0.0),
                "chunks": probe.get("chunks", len(starts))}))
            if probe.get("shard_h2d_s"):
                extra["shard_h2d_s"] = probe["shard_h2d_s"]
            extra["drain_s"] = drain_s
            extra.update(_shard_fields(n, nb, self.nshard))
        edops._record_launch(self.MESH_PATH, self.mesh.devices[0], n, nb,
                             time.perf_counter() - t0, extra)
        return res[:n] & host_ok

    def verify_batch(self, pubkeys, msgs, sigs):
        """Sharded equivalent of ops/ed25519.verify_batch: identical
        bitmap, batch split across positions — K1 on a CUDA plane, K3 on
        the compact rows elsewhere."""
        if self.device_type == "cuda":
            return self._verify_packed(pubkeys, msgs, sigs)
        staged, host_ok = edops.prepare_batch_compact(pubkeys, sigs, msgs)
        return self._verify_compact(staged, host_ok)


class _GlobalDataPlane(_DataPlane):
    """The cross-process plane (ADR-027): the compact route of
    _DataPlane over every rank's positions, each rank staging and
    launching only its own, the chunk bitmaps all-gathered and the
    all-valid bit all-reduced with torch.distributed, so both arrive
    identically on every rank.  Kernels build ahead of the first
    collective call with a store barrier after the build, so no process
    enters a collective a peer is still building for.  Only reachable
    through global_plane(), i.e. from inside a lockstep() window
    (blocksync replay_window, coordinated bulk verify)."""

    MESH_PATH = "global-mesh"
    FAIL_SITE = "sharding.global_plane"

    @property
    def batch_path(self) -> str:
        return self.MESH_PATH

    def _chunk_lanes(self) -> int:
        # the chunk count is part of the cross-process collective's
        # shape: the per-process governed knob (and TM_TPU_MESH_CHUNK)
        # is excluded here — two peers steered across a power-of-two
        # boundary would otherwise launch mismatched chunk sequences
        # into the same collective and deadlock the job
        return _static_chunk_lanes()

    def _local_positions(self):
        ranks = self.mesh.ranks
        if ranks is None:
            return super()._local_positions()
        me = _rank()
        return [(pos, d) for pos, d in enumerate(self.mesh.devices)
                if ranks[pos] == me]

    def _seal(self, chunk: int):
        if self.device_type == "cuda":
            from tendermint_tpu_torch.ops import cuda_ed25519 as ck
            ck.kernels()
        _barrier(f"tm_tpu_gmesh_step_{chunk}")

    def _gather(self, outs, live):
        """All-gather the chunk's bitmap and all-reduce its all-valid bit
        over the process group, on its own backend: NCCL keeps the
        tensors on the card, gloo gets host tensors."""
        dist = _dist()
        if dist is None or self.mesh.ranks is None:
            return super()._gather(outs, live)
        per = live.shape[0] // self.nshard
        mine = np.concatenate([np.arange(pos * per, (pos + 1) * per)
                               for pos, _, _ in outs])
        on_card = dist.get_backend() == "nccl"
        if on_card:
            t = torch.cat([b.to(torch.uint8) for _, _, b in outs])
            bm_local = t
            av = ((t.bool() | ~torch.from_numpy(live[mine]).to(t.device))
                  .all().to(torch.int32).reshape(1))
        else:
            host = np.concatenate([
                self._collect(pos, dev, lambda b=b: b.cpu().numpy())
                for pos, dev, b in outs]).astype(bool)
            bm_local = torch.from_numpy(host.astype(np.uint8))
            av = torch.tensor([int((host | ~live[mine]).all())],
                              dtype=torch.int32)
        gathered = [torch.empty_like(bm_local)
                    for _ in range(_world_size())]
        dist.all_gather(gathered, bm_local)
        dist.all_reduce(av, op=dist.ReduceOp.MIN)
        bm = torch.cat(gathered).cpu().numpy().astype(bool)
        return bm, bool(av.item())

    def verify_batch(self, pubkeys, msgs, sigs):
        # the compact route is the one kernel shape run across processes;
        # the packed route stays per-process (ADR-027)
        staged, host_ok = edops.prepare_batch_compact(pubkeys, sigs, msgs)
        return self._verify_compact(staged, host_ok)


def _window_points(ws: np.ndarray) -> list:
    """(4, W, 32) uint8 canonical window sums -> W extended points as
    Python integers."""
    return [tuple(int.from_bytes(ws[j, w].tobytes(), "little")
                  for j in range(4)) for w in range(ws.shape[1])]


def _window_bytes(pts: list) -> np.ndarray:
    """_window_points' inverse: W points (coordinates reduced mod p) ->
    (4, W, 32) uint8."""
    from tendermint_tpu_torch.ops import curve as C

    out = np.zeros((4, len(pts), 32), dtype=np.uint8)
    for w, p in enumerate(pts):
        for j in range(4):
            out[j, w] = np.frombuffer(
                (p[j] % C.P).to_bytes(32, "little"), dtype=np.uint8)
    return out


def _shard_fields(n: int, nb: int, shards: int) -> dict:
    from tendermint_tpu_torch.crypto import devobs
    return devobs.shard_fields(n, nb, shards)


def make_sharded_verifier(mesh: Mesh, axis: str = BATCH_AXIS):
    """Returns (step, run) over `mesh`.  step(rows) runs K3 on each
    position's lanes of (160, nb) uint8 rows (pub | r | s | digest, nb a
    multiple of the positions) and returns (bitmap (nb,) numpy bool,
    all_valid).  run(staged) takes ops/ed25519.prepare_batch_compact's
    lane-major rows, pads them to a multiple of the positions (to a
    power-of-two bucket first with bucket=True) and returns the (n,)
    bitmap, recorded as route "mesh-sharded".

    With the device observatory enabled (crypto/devobs.py, ADR-021) the
    launch is decomposed: pad (host stage), the per-position copies
    brought to completion (H2D), the launches -> their completion
    (compute), and the bitmap readback (collect) — plus per-shard
    real-row counts."""
    plane = _DataPlane(mesh)

    def launch(args):
        return [(pos, dev, plane._launch(pos, dev, _k3_rows, args[pos][0]))
                for pos, dev in plane._local_positions()]

    def step(rows):
        nb = rows.shape[1]
        return plane._gather(launch(plane._put_sharded((rows,), axis=1)),
                             np.ones(nb, dtype=bool))

    def sync():
        for d in {d for d in mesh.devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    def run(dev_arrays: dict, bucket: bool = False, shards: int = 0):
        from tendermint_tpu_torch.crypto import devobs

        t0 = time.perf_counter()
        n = dev_arrays["pub"].shape[1]
        nshard = mesh.nshard
        base = edops.bucket_size(n) if bucket else n
        nb = max(-(-base // nshard) * nshard, nshard)
        rows = _compact_rows(dev_arrays, nb)
        extra = None
        if devobs.is_enabled():
            t_st = time.perf_counter()
            devobs.ledger_add("staging", rows.nbytes)
            try:
                put = plane._put_sharded((rows,), axis=1)
                sync()
                t_h2d = time.perf_counter()
                outs = launch(put)
                sync()
                t_cmp = time.perf_counter()
                res, _ = plane._gather(outs, np.ones(nb, dtype=bool))
                t_col = time.perf_counter()
            finally:
                devobs.ledger_add("staging", -rows.nbytes)
            extra = {"stage_s": t_st - t0, "h2d_s": t_h2d - t_st,
                     "compute_s": t_cmp - t_h2d,
                     "collect_s": t_col - t_cmp,
                     **_shard_fields(n, nb, nshard)}
        else:
            res, _ = step(rows)
        edops._record_launch("mesh-sharded", mesh.devices[0], n, nb,
                             time.perf_counter() - t0,
                             dict(extra or {}, shards=shards or nshard))
        return res[:n]

    return step, run
