"""The PyTorch port stands alone: no jax, nothing of tendermint_tpu, and no
quiet fall-back to the CPU when CUDA is missing."""
import ast
import contextlib
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import batch as cbatch
from tendermint_tpu_torch.ops import cuda_ed25519 as ck
from tendermint_tpu_torch.ops import cuda_msm as cm
from tendermint_tpu_torch.ops import ed25519 as E
from tendermint_tpu_torch.ops import msm

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tendermint_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is thousands of small tensor ops: with one intra-op
    thread per test process they do not contend with parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_resilience_modules_are_checked():
    """The degradation runtime and the libs under it are among the modules
    the two checks below cover."""
    mods = _port_modules()
    for m in ("crypto.degrade", "libs.fail", "libs.trace", "libs.metrics",
              "libs.slo"):
        assert f"tendermint_tpu_torch.{m}" in mods, m


def test_scheduler_modules_are_checked():
    """The VerifyScheduler, the device observatory and the service
    lifecycle under them are among the modules the checks below cover."""
    mods = _port_modules()
    for m in ("crypto.scheduler", "crypto.devobs", "libs.service"):
        assert f"tendermint_tpu_torch.{m}" in mods, m


def test_types_modules_are_checked():
    """The types and codecs (votes, vote sets, blocks, part sets,
    proposals, evidence, light blocks, genesis, the event bus, bit arrays,
    the safe codec, Amino JSON, the log and the ABCI types) are among the
    modules the checks below cover."""
    mods = _port_modules()
    for m in ("libs.bits", "libs.log", "libs.safe_codec", "abci.types",
              "types.params", "types.vote", "types.proposal",
              "types.part_set", "types.block", "types.vote_set",
              "types.light_block", "types.evidence", "libs.amino_json",
              "types.genesis", "types.event_bus"):
        assert f"tendermint_tpu_torch.{m}" in mods, m


def test_storage_and_execution_modules_are_checked():
    """Storage, ABCI and block execution (the key-value stores, the
    pubsub query, the snapshot integrity, the ABCI wire, server, client
    and kvstore, the proxy, the state and its store, the block store, the
    consensus observatory, the BlockExecutor, rollback, the indexers and
    the event sinks) are among the modules the checks below cover."""
    mods = _port_modules()
    for m in ("libs.kvdb", "libs.pubsub_query", "statesync.integrity",
              "abci.wire", "abci.server", "abci.client", "abci.kvstore",
              "proxy", "state.state", "state.store", "store.block_store",
              "consensus.observatory", "state.execution", "state.rollback",
              "state.indexer", "state.sinks"):
        assert f"tendermint_tpu_torch.{m}" in mods, m


def test_p2p_and_blocksync_modules_are_checked():
    """The P2P transport core (flowrate, the wire registry, the node key,
    SecretConnection, the gossip observatory, MConnection, the Switch),
    blocksync (the pool, replay, the reactor) and the BlockPipeline are
    among the modules the checks below cover."""
    mods = _port_modules()
    for m in ("libs.flowrate", "p2p", "p2p.wire", "p2p.key",
              "p2p.secret_connection", "p2p.netobs", "p2p.connection",
              "p2p.switch", "blocksync", "blocksync.pool",
              "blocksync.replay", "blocksync.reactor", "state.pipeline"):
        assert f"tendermint_tpu_torch.{m}" in mods, m


def test_evidence_and_light_modules_are_checked():
    """The evidence package (verification, the pool, the reactor), the
    light client (the verifier, the trusted store, the providers, the
    detector, the client), LightServe and the RPC client are among the
    modules the checks below cover."""
    mods = _port_modules()
    for m in ("evidence", "evidence.verify", "evidence.pool",
              "evidence.reactor", "light", "light.verifier", "light.store",
              "light.provider", "light.detector", "light.client",
              "light.service", "rpc", "rpc.client"):
        assert f"tendermint_tpu_torch.{m}" in mods, m


def test_mempool_and_signer_modules_are_checked():
    """The mempool (the v0 and v1 pools, the IngressGate, the reactor),
    the validator signer (FilePV, the remote signer, its harness) and the
    ciphers under it (armor, xsalsa20) are among the modules the checks
    below cover, lazy imports included (the AST check walks every
    function body)."""
    mods = _port_modules()
    for m in ("mempool", "mempool.mempool", "mempool.priority_mempool",
              "mempool.ingress", "mempool.reactor", "privval",
              "privval.file_pv", "privval.signer", "privval.harness",
              "crypto.armor", "crypto.xsalsa20"):
        assert f"tendermint_tpu_torch.{m}" in mods, m


def test_mempool_and_signer_lazy_imports_stay_in_the_port():
    """Every import inside a function of the new modules (the reference's
    lazy imports: the log, the metrics, the scheduler, the vote and
    proposal types, the key types, the cipher) names the port or a
    package that is neither jax nor the JAX package."""
    lazy = []
    for rel in ("mempool/ingress.py", "mempool/mempool.py",
                "mempool/priority_mempool.py", "mempool/reactor.py",
                "privval/file_pv.py", "privval/signer.py",
                "crypto/armor.py"):
        tree = ast.parse((PKG / rel).read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.ImportFrom):
                    name = "." * node.level + (node.module or "")
                elif isinstance(node, ast.Import):
                    name = node.names[0].name
                else:
                    continue
                lazy.append((rel, name))
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "tendermint_tpu"), \
                    (rel, name)
    assert len(lazy) >= 19, lazy
    assert ("mempool/ingress.py",
            "tendermint_tpu_torch.crypto") in lazy


CONSENSUS_MODULES = (
    "libs/autofile.py", "consensus/config.py", "consensus/round_types.py",
    "consensus/ticker.py", "consensus/wal.py", "consensus/messages.py",
    "consensus/state.py", "consensus/reactor.py",
    "consensus/replay_console.py", "consensus/wal_generator.py")


def test_consensus_modules_are_checked():
    """The consensus slice (the WAL's autofile group, the config, the
    round types, the ticker, the WAL, the wire messages, the state
    machine, its reactor, the replay console, the WAL generator) is among
    the modules the checks below cover."""
    mods = _port_modules()
    for rel in CONSENSUS_MODULES:
        m = rel[:-3].replace("/", ".")
        assert f"tendermint_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("rel", CONSENSUS_MODULES)
def test_consensus_imports_stay_in_the_port(rel):
    """Every import of a consensus module, at its top and inside its
    functions (the reference's lazy imports), names the port, the standard
    library or numpy/torch; the module imports in a fresh interpreter
    without jax or the JAX package showing up in sys.modules."""
    tree = ast.parse((PKG / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            name = "." * node.level + (node.module or "")
        elif isinstance(node, ast.Import):
            name = node.names[0].name
        else:
            continue
        assert name.split(".")[0] not in ("jax", "jaxlib",
                                          "tendermint_tpu"), (rel, name)
    mod = "tendermint_tpu_torch." + rel[:-3].replace("/", ".")
    code = (f"import sys, {mod}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tendermint_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


STATESYNC_RPC_MODULES = (
    "p2p/trust.py", "p2p/fuzz.py", "p2p/pex.py", "p2p/wire.py",
    "libs/metrics.py", "libs/fail.py", "statesync/ledger.py",
    "statesync/stateprovider.py", "statesync/syncer.py",
    "statesync/reactor.py", "statesync/__init__.py", "rpc/server.py",
    "rpc/light.py", "rpc/__init__.py", "libs/grpc_util.py", "abci/grpc.py",
    "rpc/grpc_api.py", "proxy/__init__.py")


def test_statesync_rpc_modules_are_checked():
    """The state-sync, RPC and PEX slice (the trust metric, the fuzzed
    connection, PEX, the state-sync ledger, provider, syncer and reactor,
    the RPC server and its light routes, the gRPC transports) is among the
    modules the checks below cover."""
    mods = _port_modules()
    for rel in STATESYNC_RPC_MODULES:
        m = rel[:-3].replace("/", ".").removesuffix(".__init__")
        assert f"tendermint_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("rel", STATESYNC_RPC_MODULES)
def test_statesync_rpc_imports_stay_in_the_port(rel):
    """Every import of the slice's modules, at the top and inside
    functions, names the port, the standard library or an optional
    dependency (grpcio); the module imports in a fresh interpreter
    without jax or the JAX package showing up in sys.modules."""
    tree = ast.parse((PKG / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            name = "." * node.level + (node.module or "")
        elif isinstance(node, ast.Import):
            name = node.names[0].name
        else:
            continue
        assert name.split(".")[0] not in ("jax", "jaxlib",
                                          "tendermint_tpu"), (rel, name)
    mod = "tendermint_tpu_torch." + rel[:-3].replace("/", ".") \
        .removesuffix(".__init__")
    code = (f"import sys, {mod}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tendermint_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


NODE_MODULES = (
    "config/__init__.py", "config/config.py", "parallel/__init__.py",
    "parallel/sharding.py", "libs/control.py", "libs/pprof.py",
    "node/__init__.py", "node/node.py", "light/proxy.py",
    "cmd/__init__.py", "cmd/__main__.py")


def test_node_modules_are_checked():
    """The node slice (the config, the sharding module, the control
    plane, the debug server, the node, the light proxy, the CLI) is among
    the modules the checks below cover."""
    mods = _port_modules()
    for rel in NODE_MODULES:
        m = rel[:-3].replace("/", ".").removesuffix(".__init__")
        assert f"tendermint_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("rel", NODE_MODULES)
def test_node_imports_stay_in_the_port(rel):
    """Every import of the node slice's modules, at the top and inside
    functions (the CLI's and the node's lazy imports, pprof's), names the
    port, the standard library or torch; the module imports in a fresh
    interpreter without jax or the JAX package in sys.modules."""
    _imports_stay_in_the_port(rel)


def _imports_stay_in_the_port(rel):
    tree = ast.parse((PKG / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            name = "." * node.level + (node.module or "")
        elif isinstance(node, ast.Import):
            name = node.names[0].name
        else:
            continue
        assert name.split(".")[0] not in ("jax", "jaxlib",
                                          "tendermint_tpu"), (rel, name)
    mod = "tendermint_tpu_torch." + rel[:-3].replace("/", ".") \
        .removesuffix(".__init__")
    code = (f"import sys, {mod}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tendermint_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# the reference's module-level names, and the _DataPlane methods that are
# jit / shard_map bodies there: each per-position kernel launch takes
# their place here (parallel/sharding.py's docstring)
_JIT_BODIES = {"_msm_fn", "_comb_fn", "_comb_sharded_fn", "_packed_fn",
               "_step_fn"}


def _defs(path):
    tree = ast.parse(pathlib.Path(path).read_text())
    top = {n.name for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    methods = {n.name: {m.name for m in n.body
                        if isinstance(m, ast.FunctionDef)}
               for n in tree.body if isinstance(n, ast.ClassDef)}
    return top, methods


def test_sharding_holds_the_reference_surface():
    """parallel/sharding.py has every module-level function and class of
    the JAX package's, and every method of its _DataPlane and
    _GlobalDataPlane but the jit / shard_map bodies; the public surface
    imports."""
    from tendermint_tpu_torch.parallel import sharding

    ref_top, ref_methods = _defs(ROOT / "tendermint_tpu" / "parallel"
                                 / "sharding.py")
    top, methods = _defs(PKG / "parallel" / "sharding.py")
    assert ref_top <= top, ref_top - top
    for cls in ("_DataPlane", "_GlobalDataPlane"):
        missing = ref_methods[cls] - methods[cls] - _JIT_BODIES
        if cls == "_GlobalDataPlane":
            missing -= methods["_DataPlane"]
        assert not missing, (cls, missing)
    for name in ("make_mesh", "data_plane", "global_plane", "lockstep",
                 "in_lockstep", "global_mesh_ready", "disable_global_plane",
                 "invalidate_on_topology_change", "_DataPlane",
                 "_GlobalDataPlane", "make_sharded_verifier"):
        assert callable(getattr(sharding, name)), name


def test_sharding_without_cuda(monkeypatch):
    """No CUDA: make_mesh(None) raises RuntimeError, the topology reads as
    no devices (never raising), this process's devices are the CPU alone,
    so data_plane() is None; an explicit CPU mesh may repeat its device."""
    from tendermint_tpu_torch.parallel import sharding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharding.make_mesh()
    assert sharding._topology_key() == ()
    assert sharding._local_devices() == [torch.device("cpu")]
    monkeypatch.setattr(sharding, "_PLANE", None)
    monkeypatch.setattr(sharding, "_PLANE_KEY", None)
    monkeypatch.delenv("TM_TPU_NO_MESH", raising=False)
    assert sharding.data_plane() is None
    mesh = sharding.make_mesh(["cpu"] * 4)
    assert mesh.nshard == 4 and mesh.device_type == "cpu"
    with pytest.raises(ValueError):
        sharding.make_mesh([])
    assert sharding.global_mesh_ready() is False


def test_a_card_position_that_raises_raises_device_lane_error(monkeypatch):
    """On a CUDA position a kernel that raises leaves the plane as
    degrade.DeviceLaneError (no plain version runs in its place); on a CPU
    position the exception is the plain version's own."""
    from tendermint_tpu_torch.crypto import degrade
    from tendermint_tpu_torch.parallel import sharding

    monkeypatch.setattr(sharding, "_device_ctx",
                        lambda dev: contextlib.nullcontext())
    ran = []

    def kernel(x):
        ran.append(x)
        raise RuntimeError("an illegal memory access was encountered")

    card = torch.device("cuda", 0)
    with pytest.raises(degrade.DeviceLaneError, match="position 2"):
        sharding._DataPlane._launch(2, card, kernel, 1)
    with pytest.raises(degrade.DeviceLaneError):
        sharding._DataPlane._collect(
            1, card, lambda: kernel(2))
    with pytest.raises(RuntimeError) as e:
        sharding._DataPlane._launch(0, torch.device("cpu"), kernel, 3)
    assert not isinstance(e.value, degrade.DeviceLaneError)
    assert ran == [1, 2, 3]


def test_fail_registers_the_sharding_sites():
    from tendermint_tpu_torch.libs import fail

    for site in ("sharding.mesh_stage", "sharding.mesh_comb",
                 "sharding.global_plane"):
        assert site in fail.REGISTERED_SITES and fail.is_registered(site)


NET_MODULES = (
    "networks/__init__.py", "networks/vnet.py", "networks/invariants.py",
    "networks/scenarios.py", "networks/harness.py", "e2e/__init__.py",
    "e2e/manifest.py", "e2e/runner.py")


def test_net_modules_are_checked():
    """The in-process network harness and the e2e runner (item 10) are
    among the modules the checks cover."""
    mods = _port_modules()
    for rel in NET_MODULES:
        m = rel[:-3].replace("/", ".").removesuffix(".__init__")
        assert f"tendermint_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("rel", NET_MODULES)
def test_net_imports_stay_in_the_port(rel):
    """Every import of the harness's and the e2e runner's modules, lazy
    ones too, names the port, the standard library or torch; each imports
    in a fresh interpreter without jax or the JAX package."""
    _imports_stay_in_the_port(rel)


def test_harness_runner_and_e2e_default_to_the_card(monkeypatch,
                                                    tmp_path):
    """NetHarness(device=None), NetHarness.run and E2ERunner take the
    package default, "cuda", and with no CUDA raise RuntimeError unless
    device="cpu" was asked for; the `e2e` command's --device defaults to
    cuda."""
    import inspect

    from tendermint_tpu_torch.cmd import __main__ as cli
    from tendermint_tpu_torch.e2e import E2ERunner, manifest_from_dict
    from tendermint_tpu_torch.networks.harness import NetHarness

    for fn in (NetHarness.__init__, NetHarness.run, E2ERunner.__init__):
        assert inspect.signature(fn).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    m = manifest_from_dict({"node": {"v0": {}}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NetHarness(validators=2, workdir=str(tmp_path / "h"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E2ERunner(m, str(tmp_path / "e"))
    assert NetHarness(validators=2, workdir=str(tmp_path / "h"),
                      device="cpu").device == torch.device("cpu")
    assert E2ERunner(m, str(tmp_path / "e"), device="cpu").device \
        == torch.device("cpu")
    seen = {}
    monkeypatch.setattr(cli, "cmd_e2e", lambda a: seen.update(e=a))
    cli.main(["e2e", "m.toml"])
    assert seen["e"].device == "cuda"


def test_fail_registers_the_net_sites():
    from tendermint_tpu_torch.libs import fail

    for site in ("vnet.deliver", "vnet.partition", "vnet.reorder",
                 "harness.step"):
        assert site in fail.REGISTERED_SITES and fail.is_registered(site)


def test_node_and_start_default_to_the_card(monkeypatch, tmp_path):
    """Node(device=None) takes the package default, "cuda", and with no
    CUDA raises RuntimeError unless device="cpu" was asked for; the
    `start` and `light` commands' --device defaults to cuda."""
    import inspect

    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.cmd import __main__ as cli
    from tendermint_tpu_torch.config.config import Config
    from tendermint_tpu_torch.node import Node

    assert inspect.signature(Node.__init__).parameters["device"].default \
        is None
    cfg = Config(home=str(tmp_path), moniker="dflt")
    cfg.ensure_dirs()
    from test_torch_node import make_genesis
    gdoc, _ = make_genesis(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Node(cfg, KVStoreApplication(), genesis=gdoc, in_memory=True)
    node = Node(cfg, KVStoreApplication(), genesis=gdoc, in_memory=True,
                device="cpu")
    assert node.device == torch.device("cpu")
    seen = {}
    monkeypatch.setattr(cli, "cmd_start", lambda a: seen.update(s=a))
    monkeypatch.setattr(cli, "cmd_light", lambda a: seen.update(li=a))
    cli.main(["start"])
    cli.main(["light", "127.0.0.1:1"])
    assert seen["s"].device == "cuda" and seen["li"].device == "cuda"


def test_fail_registers_the_control_site():
    from tendermint_tpu_torch.libs import fail

    assert "control.decide" in fail.REGISTERED_SITES
    assert fail.is_registered("control.decide")


def test_statesync_follows_the_light_clients_device(monkeypatch):
    """State sync takes no device of its own: its StateProvider verifies
    on its light client's, and with no CUDA the client (the entry point)
    raises unless the caller asks for the CPU."""
    import inspect

    from tendermint_tpu_torch import light
    from tendermint_tpu_torch.libs.kvdb import MemDB
    from tendermint_tpu_torch.statesync import StateProvider, Syncer

    from test_torch_light import PORT as LPORT
    from test_torch_light import light_chain

    for cls in (StateProvider, Syncer):
        assert "device" not in inspect.signature(cls.__init__).parameters
    gdoc, lbs = light_chain(LPORT, 4)
    prov = light.DictProvider(gdoc.chain_id, lbs)
    opts = light.TrustOptions(1, lbs[1].hash(), 86400.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        light.Client(gdoc.chain_id, opts, prov, [], light.LightStore(MemDB()))
    lc = light.Client(gdoc.chain_id, opts, prov, [],
                      light.LightStore(MemDB()), device="cpu")
    sp = StateProvider(lc, now=lbs[4].signed_header.header.time)
    assert sp.commit(2).height == 2


def test_fail_registers_the_statesync_sites():
    from tendermint_tpu_torch.libs import fail

    for site in ("statesync.fetch", "statesync.verify", "statesync.apply",
                 "statesync.serve"):
        assert site in fail.REGISTERED_SITES and fail.is_registered(site)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PKG.rglob("*.py")]
    + [pathlib.Path("chip_smoke.py")]), ids=str)
def test_no_jax_package_path_in_source(path):
    """No dotted path into the JAX package anywhere in the source, lazy
    imports and import_module strings included: `tendermint_tpu.` is
    always `tendermint_tpu_torch.` here."""
    for n, line in enumerate((ROOT / path).read_text().splitlines(), 1):
        assert not re.search(r"\btendermint_tpu\.[A-Za-z_]", line), \
            f"{path}:{n}: {line.strip()}"


def test_scheduler_cuda_missing_raises(monkeypatch):
    """With no CUDA and no device='cpu', the scheduler's constructor and
    its sync wrapper raise instead of running on the CPU."""
    from tendermint_tpu_torch.crypto import scheduler as vs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vs.VerifyScheduler()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vs.verify_items([(bytes(32), b"m", bytes(64))])
    s = vs.VerifyScheduler(device="cpu")
    assert s.device == torch.device("cpu") and not s.is_running()


def test_import_keeps_jax_out():
    """Importing every module of the port in a fresh interpreter loads
    neither jax nor the JAX package."""
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'tendermint_tpu' or "
            "m.startswith('tendermint_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PKG.rglob("*.py")]
    + [pathlib.Path("chip_smoke.py")]), ids=str)
def test_no_jax_imports_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tendermint_tpu"), \
                f"{path}:{node.lineno} imports {name}"


def test_cuda_missing_raises(monkeypatch):
    """With no CUDA and no device='cpu', entry points raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    pub = bytes(32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.verify_batch([pub], [b"m"], [bytes(64)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cbatch.verify_sigs_bulk(np.zeros((40, 32), np.uint8),
                                [b"m"] * 40, [bytes(64)] * 40)
    bv = cbatch.BatchVerifier()
    for _ in range(40):
        bv.add(cbatch.ed.PubKey(pub), b"m", bytes(64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bv.verify()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        msm.verify_batch_rlc([pub], [b"m"], [bytes(64)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.verify_batch_staged([pub], [b"m"], [bytes(64)])
    with pytest.raises(ValueError):
        T.resolve_device("mps")
    with pytest.raises(ValueError):
        T.set_default_device("mps")
    assert T.resolve_device("cpu") == torch.device("cpu")


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    ck.reset_launches()
    with pytest.raises(ValueError):
        ck.verify_packed(torch.zeros((96, 8), dtype=torch.uint8))
    with pytest.raises(TypeError):
        ck.verify_packed(torch.zeros((128, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        ck.verify_packed_split(torch.zeros((32, 8), dtype=torch.uint8),
                               torch.zeros((96, 4), dtype=torch.uint8))
    # a CPU tensor takes the plain version, which is not a launch
    out = ck.verify_packed(torch.zeros((128, 4), dtype=torch.uint8))
    assert out.dtype == torch.bool and out.shape == (4,)
    assert not out.any()
    assert ck.launches == {"verify_packed": 0, "verify_packed_split": 0,
                           "verify_staged": 0, "fe_selftest": 0}


def test_msm_wrappers_check_inputs_and_count_only_kernel_launches():
    cm.reset_launches()
    with pytest.raises(ValueError):
        cm.decompress_niels(torch.zeros((31, 8), dtype=torch.uint8))
    with pytest.raises(TypeError):
        cm.decompress_niels(torch.zeros((32, 8), dtype=torch.int8))
    with pytest.raises(TypeError):
        cm.bucket_scan(torch.zeros((3, 22, 4), dtype=torch.int64),
                       torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        cm.bucket_scan(torch.zeros((3, 10, 4), dtype=torch.int64),
                       torch.zeros((2, 8), dtype=torch.int32))
    # CPU tensors take the plain versions, which are not launches
    niels, ok = cm.decompress_niels(torch.zeros((32, 4), dtype=torch.uint8))
    assert niels.shape == (3, 22, 4) and ok.all()   # y = 0 decodes
    table = msm.assemble_table(niels)
    buckets = cm.bucket_scan(table, torch.zeros((3, 2 << 4),
                                                dtype=torch.int32))
    ws = cm.aggregate(buckets, 2, 4)
    assert ws.shape == (4, 2, 32) and ws.dtype == torch.uint8
    assert cm.launches == {"decompress_niels": 0, "bucket_scan": 0,
                           "aggregate": 0}


def test_bound_counts():
    """The per-signature work behind bound_ms: 100 products per multiply,
    55 per square, two 32-bit multiply-add halves each."""
    assert ck.PRODUCTS_PER_SIG == 100 * 2004 + 55 * 1549
    assert ck.bound_ms(65536) == pytest.approx(
        65536 * 2 * ck.PRODUCTS_PER_SIG / (132 * 64 * 1.98e9) * 1e3)
    assert ck.bound_ms(65536, staged=True) > ck.bound_ms(65536)


def test_msm_bound_counts():
    """K4: 255 squares + 21 multiplies per point; K5: 7 multiplies per
    bucket member; A1: 18 multiplies per digit of each window."""
    rate = 132 * 64 * 1.98e9
    assert cm.bound_ms_decompress(262144) == pytest.approx(
        262144 * 2 * (100 * 21 + 55 * 255) / rate * 1e3)
    assert cm.bound_ms_bucket_scan(6_000_000, 262146, 1304, 8192) == \
        pytest.approx(6_000_000 * 2 * 700 / rate * 1e3)
    assert cm.bound_ms_aggregate(32, 8) == pytest.approx(
        32 * 255 * 18 * 100 * 2 / rate * 1e3)


def test_lane_modules_are_checked():
    """The secp256k1 and sr25519 lanes, their kernels' wrappers, the keys
    and the host-lane pool are among the modules the checks above
    cover."""
    mods = _port_modules()
    for m in ("ops.field_secp", "ops.secp", "ops.cuda_secp",
              "ops.ristretto", "ops.sr25519", "ops.cuda_sr25519",
              "crypto.secp256k1", "crypto.sr25519", "crypto._ristretto",
              "crypto._strobe", "crypto.lanepool", "libs.native"):
        assert f"tendermint_tpu_torch.{m}" in mods, m


def test_lanes_cuda_missing_raises(monkeypatch):
    """The secp256k1 and sr25519 entry points raise without CUDA unless
    the CPU is asked for."""
    from tendermint_tpu_torch.ops import secp, sr25519
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        secp.verify_batch_device([b"\x02" + bytes(32)], [b"m"], [bytes(64)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sr25519.verify_batch_device([bytes(32)], [b"m"], [bytes(64)])


def test_lane_wrappers_check_inputs_and_count_only_kernel_launches():
    from tendermint_tpu_torch.ops import cuda_secp, cuda_sr25519
    cuda_secp.reset_launches()
    cuda_sr25519.reset_launches()
    for fn in (cuda_secp.verify_rows, cuda_sr25519.verify_packed):
        with pytest.raises(ValueError):
            fn(torch.zeros((96, 8), dtype=torch.uint8))
        with pytest.raises(ValueError):
            fn(torch.zeros((128, 8), dtype=torch.int64))
    for fn in (cuda_secp.fe_secp_selftest, cuda_sr25519.fe2_selftest):
        with pytest.raises(ValueError):
            fn(torch.zeros((4, 31), dtype=torch.uint8),
               torch.zeros((4, 31), dtype=torch.uint8))
    # CPU tensors take the plain versions, which are not launches
    out = cuda_sr25519.verify_packed(torch.zeros((128, 2),
                                                 dtype=torch.uint8))
    assert out.dtype == torch.bool and out.shape == (2,)
    fs = cuda_secp.fe_secp_selftest(torch.zeros((2, 32), dtype=torch.uint8),
                               torch.ones((2, 32), dtype=torch.uint8))
    assert fs.shape == (7, 2, 32) and fs.dtype == torch.uint8
    f2 = cuda_sr25519.fe2_selftest(torch.zeros((2, 32), dtype=torch.uint8),
                                   torch.ones((2, 32), dtype=torch.uint8))
    assert f2.shape == (5, 2, 32) and f2.dtype == torch.uint8
    assert cuda_secp.launches == {"verify_rows": 0, "fe_secp_selftest": 0}
    assert cuda_sr25519.launches == {"verify_packed": 0, "fe2_selftest": 0}


def test_lane_bound_counts():
    """S1: 689 field multiplies and 1,861 squarings a signature, plus
    7 M + 4 S a nonzero digit of s and 11 M + 5 S a nonzero digit of e;
    a multiply 72 products, a square 44; S2: two ristretto decodes, K1's
    table, 256 doublings and the four-product check, plus 7 multiplies a
    nonzero digit of s (radix 256) and of k (radix 16)."""
    from tendermint_tpu_torch.ops import cuda_secp, cuda_sr25519
    rate = 132 * 64 * 1.98e9

    def halves(m, s):
        return 2 * (72 * m + 44 * s)
    assert cuda_secp.bound_ms(2048) == pytest.approx(
        2048 * halves(689 + 18 * 60, 1861 + 9 * 60) / rate * 1e3)
    rows = torch.zeros((128, 3), dtype=torch.uint8)
    rows[64:96] = 0x11                        # every digit of s nonzero
    assert cuda_secp.digit_adds(rows) == (3 * 64, 0)
    assert cuda_secp.bound_ms(3, *cuda_secp.digit_adds(rows)) == \
        pytest.approx(3 * halves(689 + 7 * 64, 1861 + 4 * 64) / rate * 1e3)

    def sr_halves(b_adds, a_adds):
        return 2 * (100 * (1128 + 7 * (b_adds + a_adds)) + 55 * 1554)
    assert cuda_sr25519.bound_ms(65536) == pytest.approx(
        65536 * sr_halves(32, 60) / rate * 1e3)
    rows = torch.zeros((128, 3), dtype=torch.uint8)
    assert cuda_sr25519.digit_adds(rows) == (0, 0)
    rows[64:96] = 0x7F                        # s + 0x80..80: bytes 0xff
    rows[96:128] = 0x77                       # k + 0x88..8: nibbles 0xf
    assert cuda_sr25519.digit_adds(rows) == (3 * 32, 3 * 64)
    rows[64:96] = 0
    rows[64] = 0x01                           # one nonzero digit of s
    assert cuda_sr25519.digit_adds(rows) == (3, 3 * 64)
    rows[64] = 0x80                           # digits -128 and 1 (carry)
    assert cuda_sr25519.digit_adds(rows) == (6, 3 * 64)
    assert cuda_sr25519.bound_ms(3, 6, 3 * 64) == pytest.approx(
        3 * sr_halves(2, 64) / rate * 1e3)


def test_comb_modules_are_checked():
    """The comb's kernel wrappers are among the modules the checks above
    cover."""
    assert "tendermint_tpu_torch.ops.cuda_comb" in _port_modules()


def test_comb_cuda_missing_raises(monkeypatch):
    """prewarm and prewarm_async raise without CUDA unless the CPU is
    asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.prewarm([bytes(32)] * 40)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.prewarm_async([bytes(32)] * 40)


def test_comb_wrappers_check_inputs_and_count_only_kernel_launches():
    from tendermint_tpu_torch.ops import cuda_comb as cc
    cc.reset_launches()
    with pytest.raises(ValueError):
        cc.comb_build(torch.zeros((8, 31), dtype=torch.uint8))
    with pytest.raises(TypeError):
        cc.comb_build(torch.zeros((8, 32), dtype=torch.int8))
    tab, dec_ok = cc.comb_build(torch.zeros((8, 32), dtype=torch.uint8))
    assert dec_ok.dtype == torch.bool and dec_ok.all()   # y = 0 decodes
    z = np.zeros((2, 32), np.uint8)
    rows = torch.from_numpy(cc.pack_rows(z, z, z, np.array([0, 8])))
    assert rows.shape == (2, cc.ROW_BYTES) == (2, 100)
    with pytest.raises(TypeError):
        cc.comb_verify(rows.to(torch.int8), tab, dec_ok)
    with pytest.raises(ValueError):
        cc.comb_verify(rows[:, :96].contiguous(), tab, dec_ok)
    with pytest.raises(ValueError):
        cc.comb_verify(rows, tab, dec_ok, groups=3)
    # a CPU tensor takes the plain version, which is not a launch; a row
    # outside the table fails its lane
    out = cc.comb_verify(rows, tab, dec_ok)
    assert out.dtype == torch.bool and out.shape == (2,) and not out.any()
    assert cc.launches == {"comb_build": 0, "comb_verify": 0}


def test_comb_bound_counts():
    """C1: the decode, -A's T and 64 windows of 5 doublings, 3 cached
    additions and 8 conversions a key, 92,193 bytes moved; C2's bound: one
    inversion a launch shared by Montgomery's trick (3 multiplies a
    signature past the first), x and y, 7 or 8 multiplies a nonzero digit,
    its own 101 bytes a signature and the table entries its data touches,
    the same at every G; C2's design count at G = 1 and 8: a block's
    inversion on the 32 lanes of its first warp and 9 multiplies an
    addition of the butterfly (G - 1 a signature)."""
    from tendermint_tpu_torch.ops import cuda_comb as cc
    rate = 132 * 64 * 1.98e9
    assert (cc.C1_MULS_PER_KEY, cc.C1_SQS_PER_KEY) == (3349, 1535)
    assert cc.bound_ms_build(1024) == pytest.approx(
        1024 * 2 * (100 * 3349 + 55 * 1535) / rate * 1e3)
    assert cc.bound_by_build(1024) == "operations"
    sd = np.zeros((4, 64), np.int8)
    kd = np.zeros((4, 64), np.int8)
    sd[:, 0] = 3
    kd[:2, 5] = -8
    vidx = np.array([0, 1, 1, 0], np.int32)
    work = cc.verify_work(sd, kd, vidx)
    assert work == {"lanes": 4, "b_adds": 4, "a_adds": 2,
                    "a_entries": 2 * 65, "b_entries": 64}
    muls = 11 + 3 * 3 + 4 * 2 + 7 * 4 + 8 * 2
    ops_ms = 2 * (100 * muls + 55 * 254) / rate * 1e3
    bytes_ms = (4 * 101 + 130 * 160 + 64 * 120) / 3.35e12 * 1e3
    assert bytes_ms > ops_ms      # four lanes touch 130 entries of -A
    assert cc.bound_ms_verify(work) == pytest.approx(bytes_ms)
    assert cc.bound_by_verify(work) == "bytes"
    assert cc._verify_s(work)[0] == pytest.approx(ops_ms / 1e3)
    # the design: at G = 1 one block of 4 signatures, no butterfly, and
    # the block's first warp inverts on all 32 lanes
    assert cc.design_ms_verify(work, 1) == pytest.approx(
        2 * (100 * (32 * 11 + 4 * 2 + 7 * 4 + 8 * 2) + 55 * 32 * 254)
        / rate * 1e3)
    # G = 8: a block serves 4 signatures, so 8 lanes take 2 blocks, and 7
    # butterfly additions each; the bound does not move with G
    w8 = cc.verify_work(np.tile(sd, (2, 1)), np.tile(kd, (2, 1)),
                        np.tile(vidx, 2))
    assert (w8["lanes"], w8["b_adds"], w8["a_adds"]) == (8, 8, 4)
    assert cc._verify_s(w8)[0] == pytest.approx(
        2 * (100 * (11 + 3 * 7 + 8 * 2 + 7 * 8 + 8 * 4) + 55 * 254) / rate)
    muls8 = 64 * 11 + 8 * 2 + 56 * 9 + 7 * 8 + 8 * 4
    assert cc.design_ms_verify(w8, 8) == pytest.approx(
        2 * (100 * muls8 + 55 * 64 * 254) / rate * 1e3)
    assert cc.design_ms_verify(w8, 8) > cc.design_ms_verify(w8, 1) > \
        cc._verify_s(w8)[0] * 1e3
    # 65,536 lanes: one inversion, 3 multiplies a signature for sharing it
    big = dict(work, lanes=65536, b_adds=65536 * 60, a_adds=65536 * 60)
    assert cc.bound_by_verify(big) == "operations"
    assert cc._verify_s(big)[0] == pytest.approx(2 * (100 * (
        11 + 3 * 65535 + 65536 * (2 + 60 * 15)) + 55 * 254) / rate)
    assert cc.verify_blocks(65536, 1) == 2048 and \
        cc.verify_blocks(256, 8) == 64 and cc.verify_blocks(17, 2) == 2
    assert [cc.groups_for(n) for n in (64, 1024, 2048, 4096, 8192)] == \
        [8, 8, 4, 2, 1]
