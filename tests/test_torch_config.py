"""The port's node config (config/config.py) against the JAX package's, on
the CPU.

tests/test_config.py's cases (all but :130, whose manifest runner is ROADMAP
item 10) run through both packages; a config.toml saved by either package
is loaded by the other and compared field by field, section by section;
tests/test_comb.py:583 (the [batch_verifier] comb keys) and
tests/test_light_serve.py:509 (the [light_serve] keys) run through both;
the [control] keys of tests/test_control.py:470 are in
tests/test_torch_control.py.  Tolerance: exact equality.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import pathlib
import re
import sys
import types

import pytest

from test_torch_types import _cpu, _one_torch_thread  # noqa: F401

_MODS = {"config": "config.config", "kvstore": "abci.kvstore",
         "node": "node", "fail": "libs.fail"}


def _pkg(root, name):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    ns.Config = ns.config.Config
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)
BY_NAME = {p.name: p for p in PKGS}


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


def port_twin(name: str, only: str = "", replace=()):
    """tests/<name>.py run through the port, as a module of its own: each
    (old, new) of `replace` applied to its source, then every dotted path
    into the JAX package mapped to the port.  Its imports are each kept
    only if they resolve in the port; with `only`, the module holds that
    one test (undecorated, with its module's helpers, constants and
    fixtures, these undecorated too) and no other.  The JAX test file
    itself is imported as it is for the JAX side."""
    path = pathlib.Path(__file__).with_name(name + ".py")
    src = path.read_text()
    for old, new in replace:
        assert old in src, old
        src = src.replace(old, new)
    body = []
    for node in ast.parse(src).body:
        if only and isinstance(node, ast.FunctionDef):
            if node.name.startswith("test_") and node.name != only:
                continue
            if node.name == only or any(
                    "fixture" in ast.unparse(d)
                    for d in node.decorator_list):
                node.decorator_list = []
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            node = ast.Try(body=[node], handlers=[ast.ExceptHandler(
                type=ast.Name("ImportError", ast.Load()), name=None,
                body=[ast.Pass()])], orelse=[], finalbody=[])
        body.append(node)
    mod_ast = ast.fix_missing_locations(ast.Module(body=body,
                                                   type_ignores=[]))
    src = re.sub(r"\btendermint_tpu(?=\.)", "tendermint_tpu_torch",
                 ast.unparse(mod_ast))
    mod = types.ModuleType(f"{name}__port{'__' + only if only else ''}")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(src, f"{path} (port)", "exec"), mod.__dict__)
    return mod


def case_names(mod):
    """The names of a test module's test functions, in file order."""
    return [n for n, f in vars(mod).items()
            if n.startswith("test_") and inspect.isfunction(f)]


def call_case(fn, **fixtures):
    """A test function called with the fixtures it names (out of those
    given)."""
    names = inspect.signature(fn).parameters
    return fn(**{n: fixtures[n] for n in names})


def sections(cfg) -> dict:
    """Every section of a Config as plain values (the home aside): the
    two packages' dataclasses compare by field name and value."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "home":
            continue
        out[f.name] = dataclasses.asdict(v) \
            if dataclasses.is_dataclass(v) else v
    return out


def knobs(cfg):
    """tests/test_config.py:12's non-default knobs, and more of every
    section, on a Config."""
    cfg.consensus.timeout_commit = 2.5
    cfg.consensus.timeout_propose = 4.25
    cfg.mempool.size = 1234
    cfg.mempool.cache_size = 777
    cfg.mempool.max_txs_bytes = 9_000_000
    cfg.mempool.keep_invalid_txs_in_cache = True
    cfg.mempool.version = "v1"
    cfg.p2p.send_rate = 1_000_000
    cfg.p2p.recv_rate = 2_000_000
    cfg.p2p.dial_timeout_s = 1.5
    cfg.p2p.handshake_timeout_s = 7.0
    cfg.p2p.persistent_peers = "ab@127.0.0.1:1,cd@127.0.0.1:2"
    cfg.rpc.max_body_bytes = 65536
    cfg.rpc.pprof_laddr = "127.0.0.1:6061"
    cfg.batch_verifier.secp_lane = False
    cfg.batch_verifier.host_pool_workers = 6
    cfg.batch_verifier.tpu_threshold = 17
    cfg.block_pipeline.enable = False
    cfg.block_pipeline.depth = 7
    cfg.block_pipeline.group_commit_heights = 24
    cfg.slo.enable = True
    cfg.slo.window = 2048
    cfg.slo.consensus_p99_ms = 5.0
    cfg.slo.mempool_p99_ms = 250.0
    cfg.slo.block_interval_p99_ms = 1500.0
    cfg.slo.apply_p99_ms = 40.0
    cfg.mempool.ingress_enable = False
    cfg.mempool.ingress_queue = 321
    cfg.mempool.ingress_workers = 3
    cfg.mempool.ingress_batch = 17
    cfg.mempool.ingress_rate_per_s = 125.5
    cfg.mempool.ingress_burst = 9
    cfg.mempool.ingress_recheck_slice = 33
    cfg.state_sync.enable = True
    cfg.state_sync.rpc_servers = "127.0.0.1:1,127.0.0.1:2"
    cfg.state_sync.trust_height = 5
    cfg.state_sync.trust_hash = "ab" * 32
    cfg.state_sync.fetchers = 3
    cfg.light_serve.queue = 99
    cfg.control.enable = True
    cfg.control.period_ms = 125.0
    cfg.devobs.capacity = 64
    return cfg


# ---------------------------------------------------------------------------
# tests/test_config.py through both packages
# ---------------------------------------------------------------------------

def test_toml_roundtrip_preserves_new_knobs(pkg, tmp_path):
    cfg = pkg.Config(home=str(tmp_path), moniker="knobs")
    knobs(cfg)
    cfg.save()
    back = pkg.Config.load(str(tmp_path))
    assert sections(back) == sections(cfg)
    assert back.slo.targets_s() == {"consensus": 0.005, "mempool": 0.25,
                                    "block_interval": 1.5, "apply": 0.04}
    fresh = pkg.Config(home=str(tmp_path))
    assert fresh.mempool.ingress_enable is True
    assert fresh.mempool.ingress_queue == 8192
    assert fresh.batch_verifier.secp_lane is True
    assert fresh.slo.enable is False
    assert fresh.block_pipeline.enable is True
    assert fresh.block_pipeline.depth == 4
    assert fresh.block_pipeline.group_commit_heights == 8
    back.validate_basic()


NONSENSE = [
    ("consensus", "timeout_commit", -1.0),
    ("consensus", "timeout_propose_delta", -0.1),
    ("mempool", "size", 0), ("mempool", "max_txs_bytes", -5),
    ("mempool", "version", "v9"), ("mempool", "ingress_queue", 0),
    ("mempool", "ingress_workers", -1), ("mempool", "ingress_batch", 0),
    ("mempool", "ingress_rate_per_s", -0.5), ("mempool", "ingress_burst", -1),
    ("mempool", "ingress_recheck_slice", 0), ("p2p", "send_rate", 0),
    ("p2p", "max_num_peers", -1), ("rpc", "max_body_bytes", 0),
    ("batch_verifier", "host_pool_workers", -2),
    ("block_pipeline", "depth", 0),
    ("block_pipeline", "group_commit_heights", -1), ("slo", "window", 0),
    ("slo", "consensus_p99_ms", -1.0),
]


@pytest.mark.parametrize("sect,key,value", NONSENSE,
                         ids=[f"{s}.{k}" for s, k, _ in NONSENSE])
def test_validate_basic_rejects_nonsense(sect, key, value):
    """Each package rejects the value, naming the section, with the same
    message."""
    msgs = {}
    for p in PKGS:
        cfg = p.Config(home="/tmp/x")
        setattr(getattr(cfg, sect), key, value)
        with pytest.raises(ValueError, match=sect) as e:
            cfg.validate_basic()
        msgs[p.name] = str(e.value)
    assert msgs["jax"] == msgs["port"]


def test_node_rejects_invalid_config(pkg, tmp_path):
    cfg = pkg.Config(home=str(tmp_path), moniker="bad")
    cfg.ensure_dirs()
    cfg.consensus.timeout_commit = -3.0
    with pytest.raises(ValueError, match="consensus"):
        pkg.node.Node(cfg, pkg.kvstore.KVStoreApplication(), in_memory=True)


def test_rpc_aux_laddrs_roundtrip(pkg, tmp_path):
    cfg = pkg.Config(home=str(tmp_path))
    cfg.ensure_dirs()
    cfg.rpc.pprof_laddr = "127.0.0.1:6060"
    cfg.rpc.grpc_laddr = "127.0.0.1:26660"
    cfg.save()
    cfg2 = pkg.Config.load(str(tmp_path))
    assert cfg2.rpc.pprof_laddr == "127.0.0.1:6060"
    assert cfg2.rpc.grpc_laddr == "127.0.0.1:26660"


def test_grpc_laddr_requires_rpc_enabled(pkg):
    rc = pkg.config.RPCConfig(grpc_laddr="127.0.0.1:26660", enabled=False)
    with pytest.raises(ValueError, match="grpc_laddr"):
        rc.validate_basic()


# ---------------------------------------------------------------------------
# config.toml across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("tweak", [False, True], ids=["defaults", "knobs"])
def test_config_toml_carries_across(tmp_path, writer, reader, tweak):
    """A config.toml saved by one package loads in the other with every
    field of every section equal, and validates."""
    w, r = BY_NAME[writer], BY_NAME[reader]
    cfg = w.Config(home=str(tmp_path), moniker="across")
    if tweak:
        knobs(cfg)
    cfg.save()
    back = r.Config.load(str(tmp_path))
    assert sections(back) == sections(cfg)
    back.validate_basic()


def test_config_text_is_the_reference_but_its_title(tmp_path):
    """The two packages write the same config.toml but for the title
    line, which names the package."""
    texts = {}
    for p in PKGS:
        home = tmp_path / p.name
        cfg = knobs(p.Config(home=str(home), moniker="same"))
        cfg.save()
        texts[p.name] = (home / "config" / "config.toml").read_text()
    a, b = (texts[n].splitlines() for n in ("jax", "port"))
    assert len(a) == len(b)
    diff = [(x, y) for x, y in zip(a, b) if x != y]
    assert diff == [("# tendermint_tpu node configuration",
                     "# tendermint_tpu_torch node configuration")]


def test_config_has_no_device_key(pkg):
    """The node's device is the `start` command's --device (the port's
    departure), not a config key: neither package's config has one."""
    cfg = pkg.Config(home="/tmp/x")
    flat = sections(cfg)
    assert "device" not in flat
    assert all("device" not in v for v in flat.values()
               if isinstance(v, dict))


# ---------------------------------------------------------------------------
# tests/test_comb.py:583 and tests/test_light_serve.py:509
# ---------------------------------------------------------------------------

def test_config_comb_roundtrip(pkg, tmp_path):
    cfg = pkg.Config(home=str(tmp_path))
    assert cfg.batch_verifier.comb is True
    assert cfg.batch_verifier.table_cache_mb == 256
    cfg.batch_verifier.comb = False
    cfg.batch_verifier.table_cache_mb = 64
    cfg.save()
    cfg2 = pkg.Config.load(str(tmp_path))
    assert cfg2.batch_verifier.comb is False
    assert cfg2.batch_verifier.table_cache_mb == 64
    cfg2.validate_basic()
    cfg2.batch_verifier.table_cache_mb = -1
    with pytest.raises(ValueError, match="table_cache_mb"):
        cfg2.validate_basic()


def test_config_light_serve_roundtrip(pkg, tmp_path):
    cfg = pkg.Config(home=str(tmp_path))
    assert cfg.light_serve.enable is True
    cfg.light_serve.enable = False
    cfg.light_serve.queue = 128
    cfg.light_serve.rate_per_s = 40.0
    cfg.light_serve.burst = 8
    cfg.save()
    back = pkg.Config.load(str(tmp_path))
    assert back.light_serve.enable is False
    assert back.light_serve.queue == 128
    assert back.light_serve.rate_per_s == pytest.approx(40.0)
    assert back.light_serve.burst == 8
    back.validate_basic()
    back.light_serve.queue = 0
    with pytest.raises(ValueError, match="light_serve.queue"):
        back.validate_basic()
