"""tendermint_tpu_torch command line (reference cmd/tendermint/main.go:16-35 and
cmd/tendermint/commands/*.go).

Departures from the JAX package's cmd/__main__.py:

- `start` and `light` take `--device {cuda,cpu}` (default cuda), passed
  to the Node or the light client; the reference has no such flag.  With
  no CUDA and no `--device cpu` they fail with the entry points'
  RuntimeError.
- `e2e` stays registered but its runner (`e2e/`) is not ported yet: the
  command fails with a clear message and imports nothing else.
- The default home (no --home, no TMHOME) is ~/.tendermint_tpu_torch.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

from tendermint_tpu_torch import __version__
from tendermint_tpu_torch.config.config import Config


def _home(args) -> str:
    return os.path.abspath(args.home or os.environ.get(
        "TMHOME", os.path.expanduser("~/.tendermint_tpu_torch")))


def cmd_init(args):
    """Reference commands/init.go: private validator, node key, genesis."""
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.basic import Timestamp
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    cfg = Config(home=_home(args))
    cfg.ensure_dirs()
    cfg.save()

    pv = FilePV.load_or_generate(cfg.priv_validator_key_file(),
                                 cfg.priv_validator_state_file())
    NodeKey.load_or_generate(cfg.node_key_file())

    if not os.path.exists(cfg.genesis_file()):
        pub = pv.get_pub_key()
        gdoc = GenesisDoc(
            chain_id=args.chain_id or f"test-chain-{os.urandom(3).hex()}",
            genesis_time=Timestamp(int(time.time()), 0),
            validators=[GenesisValidator(
                address=pub.address(), pub_key_type=pub.type_name,
                pub_key_bytes=pub.bytes(), power=10)])
        with open(cfg.genesis_file(), "w") as f:
            f.write(gdoc.to_json())
    print(f"Initialized node in {cfg.home}")


def cmd_start(args):
    """Reference commands/run_node.go: assemble + start a node and block."""
    from tendermint_tpu_torch.node import Node

    cfg = Config.load(_home(args))
    cfg.home = _home(args)
    from tendermint_tpu_torch.libs import log as tmlog
    tmlog.setup(level=getattr(args, "log_level", "") or cfg.log_level,
                module_levels=cfg.log_module_levels)
    if args.p2p_laddr:
        cfg.p2p.laddr = args.p2p_laddr
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    if args.persistent_peers:
        cfg.p2p.persistent_peers = args.persistent_peers
    app = _load_app(args.app)
    node = Node(cfg, app, device=args.device)
    node.start()
    print(f"node {node.node_key.node_id} started: "
          f"p2p={node.switch.actual_listen_addr()} "
          f"rpc={node.rpc_server.laddr if node.rpc_server else 'off'}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        node.stop()


def cmd_replay(args):
    """Reference cmd replay/replay_console (consensus/replay_file.go):
    print a WAL stream; --console single-steps."""
    from tendermint_tpu_torch.consensus.replay_console import replay_messages
    wal = args.wal or os.path.join(_home(args), "data", "cs.wal", "wal")
    n = replay_messages(wal, console=args.console)
    print(f"replayed {n} WAL messages from {wal}")


def _load_app(spec: str):
    """`kvstore` / `kvstore-provable` (optionally with `@snapshots=N` to
    take an app snapshot every N heights), a socket address
    (`unix:///path` or `tcp://host:port`) for an external ABCI app
    process, or `module:factory` for an in-process Python app."""
    base, _, opt = spec.partition("@")
    if base in ("", "kvstore", "kvstore-provable"):
        from tendermint_tpu_torch.abci.kvstore import (
            KVStoreApplication, ProvableKVStoreApplication)
        app = ProvableKVStoreApplication() if base == "kvstore-provable" \
            else KVStoreApplication()
        if opt:
            if not opt.startswith("snapshots="):
                raise SystemExit(
                    f"unknown app option {opt!r} (supported: snapshots=N)")
            try:
                app.snapshot_interval = int(opt[len("snapshots="):])
            except ValueError:
                raise SystemExit(f"bad snapshots interval in {spec!r}")
        return app
    if spec.startswith(("unix://", "tcp://", "grpc://")):
        from tendermint_tpu_torch.proxy import AppConns, ClientCreator
        return AppConns(ClientCreator.remote(spec))
    mod, _, fn = spec.partition(":")
    import importlib
    m = importlib.import_module(mod)
    return getattr(m, fn or "make_app")()


def cmd_testnet(args):
    """Reference commands/testnet.go: write N validator home dirs sharing
    one genesis, with persistent_peers wired full-mesh."""
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.basic import Timestamp
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    n = args.v
    out = os.path.abspath(args.o)
    base_p2p = args.starting_p2p_port
    base_rpc = args.starting_rpc_port
    homes, pvs, keys = [], [], []
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        cfg = Config(home=home, moniker=f"node{i}")
        cfg.ensure_dirs()
        pv = FilePV.load_or_generate(cfg.priv_validator_key_file(),
                                     cfg.priv_validator_state_file())
        nk = NodeKey.load_or_generate(cfg.node_key_file())
        homes.append(home)
        pvs.append(pv)
        keys.append(nk)
    gdoc = GenesisDoc(
        chain_id=args.chain_id or f"testnet-{os.urandom(3).hex()}",
        genesis_time=Timestamp(int(time.time()), 0),
        validators=[GenesisValidator(
            address=pv.get_pub_key().address(),
            pub_key_type=pv.get_pub_key().type_name,
            pub_key_bytes=pv.get_pub_key().bytes(), power=10)
            for pv in pvs])
    gjson = gdoc.to_json()
    for i, home in enumerate(homes):
        cfg = Config(home=home, moniker=f"node{i}")
        cfg.p2p.laddr = f"127.0.0.1:{base_p2p + i}"
        cfg.rpc.laddr = f"127.0.0.1:{base_rpc + i}"
        cfg.p2p.persistent_peers = ",".join(
            f"{keys[j].node_id}@127.0.0.1:{base_p2p + j}"
            for j in range(n) if j != i)
        cfg.save()
        with open(cfg.genesis_file(), "w") as f:
            f.write(gjson)
    print(f"Successfully initialized {n} node directories in {out}")


def cmd_show_node_id(args):
    from tendermint_tpu_torch.p2p.key import NodeKey
    cfg = Config(home=_home(args))
    print(NodeKey.load_or_generate(cfg.node_key_file()).node_id)


def cmd_show_validator(args):
    from tendermint_tpu_torch.privval.file_pv import FilePV
    cfg = Config(home=_home(args))
    pv = FilePV.load_or_generate(cfg.priv_validator_key_file(),
                                 cfg.priv_validator_state_file())
    pub = pv.get_pub_key()
    print(json.dumps({"type": pub.type_name, "value":
                      pub.bytes().hex()}))


def cmd_unsafe_reset_all(args):
    """Reference commands/reset.go: wipe data, keep config + keys."""
    cfg = Config(home=_home(args))
    if os.path.isdir(cfg.data_dir()):
        shutil.rmtree(cfg.data_dir())
    os.makedirs(cfg.data_dir(), exist_ok=True)
    # reset privval state (sign-state only; key survives)
    st = cfg.priv_validator_state_file()
    if os.path.exists(st):
        os.remove(st)
    print(f"Reset {cfg.data_dir()}")


def cmd_version(args):
    print(__version__)


def cmd_remote_signer(args):
    """Run this home dir's FilePV as a remote signer process that dials
    the node's priv_validator_laddr (reference privval signer harness /
    tmkms topology)."""
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.privval.signer import SignerServer

    cfg = Config.load(_home(args))
    cfg.home = _home(args)
    pv = FilePV.load_or_generate(cfg.priv_validator_key_file(),
                                 cfg.priv_validator_state_file())
    srv = SignerServer(pv, args.node_addr, max_dial_retries=10 ** 9)
    srv.start()
    print(f"remote signer for {pv.get_pub_key().address().hex()} "
          f"dialing {args.node_addr}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


def cmd_rollback(args):
    """Reference commands/rollback.go: overwrite state height n with a
    state rebuilt from block n-1; the node then re-executes block n."""
    from tendermint_tpu_torch.libs.kvdb import SQLiteDB
    from tendermint_tpu_torch.state.rollback import rollback
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.block_store import BlockStore

    cfg = Config(home=_home(args))
    block_store = BlockStore(SQLiteDB(cfg.block_db_file()))
    state_store = StateStore(SQLiteDB(cfg.state_db_file()))
    height, app_hash = rollback(block_store, state_store)
    # close() commits the deferred single-op window (ADR-017) — the
    # rewritten state must be durable when the command exits
    state_store.db.close()
    block_store.db.close()
    print(f"Rolled back state to height {height} and "
          f"hash {app_hash.hex().upper()}")


def cmd_gen_validator(args):
    """Reference commands/gen_validator.go: print a fresh validator key
    (does NOT write any file)."""
    from tendermint_tpu_torch.crypto import ed25519 as edkeys

    priv = edkeys.PrivKey.generate()
    pub = priv.pub_key()
    print(json.dumps({
        "address": pub.address().hex().upper(),
        "pub_key": {"type": pub.type_name, "value": pub.bytes().hex()},
        "priv_key": {"type": pub.type_name, "value": priv.bytes().hex()},
    }, indent=2))


def cmd_gen_node_key(args):
    """Reference commands/gen_node_key.go: write node_key.json if absent
    and print the node id."""
    from tendermint_tpu_torch.p2p.key import NodeKey

    cfg = Config(home=_home(args))
    cfg.ensure_dirs()
    nk = NodeKey.load_or_generate(cfg.node_key_file())
    print(nk.node_id)


def cmd_compact(args):
    """Reference commands/compact.go: compact the node's databases (the
    node must be stopped)."""
    from tendermint_tpu_torch.libs.kvdb import SQLiteDB

    cfg = Config(home=_home(args))
    n = 0
    for name in sorted(os.listdir(cfg.data_dir())):
        if name.endswith(".db"):
            path = os.path.join(cfg.data_dir(), name)
            db = SQLiteDB(path)
            db.compact()
            db.close()
            print(f"compacted {path}")
            n += 1
    print(f"compacted {n} databases")


def cmd_reindex_event(args):
    """Reference commands/reindex_event.go: rebuild the tx/block indexes
    from stored blocks + ABCI responses over a height range."""
    from tendermint_tpu_torch.libs.kvdb import SQLiteDB
    from tendermint_tpu_torch.state.indexer import BlockIndexer, TxIndexer
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.block_store import BlockStore

    cfg = Config(home=_home(args))
    block_store = BlockStore(SQLiteDB(cfg.block_db_file()))
    state_store = StateStore(SQLiteDB(cfg.state_db_file()))
    ix_db = SQLiteDB(os.path.join(cfg.data_dir(), "tx_index.db"))
    tx_ix, bl_ix = TxIndexer(ix_db), BlockIndexer(ix_db)  # shared, as Node
    first = args.start_height or max(block_store.base(), 1)
    last = args.end_height or block_store.height()
    if first > last:
        raise SystemExit(f"start height {first} > end height {last}")
    n = 0
    for h in range(first, last + 1):
        block = block_store.load_block(h)
        resp = state_store.load_abci_responses(h)
        if block is None or resp is None:
            print(f"skipping height {h}: missing block or responses")
            continue
        tx_ix.index_block_txs(h, block.data.txs, resp.deliver_txs or [])
        bl_ix.index(h, getattr(resp.begin_block, "events", []) or [],
                    getattr(resp.end_block, "events", []) or [])
        n += 1
    ix_db.close()   # commit the deferred index writes (ADR-017)
    print(f"reindexed events for {n} heights in [{first}, {last}]")


def cmd_debug_dump(args):
    """Reference cmd debug dump: collect node status, consensus state,
    net info, metrics, config and WAL into a tarball via the node's RPC
    (the node keeps running)."""
    import tarfile
    import urllib.request

    cfg = Config.load(_home(args))
    cfg.home = _home(args)
    out = os.path.abspath(args.output_file or
                          f"tm-debug-{int(time.time())}.tar.gz")
    rpc = args.rpc_laddr or cfg.rpc.laddr
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    def fetch(route):
        try:
            with urllib.request.urlopen(f"http://{rpc}/{route}",
                                        timeout=5) as r:
                return r.read()
        except Exception as e:
            return json.dumps({"error": f"{route}: {e}"}).encode()

    with tarfile.open(out, "w:gz") as tar:
        def add_bytes(name, body):
            import io
            info = tarfile.TarInfo(name)
            info.size = len(body)
            tar.addfile(info, io.BytesIO(body))

        for route in ("status", "consensus_state", "net_info",
                      "num_unconfirmed_txs", "metrics"):
            add_bytes(f"{route}.json", fetch(route))
        cfg_file = os.path.join(cfg.home, "config", "config.toml")
        if os.path.exists(cfg_file):
            tar.add(cfg_file, arcname="config.toml")
        wal_path = os.path.join(cfg.data_dir(), "cs.wal")
        if os.path.exists(wal_path):  # autofile group dir or single file
            tar.add(wal_path, arcname="cs.wal")
    print(f"wrote debug dump to {out}")


def _pprof_addr(args, hint: str = "") -> str:
    """Resolve the pprof listener address for the debug-* commands:
    --pprof-laddr wins, else the home config's [rpc] pprof_laddr; no
    listener is a SystemExit with the command's usage hint."""
    addr = args.pprof_laddr
    if not addr:
        cfg = Config.load(_home(args))
        cfg.home = _home(args)
        addr = cfg.rpc.pprof_laddr
    if not addr:
        raise SystemExit(
            "no pprof listener: pass --pprof-laddr or set [rpc] "
            "pprof_laddr in config.toml" + (f" ({hint})" if hint else ""))
    return addr


def cmd_debug_trace(args):
    """Snapshot the running node's flight recorder (libs/trace.py) via
    its pprof listener's GET /debug/trace and print (or write) the
    Chrome-trace JSON — load the output into chrome://tracing or
    ui.perfetto.dev to see the vote -> verify -> commit timeline."""
    import urllib.request

    addr = _pprof_addr(args, "and TM_TPU_TRACE=1 or trace.enable() on "
                             "the node to record spans")
    url = f"http://{addr}/debug/trace?since={args.since}"
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
    if args.output_file:
        out = os.path.abspath(args.output_file)
        with open(out, "w") as f:
            f.write(body)
        n = len(json.loads(body).get("traceEvents", []))
        print(f"wrote {n} trace events to {out}")
    else:
        print(body)


def cmd_debug_latency(args):
    """Snapshot the running node's latency observatory (libs/slo.py +
    the VerifyScheduler lifecycle report) via its pprof listener's
    GET /debug/latency — windowed p50/p99/burn-rate per priority
    stream and the most recent verify window's submit -> window-close
    -> stage -> launch -> settle decomposition."""
    import urllib.request

    addr = _pprof_addr(args, "and enable the SLO estimator with [slo] "
                             "enable or TM_TPU_SLO=1 for windowed "
                             "quantiles")
    url = f"http://{addr}/debug/latency"
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
    if args.output_file:
        out = os.path.abspath(args.output_file)
        with open(out, "w") as f:
            f.write(body)
        doc = json.loads(body)
        n = len((doc.get("slo") or {}).get("streams") or {})
        print(f"wrote latency report ({n} SLO streams) to {out}")
    else:
        print(json.dumps(json.loads(body), indent=2))


def cmd_debug_consensus(args):
    """Snapshot the running node's consensus observatory
    (consensus/observatory.py, ADR-020) via its pprof listener's
    GET /debug/consensus — the last N heights' block-lifecycle stage
    decompositions (propose / gossip / prevote-wait / precommit-wait /
    commit / apply / persist), per-peer part/vote receipt accounting,
    and the cross-node skew report when several in-process nodes share
    the recorder."""
    import urllib.request

    addr = _pprof_addr(args, "the observatory records by default; "
                             "TM_TPU_OBSERVATORY=0 disables it")
    url = f"http://{addr}/debug/consensus?last={args.last}"
    if args.node:
        url += f"&node={args.node}"
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
    if args.output_file:
        out = os.path.abspath(args.output_file)
        with open(out, "w") as f:
            f.write(body)
        doc = json.loads(body)
        n = sum(len(v) for v in (doc.get("nodes") or {}).values())
        print(f"wrote consensus observatory report ({n} height "
              f"records) to {out}")
    else:
        print(json.dumps(json.loads(body), indent=2))


def cmd_debug_device(args):
    """Snapshot the running node's device observatory
    (crypto/devobs.py, ADR-021) via its pprof listener's
    GET /debug/device — the last N device launches' stage/transfer/
    compute/collect decomposition with chunk-overlap ratios and
    per-shard row counts, the compile-cache inventory ((kernel, bucket
    shape) -> compile wall + hit count), and the HBM residency ledger
    (comb tables / pubkey rows / static comb / in-flight staging)."""
    import urllib.request

    addr = _pprof_addr(args, "the device observatory records by "
                             "default; TM_TPU_DEVOBS=0 disables it")
    url = f"http://{addr}/debug/device?last={args.last}"
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
    if args.output_file:
        out = os.path.abspath(args.output_file)
        with open(out, "w") as f:
            f.write(body)
        doc = json.loads(body)
        print(f"wrote device observatory report "
              f"({len(doc.get('launches') or [])} launch records, "
              f"{len(doc.get('compile_cache') or [])} compile-cache "
              f"entries) to {out}")
    else:
        print(json.dumps(json.loads(body), indent=2))


def cmd_debug_net(args):
    """Snapshot the running node's gossip observatory
    (p2p/netobs.py, ADR-025) via its pprof listener's GET /debug/net —
    per-peer/per-channel flow ledgers (bytes, queue wait, send/recv
    wall, flowrate stall), per-peer RTT, and the useful/duplicate
    receipt split the consensus state machine judged."""
    import urllib.request

    addr = _pprof_addr(args, "the gossip observatory records by "
                             "default; TM_TPU_NETOBS=0 disables it")
    url = f"http://{addr}/debug/net"
    if args.node:
        url += f"?node={args.node}"
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
    if args.output_file:
        out = os.path.abspath(args.output_file)
        with open(out, "w") as f:
            f.write(body)
        doc = json.loads(body)
        npeers = sum(len(v) for v in (doc.get("nodes") or {}).values())
        print(f"wrote gossip observatory report ({npeers} peer flows) "
              f"to {out}")
    else:
        print(json.dumps(json.loads(body), indent=2))


def cmd_debug_light(args):
    """Snapshot the running node's light serving plane
    (light/service.py, ADR-026) via its pprof listener's
    GET /debug/light — admission and coalesce stats, the follow-cursor
    table, and per-client p99 verify latency."""
    import urllib.request

    addr = _pprof_addr(args, "and enable the plane with "
                             "[light_serve] enable or "
                             "TM_TPU_LIGHT_SERVE=1")
    url = f"http://{addr}/debug/light"
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
    if args.output_file:
        out = os.path.abspath(args.output_file)
        with open(out, "w") as f:
            f.write(body)
        doc = json.loads(body)
        st = doc.get("stats") or {}
        print(f"wrote light serving report "
              f"({st.get('submitted', 0)} requests, coalesce ratio "
              f"{doc.get('coalesce_ratio', 0.0)}) to {out}")
    else:
        print(json.dumps(json.loads(body), indent=2))


def cmd_debug_control(args):
    """Snapshot the running node's adaptive control plane
    (libs/control.py, ADR-023) via its pprof listener's
    GET /debug/control — every governed knob's current vs static value
    and safe range, the bounded decision ring (what the loop did and
    why), and the kill-switch state."""
    import urllib.request

    addr = _pprof_addr(args, "and enable the controller with "
                             "[control] enable or TM_TPU_CONTROL=1")
    url = f"http://{addr}/debug/control"
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
    if args.output_file:
        out = os.path.abspath(args.output_file)
        with open(out, "w") as f:
            f.write(body)
        doc = json.loads(body)
        print(f"wrote control-plane report ({len(doc.get('knobs') or {})}"
              f" knobs, {len(doc.get('decisions') or [])} decisions) "
              f"to {out}")
    else:
        print(json.dumps(json.loads(body), indent=2))


def cmd_debug_index(args):
    """Print the pprof listener's GET /debug index — every registered
    debug endpoint with a one-line description, so operators stop
    guessing URLs."""
    import urllib.request

    addr = _pprof_addr(args)
    with urllib.request.urlopen(f"http://{addr}/debug", timeout=10) as r:
        print(r.read().decode(), end="")


def cmd_debug_kill(args):
    """Reference cmd debug kill: take a dump, then kill the node."""
    import signal

    cmd_debug_dump(args)
    pid = args.pid
    os.kill(pid, signal.SIGTERM)
    print(f"sent SIGTERM to {pid}")


def cmd_light(args):
    """Run a light-client-verifying RPC proxy against a full node
    (reference cmd light.go + light/proxy)."""
    from tendermint_tpu_torch.libs.kvdb import SQLiteDB
    from tendermint_tpu_torch.light.client import Client, TrustOptions
    from tendermint_tpu_torch.light.proxy import LightProxy
    from tendermint_tpu_torch.light.provider import HTTPProvider
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.rpc.client import HTTPClient

    primary = args.primary
    chain_id = args.chain_id
    if not chain_id:
        st = HTTPClient(primary).status()
        chain_id = st["node_info"]["network"]

    if args.trusted_height:
        opts = TrustOptions(args.trusted_height,
                            bytes.fromhex(args.trusted_hash),
                            period_s=args.trust_period)
    else:
        # trust the primary's current head (subjective initialization)
        lb = HTTPProvider(chain_id, primary).light_block(0)
        opts = TrustOptions(lb.height, lb.hash(),
                            period_s=args.trust_period)
        print(f"trusting current head {lb.height} "
              f"({lb.hash().hex().upper()})")

    home = _home(args)
    os.makedirs(home, exist_ok=True)
    db = SQLiteDB(os.path.join(home, "light.db"))
    client = Client(chain_id, opts, HTTPProvider(chain_id, primary),
                    witnesses=[HTTPProvider(chain_id, w)
                               for w in args.witnesses.split(",") if w],
                    store=LightStore(db), device=args.device)
    proxy = LightProxy(client, primary, args.laddr)
    proxy.start()
    print(f"light proxy for {chain_id} via {primary} "
          f"serving on {proxy.laddr}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        proxy.stop()


def cmd_abci_cli(args):
    """Interactive/one-shot console against an ABCI server process
    (reference abci/cmd/abci-cli: echo, info, deliver_tx, check_tx,
    commit, query)."""
    import shlex

    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.abci.client import SocketClient

    client = SocketClient(args.address)

    def _data(arg: str) -> bytes:
        return bytes.fromhex(arg[2:]) if arg.startswith("0x") \
            else arg.encode()

    def run_one(cmd: str, cargs: list) -> int:
        if cmd in ("deliver_tx", "check_tx", "query") and not cargs:
            print(f"usage: {cmd} <data|0xHEX>")
            return 1
        if cmd == "echo":
            print(client.echo(" ".join(cargs)))
        elif cmd == "info":
            r = client.info(abci.RequestInfo())
            print(json.dumps({"data": r.data,
                              "last_block_height": r.last_block_height,
                              "last_block_app_hash":
                                  (r.last_block_app_hash or b"").hex()}))
        elif cmd == "deliver_tx":
            r = client.deliver_tx(_data(cargs[0]))
            print(json.dumps({"code": r.code, "log": r.log}))
        elif cmd == "check_tx":
            r = client.check_tx(abci.RequestCheckTx(tx=_data(cargs[0])))
            print(json.dumps({"code": r.code, "log": r.log}))
        elif cmd == "commit":
            r = client.commit()
            print(json.dumps({"data": (r.data or b"").hex()}))
        elif cmd == "query":
            r = client.query(abci.RequestQuery(data=_data(cargs[0])))
            print(json.dumps({"code": r.code, "log": r.log,
                              "key": (r.key or b"").hex(),
                              "value": (r.value or b"").hex()}))
        else:
            print(f"unknown command {cmd!r}; commands: echo info "
                  f"deliver_tx check_tx commit query", flush=True)
            return 1
        return 0

    try:
        if args.command:
            raise SystemExit(run_one(args.command[0], args.command[1:]))
        print("abci-cli console; commands: echo info deliver_tx check_tx "
              "commit query; ^D exits", flush=True)
        while True:
            try:
                line = input("> ")
            except EOFError:
                break
            parts = shlex.split(line)
            if parts:
                try:
                    run_one(parts[0], parts[1:])
                except (ValueError, IndexError) as e:
                    print(f"error: {e}")
    finally:
        client.close()


def cmd_signer_harness(args):
    """Conformance-test an external remote signer (reference
    tools/tm-signer-harness): listen on --laddr, wait for the signer to
    dial in, run the protocol checks, exit nonzero on failure."""
    from tendermint_tpu_torch.privval.harness import run_harness
    from tendermint_tpu_torch.privval.signer import SignerClient

    client = SignerClient(args.laddr, accept_timeout_s=args.accept_timeout)
    bound = client._listener.getsockname()
    addr = f"{bound[0]}:{bound[1]}" if isinstance(bound, tuple) else bound
    print(f"signer harness listening on {addr}; waiting for the "
          f"signer to dial in...", flush=True)
    try:
        res = run_harness(client, chain_id=args.chain_id)
    finally:
        client.close()
    for name in res.passed:
        print(f"PASS {name}")
    for name in res.failed:
        print(f"FAIL {name}")
    print(json.dumps({"ok": res.ok, "passed": len(res.passed),
                      "failed": len(res.failed)}))
    if not res.ok:
        raise SystemExit(1)


def cmd_e2e(args):
    """Run a manifest-driven multi-process testnet end to end
    (reference test/e2e/runner/main.go).  The runner is not ported yet
    (ROADMAP Queue 1 item 10)."""
    raise SystemExit("e2e: the manifest runner is not ported yet "
                     "(ROADMAP item 10)")


def cmd_abci_kvstore(args):
    """Run the example kvstore as a standalone ABCI server process
    (reference abci/cmd/abci-cli kvstore); grpc:// addresses serve the
    gRPC transport (reference --abci grpc)."""
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication

    if args.address.startswith("grpc://"):
        from tendermint_tpu_torch.abci.grpc import GRPCServer
        srv = GRPCServer(KVStoreApplication(),
                         args.address[len("grpc://"):])
    else:
        from tendermint_tpu_torch.abci.server import ABCIServer
        srv = ABCIServer(KVStoreApplication(), args.address)
    srv.start()
    print(f"ABCI kvstore serving on {srv.addr}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


def main(argv=None):
    p = argparse.ArgumentParser(prog="tendermint_tpu_torch")
    p.add_argument("--home", default=None)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("init", help="initialize a node home dir")
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("start", help="run a node")
    sp.add_argument("--app", default="kvstore")
    sp.add_argument("--p2p-laddr", dest="p2p_laddr", default="")
    sp.add_argument("--rpc-laddr", dest="rpc_laddr", default="")
    sp.add_argument("--persistent-peers", dest="persistent_peers",
                    default="")
    sp.add_argument("--log-level", dest="log_level", default="",
                    help="debug|info|error|none (default: config)")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the node's verifiers run (default cuda)")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("testnet", help="initialize a local testnet")
    sp.add_argument("--v", type=int, default=4)
    sp.add_argument("--o", default="./mytestnet")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--starting-p2p-port", type=int, default=26656)
    sp.add_argument("--starting-rpc-port", type=int, default=26657)
    sp.set_defaults(fn=cmd_testnet)

    sp = sub.add_parser("show-node-id")
    sp.set_defaults(fn=cmd_show_node_id)
    sp = sub.add_parser("show-validator")
    sp.set_defaults(fn=cmd_show_validator)
    sp = sub.add_parser("unsafe-reset-all")
    sp.set_defaults(fn=cmd_unsafe_reset_all)
    sp = sub.add_parser("version")
    sp.set_defaults(fn=cmd_version)
    sp = sub.add_parser("remote-signer",
                        help="serve this home's validator key to a node")
    sp.add_argument("--node-addr", required=True,
                    help="the node's priv_validator_laddr to dial")
    sp.set_defaults(fn=cmd_remote_signer)

    sp = sub.add_parser("replay", help="print a consensus WAL")
    sp.add_argument("--wal", default="")
    sp.set_defaults(fn=cmd_replay, console=False)
    sp = sub.add_parser("replay-console",
                        help="single-step through a consensus WAL")
    sp.add_argument("--wal", default="")
    sp.set_defaults(fn=cmd_replay, console=True)

    sp = sub.add_parser("abci-kvstore",
                        help="run the kvstore app as an ABCI server")
    sp.add_argument("--address", default="tcp://127.0.0.1:26658")
    sp.set_defaults(fn=cmd_abci_kvstore)

    sp = sub.add_parser("abci-cli",
                        help="console against an ABCI server")
    sp.add_argument("--address", default="tcp://127.0.0.1:26658")
    sp.add_argument("command", nargs="*",
                    help="one-shot command (omit for interactive)")
    sp.set_defaults(fn=cmd_abci_cli)

    sp = sub.add_parser("signer-harness",
                        help="conformance-test a remote signer")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:0",
                    help="address to listen on for the signer")
    sp.add_argument("--chain-id", default="signer-harness-chain")
    sp.add_argument("--accept-timeout", type=float, default=60.0)
    sp.set_defaults(fn=cmd_signer_harness)

    sp = sub.add_parser("e2e",
                        help="run a manifest-driven multi-process testnet")
    sp.add_argument("manifest", help="path to the testnet TOML manifest")
    sp.add_argument("--workdir", default="")
    sp.set_defaults(fn=cmd_e2e)

    sp = sub.add_parser("rollback",
                        help="roll the state back one height")
    sp.set_defaults(fn=cmd_rollback)
    sp = sub.add_parser("gen-validator",
                        help="print a fresh validator key")
    sp.set_defaults(fn=cmd_gen_validator)
    sp = sub.add_parser("gen-node-key",
                        help="write node_key.json and print the node id")
    sp.set_defaults(fn=cmd_gen_node_key)
    sp = sub.add_parser("compact", help="compact the node's databases")
    sp.set_defaults(fn=cmd_compact)
    sp = sub.add_parser("reindex-event",
                        help="rebuild tx/block indexes from stored blocks")
    sp.add_argument("--start-height", type=int, default=0)
    sp.add_argument("--end-height", type=int, default=0)
    sp.set_defaults(fn=cmd_reindex_event)
    sp = sub.add_parser("debug-dump",
                        help="collect a diagnostic tarball from a "
                             "running node")
    sp.add_argument("--rpc-laddr", dest="rpc_laddr", default="")
    sp.add_argument("--output-file", dest="output_file", default="")
    sp.set_defaults(fn=cmd_debug_dump)
    sp = sub.add_parser("debug-trace",
                        help="snapshot the node's flight recorder as "
                             "Chrome-trace JSON")
    sp.add_argument("--pprof-laddr", dest="pprof_laddr", default="",
                    help="pprof listener (default: [rpc] pprof_laddr)")
    sp.add_argument("--since", type=int, default=0,
                    help="fetch only events after this seq cursor")
    sp.add_argument("--output-file", dest="output_file", default="")
    sp.set_defaults(fn=cmd_debug_trace)
    sp = sub.add_parser("debug-latency",
                        help="snapshot the node's latency observatory "
                             "(SLO quantiles + lifecycle decomposition)")
    sp.add_argument("--pprof-laddr", dest="pprof_laddr", default="",
                    help="pprof listener (default: [rpc] pprof_laddr)")
    sp.add_argument("--output-file", dest="output_file", default="")
    sp.set_defaults(fn=cmd_debug_latency)
    sp = sub.add_parser("debug-consensus",
                        help="snapshot the node's consensus "
                             "observatory (per-height stage "
                             "decomposition + cross-node skew)")
    sp.add_argument("--pprof-laddr", dest="pprof_laddr", default="",
                    help="pprof listener (default: [rpc] pprof_laddr)")
    sp.add_argument("--last", type=int, default=16,
                    help="newest N height records per node")
    sp.add_argument("--node", default="",
                    help="restrict to one node name (harness runs)")
    sp.add_argument("--output-file", dest="output_file", default="")
    sp.set_defaults(fn=cmd_debug_consensus)
    sp = sub.add_parser("debug-device",
                        help="snapshot the node's device observatory "
                             "(launch decomposition + compile cache + "
                             "HBM ledger)")
    sp.add_argument("--pprof-laddr", dest="pprof_laddr", default="",
                    help="pprof listener (default: [rpc] pprof_laddr)")
    sp.add_argument("--last", type=int, default=16,
                    help="newest N launch records")
    sp.add_argument("--output-file", dest="output_file", default="")
    sp.set_defaults(fn=cmd_debug_device)
    sp = sub.add_parser("debug-net",
                        help="snapshot the node's gossip observatory "
                             "(per-peer/per-channel flow + RTT + "
                             "duplicate-waste accounting)")
    sp.add_argument("--pprof-laddr", dest="pprof_laddr", default="",
                    help="pprof listener (default: [rpc] pprof_laddr)")
    sp.add_argument("--node", default="",
                    help="restrict to one node name (harness runs)")
    sp.add_argument("--output-file", dest="output_file", default="")
    sp.set_defaults(fn=cmd_debug_net)
    sp = sub.add_parser("debug-control",
                        help="snapshot the node's adaptive control "
                             "plane (knob values + decision ring + "
                             "kill state)")
    sp.add_argument("--pprof-laddr", dest="pprof_laddr", default="",
                    help="pprof listener (default: [rpc] pprof_laddr)")
    sp.add_argument("--output-file", dest="output_file", default="")
    sp.set_defaults(fn=cmd_debug_control)
    sp = sub.add_parser("debug-light",
                        help="snapshot the node's light serving plane "
                             "(admission/coalesce stats + follow "
                             "cursors + per-client p99)")
    sp.add_argument("--pprof-laddr", dest="pprof_laddr", default="",
                    help="pprof listener (default: [rpc] pprof_laddr)")
    sp.add_argument("--output-file", dest="output_file", default="")
    sp.set_defaults(fn=cmd_debug_light)
    sp = sub.add_parser("debug-index",
                        help="list the pprof listener's registered "
                             "debug endpoints")
    sp.add_argument("--pprof-laddr", dest="pprof_laddr", default="",
                    help="pprof listener (default: [rpc] pprof_laddr)")
    sp.set_defaults(fn=cmd_debug_index)
    sp = sub.add_parser("debug-kill",
                        help="collect a diagnostic tarball, then SIGTERM "
                             "the node")
    sp.add_argument("pid", type=int)
    sp.add_argument("--rpc-laddr", dest="rpc_laddr", default="")
    sp.add_argument("--output-file", dest="output_file", default="")
    sp.set_defaults(fn=cmd_debug_kill)

    sp = sub.add_parser("light",
                        help="light-client-verifying RPC proxy")
    sp.add_argument("primary", help="primary node RPC addr (host:port)")
    sp.add_argument("--laddr", default="127.0.0.1:8888")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--trusted-height", type=int, default=0)
    sp.add_argument("--trusted-hash", default="")
    sp.add_argument("--trust-period", type=float, default=86400 * 7)
    sp.add_argument("--witnesses", default="",
                    help="comma-separated witness RPC addrs")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the light client verifies (default cuda)")
    sp.set_defaults(fn=cmd_light)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
