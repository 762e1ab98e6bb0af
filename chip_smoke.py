"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  0  the card: CUDA available, compute capability >= 9.0, nvidia-smi line
  1  build the kernels from csrc/ (nvcc, one process a source, side by
     side) and the host C (cc); registers, spills, stack and blocks per SM
     of each verify kernel, of K4, K5 and A1, of S1 and S2, and of C1 and
     C2; S1, S2 and C2
     must each fit their design's 16 warps an SM (4 blocks of 128
     threads), checked after the report is written
  2  field: the CUDA field arithmetic (fe_selftest) against the plain
     PyTorch field on the card, on edge values and seeded elements
  3  K1, K2 and K3 on adversarial vectors (R edge vectors of the
     projective R check included) + 4,096 seeded triples, each staged in
     its own layout: kernel bitmap = plain bitmap on the card = pure-Python
     oracle
  4  ValidatorSet.verify_commit on a 150-validator commit (K1)
  5  ValidatorSet.verify_commit on a 100,000-validator commit (K2, 7
     launches over 114,688 lanes, pubkey cache hit on the second call),
     verify_sigs_bulk with 0.1% corrupted lanes, K2 against its plain
     version on a 4,096-lane slice
  6  BatchVerifier over 100,000 ad-hoc triples (K1 pipelined, 2 x 65,536)
  In phases 4-6 the wrappers are wrapped to keep one main-path launch's
  inputs and output: K1 at 256 lanes (the 150-validator commit with a
  corrupted signature), K2 at 16,384 (a chunk of the corrupted bulk run)
  and K1 at 65,536 (a chunk of the ad-hoc batch); each is held against
  its plain version on the same inputs, and that against the expected
  bitmap.  The launches run on the degradation runtime's lane worker
  thread (crypto/degrade.py); the capture is module-level and clones the
  inputs inside the launch's own bracket on the worker's current stream,
  the one the kernel ran on, before the launch's done event is recorded.
  After every run of phases 4-9 the runtime must have served it from the
  card: crypto_device_launch_total{site} rose, no device failure and no
  host fallback was counted, and the breaker is closed.
  7  times (CUDA events; host clock for end-to-end walls), K1 and K2
     beside the one-lane kernel's recorded times; phases 4-7 run
     with RLC off (its default) and must launch no K4, K5 or A1
  8  RLC on (msm.set_enabled): the phase-5 100,000-validator commit is
     vouched for by one random linear combination (route rlc-single,
     nb 131,072, c = 8; K4, K5 and A1 once each, K2 never); with one bad
     signature the combination is rejected and 7 K2 launches name it; a
     non-canonical R makes the batch rlc-ineligible (no K4 launch)
  9  RLC through BatchVerifier at 16,384 (c = 8) and 4,096 (c = 4) triples
 10  K4, K5 and A1 against their plain versions on the inputs they got in
     phases 8-9: K4 as canonical bytes and ok flags on all four of its
     launches (262,144 points twice, 32,768, 8,192) and on adversarial
     encodings (each edge y with both sign bits, the R edge vectors,
     random bytes; at a ragged size, padded to whole blocks, tiled to
     100,003); K5 and A1 ((T, K) = (1,304, 8,192) and (712, 1,024)) as
     points (cuda_msm.points_mismatch: the same point, and a valid
     extended point); K4's times at its three sizes and K5's and A1's
     beside their bounds, their plain versions' and the earlier kernels';
     K5's launch alone, also at half and twice its segment count
 11  K3 (verify_batch_staged) on the phase-6 batch's first 65,536 lanes:
     K3 = K1 = the expected bitmap, K3 = its plain version; its time
 12  the degradation runtime on the card: the phase-5 100,000-validator
     commit (one bad signature) with bulk.ed25519=raise re-verified on the
     host with no kernel launch (the degraded wall, beside phase 5's), then
     a real K2 run; the chaos matrix (raise, latency:2000 against a 0.5 s
     deadline, corrupt-bitmap at the lane site, raise at
     ops.ed25519.verify_batch) on a 4,096-validator commit (K2) and a
     4,096-triple BatchVerifier batch (K1): exact bitmaps, the failure
     class, 0 launches under a raise, 1 or more when the kernel ran; the
     breaker opened by three raises, refusing the device, and closed by
     a half-open K2 trial on an injected clock; outside a drill (no
     failpoint armed) a kernel wrapper that raises and a launch past its
     deadline raise DeviceLaneError out of both targets, with the failure
     counted and no host fallback; the 150-validator
     verify_commit with and without the spot check
     (TM_TPU_SPOT_CHECK=0), and the bulk call through the runtime beside
     the direct call
 13  the VerifyScheduler at the node's defaults (window 2 ms, max_batch
     8,192, max_pending 65,536, tpu_threshold 32): 24 consumer threads,
     one submission in flight each — blocksync replay (4 x 2 x 8,192,
     verify_items), commit checks (4 x 4 x 1,024, verify_sigs_bulk under
     priority_context(COMMIT), 10% of them pre-cached), vote pre-verify
     (8 x 10 x 150, verify_items with a 5 ms deadline, 50 of each window
     also in its pair's window) and mempool pre-checks (8 x 8 x 512,
     submit) — 126,688 triples from phases 5-6 and the generator, 1 in
     1,000 corrupted: exact bitmaps; every triple verified on the card
     once, but for the pre-cached (never) and the gossip duplicates
     (deduped, cache hits or, when the pair's windows were staged apart
     while the first copy was in flight, a second lane), with stats()
     agreeing; no shed, no direct-path fallback; every launch K1 at
     sched.ed25519, one per device lane, the first window's K1 held
     against its plain version; beside the same load on the direct path
     one call after another, and the JAX bench's 16 x 64 shape sync
     against pipelined.  Chaos through the scheduler on phase 12's
     4,096-triple batch: raise and corrupt-bitmap drills (exact bitmaps,
     sched-fallback), a K1 wrapper that raises outside a drill
     (DeviceLaneError on the future, no host fallback, the next
     submission served by the card).  The launch observatory since phase
     4: one record per launch (the ring rotates, the totals do not), each
     with its phases; each (path, nb) bucket once in the inventory with
     its first-launch wall; pub_cache = the DeviceLRU's bytes after phase
     5 and staging back to 0 after every phase; the 150-validator
     verify_commit with devobs off and on
 14  the secp256k1 and sr25519 lanes: S1's field (fe_secp_selftest)
     against the plain field, its square also against fs_mul(a, a); S2's
     field (fe2_selftest: fe_mul2 both ways, fe_sq2 and the power chain
     on them) against the plain field; S1
     and S2 against their plain versions (raw
     bitmaps) and, behind the host screens, the pure-Python oracles and
     the native C lanes: S1 on the adversarial set (s = 0, s >= N,
     r >= P, x >= P, a non-square lift_x, an off-curve R_x), on rows
     whose ladder meets the degenerate additions and on a 1,000-triple
     sweep, 1 in 10 corrupted; S2 on the tamper classes and on
     non-canonical, odd, high-bit and non-square encodings of A and R,
     and the same sweep.  BASELINE config 5: 4,096 triples round-robined
     over ed25519, secp256k1 and sr25519 (1,366 / 1,365 / 1,365, each
     lane padded to 2,048) through BatchVerifier(device="cuda"), a fresh
     SigCache a pass, one warm-up and 7 timed passes, each launching K1,
     S1 and S2 once at batch.<scheme> with an all-true bitmap and no
     host fallback: median wall, sigs/s, the lane report, the spot
     checks' share of the wall; the first pass's S1 and S2 launches
     against their plain versions.  The secp256k1 rollback
     (set_lane_enabled(False): the native host lane through the pool, at
     its default size and at one worker).  A mixed 150-validator commit
     (50 of each scheme) through ValidatorSet.verify_commit: 10 walls,
     then one bad signature of each scheme named at its index; its S1
     and S2 launches (64 lanes) against their plain versions.  Drills:
     a raise at ops.secp/ops.sr25519.verify_batch re-verified on the host
     (exact bitmap); S1's and S2's wrappers raising outside a drill
     (DeviceLaneError, no host fallback); a clean pass after.  A mixed
     verify_items call through a VerifyScheduler on the card (launches
     at sched.secp256k1 and sched.sr25519).  S1's and S2's times at
     64, 2,048 and 65,536 lanes beside their bounds and their plain
     versions
 15  the comb (C1, C2, ops/ed25519's table cache and prewarm), after
     phases 4-14 ran with it on (its default) and never launched it (the
     100k and 4,096-validator commits declined early, before their
     distinct-key sort): C1
     against its plain version as field values on adversarial encodings
     (y = p, y = p + 1, a non-square, negative zero, order-8, order-4,
     identity) and on 1,024- and 4,096-key sets; prewarms through the
     entry point (the 150-validator set and the 1,024-key set built, each
     launch held against the plain version, a 2,048-key set declined by
     the 256 MiB budget), the card's bytes beside the charged ones; the
     prewarmed 150-validator verify_commit on path comb (C2 once,
     K1 never, no doublings in the record), its bad signature named and
     its bitmap the ladder's; 65,536 triples over the 1,024-key set
     through BatchVerifier (one C2 launch at MAX_CHUNK); one unknown key
     sends a batch to K1; C2 against its plain version on its main-path
     launches, and at each G (1, 2, 4, 8 groups a signature) on the
     phase-3 vectors with s of extreme digits added and at 64, 256,
     1,024, 2,048, 4,096, 8,192, 16,384 and 65,536 lanes, each launch also
     against K1 and the oracle or the expected bitmap on the same triples;
     C1 and C2 times beside their bounds and plain versions (C1 at 150
     (k_pad 256), 1,024 and 4,096 keys, beside PR 11's times; C2 at each G
     and at the wrapper's, with its design count at each G beside the
     bound), the prewarm wall, the 150-validator wall
     prewarmed and on the ladder, the 100k commit with the comb on and off
 16  votes to a commit, for a 150-validator set (BASELINE config 2) and
     a 10,000-validator set (the VoteSet's MAX_VOTES_COUNT): a GenesisDoc
     of the set through its JSON; a block at height 2 (300 small txs and
     a signed height-1 commit) and its parts; a precommit from every
     validator through Vote.proto/from_proto, 1 in 1,000 corrupted (at
     least 2) and one conflicting precommit; the consensus pre-verify of
     every triple through a VerifyScheduler on the card (Priority
     CONSENSUS, a 5 ms deadline; the bitmap the oracle's, its K1 launch
     against the plain version); the VoteSet, where only the corrupted
     votes reach PubKey.verify_signature (VoteSetError), the conflicting
     one raises ConflictingVoteError and makes a DuplicateVoteEvidence
     that round-trips; make_commit, the LightBlock, verify_commit of the
     made commit on the card (150: K1, then C2 after a prewarm, C1's
     launch against its plain version and C2's against its plain version
     and K1; 10,000: K2 through the pubkey cache, held against its plain
     version); the block at height 3 carrying the commit, its parts
     reassembled and decoded to the same hash; an EventBus subscriber
     thread receiving the votes' and the block's events.  Walls, the
     scheduler's launches and lanes and its deadline misses are logged,
     not gated
 17  blocks through the executor (storage, ABCI and block execution):
     a 150-validator kvstore localnet (BASELINE config 2) of 60 heights
     of 1,000 txs of 64 bytes, each block made by State.make_block,
     saved with its parts and seen commit in a SQLite BlockStore and
     applied by BlockExecutor.apply_block on its default device (its
     last commit verified on the card), the state in a SQLite
     StateStore, the app through proxy.AppConns(ClientCreator.local)
     and the events indexed by an IndexerService (in memory; one
     block's txs also into SQLite, timed); its cases: a tampered
     last commit refused with the state and the app unmoved, a
     pre-verified height with no launch (and one short of 2/3 power
     refused), val: power changes (the heights after verify against the
     reordered set), a prewarmed stretch on C2 (C1 at 256 keys) until a
     key joins and the commits take K1 again; the indexer drained and
     queried; the first 10 heights replayed against the kvstore behind
     ABCIServer on a unix socket (ClientCreator.remote), every app,
     results and validators hash equal; both databases closed and
     reopened (the State field by field, every stored block by its meta's
     hash) and rollback to height 59; a 10,000-validator chain of 6
     heights of 100 txs with a power change at height 2 (K2, a
     pubkey-row cache miss for the reordered set).  Every K1, K2, C1 and
     C2 launch of the phase held against its plain version, four
     commits' kernel bitmaps against OpenSSL's, one observatory apply
     stage a height applied; each step's host wall logged, not gated
 18  blocksync replay (BASELINE config 4, its depth cut from 50,000 blocks to
     128): a 150-validator kvstore chain of 128 heights of 100 txs served
     from a BlockStore (each certifier the next block's LastCommit, the
     last the seen commit); blocksync.replay_window in windows of 64 into
     fresh SQLite stores, one coalesced verify_items a window on K1 (the
     LastCommits pre-verified, so validate_block launches nothing); the
     same through a BlockPipeline (depth 4, group commits of 8 heights,
     GroupCommitDB stores) over a VerifyScheduler on the card, the same
     state and store contents; two bad windows (a lying certifier's
     prefix lane, a block whose LastCommit holds a bad non-prefix lane),
     serial and pipelined, attributed to their height; a prewarmed window
     on C2 (C1 at 256 keys); two Switches on 127.0.0.1 (SecretConnection,
     MConnection, BlocksyncReactor) syncing the chain to height 255; phase
     17's 10,000-validator chain from its block store (the windows stop
     at its set change: K1 at >= 16,384 lanes, the strict window on K2
     with a pubkey-row cache miss); K1's wrapper raising with no
     failpoint armed in a serial window, a pipelined window and the
     reactor's sync (WindowDeviceError with the applied state, no
     WindowSyncError, no redo, no peer stopped, no host re-verify), then
     the replays and the sync finished.  Every K1, K2, C1 and C2 launch
     of the phase held against its plain version, three windows'
     bitmaps against OpenSSL's; each window's collect, verify and apply
     walls, blocks/s and signatures/s logged, not gated
 19  the light client, LightServe and evidence: BASELINE config 3 (its
     depth cut to phase 17's 10,000-validator chain of 6 heights, served
     from its SQLite stores through NodeBackedProvider): a light.Client
     trusting height 1 verifies height 6 by skipping (the height-1 set's
     1/3 and height 6's 2/3 prefix, K1/K2, the comb declined) and a second
     one heights 2-6 sequentially; a 150-validator kvstore chain of 24
     heights whose set rotates 110 keys at height 12: the client bisects,
     its trusted heights those of a client on device="cpu"; LightServe
     over that chain's growing stores with a VerifyScheduler on the card
     and its own prewarm (C1 at 256 keys for the genesis set, then for
     the rotated set on the ValidatorSetUpdates event), sixteen clients
     on follow cursors verifying every height (C2 on a prewarmed set, K1
     across the rotation until the prewarm), every verdict the direct
     path's, a tampered commit refused, the light.serve and light.coalesce
     drills' verdicts identical; LightServe over the 10,000-validator
     chain (its prewarm declined, K2); evidence: a duplicate vote pooled
     and committed in a block, a forked witness's light-client attack
     reported by the detector through NodeBackedProvider into the pool
     (every certificate >= 32 lanes on the card), tampered copies refused;
     K1's wrapper raising with no failpoint armed under a LightServe
     request and its coalesced waiter, a client verify and gossiped
     evidence (DeviceLaneError, no refused verdict, no dropped witness, no
     stopped peer, no host re-verify), then each finished.  Every K1, K2,
     C1 and C2 launch of the phase held against its plain version, the
     skipping hop's certificate bitmap against OpenSSL's; each step's
     host wall logged, not gated
 20  the mempool and the validator signer, at the reference's mempool
     defaults (size 5,000, cache 10,000, an ingress queue of 8,192,
     batches of 256, one worker, recheck slices of 256): SIGTX envelopes
     (166 bytes) from 1,000 in-repo keys, pre-verified by the IngressGate
     through a VerifyScheduler on the card at Priority.MEMPOOL (K1 at 256
     lanes a batch); (a) 6,000 signed txs (1% corrupted, 5% resubmitted)
     and 200 plain ones through a gate over a Mempool and the kvstore:
     every corrupted tx refused before the app ("invalid signature", or
     "mempool is full" once the precheck finds the pool full), every
     other response and the pool's content those of the synchronous
     check_tx path, the pool at 5,000; one window's bitmap against
     OpenSSL's; (b) the same over a PriorityMempool, its reap order and
     responses those of a gate and scheduler on device="cpu"; (c) a
     150-validator kvstore chain whose BlockExecutor reaps (a)'s pool
     while four clients flood 6,000 more signed txs: no corrupted tx in a
     block, every block's txs admitted, every admitted tx in one block,
     update's recheck offloaded to the gate's worker, each last commit on
     K1 at 256 lanes; (d) 20,000 signed txs through a gate of 16 workers
     over a PriorityMempool against a scheduler with max_pending 1,024
     while a loop pre-verifies fresh 150-validator precommit sets at
     CONSENSUS (5 ms deadline) and verifies a commit under COMMIT:
     MEMPOOL sheds as busy with a Retry-After hint, CONSENSUS never shed
     and every bitmap exact, the gate's queue at most 8,192; the votes'
     p50/p99 alone and under the flood; (e) two Switches on 127.0.0.1
     with a MempoolReactor each: 2,000 txs admitted at A reach B's pool
     through B's gate from p2p:<A's id> (B's launches and SigCache hits
     logged); (f) 150 FilePVs with key and state files, four behind
     SignerServers dialling SignerClients (two TCP, two unix): a proposal,
     150 prevotes and 150 precommits, both pre-verified at CONSENSUS on
     K1, the precommits through VoteSet.add_vote (no host verify),
     make_commit, verify_commit on K1, the next height applied; the
     double-sign guards (local, remote, reloaded from the files; the
     state files unchanged; a timestamp-only re-sign returns the first
     signature), run_harness, a redial after a dropped connection; (g)
     the ingress.admit, ingress.checktx and ingress.recheck drills, each
     with the gate's own results, then K1's wrapper raising with no
     failpoint armed under a gate batch, a batch gossiped to B's reactor
     and check_tx (DeviceLaneError on every signed tx's future, no `sig`
     rejection, the plain txs admitted, the worker alive, no peer
     stopped), each tx admitted when resubmitted.  Every K1 launch of the
     phase held against its plain version; each step's host wall, the
     admission rate and the card's share (CUDA events) logged, not gated
 21  consensus (ConsensusState, ConsensusReactor, the WAL, autofile):
     (a) BASELINE config 2, 150 ConsensusStates in this process, each over
     its own kvstore, Mempool, EvidencePool and FilePV and a BlockExecutor
     on the card (node 0 on SQLite stores with a WAL file), wired full
     mesh in memory, one VerifyScheduler on the card, ConsensusConfig()'s
     timeouts, 200 txs of 64 bytes a block in every node's mempool: 2
     heights, then 1 with the genesis set prewarmed (C1 at 256 keys, the
     storms and last commits on C2); every node the same block hashes and
     final state, no state machine dead, a K1 launch from a consensus
     pre-verify, every last commit on the card; node 0's own storm of a
     recorded height with a cold SigCache (K1 at 256 lanes) timed and
     held against OpenSSL; (b) the 4-node localnet over TCP on 127.0.0.1
     (ConsensusReactor, MempoolReactor, BlocksyncReactor, a WAL file each,
     node 0 on SQLite): txs at node 0 committed, 20 heights with no
     kernel launch (4 signatures are under the batch floor), node 3
     stopped (3/4 keep committing) and restarted over its own stores and
     WAL, a fifth node joining through blocksync (its windows launch K1
     only for signatures the process's SigCache does not hold yet) and
     switch_to_consensus, all five chains equal; (c) K1's wrapper raising
     with no failpoint armed under a storm of 149 prevotes: device_error
     set, the routine stopped, no vote applied or logged, no host verify
     on the receive thread; a fresh state over the same stores and WAL
     resumes on the card; the storm in a drill (sched.ed25519=raise)
     applied; (d) generate_wal, replay_console and a rotated WAL group.
     Every K1, C1 and C2 launch of the phase held against its plain
     version; each step's host wall and the card's share logged, not gated
 22  state sync, the RPC server and PEX, at BASELINE config 2's width: a
     150-validator kvstore chain of 121 heights of 1,000 txs of 64 bytes,
     snapshots every 50 heights (64 KiB chunks), behind two RPCServers over
     a stand-in node and a StateSyncReactor on a Switch; (b) a fresh node
     (its light client over HTTPProviders against the two servers, trust
     pinned at height 1, a SQLite RestoreLedger, the reference's default
     statesync settings) restores snapshot 100 through sync_any, the
     light certificates on K1, its app hash, data and bootstrapped State
     the chain's, then blocksyncs the 20-height tail (K1 windows) to the
     chain's app hash; (c) after a prewarm (C1 at 256 keys) a second
     joiner restores snapshot 50, its certificates on C2; (d) 1,800
     signed txs (1% corrupted) through broadcast_tx_sync from 4 client
     threads into the serving node's IngressGate, every answer a
     device="cpu" gate's, a window's bitmap OpenSSL's, 200 through
     broadcast_tx_async, RPC_BUSY_CODE from a full queue; (e) 16 clients
     calling light_verify (adjacent and non-adjacent) over LightServe
     (C2); (f) PEX among 4 Switches and a seed, a flooding peer banned;
     (g) K1's wrapper raising with no failpoint armed under sync_any
     (DeviceLaneError, nothing offered, rejected, banned or cleared; a
     fresh Syncer over the same ledger resumes), broadcast_tx_sync and
     light_verify (-32603), and the statesync.* drills.  Every K1, C1 and
     C2 launch of the phase held against its plain version; each step's
     wall, the restore's rate and the card's share logged, not gated
 23  the node, its config, the CLI and the light proxy: (a) four node
     processes from the CLI's `testnet` homes (`start --device cuda`, each
     home's [batch_verifier] tpu_threshold 1), 2,000 signed txs (1%
     corrupted) into node 0's broadcast_tx_sync from 4 client threads,
     gossiped and pre-verified by each process's IngressGate (K1), every
     answer a device="cpu" gate's here, the chains equal at height 12,
     each process's launches, failures, fallbacks and breaker read from
     its /metrics, node 3 SIGKILLed and restarted from its home, the
     debug-device, debug-consensus, show-node-id and version commands,
     each node's own height wall and /debug/gc; (b) at BASELINE config
     2's width, a Node(device="cuda") serving a 150-validator kvstore
     chain of 61 heights of 1,000 txs from its SQLite home (snapshots
     every 25), a fresh Node with [state_sync] enable restoring snapshot
     50 through its own routine (certificates on K1), blocksyncing the
     tail (K1 windows) and switching to consensus with the chain's app
     hash, a LightProxy (after a prewarm: C1, its certificates on C2)
     whose headers and commits equal the node's RPC, the joiner's
     /debug/device and /debug/light; (c) K1's wrapper raising with no
     failpoint armed under a joiner's _statesync_routine (device_error,
     no blocksync fallback, nothing offered, rejected or banned; a fresh
     Node over the same home resumes from the RestoreLedger), the
     control.decide=raise drill (every knob reverts).  Every K1, C1 and C2
     launch of (b) and (c) held against its plain version
 24  the in-process network harness and the e2e runner: (a) the
     catalog's widest scenario, partition_heal_16 (16 validators, each a
     Node(device="cuda") over the fault-injecting in-memory transport,
     through NetHarness(device="cuda"); slot 0's [batch_verifier]
     tpu_threshold 1 through its cfg_mutator seam, so every CONSENSUS
     window of fresh votes goes to K1): no ChainWatcher violation, the 16
     nodes' blocks equal at every common height, cross-group frames
     swallowed by the partition, every K1 launch its plain version's; the
     scheduler's launches, lanes and deadline misses, host verifies on
     the receive threads against SigCache hits, each height's wall and
     round, full collections and the card's share logged; on a
     16-validator persist=True harness, K1's wrapper raising once with no
     failpoint armed (device_error on the nodes whose votes were in the
     window, no violation, the liveness gate failing by the fault's
     name, a fresh harness node over each faulted home resuming on the
     card) and the vnet.deliver and harness.step drills; (b) beside (a),
     networks/ci.toml through `python -m tendermint_tpu_torch.cmd e2e
     --device cuda` (4 validators with kill, pause and restart, a
     state-syncing full node, 2 evidence items): every node process on
     the card with 0 launch failures and fallbacks and the breaker
     closed on its /metrics, read from outside while it runs; the
     runner's stages and stats; the full node's app hash the chain's
 25  the multi-GPU data planes (parallel/sharding.py): (a) data_plane()
     is None on this one-card host (and under TM_TPU_NO_MESH=1); a plane
     of 4 positions on cuda:0 (make_mesh([cuda:0] * 4)) runs K1 on each
     position's lanes of phase 6's 100,000 triples (plane.verify_batch,
     then BatchVerifier with the plane installed), K3 on phase 5's
     corrupted 100,000-validator bulk (make_sharded_verifier, the compact
     route: all-valid false), rlc-sharded on phase 8's commit (K4, K5 and
     A1 a position; vouched, then one bad signature rejected and named by
     the plane's K1) and phase 15's 1,024-key comb at three budgets
     (mesh-comb, mesh-comb-sharded, the single-device comb; the
     mesh_tables ledger), every bitmap and verdict the single-device
     route's; chaos at sharding.mesh_stage and sharding.mesh_comb; a
     position's K1 wrapper raising outside a drill (DeviceLaneError, no
     redo, no plain version); each kernel launched on every position, its
     first launch held against its plain version; the walls beside the
     single-device walls (one card: the plane's overhead, not scaling);
     (b) two ranks of a gloo process group on cuda:0 (`--gmesh-child`,
     started before phase 24): verify_sigs_bulk(coordinated=True) on a
     4,096-validator commit with one bad signature (route global-mesh,
     K3 on each rank's half, both bitmaps the single-device one), one
     lockstep replay_window of a 150-validator chain of 16 heights (the
     chain's app hash), the poison latch (rank 1 latches, rank 0 reads
     None within 2 x _POISON_CHECK_EVERY_S, the next call on both ranks
     local), every K3 launch against its plain version
 26  the kernels line; then the last line {"ok": true, "device": ...}

Signatures come from a seeded incremental generator (a_i = a_0 + i, so
A_i = A_{i-1} + B), because signing 100k triples one by one in pure
Python would take a quarter of an hour.  Longer output goes to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import atexit
import base64
import copy
import gc
import hashlib
import http.client
import io
import json
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from queue import Empty as QueueEmpty
from types import SimpleNamespace


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(**kw) -> None:
    print(json.dumps(kw, default=str), flush=True)


# -- phase 0: the card ------------------------------------------------------

import torch  # noqa: E402

if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is false: this script needs a GPU")
check(torch.cuda.get_device_capability(0) >= (9, 0),
      f"compute capability {torch.cuda.get_device_capability(0)} < 9.0")

import numpy as np  # noqa: E402

import tendermint_tpu_torch as T  # noqa: E402
from tendermint_tpu_torch.crypto import _edref  # noqa: E402
from tendermint_tpu_torch.crypto import _ristretto  # noqa: E402
from tendermint_tpu_torch.crypto import batch as cbatch  # noqa: E402
from tendermint_tpu_torch.crypto import degrade  # noqa: E402
from tendermint_tpu_torch.crypto import devobs  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as edkeys  # noqa: E402
from tendermint_tpu_torch.crypto import lanepool  # noqa: E402
from tendermint_tpu_torch.crypto import scheduler as vsched  # noqa: E402
from tendermint_tpu_torch.crypto import secp256k1 as secpkeys  # noqa: E402
from tendermint_tpu_torch.crypto import sr25519 as srkeys  # noqa: E402
from tendermint_tpu_torch.libs import fail as failpoints  # noqa: E402
from tendermint_tpu_torch.libs import native  # noqa: E402
from tendermint_tpu_torch.libs import slo  # noqa: E402
from tendermint_tpu_torch.libs import trace  # noqa: E402
from tendermint_tpu_torch.libs.metrics import Registry  # noqa: E402
from tendermint_tpu_torch.ops import cuda_comb as cc  # noqa: E402
from tendermint_tpu_torch.ops import cuda_ed25519 as ck  # noqa: E402
from tendermint_tpu_torch.ops import cuda_msm as cm  # noqa: E402
from tendermint_tpu_torch.ops import cuda_secp as cs1  # noqa: E402
from tendermint_tpu_torch.ops import cuda_sr25519 as cs2  # noqa: E402
from tendermint_tpu_torch.ops import ed25519 as E  # noqa: E402
from tendermint_tpu_torch.ops import field as F  # noqa: E402
from tendermint_tpu_torch.ops import msm  # noqa: E402
from tendermint_tpu_torch.ops import secp as secp_ops  # noqa: E402
from tendermint_tpu_torch.ops import sr25519 as sr_ops  # noqa: E402
from tendermint_tpu_torch.ops._nvcc import parse_ptxas  # noqa: E402
from tendermint_tpu_torch.abci import types as abci_t  # noqa: E402
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication  # noqa: E402
from tendermint_tpu_torch.abci.server import ABCIServer  # noqa: E402
from tendermint_tpu_torch.abci.types import ResponseDeliverTx  # noqa: E402
from tendermint_tpu_torch.consensus import observatory as obsv  # noqa: E402
from tendermint_tpu_torch.consensus import config as cconfig  # noqa: E402
from tendermint_tpu_torch.consensus import reactor as creactor  # noqa: E402
from tendermint_tpu_torch.consensus import \
    replay_console as cconsole  # noqa: E402
from tendermint_tpu_torch.consensus import round_types as crt  # noqa: E402
from tendermint_tpu_torch.consensus import state as cstate  # noqa: E402
from tendermint_tpu_torch.consensus import wal as cwal  # noqa: E402
from tendermint_tpu_torch.consensus import \
    wal_generator as cwalgen  # noqa: E402
from tendermint_tpu_torch.libs import autofile  # noqa: E402
from tendermint_tpu_torch.libs import log as tmlog  # noqa: E402
from tendermint_tpu_torch.blocksync import replay as breplay  # noqa: E402
from tendermint_tpu_torch.blocksync.pool import BlockPool  # noqa: E402
from tendermint_tpu_torch.blocksync.reactor import \
    BlocksyncReactor  # noqa: E402
from tendermint_tpu_torch.libs.kvdb import (GroupCommitDB, MemDB,  # noqa: E402
                                            SQLiteDB)
from tendermint_tpu_torch.libs.metrics import ConsensusMetrics  # noqa: E402
from tendermint_tpu_torch.libs.metrics import LightMetrics  # noqa: E402
from tendermint_tpu_torch import light  # noqa: E402
from tendermint_tpu_torch.light import provider as lprov  # noqa: E402
from tendermint_tpu_torch.light import service as lserve  # noqa: E402
from tendermint_tpu_torch.light.service import LightRequest  # noqa: E402
from tendermint_tpu_torch.mempool import ingress  # noqa: E402
from tendermint_tpu_torch.mempool import reactor as mreactor  # noqa: E402
from tendermint_tpu_torch.mempool.mempool import Mempool  # noqa: E402
from tendermint_tpu_torch.mempool.priority_mempool import \
    PriorityMempool  # noqa: E402
from tendermint_tpu_torch.privval import file_pv as fpv  # noqa: E402
from tendermint_tpu_torch.privval import signer as pvsigner  # noqa: E402
from tendermint_tpu_torch.privval.harness import run_harness  # noqa: E402
from tendermint_tpu_torch.types.proposal import Proposal  # noqa: E402
from tendermint_tpu_torch.evidence import pool as evpool  # noqa: E402
from tendermint_tpu_torch.evidence import reactor as evreactor  # noqa: E402
from tendermint_tpu_torch.libs.metrics import P2PMetrics  # noqa: E402
from tendermint_tpu_torch.p2p import netobs  # noqa: E402
from tendermint_tpu_torch.p2p.key import NodeKey  # noqa: E402
from tendermint_tpu_torch.p2p.switch import Switch  # noqa: E402
from tendermint_tpu_torch.p2p.pex import (AddrBook, PEX_CHANNEL,  # noqa: E402
                                           PexReactor, PexRequest)
from tendermint_tpu_torch.rpc.server import RPCServer  # noqa: E402
from tendermint_tpu_torch.rpc import client as rpcclient  # noqa: E402
from tendermint_tpu_torch.libs import control  # noqa: E402
from tendermint_tpu_torch.config.config import Config as NodeConfig  # noqa: E402
from tendermint_tpu_torch.light.proxy import LightProxy  # noqa: E402
from tendermint_tpu_torch.node import Node  # noqa: E402
from tendermint_tpu_torch.e2e import load_manifest  # noqa: E402
from tendermint_tpu_torch.networks import scenarios as nscen  # noqa: E402
from tendermint_tpu_torch.networks.harness import (  # noqa: E402
    NetHarness, ScenarioFailure)
from tendermint_tpu_torch.rpc.server import RPC_BUSY_CODE  # noqa: E402
from tendermint_tpu_torch.statesync import syncer as ssync  # noqa: E402
from tendermint_tpu_torch.statesync.ledger import RestoreLedger  # noqa: E402
from tendermint_tpu_torch.statesync.reactor import \
    StateSyncReactor  # noqa: E402
from tendermint_tpu_torch.statesync.stateprovider import \
    StateProvider  # noqa: E402
from tendermint_tpu_torch.state import pipeline as bpipe  # noqa: E402
from tendermint_tpu_torch.proxy import AppConns, ClientCreator  # noqa: E402
from tendermint_tpu_torch.state import execution as sexec  # noqa: E402
from tendermint_tpu_torch.state.indexer import (  # noqa: E402
    BlockIndexer, IndexerService, TxIndexer)
from tendermint_tpu_torch.state.rollback import rollback  # noqa: E402
from tendermint_tpu_torch.state.state import state_from_genesis  # noqa: E402
from tendermint_tpu_torch.state.store import StateStore  # noqa: E402
from tendermint_tpu_torch.store.block_store import BlockStore  # noqa: E402
from tendermint_tpu_torch.types import block as tblock  # noqa: E402
from tendermint_tpu_torch.types import event_bus as tbus  # noqa: E402
from tendermint_tpu_torch.types import evidence as tev  # noqa: E402
from tendermint_tpu_torch.types import genesis as tgen  # noqa: E402
from tendermint_tpu_torch.types import light_block as tlight  # noqa: E402
from tendermint_tpu_torch.types import params as tparams  # noqa: E402
from tendermint_tpu_torch.types import part_set as tparts  # noqa: E402
from tendermint_tpu_torch.types import vote as tvote  # noqa: E402
from tendermint_tpu_torch.types import vote_set as tvset  # noqa: E402
from tendermint_tpu_torch.types.basic import (BlockID, BlockIDFlag,  # noqa: E402
                                              PartSetHeader, SignedMsgType,
                                              Timestamp)
from tendermint_tpu_torch.types.canonical import \
    commit_sign_bytes_batch  # noqa: E402
from tendermint_tpu_torch.types.commit import Commit, CommitSig  # noqa: E402
from tendermint_tpu_torch.types.validator import Validator  # noqa: E402
from tendermint_tpu_torch.types.validator_set import (  # noqa: E402
    CommitVerifyError, ValidatorSet)

check(os.environ.get("TM_TPU_DISABLE_BATCH") != "1"
      and not failpoints.armed(), "TM_TPU_DISABLE_BATCH=1 or TM_TPU_FAILPOINTS is set: this script "
      "measures the card, not the host lanes or a chaos drill")
T0 = time.perf_counter()
DEV = torch.device("cuda", 0)
KIND = torch.cuda.get_device_name(0)
SMI = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
CARD = SMI[0] if SMI else KIND
print(CARD, flush=True)
OUT_DIR = "chiprun_out"
REPORT: dict = {"card": CARD, "torch": torch.__version__,
                "cuda": torch.version.cuda}
P, L = F.P, E.L
SEED = 20261016


# -- phase 24 (a)'s process: the 16-validator network on the card -------------
# `python3 chip_smoke.py --network-child DIR` runs the catalog's widest
# scenario, partition_heal_16, and nothing else: 16 validators, each a
# Node(device="cuda") over the fault-injecting in-memory transport
# (NetHarness(device="cuda")), at the scenario's own consensus clock.
# Phase 24 starts it as a process of its own before phase 17 and reads it
# back at its end: 16 state machines in one process hold its GIL for 50-220
# s (the rounds escalate: PERF.md §6), and the earlier phases run on
# other cores meanwhile.  Slot 0 installs the process's VerifyScheduler and,
# through its cfg_mutator seam, takes [batch_verifier] tpu_threshold 1
# (phase 23's setting), so every window of fresh votes goes to K1 (16 votes
# a round are under the default 32).  The launch counts are zeroed before
# the harness boots and read when it has stopped; every K1 launch's input
# and output is kept for phase 24 to hold against the plain version.
def thr1_24(cfg):
    """A harness slot's config, through the harness's cfg_mutator seam:
    the VerifyScheduler the slot installs takes every window to the
    card."""
    cfg.batch_verifier.tpu_threshold = 1


def network_child(out_dir: str) -> None:
    sc = nscen.by_name("partition_heal_16")
    check(sc["validators"] == 16 and not sc.get("persist")
          and [s["op"] for s in sc["steps"]] == [
              "wait_height", "partition", "wait_height", "heal",
              "wait_height"],
          f"phase 24 (a): the catalog's partition_heal_16 is {sc}")
    bare, kept, label = ck.verify_packed, [], [""]
    kept_lock = threading.Lock()

    def keeping(packed):
        out = bare(packed)
        with kept_lock:
            kept.append((label[0], packed.clone(), out.clone()))
        return out

    # host verify_signature calls by the thread that made them: the
    # nodes' receive threads ("consensus-<name>") against every other
    hostv = {"consensus": 0, "other": 0}
    real_verify = edkeys.PubKey.verify_signature

    def counted(self, msg, sig):
        kind = ("consensus" if threading.current_thread().name
                .startswith("consensus-") else "other")
        hostv[kind] += 1
        return real_verify(self, msg, sig)

    gcs = {"n": [0, 0, 0], "s": [0.0, 0.0, 0.0], "t0": 0.0}

    def on_gc(stage, info):
        if stage == "start":
            gcs["t0"] = time.perf_counter()
        else:
            gcs["n"][info["generation"]] += 1
            gcs["s"][info["generation"]] += time.perf_counter() - gcs["t0"]

    ck.verify_packed = keeping
    edkeys.PubKey.verify_signature = counted
    gc.callbacks.append(on_gc)
    tmlog.setup("info", module_levels="consensus:error,p2p:error,node:error,"
                "blocksync:error,mempool:error,state:error,light:error,"
                "evidence:error,statesync:error,pex:error")
    h = NetHarness(validators=sc["validators"], seed=SEED,
                   workdir=os.path.join(out_dir, "a"),
                   consensus_overrides=sc["consensus"], device=DEV)
    h.nodes[0].cfg_mutator = thr1_24
    cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
    commits, walls, sched = [], {}, [None]
    ck.reset_launches()
    t = time.perf_counter()
    label[0] = "a boot"
    h.start()
    walls["a boot"] = time.perf_counter() - t
    sched[0] = vsched.installed()
    cs0 = h.nodes[0].node.consensus
    cs0.on_committed.append(lambda b: commits.append(
        (b.header.height, time.perf_counter(), cs0.rs.commit_round)))
    check(sched[0] is not None and sched[0].tpu_threshold == 1
          and sched[0].device == DEV
          and all(hn.node.device == DEV for hn in h.nodes),
          "phase 24 (a): slot 0's scheduler or a node is not on the card")
    hostv.update(consensus=0, other=0)
    hits0 = (cbatch.verified_sigs.hits, cbatch.verified_sigs.misses)
    label[0] = "a scenario"
    t_sc = time.perf_counter()
    res = h.run_scenario(sc)
    walls["a scenario"] = time.perf_counter() - t_sc
    t_end = time.perf_counter()
    label[0] = ""
    top = min(hn.height() for hn in h.nodes)
    for hh in range(1, top + 1):
        ids = {bytes(hn.node.block_store.load_block_meta(hh).block_id.hash)
               for hn in h.nodes}
        check(len(ids) == 1, f"phase 24 (a): the 16 nodes' blocks differ "
              f"at height {hh}")
    grp = {hn.addr: int(hn.idx >= 11) for hn in h.nodes}
    dec = h.net.decisions()
    cut = [d for d in dec if d[5] == "drop:partition"]
    check(cut and all(grp[d[0]] != grp[d[1]] for d in cut),
          f"phase 24 (a): the partition swallowed {len(cut)} frames")
    check(res["violations"] == [] and h.watcher.violations == []
          and not h.device_errors(),
          f"phase 24 (a): violations {res['violations']}, card faults "
          f"{h.device_errors()}")
    host = dict(hostv)
    cache = (cbatch.verified_sigs.hits - hits0[0],
             cbatch.verified_sigs.misses - hits0[1])
    flows = len(h.gossip_table()["links"])
    t = time.perf_counter()
    h.stop()
    walls["a stop"] = time.perf_counter() - t
    launches = {k: v for k, v in ck.launches.items() if v}
    st = sched[0].stats()
    rt = degrade.runtime()
    bad = [ln for c in (rt.metrics.device_failures, rt.metrics.host_fallbacks)
           for ln in c.render() if not ln.startswith("#")
           and float(ln.rsplit(" ", 1)[1]) > 0]
    check(launches.get("verify_packed", 0) > 0 and st["launches"] > 0
          and st["shed"] == 0 and not bad
          and rt.breaker.state == degrade.CLOSED,
          f"phase 24 (a): the card did not serve the scenario: {launches}, "
          f"{st}, {bad}, breaker {rt.breaker.state}")
    per_h, prev = [], t_sc
    for hh, tc, rnd in [c for c in commits if c[1] <= t_end]:
        per_h.append({"height": hh, "wall_s": tc - prev,
                      "commit_round": rnd})
        prev = tc
    report = {
        "scenario": sc["name"], "validators": sc["validators"],
        "heights": top, "block_hashes_equal": True, "violations": 0,
        "partition_drops": len(cut), "decisions": len(dec),
        "dropped": dict(h.net.dropped), "gossip_flows": flows,
        "steps": [{"op": s["step"]["op"], "dur_s": s["dur_s"],
                   "heights": sorted(set(s["heights"].values()))}
                  for s in res["steps"]],
        "per_height": per_h,
        "rounds_past_0": sum(1 for r in per_h if r["commit_round"] > 0),
        "launches": launches,
        "scheduler": {k: st[k] for k in (
            "submissions", "items", "launches", "lanes", "cache_hits",
            "dedup", "shed")},
        "consensus_deadline_misses": sched[0]._metrics()
        .sched_deadline_miss.value(priority="consensus"),
        "host_verify_signature": host,
        "sigcache": {"hits": cache[0], "misses": cache[1]},
        "gc": {"collections": gcs["n"], "seconds": gcs["s"]},
        "walls_s": walls}
    torch.save([(lab, p.cpu(), o.cpu()) for lab, p, o in kept],
               os.path.join(out_dir, "network_a.pt"))
    with open(os.path.join(out_dir, "network_a.json"), "w") as f:
        json.dump(report, f, default=str)


# -- phase 25 (b)'s processes: two ranks of one global plane on the card ------
# `python3 chip_smoke.py --gmesh-child DIR RANK PORT` is one rank of a
# two-process job (gloo, a TCP store on 127.0.0.1:PORT, rank 0 its server),
# both ranks on cuda:0, so that the global plane (parallel/sharding.py
# _GlobalDataPlane) has two positions, one a rank.  Phase 25 writes the
# inputs (DIR/gmesh_in.pkl: a 4,096-validator commit with one bad signature
# and a 150-validator chain from one seed) and starts both ranks before
# phase 24; each rank, in lockstep with the other: (1) verify_sigs_bulk(
# coordinated=True) on the commit, (2) one lockstep replay_window of the
# chain into fresh stores, (3) the latch: rank 1 calls
# disable_global_plane(), rank 0's global_plane() must read None within
# 2 x _POISON_CHECK_EVERY_S, and the next coordinated bulk call of both
# ranks takes the local route.  Every K3 launch's inputs and output are kept
# and held against the plain version in the rank; the launch counts of each
# step are zeroed before it and read after.  Its report: DIR/gmesh_<rank>.json.
def gmesh_child(out_dir: str, rank: int, port: int) -> None:
    import pickle
    from datetime import timedelta

    import torch.distributed as dist

    from tendermint_tpu_torch.parallel import sharding as shd

    with open(os.path.join(out_dir, "gmesh_in.pkl"), "rb") as f:
        inp = pickle.load(f)
    ck.kernels()
    bare, kept = ck.verify_staged, []

    def keeping(*rows):
        out = bare(*rows)
        kept.append(([r.clone() for r in rows], out.clone()))
        return out

    ck.verify_staged = keeping
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=300))
    rep = {"rank": rank, "backend": dist.get_backend()}

    def step(name, fn):
        ck.reset_launches()
        n_kept = len(kept)
        dist.barrier()
        t = time.perf_counter()
        out = fn()
        wall_s = time.perf_counter() - t
        ll = dict(E.last_launch())
        rep[name] = {"wall_s": wall_s, "path": ll.get("path"),
                     "shards": ll.get("shards"), "nb": ll.get("nb"),
                     "all_valid": ll.get("all_valid"),
                     "launches": {k: v for k, v in ck.launches.items() if v},
                     "k3_lanes": [int(o.shape[0]) for _, o in kept[n_kept:]]}
        return out

    try:
        keys = [edkeys.PubKey(p) for p in inp["pubs"]]
        bits = step("bulk", lambda: cbatch.verify_sigs_bulk(
            keys, inp["msgs"], inp["sigs"], device=DEV, coordinated=True))
        rep["bulk"]["bitmap"] = np.packbits(bits).tobytes().hex()
        gdoc = inp["gdoc"]
        app = KVStoreApplication()
        app.init_chain(abci_t.RequestInitChain(
            chain_id=gdoc.chain_id, validators=[
                abci_t.ValidatorUpdate("ed25519", v.pub_key_bytes, v.power)
                for v in gdoc.validators]))
        ex = sexec.BlockExecutor(StateStore(MemDB()), app, device=DEV)
        store = BlockStore(MemDB())
        blocks, certs = inp["blocks"], inp["certs"]
        state, applied = step("replay", lambda: breplay.replay_window(
            ex, store, state_from_genesis(gdoc), blocks, certs,
            max_window=len(blocks)))
        rep["replay"].update(applied=applied,
                             app_hash=bytes(state.app_hash).hex())
        # the latch
        dist.barrier()
        latch = {"check_every_s": shd._POISON_CHECK_EVERY_S}
        if rank == 1:
            shd.disable_global_plane()
            latch["self_latched"] = shd._GLOBAL_PLANE is False
        dist.barrier()
        if rank == 0:
            t = time.monotonic()
            seen = False
            while time.monotonic() - t < 3 * shd._POISON_CHECK_EVERY_S:
                with shd.lockstep():
                    if shd.global_plane() is None:
                        seen = True
                        break
                time.sleep(0.02)
            latch.update(peer_saw_poison=seen,
                         seen_after_s=time.monotonic() - t)
        rep["latch"] = latch
        bits2 = step("after_latch", lambda: cbatch.verify_sigs_bulk(
            keys, inp["msgs"], inp["sigs"], device=DEV, coordinated=True))
        rep["after_latch"]["bitmap"] = np.packbits(bits2).tobytes().hex()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    ck.verify_staged = bare
    rows = []
    for rows_in, out in kept:
        want = ck.verify_staged_plain(*rows_in)
        err = np.abs(out.cpu().numpy().astype(int)
                     - want.cpu().numpy().astype(int))
        rows.append((f"rank {rank}", int(out.shape[0]), int(err.sum()),
                     float(err.max())))
    rt = degrade.runtime()

    def total(counter):
        return sum(float(ln.rsplit(" ", 1)[1]) for ln in counter.render())

    rep.update(k3_vs_plain=rows, failures=total(rt.metrics.device_failures),
               fallbacks=total(rt.metrics.host_fallbacks),
               breaker=rt.breaker.state)
    with open(os.path.join(out_dir, f"gmesh_{rank}.json"), "w") as f:
        json.dump(rep, f, default=str)


MANIFEST24 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "networks", "ci.toml")


def http24(addr, path, timeout=2.0):
    with urllib.request.urlopen(f"http://{addr}{path}",
                                timeout=timeout) as r:
        return r.read().decode()


def rpc24(addr, method, **params):
    """One JSON-RPC call with a short timeout (a paused process does not
    answer); None while the node does not answer."""
    try:
        return rpcclient.HTTPClient(addr, timeout=2.0).call(method, **params)
    except Exception:  # noqa: BLE001 - a node killed or paused on purpose
        return None


def metric23(text, name, label=""):
    """The sum over its label sets (those holding `label`) of a metric in
    a /metrics exposition."""
    total = 0.0
    for ln in text.splitlines():
        if (ln.startswith(name + "{") or ln.startswith(name + " ")) \
                and label in ln:
            total += float(ln.rsplit(" ", 1)[1])
    return total


class Watch24:
    """(b)'s node processes read from outside, as an operator would, every
    0.2 s from a process of its own (the state-synced full node may live
    only seconds before the runner's last stages stop it, and the smoke's
    own process is busy with phases 17-23): each node's command line (its
    --device) from /proc, its runtime's launch, failure, fallback and
    breaker metrics from /metrics, and the state-synced full node's app
    against the chain (its abci_info at height h against a validator's
    header h + 1)."""

    def __init__(self, man, e2e_dir):
        self.man, self.e2e_dir = man, e2e_dir
        self.rows = {n.name: {"scrapes": 0} for n in man.nodes}
        self.devices = {n.name: set() for n in man.nodes}
        self.laddrs: dict = {}
        self.app_pairs = []

    def _laddr(self, name):
        if name not in self.laddrs:
            try:
                self.laddrs[name] = NodeConfig.load(
                    os.path.join(self.e2e_dir, name)).rpc.laddr
            except Exception:  # noqa: BLE001 - not written yet
                return None
        return self.laddrs[name]

    def _live(self):
        """The nodes whose process runs now (each one's --device noted)."""
        live = set()
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().decode(errors="replace").split("\0")
            except OSError:
                continue
            if "tendermint_tpu_torch.cmd" not in argv or "start" not in argv \
                    or "--home" not in argv:
                continue
            home = os.path.abspath(argv[argv.index("--home") + 1])
            name = os.path.basename(home)
            if os.path.dirname(home) == self.e2e_dir \
                    and name in self.devices:
                self.devices[name].add(argv[argv.index("--device") + 1]
                                       if "--device" in argv else None)
                live.add(name)
        return live

    def _tick(self):
        live = self._live()
        for n in self.man.nodes:
            a = self._laddr(n.name) if n.name in live else None
            if a is None:
                continue
            try:
                text = http24(a, "/metrics")
            except Exception:  # noqa: BLE001 - not up yet or paused
                continue
            row = self.rows[n.name]
            row.update(
                scrapes=row["scrapes"] + 1,
                launches=metric23(
                    text, "tendermint_crypto_device_launch_total"),
                failures=metric23(
                    text, "tendermint_crypto_device_failure_total"),
                fallbacks=metric23(
                    text, "tendermint_crypto_host_fallback_total"),
                breaker=metric23(text, "tendermint_crypto_breaker_state"),
                breaker_reported="tendermint_crypto_breaker_state" in text)
            info = rpc24(a, "abci_info") if n.state_sync else None
            hh = int(info["response"]["last_block_height"] or 0) \
                if info else 0
            for v in (self.man.validators() if hh >= 1 else ()):
                va = self._laddr(v.name)
                b = rpc24(va, "block", height=hh + 1) if va else None
                if b is not None:
                    got = base64.b64decode(
                        info["response"]["last_block_app_hash"])
                    self.app_pairs.append(
                        (hh, got.hex().upper()
                         == b["block"]["header"]["app_hash"]))
                    break

    def run_until(self, pid: int):
        """Watch until process `pid` (the runner) has ended."""
        while True:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                        return
            except OSError:
                return
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - the next tick reads again
                pass
            time.sleep(0.2)


def e2e_watch(out_dir: str, runner_pid: int) -> None:
    """`python3 chip_smoke.py --e2e-watch DIR PID`: Watch24 over the e2e
    run in DIR until the runner PID ends; its readings to
    DIR/e2e_watch.json."""
    w = Watch24(load_manifest(MANIFEST24), os.path.join(out_dir, "e2e"))
    w.run_until(runner_pid)
    with open(os.path.join(out_dir, "e2e_watch.json"), "w") as f:
        json.dump({"rows": w.rows, "app_pairs": w.app_pairs,
                   "devices": {n: sorted(map(str, d))
                               for n, d in w.devices.items()}}, f)


if len(sys.argv) == 3 and sys.argv[1] == "--network-child":
    network_child(sys.argv[2])
    sys.exit(0)
if len(sys.argv) == 4 and sys.argv[1] == "--e2e-watch":
    e2e_watch(sys.argv[2], int(sys.argv[3]))
    sys.exit(0)
if len(sys.argv) == 5 and sys.argv[1] == "--gmesh-child":
    gmesh_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    sys.exit(0)


# -- signature generator ----------------------------------------------------

def _encode_many(pts):
    """Extended points -> 32-byte encodings with one batch inversion."""
    zs = [p[2] for p in pts]
    pref = [1] * (len(zs) + 1)
    for i, z in enumerate(zs):
        pref[i + 1] = pref[i] * z % P
    inv = pow(pref[-1], P - 2, P)
    out = [None] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        zi = inv * pref[i] % P
        inv = inv * zs[i] % P
        x, y = pts[i][0] * zi % P, pts[i][1] * zi % P
        out[i] = (y | ((x & 1) << 255)).to_bytes(32, "little")
    return out


def _multiples(s0: int, n: int):
    """[(s0 + i) mod L for i < n] and their points, each by one addition."""
    p = _edref._mul(s0, _edref.BASE)
    pts = [p]
    for _ in range(n - 1):
        p = _edref._add(p, _edref.BASE)
        pts.append(p)
    return [(s0 + i) % L for i in range(n)], _encode_many(pts)


def gen_keys(n: int, rng: random.Random):
    return _multiples(rng.randrange(1, L), n)


def sign_batch(a_list, pubs, msgs, rng: random.Random):
    """sig_j = R_j || (r_j + k_j a_j mod L), k_j = H(R_j || A_j || M_j)."""
    n = len(pubs)
    r_list, r_enc = _multiples(rng.randrange(1, L), n)
    prefix = np.frombuffer(b"".join(r + p for r, p in zip(r_enc, pubs)),
                           dtype=np.uint8).reshape(n, 64)
    k = native.challenge_scalars(np.ascontiguousarray(prefix), msgs)
    check(k is not None, "native staging library unavailable")
    sigs = []
    for j in range(n):
        kj = int.from_bytes(k[j].tobytes(), "little")
        s = (r_list[j] + kj * a_list[j]) % L
        sigs.append(r_enc[j] + s.to_bytes(32, "little"))
    return sigs


def corrupt(sig: bytes, rng: random.Random) -> bytes:
    b = bytearray(sig)
    b[rng.randrange(32)] ^= 1 << rng.randrange(8)  # a bit of R
    return bytes(b)


def r_edge_vectors(p0: bytes, m0: bytes, s0: bytes, y_ns: int):
    """The R edge vectors of the projective R check and their verdicts: a
    non-square R; R = (0, 1) with the sign bit (P = O); the order-2 R =
    (0, -1) without and with the sign bit (A = (0, -1), s = 0, k odd, so
    P = A); R with y = p and with y = 0 (A = the order-4 point y = 0,
    s = 0, k = 3 mod 4, so P = A); R with y = 2^255 - 1, both signs."""
    enc = lambda v: v.to_bytes(32, "little")  # noqa: E731
    z32, a2, a4 = bytes(32), enc(P - 1), enc(0)

    def msg_where(r, a, cond):
        i = 0
        while not cond(int.from_bytes(hashlib.sha512(
                r + a + b"r-edge %d" % i).digest(), "little") % L):
            i += 1
        return b"r-edge %d" % i
    rows = [(p0, m0, enc(y_ns) + s0[32:], False),
            (enc(1), m0, enc(1 | 1 << 255) + z32, False)]
    for r, want in ((a2, True), (enc(P - 1 | 1 << 255), False)):
        rows.append((a2, msg_where(r, a2, lambda k: k % 2 == 1), r + z32,
                     want))
    for r, want in ((enc(P), False), (a4, True)):
        rows.append((a4, msg_where(r, a4, lambda k: k % 4 == 3), r + z32,
                     want))
    for r in (enc((1 << 255) - 1), enc((1 << 256) - 1)):
        rows.append((p0, m0, r + s0[32:], False))
    return [r[:3] for r in rows], [r[3] for r in rows]


def time_events(fn, iters: int) -> float:
    """Mean ms of fn() over iters launches, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# -- phase 1: build ---------------------------------------------------------

t = time.perf_counter()
errs = []


def _build(fn, what):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - reported below, then fail
        errs.append(f"{what}: {e}")


threads = [threading.Thread(target=_build, args=(fn, what)) for fn, what in (
    (lambda: native.get_lib() or errs.append("host staging C did not build"),
     "cc"),
    (ck.kernels, "nvcc ed25519_verify.cu"), (cm.kernels, "nvcc msm.cu"),
    (cs1.kernels, "nvcc secp256k1_verify.cu"),
    (cs2.kernels, "nvcc sr25519_verify.cu"), (cc.kernels, "nvcc comb.cu"))]
for th in threads:
    th.start()
for th in threads:
    th.join()
check(not errs, "; ".join(errs))
ptxas = [ln.strip() for info in (ck.build_info, cm.build_info,
                                 cs1.build_info, cs2.build_info,
                                 cc.build_info)
         for ln in info.get("ptxas", "").splitlines()
         if any(w in ln for w in ("registers", "spill", "Compiling entry",
                                  "Function properties"))]
log(phase=1, build_s=round(time.perf_counter() - t, 3),
    nvcc_s={"ed25519_verify": round(ck.build_info["seconds"], 3),
            "msm": round(cm.build_info["seconds"], 3),
            "secp256k1_verify": round(cs1.build_info["seconds"], 3),
            "sr25519_verify": round(cs2.build_info["seconds"], 3),
            "comb": round(cc.build_info["seconds"], 3)},
    ptxas=ptxas)
# registers, spills and stack of each verify kernel, and blocks per SM
occ = ck.occupancy()
verify_build = {}
for _name, _row in parse_ptxas(ck.build_info.get("ptxas", "")).items():
    if _name.startswith("k_verify"):
        blocks, threads = occ[_name[2:]]
        verify_build[_name] = dict(_row, blocks_per_sm=blocks,
                                   threads_per_block=threads)
        log(phase=1, kernel=_name, **verify_build[_name])
check(len(verify_build) == 3, f"ptxas report: {sorted(verify_build)}")
occ = cm.occupancy()
msm_build = {}
for _name, _row in parse_ptxas(cm.build_info.get("ptxas", "")).items():
    if _name[2:] in occ:
        blocks, threads = occ[_name[2:]]
        msm_build[_name] = dict(_row, blocks_per_sm=blocks,
                                threads_per_block=threads)
        log(phase=1, kernel=_name, **msm_build[_name])
check(len(msm_build) == 3, f"ptxas report: {sorted(msm_build)}")
# S1 and S2: registers, spills, stack and blocks per SM
lane_build = {}
for mod in (cs1, cs2):
    occ = mod.occupancy()
    for _name, _row in parse_ptxas(mod.build_info.get("ptxas", "")).items():
        if _name[2:] in occ:
            blocks, threads = occ[_name[2:]]
            lane_build[_name] = dict(_row, blocks_per_sm=blocks,
                                     threads_per_block=threads)
            log(phase=1, kernel=_name, **lane_build[_name])
check(len(lane_build) == 2, f"ptxas report: {sorted(lane_build)}")
# C1 and C2 (csrc/comb.cu): registers, spills, stack and blocks per SM
occ = cc.occupancy()
comb_build_rep = {}
for _name, _row in parse_ptxas(cc.build_info.get("ptxas", "")).items():
    if _name[2:] in occ:
        blocks, threads = occ[_name[2:]]
        comb_build_rep[_name] = dict(_row, blocks_per_sm=blocks,
                                     threads_per_block=threads)
        log(phase=1, kernel=_name, **comb_build_rep[_name])
check(len(comb_build_rep) == 2, f"ptxas report: {sorted(comb_build_rep)}")
# S1's design (csrc/secp256k1_verify.cu): 128-thread blocks, 4 an SM, 16
# warps; checked at the end, after the report is written, so that this
# script run in an earlier tree's checkout still times that tree's kernels
S1_BUILD = lane_build["k_secp_verify"]
S1_WARPS_PER_SM = (S1_BUILD["blocks_per_sm"]
                   * S1_BUILD["threads_per_block"] // 32)
log(phase=1, kernel="k_secp_verify", warps_per_sm=S1_WARPS_PER_SM)
# S2's design (csrc/sr25519_verify.cu): the same shape, 128-thread
# blocks, 4 an SM (16 warps) within 128 registers; checked at the end
S2_BUILD = lane_build["k_sr25519_verify"]
S2_WARPS_PER_SM = (S2_BUILD["blocks_per_sm"]
                   * S2_BUILD["threads_per_block"] // 32)
log(phase=1, kernel="k_sr25519_verify", warps_per_sm=S2_WARPS_PER_SM)

# -- phase 2: field ---------------------------------------------------------

rng = random.Random(SEED)
edge = [0, 1, P - 1, P, P + 1, P + 18, (1 << 255) - 1, 2, 19, P - 19]
vals_a = edge + [rng.randrange(1 << 255) for _ in range(4096)]
vals_b = [rng.randrange(1 << 255) for _ in vals_a[:-len(edge)]] + edge
to_u8 = lambda xs: torch.from_numpy(np.frombuffer(  # noqa: E731
    b"".join(x.to_bytes(32, "little") for x in xs),
    dtype=np.uint8).reshape(-1, 32).copy()).to(DEV)
fa, fb = to_u8(vals_a), to_u8(vals_b)
got = ck.fe_selftest(fa, fb)
want = ck.fe_selftest_plain(fa, fb)
torch.cuda.synchronize()
fe_mism = int((got != want).any(-1).sum())
# and against Python integers on the edge values
for i, a in enumerate(vals_a[:len(edge)]):
    b = vals_b[i] & ((1 << 255) - 1)
    a &= (1 << 255) - 1
    exp = [a % P, a * b % P, a * a % P, pow(a, P - 2, P)]
    for op in range(4):
        g = int.from_bytes(got[op, i].cpu().numpy().tobytes(), "little")
        check(g == exp[op], f"fe_selftest op {op} on {hex(vals_a[i])}")
log(phase=2, elements=len(vals_a), ops=4, mismatches=fe_mism)
check(fe_mism == 0, "CUDA field differs from the plain field")

# -- phase 3: K1, K2, K3 on vectors ---------------------------------------------

rng = random.Random(SEED + 3)
vec_p, vec_m, vec_s = [], [], []
a_list, pubs = gen_keys(24, rng)
msgs = [bytes(rng.randrange(256) for _ in range(40)) for _ in range(24)]
sigs = sign_batch(a_list, pubs, msgs, rng)
for i in range(24):
    p, m, s = pubs[i], msgs[i], sigs[i]
    vec_p.append(p), vec_m.append(m), vec_s.append(s)           # valid
    which = i % 3
    if which == 0:
        s = corrupt(s, rng) if i % 2 else s[:32] + bytes(
            [s[32] ^ 1]) + s[33:]
    elif which == 1:
        m = m[:-1] + bytes([m[-1] ^ 1])
    else:
        b = bytearray(p)
        b[rng.randrange(32)] ^= 1 << rng.randrange(8)
        p = bytes(b)
    vec_p.append(p), vec_m.append(m), vec_s.append(s)           # flipped
p0, m0, s0 = pubs[0], msgs[0], sigs[0]
ident = (1).to_bytes(32, "little")
y_ns = 2
while _edref._recover_x(y_ns, 0) is not None:
    y_ns += 1
s_int = int.from_bytes(s0[32:], "little")
edges = [
    (p0, m0, s0[:32] + (s_int + L).to_bytes(32, "little")),     # s + L
    (y_ns.to_bytes(32, "little"), m0, s0),                       # non-square
    (ident, m0, s0),                                             # identity
    ((P - 1).to_bytes(32, "little"), m0, s0),                    # order 2
    (bytes(32), m0, s0),                                         # order 4
    ((1 | (1 << 255)).to_bytes(32, "little"), m0, s0),          # x=0, sign
    ((P + 1).to_bytes(32, "little"), m0, ident + bytes(32)),     # y >= p
    (ident, m0, ident + bytes(32)),                              # [0]B = R
    (ident, m0, (P + 1).to_bytes(32, "little") + bytes(32)),     # R >= p
]
r_edges, r_edges_want = r_edge_vectors(p0, m0, s0, y_ns)
edges += r_edges
for p, m, s in edges:
    vec_p.append(p), vec_m.append(m), vec_s.append(s)
n_vec = len(vec_p)
oracle_vec = np.array([_edref.verify(p, m, s)
                       for p, m, s in zip(vec_p, vec_m, vec_s)])
check(list(oracle_vec[n_vec - len(r_edges):]) == r_edges_want,
      "R edge vectors: the oracle disagrees with their construction")
# 4,096 seeded triples, 1% corrupted
a_list, pubs = gen_keys(4096, rng)
msgs = [rng.randbytes(64) for _ in range(4096)]
sigs = sign_batch(a_list, pubs, msgs, rng)
bad = set(rng.sample(range(4096), 41))
sigs = [corrupt(s, rng) if i in bad else s for i, s in enumerate(sigs)]
all_p, all_m, all_s = vec_p + pubs, vec_m + msgs, vec_s + sigs
packed, host_ok = E.prepare_batch_packed(all_p, all_s, all_m)
buf = torch.from_numpy(packed.view(np.uint8)).to(DEV)
k1_raw = ck.verify_packed(buf).cpu().numpy()
plain_raw = ck.verify_packed_plain(buf).cpu().numpy()
k1_cmp_lanes = len(k1_raw)
k1_mism = int((k1_raw != plain_raw).sum())
final = E.verify_batch(all_p, all_m, all_s, device=DEV)
sample = rng.sample(range(n_vec, len(all_p)), 256)
oracle_sample = np.array([_edref.verify(all_p[i], all_m[i], all_s[i])
                          for i in sample])
expect = np.ones(len(all_p), dtype=bool)
expect[:n_vec] = oracle_vec
expect[[n_vec + i for i in bad]] = False
log(phase=3, vectors=n_vec, seeded=4096, kernel_vs_plain_mismatches=k1_mism,
    oracle_vectors_valid=int(oracle_vec.sum()))
check(k1_mism == 0, "K1 differs from its plain version")
check(np.array_equal(final[:n_vec], oracle_vec), "K1 bitmap != oracle")
check(np.array_equal(final[sample], oracle_sample), "sample != oracle")
check(np.array_equal(final, expect), "seeded bitmap != expected")
check(np.array_equal(plain_raw[:len(all_p)] & host_ok, expect),
      "plain bitmap != expected")
# the same lanes through K2 (split rows) and K3 (raw digests)
pub3, rsk3, ok3 = E.prepare_batch_split(all_p, all_s, all_m)
pub3 = torch.from_numpy(pub3).to(DEV)
rsk3 = torch.from_numpy(rsk3.view(np.uint8)).to(DEV)
k2_raw3 = ck.verify_packed_split(pub3, rsk3).cpu().numpy()
k2_plain3 = ck.verify_packed_split_plain(pub3, rsk3).cpu().numpy()
staged3, ok3s = E.prepare_batch_compact(all_p, all_s, all_m)
staged3 = [torch.from_numpy(staged3[k].view(np.uint8)).to(DEV)
           for k in ("pub", "r", "s", "digest")]
k3_raw3 = ck.verify_staged(*staged3).cpu().numpy()
k3_plain3 = ck.verify_staged_plain(*staged3).cpu().numpy()
k2_mism3 = int((k2_raw3 != k2_plain3).sum())
k3_mism3 = int((k3_raw3 != k3_plain3).sum())
log(phase=3, k2_vs_plain_mismatches=k2_mism3,
    k3_vs_plain_mismatches=k3_mism3)
check(k2_mism3 == 0, "K2 differs from its plain version")
check(k3_mism3 == 0, "K3 differs from its plain version")
check(np.array_equal(k2_raw3 & ok3, expect), "K2 bitmap != expected")
check(np.array_equal(k3_raw3 & ok3s, expect), "K3 bitmap != expected")


# -- phases 4/5: validator sets and commits ---------------------------------

CHAIN = "chip-smoke"


def make_commit(n: int, rng: random.Random, height: int = 9):
    """A fully signed n-validator commit + its ValidatorSet, shaped as
    scripts/bench_report.py _make_commit (power 10, for-block votes)."""
    a_list, pubs = gen_keys(n, rng)
    vset = ValidatorSet([Validator.new(edkeys.PubKey(p), 10) for p in pubs])
    a_of = {p: a for p, a in zip(pubs, a_list)}
    bid = BlockID(b"\x27" * 32, PartSetHeader(1, b"\x28" * 32))
    sigs = [CommitSig(block_id_flag=BlockIDFlag.COMMIT,
                      validator_address=v.address,
                      timestamp=Timestamp(1700000600,
                                          (i * 9973) % 1_000_000_000))
            for i, v in enumerate(vset.validators)]
    commit = Commit(height=height, round=0, block_id=bid, signatures=sigs)
    msgs = commit_sign_bytes_batch(CHAIN, commit, list(range(n)))
    vp = [v.pub_key.bytes() for v in vset.validators]
    signed = sign_batch([a_of[p] for p in vp], vp, msgs, rng)
    for cs, s in zip(sigs, signed):
        cs.signature = s
    return vset, commit, bid, msgs


def commit_error_index(vset, bid, commit, height=9):
    try:
        vset.verify_commit(CHAIN, bid, height, commit, device=DEV)
    except CommitVerifyError as e:
        return str(e)
    return None


KERNEL_MOD = {"verify_packed": ck, "verify_packed_split": ck,
              "verify_staged": ck, "decompress_niels": cm,
              "bucket_scan": cm, "aggregate": cm, "comb_build": cc,
              "comb_verify": cc}
launches_main = {name: 0 for name in KERNEL_MOD}
PLAIN = {"verify_packed": ck.verify_packed_plain,
         "verify_packed_split": ck.verify_packed_split_plain,
         "verify_staged": ck.verify_staged_plain}
REAL = {name: getattr(mod, name) for name, mod in KERNEL_MOD.items()}
captured = {name: [] for name in KERNEL_MOD}  # (label, inputs, output)
capture_next = {name: None for name in KERNEL_MOD}


def _recording(name):
    """The wrapper, plus a copy of the inputs and output of the first call
    after capture_next[name] is set (the main path reuses its device
    buffers, so tensor inputs are cloned on the same stream)."""
    def wrapper(*args):
        out = REAL[name](*args)
        label = capture_next[name]
        if label is not None:
            capture_next[name] = None
            captured[name].append((label, [
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args], out))
        return out
    return wrapper


for _name, _mod in KERNEL_MOD.items():
    setattr(_mod, _name, _recording(_name))


def counter_total(counter) -> float:
    """The sum of a counter over all its label sets."""
    return sum(float(line.rsplit(" ", 1)[1]) for line in counter.render())


def runtime_clean(what: str, site=None, launched0=0.0) -> None:
    """The degradation runtime served `what` from the card: its device
    launches at `site` rose, no device launch failed and no batch fell
    back to the host anywhere so far, and the breaker is closed."""
    rt = degrade.runtime()
    if site is not None:
        check(rt.metrics.device_launches.value(site=site) > launched0,
              f"{what}: crypto_device_launch_total{{site={site}}} did not "
              f"rise")
    fails = counter_total(rt.metrics.device_failures)
    falls = counter_total(rt.metrics.host_fallbacks)
    check(fails == 0 and falls == 0,
          f"{what}: device failures {fails}, host fallbacks {falls}:\n"
          + "\n".join(rt.metrics.device_failures.render()
                      + rt.metrics.host_fallbacks.render()))
    check(rt.breaker.state == degrade.CLOSED,
          f"{what}: breaker {rt.breaker.state}")


def main_path(fn, capture=(), site=None):
    """Run fn with every launch counter zeroed just before and read just
    after; the counts are added to the main-path totals.  capture: one
    (kernel, label) pair or a list of them; each kernel's first launch of
    the run is kept.  site: the degradation runtime's lane site the run
    goes through; the runtime must have served it from the card
    (runtime_clean)."""
    if capture and isinstance(capture[0], str):
        capture = [capture]
    for name, label in capture:
        capture_next[name] = label
    launched0 = (degrade.runtime().metrics.device_launches.value(site=site)
                 if site is not None else 0.0)
    ck.reset_launches()
    cm.reset_launches()
    cc.reset_launches()
    out = fn()
    got = {**ck.launches, **cm.launches, **cc.launches}
    for k in launches_main:
        launches_main[k] += got[k]
    for name, label in capture:
        check(capture_next[name] is None,
              f"{name} ({label}): the kernel was not launched")
    if site is not None:
        runtime_clean(f"main path at {site}", site, launched0)
    return out, got


def staging_clear(phase) -> None:
    """The device observatory's staging pool is back to 0 bytes: every
    launch of the phase released its chunk feed's buffers."""
    level = devobs.ledger_report().get("staging", {}).get("bytes", 0)
    check(level == 0, f"phase {phase}: staging pool holds {level} bytes")


def plain_on_captured(name: str, expect: np.ndarray):
    """Hold the kernel output of the last capture of `name` against the
    plain version on the same inputs, and the plain verdict against the
    expected bitmap of the batch's real lanes (padding lanes must fail).
    Returns (label, lanes, mismatches, max_abs_err)."""
    label, args, out = captured[name][-1]
    plain = PLAIN[name](*args)
    got, want = out.cpu().numpy(), plain.cpu().numpy()
    check(np.array_equal(want[:len(expect)], expect),
          f"{label}: plain verdict != expected bitmap")
    check(not want[len(expect):].any(), f"{label}: a padding lane passed")
    err = np.abs(got.astype(int) - want.astype(int))
    return label, len(got), int(err.sum()), float(err.max())


# the device observatory from here on: every launch record is counted
# against ops/ed25519's launch sequence in phase 13
check(devobs.is_enabled(), "the device observatory is disabled")
DEVOBS_CUR4 = devobs.cursor()
# devobs's own time on the main path: each entry point the ops modules
# call is timed from here on ({name: [calls, seconds]})
OBS_COST: dict = {}
_obs_lock = threading.Lock()


def _timed_obs(name):
    fn = getattr(devobs, name)

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            dt = time.perf_counter() - t
            with _obs_lock:
                c = OBS_COST.setdefault(name, [0, 0.0])
                c[0] += 1
                c[1] += dt
    setattr(devobs, name, timed)


for _name in ("record", "publish_pending", "ledger_set", "ledger_add"):
    _timed_obs(_name)


def obs_cost_since(before: dict, calls: int) -> dict:
    """devobs's calls and microseconds per verify call since `before`."""
    with _obs_lock:
        now = {k: list(v) for k, v in OBS_COST.items()}
    return {k: {"calls": (v[0] - before.get(k, [0, 0.0])[0]) / calls,
                "us": 1e6 * (v[1] - before.get(k, [0, 0.0])[1]) / calls}
            for k, v in now.items()}


LAUNCH_SEQ4 = E.last_launch()["seq"]
rng = random.Random(SEED + 4)
vset150, commit150, bid150, _ = make_commit(150, rng)
_, c4a = main_path(lambda: vset150.verify_commit(CHAIN, bid150, 9, commit150,
                                                 device=DEV),
                   site="bulk.ed25519")
rec150 = dict(E.last_launch())
bad_i = 77
orig = commit150.signatures[bad_i].signature
commit150.signatures[bad_i].signature = corrupt(orig, rng)
err, c4b = main_path(lambda: commit_error_index(vset150, bid150, commit150),
                     capture=("verify_packed", "150-validator commit"),
                     site="bulk.ed25519")
commit150.signatures[bad_i].signature = orig
expect4 = np.ones(150, dtype=bool)
expect4[bad_i] = False
cmp4 = plain_on_captured("verify_packed", expect4)
log(phase=4, validators=150, launches=c4a, launches_bad=c4b,
    path=rec150["path"], nb=rec150["nb"], error=err,
    k1_vs_plain=cmp4)
check(rec150["path"] == "cuda" and rec150["nb"] == 256, str(rec150))
check(c4a["verify_packed"] >= 1, "K1 counter did not rise")
check(err is not None and f"(#{bad_i})" in err, f"bad index: {err}")
check(cmp4[1] == 256 and cmp4[2] == 0, f"K1 differs from plain: {cmp4}")
staging_clear(4)

t = time.perf_counter()
rng = random.Random(SEED + 5)
vset100k, commit100k, bid100k, msgs100k = make_commit(100_000, rng)
gen_s = time.perf_counter() - t
smp = rng.sample(range(100_000), 64)
vp100k = [v.pub_key.bytes() for v in vset100k.validators]
sig100k = [cs.signature for cs in commit100k.signatures]
check(all(_edref.verify(vp100k[i], msgs100k[i], sig100k[i]) for i in smp),
      "generator produced an invalid signature")
hits0 = E._pub_cache.hits
_, c5a = main_path(lambda: vset100k.verify_commit(CHAIN, bid100k, 9,
                                                  commit100k, device=DEV),
                   site="bulk.ed25519")
rec5a = dict(E.last_launch())
_, c5b = main_path(lambda: vset100k.verify_commit(CHAIN, bid100k, 9,
                                                  commit100k, device=DEV),
                   site="bulk.ed25519")
rec5b = dict(E.last_launch())
hit = E._pub_cache.hits - hits0
mat = vset100k._pub_matrix()[0]
bad5 = set(rng.sample(range(100_000), 100)) | {5, 4000}
sig_bad = [corrupt(s, rng) if i in bad5 else s for i, s in enumerate(sig100k)]
bits, c5c = main_path(lambda: cbatch.verify_sigs_bulk(mat, msgs100k, sig_bad,
                                                      device=DEV),
                      capture=("verify_packed_split", "100k bulk chunk 0"),
                      site="bulk.ed25519")
expect5 = np.ones(100_000, dtype=bool)
expect5[list(bad5)] = False
cmp5 = plain_on_captured("verify_packed_split", expect5[:E.SPLIT_CHUNK])
pub_rows, rsk, ok_sl = E.prepare_batch_split(
    mat[:4096], sig_bad[:4096], msgs100k.slice(0, 4096))
pr = torch.from_numpy(pub_rows).to(DEV)
rk = torch.from_numpy(rsk.view(np.uint8)).to(DEV)
k2_raw = ck.verify_packed_split(pr, rk).cpu().numpy()
k2_plain = ck.verify_packed_split_plain(pr, rk).cpu().numpy()
k2_mism = int((k2_raw != k2_plain).sum())
log(phase=5, validators=100_000, gen_s=round(gen_s, 3), launches=c5a,
    launches_second=c5b, launches_bulk=c5c, nb=rec5a["nb"],
    path=rec5a["path"], pub_cache_hits=hit, bulk_bad=len(bad5),
    bulk_mismatches=int((bits != expect5).sum()),
    k2_vs_plain_lanes=4096, k2_vs_plain_mismatches=k2_mism,
    k2_vs_plain_main_path=cmp5, record=rec5b)
check(rec5a["path"] == "cuda-split" and rec5a["nb"] == 114_688, str(rec5a))
check(c5a["verify_packed_split"] == 7 and c5b["verify_packed_split"] == 7,
      "expected 7 K2 launches per 100k commit")
check(hit >= 1, "second 100k call missed the pubkey cache")
check(np.array_equal(bits, expect5), "bulk bitmap != expected")
check(k2_mism == 0, "K2 differs from its plain version")
check(np.array_equal(k2_plain & ok_sl, expect5[:4096]), "K2 slice bitmap")
check(cmp5[1] == 16_384 and cmp5[2] == 0, f"K2 differs from plain: {cmp5}")
pub_pool5 = devobs.ledger_report().get("pub_cache", {}).get("bytes")
check(pub_pool5 == E._pub_cache.total_bytes > 0,
      f"devobs pub_cache {pub_pool5} != DeviceLRU "
      f"{E._pub_cache.total_bytes}")
staging_clear(5)

# -- phase 6: pipelined K1 through BatchVerifier -------------------------------

rng = random.Random(SEED + 6)
a_list, pubs = gen_keys(1024, rng)
msgs = [rng.randbytes(64) for _ in range(1024)]
sigs = sign_batch(a_list, pubs, msgs, rng)
bad6 = set(rng.sample(range(100_000), 97))
bv = cbatch.BatchVerifier(device=DEV)
pk_objs = [edkeys.PubKey(p) for p in pubs]
trip6 = ([], [], [])   # the triples as added, for K3 in phase 11
for i in range(100_000):
    j = i % 1024
    sig = corrupt(sigs[j], rng) if i in bad6 else sigs[j]
    bv.add(pk_objs[j], msgs[j], sig)
    for lst, v in zip(trip6, (pubs[j], msgs[j], sig)):
        lst.append(v)
(ok6, bits6), c6 = main_path(bv.verify,
                             capture=("verify_packed", "100k ad-hoc chunk 0"),
                             site="batch.ed25519")
rec6 = dict(E.last_launch())
expect6 = np.ones(100_000, dtype=bool)
expect6[list(bad6)] = False
cmp6 = plain_on_captured("verify_packed", expect6[:E.MAX_CHUNK])
for _name in ("verify_packed", "verify_packed_split"):
    setattr(ck, _name, REAL[_name])   # the timings below call these bare
log(phase=6, triples=100_000, launches=c6, nb=rec6["nb"],
    chunks=rec6.get("chunks"), chunk_overlap=rec6.get("chunk_overlap"),
    mismatches=int((bits6 != expect6).sum()), k1_vs_plain_main_path=cmp6)
check(rec6["path"] == "cuda" and rec6["nb"] == 131_072
      and c6["verify_packed"] == 2, str(rec6))
check(np.array_equal(bits6, expect6), "pipelined bitmap != expected")
check(cmp6[1] == 65_536 and cmp6[2] == 0, f"K1 differs from plain: {cmp6}")
staging_clear(6)

# -- phase 7: times ---------------------------------------------------------

times = {}
rng = random.Random(SEED + 7)
a_list, pubs = gen_keys(1024, rng)
msgs = [rng.randbytes(64) for _ in range(1024)]
sigs = sign_batch(a_list, pubs, msgs, rng)
big = E.prepare_batch_packed(pubs * 64, sigs * 64, msgs * 64)[0]
buf65 = torch.from_numpy(big.view(np.uint8)).to(DEV)
pr16 = torch.from_numpy(np.ascontiguousarray(big[0:32, :16384]).view(
    np.uint8)).to(DEV)
rk16 = torch.from_numpy(np.ascontiguousarray(big[32:128, :16384]).view(
    np.uint8)).to(DEV)
for lanes in (256, 4096, 65536):
    b = buf65[:, :lanes].contiguous()
    times[f"k1_{lanes}_ms"] = time_events(lambda: ck.verify_packed(b), 5)
times["k2_16384_ms"] = time_events(
    lambda: ck.verify_packed_split(pr16, rk16), 5)
b4 = buf65[:, :4096].contiguous()
times["plain_k1_4096_ms"] = time_events(lambda: ck.verify_packed_plain(b4), 1)
times["plain_k2_16384_ms"] = time_events(
    lambda: ck.verify_packed_split_plain(pr16, rk16), 1)
times["plain_k1_65536_ms"] = time_events(
    lambda: ck.verify_packed_plain(buf65), 1)
check(bool(ck.verify_packed(buf65).all()), "timing batch must verify")


def wall(fn, reps):
    fn()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t)
    return out


cm.reset_launches()
w150 = wall(lambda: vset150.verify_commit(CHAIN, bid150, 9, commit150,
                                          device=DEV), 10)
w100k = wall(lambda: vset100k.verify_commit(CHAIN, bid100k, 9, commit100k,
                                            device=DEV), 3)
rec7 = dict(E.last_launch())
runtime_clean("phase-7 walls")
rlc_off = {k: launches_main[k] + cm.launches[k] for k in cm.launches}
check(not any(rlc_off.values()),
      f"K4/K5/A1 launched while RLC is off: {rlc_off}")
times["verify_commit_150_wall_s"] = sorted(w150)[len(w150) // 2]
times["verify_commit_100k_wall_s"] = sorted(w100k)[len(w100k) // 2]
# the times of the one-lane kernel this design replaced, as PERF.md
# records them for this card (K1 at 4,096 lanes was not recorded)
ONE_LANE_MS = {"k1_256_ms": 4.033, "k1_4096_ms": None,
               "k1_65536_ms": 12.441, "k2_16384_ms": 4.407}
for name in ONE_LANE_MS:
    log(phase=7, card=CARD, kernel_time=name, ms=times[name],
        one_lane_ms=ONE_LANE_MS[name])
for name, value in times.items():
    log(phase=7, card=CARD, metric=name, value=value)
log(phase=7, card=CARD, verify_commit_150_walls_s=w150,
    verify_commit_100k_walls_s=w100k, rlc_off_msm_launches=rlc_off,
    verify_commit_100k_phases={k: rec7.get(k) for k in (
        "stage_s", "h2d_s", "compute_s", "device_s", "drain_s", "chunks",
        "chunk_overlap")})
staging_clear(7)

# -- phase 8: RLC on the 100,000-validator commit -----------------------------

RLC_CAP = [("decompress_niels", "100k RLC"), ("bucket_scan", "100k RLC"),
           ("aggregate", "100k RLC")]
msm.set_enabled(True)
_, c8a = main_path(lambda: vset100k.verify_commit(CHAIN, bid100k, 9,
                                                  commit100k, device=DEV),
                   capture=RLC_CAP, site="bulk.ed25519")
route8a, rec8a = dict(msm.last_route()), dict(E.last_launch())
check((route8a["path"], route8a["outcome"], route8a["nb"], route8a["c"])
      == ("rlc-single", "vouched", 131_072, 8), str(route8a))
check(rec8a["path"] == "rlc-single", str(rec8a))
check((c8a["decompress_niels"], c8a["bucket_scan"], c8a["aggregate"],
       c8a["verify_packed_split"]) == (1, 1, 1, 0), str(c8a))
# one bad signature: s + 1 keeps s < L and R canonical, so the batch is
# eligible and the combination rejects it; the ladder names the index
bad8 = 4321
orig8 = commit100k.signatures[bad8].signature
s8 = (int.from_bytes(orig8[32:], "little") + 1) % L
commit100k.signatures[bad8].signature = orig8[:32] + s8.to_bytes(32, "little")
err8b, c8b = main_path(lambda: commit_error_index(vset100k, bid100k,
                                                  commit100k),
                       capture=("decompress_niels",
                                "100k RLC, one bad signature"),
                       site="bulk.ed25519")
route8b = dict(msm.last_route())
check(route8b["outcome"] == "rejected", str(route8b))
check(c8b["verify_packed_split"] == 7 and c8b["decompress_niels"] == 1,
      str(c8b))
check(err8b is not None and f"(#{bad8})" in err8b, f"bad index: {err8b}")
# a non-canonical R (y = p): ineligible on the host, no K4 launch
commit100k.signatures[bad8].signature = P.to_bytes(32, "little") + orig8[32:]
err8c, c8c = main_path(lambda: commit_error_index(vset100k, bid100k,
                                                  commit100k),
                       site="bulk.ed25519")
route8c = dict(msm.last_route())
commit100k.signatures[bad8].signature = orig8
check(route8c["path"] == "rlc-ineligible", str(route8c))
check(c8c["decompress_niels"] == 0 and c8c["verify_packed_split"] == 7,
      str(c8c))
check(err8c is not None and f"(#{bad8})" in err8c, f"bad index: {err8c}")
with _obs_lock:
    obs8 = {k: list(v) for k, v in OBS_COST.items()}
w8 = wall(lambda: vset100k.verify_commit(CHAIN, bid100k, 9, commit100k,
                                         device=DEV), 3)
obs8 = obs_cost_since(obs8, 4)      # wall() warms up with one more call
rec8 = dict(E.last_launch())
runtime_clean("phase-8 walls")
check(rec8["path"] == "rlc-single" and rec8["outcome"] == "vouched",
      str(rec8))
times["rlc_verify_commit_100k_wall_s"] = sorted(w8)[1]
log(phase=8, card=CARD, launches=c8a, route=route8a,
    launches_bad=c8b, route_bad=route8b, error_bad=err8b,
    launches_ineligible=c8c, route_ineligible=route8c,
    rlc_verify_commit_100k_walls_s=w8, devobs_per_call=obs8, record=rec8)
staging_clear(8)

# -- phase 9: RLC through BatchVerifier --------------------------------------

rng = random.Random(SEED + 9)
a_list, pubs9 = gen_keys(16384, rng)
msgs9 = [rng.randbytes(64) for _ in range(16384)]
sigs9 = sign_batch(a_list, pubs9, msgs9, rng)
pk9 = [edkeys.PubKey(p) for p in pubs9]
bv9 = {}
for n9 in (16384, 4096):
    bv9[n9] = cbatch.BatchVerifier(device=DEV)
    for i in range(n9):
        bv9[n9].add(pk9[i], msgs9[i], sigs9[i])
    cap = [(k, f"{n9} ad-hoc RLC") for k, _ in RLC_CAP] if n9 == 4096 \
        else ("decompress_niels", f"{n9} ad-hoc RLC")
    (ok9, bits9), c9 = main_path(bv9[n9].verify, capture=cap,
                                 site="batch.ed25519")
    route9 = dict(msm.last_route())
    log(phase=9, triples=n9, launches=c9, route=route9)
    check(ok9 and bits9.all(), f"{n9}: batch not all valid")
    check((route9["path"], route9["outcome"], route9["nb"], route9["c"])
          == ("rlc-single", "vouched", n9, 8 if n9 >= 8192 else 4),
          str(route9))
    check((c9["decompress_niels"], c9["bucket_scan"], c9["aggregate"],
           c9["verify_packed"]) == (1, 1, 1, 0), str(c9))
w9 = wall(bv9[16384].verify, 5)
rec9 = dict(E.last_launch())
runtime_clean("phase-9 walls")
times["rlc_batch_16384_wall_s"] = sorted(w9)[2]
log(phase=9, card=CARD, rlc_batch_16384_walls_s=w9, record=rec9)
msm.set_enabled(None)
staging_clear(9)

# -- phase 10: K4, K5 and A1 against their plain versions ---------------------


def byte_cmp(got: torch.Tensor, want: torch.Tensor):
    """(coords, N, 32) canonical bytes -> (elements compared, mismatching
    elements, max |byte difference|)."""
    check(got.shape == want.shape, f"{tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return (int(got.shape[0] * got.shape[1]), int(diff.any(-1).sum()),
            float(diff.max()))


def timed(fn):
    """(result, ms) of one call, CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def point_cmp(got: torch.Tensor, want: torch.Tensor):
    """(4, N, 32) canonical bytes of extended points -> (points compared,
    positions that are not the same point or not a valid point, max_abs_err:
    1.0 where any position mismatches, else 0.0)."""
    bad = cm.points_mismatch(got, want)
    return int(got.shape[1]), bad, float(bad > 0)


def k5_launch(table, rows, seg, S: int):
    """A function that launches K5 with S segments a lane through its C
    entry (no wrapper checks, no launch count), and the tensor it writes."""
    T9, K9 = rows.shape
    lib, out9 = cm.kernels(), torch.empty((K9, 4, 10), dtype=torch.int32,
                                          device=DEV)
    args9 = (table.data_ptr(), rows.data_ptr(), seg.data_ptr(),
             out9.data_ptr(), T9, K9, S, DEV.index,
             torch.cuda.current_stream(DEV).cuda_stream)

    def launch():
        check(lib.tm_bucket_scan(*args9) == 0, f"K5 at S = {S}: launch")
    return launch, out9


# the times of the kernels that these designs replaced, as PERF.md records
# them for this card: the one-thread-a-chain K5 and A1, K4 on the shared
# field ops with their serial carry
EARLIER_MS = {"k5_1304x8192_ms": 6.652, "k5_712x1024_ms": 3.580,
              "a1_32x8_ms": 7.206, "a1_64x4_ms": 0.445,
              "k4_262144_ms": 1.650}
msm_cmp = {"decompress_niels": [], "bucket_scan": [], "aggregate": []}


def k4_cmp(label, b_rows, rows10, ok10):
    """K4's rows (as canonical bytes) and ok flags against the plain
    version on the same input; appended to msm_cmp.  -> plain ok flags."""
    n22, ok22 = cm.decompress_niels_plain(b_rows)
    cmp = byte_cmp(cm.to_bytes10(rows10), cm.to_bytes22(n22))
    msm_cmp["decompress_niels"].append(
        (label, cmp[0], cmp[1] + int((ok10 != ok22).sum()), cmp[2]))
    return ok22


# K4 on each of its main-path launches (all of their points are valid)
k4_inputs = {}
for label, (b_rows,), (n10, ok10) in captured["decompress_niels"]:
    k4_cmp(label, b_rows, n10, ok10)
    check(bool(ok10.all()), f"K4 ({label}): a valid point rejected")
    k4_inputs.setdefault(b_rows.shape[1], b_rows)
check([c[1] // 3 for c in msm_cmp["decompress_niels"]]
      == [262_144, 262_144, 32_768, 8_192],
      f"K4 launches: {msm_cmp['decompress_niels']}")
# and on adversarial encodings: y = 0, 1, 2, p - 1, p, p + 1, p + 18,
# 2^255 - 1 and a non-square, each with both sign bits; the R and A of
# the phase-3 R edge vectors and the phase-3 keys (flipped ones among
# them); seeded random bytes.  Once at a size that ends inside a block,
# once padded to whole blocks, and tiled to 100,003 points.
rng = random.Random(SEED + 10)
adv = [(y | sgn << 255).to_bytes(32, "little")
       for y in (0, 1, 2, P - 1, P, P + 1, P + 18, (1 << 255) - 1, y_ns)
       for sgn in (0, 1)]
adv += [s[:32] for _, _, s in r_edges] + [p for p, _, _ in r_edges]
adv += vec_p[:48] + [rng.randbytes(32) for _ in range(27)]
oracle_adv = np.array([_edref._decode(e) is not None for e in adv])
adv_u8 = np.frombuffer(b"".join(adv), np.uint8).reshape(-1, 32)
block = cm.occupancy()["decompress_niels"][1]
pad = -len(adv) % block
for label, rows in (
        (f"adversarial, {len(adv)}", adv_u8),
        (f"adversarial + {pad} random, {len(adv) + pad}",
         np.concatenate([adv_u8, np.frombuffer(rng.randbytes(32 * pad),
                                               np.uint8).reshape(-1, 32)])),
        ("adversarial tiled, 100,003", np.resize(adv_u8, (100_003, 32)))):
    b_adv = torch.from_numpy(np.ascontiguousarray(rows.T)).to(DEV)
    n10, ok10 = REAL["decompress_niels"](b_adv)
    ok22 = k4_cmp(label, b_adv, n10, ok10).cpu().numpy()
    check(np.array_equal(ok22[:len(adv)], oracle_adv),
          f"K4 plain ({label}) != the oracle's decode")
_, times["plain_k4_262144_ms"] = timed(   # warmed by k4_cmp
    lambda: cm.decompress_niels_plain(k4_inputs[262_144]))
for m10, b10 in k4_inputs.items():
    times[f"k4_{m10}_ms"] = time_events(
        lambda: REAL["decompress_niels"](b10), 20)
    log(phase=10, card=CARD, kernel_time=f"k4_{m10}_ms",
        ms=times[f"k4_{m10}_ms"], bound_ms=cm.bound_ms_decompress(m10),
        earlier_ms=EARLIER_MS.get(f"k4_{m10}_ms"), points_per_thread=1,
        threads_per_block=block, blocks=-(-m10 // block),
        blocks_per_sm=msm_build["k_decompress_niels"]["blocks_per_sm"])
# the RLC 100k record's k4_s span in its parts: the transpose of the
# staged R and A rows (ops/msm.py:179), K4, assemble_table (:181)
b10 = k4_inputs[262_144]
r10, p10 = (h.t().contiguous() for h in b10.chunk(2, dim=1))
n10 = captured["decompress_niels"][0][2][0]
k4_span = {"transpose_ms": time_events(
               lambda: torch.cat([r10, p10]).t().contiguous(), 20),
           "k4_ms": times["k4_262144_ms"],
           "assemble_table_ms": time_events(
               lambda: msm.assemble_table(n10), 20),
           "record_k4_s": rec8.get("k4_s")}
log(phase=10, card=CARD, rlc_100k_k4_span=k4_span)
scan_shapes, segment_sweep, bounds = [], [], {}
for (label, (table, rows, seg), out), (_, (bk, W, c), ws) in zip(
        captured["bucket_scan"], captured["aggregate"]):
    T9, K9 = rows.shape
    items = int(seg.clamp(max=T9).sum())
    scan_shapes.append((T9, K9, W, c, items, table.shape[0]))
    table22 = cm.limbs22_from_bytes(cm.to_bytes10(table))
    plain, ms = timed(lambda: cm.bucket_scan_plain(table22, rows))
    times[f"plain_k5_{T9}x{K9}_ms"] = ms
    plain_bytes = cm.to_bytes22(plain)
    msm_cmp["bucket_scan"].append(
        (label,) + point_cmp(cm.to_bytes10(out), plain_bytes))
    key = f"k5_{T9}x{K9}_ms"
    times[key] = time_events(lambda: REAL["bucket_scan"](table, rows, seg), 3)
    bounds[key] = cm.bound_ms_bucket_scan(items, table.shape[0], T9, K9)
    # the launch alone (the wrapper's time above includes its row-range
    # check: an aminmax over the (T, K) rows and a host sync), at the
    # wrapper's segment count and at half and twice it
    S0 = cm.scan_segments(K9)
    for S in (S0, S0 // 2, 2 * S0):
        launch, out9 = k5_launch(table, rows, seg, S)
        ms = time_events(launch, 5)
        if S == S0:
            times[f"k5_{T9}x{K9}_launch_only_ms"] = ms
            check(torch.equal(out9, out), "K5 launched alone differs from "
                  "the wrapper's launch")
        else:
            segment_sweep.append(dict(
                shape=key, segments=S, default_segments=S0, ms=ms,
                mismatches=point_cmp(cm.to_bytes10(out9), plain_bytes)[1]))
    bk22 = cm.limbs22_from_bytes(cm.to_bytes10(bk))
    plain, ms = timed(lambda: cm.aggregate_plain(bk22, W, c))
    times[f"plain_a1_{W}x{c}_ms"] = ms
    msm_cmp["aggregate"].append((label,) + point_cmp(ws, plain))
    key = f"a1_{W}x{c}_ms"
    times[key] = time_events(lambda: REAL["aggregate"](bk, W, c), 3)
    bounds[key] = cm.bound_ms_aggregate(W, c)
for key, bound in bounds.items():
    log(phase=10, card=CARD, kernel_time=key, ms=times[key], bound_ms=bound,
        plain_ms=times["plain_" + key], earlier_ms=EARLIER_MS[key],
        launch_only_ms=times.get(key.replace("_ms", "_launch_only_ms")))
log(phase=10, card=CARD, comparisons=msm_cmp, shapes=scan_shapes,
    segment_sweep=segment_sweep,
    times={k: v for k, v in times.items() if k.split("_")[0] in (
        "k4", "k5", "a1", "plain")})
check([sh[:4] for sh in scan_shapes]
      == [(1304, 8192, 32, 8), (712, 1024, 64, 4)], f"shapes {scan_shapes}")
check(all(c[2] == 0 for v in msm_cmp.values() for c in v),
      f"a kernel differs from its plain version: {msm_cmp}")
check(all(r["mismatches"] == 0 for r in segment_sweep),
      f"K5 at another segment count differs: {segment_sweep}")
staging_clear(10)

# -- phase 11: K3 on the phase-6 batch ----------------------------------------

p11, m11, s11 = (lst[:E.MAX_CHUNK] for lst in trip6)
bits11, c11 = main_path(lambda: E.verify_batch_staged(p11, m11, s11,
                                                      device=DEV),
                        capture=("verify_staged", "65,536 ad-hoc"))
rec11 = dict(E.last_launch())
cmp11 = plain_on_captured("verify_staged", expect6[:E.MAX_CHUNK])
_, k3_args, k3_out = captured["verify_staged"][-1]
k1_out = captured["verify_packed"][-1][2]   # phase 6, the same lanes
k3_vs_k1 = int((k3_out != k1_out).sum())
times["k3_65536_ms"] = time_events(lambda: REAL["verify_staged"](*k3_args), 3)
times["plain_k3_65536_ms"] = time_events(
    lambda: ck.verify_staged_plain(*k3_args), 1)
log(phase=11, card=CARD, launches=c11, record=rec11, k3_vs_plain=cmp11,
    k3_vs_k1_mismatches=k3_vs_k1, k3_65536_ms=times["k3_65536_ms"],
    plain_k3_65536_ms=times["plain_k3_65536_ms"])
check(np.array_equal(bits11, expect6[:E.MAX_CHUNK]), "K3 bitmap != expected")
check(c11["verify_staged"] == 1 and rec11["path"] == "cuda-staged", str(c11))
check(cmp11[1] == 65_536 and cmp11[2] == 0, f"K3 differs from plain: {cmp11}")
check(k3_vs_k1 == 0, "K3 differs from K1 on the same lanes")
staging_clear(11)

# -- phase 12: the degradation runtime on the card ----------------------------

LANE_THREAD = "batch-device-lane"


def join_abandoned() -> None:
    """Wait for the launches the runtime abandoned at their deadline: each
    runs on to its end on its quarantined lane thread, launching kernels
    and writing ops/ed25519's launch record there, so a mode's launch
    count is read, and the next mode started, only after them."""
    rt = degrade.runtime()
    live = rt._pool._thread if rt._pool is not None else None
    for th in threading.enumerate():
        if th.name == LANE_THREAD and th is not live:
            th.join(120)
            check(not th.is_alive(), "an abandoned launch did not end")
    torch.cuda.synchronize()


def timed_call(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


runtime12 = {"card": CARD}
rt = degrade.runtime()
timeout0 = rt.cfg.launch_timeout_s

# full width: the phase-5 100,000-validator commit with the bulk lane's
# launch raising: the host re-verifies all 100k signatures and names the
# bad one; no kernel runs.  Then a real K2 run resets the breaker's count.
bad12 = 31_337
orig12 = commit100k.signatures[bad12].signature
commit100k.signatures[bad12].signature = corrupt(orig12, rng)
failpoints.set_mode("bulk.ed25519", "raise")
ck.reset_launches()
err12, degraded_s = timed_call(
    lambda: commit_error_index(vset100k, bid100k, commit100k))
failpoints.clear()
k12 = dict(ck.launches)
consecutive = rt.breaker._consecutive
commit100k.signatures[bad12].signature = orig12
check(err12 is not None and f"(#{bad12})" in err12,
      f"degraded 100k commit: bad index {err12}")
check(k12["verify_packed_split"] == 0 and k12["verify_packed"] == 0,
      f"degraded 100k commit launched kernels: {k12}")
check(rt.metrics.device_failures.value(site="bulk.ed25519",
                                       reason="raise") == 1
      and rt.metrics.host_fallbacks.value(site="bulk.ed25519",
                                          reason="raise") == 1,
      "degraded 100k commit: failure and fallback not counted once")
check(consecutive == 1 and rt.breaker.state == degrade.CLOSED,
      f"breaker after one raise: {rt.breaker.state}, {consecutive}")
ck.reset_launches()
_, real_s = timed_call(lambda: vset100k.verify_commit(
    CHAIN, bid100k, 9, commit100k, device=DEV))
check(ck.launches["verify_packed_split"] == 7
      and rt.breaker._consecutive == 0
      and rt.breaker.state == degrade.CLOSED,
      f"the real K2 run after the raise: {ck.launches}, "
      f"{rt.breaker.state}, {rt.breaker._consecutive}")
runtime12["full_width"] = dict(
    validators=100_000, site="bulk.ed25519", mode="raise", error=err12,
    kernel_launches=k12, degraded_wall_s=degraded_s,
    phase7_100k_wall_s=times["verify_commit_100k_wall_s"],
    real_k2_wall_s=real_s, consecutive_failures_after_raise=consecutive)
log(phase=12, card=CARD, **runtime12["full_width"])

# the chaos matrix on the card: a 4,096-validator commit (cuda-split, K2)
# with one bad signature, and a 4,096-triple BatchVerifier batch with 3
# invalid lanes (cuda, K1)
rng = random.Random(SEED + 12)
vset4k, commit4k, bid4k, _ = make_commit(4096, rng)
bad4k = 1234
commit4k.signatures[bad4k].signature = corrupt(
    commit4k.signatures[bad4k].signature, rng)
a_list, pubs12 = gen_keys(4096, rng)
msgs12 = [rng.randbytes(64) for _ in range(4096)]
sigs12 = sign_batch(a_list, pubs12, msgs12, rng)
bad12b = sorted(rng.sample(range(4096), 3))
sigs12 = [corrupt(s, rng) if i in bad12b else s for i, s in enumerate(sigs12)]
pk12 = [edkeys.PubKey(p) for p in pubs12]
expect12 = np.ones(4096, dtype=bool)
expect12[bad12b] = False


def commit4k_run():
    return commit_error_index(vset4k, bid4k, commit4k)


def batch4k_run():
    bv = cbatch.BatchVerifier(device=DEV)
    for p, m, s in zip(pk12, msgs12, sigs12):
        bv.add(p, m, s)
    return bv.verify()[1]


TARGETS = [
    ("4,096-validator commit", "bulk.ed25519", commit4k_run,
     lambda out: out is not None and f"(#{bad4k})" in out,
     "verify_packed_split", "cuda-split"),
    ("4,096-triple BatchVerifier", "batch.ed25519", batch4k_run,
     lambda out: np.array_equal(out, expect12), "verify_packed", "cuda")]
# (mode, site: None = the lane's own, failure class, kernel launches)
MODES = [("raise", None, "raise", "none"),
         ("latency:2000", None, "timeout", "some"),
         ("corrupt-bitmap", None, "integrity", "some"),
         ("raise", "ops.ed25519.verify_batch", "raise", "none")]
chaos12 = []
for label, lane, run, ok_out, kernel, route in TARGETS:
    ck.reset_launches()
    out = run()                                    # the clean control
    rec12 = dict(E.last_launch())
    check(ok_out(out) and rec12["path"] == route
          and ck.launches[kernel] == 1, f"{label}: control {rec12}")
    for mode, at, reason, want in MODES:
        site = at or lane
        rt = degrade.runtime()
        m = rt.metrics
        fails0 = m.device_failures.value(site=lane, reason=reason)
        falls0 = m.host_fallbacks.value(site=lane, reason=reason)
        fired0 = failpoints.fired(site, mode)
        if reason == "timeout":
            rt.cfg.launch_timeout_s = 0.5
        failpoints.set_mode(site, mode)
        ck.reset_launches()
        out, wall_s = timed_call(run)
        failpoints.clear()
        rt.cfg.launch_timeout_s = timeout0
        launches_at_return = ck.launches[kernel]
        join_abandoned()
        launched = ck.launches[kernel]
        row = dict(target=label, site=site, mode=mode, reason=reason,
                   wall_s=wall_s, kernel=kernel,
                   launches_at_return=launches_at_return,
                   launches=launched, bitmap_ok=bool(ok_out(out)),
                   failures=m.device_failures.value(site=lane,
                                                    reason=reason) - fails0,
                   fallbacks=m.host_fallbacks.value(site=lane,
                                                    reason=reason) - falls0,
                   fired=failpoints.fired(site, mode) - fired0)
        chaos12.append(row)
        log(phase=12, card=CARD, **row)
        check(row["bitmap_ok"], f"{label} under {site}={mode}: bitmap")
        check(row["failures"] == 1 and row["fallbacks"] == 1
              and row["fired"] >= 1,
              f"{label} under {site}={mode}: not counted as {reason}")
        check(launched == 0 if want == "none" else launched >= 1,
              f"{label} under {site}={mode}: {launched} {kernel} launches")
        # the device lane serves again on a fresh worker, and the clean
        # run resets the breaker's consecutive count for the next mode
        ck.reset_launches()
        out = run()
        check(ok_out(out) and ck.launches[kernel] == 1
              and rt.breaker.state == degrade.CLOSED,
              f"{label}: the clean run after {site}={mode}")
runtime12["chaos"] = chaos12

# outside a drill a fault on the card reaches the caller: a kernel wrapper
# that raises and a launch past its deadline, with no failpoint armed,
# raise DeviceLaneError out of both targets; the failure is counted and
# nothing is re-verified on the host


def launch_failed(*args):
    raise RuntimeError("cudaErrorLaunchFailure (raised by chip_smoke.py)")


check(not failpoints.armed(), "a failpoint is still armed")
card_faults = []
for label, lane, run, ok_out, kernel, route in TARGETS:
    for reason in ("raise", "timeout"):
        rt = degrade.runtime()
        m = rt.metrics
        fails0 = m.device_failures.value(site=lane, reason=reason)
        falls0 = counter_total(m.host_fallbacks)
        real_fn = getattr(ck, kernel)   # bare again since phase 7
        if reason == "raise":
            setattr(ck, kernel, launch_failed)
        else:
            rt.cfg.launch_timeout_s = 1e-4
        ck.reset_launches()
        raised = None
        try:
            run()
        except degrade.DeviceLaneError as e:
            raised = str(e)
        finally:
            setattr(ck, kernel, real_fn)
            rt.cfg.launch_timeout_s = timeout0
        join_abandoned()
        row = dict(target=label, site=lane, reason=reason, raised=raised,
                   kernel=kernel, launches=ck.launches[kernel],
                   failures=m.device_failures.value(site=lane,
                                                    reason=reason) - fails0,
                   fallbacks=counter_total(m.host_fallbacks) - falls0)
        card_faults.append(row)
        log(phase=12, card=CARD, **row)
        check(raised is not None and f"({reason})" in raised
              and row["failures"] == 1 and row["fallbacks"] == 0,
              f"{label}: an un-injected {reason} on the card: {row}")
        check(row["launches"] == 0 if reason == "raise"
              else row["launches"] >= 1,
              f"{label}: un-injected {reason}: {row['launches']} launches")
        ck.reset_launches()
        out = run()
        check(ok_out(out) and ck.launches[kernel] == 1
              and rt.breaker.state == degrade.CLOSED,
              f"{label}: the clean run after an un-injected {reason}")
runtime12["card_faults"] = card_faults

# the breaker: an injected clock and failure_threshold=3; three raises
# open it, the next call is refused the device (breaker_open, no launch),
# and once the clock passes the backoff the half-open trial runs a real
# K2 launch and closes it
clk = [0.0]
cfg12 = degrade.DegradeConfig(failure_threshold=3, launch_timeout_s=60.0,
                              backoff_base_s=10.0, backoff_max_s=120.0,
                              backoff_jitter=0.0)
rtb = degrade.configure(cfg12, clock=lambda: clk[0],
                        registry=Registry("breaker"))
trans = []
rtb.breaker.add_listener(lambda o, n, r: trans.append((o, n)))
failpoints.set_mode("bulk.ed25519", "raise")
ck.reset_launches()
for _ in range(3):
    check(TARGETS[0][3](commit4k_run()), "breaker: bad index under raise")
state_after_3 = rtb.breaker.state
launched3 = rtb.metrics.device_launches.value(site="bulk.ed25519")
check(TARGETS[0][3](commit4k_run()), "breaker: bad index while open")
refused = rtb.metrics.host_fallbacks.value(site="bulk.ed25519",
                                           reason="breaker_open")
k_open = ck.launches["verify_packed_split"]
launched4 = rtb.metrics.device_launches.value(site="bulk.ed25519")
failpoints.clear()
clk[0] = 10.1
ck.reset_launches()
check(TARGETS[0][3](commit4k_run()), "breaker: bad index on the trial")
k_trial = ck.launches["verify_packed_split"]
runtime12["breaker"] = dict(
    state_after_3_raises=state_after_3, breaker_open_fallbacks=refused,
    k2_launches_while_open=k_open, device_launches=[launched3, launched4],
    k2_launches_on_trial=k_trial, state_after_trial=rtb.breaker.state,
    transitions=trans)
log(phase=12, card=CARD, **runtime12["breaker"])
check(state_after_3 == degrade.OPEN, f"breaker after 3 raises: "
      f"{state_after_3}")
check(refused == 1 and k_open == 0 and launched4 == launched3 == 3,
      f"breaker open: {runtime12['breaker']}")
check(k_trial == 1 and rtb.breaker.state == degrade.CLOSED
      and trans == [(degrade.CLOSED, degrade.OPEN),
                    (degrade.OPEN, degrade.HALF_OPEN),
                    (degrade.HALF_OPEN, degrade.CLOSED)],
      f"breaker trial: {runtime12['breaker']}")

# the cost of the runtime on the per-block path: the 150-validator
# verify_commit through the runtime with its one host spot check and
# without it (TM_TPU_SPOT_CHECK=0), the bulk call on the same rows through
# the runtime, with and without, beside the same call made directly, the
# direct call handed to a bare lane worker and waited for (the hand-off
# alone: no breaker, counters or spot check), and the spot check alone;
# in turns, round by round
mat150 = vset150._pub_matrix()[0]
msgs150 = commit_sign_bytes_batch(CHAIN, commit150, list(range(150)))
sigs150 = [cs.signature for cs in commit150.signatures]
os.environ["TM_TPU_SPOT_CHECK"] = "0"
rt = degrade.configure(degrade.DegradeConfig.from_env(),
                       registry=Registry("per_block"))
os.environ.pop("TM_TPU_SPOT_CHECK")
check(rt.cfg.spot_check is False, "TM_TPU_SPOT_CHECK=0 was not read")
ones150 = np.ones(150, dtype=bool)
VARIANTS = {
    "verify_commit_spot_on": (True, lambda: vset150.verify_commit(
        CHAIN, bid150, 9, commit150, device=DEV)),
    "verify_commit_spot_off": (False, lambda: vset150.verify_commit(
        CHAIN, bid150, 9, commit150, device=DEV)),
    "bulk_spot_on": (True, lambda: cbatch.verify_sigs_bulk(
        mat150, msgs150, sigs150, device=DEV)),
    "bulk_spot_off": (False, lambda: cbatch.verify_sigs_bulk(
        mat150, msgs150, sigs150, device=DEV)),
    "direct": (None, lambda: cbatch.verify_ed25519_batch(
        mat150, msgs150, sigs150, cache_pubs=True, device=DEV)),
    "direct_on_bare_worker": (None, lambda: bare_worker.submit(
        lambda: cbatch.verify_ed25519_batch(
            mat150, msgs150, sigs150, cache_pubs=True, device=DEV))
        .result(60)),
    "spot_check_alone": (None, lambda: check(
        cbatch._spot_check_bulk(mat150, msgs150, sigs150)(ones150),
        "spot check on a valid commit")),
}
bare_worker = degrade._LaneWorker("bare-lane")
walls12 = {k: [] for k in VARIANTS}
for rnd in range(41):           # round 0 warms up
    for key, (spot, fn) in VARIANTS.items():
        if spot is not None:
            rt.cfg.spot_check = spot
        t = time.perf_counter()
        fn()
        if rnd:
            walls12[key].append(time.perf_counter() - t)
bare_worker.shutdown(wait=True)
runtime_clean("phase-12 per-block walls", "bulk.ed25519")
degrade.configure(degrade.DegradeConfig.from_env())
runtime12["per_block"] = dict(
    median_s={k: sorted(v)[len(v) // 2] for k, v in walls12.items()},
    quartiles_s={k: (sorted(v)[len(v) // 4], sorted(v)[3 * len(v) // 4])
                 for k, v in walls12.items()},
    walls_s=walls12, rounds=40,
    phase7_verify_commit_150_wall_s=times["verify_commit_150_wall_s"])
log(phase=12, card=CARD, **{k: v for k, v in runtime12["per_block"].items()
                             if k != "walls_s"})

# the same commit, called ten times in a row as phase 7 times it, under
# the flight recorder: each call's device.collect (caller) and
# device.launch (lane worker) spans split its wall into the hand-off to
# the worker, the launch (ops.ed25519.verify_batch inside it) and the way
# back (the wake-up, the spot check's one-bit compare, the breaker; its
# host verify runs in the caller after the submit, before the wait)
trace.enable()
seq12 = trace.last_seq()
traced_w = wall(lambda: vset150.verify_commit(CHAIN, bid150, 9, commit150,
                                              device=DEV), 10)
spans12 = trace.snapshot(seq12)
trace.disable()
trace.reset()
collects = [r for r in spans12 if r["name"] == "device.collect"][1:]
launches12 = [r for r in spans12 if r["name"] == "device.launch"][1:]
ops12 = {r["parent"]: r for r in spans12
         if r["name"] == "ops.ed25519.verify_batch"}
check(len(collects) == len(launches12) == 10
      and all(r["id"] in ops12 for r in launches12)
      and all(r["attrs"].get("outcome") == "ok" for r in collects),
      f"phase 12: traced spans {[r['name'] for r in spans12]}")
split = {"to_worker": [], "launch": [], "ops_verify_batch": [], "back": []}
for c, ln in zip(collects, launches12):
    split["to_worker"].append((ln["ts_ns"] - c["ts_ns"]) / 1e9)
    split["launch"].append(ln["dur_ns"] / 1e9)
    split["ops_verify_batch"].append(ops12[ln["id"]]["dur_ns"] / 1e9)
    split["back"].append((c["ts_ns"] + c["dur_ns"] - ln["ts_ns"]
                          - ln["dur_ns"]) / 1e9)
runtime12["traced_150"] = dict(
    walls_s=traced_w, median_wall_s=sorted(traced_w)[5],
    median_s={k: sorted(v)[5] for k, v in split.items()}, split_s=split,
    spans=len(spans12), threads=sorted({r["tname"] for r in spans12}))
log(phase=12, card=CARD, **{k: v for k, v in runtime12["traced_150"].items()
                             if k != "split_s"})
times["degraded_verify_commit_100k_wall_s"] = degraded_s
times["verify_commit_150_spot_off_wall_s"] = \
    runtime12["per_block"]["median_s"]["verify_commit_spot_off"]
check(degrade.runtime().breaker.state == degrade.CLOSED, "breaker at the end")
staging_clear(12)

# -- phase 13: the VerifyScheduler and the launch observatory ------------------


def pctl(vals, q):
    v = sorted(vals)
    return v[min(len(v) - 1, int(q * len(v)))] if v else None


def wait_for(cond, what, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < end, f"phase 13: {what}")
        time.sleep(0.002)


sched13 = {"card": CARD}
# a private registry: phase 12 counted its drills in the default one
degrade.configure(degrade.DegradeConfig.from_env(),
                  registry=Registry("sched13"))

# the triples: phase 5's 100,000, phase 6's 1,024 distinct (its corrupted
# ones stay invalid) and fresh ones from the same generator, 1 in 1,000
# corrupted at seeded positions; every consumer's triples are distinct
# but for the gossip duplicates of the vote windows
rng = random.Random(SEED + 13)
N_BS, N_CM, N_CS, N_MP = (4, 2, 8192), (4, 4, 1024), (8, 10, 150), (8, 8, 512)
SHARED = 50   # triples of each vote window also in its pair's window
n_items13 = sum(t * c * k for t, c, k in (N_BS, N_CM, N_CS, N_MP))
n_dup13 = (N_CS[0] // 2) * N_CS[1] * SHARED
n_pool = n_items13 - n_dup13
n5, n6 = len(vp100k), 1024
n_fresh = n_pool - n5 - n6
a_x, p_x = gen_keys(n_fresh, rng)
m_x = [rng.randbytes(64) for _ in range(n_fresh)]
s_x = sign_batch(a_x, p_x, m_x, rng)
pool_p = vp100k + trip6[0][:n6] + p_x
pool_m = [msgs100k[i] for i in range(n5)] + trip6[1][:n6] + m_x
pool_s = list(sig100k) + trip6[2][:n6] + s_x
pool_ok = [True] * n5 + [i not in bad6 for i in range(n6)] + [True] * n_fresh
bad13 = rng.sample([i for i in range(n_pool) if pool_ok[i]], n_pool // 1000)
for i in bad13:
    pool_s[i] = corrupt(pool_s[i], rng)
    pool_ok[i] = False
check(len(set(pool_s)) == n_pool, "phase 13: the triples are not distinct")
order = list(range(n_pool))
rng.shuffle(order)
_next = iter(order)


def take(k):
    return [next(_next) for _ in range(k)]


calls13 = {
    "blocksync": [[take(N_BS[2]) for _ in range(N_BS[1])]
                  for _ in range(N_BS[0])],
    "commit": [[take(N_CM[2]) for _ in range(N_CM[1])]
               for _ in range(N_CM[0])],
    "mempool": [[take(N_MP[2]) for _ in range(N_MP[1])]
                for _ in range(N_MP[0])],
    "consensus": [[None] * N_CS[1] for _ in range(N_CS[0])]}
dup13 = set()
for pair in range(N_CS[0] // 2):
    for c in range(N_CS[1]):
        shared = take(SHARED)
        dup13.update(shared)
        calls13["consensus"][2 * pair][c] = shared + take(N_CS[2] - SHARED)
        calls13["consensus"][2 * pair + 1][c] = \
            take(N_CS[2] - SHARED) + shared
commit_idx = [i for t in calls13["commit"] for c in t for i in c]
pre13 = rng.sample([i for i in commit_idx if pool_ok[i]],
                   len(commit_idx) // 10)
pk_obj = {i: edkeys.PubKey(pool_p[i]) for i in commit_idx}


def args13(cls, idx):
    if cls == "commit":
        return ([pk_obj[i] for i in idx], [pool_m[i] for i in idx],
                [pool_s[i] for i in idx])
    return [(pool_p[i], pool_m[i], pool_s[i]) for i in idx]


inputs13 = {cls: [[args13(cls, c) for c in t] for t in calls]
            for cls, calls in calls13.items()}
expect13 = {cls: [[np.array([pool_ok[i] for i in c]) for c in t]
                  for t in calls]
            for cls, calls in calls13.items()}


def fresh_cache():
    """A SigCache no entry of the phase can be evicted from, holding the
    pre-cached 10% of the COMMIT triples."""
    cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
    for i in pre13:
        cbatch.verified_sigs.add(pool_p[i], pool_m[i], pool_s[i])


def consume(cls, args, sched=None):
    """One consumer call on its entry point; returns the bitmap."""
    if cls == "blocksync":
        return vsched.verify_items(args, vsched.Priority.BLOCKSYNC,
                                   device=DEV)[1]
    if cls == "consensus":
        return vsched.verify_items(args, vsched.Priority.CONSENSUS,
                                   deadline=time.monotonic() + 0.005,
                                   device=DEV)[1]
    if cls == "commit":
        with vsched.priority_context(vsched.Priority.COMMIT):
            return cbatch.verify_sigs_bulk(*args, device=DEV)
    if sched is None:   # the mempool pre-check's direct path
        return vsched.verify_items(args, vsched.Priority.MEMPOOL,
                                   device=DEV)[1]
    return sched.submit(args, vsched.Priority.MEMPOOL).result(
        timeout=sched.sync_timeout())


def exact13(bits) -> bool:
    return all(np.array_equal(b, e) for cls in bits
               for tb, te in zip(bits[cls], expect13[cls])
               for b, e in zip(tb, te))


def sync_baseline():
    """No scheduler running: each consumer's calls on its direct path,
    one after another (bench.py's sync loop).  Returns (wall, the
    launches' devobs block)."""
    check(vsched.running() is None, "a scheduler is running")
    fresh_cache()
    cur = devobs.cursor()
    t0 = time.perf_counter()
    bits = {cls: [[consume(cls, a) for a in t_args] for t_args in ins]
            for cls, ins in inputs13.items()}
    wall_s = time.perf_counter() - t0
    check(exact13(bits), "phase 13: sync baseline bitmaps")
    return wall_s, devobs.device_block(since=cur)


def start_sched():
    """A fresh SigCache and a scheduler at the node's defaults."""
    fresh_cache()
    sch = vsched.install(vsched.VerifyScheduler(
        window_s=0.002, max_batch=8192, max_pending=65536,
        tpu_threshold=32, device=DEV))
    sch.start()
    return sch


sync13_s, sync13_blk = sync_baseline()

# the mixed load through the scheduler at the node's defaults
s13 = start_sched()
rt13 = degrade.runtime()
m13 = rt13.metrics
slo.reset()
slo.enable(window=1 << 14)
launched13 = []     # the signatures of each device launch, in order
real_veb = cbatch.verify_ed25519_batch
direct13 = [0]


def recording_veb(pubkeys, msgs, sigs, cache_pubs=False, device=None):
    launched13.append(list(sigs))
    return real_veb(pubkeys, msgs, sigs, cache_pubs=cache_pubs,
                    device=device)


class CountingBV(cbatch.BatchVerifier):
    def verify(self):
        direct13[0] += 1
        return super().verify()


site_launches0 = {site: m13.device_launches.value(site=site)
                  for site in ("batch.ed25519", "bulk.ed25519")}
n_threads = sum(len(ins) for ins in inputs13.values())


def consumer13(load, cls, k):
    def run():
        load["start"].wait(60)
        try:
            for c, a in enumerate(inputs13[cls][k]):
                if cls == "consensus":
                    load["pairs"][k // 2].wait(60)
                t0 = time.perf_counter()
                load["bits"][cls][k][c] = consume(cls, a, load["sched"])
                load["lat"][cls].append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - surfaced below
            load["errors"].append((cls, k, repr(e)))
    return threading.Thread(target=run, name=f"consumer-{cls}-{k}")


def mixed_load(sched):
    """Every consumer thread on its entry point through `sched`, started
    together; returns the load's record (wall, bitmaps, latencies)."""
    load = dict(sched=sched, errors=[],
                lat={cls: [] for cls in inputs13},
                bits={cls: [[None] * len(t) for t in ins]
                      for cls, ins in inputs13.items()},
                start=threading.Barrier(n_threads + 1),
                pairs=[threading.Barrier(2) for _ in range(N_CS[0] // 2)],
                cursor=devobs.cursor())
    threads = [consumer13(load, cls, k) for cls, ins in inputs13.items()
               for k in range(len(ins))]
    for th in threads:
        th.start()
    load["start"].wait(60)
    t0 = time.perf_counter()
    for th in threads:
        th.join(300)
    load["wall_s"] = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "a consumer hung")
    check(not load["errors"],
          f"phase 13: consumer errors {load['errors'][:3]}")
    check(exact13(load["bits"]), "phase 13: scheduled bitmaps")
    return load


cbatch.verify_ed25519_batch = recording_veb
cbatch.BatchVerifier = CountingBV
ck.verify_packed = _recording("verify_packed")
try:
    load13, c13 = main_path(lambda: mixed_load(s13),
                            capture=("verify_packed", "scheduler window"),
                            site="sched.ed25519")
finally:
    cbatch.verify_ed25519_batch = real_veb
    cbatch.BatchVerifier = CountingBV.__bases__[0]
    ck.verify_packed = REAL["verify_packed"]
piped13_s, lat13 = load13["wall_s"], load13["lat"]
wait_for(lambda: s13.stats()["launches"] == len(launched13),
         "the executor did not settle its launches")
st13 = s13.stats()
slo_rep = {cls: slo.stream_report(cls) for cls in inputs13}
slo.disable()
slo.reset()
# the accounting: each triple verified on the card once, but for the
# pre-cached ones (never) and the gossip duplicates (once, or twice
# when the pair's windows were staged apart while the first copy was
# still in flight); every other copy was resolved without a lane
sig_count: dict = {}
for launch in launched13:
    for sg in launch:
        sig_count[sg] = sig_count.get(sg, 0) + 1
relaned13 = sum(1 for i in dup13 if sig_count.get(pool_s[i]) == 2)
others_once = all(sig_count.get(pool_s[i]) == 1 for i in range(n_pool)
                  if i not in dup13 and i not in pre13)
pre_launched = sum(1 for i in pre13 if pool_s[i] in sig_count)
dup_hits13 = st13["cache_hits"] - len(pre13)
sched13["accounting"] = dict(
    items=st13["items"], lanes=st13["lanes"], dedup=st13["dedup"],
    cache_hits=st13["cache_hits"], precached=len(pre13),
    gossip_duplicates=n_dup13, duplicates_deduped=st13["dedup"],
    duplicates_from_cache=dup_hits13, duplicates_relaned=relaned13,
    card_lanes=sum(sig_count.values()), shed=st13["shed"])
log(phase=13, card=CARD, **sched13["accounting"])
check(st13["items"] == n_items13 and st13["shed"] == 0
      and st13["exec_faults"] == 0 and st13["submissions"] == sum(
          len(c) for ins in inputs13.values() for c in ins),
      f"phase 13: stats {st13}")
check(st13["lanes"] + st13["dedup"] + st13["cache_hits"] == n_items13,
      "phase 13: lanes + dedup + cache_hits != items")
check(others_once and pre_launched == 0
      and all(1 <= sig_count.get(pool_s[i], 0) <= 2 for i in dup13),
      f"phase 13: lanes per triple (pre-cached launched {pre_launched})")
check(st13["lanes"] == sum(sig_count.values()),
      "phase 13: stats lanes != the lanes the card verified")
check(st13["cache_hits"] >= len(pre13) and dup_hits13 + st13["dedup"]
      + relaned13 == n_dup13,
      f"phase 13: duplicates {sched13['accounting']}")
# every device launch was K1 at sched.ed25519, one per device lane
sched_lanes = m13.device_launches.value(site="sched.ed25519")
check(c13["verify_packed"] == len(launched13) == sched_lanes
      and c13["verify_packed_split"] == 0
      and not any(c13[k] for k in cm.launches),
      f"phase 13: launches {c13}, device lanes {sched_lanes}")
direct_launches = {site: m13.device_launches.value(site=site) - v
                   for site, v in site_launches0.items()}
check(direct13[0] == 0 and not any(direct_launches.values()),
      f"phase 13: direct-path fallbacks {direct13[0]}, {direct_launches}")
runtime_clean("phase-13 mixed load", "sched.ed25519")
# the first coalesced window's K1 launch against its plain version
ok_of = {pool_s[i]: pool_ok[i] for i in range(n_pool)}
cmp13 = plain_on_captured("verify_packed",
                          np.array([ok_of[sg] for sg in launched13[0]]))
check(cmp13[2] == 0, f"K1 differs from plain on a scheduler window: {cmp13}")
paths13 = {r["path"] for r in devobs.records(last=len(launched13))}
check(paths13 == {"cuda"}, f"phase 13: launch paths {paths13}")
sizes13 = sorted(len(x) for x in launched13)
sched13["mixed"] = dict(
    consumers={cls: f"{len(ins)} x {len(ins[0])} x {len(ins[0][0]) if cls != 'commit' else len(ins[0][0][0])}"
               for cls, ins in inputs13.items()},
    items=n_items13, window_ms=2, max_batch=8192, max_pending=65536,
    tpu_threshold=32, pipelined_wall_s=piped13_s,
    pipelined_sigs_per_s=n_items13 / piped13_s, sync_wall_s=sync13_s,
    sync_sigs_per_s=n_items13 / sync13_s, speedup=sync13_s / piped13_s,
    launches=st13["launches"], mean_batch=st13["mean_batch"],
    overlap_ratio=st13["overlap_ratio"], stager_busy_s=st13["stage_s"],
    executor_busy_s=st13["exec_busy_s"],
    pipelined_launches=devobs.device_block(since=load13["cursor"]),
    sync_launches=sync13_blk, window_lanes_min_median_max=(
        sizes13[0], sizes13[len(sizes13) // 2], sizes13[-1]),
    consensus_deadline_misses=m13.sched_deadline_miss.value(
        priority="consensus"),
    consensus_calls=len(lat13["consensus"]),
    client_e2e_s={cls: {"p50": pctl(v, 0.5), "p99": pctl(v, 0.99)}
                  for cls, v in lat13.items()},
    sched_e2e_s={cls: {"p50": r["p50_s"], "p99": r["p99_s"], "n": r["n"]}
                 for cls, r in slo_rep.items() if r},
    k1_vs_plain=cmp13)
log(phase=13, **sched13["mixed"])
staging_clear("13 mixed load")

# the JAX bench's own shape (bench.py _sched_main): 16 BLOCKSYNC
# submissions of 64, each consumer's BatchVerifier one after another
# against all 16 submitted at once through the scheduler
rng = random.Random(SEED + 131)
a_b, p_b = gen_keys(1024, rng)
m_b = [rng.randbytes(64) for _ in range(1024)]
s_b = sign_batch(a_b, p_b, m_b, rng)
subs_b = [[(edkeys.PubKey(p_b[i]), m_b[i], s_b[i])
           for i in range(k * 64, (k + 1) * 64)] for k in range(16)]


def bench_sync():
    cbatch.verified_sigs = cbatch.SigCache()
    for sub in subs_b:
        bv = cbatch.BatchVerifier(device=DEV)
        for pub, m_, sg in sub:
            bv.add(pub, m_, sg)
        check(bv.verify()[0], "bench shape: sync batch invalid")


def bench_piped():
    cbatch.verified_sigs = cbatch.SigCache()
    futs = [None] * 16
    ths = [threading.Thread(target=lambda k=k: futs.__setitem__(
        k, s13.submit(subs_b[k], vsched.Priority.BLOCKSYNC)))
        for k in range(16)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(60)
    check(all(f.result(timeout=60).all() for f in futs),
          "bench shape: pipelined batch invalid")


bench_w = {"sync": [], "pipelined": []}
for rnd in range(6):            # round 0 warms up
    for key, fn in (("sync", bench_sync), ("pipelined", bench_piped)) \
            if rnd % 2 else (("pipelined", bench_piped), ("sync", bench_sync)):
        t = time.perf_counter()
        fn()
        if rnd:
            bench_w[key].append(time.perf_counter() - t)
sched13["bench_16x64"] = dict(
    walls_s=bench_w, sync_median_s=pctl(bench_w["sync"], 0.5),
    pipelined_median_s=pctl(bench_w["pipelined"], 0.5),
    speedup=pctl(bench_w["sync"], 0.5) / pctl(bench_w["pipelined"], 0.5))
log(phase=13, card=CARD, bench_16x64={k: v for k, v in
                                      sched13["bench_16x64"].items()
                                      if k != "walls_s"})
runtime_clean("phase-13 bench shape", "sched.ed25519")

# chaos through the scheduler: one 4,096-triple BLOCKSYNC submission with
# 3 invalid lanes (phase 12's), on a fresh runtime
degrade.configure(degrade.DegradeConfig.from_env(),
                  registry=Registry("sched13_chaos"))
items4k = list(zip(pk12, msgs12, sigs12))


def sub4k():
    cbatch.verified_sigs = cbatch.SigCache()
    return s13.submit(items4k, vsched.Priority.BLOCKSYNC,
                      populate_cache=False).result(timeout=120)


chaos13 = []
for mode, reason, want in (("raise", "raise", "none"),
                           ("corrupt-bitmap", "integrity", "some")):
    m = degrade.runtime().metrics
    failpoints.set_mode("sched.ed25519", mode)
    ck.reset_launches()
    try:
        bits = sub4k()
    finally:
        failpoints.clear()
    row = dict(site="sched.ed25519", mode=mode, reason=reason,
               bitmap_ok=bool(np.array_equal(bits, expect12)),
               path=vsched.last_latency_report().get("path"),
               launches=ck.launches["verify_packed"],
               failures=m.device_failures.value(site="sched.ed25519",
                                                reason=reason),
               fallbacks=m.host_fallbacks.value(site="sched.ed25519",
                                                reason=reason))
    chaos13.append(row)
    log(phase=13, card=CARD, **row)
    check(row["bitmap_ok"] and row["path"] == "sched-fallback"
          and row["failures"] == 1 and row["fallbacks"] == 1,
          f"phase 13 chaos {mode}: {row}")
    check(row["launches"] == 0 if want == "none" else row["launches"] >= 1,
          f"phase 13 chaos {mode}: {row['launches']} K1 launches")
    ck.reset_launches()
    check(np.array_equal(sub4k(), expect12)
          and ck.launches["verify_packed"] == 1
          and degrade.runtime().breaker.state == degrade.CLOSED,
          f"phase 13: the clean submission after {mode}")
# outside a drill: a K1 wrapper that raises fails the launch's futures
# with DeviceLaneError, counted once, with no host fallback; the
# scheduler keeps running and the next submission is served by the card
check(not failpoints.armed(), "a failpoint is still armed")
m = degrade.runtime().metrics
real_k1 = ck.verify_packed
ck.verify_packed = launch_failed
raised13 = None
try:
    sub4k()
except degrade.DeviceLaneError as e:
    raised13 = str(e)
finally:
    ck.verify_packed = real_k1
ck.reset_launches()
after13 = sub4k()
row = dict(site="sched.ed25519", reason="raise", raised=raised13,
           failures=m.device_failures.value(site="sched.ed25519",
                                            reason="raise") - 1,
           fallbacks=counter_total(m.host_fallbacks) - 2,
           running=s13.is_running(),
           next_bitmap_ok=bool(np.array_equal(after13, expect12)),
           next_launches=ck.launches["verify_packed"])
chaos13.append(row)
log(phase=13, card=CARD, **row)
check(raised13 is not None and "(raise)" in raised13
      and row["failures"] == 1 and row["fallbacks"] == 0
      and row["running"] and row["next_bitmap_ok"]
      and row["next_launches"] == 1
      and degrade.runtime().breaker.state == degrade.CLOSED,
      f"phase 13: an un-injected K1 raise through the scheduler: {row}")
sched13["chaos"] = chaos13
s13.stop()
vsched.uninstall(s13)
degrade.configure(degrade.DegradeConfig.from_env(),
                  registry=Registry("devobs13"))

# devobs on the card: one record per launch since phase 4 (the ring's
# 256 slots rotate; the totals do not), each with its phases; each
# (path, nb) bucket once in the inventory with its first-launch wall
blk13 = devobs.device_block(since=DEVOBS_CUR4)
n_launch13 = E.last_launch()["seq"] - LAUNCH_SEQ4
recs13 = devobs.records(since_seq=DEVOBS_CUR4["seq"])
seqs13 = [r["seq"] for r in recs13]
no_phases = [(r["path"], r["seq"]) for r in recs13 if not (
    all(r.get(k) is not None for k in ("stage_s", "h2d_s", "compute_s"))
    and (r.get("collect_s") is not None or r.get("drain_s") is not None))]
inv13 = devobs.compile_inventory()
inv_keys = [(e["path"], e["nb"]) for e in inv13]
seen13 = {(p_, nb) for p_, _, nb in E._seen_buckets}
sched13["devobs"] = dict(
    launches=blk13["launches"], launch_seq_delta=n_launch13,
    ring_records=len(recs13), rotated=devobs.OBS.rotated(),
    shed=devobs.OBS.shed_counts(), wall_s=blk13["wall_s"],
    compile_s=blk13["compile_s"], window=blk13["window"],
    inventory=[{k: e[k] for k in ("path", "nb", "compile_s", "hits")}
               for e in inv13],
    hbm=devobs.ledger_report(), records_without_phases=no_phases[:8],
    own_time_since_phase4={k: {"calls": v[0], "us_per_call": 1e6 * v[1]
                               / max(v[0], 1)}
                           for k, v in OBS_COST.items()},
    own_time_rlc_100k_per_call=obs8)
log(phase=13, card=CARD, **sched13["devobs"])
ring = devobs.OBS.capacity
check(blk13["launches"] == n_launch13 > ring
      and devobs.OBS.shed_counts() == {"chaos": 0, "evict": 0},
      f"phase 13: devobs counted {blk13['launches']} of {n_launch13}")
check(len(recs13) == ring and seqs13 == list(range(
    E.last_launch()["seq"] - ring + 1, E.last_launch()["seq"] + 1)),
      f"phase 13: the ring does not hold the last {ring} launches in order")
check(not no_phases, f"phase 13: records without their phases {no_phases}")
check(len(inv_keys) == len(set(inv_keys)) and set(inv_keys) == seen13
      and all(e["compile_s"] is not None for e in inv13),
      f"phase 13: inventory {inv_keys} against {seen13}")

# the cost of recording: the 150-validator verify_commit, devobs off and
# on in turns, 10 calls each
w_obs = {"on": [], "off": []}
for rnd in range(11):           # round 0 warms up
    for key in (("on", "off") if rnd % 2 else ("off", "on")):
        (devobs.enable if key == "on" else devobs.disable)()
        t = time.perf_counter()
        vset150.verify_commit(CHAIN, bid150, 9, commit150, device=DEV)
        if rnd:
            w_obs[key].append(time.perf_counter() - t)
devobs.enable()
sched13["devobs_wall_150"] = dict(
    walls_s=w_obs, median_on_s=pctl(w_obs["on"], 0.5),
    median_off_s=pctl(w_obs["off"], 0.5))
times["verify_commit_150_devobs_on_wall_s"] = pctl(w_obs["on"], 0.5)
times["verify_commit_150_devobs_off_wall_s"] = pctl(w_obs["off"], 0.5)
log(phase=13, card=CARD, verify_commit_150_devobs_on_s=pctl(w_obs["on"], 0.5),
    verify_commit_150_devobs_off_s=pctl(w_obs["off"], 0.5))
runtime_clean("phase-13 devobs walls")
staging_clear(13)

# -- phase 14: the secp256k1 and sr25519 lanes; BASELINE config 5 -------------

PS, NS = secp_ops.P, secp_ops.N
lanes14: dict = {}
# S1's field (fe_secp_selftest) against the plain field, and against Python
# integers on the edge values
rng = random.Random(SEED + 14)
edge_s = [0, 1, 2, PS - 1, PS, PS + 1, (1 << 256) - 1, 977, (1 << 32) + 977,
          1 << 255, PS - 977]
vals_a = edge_s + [rng.randrange(1 << 256) for _ in range(4096)]
vals_b = [rng.randrange(1 << 256) for _ in vals_a[:-len(edge_s)]] + edge_s
fa, fb = to_u8(vals_a), to_u8(vals_b)
got = cs1.fe_secp_selftest(fa, fb)
want = cs1.fe_secp_selftest_plain(fa, fb)
torch.cuda.synchronize()
fs_mism = int((got != want).any(-1).sum())
for i, a in enumerate(vals_a[:len(edge_s)]):
    a, b = a % PS, vals_b[i] % PS
    exp = [a, a * b % PS, a * a % PS, (a + b) % PS, (a - b) % PS,
           pow(a, PS - 2, PS), pow(a, (PS + 1) // 4, PS)]
    for op in range(7):
        g = int.from_bytes(got[op, i].cpu().numpy().tobytes(), "little")
        check(g == exp[op],
              f"fe_secp_selftest op {op} on {hex(vals_a[i])}")
# with b = a, op 1 is fs_mul(a, a): fs_sqr (op 2) must equal it
got_aa = cs1.fe_secp_selftest(fa, fa)
sqr_mism = int((got_aa[1] != got_aa[2]).any(-1).sum()
               + (got_aa[2] != want[2]).any(-1).sum())
log(phase=14, s1_field_elements=len(vals_a), ops=7, mismatches=fs_mism,
    sqr_vs_mul_mismatches=sqr_mism)
check(fs_mism == 0, "S1's field differs from the plain field")
check(sqr_mism == 0, "S1's fs_sqr differs from fs_mul(a, a) or the plain "
      "square")
lanes14["s1_field"] = dict(elements=len(vals_a), ops=7,
                           mismatches=fs_mism, sqr_vs_mul=sqr_mism)
# S2's field (fe2_selftest: fe_mul2 both ways, fe_sq2, the power chain on
# them) against the plain field, and against Python integers on the edge
# values of phase 2
vals_a = edge + [rng.randrange(1 << 255) for _ in range(4096)]
vals_b = [rng.randrange(1 << 255) for _ in vals_a[:-len(edge)]] + edge
fa, fb = to_u8(vals_a), to_u8(vals_b)
got = cs2.fe2_selftest(fa, fb)
want = cs2.fe2_selftest_plain(fa, fb)
torch.cuda.synchronize()
fe2_mism = int((got != want).any(-1).sum())
for i, a in enumerate(vals_a[:len(edge)]):
    a, b = a % (1 << 255), vals_b[i] % (1 << 255)
    exp = [a % P, a * b % P, a * b % P, a * a % P, pow(a, (P - 5) // 8, P)]
    for op in range(5):
        g = int.from_bytes(got[op, i].cpu().numpy().tobytes(), "little")
        check(g == exp[op], f"fe2_selftest op {op} on {hex(vals_a[i])}")
log(phase=14, s2_field_elements=len(vals_a), ops=5, mismatches=fe2_mism)
check(fe2_mism == 0, "S2's field differs from the plain field")
lanes14["s2_field"] = dict(elements=len(vals_a), ops=5, mismatches=fe2_mism)

# BASELINE config 5: 4,096 triples round-robined over ed25519, secp256k1
# and sr25519 (scripts/bench_report.py's mixed shape: "mixed bench %6d"
# messages), signed by the in-repo signers; ed25519 by the generator
t = time.perf_counter()
N5 = 4096
msgs5 = [b"mixed bench %6d" % i for i in range(N5)]
idx5 = {s: [i for i in range(N5) if i % 3 == j]
        for j, s in enumerate(("ed25519", "secp256k1", "sr25519"))}
ed_a, ed_p = gen_keys(len(idx5["ed25519"]), rng)
ed_s = sign_batch(ed_a, ed_p, [msgs5[i] for i in idx5["ed25519"]], rng)
secp_k = [secpkeys.PrivKey.gen_from_secret(b"config5 %d" % i)
          for i in idx5["secp256k1"]]
secp_p = [k.pub_key().bytes() for k in secp_k]
secp_s = [k.sign(msgs5[i]) for k, i in zip(secp_k, idx5["secp256k1"])]
sr_m = [hashlib.sha256(b"config5 %d" % i).digest()
        for i in idx5["sr25519"]]
sr_p = [srkeys.PrivKey(m).pub_key().bytes() for m in sr_m]
sr_s = [srkeys.sign(m, msgs5[i]) for m, i in zip(sr_m, idx5["sr25519"])]
gen14_s = time.perf_counter() - t
RAW5 = {"ed25519": (ed_p, ed_s), "secp256k1": (secp_p, secp_s),
        "sr25519": (sr_p, sr_s)}
KEYS5 = {"ed25519": edkeys, "secp256k1": secpkeys, "sr25519": srkeys}
ITEMS5 = [None] * N5
for s, ix in idx5.items():
    for j, i in enumerate(ix):
        ITEMS5[i] = (KEYS5[s].PubKey(RAW5[s][0][j]), msgs5[i], RAW5[s][1][j])
for i in rng.sample(range(N5), 12):
    check(ITEMS5[i][0].verify_signature(ITEMS5[i][1], ITEMS5[i][2]),
          f"config 5 generator: triple {i} does not verify")
log(phase=14, config5_triples=N5,
    per_scheme={s: len(ix) for s, ix in idx5.items()},
    gen_s=round(gen14_s, 3))


def lane_rows(scheme, pubs, msgs, sigs, corrupt_every=0):
    """(rows (128, n) uint8 on the card, host_ok, the oracle's verdicts)
    of a lane's kernel: staged as its verify_batch_device stages them,
    no range screen applied to the rows."""
    if scheme == "secp256k1":
        rows, ok = secp_ops.stage(pubs, msgs, sigs)
        # the raw rows of screened lanes too (stage zeroes them)
        for i in np.flatnonzero(~ok):
            p, s = bytes(pubs[i]), bytes(sigs[i])
            e = int.from_bytes(secp_ops._tagged_hash(
                "BIP0340/challenge", s[:32] + p[1:]
                + hashlib.sha256(bytes(msgs[i])).digest()), "big") % NS
            rows[i] = np.frombuffer(p[1:] + s + e.to_bytes(32, "big"),
                                    np.uint8)
    else:
        rows, ok = sr_ops.stage(pubs, msgs, sigs)
    oracle = np.array([KEYS5[scheme].PubKey(bytes(p)).verify_signature(
        bytes(m), bytes(s)) for p, m, s in zip(pubs, msgs, sigs)])
    return (torch.from_numpy(np.ascontiguousarray(rows.T)).to(DEV), ok,
            oracle)


def lane_cmp(label, scheme, pubs, msgs, sigs):
    """S1 or S2 against its plain version (raw bitmaps, every lane) and,
    masked by the host screens, against the pure-Python oracle and the
    native C lane.  Returns (label, lanes, mismatches, max_abs_err)."""
    rows, ok, oracle = lane_rows(scheme, pubs, msgs, sigs)
    mod = cs1 if scheme == "secp256k1" else cs2
    kern = mod.verify_rows if scheme == "secp256k1" else mod.verify_packed
    plain = (mod.verify_rows_plain if scheme == "secp256k1"
             else mod.verify_packed_plain)
    got = kern(rows).cpu().numpy()
    want = plain(rows).cpu().numpy()
    nat = (native.secp_verify if scheme == "secp256k1"
           else native.sr25519_verify)(pubs, msgs, sigs)
    err = np.abs(got.astype(int) - want.astype(int))
    row = dict(label=label, scheme=scheme, lanes=len(got),
               mismatches=int(err.sum()), valid=int(oracle.sum()),
               vs_oracle=int(((got & ok) != oracle).sum()),
               vs_native=int(((got & ok) != nat).sum()))
    log(phase=14, card=CARD, **row)
    check(row["mismatches"] == 0 and row["vs_oracle"] == 0
          and row["vs_native"] == 0, f"phase 14 {label}: {row}")
    return label, len(got), int(err.sum()), float(err.max())


# S1: the adversarial set (s = 0, s >= N, r >= P, x >= P, a non-square
# lift_x, an off-curve R_x), rows whose ladder meets the complete add's
# degenerate cases, and a seeded sweep at a ragged size, 1 in 10 corrupted
def be32(x):
    return x.to_bytes(32, "big")


k0 = secpkeys.PrivKey.gen_from_secret(b"\x77" * 32)
pk0, m0 = k0.pub_key().bytes(), b"structured secp lane"
g0 = k0.sign(m0)
xn = 5
while pow((pow(xn, 3, PS) + 7) % PS, (PS - 1) // 2, PS) == 1:
    xn += 1
adv1 = [(pk0, m0, g0[:32] + be32(NS)), (pk0, m0, g0[:32] + be32(NS + 1)),
        (pk0, m0, be32(PS) + g0[32:]), (pk0, m0, be32(PS + 1) + g0[32:]),
        (pk0, m0, be32(xn) + g0[32:]), (b"\x02" + be32(PS), m0, g0),
        (b"\x02" + be32(xn), m0, g0), (pk0, m0, g0[:32] + be32(0)),
        (pk0, m0, g0), (b"\x03" + pk0[1:], m0, g0)]
s1_cmp = [lane_cmp("S1 adversarial", "secp256k1", *zip(*adv1))]
gmul = secp_ops.g_multiples()
deg = []
for kx in (1, 2, 3):
    for de in (1, 2, 5):
        ds = (kx * de) % 16 or 1
        deg.append(be32(gmul[kx][0]) + be32(rng.getrandbits(256))
                   + be32((ds << 252) | rng.getrandbits(250))
                   + be32((de << 252) | rng.getrandbits(250)))
sd = rng.getrandbits(255)
deg.append(be32(gmul[1][0]) + bytes(32) + be32(sd) * 2)
deg_rows = torch.from_numpy(np.ascontiguousarray(np.frombuffer(
    b"".join(deg), np.uint8).reshape(-1, 128).T)).to(DEV)
deg_got = cs1.verify_rows(deg_rows).cpu().numpy()
deg_want = cs1.verify_rows_plain(deg_rows).cpu().numpy()
deg_mism = int((deg_got != deg_want).sum())
log(phase=14, card=CARD, s1_degenerate_rows=len(deg), mismatches=deg_mism)
check(deg_mism == 0, "S1 differs from its plain version on the "
      "degenerate additions")
s1_cmp.append(("S1 degenerate adds", len(deg), deg_mism,
               float(deg_mism > 0)))


def sweep(scheme, n):
    """The first n of config 5's triples of a scheme, 1 in 10 corrupted."""
    pubs, sigs = RAW5[scheme]
    msgs = [msgs5[i] for i in idx5[scheme][:n]]
    sigs = [corrupt(s, rng) if j % 10 == 3 else s
            for j, s in enumerate(sigs[:n])]
    return pubs[:n], msgs, sigs


s1_cmp.append(lane_cmp("S1 sweep 1,000", "secp256k1",
                       *sweep("secp256k1", 1000)))

# S2: the tamper classes of tests/test_sr25519_lane.py (R tampered, s
# tampered, marker cleared, s >= L, wrong message, wrong key) and
# non-canonical, odd, high-bit and non-square encodings of A and R
PE = (1 << 255) - 19
nsq = next(s for s in range(2, 200, 2)
           if _ristretto.Point.decode(s.to_bytes(32, "little")) is None)
sp = list(RAW5["sr25519"][0][:24])
sm = [msgs5[i] for i in idx5["sr25519"][:24]]
ss = [bytearray(s) for s in RAW5["sr25519"][1][:24]]
ss[3][2] ^= 1
ss[5][40] ^= 1
ss[7][63] &= 0x7F
ss[9][63] = 0xFF
sm[11] = b"tampered"
sp[13] = sp[14]
for j, v in enumerate((nsq, 3, PE + 1, 2 + (1 << 255))):
    e = v.to_bytes(32, "little")
    sp[15 + j] = e
    ss[19 + j][:32] = e
s2_cmp = [lane_cmp("S2 adversarial", "sr25519", sp, sm,
                   [bytes(s) for s in ss])]
s2_cmp.append(lane_cmp("S2 sweep 1,000", "sr25519", *sweep("sr25519", 1000)))
lanes14["compared"] = {"S1": s1_cmp, "S2": s2_cmp}

# config 5 through BatchVerifier(device="cuda"): a fresh SigCache each
# pass, one warm-up pass and 7 timed; every pass launches K1, S1 and S2
# once each, on the card, with an all-true bitmap and no host fallback.
# The spot check (one pure-Python verify a secp256k1 or sr25519 lane,
# OpenSSL for ed25519) is timed inside the pass.
degrade.configure(degrade.DegradeConfig.from_env(), registry=Registry("c5"))
spot_s = [0.0]
_prepare = cbatch._SpotCheck.prepare


def timed_prepare(self):
    t = time.perf_counter()
    try:
        return _prepare(self)
    finally:
        spot_s[0] += time.perf_counter() - t


cbatch._SpotCheck.prepare = timed_prepare
cap14 = {}
REAL14 = {"S1": cs1.verify_rows, "S2": cs2.verify_packed}


def capture14(name):
    def wrapper(rows):
        out = REAL14[name](rows)
        if name not in cap14:
            cap14[name] = (rows.clone(), out.clone())
        return out
    return wrapper


def config5_pass(items=ITEMS5):
    cbatch.verified_sigs = cbatch.SigCache()
    bv = cbatch.BatchVerifier(device=DEV)
    for it in items:
        bv.add(*it)
    spot_s[0] = 0.0
    t = time.perf_counter()
    ok, bits = bv.verify()
    return ok, bits, time.perf_counter() - t, spot_s[0]


SITES5 = ("batch.ed25519", "batch.secp256k1", "batch.sr25519")
launches14 = {"S1": 0, "S2": 0}
walls5, spots5, reports5 = [], [], []
cs1.verify_rows, cs2.verify_packed = capture14("S1"), capture14("S2")
for rnd in range(8):
    rt = degrade.runtime()
    before = {s: rt.metrics.device_launches.value(site=s) for s in SITES5}
    cs1.reset_launches()
    cs2.reset_launches()
    (ok, bits, w, sp_s), got = main_path(config5_pass)
    n1, n2 = cs1.launches["verify_rows"], cs2.launches["verify_packed"]
    launches14["S1"] += n1
    launches14["S2"] += n2
    for s in SITES5:
        runtime_clean(f"config 5 pass {rnd}", s, before[s])
    check(ok and bits.all(), f"config 5 pass {rnd}: bitmap not all true")
    check(got["verify_packed"] == 1 and n1 == 1 and n2 == 1,
          f"config 5 pass {rnd}: K1 {got['verify_packed']}, S1 {n1}, S2 {n2}")
    if rnd:
        walls5.append(w)
        spots5.append(sp_s)
        reports5.append(cbatch.last_lane_report())
cs1.verify_rows, cs2.verify_packed = REAL14["S1"], REAL14["S2"]
med5 = pctl(walls5, 0.5)
rep5 = reports5[walls5.index(med5)] if med5 in walls5 else reports5[0]
lanes14["config5"] = dict(
    triples=N5, walls_s=walls5, median_wall_s=med5, sigs_per_s=N5 / med5,
    spot_check_s=spots5, spot_check_share=pctl(spots5, 0.5) / med5,
    lane_report=rep5, launches=launches14)
times["config5_wall_s"] = med5
times["config5_sigs_per_s"] = N5 / med5
log(phase=14, card=CARD, config5_median_wall_s=med5,
    sigs_per_s=round(N5 / med5, 1),
    spot_check_share=round(lanes14["config5"]["spot_check_share"], 4),
    lane_report=rep5)
# the main path's S1 and S2 launches against their plain versions
for name, mod, plain, cmps in (("S1", cs1, cs1.verify_rows_plain, s1_cmp),
                               ("S2", cs2, cs2.verify_packed_plain, s2_cmp)):
    rows, out = cap14[name]
    want = plain(rows).cpu().numpy()
    got = out.cpu().numpy()
    n_real = len(idx5["secp256k1" if name == "S1" else "sr25519"])
    mism = int((got != want).sum())
    check(rows.shape[1] == 2048 and mism == 0 and want[:n_real].all(),
          f"{name} on config 5's launch: {mism} mismatches, lanes "
          f"{rows.shape[1]}")
    cmps.append((f"{name} config 5 launch", rows.shape[1], mism,
                 float(mism > 0)))
ROWS5 = {k: v[0] for k, v in cap14.items()}

# the secp256k1 rollback: secp256k1 on the native host lane through the
# pool, at the pool's default size and at one worker
roll = {}
secp_ops.set_lane_enabled(False)
try:
    for label, nw in (("pool_default", None), ("pool_1", 1)):
        lanepool.set_workers(nw)
        ws = []
        for rnd in range(4):
            cs1.reset_launches()
            (ok, bits, w, _), got = main_path(config5_pass)
            check(ok and bits.all() and cs1.launches["verify_rows"] == 0,
                  f"rollback {label}: bitmap or an S1 launch")
            if rnd:
                ws.append(w)
        roll[label] = dict(workers=lanepool.workers(), walls_s=ws,
                           median_wall_s=pctl(ws, 0.5),
                           lane_report=cbatch.last_lane_report())
        log(phase=14, card=CARD, rollback=label,
            workers=lanepool.workers(), median_wall_s=pctl(ws, 0.5))
finally:
    secp_ops.set_lane_enabled(None)
    lanepool.set_workers(None)
lanes14["rollback"] = roll
times["config5_rollback_pool_wall_s"] = roll["pool_default"]["median_wall_s"]
times["config5_rollback_serial_wall_s"] = roll["pool_1"]["median_wall_s"]

# a mixed 150-validator commit (50 of each scheme) through
# ValidatorSet.verify_commit on the card: K1, S1 and S2 once a call
signer = {}
vals150 = []
for j in range(150):
    s = ("ed25519", "secp256k1", "sr25519")[j % 3]
    seed = hashlib.sha256(b"mixed150 %d" % j).digest()
    if s == "ed25519":
        k = edkeys.PrivKey(seed)
        pub = k.pub_key()
        signer[pub.bytes()] = k.sign
    elif s == "secp256k1":
        k = secpkeys.PrivKey.gen_from_secret(seed)
        pub = k.pub_key()
        signer[pub.bytes()] = k.sign
    else:
        pub = srkeys.PrivKey(seed).pub_key()
        signer[pub.bytes()] = (lambda m, seed=seed: srkeys.sign(seed, m))
    vals150.append(Validator.new(pub, 10))
vsetm = ValidatorSet(vals150)
bidm = BlockID(b"\x37" * 32, PartSetHeader(1, b"\x38" * 32))
sigsm = [CommitSig(block_id_flag=BlockIDFlag.COMMIT,
                   validator_address=v.address,
                   timestamp=Timestamp(1700000700, i * 7919))
         for i, v in enumerate(vsetm.validators)]
commitm = Commit(height=9, round=0, block_id=bidm, signatures=sigsm)
msgsm = commit_sign_bytes_batch(CHAIN, commitm, list(range(150)))
for i, v in enumerate(vsetm.validators):
    sigsm[i].signature = signer[v.pub_key.bytes()](bytes(msgsm[i]))
wm = []
cs1.verify_rows = capture14("S1_150")
cs2.verify_packed = capture14("S2_150")
REAL14["S1_150"] = REAL14["S1"]
REAL14["S2_150"] = REAL14["S2"]
for rnd in range(11):
    cs1.reset_launches()
    cs2.reset_launches()
    t = time.perf_counter()
    _, got = main_path(lambda: vsetm.verify_commit(CHAIN, bidm, 9, commitm,
                                                   device=DEV))
    w = time.perf_counter() - t
    if rnd == 0:
        cs1.verify_rows = REAL14["S1"]
        cs2.verify_packed = REAL14["S2"]
    check(got["verify_packed"] == 1 and cs1.launches["verify_rows"] == 1
          and cs2.launches["verify_packed"] == 1,
          f"mixed 150 commit: K1 {got['verify_packed']}, S1 "
          f"{cs1.launches['verify_rows']}, S2 {cs2.launches['verify_packed']}")
    if rnd:
        wm.append(w)
bad_m = {}
for s in ("ed25519", "secp256k1", "sr25519"):
    i = next(i for i, v in enumerate(vsetm.validators)
             if v.pub_key.type_name == s)
    orig = commitm.signatures[i].signature
    commitm.signatures[i].signature = bytes([orig[0] ^ 1]) + orig[1:]
    err = commit_error_index(vsetm, bidm, commitm)
    commitm.signatures[i].signature = orig
    bad_m[s] = (i, err)
    check(err is not None and f"(#{i})" in err,
          f"mixed 150 commit: a bad {s} signature at {i}: {err}")
for s in SITES5:
    runtime_clean("mixed 150 commit", s)
lanes14["mixed_150"] = dict(walls_s=wm, median_wall_s=pctl(wm, 0.5),
                            bad_index={k: v[0] for k, v in bad_m.items()})
# the commit's S1 and S2 launches (50 lanes each, padded to 64) against
# their plain versions
for name, plain, cmps in (("S1", cs1.verify_rows_plain, s1_cmp),
                          ("S2", cs2.verify_packed_plain, s2_cmp)):
    rows150, out150 = cap14[f"{name}_150"]
    mism = int((out150.cpu().numpy() != plain(rows150).cpu().numpy()).sum())
    check(mism == 0 and out150[:50].all(),
          f"{name} on the mixed 150 commit's launch ({rows150.shape[1]} "
          f"lanes): {mism} mismatches")
    cmps.append((f"{name} mixed 150 launch", rows150.shape[1], mism,
                 float(mism > 0)))
    ROWS5[f"{name}_150"] = rows150
times["verify_commit_mixed_150_wall_s"] = pctl(wm, 0.5)
log(phase=14, card=CARD, verify_commit_mixed_150_s=pctl(wm, 0.5),
    bad_index=lanes14["mixed_150"]["bad_index"])

# the drills: a raise at ops.secp.verify_batch and ops.sr25519.verify_batch
# in a drill re-verifies those lanes on the host (exact bitmap); outside a
# drill S1's and S2's wrappers swapped for ones that raise: DeviceLaneError
# and no host fallback
drills = []
for site in ("ops.secp.verify_batch", "ops.sr25519.verify_batch"):
    rt = degrade.configure(degrade.DegradeConfig.from_env(),
                           registry=Registry("drill14"))
    failpoints.set_mode(site, "raise")
    try:
        ok, bits, w, _ = config5_pass()
    finally:
        failpoints.reset()
    lane = "batch." + ("secp256k1" if "secp" in site else "sr25519")
    row = dict(site=site, exact=bool(ok and bits.all()), wall_s=w,
               fallbacks=rt.metrics.host_fallbacks.value(site=lane,
                                                         reason="raise"))
    drills.append(row)
    log(phase=14, card=CARD, drill=row)
    check(row["exact"] and row["fallbacks"] == 1, f"drill at {site}: {row}")
for name, mod, attr in (("S1", cs1, "verify_rows"),
                        ("S2", cs2, "verify_packed")):
    rt = degrade.configure(degrade.DegradeConfig.from_env(),
                           registry=Registry("card14"))
    real_fn = getattr(mod, attr)
    setattr(mod, attr, launch_failed)
    raised = None
    try:
        config5_pass()
    except degrade.DeviceLaneError as e:
        raised = str(e)
    finally:
        setattr(mod, attr, real_fn)
    row = dict(kernel=name, raised=raised,
               fallbacks=counter_total(rt.metrics.host_fallbacks))
    drills.append(row)
    log(phase=14, card=CARD, card_fault=row)
    check(raised is not None and row["fallbacks"] == 0,
          f"{name} raising outside a drill: {row}")
degrade.configure(degrade.DegradeConfig.from_env(),
                  registry=Registry("c5_after"))
ok, bits, _, _ = config5_pass()
check(ok and bits.all(), "config 5 after the drills")
for s in ("batch.secp256k1", "batch.sr25519"):
    runtime_clean("config 5 after the drills", s)
lanes14["drills"] = drills

# the scheduler: one mixed verify_items call launches at sched.secp256k1
# and sched.sr25519 (start() builds S1 and S2 on this thread)
s14 = vsched.install(vsched.VerifyScheduler(device=DEV))
s14.start()
try:
    rt = degrade.runtime()
    cs1.reset_launches()
    cs2.reset_launches()
    cbatch.verified_sigs = cbatch.SigCache()
    ok, bits = vsched.verify_items(ITEMS5, device=DEV)
    sched_sites = {s: rt.metrics.device_launches.value(site=s)
                   for s in ("sched.ed25519", "sched.secp256k1",
                             "sched.sr25519")}
finally:
    s14.stop()
    vsched.uninstall(s14)
st14 = s14.stats()
lanes14["scheduler"] = dict(sites=sched_sites, exec_faults=st14["exec_faults"],
                            launches=st14["launches"],
                            s1=cs1.launches["verify_rows"],
                            s2=cs2.launches["verify_packed"])
log(phase=14, card=CARD, scheduler=lanes14["scheduler"])
check(ok and bits.all() and all(v >= 1 for v in sched_sites.values())
      and cs1.launches["verify_rows"] >= 1
      and cs2.launches["verify_packed"] >= 1 and st14["exec_faults"] == 0,
      f"scheduler: {lanes14['scheduler']}")
cbatch._SpotCheck.prepare = _prepare

# kernel times: S1 and S2 by CUDA events at 2,048 (config 5's launch),
# 65,536 lanes and 64 (the mixed 150-validator commit's launch), beside
# their bounds and their plain versions at 2,048
for name, fn, plain in (("s1", REAL14["S1"], cs1.verify_rows_plain),
                        ("s2", REAL14["S2"], cs2.verify_packed_plain)):
    rows = ROWS5[name.upper()]
    big = rows.repeat(1, 32).contiguous()
    times[f"{name}_64_ms"] = time_events(
        lambda: fn(ROWS5[f"{name.upper()}_150"]), 20)
    times[f"{name}_2048_ms"] = time_events(lambda: fn(rows), 20)
    times[f"{name}_65536_ms"] = time_events(lambda: fn(big), 3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain(rows)
    torch.cuda.synchronize()
    times[f"plain_{name}_2048_ms"] = 1e3 * (time.perf_counter() - t)
ga, pa = cs1.digit_adds(ROWS5["S1"])
times["s1_2048_bound_ms"] = cs1.bound_ms(2048, ga, pa)
times["s1_65536_bound_ms"] = cs1.bound_ms(65536, 32 * ga, 32 * pa)
times["s1_64_bound_ms"] = cs1.bound_ms(64, *cs1.digit_adds(ROWS5["S1_150"]))
ba, aa = cs2.digit_adds(ROWS5["S2"])
times["s2_2048_bound_ms"] = cs2.bound_ms(2048, ba, aa)
times["s2_65536_bound_ms"] = cs2.bound_ms(65536, 32 * ba, 32 * aa)
times["s2_64_bound_ms"] = cs2.bound_ms(64, *cs2.digit_adds(ROWS5["S2_150"]))
log(phase=14, card=CARD, **{k: v for k, v in times.items()
                            if k.startswith(("s1_", "s2_", "plain_s"))})
REPORT["lanes"] = lanes14
runtime_clean("phase 14")
staging_clear(14)

# -- phase 15: the comb (C1, C2, the table cache, prewarm) ---------------------

# phases 4-14 ran with the comb on (its default) and never launched it: no
# set was prewarmed, and the 100k and 4,096-validator commits were declined
# by the budget before any build
check(cc.launches == {"comb_build": 0, "comb_verify": 0}
      and len(E._table_cache) == 0 and E.comb_enabled(),
      f"phases 4-14 reached the comb: {cc.launches}")
degrade.configure(degrade.DegradeConfig.from_env(),
                  registry=Registry("comb15"))
comb15: dict = {}
rng = random.Random(SEED + 15)


def u8(rows, width):
    return torch.from_numpy(np.frombuffer(b"".join(rows), dtype=np.uint8)
                            .reshape(-1, width).copy()).to(DEV)


def c1_cmp(label, keys):
    """C1 on the card against its plain version on the same keys: table
    entries whose field values differ, and decode verdicts that do."""
    pub = u8(keys, 32)
    tab, ok = REAL["comb_build"](pub)
    ptab, pok = cc.comb_build_plain(pub)
    row = (label, len(keys), cc.tables_mismatch(tab, ptab)
           + int((ok != pok).sum()))
    comb15.setdefault("c1_vs_plain", []).append(row)
    log(phase=15, c1_vs_plain=row)
    return row


# C1 on the adversarial encodings (valid keys, y = p, y = p + 1, the
# non-square y, negative zero, an order-8 and an order-4 point, the
# identity) and on the 1,024-key set
y_ord8 = 2
while True:
    q8 = _edref._decode(y_ord8.to_bytes(32, "little"))
    if q8 is not None:
        t8 = _edref._mul(L, q8)
        if _edref._encode(_edref._mul(4, t8)) != ident:
            break
    y_ord8 += 1
a8_list, p8 = gen_keys(3, rng)
adv_keys = p8 + [P.to_bytes(32, "little"), (P + 1).to_bytes(32, "little"),
                 y_ns.to_bytes(32, "little"),
                 (1 | (1 << 255)).to_bytes(32, "little"),
                 _edref._encode(t8), bytes(32), ident]
a1k, keys1k = gen_keys(1024, rng)
# 4,096 keys (512 blocks: every SM holds C1's blocks), from a generator of
# their own so that the rest of the phase draws what it drew before
_, keys4k = gen_keys(4096, random.Random(SEED + 1504))
cmp15 = [c1_cmp("adversarial", adv_keys), c1_cmp("1,024-key set", keys1k),
         c1_cmp("4,096-key set", keys4k)]
check(all(r[2] == 0 for r in cmp15), f"C1 differs from plain: {cmp15}")

# prewarms through the entry point: the phase-4 150-validator set
# (k_pad 256) and the 1,024-key set are built, a 2,048-key set is
# declined by the 256 MiB budget (2,048 x 202,752 B charged)
rt15 = degrade.runtime()
vp150 = [v.pub_key.bytes() for v in vset150.validators]
_, keys2k = gen_keys(2048, rng)
prewarm15 = {}
for label, keys in (("150", vp150), ("1,024", keys1k), ("2,048", keys2k)):
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(DEV)
    t = time.perf_counter()
    (ok, got) = main_path(lambda: E.prewarm(keys, device=DEV),
                          capture=("comb_build", f"prewarm {label}")
                          if label != "2,048" else ())
    wall_s = time.perf_counter() - t
    prewarm15[label] = dict(
        built=ok, wall_s=wall_s, launches=got,
        card_bytes=torch.cuda.memory_allocated(DEV) - mem0,
        charged_bytes=E._table_cache.total_bytes,
        ledger_bytes=devobs.ledger_report().get("table_cache", {})
        .get("bytes"))
    log(phase=15, prewarm=label, **prewarm15[label])
declined15 = rt15.metrics.msm_route.value(path="comb", outcome="declined")
check(prewarm15["150"]["built"] and prewarm15["1,024"]["built"]
      and not prewarm15["2,048"]["built"] and declined15 == 1,
      f"prewarms: {prewarm15}, declined {declined15}")
check(prewarm15["1,024"]["charged_bytes"] == (256 + 1024) * 202_752
      == prewarm15["1,024"]["ledger_bytes"]
      and prewarm15["150"]["card_bytes"] >= 256 * cc.TABLE_BYTES_PER_KEY,
      f"table bytes: {prewarm15}")
comb15["prewarm"] = prewarm15
# the prewarms' C1 launches (the main path's) against the plain version on
# the same padded keys
for label, args, (tab_, ok_) in captured["comb_build"]:
    ptab_, pok_ = cc.comb_build_plain(args[0])
    row = (label, args[0].shape[0], cc.tables_mismatch(tab_, ptab_)
           + int((ok_ != pok_).sum()))
    comb15["c1_vs_plain"].append(row)
    log(phase=15, c1_vs_plain=row)
    cmp15.append(row)
check(len(cmp15) == 5 and all(r[2] == 0 for r in cmp15),
      f"C1 on the prewarms differs from plain: {cmp15}")

# the 150-validator commit of the prewarmed set through verify_commit: the
# comb, C2 launched and K1 not; with one bad signature its error names the
# lane, and its bitmap (the bulk lane on the set's key matrix) is the
# ladder's (the comb off)
_, c15a = main_path(lambda: vset150.verify_commit(CHAIN, bid150, 9, commit150,
                                                  device=DEV),
                    site="bulk.ed25519")
rec15 = dict(E.last_launch())
check(rec15["path"] == "comb" and rec15["nb"] == 256
      and rec15["group_ops"] == {"doublings": 0, "adds": 128}
      and c15a["comb_verify"] == 1 and c15a["verify_packed"] == 0,
      f"prewarmed 150-validator commit: {rec15}, {c15a}")
orig15 = commit150.signatures[bad_i].signature
commit150.signatures[bad_i].signature = corrupt(orig15, rng)
err15, c15b = main_path(lambda: commit_error_index(vset150, bid150,
                                                   commit150),
                        capture=("comb_verify", "150-validator commit"),
                        site="bulk.ed25519")
mat150 = vset150._pub_matrix()[0]
msgs150 = commit_sign_bytes_batch(CHAIN, commit150, list(range(150)))
sig150 = [cs.signature for cs in commit150.signatures]
bits_comb, _ = main_path(lambda: cbatch.verify_sigs_bulk(
    mat150, msgs150, sig150, device=DEV), site="bulk.ed25519")
E.set_comb_config(enabled=False)
bits_ladder, c15c = main_path(lambda: cbatch.verify_sigs_bulk(
    mat150, msgs150, sig150, device=DEV), site="bulk.ed25519")
E.set_comb_config(enabled=True)
commit150.signatures[bad_i].signature = orig15
log(phase=15, validators=150, launches=c15a, launches_bad=c15b,
    record=rec15, error=err15, ladder_launches=c15c)
check(err15 is not None and f"(#{bad_i})" in err15, f"bad index: {err15}")
check(np.array_equal(bits_comb, bits_ladder)
      and np.array_equal(bits_comb, expect4) and c15c["verify_packed"] == 1
      and c15c["comb_verify"] == 0, "150-validator comb bitmap != ladder's")

# 65,536 triples over the 1,024-key set through BatchVerifier: one C2
# launch at MAX_CHUNK lanes; 1 in 1,000 corrupted
n15 = E.MAX_CHUNK
idx15 = [i % 1024 for i in range(n15)]
msgs15 = [rng.randbytes(64) for _ in range(n15)]
sigs15 = sign_batch([a1k[j] for j in idx15], [keys1k[j] for j in idx15],
                    msgs15, rng)
bad15 = set(rng.sample(range(n15), 66))
sigs15 = [corrupt(s, rng) if i in bad15 else s for i, s in enumerate(sigs15)]
pk1k = [edkeys.PubKey(p) for p in keys1k]
cbatch.verified_sigs = cbatch.SigCache()
bv = cbatch.BatchVerifier(device=DEV)
for i in range(n15):
    bv.add(pk1k[idx15[i]], msgs15[i], sigs15[i])
(ok15, bits15), c15d = main_path(
    bv.verify, capture=("comb_verify", "65,536 over 1,024 keys"),
    site="batch.ed25519")
rec15d = dict(E.last_launch())
expect15 = np.ones(n15, dtype=bool)
expect15[list(bad15)] = False
log(phase=15, triples=n15, launches=c15d, record=rec15d,
    mismatches=int((bits15 != expect15).sum()))
check(rec15d["path"] == "comb" and rec15d["nb"] == n15
      and c15d["comb_verify"] == 1 and c15d["verify_packed"] == 0
      and np.array_equal(bits15, expect15), f"65,536 comb batch: {rec15d}")

# a batch with one key outside the set falls to K1
mix_p = keys1k[:255] + [vp150[0]]
mix_m = msgs15[:255] + [b"outside"]
mix_s = sigs15[:255] + [sig100k[0]]
bits_mix, c15e = main_path(lambda: E.verify_batch(mix_p, mix_m, mix_s,
                                                  device=DEV))
check(E.last_launch()["path"] == "cuda" and c15e["verify_packed"] == 1
      and c15e["comb_verify"] == 0, f"mixed keys: {c15e}")

# C2 against its plain version on the captured launches, and on the
# phase-3 vectors (tables built on the card for their keys) beside K1 and
# the oracle, at every G
# a set's table rows follow its distinct keys in np.unique's order, which
# is the keys' bytes sorted
SET_KEYS = {"150-validator commit": vp150, "65,536 over 1,024 keys": keys1k}


def plain_tables(keys):
    """The plain C1 of a set as the table cache builds it."""
    uniq = sorted(set(keys))
    return cc.comb_build_plain(u8(uniq + [bytes(32)] * (
        E._comb_k_pad(len(uniq)) - len(uniq)), 32))


def k1_on_rows(rows, keys):
    """K1's raw bitmap and the host's s < L screen on the triples of C2's
    rows, their keys found by table row among a set's sorted keys."""
    r = rows.cpu().numpy()
    uniq = np.frombuffer(b"".join(sorted(set(keys))), np.uint8).reshape(-1,
                                                                        32)
    v = r[:, 96:100].copy().view("<i4").reshape(-1)
    packed = np.ascontiguousarray(np.concatenate(
        [uniq[np.clip(v, 0, len(uniq) - 1)].T, r[:, :96].T]))
    k1 = REAL["verify_packed"](torch.from_numpy(packed).to(DEV))
    return k1.cpu().numpy(), E._s_canonical(np.ascontiguousarray(
        r[:, 32:64]))


def c2_row(label, got, plain):
    return (label, len(got), int((got != plain).sum()),
            float(np.abs(got.astype(int) - plain.astype(int)).max()))


c2_cmp, c2_vs_k1 = [], 0
cap = {label: (args, out) for label, args, out in captured["comb_verify"]}
plain_cap = {}
for label, (args, out) in cap.items():
    ptab, pok = plain_tables(SET_KEYS[label])
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain_cap[label] = cc.comb_verify_plain(args[0], ptab, pok).cpu().numpy()
    torch.cuda.synchronize()
    times[f"plain_c2_{args[0].shape[0]}_ms"] = 1e3 * (time.perf_counter()
                                                       - t)
    c2_cmp.append(c2_row(f"{label}, G {cc.groups_for(args[0].shape[0])}",
                         out.cpu().numpy(), plain_cap[label]))
# the phase-3 vectors, and s with extreme digits (0, L - 1, 2^252, every
# digit 7 but the top one, every byte 0x88, 2^256 - 1: the last two are
# screened on the host, C2 still computes their raw verdicts)
vec15 = list(zip(vec_p, vec_m, vec_s)) + [
    (p0, m0, s0[:32] + v.to_bytes(32, "little")) for v in (
        0, L - 1, 1 << 252, int("7" * 63, 16),
        int.from_bytes(b"\x88" * 32, "little"), (1 << 256) - 1)]
p15v, m15v, s15v = (list(c) for c in zip(*vec15))
oracle15v = np.array([_edref.verify(p, m, s) for p, m, s in vec15])
vk = sorted(set(p15v))
vidx3 = np.array([vk.index(p) for p in p15v], dtype=np.int32)
tab3, ok3c = REAL["comb_build"](u8(vk + [bytes(32)] * (
    E._comb_k_pad(len(vk)) - len(vk)), 32))
ptab3, pok3 = plain_tables(p15v)
_, r3, s3_, k3_, hok3 = E._stage_rows(p15v, s15v, m15v)
rows3 = torch.from_numpy(cc.pack_rows(r3, s3_, k3_, vidx3)).to(DEV)
c2v_plain = cc.comb_verify_plain(rows3, ptab3, pok3).cpu().numpy()
pk3, hk3 = E.prepare_batch_packed(p15v, s15v, m15v)
k1v = REAL["verify_packed"](torch.from_numpy(pk3.view(np.uint8)).to(DEV)
                            ).cpu().numpy()
check(np.array_equal(k1v & hk3, oracle15v) and np.array_equal(hk3, hok3),
      "K1 on the phase-15 vectors != the oracle")
for G in cc.GROUPS:
    c2v = REAL["comb_verify"](rows3, tab3, ok3c, G).cpu().numpy()
    c2_cmp.append(c2_row(f"phase-3 vectors + extreme s, G {G}", c2v,
                         c2v_plain))
    c2_vs_k1 += int(((c2v & hok3) != (k1v & hk3)).sum())

# times (CUDA events): C1 at 150 (k_pad 256) and 1,024 keys; C2 at the
# 150-validator launch (256 lanes) and at 64 to 65,536 lanes (the batch's
# launch and its first rows), at each G and at the wrapper's; every launch
# held against the plain version, K1 and the expected bitmap on the same
# triples; each beside its bound
pub150 = u8(vp150 + [bytes(32)] * 106, 32)
pub1k = u8(keys1k, 32)
pub4k = u8(keys4k, 32)
# C1 at the 150-validator set (k_pad 256), 1,024 and 4,096 keys, beside
# its bound and the first design's time (PERF.md, PR 11, call 3; none at
# 4,096)
C1_PR11_MS = {"150": 1.587, "1024": 1.711, "4096": None}
for label, pub_, keys_, iters in (("150", pub150, 256, 10),
                                  ("1024", pub1k, 1024, 10),
                                  ("4096", pub4k, 4096, 5)):
    times[f"c1_{label}_ms"] = time_events(
        lambda: REAL["comb_build"](pub_), iters)
    times[f"c1_{label}_bound_ms"] = cc.bound_ms_build(keys_)
    log(phase=15, card=CARD, c1_keys=keys_, ms=times[f"c1_{label}_ms"],
        bound_ms=times[f"c1_{label}_bound_ms"],
        bound_by=cc.bound_by_build(keys_), pr11_ms=C1_PR11_MS[label])
torch.cuda.synchronize()
t = time.perf_counter()
cc.comb_build_plain(pub1k)
torch.cuda.synchronize()
times["plain_c1_1024_ms"] = 1e3 * (time.perf_counter() - t)
big, big_out = cap["65,536 over 1,024 keys"]
small, _ = cap["150-validator commit"]
k1_big, hk_big = k1_on_rows(big[0], keys1k)
k1_small, hk_small = k1_on_rows(small[0], vp150)
check(np.array_equal(k1_big & hk_big, expect15)
      and np.array_equal(big_out.cpu().numpy() & hk_big, expect15),
      "K1 or C2 on the 65,536 triples != the expected bitmap")
c2_sizes = {}          # lanes -> (rows, tables, dec_ok, plain, K1, screen)
for lanes in (64, 1024, 2048, 4096, 8192, 16384, 65536):
    c2_sizes[lanes] = (big[0][:lanes].contiguous(), big[1], big[2],
                       plain_cap["65,536 over 1,024 keys"][:lanes],
                       k1_big[:lanes], hk_big[:lanes])
c2_sizes[256] = (*small[:3], plain_cap["150-validator commit"], k1_small,
                 hk_small)
c2_work, c2_grid = {}, {}
for lanes in sorted(c2_sizes):
    rows_, tab_, ok_, plain_, k1_, hk_ = c2_sizes[lanes]
    c2_work[lanes] = work = cc.verify_work(
        *cc.unpack_rows(rows_.cpu().numpy())[1:])
    times[f"c2_{lanes}_bound_ms"] = cc.bound_ms_verify(work)
    for G in cc.GROUPS:
        got = REAL["comb_verify"](rows_, tab_, ok_, G).cpu().numpy()
        c2_cmp.append(c2_row(f"{lanes} lanes, G {G}", got, plain_))
        c2_vs_k1 += int(((got & hk_) != (k1_ & hk_)).sum())
        c2_grid[(lanes, G)] = dict(
            ms=time_events(lambda: REAL["comb_verify"](rows_, tab_, ok_, G),
                           20 if lanes < 65536 else 5),
            design_ms=cc.design_ms_verify(work, G))
        if G == cc.groups_for(lanes):
            times[f"c2_{lanes}_ms"] = c2_grid[(lanes, G)]["ms"]
    best = min(cc.GROUPS, key=lambda g: c2_grid[(lanes, g)]["ms"])
    log(phase=15, c2_lanes=lanes, groups_chosen=cc.groups_for(lanes),
        groups_fastest=best, card=CARD,
        ms={G: round(c2_grid[(lanes, G)]["ms"], 5) for G in cc.GROUPS},
        bound_ms=round(times[f"c2_{lanes}_bound_ms"], 6),
        design_ms={G: round(c2_grid[(lanes, G)]["design_ms"], 5)
                   for G in cc.GROUPS})
log(phase=15, c2_vs_plain=c2_cmp, c2_vs_k1=c2_vs_k1,
    c1_c2_launches_compared=dict(cc.launches))
check(all(c[2] == 0 for c in c2_cmp), f"C2 differs from plain: "
      f"{[c for c in c2_cmp if c[2]]}")
check(c2_vs_k1 == 0, "C2 != K1 behind the host screen")
check(all(np.array_equal(c2_sizes[n][4] & c2_sizes[n][5],
                         expect15[:n]) for n in c2_sizes if n != 256),
      "K1 on the 65,536 rows != the expected bitmap")
comb15.update(c2_vs_plain=c2_cmp, c2_vs_k1=c2_vs_k1,
              c2_grid={f"{n}x{g}": v for (n, g), v in c2_grid.items()})

# walls (host clock): the prewarm of a fresh 1,024-key set; the prewarmed
# 150-validator verify_commit against the same call on the ladder (the
# comb off), 10 each in turns; the 100k commit with the comb on and off,
# 7 each in turns (on: declined early, from its keys' first 8 bytes)
_, keys1k_b = gen_keys(1024, rng)
E.table_cache_clear()
E.prewarm(vp150, device=DEV)
t = time.perf_counter()
check(E.prewarm(keys1k_b, device=DEV), "fresh 1,024-key prewarm declined")
times["prewarm_1024_wall_s"] = time.perf_counter() - t
w15 = {"comb": [], "ladder": []}
w15k = {"on": [], "off": []}
for rnd in range(11):
    for key in (("comb", "ladder") if rnd % 2 else ("ladder", "comb")):
        E.set_comb_config(enabled=key == "comb")
        t = time.perf_counter()
        vset150.verify_commit(CHAIN, bid150, 9, commit150, device=DEV)
        if rnd:
            w15[key].append(time.perf_counter() - t)
        check(E.last_launch()["path"] == ("comb" if key == "comb"
                                          else "cuda"), f"150 wall {key}")
# the comb-on runs decline the 100k set early: no 2-D distinct-key sort
sorts15 = []
_np_unique = np.unique


def _unique_counted(a, *args, **kw):
    if kw.get("axis") is not None:
        sorts15.append(np.shape(a))
    return _np_unique(a, *args, **kw)


np.unique = _unique_counted
for rnd in range(8):
    for key in (("on", "off") if rnd % 2 else ("off", "on")):
        E.set_comb_config(enabled=key == "on")
        t = time.perf_counter()
        vset100k.verify_commit(CHAIN, bid100k, 9, commit100k, device=DEV)
        if rnd:
            w15k[key].append(time.perf_counter() - t)
        check(E.last_launch()["path"] == "cuda-split", "100k wall route")
np.unique = _np_unique
check(not sorts15, f"the 100k commit ran the distinct-key sort: {sorts15}")
E.set_comb_config(enabled=True)
times["verify_commit_150_comb_wall_s"] = pctl(w15["comb"], 0.5)
times["verify_commit_150_ladder_wall_s"] = pctl(w15["ladder"], 0.5)
times["verify_commit_100k_comb_on_wall_s"] = pctl(w15k["on"], 0.5)
times["verify_commit_100k_comb_off_wall_s"] = pctl(w15k["off"], 0.5)
comb15.update(walls_150_s=w15, walls_100k_s=w15k, work=c2_work,
              declined=rt15.metrics.msm_route.value(path="comb",
                                                    outcome="declined"))
log(phase=15, card=CARD, **{k: v for k, v in times.items()
                            if "c1_" in k or "c2_" in k or "prewarm" in k
                            or "comb" in k or "ladder" in k})
for s_ in ("bulk.ed25519", "batch.ed25519"):
    runtime_clean("phase 15", s_)
staging_clear(15)
E.table_cache_clear()
check(devobs.ledger_report().get("table_cache", {}).get("bytes") == 0,
      "phase 15: the table_cache pool is not back to 0")
REPORT["comb"] = comb15

# -- phase 16: votes to a commit ----------------------------------------------

# The consumer of the types: votes signed for a block, pre-verified on the
# card in one coalesced launch (consensus/state.py's receive loop), added to
# a VoteSet that finds every valid one in the verified-signature cache, and
# the commit it makes verified on the card.
SIZES16 = (150, 10_000)
votes16: dict = {}
# each comparison as in the kernels line: (input, lanes, mismatching lanes,
# max |kernel - plain|)
cmp16 = {name: [] for name in ("verify_packed", "verify_packed_split",
                               "comb_build", "comb_verify")}
c2_vs_k1_16 = 0
# the main path's K1 and K2 launches are kept again (their wrappers are
# bare since phase 6's timings; phase 13 kept K1's the same way)
for _name in ("verify_packed", "verify_packed_split"):
    setattr(ck, _name, _recording(_name))


def block16(vset, height: int, txs, last_bid, last_commit):
    """A block of the set at `height` carrying `last_commit`, its derived
    hashes filled in and validated."""
    b = tblock.Block(
        header=tblock.Header(
            chain_id=CHAIN, height=height,
            time=Timestamp(1700000000 + height, 0), last_block_id=last_bid,
            validators_hash=vset.hash(), next_validators_hash=vset.hash(),
            consensus_hash=tparams.ConsensusParams().hash(),
            app_hash=bytes(8),
            proposer_address=vset.get_proposer().address),
        data=tblock.Data(txs=txs), last_commit=last_commit)
    b.fill_header()
    b.validate_basic()
    return b


def oracle16(items, bad, rng):
    """The oracle's verdicts by lane: OpenSSL on every triple where the
    cryptography package is installed, else the pure-Python verify on the
    corrupted and conflicting triples and 64 others."""
    if edkeys._HAVE_OSSL:
        return "openssl", {j: edkeys._ossl_verify(p.bytes(), m, s)
                           for j, (p, m, s) in enumerate(items)}
    lanes = set(bad) | {len(items) - 1} | set(rng.sample(range(len(items)),
                                                         64))
    return "_edref", {j: _edref.verify(items[j][0].bytes(), items[j][1],
                                       items[j][2]) for j in sorted(lanes)}


class EventCounter:
    """A subscriber thread: drains the bus's vote, block and tx
    subscriptions as consensus's event consumers do, and counts them."""

    def __init__(self, bus):
        self.subs = {k: bus.subscribe(k) for k in (
            tbus.EVENT_VOTE, tbus.EVENT_NEW_BLOCK, tbus.EVENT_TX)}
        self.counts = {k: 0 for k in self.subs}
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run,
                                       name="event-bus-subscriber")
        self.thread.start()

    def _drain(self) -> int:
        got = 0
        for k, sub in self.subs.items():
            while True:
                try:
                    sub.queue.get_nowait()
                except QueueEmpty:
                    break
                self.counts[k] += 1
                got += 1
        return got

    def _run(self):
        while not self.done.is_set():
            if not self._drain():
                time.sleep(0.001)
        self._drain()

    def close(self) -> dict:
        self.done.set()
        self.thread.join(timeout=10)
        check(not self.thread.is_alive(), "phase 16: the subscriber hangs")
        return self.counts


def votes_to_commit(n: int) -> dict:
    global c2_vs_k1_16
    rng = random.Random(SEED + 1600 + n)
    walls: dict = {}
    row: dict = {"validators": n, "walls_s": walls}
    # 1. genesis, through its JSON
    a_list, pubs = gen_keys(n, rng)
    a_of = dict(zip(pubs, a_list))
    gdoc = tgen.GenesisDoc(
        chain_id=CHAIN, genesis_time=Timestamp(1700000000, 0),
        validators=[tgen.GenesisValidator(
            address=b"", pub_key_type="ed25519", pub_key_bytes=p, power=10,
            name=f"v{i}") for i, p in enumerate(pubs)])
    gdoc.validate_and_complete()
    t = time.perf_counter()
    gback = tgen.GenesisDoc.from_json(gdoc.to_json())
    walls["genesis_json"] = time.perf_counter() - t
    check(gback.chain_id == CHAIN and gback.genesis_time == gdoc.genesis_time
          and [(v.address, v.pub_key_bytes, v.power) for v in gback.validators]
          == [(v.address, v.pub_key_bytes, v.power) for v in gdoc.validators],
          f"phase 16 ({n}): the genesis doc's JSON round trip")
    vset = gback.validator_set()
    vp = [v.pub_key.bytes() for v in vset.validators]
    va = [a_of[p] for p in vp]
    # 2. the block at height 2: 300 small txs and a signed height-1 commit
    bid1 = BlockID(b"\x31" * 32, PartSetHeader(1, b"\x32" * 32))
    sigs1 = [CommitSig(BlockIDFlag.COMMIT, v.address,
                       Timestamp(1700000001, i))
             for i, v in enumerate(vset.validators)]
    commit1 = Commit(1, 0, bid1, sigs1)
    for cs, sig in zip(sigs1, sign_batch(va, vp, commit_sign_bytes_batch(
            CHAIN, commit1, list(range(n))), rng)):
        cs.signature = sig
    txs2 = [rng.randbytes(rng.randrange(16, 256)) for _ in range(300)]
    block2 = block16(vset, 2, txs2, bid1, commit1)
    t = time.perf_counter()
    parts2 = tparts.make_block_parts(block2)
    walls["part_set"] = time.perf_counter() - t
    check(isinstance(parts2, tparts.StreamingPartSet)
          and parts2.assemble() == block2.proto(),
          f"phase 16 ({n}): the block's part set")
    bid2 = BlockID(block2.hash(), parts2.header())
    # 3. a precommit from every validator; 4. the corrupted and the
    # conflicting ones; every vote through its wire encoding
    votes = [tvote.Vote(SignedMsgType.PRECOMMIT, 2, 0, bid2,
                        Timestamp(1700000002, 1000 + 7 * i), v.address, i)
             for i, v in enumerate(vset.validators)]
    for v, sig in zip(votes, sign_batch(
            va, vp, [v.sign_bytes(CHAIN) for v in votes], rng)):
        v.signature = sig
    n_bad = max(2, n // 1000)
    bad = sorted(rng.sample(range(n), n_bad))
    for i in bad:
        votes[i].signature = corrupt(votes[i].signature, rng)
    ci = rng.choice([i for i in range(n) if i not in bad])
    cv = tvote.Vote(SignedMsgType.PRECOMMIT, 2, 0,
                    BlockID(b"\x33" * 32, PartSetHeader(1, b"\x34" * 32)),
                    Timestamp(1700000002, 3), vset.validators[ci].address, ci)
    cv.signature = sign_batch([va[ci]], [vp[ci]], [cv.sign_bytes(CHAIN)],
                              rng)[0]
    t = time.perf_counter()
    votes = [tvote.Vote.from_proto(v.proto()) for v in votes + [cv]]
    walls["votes_wire"] = time.perf_counter() - t
    # 5. the pre-verify: every triple, one CONSENSUS submission with a 5 ms
    # deadline, through a scheduler on the card with the node's defaults
    items = [(vset.validators[v.validator_index].pub_key,
              v.sign_bytes(CHAIN), v.signature) for v in votes]
    expect = np.ones(n + 1, dtype=bool)
    expect[bad] = False
    kind, oracle = oracle16(items, bad, rng)
    check(all(oracle[j] == expect[j] for j in oracle),
          f"phase 16 ({n}): the oracle disagrees with the corruptions")
    cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 16)
    m16 = degrade.runtime().metrics
    miss0 = m16.sched_deadline_miss.value(priority="consensus")
    sch = vsched.install(vsched.VerifyScheduler(
        window_s=0.002, max_batch=8192, max_pending=65536,
        tpu_threshold=32, device=DEV))
    sch.start()
    t = time.perf_counter()
    (all_ok, bits), c_pre = main_path(
        lambda: vsched.verify_items(items, vsched.Priority.CONSENSUS,
                                    deadline=time.monotonic() + 0.005,
                                    device=DEV),
        capture=("verify_packed", f"{n}-validator pre-verify"),
        site="sched.ed25519")
    walls["preverify"] = time.perf_counter() - t
    rec_pre = dict(E.last_launch())
    sch.stop()
    vsched.uninstall(sch)
    st = sch.stats()
    row["scheduler"] = {k: st[k] for k in ("launches", "lanes",
                                           "cache_hits", "dedup",
                                           "exec_faults", "stage_s",
                                           "exec_busy_s")}
    row["deadline_misses"] = (m16.sched_deadline_miss.value(
        priority="consensus") - miss0)
    row.update(oracle=kind, oracle_lanes=len(oracle), bad=bad,
               conflicting=ci, preverify_launches=c_pre, record=rec_pre)
    check(np.array_equal(bits, expect) and not all_ok,
          f"phase 16 ({n}): pre-verify bitmap != the oracle's")
    check(c_pre["verify_packed"] == st["launches"] == 1
          and st["lanes"] == n + 1 and st["exec_faults"] == 0
          and rec_pre["path"] == "cuda",
          f"phase 16 ({n}): pre-verify launches {c_pre}, {st}, {rec_pre}")
    cmp16["verify_packed"].append(plain_on_captured("verify_packed", expect))
    # 6. the VoteSet, counting the host verifies its add_vote calls make
    bus = tbus.EventBus()
    events = EventCounter(bus)
    vote_set = tvset.VoteSet(CHAIN, 2, 0, SignedMsgType.PRECOMMIT, vset)
    real_verify = edkeys.PubKey.verify_signature
    host_verifies = [0]

    def counted(self, msg, sig):
        host_verifies[0] += 1
        return real_verify(self, msg, sig)

    errors = {}
    hits0 = cbatch.verified_sigs.hits
    edkeys.PubKey.verify_signature = counted
    t = time.perf_counter()
    try:
        for j, v in enumerate(votes):
            try:
                if vote_set.add_vote(v):
                    bus.publish_vote(v)
            except tvset.VoteSetError as e:   # checked just below
                errors[j] = e
    finally:
        edkeys.PubKey.verify_signature = real_verify
    walls["add_vote"] = time.perf_counter() - t
    row.update(host_verifies=host_verifies[0],
               cache_hits=cbatch.verified_sigs.hits - hits0,
               errors={j: f"{type(e).__name__}: {e}"
                       for j, e in errors.items()})
    check(host_verifies[0] == n_bad,
          f"phase 16 ({n}): {host_verifies[0]} host verifies, {n_bad} "
          f"corrupted votes")
    check(row["cache_hits"] == n - n_bad + 1,
          f"phase 16 ({n}): {row['cache_hits']} cache hits")
    check(sorted(errors) == bad + [n]
          and all(type(errors[i]) is tvset.VoteSetError
                  and "invalid signature" in str(errors[i]) for i in bad)
          and isinstance(errors[n], tvset.ConflictingVoteError)
          and errors[n].vote_b is votes[n],
          f"phase 16 ({n}): add_vote errors {row['errors']}")
    conflict = errors[n]
    ev = tev.DuplicateVoteEvidence.from_votes(
        conflict.vote_a, conflict.vote_b, block2.header.time, vset)
    ev.validate_basic()
    ev_back = tev.evidence_from_proto(tev.evidence_proto(ev))
    check(isinstance(ev_back, tev.DuplicateVoteEvidence)
          and ev_back.hash() == ev.hash()
          and ev.validator_power == 10 and ev.total_voting_power == 10 * n,
          f"phase 16 ({n}): duplicate-vote evidence")
    check(vote_set.two_thirds_majority() == (bid2, True),
          f"phase 16 ({n}): two_thirds_majority")
    # 7. the commit, its light block, and verify_commit on the card
    t = time.perf_counter()
    commit = vote_set.make_commit()
    walls["make_commit"] = time.perf_counter() - t
    flags = [cs.block_id_flag for cs in commit.signatures]
    check(commit.height == 2 and commit.block_id == bid2
          and flags.count(BlockIDFlag.COMMIT) == n - n_bad
          and flags.count(BlockIDFlag.ABSENT) == n_bad,
          f"phase 16 ({n}): the made commit")
    light = tlight.LightBlock(tlight.SignedHeader(block2.header, commit),
                              vset)
    light.validate_basic(CHAIN)
    expect_c = np.ones(n - n_bad, dtype=bool)

    def verify():
        vset.verify_commit(CHAIN, bid2, 2, commit, device=DEV)

    if n < E.PUB_CACHE_MIN:
        t = time.perf_counter()
        _, c = main_path(verify, capture=("verify_packed",
                                          f"{n}-validator made commit"),
                         site="bulk.ed25519")
        walls["verify_commit_ladder"] = time.perf_counter() - t
        rec = dict(E.last_launch())
        check(rec["path"] == "cuda" and c["verify_packed"] == 1
              and c["comb_verify"] == 0,
              f"phase 16 ({n}): ladder verify_commit {rec}, {c}")
        cmp16["verify_packed"].append(plain_on_captured("verify_packed",
                                                        expect_c))
        k1_bits = captured["verify_packed"][-1][2].cpu().numpy()
        t = time.perf_counter()
        built, c = main_path(lambda: E.prewarm(vp, device=DEV),
                             capture=("comb_build", f"prewarm {n}"))
        walls["prewarm"] = time.perf_counter() - t
        check(built and c["comb_build"] >= 1,
              f"phase 16 ({n}): prewarm {built}, {c}")
        label, args, (tab_, ok_) = captured["comb_build"][-1]
        ptab_, pok_ = cc.comb_build_plain(args[0])
        cmp16["comb_build"].append(
            (label, args[0].shape[0], cc.tables_mismatch(tab_, ptab_)
             + int((ok_ != pok_).sum())))
        t = time.perf_counter()
        _, c = main_path(verify, capture=("comb_verify",
                                          f"{n}-validator made commit"),
                         site="bulk.ed25519")
        walls["verify_commit_comb"] = time.perf_counter() - t
        rec = dict(E.last_launch())
        check(rec["path"] == "comb" and c["comb_verify"] == 1
              and c["verify_packed"] == 0,
              f"phase 16 ({n}): prewarmed verify_commit {rec}, {c}")
        label, args, out = captured["comb_verify"][-1]
        ptab, pok = plain_tables(vp)
        c2_got = out.cpu().numpy()
        cmp16["comb_verify"].append(c2_row(
            f"{label}, G {cc.groups_for(args[0].shape[0])}", c2_got,
            cc.comb_verify_plain(args[0], ptab, pok).cpu().numpy()))
        k1_rows, canon = k1_on_rows(args[0], vp)
        m = n - n_bad
        c2_vs_k1_16 += int(((c2_got & canon) != (k1_rows & canon)).sum()) \
            + int((c2_got[:m] != k1_bits[:m]).sum())
        check(c2_got[:m].all() and not c2_got[m:].any()
              and c2_vs_k1_16 == 0,
              f"phase 16 ({n}): C2 against K1 on the made commit")
        E.table_cache_clear()
    else:
        hits0 = E._pub_cache.hits
        for k in range(2):
            t = time.perf_counter()
            _, c = main_path(verify, capture=(
                ("verify_packed_split", f"{n}-validator made commit")
                if k == 0 else ()), site="bulk.ed25519")
            walls[f"verify_commit_split_{k}"] = time.perf_counter() - t
            rec = dict(E.last_launch())
            check(rec["path"] == "cuda-split" and c["verify_packed_split"]
                  >= 1 and c["verify_packed"] == 0 and c["comb_verify"] == 0,
                  f"phase 16 ({n}): verify_commit {rec}, {c}")
        row["pub_cache_hits"] = E._pub_cache.hits - hits0
        check(row["pub_cache_hits"] >= 1,
              f"phase 16 ({n}): the second verify_commit missed the pubkey "
              f"cache")
        cmp16["verify_packed_split"].append(
            plain_on_captured("verify_packed_split", expect_c))
    row["verify_commit_record"] = rec
    # 8. the next block: it carries the commit; its parts, decoded as a
    # peer receives them, reassemble to the same block
    txs3 = [rng.randbytes(rng.randrange(16, 256)) for _ in range(200)]
    block3 = block16(vset, 3, txs3, bid2, commit)
    t = time.perf_counter()
    parts3 = tparts.make_block_parts(block3)
    walls["part_set_next"] = time.perf_counter() - t
    peer = tparts.PartSet(parts3.header())
    for part in parts3.iter_parts():
        check(peer.add_part(tparts.Part.from_proto(part.proto())),
              f"phase 16 ({n}): a part of the next block was refused")
    back = tblock.Block.from_proto(peer.assemble())
    check(peer.is_complete() and back.hash() == block3.hash()
          and back.last_commit.hash() == commit.hash()
          and back.proto() == block3.proto(),
          f"phase 16 ({n}): the next block's parts")
    bus.publish_new_block(block3, BlockID(block3.hash(), parts3.header()),
                          SimpleNamespace(deliver_txs=[
                              ResponseDeliverTx() for _ in txs3]))
    row["events"] = events.close()
    check(row["events"] == {tbus.EVENT_VOTE: n - n_bad,
                            tbus.EVENT_NEW_BLOCK: 1,
                            tbus.EVENT_TX: len(txs3)},
          f"phase 16 ({n}): events {row['events']}")
    row.update(parts=(parts2.header().total, parts3.header().total),
               block_bytes=(len(block2.proto()), len(block3.proto())))
    return row


for _n in SIZES16:
    t16 = time.perf_counter()
    votes16[str(_n)] = votes_to_commit(_n)
    votes16[str(_n)]["phase_s"] = time.perf_counter() - t16
    log(phase=16, card=CARD, **votes16[str(_n)])
for _name in ("verify_packed", "verify_packed_split"):
    setattr(ck, _name, REAL[_name])
staging_clear(16)
check(devobs.ledger_report().get("table_cache", {}).get("bytes") == 0,
      "phase 16: the table_cache pool is not back to 0")
REPORT["votes_to_commit"] = votes16

# -- phase 24's processes, started here and read back in phase 24 -------------
# Phase 24 (a)'s 16-validator network (`--network-child`, above) and (b)'s
# e2e runner (`python -m tendermint_tpu_torch.cmd e2e networks/ci.toml
# --device cuda`: 4 validators with kill, pause and restart, a
# state-syncing full node, 2 evidence items) each run as processes of their
# own beside phases 17-23, on cores the smoke's one process leaves idle;
# phase 24 collects them.  (b)'s node processes are read from outside while
# they run (Watch24).  Every process started here belongs to a process group
# of its own, ended at exit whatever the outcome.
HERE24 = os.path.dirname(os.path.abspath(__file__))
root24 = tempfile.mkdtemp(prefix="smoke24_")
man24 = load_manifest(MANIFEST24)
e2e_dir24 = os.path.join(root24, "e2e")
procs24: dict = {}        # name -> (Popen, its log, its start)
ends24: dict = {}         # name -> the perf_counter at its exit


def start24(name, argv):
    """A process of the phase, in a process group of its own, its output
    in the phase's directory; a thread notes when it exits."""
    log_path = os.path.join(root24, f"{name}.out")
    with open(log_path, "w") as f:
        p = subprocess.Popen(argv, cwd=HERE24, stdout=f,
                             stderr=subprocess.STDOUT,
                             start_new_session=True)
    procs24[name] = (p, log_path, time.perf_counter())
    threading.Thread(target=lambda: ends24.__setitem__(
        name, (p.wait(), time.perf_counter())[1]), daemon=True,
        name=f"wait24-{name}").start()


def stop_procs24():
    """Every process of the phase, and every process it started, ends."""
    for p, _, _ in procs24.values():
        try:
            os.killpg(p.pid, 9)
        except OSError:
            pass
        try:
            p.wait(30)
        except subprocess.TimeoutExpired:
            pass


atexit.register(stop_procs24)


check(not failpoints.armed(), "phase 24: a failpoint is armed")
start24("network", [sys.executable, os.path.abspath(__file__),
                    "--network-child", root24])
start24("e2e", [sys.executable, "-m", "tendermint_tpu_torch.cmd", "e2e",
                MANIFEST24, "--device", DEV.type, "--workdir", e2e_dir24])
start24("watch", [sys.executable, os.path.abspath(__file__), "--e2e-watch",
                  root24, str(procs24["e2e"][0].pid)])

# -- phase 17: blocks through the executor ------------------------------------

# The consumer of the storage, ABCI and execution modules: kvstore blocks made
# by State.make_block, saved with their part sets and seen commits in a SQLite
# BlockStore, applied by BlockExecutor.apply_block on its default device (its
# validate_block verifies each last commit on the card: K1, C2 on a prewarmed
# set, K2 at 10,000 validators), the state saved in a SQLite StateStore and
# the blocks' events indexed by an IndexerService, as the node wires them
# (BASELINE config 2, the kvstore localnet; the index in memory, as the
# node's in-memory layout keeps it).  Walls are host-clock, logged and not
# gated.
N17, H17, TXS17 = 150, 60, 1000           # the kvstore localnet
N17_BIG, H17_BIG, TXS17_BIG = 10_000, 6, 100   # MAX_VOTES_COUNT validators
# heights of the cases; a val: tx in block H changes the set that signs
# commit H + 2, which block H + 3 verifies
TAMPER17, PREVERIFIED17, POWER17 = 5, 7, 10
PREWARM17, POWER17_COMB, JOIN17 = 20, 20, 24
SOCKET17 = 10                             # heights replayed over the socket
POWER17_BIG = 2
rng17 = random.Random(SEED + 17)
T17 = time.perf_counter()
# every K1, K2, C1 and C2 launch of the phase: (label, inputs, output)
keep17 = {name: [] for name in ("verify_packed", "verify_packed_split",
                                "comb_build", "comb_verify")}
label17 = [""]
was17 = {name: getattr(KERNEL_MOD[name], name) for name in keep17}


def _keeping17(name):
    """The bare wrapper (REAL), keeping a copy of every launch's tensor
    inputs (C2's tables are the table cache's own C1 output, kept by
    reference) and its output."""
    def wrapper(*args):
        out = REAL[name](*args)
        keep17[name].append((label17[0], [
            a.clone() if isinstance(a, torch.Tensor)
            and not (name == "comb_verify" and i == 1) else a
            for i, a in enumerate(args)], out))
        return out
    return wrapper


for _name in keep17:
    setattr(KERNEL_MOD[_name], _name, _keeping17(_name))

# each step's host wall: {chain: {step: [calls, seconds]}}; the indexer's
# step runs on the IndexerService's thread
steps17: dict = {}
_steps_lock = threading.Lock()
chain17 = [""]


def _timed17(step, fn, chain=None):
    def timed(*a, **k):
        name = chain or chain17[0]
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            dt = time.perf_counter() - t
            with _steps_lock:
                c = steps17.setdefault(name, {}).setdefault(step, [0, 0.0])
                c[0] += 1
                c[1] += dt
    return timed


# the interpreter's garbage collections in the phase: count and seconds by
# generation (a full collection walks every object the process holds)
gc17 = {"n": [0, 0, 0], "s": [0.0, 0.0, 0.0], "t0": 0.0}


def _gc17(stage, info):
    if stage == "start":
        gc17["t0"] = time.perf_counter()
    else:
        g = info["generation"]
        gc17["n"][g] += 1
        gc17["s"][g] += time.perf_counter() - gc17["t0"]


gc.callbacks.append(_gc17)
REAL17 = {"update_state": sexec.update_state,
          "verify_commit": ValidatorSet.verify_commit}
sexec.update_state = _timed17("update_state", REAL17["update_state"])
ValidatorSet.verify_commit = _timed17("verify_commit",
                                      REAL17["verify_commit"])


def txs17(h: int, n: int):
    """n txs of 64 bytes each, k<h>_<i>=<hex>."""
    out = []
    for i in range(n):
        key = b"k%d_%d=" % (h, i)
        out.append(key + rng17.randbytes(32).hex().encode()[:64 - len(key)])
    return out


def val_tx17(pub: bytes, power: int) -> bytes:
    return b"val:" + base64.b64encode(pub) + b"!%d" % power


def sign17(state, bid, h: int, a_of):
    """The commit of height h: a precommit from every validator of the
    height's set, in the set's order, signed over its canonical bytes."""
    vals = state.validators.validators
    sigs = [CommitSig(BlockIDFlag.COMMIT, v.address,
                      Timestamp(1700000000 + h, 500 + i))
            for i, v in enumerate(vals)]
    commit = Commit(h, 0, bid, sigs)
    vp = [v.pub_key.bytes() for v in vals]
    idxs = list(range(len(vals)))
    for cs, sig in zip(sigs, sign_batch([a_of[p] for p in vp], vp,
                                        commit_sign_bytes_batch(
                                            CHAIN, commit, idxs), rng17)):
        cs.signature = sig
    return commit


def flip17(commit):
    """The commit with the first signature's R flipped (a lying peer)."""
    sigs = list(commit.signatures)
    s0 = sigs[0]
    sigs[0] = CommitSig(s0.block_id_flag, s0.validator_address, s0.timestamp,
                        bytes([s0.signature[0] ^ 1]) + s0.signature[1:])
    return Commit(commit.height, commit.round, commit.block_id, sigs)


def expect_raises17(exc, fn, what):
    """fn() must raise exc; returns the exception."""
    try:
        fn()
    except exc as e:
        return e
    fail(f"phase 17: {what} did not raise {exc.__name__}")


def vset_view17(vs):
    if vs is None:
        return None
    return ([(v.address, v.pub_key.bytes(), v.voting_power,
              v.proposer_priority) for v in vs.validators],
            vs.get_proposer().address, vs.hash())


def state_view17(s):
    """A State's fields as comparable values (validator sets by content)."""
    return (s.chain_id, s.initial_height, s.last_block_height,
            s.last_block_id, s.last_block_time, vset_view17(s.next_validators),
            vset_view17(s.validators), vset_view17(s.last_validators),
            s.last_height_validators_changed, s.consensus_params,
            s.last_height_consensus_params_changed, s.last_results_hash,
            s.app_hash, s.app_version)


class Chain17:
    """One node's SQLite stores, app connections, executor and (for the
    localnet) its indexer, from a genesis of seeded keys."""

    def __init__(self, name, gdoc, root, conns, index: bool):
        self.name, self.conns = name, conns
        chain17[0] = name
        self.dir = os.path.join(root, name)
        os.makedirs(self.dir)
        self.open_stores()
        self.bus = tbus.EventBus()
        self.ex = sexec.BlockExecutor(self.state_store, conns.consensus,
                                      event_bus=self.bus,
                                      block_store=self.block_store)
        self.ex.obs_node = name
        for attr, step in (("validate_block", "validate_block"),
                           ("_exec_block_on_app", "abci_calls"),
                           ("_commit", "app_commit"),
                           ("_fire_events", "events")):
            setattr(self.ex, attr, _timed17(step, getattr(self.ex, attr)))
        self.state = state_from_genesis(gdoc)
        self.state_store.save(self.state)
        conns.consensus.init_chain(abci_t.RequestInitChain(
            chain_id=gdoc.chain_id, validators=[
                abci_t.ValidatorUpdate("ed25519", v.pub_key_bytes, v.power)
                for v in gdoc.validators]))
        self.rows: list = []
        self.svc = None
        if index:
            # the node's in-memory index layout: over SQLite (a commit a
            # key) the service falls far behind the chain, and that cost
            # is timed on one block below
            self.ix_db = MemDB()
            self.tx_ix = TxIndexer(self.ix_db)
            self.blk_ix = BlockIndexer(self.ix_db)
            self.tx_ix.index_block_txs = _timed17(
                "indexer", self.tx_ix.index_block_txs, name)
            self.blk_ix.index = _timed17("indexer", self.blk_ix.index, name)
            self.svc = IndexerService(self.tx_ix, self.blk_ix, self.bus)
            self.svc.start()

    def open_stores(self):
        """The node's layout: the block store commits every write, the
        state store defers single writes in windows of 64."""
        self.block_db = SQLiteDB(os.path.join(self.dir, "blockstore.db"))
        self.state_db = SQLiteDB(os.path.join(self.dir, "state.db"),
                                 commit_every=64)
        self.block_store = BlockStore(self.block_db)
        self.state_store = StateStore(self.state_db)
        self.state_store.save_abci_responses = _timed17(
            "save_abci_responses", self.state_store.save_abci_responses)
        self.state_store.save = _timed17("state_store_save",
                                         self.state_store.save)

    def make(self, h, txs, last_commit):
        block = self.state.make_block(
            h, txs, last_commit, [],
            self.state.validators.get_proposer().address,
            block_time=Timestamp(1700000000 + h, 0))
        parts = tparts.make_block_parts(block)
        return block, parts, BlockID(block.hash(), parts.header())

    def try_apply(self, block, bid, what, site, refused=None):
        """apply_block on the main path (launch counts zeroed just before
        and read just after).  Returns (the new state, or the exception of
        class `refused` it must raise; the counts; the launch record)."""
        chain17[0] = self.name
        label17[0] = f"{self.name} h{block.header.height} ({what})"
        seq0 = E.last_launch()["seq"]

        def run():
            if refused is None:
                return self.ex.apply_block(self.state, bid, block)[0]
            return expect_raises17(refused, lambda: self.ex.apply_block(
                self.state, bid, block), what)
        out, c = main_path(run, site=site)
        rec = dict(E.last_launch())
        return out, c, rec if rec["seq"] != seq0 else {}

    def apply(self, block, bid, what="block"):
        """Save the block with its parts and seen commit, as the node does
        before it applies it, then apply it; the state advances."""
        h = block.header.height
        gc0 = sum(gc17["s"])
        t = time.perf_counter()
        site = None if h == 1 or what == "pre-verified" else "bulk.ed25519"
        state, c, rec = self.try_apply(block, bid, what, site)
        wall = time.perf_counter() - t
        route = ("K1" if c["verify_packed"] else "K2"
                 if c["verify_packed_split"] else "C2"
                 if c["comb_verify"] else "none")
        check(sum(c.values()) == (0 if route == "none" else 1)
              and state.last_block_height == h
              and (route == "none") == (site is None),
              f"phase 17: {label17[0]} launched {c}")
        self.rows.append({"height": h, "what": what, "route": route,
                          "wall_s": wall, "gc_s": sum(gc17["s"]) - gc0,
                          "stage_s": rec.get("stage_s"),
                          "compute_s": rec.get("compute_s"),
                          "path": rec.get("path"),
                          "app_hash": state.app_hash.hex(),
                          "results_hash": state.last_results_hash.hex(),
                          "validators_hash": state.validators.hash().hex()})
        self.state = state
        return route

    def save(self, block, parts, seen):
        chain17[0] = self.name
        _timed17("block_store_save", self.block_store.save_block)(
            block, parts, seen)

    def close(self):
        if self.svc is not None:
            self.svc.stop()
            self.ix_db.close()
            self.svc = None
        self.block_db.close()
        self.state_db.close()


def chain_keys17(n: int):
    """n + 1 seeded keys: a genesis of the first n at power 10, and one
    that joins later."""
    a_list, pubs = gen_keys(n + 1, rng17)
    gdoc = tgen.GenesisDoc(
        chain_id=CHAIN, genesis_time=Timestamp(1700000000, 0),
        validators=[tgen.GenesisValidator(
            address=b"", pub_key_type="ed25519", pub_key_bytes=p, power=10,
            name=f"v{i}") for i, p in enumerate(pubs[:n])])
    gdoc.validate_and_complete()
    return gdoc, dict(zip(pubs, a_list)), pubs


def oracle_bits17(commit, vset):
    """OpenSSL's verdict on every signature of a full commit, in the set's
    order (the lanes' order)."""
    msgs = commit_sign_bytes_batch(CHAIN, commit,
                                   list(range(len(vset.validators))))
    return np.array([edkeys._ossl_verify(v.pub_key.bytes(), m, cs.signature)
                     for v, m, cs in zip(vset.validators, msgs,
                                         commit.signatures)], dtype=bool)


check(edkeys._HAVE_OSSL, "phase 17: the cryptography package (OpenSSL) is "
      "missing, and the commits' bitmaps are held against OpenSSL's")
root17 = tempfile.mkdtemp(prefix="tm17_")
obsv.reset()
stage_apply0 = ConsensusMetrics().height_stage.count(stage="apply")
cases17: dict = {}
oracle17 = []           # (case, kernel, launch index, commit, verifying set)

# -- the 150-validator localnet and its cases
gdoc17, a_of17, pubs17 = chain_keys17(N17)
app17 = KVStoreApplication()
ch = Chain17("localnet150", gdoc17, root17,
             AppConns(ClientCreator.local(app17)), index=True)
chain_blocks17 = []     # (block, parts, bid, seen commit), by height
last17 = Commit(0, 0, BlockID(), [])
t150 = time.perf_counter()
for h in range(1, H17 + 1):
    txs = txs17(h, TXS17)
    vals = ch.state.validators.validators
    if h == POWER17:        # a power change: the set reorders
        txs[-1] = val_tx17(vals[3].pub_key.bytes(), 37)
    if h == POWER17_COMB:   # another, inside the prewarmed stretch
        txs[-1] = val_tx17(vals[-1].pub_key.bytes(), 41)
    if h == JOIN17:         # a key joins: the comb's set misses
        txs[-1] = val_tx17(pubs17[N17], 10)
    block, parts, bid = ch.make(h, txs, last17)
    verifier = ch.state.last_validators
    if h == TAMPER17:
        bad, _, bad_bid = ch.make(h, txs, flip17(last17))
        state0 = ch.state
        e, c, _ = ch.try_apply(bad, bad_bid, "tampered last commit",
                               "bulk.ed25519", refused=CommitVerifyError)
        app_h = app17.info(abci_t.RequestInfo()).last_block_height
        check(ch.state is state0
              and ch.state_store.load().last_block_height == h - 1
              and app_h == h - 1 and c["verify_packed"] == 1,
              f"phase 17: the tampered last commit: {e!r}, {c}, app at "
              f"{app_h}")
        cases17["tampered"] = {"height": h, "error": f"{type(e).__name__}: "
                               f"{e}", "launches": c, "app_height": app_h}
        oracle17.append(("tampered", "verify_packed",
                         len(keep17["verify_packed"]) - 1, flip17(last17),
                         verifier))
    if h == PREVERIFIED17:
        # the last commit short of a third of its signatures, marked as
        # verified: no signature is checked, the power still is
        weak = Commit(last17.height, last17.round, last17.block_id,
                      [CommitSig.absent() if i % 3 == 0 else cs
                       for i, cs in enumerate(last17.signatures)])
        wblock, _, wbid = ch.make(h, txs, weak)
        ch.ex.mark_commit_verified(h - 1, weak)
        e, c, _ = ch.try_apply(wblock, wbid, "pre-verified, short of 2/3 "
                               "power", None, refused=CommitVerifyError)
        check(sum(c.values()) == 0 and "voting power" in str(e),
              f"phase 17: the pre-verified short commit: {e!r}, {c}")
        ch.ex.mark_commit_verified(h - 1, last17)
        cases17["preverified"] = {"height": h, "short_error": str(e),
                                  "short_launches": c}
    if h == PREWARM17:
        keys = [v.pub_key.bytes() for v in verifier.validators]
        label17[0] = f"{ch.name} prewarm at h{h}"
        t = time.perf_counter()
        built, c = main_path(lambda: E.prewarm(keys, device=DEV))
        check(built and c["comb_build"] == 1,
              f"phase 17: prewarm {built}, {c}")
        cases17["prewarm"] = {"height": h, "keys": len(keys), "launches": c,
                              "wall_s": time.perf_counter() - t}
        keys_comb17 = keys
    seen = sign17(ch.state, bid, h, a_of17)
    ch.save(block, parts, seen)
    route = ch.apply(block, bid, "pre-verified" if h == PREVERIFIED17
                     else "block")
    if h == 3:
        oracle17.append(("K1", "verify_packed",
                         len(keep17["verify_packed"]) - 1, last17, verifier))
    if h == POWER17_COMB + 3:
        oracle17.append(("C2 after a power change", "comb_verify",
                         len(keep17["comb_verify"]) - 1, last17, verifier))
    chain_blocks17.append((block, parts, bid, seen))
    last17 = seen
wall150 = time.perf_counter() - t150
# the socket replay below verifies its commits on the ladder
E.table_cache_clear()
routes150 = "".join({"K1": "1", "K2": "2", "C2": "c", "none": "."}[r["route"]]
                    for r in ch.rows)
want150 = "".join(
    "." if h in (1, PREVERIFIED17) else
    "c" if PREWARM17 <= h < JOIN17 + 3 else "1" for h in range(1, H17 + 1))
check(routes150 == want150, f"phase 17: routes {routes150} != {want150}")
cases17["power_change"] = {
    "heights": [POWER17, POWER17_COMB], "join": JOIN17,
    "reordered": [r["route"] for r in ch.rows
                  if r["height"] in (POWER17 + 3, POWER17_COMB + 3)],
    "after_join": ch.rows[JOIN17 + 3 - 1]["route"]}
log(phase=17, card=CARD, chain=ch.name, heights=H17, txs=TXS17,
    routes=routes150, wall_s=wall150, blocks_per_s=H17 / wall150,
    txs_per_s=H17 * TXS17 / wall150,
    slowest_applies=sorted(((r["wall_s"], r["gc_s"], r["height"])
                            for r in ch.rows), reverse=True)[:3],
    cases=cases17)


# -- the indexer, drained (with a timeout) before it is queried
last_tx = chain_blocks17[-1][0].data.txs[-1]
end = time.monotonic() + 60
while ch.tx_ix.get(tblock.tx_hash(last_tx)) is None \
        or not ch.blk_ix.search(f"block.height = '{H17}'")["blocks"]:
    check(time.monotonic() < end, "phase 17: the indexer did not drain "
          "in 60 s")
    time.sleep(0.01)
drain17 = time.perf_counter() - t150 - wall150
index17 = {"drain_after_last_apply_s": drain17}
want30 = [tblock.tx_hash(tx).hex().upper()
          for tx in chain_blocks17[29][0].data.txs]
for q in ("tx.height = 30", "tx.height = '30'"):
    t = time.perf_counter()
    got = ch.tx_ix.search(q, per_page=TXS17)
    index17[q] = {"wall_s": time.perf_counter() - t,
                  "total": got["total_count"]}
    check(got["total_count"] == TXS17
          and [r["hash"] for r in got["txs"]] == want30
          and all(r["height"] == 30 for r in got["txs"]),
          f"phase 17: {q!r} found {got['total_count']} txs")
h_get = min(42, H17)
tx7 = chain_blocks17[h_get - 1][0].data.txs[7]
t = time.perf_counter()
got = ch.tx_ix.get(tblock.tx_hash(tx7))
index17["get_wall_s"] = time.perf_counter() - t
check(got is not None and got["height"] == h_get and got["index"] == 7
      and base64.b64decode(got["tx"]) == tx7 and got["tx_result"]["code"]
      == 0, f"phase 17: TxIndexer.get {got}")
# the node's disk layout: block 30's txs indexed into SQLite, a commit for
# each key, with the same search result
sq = SQLiteDB(os.path.join(ch.dir, "tx_index.db"))
t = time.perf_counter()
TxIndexer(sq).index_block_txs(30, chain_blocks17[29][0].data.txs,
                              ch.state_store.load_abci_responses(30)
                              .deliver_txs)
index17["sqlite_block_s"] = time.perf_counter() - t
got = TxIndexer(sq).search("tx.height = '30'", per_page=TXS17)
sq.close()
check([r["hash"] for r in got["txs"]] == want30,
      "phase 17: the SQLite index of block 30")
log(phase=17, card=CARD, indexer=index17)

# -- the socket transport: the same kvstore served by ABCIServer on a unix
# socket, the first heights of the same blocks through ClientCreator.remote
sock_dir = tempfile.mkdtemp(prefix="tm17s_")
sock_path = os.path.join(sock_dir, "app.sock")
if len(sock_path) > 100:    # an AF_UNIX path holds ~107 bytes
    sock_path = os.path.relpath(sock_path)
srv17 = ABCIServer(KVStoreApplication(), f"unix://{sock_path}")
srv17.start()
conns17 = AppConns(ClientCreator.remote(f"unix://{sock_path}"))
sk = Chain17("socket150", gdoc17, root17, conns17, index=False)
t = time.perf_counter()
for block, parts, bid, seen in chain_blocks17[:SOCKET17]:
    sk.save(block, parts, seen)
    sk.apply(block, bid)
wall_sock = time.perf_counter() - t
info17 = conns17.query.info(abci_t.RequestInfo())
conns17.stop()
srv17.stop()
sk.close()
same = [(a["app_hash"], a["results_hash"], a["validators_hash"])
        == (b["app_hash"], b["results_hash"], b["validators_hash"])
        for a, b in zip(sk.rows, ch.rows)]
check(len(sk.rows) == SOCKET17 and all(same)
      and info17.last_block_height == SOCKET17
      and info17.last_block_app_hash.hex() == ch.rows[SOCKET17 - 1][
          "app_hash"],
      f"phase 17: the socket chain's hashes {same}, info {info17}")
socket17 = {"heights": SOCKET17, "wall_s": wall_sock,
            "blocks_per_s": SOCKET17 / wall_sock,
            "txs_per_s": SOCKET17 * TXS17 / wall_sock,
            "routes": [r["route"] for r in sk.rows],
            "app_hashes_equal": sum(same)}
log(phase=17, card=CARD, chain=sk.name, **socket17)

# -- restart (both databases closed and reopened) and rollback
last_state = ch.state
ch.close()
ch.open_stores()
loaded = ch.state_store.load()
check(state_view17(loaded) == state_view17(last_state),
      "phase 17: the reopened state store's State differs from the last "
      "state")
check(ch.block_store.height() == H17 and ch.block_store.base() == 1,
      f"phase 17: the reopened block store at {ch.block_store.height()}")
t = time.perf_counter()
for h in range(1, H17 + 1):
    meta = ch.block_store.load_block_meta(h)
    blk = ch.block_store.load_block(h)
    check(blk.hash() == meta.block_id.hash == chain_blocks17[h - 1][2].hash
          and ch.block_store.load_seen_commit(h).hash()
          == chain_blocks17[h - 1][3].hash(),
          f"phase 17: the stored block at {h}")
reload_s = time.perf_counter() - t
meta60 = ch.block_store.load_block_meta(H17)
rb = rollback(ch.block_store, ch.state_store)
check(rb == (H17 - 1, meta60.header.app_hash)
      and rb[1].hex() == ch.rows[H17 - 2]["app_hash"]
      and ch.state_store.load().last_block_height == H17 - 1,
      f"phase 17: rollback {rb}")
restart17 = {"blocks_reloaded_s": reload_s, "rollback": [rb[0], rb[1].hex()]}
ch.close()
log(phase=17, card=CARD, restart=restart17)

# -- the 10,000-validator chain, with a power change at height 2:
# the commit of height 4 is signed by the reordered set, and block 5
# verifies it on K2 after a pubkey-row cache miss
gdoc_big, a_of_big, _ = chain_keys17(N17_BIG)
big = Chain17(f"chain{N17_BIG}", gdoc_big, root17,
              AppConns(ClientCreator.local(KVStoreApplication())),
              index=False)
last_big = Commit(0, 0, BlockID(), [])
hits_big = []
t_big = time.perf_counter()
for h in range(1, H17_BIG + 1):
    txs = txs17(h, TXS17_BIG)
    if h == POWER17_BIG:
        txs[-1] = val_tx17(
            big.state.validators.validators[5].pub_key.bytes(), 20)
    block, parts, bid = big.make(h, txs, last_big)
    verifier = big.state.last_validators
    seen = sign17(big.state, bid, h, a_of_big)
    big.save(block, parts, seen)
    h0, m0 = E._pub_cache.hits, E._pub_cache.misses
    big.apply(block, bid)
    hits_big.append((E._pub_cache.hits - h0, E._pub_cache.misses - m0))
    if h == POWER17_BIG + 3:
        oracle17.append(("K2 on the reordered set", "verify_packed_split",
                         len(keep17["verify_packed_split"]) - 1, last_big,
                         verifier))
    last_big = seen
wall_big = time.perf_counter() - t_big
big.close()
check([r["route"] for r in big.rows] == ["none"] + ["K2"] * (H17_BIG - 1),
      f"phase 17: the {N17_BIG}-validator routes "
      f"{[r['route'] for r in big.rows]}")
# block 2 meets the set first; blocks 3 and 4 hit; block 5 carries the
# reordered set's commit: a miss; block 6 hits
check(hits_big[1:] == [(0, 1), (1, 0), (1, 0), (0, 1), (1, 0)][:H17_BIG - 1],
      f"phase 17: pubkey-row cache (hits, misses) by height {hits_big}")
big17 = {"heights": H17_BIG, "txs": TXS17_BIG, "wall_s": wall_big,
         "applies_wall_gc_s": [(r["wall_s"], r["gc_s"]) for r in big.rows],
         "blocks_per_s": H17_BIG / wall_big,
         "txs_per_s": H17_BIG * TXS17_BIG / wall_big,
         "pub_cache_hits_misses": hits_big}
log(phase=17, card=CARD, chain=big.name, **big17)

# -- every launch of the phase against its plain version on the same
# inputs (concatenated: each lane's verdict depends on its row alone), and
# commits' bitmaps against OpenSSL's
label17[0] = ""
gc.callbacks.remove(_gc17)
for _name in keep17:
    setattr(KERNEL_MOD[_name], _name, was17[_name])
ValidatorSet.verify_commit = REAL17["verify_commit"]
sexec.update_state = REAL17["update_state"]
cmp17 = {name: [] for name in keep17}
t = time.perf_counter()
for name, plain in (("verify_packed", ck.verify_packed_plain),
                    ("verify_packed_split", ck.verify_packed_split_plain)):
    for chain in (ch.name, sk.name, big.name):
        runs = [(args, out) for label, args, out in keep17[name]
                if label.startswith(chain + " ")]
        if not runs:
            continue
        got = torch.cat([out for _, out in runs]).cpu().numpy()
        want = []
        lanes = sum(out.shape[0] for _, out in runs)
        step = 16_384
        cols = [torch.cat([args[k] for args, _ in runs], dim=1)
                for k in range(len(runs[0][0]))]
        for a in range(0, lanes, step):
            want.append(plain(*[c[:, a:a + step] for c in cols]).cpu())
        want = torch.cat(want).numpy()
        err = np.abs(got.astype(int) - want.astype(int))
        cmp17[name].append((f"phase 17 {chain}: {len(runs)} launches",
                            lanes, int(err.sum()), float(err.max())))
for label, args, (tab, ok) in keep17["comb_build"]:
    ptab, pok = cc.comb_build_plain(args[0])
    cmp17["comb_build"].append(
        (f"phase 17 {label}", args[0].shape[0],
         cc.tables_mismatch(tab, ptab) + int((ok != pok).sum())))
check(len(keep17["comb_build"]) == 1
      and all(args[1] is keep17["comb_build"][0][2][0]
              for _, args, _ in keep17["comb_verify"]),
      "phase 17: a C2 launch on another table than the prewarm's")
ptab, pok = plain_tables(keys_comb17)
rows_c2 = torch.cat([args[0] for _, args, _ in keep17["comb_verify"]])
got = torch.cat([out for _, _, out in keep17["comb_verify"]]).cpu().numpy()
cmp17["comb_verify"].append(c2_row(
    f"phase 17 {ch.name}: {len(keep17['comb_verify'])} launches", got,
    cc.comb_verify_plain(rows_c2, ptab, pok).cpu().numpy()))
plain17_s = time.perf_counter() - t
t = time.perf_counter()
oracle_rows = []
for case, name, i, commit, vset in oracle17:
    bits = oracle_bits17(commit, vset)
    kernel = keep17[name][i][2].cpu().numpy()
    n = len(bits)
    expect = np.ones(n, dtype=bool)
    if case == "tampered":
        expect[0] = False
    oracle_rows.append((case, n, int((kernel[:n] != bits).sum()),
                        int(kernel[n:].sum()), bool((bits == expect).all())))
check(len(oracle_rows) >= 3 and all(r[2] == 0 and r[3] == 0 and r[4]
                                    for r in oracle_rows),
      f"phase 17: kernel bitmaps against OpenSSL's {oracle_rows}")
oracle17_s = time.perf_counter() - t

# -- the observatory: one apply stage for each height applied
obsv.publish_pending()
applied = {c.name: len(c.rows) for c in (ch, sk, big)}
stamped = {c.name: sum(r["stages"].get("apply") is not None
                       for r in obsv.records(c.name)) for c in (ch, sk, big)}
stage_apply = ConsensusMetrics().height_stage.count(stage="apply") \
    - stage_apply0
check(stamped == applied and stage_apply == sum(applied.values()),
      f"phase 17: observatory apply stages {stamped}, {stage_apply}, "
      f"applied {applied}")
E.table_cache_clear()
staging_clear(17)
check(devobs.ledger_report().get("table_cache", {}).get("bytes") == 0,
      "phase 17: the table_cache pool is not back to 0")
shutil.rmtree(sock_dir, ignore_errors=True)
launches17 = {name: len(v) for name, v in keep17.items()}
blocks17 = {
    "chains": {c.name: c.rows for c in (ch, sk, big)},
    "steps_s": steps17, "cases": cases17, "socket": socket17,
    "indexer": index17, "restart": restart17, "big": big17,
    "comparisons": cmp17, "openssl": oracle_rows, "launches": launches17,
    "observatory_apply": stamped, "plain_s": plain17_s,
    "gc": {"collections": gc17["n"], "seconds": gc17["s"]},
    "openssl_s": oracle17_s, "localnet_wall_s": wall150,
    "localnet_blocks_per_s": H17 / wall150,
    "localnet_txs_per_s": H17 * TXS17 / wall150,
    "phase_s": time.perf_counter() - T17}
log(phase=17, card=CARD, steps_s={
    c: {s: [n, round(v, 6)] for s, (n, v) in d.items()}
    for c, d in steps17.items()}, launches=launches17,
    comparisons=cmp17, openssl=oracle_rows, observatory_apply=stamped,
    gc=blocks17["gc"], plain_s=plain17_s, phase_s=blocks17["phase_s"])
check(all(r[2] == 0 for rows in cmp17.values() for r in rows),
      f"phase 17: a kernel disagrees with its plain version: {cmp17}")
REPORT["blocks_through_executor"] = blocks17

# -- phase 18: blocksync replay -----------------------------------------------

# BASELINE config 4 (`BASELINE.md:33`: blocksync fast-sync replay, 50k blocks
# x 150 validators, coalesced batches), its depth cut to 128 heights (two
# windows; 256 before phase 24 came) to keep the smoke inside its time limit.
# A 150-validator kvstore chain of 128 heights of 100 txs, served from a
# BlockStore, is replayed by blocksync.replay_window in windows of 64 (one
# coalesced verify_items a window, on K1); then through a BlockPipeline over
# a VerifyScheduler on the card; bad windows; a prewarmed window (C2); two
# Switches syncing it over TCP on 127.0.0.1 (SecretConnection, MConnection,
# BlocksyncReactor); phase 17's 10,000-validator chain from its block store;
# and launches that fail on the card, which reach the caller as
# WindowDeviceError.  Walls are host-clock, logged and not gated.
N18, H18, TXS18, W18 = 150, 128, 100, 64
BAD18 = 12               # the bad windows' height
# the >2/3 prefix of a commit of N18 equal powers
PREFIX18 = N18 * 10 * 2 // 3 // 10 + 1
T18 = time.perf_counter()
root18 = tempfile.mkdtemp(prefix="tm18_")
# every K1, K2, C1 and C2 launch of the phase: (label, inputs, output)
keep18 = {name: [] for name in ("verify_packed", "verify_packed_split",
                                "comb_build", "comb_verify")}
label18 = [""]
was18 = {name: getattr(KERNEL_MOD[name], name) for name in keep18}


def _keeping18(name):
    """The bare wrapper (REAL), keeping a copy of every launch's tensor
    inputs (C2's tables by reference) and its output."""
    def wrapper(*args):
        out = REAL[name](*args)
        keep18[name].append((label18[0], [
            a.clone() if isinstance(a, torch.Tensor)
            and not (name == "comb_verify" and i == 1) else a
            for i, a in enumerate(args)], out))
        return out
    return wrapper


for _name in keep18:
    setattr(KERNEL_MOD[_name], _name, _keeping18(_name))

# each window's host walls: collect (the structural checks and item
# collection), verify (verify_items; its launch record's stage and device
# time) and apply; the current window's record is win18[0]
win18 = [None]
REAL18 = {"collect": breplay._collect_block_items,
          "apply": breplay._apply_one, "verify_items": vsched.verify_items,
          "light": ValidatorSet.verify_commit_light}
calls18 = {"verify_items": 0, "light": 0}


def _win_timed(key, fn):
    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            w = win18[0]
            if w is not None:
                with _steps_lock:
                    w[key] = w.get(key, 0.0) + time.perf_counter() - t
    return timed


def verify18(items, *a, **k):
    calls18["verify_items"] += 1
    seq0 = E.last_launch()["seq"]
    t = time.perf_counter()
    ok, bits = REAL18["verify_items"](items, *a, **k)
    rec = dict(E.last_launch())
    w = win18[0]
    if w is not None:
        w.setdefault("verifies", []).append({
            "lanes": len(items), "wall_s": time.perf_counter() - t,
            "stage_s": rec.get("stage_s") if rec["seq"] != seq0 else None,
            "compute_s": rec.get("compute_s") if rec["seq"] != seq0
            else None, "path": rec.get("path") if rec["seq"] != seq0
            else None, "all_ok": bool(ok)})
        w.setdefault("batches", []).append((items, bits))
    return ok, bits


def light18(self, *a, **k):
    calls18["light"] += 1
    return REAL18["light"](self, *a, **k)


breplay._collect_block_items = _win_timed("collect_s", REAL18["collect"])
breplay._apply_one = _win_timed("apply_s", REAL18["apply"])
vsched.verify_items = verify18
ValidatorSet.verify_commit_light = light18


def app18(gdoc):
    """A kvstore app past InitChain of the genesis validators, as phase
    17's chains start."""
    app = KVStoreApplication()
    app.init_chain(abci_t.RequestInitChain(
        chain_id=gdoc.chain_id, validators=[
            abci_t.ValidatorUpdate("ed25519", v.pub_key_bytes, v.power)
            for v in gdoc.validators]))
    return app


def build18(n, heights, txs_n, bad_lc=None):
    """A kvstore chain of seeded keys, signed by real precommits: (genesis,
    the served BlockStore holding each block with its parts and seen
    commit, the state after each height, the keys).  bad_lc=(h, idx):
    block h carries its LastCommit with signature idx flipped (a
    proposer that included a bad signature; the chain stays linked).  The
    builder trusts its own signatures (mark_commit_verified): it launches
    nothing."""
    gdoc, a_of, pubs = chain_keys17(n)
    ex = sexec.BlockExecutor(StateStore(MemDB()), app18(gdoc))
    state = state_from_genesis(gdoc)
    store = BlockStore(MemDB())
    last = Commit(0, 0, BlockID(), [])
    states = []
    for h in range(1, heights + 1):
        lc = last
        if bad_lc is not None and h == bad_lc[0]:
            lc = flip_at18(last, bad_lc[1])
        block = state.make_block(h, txs17(h, txs_n), lc, [],
                                 state.validators.get_proposer().address,
                                 block_time=Timestamp(1700000000 + h, 0))
        parts = tparts.make_block_parts(block)
        bid = BlockID(block.hash(), parts.header())
        seen = sign17(state, bid, h, a_of)
        if h > 1:
            ex.mark_commit_verified(h - 1, lc)
        state, _ = ex.apply_block(state, bid, block)
        store.save_block(block, parts, seen)
        states.append(state)
        last = seen
    return gdoc, store, states, pubs[:n]


def flip_at18(commit, idx):
    """The commit with signature idx's R flipped."""
    sigs = list(commit.signatures)
    s = sigs[idx]
    sigs[idx] = CommitSig(s.block_id_flag, s.validator_address, s.timestamp,
                          bytes([s.signature[0] ^ 1]) + s.signature[1:])
    return Commit(commit.height, commit.round, commit.block_id, sigs)


def served18(store, heights):
    """The chain as a peer serves it: the blocks, and each one's certifier
    (the next block's LastCommit; for the last, the seen commit)."""
    blocks = [store.load_block(h) for h in range(1, heights + 1)]
    certs = [blocks[i + 1].last_commit for i in range(heights - 1)] \
        + [store.load_seen_commit(heights)]
    return blocks, certs


def node18(name, gdoc, grouped=False, sqlite=True):
    """A syncing node: fresh block and state stores (SQLite, or MemDB),
    GroupCommitDB-wrapped for the pipeline, and an executor on its default
    device."""
    if sqlite:
        d = os.path.join(root18, name)
        os.makedirs(d)
        bdb = SQLiteDB(os.path.join(d, "blockstore.db"))
        sdb = SQLiteDB(os.path.join(d, "state.db"))
    else:
        bdb, sdb = MemDB(), MemDB()
    inner = (bdb, sdb)
    if grouped:
        bdb, sdb = GroupCommitDB(bdb), GroupCommitDB(sdb)
    ex = sexec.BlockExecutor(StateStore(sdb), app18(gdoc))
    return SimpleNamespace(name=name, ex=ex, store=BlockStore(bdb), bdb=bdb,
                           sdb=sdb, inner=inner,
                           state=state_from_genesis(gdoc))


def window18(node, blocks, certs, site, max_window=W18):
    """One replay_window call from the node's height on the main path
    (launch counts zeroed just before and read just after); the state
    advances.  Returns the window's record."""
    h0 = node.state.last_block_height
    w = {"node": node.name, "from": h0 + 1}
    win18[0] = w
    label18[0] = f"{node.name} w{h0 + 1}"
    t = time.perf_counter()
    try:
        (state, n), c = main_path(lambda: breplay.replay_window(
            node.ex, node.store, node.state, blocks[h0:], certs[h0:],
            max_window=max_window), site=site)
    finally:
        win18[0] = None
    w.update(applied=n, wall_s=time.perf_counter() - t, launches=c)
    node.state = state
    return w


def replay18(node, blocks, certs, site, max_window=W18):
    """Windows until the node holds every block given."""
    rows = []
    t = time.perf_counter()
    while node.state.last_block_height < len(blocks):
        rows.append(window18(node, blocks, certs, site, max_window))
        check(rows[-1]["applied"] > 0, f"phase 18: {node.name} made no "
              f"progress at {node.state.last_block_height}")
    return rows, time.perf_counter() - t


def db_items18(db):
    return list(db.iterate_prefix(b""))


def expect_window_error18(node, blocks, certs, exc):
    """replay_window must raise exc; returns it."""
    label18[0] = f"{node.name} bad"
    win18[0] = w = {"node": node.name, "from": 1}
    try:
        breplay.replay_window(node.ex, node.store, node.state, blocks,
                              certs, max_window=W18)
    except exc as e:
        return e, w
    finally:
        win18[0] = None
    fail(f"phase 18: {node.name} did not raise {exc.__name__}")


def wait18(cond, what, timeout):
    end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < end, f"phase 18: {what}")
        time.sleep(0.005)


def window_view18(rows):
    """The logged part of each window's record."""
    return [{k: v for k, v in r.items() if k != "batches"} for r in rows]


check(not msm.use_rlc(10_000) and not failpoints.armed()
      and vsched.installed() is None and bpipe.installed() is None,
      "phase 18: RLC, a failpoint, a scheduler or a pipeline is still on")
steps18: dict = {}
oracle18 = []        # (window, items, bits, expected bad lanes)

# -- step 1: the chain, at full width
t = time.perf_counter()
gdoc18, srv_store18, states18, keys18 = build18(N18, H18, TXS18)
blocks18, certs18 = served18(srv_store18, H18)
steps18["build_s"] = time.perf_counter() - t
log(phase=18, card=CARD, step="chain", validators=N18, heights=H18,
    txs=TXS18, build_s=steps18["build_s"])

# -- step 2: serial replay (no scheduler, no pipeline), one coalesced
# verify_items a window of 64 on K1
ser18 = node18("serial", gdoc18)
rows_ser, wall_ser = replay18(ser18, blocks18, certs18, "batch.ed25519")
want_lanes = [(W18 - 1) * N18 + PREFIX18] \
    + [W18 * N18 + PREFIX18] * (H18 // W18 - 1)
check([r["applied"] for r in rows_ser] == [W18] * (H18 // W18)
      and [[v["lanes"] for v in r["verifies"]] for r in rows_ser]
      == [[n] for n in want_lanes]
      and all(r["launches"]["verify_packed"] == 1
              and sum(r["launches"].values()) == 1 for r in rows_ser),
      f"phase 18: the serial windows {window_view18(rows_ser)}")
check(state_view17(ser18.state) == state_view17(states18[-1])
      and [ser18.store.load_block(h).hash() for h in range(1, H18 + 1)]
      == [b.hash() for b in blocks18],
      "phase 18: the serial replay's state or stored blocks differ from the "
      "chain's")
for r in rows_ser[:2]:
    oracle18.append((f"serial w{r['from']}", *r["batches"][0], []))
steps18["serial"] = {"wall_s": wall_ser, "blocks_per_s": H18 / wall_ser,
                     "sigs_per_s": sum(want_lanes) / wall_ser,
                     "windows": window_view18(rows_ser)}
log(phase=18, card=CARD, step="serial", wall_s=wall_ser,
    blocks_per_s=H18 / wall_ser, sigs_per_s=sum(want_lanes) / wall_ser,
    windows=[(r["from"], r["applied"], r["verifies"][0]["lanes"],
              round(r.get("collect_s", 0.0), 4),
              round(r["verifies"][0]["wall_s"], 4),
              r["verifies"][0]["stage_s"], r["verifies"][0]["compute_s"],
              round(r.get("apply_s", 0.0), 4)) for r in rows_ser])


# -- step 4 (serial half): bad windows.  "certifier": the certifier of
# height BAD18 as a lying peer hands it, its lane 0 (in the >2/3 prefix)
# flipped; "lastcommit": block BAD18 carries its LastCommit with lane N18-1
# (outside the prefix) flipped, a chain built that way.  Both attribute
# height BAD18 with the heights before it applied
gdoc_bad, store_bad, states_bad, _ = build18(N18, BAD18 + 2, TXS18,
                                             bad_lc=(BAD18, N18 - 1))
blocks_bad, certs_bad = served18(store_bad, BAD18 + 2)
certs_liar = list(certs18[:BAD18 + 2])
certs_liar[BAD18 - 1] = flip_at18(certs_liar[BAD18 - 1], 0)
BAD_CASES18 = {"certifier": (gdoc18, blocks18[:BAD18 + 2], certs_liar,
                             states18),
               "lastcommit": (gdoc_bad, blocks_bad, certs_bad, states_bad)}
bad18 = {}


def bad_case18(case, mode):
    gdoc, blocks, certs, states = BAD_CASES18[case]
    node = node18(f"bad-{case}-{mode}", gdoc, grouped=mode == "pipelined",
                  sqlite=False)
    (e, w), c = main_path(lambda: expect_window_error18(
        node, blocks, certs, breplay.WindowSyncError))
    stored = node.store.height()
    state_h = node.ex.state_store.load().last_block_height
    row = {"height": e.height, "applied": e.applied,
           "state_height": e.state.last_block_height,
           "state_store_height": state_h, "block_store_height": stored,
           "launches": c, "reason": str(e)[:160]}
    check(e.height == BAD18 and e.applied == BAD18 - 1
          and e.state.last_block_height == BAD18 - 1 and state_h == BAD18 - 1
          and e.state.app_hash == states[BAD18 - 2].app_hash
          and stored == (BAD18 - 1 if case == "certifier" else BAD18),
          f"phase 18: the bad window ({case}, {mode}): {row}")
    bad18[f"{case}/{mode}"] = row
    return w


w = bad_case18("certifier", "serial")
# the batch: blocks 2-11's LastCommits (covered certifiers), then the lying
# certifier's prefix: its lane 0 is the batch's lane (BAD18 - 2) * N18
oracle18.append(("bad certifier, serial", *w["batches"][0],
                 [(BAD18 - 2) * N18]))
w = bad_case18("lastcommit", "serial")

# -- step 3: pipelined replay (a VerifyScheduler on the card, a BlockPipeline
# of depth 4 committing groups of 8 heights, GroupCommitDB-wrapped SQLite
# stores); the same state and store contents as step 2
sch18 = start_sched()
prios18 = []
_submit18 = sch18.submit
sch18.submit = lambda items, prio=vsched.Priority.COMMIT, **kw: (
    prios18.append(prio), _submit18(items, prio, **kw))[1]
pipe18 = bpipe.set_config(enable=True, depth=4, group_commit_heights=8)
traced0 = trace.is_enabled()
since18 = trace.last_seq()
trace.enable(capacity=1 << 17)
pip18 = node18("pipelined", gdoc18, grouped=True)
rows_pip, wall_pip = replay18(pip18, blocks18, certs18, "sched.ed25519")
spans18 = trace.snapshot(since=since18)
if not traced0:
    trace.disable()
check(state_view17(pip18.state) == state_view17(ser18.state),
      "phase 18: the pipelined state differs from the serial one")
check(pip18.bdb.pending_ops() == 0 and pip18.sdb.pending_ops() == 0
      and db_items18(pip18.inner[0]) == db_items18(ser18.inner[0])
      and db_items18(pip18.inner[1]) == db_items18(ser18.inner[1]),
      "phase 18: the pipelined stores differ from the serial ones")
span_sum = {}
for s in spans18:
    if s["name"] in ("pipeline.stage", "pipeline.apply", "pipeline.commit"):
        c = span_sum.setdefault(s["name"], [0, 0.0])
        c[0] += 1
        c[1] += s["dur_ns"] / 1e9
launches_pip = sum(r["launches"]["verify_packed"] for r in rows_pip)
check(pipe18.windows_pipelined == H18 // W18 and pipe18.windows_degraded == 0
      and launches_pip > 0
      and span_sum.get("pipeline.stage", [0])[0] == H18
      and span_sum.get("pipeline.apply", [0])[0] == H18
      and set(prios18) == {vsched.Priority.BLOCKSYNC} and len(prios18) == H18,
      f"phase 18: the pipelined windows {pipe18.windows_pipelined}, "
      f"{pipe18.windows_degraded}, K1 {launches_pip}, spans {span_sum}, "
      f"{len(prios18)} submissions")
steps18["pipelined"] = {
    "wall_s": wall_pip, "blocks_per_s": H18 / wall_pip,
    "sigs_per_s": sum(want_lanes) / wall_pip, "spans": span_sum,
    "k1_launches": launches_pip, "submissions": len(prios18),
    "durable_height": pipe18.durable_height(),
    "windows": window_view18(rows_pip)}
log(phase=18, card=CARD, step="pipelined", wall_s=wall_pip,
    blocks_per_s=H18 / wall_pip, k1_launches=launches_pip,
    spans={k: [n, round(v, 4)] for k, (n, v) in span_sum.items()},
    windows=[(r["from"], r["applied"], round(r["wall_s"], 4),
              round(r.get("collect_s", 0.0), 4),
              round(r.get("apply_s", 0.0), 4), r["launches"]["verify_packed"])
             for r in rows_pip])

# -- step 4 (pipelined half)
bad_case18("certifier", "pipelined")
bad_case18("lastcommit", "pipelined")
check(pipe18.windows_degraded == 2,
      f"phase 18: {pipe18.windows_degraded} degraded windows, want the two "
      f"bad ones")
log(phase=18, card=CARD, step="bad windows", cases=bad18)
bpipe.set_config(enable=False)
sch18.stop()
vsched.uninstall(sch18)
steps18["scheduler"] = sch18.stats()
check(steps18["scheduler"]["launches"] > 0
      and steps18["scheduler"]["exec_faults"] == 0,
      f"phase 18: the scheduler's stats {steps18['scheduler']}")

# -- step 5: a prewarmed window takes C2
label18[0] = "prewarm"
t = time.perf_counter()
built18, c = main_path(lambda: E.prewarm(keys18, device=DEV))
check(built18 and c["comb_build"] == 1, f"phase 18: prewarm {built18}, {c}")
prewarm18 = {"keys": len(keys18), "launches": c,
             "wall_s": time.perf_counter() - t}
pw18 = node18("prewarmed", gdoc18, sqlite=False)
w = window18(pw18, blocks18, certs18, "batch.ed25519")
route18 = w["verifies"][0]["path"]
check(w["applied"] == W18 and w["launches"]["comb_verify"] == 1
      and sum(w["launches"].values()) == 1 and route18 == "comb"
      and pw18.state.app_hash == states18[W18 - 1].app_hash,
      f"phase 18: the prewarmed window {window_view18([w])}")
prewarm18["window"] = window_view18([w])[0]
log(phase=18, card=CARD, step="prewarmed window", route=route18,
    lanes=w["verifies"][0]["lanes"], wall_s=w["wall_s"],
    stage_s=w["verifies"][0]["stage_s"],
    compute_s=w["verifies"][0]["compute_s"], prewarm=prewarm18["launches"])
E.table_cache_clear()


# -- step 6: the reactor over two Switches on 127.0.0.1
def switch18(i, moniker, reactor):
    sw = Switch(NodeKey(edkeys.PrivKey(hashlib.sha256(
        b"phase 18 node %d" % i).digest())), "127.0.0.1:0", CHAIN,
        moniker=moniker)
    sw.add_reactor("BLOCKSYNC", reactor)
    sw.start()
    return sw


def p2p_bytes18():
    netobs.publish_pending()
    m = P2PMetrics()
    return (m.bytes_sent.value(ch_id="0x40"),
            m.bytes_recv.value(ch_id="0x40"))


def sync18(server_store, moniker, target, node, on_fault=None):
    """A server Switch holding server_store's blocks and a client Switch
    whose BlocksyncReactor (window 64, the scheduler and the pipeline
    running) syncs `node` until it holds `target` heights.  on_fault(r_c,
    sw_c) runs once the client's sync routine has stopped on a card fault
    (the fault case) and must let it finish."""
    r_s = BlocksyncReactor(sexec.BlockExecutor(StateStore(MemDB()),
                                               KVStoreApplication()),
                           server_store, state_from_genesis(gdoc18),
                           fast_sync=False)
    r_c = BlocksyncReactor(node.ex, node.store, node.state, fast_sync=True,
                           window=W18)
    sw_s = switch18(0, f"{moniker}-server", r_s)
    sw_c = None
    try:
        sw_c = switch18(1, moniker, r_c)
        t = time.perf_counter()
        peer = sw_c.dial_peer(sw_s.actual_listen_addr())
        check(peer is not None and peer.id == sw_s.node_key.node_id,
              f"phase 18: {moniker} could not dial the server")
        if on_fault is not None:
            wait18(lambda: r_c.device_error is not None,
                   f"{moniker}'s card fault", 120)
            on_fault(r_c, sw_c)
        wait18(lambda: r_c.state.last_block_height >= target,
               f"{moniker} syncing to {target}", 300)
        wall = time.perf_counter() - t
    finally:
        if sw_c is not None:
            sw_c.stop()
        sw_s.stop()
    node.state = r_c.state
    return r_c, sw_c, peer.id, wall


sch18 = start_sched()
pipe18 = bpipe.set_config(enable=True, depth=4, group_commit_heights=8)
sent0, recv0 = p2p_bytes18()
sw18 = node18("switch", gdoc18, grouped=True)
label18[0] = "switch"
(r_c18, _, srv_id18, wall_sw), c_sw = main_path(
    lambda: sync18(srv_store18, "client18", H18 - 1, sw18),
    site="sched.ed25519")
sent1, recv1 = p2p_bytes18()
flow18 = netobs.flow_table("client18").get("client18", {}).get(srv_id18, {})
check([sw18.store.load_block(h).hash() for h in range(1, H18)]
      == [b.hash() for b in blocks18[:H18 - 1]]
      and sw18.state.app_hash == states18[H18 - 2].app_hash
      and r_c18.blocks_synced == H18 - 1 and r_c18.device_error is None
      and c_sw["verify_packed"] > 0 and pipe18.windows_pipelined > 0,
      f"phase 18: the switch sync: {sw18.state.last_block_height}, "
      f"{r_c18.blocks_synced}, {c_sw}, {pipe18.windows_pipelined}")
wire18 = sum(len(b.proto()) for b in blocks18[:H18 - 1])
check(sent1 - sent0 > wire18 and recv1 - recv0 > wire18
      and flow18.get("recv_bytes", 0) > wire18,
      f"phase 18: p2p bytes sent {sent1 - sent0}, received "
      f"{recv1 - recv0}, the client's flow {flow18}")
steps18["switch"] = {"wall_s": wall_sw, "blocks_per_s": (H18 - 1) / wall_sw,
                     "lastcommit_sigs_per_s": (H18 - 2) * N18 / wall_sw,
                     "launches": c_sw, "bytes_sent": sent1 - sent0,
                     "bytes_recv": recv1 - recv0,
                     "flow": {k: v for k, v in flow18.items()
                              if not isinstance(v, dict)},
                     "windows_pipelined": pipe18.windows_pipelined}
log(phase=18, card=CARD, step="switch", **steps18["switch"])
bpipe.set_config(enable=False)
sch18.stop()
vsched.uninstall(sch18)

# -- step 7: phase 17's 10,000-validator chain from its block store: the
# windows stop at the set change (a val: tx at height 2 changes the set
# from height 4); the coalesced windows on K1, the strict one on K2
# through the pubkey-row cache
big_db18 = SQLiteDB(os.path.join(root17, f"chain{N17_BIG}", "blockstore.db"))
blocks_big18, certs_big18 = served18(BlockStore(big_db18), H17_BIG)
big_db18.close()
bg18 = node18("big", gdoc_big, sqlite=False)
rows_big = []
t = time.perf_counter()
while bg18.state.last_block_height < H17_BIG:
    hm = E._pub_cache.hits, E._pub_cache.misses
    rows_big.append(window18(bg18, blocks_big18, certs_big18, None))
    rows_big[-1]["pub_cache"] = (E._pub_cache.hits - hm[0],
                                 E._pub_cache.misses - hm[1])
wall_big18 = time.perf_counter() - t
shape_big = [(r["applied"], [v["lanes"] for v in r.get("verifies", [])],
              r["launches"]["verify_packed"],
              r["launches"]["verify_packed_split"], r["pub_cache"])
             for r in rows_big]
check([s[0] for s in shape_big] == [2, 1, 3]
      and shape_big[0][2] == 1 and shape_big[0][1][0] >= 16_384
      and shape_big[2][2] == 1 and shape_big[2][1][0] >= 16_384
      and shape_big[0][3] == shape_big[2][3] == 0
      and shape_big[1][1] == [] and shape_big[1][3] == 2
      and shape_big[1][4][1] >= 1
      and bg18.state.app_hash.hex() == big.rows[-1]["app_hash"],
      f"phase 18: the {N17_BIG}-validator windows {shape_big}")
sigs_big = sum(v["lanes"] for r in rows_big for v in r.get("verifies", []))
# the signatures the windows verified: the coalesced batches, and the strict
# block's light prefix and LastCommit
sigs_big += len(blocks_big18[2].last_commit.signatures) \
    + N17_BIG * 2 // 3 + 1
steps18["big"] = {"wall_s": wall_big18, "blocks_per_s": H17_BIG / wall_big18,
                  "sigs_per_s": sigs_big / wall_big18, "sigs": sigs_big,
                  "windows": shape_big, "records": window_view18(rows_big)}
log(phase=18, card=CARD, step=f"{N17_BIG} validators", wall_s=wall_big18,
    blocks_per_s=H17_BIG / wall_big18, sigs_per_s=sigs_big / wall_big18,
    windows=shape_big)


# -- step 8: a launch that fails on the card, no failpoint armed: K1's
# wrapper swapped for one that raises (as phase 12 does) during a serial
# window, a pipelined window and the reactor's sync.  Each time
# WindowDeviceError (a DeviceLaneError) reaches the caller with the state of
# the blocks already applied: no WindowSyncError, no strict retry, no
# redo_request, no peer stopped, nothing re-verified on the host; then the
# wrapper is restored, the window replays again and the sync finishes
def card_fault18(what, fn):
    """fn() with K1 raising; returns (the error, the runtime's failures and
    host fallbacks, the verify_items and light-verify calls)."""
    check(not failpoints.armed(), "phase 18: a failpoint is armed")
    rt = degrade.runtime()
    fails0 = counter_total(rt.metrics.device_failures)
    falls0 = counter_total(rt.metrics.host_fallbacks)
    calls0 = dict(calls18)
    keeping = ck.verify_packed
    ck.verify_packed = launch_failed
    try:
        err = fn()
    finally:
        ck.verify_packed = keeping
    join_abandoned()
    row = {"what": what, "error": type(err).__name__,
           "height": getattr(err, "height", None),
           "applied": getattr(err, "applied", None),
           "failures": counter_total(rt.metrics.device_failures) - fails0,
           "fallbacks": counter_total(rt.metrics.host_fallbacks) - falls0,
           "verify_items": calls18["verify_items"] - calls0["verify_items"],
           "light": calls18["light"] - calls0["light"]}
    # a fresh runtime: the breaker closed and its counters at 0
    degrade.configure(degrade.DegradeConfig.from_env(),
                      registry=Registry(f"p18 {what}"))
    return err, row


def raises18(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - returned and checked
        return e
    return None


faults18 = []
# a serial window: the second (heights 65-128)
sf = node18("fault-serial", gdoc18, sqlite=False)
window18(sf, blocks18, certs18, "batch.ed25519")
err, row = card_fault18("serial", lambda: raises18(
    lambda: breplay.replay_window(sf.ex, sf.store, sf.state, blocks18[W18:],
                                  certs18[W18:], max_window=W18)))
faults18.append(row)
check(isinstance(err, breplay.WindowDeviceError)
      and isinstance(err, degrade.DeviceLaneError)
      and not isinstance(err, breplay.WindowSyncError)
      and err.state.last_block_height == W18 and err.applied == 0
      and row["verify_items"] == 1 and row["light"] == 0
      and row["failures"] >= 1 and row["fallbacks"] == 0
      and sf.store.height() == W18,
      f"phase 18: the serial card fault {row} ({err!r})")
w = window18(sf, blocks18, certs18, "batch.ed25519")
check(w["applied"] == W18
      and sf.state.app_hash == states18[2 * W18 - 1].app_hash,
      "phase 18: the serial window again after the card fault")

# a pipelined window: the second
sch18 = start_sched()
pipe18 = bpipe.set_config(enable=True, depth=4, group_commit_heights=8)
pf = node18("fault-pipelined", gdoc18, grouped=True, sqlite=False)
window18(pf, blocks18, certs18, "sched.ed25519")
err, row = card_fault18("pipelined", lambda: raises18(
    lambda: breplay.replay_window(pf.ex, pf.store, pf.state, blocks18[W18:],
                                  certs18[W18:], max_window=W18)))
row["windows_degraded"] = pipe18.windows_degraded
faults18.append(row)
check(isinstance(err, breplay.WindowDeviceError)
      and err.state.last_block_height >= W18
      and err.state.last_block_height == W18 + err.applied
      and row["verify_items"] == 0 and row["light"] == 0
      and row["failures"] >= 1 and row["fallbacks"] == 0
      and pipe18.windows_degraded == 0
      and pf.ex.state_store.load().last_block_height
      == err.state.last_block_height,
      f"phase 18: the pipelined card fault {row} ({err!r})")
pf.state = err.state
w = window18(pf, blocks18, certs18, "sched.ed25519")
check(pf.state.last_block_height == 2 * W18
      and pf.state.app_hash == states18[2 * W18 - 1].app_hash,
      "phase 18: the pipelined window again after the card fault")

# the reactor's sync, against a server of 65 blocks: the card fault ends
# the client's sync routine (kept on the reactor); no redo, no peer
# stopped; the wrapper restored, resume_sync() finishes it.  A fresh
# scheduler and SigCache: the chain's signatures are cached by now
sch18.stop()
vsched.uninstall(sch18)
sch18 = start_sched()
srv65 = BlockStore(MemDB())
for h in range(1, W18 + 2):
    srv65.save_block(srv_store18.load_block(h),
                     tparts.make_block_parts(srv_store18.load_block(h)),
                     srv_store18.load_seen_commit(h))
rf = node18("fault-reactor", gdoc18, grouped=True, sqlite=False)
label18[0] = "fault-reactor"
fault_seen = {}
redos18, stops18 = [], []
rt_f = degrade.runtime()
fails_f0 = counter_total(rt_f.metrics.device_failures)
falls_f0 = counter_total(rt_f.metrics.host_fallbacks)
keeping_f = ck.verify_packed


def _on_fault(r_c, sw_c):
    ck.verify_packed = keeping_f
    join_abandoned()
    fault_seen["error"] = r_c.device_error
    fault_seen["state_height"] = r_c.state.last_block_height
    fault_seen["failures"] = counter_total(
        rt_f.metrics.device_failures) - fails_f0
    fault_seen["fallbacks"] = counter_total(
        rt_f.metrics.host_fallbacks) - falls_f0
    degrade.configure(degrade.DegradeConfig.from_env(),
                      registry=Registry("p18 reactor"))
    r_c.resume_sync()


_real_redo = BlockPool.redo_request
_real_stop = Switch.stop_peer_for_error
BlockPool.redo_request = lambda self, h: (redos18.append(h),
                                          _real_redo(self, h))[1]
# (a switch's own stop stops its peers too: that reason is not counted)
Switch.stop_peer_for_error = lambda self, p, r: (
    r != "switch stopping" and stops18.append(r), _real_stop(self, p, r))[1]
ck.verify_packed = launch_failed
try:
    r_f, _, _, wall_f = sync18(srv65, "fault18", W18, rf, on_fault=_on_fault)
finally:
    ck.verify_packed = keeping_f
    BlockPool.redo_request = _real_redo
    Switch.stop_peer_for_error = _real_stop
bpipe.set_config(enable=False)
sch18.stop()
vsched.uninstall(sch18)
e_f = fault_seen.get("error")
row = {"what": "reactor", "error": type(e_f).__name__,
       "height": getattr(e_f, "height", None),
       "applied": getattr(e_f, "applied", None),
       "state_height": fault_seen.get("state_height"),
       "failures": fault_seen.get("failures"),
       "fallbacks": fault_seen.get("fallbacks"), "redos": redos18,
       "peers_stopped": stops18, "wall_s": wall_f}
faults18.append(row)
check(isinstance(e_f, breplay.WindowDeviceError) and redos18 == []
      and stops18 == [] and row["failures"] >= 1 and row["fallbacks"] == 0
      and r_f.device_error is None
      and [rf.store.load_block(h).hash() for h in range(1, W18 + 1)]
      == [b.hash() for b in blocks18[:W18]]
      and rf.state.app_hash == states18[W18 - 1].app_hash,
      f"phase 18: the reactor's card fault {row}")
log(phase=18, card=CARD, step="card faults", faults=faults18)

# -- every launch of the phase against its plain version on the same
# inputs (concatenated by step), and three windows' bitmaps against
# OpenSSL's
label18[0] = ""
for _name in keep18:
    setattr(KERNEL_MOD[_name], _name, was18[_name])
breplay._collect_block_items = REAL18["collect"]
breplay._apply_one = REAL18["apply"]
vsched.verify_items = REAL18["verify_items"]
ValidatorSet.verify_commit_light = REAL18["light"]
cmp18 = {name: [] for name in keep18}
t = time.perf_counter()
for name, plain in (("verify_packed", ck.verify_packed_plain),
                    ("verify_packed_split", ck.verify_packed_split_plain)):
    runs = keep18[name]
    if not runs:
        continue
    # every launch's signatures, grouped by step (a padding lane is all
    # zeros, and both the kernel and the plain version refuse it), held
    # in chunks of 65,536 lanes: the plain version's cost is per call
    got = torch.cat([out for _, _, out in runs])
    cols = [torch.cat([args[k] for _, args, _ in runs], dim=1)
            for k in range(len(runs[0][1]))]
    step_of = np.repeat([label.split(" ")[0] for label, _, _ in runs],
                        [out.shape[0] for _, _, out in runs])
    real = (cols[-1] != 0).any(dim=0)
    check(not got[~real].any(), f"phase 18 {name}: a padding lane passed")
    got = got[real].cpu().numpy()
    step_of = step_of[real.cpu().numpy()]
    cols = [c[:, real] for c in cols]
    want = torch.cat([plain(*[c[:, a:a + 65_536] for c in cols]).cpu()
                      for a in range(0, len(got), 65_536)]).numpy()
    err = np.abs(got.astype(int) - want.astype(int))
    for g in sorted(set(step_of)):
        on = step_of == g
        n_runs = sum(label.split(" ")[0] == g for label, _, _ in runs)
        cmp18[name].append((f"phase 18 {g}: {n_runs} launches",
                            int(on.sum()), int(err[on].sum()),
                            float(err[on].max())))
for label, args, (tab, ok) in keep18["comb_build"]:
    ptab, pok = cc.comb_build_plain(args[0])
    cmp18["comb_build"].append(
        (f"phase 18 {label}", args[0].shape[0],
         cc.tables_mismatch(tab, ptab) + int((ok != pok).sum())))
check(len(keep18["comb_build"]) == 1 and keep18["comb_verify"]
      and all(args[1] is keep18["comb_build"][0][2][0]
              for _, args, _ in keep18["comb_verify"]),
      "phase 18: a C2 launch on another table than the prewarm's")
ptab, pok = plain_tables(keys18)
rows_c2 = torch.cat([args[0] for _, args, _ in keep18["comb_verify"]])
got = torch.cat([out for _, _, out in keep18["comb_verify"]]).cpu().numpy()
cmp18["comb_verify"].append(c2_row(
    f"phase 18: {len(keep18['comb_verify'])} launches", got,
    cc.comb_verify_plain(rows_c2, ptab, pok).cpu().numpy()))
plain18_s = time.perf_counter() - t
t = time.perf_counter()
oracle_rows18 = []
for what, items, bits, bad in oracle18:
    want = np.array([edkeys._ossl_verify(p.bytes(), m, s)
                     for p, m, s in items], dtype=bool)
    expect = np.ones(len(items), dtype=bool)
    expect[bad] = False
    oracle_rows18.append((what, len(items), int((bits != want).sum()),
                          bool((want == expect).all())))
check(len(oracle_rows18) >= 3
      and all(r[2] == 0 and r[3] for r in oracle_rows18),
      f"phase 18: window bitmaps against OpenSSL's {oracle_rows18}")
oracle18_s = time.perf_counter() - t
E.table_cache_clear()
staging_clear(18)
shutil.rmtree(root18)
launches18 = {name: len(v) for name, v in keep18.items()}
replay18_rep = {
    "steps": steps18, "bad": bad18, "prewarm": prewarm18, "faults": faults18,
    "comparisons": cmp18, "openssl": oracle_rows18, "launches": launches18,
    "plain_s": plain18_s, "openssl_s": oracle18_s,
    "phase_s": time.perf_counter() - T18}
log(phase=18, card=CARD, launches=launches18, comparisons=cmp18,
    openssl=oracle_rows18, plain_s=plain18_s, openssl_s=oracle18_s,
    phase_s=replay18_rep["phase_s"])
check(all(r[2] == 0 for rows in cmp18.values() for r in rows),
      f"phase 18: a kernel disagrees with its plain version: {cmp18}")
REPORT["blocksync_replay"] = replay18_rep

# -- phase 19: the light client, LightServe and evidence -----------------------

# The light client and its serving plane on the card, and evidence: BASELINE
# config 3 (`BASELINE.md:32`: skipping verification over a 10,000-validator
# header chain) through light.Client over phase 17's 10,000-validator chain,
# its depth cut to that chain's 6 heights; a bisection over a 150-validator
# chain whose set rotates 110 of its 150 keys at height 12; LightServe over
# that chain with a VerifyScheduler on the card and its own prewarm (C1 at
# 256 keys), sixteen clients verifying every height (bench.py's
# run_light_serve shape), and over the 10,000-validator chain; evidence (a
# duplicate vote committed in a block, a light-client attack found by the
# detector and reported through NodeBackedProvider); K1's wrapper raising
# with no failpoint armed under a LightServe request, a client verify and an
# evidence reactor.  Walls are host-clock, logged and not gated; every
# verdict, route and count named below is.
N19, H19, ROT19, ROTATED19 = 150, 24, 12, 110   # (b)'s chain
CLIENTS19 = 16
DUP19, FORK19, FORK19_GOSSIP = 5, 10, 8
PERIOD19 = 14 * 24 * 3600.0
NOW19 = Timestamp(1700000000 + 3600, 0)
T19 = time.perf_counter()
rng19 = random.Random(SEED + 19)
E.table_cache_clear()
check(not msm.use_rlc(10_000) and not failpoints.armed()
      and vsched.installed() is None and bpipe.installed() is None,
      "phase 19: RLC, a failpoint, a scheduler or a pipeline is still on")
# every K1, K2, C1 and C2 launch of the phase: (label, inputs, output)
keep19 = {name: [] for name in ("verify_packed", "verify_packed_split",
                                "comb_build", "comb_verify")}
label19 = [""]
was19 = {name: getattr(KERNEL_MOD[name], name) for name in keep19}
_keep19_lock = threading.Lock()


def _keeping19(name):
    """The bare wrapper (REAL), keeping a copy of every launch's tensor
    inputs (C2's tables by reference) and its output; LightServe's lanes
    launch from several threads."""
    def wrapper(*args):
        out = REAL[name](*args)
        kept = [a.clone() if isinstance(a, torch.Tensor)
                and not (name == "comb_verify" and i == 1) else a
                for i, a in enumerate(args)]
        with _keep19_lock:
            keep19[name].append((label19[0], kept, out))
        return out
    return wrapper


for _name in keep19:
    setattr(KERNEL_MOD[_name], _name, _keeping19(_name))

# each certificate of the sequential steps: its kind, height, route, lanes,
# launches and wall (recorded on the calling thread; LightServe's lanes run
# concurrently and are counted by step instead)
certs19: list = []
cert_on19 = [False]
REAL19 = {n: getattr(ValidatorSet, n) for n in (
    "verify_commit_light", "verify_commit_light_trusting")}


def _cert19(name):
    real = REAL19[name]
    kind = "trusting" if name.endswith("trusting") else "light"

    def cert(self, *a, **k):
        if not cert_on19[0]:
            return real(self, *a, **k)
        height = a[2] if kind == "light" else a[1].height
        seq0 = E.last_launch()["seq"]
        c0 = {**ck.launches, **cc.launches}
        t = time.perf_counter()
        err = None
        try:
            return real(self, *a, **k)
        except Exception as e:  # noqa: BLE001 - recorded, then raised
            err = type(e).__name__
            raise
        finally:
            rec = dict(E.last_launch())
            c1 = {**ck.launches, **cc.launches}
            certs19.append({
                "step": label19[0], "kind": kind, "height": height,
                "wall_s": time.perf_counter() - t, "error": err,
                "path": rec["path"] if rec["seq"] != seq0 else None,
                "lanes": rec["n"] if rec["seq"] != seq0 else 0,
                # the launch's staging (host clock) and device time (CUDA
                # events), from its launch record
                "stage_s": rec.get("stage_s") if rec["seq"] != seq0
                else None,
                "compute_s": rec.get("compute_s") if rec["seq"] != seq0
                else None,
                "launches": {n: c1[n] - c0[n] for n in (
                    "verify_packed", "verify_packed_split", "comb_verify")
                    if c1[n] != c0[n]}})
    return cert


for _n in REAL19:
    setattr(ValidatorSet, _n, _cert19(_n))

# LightServe's own prewarms (ops.ed25519.prewarm_async runs prewarm on a
# pool worker): each call's keys, result and wall, to wait for them
prewarms19: list = []
_pw19 = threading.Condition()
REAL_PREWARM19 = E.prewarm


def _prewarm19(keys, warm_kernel=True, device=None):
    t = time.perf_counter()
    ok = REAL_PREWARM19(keys, warm_kernel=warm_kernel, device=device)
    with _pw19:
        prewarms19.append({"keys": len(keys), "resident": ok,
                           "wall_s": time.perf_counter() - t,
                           "step": label19[0]})
        _pw19.notify_all()
    return ok


E.prewarm = _prewarm19


def wait_prewarms19(n, what):
    with _pw19:
        check(_pw19.wait_for(lambda: len(prewarms19) >= n, timeout=300),
              f"phase 19: {what}: the prewarm never landed")
    return prewarms19[n - 1]


def step19(label, fn):
    """fn() on the main path with the phase's label; the runtime must have
    served it without a device failure or a host fallback.  Returns
    (the result, the launch counts, the wall)."""
    label19[0] = label
    t = time.perf_counter()
    out, c = main_path(fn)
    wall = time.perf_counter() - t
    runtime_clean(f"phase 19 {label}")
    return out, {k: v for k, v in c.items() if v}, wall


def expect19(exc, fn, what):
    """fn() must raise exc; returns it."""
    try:
        fn()
    except exc as e:
        return e
    fail(f"phase 19: {what} did not raise {exc.__name__}")


def client19(primary, witnesses, **kw):
    """A light client trusting height 1 of the primary's chain (the anchor
    taken out of band), its store in memory."""
    return light.Client(CHAIN, light.TrustOptions(
        1, primary.light_block(1).hash(), PERIOD19), primary, witnesses,
        light.LightStore(MemDB()), **kw)


def step_certs19(prefix):
    return [c for c in certs19 if c["step"].startswith(prefix)]


def cert_view19(rows):
    return [(c["kind"], c["height"], c["path"], c["lanes"], c["error"],
             c["launches"], c["wall_s"], c["stage_s"], c["compute_s"])
            for c in rows]


light19: dict = {}
walls19: dict = {}
cert_on19[0] = True

# -- (a) BASELINE config 3: phase 17's 10,000-validator chain of 6 heights
# (a power change at height 2 reorders the set from height 4), served from
# its SQLite stores.  One client trusting height 1 verifies height 6 by
# skipping (one non-adjacent hop: the height-1 set's 1/3, then height 6's
# 2/3 prefix); a second one verifies heights 2-6 sequentially.  The comb
# declines this set early (its tables are over the budget)
big_dir19 = os.path.join(root17, f"chain{N17_BIG}")
big_bdb19 = SQLiteDB(os.path.join(big_dir19, "blockstore.db"))
big_sdb19 = SQLiteDB(os.path.join(big_dir19, "state.db"))
big_bs19, big_ss19 = BlockStore(big_bdb19), StateStore(big_sdb19)
rt19 = degrade.runtime()
declined0 = rt19.metrics.msm_route.value(path="comb", outcome="declined")
prov_a = lprov.NodeBackedProvider(CHAIN, big_bs19, big_ss19)
wit_a = lprov.NodeBackedProvider(CHAIN, big_bs19, big_ss19)
cA, _, walls19["a_anchor_s"] = step19("a anchor",
                                      lambda: client19(prov_a, [wit_a]))
lbA, cnt_a, walls19["a_skip_s"] = step19(
    "a skip", lambda: cA.verify_light_block_at_height(H17_BIG, NOW19))
cB, _, walls19["a_seq_anchor_s"] = step19(
    "a seq anchor", lambda: client19(prov_a, [wit_a], sequential=True))
_, cnt_a_seq, walls19["a_sequential_s"] = step19(
    "a seq", lambda: cB.verify_light_block_at_height(H17_BIG, NOW19))
skip_a = step_certs19("a skip")
seq_a = step_certs19("a seq")
vals6 = big_ss19.load_validators(H17_BIG)
prefix_a = N17_BIG * 10 * 2 // 3 // 10 + 1
check(cA.store.heights() == [1, H17_BIG]
      and lbA.hash() == prov_a.light_block(H17_BIG).hash()
      and [(c["kind"], c["height"]) for c in skip_a]
      == [("trusting", H17_BIG), ("light", H17_BIG)]
      and skip_a[0]["lanes"] >= N17_BIG // 3
      and skip_a[1]["lanes"] >= prefix_a - 1
      and all(c["path"] in ("cuda", "cuda-split") and c["error"] is None
              for c in skip_a + seq_a)
      and cB.store.heights() == list(range(1, H17_BIG + 1))
      and [c["height"] for c in seq_a if c["step"] == "a seq"]
      == list(range(2, H17_BIG + 1)),
      f"phase 19: config 3 {cert_view19(skip_a)} {cert_view19(seq_a)} "
      f"{cA.store.heights()} {cB.store.heights()}")
light19["config3"] = {
    "validators": N17_BIG, "heights": H17_BIG,
    "skip": cert_view19(skip_a), "sequential": cert_view19(seq_a),
    "skip_launches": cnt_a, "sequential_launches": cnt_a_seq,
    "comb_declined": rt19.metrics.msm_route.value(
        path="comb", outcome="declined") - declined0,
    "device_share": sum(c["compute_s"] or 0.0 for c in skip_a + seq_a)
    / (walls19["a_skip_s"] + walls19["a_sequential_s"])}
log(phase=19, card=CARD, step="a config 3", skip_wall_s=walls19["a_skip_s"],
    sequential_wall_s=walls19["a_sequential_s"],
    anchor_wall_s=walls19["a_anchor_s"], skip=cert_view19(skip_a),
    sequential=cert_view19(seq_a),
    comb_declined=light19["config3"]["comb_declined"],
    device_share=light19["config3"]["device_share"])


# -- (b) bisection at 150 validators: a kvstore chain of 24 heights made by
# the port's executor; val: txs in block 12 remove 110 of the genesis keys
# and add 110 new ones (the set that signs heights 14 on).  A client
# trusting height 1 targets height 24: the skipping hop fails trust, the
# client bisects, and its trusted heights are those of a client on
# device="cpu" over the same chain
def build19():
    a_list, pubs = gen_keys(N19 + ROTATED19, rng19)
    a_of = dict(zip(pubs, a_list))
    gdoc = tgen.GenesisDoc(
        chain_id=CHAIN, genesis_time=Timestamp(1700000000, 0),
        validators=[tgen.GenesisValidator(
            address=b"", pub_key_type="ed25519", pub_key_bytes=p, power=10,
            name=f"v{i}") for i, p in enumerate(pubs[:N19])])
    gdoc.validate_and_complete()
    app = app18(gdoc)
    ss, bs = StateStore(MemDB()), BlockStore(MemDB())
    ex = sexec.BlockExecutor(ss, app)
    state = state_from_genesis(gdoc)
    ss.save(state)
    last = Commit(0, 0, BlockID(), [])
    states = []
    for h in range(1, H19 + 1):
        txs = txs17(h, 20)
        if h == ROT19:
            txs = [val_tx17(p, 0) for p in pubs[:ROTATED19]] \
                + [val_tx17(p, 10) for p in pubs[N19:]]
        block = state.make_block(h, txs, last, [],
                                 state.validators.get_proposer().address,
                                 block_time=Timestamp(1700000000 + h, 0))
        parts = tparts.make_block_parts(block)
        bid = BlockID(block.hash(), parts.header())
        seen = sign17(state, bid, h, a_of)
        if h > 1:
            ex.mark_commit_verified(h - 1, last)
        state, _ = ex.apply_block(state, bid, block)
        bs.save_block(block, parts, seen)
        states.append(state)
        last = seen
    return gdoc, a_of, pubs, app, ss, bs, states


t = time.perf_counter()
gdoc19, a_of19, pubs19, app19, ss19, bs19, states19 = build19()
walls19["b_build_s"] = time.perf_counter() - t
old19 = {v.pub_key.bytes() for v in states19[0].validators.validators}
new19 = {v.pub_key.bytes() for v in states19[-1].validators.validators}
check(len(old19 & new19) == N19 - ROTATED19 and len(new19) == N19
      and states19[ROT19 - 1].validators.hash()
      == states19[0].validators.hash()
      and states19[ROT19].validators.hash()
      == states19[-1].validators.hash(),
      "phase 19: the 150-validator chain's rotation")
prov_b = lprov.NodeBackedProvider(CHAIN, bs19, ss19)
wit_b = lprov.NodeBackedProvider(CHAIN, bs19, ss19)
cb19, _, _ = step19("b anchor", lambda: client19(prov_b, [wit_b]))
_, cnt_b, walls19["b_bisect_s"] = step19(
    "b bisect", lambda: cb19.verify_light_block_at_height(H19, NOW19))
trace_b = cb19.store.heights()
label19[0] = "b cpu"
t = time.perf_counter()
cpu19 = client19(lprov.NodeBackedProvider(CHAIN, bs19, ss19),
                 [lprov.NodeBackedProvider(CHAIN, bs19, ss19)], device="cpu")
cpu19.verify_light_block_at_height(H19, NOW19)
walls19["b_cpu_s"] = time.perf_counter() - t
bis_b = step_certs19("b bisect")
check(len(trace_b) > 3 and trace_b == cpu19.store.heights()
      and trace_b[-1] == H19
      and bis_b[0]["kind"] == "trusting" and bis_b[0]["height"] == H19
      and bis_b[0]["error"] == "NotEnoughVotingPowerError"
      and bis_b[0]["lanes"] == 0
      and all(c["lanes"] >= 32 and c["path"] in ("cuda", "cuda-split")
              for c in bis_b if c["error"] is None)
      and all(c["launches"] == {} for c in step_certs19("b cpu")),
      f"phase 19: bisection {trace_b} vs {cpu19.store.heights()}: "
      f"{cert_view19(bis_b)}")
light19["bisection"] = {"trusted_heights": trace_b,
                        "cpu_trusted_heights": cpu19.store.heights(),
                        "certificates": cert_view19(bis_b),
                        "launches": cnt_b}
log(phase=19, card=CARD, step="b bisection", trusted=trace_b,
    wall_s=walls19["b_bisect_s"], cpu_wall_s=walls19["b_cpu_s"],
    build_s=walls19["b_build_s"], certificates=cert_view19(bis_b))
cert_on19[0] = False


# -- (c) LightServe over (b)'s chain, served from stores that grow as a
# full node's do, with a VerifyScheduler on the card and the service's own
# prewarm.  Heights 1-11: the service starts and prewarms the genesis set
# (C1 at 256 keys); sixteen clients follow the chain (subscribe/poll) and
# verify heights 2-11 (C2).  Heights 12-18: the set rotates at 14; no
# valset event yet, so heights 14-18 take K1.  Then the ValidatorSetUpdates
# event: the watcher prewarms the new set (C1) and heights 19-24 take C2.
# Every verdict against the direct path; the light.serve and light.coalesce
# drills; a tampered commit refused
def start_sched19():
    """A fresh SigCache and a VerifyScheduler at the node's defaults."""
    cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
    sch = vsched.install(vsched.VerifyScheduler(
        window_s=0.002, max_batch=8192, max_pending=65536,
        tpu_threshold=32, device=DEV))
    sch.start()
    return sch


ss_c, bs_c = StateStore(MemDB()), BlockStore(MemDB())
ss_c.save(state_from_genesis(gdoc19))


def serve19(store_bs, store_ss, src_bs, states, upto):
    """Copy heights into a serving node's stores, as a full node commits
    them."""
    for h in range(store_bs.height() + 1, upto + 1):
        block = src_bs.load_block(h)
        store_bs.save_block(block, tparts.make_block_parts(block),
                            src_bs.load_seen_commit(h))
        store_ss.save(states[h - 1])


class Clients19:
    """Sixteen light clients of one service: each follows the chain on its
    own cursor and asks, height after height, for the adjacent
    verification of the header it has not verified yet (all clients the
    same height back to back, as bench.py's run_light_serve asks)."""

    def __init__(self, svc, n):
        self.svc = svc
        self.ids = [f"client-{c}" for c in range(n)]
        self.cur = {c: svc.subscribe(c, from_height=1) for c in self.ids}
        self.lbs = {c: {} for c in self.ids}
        self.polled = {c: [] for c in self.ids}
        self.rows = []          # (client, height, request, verdict)

    def follow(self):
        for c in self.ids:
            while True:
                got = self.svc.poll(self.cur[c])
                check(got is not None, f"phase 19: {c}'s cursor evicted")
                if not got:
                    break
                for lb in got:
                    self.polled[c].append(lb.height)
                    self.lbs[c][lb.height] = lb

    def request(self, c, h):
        t, u = self.lbs[c][h - 1], self.lbs[c][h]
        return LightRequest("adjacent", CHAIN, trusted=t.signed_header,
                            untrusted=u.signed_header,
                            untrusted_vals=u.validators, now=NOW19,
                            trusting_period_s=PERIOD19)

    def wave(self, lo, hi):
        self.follow()
        futs = []
        t = time.perf_counter()
        for h in range(lo, hi + 1):
            for c in self.ids:
                r = self.request(c, h)
                futs.append((c, h, r, self.svc.submit(r, client=c)))
        for c, h, r, f in futs:
            self.rows.append((c, h, r, f.result(timeout=300)))
        return time.perf_counter() - t


def verdict19(v):
    return (v.ok, v.error, v.retry_after_s)


label19[0] = "c"
sch19 = start_sched19()
bus19 = tbus.EventBus()
serve19(bs_c, ss_c, bs19, states19, ROT19 - 1)
svc19 = lserve.LightServe(bs_c, ss_c, CHAIN, prewarm=True, event_bus=bus19)
svc19.metrics = LightMetrics(Registry("p19 light serve"))
cl19 = Clients19(svc19, CLIENTS19)
sched0 = sch19.stats()


def stage_c1():
    svc19.start()           # prewarms the current (genesis) set
    wait_prewarms19(1, "the genesis set")
    return cl19.wave(2, ROT19 - 1)


serve_c: dict = {}
w, c, wall = step19("c1", stage_c1)
serve_c["genesis set, prewarmed"] = {"heights": [2, ROT19 - 1],
                                     "launches": c, "wave_s": w,
                                     "wall_s": wall}
check(prewarms19[0]["resident"] and prewarms19[0]["keys"] == N19
      and c.get("comb_build") == 1 and c.get("comb_verify", 0) >= ROT19 - 2
      and not c.get("verify_packed") and not c.get("verify_packed_split"),
      f"phase 19: LightServe on the genesis set {c} {prewarms19}")
serve19(bs_c, ss_c, bs19, states19, ROT19 + 6)
w, c, wall = step19("c2", lambda: cl19.wave(ROT19, ROT19 + 6))
serve_c["rotated, no prewarm yet"] = {"heights": [ROT19, ROT19 + 6],
                                      "launches": c, "wave_s": w,
                                      "wall_s": wall}
check(c.get("verify_packed", 0) >= 5 and c.get("comb_verify", 0) >= 2
      and not c.get("comb_build"),
      f"phase 19: LightServe across the rotation {c}")


def stage_c3():
    bus19.publish_validator_set_updates([])   # the watcher prewarms
    wait_prewarms19(2, "the rotated set")
    serve19(bs_c, ss_c, bs19, states19, H19)
    return cl19.wave(ROT19 + 7, H19)


w, c, wall = step19("c3", stage_c3)
serve_c["rotated set, prewarmed"] = {"heights": [ROT19 + 7, H19],
                                     "launches": c, "wave_s": w,
                                     "wall_s": wall}
check(prewarms19[1]["resident"] and c.get("comb_build") == 1
      and c.get("comb_verify", 0) >= H19 - ROT19 - 6
      and not c.get("verify_packed"),
      f"phase 19: LightServe on the prewarmed rotated set {c}")
cl19.follow()
check(all(cl19.polled[c] == list(range(1, H19 + 1)) for c in cl19.ids),
      "phase 19: the follow cursors' heights")
st_c = svc19.stats()
rep_c = svc19.report()
n_req = CLIENTS19 * (H19 - 1)
check(st_c["verified"] == n_req and st_c["refuted"] == 0
      and all(v.ok for _, _, _, v in cl19.rows) and len(cl19.rows) == n_req,
      f"phase 19: LightServe verdicts {st_c}")


# every verdict against the direct path, on the same requests
def direct_c():
    return [verdict19(svc19._verify_direct(r)) for _, _, r, _ in cl19.rows]


direct19, c_direct, walls19["c_direct_s"] = step19("c direct", direct_c)
check(direct19 == [verdict19(v) for _, _, _, v in cl19.rows],
      "phase 19: a LightServe verdict differs from the direct path's")


# a tampered commit (a client handed a header whose certifying commit
# carries a flipped signature) is refused on both paths
def tampered_c():
    r0 = cl19.request(cl19.ids[0], 10)
    sh = copy.deepcopy(r0.untrusted)
    sh.commit = flip17(sh.commit)
    r = LightRequest("adjacent", CHAIN, trusted=r0.trusted, untrusted=sh,
                     untrusted_vals=r0.untrusted_vals, now=NOW19,
                     trusting_period_s=PERIOD19)
    return verdict19(svc19.verify(r, client="tamper", timeout=300)), \
        verdict19(svc19._verify_direct(r))


(tq, td), c_t, _ = step19("c tampered", tampered_c)
check(tq == td and not tq[0] and "wrong signature (#0)" in (tq[1] or ""),
      f"phase 19: the tampered commit {tq} {td}")


# the drills: the same requests give the same verdicts
def drill_c(site):
    failpoints.set_mode(site, "raise")
    try:
        picks = [(c, h) for c in cl19.ids[:4] for h in (5, 16, 22)]
        futs = [svc19.submit(cl19.request(c, h), client=c)
                for c, h in picks]
        got = [verdict19(f.result(timeout=300)) for f in futs]
        return got, failpoints.fired(site, "raise")
    finally:
        failpoints.reset()


drills19 = {}
want_d = [verdict19(v) for c in cl19.ids[:4] for h in (5, 16, 22)
          for cc_, hh, _, v in cl19.rows if (cc_, hh) == (c, h)]
for site in ("light.serve", "light.coalesce"):
    (got, fired), c, wall = step19(f"c drill {site}",
                                   lambda s=site: drill_c(s))
    drills19[site] = {"fired": fired, "launches": c, "wall_s": wall,
                      "identical": got == want_d}
    check(got == want_d and fired >= 1,
          f"phase 19: the {site} drill's verdicts")
st_c = svc19.stats()
sched_c = {k: sch19.stats()[k] - sched0[k] for k in ("submissions", "items",
                                                     "launches", "lanes")}
svc19.stop()
serve_c.update(
    clients=CLIENTS19, requests=n_req, stats=st_c,
    coalesce_ratio=rep_c["coalesce_ratio"], prewarms=prewarms19[:2],
    per_client_p99_ms=rep_c["per_client_p99_ms"],
    headers_per_s=n_req / sum(s["wave_s"] for s in serve_c.values()
                              if isinstance(s, dict) and "wave_s" in s),
    scheduler=sched_c, drills=drills19, tampered=[tq, td],
    direct_identical=True, direct_launches=c_direct)
light19["serve150"] = serve_c
log(phase=19, card=CARD, step="c LightServe 150",
    stages={k: v for k, v in serve_c.items() if isinstance(v, dict)
            and "launches" in v},
    lead=st_c["coalesce_lead"], hit=st_c["coalesce_hit"],
    headers_per_s=serve_c["headers_per_s"],
    p99_ms_max=max(rep_c["per_client_p99_ms"].values()),
    prewarms=prewarms19[:2], scheduler=sched_c, drills=drills19)


# -- (d) LightServe at 10,000 validators over (a)'s stores: its prewarm is
# declined early, the sixteen clients' certificates (heights 2-6) take
# K1/K2
label19[0] = "d"
svc_d = lserve.LightServe(big_bs19, big_ss19, CHAIN, prewarm=True,
                          event_bus=tbus.EventBus())
svc_d.metrics = LightMetrics(Registry("p19 light serve 10k"))
cl_d = Clients19(svc_d, CLIENTS19)


def stage_d():
    svc_d.start()
    wait_prewarms19(3, f"the {N17_BIG}-key set")
    return cl_d.wave(2, H17_BIG)


w, c_d, wall = step19("d", stage_d)
cl_d.follow()
st_d = svc_d.stats()
rep_d = svc_d.report()
d_direct, _, _ = step19("d direct", lambda: [
    verdict19(svc_d._verify_direct(r)) for cc_, _, r, _ in cl_d.rows
    if cc_ == cl_d.ids[0]])
svc_d.stop()
check(not prewarms19[2]["resident"] and prewarms19[2]["keys"] == N17_BIG
      and not c_d.get("comb_build") and not c_d.get("comb_verify")
      and c_d.get("verify_packed_split", 0) + c_d.get("verify_packed", 0)
      >= H17_BIG - 1
      and st_d["verified"] == CLIENTS19 * (H17_BIG - 1)
      and all(cl_d.polled[c] == list(range(1, H17_BIG + 1))
              for c in cl_d.ids)
      and d_direct == [verdict19(v) for cc_, _, _, v in cl_d.rows
                       if cc_ == cl_d.ids[0]],
      f"phase 19: LightServe at {N17_BIG} validators {c_d} {st_d} "
      f"{prewarms19[2:]}")
light19["serve10k"] = {
    "clients": CLIENTS19, "requests": CLIENTS19 * (H17_BIG - 1),
    "launches": c_d, "wave_s": w, "wall_s": wall, "stats": st_d,
    "headers_per_s": CLIENTS19 * (H17_BIG - 1) / w,
    "per_client_p99_ms": rep_d["per_client_p99_ms"],
    "prewarm": prewarms19[2]}
log(phase=19, card=CARD, step=f"d LightServe {N17_BIG}", launches=c_d,
    wave_s=w, lead=st_d["coalesce_lead"], hit=st_d["coalesce_hit"],
    headers_per_s=light19["serve10k"]["headers_per_s"],
    p99_ms_max=max(rep_d["per_client_p99_ms"].values()),
    prewarm=prewarms19[2])


# -- (e) evidence on the card, over (b)'s stores: a duplicate vote of one
# of its validators enters an EvidencePool and a block carrying it is
# applied and committed (the pool marks it committed); a witness forked
# at height 10 makes the detector report a LightClientAttackEvidence to the
# full node through NodeBackedProvider.report_evidence, verified on the
# card with >= 32 lanes a certificate; tampered copies are refused
cert_on19[0] = True
pool19 = evpool.EvidencePool(MemDB(), ss19, bs19)


def dup_vote19(h, idx):
    vals = ss19.load_validators(h)
    v = vals.validators[idx]
    votes = []
    for tag in (b"\xAA", b"\xBB"):
        bid = BlockID(tag * 32, PartSetHeader(1, tag * 32))
        votes.append(tvote.Vote(
            type=SignedMsgType.PRECOMMIT, height=h, round=0, block_id=bid,
            timestamp=Timestamp(1700000000 + h, 900),
            validator_address=v.address, validator_index=idx))
    pub = v.pub_key.bytes()
    for vote, sig in zip(votes, sign_batch(
            [a_of19[pub]] * 2, [pub] * 2,
            [vote.sign_bytes(CHAIN) for vote in votes], rng19)):
        vote.signature = sig
    return tev.DuplicateVoteEvidence.from_votes(
        votes[0], votes[1], bs19.load_block_meta(h).header.time, vals)


dup19 = dup_vote19(DUP19, 7)
s0 = sch19.stats()
_, c_dup, _ = step19("e duplicate vote", lambda: pool19.add_evidence(dup19))
dup_route = {k: sch19.stats()[k] - s0[k] for k in ("submissions", "launches",
                                                   "lanes")}
check(pool19.size() == 1, "phase 19: the duplicate vote is not pending")
# block 25 carries it; the executor verifies the last commit on the card
# and the pool marks the evidence committed
st24 = states19[-1]
ex19 = sexec.BlockExecutor(ss19, app19, evidence_pool=pool19,
                           block_store=bs19)
block25 = st24.make_block(H19 + 1, txs17(H19 + 1, 20),
                          bs19.load_seen_commit(H19), [dup19],
                          st24.validators.get_proposer().address,
                          block_time=Timestamp(1700000000 + H19 + 1, 0))
parts25 = tparts.make_block_parts(block25)
bid25 = BlockID(block25.hash(), parts25.header())
bs19.save_block(block25, parts25, sign17(st24, bid25, H19 + 1, a_of19))
st25, c_apply, _ = step19("e apply", lambda: ex19.apply_block(
    st24, bid25, block25)[0])
check(st25.last_block_height == H19 + 1 and pool19.size() == 0
      and pool19._is_committed(dup19)
      and tev.evidence_list_hash([dup19]) == block25.header.evidence_hash,
      "phase 19: the block carrying the duplicate vote")


def fork19(lb):
    """lb with its app hash changed and re-signed by every validator of
    its set (a witness's forked chain)."""
    f = copy.deepcopy(lb)
    hdr = f.signed_header.header
    hdr.app_hash = b"\xBA\xD0" * 16
    bid = BlockID(hdr.hash(), PartSetHeader(1, b"\x99" * 32))
    vals = f.validators.validators
    sigs = [CommitSig(BlockIDFlag.COMMIT, v.address,
                      Timestamp(hdr.time.seconds, 500 + i))
            for i, v in enumerate(vals)]
    commit = Commit(hdr.height, 0, bid, sigs)
    vp = [v.pub_key.bytes() for v in vals]
    for cs, sig in zip(sigs, sign_batch(
            [a_of19[p] for p in vp], vp, commit_sign_bytes_batch(
                CHAIN, commit, list(range(len(vals)))), rng19)):
        cs.signature = sig
    f.signed_header.commit = commit
    return f


lbs19 = {h: prov_b.light_block(h) for h in range(1, H19 + 1)}
forked19 = dict(lbs19)
forked19[FORK19] = fork19(lbs19[FORK19])
prim_e = lprov.NodeBackedProvider(CHAIN, bs19, ss19, evidence_pool=pool19)
wit_e = lprov.DictProvider(CHAIN, forked19)
ce19, _, _ = step19("e anchor", lambda: client19(prim_e, [wit_e]))
div_e, c_lca, walls19["e_attack_s"] = step19("e attack", lambda: expect19(
    light.Divergence, lambda: ce19.verify_light_block_at_height(
        FORK19, NOW19), "the forked witness"))
pend19 = pool19.pending_evidence()
lca_certs = step_certs19("e attack")
check(len(pend19) == 1
      and isinstance(pend19[0], tev.LightClientAttackEvidence)
      and pend19[0].conflicting_block.hash() == forked19[FORK19].hash()
      and len(pend19[0].byzantine_validators) == N19
      and wit_e not in ce19.witnesses and ce19.store.heights() == [1]
      and len(lca_certs) == 6
      and all(c["lanes"] >= 32 and c["error"] is None
              and c["path"] in ("cuda", "comb") for c in lca_certs),
      f"phase 19: the light-client attack {cert_view19(lca_certs)} "
      f"{len(pend19)}")


# tampered copies: a flipped signature in the attack's conflicting commit,
# and in a duplicate vote
def tampered_e():
    bad = copy.deepcopy(pend19[0])
    bad.conflicting_block.signed_header.commit = flip17(
        bad.conflicting_block.signed_header.commit)
    e1 = expect19(tev.EvidenceError, lambda: pool19.add_evidence(bad),
                  "the tampered attack")
    bad2 = dup_vote19(DUP19 + 1, 9)
    bad2.vote_a.signature = bytes([bad2.vote_a.signature[0] ^ 1]) \
        + bad2.vote_a.signature[1:]
    e2 = expect19(tev.EvidenceError, lambda: pool19.add_evidence(bad2),
                  "the tampered duplicate vote")
    return str(e1), str(e2)


(e1, e2), c_bad, _ = step19("e tampered", tampered_e)
check("wrong signature (#0)" in e1 and "invalid signature" in e2
      and pool19.size() == 1,
      f"phase 19: tampered evidence {e1!r} {e2!r}")

# the attack to gossip in (f): a witness forked at height 8 makes the
# detector report it to a primary that keeps what it is sent
prim_g = lprov.DictProvider(CHAIN, lbs19)
forked_g = dict(lbs19)
forked_g[FORK19_GOSSIP] = fork19(lbs19[FORK19_GOSSIP])
cg19, _, _ = step19("e gossip anchor", lambda: client19(
    prim_g, [lprov.DictProvider(CHAIN, forked_g)]))
step19("e gossip attack", lambda: expect19(
    light.Divergence, lambda: cg19.verify_light_block_at_height(
        FORK19_GOSSIP, NOW19), "the second forked witness"))
check(len(prim_g.evidence) == 1, "phase 19: the gossip attack's evidence")
ev_g19 = prim_g.evidence[0]
cert_on19[0] = False
sch19.stop()
vsched.uninstall(sch19)
light19["evidence"] = {
    "duplicate_vote": {"hash": dup19.hash().hex(), "launches": c_dup,
                       "scheduler": dup_route, "apply_launches": c_apply},
    "attack": {"hash": pend19[0].hash().hex(),
               "byzantine": len(pend19[0].byzantine_validators),
               "certificates": cert_view19(lca_certs), "launches": c_lca,
               "wall_s": walls19["e_attack_s"]},
    "tampered": [e1, e2], "tampered_launches": c_bad}
log(phase=19, card=CARD, step="e evidence", **light19["evidence"])


# -- (f) a launch that fails on the card, no failpoint armed: K1's wrapper
# swapped for one that raises under a LightServe request and a waiter
# coalesced on its certificate, a client verify and gossiped evidence.  The
# table cache is cleared first, so the 150-validator certificates take K1.
# Each time DeviceLaneError reaches the caller: no refused verdict, no
# dropped witness, no stopped peer, nothing re-verified on the host; then the
# wrapper is restored and each step finishes
E.table_cache_clear()


def card_fault19(what, fn):
    check(not failpoints.armed(), "phase 19: a failpoint is armed")
    label19[0] = f"f {what}"
    rt = degrade.runtime()
    fails0 = counter_total(rt.metrics.device_failures)
    falls0 = counter_total(rt.metrics.host_fallbacks)
    keeping = ck.verify_packed
    ck.verify_packed = launch_failed
    try:
        out = fn()
    finally:
        ck.verify_packed = keeping
    join_abandoned()
    row = {"what": what,
           "failures": counter_total(rt.metrics.device_failures) - fails0,
           "fallbacks": counter_total(rt.metrics.host_fallbacks) - falls0}
    degrade.configure(degrade.DegradeConfig.from_env(),
                      registry=Registry(f"p19 {what}"))
    return out, row


def raises19(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - returned and checked
        return e
    return None


faults19 = []
svc_f = lserve.LightServe(bs_c, ss_c, CHAIN, prewarm=False)
svc_f.metrics = LightMetrics(Registry("p19 light serve faults"))
svc_f.start()
cl_f = Clients19(svc_f, 2)
cl_f.follow()
reqs_f = [cl_f.request(c, 5) for c in cl_f.ids]


def fault_serve():
    # both requests queued before the worker drains them: one batch, one
    # certificate, a lead and a coalesced waiter
    with svc_f._cond:
        futs = [svc_f.submit(r, client=c) for r, c in zip(reqs_f, cl_f.ids)]
    return [raises19(lambda f=f: f.result(timeout=300)) for f in futs]


errs_f, row = card_fault19("light serve", fault_serve)
st_f = svc_f.stats()
refused_f = svc_f.metrics.requests.value(outcome="refused")
row.update(errors=[type(e).__name__ for e in errs_f], stats=st_f,
           refused=refused_f)
faults19.append(row)
check(all(isinstance(e, degrade.DeviceLaneError) for e in errs_f)
      and st_f["refuted"] == 0 and refused_f == 0
      and st_f["coalesce_lead"] == 1 and st_f["coalesce_hit"] == 1
      and row["failures"] >= 1 and row["fallbacks"] == 0,
      f"phase 19: the LightServe card fault {row}")
again_f, c_again, _ = step19("f light serve again", lambda: [
    verdict19(svc_f.verify(r, client=c, timeout=300))
    for r, c in zip(reqs_f, cl_f.ids)])
svc_f.stop()
check(all(v[0] for v in again_f) and c_again.get("verify_packed", 0) >= 1,
      f"phase 19: LightServe after the card fault {again_f} {c_again}")

prov_f = lprov.NodeBackedProvider(CHAIN, bs19, ss19)
wit_f = lprov.NodeBackedProvider(CHAIN, bs19, ss19)
cf19, _, _ = step19("f client anchor", lambda: client19(prov_f, [wit_f]))
err, row = card_fault19("client", lambda: raises19(
    lambda: cf19.verify_light_block_at_height(H19, NOW19)))
row.update(error=type(err).__name__, trusted=cf19.store.heights())
faults19.append(row)
check(isinstance(err, degrade.DeviceLaneError) and cf19.primary is prov_f
      and cf19.witnesses == [wit_f] and cf19.store.heights() == [1]
      and row["failures"] >= 1 and row["fallbacks"] == 0,
      f"phase 19: the client's card fault {row} ({err!r})")
step19("f client again", lambda: cf19.verify_light_block_at_height(
    H19, NOW19))
check(cf19.store.heights() == trace_b,
      f"phase 19: the client after the card fault {cf19.store.heights()}")


class StopSwitch19:
    """The reactor's switch: no peers to push to; stops recorded."""

    def __init__(self):
        self.peers = {}
        self.stopped = []

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append(reason)


reactor19 = evreactor.EvidenceReactor(pool19)
reactor19.switch = sw19 = StopSwitch19()
peer19 = SimpleNamespace(id="gossip-peer", data={},
                         try_send=lambda ch, m: True)
msg19 = evreactor.encode_msg(evreactor.EvidenceGossip(
    [tev.evidence_proto(ev_g19)]))
size0 = pool19.size()
_, row = card_fault19("evidence reactor", lambda: reactor19.receive(
    evreactor.EVIDENCE_CHANNEL, peer19, msg19))
row.update(device_error=type(reactor19.device_error).__name__,
           peers_stopped=list(sw19.stopped), pending=pool19.size())
faults19.append(row)
check(isinstance(reactor19.device_error, degrade.DeviceLaneError)
      and sw19.stopped == [] and pool19.size() == size0
      and row["failures"] >= 1 and row["fallbacks"] == 0,
      f"phase 19: the evidence reactor's card fault {row}")
step19("f evidence again", lambda: reactor19.receive(
    evreactor.EVIDENCE_CHANNEL, peer19, msg19))
check(pool19.size() == size0 + 1 and sw19.stopped == [],
      "phase 19: the gossiped evidence after the card fault")
log(phase=19, card=CARD, step="f card faults", faults=faults19)
light19["faults"] = faults19

# -- every launch of the phase against its plain version on the same inputs
# (grouped by step), C2 against the plain tables of the build it used, and
# the skipping hop's light certificate (K2) against OpenSSL's verdicts
label19[0] = ""
for _name in keep19:
    setattr(KERNEL_MOD[_name], _name, was19[_name])
for _n, _f in REAL19.items():
    setattr(ValidatorSet, _n, _f)
E.prewarm = REAL_PREWARM19
cmp19 = {name: [] for name in keep19}
t = time.perf_counter()
for name, plain in (("verify_packed", ck.verify_packed_plain),
                    ("verify_packed_split", ck.verify_packed_split_plain)):
    runs = keep19[name]
    if not runs:
        continue
    got = torch.cat([out for _, _, out in runs])
    cols = [torch.cat([args[k] for _, args, _ in runs], dim=1)
            for k in range(len(runs[0][1]))]
    step_of = np.repeat([label.split(" ")[0] or "-" for label, _, _ in runs],
                        [out.shape[0] for _, _, out in runs])
    real = (cols[-1] != 0).any(dim=0)
    check(not got[~real].any(), f"phase 19 {name}: a padding lane passed")
    got = got[real].cpu().numpy()
    step_of = step_of[real.cpu().numpy()]
    cols = [c[:, real] for c in cols]
    want = torch.cat([plain(*[c[:, a:a + 65_536] for c in cols]).cpu()
                      for a in range(0, len(got), 65_536)]).numpy()
    err = np.abs(got.astype(int) - want.astype(int))
    for g in sorted(set(step_of)):
        on = step_of == g
        n_runs = sum((label.split(" ")[0] or "-") == g
                     for label, _, _ in runs)
        cmp19[name].append((f"phase 19 ({g}): {n_runs} launches",
                            int(on.sum()), int(err[on].sum()),
                            float(err[on].max())))
builds19 = {}
for label, args, (tab, ok) in keep19["comb_build"]:
    ptab, pok = cc.comb_build_plain(args[0])
    builds19[id(tab)] = (ptab, pok)
    cmp19["comb_build"].append(
        (f"phase 19 {label}", args[0].shape[0],
         cc.tables_mismatch(tab, ptab) + int((ok != pok).sum())))
check(len(keep19["comb_build"]) == 2
      and all(id(args[1]) in builds19 for _, args, _ in keep19["comb_verify"]),
      "phase 19: a C2 launch on a table that no build of the phase made")
for key, (ptab, pok) in builds19.items():
    runs = [(args, out) for _, args, out in keep19["comb_verify"]
            if id(args[1]) == key]
    if not runs:
        continue
    rows_c2 = torch.cat([args[0] for args, _ in runs])
    got = torch.cat([out for _, out in runs]).cpu().numpy()
    cmp19["comb_verify"].append(c2_row(
        f"phase 19: {len(runs)} launches on one table", got,
        cc.comb_verify_plain(rows_c2, ptab, pok).cpu().numpy()))
plain19_s = time.perf_counter() - t
# the OpenSSL check: the last K2 launch of the skipping hop is its light
# certificate, height 6's 2/3 prefix in the set's order
hop = [out for label, _, out in keep19["verify_packed_split"]
       if label == "a skip"]
commit6 = big_bs19.load_seen_commit(H17_BIG)
idx6 = vals6.collect_commit_light(CHAIN, commit6.block_id, H17_BIG, commit6)
msgs6 = commit_sign_bytes_batch(CHAIN, commit6, idx6)
want6 = np.array([edkeys._ossl_verify(vals6.validators[i].pub_key.bytes(),
                                      m, commit6.signatures[i].signature)
                  for i, m in zip(idx6, msgs6)], dtype=bool)
kern6 = hop[-1].cpu().numpy() if hop else np.zeros(0, dtype=bool)
n6 = len(idx6)
oracle19 = ("the skipping hop's light certificate", n6,
            int((kern6[:n6] != want6).sum()) if len(kern6) >= n6 else -1,
            int(kern6[n6:].sum()), bool(want6.all()))
check(hop and oracle19[2] == 0 and oracle19[3] == 0 and oracle19[4],
      f"phase 19: the certificate's bitmap against OpenSSL's {oracle19}")
big_bdb19.close()
big_sdb19.close()
E.table_cache_clear()
staging_clear(19)
shutil.rmtree(root17)
launches19 = {name: len(v) for name, v in keep19.items()}
light19.update(comparisons=cmp19, openssl=oracle19, launches=launches19,
               walls_s=walls19, plain_s=plain19_s,
               phase_s=time.perf_counter() - T19)
log(phase=19, card=CARD, launches=launches19, comparisons=cmp19,
    openssl=oracle19, plain_s=plain19_s, walls_s=walls19,
    phase_s=light19["phase_s"])
check(all(r[2] == 0 for rows in cmp19.values() for r in rows),
      f"phase 19: a kernel disagrees with its plain version: {cmp19}")
REPORT["light"] = light19

# -- phase 20: the mempool and the validator signer ---------------------------

# The mempool (Mempool, PriorityMempool, the IngressGate, the MempoolReactor)
# and the validator signer (FilePV, the remote signer, its harness) on the
# card, at the reference DefaultMempoolConfig (`tendermint_tpu/config/
# config.py:47-67`: size 5,000, cache 10,000, an ingress queue of 8,192,
# batches of 256, one worker, recheck slices of 256), passed to the
# constructors.  Signed txs are SIGTX envelopes (mempool/ingress.py) from
# 1,000 in-repo ed25519 keys over a payload k<i>=v<i> padded to 64 bytes
# (166 bytes a tx), signed before the steps that submit them; the gate
# pre-verifies them through a VerifyScheduler on the card at
# Priority.MEMPOOL (K1).  (a) 6,000 signed txs (1% corrupted, 5%
# resubmitted, 200 plain) through a gate over a Mempool and the kvstore,
# against the synchronous check_tx path; (b) the same over a
# PriorityMempool, against a gate on device="cpu"; (c) 150-validator blocks
# reaped from (a)'s pool while four clients flood 6,000 more; (d) the
# MEMPOOL shed under consensus load (max_pending 1,024); (e) gossip between
# two Switches over TCP on 127.0.0.1; (f) 150 FilePVs (four behind
# SignerServers) signing a height that applies, the double-sign guards, the
# harness and a redial; (g) the ingress.* drills, then K1's wrapper raising
# with no failpoint armed under a gate batch, a gossiped batch and check_tx.
# Walls are host-clock, logged and not gated; every response, route and
# count named below is.
N20_KEYS, N20 = 1000, 150
A20, BAD20, DUP20, PLAIN20 = 6000, 60, 300, 200    # (a) and (b)
C20, CLIENTS20, D20, E20 = 6000, 4, 20_000, 2000   # (c), (d), (e)
MP20 = {"size_limit": 5000, "cache_size": 10_000}
GATE20 = {"queue_size": 8192, "batch": 256, "workers": 1,
          "recheck_slice": 256}
REASONS20 = ("full", "busy", "cache", "ratelimit", "sig", "app_err",
             "toolarge")
T20 = time.perf_counter()
rng20 = random.Random(SEED + 20)
E.table_cache_clear()
check(not msm.use_rlc(10_000) and not failpoints.armed()
      and vsched.installed() is None and bpipe.installed() is None,
      "phase 20: RLC, a failpoint, a scheduler or a pipeline is still on")
degrade.configure(degrade.DegradeConfig.from_env(), registry=Registry("p20"))
ingress.set_enabled(None)
ON_CARD20 = DEV.type == "cuda"
# the interpreter's garbage collections in the phase (phase 17's counter).
# The earlier phases' objects are frozen out of the collector's walks (and
# stay so through phase 21): the process holds every one of them, so a full
# collection took seconds (3.1 s in PR 18's phase 20), and one landing on
# the first gate batch outlasts its pre-verify's 1 s result timeout, after
# which the gate admits the batch unverified, by its policy
gc.collect()
gc.freeze()
gc17.update(n=[0, 0, 0], s=[0.0, 0.0, 0.0])
gc.callbacks.append(_gc17)
# every K1, K2, C1 and C2 launch of the phase: (label, inputs, output)
keep20 = {name: [] for name in ("verify_packed", "verify_packed_split",
                                "comb_build", "comb_verify")}
label20 = [""]
was20 = {name: getattr(KERNEL_MOD[name], name) for name in keep20}
_keep20_lock = threading.Lock()


def _keeping20(name):
    """The bare wrapper (REAL), keeping a copy of every launch's tensor
    inputs (C2's tables by reference) and its output; the gate's windows
    and the commit checks launch from the runtime's lane thread."""
    def wrapper(*args):
        out = REAL[name](*args)
        kept = [a.clone() if isinstance(a, torch.Tensor)
                and not (name == "comb_verify" and i == 1) else a
                for i, a in enumerate(args)]
        with _keep20_lock:
            keep20[name].append((label20[0], kept, out))
        return out
    return wrapper


for _name in keep20:
    setattr(KERNEL_MOD[_name], _name, _keeping20(_name))


def k1_rows20(prefix):
    """(launches, padded lanes, real lanes) of the phase's K1 launches whose
    label starts with prefix."""
    runs = [r for r in keep20["verify_packed"] if r[0].startswith(prefix)]
    real = sum(int((args[0] != 0).any(dim=0).sum()) for _, args, _ in runs)
    return {"launches": len(runs),
            "lanes": sum(int(out.shape[0]) for _, _, out in runs),
            "real_lanes": real}


keys20 = [edkeys.PrivKey(hashlib.sha256(b"phase 20 key %d" % i).digest())
          for i in range(N20_KEYS)]
MAGIC20 = len(ingress.SIGTX_MAGIC)
_seq20 = [0]


def sigtxs20(n):
    """n fresh SIGTX envelopes over k<i>=v<i> padded to 64 bytes, i counting
    across the phase, signed by key i mod 1,000."""
    out = []
    for _ in range(n):
        i = _seq20[0]
        _seq20[0] += 1
        payload = (b"k%d=v%d" % (i, i)).ljust(64, b".")
        out.append(ingress.make_signed_tx(keys20[i % N20_KEYS], payload))
    return out


def corrupt20(tx):
    """The envelope with its signature's first byte flipped."""
    b = bytearray(tx)
    b[MAGIC20 + 32] ^= 0x01
    return bytes(b)


class App20:
    """The port's kvstore behind CheckTx: every tx asked about is recorded;
    a signed tx's priority is its signature's first byte mod 8 (the kvstore
    sets none, and a PriorityMempool orders by it); a tx in `stale` fails
    its recheck."""

    def __init__(self, kv=None):
        self.kv = kv if kv is not None else KVStoreApplication()
        self.seen = []
        self.stale = set()

    def check_tx(self, req):
        self.seen.append(req.tx)
        if (req.type == abci_t.CheckTxType.RECHECK
                and req.tx in self.stale):
            return abci_t.ResponseCheckTx(code=3, log="stale")
        res = self.kv.check_tx(req)
        if req.tx.startswith(ingress.SIGTX_MAGIC) \
                and len(req.tx) > MAGIC20 + 32:
            res.priority = req.tx[MAGIC20 + 32] % 8
        return res


def sched20(**kw):
    """A scheduler on the card with the constructor's defaults (but for kw)
    and a fresh SigCache, so that a step's signatures are verified on the
    card and not found among an earlier step's."""
    cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
    s = vsched.install(vsched.VerifyScheduler(device=DEV, **kw))
    s.start()
    return s


def stop_sched20(s):
    s.stop()
    vsched.uninstall(s)


def gate20(mp, device=DEV, **kw):
    g = ingress.IngressGate(mp, **{**GATE20, **kw}, device=device).attach()
    g.start()
    return g


def settle20(futs, timeout=300.0):
    """Each future's ResponseCheckTx, or the exception it raises."""
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=timeout))
        except Exception as e:  # noqa: BLE001 - returned and checked
            out.append(e)
    return out


def ok20(r):
    return isinstance(r, abci_t.ResponseCheckTx) and r.is_ok()


def view20(r):
    if isinstance(r, abci_t.ResponseCheckTx):
        return (r.code, r.codespace, r.log)
    return type(r).__name__


def reasons20(mp):
    return {r: mp.metrics.rejected_txs.value(reason=r) for r in REASONS20}


def wait20(cond, what, timeout):
    end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < end, f"phase 20: {what} timed out")
        time.sleep(0.002)


def workers_alive20(g):
    return all(th.is_alive() for th in g._threads
               if th.name.startswith("ingress-worker"))


# MEMPOOL submissions of step (a): (items, future), for the OpenSSL check
subs20: list = []


def record_subs20(s):
    real = s.submit

    def submit(items, prio, *a, **k):
        fut = real(items, prio, *a, **k)
        if prio == vsched.Priority.MEMPOOL and len(subs20) < 64:
            subs20.append((list(items), fut))
        return fut
    s.submit = submit


mempool20: dict = {"card": CARD}
walls20: dict = {}

# -- (a) admission through the gate over a Mempool: 6,000 signed txs (60
# corrupted), 200 plain, 300 resubmissions of txs the pool admitted early
# (among the first half, each at least two batches after its original, so
# a batch never holds both), in a seeded order, from one thread
t = time.perf_counter()
signed_a = sigtxs20(A20)
walls20["sign_a"] = time.perf_counter() - t
check(all(len(tx) == 166 for tx in signed_a), "phase 20: a tx is not 166 B")
bad_a = set(rng20.sample(range(A20), BAD20))
signed_a = [corrupt20(tx) if i in bad_a else tx
            for i, tx in enumerate(signed_a)]
bad_set20 = {signed_a[i] for i in bad_a}
seq_a = signed_a + [b"plain%d=v%d" % (i, i) for i in range(PLAIN20)]
rng20.shuffle(seq_a)
_cand = [j for j in range(len(seq_a) // 2) if seq_a[j] not in bad_set20]
for _at, _tx in sorted(((rng20.randrange(j + 2 * GATE20["batch"],
                                         len(seq_a) + 1), seq_a[j])
                        for j in rng20.sample(_cand, DUP20)), reverse=True):
    seq_a.insert(_at, _tx)
kv_a = KVStoreApplication()
app_a = App20(kv_a)
mp_a = Mempool(app_a, registry=Registry("p20 a"), **MP20)
s_a = sched20()
record_subs20(s_a)
g_a = gate20(mp_a)
label20[0] = "a v0"


def run_a():
    t = time.perf_counter()
    futs = [g_a.submit(tx) for tx in seq_a]
    t_sub = time.perf_counter() - t
    res = settle20(futs)
    return res, t_sub, time.perf_counter() - t


gc_a = sum(gc17["s"])
(res_a, sub_a_s, wall_a), c_a = main_path(run_a, site="sched.ed25519")
gc_a = sum(gc17["s"]) - gc_a
st_sched_a = s_a.stats()
stop_sched20(s_a)
# a corrupted tx is refused "invalid signature" by the pre-verify, or, once
# the pool is full, "mempool is full" by the precheck that comes before it
FULL20 = (1, "", "mempool is full")
INVALID20 = (1, "ingress", "invalid signature")
first_full_a = next(k for k, r in enumerate(res_a) if view20(r) == FULL20)
bad_views_a = [(k, view20(res_a[k])) for k, tx in enumerate(seq_a)
               if tx in bad_set20]
check(all(v == INVALID20 or (v == FULL20 and k > first_full_a)
          for k, v in bad_views_a)
      and all(v == INVALID20 for k, v in bad_views_a if k < first_full_a),
      f"phase 20 (a): corrupted txs answered {bad_views_a}")
check(not bad_set20 & set(app_a.seen),
      "phase 20 (a): a corrupted tx reached the app's CheckTx")
twin_a = Mempool(App20(), registry=Registry("p20 a twin"), **MP20)
good_a = [(tx, r) for tx, r in zip(seq_a, res_a) if tx not in bad_set20]
t = time.perf_counter()
gc_sync_a = sum(gc17["s"])
want_a = [twin_a.check_tx(tx) for tx, _ in good_a]
walls20["sync_a"] = time.perf_counter() - t
gc_sync_a = sum(gc17["s"]) - gc_sync_a
mism_a = sum(r != w for (_, r), w in zip(good_a, want_a))
pool_a = mp_a.reap_max_txs(-1)
views_a = [view20(r) for r in res_a]
rows_a = k1_rows20("a ")
admitted_a = sum(ok20(r) for r in res_a)
st_a = g_a.stats()
mempool20["a"] = {
    "submitted": len(seq_a), "admitted": admitted_a,
    "responses": {str(v): views_a.count(v) for v in sorted(set(views_a),
                                                           key=str)},
    "rejected_total": reasons20(mp_a), "gate": st_a,
    "app_checktx_calls": len(app_a.seen), "submit_s": sub_a_s,
    "wall_s": wall_a, "admitted_per_s": admitted_a / wall_a,
    "sync_wall_s": walls20["sync_a"], "gc_s": gc_a, "sync_gc_s": gc_sync_a,
    "sync_admitted_per_s": sum(w.is_ok() for w in want_a)
    / walls20["sync_a"],
    "launches": {k: v for k, v in c_a.items() if v}, "k1": rows_a,
    "scheduler": {k: st_sched_a[k] for k in (
        "launches", "lanes", "submissions", "items", "cache_hits", "dedup",
        "shed", "exec_faults", "mean_batch", "stage_s", "exec_busy_s")
        if k in st_sched_a},
    "sync_mismatches": mism_a, "pool": len(pool_a),
    "corrupted": {"invalid_signature": sum(v == INVALID20
                                           for _, v in bad_views_a),
                  "full": sum(v == FULL20 for _, v in bad_views_a)},
    "sign_s": walls20["sign_a"]}
log(phase=20, card=CARD, step="a admission v0", **mempool20["a"])
check(mism_a == 0 and pool_a == twin_a.reap_max_txs(-1)
      and len(pool_a) == MP20["size_limit"]
      and views_a.count((1, "", "mempool is full")) > 0
      and c_a["verify_packed"] == rows_a["launches"] > 0
      and st_a["sig_rejected"] == sum(v == INVALID20 for _, v in bad_views_a)
      > 0 and st_a["device_error"] == 0,
      f"phase 20 (a): {mism_a} responses differ from the synchronous path, "
      f"pool {len(pool_a)}, launches {c_a}, gate {st_a}")
# one pre-verify window's bitmap against OpenSSL's: the first of the gate's
# MEMPOOL submissions that holds a corrupted tx
win_a = next(((items, fut) for items, fut in subs20
              if any(ingress.SIGTX_MAGIC + bytes(pub) + bytes(sig)
                     + msg[MAGIC20 + 32:] in bad_set20
                     for pub, msg, sig in items)), None)
check(win_a is not None, "phase 20 (a): no window held a corrupted tx")
bits_a = np.asarray(win_a[1].result(timeout=0))
want_bits_a = np.array([edkeys._ossl_verify(bytes(p), m, bytes(s))
                        for p, m, s in win_a[0]], dtype=bool)
oracle20 = ("(a) a pre-verify window", len(want_bits_a),
            int((bits_a != want_bits_a).sum()), int((~want_bits_a).sum()))
check(oracle20[2] == 0 and oracle20[3] > 0,
      f"phase 20 (a): the window's bitmap against OpenSSL's {oracle20}")


# -- (b) the same sequence over a PriorityMempool, a batch of 256 at a time
# (each submitted under the gate's condition and settled before the next,
# so the batches, and with them the pool's evictions, are the same in every
# run), on the card and then on a gate and scheduler on device="cpu"
def chunked20(g, seq, chunk=256):
    res = []
    for i in range(0, len(seq), chunk):
        with g._cond:
            futs = [g.submit(tx) for tx in seq[i:i + chunk]]
        res += settle20(futs)
    return res


s_b = sched20()
app_b = App20()
mp_b = PriorityMempool(app_b, registry=Registry("p20 b"), **MP20)
g_b = gate20(mp_b)
label20[0] = "b v1"
(res_b, wall_b), c_b = main_path(lambda: timed_call(lambda: chunked20(
    g_b, seq_a)), site="sched.ed25519")
g_b.stop()
stop_sched20(s_b)
order_b = mp_b.reap_max_bytes_max_gas(-1, -1)
s_bc = vsched.install(vsched.VerifyScheduler(device="cpu"))
s_bc.start()
app_bc = App20()
mp_bc = PriorityMempool(app_bc, registry=Registry("p20 b cpu"), **MP20)
g_bc = gate20(mp_bc, device="cpu")
label20[0] = "b cpu"
(res_bc, wall_bc), c_bc = main_path(lambda: timed_call(lambda: chunked20(
    g_bc, seq_a)))
g_bc.stop()
stop_sched20(s_bc)
order_bc = mp_bc.reap_max_bytes_max_gas(-1, -1)
views_b = [view20(r) for r in res_b]
prio_b = [tx[MAGIC20 + 32] % 8 if tx.startswith(ingress.SIGTX_MAGIC) else 0
          for tx in order_b]
rows_b = k1_rows20("b v1")
mempool20["b"] = {
    "admitted": sum(ok20(r) for r in res_b), "wall_s": wall_b,
    "admitted_per_s": sum(ok20(r) for r in res_b) / wall_b,
    "responses": {str(v): views_b.count(v) for v in sorted(set(views_b),
                                                           key=str)},
    "rejected_total": reasons20(mp_b), "gate": g_b.stats(),
    "launches": {k: v for k, v in c_b.items() if v}, "k1": rows_b,
    "cpu_wall_s": wall_bc, "cpu_launches": sum(c_bc.values()),
    "pool": len(order_b),
    "priorities_reaped": {p: prio_b.count(p) for p in range(8)}}
log(phase=20, card=CARD, step="b admission v1", **mempool20["b"])
check(order_b == order_bc and views_b == [view20(r) for r in res_bc]
      and len(order_b) == MP20["size_limit"]
      and not bad_set20 & set(app_b.seen)
      and views_b.count((1, "ingress", "invalid signature")) == BAD20
      and prio_b == sorted(prio_b, reverse=True)
      and c_b["verify_packed"] == rows_b["launches"] > 0
      and sum(c_bc.values()) == 0,
      f"phase 20 (b): the PriorityMempool's reap order or responses differ "
      f"from the device='cpu' run's, or launches {c_b} / {c_bc}")

# -- (c) into blocks: a 150-validator kvstore chain whose BlockExecutor reaps
# (a)'s pool (its gate attached, the recheck offloaded to the gate's worker)
# with the default block size, each height's last commit verified on K1,
# while four clients flood 6,000 more signed txs (1% corrupted) through the
# gate, chunks of 64 each waited for, a tx refused "mempool is full"
# submitted again; heights go on until every client is done and the pool is
# empty
gdoc20, a_of20, pubs20 = chain_keys17(N20)


def executor20(gdoc, kv, mempool=None):
    conns = AppConns(ClientCreator.local(kv))
    conns.consensus.init_chain(abci_t.RequestInitChain(
        chain_id=gdoc.chain_id, validators=[
            abci_t.ValidatorUpdate("ed25519", v.pub_key_bytes, v.power)
            for v in gdoc.validators]))
    ss, bs = StateStore(MemDB()), BlockStore(MemDB())
    state = state_from_genesis(gdoc)
    ss.save(state)
    return sexec.BlockExecutor(ss, conns.consensus, mempool=mempool,
                               block_store=bs), bs, state


ex_c, bs_c20, state_c = executor20(gdoc20, kv_a, mempool=mp_a)
upd20: list = []
_real_update_a = mp_a.update


def _timed_update20(height, txs):
    t = time.perf_counter()
    _real_update_a(height, txs)
    upd20.append({"height": height, "committed": len(txs),
                  "update_s": time.perf_counter() - t,
                  "resident": len(mp_a._txs)})


mp_a.update = _timed_update20
t = time.perf_counter()
flood_c = sigtxs20(C20)
walls20["sign_c"] = time.perf_counter() - t
bad_c_idx = set(rng20.sample(range(C20), C20 // 100))
flood_c = [corrupt20(tx) if i in bad_c_idx else tx
           for i, tx in enumerate(flood_c)]
bad_c = {flood_c[i] for i in bad_c_idx}
admitted_c: list = []
refused_c: list = []
retried_c = [0]


def client20(txs):
    pending = list(txs)
    while pending:
        again = []
        for i in range(0, len(pending), 64):
            chunk = pending[i:i + 64]
            res = settle20([g_a.submit(tx) for tx in chunk])
            full = False
            for tx, r in zip(chunk, res):
                if ok20(r):
                    admitted_c.append(tx)
                elif isinstance(r, abci_t.ResponseCheckTx) \
                        and r.log == "mempool is full":
                    again.append(tx)
                    full = True
                else:
                    refused_c.append((tx, view20(r)))
            if full:
                time.sleep(0.05)
        retried_c[0] += len(again)
        pending = again


s_c = sched20()
heights_c: list = []
blocks_c: list = []
label20[0] = "c blocks"


def run_c():
    global state_c
    bulk = degrade.runtime().metrics.device_launches
    last = Commit(0, 0, BlockID(), [])
    threads = [threading.Thread(target=client20, args=(flood_c[k::CLIENTS20],),
                                daemon=True, name=f"client20-{k}")
               for k in range(CLIENTS20)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    h = 0
    while True:
        h += 1
        t = time.perf_counter()
        block = ex_c.create_proposal_block(
            h, state_c, last, state_c.validators.get_proposer().address)
        reap_s = time.perf_counter() - t
        parts = tparts.make_block_parts(block)
        bid = BlockID(block.hash(), parts.header())
        seen = sign17(state_c, bid, h, a_of20)
        bs_c20.save_block(block, parts, seen)
        rc0 = g_a.stats()["rechecked"]
        b0 = bulk.value(site="bulk.ed25519")
        t = time.perf_counter()
        state_c = ex_c.apply_block(state_c, bid, block)[0]
        apply_s = time.perf_counter() - t
        u = upd20[-1]
        t = time.perf_counter()
        wait20(lambda: g_a.stats()["rechecked"] - rc0 >= u["resident"],
               f"(c) height {h}'s offloaded recheck", 120)
        heights_c.append({
            "height": h, "txs": len(block.data.txs), "reap_s": reap_s,
            "apply_s": apply_s, "update_s": u["update_s"],
            "committed": u["committed"], "resident": u["resident"],
            "recheck_s": time.perf_counter() - t,
            "bulk_launches": bulk.value(site="bulk.ed25519") - b0})
        blocks_c.append(list(block.data.txs))
        last = seen
        done = not any(th.is_alive() for th in threads)
        if done and mp_a.size() == 0 and g_a.depth() == 0:
            break
        check(time.perf_counter() - t0 < 600,
              "phase 20 (c): the pool did not empty within 600 s")
        if not block.data.txs:
            time.sleep(0.05)
    for th in threads:
        th.join()
    return time.perf_counter() - t0


wall_c, c_c = main_path(run_c, site="bulk.ed25519")
st_sched_c = s_c.stats()
stop_sched20(s_c)
in_blocks = [tx for txs in blocks_c for tx in txs]
ok_a = {tx for tx, r in zip(seq_a, res_a) if ok20(r)}
# the commits' K1 launches: 150 real lanes, every A row a validator's key
vkeys20 = set(pubs20[:N20])
commit_k1 = []
for _lab, _args, _out in keep20["verify_packed"]:
    if _lab != "c blocks":
        continue
    _real = (_args[0] != 0).any(dim=0)
    _a = _args[0][:32, _real].t().contiguous().cpu().numpy()
    if len(_a) == N20 and all(bytes(r) in vkeys20 for r in _a):
        commit_k1.append(int(_out.shape[0]))
rows_c = k1_rows20("c ")
mempool20["c"] = {
    "heights": heights_c, "wall_s": wall_c,
    "txs_in_blocks": len(in_blocks),
    "txs_per_s": len(in_blocks) / wall_c,
    "flood_admitted": len(admitted_c), "flood_refused": len(refused_c),
    "flood_retried_full": retried_c[0], "gate": g_a.stats(),
    "launches": {k: v for k, v in c_c.items() if v}, "k1": rows_c,
    "commit_k1_lanes": commit_k1,
    # the gate's windows on K1; the rest, below tpu_threshold (32 lanes),
    # took the host lane
    "gate_windows_on_k1": rows_c["launches"] - len(commit_k1),
    "scheduler": {k: st_sched_c[k] for k in ("launches", "lanes",
                                             "submissions", "cache_hits")
                  if k in st_sched_c},
    "offload_hook": mp_a.recheck_offload == g_a._schedule_recheck}
log(phase=20, card=CARD, step="c into blocks", **mempool20["c"])
check(len(in_blocks) == len(set(in_blocks))
      and not set(in_blocks) & (bad_c | bad_set20)
      and set(in_blocks) <= ok_a | set(admitted_c)
      and set(admitted_c) | set(pool_a) == set(in_blocks)
      and {tx for tx, _ in refused_c} == bad_c
      and all(v == (1, "ingress", "invalid signature") for _, v in refused_c)
      and mp_a.size() == 0,
      f"phase 20 (c): blocks hold {len(in_blocks)} txs ("
      f"{len(set(in_blocks))} distinct), {len(admitted_c)} flood txs "
      f"admitted, refused {len(refused_c)}")
check(mempool20["c"]["offload_hook"]
      and all(r["bulk_launches"] == (0 if r["height"] == 1 else 1)
              for r in heights_c)
      and commit_k1 == [256] * (len(heights_c) - 1),
      f"phase 20 (c): the recheck hook, or the commits' K1 launches "
      f"{commit_k1} over {len(heights_c)} heights")

# -- (d) the shed under consensus load: a scheduler with max_pending 1,024
# (four gate batches) and a gate of sixteen workers (so that more than four
# batches wait for a window while the stager stages the last one) over a
# PriorityMempool (its fullness is decided at insert, so every tx is
# pre-verified); one
# thread floods 20,000 signed txs while a loop pre-verifies a fresh
# 150-validator precommit set at CONSENSUS with a 5 ms deadline (one lane
# corrupted) and verifies a 150-validator commit under COMMIT; first ten
# rounds without the flood
s_d = sched20(max_pending=1024)
app_d = App20()
mp_d = PriorityMempool(app_d, registry=Registry("p20 d"), **MP20)
g_d = gate20(mp_d, workers=16)
t = time.perf_counter()
flood_d = sigtxs20(D20)
walls20["sign_d"] = time.perf_counter() - t
a_d, p_d = gen_keys(N20, rng20)
vset_d, commit_d, bid_d, _ = make_commit(N20, rng20, height=20)


def votes20(r):
    """The round's precommit triples (fresh signatures, lane r mod 150
    corrupted) and the expected bitmap."""
    sigs = [CommitSig(BlockIDFlag.COMMIT, b"\x00" * 20,
                      Timestamp(1700002000 + r, i)) for i in range(N20)]
    cm_r = Commit(1000 + r, 0, BlockID(b"\x41" * 32,
                                       PartSetHeader(1, b"\x42" * 32)), sigs)
    msgs = commit_sign_bytes_batch(CHAIN, cm_r, list(range(N20)))
    sig = sign_batch(a_d, p_d, msgs, rng20)
    j = r % N20
    sig[j] = corrupt(sig[j], rng20)
    expect = np.ones(N20, dtype=bool)
    expect[j] = False
    return [(edkeys.PubKey(p), m, s) for p, m, s in zip(p_d, msgs, sig)], \
        expect


metrics_d = degrade.runtime().metrics
shed0 = {p: metrics_d.sched_shed_total.value(priority=p)
         for p in ("mempool", "consensus", "commit")}
miss0_d = metrics_d.sched_deadline_miss.value(priority="consensus")
cons_d = {"alone": [], "flood": []}
exact_d: list = []
commit_err_d: list = []


def consensus20(key, stop):
    r = len(exact_d)
    while not stop():
        items, expect = votes20(r)
        r += 1
        t = time.perf_counter()
        ok, bits = vsched.verify_items(
            items, vsched.Priority.CONSENSUS,
            deadline=time.monotonic() + 0.005, device=DEV)
        cons_d[key].append(time.perf_counter() - t)
        exact_d.append(bool(np.array_equal(bits, expect)) and not ok)
        with vsched.priority_context(vsched.Priority.COMMIT):
            commit_err_d.append(commit_error_index(vset_d, bid_d, commit_d,
                                                   height=20))


futs_d: list = []
depth_d: list = []


def flood20():
    # the first queue-full is submitted under the gate's condition: every
    # worker finds a whole batch when it is released, and they submit
    # their pre-verifies one after another, faster than the stager takes
    # windows of them; the rest as fast as the queue takes it
    with g_d._cond:
        for tx in flood_d[:GATE20["queue_size"]]:
            futs_d.append(g_d.submit(tx, source="p2p:flood"))
        depth_d.append(g_d.depth())
    for i, tx in enumerate(flood_d[GATE20["queue_size"]:]):
        futs_d.append(g_d.submit(tx, source="p2p:flood"))
        if not i % 128:
            depth_d.append(g_d.depth())
    depth_d.append(g_d.depth())


label20[0] = "d shed"


def run_d():
    consensus20("alone", lambda: len(cons_d["alone"]) >= 10)
    th = threading.Thread(target=flood20, daemon=True, name="flood20")
    t0 = time.perf_counter()
    th.start()
    consensus20("flood", lambda: not th.is_alive() and all(
        f.done() for f in futs_d))
    th.join()
    res = settle20(futs_d)
    return res, time.perf_counter() - t0


(res_d, wall_d), c_d = main_path(run_d, site="sched.ed25519")
st_sched_d = s_d.stats()
st_d = g_d.stats()
g_d.stop()
stop_sched20(s_d)
views_d = [view20(r) for r in res_d]
shed_d = {p: metrics_d.sched_shed_total.value(priority=p) - shed0[p]
          for p in shed0}
hints_d = [f.retry_after_s for f, v in zip(futs_d, views_d)
           if v[1:] == ("ingress", "mempool is busy (verify shed)")]
busy_q = [f.retry_after_s for f, v in zip(futs_d, views_d)
          if v[1:] == ("ingress", "mempool is busy")]
rows_d = k1_rows20("d ")
mempool20["d"] = {
    "votes_ms_alone": {"p50": pctl(cons_d["alone"], 0.5) * 1e3,
                       "p99": pctl(cons_d["alone"], 0.99) * 1e3,
                       "n": len(cons_d["alone"])},
    "votes_ms_flood": {"p50": pctl(cons_d["flood"], 0.5) * 1e3,
                       "p99": pctl(cons_d["flood"], 0.99) * 1e3,
                       "n": len(cons_d["flood"])},
    "consensus_deadline_misses": metrics_d.sched_deadline_miss.value(
        priority="consensus") - miss0_d,
    "shed_total": shed_d, "preverify_shed": st_d["preverify_shed"],
    "busy_verify_shed": len(hints_d), "busy_queue_full": len(busy_q),
    "retry_after_s": [min(hints_d + busy_q, default=None),
                      max(hints_d + busy_q, default=None)],
    "admitted": sum(ok20(r) for r in res_d), "wall_s": wall_d,
    "queue_depth_max": max(depth_d, default=0),
    "responses": {str(v): views_d.count(v) for v in sorted(set(views_d),
                                                           key=str)},
    "gate": st_d, "launches": {k: v for k, v in c_d.items() if v},
    "k1": rows_d,
    "scheduler": {k: st_sched_d[k] for k in ("launches", "lanes", "shed",
                                             "submissions", "cache_hits")
                  if k in st_sched_d}}
log(phase=20, card=CARD, step="d shed", **mempool20["d"])
check(st_d["preverify_shed"] > 0 and shed_d["mempool"] > 0
      and len(hints_d) > 0 and all(h is not None and h > 0 for h in hints_d)
      and shed_d["consensus"] == 0 and all(exact_d)
      and all(e is None for e in commit_err_d)
      and len(cons_d["flood"]) > 0
      and max(depth_d, default=0) <= GATE20["queue_size"]
      and not any(isinstance(r, Exception) for r in res_d),
      f"phase 20 (d): shed {shed_d}, gate {st_d}, consensus exact "
      f"{sum(exact_d)}/{len(exact_d)}, commit errors "
      f"{[e for e in commit_err_d if e]}, depth {max(depth_d, default=0)}")


# -- (e) gossip: two Switches on 127.0.0.1, each with a MempoolReactor, its
# own gate and its own Mempool; 2,000 txs admitted at A, then B dials A and
# A's broadcast routine sends them; B admits them through its gate with the
# source p2p:<A's id>.  Both gates share one scheduler on the card, and with
# it the SigCache that A's pre-verify filled
def node20(i):
    app = App20()
    mp = Mempool(app, registry=Registry(f"p20 e{i}"), **MP20)
    g = gate20(mp)
    r = mreactor.MempoolReactor(mp, gate=g)
    sw = Switch(NodeKey(edkeys.PrivKey(hashlib.sha256(
        b"phase 20 node %d" % i).digest())), "127.0.0.1:0", CHAIN,
        moniker=f"mempool20-{i}")
    sw.add_reactor("MEMPOOL", r)
    sw.start()
    return app, mp, g, r, sw


s_e = sched20()
txs_e = sigtxs20(E20)
app_ea, mp_ea, g_ea, r_ea, sw_ea = node20(0)
app_eb, mp_eb, g_eb, r_eb, sw_eb = node20(1)
src_e: list = []
_real_submit_eb = g_eb.submit


def _submit_eb(tx, source=ingress.SOURCE_RPC):
    src_e.append(source)
    return _real_submit_eb(tx, source)


g_eb.submit = _submit_eb
label20[0] = "e gossip A"
(res_ea, wall_ea), c_ea = main_path(lambda: timed_call(lambda: settle20(
    [g_ea.submit(tx) for tx in txs_e])), site="sched.ed25519")
hits0_e = s_e.stats()["cache_hits"]
label20[0] = "e gossip B"


def run_eb():
    t = time.perf_counter()
    peer = sw_eb.dial_peer(sw_ea.actual_listen_addr())
    check(peer is not None and peer.id == sw_ea.node_key.node_id,
          "phase 20 (e): B could not dial A")
    wait20(lambda: mp_eb.size() >= E20, "(e) B's pool filling", 120)
    return time.perf_counter() - t


wall_eb, c_eb = main_path(run_eb)
st_sched_e = s_e.stats()
sw_eb.stop()
sw_ea.stop()
g_ea.stop()
stop_sched20(s_e)
a_id = sw_ea.node_key.node_id
mempool20["e"] = {
    "admitted_at_a": sum(ok20(r) for r in res_ea), "a_wall_s": wall_ea,
    "a_launches": {k: v for k, v in c_ea.items() if v},
    "b_wall_s": wall_eb, "b_pool": mp_eb.size(),
    "b_launches": {k: v for k, v in c_eb.items() if v},
    "b_cache_hits": st_sched_e["cache_hits"] - hits0_e,
    "b_sources": sorted(set(src_e)), "b_gate": g_eb.stats(),
    "b_launched_nothing": sum(c_eb.values()) == 0}
log(phase=20, card=CARD, step="e gossip", **mempool20["e"])
check(all(ok20(r) for r in res_ea) and c_ea["verify_packed"] > 0
      and set(mp_eb.reap_max_txs(-1)) == set(mp_ea.reap_max_txs(-1))
      == set(txs_e) and set(src_e) == {f"p2p:{a_id}"}
      and len(src_e) >= E20,
      f"phase 20 (e): B's pool {mp_eb.size()}, sources {set(src_e)}")

# -- (f) the validator signer: 150 FilePVs with key and state files; four of
# them behind SignerServers that dial SignerClients (two over TCP on
# 127.0.0.1, two over unix sockets).  Height 1 applies; its proposer signs a
# proposal, all 150 sign a prevote and a precommit; both vote sets are
# pre-verified at CONSENSUS on the card (K1 at 256 lanes), the precommits go
# through VoteSet.add_vote (every one found in the verified-signature
# cache), make_commit, verify_commit on K1, and block 2 carrying the commit
# applies.  Then the double-sign guards, the harness and a redial
root20 = tempfile.mkdtemp(prefix="tm20_")
privval20: dict = {"card": CARD}
privs_f = [edkeys.PrivKey(hashlib.sha256(b"phase 20 validator %d" % i)
                          .digest()) for i in range(N20)]
pvs_f = {}
for _i, _pk in enumerate(privs_f):
    _d = os.path.join(root20, f"pv{_i}")
    _pv = fpv.FilePV(_pk, os.path.join(_d, "key.json"),
                     os.path.join(_d, "state.json"))
    _pv.save_key()
    pvs_f[_pk.pub_key().address()] = _pv
gdoc_f = tgen.GenesisDoc(
    chain_id=CHAIN, genesis_time=Timestamp(1700000000, 0),
    validators=[tgen.GenesisValidator(
        address=b"", pub_key_type="ed25519",
        pub_key_bytes=pk.pub_key().bytes(), power=10, name=f"pv{i}")
        for i, pk in enumerate(privs_f)])
gdoc_f.validate_and_complete()
ex_f, bs_f, state_f = executor20(gdoc_f, KVStoreApplication())
vset_f = state_f.validators
sock20 = tempfile.mkdtemp(prefix="tm20s_")


def sock_addr20(name):
    path = os.path.join(sock20, name)
    if len(path) > 100:    # an AF_UNIX path holds ~107 bytes
        path = os.path.relpath(path)
    return f"unix://{path}"


remote_f = {}      # validator index -> (client, server, its FilePV)
for _k, _idx in enumerate((3, 50, 97, 149)):
    _v = vset_f.validators[_idx]
    _addr = "tcp://127.0.0.1:0" if _k < 2 else sock_addr20(f"pv{_k}.sock")
    _cl = pvsigner.SignerClient(_addr, timeout_s=10.0, accept_timeout_s=30.0)
    if _k < 2:
        _addr = f"tcp://127.0.0.1:{_cl._listener.getsockname()[1]}"
    _srv = pvsigner.SignerServer(pvs_f[_v.address], _addr)
    _srv.start()
    remote_f[_idx] = (_cl, _srv, pvs_f[_v.address])


def signer_f(idx):
    if idx in remote_f:
        return remote_f[idx][0]
    return pvs_f[vset_f.validators[idx].address]


s_f = sched20()
label20[0] = "f signer"
t = time.perf_counter()
block1_f = state_f.make_block(1, [b"f1=v1"], Commit(0, 0, BlockID(), []),
                              [], vset_f.get_proposer().address,
                              block_time=Timestamp(1700000001, 0))
parts1_f = tparts.make_block_parts(block1_f)
bid1_f = BlockID(block1_f.hash(), parts1_f.header())
(state_f1, _), _c = main_path(lambda: ex_f.apply_block(state_f, bid1_f,
                                                       block1_f))
prop_idx = next(i for i, v in enumerate(vset_f.validators)
                if v.address == vset_f.get_proposer().address)
prop_f = signer_f(prop_idx).sign_proposal(CHAIN, Proposal(
    height=1, round=0, pol_round=-1, block_id=bid1_f,
    timestamp=Timestamp(1700000001, 500)))
check(vset_f.get_proposer().pub_key.verify_signature(
    prop_f.sign_bytes(CHAIN), prop_f.signature),
      "phase 20 (f): the proposal's signature")


def sign_votes20(typ, ts):
    out = []
    for i, v in enumerate(vset_f.validators):
        vote = tvote.Vote(typ, 1, 0, bid1_f, Timestamp(ts, 1000 + i),
                          v.address, i)
        out.append(signer_f(i).sign_vote(CHAIN, vote))
    return out


t = time.perf_counter()
prevotes_f = sign_votes20(SignedMsgType.PREVOTE, 1700000002)
precommits_f = sign_votes20(SignedMsgType.PRECOMMIT, 1700000003)
walls20["sign_votes_f"] = time.perf_counter() - t


def preverify_f(votes):
    items = [(vset_f.validators[v.validator_index].pub_key,
              v.sign_bytes(CHAIN), v.signature) for v in votes]
    return vsched.verify_items(items, vsched.Priority.CONSENSUS,
                               deadline=time.monotonic() + 0.005,
                               device=DEV)


t = time.perf_counter()
(pre_f, c_pre_f) = main_path(lambda: [preverify_f(prevotes_f),
                                      preverify_f(precommits_f)],
                             site="sched.ed25519")
walls20["preverify_f"] = time.perf_counter() - t
check(all(ok and bits.all() for ok, bits in pre_f)
      and c_pre_f["verify_packed"] >= 1,
      f"phase 20 (f): the votes' pre-verify {c_pre_f}")
real_verify20 = edkeys.PubKey.verify_signature
host_verifies20 = [0]


def _counted20(self, msg, sig):
    host_verifies20[0] += 1
    return real_verify20(self, msg, sig)


edkeys.PubKey.verify_signature = _counted20
try:
    sets_f = {}
    for typ, votes in ((SignedMsgType.PREVOTE, prevotes_f),
                       (SignedMsgType.PRECOMMIT, precommits_f)):
        vs = tvset.VoteSet(CHAIN, 1, 0, typ, vset_f)
        for v in votes:
            check(vs.add_vote(tvote.Vote.from_proto(v.proto())),
                  f"phase 20 (f): add_vote {typ}")
        sets_f[typ] = vs
finally:
    edkeys.PubKey.verify_signature = real_verify20
commit1_f = sets_f[SignedMsgType.PRECOMMIT].make_commit()
check(host_verifies20[0] == 0
      and all(vs.two_thirds_majority() == (bid1_f, True)
              for vs in sets_f.values())
      and [cs.block_id_flag for cs in commit1_f.signatures]
      == [BlockIDFlag.COMMIT] * N20,
      f"phase 20 (f): the vote sets ({host_verifies20[0]} host verifies)")
_, c_vc_f = main_path(lambda: vset_f.verify_commit(
    CHAIN, bid1_f, 1, commit1_f, device=DEV), site="bulk.ed25519")
block2_f = state_f1.make_block(2, [b"f2=v2"], commit1_f, [],
                               state_f1.validators.get_proposer().address,
                               block_time=Timestamp(1700000004, 0))
parts2_f = tparts.make_block_parts(block2_f)
bid2_f = BlockID(block2_f.hash(), parts2_f.header())
(state_f2, _), c_ap_f = main_path(lambda: ex_f.apply_block(
    state_f1, bid2_f, block2_f), site="bulk.ed25519")
walls20["height_f"] = time.perf_counter() - t
check(state_f2.last_block_height == 2 and c_vc_f["verify_packed"] == 1
      and c_ap_f["verify_packed"] == 1,
      f"phase 20 (f): verify_commit {c_vc_f}, the height {c_ap_f}")
# the double-sign guards: a conflicting block id at the same height, round
# and step, locally and through a remote signer; a timestamp-only re-sign;
# a FilePV reloaded from its files
other_bid = BlockID(b"\x66" * 32, PartSetHeader(1, b"\x67" * 32))
loc_i = next(i for i in range(N20) if i not in remote_f)
loc_pv = pvs_f[vset_f.validators[loc_i].address]
state_bytes = open(loc_pv.state_path, "rb").read()
conflict = tvote.Vote(SignedMsgType.PRECOMMIT, 1, 0, other_bid,
                      Timestamp(1700000003, 1000 + loc_i),
                      vset_f.validators[loc_i].address, loc_i)
guards_f = {}
try:
    loc_pv.sign_vote(CHAIN, conflict)
    guards_f["local"] = None
except fpv.DoubleSignError as e:
    guards_f["local"] = f"{type(e).__name__}: {e}"
guards_f["state_unchanged"] = open(loc_pv.state_path,
                                   "rb").read() == state_bytes
resign = loc_pv.sign_vote(CHAIN, tvote.Vote(
    SignedMsgType.PRECOMMIT, 1, 0, bid1_f, Timestamp(1700000099, 7),
    vset_f.validators[loc_i].address, loc_i))
guards_f["timestamp_only"] = (
    resign.signature == precommits_f[loc_i].signature
    and resign.timestamp == precommits_f[loc_i].timestamp)
reloaded = fpv.FilePV.load_or_generate(loc_pv.key_path, loc_pv.state_path)
try:
    reloaded.sign_vote(CHAIN, conflict)
    guards_f["reloaded"] = None
except fpv.DoubleSignError as e:
    guards_f["reloaded"] = f"{type(e).__name__}: {e}"
rem_i = next(iter(remote_f))
rem_cl, _, rem_pv = remote_f[rem_i]
rem_state = open(rem_pv.state_path, "rb").read()
try:
    rem_cl.sign_vote(CHAIN, tvote.Vote(
        SignedMsgType.PRECOMMIT, 1, 0, other_bid, Timestamp(1700000003, 5),
        vset_f.validators[rem_i].address, rem_i))
    guards_f["remote"] = None
except pvsigner.RemoteSignerError as e:
    guards_f["remote"] = f"{type(e).__name__}: {e}"
guards_f["remote_state_unchanged"] = open(rem_pv.state_path,
                                          "rb").read() == rem_state
check(guards_f["local"] and guards_f["reloaded"] and guards_f["remote"]
      and "DoubleSignError" in guards_f["local"]
      and "DoubleSignError" in guards_f["reloaded"]
      and "RemoteSignerError" in guards_f["remote"]
      and guards_f["state_unchanged"] and guards_f["timestamp_only"]
      and guards_f["remote_state_unchanged"],
      f"phase 20 (f): the double-sign guards {guards_f}")
# the harness against a conforming SignerServer (a FilePV of its own)
cl_h = pvsigner.SignerClient("tcp://127.0.0.1:0", accept_timeout_s=30.0)
srv_h = pvsigner.SignerServer(
    fpv.FilePV(edkeys.PrivKey(hashlib.sha256(b"phase 20 harness")
                              .digest())),
    f"tcp://127.0.0.1:{cl_h._listener.getsockname()[1]}")
srv_h.start()
try:
    harness_f = run_harness(cl_h)
finally:
    cl_h.close()
    srv_h.stop()
# a dropped connection (a unix one) is redialled by its signer
red_i = list(remote_f)[2]
red_cl = remote_f[red_i][0]
red_cl._drop()
t = time.perf_counter()
red_ok = False
while not red_ok and time.perf_counter() - t < 20:
    try:
        red_ok = red_cl.ping()
    except pvsigner.RemoteSignerError:
        time.sleep(0.1)
redial_s = time.perf_counter() - t
red_vote = red_cl.sign_vote(CHAIN, tvote.Vote(
    SignedMsgType.PREVOTE, 2, 0, bid2_f, Timestamp(1700000005, 0),
    vset_f.validators[red_i].address, red_i)) if red_ok else None
for _cl, _srv, _ in remote_f.values():
    _cl.close()
    _srv.stop()
stop_sched20(s_f)
privval20.update(
    validators=N20, remote={str(i): ("tcp" if k < 2 else "unix")
                            for k, i in enumerate(remote_f)},
    sign_votes_s=walls20["sign_votes_f"],
    preverify_s=walls20["preverify_f"],
    preverify_launches={k: v for k, v in c_pre_f.items() if v},
    height_s=walls20["height_f"], host_verifies=host_verifies20[0],
    guards=guards_f, harness={"passed": harness_f.passed,
                              "failed": harness_f.failed},
    redial_s=redial_s, k1=k1_rows20("f "))
log(phase=20, step="f validator signer", **privval20)
check(harness_f.ok and len(harness_f.passed) == 6 and red_ok
      and red_vote is not None
      and vset_f.validators[red_i].pub_key.verify_signature(
          red_vote.sign_bytes(CHAIN), red_vote.signature),
      f"phase 20 (f): the harness {harness_f.failed} or the redial")
shutil.rmtree(root20)
shutil.rmtree(sock20, ignore_errors=True)

# -- (g) the drills, each with the gate's own results, then a launch that
# fails on the card with no failpoint armed: K1's wrapper swapped for one
# that raises under a gate batch, a batch gossiped to (e)'s B and check_tx
# a threshold of one lane: check_tx's single tx launches on the card too
s_g = sched20(tpu_threshold=1)
drill_seq = sigtxs20(384) + [b"drill%d=v" % i for i in range(64)]
rng20.shuffle(drill_seq)
drill_seq += [drill_seq[j] for j in rng20.sample(range(len(drill_seq)), 32)]
drills_g = {}
label20[0] = "g drills"


def drill_run(site):
    mp = Mempool(App20(), registry=Registry(f"p20 g {site}"), **MP20)
    g = gate20(mp)
    if site:
        failpoints.set_mode(site, "raise")
    try:
        res = settle20([g.submit(tx) for tx in drill_seq])
        fired = failpoints.fired(site, "raise") if site else 0
    finally:
        failpoints.reset()
        g.stop()
    return [view20(r) for r in res], mp.reap_max_txs(-1), fired


base_g, _c = main_path(lambda: drill_run(None), site="sched.ed25519")
for _site in ("ingress.admit", "ingress.checktx"):
    views, pool, fired = drill_run(_site)
    drills_g[_site] = {"fired": fired, "same_responses": views == base_g[0],
                       "same_pool": pool == base_g[1]}


def recheck_run(drill):
    app = App20()
    mp = Mempool(app, registry=Registry(f"p20 g recheck {drill}"), **MP20)
    g = gate20(mp)
    try:
        settle20([g.submit(tx) for tx in drill_seq])
        held = mp.reap_max_txs(-1)
        app.stale = set(held[1::3])
        rc0 = g.stats()["rechecked"]
        if drill:
            failpoints.set_mode("ingress.recheck", "raise")
        mp.lock()
        try:
            mp.update(2, held[:16])
        finally:
            mp.unlock()
        fired = failpoints.fired("ingress.recheck", "raise")
        failpoints.reset()
        if not drill:
            wait20(lambda: g.stats()["rechecked"] - rc0 >= len(held) - 16,
                   "(g) the offloaded recheck", 60)
        return mp.reap_max_txs(-1), fired, g.stats()["rechecked"] - rc0
    finally:
        failpoints.reset()
        g.stop()


pool_off, _, n_off = recheck_run(False)
pool_sync, fired_sync, n_sync = recheck_run(True)
drills_g["ingress.recheck"] = {"fired": fired_sync,
                               "same_pool": pool_sync == pool_off,
                               "offloaded": n_off, "in_update": n_sync}
check(all(d["fired"] >= 1 and d["same_pool"]
          and d.get("same_responses", True) for d in drills_g.values())
      and n_off > 0 and n_sync == 0,
      f"phase 20 (g): the drills {drills_g}")
runtime_clean("phase 20 (g) drills")


def card_fault20(what, fn):
    check(not failpoints.armed(), "phase 20: a failpoint is armed")
    label20[0] = f"g {what}"
    rt = degrade.runtime()
    fails0 = counter_total(rt.metrics.device_failures)
    falls0 = counter_total(rt.metrics.host_fallbacks)
    keeping = ck.verify_packed
    ck.verify_packed = launch_failed
    try:
        out = fn()
    finally:
        ck.verify_packed = keeping
    join_abandoned()
    row = {"what": what,
           "failures": counter_total(rt.metrics.device_failures) - fails0,
           "fallbacks": counter_total(rt.metrics.host_fallbacks) - falls0}
    degrade.configure(degrade.DegradeConfig.from_env(),
                      registry=Registry(f"p20 {what}"))
    return out, row


faults20 = []
mp_g = Mempool(App20(), registry=Registry("p20 g faults"), **MP20)
g_g = gate20(mp_g)
signed_g1 = sigtxs20(64)
plain_g1 = [b"fault%d=v" % i for i in range(16)]
batch_g1 = signed_g1[:32] + plain_g1 + signed_g1[32:]


def fault_batch():
    # one batch: queued under the gate's condition, drained whole
    with g_g._cond:
        futs = [g_g.submit(tx) for tx in batch_g1]
    return settle20(futs)


res_g1, row = card_fault20("gate batch", fault_batch)
st_g1 = g_g.stats()
row.update(errors=sorted({view20(r) for r in res_g1}, key=str), gate=st_g1,
           sig_rejected_total=mp_g.metrics.rejected_txs.value(reason="sig"),
           failed_txs=mp_g.metrics.failed_txs.value(),
           worker_alive=workers_alive20(g_g),
           device_error=type(g_g.device_error).__name__)
faults20.append(row)
check(all(isinstance(r, degrade.DeviceLaneError)
          for tx, r in zip(batch_g1, res_g1) if tx in signed_g1)
      and all(ok20(r) for tx, r in zip(batch_g1, res_g1) if tx in plain_g1)
      and st_g1["device_error"] == 64 and st_g1["sig_rejected"] == 0
      and row["sig_rejected_total"] == 0 and row["failed_txs"] == 0
      and row["worker_alive"]
      and isinstance(g_g.device_error, degrade.DeviceLaneError)
      and row["failures"] >= 1 and row["fallbacks"] == 0,
      f"phase 20 (g): the gate batch's card fault {row}")


r_eb.switch = sw20 = StopSwitch19()
peer20 = SimpleNamespace(id=a_id, data={}, try_send=lambda ch, m: True)
signed_g2 = sigtxs20(32)
msg_g2 = mreactor.encode_msg(mreactor.TxsMessage(
    signed_g2 + [b"gossip%d=v" % i for i in range(8)]))
st0 = g_eb.stats()


def fault_gossip():
    with g_eb._cond:
        r_eb.receive(mreactor.MEMPOOL_CHANNEL, peer20, msg_g2)
    wait20(lambda: g_eb.stats()["device_error"] - st0["device_error"] >= 32
           and g_eb.stats()["admitted"] - st0["admitted"] >= 8,
           "(g) the gossiped batch settling", 60)


_, row = card_fault20("gossip", fault_gossip)
st_g2 = g_eb.stats()
row.update(device_error=type(g_eb.device_error).__name__,
           peers_stopped=list(sw20.stopped),
           failed=st_g2["device_error"] - st0["device_error"],
           admitted=st_g2["admitted"] - st0["admitted"],
           sig_rejected=st_g2["sig_rejected"] - st0["sig_rejected"],
           worker_alive=workers_alive20(g_eb))
faults20.append(row)
check(isinstance(g_eb.device_error, degrade.DeviceLaneError)
      and sw20.stopped == [] and row["failed"] == 32
      and row["admitted"] == 8 and row["sig_rejected"] == 0
      and row["worker_alive"] and row["failures"] >= 1
      and row["fallbacks"] == 0,
      f"phase 20 (g): the gossiped batch's card fault {row}")
tx_g3 = sigtxs20(1)[0]


def fault_check_tx():
    try:
        g_g.check_tx(tx_g3, timeout=60)
    except Exception as e:  # noqa: BLE001 - returned and checked
        return e
    return None


err_g3, row = card_fault20("check_tx", fault_check_tx)
row.update(error=type(err_g3).__name__, busy=g_g.stats()["busy"])
faults20.append(row)
check(isinstance(err_g3, degrade.DeviceLaneError) and row["busy"] == 0
      and row["failures"] >= 1 and row["fallbacks"] == 0,
      f"phase 20 (g): check_tx's card fault {row} ({err_g3!r})")
# the card back: each of those txs is admitted when resubmitted
label20[0] = "g again"
(again_g, c_again_g) = main_path(lambda: [
    g_g.check_tx(tx, timeout=60) for tx in signed_g1 + [tx_g3]] + [
    g_eb.check_tx(tx, timeout=60) for tx in signed_g2],
    site="sched.ed25519")
check(all(ok20(r) for r in again_g) and c_again_g["verify_packed"] >= 1,
      f"phase 20 (g): the resubmissions "
      f"{sorted({view20(r) for r in again_g}, key=str)}")
g_g.stop()
g_eb.stop()
g_a.stop()
stop_sched20(s_g)
mempool20["g"] = {"drills": drills_g, "faults": faults20}
log(phase=20, card=CARD, step="g drills and card faults", drills=drills_g,
    faults=faults20)

# -- every launch of the phase against its plain version on the same inputs
# (grouped by step)
label20[0] = ""
for _name in keep20:
    setattr(KERNEL_MOD[_name], _name, was20[_name])
cmp20 = {name: [] for name in keep20}
t = time.perf_counter()
for name, plain in (("verify_packed", ck.verify_packed_plain),
                    ("verify_packed_split", ck.verify_packed_split_plain)):
    runs = keep20[name]
    if not runs:
        continue
    got = torch.cat([out for _, _, out in runs])
    cols = [torch.cat([args[k] for _, args, _ in runs], dim=1)
            for k in range(len(runs[0][1]))]
    step_of = np.repeat([label.split(" ")[0] or "-" for label, _, _ in runs],
                        [out.shape[0] for _, _, out in runs])
    real = (cols[-1] != 0).any(dim=0)
    check(not got[~real].any(), f"phase 20 {name}: a padding lane passed")
    got = got[real].cpu().numpy()
    step_of = step_of[real.cpu().numpy()]
    cols = [c[:, real] for c in cols]
    want = torch.cat([plain(*[c[:, a:a + 65_536] for c in cols]).cpu()
                      for a in range(0, len(got), 65_536)]).numpy()
    err = np.abs(got.astype(int) - want.astype(int))
    for g in sorted(set(step_of)):
        on = step_of == g
        n_runs = sum((label.split(" ")[0] or "-") == g
                     for label, _, _ in runs)
        cmp20[name].append((f"phase 20 ({g}): {n_runs} launches",
                            int(on.sum()), int(err[on].sum()),
                            float(err[on].max())))
plain20_s = time.perf_counter() - t
# the card's time for each step's K1 launches: the kept launches replayed
# back to back between two CUDA events on a quiet card (events around a
# launch in flight also hold its host enqueue, which waits on the GIL
# under the floods), against the step's host wall
card20 = {}
walls_step20 = {"a": wall_a, "b": wall_b, "c": wall_c, "d": wall_d,
                "e": wall_ea + wall_eb}
if ON_CARD20 and keep20["verify_packed"]:
    REAL["verify_packed"](keep20["verify_packed"][0][1][0])
    for g in sorted({label.split(" ")[0]
                     for label, _, _ in keep20["verify_packed"]}):
        runs = [args[0] for label, args, _ in keep20["verify_packed"]
                if label.split(" ")[0] == g]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for packed in runs:
            REAL["verify_packed"](packed)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        card20[g] = {"launches": len(runs), "k1_ms": ms,
                     "wall_s": walls_step20.get(g),
                     "card_share": (ms / 1e3 / walls_step20[g]
                                    if g in walls_step20 else None)}
log(phase=20, card=CARD, step="card time", k1_replayed=card20)
check(not keep20["comb_build"] and not keep20["comb_verify"],
      "phase 20: a comb launch with no set prewarmed")
staging_clear(20)
launches20 = {name: len(v) for name, v in keep20.items()}
gc.callbacks.remove(_gc17)
mempool20.update(gc={"collections": gc17["n"], "seconds": gc17["s"]},
                 card_time=card20, comparisons=cmp20, openssl=oracle20,
                 launches=launches20,
                 walls_s=walls20, plain_s=plain20_s,
                 phase_s=time.perf_counter() - T20)
log(phase=20, card=CARD, launches=launches20, comparisons=cmp20,
    openssl=oracle20, plain_s=plain20_s, walls_s=walls20,
    phase_s=mempool20["phase_s"])
check(launches20["verify_packed"] > 0
      and all(r[2] == 0 for rows in cmp20.values() for r in rows),
      f"phase 20: a kernel disagrees with its plain version: {cmp20}")
REPORT["mempool"] = mempool20
REPORT["privval"] = privval20

# -- phase 21: consensus ------------------------------------------------------

# The consensus slice (consensus/state.py, reactor.py, messages.py, wal.py,
# ticker.py, replay_console.py, wal_generator.py, libs/autofile.py) on the
# card, through the entry points a node wires: ConsensusState over a
# BlockExecutor on its default device, ConsensusReactor on a Switch, and one
# VerifyScheduler on the card at the node's defaults.  (a) BASELINE config 2:
# 150 ConsensusStates in this process, each over its own kvstore, Mempool,
# EvidencePool and FilePV (node 0 on SQLite stores with a WAL file, the rest
# on MemDB), wired full mesh in memory (tests/helpers.py's Node and wire,
# copied: that module imports the JAX package; with Gossip21 in the
# reactor's catch-up role), at ConsensusConfig()'s timeouts; 200 txs of 64
# bytes a block (max_gas 200 in the genesis params, the kvstore asking 1
# gas a tx), every tx in every node's mempool as mempool gossip would
# deliver it; 2 heights, then 1 with the genesis set prewarmed (C1 at 256
# keys; the storms and the last commits on C2): the depth cut from 6 + a
# stretch, since a height takes 13-61 s of this process's host time (PR
# 19's call 2 ran 4 + 2 and the smoke 912 s); node 0's own
# storm of height 1 through ConsensusState's pre-verify with a cold
# SigCache (K1 at 256 lanes), held against OpenSSL.  (b) the 4-node localnet over TCP on
# 127.0.0.1 (a ConsensusReactor, a MempoolReactor and a BlocksyncReactor a
# Switch, a WAL file each, node 0 on SQLite), node 3 stopped and restarted
# over its own stores and WAL, a fifth node joining late through blocksync.
# (c) the card-fault rule: K1's wrapper raising with no failpoint armed
# under a storm of 149 prevotes; a fresh state over the same stores and WAL
# resuming; the same storm in a drill.  (d) the WAL tools.  Walls are
# host-clock, logged and not gated; every chain, count and route named
# below is.
N21, H21, PRE21, TXS21 = 150, 2, 1, 200       # (a)
H21B, AFTER21B, JOIN21B = 20, 3, 3            # (b)
T21 = time.perf_counter()
rng21 = random.Random(SEED + 21)
E.table_cache_clear()
check(not msm.use_rlc(10_000) and not failpoints.armed()
      and vsched.installed() is None and bpipe.installed() is None,
      "phase 21: RLC, a failpoint, a scheduler or a pipeline is still on")
degrade.configure(degrade.DegradeConfig.from_env(), registry=Registry("p21"))
ON_CARD21 = DEV.type == "cuda"
# a node's log_level "consensus:error,...": 150 state machines log a line
# a block each at info
tmlog.setup("info", module_levels="consensus:error,blocksync:error,"
            "p2p:error,mempool:error")
gc17.update(n=[0, 0, 0], s=[0.0, 0.0, 0.0])
gc.callbacks.append(_gc17)
# phase 20's objects out of the collector's walks too: a node's own
# process does not hold them, and 150 state machines make a full
# collection come due every few seconds
gc.collect()
gc.freeze()
consensus21: dict = {"card": CARD}
walls21: dict = {}
# every K1, K2, C1 and C2 launch of the phase: (label, inputs, output)
keep21 = {name: [] for name in ("verify_packed", "verify_packed_split",
                                "comb_build", "comb_verify")}
label21 = [""]
was21 = {name: getattr(KERNEL_MOD[name], name) for name in keep21}
_keep21_lock = threading.Lock()


def _keeping21(name):
    """The bare wrapper (REAL), keeping a copy of every launch's tensor
    inputs (C2's tables by reference) and its output; the storms launch
    from the scheduler's executor, the last commits from the nodes'
    receive threads through the runtime's lane thread."""
    def wrapper(*args):
        out = REAL[name](*args)
        kept = [a.clone() if isinstance(a, torch.Tensor)
                and not (name == "comb_verify" and i == 1) else a
                for i, a in enumerate(args)]
        with _keep21_lock:
            keep21[name].append((label21[0], kept, out))
        return out
    return wrapper


for _name in keep21:
    setattr(KERNEL_MOD[_name], _name, _keeping21(_name))

# host verify_signature calls by the thread that made them: the nodes'
# receive threads ("consensus-<name>": a vote or proposal the SigCache did
# not hold) against every other thread (the runtime's spot checks)
hostv21 = {"consensus": 0, "other": 0}
_hostv21_lock = threading.Lock()
REAL_VERIFY21 = edkeys.PubKey.verify_signature


def _counted_verify21(self, msg, sig):
    kind = ("consensus" if threading.current_thread().name
            .startswith("consensus-") else "other")
    with _hostv21_lock:
        hostv21[kind] += 1
    return REAL_VERIFY21(self, msg, sig)


edkeys.PubKey.verify_signature = _counted_verify21
root21 = tempfile.mkdtemp(prefix="smoke21_")


class Node21:
    """tests/helpers.py's Node: one consensus node over its own kvstore,
    Mempool, EvidencePool and FilePV (none for a non-validator), its
    BlockExecutor and ConsensusState on the default device.  db_dir: SQLite
    stores there (the node's layout), else MemDB; stores/app/mempool: a
    restarted node's own.  txs_available=False leaves the mempool's
    new-tx callback unwired: at ConsensusConfig()'s create_empty_blocks
    the state machine never waits for txs, so the callback only takes
    the node's state mutex once a tx."""

    def __init__(self, gdoc, priv, name, wal_path=None, db_dir=None,
                 stores=None, app=None, mempool=None, txs_available=True):
        self.app = app or KVStoreApplication()
        self.mempool = mempool or Mempool(self.app)
        self.dbs = []
        if stores is not None:
            self.state_store, self.block_store = stores
        elif db_dir is not None:
            os.makedirs(db_dir, exist_ok=True)
            self.dbs = [SQLiteDB(os.path.join(db_dir, "blockstore.db")),
                        SQLiteDB(os.path.join(db_dir, "state.db"),
                                 commit_every=64)]
            self.block_store = BlockStore(self.dbs[0])
            self.state_store = StateStore(self.dbs[1])
        else:
            self.block_store = BlockStore(MemDB())
            self.state_store = StateStore(MemDB())
        self.event_bus = tbus.EventBus()
        state = self.state_store.load()
        if state is None:
            state = state_from_genesis(gdoc)
            self.state_store.save(state)
        self.evidence_pool = evpool.EvidencePool(
            MemDB(), self.state_store, self.block_store)
        self.exec = sexec.BlockExecutor(
            self.state_store, self.app, mempool=self.mempool,
            evidence_pool=self.evidence_pool, event_bus=self.event_bus)
        self.pv = fpv.FilePV(priv) if priv is not None else None
        self.cs = cstate.ConsensusState(
            cconfig.ConsensusConfig(), state, self.exec,
            self.block_store, mempool=self.mempool, priv_validator=self.pv,
            wal_path=wal_path, event_bus=self.event_bus, name=name,
            evidence_pool=self.evidence_pool)
        if txs_available:
            self.mempool.on_new_tx(self.cs.notify_txs_available)

    def close(self):
        for db in self.dbs:
            db.close()


def wire21(nodes):
    """tests/helpers.py's wire: every node's broadcasts feed every other
    node's queues (the in-memory analog of the reactor's channels), but
    for a message two or more heights ahead of the peer, which it could
    only drop on arrival: a node that fell behind would otherwise find
    its queue (5,000) full of later heights, the catch-up it needs shed
    with them."""
    for i, a in enumerate(nodes):
        peers = [b for j, b in enumerate(nodes) if j != i]
        pid = f"node{i}"

        def on_vote(vote, peers=peers, pid=pid):
            for b in peers:
                if vote.height <= b.cs.rs.height + 1:
                    b.cs.add_vote(vote, peer_id=pid)

        def on_proposal(pr, peers=peers, pid=pid):
            for b in peers:
                if pr.height <= b.cs.rs.height + 1:
                    b.cs.set_proposal(pr, peer_id=pid)

        def on_part(h, r, part, peers=peers, pid=pid):
            for b in peers:
                if h <= b.cs.rs.height + 1:
                    b.cs.add_block_part(h, r, part, peer_id=pid)
        a.cs.broadcast_vote.append(on_vote)
        a.cs.broadcast_proposal.append(on_proposal)
        a.cs.broadcast_block_part.append(on_part)


class Gossip21:
    """The in-memory analog of the consensus reactor's gossip routines,
    which wire21's broadcast has not: a node that was a round behind when
    a proposal, a part or a vote arrived dropped it, as a reactor's peer
    would, and the reactor's catch-up routine resends what such a peer
    lacks.  Here one thread watches every node's (height, round, step)
    and helps a node that has not moved for STALL_S seconds: a height
    some store holds is served from it (the reactor's _serve_catchup:
    the commit's precommits, then the parts); at the live height it
    gets the round's proposal and parts, the parts of the block its part
    set waits for, and the votes of a later round that the node furthest
    in round holds; after STUCK_S (past every timeout of a round, so no
    timeout of its own is pending) also the votes of its own round that
    it lacks.  Each (node, height, round, kind) at most every RESEND_S
    seconds.  The views are read without the nodes' locks (a stale view
    only delays the help)."""

    TICK_S, STALL_S, STUCK_S, RESEND_S = 0.25, 2.0, 6.0, 2.0

    def __init__(self, nodes):
        self.nodes = nodes
        self.sent: dict = {}
        self.last = [None] * len(nodes)
        self.since = [0.0] * len(nodes)
        self.resent = {"proposal": 0, "parts": 0, "votes": 0, "store": 0}
        self.stop_ev = threading.Event()
        self.thread = threading.Thread(target=self._run, name="gossip21",
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.stop_ev.set()
        self.thread.join(10)

    def _due(self, key) -> bool:
        now = time.monotonic()
        if now - self.sent.get(key, -1e9) < self.RESEND_S:
            return False
        self.sent[key] = now
        return True

    def _run(self):
        while not self.stop_ev.wait(self.TICK_S):
            now = time.monotonic()
            views = []
            for n in self.nodes:
                rs = n.cs.rs
                views.append((rs.height, rs.round, rs.step, rs.proposal,
                              rs.proposal_block, rs.proposal_block_parts,
                              rs.votes))
            best = {}   # height -> the node furthest in round there
            for i, v in enumerate(views):
                if v[0] not in best or v[1] > views[best[v[0]]][1]:
                    best[v[0]] = i
            top = max(n.block_store.height() for n in self.nodes)
            for j, v in enumerate(views):
                if self.last[j] != v[:3]:
                    self.last[j], self.since[j] = v[:3], now
                elif now - self.since[j] >= self.STALL_S:
                    if v[0] <= top:
                        self._serve_store(j, v[0])
                    elif best.get(v[0]) not in (None, j):
                        self._help(j, v, best[v[0]], views[best[v[0]]],
                                   now - self.since[j] >= self.STUCK_S)

    def _help(self, j, v, a, va, stuck):
        h, r, _, prop, block, parts, votes = v
        _, ra, _, prop_a, _, parts_a, votes_a = va
        cs, pid = self.nodes[j].cs, f"node{a}"
        if prop is None and prop_a is not None and ra == r \
                and self._due((j, h, r, "proposal")):
            cs.set_proposal(prop_a, peer_id=pid)
            self.resent["proposal"] += 1
        if block is None and parts is not None and parts_a is not None \
                and parts_a.is_complete() \
                and parts.has_header(parts_a.header()) \
                and self._due((j, h, r, "parts")):
            for i in range(parts_a.header().total):
                cs.add_block_part(h, ra, parts_a.get_part(i), peer_id=pid)
            self.resent["parts"] += 1
        if (ra > r or stuck) and self._due((j, h, ra, "votes")):
            # the vote sets read as they stand (prevotes()/precommits()
            # would add a round to the node's set from this thread)
            for kind in ("_prevotes", "_precommits"):
                theirs = getattr(votes_a, kind).get(ra)
                if theirs is None:
                    continue
                mine = getattr(votes, kind).get(ra)
                have = mine.votes if mine is not None else None
                for idx, vote in enumerate(list(theirs.votes)):
                    if vote is not None and (have is None
                                             or have[idx] is None):
                        cs.add_vote(vote, peer_id=pid)
                        self.resent["votes"] += 1

    def _serve_store(self, j, h):
        """The reactor's _serve_catchup for height h: the stored commit's
        precommits, then the block's parts."""
        if not self._due((j, h, -1, "store")):
            return
        src = next(n for n in self.nodes if n.block_store.height() >= h)
        commit = src.block_store.load_seen_commit(h) \
            or src.block_store.load_block_commit(h)
        meta = src.block_store.load_block_meta(h)
        if commit is None or meta is None:
            return
        cs = self.nodes[j].cs
        for i, sig in enumerate(commit.signatures):
            if sig.for_block():
                cs.add_vote(tvote.Vote(
                    type=SignedMsgType.PRECOMMIT, height=h,
                    round=commit.round, block_id=commit.block_id,
                    timestamp=sig.timestamp,
                    validator_address=sig.validator_address,
                    validator_index=i, signature=sig.signature),
                    peer_id="store")
        for i in range(meta.block_id.part_set_header.total):
            cs.add_block_part(h, commit.round,
                              src.block_store.load_block_part(h, i),
                              peer_id="store")
        self.resent["store"] += 1


def wait21(nodes, height, what, timeout):
    """Every node's block store at `height` or above; fails if a state
    machine died."""
    end = time.monotonic() + timeout
    while min(n.block_store.height() for n in nodes) < height:
        dead = [n.cs.name for n in nodes if not n.cs.is_running()]
        check(not dead, f"phase 21 {what}: state machines died {dead[:4]}"
              f" {[n.cs.device_error for n in nodes if n.cs.device_error]}")
        check(time.monotonic() < end, f"phase 21 {what}: heights "
              f"{sorted({n.block_store.height() for n in nodes})} < {height}")
        time.sleep(0.05)


def chains_equal21(nodes, top):
    """The block hashes of heights 1..top, equal across the nodes."""
    hashes = []
    for h in range(1, top + 1):
        hs = {n.block_store.load_block(h).hash() for n in nodes}
        check(len(hs) == 1, f"phase 21: the nodes disagree at height {h}")
        hashes.append(hs.pop())
    return hashes


def genesis21(privs, chain_id, max_gas=-1):
    return tgen.GenesisDoc(
        chain_id=chain_id, genesis_time=Timestamp(1700000000, 0),
        consensus_params=tparams.ConsensusParams(
            block=tparams.BlockParams(max_gas=max_gas)),
        validators=[tgen.GenesisValidator(
            address=k.pub_key().address(), pub_key_type="ed25519",
            pub_key_bytes=k.pub_key().bytes(), power=10) for k in privs])


def until21(cond, what, timeout):
    end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < end, f"phase 21 {what}")
        time.sleep(0.005)


def sched21_start():
    """A fresh SigCache and a scheduler on the card at the node's
    defaults."""
    cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
    sch = vsched.install(vsched.VerifyScheduler(
        window_s=0.002, max_batch=8192, max_pending=65536,
        tpu_threshold=32, device=DEV))
    sch.start()
    return sch


def sched21_stop(sch):
    sch.stop()
    vsched.uninstall(sch)


def bulk21() -> float:
    return degrade.runtime().metrics.device_launches.value(
        site="bulk.ed25519")


# -- (a) the 150-validator kvstore network ----------------------------------
# the gossip observatory off for (a) (TM_TPU_NETOBS=0's switch): it is one
# per process, so 150 nodes in this one make its drain walk 150 x 149
# (node, peer) flows where a node's own process holds 149, and every
# receive loop that passes its min-interval check at once walks them all
netobs.disable()
keys21 = [edkeys.PrivKey(hashlib.sha256(b"phase 21 key %d" % i).digest())
          for i in range(N21)]
vp21 = [k.pub_key().bytes() for k in keys21]
gdoc21 = genesis21(keys21, "chip-smoke-21", max_gas=TXS21)
n_heights21 = H21 + PRE21 + 1
txs21 = {}
for _h in range(1, n_heights21 + 3):
    txs21[_h] = []
    for _i in range(TXS21):
        _key = b"c%d_%d=" % (_h, _i)
        txs21[_h].append(_key + rng21.randbytes(32).hex().encode()[
            :64 - len(_key)])
t = time.perf_counter()
nodes21 = [Node21(gdoc21, keys21[i], f"n{i}",
                  wal_path=(os.path.join(root21, "a0", "cs.wal")
                            if i == 0 else None),
                  db_dir=os.path.join(root21, "a0") if i == 0 else None,
                  txs_available=False)
           for i in range(N21)]
wire21(nodes21)
gossip21 = Gossip21(nodes21)
walls21["a_build_s"] = time.perf_counter() - t
fed21 = [0]
feed_s21 = [0.0]


def feed21(ahead=2):
    """Keep every node's mempool `ahead` blocks of txs in front of the
    highest committed height: each tx checked into each node's mempool."""
    top = max(n.block_store.height() for n in nodes21)
    while fed21[0] < min(top + ahead, n_heights21 + 2):
        fed21[0] += 1
        t0 = time.perf_counter()
        for n in nodes21:
            for tx in txs21[fed21[0]]:
                n.mempool.check_tx(tx)
        feed_s21[0] += time.perf_counter() - t0


class Feeder21:
    """The mempool gossip's analog: a thread running feed21."""

    def __init__(self):
        self.stop_ev = threading.Event()
        self.thread = threading.Thread(target=self._run, name="feed21",
                                       daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop_ev.wait(0.05):
            feed21()

    def stop(self):
        self.stop_ev.set()
        self.thread.join(60)


commits21 = []   # node 0's commits: (height, time, commit round, txs)
nodes21[0].cs.on_committed.append(lambda b: commits21.append(
    (b.header.height, time.perf_counter(), nodes21[0].cs.rs.commit_round,
     len(b.data.txs))))
feed21()
sched21 = sched21_start()
feeder21 = Feeder21()
hostv21.update(consensus=0, other=0)
hits21 = (cbatch.verified_sigs.hits, cbatch.verified_sigs.misses)
bulk0_21 = bulk21()
sched0_21 = degrade.runtime().metrics.device_launches.value(
    site="sched.ed25519")
label21[0] = "a network"
t_a21 = time.perf_counter()


def run_a1():
    for n in nodes21:
        n.cs.start()
    wait21(nodes21, H21, "(a)", 600)


_, c_a1 = main_path(run_a1)
walls21["a_heights_s"] = time.perf_counter() - t_a21
st_a1 = sched21.stats()
host_a1 = dict(hostv21)
cache_a1 = (cbatch.verified_sigs.hits - hits21[0],
            cbatch.verified_sigs.misses - hits21[1])
bulk_a1 = bulk21() - bulk0_21
top_a1 = min(n.block_store.height() for n in nodes21)
# the scheduler serves the consensus pre-verify alone here: its device
# launches (site sched.ed25519) are the storms' K1 launches; the nodes
# share this process's SigCache, so only a window of 32 votes that no node
# has verified yet launches (node 0's own storm below launches for sure)
sched_a1 = degrade.runtime().metrics.device_launches.value(
    site="sched.ed25519") - sched0_21
check(c_a1.get("verify_packed", 0) > 0,
      f"phase 21 (a): no K1 launch: {st_a1}, {c_a1}")
# each node verifies each last commit it applies (heights 2..) on the card
check(bulk_a1 >= N21 * (top_a1 - 1),
      f"phase 21 (a): {bulk_a1} bulk launches for {N21} nodes and "
      f"{top_a1} heights")
runtime_clean("phase 21 (a)", "bulk.ed25519", bulk0_21)
# the prewarmed stretch: C1 at 256 keys for the genesis set, then the
# storms and the last commits on C2
label21[0] = "a prewarmed"
bulk0_a2 = bulk21()
t_a2 = time.perf_counter()


def run_a2():
    ok = E.prewarm(vp21, device=DEV)
    check(ok, "phase 21 (a): the genesis set's prewarm was declined")
    walls21["a_prewarm_s"] = time.perf_counter() - t_a2
    top = min(n.block_store.height() for n in nodes21)
    wait21(nodes21, top + PRE21, "(a) prewarmed", 600)


_, c_a2 = main_path(run_a2)
walls21["a_prewarmed_s"] = time.perf_counter() - t_a2
st_a2 = sched21.stats()
for n in nodes21:
    check(n.cs.is_running() and n.cs.device_error is None,
          f"phase 21 (a): {n.cs.name} died")
t = time.perf_counter()
gossip21.stop()
feeder21.stop()
stops21 = [threading.Thread(target=n.cs.stop) for n in nodes21]
for th in stops21:
    th.start()
for th in stops21:
    th.join(60)
walls21["a_stop_s"] = time.perf_counter() - t
label21[0] = ""
sched21_stop(sched21)
bulk_a2 = bulk21() - bulk0_a2
check(c_a2.get("comb_build") == 1 and c_a2.get("comb_verify", 0) > 0,
      f"phase 21 (a): the prewarmed stretch's C1/C2 launches {c_a2}")
runtime_clean("phase 21 (a) prewarmed", "bulk.ed25519", bulk0_a2)
top21 = min(n.block_store.height() for n in nodes21)
hashes21 = chains_equal21(nodes21, top21)
# app hash and results of every height, from the next block's header and
# the stored state of the nodes at the top
heads21 = [nodes21[0].block_store.load_block(h).header
           for h in range(1, top21 + 1)]
finals = {(s.last_block_height, s.app_hash, s.last_results_hash)
          for s in (n.state_store.load() for n in nodes21)
          if s.last_block_height == top21}
check(len(finals) == 1, f"phase 21 (a): the states at {top21} differ")
tx_counts21 = [len(nodes21[0].block_store.load_block(h).data.txs)
               for h in range(1, top21 + 1)]
check(sum(1 for c in tx_counts21 if c == TXS21) >= H21,
      f"phase 21 (a): txs a block {tx_counts21}")
per_height21 = []
prev = t_a21
for h, tc, rnd, ntx in commits21:
    per_height21.append({"height": h, "wall_s": tc - prev,
                         "commit_round": rnd, "txs": ntx})
    prev = tc
a21 = {"validators": N21, "heights": top21,
       "block_hashes_equal": True, "txs": tx_counts21,
       "per_height": per_height21,
       "app_hashes": [hd.app_hash.hex() for hd in heads21[1:]],
       "final_state": [x.hex() if isinstance(x, bytes) else x
                       for x in finals.pop()],
       "launches": {"unprewarmed": c_a1, "prewarmed": c_a2},
       "bulk_launches": {"unprewarmed": bulk_a1, "prewarmed": bulk_a2},
       "preverify_launches_unprewarmed": sched_a1,
       "scheduler": {"unprewarmed": {k: st_a1[k] for k in (
           "submissions", "items", "launches", "lanes", "cache_hits",
           "dedup", "shed")}, "total": {k: st_a2[k] for k in (
               "submissions", "items", "launches", "lanes", "cache_hits",
               "dedup", "shed")},
           "deadline_misses": sched21._metrics().sched_deadline_miss.value(
               priority="consensus")},
       "host_verify_signature": {"unprewarmed": host_a1,
                                 "total": dict(hostv21)},
       "sigcache_unprewarmed": {"hits": cache_a1[0], "misses": cache_a1[1]},
       "gossip_resent": dict(gossip21.resent),
       "feed_s": feed_s21[0], "walls_s": dict(walls21)}
log(phase=21, card=CARD, step="a network", **{
    k: v for k, v in a21.items() if k not in ("app_hashes", "per_height")})
log(phase=21, card=CARD, step="a heights", per_height=per_height21)

# node 0's own storm: the 149 peer prevotes of height 1 from its WAL (the
# round most of them voted in), through ConsensusState's pre-verify on a
# fresh state machine at genesis with a cold SigCache and no table resident
# (K1 at 256 lanes, through a fresh scheduler), then applied: every vote
# from the cache; the bitmap held against OpenSSL's
recs21 = list(cwal.WAL.iter_messages(os.path.join(root21, "a0", "cs.wal")))
by_r21: dict = {}
for r in recs21:
    if isinstance(r, tuple) and isinstance(r[0], crt.VoteMessage) and r[1] \
            and r[0].vote.height == 1 \
            and r[0].vote.type == SignedMsgType.PREVOTE:
        by_r21.setdefault(r[0].vote.round, {})[r[0].vote.validator_index] \
            = r[0].vote
storm_r21 = max(sorted(by_r21), key=lambda r: len(by_r21[r]))
storm21 = list(by_r21[storm_r21].values())
check(len(storm21) * 3 > 2 * N21,
      f"phase 21: node 0 logged {len(storm21)} peer prevotes at height 1")
vset21 = state_from_genesis(gdoc21).validators
items21 = [(vset21.validators[v.validator_index].pub_key,
            v.sign_bytes(gdoc21.chain_id), v.signature) for v in storm21]
E.table_cache_clear()
sched21 = sched21_start()
own21 = Node21(gdoc21, None, "own")
batch21 = [(crt.VoteMessage(v), f"node{v.validator_index}") for v in storm21]
label21[0] = "a own storm"
sched0_own = degrade.runtime().metrics.device_launches.value(
    site="sched.ed25519")
(_, own_s), c_own = main_path(lambda: timed_call(
    lambda: own21.cs._preverify_votes(batch21)))
label21[0] = ""
hostv21.update(consensus=0, other=0)
with own21.cs._mtx:
    for msg, peer in batch21:
        own21.cs._apply_msg(msg, peer)
own_applied = sum(1 for v in own21.cs.rs.votes.prevotes(storm_r21).votes
                  if v is not None)
own_host = hostv21["consensus"] + hostv21["other"]
sched_own = degrade.runtime().metrics.device_launches.value(
    site="sched.ed25519") - sched0_own
sched21_stop(sched21)
check(c_own.get("verify_packed") == 1 and sched_own == 1
      and own_applied == len(storm21) and own_host == 0,
      f"phase 21: node 0's storm: launches {c_own}, applied {own_applied},"
      f" host verifies {own_host}")
own_out = [out for lab, _, out in keep21["verify_packed"]
           if lab == "a own storm"][-1]
want_own = np.array([edkeys._ossl_verify(p.bytes(), m, s)
                     for p, m, s in items21], dtype=bool)
bits_own = own_out.cpu().numpy()[:len(items21)]
oracle21 = (f"node 0's storm of height 1, round {storm_r21}", len(items21),
            int((bits_own != want_own).sum()), int(own_out.shape[0]),
            bool(want_own.all()))
check(oracle21[2] == 0 and oracle21[3] == 256 and oracle21[4],
      f"phase 21: node 0's storm against OpenSSL {oracle21}")
own_card_ms = None
if ON_CARD21:
    packed = [args[0] for lab, args, _ in keep21["verify_packed"]
              if lab == "a own storm"][-1]
    own_card_ms = time_events(lambda: REAL["verify_packed"](packed), 20)
a21["own_storm"] = {"round": storm_r21, "votes": len(items21),
                    "wall_s": own_s, "applied": own_applied,
                    "k1_ms": own_card_ms, "lanes": int(own_out.shape[0])}
log(phase=21, card=CARD, step="a own storm", **a21["own_storm"],
    openssl=oracle21)
for n in nodes21:
    n.close()
netobs.enable()
consensus21["a"] = a21
del nodes21
gc.collect()

# -- (b) the 4-node localnet over TCP ----------------------------------------
keys21b = [edkeys.PrivKey(hashlib.sha256(b"phase 21 localnet %d" % i)
                          .digest()) for i in range(4)]
gdoc21b = genesis21(keys21b, "chip-smoke-21b")
nkeys21b = [NodeKey(edkeys.PrivKey(hashlib.sha256(b"phase 21 p2p %d" % i)
                                   .digest())) for i in range(5)]


class Peer21:
    """A node of the localnet on its own Switch (127.0.0.1, port 0) with a
    ConsensusReactor, a MempoolReactor and a BlocksyncReactor, as the node
    wires them; a validator's blocksync only serves (fast_sync off), the
    late joiner's syncs and hands over to consensus when caught up."""

    def __init__(self, i, priv, joiner=False, old=None):
        d = os.path.join(root21, f"b{i}")
        self.node = Node21(
            gdoc21b, priv, f"b{i}", wal_path=os.path.join(d, "cs.wal"),
            db_dir=d if i == 0 and old is None else None,
            stores=None if old is None else (old.node.state_store,
                                             old.node.block_store),
            app=None if old is None else old.node.app,
            mempool=None if old is None else old.node.mempool)
        if old is not None:
            self.node.dbs = old.node.dbs
        n = self.node
        self.switch = Switch(nkeys21b[i], "127.0.0.1:0", gdoc21b.chain_id,
                             moniker=f"b{i}")
        self.switch.add_reactor("CONSENSUS",
                                creactor.ConsensusReactor(n.cs))
        self.switch.add_reactor("MEMPOOL", mreactor.MempoolReactor(n.mempool))
        self.caught_up = threading.Event()

        def on_caught_up(state):
            if state.last_block_height > n.cs.state.last_block_height:
                n.cs.switch_to_consensus(state)
            n.cs.start()
            self.caught_up.set()
        self.switch.add_reactor("BLOCKSYNC", BlocksyncReactor(
            n.exec, n.block_store, n.cs.state, fast_sync=joiner,
            on_caught_up=on_caught_up if joiner else None))
        self.switch.start()

    def dial(self, others):
        for o in others:
            check(self.switch.dial_peer(o.switch.actual_listen_addr())
                  is not None, f"phase 21 (b): {self.node.cs.name} dial")

    def stop(self):
        self.node.cs.stop()
        self.switch.stop()


b21: dict = {}
sched21 = sched21_start()
label21[0] = "b localnet"
t = time.perf_counter()
peers21 = [Peer21(i, keys21b[i]) for i in range(4)]
for i, pr in enumerate(peers21):
    pr.dial(peers21[i + 1:])
until21(lambda: all(pr.switch.num_peers() == 3 for pr in peers21),
        "(b): the mesh", timeout=30)
txs21b = [b"b%d=%s" % (i, rng21.randbytes(24).hex().encode())
          for i in range(2 * H21B)]


def run_b1():
    for pr in peers21:
        pr.node.cs.start()
    for tx in txs21b:
        check(peers21[0].node.mempool.check_tx(tx).is_ok(),
              "phase 21 (b): a tx at node 0")
    wait21([pr.node for pr in peers21], H21B, "(b)", 300)


_, c_b1 = main_path(run_b1)
walls21["b_heights_s"] = time.perf_counter() - t
committed21b = {tx for h in range(1, H21B + 1)
                for tx in peers21[1].node.block_store.load_block(h).data.txs}
# node 3 down: the other three (3/4 of the power) keep committing
top_b = max(pr.node.block_store.height() for pr in peers21)
t = time.perf_counter()
peers21[3].stop()
live21 = peers21[:3]
_, c_b2 = main_path(lambda: wait21([pr.node for pr in live21],
                                   top_b + AFTER21B, "(b) 3 of 4", 300))
walls21["b_three_s"] = time.perf_counter() - t
check(not any(c_b1.values()) and not any(c_b2.values()),
      f"phase 21 (b): a kernel launched on the localnet {c_b1} {c_b2}")
# node 3 restarts over its own stores and WAL (its app and mempool kept,
# as an app process that outlived the node): its WAL catch-up, then the
# reactor's store-backed catch-up from its peers
t = time.perf_counter()
h3_21 = peers21[3].node.block_store.height()
peers21[3] = Peer21(3, keys21b[3], old=peers21[3])
peers21[3].dial(peers21[:3])
label21[0] = "b restart"


def run_b3():
    peers21[3].node.cs.start()
    top = max(pr.node.block_store.height() for pr in peers21[:3])
    wait21([pr.node for pr in peers21], top + 1, "(b) restart", 300)


_, c_b3 = main_path(run_b3)
walls21["b_restart_s"] = time.perf_counter() - t
# a fifth node, no validator, joins late: blocksync to the top, then
# switch_to_consensus through on_caught_up
label21[0] = "b join"
t = time.perf_counter()
joiner21 = Peer21(4, None, joiner=True)
joiner21.dial(peers21)


def run_b4():
    check(joiner21.caught_up.wait(300), "phase 21 (b): the joiner never "
          "caught up")
    top = max(pr.node.block_store.height() for pr in peers21)
    wait21([pr.node for pr in peers21] + [joiner21.node], top + JOIN21B,
           "(b) join", 300)


_, c_b4 = main_path(run_b4)
walls21["b_join_s"] = time.perf_counter() - t
label21[0] = ""
all21b = [pr.node for pr in peers21] + [joiner21.node]
for n in all21b:
    check(n.cs.is_running() and n.cs.device_error is None,
          f"phase 21 (b): {n.cs.name} died")
for pr in peers21 + [joiner21]:
    pr.stop()
sched21_stop(sched21)
top21b = min(n.block_store.height() for n in all21b)
chains_equal21(all21b, top21b)
check(set(txs21b) <= {tx for h in range(1, top21b + 1)
                      for tx in all21b[4].block_store.load_block(h).data.txs},
      "phase 21 (b): a tx submitted at node 0 was not committed")
b21.update(heights=top21b, node3_stopped_at=h3_21,
           five_chains_equal=True,
           txs_in_20_heights=len(committed21b),
           launches={"localnet": c_b1, "three_of_four": c_b2,
                     "restart": c_b3, "join": c_b4},
           walls_s={k: v for k, v in walls21.items() if k.startswith("b_")})
log(phase=21, card=CARD, step="b localnet", **b21)
for n in all21b:
    n.close()
consensus21["b"] = b21

# -- (c) the card-fault rule and the drills ----------------------------------
gdoc21c = genesis21(keys21, "chip-smoke-21c")


def storm21c(node):
    """The 149 prevotes of validators 1..149 for one block at height 1,
    queued at `node` before it starts, so its receive routine drains them
    as one batch."""
    bid = BlockID(hashlib.sha256(b"phase 21 storm").digest(),
                  PartSetHeader(1, hashlib.sha256(b"parts").digest()))
    vals = node.cs.state.validators
    by_addr = {k.pub_key().address(): k for k in keys21}
    votes = []
    for idx in range(vals.size()):
        addr, _ = vals.get_by_index(idx)
        if by_addr[addr] is keys21[0]:
            continue
        v = tvote.Vote(type=SignedMsgType.PREVOTE, height=1, round=0,
                       block_id=bid, timestamp=Timestamp(1700000100, idx),
                       validator_address=addr, validator_index=idx)
        v.signature = by_addr[addr].sign(v.sign_bytes(gdoc21c.chain_id))
        votes.append(v)
    return votes


def feed_storm21(cs, votes):
    for i, v in enumerate(votes):
        cs.add_vote(v, peer_id=f"peer{v.validator_index}")


def present21(cs):
    with cs._mtx:
        return sum(1 for v in cs.rs.votes.prevotes(0).votes if v is not None)


c21: dict = {}
sched21 = sched21_start()
wal_c = os.path.join(root21, "c", "cs.wal")
node_c = Node21(gdoc21c, keys21[0], "c", wal_path=wal_c)
votes_c = storm21c(node_c)
feed_storm21(node_c.cs, votes_c)
hostv21.update(consensus=0, other=0)
fails0_21 = counter_total(degrade.runtime().metrics.device_failures)
ck.verify_packed = launch_failed
t = time.perf_counter()
node_c.cs.start()
until21(lambda: not node_c.cs.is_running(),
        "(c): the receive routine did not stop", timeout=60)
c21["halt_s"] = time.perf_counter() - t
ck.verify_packed = _keeping21("verify_packed")
wal_votes = [r for r in cwal.WAL.iter_messages(wal_c)
             if isinstance(r, tuple) and isinstance(r[0], crt.VoteMessage)]
c21.update(
    device_error=type(node_c.cs.device_error).__name__,
    prevotes_applied=present21(node_c.cs),
    host_verifies_on_consensus_thread=hostv21["consensus"],
    wal_votes=len(wal_votes),
    device_failures=counter_total(degrade.runtime().metrics.device_failures)
    - fails0_21)
node_c.cs.stop()
check(isinstance(node_c.cs.device_error, degrade.DeviceLaneError)
      and c21["prevotes_applied"] == 0
      and c21["host_verifies_on_consensus_thread"] == 0
      and c21["wal_votes"] == 0 and c21["device_failures"] >= 1,
      f"phase 21 (c): the card fault {c21}")
# the card back (a fresh runtime: the fault above is counted in the old
# one's breaker): a fresh state over the same stores and WAL resumes, fed
# the same storm; it reaches +2/3 prevotes on the card
degrade.configure(degrade.DegradeConfig.from_env(),
                  registry=Registry("p21c"))
cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
node_c2 = Node21(gdoc21c, keys21[0], "c2", wal_path=wal_c,
                 stores=(node_c.state_store, node_c.block_store),
                 app=node_c.app, mempool=node_c.mempool)
feed_storm21(node_c2.cs, votes_c)
label21[0] = "c resume"


def run_c2():
    node_c2.cs.start()
    until21(lambda: node_c2.cs.rs.votes.prevotes(0)
            .has_two_thirds_majority(), "(c): the resume", timeout=60)


(_, c21["resume_s"]), c_c2 = main_path(lambda: timed_call(run_c2),
                                       site="sched.ed25519")
label21[0] = ""
c21.update(resumed_prevotes=present21(node_c2.cs),
           resume_launches=c_c2,
           resumed_running=node_c2.cs.is_running())
node_c2.cs.stop()
check(c21["resumed_prevotes"] == N21 - 1 and c21["resumed_running"]
      and c_c2.get("verify_packed", 0) >= 1,
      f"phase 21 (c): the resume {c21}")
# the same storm in a drill (the scheduler's site armed to raise): the
# runtime re-verifies on the host, every vote is applied, the JAX
# package's path
cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
node_d = Node21(gdoc21c, keys21[0], "drill")
feed_storm21(node_d.cs, votes_c)
failpoints.set_mode("sched.ed25519", "raise")
try:
    node_d.cs.start()
    until21(lambda: present21(node_d.cs) == N21 - 1,
            "(c): the drill's votes", timeout=60)
    c21.update(drill_prevotes=present21(node_d.cs),
               drill_fired=failpoints.fired("sched.ed25519", "raise"),
               drill_running=node_d.cs.is_running(),
               drill_device_error=node_d.cs.device_error)
finally:
    failpoints.reset()
    node_d.cs.stop()
sched21_stop(sched21)
check(c21["drill_fired"] >= 1 and c21["drill_running"]
      and c21["drill_device_error"] is None,
      f"phase 21 (c): the drill {c21}")
degrade.configure(degrade.DegradeConfig.from_env(),
                  registry=Registry("p21d"))
log(phase=21, card=CARD, step="c card fault", **c21)
consensus21["c"] = c21

# -- (d) the WAL tools -------------------------------------------------------
d21: dict = {}
t = time.perf_counter()
wal_g = os.path.join(root21, "d", "wal")
cwalgen.generate_wal(wal_g, num_blocks=4)
out21 = io.StringIO()
d21["shown"] = cconsole.replay_messages(wal_g, console=False, out=out21)
cmds21 = iter(["l", "n", "q"])
d21["stepped"] = cconsole.replay_messages(
    wal_g, console=True, out=io.StringIO(), input_fn=lambda _: next(cmds21))
ends_g = [m.height for m in cwal.WAL.iter_messages(wal_g)
          if isinstance(m, cwal.EndHeightMessage)]
wal_r = os.path.join(root21, "d", "rot", "wal")
cwalgen.generate_wal(wal_r, num_blocks=6, head_size_limit=2048)
chunks_r = autofile.list_group_paths(wal_r)[:-1]
ends_r = [m.height for m in cwal.WAL.iter_messages(wal_r)
          if isinstance(m, cwal.EndHeightMessage)]
after_r, found_r = cwal.WAL.messages_after_end_height(wal_r, 3)
d21.update(end_heights=ends_g, rotated_chunks=len(chunks_r),
           rotated_end_heights=ends_r, after_3=len(after_r),
           wall_s=time.perf_counter() - t)
check(ends_g[:5] == [0, 1, 2, 3, 4] and "ENDHEIGHT 4" in out21.getvalue()
      and 0 < d21["stepped"] < d21["shown"] and len(chunks_r) >= 2
      and ends_r[:7] == list(range(7)) and found_r and after_r,
      f"phase 21 (d): the WAL tools {d21}")
log(phase=21, card=CARD, step="d wal tools", **d21)
consensus21["d"] = d21

# -- every launch of the phase against its plain version on the same inputs
# (grouped by step), C2 against the plain tables of the build it used
edkeys.PubKey.verify_signature = REAL_VERIFY21
for _name in keep21:
    setattr(KERNEL_MOD[_name], _name, was21[_name])
cmp21 = {name: [] for name in keep21}
t = time.perf_counter()
for name, plain in (("verify_packed", ck.verify_packed_plain),
                    ("verify_packed_split", ck.verify_packed_split_plain)):
    runs = keep21[name]
    if not runs:
        continue
    got = torch.cat([out for _, _, out in runs])
    cols = [torch.cat([args[k] for _, args, _ in runs], dim=1)
            for k in range(len(runs[0][1]))]
    step_of = np.repeat([label.split(" ")[0] or "-" for label, _, _ in runs],
                        [out.shape[0] for _, _, out in runs])
    real = (cols[-1] != 0).any(dim=0)
    check(not got[~real].any(), f"phase 21 {name}: a padding lane passed")
    got = got[real].cpu().numpy()
    step_of = step_of[real.cpu().numpy()]
    # the 150 nodes verify the same last commits and storms: the plain
    # version runs once on each distinct lane, its verdict mapped back to
    # every lane of every launch
    uniq, inv = torch.unique(torch.cat([c[:, real] for c in cols]), dim=1,
                             return_inverse=True)
    sizes = [c.shape[0] for c in cols]
    ucols = list(torch.split(uniq, sizes))
    want_u = torch.cat([plain(*[c[:, a:a + 65_536] for c in ucols]).cpu()
                        for a in range(0, uniq.shape[1], 65_536)])
    want = want_u[inv.cpu()].numpy()
    err = np.abs(got.astype(int) - want.astype(int))
    for g in sorted(set(step_of)):
        on = step_of == g
        n_runs = sum((label.split(" ")[0] or "-") == g
                     for label, _, _ in runs)
        cmp21[name].append((f"phase 21 ({g}): {n_runs} launches, "
                            f"{uniq.shape[1]} distinct lanes",
                            int(on.sum()), int(err[on].sum()),
                            float(err[on].max())))
builds21 = {}
for label, args, (tab, ok) in keep21["comb_build"]:
    ptab, pok = cc.comb_build_plain(args[0])
    builds21[id(tab)] = (ptab, pok)
    cmp21["comb_build"].append(
        (f"phase 21 {label}", args[0].shape[0],
         cc.tables_mismatch(tab, ptab) + int((ok != pok).sum())))
check(len(keep21["comb_build"]) == 1
      and all(id(args[1]) in builds21 for _, args, _ in keep21["comb_verify"]),
      "phase 21: a C2 launch on a table that no build of the phase made")
for key, (ptab, pok) in builds21.items():
    runs = [(args, out) for _, args, out in keep21["comb_verify"]
            if id(args[1]) == key]
    if not runs:
        continue
    rows_c2 = torch.cat([args[0] for args, _ in runs])
    got = torch.cat([out for _, out in runs]).cpu().numpy()
    # the plain C2 once on each distinct row, mapped back to every row
    urows, uinv = torch.unique(rows_c2, dim=0, return_inverse=True)
    want = cc.comb_verify_plain(urows, ptab, pok).cpu()[uinv.cpu()]
    cmp21["comb_verify"].append(c2_row(
        f"phase 21: {len(runs)} launches on one table, {urows.shape[0]} "
        f"distinct rows", got, want.numpy()))
plain21_s = time.perf_counter() - t
# the card's time for (a)'s launches: each kernel's kept launches replayed
# back to back between two CUDA events on a quiet card, against the
# stretch's host wall
card21 = {}
if ON_CARD21:
    for name, stretch, wall_key in (
            ("verify_packed", "a network", "a_heights_s"),
            ("comb_verify", "a prewarmed", "a_prewarmed_s")):
        runs = [args for lab, args, _ in keep21[name] if lab == stretch]
        if not runs:
            continue
        REAL[name](*runs[0])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for a in runs:
            REAL[name](*a)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        card21[f"{stretch} {name}"] = {
            "launches": len(runs), "ms": ms, "wall_s": walls21[wall_key],
            "card_share": ms / 1e3 / walls21[wall_key]}
log(phase=21, card=CARD, step="card time", replayed=card21)
E.table_cache_clear()
staging_clear(21)
shutil.rmtree(root21)
tmlog.setup("info")
gc.callbacks.remove(_gc17)
gc.unfreeze()
launches21 = {name: len(v) for name, v in keep21.items()}
consensus21.update(gc={"collections": gc17["n"], "seconds": gc17["s"]},
                   card_time=card21, comparisons=cmp21, openssl=oracle21,
                   launches=launches21, plain_s=plain21_s,
                   phase_s=time.perf_counter() - T21)
log(phase=21, card=CARD, launches=launches21, comparisons=cmp21,
    openssl=oracle21, plain_s=plain21_s, phase_s=consensus21["phase_s"])
check(launches21["verify_packed"] > 0 and launches21["comb_verify"] > 0
      and all(r[2] == 0 for rows in cmp21.values() for r in rows),
      f"phase 21: a kernel disagrees with its plain version: {cmp21}")
REPORT["consensus"] = consensus21

# -- phase 22: state sync, the RPC server and PEX ------------------------------

# The state-sync, RPC and PEX slice (statesync/syncer.py, reactor.py,
# ledger.py, stateprovider.py; rpc/server.py, light.py; p2p/pex.py,
# trust.py) on the card, through the entry points a node wires: a fresh
# node restores a BASELINE config 2 chain (150 validators, 1,000 txs of 64
# bytes a block) from the kvstore's snapshot (the reference's default state
# sync settings: 4 fetchers, the default chunk timeout, 3 retries, 64 KiB
# chunks) over a StateSyncReactor on a Switch, its trust from a light.Client
# over HTTPProviders against two RPCServers of the serving node, then
# blocksyncs the tail.  The serving node is a stand-in with the attributes
# the routes read (the node itself is ROADMAP Queue 1 item 9).  (a) the
# chain (121 heights, snapshots every 50), two RPCServers and a serving
# StateSyncReactor; (b) the joiner: snapshot 100 restored (the light
# certificates on K1), the State bootstrapped, 20 tail heights through the
# BlocksyncReactor (K1 windows); (c) a second joiner from snapshot 50 after
# a prewarm of the set (C1 at 256 keys; its certificates on C2); (d) 2,000
# signed txs (1% corrupted) through broadcast_tx_sync from 4 HTTP client
# threads into the serving node's IngressGate (K1 MEMPOOL windows), 200 more
# through broadcast_tx_async, and RPC_BUSY_CODE from a full queue; (e) 16
# clients calling light_verify over LightServe's prewarmed tables (C2); (f)
# PEX: 4 Switches and a seed, a flooding peer disconnected; (g) K1's
# wrapper raising with no failpoint armed under sync_any, broadcast_tx_sync
# and light_verify, a fresh Syncer resuming from the same ledger, and the
# statesync.* drills.  Walls are host-clock, logged and not gated; every
# hash, state, response, count and route named below is.
N22, H22, TXS22, SNAP22 = 150, 121, 1000, 50      # (a)
TX22, BAD22, ASYNC22, CLIENTS22, WIDTH22 = 2000, 20, 200, 4, 64  # (d)
LIGHT22, LIGHT_H22 = 16, (10, 25, 40, 55, 70, 85, 100, 115)     # (e)
PEX22, PEX_PERIOD22 = 4, 0.5                      # (f)
PERIOD22 = 14 * 24 * 3600.0
NOW22 = Timestamp(1700000000 + 3600, 0)           # an hour past genesis
T22 = time.perf_counter()
rng22 = random.Random(SEED + 22)
E.table_cache_clear()
check(not msm.use_rlc(10_000) and not failpoints.armed()
      and vsched.installed() is None and bpipe.installed() is None,
      "phase 22: RLC, a failpoint, a scheduler or a pipeline is still on")
degrade.configure(degrade.DegradeConfig.from_env(), registry=Registry("p22"))
ingress.set_enabled(None)
ON_CARD22 = DEV.type == "cuda"
tmlog.setup("info", module_levels="statesync:error,blocksync:error,"
            "p2p:error,mempool:error,light:error,rpc:error,pex:error")
gc.collect()
gc.freeze()
gc17.update(n=[0, 0, 0], s=[0.0, 0.0, 0.0])
gc.callbacks.append(_gc17)
statesync22: dict = {"card": CARD}
walls22: dict = {}
# every K1, K2, C1 and C2 launch of the phase: (label, inputs, output)
keep22 = {name: [] for name in ("verify_packed", "verify_packed_split",
                                "comb_build", "comb_verify")}
label22 = [""]
was22 = {name: getattr(KERNEL_MOD[name], name) for name in keep22}
_keep22_lock = threading.Lock()


def _keeping22(name):
    """The bare wrapper (REAL), keeping a copy of every launch's tensor
    inputs (C2's tables by reference) and its output; the launches come
    from the fetch plane's caller, the RPC handler threads (through the
    gate and LightServe) and the blocksync routine."""
    def wrapper(*args):
        out = REAL[name](*args)
        kept = [a.clone() if isinstance(a, torch.Tensor)
                and not (name == "comb_verify" and i == 1) else a
                for i, a in enumerate(args)]
        with _keep22_lock:
            keep22[name].append((label22[0], kept, out))
        return out
    return wrapper


for _name in keep22:
    setattr(KERNEL_MOD[_name], _name, _keeping22(_name))
root22 = tempfile.mkdtemp(prefix="smoke22_")


def step22(label, fn, site=None):
    """fn() on the main path with a fresh SigCache (a step's signatures are
    verified on the card, not found among an earlier step's) and the step's
    label; the runtime must have served it without a device failure or a
    host fallback.  Returns (the result, the launch counts, the wall)."""
    cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
    label22[0] = label
    t = time.perf_counter()
    out, c = main_path(fn, site=site)
    walls22[label] = time.perf_counter() - t
    runtime_clean(f"phase 22 {label}")
    return out, {k: v for k, v in c.items() if v}, walls22[label]


def wait22(cond, what, timeout):
    end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < end, f"phase 22: {what} timed out")
        time.sleep(0.005)


def txs22(h: int):
    """TXS22 txs of 64 bytes each, s<h>_<i>=<hex>."""
    out = []
    for i in range(TXS22):
        key = b"s%d_%d=" % (h, i)
        out.append(key + rng22.randbytes(32).hex().encode()[:64 - len(key)])
    return out


a22, pubs22 = gen_keys(N22, rng22)
a_of22 = dict(zip(pubs22, a22))
gdoc22 = tgen.GenesisDoc(
    chain_id=CHAIN, genesis_time=Timestamp(1700000000, 0),
    validators=[tgen.GenesisValidator(
        address=b"", pub_key_type="ed25519", pub_key_bytes=p, power=10,
        name=f"v{i}") for i, p in enumerate(pubs22)])
gdoc22.validate_and_complete()


def sign22(state, bid, h: int):
    """The commit of height h: a precommit from every validator of the
    height's set, signed over its canonical bytes."""
    vals = state.validators.validators
    sigs = [CommitSig(BlockIDFlag.COMMIT, v.address,
                      Timestamp(1700000000 + h, 500 + i))
            for i, v in enumerate(vals)]
    commit = Commit(h, 0, bid, sigs)
    vp = [v.pub_key.bytes() for v in vals]
    for cs, sig in zip(sigs, sign_batch(
            [a_of22[p] for p in vp], vp,
            commit_sign_bytes_batch(CHAIN, commit, list(range(len(vals)))),
            rng22)):
        cs.signature = sig
    return commit


# -- (a) the serving node: the chain built and applied by its own executor
# (which trusts its own signatures: mark_commit_verified, no launch), the
# kvstore taking a snapshot every SNAP22 heights
t = time.perf_counter()
srv_app22 = app18(gdoc22)
srv_app22.snapshot_interval = SNAP22
srv_ss22, srv_bs22 = StateStore(MemDB()), BlockStore(MemDB())
ex22 = sexec.BlockExecutor(srv_ss22, srv_app22)
state = state_from_genesis(gdoc22)
srv_ss22.save(state)
states22 = []
last = Commit(0, 0, BlockID(), [])
for h in range(1, H22 + 1):
    block = state.make_block(h, txs22(h), last, [],
                             state.validators.get_proposer().address,
                             block_time=Timestamp(1700000000 + h, 0))
    parts = tparts.make_block_parts(block)
    bid = BlockID(block.hash(), parts.header())
    seen = sign22(state, bid, h)
    if h > 1:
        ex22.mark_commit_verified(h - 1, last)
    state, _ = ex22.apply_block(state, bid, block)
    srv_bs22.save_block(block, parts, seen)
    states22.append(state)
    last = seen
walls22["a build_s"] = time.perf_counter() - t
snaps22 = {s.height: s for s in srv_app22.list_snapshots()}
check(sorted(snaps22) == [SNAP22, 2 * SNAP22]
      and not any(keep22.values()),
      f"phase 22 (a): snapshots at {sorted(snaps22)}, build launches "
      f"{ {k: len(v) for k, v in keep22.items()} }")
snap_b22 = snaps22[2 * SNAP22]
chunk_bytes22 = sum(len(srv_app22.load_snapshot_chunk(
    snap_b22.height, snap_b22.format, i)) for i in range(snap_b22.chunks))
log(phase=22, card=CARD, at_s=time.perf_counter() - T22, step="a chain", heights=H22, txs=H22 * TXS22,
    build_s=walls22["a build_s"], snapshots={
        h: {"chunks": s.chunks} for h, s in snaps22.items()},
    snapshot_bytes=chunk_bytes22, app_keys=len(srv_app22.data))
bus22 = tbus.EventBus()
node22 = SimpleNamespace(
    block_store=srv_bs22, state_store=srv_ss22, state=states22[-1],
    app=srv_app22, mempool=Mempool(App20(), registry=Registry("p22 idle"),
                                   **MP20),
    ingress_gate=None, light_serve=None, event_bus=bus22, genesis=gdoc22,
    tx_indexer=None, block_indexer=None, switch=None, evidence_pool=None,
    config=None, status=lambda: {"node_info": {"network": CHAIN},
                                 "sync_info": {
                                     "latest_block_height":
                                         srv_bs22.height()}})
rpc22 = RPCServer(node22, "127.0.0.1:0")
rpc22.start()
wit22 = RPCServer(node22, "127.0.0.1:0")
wit22.start()
NK22 = [0]


def switch22(moniker, reactors):
    """A Switch on 127.0.0.1 with the reactors, started, its NodeInfo
    carrying the port it listens on (PEX shares that address)."""
    NK22[0] += 1
    sw = Switch(NodeKey(edkeys.PrivKey(hashlib.sha256(
        b"phase 22 node %d" % NK22[0]).digest())),
        f"127.0.0.1:{free_port22()}", CHAIN, moniker=moniker)
    for name, r in reactors.items():
        sw.add_reactor(name, r)
    sw.start()
    return sw


def free_port22():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ss_srv22 = StateSyncReactor(srv_app22)
bs_srv22 = BlocksyncReactor(sexec.BlockExecutor(
    StateStore(MemDB()), KVStoreApplication()), srv_bs22,
    state_from_genesis(gdoc22), fast_sync=False)
sw_srv22 = switch22("server22", {"STATESYNC": ss_srv22,
                                 "BLOCKSYNC": bs_srv22})
anchor22 = srv_bs22.load_block(1).hash()


class Offers22:
    """A kvstore whose offer_snapshot calls are counted."""

    def __init__(self):
        self.app = KVStoreApplication()
        self.offers = 0

    def __getattr__(self, name):
        return getattr(self.app, name)

    def offer_snapshot(self, snapshot, app_hash):
        self.offers += 1
        return self.app.offer_snapshot(snapshot, app_hash)


def joiner22(name, serving_sw, ledger, want):
    """A fresh node: a counted kvstore, MemDB stores, a BlockExecutor on the
    card, a light.Client trusting height 1 (the anchor taken out of band)
    over HTTPProviders against the two RPC servers (its anchor's
    self-check a step of its own), a StateProvider pinned at NOW22, a
    StateSyncReactor and a BlocksyncReactor on its own Switch dialled to
    serving_sw; returns once the snapshots at `want` are discovered."""
    j = SimpleNamespace(name=name, app=Offers22(), ss=StateStore(MemDB()),
                        bs=BlockStore(MemDB()), ledger=ledger, bans=[])
    j.ex = sexec.BlockExecutor(j.ss, j.app, device=DEV)
    j.lc, j.c_anchor, _ = step22(f"{name} anchor", lambda: light.Client(
        CHAIN, light.TrustOptions(1, anchor22, PERIOD22),
        lprov.HTTPProvider(CHAIN, rpc22.laddr),
        [lprov.HTTPProvider(CHAIN, wit22.laddr)],
        light.LightStore(MemDB()), device=DEV))
    j.sp = StateProvider(j.lc, now=NOW22)
    j.r = StateSyncReactor(
        j.app, j.sp, ledger=ledger, fetchers=ssync.DEFAULT_FETCHERS,
        chunk_timeout_s=ssync.DEFAULT_CHUNK_TIMEOUT_MS / 1000.0,
        retries=ssync.DEFAULT_RETRIES)
    ban = j.r._ban_peer
    j.r._ban_peer = lambda pid, why: (j.bans.append((pid, why)),
                                      ban(pid, why))
    j.bsr = BlocksyncReactor(j.ex, j.bs, state_from_genesis(gdoc22),
                             fast_sync=False, window=64)
    j.sw = switch22(name, {"STATESYNC": j.r, "BLOCKSYNC": j.bsr})
    peer = j.sw.dial_peer(serving_sw.actual_listen_addr())
    check(peer is not None, f"phase 22: {name} could not dial the server")
    j.server_id = peer.id
    wait22(lambda: {k[0] for k in j.r.syncer._snapshots} >= set(want),
           f"{name} discovering snapshots {want}", 30)
    return j


def restored22(j, h):
    """The joiner's app restored to height h with the serving chain's app
    hash."""
    info = j.app.info(abci_t.RequestInfo())
    return (info.last_block_height == h
            and info.last_block_app_hash == states22[h - 1].app_hash
            and j.app.data == _data_at22(h))


def _data_at22(h):
    """The serving app's keys as of height h (each height writes its own
    s<h>_<i> keys)."""
    return {k: v for k, v in srv_app22.data.items()
            if int(k[1:].split(b"_")[0]) <= h}


def restore_view22(j):
    r = dict(j.r.syncer.last_restore or {})
    r["banned"] = list(r.get("banned", []))
    return r


def launch_rows22(prefix):
    """Launches, padded lanes and real lanes by kernel of the phase's kept
    launches whose label starts with prefix."""
    out = {}
    for name, runs in keep22.items():
        rs = [r for r in runs if r[0].startswith(prefix)]
        if not rs:
            continue
        lanes = sum(int(a[0].shape[0] if name == "comb_build"
                        else o.shape[0]) for _, a, o in rs)
        out[name] = {"launches": len(rs), "lanes": lanes}
    return out


# -- (b) the joiner: snapshot 100 over the Switch, trust from the light
# client (the skipping hop's 1/3 and 2/3 checks, heights 100-102: K1), the
# State bootstrapped, then the 20 tail heights through the BlocksyncReactor
# (the node's handoff: switch_to_blocksync, activate; windows on K1)
jb22 = joiner22("joiner22", sw_srv22, RestoreLedger(SQLiteDB(
    os.path.join(root22, "statesync_b.db"))), (SNAP22, 2 * SNAP22))
(state_b22, commit_b22), c_b22, wall_b22 = step22(
    "b sync", lambda: jb22.r.syncer.sync_any())
rest_b22 = restore_view22(jb22)
want_b = states22[2 * SNAP22 - 1]
view_b, view_w = state_view17(state_b22), state_view17(want_b)
# the reference's StateProvider leaves the two last-changed heights at 0
# (stateprovider.go builds them so); every other field is the chain's
diff_b22 = [i for i, (x, y) in enumerate(zip(view_b, view_w))
            if x != y and i not in (8, 10)]
check(restored22(jb22, 2 * SNAP22) and not diff_b22
      and state_b22.last_height_validators_changed == 0
      and state_b22.last_height_consensus_params_changed == 0
      and commit_b22.height == 2 * SNAP22
      and c_b22.get("verify_packed", 0) > 0 and "comb_verify" not in c_b22
      and jb22.app.offers == 1 and not jb22.bans
      and rest_b22["chunks"] == snap_b22.chunks and rest_b22["resumed"] == 0
      and jb22.ledger.manifest() is None,
      f"phase 22 (b): the restore {rest_b22}, launches {c_b22}, state "
      f"fields differing {diff_b22}, offers {jb22.app.offers}, bans "
      f"{jb22.bans}")
jb22.ss.bootstrap(state_b22)
jb22.bs.save_seen_commit(state_b22.last_block_height, commit_b22)
jb22.bsr.switch_to_blocksync(state_b22)


def tail22():
    jb22.bsr.activate()
    wait22(lambda: jb22.bsr.state.last_block_height >= H22 - 1,
           "(b) the tail's blocksync", 120)


_, c_tail22, wall_tail22 = step22("b tail", tail22)
check(jb22.bsr.state.app_hash == states22[H22 - 2].app_hash
      and jb22.app.info(abci_t.RequestInfo()).last_block_height == H22 - 1
      and [jb22.bs.load_block(h).hash()
           for h in range(2 * SNAP22 + 1, H22)]
      == [srv_bs22.load_block(h).hash() for h in range(2 * SNAP22 + 1, H22)]
      and jb22.bsr.device_error is None
      and c_tail22.get("verify_packed", 0) > 0,
      f"phase 22 (b): the tail to {jb22.bsr.state.last_block_height}, "
      f"launches {c_tail22}")
statesync22["b"] = {
    "anchor_launches": jb22.c_anchor, "sync_wall_s": wall_b22,
    "restore": rest_b22, "launches": c_b22,
    "lanes": launch_rows22("b sync"), "tail_wall_s": wall_tail22,
    "tail_heights": H22 - 1 - 2 * SNAP22, "tail_launches": c_tail22,
    "tail_lanes": launch_rows22("b tail"),
    "last_changed_heights": (state_b22.last_height_validators_changed,
                             state_b22.last_height_consensus_params_changed,
                             want_b.last_height_validators_changed,
                             want_b.last_height_consensus_params_changed)}
log(phase=22, card=CARD, at_s=time.perf_counter() - T22, step="b joiner", **statesync22["b"])

# -- (c) the prewarmed sync: the set's tables built (C1 at 256 keys), then a
# second joiner served only the snapshot at 50 (a peer that holds no other)
# restores it with every certificate on C2
ok_c22, c_pre22, wall_pre22 = step22(
    "c prewarm", lambda: E.prewarm(pubs22, device=DEV))
check(ok_c22 and c_pre22.get("comb_build") == 1,
      f"phase 22 (c): the prewarm {ok_c22}, launches {c_pre22}")


class Only22:
    """A serving app that offers only its snapshot at one height."""

    def __init__(self, app, height):
        self.app, self.height = app, height

    def list_snapshots(self):
        return [s for s in self.app.list_snapshots()
                if s.height == self.height]

    def load_snapshot_chunk(self, height, format_, index):
        return self.app.load_snapshot_chunk(height, format_, index)


ss50_22 = StateSyncReactor(Only22(srv_app22, SNAP22))
sw50_22 = switch22("server50", {"STATESYNC": ss50_22})
jc22 = joiner22("joiner50", sw50_22, RestoreLedger(MemDB()), (SNAP22,))
(state_c22, commit_c22), c_c22, wall_c22 = step22(
    "c sync", lambda: jc22.r.syncer.sync_any())
rest_c22 = restore_view22(jc22)
check(restored22(jc22, SNAP22) and state_c22.app_hash
      == states22[SNAP22 - 1].app_hash
      and c_c22.get("comb_verify", 0) > 0 and "verify_packed" not in c_c22
      and jc22.c_anchor.get("comb_verify", 0) == 1,
      f"phase 22 (c): the prewarmed restore {rest_c22}, launches {c_c22}, "
      f"anchor {jc22.c_anchor}")
statesync22["c"] = {"prewarm_wall_s": wall_pre22, "prewarm": c_pre22,
                    "sync_wall_s": wall_c22, "restore": rest_c22,
                    "launches": c_c22, "lanes": launch_rows22("c sync")}
log(phase=22, card=CARD, at_s=time.perf_counter() - T22, step="c prewarmed joiner", **statesync22["c"])
E.table_cache_clear()


# -- (d) txs through the RPC server into the serving node's IngressGate (the
# reference DefaultMempoolConfig, phase 20's): broadcast_tx_sync from 4
# client threads, each with WIDTH22 requests in flight on as many
# connections (the server's handler threads admit them together, so the
# gate's batches fill and its MEMPOOL windows reach the card); every
# response against a device="cpu" gate's on the same txs; the window that
# held a corrupted tx against OpenSSL
def rpc_burst22(addr, txs, method, width=WIDTH22):
    """One JSON-RPC call of `method` a tx from this thread, `width` in
    flight (a connection each; a new one sent as the oldest is answered);
    the replies in order."""
    host, port = addr.rsplit(":", 1)
    out, flight = [], []

    def take():
        c = flight.pop(0)
        out.append(json.loads(c.getresponse().read()))
        c.close()
    for i, tx in enumerate(txs):
        if len(flight) >= width:
            take()
        c = http.client.HTTPConnection(host, int(port), timeout=120)
        c.request("POST", "/", json.dumps({
            "jsonrpc": "2.0", "id": i, "method": method,
            "params": {"tx": base64.b64encode(tx).decode()}}),
            {"Content-Type": "application/json"})
        flight.append(c)
    while flight:
        take()
    return out


def clients22(addr, txs, method):
    """CLIENTS22 client threads, each sending every CLIENTS22-th tx."""
    got = [None] * CLIENTS22

    def run(k):
        got[k] = rpc_burst22(addr, txs[k::CLIENTS22], method)
    ths = [threading.Thread(target=run, args=(k,), name=f"rpc-client-{k}")
           for k in range(CLIENTS22)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(300)
    check(all(g is not None for g in got), "phase 22: an RPC client died")
    out = [None] * len(txs)
    for k in range(CLIENTS22):
        out[k::CLIENTS22] = got[k]
    return out


class Held22(App20):
    """App20 whose CheckTx of a marker tx waits until the gate's queue
    holds HOLD22 txs (at most 3 s): a node whose app is busy while a
    burst arrives.  Without it the worker drains the handler threads'
    txs a few at a time, and windows under the card's 32-lane floor take
    the host lane."""

    def __init__(self):
        super().__init__()
        self.gate = None

    def check_tx(self, req):
        if req.tx.startswith(b"hold22="):
            end = time.monotonic() + 3.0
            while len(self.gate._queue) < HOLD22 \
                    and time.monotonic() < end:
                time.sleep(0.002)
        return super().check_tx(req)


def held_burst22(marker, txs, method="broadcast_tx_sync"):
    """The marker through broadcast_tx_async (it holds the worker), then
    the txs from the client threads."""
    check("result" in rpc_burst22(rpc22.laddr, [marker],
                                  "broadcast_tx_async")[0],
          f"phase 22: the marker {marker!r}")
    return clients22(rpc22.laddr, txs, method)


HOLD22 = CLIENTS22 * WIDTH22 * 3 // 4
s_d22 = sched20()
subs20.clear()
record_subs20(s_d22)
app_d22 = Held22()
mp_d22 = Mempool(app_d22, registry=Registry("p22 d"), **MP20)
g_d22 = gate20(mp_d22)
app_d22.gate = g_d22
node22.mempool, node22.ingress_gate = mp_d22, g_d22
signed_d22 = sigtxs20(TX22)
bad_d22 = set(rng22.sample(range(TX22 - ASYNC22), BAD22))
signed_d22 = [corrupt20(tx) if i in bad_d22 else tx
              for i, tx in enumerate(signed_d22)]
sync_d22, async_d22 = signed_d22[:-ASYNC22], signed_d22[-ASYNC22:]
bad_set22 = {signed_d22[i] for i in bad_d22}
res_d22, c_d22, wall_d22 = step22(
    "d broadcast_tx_sync", lambda: held_burst22(b"hold22=d", sync_d22),
    site="sched.ed25519")
res_a22, c_a22, wall_a22 = step22(
    "d broadcast_tx_async", lambda: (
        clients22(rpc22.laddr, async_d22, "broadcast_tx_async"),
        wait22(lambda: set(async_d22) <= set(mp_d22.reap_max_txs(-1)),
               "(d) the async txs reaching the pool", 60))[0])
st_d22 = g_d22.stats()
stop_sched20(s_d22)
# the same txs through a gate and a scheduler on device="cpu" (its
# pre-verify on the host lanes), in the same order
s_dc22 = vsched.install(vsched.VerifyScheduler(device="cpu"))
s_dc22.start()
mp_dc22 = Mempool(App20(), registry=Registry("p22 d cpu"), **MP20)
g_dc22 = gate20(mp_dc22, device="cpu")
label22[0] = "d cpu"
t = time.perf_counter()
want_d22, c_dc22 = main_path(lambda: settle20(
    [g_dc22.submit(tx) for tx in sync_d22]))
walls22["d cpu gate"] = time.perf_counter() - t
g_dc22.stop()
stop_sched20(s_dc22)
# the serving node's gate goes on with a scheduler on the card, for (g)
s_d22 = sched20()
view_d22 = [(r["result"]["code"], r["result"]["data"], r["result"]["log"])
            if "result" in r else ("error", r["error"]["code"]) for r in res_d22]
want_view22 = [(r.code, base64.b64encode(r.data or b"").decode(), r.log)
               for r in want_d22]
hash_ok22 = all(r["result"]["hash"] == tblock.tx_hash(tx).hex().upper()
                for r, tx in zip(res_d22, sync_d22) if "result" in r)
mism_d22 = sum(a != b for a, b in zip(view_d22, want_view22))
win_d22 = next(((items, fut) for items, fut in subs20
                if any(ingress.SIGTX_MAGIC + bytes(pub) + bytes(sig)
                       + msg[MAGIC20 + 32:] in bad_set22
                       for pub, msg, sig in items)), None)
check(win_d22 is not None, "phase 22 (d): no window held a corrupted tx")
bits_d22 = np.asarray(win_d22[1].result(timeout=0))
want_bits_d22 = np.array([edkeys._ossl_verify(bytes(p), m, bytes(s))
                          for p, m, s in win_d22[0]], dtype=bool)
oracle22 = ("(d) a pre-verify window", len(want_bits_d22),
            int((bits_d22 != want_bits_d22).sum()),
            int((~want_bits_d22).sum()))
check(mism_d22 == 0 and hash_ok22 and c_dc22["verify_packed"] == 0
      and c_d22.get("verify_packed", 0) > 0
      and view_d22.count((1, "", "invalid signature")) == BAD22
      and all(r.get("result", {}).get("code") == 0 for r in res_a22)
      and st_d22["device_error"] == 0 and oracle22[2] == 0
      and oracle22[3] > 0,
      f"phase 22 (d): {mism_d22} responses differ from the device='cpu' "
      f"gate's ({sorted(set(view_d22), key=str)}), launches {c_d22}, "
      f"gate {st_d22}, OpenSSL {oracle22}")


# a full queue answers RPC_BUSY_CODE with its Retry-After: a gate of one
# queued tx whose worker is held inside CheckTx
class Hold22:
    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def check_tx(self, req):
        self.entered.set()
        self.release.wait(60)
        return abci_t.ResponseCheckTx(code=abci_t.CODE_TYPE_OK)


t = time.perf_counter()
hold22 = Hold22()
mp_h22 = Mempool(hold22, registry=Registry("p22 busy"), **MP20)
g_h22 = gate20(mp_h22, queue_size=1, batch=1)
node_h22 = SimpleNamespace(**{**vars(node22), "mempool": mp_h22,
                              "ingress_gate": g_h22})
rpc_h22 = RPCServer(node_h22, "127.0.0.1:0")
rpc_h22.start()
first22 = rpc_burst22(rpc_h22.laddr, [b"held=1"], "broadcast_tx_async")
wait22(hold22.entered.is_set, "(d) the held CheckTx", 30)
second22 = rpc_burst22(rpc_h22.laddr, [b"queued=1"], "broadcast_tx_async")
busy22 = rpc_burst22(rpc_h22.laddr, [b"refused=1"], "broadcast_tx_sync")[0]
hold22.release.set()
check("result" in first22[0] and "result" in second22[0]
      and busy22.get("error", {}).get("code") == RPC_BUSY_CODE
      and "retry after" in busy22["error"]["message"],
      f"phase 22 (d): the full queue answered {first22}, {second22}, "
      f"{busy22}")
rpc_h22.stop()
g_h22.stop()
walls22["d busy"] = time.perf_counter() - t
statesync22["d"] = {
    "sync_wall_s": wall_d22, "sync_txs_per_s": len(sync_d22) / wall_d22,
    "async_wall_s": wall_a22, "launches": c_d22, "async_launches": c_a22,
    "lanes": launch_rows22("d broadcast_tx_sync"),
    "responses": {str(v): view_d22.count(v)
                  for v in sorted(set(view_d22), key=str)},
    "cpu_mismatches": mism_d22, "gate": st_d22, "openssl": oracle22,
    "busy": busy22["error"], "pool": mp_d22.size()}
log(phase=22, card=CARD, at_s=time.perf_counter() - T22, step="d txs through the RPC", **statesync22["d"])


# -- (e) light verification through the RPC: LightServe over the serving
# node's stores, its set prewarmed (C2); LIGHT22 clients each asking the
# adjacent and the non-adjacent (from height 1) verification of the same
# headers, as light clients of one chain do
def sh22(h):
    com = (srv_bs22.load_block(h + 1).last_commit if h < srv_bs22.height()
           else srv_bs22.load_seen_commit(h))
    return base64.b64encode(tlight.SignedHeader(
        srv_bs22.load_block(h).header, com).proto()).decode()


def vals22(h):
    return base64.b64encode(srv_ss22.load_validators(h).proto()).decode()


lb22 = {h: (sh22(h), vals22(h)) for h in
        {1, *LIGHT_H22, *(h - 1 for h in LIGHT_H22), H22 - 3, H22 - 2}}


def light_call22(client, kind, t, u):
    params = {"kind": kind, "trusted": lb22[t][0], "untrusted": lb22[u][0],
              "untrusted_vals": lb22[u][1], "now": NOW22.seconds,
              "trusting_period_s": PERIOD22, "client": client}
    if kind == "non_adjacent":
        params["trusted_vals"] = lb22[t][1]
    body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": "light_verify",
                       "params": params})
    host, port = rpc22.laddr.rsplit(":", 1)
    c = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        c.request("POST", "/", body, {"Content-Type": "application/json"})
        return json.loads(c.getresponse().read())
    finally:
        c.close()


svc22 = lserve.LightServe(srv_bs22, srv_ss22, CHAIN, prewarm=False,
                          event_bus=bus22)
svc22.metrics = LightMetrics(Registry("p22 light serve"))
svc22.start()
node22.light_serve = svc22


def light_e22():
    check(E.prewarm(pubs22, device=DEV), "phase 22 (e): the prewarm")
    got = [None] * LIGHT22

    def run(k):
        got[k] = [(kind, h, light_call22(f"client-{k}", kind,
                                         h - 1 if kind == "adjacent" else 1,
                                         h))
                  for h in LIGHT_H22 for kind in ("adjacent", "non_adjacent")]
    ths = [threading.Thread(target=run, args=(k,)) for k in range(LIGHT22)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(300)
    return got


got_e22, c_e22, wall_e22 = step22("e light_verify", light_e22)
rows_e22 = [r for g in got_e22 if g is not None for r in g]
check(len(rows_e22) == LIGHT22 * len(LIGHT_H22) * 2
      and all(r.get("result") == {"ok": True, "error": None}
              for _, _, r in rows_e22)
      and c_e22.get("comb_verify", 0) > 0 and "verify_packed" not in c_e22,
      f"phase 22 (e): verdicts "
      f"{sorted({json.dumps(r) for _, _, r in rows_e22})[:4]}, launches "
      f"{c_e22}")
statesync22["e"] = {"calls": len(rows_e22), "wall_s": wall_e22,
                    "calls_per_s": len(rows_e22) / wall_e22,
                    "launches": c_e22, "lanes": launch_rows22("e "),
                    "serve": svc22.report()}
log(phase=22, card=CARD, at_s=time.perf_counter() - T22, step="e light_verify", **{
    k: v for k, v in statesync22["e"].items() if k != "serve"})
E.table_cache_clear()

# -- (f) PEX: a seed and PEX22 Switches that know only the seed; each learns
# the others' addresses and dials them; a peer flooding PexRequests is
# disconnected and banned.  Host only
t = time.perf_counter()
seed_book22 = AddrBook()
seed_r22 = PexReactor(seed_book22, ensure_period_s=PEX_PERIOD22,
                      target_out_peers=0)
sw_seed22 = switch22("seed22", {"PEX": seed_r22})
seed_book22.add_our_id(sw_seed22.node_key.node_id)
seed_addr22 = f"{sw_seed22.node_key.node_id}@{sw_seed22.actual_listen_addr()}"
pex22 = []
for i in range(PEX22):
    book = AddrBook()
    r = PexReactor(book, ensure_period_s=PEX_PERIOD22, target_out_peers=4,
                   seeds=seed_addr22)
    sw = switch22(f"pex22-{i}", {"PEX": r})
    book.add_our_id(sw.node_key.node_id)
    pex22.append((sw, book, r))
ids22 = [sw.node_key.node_id for sw, _, _ in pex22]


def learned22():
    return all(all(book.has(o) for o in ids22 if o != sw.node_key.node_id)
               and len(sw.peers) >= PEX22 - 1 for sw, book, _ in pex22)


wait22(learned22, "(f) PEX discovery", 60)
wall_f22 = time.perf_counter() - t
fl_r22 = PexReactor(AddrBook(), ensure_period_s=30.0)
sw_fl22 = switch22("flooder22", {"PEX": fl_r22})
victim22 = pex22[0][0]
peer_fl22 = sw_fl22.dial_peer(victim22.actual_listen_addr())
check(peer_fl22 is not None, "phase 22 (f): the flooder could not dial")
peer_fl22.send(PEX_CHANNEL, PexRequest())
peer_fl22.send(PEX_CHANNEL, PexRequest())
fl_id22 = sw_fl22.node_key.node_id
t = time.perf_counter()
wait22(lambda: fl_id22 not in victim22.peers
       and pex22[0][1].is_banned(fl_id22), "(f) the flood's disconnect", 30)
walls22["f flood"] = time.perf_counter() - t
statesync22["f"] = {
    "wall_s": wall_f22, "books": [book.size() for _, book, _ in pex22],
    "peers": [len(sw.peers) for sw, _, _ in pex22],
    "seed_book": seed_book22.size(),
    "trust": [round(r.trust.peer_trust(o), 3) for sw, _, r in pex22[:1]
              for o in ids22[1:]], "flood_banned": True}
log(phase=22, card=CARD, at_s=time.perf_counter() - T22, step="f pex", **statesync22["f"])
t = time.perf_counter()
for sw in [sw_fl22, sw_seed22] + [sw for sw, _, _ in pex22]:
    sw.stop()
walls22["f stop"] = time.perf_counter() - t


# -- (g) card faults and drills: K1's wrapper raising with no failpoint
# armed (the set's tables gone, so the certificates take K1), each under a
# fresh SigCache; the runtime re-configured after each
def card_fault22(what, fn):
    check(not failpoints.armed(), "phase 22: a failpoint is armed")
    cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
    label22[0] = f"g {what}"
    rt = degrade.runtime()
    fails0 = counter_total(rt.metrics.device_failures)
    falls0 = counter_total(rt.metrics.host_fallbacks)
    keeping = ck.verify_packed
    ck.verify_packed = launch_failed
    t = time.perf_counter()
    try:
        out = fn()
    finally:
        ck.verify_packed = keeping
    join_abandoned()
    row = {"what": what, "wall_s": time.perf_counter() - t,
           "failures": counter_total(rt.metrics.device_failures) - fails0,
           "fallbacks": counter_total(rt.metrics.host_fallbacks) - falls0}
    degrade.configure(degrade.DegradeConfig.from_env(),
                      registry=Registry(f"p22 {what}"))
    return out, row


def raises22(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - returned and checked
        return e
    return None


faults22 = []
# (g1) sync_any: a node whose ledger holds three quarters of snapshot 100's
# chunks, verified (a restore a crash cut short)
PREFIX22 = snap_b22.chunks * 3 // 4
ledger_g22 = RestoreLedger(SQLiteDB(os.path.join(root22, "statesync_g.db")))
ledger_g22.begin(snap_b22)
for i in range(PREFIX22):
    ledger_g22.put_chunk(i, srv_app22.load_snapshot_chunk(
        snap_b22.height, snap_b22.format, i))
ledger_g22.flush()
jg22 = joiner22("joiner-fault22", sw_srv22, ledger_g22, (2 * SNAP22,))
banned0_22 = ssync.metrics().peers_banned.value()
err_g1, row = card_fault22("sync_any", lambda: raises22(
    jg22.r.syncer.sync_any))
row.update(error=type(err_g1).__name__, offers=jg22.app.offers,
           rejected=len(jg22.r.syncer._rejected), bans=len(jg22.bans),
           banned_total=ssync.metrics().peers_banned.value() - banned0_22,
           ledger=len(ledger_g22.begin(snap_b22)),
           peer_kept=jg22.server_id in jg22.sw.peers)
faults22.append(row)
check(isinstance(err_g1, degrade.DeviceLaneError) and row["offers"] == 0
      and row["rejected"] == 0 and row["bans"] == 0
      and row["banned_total"] == 0 and row["ledger"] == PREFIX22
      and row["peer_kept"] and row["failures"] >= 1
      and row["fallbacks"] == 0,
      f"phase 22 (g): sync_any's card fault {row} ({err_g1!r})")
# the card back: a fresh Syncer over the same ledger and app resumes
jg22.r.syncer = ssync.Syncer(
    jg22.app, StateProvider(jg22.lc, now=NOW22), jg22.r._fetch_chunk,
    ban_peer=jg22.r._ban_peer, fetchers=ssync.DEFAULT_FETCHERS,
    chunk_timeout_s=ssync.DEFAULT_CHUNK_TIMEOUT_MS / 1000.0,
    retries=ssync.DEFAULT_RETRIES, ledger=ledger_g22,
    stop_event=jg22.r.quitting)
jg22.r.request_snapshots()
wait22(lambda: {k[0] for k in jg22.r.syncer._snapshots} >= {2 * SNAP22},
       "(g) the resume's discovery", 30)
(state_g22, _), c_res22, wall_res22 = step22(
    "g resume", lambda: jg22.r.syncer.sync_any())
rest_g22 = restore_view22(jg22)
check(restored22(jg22, 2 * SNAP22) and rest_g22["resumed"] == PREFIX22
      and state_view17(state_g22) == view_b
      and c_res22.get("verify_packed", 0) > 0,
      f"phase 22 (g): the resume {rest_g22}, launches {c_res22}")
# (g2) broadcast_tx_sync: signed txs through the RPC with K1 raising (the
# worker held as in (d)); a window at the card's lane floor or above fails
# with DeviceLaneError and each of its txs is answered -32603 (never a
# CheckTx code, never busy)
signed_g22 = sigtxs20(256)
res_g2, row = card_fault22("broadcast_tx_sync", lambda: held_burst22(
    b"hold22=g", signed_g22))
errs_g2 = [r["error"] for r in res_g2 if "error" in r]
row.update(answers=sorted({json.dumps(r.get("error", {}).get("code", 0))
                           for r in res_g2}),
           internal=len(errs_g2),
           device_error=type(g_d22.device_error).__name__)
faults22.append(row)
check(errs_g2 and all(e["code"] == -32603
                      and "device lane failed on the card" in e["message"]
                      for e in errs_g2)
      and all(r["result"]["code"] == 0 for r in res_g2 if "result" in r)
      and isinstance(g_d22.device_error, degrade.DeviceLaneError)
      and row["failures"] >= 1 and row["fallbacks"] == 0,
      f"phase 22 (g): broadcast_tx_sync's card fault {row} "
      f"{errs_g2[:2]}")
# (g3) light_verify: a certificate of LightServe on K1
res_g3, row = card_fault22("light_verify", lambda: light_call22(
    "fault", "adjacent", H22 - 3, H22 - 2))
row.update(answer=res_g3.get("error") or res_g3.get("result"))
faults22.append(row)
check(res_g3.get("error", {}).get("code") == -32603
      and "device lane failed on the card" in res_g3["error"]["message"]
      and row["failures"] >= 1 and row["fallbacks"] == 0,
      f"phase 22 (g): light_verify's card fault {row}")
_, c_g3b, _ = step22("g light_verify again", lambda: check(
    light_call22("again", "adjacent", H22 - 3, H22 - 2).get("result")
    == {"ok": True, "error": None}, "phase 22 (g): light_verify again"))
svc22.stop()
node22.light_serve = None
g_d22.stop()
stop_sched20(s_d22)


# the statesync.* drills on snapshot 50, each through a Syncer over two
# providers that read the serving app: the reference's outcome at each
class Recording22:
    def __init__(self):
        self.app = KVStoreApplication()
        self.applied = []

    def __getattr__(self, name):
        return getattr(self.app, name)

    def apply_snapshot_chunk(self, index, chunk, sender):
        self.applied.append(index)
        return self.app.apply_snapshot_chunk(index, chunk, sender)


sp_dr22 = StateProvider(jc22.lc, now=NOW22)


def drill_sync22(app, **kw):
    syncer = ssync.Syncer(app, sp_dr22, lambda s, i, p: (
        srv_app22.load_snapshot_chunk(s.height, s.format, i), p), **kw)
    for p in ("p1", "p2"):
        syncer.add_snapshot(snaps22[SNAP22], p)
    return syncer.sync_any()


drills22 = {}
m22 = ssync.metrics()
t = time.perf_counter()
for site, mode, kw in (("statesync.fetch", "raise", {"retries": 1}),
                       ("statesync.fetch", "corrupt-chunk", {"retries": 1}),
                       ("statesync.verify", "raise", {"retries": 1}),
                       ("statesync.apply", "raise", {})):
    app = Recording22()
    corrupt0 = m22.chunks_verified.value(outcome="corrupt")
    failpoints.set_mode(site, mode)
    label22[0] = f"g drill {site}={mode}"
    try:
        err = raises22(lambda: drill_sync22(app, **kw))
        fired = failpoints.fired(site, mode)
    finally:
        failpoints.clear()
    drills22[f"{site}={mode}"] = {
        "error": type(err).__name__, "fired": fired,
        "applied": len(app.applied), "message": str(err)[:120],
        "corrupt": m22.chunks_verified.value(outcome="corrupt") - corrupt0}
d22 = drills22
check(all(v["error"] == "StateSyncError" and v["fired"] >= 1
          for v in d22.values())
      and d22["statesync.fetch=raise"]["applied"] == 0
      and d22["statesync.fetch=corrupt-chunk"]["applied"] == 0
      and d22["statesync.fetch=corrupt-chunk"]["corrupt"] > 0
      and d22["statesync.verify=raise"]["applied"] == 0
      and "REJECTED" in d22["statesync.apply=raise"]["message"],
      f"phase 22 (g): the statesync drills {d22}")
err0_22 = ssync.metrics().serve_refused.value(reason="error")
failpoints.set_mode("statesync.serve", "raise")
try:
    busy_g22 = raises22(lambda: jg22.r._fetch_chunk(
        snap_b22, 0, jg22.server_id))
    fired22 = failpoints.fired("statesync.serve", "raise")
finally:
    failpoints.clear()
served_g22 = jg22.r._fetch_chunk(snap_b22, 0, jg22.server_id)
drills22["statesync.serve=raise"] = {
    "error": type(busy_g22).__name__, "fired": fired22,
    "refused": ssync.metrics().serve_refused.value(reason="error") - err0_22,
    "served_after": served_g22[0] == srv_app22.load_snapshot_chunk(
        snap_b22.height, snap_b22.format, 0)}
check(isinstance(busy_g22, ssync.ChunkBusy) and fired22 >= 1
      and drills22["statesync.serve=raise"]["refused"] >= 1
      and drills22["statesync.serve=raise"]["served_after"],
      f"phase 22 (g): the serve drill {drills22['statesync.serve=raise']}")
walls22["g drills"] = time.perf_counter() - t
statesync22["g"] = {"faults": faults22, "resume_wall_s": wall_res22,
                    "resume": rest_g22, "resume_launches": c_res22,
                    "drills": drills22}
log(phase=22, card=CARD, at_s=time.perf_counter() - T22, step="g card faults and drills", **statesync22["g"])
t = time.perf_counter()
for j in (jb22, jc22, jg22):
    j.sw.stop()
for sw in (sw_srv22, sw50_22):
    sw.stop()
rpc22.stop()
wit22.stop()
walls22["teardown"] = time.perf_counter() - t

# -- every launch of the phase against its plain version on the same inputs
# (grouped by step), C2 against the plain tables of the build it used
label22[0] = ""
for _name in keep22:
    setattr(KERNEL_MOD[_name], _name, was22[_name])
cmp22 = {name: [] for name in keep22}
t = time.perf_counter()
for name, plain in (("verify_packed", ck.verify_packed_plain),
                    ("verify_packed_split", ck.verify_packed_split_plain)):
    runs = keep22[name]
    if not runs:
        continue
    got = torch.cat([out for _, _, out in runs])
    cols = [torch.cat([args[k] for _, args, _ in runs], dim=1)
            for k in range(len(runs[0][1]))]
    step_of = np.repeat([label or "-" for label, _, _ in runs],
                        [out.shape[0] for _, _, out in runs])
    real = (cols[-1] != 0).any(dim=0)
    check(not got[~real].any(), f"phase 22 {name}: a padding lane passed")
    got = got[real].cpu().numpy()
    step_of = step_of[real.cpu().numpy()]
    # the plain version once on each distinct lane, its verdict mapped
    # back to every lane of every launch
    uniq, inv = torch.unique(torch.cat([c[:, real] for c in cols]), dim=1,
                             return_inverse=True)
    sizes = [c.shape[0] for c in cols]
    ucols = list(torch.split(uniq, sizes))
    want_u = torch.cat([plain(*[c[:, a:a + 65_536] for c in ucols]).cpu()
                        for a in range(0, uniq.shape[1], 65_536)])
    want = want_u[inv.cpu()].numpy()
    err = np.abs(got.astype(int) - want.astype(int))
    for g in sorted(set(step_of)):
        on = step_of == g
        n_runs = sum((label or "-") == g for label, _, _ in runs)
        cmp22[name].append((f"phase 22 ({g}): {n_runs} launches, "
                            f"{uniq.shape[1]} distinct lanes",
                            int(on.sum()), int(err[on].sum()),
                            float(err[on].max())))
builds22 = {}
for label, args, (tab, ok) in keep22["comb_build"]:
    ptab, pok = cc.comb_build_plain(args[0])
    builds22[id(tab)] = (ptab, pok)
    cmp22["comb_build"].append(
        (f"phase 22 {label}", args[0].shape[0],
         cc.tables_mismatch(tab, ptab) + int((ok != pok).sum())))
check(all(id(args[1]) in builds22 for _, args, _ in keep22["comb_verify"]),
      "phase 22: a C2 launch on a table that no build of the phase made")
for key, (ptab, pok) in builds22.items():
    runs = [(args, out) for _, args, out in keep22["comb_verify"]
            if id(args[1]) == key]
    if not runs:
        continue
    rows_c2 = torch.cat([args[0] for args, _ in runs])
    got = torch.cat([out for _, out in runs]).cpu().numpy()
    urows, uinv = torch.unique(rows_c2, dim=0, return_inverse=True)
    want = cc.comb_verify_plain(urows, ptab, pok).cpu()[uinv.cpu()]
    cmp22["comb_verify"].append(c2_row(
        f"phase 22: {len(runs)} launches on one table, {urows.shape[0]} "
        f"distinct rows", got, want.numpy()))
plain22_s = time.perf_counter() - t
# the card's time for each step's launches: the kept launches of a kernel
# replayed back to back between two CUDA events on a quiet card, against
# the step's host wall
card22 = {}
if ON_CARD22:
    for name in ("verify_packed", "comb_verify"):
        for step in sorted({lab for lab, _, _ in keep22[name]}):
            if step not in walls22:
                continue
            runs = [args for lab, args, _ in keep22[name] if lab == step]
            REAL[name](*runs[0])
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            for a in runs:
                REAL[name](*a)
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
            card22[f"{step} {name}"] = {
                "launches": len(runs), "ms": ms, "wall_s": walls22[step],
                "card_share": ms / 1e3 / walls22[step]}
log(phase=22, card=CARD, at_s=time.perf_counter() - T22, step="card time", replayed=card22)
E.table_cache_clear()
staging_clear(22)
shutil.rmtree(root22)
tmlog.setup("info")
gc.callbacks.remove(_gc17)
gc.unfreeze()
launches22 = {name: len(v) for name, v in keep22.items()}
statesync22.update(gc={"collections": gc17["n"], "seconds": gc17["s"]},
                   card_time=card22, comparisons=cmp22, walls=walls22,
                   launches=launches22, plain_s=plain22_s,
                   phase_s=time.perf_counter() - T22)
log(phase=22, card=CARD, at_s=time.perf_counter() - T22, launches=launches22, comparisons=cmp22,
    plain_s=plain22_s, phase_s=statesync22["phase_s"])
check(launches22["verify_packed"] > 0 and launches22["comb_verify"] > 0
      and launches22["comb_build"] > 0
      and all(r[2] == 0 for rows in cmp22.values() for r in rows),
      f"phase 22: a kernel disagrees with its plain version: {cmp22}")
REPORT["statesync_rpc"] = statesync22

# -- phase 23: the node, its config, the CLI and the light proxy -------------
# The node assembled from its config as a user starts it.  (a) four node
# processes from the CLI's `testnet` homes, each `start --device cuda` on
# the card: a flood of signed txs into node 0's broadcast_tx_sync from 4
# client threads, gossiped to the others, pre-verified by each process's
# IngressGate (K1).  Four signatures a commit are under the batch floor,
# so the flood is what puts the card on this path; and because HTTP
# clients hand the gate a few txs at a time (phase 22 (d)), each home's
# [batch_verifier] tpu_threshold is 1, so every MEMPOOL window, however
# small, goes to the card.  Every answer equals a device="cpu" gate's in
# this process; the chains reach HEIGHTS23 heights with equal blocks; each
# process's launches, failures, fallbacks and breaker are read from its own
# /metrics; node 3 is SIGKILLed and restarted from its home (handshake,
# WAL catch-up, blocksync) and commits on; the debug-device,
# debug-consensus, show-node-id and version commands run against the homes
# and processes; each node's own height wall and /debug/gc are logged.
# (b) at BASELINE config 2's width (150 validators, 1,000 txs of 64 bytes
# a block): a Node(device="cuda"), a non-validator, serves a kvstore chain
# of H23 heights with snapshots every SNAP23 from its SQLite home; a fresh
# Node with [state_sync] enable (trust at height 1) restores the newest
# snapshot through its own _statesync_routine (its light certificates on
# K1), blocksyncs the tail (K1 windows), switches to consensus, and its
# app hash is the chain's; a LightProxy in front of the serving node
# answers headers and commits equal to the node's RPC, after a prewarm of
# the set (C1; the proxy's certificates on C2); /debug/device and
# /debug/light from the joiner's pprof server.  (c) K1's wrapper raising
# with no failpoint armed under a joiner's _statesync_routine (its ledger
# holding three quarters of the snapshot's chunks): node.device_error
# set, no blocksync fallback, nothing offered, rejected or banned; a
# fresh Node over the same home resumes from the RestoreLedger on the
# card; then the control.decide=raise drill on a node with [control]
# enable: every knob reverts to its static value.  Every K1, C1 and C2
# launch of (b) and (c) is held against its plain version.  Walls are
# host-clock, logged and not gated.
NET23, FLOOD23, BAD23, CLIENTS23, HEIGHTS23 = 4, 2000, 20, 4, 12   # (a)
N23, H23, TXS23, SNAP23 = 150, 61, 1000, 25                        # (b)
CHAIN23 = "chip-smoke-23"
T23 = time.perf_counter()
rng23 = random.Random(SEED + 23)
E.table_cache_clear()
check(not msm.use_rlc(10_000) and not failpoints.armed()
      and vsched.installed() is None and bpipe.installed() is None
      and control.installed() is None,
      "phase 23: RLC, a failpoint, a scheduler, a pipeline or a controller "
      "is still on")
degrade.configure(degrade.DegradeConfig.from_env(), registry=Registry("p23"))
ingress.set_enabled(None)
ON_CARD23 = DEV.type == "cuda"
HERE23 = os.path.dirname(os.path.abspath(__file__))
root23 = tempfile.mkdtemp(prefix="smoke23_")
node23: dict = {"card": CARD}
walls23: dict = {}
tmlog.setup("info", module_levels="statesync:error,blocksync:error,"
            "p2p:error,mempool:error,light:error,rpc:error,pex:error,"
            "consensus:error,node:error,state:error,control:error")


clis23: list = []      # every CLI process the phase starts


def cli23_start(*argvs):
    """`python3 -m tendermint_tpu_torch.cmd <argv>` from the checkout for
    each argv, all started together (each pays a torch import)."""
    started = [(argv, subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.cmd", *argv],
        cwd=HERE23, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for argv in argvs]
    clis23.extend(p for _, p in started)
    return started


def cli23_wait(started, timeout=120.0):
    """The standard outputs of cli23_start's commands (each must exit
    0)."""
    outs = []
    for argv, p in started:
        out, err = p.communicate(timeout=timeout)
        check(p.returncode == 0, f"phase 23: `cmd {' '.join(argv)}` exited "
              f"{p.returncode}: {err[-3000:]}")
        outs.append(out)
    return outs


def free_ports23(n):
    """The first of n consecutive free ports on 127.0.0.1 (the testnet
    command numbers its nodes' ports up from a base)."""
    for _ in range(500):
        base = rng23.randrange(20_000, 60_000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    fail("phase 23: no range of free ports")


def wait23(cond, what, timeout):
    end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < end, f"phase 23: {what} timed out")
        time.sleep(0.05)


def rpc23(addr, method, **params):
    """One JSON-RPC call; None while the server does not answer."""
    try:
        return rpcclient.HTTPClient(addr, timeout=30).call(method, **params)
    except (OSError, rpcclient.RPCClientError):
        return None


def get23(addr, path):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=30) as r:
        return r.read().decode()


def height23(addr):
    st = rpc23(addr, "status")
    return -1 if st is None else int(st["sync_info"]["latest_block_height"])


# -- (a) node processes from the CLI's testnet homes
t = time.perf_counter()
net23 = os.path.join(root23, "net")
base23 = free_ports23(3 * NET23)
cli23_wait(cli23_start(
    ("testnet", "--v", str(NET23), "--o", net23, "--chain-id",
     "smoke23-net", "--starting-p2p-port", str(base23),
     "--starting-rpc-port", str(base23 + NET23))))
homes23 = [os.path.join(net23, f"node{i}") for i in range(NET23)]
rpcs23 = [f"127.0.0.1:{base23 + NET23 + i}" for i in range(NET23)]
pprofs23 = [f"127.0.0.1:{base23 + 2 * NET23 + i}" for i in range(NET23)]
for i, home in enumerate(homes23):
    cfg = NodeConfig.load(home)
    cfg.home = home
    cfg.rpc.pprof_laddr = pprofs23[i]
    cfg.batch_verifier.tpu_threshold = 1
    cfg.save()
walls23["a testnet"] = time.perf_counter() - t
procs23: list = [None] * NET23


def start23(i):
    """Node i as a process of its own: `start --device cuda` on its home,
    its log in the phase's directory."""
    logf = open(os.path.join(root23, f"node{i}.log"), "ab")
    procs23[i] = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.cmd", "--home",
         homes23[i], "start", "--device", "cuda", "--log-level", "error"],
        cwd=HERE23, stdout=logf, stderr=subprocess.STDOUT,
        start_new_session=True)
    logf.close()


def logs23(i):
    with open(os.path.join(root23, f"node{i}.log"), "rb") as f:
        return f.read()[-3000:].decode(errors="replace")


def alive23():
    for i, p in enumerate(procs23):
        if p is not None and p.poll() is not None:
            fail(f"phase 23 (a): node {i} exited {p.returncode}:\n"
                 f"{logs23(i)}")
    return True


def stop_procs23():
    """Every process the phase started ends: the nodes (SIGTERM, then
    SIGKILL) and any CLI command still running."""
    for p in clis23:
        if p.poll() is None:
            p.kill()
            p.wait(15)
    for p in procs23:
        if p is not None and p.poll() is None:
            p.terminate()
    for p in procs23:
        if p is None:
            continue
        try:
            p.wait(15)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(15)


try:
    t = time.perf_counter()
    for i in range(NET23):
        start23(i)
    wait23(lambda: alive23() and all(height23(a) >= 2 for a in rpcs23),
           "(a) four node processes committing height 2", 240)
    walls23["a start"] = time.perf_counter() - t
    ids23 = [rpc23(a, "status")["node_info"]["id"] for a in rpcs23]
    h0_23 = [(time.perf_counter(), height23(a)) for a in rpcs23]
    # the flood: 1% of the signed txs corrupted
    flood23 = sigtxs20(FLOOD23)
    bad23 = set(rng23.sample(range(FLOOD23), BAD23))
    flood23 = [corrupt20(tx) if i in bad23 else tx
               for i, tx in enumerate(flood23)]
    got23 = [None] * CLIENTS23

    def client23(k):
        got23[k] = rpc_burst22(rpcs23[0], flood23[k::CLIENTS23],
                               "broadcast_tx_sync")
    t = time.perf_counter()
    ths = [threading.Thread(target=client23, args=(k,),
                            name=f"rpc-client23-{k}")
           for k in range(CLIENTS23)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(600)
    walls23["a flood"] = time.perf_counter() - t
    check(all(g is not None for g in got23), "phase 23 (a): a client died")
    res23 = [None] * FLOOD23
    for k in range(CLIENTS23):
        res23[k::CLIENTS23] = got23[k]
    # the same txs through a gate and a scheduler on device="cpu" here
    s_c23 = vsched.install(vsched.VerifyScheduler(device="cpu"))
    s_c23.start()
    mp_c23 = Mempool(App20(), registry=Registry("p23 cpu"), **MP20)
    g_c23 = gate20(mp_c23, device="cpu")
    want23, c_c23 = main_path(lambda: settle20(
        [g_c23.submit(tx) for tx in flood23]))
    g_c23.stop()
    stop_sched20(s_c23)
    view23 = [(r["result"]["code"], r["result"]["data"], r["result"]["log"])
              if "result" in r else ("error", r["error"]["code"])
              for r in res23]
    want_view23 = [(r.code, base64.b64encode(r.data or b"").decode(), r.log)
                   for r in want23]
    mism23 = sum(a != b for a, b in zip(view23, want_view23))
    check(mism23 == 0 and c_c23["verify_packed"] == 0
          and view23.count((1, "", "invalid signature")) == BAD23,
          f"phase 23 (a): {mism23} answers differ from the device='cpu' "
          f"gate's: {sorted(set(view23), key=str)}")
    wait23(lambda: alive23() and all(height23(a) >= HEIGHTS23
                                     for a in rpcs23),
           f"(a) the chains reaching {HEIGHTS23} heights", 240)
    h1_23 = [(time.perf_counter(), height23(a)) for a in rpcs23]
    blocks23 = [rpc23(a, "block", height=HEIGHTS23) for a in rpcs23]
    check(all(b is not None for b in blocks23)
          and len({json.dumps(b["block_id"]) for b in blocks23}) == 1
          and len({b["block"]["header"]["app_hash"] for b in blocks23}) == 1,
          f"phase 23 (a): the chains differ at height {HEIGHTS23}")
    # each process's own launches, failures, fallbacks and breaker
    per23 = []
    for i, a in enumerate(rpcs23):
        text = get23(a, "/metrics")
        dev = json.loads(get23(pprofs23[i], "/debug/device?last=4"))
        per23.append({
            "node": i,
            "device_launches": metric23(
                text, "tendermint_crypto_device_launch_total"),
            "k1_launches": metric23(
                text, "tendermint_crypto_device_launch_total",
                'site="sched.ed25519"'),
            "failures": metric23(
                text, "tendermint_crypto_device_failure_total"),
            "fallbacks": metric23(
                text, "tendermint_crypto_host_fallback_total"),
            "breaker": metric23(text, "tendermint_crypto_breaker_state"),
            "devobs_keys": sorted(dev)})
    check(all(p["k1_launches"] > 0 and p["failures"] == 0
              and p["fallbacks"] == 0 and p["breaker"] == 0
              for p in per23),
          f"phase 23 (a): a process's runtime did not serve the card: "
          f"{per23}")
    # each node's own height wall over the flood and after it, and its
    # collector's counts
    own23 = [{"node": i, "heights": h1 - h0,
              "s_per_height": (t1 - t0) / max(1, h1 - h0)}
             for i, ((t0, h0), (t1, h1)) in enumerate(zip(h0_23, h1_23))]
    gc23 = [get23(p, "/debug/gc").strip().splitlines() for p in pprofs23]
    # the CLI against the homes and the processes, run while node 3 is
    # killed and restarted from its home (its handshake, WAL catch-up and
    # blocksync run, then it commits on with the others)
    t = time.perf_counter()
    cli_procs23 = cli23_start(
        ("--home", homes23[0], "show-node-id"), ("version",),
        ("--home", homes23[1], "debug-device", "--last", "4"),
        ("--home", homes23[2], "debug-consensus", "--last", "4"))
    procs23[3].kill()
    procs23[3].wait(30)
    procs23[3] = None
    hk23 = height23(rpcs23[0])
    wait23(lambda: alive23() and height23(rpcs23[0]) >= hk23 + 2,
           "(a) three of four committing with node 3 down", 60)
    start23(3)
    hr23 = height23(rpcs23[0])
    wait23(lambda: alive23() and height23(rpcs23[3]) >= hr23 + 2,
           "(a) node 3 restarted and committing", 180)
    hc23 = height23(rpcs23[3]) - 1
    b3, b0 = rpc23(rpcs23[3], "block", height=hc23), \
        rpc23(rpcs23[0], "block", height=hc23)
    check(b3 is not None and b0 is not None
          and b3["block_id"] == b0["block_id"],
          f"phase 23 (a): node 3's block {hc23} after its restart differs")
    nid23, ver23, dd23, dc23 = cli23_wait(cli_procs23)
    nid23, ver23 = nid23.strip(), ver23.strip()
    dd23, dc23 = json.loads(dd23), json.loads(dc23)
    check(nid23 == ids23[0] and ver23 and isinstance(dd23, dict)
          and isinstance(dc23, dict) and dc23.get("nodes"),
          f"phase 23 (a): the CLI answered {nid23!r} (want {ids23[0]!r}), "
          f"{ver23!r}, {sorted(dd23)}, {sorted(dc23)}")
    walls23["a restart and cli"] = time.perf_counter() - t
finally:
    stop_procs23()
node23["a"] = {"answers": {str(v): view23.count(v)
                           for v in sorted(set(view23), key=str)},
               "cpu_mismatches": mism23, "processes": per23,
               "own_height_wall": own23, "gc": gc23,
               "flood_txs_per_s": FLOOD23 / walls23["a flood"],
               "restart_height": hr23, "caught_up_at": hc23 + 1,
               "cli": {"version": ver23, "debug_device": sorted(dd23),
                       "debug_consensus": sorted(dc23)},
               "walls": {k: v for k, v in walls23.items()
                         if k.startswith("a ")}}
log(phase=23, card=CARD, at_s=time.perf_counter() - T23,
    step="a node processes", **node23["a"])

# -- (b) and (c) in this process: every K1, K2, C1 and C2 launch kept
keep23 = {name: [] for name in ("verify_packed", "verify_packed_split",
                                "comb_build", "comb_verify")}
label23 = [""]
was23 = {name: getattr(KERNEL_MOD[name], name) for name in keep23}
_keep23_lock = threading.Lock()


def _keeping23(name):
    """The bare wrapper (REAL), keeping a copy of every launch's tensor
    inputs (C2's tables by reference) and its output; the launches come
    from the nodes' own threads (state sync, blocksync, the proxy's
    handler threads)."""
    def wrapper(*args):
        out = REAL[name](*args)
        kept = [a.clone() if isinstance(a, torch.Tensor)
                and not (name == "comb_verify" and i == 1) else a
                for i, a in enumerate(args)]
        with _keep23_lock:
            keep23[name].append((label23[0], kept, out))
        return out
    return wrapper


for _name in keep23:
    setattr(KERNEL_MOD[_name], _name, _keeping23(_name))
gc.collect()
gc.freeze()
gc17.update(n=[0, 0, 0], s=[0.0, 0.0, 0.0])
gc.callbacks.append(_gc17)


def step23(label, fn, site=None):
    """fn() on the main path with a fresh SigCache and the step's label;
    the runtime must have served it from the card.  Returns (the result,
    the launch counts, the wall)."""
    cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
    label23[0] = label
    t = time.perf_counter()
    out, c = main_path(fn, site=site)
    walls23[label] = time.perf_counter() - t
    runtime_clean(f"phase 23 {label}")
    return out, {k: v for k, v in c.items() if v}, walls23[label]


a23, pubs23 = gen_keys(N23, rng23)
a_of23 = dict(zip(pubs23, a23))
G23 = int(time.time()) - 7200      # two hours ago: inside the trust period
gdoc23 = tgen.GenesisDoc(
    chain_id=CHAIN23, genesis_time=Timestamp(G23, 0),
    validators=[tgen.GenesisValidator(
        address=b"", pub_key_type="ed25519", pub_key_bytes=p, power=10,
        name=f"v{i}") for i, p in enumerate(pubs23)])
gdoc23.validate_and_complete()


def sign23(state, bid, h: int):
    """The commit of height h: a precommit from every validator."""
    vals = state.validators.validators
    sigs = [CommitSig(BlockIDFlag.COMMIT, v.address,
                      Timestamp(G23 + h, 500 + i))
            for i, v in enumerate(vals)]
    commit = Commit(h, 0, bid, sigs)
    vp = [v.pub_key.bytes() for v in vals]
    for cs, sig in zip(sigs, sign_batch(
            [a_of23[p] for p in vp], vp,
            commit_sign_bytes_batch(CHAIN23, commit, list(range(len(vals)))),
            rng23)):
        cs.signature = sig
    return commit


def txs23(h: int):
    out = []
    for i in range(TXS23):
        key = b"n%d_%d=" % (h, i)
        out.append(key + rng23.randbytes(32).hex().encode()[:64 - len(key)])
    return out


def home23(name, **over):
    """A node home: its config (the given sections' keys changed, p2p and
    RPC on free ports, a pprof listener), the genesis, no validator key
    (a non-validator)."""
    cfg = NodeConfig(home=os.path.join(root23, name), moniker=name)
    cfg.ensure_dirs()
    cfg.p2p.laddr = f"127.0.0.1:{free_port22()}"
    cfg.rpc.laddr = f"127.0.0.1:{free_port22()}"
    cfg.rpc.pprof_laddr = f"127.0.0.1:{free_port22()}"
    for sect, kv in over.items():
        for k, v in kv.items():
            setattr(getattr(cfg, sect), k, v)
    cfg.validate_basic()
    cfg.save()
    with open(cfg.genesis_file(), "w") as f:
        f.write(gdoc23.to_json())
    return NodeConfig.load(cfg.home), cfg.home


class Counted23:
    """A kvstore whose offer_snapshot calls are counted."""

    def __init__(self):
        self.app = KVStoreApplication()
        self.offers = 0

    def __getattr__(self, name):
        return getattr(self.app, name)

    def offer_snapshot(self, snapshot, app_hash):
        self.offers += 1
        return self.app.offer_snapshot(snapshot, app_hash)


# (b1) the serving node's home: the chain built and applied into its
# SQLite stores by an executor that trusts its own signatures (no
# launch), the kvstore taking a snapshot every SNAP23 heights; then the
# Node over that home and that app (the handshake finds them level)
t = time.perf_counter()
cfg_s23, hs23 = home23(
    "serve", block_sync={"enable": False}, light_serve={"prewarm": False})
cfg_s23.home = hs23
app_s23 = app18(gdoc23)
app_s23.snapshot_interval = SNAP23
bdb23 = SQLiteDB(cfg_s23.block_db_file())
sdb23 = SQLiteDB(cfg_s23.state_db_file(), commit_every=64)
bs_b23, ss_b23 = BlockStore(bdb23), StateStore(sdb23)
ex_b23 = sexec.BlockExecutor(ss_b23, app_s23)
state = state_from_genesis(gdoc23)
ss_b23.save(state)
states23 = []
last = Commit(0, 0, BlockID(), [])
for h in range(1, H23 + 1):
    block = state.make_block(h, txs23(h), last, [],
                             state.validators.get_proposer().address,
                             block_time=Timestamp(G23 + h, 0))
    parts = tparts.make_block_parts(block)
    bid = BlockID(block.hash(), parts.header())
    seen = sign23(state, bid, h)
    if h > 1:
        ex_b23.mark_commit_verified(h - 1, last)
    state, _ = ex_b23.apply_block(state, bid, block)
    bs_b23.save_block(block, parts, seen)
    states23.append(state)
    last = seen
for db in (bdb23, sdb23):
    db.flush()
    db.close()
walls23["b build"] = time.perf_counter() - t
snaps23 = sorted(s.height for s in app_s23.list_snapshots())
check(snaps23 == [SNAP23, 2 * SNAP23] and not any(keep23.values()),
      f"phase 23 (b): snapshots {snaps23}, build launches "
      f"{ {k: len(v) for k, v in keep23.items()} }")
serve23 = Node(cfg_s23, app_s23, device=DEV)
check(serve23.state.last_block_height == H23
      and serve23.state.app_hash == states23[-1].app_hash
      and serve23.device == DEV,
      "phase 23 (b): the serving Node's handshake did not find its chain")
serve23.start()
srpc23 = serve23.rpc_server.laddr
anchor23 = serve23.block_store.load_block(1).hash()
walls23["b serve"] = time.perf_counter() - t


def joiner23(name, app, **over):
    """A fresh node's home with [state_sync] enable: trust at height 1
    (the anchor taken out of band), the serving node's RPC as primary and
    witness, the serving node as its persistent peer; LightServe on
    without its prewarm."""
    ss = {"enable": True, "rpc_servers": f"{srpc23},{srpc23}",
          "trust_height": 1, "trust_hash": anchor23.hex()}
    cfg, home = home23(
        name, state_sync=ss, light_serve={"prewarm": False},
        p2p={"persistent_peers": f"{serve23.node_key.node_id}@"
             f"{serve23.switch.actual_listen_addr()}"}, **over)
    cfg.home = home
    return cfg, Node(cfg, app, device=DEV)


def synced23(j, app):
    """The joiner restored, blocksynced to the chain's tip and switched
    to consensus, its app at the chain's height and hash."""
    info = app.info(abci_t.RequestInfo())
    return (j._consensus_started.is_set()
            and j.block_store.height() == H23
            and info.last_block_height == H23
            and info.last_block_app_hash == states23[-1].app_hash)


# (b2) the joiner restores snapshot 2 * SNAP23 through its own routine,
# then blocksyncs the tail and switches to consensus
snap_b23 = next(s for s in app_s23.list_snapshots()
                if s.height == 2 * SNAP23)
app_j23 = Counted23()


def join_b23():
    """The joiner made (its light client's anchor checked), started, and
    waited for until it is synced."""
    global cfg_j23, join23
    cfg_j23, join23 = joiner23("join", app_j23)
    check(join23._statesync_active and join23.device == DEV,
          "phase 23 (b): the joiner is not state-syncing on the card")
    join23.start()
    wait23(lambda: synced23(join23, app_j23) or join23.device_error,
           "(b) the joiner's state sync and tail", 240)


_, c_j23, wall_j23 = step23("b joiner", join_b23)
rest_j23 = dict(join23.statesync_reactor.syncer.last_restore or {})
jv23 = {"synced": synced23(join23, app_j23),
        "height": join23.block_store.height(),
        "app": app_j23.info(abci_t.RequestInfo()).last_block_height,
        "offers": app_j23.offers, "error": repr(join23.device_error),
        "chunks": (rest_j23.get("chunks"), snap_b23.chunks)}
check(jv23["synced"] and join23.device_error is None
      and app_j23.offers == 1
      and rest_j23.get("chunks") == snap_b23.chunks
      and c_j23.get("verify_packed", 0) > 0,
      f"phase 23 (b): the joiner {jv23}, its restore {rest_j23}, "
      f"launches {c_j23}")
dev_j23 = json.loads(get23(cfg_j23.rpc.pprof_laddr, "/debug/device?last=8"))
light_j23 = json.loads(get23(cfg_j23.rpc.pprof_laddr, "/debug/light"))
check(isinstance(dev_j23, dict) and light_j23.get("running") is True,
      f"phase 23 (b): the joiner's /debug/light {light_j23}")
node23["b"] = {"restore": {k: v for k, v in rest_j23.items()
                           if k != "banned"},
               "launches": c_j23, "wall_s": wall_j23,
               "restore_s": rest_j23.get("time_to_synced_s"),
               "tail_s": wall_j23 - (rest_j23.get("time_to_synced_s") or 0),
               "debug_device": sorted(dev_j23),
               "debug_light": sorted(light_j23)}
log(phase=23, card=CARD, at_s=time.perf_counter() - T23,
    step="b joiner", **node23["b"])

# (b3) a LightProxy in front of the serving node: its light client over
# the serving node's RPC, the set prewarmed (C1), headers and commits
# verified (C2) and equal to the node's own RPC answers
_, c_pw23, _ = step23("b prewarm", lambda: E.prewarm(
    pubs23, device=DEV))
# heights no step before verified (the joiner's light client verified the
# anchor and the snapshot's heights, its blocksync the tail): the proxy's
# own certificates launch
ask23 = (2, SNAP23 - 1, 2 * SNAP23 - 1)


def proxy_b23():
    """The proxy's light client made (its anchor checked) and the proxy
    asked for each height's header and commit."""
    global proxy23
    pcl = light.Client(CHAIN23, light.TrustOptions(1, anchor23, 7 * 86400.0),
                       lprov.HTTPProvider(CHAIN23, srpc23), [],
                       light.LightStore(MemDB()), device=DEV)
    proxy23 = LightProxy(pcl, srpc23, "127.0.0.1:0")
    proxy23.start()
    out = []
    for h in ask23:
        ph = rpc23(proxy23.laddr, "header", height=h)
        pc = rpc23(proxy23.laddr, "commit", height=h)
        nb = rpc23(srpc23, "block", height=h)
        sh = tlight.SignedHeader.from_proto(
            base64.b64decode(pc["signed_header"]))
        out.append({"height": h,
                    "header": ph["hash"] == nb["block_id"]["hash"]
                    and ph["app_hash"] == nb["block"]["header"]["app_hash"],
                    "commit": sh.header.hash().hex().upper()
                    == nb["block_id"]["hash"]
                    and sh.commit.block_id.hash.hex().upper()
                    == nb["block_id"]["hash"] and pc["verified"]})
    return out


pres23, c_px23, wall_px23 = step23("b proxy", proxy_b23)
proxy23.stop()
check(all(r["header"] and r["commit"] for r in pres23)
      and c_pw23.get("comb_build", 0) > 0
      and c_px23.get("comb_verify", 0) > 0,
      f"phase 23 (b): the proxy's answers {pres23}, launches {c_pw23}, "
      f"{c_px23}")
node23["b"].update(proxy=pres23, proxy_launches=c_px23,
                   prewarm_launches=c_pw23, proxy_s=wall_px23)
log(phase=23, card=CARD, at_s=time.perf_counter() - T23,
    step="b proxy", answers=pres23, launches=c_px23, wall_s=wall_px23)

# (c1) K1 raising under a joiner's _statesync_routine, its ledger holding
# three quarters of the snapshot's chunks (a restore a crash cut short)
E.table_cache_clear()
snap_c23 = snap_b23
PREFIX23 = snap_c23.chunks * 3 // 4
app_f23 = Counted23()
pre23 = NodeConfig(home=os.path.join(root23, "fault"))
pre23.ensure_dirs()
ledger23 = RestoreLedger(SQLiteDB(os.path.join(pre23.data_dir(),
                                               "statesync.db")))
ledger23.begin(snap_c23)
for i in range(PREFIX23):
    ledger23.put_chunk(i, app_s23.load_snapshot_chunk(
        snap_c23.height, snap_c23.format, i))
ledger23.flush()
ledger23.close()
(cfg_f23, fault23), c_fn23, _ = step23(
    "c fault node", lambda: joiner23("fault", app_f23))
rt23 = degrade.runtime()
fails0_23 = counter_total(rt23.metrics.device_failures)
falls0_23 = counter_total(rt23.metrics.host_fallbacks)
banned0_23 = ssync.metrics().peers_banned.value()
cbatch.verified_sigs = cbatch.SigCache(capacity=1 << 18)
label23[0] = "c fault"
keeping23 = ck.verify_packed
ck.verify_packed = launch_failed
t = time.perf_counter()
try:
    fault23.start()
    wait23(lambda: fault23.device_error is not None,
           "(c) the joiner's card fault", 120)
finally:
    ck.verify_packed = keeping23
join_abandoned()
time.sleep(0.5)                   # the routine has returned: nothing more
row_c23 = {
    "wall_s": time.perf_counter() - t,
    "error": type(fault23.device_error).__name__,
    "failures": counter_total(rt23.metrics.device_failures) - fails0_23,
    "fallbacks": counter_total(rt23.metrics.host_fallbacks) - falls0_23,
    "offers": app_f23.offers,
    "rejected": len(fault23.statesync_reactor.syncer._rejected),
    "banned": ssync.metrics().peers_banned.value() - banned0_23,
    "blocksync_active": fault23.blocksync_reactor._active,
    "consensus": fault23._consensus_started.is_set(),
    "bootstrapped": fault23.state_store.load().last_block_height}
fault23.stop()
# the serving node drops the old connection before the fresh node (the
# same home, so the same node id) dials in
wait23(lambda: fault23.node_key.node_id not in serve23.switch.peers,
       "(c) the serving node dropping the faulted joiner", 30)
ledger23 = RestoreLedger(SQLiteDB(os.path.join(cfg_f23.data_dir(),
                                               "statesync.db")))
row_c23["ledger"] = len(ledger23.begin(snap_c23))
ledger23.close()
check(isinstance(fault23.device_error, degrade.DeviceLaneError)
      and degrade.card_fault(fault23.device_error)
      and row_c23["offers"] == 0 and row_c23["rejected"] == 0
      and row_c23["banned"] == 0 and not row_c23["blocksync_active"]
      and not row_c23["consensus"] and row_c23["bootstrapped"] == 0
      and row_c23["ledger"] == PREFIX23 and row_c23["failures"] >= 1
      and row_c23["fallbacks"] == 0,
      f"phase 23 (c): the state-sync routine's card fault {row_c23} "
      f"({fault23.device_error!r})")
degrade.configure(degrade.DegradeConfig.from_env(),
                  registry=Registry("p23 c"))
# the card back: a fresh Node over the same home resumes from the ledger
app_r23 = Counted23()


def resume_c23():
    global res23n
    res23n = Node(cfg_f23, app_r23, device=DEV)
    res23n.start()
    wait23(lambda: synced23(res23n, app_r23) or res23n.device_error,
           "(c) the resume", 240)


_, c_r23, wall_r23 = step23("c resume", resume_c23)
rest_r23 = dict(res23n.statesync_reactor.syncer.last_restore or {})
check(synced23(res23n, app_r23) and rest_r23.get("resumed") == PREFIX23
      and c_r23.get("verify_packed", 0) > 0,
      f"phase 23 (c): the resume {rest_r23}, launches {c_r23}")
row_c23.update(resume_s=wall_r23, resumed=rest_r23.get("resumed"),
               resume_launches=c_r23)
res23n.stop()
join23.stop()

# (c2) the control.decide=raise drill on a node with [control] enable:
# every governed knob moved off its static value reverts to it
cfg_k23, hk23_ = home23("control", control={"enable": True,
                                            "period_ms": 20.0})
cfg_k23.home = hk23_
ctl_node23 = Node(cfg_k23, KVStoreApplication(), device=DEV)
# its LightServe prewarms the genesis set at start (C1)
_, c_k23, _ = step23("c drill node", ctl_node23.start)
ctl23 = control.installed()
check(ctl23 is not None and ctl23.knobs(),
      "phase 23 (c): the node installed no controller")
try:
    failpoints.set_mode("control.decide", "raise")
    wait23(lambda: failpoints.fired("control.decide", "raise") >= 1,
           "(c) the control.decide drill's first period", 10)
    for name, k in list(ctl23._knobs.items()):
        lo, hi = k.safe_range
        k.setter(hi if k.static != hi else lo)
    fired0_23 = failpoints.fired("control.decide", "raise")
    wait23(lambda: failpoints.fired("control.decide", "raise")
           >= fired0_23 + 2, "(c) the drill's periods", 10)
    rep23 = ctl23.report()
finally:
    failpoints.clear("control.decide")
reverted23 = {n: v["value"] == v["static"] for n, v in rep23["knobs"].items()}
check(all(reverted23.values()) and rep23["skipped_periods"] >= 2
      and any(d["reason"] == "chaos" for d in rep23["decisions"])
      and not failpoints.armed(),
      f"phase 23 (c): the control.decide drill {reverted23}, "
      f"{rep23['skipped_periods']} skipped")
ctl_node23.stop()
check(control.installed() is None, "phase 23 (c): the controller stayed")
row_c23.update(drill_knobs=sorted(reverted23),
               drill_skipped=rep23["skipped_periods"])
node23["c"] = row_c23
log(phase=23, card=CARD, at_s=time.perf_counter() - T23,
    step="c card fault and drill", **row_c23)
serve23.stop()

# -- every launch of (b) and (c) against its plain version on the same
# inputs (grouped by step), C2 against the plain tables of its build
label23[0] = ""
for _name in keep23:
    setattr(KERNEL_MOD[_name], _name, was23[_name])
cmp23 = {name: [] for name in keep23}
t = time.perf_counter()
for name, plain in (("verify_packed", ck.verify_packed_plain),
                    ("verify_packed_split", ck.verify_packed_split_plain)):
    runs = keep23[name]
    if not runs:
        continue
    got = torch.cat([out for _, _, out in runs])
    cols = [torch.cat([args[k] for _, args, _ in runs], dim=1)
            for k in range(len(runs[0][1]))]
    step_of = np.repeat([label or "-" for label, _, _ in runs],
                        [out.shape[0] for _, _, out in runs])
    real = (cols[-1] != 0).any(dim=0)
    check(not got[~real].any(), f"phase 23 {name}: a padding lane passed")
    got = got[real].cpu().numpy()
    step_of = step_of[real.cpu().numpy()]
    uniq, inv = torch.unique(torch.cat([c[:, real] for c in cols]), dim=1,
                             return_inverse=True)
    sizes = [c.shape[0] for c in cols]
    ucols = list(torch.split(uniq, sizes))
    want_u = torch.cat([plain(*[c[:, a:a + 65_536] for c in ucols]).cpu()
                        for a in range(0, uniq.shape[1], 65_536)])
    want = want_u[inv.cpu()].numpy()
    err = np.abs(got.astype(int) - want.astype(int))
    for g in sorted(set(step_of)):
        on = step_of == g
        n_runs = sum((label or "-") == g for label, _, _ in runs)
        cmp23[name].append((f"phase 23 ({g}): {n_runs} launches, "
                            f"{uniq.shape[1]} distinct lanes",
                            int(on.sum()), int(err[on].sum()),
                            float(err[on].max())))
builds23 = {}
for label, args, (tab, ok) in keep23["comb_build"]:
    ptab, pok = cc.comb_build_plain(args[0])
    builds23[id(tab)] = (ptab, pok)
    cmp23["comb_build"].append(
        (f"phase 23 {label}", args[0].shape[0],
         cc.tables_mismatch(tab, ptab) + int((ok != pok).sum())))
check(all(id(args[1]) in builds23 for _, args, _ in keep23["comb_verify"]),
      "phase 23: a C2 launch on a table that no build of the phase made")
for key, (ptab, pok) in builds23.items():
    runs = [(args, out) for _, args, out in keep23["comb_verify"]
            if id(args[1]) == key]
    if not runs:
        continue
    rows_c2 = torch.cat([args[0] for args, _ in runs])
    got = torch.cat([out for _, out in runs]).cpu().numpy()
    urows, uinv = torch.unique(rows_c2, dim=0, return_inverse=True)
    want = cc.comb_verify_plain(urows, ptab, pok).cpu()[uinv.cpu()]
    cmp23["comb_verify"].append(c2_row(
        f"phase 23: {len(runs)} launches on one table, {urows.shape[0]} "
        f"distinct rows", got, want.numpy()))
plain23_s = time.perf_counter() - t
# the card's time for each step's launches, replayed back to back between
# two CUDA events on a quiet card, against the step's host wall
card23 = {}
if ON_CARD23:
    for name in ("verify_packed", "comb_verify"):
        for step in sorted({lab for lab, _, _ in keep23[name]}):
            if step not in walls23:
                continue
            runs = [args for lab, args, _ in keep23[name] if lab == step]
            REAL[name](*runs[0])
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            for a in runs:
                REAL[name](*a)
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
            card23[f"{step} {name}"] = {
                "launches": len(runs), "ms": ms, "wall_s": walls23[step],
                "card_share": ms / 1e3 / walls23[step]}
log(phase=23, card=CARD, at_s=time.perf_counter() - T23, step="card time",
    replayed=card23)
E.table_cache_clear()
staging_clear(23)
shutil.rmtree(root23)
tmlog.setup("info")
gc.callbacks.remove(_gc17)
gc.unfreeze()
launches23 = {name: len(v) for name, v in keep23.items()}
node23.update(gc={"collections": gc17["n"], "seconds": gc17["s"]},
              card_time=card23, comparisons=cmp23, walls=walls23,
              launches=launches23, plain_s=plain23_s,
              phase_s=time.perf_counter() - T23)
log(phase=23, card=CARD, at_s=time.perf_counter() - T23,
    launches=launches23, comparisons=cmp23, plain_s=plain23_s,
    phase_s=node23["phase_s"])
check(launches23["verify_packed"] > 0 and launches23["comb_verify"] > 0
      and launches23["comb_build"] > 0
      and all(r[2] == 0 for rows in cmp23.values() for r in rows),
      f"phase 23: a kernel disagrees with its plain version: {cmp23}")
REPORT["node"] = node23

# -- phase 25 (b)'s processes, started here and read back in phase 25 --------
# The two ranks of the global plane (`--gmesh-child`, above) run beside
# phase 24 on the one card; their inputs are made here: a 4,096-validator
# commit with one bad signature (BASELINE's commit shape) and a
# 150-validator kvstore chain (BASELINE config 4's width) of H25 heights of
# 50 txs from one seed, pickled with its genesis.  The chain's depth is cut
# to one replay window (PERF.md §4).
T25S = time.perf_counter()
root25 = tempfile.mkdtemp(prefix="smoke25_")
H25 = 16
rng = random.Random(SEED + 25)
vset25, commit25, bid25, msgs25r = make_commit(4096, rng)
pubs25 = [v.pub_key.bytes() for v in vset25.validators]
msgs25 = [msgs25r[i] for i in range(len(pubs25))]
sigs25 = [cs.signature for cs in commit25.signatures]
BAD25 = 1234
sigs25[BAD25] = corrupt(sigs25[BAD25], rng)
expect25 = np.ones(len(pubs25), dtype=bool)
expect25[BAD25] = False
gdoc25, store25, states25, _ = build18(150, H25, 50)
blocks25, certs25 = served18(store25, H25)
with open(os.path.join(root25, "gmesh_in.pkl"), "wb") as _f:
    import pickle
    pickle.dump({"pubs": pubs25, "msgs": msgs25, "sigs": sigs25,
                 "gdoc": gdoc25, "blocks": blocks25, "certs": certs25}, _f)
procs25: dict = {}


def free_port25() -> int:
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def start25() -> None:
    """Both ranks on a fresh port, each in a process group of its own."""
    port = free_port25()
    for rank in (0, 1):
        log_path = os.path.join(root25, f"rank{rank}.out")
        with open(log_path, "w") as f:
            p = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--gmesh-child",
                 root25, str(rank), str(port)], cwd=HERE24, stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True)
        procs25[rank] = (p, log_path, time.perf_counter())


def stop_procs25():
    for p, _, _ in procs25.values():
        try:
            os.killpg(p.pid, 9)
        except OSError:
            pass
        try:
            p.wait(30)
        except subprocess.TimeoutExpired:
            pass


atexit.register(stop_procs25)
check(not failpoints.armed(), "phase 25: a failpoint is armed")
start25()
log(phase=25, card=CARD, step="b processes started", heights=H25,
    prepare_s=time.perf_counter() - T25S)

# -- phase 24: the in-process network harness and the e2e runner ------------
# The harness (networks/: vnet, NetHarness, scenarios, invariants) and the
# e2e runner (e2e/) on the card, through the entry points a user calls.
# (a) the catalog's partition_heal_16 ran in its own process beside phases
# 17-23 (`--network-child`): its report and its kept K1 launches are read
# here, the launches held against the plain version and replayed on the
# quiet card for its share.  Not 150 validators: 150 Nodes with Switches
# and the vnet in one process would be slower than phase 21's 150 bare
# state machines (12-61 s a height); 16 is the widest scenario the catalog
# has.  Then, in this process, a 4-validator persist=True harness (SQLite
# stores and WALs): a storm of 9 prevotes for a fabricated block at rounds
# far ahead (the other three validators' raw keys, as phase 21 (c) feeds
# its storm) is queued at node 1's consensus in one go, so its receive
# routine pre-verifies them as one batch; K1's wrapper raises on the launch
# that carries the storm, once, with no failpoint armed: every node whose
# votes shared that window stops with DeviceLaneError on device_error, none
# of the batch is applied, no violation is recorded and the liveness gate
# fails by the fault's name; a fresh harness node over each faulted home
# resumes on the card; the vnet.deliver and harness.step drills behave as
# the JAX package's.  (b) the e2e runner's end: its stages and stats, each
# node process on the card with 0 launch failures and fallbacks and the
# breaker closed (read from outside while it ran), the full node's app
# hash the chain's; at the default tpu_threshold of 32 its 4-signature
# commits, light anchors and evidence launch nothing.  Walls are
# host-clock, logged and not gated.
T24 = time.perf_counter()
E.table_cache_clear()
check(not msm.use_rlc(10_000) and not failpoints.armed()
      and vsched.installed() is None and bpipe.installed() is None
      and control.installed() is None,
      "phase 24: RLC, a failpoint, a scheduler, a pipeline or a controller "
      "is still on")
degrade.configure(degrade.DegradeConfig.from_env(), registry=Registry("p24"))
ON_CARD24 = DEV.type == "cuda"
net24: dict = {"card": CARD}
walls24: dict = {}
tmlog.setup("info", module_levels="statesync:error,blocksync:error,"
            "p2p:error,mempool:error,light:error,rpc:error,pex:error,"
            "consensus:error,node:error,state:error,control:error,"
            "evidence:error")


def wait24(cond, what, timeout):
    end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < end, f"phase 24: {what} timed out")
        time.sleep(0.05)


def node_tails24() -> str:
    """The last lines of each e2e node's log, for a failure's message."""
    tails = []
    for node in sorted(os.listdir(e2e_dir24)) \
            if os.path.isdir(e2e_dir24) else []:
        path = os.path.join(e2e_dir24, node, "node.log")
        if os.path.exists(path):
            with open(path) as f:
                tails.append(f"-- {node}:\n" + "".join(
                    ln[:240] for ln in f.readlines()[-6:]))
    return "\n".join(tails)


def collect24(name, timeout):
    """A process of the phase, ended (within `timeout` of now) with exit
    0: its output, and its wall from start to exit."""
    p, log_path, t0 = procs24[name]
    try:
        rc = p.wait(timeout)
    except subprocess.TimeoutExpired:
        rc = None
    with open(log_path) as f:
        out = f.read()
    check(rc == 0, f"phase 24 ({name}): the process exited {rc}:\n"
          f"{out[-4000:]}" + (f"\nthe nodes' logs:\n{node_tails24()}"
                              if name == "e2e" and rc != 0 else ""))
    wait24(lambda: name in ends24, f"({name})'s exit time", 10)
    return out, ends24[name] - t0


# -- (a) the network process's report and launches
out_a24, walls24["a process"] = collect24("network", 600)
with open(os.path.join(root24, "network_a.json")) as _f:
    a24 = json.load(_f)
kept_a24 = torch.load(os.path.join(root24, "network_a.pt"))
check(a24["violations"] == 0 and a24["block_hashes_equal"]
      and a24["heights"] >= 6 and a24["partition_drops"] > 0
      and a24["launches"].get("verify_packed", 0) == len(kept_a24) > 0,
      f"phase 24 (a): {a24}")
# the process's main-path launches (zeroed at its boot, read at its stop)
for _k, _v in a24["launches"].items():
    launches_main[_k] += _v
net24["a"] = a24
walls24["a scenario"] = a24["walls_s"]["a scenario"]
log(phase=24, card=CARD, at_s=time.perf_counter() - T24,
    step="a partition_heal_16", process_s=walls24["a process"], **a24)

# every K1, K2, C1 and C2 launch of this process's steps, kept with the
# step's label
keep24 = {name: [] for name in ("verify_packed", "verify_packed_split",
                                "comb_build", "comb_verify")}
keep24["verify_packed"] = [(lab, [p.to(DEV)], o.to(DEV))
                           for lab, p, o in kept_a24]
label24 = [""]
was24 = {name: getattr(KERNEL_MOD[name], name) for name in keep24}
_keep24_lock = threading.Lock()


def _keeping24(name):
    """The bare wrapper (REAL), keeping a copy of every launch's tensor
    inputs (C2's tables by reference) and its output."""
    def wrapper(*args):
        out = REAL[name](*args)
        kept = [a.clone() if isinstance(a, torch.Tensor)
                and not (name == "comb_verify" and i == 1) else a
                for i, a in enumerate(args)]
        with _keep24_lock:
            keep24[name].append((label24[0], kept, out))
        return out
    return wrapper


for _name in keep24:
    setattr(KERNEL_MOD[_name], _name, _keeping24(_name))


def step24(label, fn):
    """fn() on the main path under the step's label; the runtime must have
    served it from the card.  Returns (the result, the launch counts)."""
    label24[0] = label
    t = time.perf_counter()
    out, c = main_path(fn)
    walls24[label] = time.perf_counter() - t
    label24[0] = ""
    runtime_clean(f"phase 24 {label}")
    return out, {k: v for k, v in c.items() if v}


hf24 = NetHarness(validators=4, seed=SEED + 1, persist=True,
                  workdir=os.path.join(root24, "fault"), device=DEV)
hf24.nodes[0].cfg_mutator = thr1_24
try:
    keep_k1_24 = ck.verify_packed
    fault24 = [0]
    storm_sig24 = [None]

    def fault_storm24(packed):
        """K1's wrapper, raising (once) on the launch whose lanes carry
        the storm's first signature (rows 32-95: R | s)."""
        sig = storm_sig24[0]
        if fault24[0] == 0 and sig is not None:
            rs = packed[32:96]
            if rs.dtype != torch.uint8:
                rs = rs.view(torch.uint8)
            if bool((rs == sig.to(rs.device)[:, None]).all(dim=0).any()):
                fault24[0] = 1
                return launch_failed(packed)
        return keep_k1_24(packed)

    def storm24(hn):
        """Prevotes at hn's height for a fabricated block, at rounds 100
        ahead of it, from every other validator (their raw keys)."""
        rs = hn.node.consensus.get_round_state()
        bid = BlockID(hashlib.sha256(b"phase 24 storm").digest(),
                      PartSetHeader(1, hashlib.sha256(b"parts24").digest()))
        votes = []
        for rnd in range(rs.round + 100, rs.round + 103):
            for other in hf24.nodes:
                if other is hn:
                    continue
                addr = other.pv.get_pub_key().address()
                idx, _ = rs.validators.get_by_address(addr)
                v = tvote.Vote(type=SignedMsgType.PREVOTE, height=rs.height,
                               round=rnd, block_id=bid,
                               timestamp=Timestamp.now(),
                               validator_address=addr, validator_index=idx)
                v.signature = other.pv.priv_key.sign(
                    v.sign_bytes(hf24.chain_id))
                votes.append(v)
        return votes

    def boot_f24():
        hf24.start()
        s = vsched.installed()
        check(s is not None and s.is_running() and s.tpu_threshold == 1
              and s is hf24.nodes[0].node._verify_sched,
              f"phase 24 (a): the fault harness's scheduler {s!r}")
        hf24.wait_height(2, timeout=120)

    _, c_fb24 = step24("fault boot", boot_f24)
    target24 = hf24.nodes[1]
    votes24 = storm24(target24)
    storm_sig24[0] = torch.tensor(list(votes24[0].signature),
                                  dtype=torch.uint8)
    fails0_24 = counter_total(degrade.runtime().metrics.device_failures)
    label24[0] = "fault storm"
    t = time.perf_counter()
    ck.verify_packed = fault_storm24
    old_switch24 = sys.getswitchinterval()
    try:
        # one batch: no other thread runs while the storm is queued
        sys.setswitchinterval(1.0)
        try:
            for v in votes24:
                target24.node.consensus.add_vote(
                    v, peer_id=f"storm{v.validator_index}")
        finally:
            sys.setswitchinterval(old_switch24)
        wait24(lambda: hf24.device_errors(), "a card fault ending a node's "
               f"consensus (the storm's launch {fault24[0]})", 60)
        time.sleep(1.0)    # every future of the failed window settled
    finally:
        ck.verify_packed = keep_k1_24
        label24[0] = ""
    walls24["fault storm"] = time.perf_counter() - t
    faults24 = hf24.device_errors()
    faulted24 = [hn.idx for hn in hf24.nodes if hn.name in faults24]
    hf24.check_invariants()
    try:
        hf24.wait_height(1, timeout=30)
        gate24 = None
    except ScenarioFailure as e:
        gate24 = e
    f24 = {"faulted": sorted(faults24),
           "errors": sorted({type(e).__name__ for e in faults24.values()}),
           "at_heights": [hf24.nodes[i].height() for i in faulted24],
           "storm_votes": len(votes24),
           "consensus_running": [hf24.nodes[i].node.consensus.is_running()
                                 for i in faulted24],
           "device_failures": counter_total(
               degrade.runtime().metrics.device_failures) - fails0_24,
           "violations": [v.as_dict() for v in hf24.watcher.violations],
           "gate": str(gate24).splitlines()[0] if gate24 else None,
           "gate_names": sorted(gate24.device_errors) if gate24 else None,
           "storm_to_fault_s": walls24["fault storm"],
           "boot_launches": c_fb24}
    check(fault24[0] == 1 and target24.name in faults24
          and all(isinstance(e, degrade.DeviceLaneError)
                  for e in faults24.values())
          and not any(f24["consensus_running"])
          and f24["device_failures"] >= 1 and f24["violations"] == []
          and f24["gate_names"] == f24["faulted"]
          and "DeviceLaneError" in (f24["gate"] or ""),
          f"phase 24 (a): the card fault {f24}")
    # the card back (a fresh runtime: the fault is counted in the old
    # one's breaker); a fresh harness node over each faulted home, which
    # must catch up with the network and commit past where it stood
    degrade.configure(degrade.DegradeConfig.from_env(),
                      registry=Registry("p24 resume"))

    def resume_f24():
        target = max(hn.height() for hn in hf24.nodes) + 1
        for i in faulted24:
            hf24.restart(i)
        wait24(lambda: all(hf24.nodes[i].height() >= target
                           for i in faulted24)
               and not hf24.device_errors(),
               f"the restarted nodes at height {target}", 240)

    _, c_res24 = step24("fault resume", resume_f24)
    check(all(hf24.nodes[i].running
              and hf24.nodes[i].node.device_error is None
              for i in faulted24) and hf24.watcher.violations == [],
          f"phase 24 (a): the resume {hf24.heights()}")
    f24.update(resume_s=walls24["fault resume"], resume_launches=c_res24,
               heights=hf24.heights())
    # the vnet.deliver drill: frames dropped as chaos loss, no violation
    chaos0_24 = hf24.net.dropped.get("chaos", 0)
    failpoints.set_mode("vnet.deliver", "raise")
    try:
        time.sleep(1.0)
        fired24 = failpoints.fired("vnet.deliver", "raise")
    finally:
        failpoints.clear("vnet.deliver")
    drops24 = hf24.net.dropped.get("chaos", 0) - chaos0_24
    hf24.check_invariants()
    # the harness.step drill: the scenario fails with its artifact
    failpoints.set_mode("harness.step", "raise")
    try:
        try:
            hf24.run_scenario({"name": "chaos_step", "validators": 4,
                               "steps": [{"op": "sleep", "s": 0.1}]})
            step_fail24 = None
        except ScenarioFailure as e:
            step_fail24 = e
    finally:
        failpoints.clear("harness.step")
    check(step_fail24 is not None
          and os.path.exists(step_fail24.artifact.get("timeline", "")),
          f"phase 24 (a): the harness.step drill {step_fail24}")
    with open(step_fail24.artifact["timeline"]) as _f:
        art24 = json.load(_f)
    f24.update(deliver_drill={"fired": fired24, "chaos_drops": drops24},
               step_drill={"seed": art24["seed"], "error": art24["error"],
                           "decisions": len(art24["vnet_decisions"])})
    check(fired24 >= 1 and drops24 >= 1 and hf24.watcher.violations == []
          and art24["seed"] == SEED + 1 and "InjectedFault" in art24["error"]
          and not failpoints.armed(),
          f"phase 24 (a): the drills {f24}")
    t = time.perf_counter()
    hf24.stop()
    walls24["fault stop"] = time.perf_counter() - t
    net24["a_fault"] = f24
    log(phase=24, card=CARD, at_s=time.perf_counter() - T24,
        step="a card fault and drills", **f24)
finally:
    if any(hn.running for hn in hf24.nodes):
        hf24.stop()

# -- (b) the e2e runner's end
out_b24, walls24["b process"] = collect24("e2e", 600)
collect24("watch", 60)
with open(os.path.join(root24, "e2e_watch.json")) as _f:
    watch24 = SimpleNamespace(**json.load(_f))
lines_b24 = out_b24.strip().splitlines()
check(lines_b24 and lines_b24[-1].startswith("{"),
      f"phase 24 (b): `cmd e2e` printed no stats:\n{out_b24[-4000:]}")
stats_b24 = json.loads(lines_b24[-1])
stages_b24 = [ln for ln in lines_b24 if ln.startswith("e2e ")]
want_b24 = ("e2e setup:", "e2e start: all initial nodes",
            f"e2e evidence: all {man24.evidence} items committed",
            "e2e perturb: done",
            f"e2e wait: all nodes at height >= {man24.wait_height}",
            "e2e test: invariants hold", "e2e benchmark:",
            "e2e stop: all nodes down")
rows_b24 = watch24.rows
check(stats_b24.get("ok") is True and stats_b24["blocks"] >= 2
      and stats_b24["txs_sent"] >= 1
      and stats_b24["interval_avg_s"] <= man24.block_interval_budget_s
      and all(any(ln.startswith(w) for ln in stages_b24) for w in want_b24),
      f"phase 24 (b): the runner's stats {stats_b24}, stages {stages_b24}")
check(all(watch24.devices[n] == [DEV.type] for n in watch24.devices)
      and all(r["scrapes"] > 0 and r["failures"] == 0 and r["fallbacks"] == 0
              and r["breaker"] == 0 for r in rows_b24.values())
      and watch24.app_pairs and all(ok for _, ok in watch24.app_pairs),
      f"phase 24 (b): the processes {watch24.devices}, {rows_b24}, the full "
      f"node's app {watch24.app_pairs[-5:]}")
net24["b"] = {"manifest": "networks/ci.toml", "stats": stats_b24,
              "stages": stages_b24,
              "devices": watch24.devices,
              "processes": rows_b24,
              "launches": sum(r.get("launches", 0) for r in rows_b24.values()),
              "full_node_app_checks": len(watch24.app_pairs),
              "full_node_app_heights": sorted(
                  {hh for hh, _ in watch24.app_pairs}),
              "process_s": walls24["b process"]}
log(phase=24, card=CARD, at_s=time.perf_counter() - T24,
    step="b e2e runner", **net24["b"])
stop_procs24()

# -- every launch of (a) against its plain version on the same inputs
# (grouped by step)
label24[0] = ""
for _name in keep24:
    setattr(KERNEL_MOD[_name], _name, was24[_name])
cmp24 = {name: [] for name in keep24}
t = time.perf_counter()
for name, plain in (("verify_packed", ck.verify_packed_plain),
                    ("verify_packed_split", ck.verify_packed_split_plain)):
    runs = keep24[name]
    if not runs:
        continue
    got = torch.cat([out for _, _, out in runs])
    cols = [torch.cat([args[k] for _, args, _ in runs], dim=1)
            for k in range(len(runs[0][1]))]
    step_of = np.repeat([label or "-" for label, _, _ in runs],
                        [out.shape[0] for _, _, out in runs])
    real = (cols[-1] != 0).any(dim=0)
    check(not got[~real].any(), f"phase 24 {name}: a padding lane passed")
    got = got[real].cpu().numpy()
    step_of = step_of[real.cpu().numpy()]
    uniq, inv = torch.unique(torch.cat([c[:, real] for c in cols]), dim=1,
                             return_inverse=True)
    sizes = [c.shape[0] for c in cols]
    ucols = list(torch.split(uniq, sizes))
    want_u = torch.cat([plain(*[c[:, a:a + 65_536] for c in ucols]).cpu()
                        for a in range(0, uniq.shape[1], 65_536)])
    want = want_u[inv.cpu()].numpy()
    err = np.abs(got.astype(int) - want.astype(int))
    for g in sorted(set(step_of)):
        on = step_of == g
        n_runs = sum((label or "-") == g for label, _, _ in runs)
        cmp24[name].append((f"phase 24 ({g}): {n_runs} launches, "
                            f"{uniq.shape[1]} distinct lanes",
                            int(on.sum()), int(err[on].sum()),
                            float(err[on].max())))
# C1 and C2 launch here only if a node's LightServe prewarms a set (16
# keys are under the comb's 32): any that did, against their plain versions
builds24 = {}
for label, args, (tab, ok) in keep24["comb_build"]:
    ptab, pok = cc.comb_build_plain(args[0])
    builds24[id(tab)] = (ptab, pok)
    cmp24["comb_build"].append(
        (f"phase 24 {label}", args[0].shape[0],
         cc.tables_mismatch(tab, ptab) + int((ok != pok).sum())))
check(all(id(args[1]) in builds24 for _, args, _ in keep24["comb_verify"]),
      "phase 24: a C2 launch on a table that no build of the phase made")
for key, (ptab, pok) in builds24.items():
    runs = [(args, out) for _, args, out in keep24["comb_verify"]
            if id(args[1]) == key]
    if not runs:
        continue
    rows_c2 = torch.cat([args[0] for args, _ in runs])
    got = torch.cat([out for _, out in runs]).cpu().numpy()
    urows, uinv = torch.unique(rows_c2, dim=0, return_inverse=True)
    want = cc.comb_verify_plain(urows, ptab, pok).cpu()[uinv.cpu()]
    cmp24["comb_verify"].append(c2_row(
        f"phase 24: {len(runs)} launches on one table, {urows.shape[0]} "
        f"distinct rows", got, want.numpy()))
plain24_s = time.perf_counter() - t
# the card's time for (a)'s scenario: its kept K1 launches replayed back to
# back between two CUDA events on a quiet card, against the stretch's wall
card24 = {}
if ON_CARD24:
    for step in sorted({lab for lab, _, _ in keep24["verify_packed"]}):
        if step not in walls24:
            continue
        runs = [args for lab, args, _ in keep24["verify_packed"]
                if lab == step]
        REAL["verify_packed"](*runs[0])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for a in runs:
            REAL["verify_packed"](*a)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        card24[step] = {"launches": len(runs),
                        "lanes": sum(int(a[0].shape[1]) for a in runs),
                        "ms": ms, "wall_s": walls24[step],
                        "card_share": ms / 1e3 / walls24[step]}
log(phase=24, card=CARD, at_s=time.perf_counter() - T24, step="card time",
    replayed=card24)
E.table_cache_clear()
staging_clear(24)
shutil.rmtree(root24)
tmlog.setup("info")
launches24 = {name: len(v) for name, v in keep24.items()}
net24.update(card_time=card24, comparisons=cmp24, walls=walls24,
             launches=launches24, plain_s=plain24_s,
             phase_s=time.perf_counter() - T24)
log(phase=24, card=CARD, at_s=time.perf_counter() - T24,
    launches=launches24, comparisons=cmp24, plain_s=plain24_s,
    phase_s=net24["phase_s"])
check(launches24["verify_packed"] > 0
      and all(r[2] == 0 for rows in cmp24.values() for r in rows),
      f"phase 24: a kernel disagrees with its plain version: {cmp24}")
REPORT["network"] = net24

# -- phase 25: the multi-GPU data planes ---------------------------------------
# parallel/sharding.py on the one card.  (a) data_plane() is None on this
# one-card host (and under TM_TPU_NO_MESH=1), so a plane of 4 positions on
# cuda:0 is built explicitly (make_mesh([cuda:0] * 4)), as the JAX CPU tests
# build theirs on virtual devices, and driven through its entry points:
# K1 on each position's lanes of phase 6's 100,000 ad-hoc triples
# (plane.verify_batch, then BatchVerifier with the plane installed as the
# process's data plane), K3 on phase 5's 100,000-validator bulk with 0.1%
# corrupted lanes (make_sharded_verifier's run and the compact route,
# all-valid bit false), rlc-sharded on phase 8's 100,000-validator commit
# (K4, the sort, K5 and A1 a position; vouched, then one bad signature
# rejected and named by the plane's K1), and phase 15's 1,024-key set at
# three budgets (mesh-comb: a table copy a position; mesh-comb-sharded: a
# quarter of the keys a position; the single-device comb), each bitmap the
# single-device route's; chaos at sharding.mesh_stage and
# sharding.mesh_comb; a position's K1 wrapper raising outside a drill
# (DeviceLaneError, no single-device redo, no plain version).  The first
# launch of each kernel (position 0) is held against its plain version.
# Walls beside the single-device walls of the same batch: on one card they
# measure the plane's overhead, not scaling.  (b) the two ranks started
# before phase 24 (`--gmesh-child`): both ranks' bitmaps the single-device
# one, each rank's K3 on its half, the lockstep replay on route
# global-mesh to the chain's app hash, the poison latch.
T25 = time.perf_counter()
from tendermint_tpu_torch.parallel import sharding as S  # noqa: E402

E.table_cache_clear()
check(not msm.use_rlc(10_000) and not failpoints.armed()
      and vsched.installed() is None,
      "phase 25: RLC, a failpoint or a scheduler is still on")
degrade.configure(degrade.DegradeConfig.from_env(), registry=Registry("p25"))
plane25: dict = {"card": CARD}
walls25: dict = {}
cmp25 = {"verify_packed": [], "verify_staged": [], "comb_verify": []}

with S._PLANE_LOCK:
    S._PLANE = S._PLANE_KEY = None
dp25 = {"cards": torch.cuda.device_count(), "data_plane": S.data_plane()}
os.environ["TM_TPU_NO_MESH"] = "1"
S._PLANE = None
dp25["no_mesh"] = S.data_plane()
del os.environ["TM_TPU_NO_MESH"]
S._PLANE = None
check(dp25 == {"cards": 1, "data_plane": None, "no_mesh": None},
      f"phase 25: data_plane() on this host: {dp25}")
plane25["data_plane"] = {k: str(v) for k, v in dp25.items()}

P25 = S._DataPlane(S.make_mesh([DEV] * 4))
pos25: dict = {}        # kernel -> launches a position
_bare_launch25 = S._DataPlane._launch


def _counting25(pos, dev, fn, *args):
    """A position's launch, its kernel launches counted by position."""
    before = {**ck.launches, **cm.launches, **cc.launches}
    out = _bare_launch25(pos, dev, fn, *args)
    for k, v in {**ck.launches, **cm.launches, **cc.launches}.items():
        if v > before[k]:
            pos25.setdefault(k, [0] * P25.nshard)[pos] += v - before[k]
    return out


P25._launch = _counting25


def install25(on: bool) -> None:
    """The 4-position plane as the process's data plane, or none."""
    with S._PLANE_LOCK:
        S._PLANE = P25 if on else None
        S._PLANE_KEY = S._topology_key()


KERN25 = ("verify_packed", "verify_staged", "decompress_niels",
          "bucket_scan", "aggregate", "comb_verify")
for _name in KERN25:
    setattr(KERNEL_MOD[_name], _name, _recording(_name))


def step25(label, fn, capture=(), site=None):
    """fn() on the main path; returns (the result, the launch counts, the
    launch record)."""
    t = time.perf_counter()
    out, c = main_path(fn, capture=capture, site=site)
    walls25[label] = time.perf_counter() - t
    return out, {k: v for k, v in c.items() if v}, dict(E.last_launch())


# -- K1: phase 6's 100,000 ad-hoc triples
p6, m6, s6 = trip6
bits, c, rec = step25("k1 plane", lambda: P25.verify_batch(p6, m6, s6),
                      capture=("verify_packed", "phase 25 K1, position 0"))
check(rec["path"] == "mesh-cuda" and rec["nb"] == 131_072
      and rec["shards"] == 4 and c == {"verify_packed": 4}
      and np.array_equal(bits, expect6) and np.array_equal(bits, bits6),
      f"phase 25 K1 plane: {c} {rec}")
cmp25["verify_packed"].append(plain_on_captured("verify_packed",
                                                expect6[:32_768]))
plane25["k1"] = {"launches": c, "record": rec}
install25(True)
cbatch.verified_sigs = cbatch.SigCache()
bv25 = cbatch.BatchVerifier(device=DEV)
for p_, m_, s_ in zip(p6, m6, s6):
    bv25.add(edkeys.PubKey(p_), m_, s_)
(ok_b, bits_b), c, rec = step25("k1 BatchVerifier", bv25.verify,
                                site="batch.ed25519")
check(rec["path"] == "mesh-cuda" and c == {"verify_packed": 4}
      and not ok_b and np.array_equal(bits_b, expect6),
      f"phase 25 K1 through BatchVerifier: {c} {rec}")
plane25["k1_batch_verifier"] = {"launches": c, "record": rec}
install25(False)

# -- K3: phase 5's corrupted 100,000-validator bulk
msgs5l = list(msgs100k)
staged25, host_ok25 = E.prepare_batch_compact(mat, sig_bad, msgs5l)
_, run25 = S.make_sharded_verifier(P25.mesh)
bits, c, rec = step25("k3 sharded verifier",
                      lambda: run25(staged25) & host_ok25,
                      capture=("verify_staged", "phase 25 K3, position 0"))
check(rec["path"] == "mesh-sharded" and rec["shards"] == 4
      and rec["nb"] == 100_000 and c == {"verify_staged": 4}
      and np.array_equal(bits, expect5),
      f"phase 25 K3 sharded verifier: {c} {rec}")
cmp25["verify_staged"].append(plain_on_captured("verify_staged",
                                                expect5[:25_000]))
check(cmp25["verify_staged"][-1][1] == 25_000,
      f"phase 25 K3: position 0's launch {cmp25['verify_staged'][-1]}")
bits, c, rec = step25("k3 compact route",
                      lambda: P25._verify_compact(staged25, host_ok25))
check(rec["path"] == "mesh-xla" and rec["nb"] == 131_072
      and rec["chunks"] == 2 and rec["all_valid"] is False
      and c == {"verify_staged": 8} and np.array_equal(bits, expect5),
      f"phase 25 K3 compact route: {c} {rec}")
plane25["k3"] = {"launches": c, "record": rec}

# -- RLC: phase 8's 100,000-validator commit, vouched, then one bad
msm.set_enabled(True)
RLC25 = [("decompress_niels", "phase 25 rlc-sharded, position 0"),
         ("bucket_scan", "phase 25 rlc-sharded, position 0"),
         ("aggregate", "phase 25 rlc-sharded, position 0")]
ok, c, rec = step25("rlc sharded", lambda: msm.verify_batch_rlc(
    vp100k, msgs100k, sig100k, plane=P25, device=DEV), capture=RLC25)
route = dict(msm.last_route())
check(ok is True and (route["path"], route["outcome"], route["nb"],
                      route["shards"], route["c"])
      == ("rlc-sharded", "vouched", 131_072, 4, 8)
      and c == {"decompress_niels": 4, "bucket_scan": 4, "aggregate": 4}
      and len(rec.get("shard_h2d_s", ())) == 4
      and route8a["outcome"] == "vouched",
      f"phase 25 rlc-sharded: {ok} {route} {c}")
plane25["rlc"] = {"launches": c, "route": route, "record": rec}
sig_s1 = list(sig100k)
sig_s1[bad8] = orig8[:32] + s8.to_bytes(32, "little")
install25(True)
bits, c, rec = step25("rlc sharded, one bad", lambda: E.verify_batch(
    vp100k, msgs100k, sig_s1, device=DEV))
route = dict(msm.last_route())
want8 = np.ones(100_000, dtype=bool)
want8[bad8] = False
check(route["path"] == "rlc-sharded" and route["outcome"] == "rejected"
      and route8b["outcome"] == "rejected" and rec["path"] == "mesh-cuda"
      and c == {"decompress_niels": 4, "bucket_scan": 4, "aggregate": 4,
                "verify_packed": 4} and np.array_equal(bits, want8),
      f"phase 25 rlc-sharded, one bad: {route} {rec} {c}")
plane25["rlc_bad"] = {"launches": c, "route": route}
install25(False)
label, (b_rows,), (n10, ok10) = captured["decompress_niels"][-1]
k4_cmp(label, b_rows, n10, ok10)
label, (table, rows, seg), out = captured["bucket_scan"][-1]
plain = cm.bucket_scan_plain(cm.limbs22_from_bytes(cm.to_bytes10(table)),
                             rows)
msm_cmp["bucket_scan"].append(
    (label,) + point_cmp(cm.to_bytes10(out), cm.to_bytes22(plain)))
label, (bk, W, c_), ws = captured["aggregate"][-1]
plain = cm.aggregate_plain(cm.limbs22_from_bytes(cm.to_bytes10(bk)), W, c_)
msm_cmp["aggregate"].append((label,) + point_cmp(ws, plain))
check(all(msm_cmp[k][-1][2] == 0 for k in msm_cmp),
      f"phase 25: K4, K5 or A1 differs from plain: "
      f"{[msm_cmp[k][-1] for k in msm_cmp]}")
msm.set_enabled(None)

# -- the comb: phase 15's 1,024-key set at three budgets
TB25 = E._TABLE_BYTES_PER_KEY
E.set_comb_config(table_cache_mb=400)
check(E.prewarm(keys1k, device=DEV), "phase 25: the 1,024-key prewarm")
keys25 = [keys1k[j] for j in idx15]
comb_single, c, rec = step25("comb single", lambda: E.verify_batch(
    keys25, msgs15, sigs15, device=DEV))
check(rec["path"] == "comb" and c == {"comb_verify": 1}
      and np.array_equal(comb_single, expect15),
      f"phase 25 single-device comb: {c} {rec}")
install25(True)
comb25 = {}
for mb, path, cap in ((400, "mesh-comb", ("comb_verify",
                                          "phase 25 mesh-comb, position 0")),
                      (300, "mesh-comb-sharded", ()), (220, "comb", ())):
    E.set_comb_config(table_cache_mb=mb)
    bits, c, rec = step25(f"comb {mb} MiB", lambda: E.verify_batch(
        keys25, msgs15, sigs15, device=DEV), capture=cap)
    comb25[path] = {"launches": c, "record": rec, "mesh_tables": (
        devobs.ledger_report().get("mesh_tables", {}).get("bytes"))}
    check(rec["path"] == path and np.array_equal(bits, comb_single)
          and c == {"comb_verify": 1 if path == "comb" else 4},
          f"phase 25 comb at {mb} MiB: {c} {rec}")
check(comb25["mesh-comb"]["mesh_tables"] == 3 * 1024 * TB25
      and comb25["mesh-comb-sharded"]["mesh_tables"] == 4 * 1024 * TB25
      and comb25["comb"]["mesh_tables"] == 4 * 1024 * TB25,
      f"phase 25: the mesh_tables ledger: {comb25}")
label, args, out = captured["comb_verify"][-1]
ptab, pok = plain_tables(keys1k)
cmp25["comb_verify"].append(c2_row(
    label, out.cpu().numpy(),
    cc.comb_verify_plain(args[0], ptab, pok).cpu().numpy()))
# chaos at sharding.mesh_comb: the single-device comb, exact bitmap
rt25 = degrade.runtime()
E.set_comb_config(table_cache_mb=400)
dec0 = rt25.metrics.msm_route.value(path="mesh-comb", outcome="declined")
failpoints.set_mode("sharding.mesh_comb", "raise")
try:
    bits, c, rec = step25("chaos mesh_comb", lambda: E.verify_batch(
        keys25[:4096], msgs15[:4096], sigs15[:4096], device=DEV))
finally:
    failpoints.clear("sharding.mesh_comb")
chaos25 = {"mesh_comb": {"launches": c, "path": rec["path"], "declined":
                         rt25.metrics.msm_route.value(
                             path="mesh-comb", outcome="declined") - dec0}}
check(rec["path"] == "comb" and c == {"comb_verify": 1}
      and chaos25["mesh_comb"]["declined"] == 1
      and np.array_equal(bits, expect15[:4096]),
      f"phase 25 chaos at sharding.mesh_comb: {chaos25}")
E.table_cache_clear()
E._table_budget_override = None
check(devobs.ledger_report().get("mesh_tables", {}).get("bytes") == 0,
      "phase 25: the mesh_tables pool is not back to 0")
plane25["comb"] = comb25
# chaos at sharding.mesh_stage: the single-device ladder, exact bitmap
dec0 = rt25.metrics.msm_route.value(path="mesh-cuda", outcome="declined")
failpoints.set_mode("sharding.mesh_stage", "raise")
try:
    bits, c, rec = step25("chaos mesh_stage", lambda: E.verify_batch(
        p6[:4096], m6[:4096], s6[:4096], device=DEV))
finally:
    failpoints.clear("sharding.mesh_stage")
chaos25["mesh_stage"] = {"launches": c, "path": rec["path"], "declined":
                         rt25.metrics.msm_route.value(
                             path="mesh-cuda", outcome="declined") - dec0}
check(rec["path"] == "cuda" and c == {"verify_packed": 1}
      and chaos25["mesh_stage"]["declined"] == 1
      and np.array_equal(bits, expect6[:4096]),
      f"phase 25 chaos at sharding.mesh_stage: {chaos25}")
plane25["chaos"] = chaos25
for s_ in ("batch.ed25519",):
    runtime_clean("phase 25", s_)

# -- walls beside the single-device walls of the same batch (one card: the
# plane's overhead, not scaling)
single25 = {
    "k1": lambda: E.verify_batch(p6, m6, s6, device=DEV),
    "k3": lambda: ck.verify_staged(*(
        torch.from_numpy(staged25[k].view(np.uint8)).to(DEV)
        for k in ("pub", "r", "s", "digest"))).cpu().numpy() & host_ok25,
    "rlc": lambda: msm.verify_batch_rlc(vp100k, msgs100k, sig100k,
                                        device=DEV)}
plane_fns25 = {
    "k1": lambda: P25.verify_batch(p6, m6, s6),
    "k3": lambda: P25._verify_compact(staged25, host_ok25),
    "rlc": lambda: msm.verify_batch_rlc(vp100k, msgs100k, sig100k,
                                        plane=P25, device=DEV)}


def walls_of25(fn, reps=2):
    """Host walls of `reps` calls of fn after one warm-up call (phase 7's
    `wall`; the name is a number by phase 25)."""
    fn()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t)
    return out


msm.set_enabled(True)
wall25 = {}
for key in single25:
    wall25[key] = {"plane_s": walls_of25(plane_fns25[key]),
                   "single_s": walls_of25(single25[key])}
msm.set_enabled(None)
plane25["walls_s"] = wall25
log(phase=25, card=CARD, at_s=time.perf_counter() - T25, step="a plane",
    walls=wall25, per_position=pos25, comb=comb25, chaos=chaos25)

# -- a position's K1 wrapper raising outside a drill
check(not failpoints.armed(), "phase 25: a failpoint is armed")
rt = degrade.runtime()
fails0 = counter_total(rt.metrics.device_failures)
falls0 = counter_total(rt.metrics.host_fallbacks)
k1_seen, plain_seen = [], [0]
keeping = ck.verify_packed
keeping_plain = ck.verify_packed_plain


def position1_fails(packed):
    k1_seen.append(int(packed.shape[1]))
    if len(k1_seen) == 2:
        launch_failed(packed)
    return keeping(packed)


def plain_counted(packed):
    plain_seen[0] += 1
    return keeping_plain(packed)


install25(True)
cbatch.verified_sigs = cbatch.SigCache()
bvf = cbatch.BatchVerifier(device=DEV)
for p_, m_, s_ in zip(p6[:4096], m6[:4096], s6[:4096]):
    bvf.add(edkeys.PubKey(p_), m_, s_)
ck.verify_packed, ck.verify_packed_plain = position1_fails, plain_counted
try:
    err25 = None
    try:
        bvf.verify()
    except Exception as e:  # noqa: BLE001 - checked below
        err25 = e
finally:
    ck.verify_packed, ck.verify_packed_plain = keeping, keeping_plain
install25(False)
fault25 = {"error": type(err25).__name__, "k1_calls": k1_seen,
           "plain_calls": plain_seen[0],
           "failures": counter_total(rt.metrics.device_failures) - fails0,
           "fallbacks": counter_total(rt.metrics.host_fallbacks) - falls0}
check(isinstance(err25, degrade.DeviceLaneError) and k1_seen == [1024, 1024]
      and plain_seen[0] == 0 and fault25["failures"] >= 1
      and fault25["fallbacks"] == 0,
      f"phase 25: a position's card fault: {fault25} ({err25!r})")
degrade.configure(degrade.DegradeConfig.from_env(),
                  registry=Registry("p25 after the fault"))
plane25["card_fault"] = fault25
for _name in KERN25:
    setattr(KERNEL_MOD[_name], _name, REAL[_name])
check(sorted(pos25) == sorted(KERN25)
      and all(len(v) == 4 and min(v) > 0 for v in pos25.values()),
      f"phase 25: a kernel did not launch on every position: {pos25}")
plane25["per_position_launches"] = pos25
staging_clear(25)

# -- (b) the two ranks of the global plane
single_b25, c, rec = step25("b single-device", lambda: cbatch.verify_sigs_bulk(
    [edkeys.PubKey(p_) for p_ in pubs25], msgs25, sigs25, device=DEV),
    site="bulk.ed25519")
check(np.array_equal(single_b25, expect25), "phase 25 (b): the single-device "
      "bitmap of the 4,096-validator commit")


def collect25():
    """Both ranks' reports; a pair whose rank 0 lost its port to another
    process between the probe and the bind is started once more."""
    for attempt in range(2):
        rcs = []
        for rank in (0, 1):
            p_, _, _ = procs25[rank]
            try:
                rcs.append(p_.wait(max(60.0, 400.0 - (
                    time.perf_counter() - procs25[rank][2]))))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        outs = []
        for rank in (0, 1):
            with open(procs25[rank][1]) as f_:
                outs.append(f_.read())
        if rcs == [0, 0]:
            break
        stop_procs25()
        if attempt == 0 and any("EADDRINUSE" in o or "ddress already in use"
                                in o for o in outs):
            start25()
            continue
        fail(f"phase 25 (b): the ranks exited {rcs}:\n"
             + "\n".join(o[-3000:] for o in outs))
    reps = []
    for rank in (0, 1):
        with open(os.path.join(root25, f"gmesh_{rank}.json")) as f_:
            reps.append(json.load(f_))
    return reps, {r: procs25[r][2] for r in (0, 1)}


g25, _ = collect25()
walls25["b ranks"] = time.perf_counter() - T25S


def bits25(hexs):
    return np.unpackbits(np.frombuffer(bytes.fromhex(hexs), np.uint8)
                         )[:len(pubs25)].astype(bool)


for r in g25:
    b_, rp, al = r["bulk"], r["replay"], r["after_latch"]
    check(r["backend"] == "gloo" and b_["path"] == "global-mesh"
          and b_["shards"] == 2 and b_["all_valid"] is False
          and b_["launches"] == {"verify_staged": 1}
          and b_["k3_lanes"] == [b_["nb"] // 2]
          and np.array_equal(bits25(b_["bitmap"]), single_b25),
          f"phase 25 (b) rank {r['rank']}: the coordinated bulk {b_}")
    check(rp["path"] == "global-mesh" and rp["shards"] == 2
          and rp["applied"] == H25 and rp["launches"].get("verify_staged")
          and rp["app_hash"] == bytes(states25[-1].app_hash).hex(),
          f"phase 25 (b) rank {r['rank']}: the lockstep replay {rp}")
    check(al["path"] != "global-mesh" and al["shards"] == 1
          and "verify_staged" not in al["launches"]
          and np.array_equal(bits25(al["bitmap"]), single_b25),
          f"phase 25 (b) rank {r['rank']}: after the latch {al}")
    check(r["failures"] == 0 and r["fallbacks"] == 0
          and r["breaker"] == degrade.CLOSED
          and all(row[2] == 0 for row in r["k3_vs_plain"]),
          f"phase 25 (b) rank {r['rank']}: {r}")
    cmp25["verify_staged"] += [tuple(row) for row in r["k3_vs_plain"]]
    for step_ in (b_, rp, al):
        for k_, v_ in step_["launches"].items():
            launches_main[k_] = launches_main.get(k_, 0) + v_
check(g25[1]["latch"]["self_latched"] and g25[0]["latch"]["peer_saw_poison"]
      and g25[0]["latch"]["seen_after_s"]
      <= 2 * g25[0]["latch"]["check_every_s"],
      f"phase 25 (b): the poison latch {g25[0]['latch']} "
      f"{g25[1]['latch']}")
plane25["global"] = g25
shutil.rmtree(root25)
plane25.update(comparisons=cmp25, walls=walls25,
               phase_s=time.perf_counter() - T25)
log(phase=25, card=CARD, at_s=time.perf_counter() - T25, step="b ranks",
    ranks=[{k: r[k] for k in ("rank", "bulk", "replay", "latch",
                              "after_latch")} for r in g25])
log(phase=25, card=CARD, at_s=time.perf_counter() - T25,
    comparisons=cmp25, walls=walls25, phase_s=plane25["phase_s"])
REPORT["planes"] = plane25

# -- phase 26: the kernels line -----------------------------------------------

src = "tendermint_tpu_torch/csrc/ed25519_verify.cu"
# each comparison: (input, lanes, mismatching lanes, max |kernel - plain|)
k1_cmp = [("phase-3 vectors + seeded", k1_cmp_lanes, k1_mism,
           float(np.abs(k1_raw.astype(int) - plain_raw.astype(int)).max())),
          cmp4, cmp6, cmp13] + cmp16["verify_packed"] \
    + cmp17["verify_packed"] + cmp18["verify_packed"] \
    + cmp19["verify_packed"] + cmp20["verify_packed"] \
    + cmp21["verify_packed"] + cmp22["verify_packed"] \
    + cmp23["verify_packed"] + cmp24["verify_packed"] \
    + cmp25["verify_packed"]
k2_cmp = [("phase-3 vectors + seeded", len(k2_raw3), k2_mism3,
           float(np.abs(k2_raw3.astype(int) - k2_plain3.astype(int)).max())),
          ("100k slice", 4096, k2_mism,
           float(np.abs(k2_raw.astype(int) - k2_plain.astype(int)).max())),
          cmp5] + cmp16["verify_packed_split"] \
    + cmp17["verify_packed_split"] + cmp18["verify_packed_split"] \
    + cmp19["verify_packed_split"] + cmp20["verify_packed_split"] \
    + cmp21["verify_packed_split"] + cmp22["verify_packed_split"] \
    + cmp23["verify_packed_split"] + cmp24["verify_packed_split"]
k3_cmp = [("phase-3 vectors + seeded", len(k3_raw3), k3_mism3,
           float(np.abs(k3_raw3.astype(int) - k3_plain3.astype(int)).max())),
          cmp11] + cmp25["verify_staged"]
kernels = [
    {"name": "K1 verify_packed", "route": "cuda", "source": src,
     "replaces": "tendermint_tpu/ops/pallas_ed25519.py:826",
     "launches": launches_main["verify_packed"],
     "lanes_compared": [c[1] for c in k1_cmp],
     "mismatches": sum(c[2] for c in k1_cmp),
     "max_abs_err": max(c[3] for c in k1_cmp),
     "lanes": 65536, "ms": times["k1_65536_ms"],
     "plain_ms": times["plain_k1_65536_ms"],
     "bound_ms": ck.bound_ms(65536), "bound_by": "operations",
     "library_ms": None},
    {"name": "K2 verify_packed_split", "route": "cuda", "source": src,
     "replaces": "tendermint_tpu/ops/pallas_ed25519.py:796",
     "launches": launches_main["verify_packed_split"],
     "lanes_compared": [c[1] for c in k2_cmp],
     "mismatches": sum(c[2] for c in k2_cmp),
     "max_abs_err": max(c[3] for c in k2_cmp),
     "lanes": 16384, "ms": times["k2_16384_ms"],
     "plain_ms": times["plain_k2_16384_ms"],
     "bound_ms": ck.bound_ms(16384), "bound_by": "operations",
     "library_ms": None},
    {"name": "K3 verify_staged", "route": "cuda", "source": src,
     "replaces": "tendermint_tpu/ops/pallas_ed25519.py:853",
     "launches": launches_main["verify_staged"],
     "lanes_compared": [c[1] for c in k3_cmp],
     "mismatches": sum(c[2] for c in k3_cmp) + k3_vs_k1,
     "max_abs_err": max(c[3] for c in k3_cmp),
     "lanes": 65536, "ms": times["k3_65536_ms"],
     "plain_ms": times["plain_k3_65536_ms"],
     "bound_ms": ck.bound_ms(65536, staged=True), "bound_by": "operations",
     "library_ms": None},
]
msm_src = "tendermint_tpu_torch/csrc/msm.cu"
T5, K5, W5, c5, items5, rows5 = scan_shapes[0]
# K4 is compared as bytes; K5 and A1 as points (max_abs_err: 1.0 where any
# point differs)
for name, key, replaces, compared, lanes, ms, plain_ms, bound in (
        ("K4 decompress_niels", "decompress_niels",
         "tendermint_tpu/ops/pallas_msm.py:106", "bytes", 262_144,
         times["k4_262144_ms"], times["plain_k4_262144_ms"],
         cm.bound_ms_decompress(262_144)),
        ("K5 bucket_scan", "bucket_scan",
         "tendermint_tpu/ops/pallas_msm.py:188", "points", K5,
         times[f"k5_{T5}x{K5}_ms"], times[f"plain_k5_{T5}x{K5}_ms"],
         cm.bound_ms_bucket_scan(items5, rows5, T5, K5)),
        ("A1 aggregate (XLA _aggregate, not a Pallas kernel)", "aggregate",
         "tendermint_tpu/ops/msm.py:176", "points", W5,
         times[f"a1_{W5}x{c5}_ms"], times[f"plain_a1_{W5}x{c5}_ms"],
         cm.bound_ms_aggregate(W5, c5))):
    cmps = msm_cmp[key]
    kernels.append(
        {"name": name, "route": "cuda", "source": msm_src,
         "replaces": replaces, "launches": launches_main[key],
         "compared": compared, "lanes_compared": [c[1] for c in cmps],
         "mismatches": sum(c[2] for c in cmps),
         "max_abs_err": max(c[3] for c in cmps),
         "lanes": lanes, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
         "bound_by": "operations", "library_ms": None})
# S1 and S2, each at config 5's launch (2,048 lanes); held against their
# plain versions as verdict bitmaps
for name, key, src_f, replaces, cmps, bound in (
        ("S1 secp256k1 verify_rows (XLA _verify_core, not a Pallas kernel)",
         "s1", "tendermint_tpu_torch/csrc/secp256k1_verify.cu",
         "tendermint_tpu/ops/secp.py:201", s1_cmp,
         times["s1_2048_bound_ms"]),
        ("S2 sr25519 verify_packed (XLA _verify_core with ristretto decode "
         "and eq, not a Pallas kernel)", "s2",
         "tendermint_tpu_torch/csrc/sr25519_verify.cu",
         "tendermint_tpu/ops/sr25519.py:44", s2_cmp,
         times["s2_2048_bound_ms"])):
    kernels.append(
        {"name": name, "route": "cuda", "source": src_f,
         "replaces": replaces, "launches": launches14[key.upper()],
         "compared": "verdict bitmaps",
         "lanes_compared": [c[1] for c in cmps],
         "mismatches": sum(c[2] for c in cmps),
         "max_abs_err": max(c[3] for c in cmps),
         "lanes": 2048, "ms": times[f"{key}_2048_ms"],
         "plain_ms": times[f"plain_{key}_2048_ms"], "bound_ms": bound,
         "bound_by": "operations", "library_ms": None})
# C1 and C2 (XLA functions of the JAX package, not Pallas kernels): C1 at
# the 1,024-key set, held as field values; C2 at 65,536 lanes, as bitmaps
cmp15 += cmp16["comb_build"] + cmp17["comb_build"] + cmp18["comb_build"] \
    + cmp19["comb_build"] + cmp21["comb_build"] + cmp22["comb_build"] \
    + cmp23["comb_build"] + cmp24["comb_build"]
c2_cmp += cmp16["comb_verify"] + cmp17["comb_verify"] \
    + cmp18["comb_verify"] + cmp19["comb_verify"] + cmp21["comb_verify"] \
    + cmp22["comb_verify"] + cmp23["comb_verify"] + cmp24["comb_verify"] \
    + cmp25["comb_verify"]
c2_vs_k1 += c2_vs_k1_16
comb_src = "tendermint_tpu_torch/csrc/comb.cu"
kernels.append(
    {"name": "C1 comb_build (XLA comb_build_kernel_impl, not a Pallas "
     "kernel)", "route": "cuda", "source": comb_src,
     "replaces": "tendermint_tpu/ops/ed25519.py:495",
     "launches": launches_main["comb_build"],
     "compared": "table field values and decode verdicts",
     "lanes_compared": [c[1] for c in cmp15],
     "mismatches": sum(c[2] for c in cmp15),
     "max_abs_err": float(min(1, sum(c[2] for c in cmp15))),
     "lanes": 1024, "ms": times["c1_1024_ms"],
     "plain_ms": times["plain_c1_1024_ms"],
     "bound_ms": times["c1_1024_bound_ms"],
     "bound_by": cc.bound_by_build(1024), "library_ms": None})
kernels.append(
    {"name": "C2 comb_verify (XLA comb_verify_staged, not a Pallas kernel)",
     "route": "cuda", "source": comb_src,
     "replaces": "tendermint_tpu/ops/ed25519.py:542",
     "launches": launches_main["comb_verify"],
     "compared": "verdict bitmaps",
     "lanes_compared": [c[1] for c in c2_cmp],
     "mismatches": sum(c[2] for c in c2_cmp) + c2_vs_k1,
     "max_abs_err": max(c[3] for c in c2_cmp),
     "lanes": 65536, "ms": times["c2_65536_ms"],
     "plain_ms": times["plain_c2_65536_ms"],
     "bound_ms": times["c2_65536_bound_ms"],
     "bound_by": cc.bound_by_verify(c2_work[65536]), "library_ms": None})
REPORT.update(times=times, kernels=kernels, ptxas=ptxas, k4_span=k4_span,
              runtime=runtime12, scheduler=sched13,
              verify_build=verify_build, msm_build=msm_build,
              lane_build=lane_build, comb_build=comb_build_rep,
              segment_sweep=segment_sweep,
              records={"150": rec150, "100k": rec5b, "pipelined": rec6,
                       "rlc_100k": rec8, "rlc_16384": rec9,
                       "staged_65536": rec11},
              total_s=time.perf_counter() - T0)
os.makedirs(OUT_DIR, exist_ok=True)
with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
    json.dump(REPORT, f, indent=1, default=str)
check(all(k["mismatches"] == 0 and k["launches"] > 0 for k in kernels),
      "a kernel of the path mismatched or never launched")
check(S1_BUILD["threads_per_block"] == 128 and S1_WARPS_PER_SM >= 16,
      f"S1 occupancy below its design's 16 warps an SM: {S1_BUILD}")
check(S2_BUILD["threads_per_block"] == 128 and S2_WARPS_PER_SM >= 16,
      f"S2 occupancy below its design's 16 warps an SM: {S2_BUILD}")
C1_BUILD = comb_build_rep["k_comb_build"]
check(C1_BUILD["threads_per_block"] == 128 and C1_BUILD["blocks_per_sm"] >= 4
      and C1_BUILD["registers"] <= 128 and C1_BUILD["spill_stores"] == 0,
      f"C1 below its design's 4 blocks of 128 an SM within 128 registers "
      f"and no spill: {C1_BUILD}")
C2_BUILD = comb_build_rep["k_comb_verify"]
check(C2_BUILD["threads_per_block"] == 128 and C2_BUILD["blocks_per_sm"] >= 4,
      f"C2 occupancy below its design's 4 blocks of 128 an SM: {C2_BUILD}")
print(json.dumps({"kernels": kernels}), flush=True)
print(json.dumps({"ok": True, "device": {
    "platform": "gpu", "kind": KIND, "count": torch.cuda.device_count()}}),
    flush=True)
