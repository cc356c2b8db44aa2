"""Database test suites — the L7 layer.

The reference ships 25 standalone per-database suites (tidb, yugabyte,
zookeeper, ...: SURVEY.md §2.4), each wiring a DB lifecycle
implementation, per-workload clients, a nemesis, and a CLI main into
the shared framework. The suites ported so far:

- `toykv` — a real networked key-value store driven end to end over
  the localexec remote, proving the whole stack against live
  processes, down to the per-key linearizability check on the card.
- `etcd` — the tutorial exemplar: release-tarball install, static
  initial-cluster daemon automation, full Process/Pause/Primary fault
  surface, a v3 JSON-gateway client, and the tidb-style test-all
  matrix: 8 workloads (register, append, wr, bank, sets,
  long-fork, monotonic, sequential — tidb's workload list)
  x 4 nemeses (partition, kill, pause, none). `mini` mode runs LIVE
  in-repo v3-gateway servers (fsync'd revision log) under kill/pause
  faults in CI; `deb` is the real automation. The register
  check's device lane and the append / wr checks' cycle search run
  on the card.
- `redis` — the redis-protocol family (the reference's disque): a
  from-scratch RESP2 codec and CAS as an atomic server-side Lua
  script, with two server modes — `source` builds real redis from the
  release tarball; `mini` (default) runs LIVE in-repo RESP servers
  with fsync'd AOFs as subprocesses over the localexec remote, so CI
  exercises install -> real-TCP workload -> kill -9 -> AOF replay ->
  checker against live processes.
- `disque` — the reference's queue-safety exemplar
  (`disque/src/jepsen/disque.clj`): enqueue/dequeue/drain with
  total-queue multiset accounting. `mini` mode (default) runs a LIVE
  in-repo RESP job-queue server per node — at-least-once redelivery,
  fsync'd AOF, kill -9 recovery — over localexec; `source` mode
  clone-and-makes real disque. CI drives the live path, including a
  deterministic volatile-loss counterexample. Its check runs on the
  host.
- `sqlite` — the SQL/ACID family exemplar: a LIVE server wrapping stdlib
  sqlite3 behind the shared RESP wire — micro-op txns in one
  serializable BEGIN IMMEDIATE, WAL + synchronous=FULL crash safety —
  driven by elle append/wr and bank workloads under a primary-kill
  nemesis, all CI-run against live processes; the elle checks' cycle
  search runs on the card.
- `postgres` — the external-SQL-endpoint exemplar (postgres-rds;
  stolon's workloads): a from-scratch pgwire v3 codec (startup
  handshake, simple query protocol, text format), register CAS via
  UPDATE command tags, bank transfers and elle list-append txns in
  BEGIN..COMMIT transactions; CI drives all three against a
  pgwire-framed stub backed by a real SQL engine. The register
  check's device lane and the append check's cycle search run on the
  card.
- `mongodb` — the document-store family (mongodb-rocks /
  mongodb-smartos): a from-scratch BSON subset codec + OP_MSG wire
  framing, document-CAS via conditional updates (nModified decides),
  write-concern knobs, deb install + replica-set initiation issued
  over the suite's own wire client. `mini` mode (default) runs LIVE
  in-repo OP_MSG servers (fsync'd mutation log) under a kill nemesis
  in CI; the mongodb-rocks `storage_engine` axis + logger queue and
  the mongodb-smartos `os=smartos` (SmartOS + ipfilter) path ride the
  deb mode. The register check's device lane runs on the card; the
  logger's latency checker on the host.
- `elasticsearch` — the search-engine family
  (elasticsearch/src/jepsen/elasticsearch/sets.clj): set workload
  over the document REST API with the refresh-before-read visibility
  gate, deb install + unicast-discovery automation. `mini` mode
  (default) runs LIVE servers with an fsync'd translog and a REAL
  refresh gate (restart reloads docs, nothing searchable until
  _refresh); the famous acknowledged-insert-loss counterexample runs
  live via `--lossy-every`.
- `consul` — the HTTP-KV exemplar (consul/src/jepsen/consul.clj):
  v1/kv client with the reference's two-step INDEX-based CAS recipe,
  agent automation with primary bootstrap + retry-join; `mini` mode
  runs LIVE v1/kv servers with fsync'd AOFs under kill and
  SIGSTOP/SIGCONT faults in CI; the register check's device lane
  runs on the card.
- `zookeeper` — the reference's minimal single-file exemplar
  (`zookeeper/src/jepsen/zookeeper.clj:1-145`): distro-package
  install, myid/zoo.cfg generation, and a znode CAS-register client
  over zkCli; `mini` mode runs LIVE znode servers plus an uploaded
  zkCli-shaped CLI in CI, so the unchanged control-plane client
  drives real processes; the CAS register's check runs on the card.
- `rabbitmq` — the queue-workload exemplar
  (`rabbitmq/src/jepsen/rabbitmq.clj`): a from-scratch AMQP 0-9-1
  subset codec (method/header/body frames, publisher confirms,
  basic.get/ack/reject), a LIVE mini broker whose confirms land only
  after an fsync (--volatile demonstrates the confirmed-then-lost
  anomaly), and the distributed-semaphore mutex workload checked
  linearizable. CI-run against live subprocess brokers. The
  semaphore's mutex check races its device lane on the card; the
  queue's total-queue check runs on the host.
- `chronos` — the scheduler-family exemplar
  (`chronos/src/jepsen/chronos{,/checker}.clj`): periodic jobs whose
  target execution windows must each be satisfied by a distinct
  completed run (greedy-EDF matching replaces the reference's
  constraint solver, exactly on the same disjoint-window structure),
  plus set-full over job names; a LIVE mini scheduler actually fires
  runs, and kill -9 leaves incomplete runs / missed windows for the
  checker to report. CI-run. Its checks run on the host.
- `yuga` — the dual-API structure (`yugabyte/src/yugabyte/core.clj`):
  one namespaced workload registry ("ycql/set", "ysql/bank", ...)
  built from shared workload definitions with per-API transport
  clients (RESP mini-redis for ycql, SQL mini-sqlite for ysql), and
  a test-all api x workload sweep. CI-run live on both surfaces. The
  registers' and the multi-key groups' device lanes and the append's
  cycle search run on the card.
- `tidb` — the reference's deep-dive exemplar
  (`tidb/src/tidb/core.clj:32-151`): 11 workloads (bank +
  multitable, long-fork, monotonic, txn-cycle, append, register,
  set, set-cas, sequential, table DDL races) over the shared
  MySQL-wire codec, with the reference's four option axes
  (auto-retry session vars, FOR UPDATE read locks, use-index,
  update-in-place) expanded combinatorially by test-all
  (all-combos / expected-to-pass / quick), and pd -> tikv -> tidb
  three-daemon automation in tarball mode. CI-run live on the
  MySQL-wire mini servers. The register check's device lane and the
  append / txn-cycle checks' cycle search run on the card.
- `stolon` — the PostgreSQL-HA family
  (`stolon/src/jepsen/stolon/{ledger,append,db}.clj`): the ledger
  double-spend workload (transactions as rows, charitable-reading
  checker; fund-then-double-spend attack generator) and elle
  list-append over the shared pgwire codec; LIVE mini pgwire
  servers in CI, real sentinel/keeper/proxy-over-etcdv3 automation
  in `ha` mode. The append check's cycle search runs on the card;
  the ledger's check on the host.
- `raftis` — redis-over-raft (`raftis/src/jepsen/raftis.clj`, the
  reference's smallest suite): one linearizable register over the
  live mini-redis servers, with the reference's definite-fail error
  taxonomy; floyd tarball automation in `tarball` mode. The register
  check's device lane runs on the card.
- `aerospike` — the record-store family
  (`aerospike/src/aerospike/*.clj`): a from-scratch Aerospike
  binary-protocol subset (AS_MSG framing, generation counters),
  generation-CAS registers / INCR counters / CAS-appended sets
  against LIVE mini servers, .deb + mesh-config automation, and the
  JAX package's `jepsen_tpu/dbs/spec/aerospike_gen.tla` TLA+ spec
  explored exhaustively in CI (the reference suite's own
  spec/aerospike.tla is the role model). The cas-register check's
  device lane runs on the card; the counter's and the set's checks on
  the host.
- `rethinkdb` — the document-store-with-topology family
  (`rethinkdb/src/jepsen/rethinkdb{,/document_cas}.clj`): a
  from-scratch ReQL subset (V0_4 handshake, term ASTs), document
  CAS via branch-update, the write_acks/read_mode durability matrix,
  and the reconfigure nemesis issuing topology churn through the
  client protocol; live mini servers in CI, apt automation in deb
  mode. The register check's device lane runs on the card.
- `hazelcast` — the data-grid primitives family
  (`hazelcast/src/jepsen/hazelcast.clj`):
  atomic-long unique IDs, CAS longs, queues, CAS'd map sets, and
  fenced locks (mutex-linearizable + fence-monotonic) over a
  from-scratch binary frame protocol; the volatile-lock violation
  is demonstrated deterministically in CI. The CAS long's and the
  lock's mutex checks race their device lane on the card; the rest,
  the fences included, run on the host.
- `robustirc` — the exactly-once-messaging family
  (`robustirc/src/jepsen/robustirc.clj`): the RobustSession HTTP
  protocol (session auth, ClientMessageId dedup) with a from-scratch
  RFC-1459 parser; topic-set workload live in CI, including
  retransmit-across-restart exactly-once proofs; go-get automation
  in `go` mode. Its check runs on the host.
- `logcabin` — the raft-reference-implementation family
  (`logcabin/src/jepsen/logcabin.clj`): CAS register driven by a
  TreeOps-shaped CLI shelled over the control plane per op (the
  reference's transport), live tree servers in CI, scons
  source-build + bootstrap/Reconfigure automation in `source` mode.
  The register check's device lane runs on the card.
- `cockroach` — the strict-serializability workloads
  (`cockroachdb/src/jepsen/cockroach/{monotonic,comments}.clj`) over
  the from-scratch pgwire client: monotonic (txn max+1 inserts with
  DB timestamps; sts-order must match val-order) and comments (blind
  multi-table inserts; a read seeing w but missing a
  completed-before-w write is the T1<T2-only-T2-visible anomaly).
  `mini` mode (default) runs LIVE WAL-backed pgwire servers under a
  kill nemesis in CI; `--addr` targets any external endpoint. Its
  checks run on the host.
- `galera` — the MySQL-replication family
  (`galera/src/jepsen/galera.clj`): a from-scratch MySQL wire codec
  (packet framing, mysql_native_password scrambling, COM_QUERY
  resultsets) over LIVE mini servers; set inserts, explicit-txn bank
  transfers, and the famous dirty-reads workload. Its checks run on
  the host.
- `percona` — the MySQL-transaction exemplar
  (`percona/src/jepsen/percona.clj`): the bank's lock_type (none /
  FOR UPDATE / LOCK IN SHARE MODE) and in-place axes swept by
  test-all, deadlock-abort retries, debconf-preseed + stock-datadir
  cluster automation. CI-run live on the shared MySQL wire. Its
  checks run on the host.
- `mysql_cluster` — NDB's three-role automation
  (`mysql-cluster/src/jepsen/mysql_cluster.clj`): ndb_mgmd / ndbd /
  mysqld with node-id blocks 1/11/21 and one shared config.ini, plus
  a linearizable register over ENGINE=NDBCLUSTER row CAS. CI-run
  live on the shared MySQL wire; the register check's device lane
  runs on the card.
- `ignite` — the data-grid cache/transaction exemplar
  (`ignite/src/jepsen/ignite*.clj`): the runner's configuration
  lattice (cache atomicity/mode/backups/write-sync x transaction
  concurrency x isolation) swept by test-all; the LIVE mini grid
  implements BOTH concurrency models (pessimistic entry locks with
  wait-timeout aborts, optimistic-serializable commit validation)
  and a real pds durability axis. CI-run live. The register check's
  device lane runs on the card; the bank's check on the host.
- `crate` — the _version MVCC family
  (`crate/src/jepsen/crate/*.clj`): pgwire clients over LIVE mini
  servers whose dialect bridge maintains a real per-row `_version`;
  version-divergence, lost-updates, and the refresh/strong-read
  dirty-read workload with its dirty/lost/not-on-all algebra. Its
  checks run on the host.
- `dgraph` — the graph-database exemplar
  (`dgraph/src/jepsen/dgraph/*.clj`): a LIVE mini alpha implementing
  dgraph's MVCC transaction model (snapshot reads, write-write
  commit conflicts, @upsert-gated index-read conflicts — the
  duplicate-uid upsert anomaly reproduces on demand) under an
  HTTP/JSON txn protocol; all eight reference workloads. CI-run. The
  register check's device lane and the wr check's cycle search run on
  the card; the other six checks on the host.
- `fauna` — the largest reference suite
  (`faunadb/src/jepsen/faunadb/*.clj`): a from-scratch FQL-subset
  JSON expression evaluator where every query is one
  strictly-serializable txn; register CAS via If/Equals,
  single-query bank, set, pages (the non-serialized paginated-read
  anomaly demonstrated live), At-temporal monotonic, adya g2.
  CI-run. The register check's device lane runs on the card; the
  other five checks on the host.

`miniserver` holds the mini servers' shared RESP codec and daemon
lifecycle, `retryclient` the shared connect-with-retry client.

Run one with `python -m jepsen_tpu_torch.dbs.<suite> test --nodes ...`;
sweep a suite's matrix with `... test-all`.

The port's copy of `jepsen_tpu/dbs/__init__.py`. The suites that speak
HTTP (etcd, consul, elasticsearch, chronos, dgraph, fauna, robustirc) do
so through `httpclient`, on the standard library.
"""

from __future__ import annotations


def node_port(test: dict, node: str, base_port: int,
              ports_key: str) -> int:
    """Per-node port for localexec-style single-host clusters: an
    explicit test[ports_key] map wins; otherwise base_port + node
    index. Shared by every suite that runs one server per node on
    localhost (toykv, redis-mini)."""
    return test.get(ports_key, {}).get(
        node, base_port + test["nodes"].index(node))


def node_for_key(test: dict, k) -> str:
    """Key -> owning node (hash sharding): every client of a key talks
    to the same standalone server, the arrangement under which per-key
    linearizability is the right claim to check."""
    nodes = test["nodes"]
    return nodes[hash(str(k)) % len(nodes)]
