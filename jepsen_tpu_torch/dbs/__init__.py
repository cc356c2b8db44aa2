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
- `sqlite` — the SQL/ACID family exemplar: a LIVE server wrapping stdlib
  sqlite3 behind the shared RESP wire — micro-op txns in one
  serializable BEGIN IMMEDIATE, WAL + synchronous=FULL crash safety —
  driven by elle append/wr and bank workloads under a primary-kill
  nemesis, all CI-run against live processes; the elle checks' cycle
  search runs on the card.
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

`miniserver` holds the mini servers' shared RESP codec and daemon
lifecycle, `retryclient` the shared connect-with-retry client.

Run one with `python -m jepsen_tpu_torch.dbs.<suite> test --nodes ...`;
sweep a suite's matrix with `... test-all`.

The port's copy of `jepsen_tpu/dbs/__init__.py`. The reference's other
suites are not ported yet (ROADMAP.md Queue A item 6.6). The suites
that speak HTTP (etcd, consul, elasticsearch) do so through
`httpclient`, on the standard library.
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
