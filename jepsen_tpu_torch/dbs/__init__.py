"""Database test suites — the L7 layer.

The reference ships 25 standalone per-database suites (tidb, yugabyte,
zookeeper, ...: SURVEY.md §2.4), each wiring a DB lifecycle
implementation, per-workload clients, a nemesis, and a CLI main into
the shared framework. The suites ported so far:

- `toykv` — a real networked key-value store driven end to end over
  the localexec remote, proving the whole stack against live
  processes, down to the per-key linearizability check on the card.

Run one with `python -m jepsen_tpu_torch.dbs.<suite> test --nodes ...`;
sweep a suite's matrix with `... test-all`.

The port's copy of `jepsen_tpu/dbs/__init__.py`. The reference's other
suites, `miniserver.py` and `retryclient.py` are not ported yet
(ROADMAP.md Queue A item 6.6).
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
