"""Transactional anomaly detection by dependency-graph cycle search.

The port of the JAX package's `jepsen_tpu.elle` (the capability of
the Elle checker the reference wraps at
`jepsen/src/jepsen/tests/cycle.clj:9-16`,
`tests/cycle/append.clj:11-22` and `tests/cycle/wr.clj:14-53`):

  * `elle.graph`   — dependency graphs as index arrays, with host
                     Tarjan SCC + shortest-cycle search (the oracle and
                     the explainer);
  * `elle.append`  — list-append histories (`check`);
  * `elle.wr`      — write/read registers (`check`);
  * `elle.build`   — tensorized graph construction: (E, 3) edge columns
                     + interval-jump metadata, no DepGraph on the hot
                     path;
  * `elle.tpu`     — the device cycle-query battery, on CUDA: the dense
                     bf16 closure (`csrc/elle_closure.cu`), the packed
                     bitset closure (`csrc/elle_packed.cu`) and the
                     peel-to-core trim (`csrc/elle_trim.cu`), behind the
                     shape-aware route of `ops/route.elle_cycle_route`.
                     The module keeps its counterpart's name.

The host modules are copies of the JAX package's jax-free ones.

Anomaly taxonomy (Adya's names, as the reference documents in
tests/cycle/wr.clj:30-46):

  G0        write cycle (ww edges only)
  G1a       aborted read
  G1b       intermediate read
  G1c       circular information flow (ww + wr edges)
  G-single  cycle with exactly one anti-dependency (rw) edge
  G2        cycle with at least one rw edge
  internal  txn inconsistent with its own prior reads/writes
"""

from .graph import (EDGE_NAMES, PROCESS, REALTIME, RW, WR, WW, DepGraph,
                    process_graph, realtime_graph)

__all__ = ["DepGraph", "WW", "WR", "RW", "REALTIME", "PROCESS",
           "EDGE_NAMES", "realtime_graph", "process_graph"]
