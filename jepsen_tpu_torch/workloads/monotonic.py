"""Monotonic workload (tidb/src/tidb/monotonic.clj:1-113, also the
faunadb suite's monotonic family).

A collection of integer registers is incremented via read-write
transactions and read in small groups. Each key's value only ever
grows, so the values observed for a key order the transactions that
observed them; those per-key orders must be mutually consistent — no
transaction may observe x increase while y decreases relative to
another transaction. Violations are cycles in the union of the
per-key version orders, found with the same typed-graph machinery as
the elle checkers (WW edges + SCC search; monotonic.clj:105-111 wires
the reference's cycle/checker the same way).

Client contract:
    {"f": "inc",  "value": {k: v_after, ...}}   increment ks, report
                                                the values written
    {"f": "read", "value": {k: v, ...}}         read a key group
                                                (missing keys -> -1)

The port's copy of `jepsen_tpu/workloads/monotonic.py`.
"""

from __future__ import annotations

from typing import Optional

from .. import checker as jchecker
from .. import generator as gen
from ..elle.graph import WW, DepGraph

DEFAULT_KEYS = 8
GROUP = 3


class MonotonicChecker(jchecker.Checker):
    """Cycle search over per-key observed-value orders."""

    def check(self, test, history, opts=None):
        oks = [op for op in history
               if op.is_ok and op.f in ("inc", "read")
               and isinstance(op.value, dict)]
        g = DepGraph()
        for op in oks:
            g.add_node(op.index)
        # per key: sort ops by observed value; earlier value -> later
        # value orders the txns (equal values are concurrent — no edge)
        by_key: dict = {}
        for op in oks:
            for k, v in op.value.items():
                if v is None:
                    continue
                by_key.setdefault(k, []).append((v, op.index))
        hub = -1  # synthetic hub ids are negative (history ids are >=0)
        for k, pairs in by_key.items():
            # group ops by distinct observed value: EVERY op at value v
            # precedes every op at the next distinct value (linking
            # only adjacent sorted pairs would let ties swallow edges
            # and miss real cycles). Large tie groups route through a
            # synthetic per-boundary hub node — O(|g1|+|g2|) edges with
            # identical cycle semantics (hubs never order group members
            # against each other) instead of O(|g1|*|g2|).
            groups: list = []
            for v, i in sorted(pairs):
                if groups and groups[-1][0] == v:
                    groups[-1][1].append(i)
                else:
                    groups.append((v, [i]))
            for (v1, g1), (v2, g2) in zip(groups, groups[1:]):
                label = {"key": k, "value": v1, "value'": v2}
                if len(g1) * len(g2) <= len(g1) + len(g2):
                    for i1 in g1:
                        for i2 in g2:
                            g.add_edge(i1, i2, WW, label)
                else:
                    for i1 in g1:
                        g.add_edge(i1, hub, WW, label)
                    for i2 in g2:
                        g.add_edge(hub, i2, WW, label)
                    hub -= 1
        cyc = g.find_cycle(types={WW})
        if cyc is None:
            return {"valid?": True, "op-count": len(oks),
                    "key-count": len(by_key)}
        # Report over real ops only: a hub hop a -> h -> b carries the
        # same label on both edges, so keep hub-exit steps and rewrite
        # their "from" to the preceding real node.
        raw = g.explain_cycle(cyc)
        steps = []
        prev_real = next(n for n in reversed(cyc[:-1]) if n >= 0)
        for s in raw:
            if s["to"] < 0:      # entering a hub: remember the source
                prev_real = s["from"]
                continue
            if s["from"] < 0:    # leaving a hub: attribute to source
                s = {**s, "from": prev_real}
            steps.append(s)
            prev_real = s["to"]
        real_cycle = [n for n in cyc if n >= 0]
        if real_cycle and real_cycle[0] != real_cycle[-1]:
            # keep the closed [a, ..., a] shape every cycle result in
            # the codebase uses (a hub at the cut point drops it)
            real_cycle.append(real_cycle[0])
        lines = []
        for s in steps:
            det = s["detail"] or {}
            v2 = det.get("value'")
            lines.append(
                f"T{s['from']} observed key {det.get('key')!r} at "
                f"{det.get('value')!r} before T{s['to']} observed it "
                f"at {v2!r}")
        return {"valid?": False, "cycle": real_cycle, "steps": steps,
                "explanation": "; ".join(lines)}


def checker() -> jchecker.Checker:
    return MonotonicChecker()


def _inc(test, ctx):
    k = gen.RNG.randrange(test.get("monotonic_keys", DEFAULT_KEYS))
    return {"f": "inc", "value": {k: None}}


def _read(test, ctx):
    n = test.get("monotonic_keys", DEFAULT_KEYS)
    ks = gen.RNG.sample(range(n), min(GROUP, n))
    return {"f": "read", "value": {k: None for k in ks}}


def generator():
    """Increments mixed with group reads (monotonic.clj:92-103)."""
    return gen.mix([_inc, _inc, _read])


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    return {"checker": checker(), "generator": generator(),
            "monotonic_keys": opts.get("keys", DEFAULT_KEYS)}
