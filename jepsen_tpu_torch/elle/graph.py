"""Dependency graphs over transactions, as index arrays (a copy of
`jepsen_tpu/elle/graph.py`: the host oracle and the explainer).

Nodes are history indices of completed transactions; edges are three
parallel int32 columns (src, dst, type). That struct-of-arrays layout is
deliberate: the device pass (`elle/tpu.py`) lifts the columns straight
into device tensors (adjacency as a sparse matrix; SCC by repeated-squaring
reachability or forward/backward reach), while the host algorithms here
(iterative Tarjan SCC, BFS shortest cycle) serve as the oracle.

Graph construction parity targets: Elle's realtime graph (ops linked
when one completes before another begins — the strict-serializability
edge source) and process graph (per-process order), which the reference
passes as `:additional-graphs` (tests/cycle/append.clj:49-50,
tests/cycle/wr.clj:16-19).
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Optional

import numpy as np

# Edge types
WW = 0        # write -> write (version order)
WR = 1        # write -> read  (information flow)
RW = 2        # read  -> write (anti-dependency)
REALTIME = 3  # completes-before-begins
PROCESS = 4   # same-process order

EDGE_NAMES = {WW: "ww", WR: "wr", RW: "rw", REALTIME: "realtime",
              PROCESS: "process"}


class DepGraph:
    """A typed digraph over txn indices, storable as index tensors."""

    def __init__(self):
        self._src: list[int] = []
        self._dst: list[int] = []
        self._typ: list[int] = []
        self._nodes: set[int] = set()
        # (src, dst, typ) -> arbitrary explanation payload
        self.labels: dict = {}

    def add_node(self, n: int) -> None:
        self._nodes.add(int(n))

    def add_edge(self, src: int, dst: int, typ: int,
                 label: Any = None) -> None:
        """Add src -> dst. Self-edges are dropped: a txn never depends
        on itself in Adya's formalism (internal anomalies are checked
        separately)."""
        src, dst = int(src), int(dst)
        if src == dst:
            return
        key = (src, dst, typ)
        if key in self.labels:
            return
        self.labels[key] = label
        self._src.append(src)
        self._dst.append(dst)
        self._typ.append(typ)
        self._nodes.add(src)
        self._nodes.add(dst)

    def merge(self, other: "DepGraph") -> "DepGraph":
        for (s, d, t), lab in other.labels.items():
            self.add_edge(s, d, t, lab)
        self._nodes |= other._nodes
        return self

    # -- tensor views --------------------------------------------------
    @property
    def edges(self) -> np.ndarray:
        """(E, 3) int32 array of (src, dst, type) — the device layout."""
        if not self._src:
            return np.zeros((0, 3), np.int32)
        return np.stack([np.asarray(self._src, np.int32),
                         np.asarray(self._dst, np.int32),
                         np.asarray(self._typ, np.int32)], axis=1)

    @property
    def nodes(self) -> np.ndarray:
        return np.asarray(sorted(self._nodes), np.int32)

    def __len__(self) -> int:
        return len(self._src)

    # -- host algorithms ----------------------------------------------
    def adjacency(self, types: Optional[set] = None) -> dict:
        adj: dict = defaultdict(list)
        for s, d, t in zip(self._src, self._dst, self._typ):
            if types is None or t in types:
                adj[s].append((d, t))
        return adj

    def sccs(self, types: Optional[set] = None) -> list[list[int]]:
        """Strongly connected components with >1 node, over the subgraph
        of the given edge types. Iterative Tarjan."""
        adj = self.adjacency(types)
        index: dict = {}
        low: dict = {}
        on_stack: set = set()
        stack: list = []
        sccs: list = []
        counter = [0]

        for root in sorted(self._nodes):
            if root in index:
                continue
            # iterative DFS: (node, iterator state)
            work = [(root, iter(adj.get(root, ())))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for child, _t in it:
                    if child not in index:
                        index[child] = low[child] = counter[0]
                        counter[0] += 1
                        stack.append(child)
                        on_stack.add(child)
                        work.append((child, iter(adj.get(child, ()))))
                        advanced = True
                        break
                    if child in on_stack:
                        low[node] = min(low[node], index[child])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        x = stack.pop()
                        on_stack.discard(x)
                        comp.append(x)
                        if x == node:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))
        return sccs

    def find_cycle(self, types: Optional[set] = None) -> Optional[list]:
        """A shortest cycle in the subgraph of the given types, as a
        node list [a, b, ..., a]; None if acyclic."""
        for comp in self.sccs(types):
            cyc = self._cycle_in(set(comp), types)
            if cyc:
                return cyc
        return None

    def find_cycle_with(self, must_type: int, other_types: set,
                        exactly_one: bool = False) -> Optional[list]:
        """A cycle containing >=1 edge of must_type; with exactly_one,
        the remaining edges avoid must_type (Elle's G-single search: one
        rw edge closed by a ww/wr path)."""
        allowed = other_types | {must_type}
        adj = self.adjacency(other_types if exactly_one else allowed)
        for s, d, t in zip(self._src, self._dst, self._typ):
            if t != must_type:
                continue
            # path dst -> src closes the cycle around this edge
            path = _bfs_path(adj, d, s)
            if path is not None:
                return [s] + path  # [s, d, ..., s]
        return None

    def _cycle_in(self, comp: set, types: Optional[set]) -> Optional[list]:
        adj = self.adjacency(types)
        start = min(comp)
        # BFS back to start constrained to the component
        for nxt, _t in adj.get(start, ()):
            if nxt not in comp:
                continue
            if nxt == start:
                continue
            path = _bfs_path(adj, nxt, start, within=comp)
            if path is not None:
                return [start] + path
        return None

    def edge_type(self, src: int, dst: int) -> Optional[int]:
        """The 'strongest' edge type between src->dst (ww < wr < rw in
        explanation preference)."""
        best = None
        for (s, d, t) in self.labels:
            if s == src and d == dst and (best is None or t < best):
                best = t
        return best

    def explain_cycle(self, cycle: list) -> list[dict]:
        """Edge-by-edge explanation of a node cycle."""
        out = []
        for a, b in zip(cycle, cycle[1:]):
            t = self.edge_type(a, b)
            out.append({"from": a, "to": b,
                        "type": EDGE_NAMES.get(t, t),
                        "detail": self.labels.get((a, b, t))})
        return out


def _bfs_path(adj: dict, start: int, goal: int,
              within: Optional[set] = None) -> Optional[list]:
    """Shortest path start -> goal (inclusive); None if unreachable."""
    if start == goal:
        return [start]
    prev: dict = {start: None}
    q = deque([start])
    while q:
        node = q.popleft()
        for child, _t in adj.get(node, ()):
            if child in prev or (within is not None and child not in within):
                continue
            prev[child] = node
            if child == goal:
                path = [child]
                while prev[path[-1]] is not None:
                    path.append(prev[path[-1]])
                return path[::-1]
            q.append(child)
    return None


# -- additional graphs (Elle's :additional-graphs) -------------------------

def realtime_graph(history) -> DepGraph:
    """A completes strictly before B begins => A -> B, transitively
    reduced.

    Sweep events in time order keeping a frontier of completed ops not
    yet *superseded*. B invoking links B from every frontier op; those
    predecessors leave the frontier only when B COMPLETES — any op D
    invoking after B's completion reaches them through B (A -> B -> D),
    but an op C invoking before B completes still needs its own A -> C
    edge (removing predecessors at B's invocation would drop it)."""
    g = DepGraph()
    pairs = [(inv, comp) for inv, comp in history.pairs()
             if comp is not None and comp.is_ok]
    # events: (time, kind, ...); completions before invocations at equal
    # times (an op invoked at t sees completions at t)
    events = []
    for inv, comp in pairs:
        events.append((inv.time, 1, comp.index, inv, comp))
        events.append((comp.time, 0, comp.index, inv, comp))
    events.sort(key=lambda e: (e[0], e[1]))
    frontier: set = set()   # completed, not superseded
    done: dict = {}         # index -> completion op
    preds_of: dict = {}     # index -> frontier snapshot at invocation
    for _t, kind, idx, inv, comp in events:
        if kind == 1:
            preds = frontier - {idx}
            preds_of[idx] = preds
            for p in preds:
                g.add_edge(p, idx, REALTIME,
                           {"pred_completed": done[p].time,
                            "succ_began": inv.time})
        else:
            frontier -= preds_of.get(idx, set())
            frontier.add(idx)
            done[idx] = comp
    return g


def process_graph(history) -> DepGraph:
    """Consecutive completed ops of the same process => earlier ->
    later."""
    g = DepGraph()
    last: dict = {}
    for inv, comp in history.pairs():
        if comp is None or not comp.is_ok:
            continue
        p = inv.process
        if p in last:
            g.add_edge(last[p], comp.index, PROCESS, {"process": p})
        last[p] = comp.index
    return g
