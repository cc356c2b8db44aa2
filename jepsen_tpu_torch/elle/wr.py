"""Write/read register anomaly detection (a copy of
`jepsen_tpu/elle/wr.py` whose cycle search runs on the port's kernels,
behind the preflight gate; the telemetry records are not ported yet).

Histories of transactions over registers where every write is unique:

    {"type": "ok", "f": "txn", "value": [["w", "x", 1], ["r", "x", 1]]}

Unlike list-append, a register read reveals only the *current* value,
not the version history — so version orders must be inferred under
explicit assumptions, exactly the knobs the reference exposes
(`jepsen/src/jepsen/tests/cycle/wr.clj:14-53`):

    sequential_keys    each key is sequentially consistent; derive
                       version order from per-process write/read order
    linearizable_keys  each key is linearizable; derive version order
                       from realtime order
    wfr_keys           within a txn, writes follow reads: read of v
                       then write of v' on the same key => v < v'

From whatever version-order fragments those sources give (plus "the
initial nil state precedes everything"), we build a per-key version
graph; a cyclic version graph is itself an anomaly (cyclic-versions),
an acyclic one is linearized topologically and the ww/wr/rw txn graph
follows as in list-append. Direct anomalies (G1a aborted read, G1b
intermediate read, internal) don't need version orders at all.
"""

from __future__ import annotations

import time as _time
from collections import defaultdict
from typing import Any, Iterable

from ..history import History
from ..txn import R, W
from .graph import RW, WR, WW, DepGraph, process_graph, realtime_graph
from .append import (MODEL_VIOLATIONS, AppendGen, _record_build,
                     _record_elle, preflight_gate)

DEFAULT_ANOMALIES = ("G0", "G1a", "G1b", "G1c", "G-single", "G2",
                     "internal", "cyclic-versions")

INIT = object()  # the initial (unwritten, nil) version of every key


def check(history: History, anomalies: Iterable[str] = DEFAULT_ANOMALIES,
          additional_graphs: Iterable[str] = (),
          sequential_keys: bool = False,
          linearizable_keys: bool = False,
          wfr_keys: bool = False,
          cycle_backend: str = "auto", device=None, devices=None) -> dict:
    """Analyze a write/read register history. cycle_backend, device and
    devices as in append.check: "host" | "cuda" | "packed" | "trim" |
    "sharded" | "device" | "auto"."""
    from ..analysis import history_lint
    t_start = _time.monotonic()
    bad = history_lint.gate(history, where="elle.wr",
                            rules=history_lint.ELLE_GATE_RULES)
    if bad is not None:
        return {"valid?": "unknown",
                "anomaly-types": ["malformed-history"],
                "anomalies": {"malformed-history": bad["anomalies"]},
                "not": [], "analyzer": bad["analyzer"]}
    anomalies = set(anomalies)
    found: dict[str, list] = {}
    for name in additional_graphs:
        if name not in ("realtime", "process"):
            raise ValueError(f"unknown additional graph {name!r}")

    oks = [op for op in history
           if op.is_ok and op.f in ("txn", None) and op.value]
    infos = [op for op in history
             if op.is_info and op.f in ("txn", None) and op.value]
    failed = [op for op in history if op.is_fail and op.value]

    # Admission preflight (analysis/preflight): reject a device closure
    # over its capacity or the memory budget (P001/P002) before the
    # graph build, as append.check does.
    if cycle_backend != "host":
        bad_pf = preflight_gate(len(oks) + len(infos), cycle_backend,
                                "elle.wr", device, devices)
        if bad_pf is not None:
            return bad_pf

    # tensorized construction (elle/build.py): writer index, version
    # evidence, and the edge columns in one vectorized pass
    from . import build as build_mod
    try:
        bt = build_mod.build_wr(history, oks, infos,
                                sequential_keys=sequential_keys,
                                linearizable_keys=linearizable_keys,
                                wfr_keys=wfr_keys,
                                additional_graphs=additional_graphs)
        writer, orders, cyclic = bt.writer, bt.orders, \
            bt.cyclic_anomalies
        gt = bt.tensors
        gt._explain = lambda: _legacy_graph(history, oks, writer,
                                            orders, additional_graphs)
        _record_build("wr", bt)
    except build_mod.BuildUnsupported:
        writer = _writer_index(oks + infos)
        orders, cyclic = _version_orders(
            history, oks, writer, sequential_keys=sequential_keys,
            linearizable_keys=linearizable_keys, wfr_keys=wfr_keys)
        gt = _legacy_graph(history, oks, writer, orders,
                           additional_graphs)

    internal = _internal_cases(oks)
    if internal:
        found["internal"] = internal
    g1a = _g1a_cases(oks, failed)
    if g1a:
        found["G1a"] = g1a
    g1b = _g1b_cases(oks)
    if g1b:
        found["G1b"] = g1b
    if cyclic:
        found["cyclic-versions"] = cyclic

    from .tpu import standard_cycle_search
    cycles = standard_cycle_search(gt, backend=cycle_backend,
                                   device=device, devices=devices)
    g = None  # the labeled DepGraph materializes only to EXPLAIN
    if any(cycles[q] for q in ("G0", "G1c", "G-single", "G2")):
        g = gt.to_depgraph() if hasattr(gt, "to_depgraph") else gt
    if cycles["G0"]:
        found["G0"] = [_cycle_case(g, cycles["G0"])]
    if cycles["G1c"] and "G0" not in found:
        found["G1c"] = [_cycle_case(g, cycles["G1c"])]
    if cycles["G-single"]:
        found["G-single"] = [_cycle_case(g, cycles["G-single"])]
    if cycles["G2"] and "G-single" not in found:
        found["G2"] = [_cycle_case(g, cycles["G2"])]

    reported = {k: v for k, v in found.items() if k in anomalies}
    silent = set(found) - set(reported)
    valid: Any = not reported
    if valid and silent:
        valid = "unknown"
    out = {"valid?": valid,
           "anomaly-types": sorted(reported),
           "anomalies": reported,
           "cycle-engine": cycles.get("engine"),
           "not": sorted({MODEL_VIOLATIONS[a] for a in reported
                          if a in MODEL_VIOLATIONS})}
    if cycles.get("util"):
        out["cycle-util"] = cycles["util"]
    if cycles.get("route_reason"):
        out["cycle-route-reason"] = cycles["route_reason"]
    if silent:
        out["unchecked-anomaly-types"] = sorted(silent)
    _record_elle("elle.wr", out, len(oks), _time.monotonic() - t_start)
    return out


def _legacy_graph(history, oks, writer, orders, additional_graphs):
    """The host-builder graph: the oracle/explanation side of the
    tensorized pass."""
    g = _txn_graph(oks, writer, orders)
    for name in additional_graphs:
        if name == "realtime":
            g.merge(realtime_graph(history))
        elif name == "process":
            g.merge(process_graph(history))
    return g


# -- internals ---------------------------------------------------------------

def _writer_index(ops):
    """(k, v) -> op index for every write (unique-writes assumption)."""
    writer: dict = {}
    for op in ops:
        for f, k, v in op.value or []:
            if f == W:
                writer[(k, v)] = op.index
    return writer


def _internal_cases(oks):
    cases = []
    for op in oks:
        state: dict = {}  # key -> last known value within the txn
        for mi, (f, k, v) in enumerate(op.value):
            if f == W:
                state[k] = v
            elif f == R:
                if k in state and state[k] != v:
                    cases.append({
                        "op-index": op.index, "mop-index": mi, "key": k,
                        "observed": v, "expected": state[k],
                        "explanation":
                        f"txn at index {op.index} read {v!r} from key "
                        f"{k!r} but its own prior state was "
                        f"{state[k]!r}"})
                else:
                    state[k] = v
    return cases


def _g1a_cases(oks, failed):
    failed_writes = {}
    for op in failed:
        for f, k, v in op.value or []:
            if f == W:
                failed_writes[(k, v)] = op.index
    cases = []
    for op in oks:
        for f, k, v in op.value:
            if f == R and (k, v) in failed_writes:
                cases.append({
                    "op-index": op.index, "key": k, "value": v,
                    "writer-index": failed_writes[(k, v)],
                    "explanation":
                    f"txn at index {op.index} observed value {v!r} of "
                    f"key {k!r}, written by FAILED txn at index "
                    f"{failed_writes[(k, v)]}"})
    return cases


def _g1b_cases(oks):
    from ..txn import int_write_mops
    intermediate = {}
    for op in oks:
        for k, mops in int_write_mops(op.value).items():
            for m in mops:
                intermediate[(k, m[2])] = op.index
    cases = []
    for op in oks:
        for f, k, v in op.value:
            if f == R and (k, v) in intermediate \
                    and intermediate[(k, v)] != op.index:
                cases.append({
                    "op-index": op.index, "key": k, "value": v,
                    "writer-index": intermediate[(k, v)],
                    "explanation":
                    f"txn at index {op.index} read {v!r} of key {k!r}, "
                    f"an intermediate write of txn at index "
                    f"{intermediate[(k, v)]}"})
    return cases


def _version_orders(history, oks, writer, sequential_keys=False,
                    linearizable_keys=False, wfr_keys=False):
    """Per-key version *evidence graph*: k -> {v1: set of v2 directly
    after v1}.

    Only evidenced precedence is recorded — we never linearize the
    partial order into an arbitrary total one, because txn edges
    derived from a fabricated order would report anomalies the history
    doesn't actually exhibit. Sources of v1 < v2 evidence on key k:

      * INIT precedes every written value (unconditional);
      * wfr_keys: a txn reads v1 then writes v2 on k;
      * sequential_keys: per-process order of reads/writes of k;
      * linearizable_keys: realtime order — evidence only between ops
        where one COMPLETES before the other INVOKES (concurrent ops
        yield no evidence; using completion order alone would
        over-constrain and manufacture false cyclic-versions).

    Returns ({k: {v: {v'...}}}, cyclic_anomalies)."""
    prec: dict = defaultdict(set)  # k -> set of (v1, v2)

    for op in oks:
        last_read: dict = {}
        for f, k, v in op.value:
            if f == R:
                last_read[k] = v
            elif f == W:
                if wfr_keys and k in last_read and last_read[k] != v:
                    prec[k].add((INIT if last_read[k] is None
                                 else last_read[k], v))
                prec[k].add((INIT, v))

    def track_order(seq_of_ops):
        """Feed per-key observation sequences: consecutive distinct
        observed/written values imply version order (a nil read
        observes the INIT version)."""
        last: dict = {}
        for op in seq_of_ops:
            for f, k, v in op.value:
                if f == R:
                    cur = INIT if v is None else v
                elif f == W:
                    cur = v
                else:
                    continue
                prev = last.get(k)
                if prev is not None and prev != cur:
                    prec[k].add((prev, cur))
                last[k] = cur

    if sequential_keys:
        per_proc: dict = defaultdict(list)
        for op in oks:
            per_proc[op.process].append(op)
        for ops in per_proc.values():
            track_order(ops)
    if linearizable_keys:
        _realtime_evidence(history, prec)

    orders: dict = {}
    cyclic: list = []
    for k, pairs in prec.items():
        adj: dict = defaultdict(set)
        for a, b in pairs:
            adj[a].add(b)
        if _has_cycle(adj):
            cyclic.append({"key": k,
                           "explanation":
                           f"version precedence evidence for key {k!r} "
                           f"is cyclic: {_fmt_pairs(pairs)}"})
        else:
            orders[k] = {a: set(bs) for a, bs in adj.items()}
    return orders, cyclic


def _realtime_evidence(history, prec):
    """Evidence from realtime order: if op A completes strictly before
    op B invokes, A's final observation of k precedes B's first
    observation of k. Sweep by invocation time, remembering the
    latest-completed op's final value per key (an under-approximation
    for overlapping ops — sound, never over-constraining)."""
    pairs = [(inv, comp) for inv, comp in history.pairs()
             if comp is not None and comp.is_ok and comp.value]
    pairs.sort(key=lambda p: p[0].time)
    latest: dict = {}  # k -> (comp_time, final value)
    for inv, comp in pairs:
        first: dict = {}
        final: dict = {}
        for f, k, v in comp.value:
            if f == R:
                cur = INIT if v is None else v
            elif f == W:
                cur = v
            else:
                continue
            first.setdefault(k, cur)
            final[k] = cur
        for k, cur in first.items():
            if k in latest:
                t_prev, v_prev = latest[k]
                if t_prev < inv.time and v_prev != cur:
                    prec[k].add((v_prev, cur))
        for k, cur in final.items():
            if k not in latest or latest[k][0] < comp.time:
                latest[k] = (comp.time, cur)


def _has_cycle(adj) -> bool:
    """DFS cycle check over a {node: successors} graph."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict = defaultdict(int)
    for start in list(adj):
        if color[start] != WHITE:
            continue
        stack = [(start, iter(adj.get(start, ())))]
        color[start] = GRAY
        while stack:
            node, it = stack[-1]
            advanced = False
            for child in it:
                if color[child] == GRAY:
                    return True
                if color[child] == WHITE:
                    color[child] = GRAY
                    stack.append((child, iter(adj.get(child, ()))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
    return False


def _fmt_pairs(pairs):
    return sorted((("nil" if a is INIT else a, b) for a, b in pairs),
                  key=repr)


def _txn_graph(oks, writer, orders):
    """ww/wr/rw edges from the evidence graphs. `orders` maps
    k -> {v: direct evidenced successors of v}."""
    g = DepGraph()
    for op in oks:
        g.add_node(op.index)

    # ww: directly-evidenced version adjacency
    for k, succ in orders.items():
        for v1, nxts in succ.items():
            for v2 in nxts:
                w1, w2 = writer.get((k, v1)), writer.get((k, v2))
                if w1 is not None and w2 is not None:
                    g.add_edge(w1, w2, WW,
                               {"key": k, "value": v1, "next_value": v2})

    # wr + rw from external reads
    from ..txn import ext_reads
    for op in oks:
        for k, v in ext_reads(op.value).items():
            if v is not None:
                w = writer.get((k, v))
                if w is not None:
                    g.add_edge(w, op.index, WR, {"key": k, "value": v})
            succ = orders.get(k)
            if not succ:
                continue
            cur = v if v is not None else INIT
            for nxt in succ.get(cur, ()):
                w = writer.get((k, nxt))
                if w is not None:
                    g.add_edge(op.index, w, RW,
                               {"key": k, "observed": v,
                                "next_value": nxt})
    return g


def _cycle_case(g: DepGraph, cycle: list) -> dict:
    steps = g.explain_cycle(cycle)
    lines = []
    for s in steps:
        det = s["detail"] or {}
        if s["type"] == "ww":
            lines.append(f"T{s['from']} wrote {det.get('value')!r} to key "
                         f"{det.get('key')!r} before T{s['to']} wrote "
                         f"{det.get('next_value')!r}")
        elif s["type"] == "wr":
            lines.append(f"T{s['to']} read value {det.get('value')!r} of "
                         f"key {det.get('key')!r} written by T{s['from']}")
        elif s["type"] == "rw":
            lines.append(f"T{s['from']} observed {det.get('observed')!r} "
                         f"of key {det.get('key')!r} before T{s['to']} "
                         f"wrote {det.get('next_value')!r}")
        else:
            lines.append(f"T{s['from']} -> T{s['to']} ({s['type']})")
    return {"cycle": cycle, "steps": steps, "explanation": "; ".join(lines)}


# -- generator ---------------------------------------------------------------

class WrGen(AppendGen):
    """Register txn generator: identical key-pool behavior to
    AppendGen, but emits plain unique writes (rw-register's core
    assumption) instead of appends."""

    write_f = W
