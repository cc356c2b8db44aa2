"""List-append anomaly detection (a copy of `jepsen_tpu/elle/append.py`
whose cycle search runs on the port's kernels, behind the preflight
gate; the telemetry records are not ported yet).

Histories of transactions over named lists, where each mop either
appends a unique value to a key's list or reads the key's whole list:

    {"type": "ok", "f": "txn",
     "value": [["append", 3, 2], ["r", 3, [1, 2]]]}

Because appends are unique and reads return *whole* lists, each read is
a trace of the key's version history: the observed list IS the order in
which appends committed. That recoverability is what makes list-append
the strongest workload in the reference's arsenal (wrapped at
`jepsen/src/jepsen/tests/cycle/append.clj:11-55`; the engine is the
external Elle library, re-implemented here from its semantics).

Pipeline:
  1. validate reads (duplicates, incompatible prefixes) and recover each
     key's version order (the longest observed prefix chain);
  2. direct anomalies: internal (txn vs its own prior ops), G1a (read of
     a failed txn's append), G1b (read of an intermediate append),
     dirty-update (failed append observed in version order);
  3. dependency graph: ww (consecutive appends in version order), wr
     (append observed as the read's last element), rw (read's
     last-observed element -> writer of the next version), plus optional
     realtime/process graphs;
  4. cycle classification over the typed graph: G0 (ww only), G1c
     (ww+wr), G-single (exactly one rw), G2 (>=1 rw).
"""

from __future__ import annotations

import random
import time as _time
from typing import Any, Iterable, Optional

from ..history import History
from ..txn import APPEND, R
from .graph import RW, WR, WW, DepGraph, process_graph, realtime_graph

# anomaly -> weakest consistency model it violates (Elle's :not field)
MODEL_VIOLATIONS = {
    "G0": "read-uncommitted",
    "G1a": "read-committed",
    "G1b": "read-committed",
    "G1c": "read-committed",
    "G-single": "consistent-view",
    "G2": "serializable",
    "internal": "read-atomic",
    "dirty-update": "read-committed",
    "duplicate-elements": "serializable",
    "incompatible-order": "serializable",
    "cyclic-versions": "read-uncommitted",
}

DEFAULT_ANOMALIES = ("G0", "G1a", "G1b", "G1c", "G-single", "G2",
                     "internal", "dirty-update", "duplicate-elements",
                     "incompatible-order")


def check(history: History, anomalies: Iterable[str] = DEFAULT_ANOMALIES,
          additional_graphs: Iterable[str] = (),
          cycle_backend: str = "auto", device=None, devices=None) -> dict:
    """Analyze a list-append history. Returns
    {"valid?": bool, "anomaly-types": [...], "anomalies": {...},
    "not": [violated models]}.

    cycle_backend: "host" (Tarjan oracle), "cuda" / "packed" / "trim"
    / "sharded" / "device" (the elle/tpu.py kernel family), or "auto"
    (shape-routed via ops/route.elle_cycle_route). `device` is where
    the kernels run: None is the first of `devices`, else the CUDA
    card (raises without one), "cpu" runs their plain PyTorch versions;
    `devices` is the sharded closure's device list (None: every card;
    it may repeat a device). The host backend needs neither."""
    from ..analysis import history_lint
    t_start = _time.monotonic()
    bad = history_lint.gate(history, where="elle.append",
                            rules=history_lint.ELLE_GATE_RULES)
    if bad is not None:
        # malformed input: version-order inference over a corrupted
        # event order would fabricate anomalies — fast-fail instead
        return {"valid?": "unknown",
                "anomaly-types": ["malformed-history"],
                "anomalies": {"malformed-history": bad["anomalies"]},
                "not": [], "analyzer": bad["analyzer"]}
    anomalies = set(anomalies)
    found: dict[str, list] = {}
    for name in additional_graphs:
        if name not in ("realtime", "process"):
            raise ValueError(f"unknown additional graph {name!r}")

    completed = [op for op in history
                 if op.type in ("ok", "info") and op.f in ("txn", None)
                 and op.value]
    oks = [op for op in completed if op.is_ok]
    infos = [op for op in completed if op.is_info]
    failed = [op for op in history if op.is_fail and op.value]

    # Admission preflight (analysis/preflight): a device closure that can
    # never fit (P001/P002, e.g. a forced cycle_backend="packed" past its
    # capacity) is rejected here, before the graph build, any kernel
    # build or any device byte.
    if cycle_backend != "host":
        bad_pf = preflight_gate(len(completed), cycle_backend,
                                "elle.append", device, devices)
        if bad_pf is not None:
            return bad_pf

    # -- 1. tensorized construction (elle/build.py): writer index,
    #    version orders, and the ww/wr/rw(+rt/proc) edge columns come
    #    out of one vectorized pass; dirty histories fall back to the
    #    exact host loops inside the builder ---------------------------
    from . import build as build_mod
    try:
        bt = build_mod.build_append(history, oks, infos,
                                    additional_graphs=additional_graphs)
        writer, orders = bt.writer, bt.orders
        dup_anoms, order_anoms = bt.dup_anomalies, bt.order_anomalies
        gt = bt.tensors
        gt._explain = lambda: _legacy_graph(history, orders, writer,
                                            oks, additional_graphs)
        _record_build("append", bt)
    except build_mod.BuildUnsupported:
        writer, dup_anoms = _writer_index(oks, infos)
        orders, order_anoms = _version_orders(oks)
        gt = _legacy_graph(history, orders, writer, oks,
                           additional_graphs)
    if dup_anoms:
        found["duplicate-elements"] = dup_anoms
    if order_anoms:
        found["incompatible-order"] = order_anoms

    # -- 2. direct anomalies ---------------------------------------------
    internal = _internal_cases(oks)
    if internal:
        found["internal"] = internal
    g1a = _g1a_cases(oks, failed)
    if g1a:
        found["G1a"] = g1a
    g1b = _g1b_cases(oks)
    if g1b:
        found["G1b"] = g1b
    dirty = _dirty_update_cases(orders, writer)
    if dirty:
        found["dirty-update"] = dirty

    # -- 3+4. cycles over the edge columns -------------------------------
    from .tpu import standard_cycle_search
    cycles = standard_cycle_search(gt, backend=cycle_backend,
                                   device=device, devices=devices)
    g = None  # the labeled DepGraph materializes only to EXPLAIN
    if any(cycles[q] for q in ("G0", "G1c", "G-single", "G2")):
        g = gt.to_depgraph() if hasattr(gt, "to_depgraph") else gt
    if cycles["G0"]:
        found["G0"] = [_cycle_case(g, cycles["G0"], history)]
    if cycles["G1c"] and "G0" not in found:
        found["G1c"] = [_cycle_case(g, cycles["G1c"], history)]
    if cycles["G-single"]:
        found["G-single"] = [_cycle_case(g, cycles["G-single"], history)]
    if cycles["G2"] and "G-single" not in found:
        found["G2"] = [_cycle_case(g, cycles["G2"], history)]

    reported = {k: v for k, v in found.items() if k in anomalies}
    # anomalies outside the requested set still make the result unknown
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
    _record_elle("elle.append", out, len(oks), _time.monotonic() - t_start)
    return out


def _record_build(checker: str, bt) -> None:
    """The `elle_build` series (metrics on): one point a tensorized
    graph build, the reference's fields."""
    from .. import metrics as _metrics
    mx = _metrics.get_default()
    if not mx.enabled:
        return
    mx.series("elle_build", "tensorized elle graph construction").append(
        {"checker": checker, "txns": int(len(bt.tensors.nodes)),
         "mops": int(bt.micro_ops), "edges": len(bt.tensors),
         "edge_counts": bt.tensors.counts(),
         "build_s": round(bt.tensors.build_s, 4), "builder": bt.builder})


def _record_elle(name: str, out: dict, op_count: int,
                 wall_s: float) -> None:
    """One check's run record, the fields the reference banks as a
    kind="elle" record of its run ledger (verdict, anomaly types as the
    cause, ops, cycle engine and kernel, kernel and check seconds). The
    port has no run ledger yet: with metrics on, the record is a point
    of the `elle` series."""
    from .. import metrics as _metrics
    mx = _metrics.get_default()
    if not mx.enabled:
        return
    util = out.get("cycle-util") or {}
    mx.series("elle", "per-check Elle run records").append(
        {"kind": "elle", "name": name, "valid?": out.get("valid?"),
         "cause": ",".join(out.get("anomaly-types") or []) or None,
         "op_count": int(op_count), "engine": out.get("cycle-engine"),
         "kernel": util.get("kernel"), "kernel_s": util.get("kernel_s"),
         "wall_s": round(wall_s, 4)})


def preflight_gate(n_txns: int, backend: str, where: str, device,
                   devices) -> Optional[dict]:
    """The Elle admission gate (`preflight.gate_elle`) over the devices
    the check would run on (`devices`, else `device`, else every card),
    as the checker's result: None when admitted, else the reference's
    `anomaly-types == ["preflight"]` answer. Devices that cannot be
    resolved (no card) are the engines' error to raise: it admits."""
    from ..analysis import preflight
    from ..util import resolve_devices

    try:
        devs = resolve_devices(devices, device)
    except RuntimeError:
        return None
    bad = preflight.gate_elle(n_txns, backend=backend, where=where,
                              devices=devs)
    if bad is None:
        return None
    return {"valid?": "unknown", "anomaly-types": ["preflight"],
            "anomalies": {"preflight": [bad["preflight"]]},
            "not": [], "preflight": bad["preflight"]}


def _legacy_graph(history, orders, writer, oks, additional_graphs):
    """The host-builder graph: the oracle/explanation side of the
    tensorized pass, and the whole pipeline when tensorization is
    unsupported."""
    g = graph(history, orders=orders, writer=writer, oks=oks)
    for name in additional_graphs:
        if name == "realtime":
            g.merge(realtime_graph(history))
        elif name == "process":
            g.merge(process_graph(history))
    return g


def graph(history: History, orders: Optional[dict] = None,
          writer: Optional[dict] = None,
          oks: Optional[list] = None) -> DepGraph:
    """The ww/wr/rw dependency graph of a list-append history."""
    if oks is None:
        oks = [op for op in history
               if op.is_ok and op.f in ("txn", None) and op.value]
    if writer is None:
        writer, _ = _writer_index(oks, [])
    if orders is None:
        orders, _ = _version_orders(oks)

    g = DepGraph()
    for op in oks:
        g.add_node(op.index)

    # ww: consecutive appends in each key's version order
    for k, order in orders.items():
        for v1, v2 in zip(order, order[1:]):
            w1, w2 = writer.get((k, v1)), writer.get((k, v2))
            if w1 is not None and w2 is not None:
                g.add_edge(w1, w2, WW,
                           {"key": k, "value": v1, "next_value": v2})

    # wr and rw from each external read
    for op in oks:
        own_appends = {(k, v) for f, k, v in op.value if f == APPEND}
        for f, k, v in op.value:
            if f != R or v is None:
                continue
            observed = [x for x in v if (k, x) not in own_appends]
            if observed:
                last = observed[-1]
                w = writer.get((k, last))
                if w is not None:
                    g.add_edge(w, op.index, WR,
                               {"key": k, "value": last})
            # rw: the next version after what we observed
            order = orders.get(k, [])
            prefix_len = len(v)
            if prefix_len < len(order):
                nxt = order[prefix_len]
                w = writer.get((k, nxt))
                if w is not None:
                    g.add_edge(op.index, w, RW,
                               {"key": k, "observed": list(v),
                                "next_value": nxt})
    return g


# -- internals ---------------------------------------------------------------

def _writer_index(oks, infos):
    """(k, v) -> writer op index over ok + info appends (info writes MAY
    have happened, so they participate in the graph), plus
    duplicate-append anomalies."""
    writer: dict = {}
    dups: list = []
    for op in list(oks) + list(infos):
        for f, k, v in op.value or []:
            if f != APPEND:
                continue
            if (k, v) in writer and writer[(k, v)] != op.index:
                dups.append({"key": k, "value": v,
                             "writers": [writer[(k, v)], op.index],
                             "explanation":
                             f"value {v!r} appended to key {k!r} by "
                             f"two different transactions"})
            writer[(k, v)] = op.index
    return writer, dups


def _version_orders(oks):
    """key -> list of values in version order, from observed reads.
    Every read must be a prefix of the longest read; mismatches are
    incompatible-order anomalies."""
    longest: dict = {}
    anoms: list = []
    for op in oks:
        for f, k, v in op.value:
            if f != R or v is None:
                continue
            cur = longest.get(k, [])
            short, long_ = (v, cur) if len(v) <= len(cur) else (cur, v)
            if list(short) != list(long_[:len(short)]):
                anoms.append({"key": k, "a": list(cur), "b": list(v),
                              "explanation":
                              f"reads of key {k!r} observed "
                              f"incompatible orders {cur!r} and {v!r}"})
            elif len(v) > len(cur):
                longest[k] = list(v)
    return longest, anoms


def _internal_cases(oks):
    """Reads inconsistent with the txn's own prior mops
    (read-atomic violations within a single txn)."""
    cases = []
    for op in oks:
        # expected[k] = (base_list_or_None, own_appends)
        state: dict = {}
        for mi, (f, k, v) in enumerate(op.value):
            if f == APPEND:
                base, own = state.get(k, (None, []))
                state[k] = (base, own + [v])
            elif f == R and v is not None:
                base, own = state.get(k, (None, []))
                if base is None and not own:
                    state[k] = (list(v), [])
                    continue
                if base is None:
                    # first read after own appends: list must end with
                    # exactly our appends, in order
                    if list(v[len(v) - len(own):]) != own:
                        cases.append(_internal_case(op, mi, k, v, own))
                    else:
                        state[k] = (list(v[:len(v) - len(own)]), own)
                else:
                    if list(v) != base + own:
                        cases.append(_internal_case(op, mi, k, v,
                                                    base + own))
    return cases


def _internal_case(op, mi, k, v, expected):
    return {"op-index": op.index, "mop-index": mi, "key": k,
            "observed": list(v), "expected": list(expected),
            "explanation":
            f"txn at index {op.index} read {list(v)!r} from key {k!r}, "
            f"inconsistent with its own prior operations "
            f"(expected suffix/state {expected!r})"}


def _g1a_cases(oks, failed):
    """Reads observing a value appended by a *failed* txn."""
    failed_writes = {}
    for op in failed:
        for f, k, v in op.value or []:
            if f == APPEND:
                failed_writes[(k, v)] = op.index
    cases = []
    for op in oks:
        for f, k, v in op.value:
            if f != R or v is None:
                continue
            for x in v:
                if (k, x) in failed_writes:
                    cases.append({
                        "op-index": op.index, "key": k, "value": x,
                        "writer-index": failed_writes[(k, x)],
                        "explanation":
                        f"txn at index {op.index} observed value {x!r} "
                        f"of key {k!r}, which was appended by FAILED "
                        f"txn at index {failed_writes[(k, x)]}"})
    return cases


def _g1b_cases(oks):
    """Reads whose final element is an *intermediate* append: the
    writer went on to append more to that key in the same txn."""
    from ..txn import int_write_mops
    # (k, v) -> writer index when v is a non-final append of its txn
    intermediate = {}
    for op in oks:
        for k, mops in int_write_mops(op.value).items():
            for m in mops:
                intermediate[(k, m[2])] = op.index
    cases = []
    for op in oks:
        own = {(k, v) for f, k, v in op.value if f == APPEND}
        for f, k, v in op.value:
            if f != R or not v:
                continue
            last = v[-1]
            if (k, last) in intermediate and (k, last) not in own \
                    and intermediate[(k, last)] != op.index:
                cases.append({
                    "op-index": op.index, "key": k, "value": last,
                    "writer-index": intermediate[(k, last)],
                    "explanation":
                    f"txn at index {op.index} read key {k!r} up to "
                    f"value {last!r}, an intermediate append of txn "
                    f"at index {intermediate[(k, last)]}"})
    return cases


def _dirty_update_cases(orders, writer):
    """A failed/aborted append that nonetheless shows up in the middle
    of a version order was 'resurrected' by later committed appends.
    (With the writer index built from ok+info ops only, a version-order
    element with no writer is a failed write that readers observed.)"""
    # G1a already reports observed-failed-values; dirty-update in Elle
    # is about a committed write overwriting an aborted one. For
    # list-append, every later append "overwrites" (extends) earlier
    # ones, so any failed append INSIDE a version order qualifies.
    cases = []
    for k, order in orders.items():
        for i, v in enumerate(order[:-1]):  # not the last: must be built on
            if (k, v) not in writer:
                cases.append({
                    "key": k, "value": v, "position": i,
                    "explanation":
                    f"key {k!r} version order contains value {v!r} with "
                    f"no committed writer, yet later appends built on "
                    f"top of it"})
    return cases


def _cycle_case(g: DepGraph, cycle: list, history: History) -> dict:
    steps = g.explain_cycle(cycle)
    lines = []
    for s in steps:
        det = s["detail"] or {}
        if s["type"] == "ww":
            lines.append(f"T{s['from']} appended {det.get('value')!r} to "
                         f"key {det.get('key')!r} before T{s['to']} "
                         f"appended {det.get('next_value')!r}")
        elif s["type"] == "wr":
            lines.append(f"T{s['to']} read value {det.get('value')!r} of "
                         f"key {det.get('key')!r} appended by "
                         f"T{s['from']}")
        elif s["type"] == "rw":
            lines.append(f"T{s['from']} observed key {det.get('key')!r} "
                         f"as {det.get('observed')!r} before T{s['to']} "
                         f"appended {det.get('next_value')!r}")
        else:
            lines.append(f"T{s['from']} -> T{s['to']} ({s['type']})")
    return {"cycle": cycle, "steps": steps, "explanation": "; ".join(lines)}


# -- generator ---------------------------------------------------------------

class AppendGen:
    """Generates list-append transactions (elle.list-append/gen
    semantics, exposed at tests/cycle/append.clj:28-31): a rotating pool
    of active keys, unique monotonically increasing write values per
    key, keys retired after max_writes_per_key writes. The write mop
    tag is parameterizable so the rw-register generator (unique plain
    writes) shares the exact same key-pool behavior."""

    write_f = APPEND

    def __init__(self, key_count: int = 3, min_txn_length: int = 1,
                 max_txn_length: int = 4, max_writes_per_key: int = 32,
                 seed: Optional[int] = None):
        self.key_count = key_count
        self.min_len = min_txn_length
        self.max_len = max_txn_length
        self.max_writes = max_writes_per_key
        self.rng = random.Random(seed)
        self.next_key = key_count
        self.active = list(range(key_count))
        self.writes: dict = {k: 0 for k in self.active}

    def txn(self) -> list:
        n = self.rng.randint(self.min_len, self.max_len)
        out = []
        for _ in range(n):
            k = self.rng.choice(self.active)
            if self.rng.random() < 0.5:
                out.append([R, k, None])
            else:
                self.writes[k] += 1
                out.append([self.write_f, k, self.writes[k]])
                if self.writes[k] >= self.max_writes:
                    self.active.remove(k)
                    self.active.append(self.next_key)
                    self.writes[self.next_key] = 0
                    self.next_key += 1
        return out

    def __call__(self, test, ctx):
        """As a function generator for the DSL: emits txn invocations
        forever."""
        return {"f": "txn", "value": self.txn()}
