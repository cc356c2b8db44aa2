"""Tensorized Elle graph construction: history -> edge columns (a copy
of `jepsen_tpu/elle/build.py`, host numpy).

The host builders in `append.py` / `wr.py` / `graph.py` walk txn
micro-ops with Python dict loops — fine for correctness (they remain
the oracle and the explanation path), but they put an O(ops x mops x
read-list) interpreter bill in front of every cycle search. This
module re-derives the SAME graphs as flat numpy columns, following the
`ops/encode.py` idiom (host-side encode, fixed dtype columns, interned
alphabets):

  encode     every micro-op becomes rows in struct-of-arrays form:
             append/write rows (txn, key, value), read rows (txn, key,
             length), read-ELEMENT rows (read, position, value) — list
             reads explode into one row per observed element, which is
             what makes version-order checks vectorizable.
  intern     keys and (key, value) pairs get dense int32 ids
             (`_hashable` from ops/encode.py); the id->object table
             reconstructs the dict forms the host anomaly passes use.
  derive     writer index, version orders, and the ww/wr/rw edge lists
             come out of sorts/segment ops over those columns; the
             realtime sweep in graph.realtime_graph collapses into a
             frontier-interval formula (see `realtime_arrays`) and the
             process graph into one lexsort.

Parity contract: for every history the derived `(E, 3)` edge columns
equal the host DepGraph's edge set exactly (same dedup, same dropped
self-edges), and the writer/orders dicts reconstruct to the same
values — tests/test_elle_build.py holds both, including aborted/info
txns and G1a/G1b corpora. Order-dependent anomaly *payloads*
(duplicate-elements, incompatible-order) are the one place vectorized
re-derivation would drift, so dirty histories take the exact host loop
for those passes (`builder: "host-fallback"` in telemetry); the clean
common case never does.

The product, `GraphTensors`, is what the device cycle engines consume
directly — nodes, edge columns, and the analytic interval metadata
(`inv_evt`/`comp_evt` event positions, process chain positions) that
lets the propagation kernel apply realtime/process reachability as
O(N) interval jumps instead of materialized O(N^2) edges. No DepGraph
is built on the hot path; `to_depgraph()` re-runs the host builders
lazily for the host engine and for cycle explanations ("device
decides, host explains").
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..txn import APPEND, R, W
from ..history import History
from ..ops.encode import _hashable
from .graph import PROCESS, REALTIME, RW, WR, WW, DepGraph

_BIG = np.int64(2**62)


class BuildUnsupported(Exception):
    """The history cannot be tensorized (e.g. ops without comparable
    times); callers fall back to the host builders."""


class Interner:
    """Hashable objects -> dense int32 ids, with the inverse table."""

    def __init__(self):
        self._ids: dict = {}
        self.objects: list = []

    def add(self, obj) -> int:
        key = _hashable(obj)
        i = self._ids.get(key)
        if i is None:
            i = len(self.objects)
            self._ids[key] = i
            self.objects.append(obj)
        return i

    def get(self, obj) -> Optional[int]:
        return self._ids.get(_hashable(obj))

    def __len__(self) -> int:
        return len(self.objects)


@dataclass
class GraphTensors:
    """A typed txn digraph in the columnar layout the device cycle
    engines consume, plus the interval metadata for analytic
    realtime/process jumps. Node references in `edges` are HISTORY
    indices, like DepGraph's."""

    nodes: np.ndarray                 # (T,) int32 sorted history indices
    edges: np.ndarray                 # (E, 3) int32 (src, dst, typ)
    # analytic-jump metadata, aligned with `nodes` (local ids):
    inv_evt: Optional[np.ndarray] = None   # (T,) int64; -_BIG absent
    comp_evt: Optional[np.ndarray] = None  # (T,) int64; +_BIG absent
    proc: Optional[np.ndarray] = None      # (T,) int32; -1 absent
    proc_pos: Optional[np.ndarray] = None  # (T,) int32; -1 absent
    # True when every REALTIME/PROCESS edge in `edges` is exactly the
    # reduced form of the interval relations above, so a closure
    # engine may replace those edges with interval jumps:
    analytic: bool = False
    build_s: float = 0.0
    builder: str = "tensor"           # "tensor" | "host-fallback"
    _explain: Optional[Callable[[], DepGraph]] = None
    _dep: Optional[DepGraph] = field(default=None, repr=False)

    def __len__(self) -> int:
        return int(self.edges.shape[0])

    def counts(self) -> dict:
        typ = self.edges[:, 2]
        from .graph import EDGE_NAMES
        return {EDGE_NAMES[t]: int(np.sum(typ == t))
                for t in np.unique(typ)} if len(typ) else {}

    def to_depgraph(self) -> DepGraph:
        """The labeled host DepGraph — built lazily by re-running the
        host builders (the explanation/oracle path), cached."""
        if self._dep is None:
            if self._explain is not None:
                self._dep = self._explain()
            else:
                g = DepGraph()
                for n in self.nodes:
                    g.add_node(int(n))
                for s, d, t in self.edges:
                    g.add_edge(int(s), int(d), int(t))
                self._dep = g
        return self._dep


def _dedup_edges(parts: list) -> np.ndarray:
    """Concatenate (E_i, 3) parts, drop self-edges, dedup rows —
    DepGraph.add_edge semantics as one unique() call."""
    parts = [np.asarray(p, np.int32).reshape(-1, 3) for p in parts
             if p is not None and len(p)]
    if not parts:
        return np.zeros((0, 3), np.int32)
    e = np.concatenate(parts, axis=0)
    e = e[e[:, 0] != e[:, 1]]
    if not len(e):
        return e
    return np.unique(e, axis=0)


def _times_ok(ops) -> bool:
    return all(isinstance(op.time, int) for op in ops)


# -- realtime / process graphs, vectorized -----------------------------------

def realtime_arrays(history: History):
    """The reduced realtime graph of graph.realtime_graph, derived
    without the sweep.

    Event positions order all invocations/completions exactly as the
    host sweep does (time, completions-first, stable). An op A sits in
    the frontier for the event interval (comp_evt(A), s(A)) where
      s(A) = min{ comp_evt(B) : inv_evt(B) > comp_evt(A) }
    — the first completion of an op invoked after A completed is what
    supersedes A. D's predecessors are then exactly the A with
    comp_evt(A) < inv_evt(D) < s(A): one searchsorted range per A,
    expanded into edge rows. Transitive closure of these reduced edges
    equals the full interval relation comp_evt(A) < inv_evt(B), which
    is what the analytic jump in the propagation kernel applies.

    Returns (idx (P,) i32, inv_evt (P,) i64, comp_evt (P,) i64,
    edges (E, 2) i32) over the ok-completed pairs."""
    pairs = [(inv, comp) for inv, comp in history.pairs()
             if comp is not None and comp.is_ok]
    P = len(pairs)
    if P == 0:
        z = np.zeros(0, np.int64)
        return (np.zeros(0, np.int32), z, z,
                np.zeros((0, 2), np.int32))
    if not _times_ok([p[0] for p in pairs] + [p[1] for p in pairs]):
        raise BuildUnsupported("non-integer op times")
    idx = np.asarray([c.index for _i, c in pairs], np.int32)
    inv_t = np.asarray([i.time for i, _c in pairs], np.int64)
    comp_t = np.asarray([c.time for _i, c in pairs], np.int64)

    # event positions: primary time, completions (kind 0) before
    # invocations (kind 1) at equal times, stable in pair order —
    # the host sweep's exact sort key
    ev_time = np.concatenate([inv_t, comp_t])
    ev_kind = np.concatenate([np.ones(P, np.int8), np.zeros(P, np.int8)])
    order = np.lexsort((ev_kind, ev_time))  # stable: ties by position
    pos = np.empty(2 * P, np.int64)
    pos[order] = np.arange(2 * P)
    inv_evt, comp_evt = pos[:P], pos[P:]

    # s(A) = min{comp_evt(B) : inv_evt(B) > comp_evt(A)} over ops
    # that CAN supersede: in the sweep, removal applies preds_of[B]
    # (the frontier snapshot at B's invocation) at B's COMPLETION —
    # an op whose completion event precedes its own invocation (a
    # zero-duration op; completions sort first at equal times) has an
    # empty snapshot when it completes and removes nothing, itself
    # included. So only ops with inv_evt < comp_evt supersede.
    normal = inv_evt < comp_evt
    inv_n = inv_evt[normal]
    comp_n = comp_evt[normal]
    by_inv_n = np.argsort(inv_n, kind="stable")
    inv_n_sorted = inv_n[by_inv_n]
    comp_by_inv = comp_n[by_inv_n]
    Pn = len(inv_n)
    sufmin = np.full(Pn + 1, _BIG, np.int64)
    if Pn:
        sufmin[:Pn] = np.minimum.accumulate(comp_by_inv[::-1])[::-1]
    s_a = sufmin[np.searchsorted(inv_n_sorted, comp_evt,
                                 side="right")]

    # D's with inv_evt in (comp_evt(A), s(A)): a range per A over ALL
    # ops (zero-duration ops still receive predecessor edges)
    by_inv = np.argsort(inv_evt, kind="stable")
    inv_sorted = inv_evt[by_inv]
    lo = np.searchsorted(inv_sorted, comp_evt, side="right")
    hi = np.searchsorted(inv_sorted, s_a, side="left")
    counts = np.maximum(hi - lo, 0)
    total = int(counts.sum())
    if total == 0:
        return idx, inv_evt, comp_evt, np.zeros((0, 2), np.int32)
    src_rep = np.repeat(np.arange(P), counts)
    offs = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    dst_rank = np.repeat(lo, counts) + offs
    dst_rep = by_inv[dst_rank]
    keep = src_rep != dst_rep
    edges = np.stack([idx[src_rep[keep]], idx[dst_rep[keep]]], axis=1)
    return idx, inv_evt, comp_evt, edges.astype(np.int32)


def process_arrays(history: History):
    """graph.process_graph as columns: per-process chains of
    ok-completed ops in pairs order. Returns (idx (P,) i32,
    proc_id (P,) i32, chain_pos (P,) i32, edges (E, 2) i32)."""
    rows = [(inv.process, comp.index) for inv, comp in history.pairs()
            if comp is not None and comp.is_ok]
    P = len(rows)
    if P == 0:
        z = np.zeros(0, np.int32)
        return z, z, z, np.zeros((0, 2), np.int32)
    procs = Interner()
    pid = np.asarray([procs.add(p) for p, _ in rows], np.int32)
    idx = np.asarray([i for _, i in rows], np.int32)
    order = np.lexsort((np.arange(P), pid))  # stable within process
    pid_s, idx_s = pid[order], idx[order]
    same = np.flatnonzero(pid_s[1:] == pid_s[:-1]) + 1
    edges = np.stack([idx_s[same - 1], idx_s[same]], axis=1)
    # chain position within each process run
    is_start = np.ones(P, bool)
    is_start[same] = False
    run_start = np.maximum.accumulate(np.where(is_start,
                                               np.arange(P), -1))
    pos_s = (np.arange(P) - run_start).astype(np.int32)
    pos = np.empty(P, np.int32)
    pos[order] = pos_s
    return idx, pid, pos, edges.astype(np.int32)


# -- append -------------------------------------------------------------------

@dataclass
class AppendBuild:
    """Everything append.check needs from the tensorized pass."""

    tensors: GraphTensors
    writer: dict                      # (k, v) -> writer history index
    orders: dict                      # k -> [values in version order]
    dup_anomalies: list
    order_anomalies: list
    micro_ops: int
    builder: str


def _encode_append(oks, infos):
    """Flat micro-op columns for append histories."""
    keys, kvs = Interner(), Interner()
    # append rows over oks then infos (writer-index order)
    a_txn, a_kv = [], []
    # read rows / read-element rows over oks only
    r_txn, r_key, r_len = [], [], []
    e_rid, e_pos, e_kv = [], [], []
    own_t, own_kv = [], []            # per-txn append set rows (oks)
    for group, is_ok in ((oks, True), (infos, False)):
        for op in group:
            for f, k, v in op.value or []:
                if f == APPEND:
                    a_txn.append(op.index)
                    a_kv.append(kvs.add((k, v)))
                    if is_ok:
                        own_t.append(op.index)
                        own_kv.append(a_kv[-1])
                elif is_ok and f == R and v is not None:
                    rid = len(r_txn)
                    r_txn.append(op.index)
                    r_key.append(keys.add(k))
                    r_len.append(len(v))
                    for p, x in enumerate(v):
                        e_rid.append(rid)
                        e_pos.append(p)
                        e_kv.append(kvs.add((k, x)))
    cols = {
        "a_txn": np.asarray(a_txn, np.int64),
        "a_kv": np.asarray(a_kv, np.int64),
        "r_txn": np.asarray(r_txn, np.int64),
        "r_key": np.asarray(r_key, np.int64),
        "r_len": np.asarray(r_len, np.int64),
        "e_rid": np.asarray(e_rid, np.int64),
        "e_pos": np.asarray(e_pos, np.int64),
        "e_kv": np.asarray(e_kv, np.int64),
        "own_t": np.asarray(own_t, np.int64),
        "own_kv": np.asarray(own_kv, np.int64),
    }
    return keys, kvs, cols


def _writer_from_rows(a_txn, a_kv, n_kv):
    """Last-assignment-wins writer array (kv id -> history index, -1
    none) plus per-kv distinct-writer count for dup detection."""
    writer = np.full(n_kv, -1, np.int64)
    if len(a_kv):
        # reversed unique keeps the LAST occurrence per kv
        _u, first = np.unique(a_kv[::-1], return_index=True)
        writer[_u] = a_txn[::-1][first]
        # dup check: same kv appended by more than one txn
        u_pairs = np.unique(np.stack([a_kv, a_txn], axis=1), axis=0)
        dup_mask = np.bincount(u_pairs[:, 0], minlength=n_kv) > 1
    else:
        dup_mask = np.zeros(n_kv, bool)
    return writer, dup_mask


def build_append(history: History, oks: list, infos: list,
                 additional_graphs=()) -> AppendBuild:
    """Tensorized equivalent of append._writer_index +
    append._version_orders + append.graph (+ additional graphs)."""
    t0 = _time.monotonic()
    keys, kvs, c = _encode_append(oks, infos)
    n_kv = len(kvs)
    builder = "tensor"

    writer_arr, dup_mask = _writer_from_rows(c["a_txn"], c["a_kv"], n_kv)
    from .append import _version_orders, _writer_index
    if dup_mask.any():
        # exact host payloads for the order-dependent anomaly lists
        writer, dups = _writer_index(oks, infos)
        builder = "host-fallback"
    else:
        writer = {_kv_key(kvs, i): int(writer_arr[i])
                  for i in range(n_kv) if writer_arr[i] >= 0}
        dups = []

    # version orders: clean iff every (key, position) sees one value
    orders_flat = None
    if len(c["e_rid"]):
        e_key = c["r_key"][c["e_rid"]]
        kp = e_key * (int(c["e_pos"].max()) + 2) + c["e_pos"]
        # clean iff one distinct kv per (key, position)
        u_kp = np.unique(kp)
        pair = np.unique(np.stack([kp, c["e_kv"]], axis=1), axis=0)
        per_kp = np.bincount(np.searchsorted(u_kp, pair[:, 0]),
                             minlength=len(u_kp))
        clean = bool((per_kp <= 1).all())
    else:
        clean = True
    if clean:
        orders, order_anoms = _orders_vectorized(keys, kvs, c)
    else:
        orders, order_anoms = _version_orders(oks)
        builder = "host-fallback"

    edges = _append_edges(keys, kvs, c, writer_arr, orders)

    parts = [edges]
    nodes = {int(op.index) for op in oks}
    if "realtime" in additional_graphs:
        ridx, rinv, rcomp, redges = realtime_arrays(history)
        if len(redges):
            parts.append(np.concatenate(
                [redges, np.full((len(redges), 1), REALTIME, np.int32)],
                axis=1))
        nodes |= {int(i) for i in np.unique(redges)} if len(redges) \
            else set()
    else:
        ridx = rinv = rcomp = None
    if "process" in additional_graphs:
        pidx, ppid, pp, pedges = process_arrays(history)
        if len(pedges):
            parts.append(np.concatenate(
                [pedges, np.full((len(pedges), 1), PROCESS, np.int32)],
                axis=1))
        nodes |= {int(i) for i in np.unique(pedges)} if len(pedges) \
            else set()
    else:
        pidx = ppid = pp = None

    all_edges = _dedup_edges(parts)
    node_arr = np.asarray(sorted(nodes | {int(x) for x in
                                          np.unique(all_edges[:, :2])}
                                 if len(all_edges) else nodes),
                          np.int32)
    inv_evt, comp_evt, proc, ppos = _jump_meta(
        node_arr, ridx, rinv, rcomp, pidx, ppid, pp)
    gt = GraphTensors(nodes=node_arr, edges=all_edges,
                      inv_evt=inv_evt, comp_evt=comp_evt,
                      proc=proc, proc_pos=ppos, analytic=True,
                      builder=builder,
                      build_s=_time.monotonic() - t0)
    return AppendBuild(tensors=gt, writer=writer, orders=orders,
                       dup_anomalies=dups, order_anomalies=order_anoms,
                       micro_ops=int(len(c["a_txn"]) + len(c["e_rid"])
                                     + len(c["r_txn"])),
                       builder=builder)


def _kv_key(kvs: Interner, i: int):
    k, v = kvs.objects[i]
    return (k, v)


def _orders_vectorized(keys, kvs, c):
    """Clean-path version orders: the longest read per key IS the
    order (all reads are prefixes of it — the clean check holds)."""
    orders: dict = {}
    if not len(c["r_txn"]):
        return orders, []
    # earliest read achieving the per-key max length
    r_key, r_len = c["r_key"], c["r_len"]
    order = np.lexsort((np.arange(len(r_key)), -r_len, r_key))
    k_sorted = r_key[order]
    firsts = np.flatnonzero(np.r_[True, k_sorted[1:] != k_sorted[:-1]])
    for f in firsts:
        rid = int(order[f])
        if c["r_len"][rid] == 0:
            continue
        mask = c["e_rid"] == rid
        kvi = c["e_kv"][mask][np.argsort(c["e_pos"][mask])]
        k = keys.objects[int(k_sorted[f])]
        orders[k] = [kvs.objects[int(i)][1] for i in kvi]
    return orders, []


def _append_edges(keys, kvs, c, writer_arr, orders):
    """ww/wr/rw edge rows from the columns + derived orders."""
    parts = []
    n_kv = len(kvs)
    # flatten orders into per-key kv arrays for ww + rw
    ord_kv, ord_key_off, key_list = [], {}, []
    for k, vals in orders.items():
        ids = [kvs.get((k, v)) for v in vals]
        ord_key_off[keys.add(k)] = (len(ord_kv), len(vals))
        ord_kv.extend(-1 if i is None else i for i in ids)
    ord_kv = np.asarray(ord_kv, np.int64)

    # ww: consecutive order entries with live writers
    if len(ord_kv) > 1:
        offs = np.asarray([[o, n] for o, n in ord_key_off.values()],
                          np.int64)
        pos = []
        for o, n in offs:
            pos.extend(range(o, o + n - 1))
        pos = np.asarray(pos, np.int64)
        if len(pos):
            kv1, kv2 = ord_kv[pos], ord_kv[pos + 1]
            ok = (kv1 >= 0) & (kv2 >= 0)
            w1 = np.where(ok, writer_arr[np.maximum(kv1, 0)], -1)
            w2 = np.where(ok, writer_arr[np.maximum(kv2, 0)], -1)
            m = (w1 >= 0) & (w2 >= 0)
            if m.any():
                parts.append(np.stack(
                    [w1[m], w2[m], np.full(int(m.sum()), WW)],
                    axis=1).astype(np.int32))

    # wr: last non-own element of each read -> reader
    if len(c["e_rid"]):
        stride = n_kv + 1
        own_set = np.unique(c["own_t"] * stride + c["own_kv"]) \
            if len(c["own_t"]) else np.zeros(0, np.int64)
        e_txn = c["r_txn"][c["e_rid"]]
        e_own = np.isin(e_txn * stride + c["e_kv"], own_set)
        pos_m = np.where(e_own, np.int64(-1), c["e_pos"])
        order = np.lexsort((pos_m, c["e_rid"]))
        rid_s, pos_s, kv_s = (c["e_rid"][order], pos_m[order],
                              c["e_kv"][order])
        last = np.flatnonzero(np.r_[rid_s[1:] != rid_s[:-1], True])
        keep = pos_s[last] >= 0
        rid_l, kv_l = rid_s[last][keep], kv_s[last][keep]
        w = writer_arr[kv_l]
        m = w >= 0
        if m.any():
            parts.append(np.stack(
                [w[m], c["r_txn"][rid_l[m]],
                 np.full(int(m.sum()), WR)], axis=1).astype(np.int32))

    # rw: read of a strict prefix -> writer of the next version
    if len(c["r_txn"]):
        nxt = np.full(len(c["r_txn"]), -1, np.int64)
        for rid in range(len(c["r_txn"])):
            off_n = ord_key_off.get(int(c["r_key"][rid]))
            if off_n is None:
                continue
            o, n = off_n
            plen = int(c["r_len"][rid])
            if plen < n:
                nxt[rid] = ord_kv[o + plen]
        ok = nxt >= 0
        w = np.where(ok, writer_arr[np.maximum(nxt, 0)], -1)
        m = w >= 0
        if m.any():
            parts.append(np.stack(
                [c["r_txn"][m], w[m],
                 np.full(int(m.sum()), RW)], axis=1).astype(np.int32))
    return _dedup_edges(parts)


def _jump_meta(node_arr, ridx, rinv, rcomp, pidx, ppid, pp):
    """Align realtime/process metadata with the node array (local
    ids). Absent entries get sentinels that disable the jump."""
    T = len(node_arr)
    inv_evt = np.full(T, -_BIG, np.int64)
    comp_evt = np.full(T, _BIG, np.int64)
    proc = np.full(T, -1, np.int32)
    ppos = np.full(T, -1, np.int32)
    if ridx is not None and len(ridx):
        loc = np.searchsorted(node_arr, ridx)
        m = (loc < T) & (node_arr[np.minimum(loc, T - 1)] == ridx)
        inv_evt[loc[m]] = rinv[m]
        comp_evt[loc[m]] = rcomp[m]
    if pidx is not None and len(pidx):
        loc = np.searchsorted(node_arr, pidx)
        m = (loc < T) & (node_arr[np.minimum(loc, T - 1)] == pidx)
        proc[loc[m]] = ppid[m]
        ppos[loc[m]] = pp[m]
    return inv_evt, comp_evt, proc, ppos


# -- wr -----------------------------------------------------------------------

@dataclass
class WrBuild:
    tensors: GraphTensors
    writer: dict
    orders: dict                      # k -> {v: set(successors)}
    cyclic_anomalies: list
    micro_ops: int
    builder: str


def build_wr(history: History, oks: list, infos: list,
             sequential_keys=False, linearizable_keys=False,
             wfr_keys=False, additional_graphs=()) -> WrBuild:
    """Tensorized equivalent of wr._writer_index + wr._version_orders
    + wr._txn_graph (+ additional graphs). Evidence-pair derivation is
    vectorized per source; the per-key cycle check stays host-side
    (pair counts are tiny) and cyclic keys keep host-exact payloads."""
    t0 = _time.monotonic()
    from .wr import INIT, _fmt_pairs, _has_cycle

    keys, kvs = Interner(), Interner()
    # mop rows over oks, in op order
    m_txn, m_seq, m_mop, m_key, m_kv, m_isw, m_proc = \
        [], [], [], [], [], [], []
    w_rows_txn, w_rows_kv = [], []    # writes over oks + infos
    for seq, op in enumerate(oks):
        for mi, (f, k, v) in enumerate(op.value):
            if f not in (R, W):
                continue
            kid = keys.add(k)
            cur = kvs.add((k, INIT)) if (f == R and v is None) \
                else kvs.add((k, v))
            m_txn.append(op.index)
            m_seq.append(seq)
            m_mop.append(mi)
            m_key.append(kid)
            m_kv.append(cur)
            m_isw.append(f == W)
            m_proc.append(op.process)
            if f == W:
                w_rows_txn.append(op.index)
                w_rows_kv.append(cur)
    for op in infos:
        for f, k, v in op.value or []:
            if f == W:
                w_rows_txn.append(op.index)
                w_rows_kv.append(kvs.add((k, v)))
    n_kv = len(kvs)
    init_ids = np.asarray([kvs.add((keys.objects[i], INIT))
                           for i in range(len(keys))], np.int64) \
        if len(keys) else np.zeros(0, np.int64)
    n_kv = len(kvs)

    writer_arr = np.full(n_kv, -1, np.int64)
    if w_rows_kv:
        wkv = np.asarray(w_rows_kv, np.int64)
        wtx = np.asarray(w_rows_txn, np.int64)
        u, first = np.unique(wkv[::-1], return_index=True)
        writer_arr[u] = wtx[::-1][first]
    writer = {tuple(kvs.objects[i]): int(writer_arr[i])
              for i in range(n_kv) if writer_arr[i] >= 0}

    M = len(m_txn)
    mt = np.asarray(m_txn, np.int64)
    ms = np.asarray(m_seq, np.int64)
    mm = np.asarray(m_mop, np.int64)
    mk = np.asarray(m_key, np.int64)
    mkv = np.asarray(m_kv, np.int64)
    miw = np.asarray(m_isw, bool)

    pair_parts = []   # (key, v1_kv, v2_kv) evidence rows

    if M:
        # INIT precedes every written value
        wm = miw
        if wm.any():
            pair_parts.append(np.stack(
                [mk[wm], init_ids[mk[wm]], mkv[wm]], axis=1))
        # wfr: last read of k in the txn before a write of k
        if wfr_keys and wm.any():
            order = np.lexsort((mm, mk, ms))
            seq_s, key_s, mop_s = ms[order], mk[order], mm[order]
            kv_s, isw_s = mkv[order], miw[order]
            grp = np.r_[True, (seq_s[1:] != seq_s[:-1])
                        | (key_s[1:] != key_s[:-1])]
            # forward-fill index of last READ row within each group
            ridx = np.where(~isw_s, np.arange(len(order)), -1)
            ridx[grp & (ridx < 0)] = -1
            # reset at group starts: offset trick
            gid = np.cumsum(grp) - 1
            filled = np.maximum.accumulate(
                np.where(~isw_s, np.arange(len(order)) + gid * 0, -1)
                + gid * len(order))
            filled = filled - gid * len(order)
            valid = filled >= 0
            tgt = np.flatnonzero(isw_s & valid)
            if len(tgt):
                lr_kv = kv_s[filled[tgt]]
                pairs = np.stack([key_s[tgt], lr_kv, kv_s[tgt]],
                                 axis=1)
                pairs = pairs[pairs[:, 1] != pairs[:, 2]]
                if len(pairs):
                    pair_parts.append(pairs)
        # sequential: consecutive distinct observations per (proc, key)
        if sequential_keys:
            procs = Interner()
            mp = np.asarray([procs.add(p) for p in m_proc], np.int64)
            order = np.lexsort((mm, ms, mk, mp))
            p_s, k_s, kv_s = mp[order], mk[order], mkv[order]
            adj = np.flatnonzero((p_s[1:] == p_s[:-1])
                                 & (k_s[1:] == k_s[:-1])
                                 & (kv_s[1:] != kv_s[:-1])) + 1
            if len(adj):
                pair_parts.append(np.stack(
                    [k_s[adj], kv_s[adj - 1], kv_s[adj]], axis=1))
        if linearizable_keys:
            ev = _wr_realtime_evidence(history, keys, kvs, INIT)
            if ev is not None and len(ev):
                pair_parts.append(ev)

    pairs = (np.unique(np.concatenate(pair_parts, axis=0), axis=0)
             if pair_parts else np.zeros((0, 3), np.int64))

    # per-key cycle check + adjacency dict (host, tiny)
    orders: dict = {}
    cyclic: list = []
    if len(pairs):
        for kid in np.unique(pairs[:, 0]):
            rows = pairs[pairs[:, 0] == kid]
            adj: dict = {}
            for _k, a, b in rows:
                adj.setdefault(int(a), set()).add(int(b))
            k = keys.objects[int(kid)]
            obj = {(_obj(kvs, a, INIT)): {_obj(kvs, b, INIT)
                                          for b in bs}
                   for a, bs in adj.items()}
            if _has_cycle({a: set(bs) for a, bs in adj.items()}):
                raw = {( _obj(kvs, int(a), INIT), _obj(kvs, int(b), INIT))
                       for _kk, a, b in rows}
                cyclic.append({"key": k,
                               "explanation":
                               f"version precedence evidence for key "
                               f"{k!r} is cyclic: {_fmt_pairs(raw)}"})
            else:
                orders[k] = obj

    edges = _wr_edges(keys, kvs, oks, writer_arr, pairs, cyclic,
                      init_ids, INIT)
    parts = [edges]
    nodes = {int(op.index) for op in oks}
    ridx = rinv = rcomp = None
    pidx = ppid = pp = None
    if "realtime" in additional_graphs:
        ridx, rinv, rcomp, redges = realtime_arrays(history)
        if len(redges):
            parts.append(np.concatenate(
                [redges, np.full((len(redges), 1), REALTIME, np.int32)],
                axis=1))
            nodes |= {int(i) for i in np.unique(redges)}
    if "process" in additional_graphs:
        pidx, ppid, pp, pedges = process_arrays(history)
        if len(pedges):
            parts.append(np.concatenate(
                [pedges, np.full((len(pedges), 1), PROCESS, np.int32)],
                axis=1))
            nodes |= {int(i) for i in np.unique(pedges)}
    all_edges = _dedup_edges(parts)
    node_arr = np.asarray(sorted(nodes | ({int(x) for x in
                                           np.unique(all_edges[:, :2])}
                                          if len(all_edges) else set())),
                          np.int32)
    inv_evt, comp_evt, proc, ppos = _jump_meta(
        node_arr, ridx, rinv, rcomp, pidx, ppid, pp)
    gt = GraphTensors(nodes=node_arr, edges=all_edges,
                      inv_evt=inv_evt, comp_evt=comp_evt,
                      proc=proc, proc_pos=ppos, analytic=True,
                      builder="tensor",
                      build_s=_time.monotonic() - t0)
    return WrBuild(tensors=gt, writer=writer, orders=orders,
                   cyclic_anomalies=cyclic, micro_ops=M,
                   builder="tensor")


def _obj(kvs: Interner, kv_id: int, INIT):
    v = kvs.objects[int(kv_id)][1]
    return v


def _wr_realtime_evidence(history, keys, kvs, INIT):
    """wr._realtime_evidence as columns: per key, the running
    latest-completed final value (strictly-max completion time, first
    writer kept on ties) versus each op's first observation.

    The encode is element-row flat (the treatment append's encoder
    got): ONE append per R/W micro-op — no per-op first/final dicts,
    no Python sweep — then numpy does the rest: the sweep rank is a
    stable argsort of invocation times, and each op's first/final
    observation per key falls out of one lexsort over (pair, key,
    mop-position) as the group's first/last element. Past ~1M
    micro-ops the old per-op dict loop was the build's floor; this
    keeps the wr evidence derivation on the vectorized path the rest
    of the builder already runs."""
    pairs = [(inv, comp) for inv, comp in history.pairs()
             if comp is not None and comp.is_ok and comp.value]
    if not pairs:
        return None
    if not _times_ok([p[0] for p in pairs] + [p[1] for p in pairs]):
        raise BuildUnsupported("non-integer op times")
    # flat element-row encode: the interner adds are the only Python
    # left (ids must come from the build's shared Interner instances)
    e_p, e_kid, e_kv, e_pos = [], [], [], []
    inv_t = np.empty(len(pairs), np.int64)
    comp_t = np.empty(len(pairs), np.int64)
    kadd, vadd = keys.add, kvs.add
    for p, (inv, comp) in enumerate(pairs):
        inv_t[p] = inv.time
        comp_t[p] = comp.time
        for pos, (f, k, v) in enumerate(comp.value):
            if f == R:
                cur = vadd((k, INIT)) if v is None else vadd((k, v))
            elif f == W:
                cur = vadd((k, v))
            else:
                continue
            e_p.append(p)
            e_kid.append(kadd(k))
            e_kv.append(cur)
            e_pos.append(pos)
    if not e_p:
        return None
    ep = np.asarray(e_p, np.int64)
    ekid = np.asarray(e_kid, np.int64)
    ekv = np.asarray(e_kv, np.int64)
    epos = np.asarray(e_pos, np.int64)
    # sweep rank = stable sort by invocation time (host sweep order)
    order = np.argsort(inv_t, kind="stable")
    sweep = np.empty(len(pairs), np.int64)
    sweep[order] = np.arange(len(pairs))
    # first/final observation per (op, key): group rows by
    # (pair, key) in mop order; the group's first element is `first`,
    # its last is `final` — exactly the old dicts, without them
    o2 = np.lexsort((epos, ekid, ep))
    p_s, kid_s, kv_s = ep[o2], ekid[o2], ekv[o2]
    newgrp = np.r_[True, (p_s[1:] != p_s[:-1])
                   | (kid_s[1:] != kid_s[:-1])]
    last_idx = np.r_[np.flatnonzero(newgrp)[1:] - 1, len(p_s) - 1]
    grp_p = p_s[newgrp]
    rk = kid_s[newgrp]
    ri = sweep[grp_p]
    rf = kv_s[newgrp]
    rl = kv_s[last_idx]
    rt_inv = inv_t[grp_p]
    rt_comp = comp_t[grp_p]
    n = len(rk)
    order2 = np.lexsort((ri, rk))
    k_s = rk[order2]
    # rank-compress times so the composite below cannot overflow
    # int64 even with nanosecond stamps: ranks preserve both < and ==
    # across comp and inv because they come from ONE unique array
    uniq_t = np.unique(np.concatenate([rt_comp, rt_inv]))
    comp_r = np.searchsorted(uniq_t, rt_comp[order2]).astype(np.int64)
    inv_r = np.searchsorted(uniq_t, rt_inv[order2]).astype(np.int64)
    # composite running max: strictly larger comp_time wins, first
    # achiever kept on ties (host `latest[k][0] < comp.time`)
    KBASE = np.int64(n + 1)
    comp_scaled = comp_r * KBASE + (KBASE - 1 - np.arange(n))
    seg = np.cumsum(np.r_[True, k_s[1:] != k_s[:-1]]) - 1
    span = np.int64(int(comp_scaled.max()) + 1) if n else np.int64(1)
    glob = comp_scaled + seg * (2 * span)
    run = np.maximum.accumulate(glob)
    # value BEFORE this row (shift within segment)
    prev_run = np.r_[np.int64(-1), run[:-1]]
    seg_start = np.r_[True, k_s[1:] != k_s[:-1]]
    have_prev = ~seg_start
    prev_comp_scaled = prev_run - seg * (2 * span)
    prev_t = np.where(have_prev, prev_comp_scaled // KBASE, -1)
    prev_row = np.where(have_prev,
                        KBASE - 1 - (prev_comp_scaled % KBASE), -1)
    first_s = rf[order2]
    inv_s = inv_r
    prev_val = np.where(prev_row >= 0, rl[order2][
        np.maximum(prev_row, 0)], -1)
    m = have_prev & (prev_t < inv_s) & (prev_val != first_s) \
        & (prev_val >= 0)
    if not m.any():
        return np.zeros((0, 3), np.int64)
    return np.stack([k_s[m], prev_val[m], first_s[m]], axis=1)


def _wr_edges(keys, kvs, oks, writer_arr, pairs, cyclic, init_ids,
              INIT):
    """ww/wr/rw rows from the wr evidence pairs (cyclic keys carry no
    order, so they contribute no ww/rw edges — host parity)."""
    parts = []
    cyc_kids = {keys.get(c["key"]) for c in cyclic}
    if len(pairs):
        ok_rows = np.asarray([int(r[0]) not in cyc_kids for r in pairs],
                             bool)
        live = pairs[ok_rows]
        if len(live):
            w1 = writer_arr[live[:, 1]]
            w2 = writer_arr[live[:, 2]]
            m = (w1 >= 0) & (w2 >= 0)
            if m.any():
                parts.append(np.stack(
                    [w1[m], w2[m], np.full(int(m.sum()), WW)],
                    axis=1).astype(np.int32))
    # ext reads: first mop of a key in a txn that is a read
    from ..txn import ext_reads
    er_txn, er_kv, er_real = [], [], []
    for op in oks:
        for k, v in ext_reads(op.value).items():
            if keys.get(k) is None:
                continue
            cur = kvs.get((k, INIT)) if v is None else kvs.get((k, v))
            er_txn.append(op.index)
            er_kv.append(-1 if cur is None else cur)
            er_real.append(v is not None and cur is not None)
    if er_txn:
        ekv = np.asarray(er_kv, np.int64)
        etx = np.asarray(er_txn, np.int64)
        m = np.asarray(er_real, bool) & (ekv >= 0)
        m[m] &= writer_arr[ekv[m]] >= 0
        if m.any():
            parts.append(np.stack(
                [writer_arr[ekv[m]], etx[m],
                 np.full(int(m.sum()), WR)], axis=1).astype(np.int32))
    # rw: evidenced successors of the observed version
    if len(pairs) and er_txn:
        live = pairs[np.asarray([int(r[0]) not in cyc_kids
                                 for r in pairs], bool)]
        if len(live):
            ek = np.asarray(er_kv, np.int64)
            et = np.asarray(er_txn, np.int64)
            ok = ek >= 0
            # join ext-read kv against evidence v1
            order = np.argsort(live[:, 1], kind="stable")
            v1_s = live[order, 1]
            lo = np.searchsorted(v1_s, ek[ok], side="left")
            hi = np.searchsorted(v1_s, ek[ok], side="right")
            counts = hi - lo
            total = int(counts.sum())
            if total:
                src_rep = np.repeat(et[ok], counts)
                offs = np.arange(total) - np.repeat(
                    np.concatenate([[0], np.cumsum(counts)[:-1]]),
                    counts)
                rows = order[np.repeat(lo, counts) + offs]
                nxt = live[rows, 2]
                w = writer_arr[nxt]
                m = w >= 0
                if m.any():
                    parts.append(np.stack(
                        [src_rep[m], w[m],
                         np.full(int(m.sum()), RW)],
                        axis=1).astype(np.int32))
    return _dedup_edges(parts)
