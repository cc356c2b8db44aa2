"""Lift single-key checks to maps of keys (jepsen.independent parity).

Expensive checks (linearizability above all) only tolerate short
histories, so the reference splits a test into independent keys: values
become `[k v]` tuples, and the checker partitions the history into
per-key subhistories (`jepsen/src/jepsen/independent.clj:2-7,21-24,
240-317`).

Two checker paths, as in `jepsen_tpu/independent.py`:

  * `checker(c)` — bounded-pmap the wrapped checker over per-key
    subhistories on host threads (independent.clj:266-317);
  * `cuda_checker(model)` — the port's `tpu_checker`: every per-key
    subhistory is batch-encoded and searched on the card by
    `parallel.check_batched` (one lane-batched kernel launch per poll
    for 4 or more keys, one search per key below that).

The generator half (`tuple_gen`, `sequential_generator`,
`concurrent_generator`, independent.clj:31-238) lifts a single-key
generator to `[k v]` tuple values, as in `jepsen_tpu/independent.py:
62-225`.
"""

from __future__ import annotations

import json
import os
import time as _time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

from . import fleet as _fleet
from . import generator as gen
from . import ledger as _ledger
from .analysis import history_lint
from .checker import Checker, check_safe, merge_valid
from .history import History, strip_nemesis
from .models.core import Model
from .util import bounded_pmap, resolve_devices

DIR = "independent"


@dataclass(frozen=True)
class KV:
    """A [k v] tuple value (independent.clj:21-29 uses MapEntry)."""

    k: Any
    v: Any

    def __iter__(self):
        return iter((self.k, self.v))

    def __repr__(self):
        return f"[{self.k!r} {self.v!r}]"


def tuple_(k, v) -> KV:
    return KV(k, v)


def is_tuple(value) -> bool:
    return isinstance(value, KV)


# ---------------------------------------------------------------------------
# Generator lifting (independent.clj:31-238)
# ---------------------------------------------------------------------------

def tuple_gen(k, g):
    """Wrap a generator so its invocations carry [k v] tuple values
    (independent.clj:96-103)."""
    def wrap(op):
        if op.get("type", "invoke") == "invoke":
            return {**op, "value": tuple_(k, op.get("value"))}
        return op
    return gen.map_(wrap, g)


def sequential_generator(keys: Iterable, fgen: Callable):
    """One key at a time: exhaust fgen(k1), move to k2, ... — each op's
    value wrapped as a [k v] tuple (independent.clj:31-47). fgen must be
    pure."""
    return [tuple_gen(k, fgen(k)) for k in keys]


def group_threads(n: int, ctx) -> list:
    """Partition the context's threads (sorted) into groups of n
    (independent.clj:49-76); asserts divisibility the same way."""
    threads = sorted(ctx.all_threads(), key=str)
    count = len(threads)
    assert n <= count, (
        f"with {count} worker threads, a concurrent generator cannot run "
        f"a key with {n} threads; raise concurrency to at least {n}")
    assert count % n == 0, (
        f"{count} worker threads cannot be evenly split into groups of "
        f"{n}; set concurrency to a multiple of {n}")
    return [frozenset(threads[i:i + n]) for i in range(0, count, n)]


class _KeyStream:
    """Memoized view over a (possibly infinite) key iterable. Cloned
    ConcurrentGenerator states share one stream and index into it; the
    buffer only grows, so `get(i)` is deterministic regardless of which
    clone asks first — pure-value semantics preserved over a lazy
    source (the reference's `(range)` infinite key seq,
    independent.clj:228)."""

    _EXHAUSTED = object()

    def __init__(self, keys: Iterable):
        self._it = iter(keys)
        self._buf: list = []
        self._done = False

    def get(self, i: int):
        """Key #i, or _EXHAUSTED if the source ran out."""
        while len(self._buf) <= i and not self._done:
            try:
                self._buf.append(next(self._it))
            except StopIteration:
                self._done = True
        return self._buf[i] if i < len(self._buf) else self._EXHAUSTED


class ConcurrentGenerator(gen.Generator):
    """Splits worker threads into groups of n per key; each group runs
    fgen(k) until exhaustion, then takes the next key. Ops are chosen by
    soonest-op selection across free groups; updates route to the
    owning group's generator (independent.clj:103-211). Keys may be an
    infinite iterable (wrap the whole thing in gen.time_limit/limit).

    Use via `concurrent_generator(...)`, which excludes the nemesis."""

    def __init__(self, n: int, keys, fgen: Callable,
                 groups: Optional[list] = None,
                 thread_group: Optional[dict] = None,
                 gens: Optional[list] = None,
                 pos: int = 0):
        assert n > 0 and isinstance(n, int)
        self.n = n
        self.keys = keys if isinstance(keys, _KeyStream) \
            else _KeyStream(keys)
        self.fgen = fgen
        self.groups = groups            # list of frozensets of threads
        self.thread_group = thread_group  # thread -> group index
        self.gens = gens                # per-group generator (or None)
        self.pos = pos                  # next key index in the stream

    def _next_key(self, pos: int):
        k = self.keys.get(pos)
        return (None, pos) if k is self.keys._EXHAUSTED else (k, pos + 1)

    def _grouped(self, ctx):
        groups = self.groups or group_threads(self.n, ctx)
        tg = self.thread_group or {t: i for i, g in enumerate(groups)
                                   for t in g}
        pos = self.pos
        if self.gens is None:
            gens = []
            for _ in groups:
                k, pos2 = self._next_key(pos)
                gens.append(tuple_gen(k, self.fgen(k))
                            if pos2 != pos else None)
                pos = pos2
        else:
            gens = list(self.gens)
        return groups, tg, gens, pos

    def op(self, test, ctx):
        groups, tg, gens, pos = self._grouped(ctx)
        free_groups = sorted({tg[t] for t in ctx.free_threads if t in tg})
        soonest = None
        for grp in free_groups:
            while True:
                g = gens[grp]
                if g is None:
                    break
                members = groups[grp]
                gctx = ctx.restrict(lambda t, s=members: t in s)
                res = gen.op(g, test, gctx)
                if res is None:
                    # exhausted: take the next key, or retire the group
                    k, pos2 = self._next_key(pos)
                    if pos2 != pos:
                        pos = pos2
                        gens[grp] = tuple_gen(k, self.fgen(k))
                        continue
                    gens[grp] = None
                    break
                o, g2 = res
                soonest = gen.soonest_op_map(
                    soonest, {"op": o, "group": grp, "gen": g2,
                              "weight": len(members)})
                if o is gen.PENDING:
                    gens[grp] = g2
                break
        if soonest is not None and soonest["op"] is not gen.PENDING:
            gens2 = list(gens)
            gens2[soonest["group"]] = soonest["gen"]
            return (soonest["op"],
                    ConcurrentGenerator(self.n, self.keys, self.fgen,
                                        groups, tg, gens2, pos))
        if any(g is not None for g in gens):
            # busy groups may still produce ops
            return (gen.PENDING,
                    ConcurrentGenerator(self.n, self.keys, self.fgen,
                                        groups, tg, gens, pos))
        return None

    def update(self, test, ctx, event):
        if self.thread_group is None or self.gens is None:
            return self
        t = ctx.process_to_thread(event.get("process"))
        grp = self.thread_group.get(t)
        if grp is None or self.gens[grp] is None:
            return self
        members = self.groups[grp]
        gctx = ctx.restrict(lambda th, s=members: th in s)
        gens = list(self.gens)
        gens[grp] = gen.update(gens[grp], test, gctx, event)
        return ConcurrentGenerator(self.n, self.keys, self.fgen,
                                   self.groups, self.thread_group, gens,
                                   self.pos)


def concurrent_generator(n: int, keys: Iterable, fgen: Callable):
    """Thread groups of n per key, soonest-op scheduling, nemesis
    excluded (independent.clj:213-238). keys may be infinite (e.g.
    itertools.count()); bound the workload with gen.time_limit."""
    return gen.clients(ConcurrentGenerator(n, keys, fgen))


def history_keys(history: History) -> list:
    """The keys present in a history's tuple values
    (independent.clj:240-250), in first-seen order."""
    seen: dict = {}
    for op in history:
        v = op.value
        if is_tuple(v) and v.k not in seen:
            seen[v.k] = True
    return list(seen)


def subhistory(k, history: History) -> History:
    """All ops that do not carry a *different* key, with tuple values
    unwrapped (independent.clj:252-264): ops without tuple values
    (nemesis, info) are kept in every subhistory."""
    out = History()
    for op in history:
        v = op.value
        if not is_tuple(v):
            out.append(op)
        elif v.k == k:
            out.append(op.with_(value=v.v))
    return out


def subhistories(history: History, ks: list) -> list:
    """`[subhistory(k, history) for k in ks]` in one pass over the
    history instead of one pass per key."""
    subs = {k: History() for k in ks}
    for op in history:
        v = op.value
        if not is_tuple(v):
            for sub in subs.values():
                sub.append(op)
        elif v.k in subs:
            subs[v.k].append(op.with_(value=v.v))
    return [subs[k] for k in ks]


def _gate(history: History, where: str) -> Optional[dict]:
    """One well-formedness pass over the WHOLE history before the
    fan-out: a malformed run fast-fails with op-level diagnoses instead
    of spending a search per key."""
    bad = history_lint.gate(strip_nemesis(history), where=where,
                            rules=history_lint.INDEPENDENT_GATE_RULES)
    if bad is not None:
        return {**bad, "results": {}, "failures": []}
    return None


def _merge(ks: list, results: dict, shards: list) -> dict:
    return {"valid?": merge_valid(r.get("valid?") for r in results.values()),
            "results": results,
            "failures": [k for k in ks if not results[k].get("valid?")],
            "util": {"fleet": _fleet.summarize(shards)}}


def _record_fanout_ledger(test, name, out, ks, model=None,
                          engine=None) -> None:
    """One run-ledger record per fan-out: the verdict, the key count, the
    failures and the fleet summary's device and straggler columns
    (`ledger.summarize_result` lifts util.fleet). A no-op without an
    installed ledger; never raises."""
    fleet_sum = (out.get("util") or {}).get("fleet") or {}
    _ledger.record_result(
        "independent", (test or {}).get("name") or name, out,
        wall_s=fleet_sum.get("span_s"), model=model, engine=engine,
        extra={"keys": len(ks),
               "failures": len(out.get("failures") or [])})


class IndependentChecker(Checker):
    """Host-parallel per-key checking (independent.clj:266-317)."""

    def __init__(self, checker):
        self.checker = checker

    def check(self, test, history, opts=None):
        opts = opts or {}
        bad = _gate(history, "independent")
        if bad is not None:
            return bad
        ks = history_keys(history)
        key_idx = {k: i for i, k in enumerate(ks)}
        status = _fleet.get_default()
        if status.enabled and ks:
            status.begin_keys(len(ks))

        def check_key(k):
            t0 = _time.monotonic()
            h = subhistory(k, history)
            subdir = list(opts.get("subdirectory", [])) + [DIR, str(k)]
            res = check_safe(self.checker, test, h,
                             {**opts, "subdirectory": subdir,
                              "history_key": k})
            res["shard"] = {"key_index": key_idx[k], "key": str(k),
                            "device": "host",
                            "engine": str(res.get("engine") or "host"),
                            "t0": round(t0, 4),
                            "wall_s": round(_time.monotonic() - t0, 4),
                            "valid?": res.get("valid?"),
                            "op_count": res.get("op_count")}
            _fleet.record_shard(res["shard"])
            _write_key_artifacts(test, subdir, h, res)
            return k, res

        results = dict(bounded_pmap(check_key, ks))
        out = _merge(ks, results,
                     [r.get("shard") for r in results.values()])
        _record_fanout_ledger(test, "independent", out, ks)
        return out


def checker(c) -> IndependentChecker:
    return IndependentChecker(c)


def _write_key_artifacts(test, subdir, h, res):
    """Persist per-key results and history under the test's store dir,
    when the test has one (independent.clj:295-303)."""
    d = (test or {}).get("store_dir")
    if not d:
        return
    path = os.path.join(d, *subdir)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "results.json"), "w") as fh:
        json.dump(res, fh, indent=2, default=str)
    h.to_jsonl(os.path.join(path, "history.jsonl"))


class CUDALinearizableIndependent(Checker):
    """Per-key linearizability on the card (the reference's
    `TPULinearizableIndependent`): the history is split into per-key
    subhistories as `IndependentChecker` does, and the whole key set is
    checked by `parallel.check_batched` over the devices
    (`util.resolve_devices`: `devices`, a list that may repeat a
    device, else `[device]`, else every card). The devices are resolved
    before anything else, so without a card `check` raises."""

    def __init__(self, model: Model, time_limit: Optional[float] = None,
                 device=None, devices=None):
        self.model = model
        self.time_limit = time_limit
        self.device = device
        self.devices = devices

    def check(self, test, history, opts=None):
        from .parallel import check_batched
        devs = resolve_devices(self.devices, self.device)
        opts = opts or {}
        bad = _gate(history, "independent.cuda")
        if bad is not None:
            return bad
        ks = history_keys(history)
        _fleet.get_default().phase("independent-check")
        subs = subhistories(history, ks)
        res_list = check_batched(self.model, [strip_nemesis(s) for s in subs],
                                 time_limit=self.time_limit, devices=devs)
        results = dict(zip(ks, res_list))
        for k, h, res in zip(ks, subs, res_list):
            if isinstance(res.get("shard"), dict):
                res["shard"]["key"] = str(k)
            subdir = list(opts.get("subdirectory", [])) + [DIR, str(k)]
            _write_key_artifacts(test, subdir, h, res)
        out = _merge(ks, results, [r.get("shard") for r in res_list])
        _record_fanout_ledger(test, "independent", out, ks,
                              model=type(self.model).__name__,
                              engine="device-mesh")
        return out


def cuda_checker(model: Model, time_limit: Optional[float] = None,
                 device=None, devices=None) -> CUDALinearizableIndependent:
    return CUDALinearizableIndependent(model, time_limit, device, devices)
