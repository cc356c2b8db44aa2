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

The generator half of the reference module (`tuple_gen`,
`concurrent_generator`) is not ported yet.
"""

from __future__ import annotations

import json
import os
import time as _time
from dataclasses import dataclass
from typing import Any, Optional

from . import fleet as _fleet
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
