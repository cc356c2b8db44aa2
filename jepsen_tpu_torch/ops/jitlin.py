"""Just-in-time linearization — the knossos `linear` algorithm.

Capability parity with `knossos.linear/analysis`, the second of the
reference's three linearizability engines (selected by
`:algorithm :linear` at jepsen/src/jepsen/checker.clj:199-202). Where
WGL explores linearization orders depth-first from the history's
front, JIT linearization (Lowe, "Testing for linearizability", 2017 —
the algorithm knossos.linear implements) sweeps the *event sequence*
once, maintaining the set of reachable configurations
(linearized-pending-set, model-state) with a memoized config cache:

  * at a call event, the op joins the pending set;
  * at a return event, every configuration must already have (or be
    able to reach, by linearizing pending ops) that op linearized —
    configurations that cannot are pruned; if none survive, the
    history is invalid *at that event*, which pins blame to a specific
    operation (the knossos `:op` in analysis results).

Returned ops are dropped from configuration masks (every surviving
configuration has them), so the cache keys stay small — the moral
equivalent of WGL's window renormalization.

Complements the WGL engines: same verdicts, different search order and
different failure diagnostics, and `competition` semantics can race
them exactly as `knossos.competition` races linear against wgl.

A copy of the JAX package's `ops/jitlin.py` (host only; no device
program).

Scope note: crashed (:info) ops never return, so they stay pending to
the end of the sweep and the closure grows exponentially in their
count — knossos.linear has the same cliff. Prefer the WGL engines
(bounded info-masks) for crash-heavy histories; this engine's budget
guards return "unknown" rather than hanging.
"""

from __future__ import annotations

import time as _time
from typing import Optional

from ..history import History
from ..models.core import Model, is_inconsistent
from .linprep import prepare


def _expand(configs: dict, pending_ops: dict, deadline, max_configs,
            explored_box):
    """Closure of configs under linearizing any pending ops: from every
    configuration, linearize each not-yet-linearized pending op in
    every order (deduped by (mask, state))."""
    stack = list(configs.items())
    out = dict(configs)
    while stack:
        (mask, state), path = stack.pop()
        for i, op in pending_ops.items():
            bit = 1 << i
            if mask & bit:
                continue
            s2 = state.step(op)
            if is_inconsistent(s2):
                continue
            key = (mask | bit, s2)
            if key not in out:
                out[key] = path + (i,)
                stack.append((key, out[key]))
                explored_box[0] += 1
                if len(out) > max_configs:
                    raise _Budget("config-limit")
        if deadline is not None and _time.monotonic() > deadline:
            raise _Budget("timeout")
    return out


class _Budget(Exception):
    def __init__(self, cause):
        self.cause = cause


def check(model: Model, history: History,
          time_limit: Optional[float] = None,
          max_configs: int = 2_000_000) -> dict:
    """Decide linearizability by JIT linearization. Returns
    {"valid?": bool | "unknown", ...}; on False, "op" names the return
    event that no configuration could satisfy, and "configs" samples
    the surviving configurations just before the failure."""
    ops = prepare(history)
    n = len(ops)
    if n == 0:
        return {"valid?": True, "op_count": 0, "algorithm": "linear"}
    if n > 1000 and time_limit is None:
        time_limit = 3600.0
    deadline = _time.monotonic() + time_limit if time_limit else None

    # event sequence: (time, kind, op index); calls before returns at
    # equal times would be malformed histories — prepare's inv/ret
    # indexes are unique positions in the original history
    events = []
    for i, o in enumerate(ops):
        events.append((o.inv, 0, i))  # call
        if o.ok:
            events.append((o.ret, 1, i))  # return (crashed never do)
    events.sort()

    # configs: {(mask-over-pending-ids, model-state): path}. The path
    # is the full id sequence in model-step order — a real witnessed
    # linearization prefix, kept for failure diagnostics.
    configs: dict = {(0, model): ()}
    pending: dict = {}  # id -> op (as seen by Model.step)
    explored = [0]

    try:
        for _t, kind, i in events:
            if kind == 0:
                pending[i] = ops[i].as_op()
                continue
            # return of op i: expand closure, keep configs with i done
            configs = _expand(configs, pending, deadline, max_configs,
                              explored)
            bit = 1 << i
            survivors = {k: p for k, p in configs.items() if k[0] & bit}
            if not survivors:
                sample = [{"model": repr(k[1]),
                           "linearized-count": len(p)}
                          for k, p in list(configs.items())[:10]]
                return {"valid?": False, "op_count": n,
                        "algorithm": "linear",
                        "op": ops[i].as_op().to_dict(),
                        "configs": sample,
                        "configs_explored": explored[0],
                        "final_paths": [
                            [ops[j].as_op().to_dict() for j in p][-10:]
                            for p in list(configs.values())[:10]]}
            # renormalize: drop op i from masks (every survivor has it)
            # and from the pending set
            del pending[i]
            configs = {}
            for (mask, state), path in survivors.items():
                key = (mask & ~bit, state)
                if key not in configs or len(path) < len(configs[key]):
                    configs[key] = path
    except _Budget as e:
        return {"valid?": "unknown", "cause": e.cause, "op_count": n,
                "algorithm": "linear",
                "configs_explored": explored[0]}

    # all returns satisfied; crashed ops are optional
    return {"valid?": True, "op_count": n, "algorithm": "linear",
            "configs_explored": explored[0]}
