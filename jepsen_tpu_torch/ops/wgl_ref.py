"""Pure-Python Wing–Gong–Lowe linearizability search.

The correctness oracle for the CUDA search (`ops.wgl`) and the
counterexample extractor. Capability parity with knossos.wgl/analysis (an
external dep of the reference, selected at
`jepsen/src/jepsen/checker.clj:199-202`): given a model and a history,
decide whether the history is linearizable, returning
`{"valid?": True/False/"unknown", ...}` with `final_paths` /
`configs` diagnostics on failure (truncated to 10, matching
`jepsen/src/jepsen/checker.clj:213-216` — "Writing these can take hours").

Algorithm: depth-first search over partial linearizations. A configuration
is (linearized-set, model-state); op i may be linearized next when every op
that *returned* before i was *invoked* is already linearized (the real-time
constraint) and the model accepts it. Configurations are memoized — the
cache is what makes WGL tractable (Lowe's "just-in-time linearization").
:info ops may be linearized or skipped; :ok ops must all be linearized.
"""

from __future__ import annotations

import time as _time
from typing import Any, Callable, Optional

from ..history import History
from ..models.core import Model, is_inconsistent
from .linprep import LinOp, prepare, precedence_masks


# configs between two polls of the deadline and the `stop` callable. A
# config of a long history can cost this search a large part of a
# millisecond, and a whole search only a few thousand configs, so a
# sparser poll lets a search the device has already decided run on to
# its own end while the race waits to join it.
STOP_POLL = 16


def _bits(mask: int):
    i = 0
    while mask:
        if mask & 1:
            yield i
        mask >>= 1
        i += 1


def check(model: Model, history: History, time_limit: Optional[float] = None,
          max_configs: int = 20_000_000,
          stop: Optional[Callable[[], bool]] = None) -> dict:
    """Decide linearizability of `history` under `model`.

    Returns {"valid?": bool | "unknown", "op_count": n, ...}. On False,
    includes "final_paths" (sample linearization prefixes that got
    furthest) and "configs" (the stuck configurations). On "unknown",
    includes "cause" ("timeout", "config-limit", or "cancelled" when
    the `stop` callable — polled every `STOP_POLL` configs — returns
    True; competition racing uses it to cancel the losing engine).
    """
    ops = prepare(history)
    n = len(ops)
    if n == 0:
        return {"valid?": True, "op_count": 0}
    if n > 1000 and time_limit is None:
        time_limit = 3600.0
    pred = precedence_masks(ops)
    ok_mask = 0
    for i, o in enumerate(ops):
        if o.ok:
            ok_mask |= 1 << i
    full = (1 << n) - 1
    deadline = _time.monotonic() + time_limit if time_limit else None

    seen: set[tuple[int, Any]] = set()
    # Each stack frame: (linearized_mask, model, path tuple of op ids)
    stack: list[tuple[int, Model, tuple]] = [(0, model, ())]
    seen.add((0, model))
    # Track the deepest progress for diagnostics.
    best_count = -1
    best: list[tuple[int, Model, tuple]] = []
    explored = 0

    while stack:
        if explored % STOP_POLL == 0:
            if deadline is not None and _time.monotonic() > deadline:
                return {"valid?": "unknown", "cause": "timeout",
                        "op_count": n, "configs_explored": explored}
            if stop is not None and stop():
                return {"valid?": "unknown", "cause": "cancelled",
                        "op_count": n, "configs_explored": explored}
        if explored > max_configs:
            return {"valid?": "unknown", "cause": "config-limit",
                    "op_count": n, "configs_explored": explored}
        mask, m, path = stack.pop()
        explored += 1
        if mask & ok_mask == ok_mask:
            return {"valid?": True, "op_count": n,
                    "configs_explored": explored,
                    "linearization": [ops[i].as_op().to_dict() for i in path]}
        cnt = bin(mask & ok_mask).count("1")
        if cnt > best_count:
            best_count = cnt
            best = [(mask, m, path)]
        elif cnt == best_count and len(best) < 10:
            best.append((mask, m, path))
        # Candidates: unlinearized ops whose real-time predecessors are all
        # linearized.
        cand = ~mask & full
        while cand:
            i = (cand & -cand).bit_length() - 1
            cand &= cand - 1
            if pred[i] & ~mask:
                continue
            m2 = m.step(ops[i].as_op())
            if is_inconsistent(m2):
                continue
            mask2 = mask | (1 << i)
            key = (mask2, m2)
            if key not in seen:
                seen.add(key)
                stack.append((mask2, m2, path + (i,)))

    # Exhausted: not linearizable. Build diagnostics from deepest configs.
    configs = []
    final_paths = []
    for mask, m, path in best[:10]:
        configs.append({
            "model": m,
            "linearized": sorted(_bits(mask)),
            "pending": [ops[i].as_op().to_dict()
                        for i in _bits(~mask & ok_mask)][:10],
        })
        final_paths.append([ops[i].as_op().to_dict() for i in path])
    return {"valid?": False, "op_count": n, "configs_explored": explored,
            "max_linearized": best_count,
            "configs": configs, "final_paths": final_paths}
