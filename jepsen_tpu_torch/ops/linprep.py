"""History preprocessing for linearizability checking.

Turns a raw Jepsen-style history (invoke/ok/fail/info events) into a table
of *linearizable operations*, each with an invocation index and a return
index, shared by the Python oracle (`wgl_ref`) and the device search
(`wgl`).

Semantics (matching knossos's treatment, which the reference relies on at
`jepsen/src/jepsen/checker.clj:185-216`):
  * an op that completed :ok happened — it must appear in any linearization;
  * an op that completed :fail did NOT happen — it is excluded entirely;
  * an op that ended :info (or never completed) is in an unknown state —
    it MAY appear at any point after its invocation, or not at all.
    Crashed *reads* are dropped outright: they have no effect on state and
    their result was never observed, so they constrain nothing.

Values of invocations are completed from their :ok completion when the
invocation's value is None (knossos history/complete parity) — this is how
reads acquire their observed value.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

from ..history import History, Op

INF_TIME = 2**62  # return index for ops that never returned


@dataclass(frozen=True)
class LinOp:
    """One linearizable operation."""

    f: Any  # op function (read/write/cas/acquire/...)
    value: Any  # completed value (see module docstring)
    ok: bool  # True: must linearize; False (:info): may linearize
    inv: int  # index of invocation event in the (stripped) history
    ret: int  # index of completion event, or INF_TIME
    process: Any = None
    orig_index: int = -1  # the invocation Op's own .index — the
    #   coordinate users see; inv/ret renumber after nemesis stripping

    def as_op(self) -> Op:
        """The op as seen by Model.step / reported in diagnostics."""
        idx = self.orig_index if self.orig_index >= 0 else self.inv
        return Op("ok" if self.ok else "info", f=self.f, process=self.process,
                  value=self.value, index=idx)


_PREP_MEMO: "OrderedDict[tuple, tuple]" = OrderedDict()
_PREP_LOCK = threading.Lock()
# 2 entries: the memo exists for the gate-probe → admitted-check pair
# (plus one concurrent neighbor); a bigger cap would only pin more
# histories alive in a long-lived serve process
_PREP_CAP = 2


def clear_prepare_memo() -> None:
    """Drop the bounded prepare memo (and the strong refs pinning its
    histories): for long-lived processes between runs."""
    with _PREP_LOCK:
        _PREP_MEMO.clear()


def prepare(history: History, crashed_read_fs=("read",)) -> list[LinOp]:
    """History -> list of LinOps ordered by invocation index.

    `crashed_read_fs` names op functions that are pure reads (droppable
    when crashed).

    Memoized (bounded, identity-keyed): the preflight admission gate
    probes a history's shapes immediately before the check it admits
    prepares the same history again, so back-to-back callers share one
    pass. The entry holds the history strongly so its id() cannot be
    recycled while cached; a hit returns a fresh list (LinOps are
    frozen, so sharing them is safe; the list itself is not). The
    history is prepared outside the lock, so the lanes of a race that
    read one history at once never wait on each other's pass.
    """
    # len() in the key: History is append-only mutable, so a grown
    # history must miss; the strong ref keeps id() from recycling
    key = (id(history), len(history), tuple(crashed_read_fs))
    with _PREP_LOCK:
        hit = _PREP_MEMO.get(key)
        if hit is not None and hit[0] is history:
            _PREP_MEMO.move_to_end(key)
            return list(hit[1])
    ops: list[LinOp] = []
    pending: dict[Any, tuple[int, Op]] = {}  # process -> (event idx, invoke op)
    for i, op in enumerate(history):
        if op.process == "nemesis":
            continue
        if op.is_invoke:
            if op.process in pending:
                raise ValueError(
                    f"process {op.process!r} invoked twice without completing "
                    f"(events {pending[op.process][0]} and {i})")
            pending[op.process] = (i, op)
        elif op.is_ok or op.is_fail or op.is_info:
            ent = pending.pop(op.process, None)
            if ent is None:
                # Completion without invocation (e.g. nemesis-style markers
                # from clients): ignore.
                continue
            inv_i, inv = ent
            if op.is_fail:
                continue  # did not happen
            value = inv.value if inv.value is not None else op.value
            if op.is_info:
                if inv.f in crashed_read_fs:
                    continue  # crashed read: no effect, no constraint
                ops.append(LinOp(inv.f, inv.value, False, inv_i, INF_TIME,
                                 inv.process, orig_index=inv.index))
            else:
                ops.append(LinOp(inv.f, value, True, inv_i, i, inv.process,
                                 orig_index=inv.index))
    # ops whose processes never completed: crashed
    for inv_i, inv in pending.values():
        if inv.f in crashed_read_fs:
            continue
        ops.append(LinOp(inv.f, inv.value, False, inv_i, INF_TIME,
                         inv.process, orig_index=inv.index))
    ops.sort(key=lambda o: o.inv)
    with _PREP_LOCK:
        _PREP_MEMO[key] = (history, ops)
        while len(_PREP_MEMO) > _PREP_CAP:
            _PREP_MEMO.popitem(last=False)
    return list(ops)


def precedence_masks(ops: list[LinOp]) -> list[int]:
    """pred[i] = bitmask (python int) of ops j that returned before op i was
    invoked — the real-time order constraint: j must be linearized before i.
    O(n log n) via sorting returns."""
    n = len(ops)
    # Sort op ids by return index; walk invocations in order, accumulating
    # the mask of ops whose return precedes the current invocation.
    by_ret = sorted(range(n), key=lambda j: ops[j].ret)
    pred = [0] * n
    acc = 0
    k = 0
    # ops are sorted by inv already
    for i in range(n):
        inv_i = ops[i].inv
        while k < n and ops[by_ret[k]].ret < inv_i:
            acc |= 1 << by_ret[k]
            k += 1
        pred[i] = acc
    return pred
