"""Polynomial-time FIFO-queue linearizability for distinct-value
complete histories.

The generic WGL search (ours and JVM knossos alike — the engines behind
`checker/linearizable` with `model/fifo-queue`) explodes on queue
histories: concurrent enqueues fork queue-content states that only
reconcile when the queue drains, so even 200-op histories DNF. But for
the common disciplined workload — every enqueue value distinct, every
dequeue's value known, history complete (no crashed ops), no
dequeue-from-empty — queue linearizability is decidable in polynomial
time (Gibbons & Korach, "Testing Shared Memories", SIAM J. Comput.
1997, establish the tractable-cases landscape; this is the classic
tractable case).

Characterization used here. Work over *values*: enq(v) has interval
[ei_v, er_v], deq(v) (if present) [di_v, dr_v]. In any linearization
the sequence of dequeued values equals the sequence of their enqueues
(FIFO), so one total order σ over values governs both. σ must respect
every forced precedence:

  (1) er(enq v) < ei(enq w)          -> v before w   (enq precedence)
  (2) dr(deq v) < di(deq w)          -> v before w   (deq precedence)
  (3) dr(deq v) < ei(enq w)          -> v before w   (deq-v precedes
                                                      enq-w entirely)
  (4) v dequeued, u never dequeued   -> v before u   (if u's enqueue
      point preceded v's, FIFO would force u out before v)

plus the pairwise feasibility ei_v < dr_v (the dequeue must be able to
linearize after its enqueue). Any σ acyclic under (1)-(4) is
realizable by an explicit point schedule (greedy earliest-feasible
placement works because each constraint family is an interval order),
so the history is linearizable iff the constraint graph is acyclic.
Acyclicity is tested by greedy topological peeling with heaps —
O(n log n), no quadratic edge materialization — so 100k-op histories
decide in milliseconds where the JVM search times out at 200 ops.

Correctness is established differentially: `tests/test_queuecheck.py`
replays thousands of random small histories (valid and corrupted)
through the JAX package's copy of this checker and the WGL oracle and
demands identical verdicts; `tests/test_torch_checker.py` holds this
copy against that one. Host only.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Optional

from ..history import History
from .linprep import prepare


class QueueUnsupported(Exception):
    """History shape outside the fast path (duplicate values, unknown
    dequeue values, crashed ops, dequeue-from-empty, failed ops that
    still need the search's may-skip semantics)."""


@dataclass
class _Val:
    v: Any
    ei: int
    er: int
    di: Optional[int] = None
    dr: Optional[int] = None

    @property
    def dequeued(self) -> bool:
        return self.di is not None


INF_T = 2**62


def _collect(history: History) -> tuple[list, bool]:
    """LinOps -> (per-value records, exact?, op count).

    Open (never-completed / crashed) ops get one-sided handling that is
    sound for True verdicts: an open dequeue is excluded (one legal
    completion choice), an open enqueue whose value is never dequeued
    is excluded (equivalent to placing it last), and an open enqueue
    whose value IS dequeued must have happened, so it is included with
    ret = infinity (exact). When any op was excluded, `exact` is False:
    an invalid verdict must then fall back to the full search, because
    including the dropped op might have rescued the history."""
    ops = prepare(history)
    n_ops = len(ops)
    vals: dict = {}
    open_enqs: dict = {}
    exact = True
    for o in ops:
        if o.f == "enqueue":
            if o.value in vals or o.value in open_enqs:
                raise QueueUnsupported(f"duplicate enqueue {o.value!r}")
            if o.ok:
                vals[o.value] = _Val(o.value, o.inv, o.ret)
            else:
                open_enqs[o.value] = o
        elif o.f == "dequeue":
            if not o.ok:
                exact = False  # excluded open dequeue
            elif o.value is None:
                raise QueueUnsupported("dequeue with unknown value")
        else:
            raise QueueUnsupported(f"op f {o.f!r}")
    for o in ops:
        if o.f != "dequeue" or not o.ok:
            continue
        rec = vals.get(o.value)
        if rec is None:
            oe = open_enqs.pop(o.value, None)
            if oe is not None:
                # the open enqueue definitely happened
                rec = _Val(o.value, oe.inv, INF_T)
                vals[o.value] = rec
            else:
                # dequeued a value never enqueued: plainly invalid
                return ([_Val(o.value, INF_T, INF_T, o.inv, o.ret)],
                        True, n_ops)
        if rec.dequeued:
            raise QueueUnsupported(f"value {o.value!r} dequeued twice")
        rec.di, rec.dr = o.inv, o.ret
    if open_enqs:
        exact = False  # excluded open never-dequeued enqueues
    return list(vals.values()), exact, n_ops


def check(history: History) -> dict:
    """{"valid?": bool, ...}; raises QueueUnsupported outside the fast
    path (callers fall back to the WGL search)."""
    vals, exact, n_ops = _collect(history)
    n = len(vals)
    if n == 0:
        return {"valid?": True, "op_count": n_ops,
                "engine": "queue-poly"}

    def invalid(res: dict) -> dict:
        if not exact:
            # the excluded open ops might have rescued this history;
            # only the full search can tell
            raise QueueUnsupported("invalid with open ops excluded")
        return res

    for r in vals:
        if r.dequeued and not r.ei < r.dr:
            return invalid({"valid?": False, "op_count": n_ops,
                            "engine": "queue-poly",
                            "error": ["dequeue-before-enqueue", r.v]})

    # Topological peel. A remaining value v has no incoming constraint
    # edge iff (minima taken over *remaining* values, self included —
    # self-inclusion is exact because ei<=er and di<=dr make the self
    # conditions vacuous):
    #   v in D:     ei_v <= B            (rule 1, B = min er, all)
    #               ei_v <= A            (rule 3, A = min dr over D)
    #               di_v <= A            (rule 2)
    #   v not in D: ei_v <= B and D empty  (rules 1, 4)
    # Peeling only raises A and B, so eligibility is monotone: a value
    # stages from the ei-ordered heap into the di-ordered heap once
    # ei <= min(A, B), and peels once its di <= A. If no value is
    # eligible, none ever will be — a constraint cycle — invalid.
    # DAG peeling is confluent, so any eligible choice is exhaustive.
    er_heap = [(r.er, i) for i, r in enumerate(vals)]
    dr_heap = [(r.dr, i) for i, r in enumerate(vals) if r.dequeued]
    by_ei = sorted(((r.ei, i) for i, r in enumerate(vals) if r.dequeued),
                   reverse=True)  # pop smallest from the end
    staged: list = []  # (di, idx) for D values whose ei passed
    undeq = sorted(((r.ei, i) for i, r in enumerate(vals)
                    if not r.dequeued), reverse=True)
    heapq.heapify(er_heap)
    heapq.heapify(dr_heap)
    done: set = set()
    order: list = []
    n_deq_left = len(dr_heap)

    def _peek(heap):
        while heap and heap[0][1] in done:
            heapq.heappop(heap)
        return heap[0] if heap else None

    while len(done) < n:
        if n_deq_left:
            a = _peek(dr_heap)[0]
            b = _peek(er_heap)[0]
            thresh = min(a, b)
            while by_ei and by_ei[-1][0] <= thresh:
                _, i = by_ei.pop()
                heapq.heappush(staged, (vals[i].di, i))
            top = _peek(staged)
            if top is None or top[0] > a:
                stuck = ([vals[i].v for _, i in by_ei[-3:]]
                         + [vals[i].v for d, i in staged[:3]
                            if i not in done])
                return invalid({"valid?": False, "op_count": n_ops,
                                "engine": "queue-poly",
                                "error": ["no-linearizable-order",
                                          stuck],
                                "linearized_prefix":
                                    [r.v for r in order[-8:]]})
            _, i = heapq.heappop(staged)
            done.add(i)
            order.append(vals[i])
            n_deq_left -= 1
        else:
            # only never-dequeued enqueues remain: a pure interval
            # order, always acyclic — min-er is always eligible
            while undeq and undeq[-1][1] in done:
                undeq.pop()
            _, i = undeq.pop()
            done.add(i)
            order.append(vals[i])

    return {"valid?": True, "op_count": n_ops, "engine": "queue-poly",
            "order": [r.v for r in order] if n <= 64 else None}
