"""Strict-serializability reverse-order anomaly detection.

Capability parity with jepsen.tests.causal-reverse
(`jepsen/src/jepsen/tests/causal_reverse.clj:1-114`): writers blind-
insert distinct keys; readers read all keys in a txn. Replaying the
history we track, for each write w, the set of writes acknowledged
before w was invoked; any read observing w but missing one of those
prior writes shows T2 visible without T1 < T2.

The port's copy of `jepsen_tpu/workloads/causal_reverse.py`.
"""

from __future__ import annotations

import itertools

from .. import checker as jchecker
from .. import generator as gen
from .. import independent
from ..checker import Checker


def graph(history) -> dict:
    """{written-value: set of values acked before its invocation}
    (causal_reverse.clj:21-48)."""
    completed: set = set()
    expected: dict = {}
    for op in history:
        if op.f != "write":
            continue
        if op.is_invoke:
            expected[op.value] = set(completed)
        elif op.is_ok:
            completed.add(op.value)
    return expected


def errors(history, expected: dict) -> list:
    """Reads that observe a write but miss one of its predecessors
    (causal_reverse.clj:50-73)."""
    out = []
    for op in history:
        if not (op.is_ok and op.f == "read"):
            continue
        seen = set(op.value or [])
        our_expected: set = set()
        for v in seen:
            our_expected |= expected.get(v, set())
        missing = our_expected - seen
        if missing:
            d = op.to_dict()
            d.pop("value", None)
            d["missing"] = sorted(missing)
            d["expected-count"] = len(our_expected)
            out.append(d)
    return out


class CausalReverseChecker(Checker):
    """causal_reverse.clj:75-84."""

    def check(self, test, history, opts=None):
        errs = errors(history, graph(history))
        return {"valid?": not errs, "errors": errs}


def checker() -> Checker:
    return CausalReverseChecker()


def workload(opts: dict) -> dict:
    """Per-key mixed blind writes (distinct values) and whole-set reads
    (causal_reverse.clj:86-114)."""
    n = len(opts.get("nodes") or []) or 1
    per_key_limit = opts.get("per_key_limit", 500)

    def fgen(k):
        # distinct write values per key; reads repeat (fn generators
        # repeat, map generators are one-shot — the reference passes a
        # bare map here, which emits a single read per key and carries
        # a TODO doubting itself; a repeating read is the intent)
        counter = itertools.count()

        def write_op(test, ctx):
            return {"f": "write", "value": next(counter)}

        def read_op(test, ctx):
            return {"f": "read", "value": None}

        return gen.limit(per_key_limit,
                         gen.stagger(1 / 100,
                                     gen.mix([read_op, write_op])))

    return {
        "checker": jchecker.compose({
            "perf": jchecker.perf(),
            "sequential": independent.checker(checker()),
        }),
        "generator": independent.concurrent_generator(
            n, itertools.count(), fgen),
    }
