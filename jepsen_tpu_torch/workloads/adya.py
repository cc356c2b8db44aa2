"""Adya G2 / G1c anomaly workloads.

Capability parity with jepsen.tests.adya
(`jepsen/src/jepsen/tests/adya.clj:12-87`): for each key, exactly two
concurrent insert txns run — one holding an a-row id, the other a
b-row id ([key [a_id, b_id]] with one id None). Each client must read
both tables by predicate and insert only if both are empty; under
anti-dependency-cycle protection (serializability) at most one insert
per key can succeed. More than one ok insert for a key is a G2
(predicate-based anti-dependency cycle) violation.

The port's copy of `jepsen_tpu/workloads/adya.py`.
"""

from __future__ import annotations

import itertools
import threading

from .. import generator as gen
from .. import independent
from ..checker import Checker


class _Ids:
    """Globally unique id source shared across key generators."""

    def __init__(self):
        self.lock = threading.Lock()
        self.n = 0

    def next(self) -> int:
        with self.lock:
            self.n += 1
            return self.n


def g2_gen():
    """Pairs of insert ops per key, ids globally unique
    (adya.clj:12-57)."""
    ids = _Ids()

    def fgen(k):
        return [
            gen.once(lambda test, ctx:
                     {"f": "insert", "value": [None, ids.next()]}),
            gen.once(lambda test, ctx:
                     {"f": "insert", "value": [ids.next(), None]}),
        ]
    return independent.concurrent_generator(2, itertools.count(), fgen)


class G2Checker(Checker):
    """At most one ok insert per key (adya.clj:59-87). History values
    are [k v] tuples (independent layer)."""

    def check(self, test, history, opts=None):
        counts: dict = {}
        from ..independent import KV
        for op in history:
            if op.f != "insert":
                continue
            v = op.value
            if isinstance(v, KV):
                k = v.k
            elif isinstance(v, (list, tuple)) and v:
                k = v[0]
            else:
                continue
            if op.is_ok:
                counts[k] = counts.get(k, 0) + 1
            else:
                counts.setdefault(k, 0)
        inserted = sum(1 for c in counts.values() if c > 0)
        illegal = {k: c for k, c in sorted(counts.items(),
                                           key=lambda kv: str(kv[0]))
                   if c > 1}
        return {"valid?": not illegal,
                "key-count": len(counts),
                "legal-count": inserted - len(illegal),
                "illegal-count": len(illegal),
                "illegal": illegal}


def g2_checker() -> Checker:
    return G2Checker()


def workload() -> dict:
    return {"checker": g2_checker(), "generator": g2_gen()}
