"""Sequential-consistency workload (tidb/src/tidb/sequential.clj:1-140,
also shipped by the cockroachdb suite).

A writer inserts a key's subkeys k_0 .. k_{n-1} in order, each in its
own transaction; a reader reads them in REVERSE order (k_{n-1} first).
Process order guarantees k_0 is visible before k_1, so a read vector
may be all-present, a prefix of nils followed by values (the writer
was mid-flight), or all-nil — but a nil AFTER a non-nil element
("trailing nil": we saw k_1 but not k_0) violates sequential
consistency.

The client contract: ops are
    {"f": "write", "value": k}          insert each subkey in order
    {"f": "read",  "value": [k, vs]}    read subkeys reversed; vs is
                                        the observed list (None for
                                        missing)

The port's copy of `jepsen_tpu/workloads/sequential.py`.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from .. import checker as jchecker
from .. import generator as gen

DEFAULT_KEY_COUNT = 5


def subkeys(key_count: int, k) -> list:
    """The subkeys for key k, in write order (sequential.clj:44-47)."""
    return [f"{k}_{i}" for i in range(key_count)]


def trailing_nil(coll) -> bool:
    """A nil anywhere after a non-nil element (sequential.clj:90-93)."""
    it = iter(coll)
    for x in it:
        if x is not None:
            break
    return any(x is None for x in it)


class SequentialChecker(jchecker.Checker):
    """Classify read vectors: all / some / none / bad
    (sequential.clj:95-117)."""

    def check(self, test, history, opts=None):
        key_count = test.get("key_count") or DEFAULT_KEY_COUNT
        reads = [op.value for op in history
                 if op.is_ok and op.f == "read"
                 and isinstance(op.value, (list, tuple))
                 and len(op.value) == 2]
        none = [r for r in reads if all(v is None for v in r[1])]
        some = [r for r in reads if any(v is None for v in r[1])]
        bad = [r for r in reads if trailing_nil(r[1])]
        all_ = [r for r in reads
                if list(r[1]) == subkeys(key_count, r[0])[::-1]]
        return {"valid?": not bad,
                "all-count": len(all_), "some-count": len(some),
                "none-count": len(none), "bad-count": len(bad),
                "bad": bad[:10]}


def checker() -> jchecker.Checker:
    return SequentialChecker()


class _Writes:
    """Sequential integer keys, logging the most recent into the shared
    ring (sequential.clj:119-128)."""

    def __init__(self, last_written: deque):
        self.k = -1
        self.last_written = last_written

    def __call__(self, test, ctx):
        self.k += 1
        self.last_written.append(self.k)
        return {"f": "write", "value": self.k}


class _Reads:
    """Read a randomly selected recently-written key
    (sequential.clj:130-136)."""

    def __init__(self, last_written: deque):
        self.last_written = last_written

    def __call__(self, test, ctx):
        if not self.last_written:
            return {"f": "read", "value": [0, []]}
        k = gen.RNG.choice(list(self.last_written))
        return {"f": "read", "value": [k, []]}


def generator(n_writers: int = 2):
    """n writer threads + readers over a 2n-deep recency buffer
    (sequential.clj:138-145)."""
    last_written: deque = deque(maxlen=2 * n_writers)
    return gen.reserve(n_writers, _Writes(last_written),
                       _Reads(last_written))


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    return {"checker": checker(),
            "generator": generator(opts.get("n_writers", 2)),
            "key_count": opts.get("key_count", DEFAULT_KEY_COUNT)}
