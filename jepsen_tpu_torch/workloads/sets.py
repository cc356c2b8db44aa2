"""Set workload: unique adds, then read it all back.

The reference has no jepsen.tests.set namespace — every suite wires
its own add-stream against `checker/set` or `checker/set-full`
(e.g. the tutorial set test `doc/tutorial/08-set.md`, zookeeper-style
suites, and checker.clj:240-291/294-592). This bundles that common
shape: a stream of unique integer adds, a final read phase, and both
set checkers composed.

The port's copy of `jepsen_tpu/workloads/sets.py`.
"""

from __future__ import annotations

import itertools
from typing import Optional

from .. import checker as jchecker
from .. import generator as gen


def adds():
    """add 0, add 1, add 2, ... (one-shot per value)."""
    counter = itertools.count()

    def add(test, ctx):
        return {"f": "add", "value": next(counter)}
    return add


def final_read(test, ctx):
    return {"f": "read", "value": None}


def workload(opts: Optional[dict] = None) -> dict:
    """Adds for time_limit seconds, then a read on every client
    (tutorial 08: add-until-timeout then read)."""
    opts = opts or {}
    return {
        "checker": jchecker.compose({
            "set": jchecker.set_checker(),
            "set-full": jchecker.set_full(
                linearizable=opts.get("linearizable", False)),
        }),
        "generator": gen.phases(
            gen.time_limit(opts.get("time_limit", 60),
                           gen.clients(adds())),
            gen.clients(gen.each_thread(gen.once(final_read)))),
    }
