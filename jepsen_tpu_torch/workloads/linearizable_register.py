"""Linearizable-register workload over independent keys.

Capability parity with jepsen.tests.linearizable-register
(`jepsen/src/jepsen/tests/linearizable_register.clj:18-53`): clients
understand write / read / cas over [k v] tuple values; the workload
bundles a concurrent multi-key generator (2n threads per key, n of
them reserved for reads), randomized per-key op limits (so key
boundaries drift out of alignment), a process limit, and an
independent checker composing linearizability with a per-key timeline.

The linearizability algorithm defaults to the competition race, whose
device lane runs the CUDA chunk kernels on `device` (default the card)
— this workload is the BASELINE flagship config (100 keys x 2k ops)
generator.

The port's copy of `jepsen_tpu/workloads/linearizable_register.py`,
with the port's `device` option passed through to
`checker.linearizable`.
"""

from __future__ import annotations

import itertools
from typing import Optional

from .. import checker as jchecker
from .. import generator as gen
from .. import independent, models
from ..checker import timeline


def w(test, ctx):
    return {"f": "write", "value": gen.RNG.randrange(5)}


def r(test, ctx):
    return {"f": "read", "value": None}


def cas(test, ctx):
    return {"f": "cas", "value": [gen.RNG.randrange(5),
                                  gen.RNG.randrange(5)]}


def workload(opts: dict) -> dict:
    """{"generator", "checker"} bundle. Options:

    nodes          list of nodes (only the count matters: 2n threads
                   serve each key, n of them reading)
    concurrency    total worker threads available; when fewer than 2n,
                   the per-key group shrinks to fit (the reference
                   would assert instead — independent.clj:118-125 —
                   which makes default "1n" CLI runs explode)
    model          model to check (default cas_register)
    algorithm      linearizable algorithm (default "competition")
    device         where the device lane runs (default the card)
    per_key_limit  max ops per key (randomized x0.9-1.0 per key)
    process_limit  max processes per key (default 20)
    """
    n = len(opts.get("nodes") or [])
    assert n > 0, "need at least one node"
    model = opts.get("model") or models.cas_register()
    per_key_limit = opts.get("per_key_limit")
    process_limit = opts.get("process_limit", 20)
    group = 2 * n
    if opts.get("concurrency"):
        group = max(1, min(group, int(opts["concurrency"])))
    readers = group // 2

    def fgen(k):
        if readers:
            g = gen.reserve(readers, r, gen.mix([w, cas, cas]))
        else:
            # a single-thread group still needs reads to witness state
            g = gen.mix([r, w, cas, cas])
        if per_key_limit:
            g = gen.limit(int((0.9 + gen.RNG.random() * 0.1)
                              * per_key_limit), g)
        return gen.process_limit(process_limit, g)

    return {
        "checker": independent.checker(jchecker.compose({
            "linear": jchecker.linearizable(
                model, algorithm=opts.get("algorithm", "competition"),
                device=opts.get("device")),
            "timeline": timeline.html(),
        })),
        "generator": independent.concurrent_generator(
            group, itertools.count(), fgen),
    }
