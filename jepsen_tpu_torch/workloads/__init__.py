"""Reusable workload packages: {generator, checker, (client
requirements)} bundles that DB test suites wire together.

Mirrors the reference's `jepsen.tests.*` namespaces (renamed to
`workloads` because `tests` collides with pytest conventions):

    reference namespace                          here
    ------------------------------------------   -----------------------
    jepsen.tests (noop-test, fakes)              jepsen_tpu_torch.fakes
    jepsen.tests.linearizable-register           .linearizable_register
    jepsen.tests.bank                            .bank
    jepsen.tests.cycle                           .cycle
    jepsen.tests.cycle.append                    .cycle_append
    jepsen.tests.cycle.wr                        .cycle_wr
    tidb.sequential / cockroachdb sequential     .sequential

Each module exposes a `workload(**opts) -> dict` returning at least
{"generator": ..., "checker": ...}; suites merge that into their test
map and add a client.

The port's copy of `jepsen_tpu/workloads/__init__.py`. The reference's
other six workloads (`adya`, `causal`, `causal_reverse`, `long_fork`,
`monotonic`, `sets`) are not ported yet (ROADMAP.md Queue A item 6.5).
"""

from . import (bank, cycle, cycle_append, cycle_wr, linearizable_register,
               sequential)

__all__ = ["bank", "cycle", "cycle_append", "cycle_wr",
           "linearizable_register", "sequential"]
