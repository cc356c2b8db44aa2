"""Reusable workload packages: {generator, checker, (client
requirements)} bundles that DB test suites wire together.

Mirrors the reference's `jepsen.tests.*` namespaces (renamed to
`workloads` because `tests` collides with pytest conventions):

    reference namespace                          here
    ------------------------------------------   -----------------------
    jepsen.tests (noop-test, fakes)              jepsen_tpu_torch.fakes
    jepsen.tests.linearizable-register           .linearizable_register
    jepsen.tests.bank                            .bank
    jepsen.tests.long-fork                       .long_fork
    jepsen.tests.causal                          .causal
    jepsen.tests.adya                            .adya
    jepsen.tests.cycle                           .cycle
    jepsen.tests.cycle.append                    .cycle_append
    jepsen.tests.cycle.wr                        .cycle_wr
    tidb.sequential / cockroachdb sequential     .sequential
    tidb.monotonic / faunadb monotonic           .monotonic

Each module exposes a `workload(**opts) -> dict` returning at least
{"generator": ..., "checker": ...}; suites merge that into their test
map and add a client.

The port's copy of `jepsen_tpu/workloads/__init__.py`.
"""

from . import (adya, bank, causal, causal_reverse, cycle, cycle_append,
               cycle_wr, linearizable_register, long_fork, monotonic,
               sequential, sets)

__all__ = ["adya", "bank", "causal", "causal_reverse", "cycle",
           "cycle_append", "cycle_wr", "linearizable_register",
           "long_fork", "monotonic", "sequential", "sets"]
