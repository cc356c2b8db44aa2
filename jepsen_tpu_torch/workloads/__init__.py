"""Reusable workload packages: {generator, checker, (client
requirements)} bundles that DB test suites wire together.

Mirrors the reference's `jepsen.tests.*` namespaces (renamed to
`workloads` because `tests` collides with pytest conventions):

    reference namespace                          here
    ------------------------------------------   -----------------------
    jepsen.tests (noop-test, fakes)              jepsen_tpu_torch.fakes
    jepsen.tests.linearizable-register           .linearizable_register
    tidb.sequential / cockroachdb sequential     .sequential

Each module exposes a `workload(**opts) -> dict` returning at least
{"generator": ..., "checker": ...}; suites merge that into their test
map and add a client.

The port's copy of `jepsen_tpu/workloads/__init__.py`. The reference's
other ten workloads (`adya`, `bank`, `causal`, `causal_reverse`,
`cycle`, `cycle_append`, `cycle_wr`, `long_fork`, `monotonic`, `sets`)
are not ported yet (ROADMAP.md Queue A item 6.5).
"""

from . import linearizable_register, sequential

__all__ = ["linearizable_register", "sequential"]
