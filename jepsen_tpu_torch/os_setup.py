"""OS preparation (parity with jepsen.os, `jepsen/src/jepsen/os.clj:4-14`):
the `OS` protocol, run once per node before DB setup and torn down after
it, and the `Noop` OS.

The port's copy of `jepsen_tpu/os_setup.py:17-33`. The distributions
(hostfile, packages, time sync over `control.nodeutil`) are not ported
yet (ROADMAP.md Queue A item 6).
"""

from __future__ import annotations


class OS:
    """os.clj:4-8."""

    def setup(self, test: dict, node: str) -> None:
        return None

    def teardown(self, test: dict, node: str) -> None:
        return None


class Noop(OS):
    """os.clj:10-14."""


noop = Noop
