"""Network fault backend protocols (parity with jepsen.net,
`jepsen/src/jepsen/net.clj` + `net/proto.clj`): the `Net` protocol
(drop/heal/slow/flaky/fast, net.clj:15-26), grudge application via
`drop_all` with the batched `PartitionAll` fast path (net.clj:29-44),
and the `Noop` net.

The port's copy of `jepsen_tpu/net.py:20-78`. The iptables/tc and
ipfilter implementations (`IPTables`, `IPFilter`) are not ported yet
(ROADMAP.md Queue A item 6).
"""

from __future__ import annotations

from typing import Optional

from .util import real_pmap


class Net:
    """net.clj:15-26."""

    def drop(self, test: dict, src: str, dest: str) -> None:
        raise NotImplementedError

    def heal(self, test: dict) -> None:
        raise NotImplementedError

    def slow(self, test: dict, opts: Optional[dict] = None) -> None:
        raise NotImplementedError

    def flaky(self, test: dict) -> None:
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        raise NotImplementedError


class PartitionAll:
    """Optional fast path: apply a whole grudge at once
    (net/proto.clj:5-11)."""

    def drop_all(self, test: dict, grudge: dict) -> None:
        raise NotImplementedError


def drop_all(test: dict, grudge: dict) -> None:
    """Apply a grudge — {node: set of nodes it should drop traffic from}
    (net.clj:29-44)."""
    net = test["net"]
    if isinstance(net, PartitionAll):
        net.drop_all(test, grudge)
        return
    pairs = [(src, dst) for dst, srcs in grudge.items() for src in srcs]
    real_pmap(lambda p: net.drop(test, p[0], p[1]), pairs)


class Noop(Net):
    """net.clj:49-57."""

    def drop(self, test, src, dest):
        pass

    def heal(self, test):
        pass

    def slow(self, test, opts=None):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass


noop = Noop
