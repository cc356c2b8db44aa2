"""Network fault backend (parity with jepsen.net,
`jepsen/src/jepsen/net.clj` + `net/proto.clj`): the `Net` protocol
(drop/heal/slow/flaky/fast, net.clj:15-26), grudge application via
`drop_all` with the batched PartitionAll fast path (net.clj:29-44,
101-111), and two implementations — iptables/tc (net.clj:58-111) and
ipfilter for SmartOS/illumos (net.clj:113-145).

The port's copy of `jepsen_tpu/net.py`.
"""

from __future__ import annotations

from typing import Optional

from . import control as c
from .control import netinfo
from .control.core import NonzeroExit, lit
from .util import real_pmap

TC = "/sbin/tc"


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


class IPTables(Net, PartitionAll):
    """Default iptables/tc implementation (net.clj:58-111)."""

    def drop(self, test, src, dest):
        with c.on(dest), c.su():
            c.exec_("iptables", "-A", "INPUT", "-s", netinfo.ip(src),
                    "-j", "DROP", "-w")

    def heal(self, test):
        def f(t, n):
            with c.su():
                c.exec_("iptables", "-F", "-w")
                c.exec_("iptables", "-X", "-w")
        c.on_nodes(test, f)

    def slow(self, test, opts=None):
        opts = opts or {}
        mean = opts.get("mean", 50)
        variance = opts.get("variance", 10)
        distribution = opts.get("distribution", "normal")

        def f(t, n):
            with c.su():
                c.exec_(TC, "qdisc", "add", "dev", "eth0", "root", "netem",
                        "delay", f"{mean}ms", f"{variance}ms",
                        "distribution", distribution)
        c.on_nodes(test, f)

    def flaky(self, test):
        def f(t, n):
            with c.su():
                c.exec_(TC, "qdisc", "add", "dev", "eth0", "root", "netem",
                        "loss", "20%", "75%")
        c.on_nodes(test, f)

    def fast(self, test):
        def f(t, n):
            try:
                with c.su():
                    c.exec_(TC, "qdisc", "del", "dev", "eth0", "root")
            except NonzeroExit as e:
                if "RTNETLINK answers: No such file or directory" not in (
                        e.result.get("err") or ""):
                    raise
        c.on_nodes(test, f)

    def drop_all(self, test, grudge):
        """One batched iptables rule per node (net.clj:101-111)."""
        def snub(t, node):
            srcs = grudge.get(node)
            if srcs:
                with c.su():
                    c.exec_("iptables", "-A", "INPUT", "-s",
                            ",".join(netinfo.ip(s) for s in srcs),
                            "-j", "DROP", "-w")
        c.on_nodes(test, snub, list(grudge.keys()))


iptables = IPTables


class IPFilter(Net):
    """ipfilter implementation for SmartOS/illumos (net.clj:113-145)."""

    def drop(self, test, src, dest):
        with c.on(dest), c.su():
            c.exec_("echo", "block", "in", "from", src, "to", "any",
                    lit("|"), "ipf", "-f", "-")

    def heal(self, test):
        def f(t, n):
            with c.su():
                c.exec_("ipf", "-Fa")
        c.on_nodes(test, f)

    def slow(self, test, opts=None):
        IPTables.slow(self, test, opts)  # type: ignore[arg-type]

    def flaky(self, test):
        IPTables.flaky(self, test)  # type: ignore[arg-type]

    def fast(self, test):
        def f(t, n):
            with c.su():
                c.exec_(TC, "qdisc", "del", "dev", "eth0", "root")
        c.on_nodes(test, f)


ipfilter = IPFilter
