"""Fault injection: nemeses alter the cluster through the same
invoke-shaped interface clients use.

Capability parity with jepsen.nemesis (`jepsen/src/jepsen/nemesis.clj`):
the `Nemesis` protocol (:11-16) and `Reflection.fs` (:18-21), grudge
algebra (complete_grudge :120-132, invert_grudge, bridge :144-155,
majorities_ring :202-275 in exact ≤5-node and stochastic variants),
partitioners (:157-200), `f_map` (:285-327) and `compose` (:329-428)
for building composite nemeses, clock scrambling (:435-450),
node start/stoppers and SIGSTOP hammering (:452-511), and file
truncation (:513-539).

The port's copy of `jepsen_tpu/nemesis/__init__.py`. The composite
nemesis packages are ported beside it, as in the reference:
`nemesis/combined.py` (kill/pause, partition and clock packages),
`timefaults.py` (clock skew), `faultfs.py` (filesystem faults) and
`membership.py` (cluster growth and shrinkage).
"""

from __future__ import annotations

import logging
import random as _random
import threading
import time as _time
from typing import Any, Callable, Iterable, Optional, Sequence

from .. import control as c
from .. import net as jnet
from ..util import majority, timeout as util_timeout

log = logging.getLogger("jepsen_tpu_torch.nemesis")

RNG = _random.Random()


class Nemesis:
    """nemesis.clj:11-16."""

    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        return None

    def fs(self) -> set:
        """Reflection: which :f values this nemesis handles
        (nemesis.clj:18-21)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support Reflection/fs")


class Noop(Nemesis):
    """nemesis.clj:40-47."""

    def invoke(self, test, op):
        return op

    def fs(self):
        return set()


noop = Noop


class InvalidNemesisCompletion(Exception):
    pass


class Validate(Nemesis):
    """Validates setup/invoke responses (nemesis.clj:49-90)."""

    def __init__(self, nemesis: Nemesis):
        self.nemesis = nemesis

    def setup(self, test):
        res = self.nemesis.setup(test)
        if not isinstance(res, Nemesis):
            raise TypeError(f"expected setup to return a Nemesis, "
                            f"got {res!r}")
        return Validate(res)

    def invoke(self, test, op):
        op2 = self.nemesis.invoke(test, op)
        problems = []
        if not isinstance(op2, dict):
            problems.append("should be a dict")
        else:
            if op2.get("type") != "info":
                problems.append("type should be info")
            if op2.get("process") != op.get("process"):
                problems.append("process should be the same")
            if op2.get("f") != op.get("f"):
                problems.append("f should be the same")
        if problems:
            raise InvalidNemesisCompletion(
                f"nemesis completed {op!r} with {op2!r}: "
                + "; ".join(problems))
        return op2

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return self.nemesis.fs()


def validate(nemesis: Nemesis) -> Validate:
    return Validate(nemesis)


class Timeout(Nemesis):
    """Bound invoke time; timed-out ops get value "timeout"
    (nemesis.clj:92-107)."""

    def __init__(self, timeout_s: float, nemesis: Nemesis):
        self.timeout_s = timeout_s
        self.nemesis = nemesis

    def setup(self, test):
        return Timeout(self.timeout_s, self.nemesis.setup(test))

    def invoke(self, test, op):
        res = util_timeout(self.timeout_s,
                           lambda: self.nemesis.invoke(test, op),
                           default={**op, "value": "timeout"})
        return res

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return self.nemesis.fs()


# ---------------------------------------------------------------------------
# Grudge algebra (nemesis.clj:109-275)
# ---------------------------------------------------------------------------

def bisect(coll: Sequence) -> list:
    """Cut a sequence in half; smaller half first (nemesis.clj:109-112)."""
    n = len(coll) // 2
    return [list(coll[:n]), list(coll[n:])]


def split_one(coll: Sequence, loner=None) -> list:
    """Split one node from the rest (nemesis.clj:114-119)."""
    if loner is None:
        loner = RNG.choice(list(coll))
    return [[loner], [x for x in coll if x != loner]]


def complete_grudge(components: Iterable[Sequence]) -> dict:
    """{node: set of nodes it cannot talk to}, isolating each component
    (nemesis.clj:120-132)."""
    comps = [set(comp) for comp in components]
    universe = set().union(*comps) if comps else set()
    grudge = {}
    for comp in comps:
        for node in comp:
            grudge[node] = universe - comp
    return grudge


def invert_grudge(nodes: Iterable, conns: dict) -> dict:
    """Connections -> non-connections (nemesis.clj:134-142)."""
    ns = set(nodes)
    return {a: ns - set(conns.get(a, set())) for a in sorted(ns, key=str)}


def bridge(nodes: Sequence) -> dict:
    """Cut the network in half, preserving one bridge node connected to
    both sides (nemesis.clj:144-155)."""
    comps = bisect(nodes)
    br = comps[1][0]
    grudge = complete_grudge(comps)
    grudge.pop(br, None)
    return {k: v - {br} for k, v in grudge.items()}


def majorities_ring_perfect(nodes: Sequence) -> dict:
    """Exact variant for <=5 nodes (nemesis.clj:202-218)."""
    U = set(nodes)
    n = len(nodes)
    m = majority(n)
    shuffled = list(nodes)
    RNG.shuffle(shuffled)
    ring = shuffled * 2
    grudge = {}
    for i in range(n):
        maj = ring[i:i + m]
        center = maj[len(maj) // 2]
        grudge[center] = U - set(maj)
    return grudge


def majorities_ring_stochastic(nodes: Sequence) -> dict:
    """Stochastic variant for larger clusters (nemesis.clj:220-258)."""
    n = len(nodes)
    m = majority(n)
    conns = {x: {x} for x in nodes}
    while True:
        degrees = sorted(((len(v), k) for k, v in conns.items()),
                         key=lambda dk: (dk[0], RNG.random()))
        a_deg, a = degrees[0]
        if a_deg >= m:
            return invert_grudge(nodes, conns)
        for b_deg, b in degrees[1:]:
            if b not in conns[a]:
                conns[a].add(b)
                conns[b].add(a)
                break
        else:
            return invert_grudge(nodes, conns)


def majorities_ring(nodes: Sequence) -> dict:
    """Every node sees a majority; no two see the same one
    (nemesis.clj:260-275)."""
    if len(nodes) <= 5:
        return majorities_ring_perfect(nodes)
    return majorities_ring_stochastic(nodes)


# ---------------------------------------------------------------------------
# Partitioners (nemesis.clj:157-200, 277-281)
# ---------------------------------------------------------------------------

class Partitioner(Nemesis):
    """start -> apply a grudge; stop -> heal (nemesis.clj:157-183). The
    grudge comes from the op's value, or from grudge_fn(test nodes)."""

    def __init__(self, grudge_fn: Optional[Callable] = None):
        self.grudge_fn = grudge_fn

    def setup(self, test):
        test["net"].heal(test)
        return self

    def invoke(self, test, op):
        f = op.get("f")
        if f == "start":
            grudge = op.get("value")
            if grudge is None:
                if self.grudge_fn is None:
                    raise ValueError(
                        f"expected op {op!r} to have a grudge for a value")
                grudge = self.grudge_fn(list(test["nodes"]))
            jnet.drop_all(test, grudge)
            log.info("Cut off %r", grudge)
            return {**op, "type": "info",
                    "value": ["isolated", {k: sorted(v, key=str)
                                           for k, v in grudge.items()}]}
        if f == "stop":
            test["net"].heal(test)
            log.info("Network healed")
            return {**op, "type": "info", "value": "network-healed"}
        raise ValueError(f"partitioner can't handle {f!r}")

    def teardown(self, test):
        test["net"].heal(test)

    def fs(self):
        return {"start", "stop"}


def partitioner(grudge_fn: Optional[Callable] = None) -> Partitioner:
    return Partitioner(grudge_fn)


def partition_halves() -> Partitioner:
    """First half vs second half (nemesis.clj:185-190)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves() -> Partitioner:
    """Random halves (nemesis.clj:192-195)."""
    def f(nodes):
        nodes = list(nodes)
        RNG.shuffle(nodes)
        return complete_grudge(bisect(nodes))
    return Partitioner(f)


def partition_random_node() -> Partitioner:
    """Isolate one random node (nemesis.clj:197-200)."""
    return Partitioner(lambda nodes: complete_grudge(split_one(nodes)))


def partition_majorities_ring() -> Partitioner:
    """nemesis.clj:277-281."""
    return Partitioner(majorities_ring)


# ---------------------------------------------------------------------------
# Composition (nemesis.clj:283-428)
# ---------------------------------------------------------------------------

class FMap(Nemesis):
    """Remap the :f values a nemesis accepts (nemesis.clj:285-327)."""

    def __init__(self, lift: Callable, nemesis: Nemesis):
        self.lift = lift
        self.nemesis = nemesis
        self.unlift = {lift(f): f for f in nemesis.fs()}

    def setup(self, test):
        return FMap(self.lift, self.nemesis.setup(test))

    def invoke(self, test, op):
        inner = {**op, "f": self.unlift[op["f"]]}
        res = self.nemesis.invoke(test, inner)
        return {**res, "f": self.lift(res["f"])}

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return {self.lift(f) for f in self.nemesis.fs()}


def f_map(lift: Callable, nemesis: Nemesis) -> FMap:
    return FMap(lift, nemesis)


class Compose(Nemesis):
    """Route ops to child nemeses by :f (nemesis.clj:329-428). Takes
    either a dict {f-mapping: nemesis} — where f-mapping is a set of fs
    or a dict renaming outer fs to inner fs — or a list of nemeses
    supporting Reflection."""

    def __init__(self, nemeses):
        self.nemeses = nemeses
        if isinstance(nemeses, dict):
            self.routes = None
        else:
            routes: dict = {}
            for i, n in enumerate(nemeses):
                for f in n.fs():
                    assert f not in routes, (
                        f"nemeses {n!r} and {nemeses[routes[f]]!r} are "
                        f"mutually incompatible; both use f {f!r}")
                    routes[f] = i
            self.routes = routes

    def setup(self, test):
        if isinstance(self.nemeses, dict):
            return Compose({k: n.setup(test)
                            for k, n in self.nemeses.items()})
        return Compose([n.setup(test) for n in self.nemeses])

    def invoke(self, test, op):
        f = op.get("f")
        if self.routes is not None:
            i = self.routes.get(f)
            if i is None:
                raise ValueError(
                    f"no nemesis can handle f {f!r} "
                    f"(expected one of {sorted(self.routes, key=str)})")
            return self.nemeses[i].invoke(test, op)
        for fmapping, nem in self.nemeses.items():
            if isinstance(fmapping, dict):
                f2 = fmapping.get(f)
            elif f in fmapping:
                f2 = f
            else:
                f2 = None
            if f2 is not None:
                res = nem.invoke(test, {**op, "f": f2})
                return {**res, "f": f}
        raise ValueError(f"no nemesis can handle {f!r}")

    def teardown(self, test):
        ns = (self.nemeses.values() if isinstance(self.nemeses, dict)
              else self.nemeses)
        for n in ns:
            n.teardown(test)

    def fs(self):
        if self.routes is not None:
            return set(self.routes)
        out: set = set()
        for fmapping in self.nemeses:
            if isinstance(fmapping, dict):
                out |= set(fmapping.keys())
            elif isinstance(fmapping, (set, frozenset)):
                out |= set(fmapping)
            else:
                raise TypeError(
                    "can only infer fs from dict- or set-keyed compose")
        return out


def compose(nemeses) -> Compose:
    return Compose(nemeses if isinstance(nemeses, dict) else list(nemeses))


# ---------------------------------------------------------------------------
# Clock + process faults (nemesis.clj:430-539)
# ---------------------------------------------------------------------------

def set_time(t: float) -> None:
    """Set node time in POSIX seconds (nemesis.clj:430-433)."""
    with c.su():
        c.exec_("date", "+%s", "-s", f"@{int(t)}")


class ClockScrambler(Nemesis):
    """Randomize node clocks within a dt-second window
    (nemesis.clj:435-450)."""

    def __init__(self, dt: float):
        self.dt = dt

    def invoke(self, test, op):
        def f(t, node):
            set_time(_time.time() + RNG.uniform(-self.dt, self.dt))
        value = c.on_nodes(test, f)
        return {**op, "type": "info", "value": value}

    def teardown(self, test):
        def f(t, node):
            set_time(_time.time())
        c.on_nodes(test, f)

    def fs(self):
        return {"scramble-clock"}


def clock_scrambler(dt: float) -> ClockScrambler:
    return ClockScrambler(dt)


class NodeStartStopper(Nemesis):
    """start -> run start_fn on targeted nodes; stop -> stop_fn
    (nemesis.clj:452-495)."""

    def __init__(self, targeter: Callable, start_fn: Callable,
                 stop_fn: Callable):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self.nodes: Optional[list] = None
        self.lock = threading.Lock()

    def invoke(self, test, op):
        with self.lock:
            f = op.get("f")
            if f == "start":
                try:
                    ns = self.targeter(test, list(test["nodes"]))
                except TypeError:
                    ns = self.targeter(list(test["nodes"]))
                if ns is None:
                    value = "no-target"
                elif self.nodes is not None:
                    value = f"nemesis already disrupting {self.nodes!r}"
                else:
                    if not isinstance(ns, (list, tuple, set)):
                        ns = [ns]
                    ns = list(ns)
                    value = c.on_many(
                        ns, lambda: self.start_fn(test, c.state.host))
                    self.nodes = ns
            elif f == "stop":
                if self.nodes is None:
                    value = "not-started"
                else:
                    value = c.on_many(
                        self.nodes,
                        lambda: self.stop_fn(test, c.state.host))
                    self.nodes = None
            else:
                raise ValueError(f"can't handle {f!r}")
            return {**op, "type": "info", "value": value}

    def fs(self):
        return {"start", "stop"}


def node_start_stopper(targeter, start_fn, stop_fn) -> NodeStartStopper:
    return NodeStartStopper(targeter, start_fn, stop_fn)


def hammer_time(process: str, targeter: Optional[Callable] = None
                ) -> NodeStartStopper:
    """SIGSTOP/SIGCONT a process on targeted nodes (nemesis.clj:497-511)."""
    if targeter is None:
        targeter = lambda nodes: RNG.choice(nodes)  # noqa: E731

    def start(test, node):
        with c.su():
            c.exec_("killall", "-s", "STOP", process)
        return ["paused", process]

    def stop(test, node):
        with c.su():
            c.exec_("killall", "-s", "CONT", process)
        return ["resumed", process]

    return NodeStartStopper(targeter, start, stop)


class TruncateFile(Nemesis):
    """Drop the last bytes of files on nodes (nemesis.clj:513-539); op
    value is {node: {"file": path, "drop": bytes}}."""

    def invoke(self, test, op):
        assert op.get("f") == "truncate"
        plan = op["value"]

        def f(t, node):
            spec = plan[node]
            with c.su():
                c.exec_("truncate", "-c", "-s", f"-{spec['drop']}",
                        spec["file"])
        c.on_nodes(test, f, list(plan.keys()))
        return {**op, "type": "info"}

    def fs(self):
        return {"truncate"}


def truncate_file() -> TruncateFile:
    return TruncateFile()
