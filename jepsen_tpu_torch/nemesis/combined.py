"""Composable nemesis packages (parity with jepsen.nemesis.combined,
`jepsen/src/jepsen/nemesis/combined.clj`): a *package* is a dict with
"nemesis", "generator", "final_generator", and "perf" keys; packages for
process kill/pause (via db.Process/db.Pause), network partitions, and
clock faults compose into one nemesis+generator pair
(combined.clj:305-328), with node-spec targeting (:one/:minority/
:majority/:minority-third/:primaries/:all, combined.clj:38-61).

The port's copy of `jepsen_tpu/nemesis/combined.py`.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .. import db as jdb
from .. import generator as gen
from ..util import majority, minority_third
from . import (Compose, Nemesis, Partitioner, RNG, bisect, complete_grudge,
               compose, f_map as nemesis_f_map, majorities_ring, noop as
               nemesis_noop, split_one)
from . import timefaults as nt

DEFAULT_INTERVAL = 10  # seconds between nemesis ops (combined.clj:27-29)

NOOP_PACKAGE = {"generator": None, "final_generator": None,
                "nemesis": nemesis_noop(), "perf": set()}


def random_nonempty_subset(nodes) -> list:
    ns = [n for n in nodes if RNG.random() < 0.5]
    return ns or [RNG.choice(list(nodes))]


def db_nodes(test: dict, db, node_spec) -> list:
    """Resolve a node spec to nodes (combined.clj:38-61)."""
    nodes = list(test["nodes"])
    if node_spec is None:
        return random_nonempty_subset(nodes)
    if node_spec == "one":
        return [RNG.choice(nodes)]
    if node_spec in ("minority", "majority", "minority-third"):
        shuffled = list(nodes)
        RNG.shuffle(shuffled)
        n = len(nodes)
        k = {"minority": majority(n) - 1,
             "majority": majority(n),
             "minority-third": minority_third(n)}[node_spec]
        return shuffled[:k]
    if node_spec == "primaries":
        return random_nonempty_subset(db.primaries(test))
    if node_spec == "all":
        return nodes
    return list(node_spec)


def node_specs(db) -> list:
    """All node specs valid for this DB (combined.clj:63-69)."""
    specs = [None, "one", "minority-third", "minority", "majority", "all"]
    if isinstance(db, jdb.Primary):
        specs.append("primaries")
    return specs


class DBNemesis(Nemesis):
    """start/kill/pause/resume a DB's processes (combined.clj:71-98)."""

    def __init__(self, db):
        self.db = db

    def invoke(self, test, op):
        from .. import control as c
        f = {"start": self.db.start,
             "kill": self.db.kill,
             "pause": self.db.pause,
             "resume": self.db.resume}[op["f"]]
        nodes = db_nodes(test, self.db, op.get("value"))
        res = c.on_nodes(test, lambda t, n: f(t, n), nodes)
        return {**op, "type": "info", "value": res}

    def fs(self):
        return {"start", "kill", "pause", "resume"}


def db_generators(opts: dict) -> dict:
    """Generators for kill/pause faults (combined.clj:100-139)."""
    db = opts["db"]
    faults = opts["faults"]
    kill = isinstance(db, jdb.Process) and "kill" in faults
    pause = isinstance(db, jdb.Pause) and "pause" in faults
    kill_targets = opts.get("kill", {}).get("targets", node_specs(db))
    pause_targets = opts.get("pause", {}).get("targets", node_specs(db))

    start = {"type": "info", "f": "start", "value": "all"}
    resume = {"type": "info", "f": "resume", "value": "all"}

    def kill_op(test, ctx):
        return {"type": "info", "f": "kill",
                "value": RNG.choice(kill_targets)}

    def pause_op(test, ctx):
        return {"type": "info", "f": "pause",
                "value": RNG.choice(pause_targets)}

    modes = []
    final = []
    if pause:
        modes.append(gen.flip_flop(pause_op, gen.repeat(resume)))
        final.append(resume)
    if kill:
        modes.append(gen.flip_flop(kill_op, gen.repeat(start)))
        final.append(start)
    return {"generator": gen.mix(modes) if modes else None,
            "final_generator": final or None}


def db_package(opts: dict) -> dict:
    """Package for killing/pausing the DB (combined.clj:141-161)."""
    needed = bool({"kill", "pause"} & set(opts["faults"]))
    gens = db_generators(opts)
    generator = gen.stagger(opts.get("interval", DEFAULT_INTERVAL),
                            gens["generator"]) \
        if gens["generator"] is not None else None
    return {
        "generator": generator if needed else None,
        "final_generator": gens["final_generator"] if needed else None,
        "nemesis": DBNemesis(opts["db"]),
        "perf": {("kill", frozenset({"kill"}), frozenset({"start"}),
                  "#E9A4A0"),
                 ("pause", frozenset({"pause"}), frozenset({"resume"}),
                  "#A0B1E9")},
    }


def grudge(test: dict, db, part_spec) -> dict:
    """Partition spec -> grudge (combined.clj:163-189)."""
    nodes = list(test["nodes"])
    if part_spec == "one":
        return complete_grudge(split_one(nodes))
    if part_spec == "majority":
        shuffled = list(nodes)
        RNG.shuffle(shuffled)
        return complete_grudge(bisect(shuffled))
    if part_spec == "majorities-ring":
        return majorities_ring(nodes)
    if part_spec == "minority-third":
        shuffled = list(nodes)
        RNG.shuffle(shuffled)
        k = minority_third(len(nodes))
        return complete_grudge([shuffled[:k], shuffled[k:]])
    if part_spec == "primaries":
        primaries = random_nonempty_subset(db.primaries(test))
        rest = [n for n in nodes if n not in set(primaries)]
        return complete_grudge([rest] + [[p] for p in primaries])
    return part_spec  # already a grudge


def partition_specs(db) -> list:
    """combined.clj:191-195."""
    specs = ["one", "minority-third", "majority", "majorities-ring"]
    if isinstance(db, jdb.Primary):
        specs.append("primaries")
    return specs


class PartitionNemesis(Nemesis):
    """Partitioner + partition specs (combined.clj:197-227)."""

    def __init__(self, db, p: Optional[Partitioner] = None):
        self.db = db
        self.p = p or Partitioner()

    def setup(self, test):
        return PartitionNemesis(self.db, self.p.setup(test))

    def invoke(self, test, op):
        if op["f"] == "start-partition":
            g = grudge(test, self.db, op.get("value"))
            res = self.p.invoke(test, {**op, "f": "start", "value": g})
        else:
            res = self.p.invoke(test, {**op, "f": "stop"})
        return {**res, "f": op["f"]}

    def teardown(self, test):
        self.p.teardown(test)

    def fs(self):
        return {"start-partition", "stop-partition"}


def partition_package(opts: dict) -> dict:
    """combined.clj:229-249."""
    needed = "partition" in opts["faults"]
    db = opts["db"]
    targets = opts.get("partition", {}).get("targets", partition_specs(db))

    def start(test, ctx):
        return {"type": "info", "f": "start-partition",
                "value": RNG.choice(targets)}

    stop = {"type": "info", "f": "stop-partition", "value": None}
    g = gen.stagger(opts.get("interval", DEFAULT_INTERVAL),
                    gen.flip_flop(start, gen.repeat(stop)))
    return {"generator": g if needed else None,
            "final_generator": stop if needed else None,
            "nemesis": PartitionNemesis(db),
            "perf": {("partition", frozenset({"start-partition"}),
                      frozenset({"stop-partition"}), "#E9DCA0")}}


def clock_package(opts: dict) -> dict:
    """combined.clj:251-282."""
    needed = "clock" in opts["faults"]
    db = opts["db"]
    nemesis = Compose(
        {_FrozenDict({"reset-clock": "reset",
                      "check-clock-offsets": "check-offsets",
                      "strobe-clock": "strobe",
                      "bump-clock": "bump"}): nt.clock_nemesis()})
    target_specs = opts.get("clock", {}).get("targets", node_specs(db))

    def targets(test):
        spec = RNG.choice(target_specs) if target_specs else None
        return db_nodes(test, db, spec)

    def reset_g(test, ctx):
        return {"type": "info", "f": "reset", "value": targets(test)}

    def bump_g(test, ctx):
        return {"type": "info", "f": "bump",
                "value": {n: int(RNG.choice([-1, 1])
                                 * 2 ** (2 + RNG.random() * 16))
                          for n in targets(test)}}

    def strobe_g(test, ctx):
        return {"type": "info", "f": "strobe",
                "value": {n: {"delta": int(2 ** (2 + RNG.random() * 16)),
                              "period": int(2 ** (RNG.random() * 10)),
                              "duration": RNG.random() * 32}
                          for n in targets(test)}}

    lifted = gen.f_map({"reset": "reset-clock",
                        "check-offsets": "check-clock-offsets",
                        "strobe": "strobe-clock",
                        "bump": "bump-clock"},
                       gen.phases({"type": "info", "f": "check-offsets"},
                                  gen.mix([reset_g, bump_g, strobe_g])))
    g = gen.stagger(opts.get("interval", DEFAULT_INTERVAL), lifted)
    return {"generator": g if needed else None,
            "final_generator": ({"type": "info", "f": "reset-clock"}
                                if needed else None),
            "nemesis": nemesis,
            "perf": {("clock", frozenset({"bump-clock"}),
                      frozenset({"reset-clock"}), "#A0E9E3")}}


class _FrozenDict(dict):
    """A hashable dict usable as a Compose routing key."""

    def __hash__(self):
        return hash(frozenset(self.items()))


def package_f_map(lift, pkg: dict) -> dict:
    """Lift a whole package's fs (combined.clj:284-303)."""
    lift_fn = lift if callable(lift) else lambda f: lift.get(f, f)
    fmap_dict = lift if isinstance(lift, dict) else None

    def lift_gen(g):
        if g is None:
            return None
        if fmap_dict is not None:
            return gen.f_map(fmap_dict, g)
        return gen.map_(lambda o: {**o, "f": lift_fn(o.get("f"))}, g)

    return {**pkg,
            "generator": lift_gen(pkg.get("generator")),
            "final_generator": lift_gen(pkg.get("final_generator")),
            "nemesis": nemesis_f_map(lift_fn, pkg["nemesis"]),
            "perf": {(lift_fn(name),
                      frozenset(lift_fn(f) for f in start),
                      frozenset(lift_fn(f) for f in stop), color)
                     for name, start, stop, color in pkg.get("perf", set())}}


def compose_packages(packages: Sequence[dict]) -> dict:
    """Combine packages: generators via any, finals sequentially,
    nemeses via compose (combined.clj:305-317)."""
    packages = list(packages)
    if not packages:
        return dict(NOOP_PACKAGE)
    if len(packages) == 1:
        return packages[0]
    perf: set = set()
    for p in packages:
        perf |= p.get("perf", set())
    return {
        "generator": gen.any_(*[p["generator"] for p in packages
                                if p.get("generator") is not None]),
        "final_generator": [p["final_generator"] for p in packages
                            if p.get("final_generator") is not None],
        "nemesis": compose([p["nemesis"] for p in packages
                            if p.get("nemesis") is not None]),
        "perf": perf,
    }


def nemesis_packages(opts: dict) -> list:
    """combined.clj:319-327."""
    opts = {**opts, "faults": set(opts.get("faults",
                                           ["partition", "kill", "pause",
                                            "clock"]))}
    return [partition_package(opts), clock_package(opts), db_package(opts)]


def nemesis_package(opts: dict) -> dict:
    """The kitchen-sink nemesis package (combined.clj:329-377)."""
    return compose_packages(nemesis_packages(opts))
