"""The port's composite nemeses and clock faults, held against the JAX
package: `nemesis/combined.py` (the twins of `tests/test_nemesis.py`'s
combined-package cases), `nemesis/timefaults.py` and `faketime.py`.

Each parity case runs both packages from the same seeded `RNG`s
(`nemesis.RNG`, `generator.RNG`, `faketime.RNG`) over a recording dummy
remote of their own package that answers the clock reads: the node
specs resolved, the generators' first 50 ops, and every command each
node was sent, in order, must equal the reference's. Nothing here runs a
command on this machine: the clock tools need root and a real node.
"""

import time

import pytest

import jepsen_tpu.control as ref_c
import jepsen_tpu.control.dummy as ref_dummy
import jepsen_tpu.db as ref_db
import jepsen_tpu.faketime as ref_faketime
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.nemesis as ref_nem
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.nemesis import combined as ref_combined
from jepsen_tpu.nemesis import timefaults as ref_timefaults
import jepsen_tpu_torch.control as port_c
import jepsen_tpu_torch.control.dummy as port_dummy
import jepsen_tpu_torch.db as port_db
import jepsen_tpu_torch.faketime as port_faketime
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.nemesis as port_nem
from jepsen_tpu_torch.generator import testlib as port_testlib
from jepsen_tpu_torch.nemesis import combined
from jepsen_tpu_torch.nemesis import timefaults as port_timefaults

NODES = ["n1", "n2", "n3", "n4", "n5"]
SEEDS = (0, 1, 2)


class Pkg:
    def __init__(self, c, dummy, db, gen, testlib, nem, combined_,
                 timefaults, faketime):
        self.c, self.dummy, self.db, self.gen = c, dummy, db, gen
        self.testlib, self.nem, self.combined = testlib, nem, combined_
        self.timefaults, self.faketime = timefaults, faketime

    def seed(self, seed: int) -> None:
        for rng in (self.nem.RNG, self.gen.RNG, self.faketime.RNG):
            rng.seed(seed)


REF = Pkg(ref_c, ref_dummy, ref_db, ref_gen, ref_testlib, ref_nem,
          ref_combined, ref_timefaults, ref_faketime)
PORT = Pkg(port_c, port_dummy, port_db, port_gen, port_testlib, port_nem,
           combined, port_timefaults, port_faketime)


def killable(pkg: Pkg):
    """A DB with the kill/pause fault surface that records its calls."""
    class KillableDB(pkg.db.DB, pkg.db.Process, pkg.db.Pause):
        def __init__(self):
            self.events = []

        def start(self, test, node):
            self.events.append(("start", node))
            return "started"

        def kill(self, test, node):
            self.events.append(("kill", node))
            return "killed"

        def pause(self, test, node):
            self.events.append(("pause", node))
            return "paused"

        def resume(self, test, node):
            self.events.append(("resume", node))
            return "resumed"

    return KillableDB()


def dummy_sessions(pkg: Pkg, nodes):
    r = pkg.dummy.remote()
    return {node: r.connect({"host": node}) for node in nodes}


# -- the twins of tests/test_nemesis.py's combined packages ------------------

def test_db_nodes_specs():
    t = {"nodes": NODES}
    db = killable(PORT)
    assert combined.db_nodes(t, db, "all") == NODES
    assert len(combined.db_nodes(t, db, "one")) == 1
    assert len(combined.db_nodes(t, db, "majority")) == 3
    assert len(combined.db_nodes(t, db, "minority")) == 2
    assert len(combined.db_nodes(t, db, "minority-third")) == 1
    assert combined.db_nodes(t, db, ["n2"]) == ["n2"]
    assert 1 <= len(combined.db_nodes(t, db, None)) <= 5


def test_db_nemesis_kill():
    db = killable(PORT)
    t = {"nodes": NODES, "sessions": dummy_sessions(PORT, NODES)}
    nem = combined.DBNemesis(db)
    res = nem.invoke(t, {"f": "kill", "process": "nemesis", "value": "all"})
    assert res["type"] == "info"
    assert {e[0] for e in db.events} == {"kill"}
    assert len(db.events) == 5


def test_nemesis_package_composition():
    db = killable(PORT)
    pkg = combined.nemesis_package({
        "db": db, "faults": ["partition", "kill", "pause"], "interval": 1})
    assert pkg["generator"] is not None
    assert pkg["nemesis"].fs() >= {"start", "kill", "pause", "resume",
                                  "start-partition", "stop-partition"}
    # final generators heal everything
    finals = pkg["final_generator"]
    fs = set()
    for g in finals:
        if isinstance(g, list):
            fs |= {x["f"] for x in g}
        elif isinstance(g, dict):
            fs.add(g["f"])
    assert "start" in fs and "resume" in fs


def test_package_generator_emits_lifted_ops():
    db = killable(PORT)
    pkg = combined.partition_package(
        {"db": db, "faults": {"partition"}, "interval": 1e-9})
    out = port_testlib.quick_ops(port_gen.limit(
        6, port_gen.nemesis(pkg["generator"])))
    fs = [o["f"] for o in out if o["type"] == "info"]
    assert set(fs) <= {"start-partition", "stop-partition"}
    assert fs[0] == "start-partition"


# -- parity: node specs, generators ---------------------------------------

def primary_db(pkg: Pkg):
    """A DB with primaries (`db.Primary`) and the kill/pause surface."""
    class DB(pkg.db.DB, pkg.db.Process, pkg.db.Pause, pkg.db.Primary):
        def primaries(self, test):
            return test["nodes"][1:4]

        def setup_primary(self, test, node):
            return None

        def start(self, test, node):
            return "started"

        def kill(self, test, node):
            return "killed"

        def pause(self, test, node):
            return "paused"

        def resume(self, test, node):
            return "resumed"

    return DB()


SPECS = [None, "one", "minority", "majority", "minority-third",
         "primaries", "all", ["n4", "n2"]]


@pytest.mark.parametrize("seed", SEEDS)
def test_db_nodes_and_specs_match_reference(seed):
    def run(pkg):
        pkg.seed(seed)
        db = primary_db(pkg)
        t = {"nodes": NODES}
        return ([pkg.combined.db_nodes(t, db, s) for s in SPECS * 3],
                pkg.combined.node_specs(db),
                pkg.combined.node_specs(killable(pkg)),
                pkg.combined.partition_specs(db),
                [pkg.combined.grudge(t, db, s) for s in
                 ("one", "majority", "majorities-ring", "minority-third",
                  "primaries")] * 2)
    assert run(PORT) == run(REF)


PACKAGES = {
    "kitchen-sink": lambda pkg, db: pkg.combined.nemesis_package(
        {"db": db, "interval": 1}),
    "partition": lambda pkg, db: pkg.combined.partition_package(
        {"db": db, "faults": {"partition"}, "interval": 1}),
    "clock": lambda pkg, db: pkg.combined.clock_package(
        {"db": db, "faults": {"clock"}, "interval": 1}),
    "db": lambda pkg, db: pkg.combined.db_package(
        {"db": db, "faults": {"kill", "pause"}, "interval": 1}),
    "lifted": lambda pkg, db: pkg.combined.package_f_map(
        {"start": "start-db", "kill": "kill-db"},
        pkg.combined.db_package({"db": db, "faults": {"kill"},
                                 "interval": 1})),
}


def quick_ops(pkg: Pkg, gen, test: dict) -> list:
    """`testlib.quick_ops` over `test` (every op completes ok at once)."""
    return pkg.testlib.simulate(gen, lambda c, inv: {**inv, "type": "ok"},
                                None, test)


def first_ops(pkg: Pkg, which: str, seed: int, n: int = 50):
    pkg.seed(seed)
    p = PACKAGES[which](pkg, primary_db(pkg))
    ops = quick_ops(pkg, pkg.gen.limit(n, pkg.gen.nemesis(p["generator"])),
                    {"nodes": NODES})
    return ([{k: o.get(k) for k in ("type", "f", "value", "time")}
             for o in ops],
            sorted(map(str, p["nemesis"].fs())), sorted(map(str, p["perf"])),
            final_shape(p["final_generator"]))


def final_shape(g):
    """A package's final generator: its ops where it is data, else its
    generator type."""
    return repr(g) if isinstance(g, (dict, list, type(None))) \
        else type(g).__name__


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", list(PACKAGES))
def test_package_generators_match_reference(which, seed):
    port = first_ops(PORT, which, seed)
    assert port == first_ops(REF, which, seed)
    assert len(port[0]) == 2 * 50    # each op invoked and completed


@pytest.mark.parametrize("seed", SEEDS)
def test_db_nemesis_targets_match_reference(seed):
    def run(pkg):
        pkg.seed(seed)
        db = killable(pkg)
        t = {"nodes": NODES, "sessions": dummy_sessions(pkg, NODES)}
        nem = pkg.combined.DBNemesis(db)
        out = [nem.invoke(t, {"f": f, "process": "nemesis", "value": s})
               for f, s in (("kill", "one"), ("start", "all"),
                            ("pause", "minority"), ("resume", "all"),
                            ("kill", None), ("start", "majority"))]
        return out, sorted(db.events), sorted(nem.fs())
    assert run(PORT) == run(REF)


# -- parity: clock faults and faketime over a recording remote ---------------

NOW = 1_700_000_123.5


def clock_script(cmd: str):
    """(out, exit): the node's clock 2.25 s ahead of the frozen control
    clock, each bump tool answering the new time; `which faketime`
    fails, so that `install` builds it."""
    if "which faketime" in cmd or "test -e" in cmd or "test -f" in cmd:
        return "", 1
    if "date +%s.%N" in cmd or "bump-time" in cmd:
        return f"{NOW + 2.25}\n", 0
    return "", 0


def recording_remote(pkg: Pkg, log: list):
    class Scripted(pkg.dummy.DummyRemote):
        def execute(self, context, action):
            cmd = action.get("cmd")
            self.log.append((self.host, cmd))
            out, code = clock_script(cmd)
            return {**action, "exit": code, "out": out, "err": "",
                    "action": action}

        def upload(self, context, local_paths, remote_path, opts=None):
            paths = [local_paths] if isinstance(local_paths, str) \
                else list(local_paths)
            self.log.append((self.host, ("upload", [
                open(p, "rb").read() for p in paths], remote_path)))

    return Scripted(log)


def on_cluster(pkg: Pkg, fn, seed: int):
    """fn(pkg, test) with sessions to every node and the RNGs seeded:
    (each node's commands in order, the result)."""
    pkg.seed(seed)
    log: list = []
    rem = recording_remote(pkg, log)
    test = {"nodes": list(NODES),
            "sessions": {n: rem.connect({"host": n}) for n in NODES}}
    with pkg.c.with_remote(rem):
        try:
            out = fn(pkg, test)
        except Exception as e:  # noqa: BLE001 - compared below
            out = ("raised", type(e).__name__, str(e))
    per_node: dict = {}
    for host, cmd in log:
        per_node.setdefault(host, []).append(cmd)
    return per_node, out


@pytest.fixture
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


def clock_ops(pkg, test):
    nem = pkg.timefaults.clock_nemesis().setup(test)
    ops = [pkg.timefaults.reset_gen(test, None),
           pkg.timefaults.bump_gen(test, None),
           pkg.timefaults.strobe_gen(test, None),
           {"type": "info", "f": "check-offsets"}]
    out = [nem.invoke(test, op) for op in ops]
    nem.teardown(test)
    return out, sorted(nem.fs())


def faketime_calls(pkg, test):
    def node(t, n):
        pkg.faketime.install()
        pkg.faketime.wrap("/opt/db/bin/db d", -7.9, 1.5)
        pkg.faketime.unwrap("/opt/db/bin/db d")
        return pkg.faketime.script("~/db", 30.2, 0.25)
    return (pkg.c.on_nodes(test, node, ["n2"]),
            [round(pkg.faketime.rand_factor(f), 12) for f in (1, 2, 10)])


CLOCK_CALLS = {
    "clock_nemesis": clock_ops,
    "install": lambda pkg, test: pkg.c.on_nodes(
        test, lambda t, n: pkg.timefaults.install(), ["n1"]),
    "bump_and_strobe": lambda pkg, test: pkg.c.on_nodes(
        test, lambda t, n: (pkg.timefaults.bump_time(-250),
                            pkg.timefaults.strobe_time(8, 2, 1.5),
                            pkg.timefaults.current_offset()), ["n3"]),
    "clock_gen": lambda pkg, test: quick_ops(pkg, pkg.gen.limit(
        12, pkg.gen.nemesis(pkg.timefaults.clock_gen())), test),
    "faketime": faketime_calls,
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("call", list(CLOCK_CALLS))
def test_clock_commands_match_reference(call, seed, frozen_clock):
    port = on_cluster(PORT, CLOCK_CALLS[call], seed)
    assert port == on_cluster(REF, CLOCK_CALLS[call], seed)
    assert port[0] or call == "clock_gen"
    assert not (isinstance(port[1], tuple) and port[1][:1] == ("raised",))


def test_clock_tools_are_the_repos_own_sources():
    """The port uploads the same `native/clock/` files as the reference:
    the path computed from `__file__` lands at the repository root from
    either package."""
    assert port_timefaults._SRC_DIR == ref_timefaults._SRC_DIR
    per_node, _ = on_cluster(PORT, CLOCK_CALLS["install"], 0)
    uploads = [c for c in per_node["n1"] if isinstance(c, tuple)]
    assert [u[2] for u in uploads] == ["/opt/jepsen/bump-time.cc",
                                       "/opt/jepsen/strobe-time.cc"]
    assert all(b"main" in u[1][0] for u in uploads)
